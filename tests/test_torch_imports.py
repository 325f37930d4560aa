"""The port stands alone: it imports torch, never jax nor ``repro``.

A fresh interpreter imports every module of ``repro_torch`` and must end
with no ``jax`` in ``sys.modules``; a source scan finds no jax or repro
import in the package, ``chip_smoke.py`` or ``kernel_bench.py``; the
entry points refuse to run without CUDA unless the CPU was asked for.
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
        .replace(".__init__", "")
        for p in PKG.rglob("*.py"))


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert "repro_torch.kernels.dequant.ops" in mods and len(mods) > 20
    assert {"repro_torch.plan", "repro_torch.plan.executor",
            "repro_torch.dist.fault", "repro_torch.launch.plan"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


_BAD = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)[\s.])",
                  re.MULTILINE)


def test_sources_do_not_import_jax_or_repro():
    scripts = [ROOT / "chip_smoke.py", ROOT / "kernel_bench.py"]
    files = list(PKG.rglob("*.py")) + scripts
    assert all(f.exists() for f in scripts)
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in _BAD.finditer(f.read_text())]
    assert not hits, hits


def test_serve_without_cuda_raises_unless_cpu_is_asked(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "minicpm-2b", "--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    done = serve.main(["--arch", "minicpm-2b", "--reduced", "--requests", "2",
                       "--max-new", "3", "--wbits", "2", "--continuous",
                       "--device", "cpu"])
    assert [len(r.out_tokens) for r in done] == [3, 3]


def test_model_builders_default_to_cuda(monkeypatch):
    """init_params, init_cache and from_jax_params take ``cuda`` when no
    device is given: without a card they raise instead of building on the
    CPU, and an explicit ``'cpu'`` still works."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import from_jax_params, init_cache, init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("minicpm-2b").reduced()
    for build in (lambda **kw: init_params(cfg, 0, **kw),
                  lambda **kw: init_cache(cfg, 1, 4, **kw),
                  lambda **kw: from_jax_params({"w": np.ones(3)}, **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert init_params(cfg, 0, device="cpu")["embed"]["w"].device.type \
        == "cpu"
    assert from_jax_params({"w": np.ones(3)}, "cpu")["w"].device.type \
        == "cpu"


def test_every_module_imports_first():
    """Each module imports on its own, before any other of the package,
    so no import cycle hides behind the order the package is used in."""
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    for k in [k for k in sys.modules\n"
            "              if k.split('.')[0] == 'repro_torch']:\n"
            "        del sys.modules[k]\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
