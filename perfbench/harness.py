"""Run one cell of ``BENCHMARK.json`` once and build its result line.

The cell's configuration, traffic, entry, metric readers and limits are
all found by name (``find``).  The entry drives the program through its
set-up and the measured window and fills a ``Run``; the readers turn the
``Run`` into metrics; the entry's ``check`` compares what the timed path
produced with the plain reference once the window has closed and the
program's state is freed.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path
from typing import Any, Dict, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "perfbench"

#: top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: the port's ArchConfig field of each size a configuration file states
ARCH_KEYS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
             "num_attention_heads": "n_heads",
             "num_key_value_heads": "n_kv", "intermediate_size": "d_ff",
             "vocab_size": "vocab", "rope_theta": "rope_theta",
             "qkv_bias": "qkv_bias", "tie_word_embeddings": "tie_embeddings"}


class Run(types.SimpleNamespace):
    """What one run recorded.  Entries set what they measure; readers
    read it with ``getattr(run, name, None)``."""


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def find(man: Dict[str, Any], workload: str, root: Path = ROOT):
    """(cell, configuration entry, configuration file, traffic, limits)
    of ``workload``, each read from its own file."""
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    bench = root / "perfbench"
    return (cell, conf, load_json(root / conf["file"]),
            load_json(bench / "traffic" / f"{cell['traffic']}.json"),
            load_json(bench / "limits" / f"{workload}.json"))


def metrics_of(man: Dict[str, Any], workload: str, trace: bool):
    """The metric entries a run of ``workload`` reports: its end-to-end
    metrics with trace off, its per-layer metrics with trace on (an entry
    without ``workloads`` holds in every cell)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in man[key]
            if workload in m.get("workloads", [workload])]


def port_arch(conf_file: Dict[str, Any]):
    """The port's ArchConfig of a configuration file, refused when any
    size the file states differs from it."""
    from repro_torch.configs import get_config
    arch = get_config(conf_file["arch"])
    bad = {k: (conf_file[k], getattr(arch, f))
           for k, f in ARCH_KEYS.items()
           if k in conf_file and conf_file[k] != getattr(arch, f)}
    if bad:
        raise SystemExit(f"{conf_file['name']}: the port's sizes differ "
                         f"from the configuration file: {bad}")
    return arch


def device_info(device, run=None) -> Dict[str, Any]:
    """The result line's ``device``: the run's own peak where its entry
    kept one (``run.memory_peak_bytes``), else the allocator's."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    peak = getattr(run, "memory_peak_bytes", None)
    info = {"platform": "gpu",
            "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(
                peak if peak is not None
                else torch.cuda.max_memory_allocated(device))}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def measured(workload: str, seed: int, seconds: float, trace: bool, *,
             device, root: Path = ROOT, arch=None,
             traffic: Optional[Dict[str, Any]] = None,
             man: Optional[Dict[str, Any]] = None):
    """Set up ``workload``, run its window and free the program's state:
    (the ``Run``, its entry, its reference module, its limits).  ``arch``,
    ``traffic`` and ``man`` replace the cell's own and ``BENCHMARK.json``
    (the tests run a cell at a small size)."""
    man = man if man is not None else manifest(root)
    _, _, conf_file, cell_traffic, limits = find(man, workload, root)
    arch = arch if arch is not None else port_arch(conf_file)
    traffic = traffic if traffic is not None else cell_traffic
    bench = root / "perfbench"
    entry = load_module(bench / "entries" / f"{traffic['entry']}.py",
                        f"perfbench_entry_{traffic['entry']}")
    reference = load_module(
        bench / "reference" / f"{conf_file['reference']}.py",
        f"perfbench_reference_{conf_file['reference']}")
    run = Run(workload=workload, seed=seed, seconds=seconds, trace=trace,
              device=device, arch=arch, traffic=traffic, man=man, root=root)
    entry.measure(run)
    run.device_info = device_info(device, run)
    entry.release(run)
    return run, entry, reference, limits


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             **kw) -> Dict[str, Any]:
    """One run of ``workload``: the result line's object (without the
    module check, which ``run.py`` makes last); ``kw`` as ``measured``
    takes it."""
    run, entry, reference, limits = measured(workload, seed, seconds, trace,
                                             **kw)
    checks = entry.check(run, reference, limits)
    metrics = {}
    bench = run.root / "perfbench"
    for m in metrics_of(run.man, workload, trace):
        reader = load_module(bench / "metrics" / f"{m['name']}.py",
                             f"perfbench_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = run.device_info
    if trace:
        dev["busy_s"] = run.busy_ns / 1e9
        dev["window_s"] = (run.trace_t1 - run.trace_t0) / 1e9
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = run.breakdown
    out["checks"] = checks
    out["notes"] = {"setup_s": run.setup_s, **getattr(run, "notes", {})}
    return out


def forbidden_modules():
    """Top-level names of ``sys.modules`` that a run may not hold."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))
