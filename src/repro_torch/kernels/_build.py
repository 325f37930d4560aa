"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` under ``repro_torch/kernels`` is compiled at first use
with plain ``nvcc`` for ``sm_90a`` into a shared library with a C
interface, and loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  Libraries land in ``kernels/build/`` (git-ignored), named
by a hash of the sources and flags, so an edited source never loads a
stale build.  All sources are compiled together, one ``nvcc`` process
each.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "sources", "build_all", "load",
           "build_log"]

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# one build and load at a time: the plan executor's threads reach the
# first launch of a kernel together
_load_lock = threading.Lock()


def sources() -> Dict[str, Path]:
    """Kernel source stem → path, for every ``csrc/*.cu`` of the port."""
    return {p.stem: p for p in sorted(_KERNELS.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine that has the card")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(src.parent.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build_log(stem: str) -> str:
    """The compiler's output (``-Xptxas -v``) of the current build."""
    log = _target(sources()[stem]).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all() -> Dict[str, float]:
    """Compile every stale kernel library, all ``nvcc`` runs in parallel.

    Returns stem → seconds spent building (0.0 when the library was
    already current).  Raises with the compiler's output on failure.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {stem: src for stem, src in sources().items()
            if not _target(src).exists()}
    procs = {}
    t0 = time.perf_counter()
    for stem, src in todo.items():
        out = _target(src)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        procs[stem] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    took = {stem: 0.0 for stem in sources()}
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[stem] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{stem}: nvcc exited {proc.returncode}\n{log}")
            continue
        # both land by rename: another process (a rank) never reads half
        log_tmp = tmp.with_name(tmp.name + ".log")
        log_tmp.write_text(log)
        os.replace(log_tmp, out.with_suffix(".log"))
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``stem``, built if needed."""
    with _load_lock:
        lib = _loaded.get(stem)
        if lib is None:
            target = _target(sources()[stem])
            if not target.exists():
                build_all()
            lib = _loaded[stem] = ctypes.CDLL(str(target))
        return lib
