"""The kernels' seam to the step cost counter (``launch.hlo_cost``).

The hand-written kernels are bound through ``ctypes``, so a
``TorchDispatchMode`` never sees them.  Each public wrapper therefore
reports its own work here when a counter is active: a name, the FLOPs of
the product it computes and the bytes it streams.  With no counter
active the cost is one ``is None`` check; with one active, the plain
twin that stands in for the kernel on the CPU runs :func:`muted`, so its
ops are not counted a second time.
"""
from __future__ import annotations

import contextlib

__all__ = ["ACTIVE", "report", "muted"]

#: the innermost active counter (``launch.hlo_cost.CostCounter``), or None
ACTIVE = [None]


def report(name: str, flops: float, nbytes: float) -> None:
    """Charge one launch of kernel ``name`` to the active counter."""
    ACTIVE[0].kernel(name, flops, nbytes)


@contextlib.contextmanager
def muted():
    """Run a kernel's twin without counting its ops (the wrapper has
    reported the kernel's work)."""
    counter = ACTIVE[0]
    if counter is None:
        yield
        return
    counter.muted += 1
    try:
        yield
    finally:
        counter.muted -= 1
