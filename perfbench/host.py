"""What the host did while a window ran, read from ``/proc`` (read only).

``Window`` wraps the loop that drives the card from the main thread and
keeps, over its wall time: the thread's CPU time, its involuntary context
switches, and the machine's steal time (CPU time its hypervisor gave to
others), each as a share of the window or a count.  A reading the machine
does not offer is left out.
"""
from __future__ import annotations

import os
import resource
import time
from typing import Dict, Optional


def _steal_s() -> Optional[float]:
    """Steal time of all CPUs together, seconds (``/proc/stat``)."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


def _switches() -> int:
    return resource.getrusage(resource.RUSAGE_THREAD).ru_nivcsw


class Window:
    """``with Window() as w:`` around the loop; ``w.readings`` after it."""

    def __enter__(self):
        self._t = time.perf_counter()
        self._cpu = time.thread_time()
        self._steal = _steal_s()
        self._sw = _switches()
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self._t
        out: Dict[str, float] = {
            "cpu_share": (time.thread_time() - self._cpu) / wall,
            "involuntary_switches": _switches() - self._sw}
        steal = _steal_s()
        if steal is not None and self._steal is not None:
            out["steal_share"] = (steal - self._steal) / wall \
                / (os.cpu_count() or 1)
        self.readings = out
        return False
