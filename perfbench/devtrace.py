"""Host spans and the device trace of one run, and their reduction.

Spans are the benchmark's own: ``Recorder.span(name)`` stamps
``time.time_ns()`` around a call into the program.  ``DeviceTrace`` runs
``torch.profiler`` (CUDA activity only, so the program's host operators
are not recorded) over a traced run's extra steps and keeps each device
operation as (name, start ns, end ns).  The profiler puts device times on
the same Unix-epoch clock as ``time.time_ns()``, so a device interval can
be placed inside a host span.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

Interval = Tuple[str, int, int]


class Recorder:
    """Spans (name, start ns, end ns) in the order they closed."""

    def __init__(self):
        self.spans: List[Interval] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))


class DeviceTrace:
    """``with DeviceTrace(device) as tr:`` profiles ``device``; after the
    block ``tr.ops`` holds every device operation (kernels, copies, sets)
    and ``tr.t0``/``tr.t1`` the traced window (ns).  On a CPU device (the
    tests) the host operators stand in for it."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.ops: List[Interval] = []
        self.t0 = self.t1 = 0
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[
            ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU])
        self._prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.ops = device_ops(self._prof, self.cuda)
        self._prof = None
        return False


def device_ops(prof, cuda: bool = True) -> List[Interval]:
    """(name, start ns, end ns) of every device activity of a finished
    profiler (of every host operator when not ``cuda``), sorted by
    start."""
    import torch
    kind = torch.autograd.DeviceType.CUDA if cuda \
        else torch.autograd.DeviceType.CPU
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == kind:
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
    out.sort(key=lambda r: r[1])
    return out


def busy_ns(ops: List[Interval], t0: int, t1: int) -> int:
    """Length of the union of the operations' intervals inside [t0, t1]."""
    busy, end = 0, t0
    for _, a, b in ops:
        a, b = max(a, end), min(b, t1)
        if b > a:
            busy += b - a
        end = max(end, min(b, t1))
    return busy


def idle_gaps(ops: List[Interval], t0: int, t1: int
              ) -> List[Tuple[int, int, str, str]]:
    """Intervals of [t0, t1] in which no operation ran: (start, end, the
    operation before, the operation after)."""
    gaps, end, prev = [], t0, "window start"
    for name, a, b in ops:
        if a >= t1:
            break
        if a > end:
            gaps.append((end, a, prev, name))
        if b > end:
            end, prev = b, name
    if t1 > end:
        gaps.append((end, t1, prev, "window end"))
    return gaps


def short(name: str, width: int = 72) -> str:
    """A kernel's name without ``void`` and its argument list."""
    name = name[5:] if name.startswith("void ") else name
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    name = name[:cut]
    return name if len(name) <= width else name[:width - 3] + "..."


def span_at(spans: List[Interval], t: int) -> str:
    """Name of the innermost span holding instant ``t`` ("outside spans"
    when none does)."""
    best: Optional[Interval] = None
    for s in spans:
        if s[1] <= t <= s[2] and (best is None or s[2] - s[1]
                                  < best[2] - best[1]):
            best = s
    return best[0] if best else "outside spans"


def breakdown(ops: List[Interval], spans: List[Interval], t0: int, t1: int,
              top: int = 10) -> Dict[str, list]:
    """The device operations that took the most time (summed by short
    name) and the idle time of the window summed by what the host was
    doing: the span that holds the gap, and the operations on either
    side.  Seconds, most first, at most ``top`` of each."""
    by_op: Dict[str, int] = {}
    for name, a, b in ops:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            by_op[short(name)] = by_op.get(short(name), 0) + (b - a)
    by_gap: Dict[str, int] = {}
    for a, b, before, after in idle_gaps(ops, t0, t1):
        key = (f"{span_at(spans, (a + b) // 2)}: {short(before, 40)} -> "
               f"{short(after, 40)}")
        by_gap[key] = by_gap.get(key, 0) + (b - a)

    def top_of(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": top_of(by_op), "idle_gaps": top_of(by_gap)}


def keep(run, trace: "DeviceTrace", spans: List[Interval]) -> None:
    """Put a finished trace's reductions on ``run``: its operations, the
    traced window, the busy time and the breakdown."""
    run.ops = trace.ops
    run.trace_t0, run.trace_t1 = trace.t0, trace.t1
    run.busy_ns = busy_ns(trace.ops, trace.t0, trace.t1)
    run.breakdown = breakdown(trace.ops, spans, trace.t0, trace.t1)


def idle_share_pct(run):
    """Percent of the traced window with no device operation running
    (None without a trace)."""
    if not getattr(run, "trace", False) or not getattr(run, "ops", None):
        return None
    return 100.0 * (1.0 - run.busy_ns / (run.trace_t1 - run.trace_t0))
