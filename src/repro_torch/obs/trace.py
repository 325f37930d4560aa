"""Structured tracing: nestable spans → Chrome trace-event JSON (port of
``repro/obs/trace.py``; a stdlib copy, so the same spans give the same
trace as the reference, apart from the timestamps).

The :class:`Tracer` records *complete* events (``ph: "X"``) and
*instant* events (``ph: "i"``) in the Chrome Trace Event format —
``{"traceEvents": [...]}`` — which chrome://tracing and Perfetto load
directly, giving the serving engines and the plan executor a zoomable
timeline for free (DESIGN.md §11).

Timestamps are ``time.perf_counter()`` microseconds relative to the
tracer's epoch, so spans from every thread share one monotonic clock.
The tracer also reads ``perf_counter_ns`` and ``time.time_ns`` together
when it is created and again at each export, and maps every stamp
linearly between the two pairs onto the Unix epoch: the clock
``torch.profiler`` stamps its host and device events with.
:meth:`Tracer.intervals` gives the spans on that clock, and the Chrome
export carries the Unix time of its ``ts`` 0 (``otherData``), so the
timeline lays over a profiler trace.  Spans recorded on one thread nest
by containment; that containment is their parent relation.
Two ways to record a span:

* ``with tracer.span("serve.prefill", slot=3): …`` — context manager,
  times the body;
* ``tracer.complete("serve.decode", t0, t1, slots=[0, 2])`` — adopt an
  existing pair of perf_counter stamps.  The engines already bracket
  their device dispatches with perf_counter for the RoundStats/StepStats
  accounting; ``complete`` turns those SAME stamps into trace events, so
  the timeline and the stats views can never disagree about a duration.

``tid`` defaults to the recording thread's ident; slot-scoped serving
spans override it with the slot index so Perfetto renders one lane per
slot.  ``list.append`` is atomic under the GIL, so concurrent recording
needs no lock on the hot path.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Tracer", "NULL_SPAN"]


class _NullSpan:
    """Shared, stateless no-op context manager — the disabled path
    allocates nothing (obs.span returns this singleton)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_tid", "_t0")

    def __init__(self, tracer: "Tracer", name: str, tid: Optional[int],
                 args: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._tid = tid
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer.complete(self._name, self._t0, time.perf_counter(),
                              tid=self._tid, **self._args)
        return False


def _clock_pair() -> Tuple[int, int]:
    """(perf_counter ns, Unix ns) read together: the Unix reading against
    the midpoint of two perf_counter readings around it."""
    a = time.perf_counter_ns()
    u = time.time_ns()
    return (a + time.perf_counter_ns()) // 2, u


class Tracer:
    def __init__(self):
        self.events: List[Dict[str, Any]] = []
        self.epoch = time.perf_counter()
        self.pid = os.getpid()
        self._anchor = _clock_pair()

    def unix_ns(self):
        """The map of a perf_counter stamp (s) to Unix ns: linear between
        the creation's clock pair and one read now."""
        (p0, u0), (p1, u1) = self._anchor, _clock_pair()
        rate = (u1 - u0) / (p1 - p0) if p1 - p0 > 10**6 else 1.0
        return lambda t_s: int(u0 + (t_s * 1e9 - p0) * rate)

    def intervals(self) -> List[Tuple[str, int, int, Dict[str, Any]]]:
        """(name, start Unix ns, end Unix ns, args) of every complete
        event, in the order they were recorded (a span when it closed)."""
        to_ns = self.unix_ns()
        out = []
        for e in self.events:
            if e["ph"] == "X":
                t0 = self.epoch + e["ts"] / 1e6
                out.append((e["name"], to_ns(t0),
                            to_ns(t0 + e["dur"] / 1e6), e["args"]))
        return out

    def _us(self, t_s: float) -> float:
        return (t_s - self.epoch) * 1e6

    def span(self, name: str, *, tid: Optional[int] = None, **args):
        """Context manager timing its body into one complete event."""
        return _Span(self, name, tid, args)

    def complete(self, name: str, t0_s: float, t1_s: float, *,
                 tid: Optional[int] = None, **args) -> None:
        """Record a complete ("X") event from existing perf_counter stamps."""
        self.events.append({
            "name": name, "ph": "X", "cat": name.split(".", 1)[0],
            "ts": self._us(t0_s), "dur": max(0.0, (t1_s - t0_s) * 1e6),
            "pid": self.pid,
            "tid": threading.get_ident() if tid is None else int(tid),
            "args": args})

    def instant(self, name: str, *, tid: Optional[int] = None,
                **args) -> None:
        """Record an instant ("i", thread-scoped) event at now."""
        self.events.append({
            "name": name, "ph": "i", "s": "t",
            "cat": name.split(".", 1)[0],
            "ts": self._us(time.perf_counter()), "pid": self.pid,
            "tid": threading.get_ident() if tid is None else int(tid),
            "args": args})

    def to_chrome(self) -> Dict[str, Any]:
        """The loadable trace object (stable event order: by ts)."""
        return {"traceEvents": sorted(self.events,
                                      key=lambda e: (e["ts"], e["ph"])),
                "displayTimeUnit": "ms",
                "otherData": {"ts0_unix_ns": self.unix_ns()(self.epoch)}}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
