"""The program's own spans inside the decode step, on the profiler's clock.

With ``repro_torch.obs`` on, the port records inside each
``ContinuousEngine.step`` (``serve.step``): ``serve.dispatch`` (the host
enqueuing the step), which holds ``decode.attention`` once a layer and
``decode.unembed``, then ``serve.sample`` (the argmax, its copy to the
host and the wait on the card).  ``Tracer.intervals()`` gives them in
Unix ns, the clock ``torch.profiler`` stamps its events with.

``segments`` runs two segments of ``trace_seconds / 2`` each with obs on,
after a traced run's obs-off trace:

* A, host only: the mean ``serve.dispatch`` and ``serve.sample`` of its
  steps (``dispatch_ms``, ``wait_ms``), and its median step beside the
  window's (the cost of tracing when it is on);
* B, under the profiler: each device operation is credited to the
  innermost span holding the instant it was launched, found through the
  correlation id the profiler gives both the operation and its runtime
  launch call (``attention_ms``: ``decode.attention``; ``unembed_ms``:
  ``decode.unembed`` and ``serve.sample``; per step).  On the CPU the
  outermost host operators stand in for device operations, each launched
  at its own start.

``result(run)`` is what the metric readers call: the segments' numbers,
made once per run and kept on it (``keep``).  The run's engine is freed
before its readers run, so ``result`` builds the cell's program again
through the entry's own ``measure`` (no window) and runs the segments on
it.  A program whose tracer has no ``intervals`` gives nothing, and
nothing is built.
"""
from __future__ import annotations

import bisect
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

from perfbench import devtrace
from perfbench.metrics.b1_roofline import is_b1

Span = Tuple[str, int, int]

#: the spans the metrics read
ATTENTION = ("decode.attention",)
UNEMBED = ("decode.unembed", "serve.sample")
#: ``serve.dispatch`` and the spans that nest in it
DISPATCH = ("serve.dispatch", "decode.attention", "decode.unembed")
#: runtime calls that wait on the card
BLOCKING = ("Synchronize",)


class Lookup:
    """The innermost span holding an instant.  Spans of one thread nest
    by containment; a span that crosses its parent's end is cut there."""

    def __init__(self, spans: List[Span]):
        self.starts: List[int] = []
        self.rows: List[Tuple[int, int, Optional[str]]] = []
        stack: List[Span] = []
        at = None
        for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
            while stack and stack[-1][2] <= a:
                at = self._close(stack, at)
            if stack:
                b = min(b, stack[-1][2])
                self._emit(at, a, stack[-1][0])
            at = a
            stack.append((name, a, b))
        while stack:
            at = self._close(stack, at)

    def _emit(self, a, b, name):
        if a is not None and b > a:
            self.starts.append(a)
            self.rows.append((a, b, name))

    def _close(self, stack, at):
        name, _, b = stack.pop()
        self._emit(at, b, name)
        return max(at, b)

    def __call__(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.rows[i][1]:
            return self.rows[i][2]
        return None


def records(prof, cuda: bool):
    """(device operations as (name, start, end, launch instant or None),
    CUDA API calls as (name, start)) of a finished profiler.  A device
    operation's launch is the start of the CUDA API call with its
    correlation id.  On the CPU the outermost host operators stand in
    for device operations, each launched at its own start."""
    import torch
    dev_kind = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    if not cuda:
        ops, end = [], None
        for e in sorted(events, key=lambda e: e.start_ns()):
            s = e.start_ns()
            if end is None or s >= end:
                end = s + e.duration_ns()
                ops.append((e.name(), s, end, s))
        return ops, []
    launch_at: Dict[int, int] = {}
    calls = []
    raw = []
    for e in events:
        if e.device_type() == dev_kind:
            raw.append(e)
        elif e.name().startswith("cu"):
            # a CUDA API call: its correlation id is the one
            # its kernel, copy or set carries (the profiler's own host
            # records, "Activity Buffer Request", may carry it too)
            calls.append((e.name(), e.start_ns()))
            if e.correlation_id():
                launch_at[e.correlation_id()] = e.start_ns()
    ops = []
    for e in raw:
        s = e.start_ns()
        ops.append((e.name(), s, s + e.duration_ns(),
                    launch_at.get(e.correlation_id())))
    ops.sort(key=lambda r: r[1])
    return ops, calls


def _events_bytes(events) -> int:
    """Bytes the tracer's event dicts hold (dicts, args and their
    values; strings shared with the code not counted twice)."""
    seen, total = set(), 0
    for e in events:
        for obj in (e, e["args"], *e.values(), *e["args"].values()):
            if id(obj) not in seen:
                seen.add(id(obj))
                total += sys.getsizeof(obj)
    return total


def _steps(spans, name="serve.step"):
    return [s for s in spans if s[0] == name]


def segment_a(step, seconds: float, obs) -> Dict:
    """Host spans of ``seconds`` of steps with obs on, no profiler."""
    with obs.scoped(enable_obs=True) as (_, tr):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            step()
        spans = [(n, a, b) for n, a, b, _ in tr.intervals()]
        n_events = len(tr.events)
        ev_bytes = _events_bytes(tr.events)
    steps = _steps(spans)
    if not steps:
        return {}

    def mean_ms(name):
        d = [b - a for n, a, b in spans if n == name]
        return 1e-6 * statistics.fmean(d) if d else None
    return {"steps": len(steps),
            "dispatch_ms": mean_ms("serve.dispatch"),
            "wait_ms": mean_ms("serve.sample"),
            "decode_ms": mean_ms("serve.decode"),
            "step_ms_median_max": [
                1e-6 * statistics.median(b - a for _, a, b in steps),
                1e-6 * max(b - a for _, a, b in steps)],
            "events_per_step": n_events / len(steps),
            "event_bytes_per_step": ev_bytes / len(steps)}


def segment_b(step, seconds: float, obs, device) -> Dict:
    """Device time of ``seconds`` of steps under the profiler, credited
    to the program's spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    with obs.scoped(enable_obs=True) as (_, tr):
        with profile(activities=[ProfilerActivity.CUDA if cuda
                                 else ProfilerActivity.CPU]) as prof:
            t0 = time.time_ns()
            w0 = time.perf_counter()
            while time.perf_counter() - w0 < seconds:
                step()
            if cuda:
                torch.cuda.synchronize(device)
            t1 = time.time_ns()
        spans = [(n, a, b) for n, a, b, _ in tr.intervals()]
    ops, calls = records(prof, cuda)
    n = len(_steps(spans))
    if not n or not ops:
        return {}
    return attribute(ops, calls, spans, t0, t1, n)


def attribute(ops, calls, spans: List[Span], t0: int, t1: int,
              n_steps: int) -> Dict:
    """Reduce one profiled segment: device ms per step by innermost span
    of each operation's launch (``None``: no launch found, or launched
    outside every span), the metrics, and the idle gaps by the span that
    held the host at their midpoint."""
    at = Lookup(spans)
    by_span: Dict[Optional[str], int] = {}
    b1 = b1_in_attention = matched = 0
    for name, a, b, launch in ops:
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        where = at(launch) if launch is not None else None
        matched += launch is not None
        by_span[where] = by_span.get(where, 0) + (b - a)
        if is_b1(name):
            b1 += b - a
            b1_in_attention += (b - a) if where in ATTENTION else 0
    total = sum(by_span.values())

    def ms(names):
        return 1e-6 * sum(by_span.get(k, 0) for k in names) / n_steps
    attention, unembed = ms(ATTENTION), ms(UNEMBED)
    out = {"steps": n_steps, "attention_ms": attention,
           "unembed_ms": unembed,
           "busy_ms": 1e-6 * devtrace.busy_ns([o[:3] for o in ops], t0, t1)
           / n_steps,
           "device_ms_by_span": {str(k): 1e-6 * v / n_steps
                                 for k, v in sorted(
                                     by_span.items(),
                                     key=lambda kv: -kv[1])},
           "attributed_share": 1.0 - by_span.get(None, 0) / total
           if total else None,
           "launch_matched_share": matched / len(ops),
           "b1_ms": 1e-6 * b1 / n_steps,
           "b1_in_attention_ms": 1e-6 * b1_in_attention / n_steps}
    out["rest_ms"] = 1e-6 * total / n_steps - attention - unembed \
        - out["b1_ms"] + out["b1_in_attention_ms"]
    gaps: Dict[str, int] = {}
    for a, b, before, after in devtrace.idle_gaps(
            [o[:3] for o in ops], t0, t1):
        key = (f"{at((a + b) // 2) or 'outside spans'}: "
               f"{devtrace.short(before, 40)} -> "
               f"{devtrace.short(after, 40)}")
        gaps[key] = gaps.get(key, 0) + (b - a)
    out["idle_gaps"] = [[k, v / 1e9] for k, v in sorted(
        gaps.items(), key=lambda kv: -kv[1])[:10]]
    blocking: Dict[str, int] = {}
    for name, s in calls:
        if any(k in name for k in BLOCKING) and at(s) in DISPATCH:
            key = f"{name} in {at(s)}"
            blocking[key] = blocking.get(key, 0) + 1
    out["blocking_calls_in_dispatch_per_step"] = {
        k: v / n_steps for k, v in sorted(blocking.items())}
    return out


def segments(run, engine) -> Dict:
    """Segments A then B, ``trace_seconds / 2`` each, of ``engine``'s
    steps at the cell's load; then how its tokens compare with the
    window's."""
    from repro_torch import obs
    step, served = _stepper(run, engine)
    half = run.traffic["trace_seconds"] / 2
    return {"a": segment_a(step, half, obs),
            "b": segment_b(step, half, obs, run.device),
            "obs_on_tokens_equal": _tokens_equal(run, engine, served)}


def supported() -> bool:
    """Whether the program's tracer gives its spans on the Unix clock."""
    from repro_torch.obs import Tracer
    return hasattr(Tracer, "intervals")


def _rebuilt(run):
    """The cell's program built again by its entry (set-up only, no
    window): (the sub-run holding the engine, its entry)."""
    from perfbench import harness
    entry = harness.load_module(
        run.root / "perfbench" / "entries" / f"{run.traffic['entry']}.py",
        f"perfbench_entry_{run.traffic['entry']}")
    sub = harness.Run(workload=run.workload, seed=run.seed, seconds=0.0,
                      trace=False, device=run.device, arch=run.arch,
                      traffic=run.traffic, man=run.man, root=run.root)
    entry.measure(sub)
    return sub, entry


def _stepper(run, engine):
    """One engine step that sends a finished request's client its next
    request (prompts of a stream the window does not use)."""
    import numpy as np

    from perfbench import inputs
    from repro_torch.serve.engine import Request
    tr, arch = run.traffic, run.arch
    served: Dict[bytes, object] = {}
    count = [0]

    def step():
        for r in engine.step():
            served[np.asarray(r.prompt).tobytes()] = r
            k = count[0]
            count[0] += 1
            client = k % tr["clients"]
            engine.submit(Request(
                rid=10**9 + k, max_new_tokens=tr["max_new_tokens"],
                prompt=inputs.prompt(run.seed, client, 10**6 + k,
                                     tr["prompt_len"], arch.vocab)))
    return step, served


def _tokens_equal(run, engine, served) -> Optional[float]:
    """Share of the check's sampled requests whose tokens served with obs
    on (the rebuilt program) equal the window's, over their common
    length."""
    import numpy as np
    mine = dict(served)
    for r in engine.slots:
        if r is not None:
            mine[np.asarray(r.prompt).tobytes()] = r
    same = total = 0
    for prompt, toks in getattr(run, "sample", []):
        r = mine.get(np.asarray(prompt).tobytes())
        if r is None:
            continue
        n = min(len(toks), len(r.out_tokens))
        total += 1
        same += list(toks[:n]) == list(r.out_tokens[:n])
    return same / total if total else None


def result(run) -> Dict:
    """The segments' metrics and notes for ``run`` (made at the first
    call, kept on the run): ``{}`` where the program lacks the spans or
    the run is not traced."""
    got = getattr(run, "progtrace", None)
    if got is not None:
        return got
    run.progtrace = {}
    if not getattr(run, "trace", False) or not supported():
        return run.progtrace
    t0 = time.perf_counter()
    sub, entry = _rebuilt(run)
    t1 = time.perf_counter()
    try:
        keep(run, sub.engine)
    finally:
        entry.release(sub)
    run.notes["progtrace_rebuild_segments_s"] = [
        t1 - t0, time.perf_counter() - t1]
    return run.progtrace


def keep(run, engine) -> None:
    """Run the segments on ``engine`` and keep their metrics on ``run``
    (``run.progtrace``), their other numbers in its notes."""
    run.progtrace = _reduce(run, segments(run, engine))


def _reduce(run, seg) -> Dict:
    """The four metrics, with the segments' other numbers as notes."""
    a, b = seg["a"], seg["b"]
    out = {k: a.get(k) for k in ("dispatch_ms", "wait_ms")}
    out.update({k: b.get(k) for k in ("attention_ms", "unembed_ms")})
    notes = run.notes
    if a:
        window = notes.get("step_ms_min_med_p95_max")
        notes["progtrace_a"] = {
            **{k: a[k] for k in ("steps", "decode_ms", "step_ms_median_max",
                                 "events_per_step", "event_bytes_per_step")},
            "window_step_ms_median": window[1] if window else None,
            "dispatch_plus_wait_over_decode": (
                (a["dispatch_ms"] + a["wait_ms"]) / a["decode_ms"]
                if a["decode_ms"] else None)}
    if b:
        notes["progtrace_b"] = {k: v for k, v in b.items()
                                if k not in ("attention_ms", "unembed_ms",
                                             "idle_gaps")}
        notes["progtrace_b_idle_gaps"] = b["idle_gaps"]
    notes["obs_on_tokens_equal"] = seg.get("obs_on_tokens_equal")
    return {k: v for k, v in out.items() if v is not None}
