"""repro_torch.obs — tracing, metrics and timeline export (port of
``repro/obs/__init__.py``, DESIGN.md §11).

One process-wide tracer + metrics registry behind a module facade, OFF
by default: every instrumentation site in the serving engines, the plan
executor and the dequant dispatch goes through these helpers, and when
disabled each helper is a boolean check returning a shared no-op
singleton, so the engines' token streams, dispatch counts and stats are
the same with the subsystem off (tests/test_torch_obs.py).

Enable with ``REPRO_OBS=1`` in the environment or :func:`enable` in
code (the ``--trace-out``/``--metrics-out``/``--events-out`` flags of
``launch/serve.py`` do the latter).  Three export surfaces:

* :func:`write_trace` — Chrome trace-event JSON (Perfetto-loadable
  timeline: per-slot serving lanes, per-task executor spans);
* :func:`write_prometheus` — Prometheus text exposition of every
  counter/gauge/histogram;
* :func:`write_jsonl` — one JSON object per time series, the offline
  event log ``launch/summarize.py --metrics`` renders.

Metric families are the reference's: ``repro_serve_*`` (engine
lifecycle: TTFT/TPOT histograms, slot/queue gauges, admission/eviction
counters), ``repro_plan_*`` (executor tasks/retries/stragglers) and
``repro_kernel_*`` (dequant dispatch + modeled HBM weight traffic,
reconciled against ``benchmarks/check_bytes.py``'s accounting by
``benchmarks/check_obs.py``).  The quality half of the reference's
``obs`` (``drift``, ``slo``, ``streamsig``) comes with ``serve/quality``.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict

from .metrics import Counter, Gauge, Histogram, Registry
from .trace import NULL_SPAN, Tracer

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "Tracer",
           "enabled", "enable", "disable", "reset", "registry", "tracer",
           "scoped",
           "span", "complete", "instant", "counter", "gauge", "histogram",
           "counters_snapshot", "prometheus_text", "jsonl_lines",
           "write_trace", "write_prometheus", "write_jsonl"]

_enabled: bool = os.environ.get("REPRO_OBS", "0").lower() \
    not in ("0", "", "false", "off")
_registry = Registry()
_tracer = Tracer()


class _NullMetric:
    """Accepts every instrument method as a no-op (the disabled path)."""

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None: ...

    def add(self, amount: float = 1.0) -> None: ...

    def set(self, value: float) -> None: ...

    def observe(self, value: float) -> None: ...


_NULL_METRIC = _NullMetric()


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Fresh registry + tracer (test isolation / per-run scoping)."""
    global _registry, _tracer
    _registry = Registry()
    _tracer = Tracer()


def registry() -> Registry:
    return _registry


def tracer() -> Tracer:
    return _tracer


@contextlib.contextmanager
def scoped(*, enable_obs: bool = False):
    """Swap in a fresh registry + tracer for the body, restore on exit.

    An isolated measurement scope: a benchmark section that must not
    pollute the surrounding run's counters (e.g. serve_bench's quality
    cells run obs-enabled even when the ladder runs obs-off, and the
    obs-smoke gate's EXACT HBM reconciliation would otherwise see their
    traffic).  The enabled flag is saved/restored too; ``enable_obs``
    turns recording on inside the scope.  Yields ``(registry, tracer)``.
    """
    global _registry, _tracer, _enabled
    saved = (_registry, _tracer, _enabled)
    _registry, _tracer = Registry(), Tracer()
    if enable_obs:
        _enabled = True
    try:
        yield _registry, _tracer
    finally:
        _registry, _tracer, _enabled = saved


# -- recording facade (each helper no-ops when disabled) --------------------


def span(name: str, **args):
    """``with obs.span("serve.prefill", slot=3): …`` — times the body."""
    return _tracer.span(name, **args) if _enabled else NULL_SPAN


def complete(name: str, t0_s: float, t1_s: float, **args) -> None:
    """Adopt an existing perf_counter stamp pair as a complete span."""
    if _enabled:
        _tracer.complete(name, t0_s, t1_s, **args)


def instant(name: str, **args) -> None:
    if _enabled:
        _tracer.instant(name, **args)


def counter(name: str, **labels):
    return _registry.counter(name, **labels) if _enabled else _NULL_METRIC


def gauge(name: str, **labels):
    return _registry.gauge(name, **labels) if _enabled else _NULL_METRIC


def histogram(name: str, **labels):
    return _registry.histogram(name, **labels) if _enabled else _NULL_METRIC


# -- export surfaces --------------------------------------------------------


def counters_snapshot(prefix: str = "") -> Dict[str, float]:
    return _registry.counters_snapshot(prefix)


def prometheus_text() -> str:
    return _registry.to_prometheus()


def jsonl_lines():
    return _registry.jsonl_lines()


def write_trace(path: str) -> None:
    _tracer.write(path)


def write_prometheus(path: str) -> None:
    with open(path, "w") as f:
        f.write(_registry.to_prometheus())


def write_jsonl(path: str) -> None:
    _registry.dump_jsonl(path)
