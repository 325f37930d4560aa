"""SLO burn-rate evaluation over the metrics registry (port of
``repro/obs/slo.py``, a stdlib copy; DESIGN.md §14).

An :class:`SloSpec` states an objective over one served-quality surface:

* ``kind="quantile"`` — a latency histogram objective ("TTFT p99 ≤
  250 ms"): the burn rate is the fraction of observations over the
  objective divided by the allowed violation fraction ``1 − q`` (the
  classic error-budget burn: 1.0 means the budget is being consumed
  exactly at its sustainable rate, >1 means it will exhaust).
* ``kind="ratio"`` — a counter-ratio objective ("drop rate ≤ 1%"): burn
  is ``bad/(bad+good)`` divided by the objective.

Evaluation reads a :class:`~repro_torch.obs.metrics.Registry` (by
default the process registry behind the ``repro_torch.obs`` facade), writes the verdicts
back as ``repro_slo_burn_rate{slo=…}`` / ``repro_slo_ok{slo=…}`` gauges
plus one ``slo.evaluate`` instant per spec on the Chrome-trace timeline,
and returns JSON-portable rows — the same records
``launch/summarize.py --metrics`` renders and the bench artifact embeds.
Label matching is by subset: a spec with ``labels={"engine":
"continuous"}`` aggregates every series of the family whose labels
contain that pair.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .metrics import Counter, Histogram, Registry

__all__ = ["SloSpec", "default_slos", "evaluate_slos"]


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One objective; see module docstring for the two kinds."""

    name: str                      # verdict label, e.g. "ttft_p99"
    kind: str                      # "quantile" | "ratio"
    metric: str                    # histogram family (quantile kind) or
    #                                bad-counter family (ratio kind)
    objective: float               # seconds (quantile) / fraction (ratio)
    quantile: float = 0.99         # target percentile (quantile kind)
    good_metric: str = ""          # good-counter family (ratio kind)
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        assert self.kind in ("quantile", "ratio"), self.kind


def default_slos(*, ttft_p99_s: float = 0.5, tpot_p99_s: float = 0.25,
                 drop_rate: float = 0.01,
                 engine: Optional[str] = None) -> List[SloSpec]:
    """The serving objectives every engine already emits metrics for."""
    labels = {} if engine is None else {"engine": engine}
    return [
        SloSpec(name="ttft_p99", kind="quantile",
                metric="repro_serve_ttft_seconds",
                objective=ttft_p99_s, quantile=0.99, labels=labels),
        SloSpec(name="tpot_p99", kind="quantile",
                metric="repro_serve_tpot_seconds",
                objective=tpot_p99_s, quantile=0.99, labels=labels),
        SloSpec(name="drop_rate", kind="ratio",
                metric="repro_serve_dropped_total",
                good_metric="repro_serve_finished_total",
                objective=drop_rate, labels=labels),
    ]


def _matches(m, name: str, labels: Dict[str, str]) -> bool:
    if m.name != name:
        return False
    have = dict(m.key)
    return all(have.get(k) == str(v) for k, v in labels.items())


def _series(reg: Registry, name: str, labels: Dict[str, str]):
    return [m for m in reg.metrics() if _matches(m, name, labels)]


def evaluate_slos(slos: List[SloSpec], reg: Optional[Registry] = None,
                  *, emit: bool = True) -> List[Dict[str, object]]:
    """Evaluate every spec against ``reg`` (default: the live process
    registry); returns one verdict row per spec.

    A spec whose metric family has no observations yet evaluates to
    ``actual=None, burn_rate=0.0, ok=True`` — absence of traffic never
    burns budget.  With ``emit`` (and obs enabled) the verdicts land as
    ``repro_slo_*`` gauges + ``slo.evaluate`` instants.
    """
    from repro_torch import obs                # facade; never cyclic here
    if reg is None:
        reg = obs.registry()
    rows: List[Dict[str, object]] = []
    for spec in slos:
        actual: Optional[float] = None
        burn = 0.0
        if spec.kind == "quantile":
            hists = [m for m in _series(reg, spec.metric, spec.labels)
                     if isinstance(m, Histogram)]
            n_obs = sum(h.count for h in hists)
            if n_obs:
                over = sum(h.fraction_above(spec.objective) * h.count
                           for h in hists) / n_obs
                # pooled nearest-rank quantile across the matched series
                sample = sorted(v for h in hists for v in h.sample())
                idx = min(len(sample) - 1,
                          max(0, round(spec.quantile * (len(sample) - 1))))
                actual = sample[idx]
                budget = max(1.0 - spec.quantile, 1e-9)
                burn = over / budget
        else:
            bad = sum(m.value for m in _series(reg, spec.metric, spec.labels)
                      if isinstance(m, Counter))
            good = sum(m.value
                       for m in _series(reg, spec.good_metric, spec.labels)
                       if isinstance(m, Counter))
            total = bad + good
            if total > 0:
                actual = bad / total
                burn = actual / max(spec.objective, 1e-12)
        ok = burn <= 1.0
        row = {"slo": spec.name, "kind": spec.kind,
               "objective": spec.objective, "actual": actual,
               "burn_rate": burn, "ok": ok}
        rows.append(row)
        if emit and obs.enabled():
            obs.gauge("repro_slo_burn_rate", slo=spec.name).set(burn)
            obs.gauge("repro_slo_ok", slo=spec.name).set(1.0 if ok else 0.0)
            obs.instant("slo.evaluate", slo=spec.name, burn_rate=burn,
                        ok=ok, objective=spec.objective,
                        actual=actual)
    return rows
