"""Windowed drift detectors over metric series (port of
``repro/obs/drift.py``, a stdlib copy; DESIGN.md §14).

Deterministic change-point detection for the quality observatory: every
detector is a pure function of the value sequence fed to it — no clock
reads, no global RNG — so the same series of observations produces the
same flags on every run (the property the quality-smoke CI cell relies
on: a chaos ``slow-step`` schedule inflates the step-time series by a
fixed sleep and MUST flag; the clean series must not).

Three detectors, one ``update(x) -> bool`` protocol:

* :class:`PageHinkley` — the Page–Hinkley test for a sustained upward
  (or downward) mean shift.  Thresholds are RELATIVE to the burn-in
  baseline mean so one configuration works across series with different
  units (seconds, ratios, eigenvalue shifts).
* :class:`Cusum` — one-sided cumulative-sum chart with a slack ``k`` and
  decision interval ``h``, both in units of the burn-in baseline.
* :class:`Threshold` — flags any observation above ``limit`` (absolute).
  The degenerate detector for series that should be identically zero,
  e.g. integrity-corruption counter deltas under ``corrupt-payload``
  chaos.

:class:`DriftMonitor` multiplexes named series over detector factories
and keeps the flag log; emission of obs instants/counters is the
caller's job (serve/quality.py) — this module stays import-free of the
rest of the package so the detectors are unit-testable and reusable from
stdlib-only tooling.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

__all__ = ["PageHinkley", "Cusum", "Threshold", "DriftMonitor",
           "DriftFlag"]


class PageHinkley:
    """Page–Hinkley mean-shift test, baseline-relative thresholds.

    After ``burn_in`` samples fix the baseline mean ``b``, maintain the
    running mean ``mu_t`` of ALL samples and the cumulative deviation

        m_t = Σ_{i≤t} (x_i − mu_i − delta·b),    M_t = min_{i≤t} m_i

    and flag when ``m_t − M_t > lam·b`` — a sustained (or single large)
    upward excursion of the series beyond the slack.  ``direction="down"``
    mirrors the test for downward shifts.  Flags repeat while the
    excursion persists unless ``reset_on_flag`` re-arms the statistic.
    """

    def __init__(self, *, delta: float = 0.5, lam: float = 8.0,
                 burn_in: int = 8, direction: str = "up",
                 reset_on_flag: bool = True):
        assert direction in ("up", "down"), direction
        self.delta = float(delta)
        self.lam = float(lam)
        self.burn_in = int(burn_in)
        self.sign = 1.0 if direction == "up" else -1.0
        self.reset_on_flag = reset_on_flag
        self.n = 0
        self.mean = 0.0
        self.base: Optional[float] = None
        self.m = 0.0
        self.m_min = 0.0

    def update(self, x: float) -> bool:
        x = float(x) * self.sign
        self.n += 1
        self.mean += (x - self.mean) / self.n
        if self.n <= self.burn_in:
            if self.n == self.burn_in:
                # scale anchor: |burn-in mean|, floored so an all-zero
                # baseline still yields a usable absolute threshold
                self.base = max(abs(self.mean), 1e-12)
            return False
        assert self.base is not None
        self.m += x - self.mean - self.delta * self.base
        self.m_min = min(self.m_min, self.m)
        if self.m - self.m_min > self.lam * self.base:
            if self.reset_on_flag:
                self.m = self.m_min = 0.0
            return True
        return False


class Cusum:
    """One-sided upper CUSUM: ``S_t = max(0, S_{t-1} + x − b − k·b)``,
    flag when ``S_t > h·b`` (``b`` the burn-in baseline mean)."""

    def __init__(self, *, k: float = 0.5, h: float = 8.0,
                 burn_in: int = 8, reset_on_flag: bool = True):
        self.k = float(k)
        self.h = float(h)
        self.burn_in = int(burn_in)
        self.reset_on_flag = reset_on_flag
        self.n = 0
        self._acc = 0.0
        self.base: Optional[float] = None
        self.s = 0.0

    def update(self, x: float) -> bool:
        x = float(x)
        self.n += 1
        if self.n <= self.burn_in:
            self._acc += x
            if self.n == self.burn_in:
                self.base = max(abs(self._acc / self.burn_in), 1e-12)
            return False
        assert self.base is not None
        self.s = max(0.0, self.s + x - self.base - self.k * self.base)
        if self.s > self.h * self.base:
            if self.reset_on_flag:
                self.s = 0.0
            return True
        return False


class Threshold:
    """Flag every observation strictly above ``limit`` (no burn-in)."""

    def __init__(self, limit: float = 0.0):
        self.limit = float(limit)
        self.n = 0

    def update(self, x: float) -> bool:
        self.n += 1
        return float(x) > self.limit


@dataclasses.dataclass(frozen=True)
class DriftFlag:
    """One detector firing: which series, at which sample index, on
    which observed value."""

    series: str
    index: int          # 1-based sample index within the series
    value: float


class DriftMonitor:
    """Named series → detector instances, flag log kept in order.

    ``detectors`` maps a series name to a zero-arg factory; unknown
    series fall back to ``default`` (Page–Hinkley) so callers can feed
    ad-hoc series without pre-registration.
    """

    def __init__(self,
                 detectors: Optional[Dict[str, Callable[[], object]]] = None,
                 default: Callable[[], object] = PageHinkley):
        self._factories = dict(detectors or {})
        self._default = default
        self._live: Dict[str, object] = {}
        self.flags: List[DriftFlag] = []

    def detector(self, series: str):
        d = self._live.get(series)
        if d is None:
            d = self._factories.get(series, self._default)()
            self._live[series] = d
        return d

    def reset(self, series: str) -> None:
        """Drop a series' live detector; the next observation re-creates
        it fresh — re-arming burn-in at a new operating point (e.g.
        after a requant actuation re-anchors the divergence reference)."""
        self._live.pop(series, None)

    def observe(self, series: str, value: float) -> bool:
        """Feed one sample; True (and a logged flag) on detection."""
        d = self.detector(series)
        fired = bool(d.update(value))
        if fired:
            self.flags.append(DriftFlag(series=series, index=d.n,
                                        value=float(value)))
        return fired

    def flags_since(self, index: int, *,
                    prefix: Optional[str] = None) -> List[DriftFlag]:
        """Flags logged at or after flag-log position ``index`` (a cursor
        into ``self.flags``, NOT a sample index), optionally restricted
        to series whose name starts with ``prefix``.  The requant
        actuator polls this with a persistent cursor so each flag is
        consumed exactly once."""
        out = self.flags[index:]
        if prefix is not None:
            out = [f for f in out if f.series.startswith(prefix)]
        return list(out)

    def flagged(self, series: Optional[str] = None) -> List[DriftFlag]:
        if series is None:
            return list(self.flags)
        return [f for f in self.flags if f.series == series]

    def summary(self) -> Dict[str, object]:
        """JSON-portable verdicts (the bench artifact embeds this)."""
        series: Dict[str, int] = {}
        for f in self.flags:
            series[f.series] = series.get(f.series, 0) + 1
        return {"n_flags": len(self.flags),
                "series": dict(sorted(series.items())),
                "flags": [dataclasses.asdict(f) for f in self.flags]}
