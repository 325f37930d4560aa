"""Metrics registry: counters, gauges, streaming histograms (port of
``repro/obs/metrics.py``, DESIGN.md §11; a stdlib copy, so the same
updates give the same Prometheus text and JSONL as the reference).

Dependency-free (stdlib only) so ops tooling — and the CI schema gate,
benchmarks/check_obs.py — can consume the outputs without torch.
Three instrument kinds behind one :class:`Registry`:

* :class:`Counter` — monotone float accumulator.  Names follow the
  Prometheus convention and MUST end in ``_total``; the exposition
  declares them ``# TYPE … counter``.
* :class:`Gauge` — last-write-wins level (queue depth, active slots).
* :class:`Histogram` — streaming quantile sketch: the first
  ``exact_max`` observations are kept exactly (small runs — the common
  benchmarking case — get EXACT p50/p99), after which Vitter's
  reservoir (Algorithm R, deterministic per-instrument seed) keeps a
  uniform sample.  ``count``/``sum``/``min``/``max`` stay exact at any
  volume.  Exported as a Prometheus ``summary`` family.

Label sets are part of a metric's identity: ``counter("x_total",
format="int8")`` and ``format="packed-int4"`` are two time series of one
family.  Every instrument carries its own lock — ``float +=`` is not
atomic under the GIL — so the serving engines and the plan executor's
worker threads can feed one registry concurrently.

Two export formats (the offline halves of the obs pillar):

* :meth:`Registry.to_prometheus` — text exposition (``# TYPE`` headers,
  escaped label values, ``_sum``/``_count``/``quantile=`` series for
  histograms) that any Prometheus scraper or promtool ingests.
* :meth:`Registry.jsonl_lines` — one self-describing JSON object per
  time series, the diffable event log ``launch/summarize.py --metrics``
  renders offline.
"""
from __future__ import annotations

import json
import random
import threading
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry"]

LabelKey = Tuple[Tuple[str, str], ...]

#: exact-mode capacity before a histogram falls back to reservoir sampling
EXACT_MAX = 2048


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key: LabelKey, extra: Tuple[Tuple[str, str], ...] = ()
                ) -> str:
    items = key + extra
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items) + "}"


class Counter:
    """Monotone accumulator; ``inc`` with a negative amount raises."""

    kind = "counter"

    def __init__(self, name: str, key: LabelKey):
        self.name = name
        self.key = key
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self.value += amount


class Gauge:
    """Last-write-wins level; ``add`` for relative moves."""

    kind = "gauge"

    def __init__(self, name: str, key: LabelKey):
        self.name = name
        self.key = key
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def add(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Histogram:
    """Exact-then-reservoir streaming quantiles (module docstring).

    The reservoir RNG is seeded from the metric identity (crc32 of
    name+labels), never from global state, so a run's quantiles are
    reproducible bit-for-bit — the JSONL logs of two identical runs diff
    clean.
    """

    kind = "histogram"

    def __init__(self, name: str, key: LabelKey,
                 exact_max: int = EXACT_MAX):
        self.name = name
        self.key = key
        self.exact_max = exact_max
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._sample: List[float] = []
        seed = zlib.crc32(repr((name, key)).encode())
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if len(self._sample) < self.exact_max:
                self._sample.append(v)
            else:  # Algorithm R: keep a uniform sample of the stream
                j = self._rng.randrange(self.count)
                if j < self.exact_max:
                    self._sample[j] = v

    @property
    def exact(self) -> bool:
        """True while every observation is still in the sample buffer."""
        return self.count <= self.exact_max

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile over the (exact or reservoir) sample."""
        with self._lock:
            if not self._sample:
                return None
            s = sorted(self._sample)
        idx = min(len(s) - 1, max(0, round(q * (len(s) - 1))))
        return s[idx]

    def sample(self) -> List[float]:
        """Copy of the current (exact or reservoir) sample buffer."""
        with self._lock:
            return list(self._sample)

    def fraction_above(self, threshold: float) -> float:
        """Estimated fraction of observations strictly above ``threshold``
        (exact while in exact mode; reservoir-unbiased after).  0.0 on an
        empty histogram — no traffic violates no objective (the SLO
        burn-rate convention, obs/slo.py)."""
        with self._lock:
            if not self._sample:
                return 0.0
            over = sum(1 for v in self._sample if v > threshold)
            return over / len(self._sample)

    def summary(self, quantiles=(0.5, 0.9, 0.99)) -> Dict[str, object]:
        return {
            "count": self.count, "sum": self.sum,
            "min": self.min, "max": self.max, "exact": self.exact,
            "quantiles": {f"{q:g}": self.quantile(q) for q in quantiles},
        }


class Registry:
    """Name+labels → instrument; get-or-create, kind-checked."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, LabelKey], object] = {}
        self._lock = threading.RLock()

    def _get(self, cls, name: str, labels: Dict[str, object]):
        if cls is Counter and not name.endswith("_total"):
            raise ValueError(
                f"counter {name!r} must end in '_total' (DESIGN.md §11 "
                "naming scheme)")
        key = _label_key(labels)
        with self._lock:
            m = self._metrics.get((name, key))
            if m is None:
                m = cls(name, key)
                self._metrics[(name, key)] = m
            elif not isinstance(m, cls):
                raise TypeError(f"{name} already registered as {m.kind}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def metrics(self) -> List[object]:
        with self._lock:
            return [m for _, m in sorted(self._metrics.items())]

    def counters_snapshot(self, prefix: str = "") -> Dict[str, float]:
        """counter/gauge values keyed ``name{labels}`` — benchmark drivers
        snapshot before/after a run to attribute deltas to that run."""
        out: Dict[str, float] = {}
        for m in self.metrics():
            if isinstance(m, (Counter, Gauge)) and m.name.startswith(prefix):
                out[m.name + _fmt_labels(m.key)] = m.value
        return out

    # -- exporters ----------------------------------------------------------

    def to_prometheus(self) -> str:
        """Prometheus text exposition, families sorted, one TYPE header
        per family (counter/gauge/summary)."""
        families: Dict[str, List[object]] = {}
        for m in self.metrics():
            families.setdefault(m.name, []).append(m)
        lines: List[str] = []
        for name in sorted(families):
            group = families[name]
            kind = group[0].kind
            lines.append(f"# TYPE {name} "
                         f"{'summary' if kind == 'histogram' else kind}")
            for m in group:
                if isinstance(m, (Counter, Gauge)):
                    lines.append(f"{name}{_fmt_labels(m.key)} {m.value:g}")
                    continue
                for q in (0.5, 0.9, 0.99):
                    v = m.quantile(q)
                    if v is None:
                        continue
                    lines.append(
                        f"{name}"
                        f"{_fmt_labels(m.key, (('quantile', f'{q:g}'),))}"
                        f" {v:g}")
                lines.append(f"{name}_sum{_fmt_labels(m.key)} {m.sum:g}")
                lines.append(f"{name}_count{_fmt_labels(m.key)} {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def jsonl_lines(self) -> Iterable[str]:
        """One JSON object per time series (the offline-diff event log)."""
        for m in self.metrics():
            rec: Dict[str, object] = {"kind": m.kind, "name": m.name,
                                      "labels": dict(m.key)}
            if isinstance(m, (Counter, Gauge)):
                rec["value"] = m.value
            else:
                rec.update(m.summary())
            yield json.dumps(rec, sort_keys=True)

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for line in self.jsonl_lines():
                f.write(line + "\n")
