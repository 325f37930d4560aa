"""Versioned, diffable ``QuantPlan`` artifact (port of
``repro/plan/artifact.py``, DESIGN.md §10).

A plan is the planner's contract with the executor and the serving stack:
per-matrix target bits (continuous waterfilled optimum), snapped bits
(integer serving grid), payload format (int2/int3/int4/int8), the model
distortion prediction behind the choice, and the sensitivity provenance
that produced it.  After execution the same artifact carries achieved
entropy bits and realized distortion.

The JSON keys, their order (sorted), the entry order (by name) and
``PLAN_SCHEMA_VERSION`` are the reference's, so a plan written by one
package loads in the other and compares equal.  Writes are atomic (tmp +
rename); loaders reject schema versions they do not understand.
"""
from __future__ import annotations

import dataclasses
import json
import os
import uuid
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["PLAN_SCHEMA_VERSION", "PlanEntry", "QuantPlan"]

PLAN_SCHEMA_VERSION = 1


def _parse_layer(name: str) -> int:
    """\"L{l}/...\" → l; −1 for synthetic/unstructured names."""
    if name.startswith("L"):
        head = name.split("/", 1)[0][1:]
        if head.isdigit():
            return int(head)
    return -1


@dataclasses.dataclass
class PlanEntry:
    """One matrix's row of the plan."""

    name: str                     # budget key, e.g. "L3/mlp/w_out"
    out_features: int
    in_features: int
    weight: float                 # linearity-theorem output-error weight
    target_bits: float            # continuous waterfilled optimum
    snapped_bits: float           # integer-grid target (== target if unsnapped)
    payload_bits: int             # serving format: 2 | 3 | 4 | 8
    pred_distortion: float        # model D_l at snapped_bits
    floor_bits: float = 0.0
    ceil_bits: float = 16.0
    provenance: str = ""
    achieved_bits: Optional[float] = None      # filled by the executor
    realized_distortion: Optional[float] = None

    @property
    def n_params(self) -> int:
        return self.out_features * self.in_features

    @property
    def layer(self) -> int:
        return _parse_layer(self.name)

    @property
    def matrix(self) -> str:
        return self.name.split("/", 1)[1] if "/" in self.name else self.name

    @property
    def execution_bits(self) -> float:
        """The rate the executor targets (snapped if snapping ran)."""
        return self.snapped_bits


@dataclasses.dataclass
class QuantPlan:
    """The full model allocation + provenance; see module docstring."""

    budget_bits_per_param: float
    weighting: str
    entries: List[PlanEntry]
    provenance: Dict[str, Any] = dataclasses.field(default_factory=dict)
    budget_overrun: bool = False
    schema_version: int = PLAN_SCHEMA_VERSION

    def __post_init__(self):
        self.entries = sorted(self.entries, key=lambda e: e.name)
        names = [e.name for e in self.entries]
        if len(set(names)) != len(names):
            dup = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate plan entries: {dup}")
        self._by_name = {e.name: e for e in self.entries}

    # -- access -------------------------------------------------------------

    def entry(self, name: str) -> PlanEntry:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __iter__(self) -> Iterator[PlanEntry]:
        return iter(self.entries)

    def names(self) -> List[str]:
        return [e.name for e in self.entries]

    @property
    def n_params_total(self) -> int:
        return sum(e.n_params for e in self.entries)

    def _mean(self, field: str) -> Optional[float]:
        vals = [(getattr(e, field), e.n_params) for e in self.entries]
        if any(v is None for v, _ in vals):
            return None
        tot = sum(n for _, n in vals)
        return sum(v * n for v, n in vals) / max(tot, 1)

    @property
    def planned_bits_per_param(self) -> float:
        return self._mean("snapped_bits")

    @property
    def realized_bits_per_param(self) -> Optional[float]:
        """Param-weighted mean achieved bits (None before execution)."""
        return self._mean("achieved_bits")

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": self.schema_version,
            "budget_bits_per_param": self.budget_bits_per_param,
            "weighting": self.weighting,
            "budget_overrun": self.budget_overrun,
            "provenance": self.provenance,
            "entries": [dataclasses.asdict(e) for e in self.entries],
        }

    def to_json(self) -> str:
        # default=float: numpy scalars serialize as plain numbers instead
        # of raising (they compare equal to the reloaded python floats)
        return json.dumps(self.to_dict(), indent=2, sort_keys=True,
                          default=float)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "QuantPlan":
        ver = d.get("schema_version")
        if ver != PLAN_SCHEMA_VERSION:
            raise ValueError(f"unsupported plan schema_version {ver!r} "
                             f"(this build reads {PLAN_SCHEMA_VERSION})")
        entries = [PlanEntry(**e) for e in d["entries"]]
        return cls(budget_bits_per_param=d["budget_bits_per_param"],
                   weighting=d["weighting"], entries=entries,
                   provenance=dict(d.get("provenance", {})),
                   budget_overrun=bool(d.get("budget_overrun", False)),
                   schema_version=ver)

    @classmethod
    def from_json(cls, s: str) -> "QuantPlan":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        """Atomic write (tmp + rename, the dist/checkpoint.py idiom)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".{os.path.basename(path)}."
                              f"{uuid.uuid4().hex[:8]}.tmp")
        with open(tmp, "w") as f:
            f.write(self.to_json())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "QuantPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- tooling ------------------------------------------------------------

    def diff(self, other: "QuantPlan",
             fields=("snapped_bits", "payload_bits", "target_bits"),
             tol: float = 1e-9) -> List[str]:
        """Semantic per-entry delta vs another plan (for run-to-run drift
        review); one line per difference, empty when equivalent."""
        out: List[str] = []
        mine, theirs = set(self.names()), set(other.names())
        for n in sorted(mine - theirs):
            out.append(f"+ {n} (only in self)")
        for n in sorted(theirs - mine):
            out.append(f"- {n} (only in other)")
        for n in sorted(mine & theirs):
            a, b = self.entry(n), other.entry(n)
            for f in fields:
                va, vb = getattr(a, f), getattr(b, f)
                if abs(float(va) - float(vb)) > tol:
                    out.append(f"~ {n}.{f}: {va} -> {vb}")
        return out

    def per_layer_bits(self) -> Dict[int, float]:
        """layer index → param-weighted mean snapped bits (the allocation
        histogram launch/summarize.py renders)."""
        acc: Dict[int, List[float]] = {}
        for e in self.entries:
            s = acc.setdefault(e.layer, [0.0, 0.0])
            s[0] += e.snapped_bits * e.n_params
            s[1] += e.n_params
        return {l: s[0] / max(s[1], 1) for l, s in sorted(acc.items())}

    def payload_histogram(self) -> Dict[int, int]:
        """payload format → matrix count."""
        out: Dict[int, int] = {}
        for e in self.entries:
            out[e.payload_bits] = out.get(e.payload_bits, 0) + 1
        return dict(sorted(out.items()))
