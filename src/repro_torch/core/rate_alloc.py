"""Rate-budget controllers (port of ``repro/core/rate_alloc.py``).

The model-level bit allocation lives in ``repro_torch.plan``, the global
waterfilling planner; this module keeps two controllers with one
``next_target`` / ``record`` interface, so ``quant.pipeline.quantize_model``
runs either through one code path:

* :class:`RateBudget` — the sequential even-spread allocator of paper §4
  "Rate assignment" / App. D: the remaining budget spread evenly
  (parameter-count weighted) over the not-yet-quantized matrices, through
  :func:`repro_torch.plan.waterfill.even_spread_target`.  When its rate
  floor binds, the overspend is RECORDED (``budget_overrun`` /
  ``overrun_bits``), never silently clamped.
* :class:`PlanBudget` — the same interface driven by a
  :class:`repro_torch.plan.QuantPlan`: per-matrix targets from the plan,
  achieved bits written back into its entries.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

__all__ = ["RateBudget", "PlanBudget"]


@dataclass
class RateBudget:
    target_bits_per_param: float
    layer_params: Dict[str, int]                 # name -> a*n
    spent_bits: float = 0.0
    floor_bits: float = 0.05                     # per-matrix rate floor
    done: Dict[str, float] = field(default_factory=dict)  # name -> achieved
    budget_overrun: bool = False                 # floor forced an overspend
    overrun_bits: float = 0.0                    # projected excess, in bits

    @property
    def total_params(self) -> int:
        return sum(self.layer_params.values())

    @property
    def total_budget_bits(self) -> float:
        return self.target_bits_per_param * self.total_params

    @property
    def remaining_params(self) -> int:
        return sum(p for k, p in self.layer_params.items()
                   if k not in self.done)

    def next_target(self, name: str) -> float:
        """Bits/param target for ``name``: remaining budget spread evenly;
        a binding floor is recorded as a budget overrun."""
        from repro_torch.plan.waterfill import even_spread_target
        if name in self.done:
            raise KeyError(f"layer {name} already quantized")
        rem_params = self.remaining_params
        if rem_params <= 0:
            return self.target_bits_per_param
        remaining_bits = self.total_budget_bits - self.spent_bits
        target, floor_bound = even_spread_target(
            remaining_bits, rem_params, floor=self.floor_bits)
        if floor_bound:
            self.budget_overrun = True
            self.overrun_bits = max(
                self.overrun_bits,
                self.floor_bits * rem_params - remaining_bits)
        return target

    def record(self, name: str, achieved_bits_per_param: float) -> None:
        params = self.layer_params[name]
        self.spent_bits += achieved_bits_per_param * params
        self.done[name] = achieved_bits_per_param

    @property
    def realized_rate(self) -> float:
        """Parameter-count-weighted average of achieved per-layer rates."""
        if not self.done:
            return 0.0
        num = sum(r * self.layer_params[k] for k, r in self.done.items())
        den = sum(self.layer_params[k] for k in self.done)
        return num / den

    def summary(self) -> List[str]:
        lines = [f"target={self.target_bits_per_param:.3f} bits/param, "
                 f"realized={self.realized_rate:.3f}"]
        if self.budget_overrun:
            lines[0] += (f"  [BUDGET OVERRUN: floor {self.floor_bits} "
                         f"bound, ≥{self.overrun_bits:.1f} bits over]")
        for k, r in self.done.items():
            lines.append(f"  {k}: {r:.3f} bits ({self.layer_params[k]} params)")
        return lines


@dataclass
class PlanBudget:
    """`RateBudget`-shaped view of a :class:`repro_torch.plan.QuantPlan`.

    ``next_target`` returns the plan's snapped per-matrix bits instead of
    the even spread; ``record`` writes achieved entropy back into the plan
    entry, so the executed artifact documents plan→realized drift.
    """

    plan: Any                                     # repro_torch.plan.QuantPlan
    spent_bits: float = 0.0
    done: Dict[str, float] = field(default_factory=dict)

    @property
    def target_bits_per_param(self) -> float:
        return self.plan.budget_bits_per_param

    @property
    def layer_params(self) -> Dict[str, int]:
        return {e.name: e.n_params for e in self.plan}

    @property
    def total_params(self) -> int:
        return self.plan.n_params_total

    @property
    def budget_overrun(self) -> bool:
        return bool(self.plan.budget_overrun)

    def next_target(self, name: str) -> float:
        if name in self.done:
            raise KeyError(f"layer {name} already quantized")
        if name not in self.plan:
            raise KeyError(
                f"matrix {name!r} has no plan entry — the plan was built "
                "for a different model (names must match the budget keys)")
        return float(self.plan.entry(name).execution_bits)

    def record(self, name: str, achieved_bits_per_param: float) -> None:
        self.done[name] = achieved_bits_per_param
        self.spent_bits += achieved_bits_per_param \
            * self.plan.entry(name).n_params
        self.plan.entry(name).achieved_bits = float(achieved_bits_per_param)

    @property
    def realized_rate(self) -> float:
        if not self.done:
            return 0.0
        lp = self.layer_params
        num = sum(r * lp[k] for k, r in self.done.items())
        den = sum(lp[k] for k in self.done)
        return num / den

    def summary(self) -> List[str]:
        lines = [f"plan budget={self.target_bits_per_param:.3f} bits/param "
                 f"({self.plan.weighting}), realized={self.realized_rate:.3f}"]
        for k, r in self.done.items():
            lines.append(f"  {k}: {r:.3f} bits "
                         f"(plan {self.plan.entry(k).execution_bits:.3f})")
        return lines
