"""Rate-budget controllers (port of ``repro/core/rate_alloc.py``).

:class:`RateBudget` is the sequential even-spread allocator of paper §4
"Rate assignment" / App. D: the remaining budget is spread evenly
(parameter-count weighted) over the not-yet-quantized matrices.  When its
rate floor binds, the overspend is RECORDED (``budget_overrun`` /
``overrun_bits``), never silently clamped.

The reference's :class:`PlanBudget` drives the same interface from a
``repro.plan.QuantPlan``; the planner is not ported yet, so here it raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

__all__ = ["RateBudget", "PlanBudget", "even_spread_target"]


def even_spread_target(remaining_bits: float, remaining_params: int,
                       *, floor: float = 0.05) -> Tuple[float, bool]:
    """Spread the remaining budget evenly per parameter (the port's copy of
    ``repro/plan/waterfill.even_spread_target``).

    Returns ``(target, floor_bound)``; ``floor_bound`` is True when the
    raw even split fell below ``floor`` and was clamped up.
    """
    if remaining_params <= 0:
        return floor, False
    raw = remaining_bits / remaining_params
    if raw < floor:
        return floor, True
    return raw, False


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


class PlanBudget:
    """Budget view of a ``QuantPlan``: needs the planner (``plan/``)."""

    def __init__(self, plan):
        raise NotImplementedError(
            "PlanBudget needs the global planner (repro_torch.plan), which "
            "is not ported yet (ROADMAP queue A item 8)")
