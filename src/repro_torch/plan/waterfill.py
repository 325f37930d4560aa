"""Outer waterfilling: the global bit allocation across layers (port of
``repro/plan/waterfill.py``, DESIGN.md §10).

Solves

    R* = argmin Σ_l w_l · N_l · D_l(R_l)
         s.t.   Σ_l N_l · R_l ≤ B · Σ_l N_l,
                floor_l ≤ R_l ≤ ceil_l,

where D_l is the exact reverse-waterfilling curve of layer l's calibration
spectrum (plan/sensitivity.py) and N_l its parameter count.  With the
inner curve's marginal dD_l/dR = −2·ln2·τ_l, stationarity gives

    τ_l = θ / (2·ln2·w_l)                                     (‡)

so ``waterfill_bits`` bisects on the one global level θ, clips to the
floor/ceiling box and hands the residual budget to the unclamped layers.
``snap_bits`` maps the continuous optimum onto the serving grid
(2/3/4/8-bit payloads) with greedy marginal-gain moves that never exceed
the budget; ``even_spread_target`` is the even-split heuristic
``core.rate_alloc.RateBudget`` delegates to.

Float64 numpy throughout, the reference's arithmetic line for line, so
both packages give the same plan from the same sensitivities.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from .sensitivity import (MatrixSensitivity, distortion_at_rate,
                          level_at_rate, rate_at_level)

__all__ = [
    "SERVING_FORMATS",
    "even_spread_target",
    "waterfill_bits",
    "allocation_distortion",
    "snap_bits",
    "payload_bits_for",
    "build_plan",
    "even_plan",
    "rewaterfill_subset",
]

#: integer target-bit grid the serving formats realize.  Every rung has a
#: real payload (int2/int3/int4/int8 — core/packing + kernels/dequant), so
#: snapped targets map 1:1 onto served HBM bytes (DESIGN §8).
SERVING_FORMATS: Tuple[int, ...] = (2, 3, 4, 8)


def even_spread_target(remaining_bits: float, remaining_params: int,
                       *, floor: float = 0.05) -> Tuple[float, bool]:
    """Legacy even-split: spread the remaining budget evenly per parameter.

    Returns ``(target, floor_bound)`` — ``floor_bound`` is True when the
    raw even split fell below ``floor`` and was clamped up, i.e. the caller
    is about to OVERSPEND the budget by (floor − raw)·params, which
    RateBudget records as a budget overrun.
    """
    if remaining_params <= 0:
        return floor, False
    raw = remaining_bits / remaining_params
    if raw < floor:
        return floor, True
    return raw, False


def _identical(sens: Sequence[MatrixSensitivity]) -> bool:
    s0 = sens[0]
    for s in sens[1:]:
        if (s.sigma_w2 != s0.sigma_w2 or s.weight != s0.weight
                or s.lambdas.shape != s0.lambdas.shape
                or not np.array_equal(s.lambdas, s0.lambdas)):
            return False
    return True


def waterfill_bits(sens: Sequence[MatrixSensitivity],
                   budget_bits_per_param: float, *,
                   tol: float = 1e-13, max_iter: int = 200) -> np.ndarray:
    """Continuous optimal allocation R* (bits/weight per layer).

    Bisects on the outer water level θ using (‡); exact for the reverse-
    waterfilling curves (no high-rate approximation).  Raises if the
    floors alone exceed the budget; returns the ceilings if even they
    underspend it.
    """
    sens = list(sens)
    if not sens:
        return np.zeros(0)
    B = float(budget_bits_per_param)
    n = np.array([s.n_params for s in sens], np.float64)
    floors = np.array([s.floor_bits for s in sens], np.float64)
    ceils = np.array([s.ceil_bits for s in sens], np.float64)
    if np.any(floors > ceils):
        raise ValueError("floor > ceiling for some layer")
    total = float(n.sum())
    budget = B * total
    if float(n @ floors) > budget * (1 + 1e-12):
        raise ValueError(
            f"infeasible: floors alone need {float(n @ floors) / total:.4f} "
            f"bits/param > budget {B:.4f}")
    if float(n @ ceils) <= budget:
        return ceils.copy()

    # degenerate uniform collapse: identical curves and weights, box admits
    # the even split → the even split is exactly optimal (and this keeps
    # the uniform==RateBudget property test bit-exact, no bisection noise)
    if (_identical(sens) and np.all(floors <= B) and np.all(ceils >= B)):
        return np.full(len(sens), B)

    spectra = [s.spectrum for s in sens]
    w = np.array([s.weight for s in sens], np.float64)
    if np.any(w <= 0):
        raise ValueError("sensitivity weights must be positive")

    def rates_at(theta: float) -> np.ndarray:
        r = np.array([rate_at_level(spectra[i], theta / (2 * math.log(2)
                                                         * w[i]))
                      for i in range(len(sens))])
        return np.clip(r, floors, ceils)

    # bracket: θ_hi drives every unclipped rate to 0 (all floors);
    # θ_lo drives every layer to its ceiling
    theta_hi = max(2 * math.log(2) * w[i] * float(spectra[i].max())
                   for i in range(len(sens))) * (1 + 1e-9)
    theta_lo = min(2 * math.log(2) * w[i]
                   * level_at_rate(spectra[i], float(ceils[i]))
                   for i in range(len(sens)))
    theta_lo = max(theta_lo * (1 - 1e-9), 1e-300)
    for _ in range(max_iter):
        mid = math.sqrt(theta_lo * theta_hi) if theta_lo > 0 \
            else 0.5 * (theta_lo + theta_hi)
        if float(n @ rates_at(mid)) > budget:
            theta_lo = mid          # spending too much → raise the level
        else:
            theta_hi = mid
        if theta_hi - theta_lo < tol * theta_hi:
            break
    bits = rates_at(theta_hi)
    # residual-budget repair: hand the bisection slack to the unclamped
    # layers (uniform per-param share keeps the KKT balance to first order)
    free = (bits > floors + 1e-12) & (bits < ceils - 1e-12)
    slack = budget - float(n @ bits)
    if np.any(free) and slack > 0:
        bits[free] += slack / float(n[free].sum())
        bits = np.clip(bits, floors, ceils)
    return bits


def allocation_distortion(sens: Sequence[MatrixSensitivity],
                          bits: Sequence[float]) -> float:
    """The planner objective Σ_l w_l · N_l · D_l(R_l) at an allocation."""
    return float(sum(s.weight * s.n_params * distortion_at_rate(s, float(b))
                     for s, b in zip(sens, bits)))


def payload_bits_for(target_bits: float) -> int:
    """Smallest serving payload format that carries a target rate: int2
    planar (targets ≤ 2), int3 bit-plane (≤ 3), packed int4 (≤ 4), int8
    otherwise.  Out-of-range codes always have the escape-COO path, so the
    payload only needs to cover the *typical* code range."""
    if target_bits <= 2.0:
        return 2
    if target_bits <= 3.0:
        return 3
    if target_bits <= 4.0:
        return 4
    return 8


def snap_bits(sens: Sequence[MatrixSensitivity], bits: Sequence[float], *,
              budget_bits_per_param: float,
              formats: Sequence[int] = SERVING_FORMATS
              ) -> Tuple[np.ndarray, bool]:
    """Snap a continuous allocation onto the integer serving grid.

    Each layer starts at the largest admissible format ≤ its continuous
    R_l (or the smallest admissible format when R_l sits below the grid).
    If that start overspends (low-rate layers forced up to the grid
    minimum), layers are first greedily DOWNGRADED in order of least
    weighted-distortion increase per bit saved; then any remaining budget
    is spent greedily upgrading in order of weighted-distortion reduction
    per budget bit.  Returns ``(snapped_bits, overrun)`` — overrun is True
    only when even the all-minimum grid exceeds the budget (recorded,
    never silent).
    """
    sens = list(sens)
    bits = np.asarray(bits, np.float64)
    n = np.array([s.n_params for s in sens], np.float64)
    budget = float(budget_bits_per_param) * float(n.sum())

    cands: List[List[float]] = []
    for s in sens:
        c = [float(f) for f in sorted(formats)
             if s.floor_bits <= f <= s.ceil_bits]
        if not c:
            raise ValueError(
                f"{s.name}: no serving format within "
                f"[{s.floor_bits}, {s.ceil_bits}] of {tuple(formats)}")
        cands.append(c)
    idx = []
    for c, b in zip(cands, bits):
        at_most = [j for j, f in enumerate(c) if f <= b + 1e-12]
        idx.append(at_most[-1] if at_most else 0)
    snapped = np.array([c[j] for c, j in zip(cands, idx)])
    spent = float(n @ snapped)

    dcache = {}

    def dist(i, b):
        if (i, b) not in dcache:
            dcache[(i, b)] = distortion_at_rate(sens[i], b)
        return dcache[(i, b)]

    # downgrade phase: shed the cheapest weighted distortion per bit saved
    # until the budget holds (or everyone sits at the grid minimum)
    while spent > budget * (1 + 1e-12):
        best, best_loss = None, None
        for i, (c, j) in enumerate(zip(cands, idx)):
            if j == 0:
                continue
            saved = n[i] * (c[j] - c[j - 1])
            loss = sens[i].weight * n[i] * (dist(i, c[j - 1]) - dist(i, c[j]))
            ratio = loss / saved
            if best is None or ratio < best_loss:
                best, best_loss = i, ratio
        if best is None:
            break                      # all at grid minimum: genuine overrun
        idx[best] -= 1
        spent -= n[best] * (cands[best][idx[best] + 1]
                            - cands[best][idx[best]])
        snapped[best] = cands[best][idx[best]]
    overrun = spent > budget * (1 + 1e-12)

    while True:
        best, best_ratio = None, 0.0
        for i, (c, j) in enumerate(zip(cands, idx)):
            if j + 1 >= len(c):
                continue
            cost = n[i] * (c[j + 1] - c[j])
            if spent + cost > budget * (1 + 1e-12):
                continue
            gain = sens[i].weight * n[i] * (dist(i, c[j]) - dist(i, c[j + 1]))
            ratio = gain / cost
            if ratio > best_ratio:
                best, best_ratio = i, ratio
        if best is None:
            break
        idx[best] += 1
        spent += n[best] * (cands[best][idx[best]] - cands[best][idx[best] - 1])
        snapped[best] = cands[best][idx[best]]
    return snapped, overrun


# ---------------------------------------------------------------------------
# Plan construction (continuous waterfill → snap → artifact)
# ---------------------------------------------------------------------------


def _make_plan(sens, bits, payloads, budget, *, weighting, snap_overrun,
               provenance):
    from .artifact import PlanEntry, QuantPlan
    entries = []
    for s, b, p in zip(sens, bits, payloads):
        entries.append(PlanEntry(
            name=s.name, out_features=int(s.out_features),
            in_features=int(s.in_features), weight=float(s.weight),
            target_bits=float(b), snapped_bits=float(b),
            payload_bits=int(p),
            pred_distortion=float(distortion_at_rate(s, float(b))),
            floor_bits=float(s.floor_bits), ceil_bits=float(s.ceil_bits),
            provenance=s.provenance))
    return QuantPlan(budget_bits_per_param=float(budget),
                     weighting=weighting, entries=entries,
                     provenance=dict(provenance or {}),
                     budget_overrun=bool(snap_overrun))


def build_plan(sens: Sequence[MatrixSensitivity],
               budget_bits_per_param: float, *, snap: bool = True,
               formats: Sequence[int] = SERVING_FORMATS,
               weighting: str = "unknown", provenance=None):
    """Waterfill (+ optional integer snapping) → :class:`QuantPlan`."""
    sens = list(sens)
    cont = waterfill_bits(sens, budget_bits_per_param)
    overrun = False
    if snap:
        bits, overrun = snap_bits(sens, cont,
                                  budget_bits_per_param=budget_bits_per_param,
                                  formats=formats)
    else:
        bits = cont
    payloads = [payload_bits_for(float(b)) for b in bits]
    plan = _make_plan(sens, bits, payloads, budget_bits_per_param,
                      weighting=weighting, snap_overrun=overrun,
                      provenance=provenance)
    for e, c in zip(plan.entries, sorted(zip([s.name for s in sens], cont))):
        assert e.name == c[0]
        e.target_bits = float(c[1])
    return plan


def rewaterfill_subset(plan, new_sens: Sequence[MatrixSensitivity], *,
                       formats: Sequence[int] = SERVING_FORMATS):
    """Partial re-solve: refresh a subset's allocation, budget held fixed.

    ``new_sens`` carries refreshed distortion-rate curves (streamed-Σ)
    for the drifted matrices; every name must already be in ``plan``.
    Unaffected entries keep their snapped allocation (and any achieved/
    realized execution fields) verbatim; the subset is waterfilled over
    the RESIDUAL budget — the global bit budget minus what the
    unaffected entries already spend — so the model total never grows.
    When the subset is the whole plan this degenerates to
    :func:`build_plan` and yields identical allocations.

    Returns ``(new_plan, overrun)`` — a fresh :class:`QuantPlan` (the
    input plan is not mutated) and the snap-overrun flag for the subset.
    """
    import dataclasses as _dc

    from .artifact import PlanEntry, QuantPlan
    new_sens = list(new_sens)
    names = [s.name for s in new_sens]
    if len(set(names)) != len(names):
        raise ValueError("duplicate names in new_sens")
    unknown = sorted(n for n in names if n not in plan)
    if unknown:
        raise KeyError(f"new_sens names not in plan: {unknown[:5]}"
                       f"{'...' if len(unknown) > 5 else ''}")
    affected = set(names)
    n_total = plan.n_params_total
    budget_total = plan.budget_bits_per_param * n_total
    kept = [e for e in plan.entries if e.name not in affected]
    spent_kept = sum(e.snapped_bits * e.n_params for e in kept)
    sub_params = sum(s.n_params for s in new_sens)
    if sub_params <= 0:
        raise ValueError("empty subset")
    sub_budget = max(budget_total - spent_kept, 0.0) / sub_params
    cont = waterfill_bits(new_sens, sub_budget)
    snapped, overrun = snap_bits(new_sens, cont,
                                 budget_bits_per_param=sub_budget,
                                 formats=formats)
    entries = [_dc.replace(e) for e in kept]
    for s, c, b in zip(new_sens, cont, snapped):
        entries.append(PlanEntry(
            name=s.name, out_features=int(s.out_features),
            in_features=int(s.in_features), weight=float(s.weight),
            target_bits=float(c), snapped_bits=float(b),
            payload_bits=payload_bits_for(float(b)),
            pred_distortion=float(distortion_at_rate(s, float(b))),
            floor_bits=float(s.floor_bits), ceil_bits=float(s.ceil_bits),
            provenance=s.provenance))
    prov = dict(plan.provenance)
    prov["requant"] = {"affected": sorted(affected),
                       "sub_budget_bits_per_param": float(sub_budget)}
    new_plan = QuantPlan(
        budget_bits_per_param=float(plan.budget_bits_per_param),
        weighting=plan.weighting, entries=entries, provenance=prov,
        budget_overrun=bool(plan.budget_overrun or overrun))
    return new_plan, overrun


def even_plan(sens: Sequence[MatrixSensitivity],
              budget_bits_per_param: float, *, provenance=None):
    """The even-spread baseline in plan form: every matrix gets exactly the
    global budget (what `RateBudget` targets when every layer achieves its
    target) — the differential oracle a waterfilled plan is compared with."""
    sens = list(sens)
    bits = np.full(len(sens), float(budget_bits_per_param))
    bits = np.clip(bits, [s.floor_bits for s in sens],
                   [s.ceil_bits for s in sens])
    payloads = [payload_bits_for(float(b)) for b in bits]
    return _make_plan(sens, bits, payloads, budget_bits_per_param,
                      weighting="even-spread", snap_overrun=False,
                      provenance=provenance)
