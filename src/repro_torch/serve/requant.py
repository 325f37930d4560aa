"""Live requantization under traffic drift (port of
``repro/serve/requant.py``, DESIGN.md §15).

The quality observatory (§14) streams Welford Σ_X per matrix from live
activations and runs drift detectors over the divergence series; this
module closes the sense→decide→act loop.  :class:`RequantActuator`
binds a :class:`~repro_torch.serve.quality.QualityMonitor` to a running
engine and, when a ``sigma_fro:*`` drift flag fires:

1. **snapshot** — freezes the flagged taps' live ``SigmaTracker`` state
   into immutable :class:`SigmaSnapshot` records (the whole actuation —
   and any chaos-retried replay of it — is a pure function of these);
2. **partial re-solve** — re-derives the affected matrices' distortion-
   rate curves from the streamed Σ
   (``plan.sensitivity.sensitivity_from_streamed``) and re-waterfills
   them over the residual budget with the global bit budget held fixed
   (``plan.waterfill.rewaterfill_subset``);
3. **incremental execute** — runs ONLY the changed matrices through the
   parallel plan executor (``plan.executor.execute_plan(subset=...)``),
   whose ``plan.task`` spans land on the live serving timeline, filling
   achieved/realized fields on the new plan;
4. **hot-swap** — rebuilds the served tree at the new leaf formats
   (``quantize_params_tree`` + ``serving_formats_from_plan``, the same
   path that built the original tree) and stages it via
   ``engine.request_swap`` — applied at the next step boundary, so
   slots drain and refill with no serving gap;
5. **re-anchor** — ``monitor.rebase_sigma`` re-references divergence
   gauges/detectors to the Σ the new plan was solved from, and the §14
   reconciliation gauges judge the swap (realized/predicted ratio must
   return to band; benchmarks/check_requant.py gates it in CI).

Determinism: :func:`replan_from_sigma` depends only on
``(reference_params, plan, sigma snapshots, damp, seed,
quantize_kwargs)`` — never on engine state — so an offline re-plan from
the same snapshots is bit-identical to the online actuation (asserted
by the bench), and a ``device-loss`` chaos fault injected at the
``requant.execute`` site (which fires BEFORE any re-plan work) retries
to the identical tree.

On the card the re-solve runs where the reference params lie: the
curves' float64 spectra, and the executor's ZSIC (the hand-written block
kernel) for every affected matrix; the swapped tree serves through the
dequant kernels.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

import torch

from repro_torch import chaos, obs

__all__ = ["SigmaSnapshot", "RequantConfig", "RequantActuator",
           "replan_from_sigma", "sigma_threshold_detectors",
           "engine_from_plan"]


@dataclasses.dataclass(frozen=True)
class SigmaSnapshot:
    """Frozen copy of one tap's streamed second moment at actuation time.

    Duck-compatible with ``StreamingSigma`` where it matters
    (``.sigma``/``.n``), so ``sensitivity_from_streamed`` accepts either.
    """

    sigma: np.ndarray        # (d, d) uncentered E[xxᵀ], float64
    n: float                 # samples folded in


@dataclasses.dataclass(frozen=True)
class RequantConfig:
    """Actuation policy knobs (the ``requant=`` field of EngineConfig)."""

    min_samples: int = 32          # skip taps with colder streamed Σ
    cooldown_steps: int = 8        # steps between actuations (hysteresis)
    max_actuations: Optional[int] = None   # None = unbounded
    series_prefix: str = "sigma_fro:"      # drift series the actuator owns
    n_workers: int = 1             # executor pool width for the re-solve
    damp: float = 0.05             # quantize_at_rate damping (match build)
    seed: int = 0                  # quantize_at_rate seed (match build)
    quantize_kwargs: Optional[Dict[str, Any]] = None
    # ^ quantize_params_tree kwargs (min_dim/skip_embed) — MUST match the
    #   originally-served tree's build or bit-identity vs offline breaks


def replan_from_sigma(cfg, reference_params, plan, sigma_by_tap: Dict, *,
                      damp: float = 0.05, seed: int = 0, n_workers: int = 1,
                      quantize_kwargs: Optional[Dict[str, Any]] = None,
                      compute_distortion: bool = True):
    """Pure core of one actuation: snapshots → (new plan, new tree).

    ``sigma_by_tap`` maps tap ids (``"L{l}/{tap}"``) to objects exposing
    ``.sigma``/``.n`` (:class:`SigmaSnapshot` or live ``StreamingSigma``).
    Every matrix fed by a listed tap and present in ``plan`` is affected:
    its curve is re-derived from the streamed Σ, the subset re-waterfilled
    with the global budget fixed, ONLY the subset re-executed
    (``plan.task`` spans on the live timeline), and the full served tree
    rebuilt at the new leaf formats.  Returns
    ``(new_plan, tree, qlinears, report, affected_names)``.

    This function reads no engine state — the online actuator and the
    offline bit-identity audit call it with identical arguments and get
    identical trees (the acceptance gate of DESIGN.md §15).
    """
    from repro_torch.core.watersic import CalibStats
    from repro_torch.plan.executor import execute_plan
    from repro_torch.plan.sensitivity import sensitivity_from_streamed
    from repro_torch.plan.waterfill import rewaterfill_subset
    from repro_torch.quant import pipeline as _pl
    from repro_torch.quant.qlinear import (quantize_params_tree,
                                           serving_formats_from_plan)
    recs = [r for r in _pl.matrix_tap_map(cfg, reference_params)
            if f"L{r['layer']}/{r['tap']}" in sigma_by_tap
            and r["name"] in plan]
    if not recs:
        raise ValueError(f"no plan matrices fed by taps "
                         f"{sorted(sigma_by_tap)[:5]}")
    new_sens = []
    weights: Dict[str, Any] = {}
    stats: Dict[str, CalibStats] = {}
    for r in recs:
        name = r["name"]
        snap = sigma_by_tap[f"L{r['layer']}/{r['tap']}"]
        e = plan.entry(name)
        w = _pl._get_w(reference_params, r["layer"], r["path"]).T
        # Appendix C damping, applied ONCE up front: a live streamed Σ can
        # be far more degenerate than a calibration pass (a drift burst of
        # near-identical prompts is close to rank-1), and the raw-spectrum
        # curve would then predict ~0 distortion the damped quantizer can
        # never reach.  Curve, quantizer and realized-distortion audit all
        # see the SAME regularized Σ (execute_plan gets damp=0 below).
        sig = np.asarray(snap.sigma, np.float64)
        sig = sig + damp * float(np.mean(np.diag(sig))) \
            * np.eye(sig.shape[0])
        damped = SigmaSnapshot(sigma=sig, n=float(getattr(snap, "n")))
        # output weighting recomputes against the LIVE Σ; any other
        # weighting keeps the plan's calibrated coefficient
        wt = None if plan.weighting == "output" else e.weight
        new_sens.append(sensitivity_from_streamed(
            name, w.to(torch.float64), damped, weight=wt,
            floor_bits=e.floor_bits, ceil_bits=e.ceil_bits))
        # f32 executor inputs, as the reference's jnp.asarray makes them
        weights[name] = w.to(torch.float32)
        stats[name] = CalibStats(sigma_x=torch.as_tensor(
            sig, dtype=torch.float32, device=w.device))
    affected = sorted(s.name for s in new_sens)
    new_plan, _ = rewaterfill_subset(plan, new_sens)
    qlinears, report = execute_plan(
        new_plan, weights, stats, damp=0.0, seed=seed, n_workers=n_workers,
        subset=affected, compute_distortion=compute_distortion)
    tree = quantize_params_tree(
        reference_params, nbits_by_path=serving_formats_from_plan(new_plan),
        **(quantize_kwargs or {}))
    return new_plan, tree, qlinears, report, affected


class RequantActuator:
    """Drift-flag → re-plan → hot-swap controller for one engine.

    Constructed over the fp ``reference_params`` the served tree was
    quantized from, the live :class:`QuantPlan`, and the engine's
    :class:`QualityMonitor` (whose ``DriftMonitor`` it polls with a
    persistent flag cursor, so each flag is consumed exactly once).
    Bind with ``engine.attach_requant(actuator)``; the engine polls it
    once per step, after quality sampling, behind the same
    ``obs.enabled()`` gate.
    """

    def __init__(self, cfg, reference_params, plan, monitor, *,
                 config: Optional[RequantConfig] = None):
        self.cfg = cfg
        self.ref = reference_params
        self.plan = plan
        self.monitor = monitor
        self.config = config or RequantConfig()
        self._flag_cursor = 0
        self._cooldown = 0
        self.actuations: List[Dict[str, Any]] = []
        self._by_tap: Dict[str, list] = {}
        for rec in monitor.mats:
            tap_id = f"L{rec['layer']}/{rec['tap']}"
            self._by_tap.setdefault(tap_id, []).append(rec)

    # -- engine hook --------------------------------------------------------

    def poll(self, engine) -> bool:
        """Consume new drift flags; actuate when one names a warm tap.

        Returns True when an actuation ran (the swap is STAGED — the
        engine applies it at its next step boundary).
        """
        c = self.config
        flags = self.monitor.drift.flags_since(self._flag_cursor,
                                               prefix=c.series_prefix)
        self._flag_cursor = len(self.monitor.drift.flags)
        if self._cooldown > 0:
            self._cooldown -= 1
            return False
        if not flags:
            return False
        if c.max_actuations is not None \
                and len(self.actuations) >= c.max_actuations:
            return False
        taps = sorted({f.series[len(c.series_prefix):] for f in flags}
                      & set(self._by_tap))
        snaps: Dict[str, SigmaSnapshot] = {}
        for t in taps:
            est = self.monitor.tracker.get(t)
            if est is not None and est.n >= c.min_samples:
                snaps[t] = SigmaSnapshot(
                    sigma=np.array(est.sigma, np.float64, copy=True),
                    n=float(est.n))
        if not snaps:
            return False
        self._actuate(engine, snaps)
        return True

    # -- internals ----------------------------------------------------------

    def _actuate(self, engine, snaps: Dict[str, SigmaSnapshot]) -> None:
        c = self.config
        t0 = time.perf_counter()
        payload_before = {e.name: int(e.payload_bits) for e in self.plan}

        def work():
            # the chaos site fires BEFORE any re-plan work, so a retried
            # actuation replays from the same frozen snapshots and lands
            # the bit-identical tree (chaos-during-requant test)
            if chaos.enabled():
                chaos.fire("requant.execute", engine=engine)
            return replan_from_sigma(
                self.cfg, self.ref, self.plan, snaps, damp=c.damp,
                seed=c.seed, n_workers=c.n_workers,
                quantize_kwargs=c.quantize_kwargs)

        new_plan, tree, _, report, affected = engine._retry(
            "requant.execute", work)
        engine.request_swap(tree, reason="requant")
        self.monitor.rebase_sigma({t: s.sigma for t, s in snaps.items()})
        plan_before, self.plan = self.plan, new_plan
        self._cooldown = c.cooldown_steps
        t1 = time.perf_counter()
        self.actuations.append({
            "tick": engine._tick,
            # frozen inputs + outputs of the pure re-plan, kept so an
            # offline replay can audit bit-identity (check_requant.py)
            "snapshots": dict(snaps),
            "plan_before": plan_before,
            "plan_after": new_plan,
            "taps": sorted(snaps),
            "matrices": list(affected),
            "sigma_n": {t: s.n for t, s in snaps.items()},
            "payload_before": {n: payload_before[n] for n in affected},
            "payload_after": {n: int(new_plan.entry(n).payload_bits)
                              for n in affected},
            "overrun": bool(new_plan.budget_overrun),
            "executor_wall_s": float(report.wall_s),
            "wall_s": t1 - t0,
        })
        if obs.enabled():
            obs.complete("requant.actuate", t0, t1, tick=engine._tick,
                         taps=sorted(snaps), matrices=len(affected))
            obs.counter("repro_requant_actuations_total").inc()
            obs.counter("repro_requant_matrices_total").inc(len(affected))


def sigma_threshold_detectors(mats, *, limit: float, base=None) -> Dict:
    """Detector-factory map arming an absolute :class:`Threshold` on
    every matrix tap's ``sigma_fro:`` divergence series (the injection-
    friendly alternative to the default Page–Hinkley: fires the first
    time relative Frobenius shift exceeds ``limit``, no burn-in).
    ``base`` defaults to the §14 default detector set."""
    from repro_torch.obs.drift import Threshold
    from repro_torch.serve.quality import _default_detectors
    out = dict(base if base is not None else _default_detectors())
    for rec in mats:
        tap_id = f"L{rec['layer']}/{rec['tap']}"
        out[f"sigma_fro:{tap_id}"] = (lambda lim=float(limit):
                                      Threshold(limit=lim))
    return out


def engine_from_plan(cfg, params, plan, *, calib=None, sensitivities=None,
                     config=None, continuous: bool = True,
                     quality_config=None,
                     quantize_kwargs: Optional[Dict[str, Any]] = None):
    """Plan → served engine with the full sense→decide→act loop attached.

    Quantizes ``params`` at the plan's leaf formats, builds (or reuses
    ``config.quality``) a :class:`QualityMonitor`, constructs the engine
    from one :class:`EngineConfig`, and binds a :class:`RequantActuator`
    (reachable as ``engine.requant``) whose tree rebuilds use the SAME
    ``quantize_kwargs`` as the initial build — the bit-identity
    invariant.  ``continuous=False`` yields the static oracle engine.
    """
    import dataclasses as _dc

    from repro_torch.quant.qlinear import (quantize_params_tree,
                                           serving_formats_from_plan)
    from .config import EngineConfig
    from .engine import ContinuousEngine, ServeEngine
    from .quality import QualityMonitor
    qkw = dict(quantize_kwargs or {})
    tree = quantize_params_tree(
        params, nbits_by_path=serving_formats_from_plan(plan), **qkw)
    config = config or EngineConfig()
    monitor = config.quality
    if monitor is None:
        monitor = QualityMonitor(cfg, params, calib=calib,
                                 sensitivities=sensitivities,
                                 config=quality_config)
        config = _dc.replace(config, quality=monitor)
    rc = config.requant or RequantConfig()
    if rc.quantize_kwargs is None and qkw:
        rc = _dc.replace(rc, quantize_kwargs=qkw)
    cls = ContinuousEngine if continuous else ServeEngine
    eng = cls(cfg, tree, config=_dc.replace(config, requant=rc))
    eng.attach_requant(RequantActuator(cfg, params, plan, monitor,
                                       config=rc))
    return eng
