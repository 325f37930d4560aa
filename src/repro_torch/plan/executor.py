"""Parallel plan execution (port of ``repro/plan/executor.py``, DESIGN.md
§10).

The sequential PTQ pipeline (quant/pipeline.py) quantizes layer l with
statistics of the quantized-so-far model, a serial chain by construction.
A ``QuantPlan`` is built from fp-model statistics only, so every matrix's
quantization is independent: the executor fans the per-matrix
``quantize_at_rate`` calls out over a thread pool, largest matrix first
(LPT scheduling).  By default every task runs where its inputs lie;
``devices="all"`` pins tasks round-robin over every visible CUDA device
(each task under ``torch.cuda.device``), or over the CPU when the inputs
lie on the CPU, i.e. when the caller asked for it.

Determinism contract: a task's result depends only on (weights, stats,
target bits, damp, seed), never on scheduling, so 1 worker and n workers
give identical results (tests/test_torch_plan.py; ``chip_smoke.py``
checks it on the card, where the threads share one stream).

Each task retries under a :class:`~repro_torch.dist.fault.RestartPolicy`;
an optional :class:`~repro_torch.dist.fault.Heartbeat` beats once per
completed task, and a :class:`~repro_torch.dist.fault.StragglerMonitor`
accumulates per-device task times.

Observability (DESIGN.md §11): with ``repro_torch.obs`` enabled each
task records a ``plan.task`` span (matrix, device, bits), bumps
``repro_plan_tasks_total`` and observes ``repro_plan_task_seconds``; the
whole run records a ``plan.execute`` span; retries count into
``repro_plan_retries_total`` and flagged stragglers into
``repro_plan_stragglers_total`` — the reference's names.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core.watersic import (CalibStats, QuantizedLinear,
                                       layer_distortion, quantize_at_rate)
from repro_torch.dist.fault import Heartbeat, RestartPolicy, StragglerMonitor

from .artifact import QuantPlan

__all__ = ["ExecutorReport", "execute_plan", "plan_inputs_for_model",
           "quantize_model_with_plan"]


@dataclasses.dataclass
class ExecutorReport:
    """Scheduling/fault accounting for one plan execution."""

    n_workers: int
    wall_s: float
    task_s: Dict[str, float]            # matrix name → task wall clock
    device_of: Dict[str, str]           # matrix name → device label
    retries: int
    stragglers: List[str]               # flagged device labels

    @property
    def serial_s(self) -> float:
        """Sum of task times — the sequential-loop wall clock this
        execution's parallelism amortized."""
        return sum(self.task_s.values())


def _devices(n_workers: int, devices, like: torch.Tensor
             ) -> Optional[List[torch.device]]:
    """None = no pinning (tasks run where their inputs lie); "all" = every
    visible CUDA device when the inputs are on a card, else the CPU; an
    explicit list pins to those devices."""
    if devices is None:
        return None
    if devices == "all":
        devs = ([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if like.is_cuda else [torch.device("cpu")])
    else:
        devs = [torch.device(d) for d in devices]
    return devs[:max(1, n_workers)] if len(devs) >= n_workers else devs


def _load_linalg(dev: torch.device) -> None:
    """Make the first CUDA linear-algebra call of the process on ``dev``.

    PyTorch loads its CUDA linalg library lazily, at the first such call,
    and that load is not thread-safe: threads making their first Cholesky
    together raise "lazy wrapper should be called at most once".  The
    executor makes the first call before it starts its threads.
    """
    if dev.type == "cuda":
        torch.linalg.cholesky(torch.ones((1, 1), device=dev))


def _stats_to(stats: CalibStats, dev: torch.device) -> CalibStats:
    return CalibStats(**{f.name: None if getattr(stats, f.name) is None
                         else getattr(stats, f.name).to(dev)
                         for f in dataclasses.fields(stats)})


def execute_plan(plan: QuantPlan,
                 weights: Dict[str, Any],
                 stats: Dict[str, CalibStats], *,
                 damp: float = 0.05,
                 seed: int = 0,
                 n_workers: int = 1,
                 devices=None,
                 policy: Optional[RestartPolicy] = None,
                 heartbeat: Optional[Heartbeat] = None,
                 compute_distortion: bool = True,
                 quantize_kwargs: Optional[Dict[str, Any]] = None,
                 subset: Optional[Sequence[str]] = None,
                 ) -> Tuple[Dict[str, QuantizedLinear], ExecutorReport]:
    """Quantize every plan entry at its snapped target, in parallel.

    ``weights[name]`` is the (out, in) algorithm-layout tensor and
    ``stats[name]`` its :class:`CalibStats`; both must cover every entry.
    Fills ``entry.achieved_bits`` (entropy) and, when
    ``compute_distortion``, ``entry.realized_distortion`` in place.
    Returns ``(qlinears, report)``.  ``subset`` restricts execution to
    those entry names (incremental mode); only they need inputs and only
    their entries are filled.
    """
    if subset is None:
        entries = list(plan.entries)
    else:
        sub = set(subset)
        unknown = sorted(n for n in sub if n not in plan)
        if unknown:
            raise KeyError(f"subset names not in plan: {unknown[:5]}"
                           f"{'...' if len(unknown) > 5 else ''}")
        entries = [e for e in plan.entries if e.name in sub]
    missing = [e.name for e in entries if e.name not in weights
               or e.name not in stats]
    if missing:
        raise KeyError(f"plan entries without weights/stats: {missing[:5]}"
                       f"{'...' if len(missing) > 5 else ''}")
    tmpl = policy or RestartPolicy(max_restarts=2, backoff_base_s=0.01,
                                   backoff_max_s=0.1)
    devs = (_devices(n_workers, devices, weights[entries[0].name])
            if entries else None)
    monitor = StragglerMonitor(threshold=3.0)
    retries = 0
    retry_lock = threading.Lock()
    results: Dict[str, QuantizedLinear] = {}

    # LPT: largest matrices first so the pool's makespan stays balanced
    order = sorted(entries, key=lambda e: -e.n_params)

    def run_one(task_idx: int, entry) -> Tuple[str, QuantizedLinear, float,
                                               str]:
        nonlocal retries
        dev = devs[task_idx % len(devs)] if devs else None
        w, st = weights[entry.name], stats[entry.name]
        if dev is not None:
            w, st = w.to(dev), _stats_to(st, dev)
        pol = dataclasses.replace(tmpl)
        t0 = time.perf_counter()
        while True:
            try:
                with (torch.cuda.device(dev) if dev is not None
                      and dev.type == "cuda" else nullcontext()):
                    q = quantize_at_rate(
                        w, st, float(entry.execution_bits), damp=damp,
                        seed=seed, **(quantize_kwargs or {}))
                break
            except Exception:
                delay = pol.next_delay()
                if delay is None:
                    raise
                with retry_lock:
                    retries += 1
                obs.counter("repro_plan_retries_total").inc()
                time.sleep(delay)
        t1 = time.perf_counter()
        dev_label = str(dev) if dev is not None else "default"
        if obs.enabled():
            obs.complete("plan.task", t0, t1, matrix=entry.name,
                         device=dev_label,
                         bits=float(entry.execution_bits))
            obs.counter("repro_plan_tasks_total").inc()
            obs.histogram("repro_plan_task_seconds").observe(t1 - t0)
        return (entry.name, q, t1 - t0, dev_label)

    t_start = time.perf_counter()
    task_s: Dict[str, float] = {}
    device_of: Dict[str, str] = {}
    pool = None
    if n_workers > 1:
        for dev in devs or {weights[e.name].device for e in entries}:
            _load_linalg(dev)
        pool = ThreadPoolExecutor(max_workers=n_workers)
    try:
        done = (pool.map(run_one, range(len(order)), order) if pool
                else (run_one(i, e) for i, e in enumerate(order)))
        # consume lazily: the heartbeat/straggler feed advances as tasks
        # complete (in submission order), not only after the whole pool
        # drains
        for k, (name, q, dt, dev) in enumerate(done):
            results[name] = q
            task_s[name] = dt
            device_of[name] = dev
            monitor.observe(dev, dt)
            if heartbeat is not None:
                heartbeat.beat(k + 1)
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    t_done = time.perf_counter()
    wall = t_done - t_start
    stragglers = monitor.stragglers()
    if obs.enabled():
        obs.complete("plan.execute", t_start, t_done, n_workers=n_workers,
                     tasks=len(order), retries=retries)
        if stragglers:
            obs.counter("repro_plan_stragglers_total").inc(len(stragglers))

    for e in entries:
        q = results[e.name]
        e.achieved_bits = float(q.entropy_bits)
        if compute_distortion:
            w = weights[e.name].to(q.codes.device)
            e.realized_distortion = float(layer_distortion(
                w, q, stats[e.name].sigma_x.to(w.device)))
    report = ExecutorReport(n_workers=n_workers, wall_s=wall, task_s=task_s,
                            device_of=device_of, retries=retries,
                            stragglers=stragglers)
    return results, report


# ---------------------------------------------------------------------------
# Model-level wrapper: calibrate → execute → write dequantized weights back
# ---------------------------------------------------------------------------


def plan_inputs_for_model(cfg, params, calib_batches
                          ) -> Tuple[Dict[str, Any], Dict[str, CalibStats]]:
    """(weights, stats) dicts covering every plan entry of a dense model,
    from one fp calibration pass on the params' device (no drift
    statistics: plan execution is the independent-layer path)."""
    from repro_torch.quant import pipeline as _pl
    from .sensitivity import collect_sigma_x
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE plan inputs belong to the MoE family's slice "
            "(ROADMAP queue A item 12)")
    acc = collect_sigma_x(cfg, params, calib_batches)
    weights: Dict[str, Any] = {}
    stats: Dict[str, CalibStats] = {}
    for rec in _pl.matrix_tap_map(cfg, params):
        weights[rec["name"]] = _pl._get_w(params, rec["layer"], rec["path"]).T
        stats[rec["name"]] = CalibStats(
            sigma_x=acc.get(rec["sigma_key"]).to(torch.float32))
    return weights, stats


def quantize_model_with_plan(cfg, params, calib_batches, plan: QuantPlan, *,
                             damp: float = 0.05, seed: int = 0,
                             n_workers: int = 1, devices=None,
                             compute_distortion: bool = False,
                             heartbeat: Optional[Heartbeat] = None):
    """Execute a plan against a model: parallel per-matrix quantization,
    dequantized weights written back into a copy of the params.

    Returns ``(qparams, qlinears, plan, report)``; the plan comes back with
    achieved bits filled in.  The drift/residual corrections of the
    sequential pipeline do not apply here (they would chain layers);
    ``quantize_model(plan=...)`` keeps them and stays sequential.
    """
    from repro_torch.quant import pipeline as _pl
    weights, stats = plan_inputs_for_model(cfg, params, calib_batches)
    # a plan built for another model fails before the quantization, not at
    # the write-back after it
    missing = sorted(set(weights) - set(plan.names()))
    if missing:
        raise KeyError(f"plan is missing entries for {missing[:5]}"
                       f"{'...' if len(missing) > 5 else ''} — built for "
                       "a different model?")
    qlinears, report = execute_plan(
        plan, weights, stats, damp=damp, seed=seed, n_workers=n_workers,
        devices=devices, heartbeat=heartbeat,
        compute_distortion=compute_distortion)
    qparams = _pl._clone(params)
    for rec in _pl.matrix_tap_map(cfg, params):
        _pl._set_w(qparams, rec["layer"], rec["path"],
                   qlinears[rec["name"]].dequant().T)
    return qparams, qlinears, plan, report
