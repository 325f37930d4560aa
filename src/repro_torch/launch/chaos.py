"""Chaos-matrix driver (port of ``repro/launch/chaos.py``): one fault
class, one seed, three invariant runs (DESIGN.md §12).

Each invocation

1. serves a seed-determined workload on a fault-free continuous engine
   (the reference streams);
2. replays the identical workload under an armed ``chaos.seeded_plan``
   with the resilience layer on, and requires every completed request's
   token stream to equal the reference — dropped requests must be
   *reported*, never silently truncated;
3. runs a snapshot → kill → resume cycle and requires the combined
   streams to equal an uninterrupted run.

Results land in a JSON summary (stream-match booleans, the injection
log, an ``obs`` counter snapshot) plus the obs trace-event log;
``benchmarks/check_chaos.py`` (stdlib only) reads both unchanged.

The default model is the reference's small serving config (2 layers,
d 32); ``--arch`` serves a registered architecture at full width with
``--n-layers`` cutting the depth.  Weights come from ``init_params`` with
seed 0, quantized to packed int4.  Runs on the card unless ``--device
cpu``.  ``--delay-s`` is the slow-step fault's sleep: it must stand out
against the step time (4× the rolling median), and a full-width step
with an integrity check every step is far longer than the small
model's.

    python -m repro_torch.launch.chaos --kind corrupt-payload --seed 0 \
        --json-out chaos.json --trace-out chaos_trace.json
    python benchmarks/check_chaos.py --summary chaos.json \
        --trace chaos_trace.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np

from repro_torch import chaos, obs, resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.dist.fault import RestartPolicy
from repro_torch.models import init_params
from repro_torch.quant import quantize_params_tree
from repro_torch.serve import (ContinuousEngine, EngineConfig, Request,
                               ResilienceConfig)

__all__ = ["CFG", "workload", "quantized_params", "run_cell", "main"]

# small-but-real serving config: quantized leaves (so corrupt-payload has
# payloads to flip), 2 slots (so admission bursts and evictions happen)
CFG = ArchConfig(name="chaos", family="dense", n_layers=2, d_model=32,
                 n_heads=2, n_kv=2, d_ff=64, vocab=64, head_dim=16)
N_REQ = 10
BUDGET = 6
MAX_LEN = 64


def workload(seed: int, vocab: int):
    """The seed-determined request list (same for every run in a cell)."""
    rng = np.random.default_rng([int(seed), 0xFA17])
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab,
                                        4 + int(rng.integers(0, 3))
                                        ).astype(np.int32),
                    max_new_tokens=BUDGET)
            for i in range(N_REQ)]


def quantized_params(cfg: ArchConfig, device):
    """Seed-0 weights as packed int4 (min_dim below the small model's
    widths, so its payloads exist to flip)."""
    return quantize_params_tree(init_params(cfg, 0, device=device), nbits=4,
                                packed=True, min_dim=16)


def _resilience(**over) -> ResilienceConfig:
    kw = dict(
        retry=RestartPolicy(max_restarts=8, backoff_base_s=1e-3,
                            backoff_max_s=1e-2, reset_after=2),
        retry_sleep=lambda s: None,      # deterministic: no real waiting
        integrity_every=1,               # heal before the next dispatch
        # warmup 1 so an early injected slow step still flags
        slow_step_warmup=1, slow_step_threshold=4.0)
    kw.update(over)
    return ResilienceConfig(**kw)


def _engine(cfg, params, **config):
    return ContinuousEngine(cfg, params, config=EngineConfig(
        n_slots=2, max_len=MAX_LEN, prefill_chunk=4, **config))


def _run(cfg, params, seed: int, *, resilience=None, plan=None):
    eng = _engine(cfg, params, resilience=resilience)
    for r in workload(seed, cfg.vocab):
        eng.submit(r)
    if plan is not None:
        with chaos.active(plan) as rt:
            done = eng.run_until_done()
        return eng, done, rt
    return eng, eng.run_until_done(), None


def _streams(reqs):
    return {int(r.rid): [int(t) for t in r.out_tokens] for r in reqs}


def _resume_cycle(cfg, params, seed: int, reference, kill_after: int = 7):
    """Snapshot → kill → resume; True iff combined streams == reference."""
    with tempfile.TemporaryDirectory() as snap:
        eng = _engine(cfg, params, resilience=ResilienceConfig(
            snapshot_dir=snap, snapshot_every=3))
        for r in workload(seed, cfg.vocab):
            eng.submit(r)
        for _ in range(kill_after):
            eng.step()
        delivered = _streams(r for r in eng.finished if r.done)
        del eng                          # the "kill": host state is gone
        eng2 = ContinuousEngine.resume(snap, cfg, params, prefill_chunk=4)
        eng2.run_until_done()
        # requests that finished after the snapshot re-finish identically
        # on the resumed engine; the union must equal the reference
        combined = dict(delivered)
        combined.update(_streams(eng2.finished))
        return combined == reference, len(delivered), len(eng2.finished)


def run_cell(cfg: ArchConfig, params, kind: str, seed: int, *,
             delay_s: float = 0.25, trace_out=None) -> dict:
    """The three runs of one matrix cell; returns the summary dict (and
    writes the faulted run's trace to ``trace_out``)."""
    # 1. fault-free reference streams (no obs: the event log holds the
    #    faulted run alone, so check_chaos reconciles one run's events)
    _, ref_done, _ = _run(cfg, params, seed)
    reference = _streams(ref_done)
    assert len(reference) == N_REQ

    # 2. faulted run under the armed plan, obs on.  serve.admit fires only
    #    when slots free up (~N_REQ/n_slots times a run), so the
    #    admission-failure horizon stays inside that count; the others
    #    start at invocation 2.
    obs.reset()
    obs.enable()
    horizon, first = (4, 1) if kind == "admission-failure" else (20, 2)
    plan = chaos.seeded_plan(kind, seed, horizon=horizon, n_faults=2,
                             first=first, delay_s=delay_s)
    eng, done, rt = _run(cfg, params, seed, resilience=_resilience(),
                         plan=plan)
    faulted = _streams(done)
    completed_match = all(faulted.get(rid) == toks
                          for rid, toks in reference.items()
                          if rid in faulted)
    summary = {
        "kind": kind,
        "seed": seed,
        "injected": rt.injected(),
        "injection_log": rt.log,
        "schedule": {s.site: list(s.at) for s in plan.specs},
        "completed": sorted(faulted),
        "streams_match": faulted == reference,
        "completed_match": completed_match,
        "dropped": [{"rid": r.rid, "reason": r.drop_reason}
                    for r in eng.dropped],
        "clock_skew_s": eng._clock_skew_s,
        "slow_steps": eng.slow_steps,
        "retries_used": (eng.resilience.retry.restarts_used
                         if eng.resilience.retry else 0),
        "counters": obs.counters_snapshot(),
        "step_s": [st.step_s for st in eng.step_stats],
    }

    # 3. snapshot → kill → resume (fault-free cycle, same workload)
    ok, pre, post = _resume_cycle(cfg, params, seed, reference)
    summary["resume_match"] = ok
    summary["resume_delivered_pre_kill"] = pre
    summary["resume_finished_post_resume"] = post
    if trace_out:
        obs.write_trace(trace_out)
    obs.disable()
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", default=os.environ.get("CHAOS_KIND",
                                                     "device-loss"),
                    choices=list(chaos.FAULT_KINDS))
    ap.add_argument("--seed", type=int,
                    default=int(os.environ.get("CHAOS_SEED", "0")))
    ap.add_argument("--arch", default=None,
                    help="a registered architecture at full width "
                         "(default: the small 2-layer d 32 model)")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="with --arch: cut the depth to this many layers")
    ap.add_argument("--delay-s", type=float, default=0.25,
                    help="the slow-step fault's sleep")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--json-out", default=None, metavar="PATH")
    ap.add_argument("--trace-out", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = CFG
    if args.arch:
        cfg = get_config(args.arch)
        if args.n_layers:
            cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    summary = run_cell(cfg, quantized_params(cfg, device), args.kind,
                       args.seed, delay_s=args.delay_s,
                       trace_out=args.trace_out)
    if args.trace_out:
        print(f"wrote {args.trace_out}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"wrote {args.json_out}")
    print(f"chaos[{args.kind} seed={args.seed}]: "
          f"{summary['injected']} injected, "
          f"streams_match={summary['streams_match']} "
          f"dropped={len(summary['dropped'])} "
          f"resume_match={summary['resume_match']}")
    return summary


if __name__ == "__main__":
    main()
