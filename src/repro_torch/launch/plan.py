"""The planner's command line: build → inspect → execute → serve (port of
``repro/launch/plan.py``, DESIGN.md §10).

    # build a waterfilled plan from calibration spectra
    python -m repro_torch.launch.plan build --arch minicpm-2b \
        --reduced --target-bits 3 --out plan.json --floor "*/attn/wo=4"

    # human-readable allocation + diff against another run
    python -m repro_torch.launch.plan inspect --plan plan.json

    # execute: parallel per-matrix quantization
    python -m repro_torch.launch.plan execute --plan plan.json \
        --workers 4 --compare-even

    # serve the mixed-rate model the plan implies
    python -m repro_torch.launch.plan serve --plan plan.json

Every subcommand but ``inspect`` runs on the card unless ``--device cpu``
is given.  The plan carries its model's provenance (arch, depth, seed,
calibration shape), so ``execute`` and ``serve`` rebuild the exact weights
it was built for.  Weights and tokens come from ``numpy.random`` seeds
(``"init": "repro_torch-numpy"``), the same on every device; a plan whose
provenance names another init (one built by the JAX package, whose weights
come from a JAX PRNG key) is refused rather than run against other
weights.  ``--n-layers`` cuts the depth at full width.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["INIT", "model_from_provenance", "main"]

#: the provenance tag of weights and tokens this module can rebuild
INIT = "repro_torch-numpy"


def _parse_bound(items):
    out = {}
    for it in items or []:
        pat, _, val = it.rpartition("=")
        if not pat:
            raise SystemExit(f"--floor/--ceil wants PATTERN=BITS, got {it!r}")
        out[pat] = float(val)
    return out


def _numpy_weights(params, seed: int):
    """``params`` with every weight ``w`` and every MoE expert tensor
    redrawn from ``numpy.random.default_rng(seed)`` (normal, std
    1/sqrt(in_features); the embedding std 0.02), leaves in sorted-key
    order: the same values on every device."""
    from repro_torch.quant.qlinear import _EXPERT_KEYS
    rng = np.random.default_rng(seed)

    def draw(node, path):
        if isinstance(node, dict):
            return {k: draw(node[k], path + (k,)) for k in sorted(node)}
        if path[-1] != "w" and path[-1] not in _EXPERT_KEYS:
            return node
        std = 0.02 if path[0] == "embed" else node.shape[-2] ** -0.5
        vals = rng.standard_normal(tuple(node.shape), dtype=np.float32)
        return torch.as_tensor(vals * np.float32(std), device=node.device)
    return draw(params, ())


def model_from_provenance(prov, device):
    """(cfg, params, calib_batches) of a plan's provenance on ``device``.

    Raises on a provenance this module cannot rebuild (no ``init`` of
    ``INIT``), naming what is missing.
    """
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    if prov.get("init") != INIT:
        raise ValueError(
            f"plan provenance has init={prov.get('init')!r}, not {INIT!r}: "
            "its weights cannot be rebuilt here (a plan built by the JAX "
            "package names weights drawn from a JAX PRNG key); rebuild the "
            "plan with `python -m repro_torch.launch.plan build`")
    cfg = get_config(prov["arch"])
    if prov.get("reduced"):
        cfg = cfg.reduced()
    if prov.get("n_layers"):
        cfg = dataclasses.replace(cfg, n_layers=int(prov["n_layers"]))
    params = _numpy_weights(init_params(cfg, 0, device=device), prov["seed"])
    rng = np.random.default_rng(prov["seed"] + 10_000)
    calib = [rng.integers(0, cfg.vocab, (prov["global_batch"],
                                         prov["seq_len"])).astype(np.int32)
             for _ in range(prov["calib_batches"])]
    return cfg, params, calib


def _even_from(plan):
    """The even-spread RateBudget baseline in plan form over the SAME
    matrices (same names/weights): the differential oracle.  Ignores the
    per-matrix floors/ceilings, as RateBudget does."""
    from repro_torch.plan import QuantPlan
    from repro_torch.plan.waterfill import payload_bits_for
    b = plan.budget_bits_per_param
    entries = [dataclasses.replace(
        e, target_bits=b, snapped_bits=b, payload_bits=payload_bits_for(b),
        achieved_bits=None, realized_distortion=None) for e in plan]
    return QuantPlan(budget_bits_per_param=b, weighting="even-spread",
                     entries=entries, provenance=dict(plan.provenance))


def _weighted_distortion(plan):
    vals = [(e.weight, e.n_params, e.realized_distortion) for e in plan]
    if any(v[2] is None for v in vals):
        return None
    return sum(w * n * d for w, n, d in vals)


def _print_summary(path):
    from repro_torch.launch.summarize import plan_summary
    with open(path) as f:
        print(plan_summary(json.load(f)))


def cmd_build(args):
    from repro_torch.plan import build_plan, model_sensitivities
    prov = {"arch": args.arch, "reduced": bool(args.reduced),
            "seed": args.seed, "calib_batches": args.calib_batches,
            "seq_len": args.seq_len, "global_batch": args.global_batch,
            "init": INIT}
    if args.n_layers:
        prov["n_layers"] = args.n_layers
    cfg, params, calib = model_from_provenance(prov,
                                               resolve_device(args.device))
    t0 = time.perf_counter()
    sens = model_sensitivities(cfg, params, calib,
                               weighting=args.weighting, seed=args.seed,
                               floors=_parse_bound(args.floor),
                               ceils=_parse_bound(args.ceil))
    plan = build_plan(sens, args.target_bits, snap=not args.no_snap,
                      weighting=args.weighting, provenance=prov)
    plan.save(args.out)
    print(f"built plan for {len(sens)} matrices in "
          f"{time.perf_counter() - t0:.1f}s -> {args.out}")
    _print_summary(args.out)
    return plan


def cmd_inspect(args):
    from repro_torch.plan import QuantPlan
    _print_summary(args.plan)
    if args.diff:
        delta = QuantPlan.load(args.plan).diff(QuantPlan.load(args.diff))
        print(f"\ndiff vs {args.diff}: "
              f"{'(allocations identical)' if not delta else ''}")
        for line in delta:
            print(f"  {line}")


def cmd_execute(args):
    from repro_torch.plan import QuantPlan, quantize_model_with_plan
    plan = QuantPlan.load(args.plan)
    cfg, params, calib = model_from_provenance(plan.provenance,
                                               resolve_device(args.device))
    t0 = time.perf_counter()
    _, _, plan, report = quantize_model_with_plan(
        cfg, params, calib, plan, n_workers=args.workers,
        devices="all" if args.pin_devices else None,
        compute_distortion=True)
    print(f"executed {len(plan.entries)} matrices on {args.workers} "
          f"worker(s) in {report.wall_s:.1f}s "
          f"(serial-equivalent {report.serial_s:.1f}s, "
          f"retries={report.retries}"
          + (f", stragglers={report.stragglers}" if report.stragglers
             else "") + ")")
    print(f"realized {plan.realized_bits_per_param:.3f} bits/param "
          f"(planned {plan.planned_bits_per_param:.3f})")
    out = args.out or args.plan.replace(".json", "") + ".executed.json"
    plan.save(out)
    if QuantPlan.load(out) != plan:
        raise RuntimeError(f"artifact round-trip mismatch: {out}")
    print(f"artifact round-trip OK -> {out}")
    if args.compare_even:
        even = _even_from(plan)
        _, _, even, _ = quantize_model_with_plan(
            cfg, params, calib, even, n_workers=args.workers,
            compute_distortion=True)
        d_wf, d_ev = _weighted_distortion(plan), _weighted_distortion(even)
        print(f"weighted output distortion: waterfilled {d_wf:.4e} vs "
              f"even-spread {d_ev:.4e} ({d_ev / max(d_wf, 1e-30):.2f}x)"
              f"  [realized {plan.realized_bits_per_param:.3f} vs "
              f"{even.realized_bits_per_param:.3f} bits/param]")
    print(f"wall {time.perf_counter() - t0:.1f}s")
    return plan


def cmd_serve(args):
    from repro_torch.kernels.dequant import LAUNCHES, reset_launches
    from repro_torch.plan import QuantPlan
    from repro_torch.quant import (leaf_format_histogram, quantize_params_tree,
                                   qweight_bytes, serving_formats_from_plan)
    from repro_torch.serve import ContinuousEngine, EngineConfig, Request
    plan = QuantPlan.load(args.plan)
    device = resolve_device(args.device)
    cfg, params, _ = model_from_provenance(plan.provenance, device)
    rng = np.random.default_rng(0)
    mixed = quantize_params_tree(
        params, nbits_by_path=serving_formats_from_plan(plan))
    qb, fb = qweight_bytes(mixed)
    print(f"mixed-rate serving formats: {leaf_format_histogram(mixed)}")
    print(f"  param bytes {qb / 1e6:.2f} MB vs bf16 {fb / 1e6:.2f} MB "
          f"({fb / max(qb, 1):.2f}x HBM win)")
    eng = ContinuousEngine(cfg, mixed, config=EngineConfig(
        n_slots=args.slots, max_len=args.prompt_len + args.max_new + 2,
        prefill_chunk=8))
    for i in range(args.requests):
        eng.submit(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, args.prompt_len)
            .astype(np.int32), max_new_tokens=args.max_new))
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    tok = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s, continuous, mixed-rate)")
    print(f"  dequant-kernel launches: int8 {LAUNCHES[8]}, int4 "
          f"{LAUNCHES[4]}, int3 {LAUNCHES[3]}, int2 {LAUNCHES[2]}")
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.plan")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="waterfill a plan from calib spectra")
    b.add_argument("--arch", required=True)
    b.add_argument("--reduced", action="store_true")
    b.add_argument("--n-layers", type=int, default=0,
                   help="cut the depth (0 = the arch's own)")
    b.add_argument("--target-bits", type=float, default=3.0)
    b.add_argument("--weighting", default="output",
                   choices=["uniform", "output", "probe"])
    b.add_argument("--calib-batches", type=int, default=2)
    b.add_argument("--seq-len", type=int, default=32)
    b.add_argument("--global-batch", type=int, default=4)
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--floor", action="append", metavar="PATTERN=BITS",
                   help='per-matrix floor, e.g. "*/attn/wo=4" (repeatable)')
    b.add_argument("--ceil", action="append", metavar="PATTERN=BITS")
    b.add_argument("--no-snap", action="store_true",
                   help="keep the continuous allocation (no integer grid)")
    b.add_argument("--out", required=True)
    b.set_defaults(fn=cmd_build)

    i = sub.add_parser("inspect", help="summarize / diff a plan artifact")
    i.add_argument("--plan", required=True)
    i.add_argument("--diff", default=None)
    i.set_defaults(fn=cmd_inspect)

    e = sub.add_parser("execute", help="parallel plan execution")
    e.add_argument("--plan", required=True)
    e.add_argument("--workers", type=int, default=1)
    e.add_argument("--pin-devices", action="store_true",
                   help="round-robin tasks over all visible devices")
    e.add_argument("--out", default=None)
    e.add_argument("--compare-even", action="store_true",
                   help="also execute the even-spread baseline and report "
                        "the weighted-distortion ratio")
    e.set_defaults(fn=cmd_execute)

    s = sub.add_parser("serve", help="serve the plan's mixed-rate formats")
    s.add_argument("--plan", required=True)
    s.add_argument("--requests", type=int, default=4)
    s.add_argument("--prompt-len", type=int, default=8)
    s.add_argument("--max-new", type=int, default=8)
    s.add_argument("--slots", type=int, default=4)
    s.set_defaults(fn=cmd_serve)

    for p in (b, e, s):
        p.add_argument("--device", default=None,
                       help="torch device (default cuda; 'cpu' runs the "
                            "plain PyTorch twins)")

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
