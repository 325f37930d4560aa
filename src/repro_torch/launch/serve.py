"""Serving driver (port of ``repro/launch/serve.py``): a batched engine
over random weights, optionally WaterSIC-quantized — int8 codes or a rung
of the packed sub-byte ladder (``--wbits {16,8,4,3,2}``).

Runs on the card unless ``--device cpu`` is given (and raises when there
is no card).  Prints tokens/s, the weight bytes, and the number of
packed-kernel launches the run made.

Every quantized ``--wbits`` of a dense config is built layer by layer
(``serving_tree``: one layer's f32 weights at a time), so a model whose
f32 tree is larger than the card serves int4 from the same command:

    python -m repro_torch.launch.serve --arch qwen2.5-32b --wbits 4 \
        --requests 8 --slots 8 --prompt-len 32 --max-new 16 \
        --prefill-chunk 16 --continuous

``--wbits 16`` (and ``--requant``, which plans from the f32 weights) of
a config whose f32 tree exceeds the device's free memory is refused
before anything is allocated.

``--trace-out``/``--metrics-out``/``--events-out`` enable
``repro_torch.obs`` (DESIGN.md §11) and export the run's Chrome trace
(Perfetto), Prometheus text exposition and JSONL metric log (the input to
``launch/summarize.py --metrics``, this package's or the reference's).

Resilience flags (DESIGN.md §12) attach the serving-resilience layer:
``--deadline-s``/``--queue-cap`` bound latency and queue growth (dropped
requests are reported at exit), ``--retries`` arms transient-dispatch
retry, ``--integrity-every`` checksums and heals the quantized payloads,
``--degrade`` walks the int4→int3→int2 ladder under queue pressure, and
``--snapshot-dir``/``--snapshot-every`` write crash-recoverable engine
snapshots (``--resume`` restarts from the latest one).

``--requant`` (DESIGN.md §15) serves from a waterfilled plan instead of
``--wbits`` and arms the live sense→decide→act loop; the driver sends a
drifted second traffic phase (repeated-token prompts) so the loop
closes.  Requires ``--continuous``; incompatible with ``--degrade``.

    python -m repro_torch.launch.serve --arch minicpm-2b --wbits 4 \
        --requests 8 --continuous --prefill-chunk 16 \
        --trace-out trace.json --metrics-out serve.prom \
        --events-out events.jsonl
    python -m repro_torch.launch.summarize --metrics events.jsonl
    python -m repro_torch.launch.serve --arch minicpm-2b --reduced \
        --wbits 3 --device cpu
    python -m repro_torch.launch.serve --arch minicpm-2b --reduced \
        --wbits 4 --continuous --retries 3 --integrity-every 2 \
        --snapshot-dir snap --snapshot-every 2 --device cpu
    python -m repro_torch.launch.serve ... --snapshot-dir snap --resume

``--mesh`` (DESIGN.md §13) serves the tree k-sharded over ``--ranks N``
rank processes (``serve.sharded``; the collective backend by
``launch.mesh.backend_rule``) and holds their token streams bit for bit
against the single-process oracle over the same sharded tree;
``--mesh-json`` writes what ``benchmarks/check_mesh.py`` audits:

    python -m repro_torch.launch.serve --arch minicpm-2b --reduced \
        --wbits 4 --continuous --mesh --ranks 4 --device cpu \
        --mesh-json mesh.json
    python benchmarks/check_mesh.py mesh.json
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import time

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.configs import get_config
from repro_torch.dist.fault import RestartPolicy
from repro_torch.kernels.dequant import LAUNCHES, reset_launches
from repro_torch.models import (init_layer_params, init_params,
                                init_shared_params)
from repro_torch.quant import quantize_params_by_layer, quantize_params_tree
from repro_torch.serve import (ContinuousEngine, DegradePolicy, EngineConfig,
                               QualityConfig, Request, RequantConfig,
                               ResilienceConfig, ServeEngine,
                               build_bit_ladder, engine_from_plan,
                               sigma_threshold_detectors)
from repro_torch.tree import tree_leaves

__all__ = ["quantize_for_wbits", "serving_tree", "f32_tree_bytes",
           "free_bytes", "check_f32_tree_fits", "add_obs_flags", "obs_setup",
           "obs_export", "add_resilience_flags", "resilience_from_args",
           "add_requant_flags", "requant_from_args", "main_mesh", "main"]


def add_obs_flags(ap: argparse.ArgumentParser) -> None:
    """The observability exports (the reference's flags)."""
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON (Perfetto)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the Prometheus text exposition")
    ap.add_argument("--events-out", default=None, metavar="PATH",
                    help="write the JSONL metric log "
                         "(launch/summarize.py --metrics)")


def obs_setup(args) -> bool:
    """Enable repro_torch.obs when any export flag is set; returns
    enablement."""
    if args.trace_out or args.metrics_out or args.events_out:
        obs.enable()
    return obs.enabled()


def obs_export(args) -> None:
    for path, write in ((args.trace_out, obs.write_trace),
                        (args.metrics_out, obs.write_prometheus),
                        (args.events_out, obs.write_jsonl)):
        if path:
            write(path)
            print(f"wrote {path}")


def add_resilience_flags(ap: argparse.ArgumentParser) -> None:
    """Serving-resilience knobs (the reference's flags)."""
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline (monotonic seconds from "
                         "arrival); expired requests are dropped, reported")
    ap.add_argument("--queue-cap", type=int, default=None,
                    help="bounded admission queue; submits past the cap "
                         "are shed")
    ap.add_argument("--retries", type=int, default=0,
                    help="transient-dispatch restart budget (0 = fail fast)")
    ap.add_argument("--retry-backoff-s", type=float, default=0.05)
    ap.add_argument("--integrity-every", type=int, default=None, metavar="N",
                    help="checksum the quantized payloads every N steps "
                         "and heal corruption from pristine copies")
    ap.add_argument("--degrade", action="store_true",
                    help="walk the serving bit ladder down under queue "
                         "pressure (and back up when it drains)")
    ap.add_argument("--degrade-high", type=int, default=8,
                    help="queue depth that counts as overload")
    ap.add_argument("--degrade-low", type=int, default=1,
                    help="queue depth that counts as drained")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="periodic engine snapshots via dist.checkpoint")
    ap.add_argument("--snapshot-every", type=int, default=16, metavar="N")
    ap.add_argument("--resume", action="store_true",
                    help="resume the continuous engine from the latest "
                         "snapshot in --snapshot-dir")


def resilience_from_args(args, params) -> ResilienceConfig | None:
    """The ResilienceConfig the flags describe (None if untouched).

    ``params`` is the engine's nominal serving tree — with ``--degrade``
    it becomes rung 0 of the ladder and the lower rungs are quantized
    down from it (already-quantized leaves pass through unchanged).
    """
    degrade = None
    if args.degrade:
        degrade = DegradePolicy(
            ladder=[("rung0", params)] + build_bit_ladder(params, (3, 2)),
            high_watermark=args.degrade_high,
            low_watermark=args.degrade_low)
    retry = RestartPolicy(max_restarts=args.retries,
                          backoff_base_s=args.retry_backoff_s,
                          reset_after=4) if args.retries else None
    if not any([args.deadline_s, args.queue_cap, retry,
                args.integrity_every, degrade, args.snapshot_dir]):
        return None
    return ResilienceConfig(
        queue_cap=args.queue_cap,
        default_deadline_s=args.deadline_s,
        retry=retry,
        integrity_every=args.integrity_every,
        degrade=degrade,
        snapshot_dir=args.snapshot_dir,
        snapshot_every=args.snapshot_every if args.snapshot_dir else None)


def add_requant_flags(ap: argparse.ArgumentParser) -> None:
    """Live-requantization knobs (DESIGN.md §15)."""
    g = ap.add_argument_group("requant")
    g.add_argument("--requant", action="store_true",
                   help="serve from a waterfilled plan and re-plan + "
                        "hot-swap live when traffic Σ drifts (needs "
                        "--continuous; incompatible with --degrade)")
    g.add_argument("--requant-budget", type=float, default=4.0,
                   help="global bit budget per param for the plan")
    g.add_argument("--requant-calib", type=int, default=2, metavar="N",
                   help="synthetic calibration batches for the initial plan")
    g.add_argument("--requant-limit", type=float, default=2.0,
                   help="sigma_fro divergence threshold arming the drift "
                        "detectors (relative Frobenius shift)")
    g.add_argument("--requant-min-samples", type=int, default=32)
    g.add_argument("--requant-cooldown", type=int, default=8)
    g.add_argument("--requant-max", type=int, default=None, metavar="K",
                   help="cap on actuations (default unbounded)")
    g.add_argument("--requant-sigma-every", type=int, default=2,
                   help="shadow Σ_X sampling period (engine ticks)")


def requant_from_args(args) -> RequantConfig | None:
    if not args.requant:
        return None
    return RequantConfig(min_samples=args.requant_min_samples,
                         cooldown_steps=args.requant_cooldown,
                         max_actuations=args.requant_max)


def _requant_engine(args, cfg, params, econfig):
    """Plan-driven engine with the live requant loop armed (§15)."""
    from repro_torch.plan import (build_plan, collect_sigma_x,
                                  model_sensitivities)
    from repro_torch.quant.pipeline import matrix_tap_map

    rng = np.random.default_rng(1)
    calib = [rng.integers(0, cfg.vocab,
                          (2, max(args.prompt_len, 8))).astype(np.int32)
             for _ in range(args.requant_calib)]
    sens = model_sensitivities(cfg, params, calib, weighting="output")
    plan = build_plan(sens, args.requant_budget, weighting="output")
    acc = collect_sigma_x(cfg, params, calib)
    qc = QualityConfig(
        sigma_every=args.requant_sigma_every,
        detectors=sigma_threshold_detectors(
            matrix_tap_map(cfg, params), limit=args.requant_limit))
    eng = engine_from_plan(cfg, params, plan, calib=acc,
                           sensitivities=sens, config=econfig,
                           continuous=True, quality_config=qc)
    print(f"requant armed: {plan.planned_bits_per_param:.2f} b/param plan, "
          f"limit={args.requant_limit} cooldown={args.requant_cooldown} "
          f"min_samples={args.requant_min_samples}")
    return eng


def _wbits_format(wbits: int) -> dict:
    """``quantize_params_tree``'s format options of ``--wbits`` 8/4/3/2:
    int8 codes, or the packed planar leaves."""
    return {} if wbits == 8 else {"nbits": wbits, "packed": wbits == 4}


def quantize_for_wbits(params, wbits: int):
    """The serving tree of ``--wbits``: 16 leaves the weights as they are,
    8 gives int8 codes, 4/3/2 the packed planar leaves."""
    if wbits == 16:
        return params
    return quantize_params_tree(params, **_wbits_format(wbits))


def f32_tree_bytes(cfg) -> int:
    """Bytes of ``init_params``' whole f32 tree of ``cfg`` (counted on
    ``meta`` tensors: nothing is allocated)."""
    return sum(x.numel() * x.element_size()
               for x in tree_leaves(init_params(cfg, device="meta")))


def free_bytes(device) -> int:
    """What ``device`` can still allocate: the card's free memory, or the
    host's free memory for the CPU."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def check_f32_tree_fits(cfg, free: int) -> None:
    """Refuse (SystemExit) a whole f32 tree of ``cfg`` larger than
    ``free`` bytes, before anything is allocated."""
    need = f32_tree_bytes(cfg)
    if need > free:
        raise SystemExit(
            f"{cfg.name}: its f32 tree takes {need / 1e9:.2f} GB and the "
            f"device has {free / 1e9:.2f} GB free; serve it quantized "
            "(--wbits 8, 4, 3 or 2), which builds it layer by layer")


def serving_tree(cfg, wbits: int, device):
    """The served tree of ``--wbits``.  A quantized format of a dense
    config is built layer by layer (``quantize_params_by_layer`` over
    ``init_layer_params``: the int4 tree of qwen2.5-32b plus one layer in
    f32, where its f32 tree alone is 128 GB); every other tree is drawn
    whole by ``init_params`` and quantized, once
    :func:`check_f32_tree_fits` has let it through."""
    if wbits != 16 and cfg.family == "dense":
        return quantize_params_by_layer(
            cfg, functools.partial(init_layer_params, cfg, 0, device=device),
            init_shared_params(cfg, 0, device=device),
            **_wbits_format(wbits))
    check_f32_tree_fits(cfg, free_bytes(device))
    return quantize_for_wbits(init_params(cfg, 0, device=device), wbits)


#: seconds before the ranks of a ``--mesh`` run are killed
MESH_TIMEOUT_S = 900.0


def main_mesh(args, cfg, device):
    """Tensor-parallel k-sharded serving (DESIGN.md §13).

    Shards the serving tree ``--ranks`` ways, runs it through (a) the
    single-process oracle (the default engine over the sharded tree, here,
    outside any mesh) and (b) one engine per rank on its local view, and
    requires every rank's streams to equal the oracle's.  ``--mesh-json``
    dumps the streams, the per-leaf inventory and the collective audit
    for ``benchmarks/check_mesh.py``.
    """
    import json

    from repro_torch.launch.mesh import (backend_rule, launch_ranks,
                                         staging_rule)
    from repro_torch.quant import (leaf_format_histogram, leaf_inventory,
                                   qweight_bytes)
    from repro_torch.serve import (MeshJob, run_oracle, serve_mesh_jobs,
                                   shard_params_tree)

    shards = args.ranks or (torch.cuda.device_count()
                            if device.type == "cuda" else 1)
    if device.type == "cuda":
        from repro_torch.kernels._build import build_all
        build_all()           # here, before the ranks would race to build
    params = shard_params_tree(serving_tree(cfg, args.wbits, device), shards)
    qb, _ = qweight_bytes(params)
    backend, why = backend_rule(shards, device)
    print(f"mesh serving: {shards}-way in-feature sharding over {shards} "
          f"ranks on {device}, backend {backend} ({why}), staging "
          f"{staging_rule(backend, device)} ({qb / 1e6:.2f} MB stored, "
          "per-shard pad included)")
    max_len = args.prompt_len + args.max_new + 2
    rng = np.random.default_rng(0)
    workload = [(0, i, rng.integers(0, cfg.vocab, args.prompt_len)
                 .astype(np.int32), args.max_new, None)
                for i in range(args.requests)]
    config = EngineConfig(n_slots=args.slots, max_len=max_len,
                          prefill_chunk=args.prefill_chunk or None,
                          resilience=resilience_from_args(args, params))
    job = MeshJob("serve", cfg, params, config, workload,
                  continuous=args.continuous)
    t0 = time.perf_counter()
    oracle = run_oracle(job)["streams"]
    print(f"  single-process oracle: {len(oracle)} requests in "
          f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    ranks = [r[0] for r in launch_ranks(serve_mesh_jobs, shards,
                                         ([job], shards), device=device,
                                         timeout_s=MESH_TIMEOUT_S)]
    print(f"  {shards}-rank mesh: {time.perf_counter() - t0:.2f}s with the "
          "ranks' start")
    meshed = ranks[0]["streams"]
    identical = all(r["streams"] == oracle for r in ranks)
    bad = sorted({line for r in ranks for line in r["integer_allgathers"]})
    n_ag = ranks[0]["allgathers"]
    print(f"  streams bit-identical on every rank: {identical}")
    print(f"  rank 0: {n_ag} all-gathers of {ranks[0]['allgather_dtypes']} "
          f"({ranks[0]['allgather_bytes']} B), {len(bad)} integer-payload "
          "all-gathers on any rank")
    if args.mesh_json:
        payload = {
            "shards": shards, "wbits": args.wbits,
            "continuous": bool(args.continuous),
            "weight_bytes": int(qb),
            "weight_formats": leaf_format_histogram(params),
            "inventory": leaf_inventory(params),
            "streams_oracle": oracle, "streams_mesh": meshed,
            "identical": identical,
            "allgather_lines": int(n_ag),
            "integer_allgathers": bad,
            "backend": backend,
        }
        with open(args.mesh_json, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        print(f"wrote {args.mesh_json}")
    obs_export(args)
    if not identical:
        raise SystemExit("mesh streams diverged from the oracle")
    if bad:
        raise SystemExit("weight payload bytes crossed ranks:\n"
                         + "\n".join(bad))
    return meshed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the depth to N layers at the config's width "
                         "(0: the config's depth)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--wbits", type=int, default=16, choices=[16, 8, 4, 3, 2])
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="tokens per prefill call (0 = per-token)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching instead of static rounds")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch twins)")
    ap.add_argument("--mesh", action="store_true",
                    help="tensor-parallel k-sharded serving over --ranks "
                         "rank processes, checked bit-identical against the "
                         "single-process oracle")
    ap.add_argument("--ranks", type=int, default=None,
                    help="with --mesh: rank processes = shards (default: "
                         "the card count, 1 on the CPU)")
    ap.add_argument("--mesh-json", default=None, metavar="PATH",
                    help="with --mesh: dump streams + storage inventory + "
                         "collective audit (input to check_mesh.py)")
    add_obs_flags(ap)
    add_resilience_flags(ap)
    add_requant_flags(ap)
    args = ap.parse_args(argv)
    if args.requant:
        if not args.continuous:
            ap.error("--requant requires --continuous")
        if args.degrade:
            ap.error("--requant is incompatible with --degrade (both "
                     "hot-swap the served tree)")
        if args.mesh:
            ap.error("--requant does not support --mesh yet")
    if args.resume and not (args.continuous and args.snapshot_dir):
        ap.error("--resume needs --continuous and --snapshot-dir")
    device = resolve_device(args.device)
    if not obs_setup(args) and args.requant:
        obs.enable()   # the sense→act loop samples behind repro_torch.obs

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    if args.mesh:
        return main_mesh(args, cfg, device)
    if args.requant:        # plans from the f32 weights
        check_f32_tree_fits(cfg, free_bytes(device))
        params = init_params(cfg, 0, device=device)
    else:
        params = serving_tree(cfg, args.wbits, device)
    # the driver builds exactly ONE EngineConfig; every construction path
    # below (fresh, resumed, plan-driven) consumes it
    econfig = EngineConfig(n_slots=args.slots,
                           max_len=args.prompt_len + args.max_new + 2,
                           prefill_chunk=args.prefill_chunk or None,
                           resilience=resilience_from_args(args, params),
                           requant=requant_from_args(args))
    cls = ContinuousEngine if args.continuous else ServeEngine
    if args.resume:
        eng = ContinuousEngine.resume(args.snapshot_dir, cfg, params,
                                      config=econfig)
        print(f"resumed from snapshot at tick {eng._tick} "
              f"({eng.active_slots} slots live, {len(eng.queue)} queued)")
    elif args.requant:
        eng = _requant_engine(args, cfg, params, econfig)
    else:
        eng = cls(cfg, params, config=econfig)
    print(f"{cfg.name} on {device}: wbits={args.wbits} "
          f"weight bytes {eng.weight_bytes} (bf16 {eng.weight_bytes_bf16}) "
          f"formats {eng.weight_formats}")
    rng = np.random.default_rng(0)
    if not args.resume:
        for i in range(args.requests):
            eng.submit(Request(rid=i, prompt=rng.integers(
                0, cfg.vocab, args.prompt_len).astype(np.int32),
                max_new_tokens=args.max_new))
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    if args.requant:
        # drifted second phase: repeated-token prompts collapse the live
        # Σ toward rank one, 2x the clean traffic so the drifted samples
        # dominate the streamed estimate
        for i in range(2 * args.requests):
            eng.submit(Request(rid=args.requests + i,
                               prompt=np.full(args.prompt_len, 7, np.int32),
                               max_new_tokens=args.max_new))
        done += eng.run_until_done()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in done)
    sched = "continuous" if args.continuous else "static"
    print(f"served {len(done)} requests, {total} tokens in {dt:.3f}s "
          f"({total / dt:.1f} tok/s, {sched})")
    print(f"  packed-kernel launches: {sum(LAUNCHES.values())} "
          f"(int4 {LAUNCHES[4]}, int3 {LAUNCHES[3]}, int2 {LAUNCHES[2]})")
    if eng.resilience is not None:
        for r in eng.dropped:
            print(f"  dropped rid={r.rid} ({r.drop_reason})")
        if eng.rung_history:
            print("  rungs: " + " -> ".join(
                f"{name}@{tick}" for tick, name, _ in eng.rung_history))
    if args.requant:
        acts = eng.requant.actuations if eng.requant else []
        print(f"  requant actuations: {len(acts)}")
        for a in acts:
            moved = {n: (a["payload_before"][n], a["payload_after"][n])
                     for n in a["matrices"]
                     if a["payload_before"][n] != a["payload_after"][n]}
            print(f"    tick={a['tick']} taps={','.join(a['taps'])} "
                  f"matrices={len(a['matrices'])} moved={moved or 'none'} "
                  f"replan={a['wall_s'] * 1e3:.0f}ms")
    for r in done[:4]:
        print(f"  rid={r.rid} out={r.out_tokens[:8]}")
    obs_export(args)
    return done


if __name__ == "__main__":
    main()
