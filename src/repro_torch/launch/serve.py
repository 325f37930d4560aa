"""Serving driver (port of ``repro/launch/serve.py``): a batched engine
over random weights, optionally WaterSIC-quantized — int8 codes or a rung
of the packed sub-byte ladder (``--wbits {16,8,4,3,2}``).

Runs on the card unless ``--device cpu`` is given (and raises when there
is no card).  Prints tokens/s, the weight bytes, and the number of
packed-kernel launches the run made.

``--trace-out``/``--metrics-out``/``--events-out`` enable
``repro_torch.obs`` (DESIGN.md §11) and export the run's Chrome trace
(Perfetto), Prometheus text exposition and JSONL metric log (the input to
``launch/summarize.py --metrics``, this package's or the reference's).

    python -m repro_torch.launch.serve --arch minicpm-2b --wbits 4 \
        --requests 8 --continuous --prefill-chunk 16 \
        --trace-out trace.json --metrics-out serve.prom \
        --events-out events.jsonl
    python -m repro_torch.launch.summarize --metrics events.jsonl
    python -m repro_torch.launch.serve --arch minicpm-2b --reduced \
        --wbits 3 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.configs import get_config
from repro_torch.kernels.dequant import LAUNCHES, reset_launches
from repro_torch.models import init_params
from repro_torch.quant import quantize_params_tree
from repro_torch.serve import (ContinuousEngine, EngineConfig, Request,
                               ServeEngine)

__all__ = ["quantize_for_wbits", "add_obs_flags", "obs_setup",
           "obs_export", "main"]


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


def quantize_for_wbits(params, wbits: int):
    """The serving tree of ``--wbits``: 16 leaves the weights as they are,
    8 gives int8 codes, 4/3/2 the packed planar leaves."""
    if wbits == 16:
        return params
    if wbits == 8:
        return quantize_params_tree(params)
    return quantize_params_tree(params, nbits=wbits, packed=wbits == 4)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
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
    add_obs_flags(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    obs_setup(args)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = quantize_for_wbits(init_params(cfg, 0, device=device),
                                args.wbits)
    econfig = EngineConfig(n_slots=args.slots,
                           max_len=args.prompt_len + args.max_new + 2,
                           prefill_chunk=args.prefill_chunk or None)
    cls = ContinuousEngine if args.continuous else ServeEngine
    eng = cls(cfg, params, config=econfig)
    print(f"{cfg.name} on {device}: wbits={args.wbits} "
          f"weight bytes {eng.weight_bytes} (bf16 {eng.weight_bytes_bf16}) "
          f"formats {eng.weight_formats}")
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new))
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in done)
    sched = "continuous" if args.continuous else "static"
    print(f"served {len(done)} requests, {total} tokens in {dt:.3f}s "
          f"({total / dt:.1f} tok/s, {sched})")
    print(f"  packed-kernel launches: {sum(LAUNCHES.values())} "
          f"(int4 {LAUNCHES[4]}, int3 {LAUNCHES[3]}, int2 {LAUNCHES[2]})")
    for r in done[:4]:
        print(f"  rid={r.rid} out={r.out_tokens[:8]}")
    obs_export(args)
    return done


if __name__ == "__main__":
    main()
