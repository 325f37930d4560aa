#!/usr/bin/env python3
"""Time and profile the port's B1 (packed dequant-matmul) and B3 (flash
attention forward) kernels alone, on one card.

    python3 kernel_bench.py [--src DIR] [--tag NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so one command can time two trees on one
card: unpack another commit with ``git archive`` into a git-ignored
directory (``scratch/``) and run both in turns.  For each shape of the
serving and ``model_ppl`` paths it prints the CUDA-event median of one
call with L2 cold (as ``chip_smoke.py`` times it) and a ``torch.profiler``
trace of 10 warm calls: every device kernel a call launches, with its
count and device µs per call.  The kernels' ``ptxas`` lines (registers,
spills, shared memory) come first.  Results also go to
``chiprun_out/kernel_bench_<tag>.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def profile_kernels(fn, dev, calls=10):
    """Device kernels of ``calls`` calls of ``fn``: name → (launches per
    call, device µs per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(dev)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + (e.time_range.end
                                            - e.time_range.start))
    return {name[:60]: {"per_call": n / calls, "us_per_call": us / calls}
            for name, (n, us) in by_name.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("kernel_bench: torch.cuda is not available", file=sys.stderr)
        return 2
    # this checkout's chip_smoke supplies the timing and operand helpers;
    # repro_torch is already imported from --src, so it is the one used
    import repro_torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.dequant import (PLANE_GROUPS,
                                             dequant_matmul_packed_cuda)
    from repro_torch.kernels.flash import flash_attention_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    print(f"[{args.tag}] {repro_torch.__file__}\n{smi.stdout.strip()}",
          flush=True)
    _build.build_all()
    for stem in ("dequant_packed", "flash_attention"):
        for line in _build.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {stem}: {line.strip()}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    cs.device_ms(lambda: flush.max(), dev, flush=flush)
    rec = {"device": smi.stdout.strip(), "tag": args.tag, "packed": [],
           "flash": []}
    for nbits in (4, 3, 2):
        for m in (1, 8):
            for k, n in cs.PATH_SHAPES:
                x, payload, s, t, _ = cs.operands(m, k, n, nbits, dev, gen)
                g, kg = PLANE_GROUPS[nbits], payload.shape[-1]
                xg = torch.nn.functional.pad(x, (0, g * kg - k)) \
                    .contiguous().view(m, g, kg)
                sg = torch.nn.functional.pad(s, (0, g * kg - k)) \
                    .contiguous().view(g, kg)

                def call():
                    return dequant_matmul_packed_cuda(xg, payload, sg, t,
                                                      nbits=nbits)
                c = {"nbits": nbits, "m": m, "k": k, "n": n,
                     "ms": cs.device_ms(call, dev, flush=flush),
                     "kernels": profile_kernels(call, dev)}
                rec["packed"].append(c)
                print(f"[{args.tag}] packed int{nbits} m={m} k={k} n={n}: "
                      f"{1e3 * c['ms']:.2f} us; kernels {c['kernels']}",
                      flush=True)
        for m in (1, 8):
            mix = sum(cs.PER_LAYER[(c["k"], c["n"])] * c["ms"]
                      for c in rec["packed"]
                      if c["nbits"] == nbits and c["m"] == m) / 7
            rec[f"int{nbits}_m{m}_mix_ms"] = mix
            print(f"[{args.tag}] packed int{nbits} m={m} decode mix: "
                  f"{1e3 * mix:.2f} us per launch", flush=True)
    for s, window in ((256, 0), (128, 0), (256, 64)):
        q, k, v = [torch.randn((4, s, 36, 64), generator=gen, device=dev)
                   for _ in range(3)]

        def call():
            return flash_attention_cuda(q, k, v, causal=True, window=window)
        c = {"bh": 144, "s": s, "d": 64, "window": window,
             "ms": cs.device_ms(call, dev, flush=flush),
             "kernels": profile_kernels(call, dev)}
        rec["flash"].append(c)
        print(f"[{args.tag}] flash B*H=144 S={s} d=64 window={window}: "
              f"{1e3 * c['ms']:.2f} us; kernels {c['kernels']}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"kernel_bench_{args.tag}.json").write_text(json.dumps(rec,
                                                                  indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
