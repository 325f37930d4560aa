#!/usr/bin/env python3
"""Time and profile the port's four kernels alone, on one card: B1
(packed dequant-matmul), B2 (int8 dequant-matmul), B3 (flash attention
forward) and B4 (in-block ZSIC recursion).

    python3 kernel_bench.py [--src DIR] [--tag NAME] [--sweep]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so one command can time two trees on one
card: unpack another commit with ``git archive`` into a git-ignored
directory (``scratch/``) and run both in turns.  For each shape of the
serving and ``model_ppl`` paths it prints the CUDA-event median of one
call with L2 cold (as ``chip_smoke.py`` times it) and a ``torch.profiler``
trace of 10 warm calls: every device kernel a call launches, with its
count and device µs per call.  The kernels' ``ptxas`` lines (registers,
spills, shared memory) come first, with the SASS instruction count of
every kernel function where ``cuobjdump`` is present.  B2 runs at m = 1,
8 and 128 on the serving shapes (its mixed-serve mix is wq/wk/wv at m =
8, (2304, 2304)); B4 at the PTQ path's row counts with bn = 128 (and its
PTQ mix, weighted by ``ZSIC_PTQ_MIX``), plus bn = 1, 32 and 64 at a =
2304, which separates a launch's fixed cost from the per-column chain.
B1 and B2 also run at the full-sequence rows of PERF.md §6 (``FULL_M``:
m = 256 on the serving shapes for every format and on the k-shard shapes,
m = 128 on the Qwen-scale shapes, m = 2304 and 12000 on paligemma-3b's and
whisper-base's), on whichever kernel the tree's wrapper picks there.
``--sweep`` (a tree with the tensor-core path) times both of B1's and
B2's kernels, called directly, at m ∈ ``SWEEP_M`` on the serving shapes
for every format, the sweep that fixes ``TC_MIN_M``.  Results also go to
``chiprun_out/kernel_bench_<tag>.json`` and B4's SASS listing to
``chiprun_out/zsic_block_<tag>.sass``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: ZSIC block launches by row count in one ``hptq`` run of the chip smoke
#: (2 full-width minicpm-2b layers at 3 bits)
ZSIC_PTQ_MIX = {230: 468, 576: 144, 2304: 234, 5760: 72}
#: block widths of the chain-length sweep at a = 2304
ZSIC_BN_SWEEP = (1, 32, 64)
#: rows of the crossover sweep of B1's and B2's two kernels
SWEEP_M = (16, 24, 32, 48, 64, 128)
#: B1/B2 at full-sequence rows, (m, k, n, formats): the prefill of 8 × 32
#: tokens on the serving shapes and the k-shard shapes, the Qwen-scale
#: shapes at 8 × 16, paligemma-3b's prefill of 8 × 288 and whisper-base's
#: encoder over 8 × 1500 frames
FULL_M = [(256, k, n, (4, 3, 2, 8)) for k, n in
          ((2304, 2304), (2304, 5760), (5760, 2304))] \
    + [(256, k, n, (4, 8)) for k, n in ((576, 2304), (576, 5760),
                                        (1440, 2304))] \
    + [(128, k, n, (4,)) for k, n in (
        (5120, 5120), (5120, 1024), (5120, 27648), (27648, 5120),
        (5120, 27392), (27392, 5120), (4096, 4096), (4096, 1024),
        (4096, 16384), (16384, 4096))] \
    + [(2304, k, n, (4,)) for k, n in ((2048, 2048), (2048, 256),
                                       (2048, 16384), (16384, 2048))] \
    + [(12000, k, n, (4,)) for k, n in ((512, 512), (512, 2048),
                                        (2048, 512))]


def dequant_operands(nbits, m, k, n, dev, gen):
    """B1's (x_groups, payload, s_groups, t) or B2's (x, z, s, t) at one
    shape, from ``gen``; B2's codes stored (k, n) as a serving leaf stores
    them, z their (n, k) view."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.packing import pack_codes_torch
    from repro_torch.kernels.dequant import PLANE_GROUPS
    x = torch.randn((m, k), generator=gen, device=dev)
    t = torch.rand(n, generator=gen, device=dev) + 0.5
    s = (torch.rand(k, generator=gen, device=dev) * 0.2 + 0.01) / k ** 0.5
    if nbits == 8:
        codes = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.int8)
        return x, codes.T, s / 30, t
    hi = {4: 8, 3: 4, 2: 2}[nbits]
    z = torch.randint(-hi, hi, (n, k), generator=gen, device=dev,
                      dtype=torch.int32)
    payload = pack_codes_torch(z, nbits=nbits)[0]
    g, kg = PLANE_GROUPS[nbits], payload.shape[-1]
    xg = F.pad(x, (0, g * kg - k)).contiguous().view(m, g, kg)
    sg = F.pad(s, (0, g * kg - k)).contiguous().view(g, kg)
    return xg, payload, sg, t


def dequant_call(nbits, ops):
    """One B1 (nbits 4, 3, 2) or B2 (8) call through the tree's wrapper."""
    from repro_torch.kernels.dequant import (dequant_matmul_int8_cuda,
                                             dequant_matmul_packed_cuda)
    if nbits == 8:
        return lambda: dequant_matmul_int8_cuda(*ops)
    return lambda: dequant_matmul_packed_cuda(*ops, nbits=nbits)


def path_calls(nbits, ops):
    """{"decode": call, "tc": call}: B1's or B2's two kernels called
    directly through their C entry points, whatever m is."""
    import importlib

    import torch
    wrapper = importlib.import_module(
        "repro_torch.kernels.dequant.dequant_matmul")
    x, z, s, t = ops
    m, n = x.shape[0], z.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    calls = {}
    for path, suffix in (("decode", ""), ("tc", "_tc")):
        if nbits == 8:
            fn = wrapper._launcher("dequant_int8",
                                   f"dequant_matmul_int8{suffix}_f32",
                                   wrapper._INT8_ARGS)
            extra = (x.shape[1], z.stride(1))
        else:
            fn = wrapper._launcher("dequant_packed",
                                   f"dequant_matmul_packed{suffix}_f32",
                                   wrapper._PACKED_ARGS)
            extra = (x.shape[-1], nbits)

        def call(fn=fn, extra=extra):
            err = fn(x.data_ptr(), z.data_ptr(), s.data_ptr(), t.data_ptr(),
                     out.data_ptr(), m, n, *extra,
                     torch.cuda.current_stream(x.device).cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError_t {err}")
            return out
        calls[path] = call
    return calls


def sass_counts(lib, dump=None, opcode=None):
    """Kernel function → SASS instruction count of a built library (empty
    without ``cuobjdump``); with ``opcode`` only the instructions whose
    mnemonic starts with it (``HGMMA``: Hopper's warpgroup products).  The
    listing also goes to ``dump``."""
    import os
    import re
    import shutil
    tool = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" \
        / "cuobjdump"
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        return {}
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    if dump is not None:
        dump.write_text(out)
    counts, fn = {}, None
    for line in out.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = 0
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                       line)
        if fn and ins and (opcode is None or ins.group(1).startswith(opcode)):
            counts[fn] += 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--sweep", action="store_true",
                    help="time B1's and B2's two kernels at m in SWEEP_M")
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
                                             dequant_matmul_int8_cuda,
                                             dequant_matmul_packed_cuda)
    from repro_torch.kernels.flash import flash_attention_cuda
    from repro_torch.kernels.zsic import zsic_block_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    print(f"[{args.tag}] {repro_torch.__file__}\n{smi.stdout.strip()}",
          flush=True)
    _build.build_all()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    rec_sass = {}
    for stem in ("dequant_packed", "dequant_int8", "flash_attention",
                 "zsic_block"):
        for line in _build.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {stem}: {line.strip()}")
        rec_sass[stem] = sass_counts(
            _build._target(_build.sources()[stem]),
            out / f"{stem}_{args.tag}.sass" if stem == "zsic_block" else None)
        for fn, count in rec_sass[stem].items():
            print(f"sass {stem}: {fn} {count} instructions")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    cs.device_ms(lambda: flush.max(), dev, flush=flush)
    rec = {"device": smi.stdout.strip(), "tag": args.tag, "packed": [],
           "int8": [], "flash": [], "zsic": [], "sass": rec_sass,
           "full_m": [], "sweep": []}
    for m, k, n, formats in FULL_M:
        for nbits in formats:
            ops = dequant_operands(nbits, m, k, n, dev, gen)
            c = {"nbits": nbits, "m": m, "k": k, "n": n,
                 "ms": cs.device_ms(dequant_call(nbits, ops), dev,
                                    flush=flush)}
            rec["full_m"].append(c)
            print(f"[{args.tag}] full-sequence {'int8' if nbits == 8 else f'packed int{nbits}'}"
                  f" m={m} k={k} n={n}: {1e3 * c['ms']:.2f} us", flush=True)
            del ops
    if args.sweep:
        for nbits in (4, 3, 2, 8):
            for m in SWEEP_M:
                for k, n in cs.PATH_SHAPES:
                    calls = path_calls(nbits, dequant_operands(
                        nbits, m, k, n, dev, gen))
                    c = {"nbits": nbits, "m": m, "k": k, "n": n}
                    for path, call in calls.items():
                        c[f"{path}_ms"] = cs.device_ms(call, dev, flush=flush)
                    rec["sweep"].append(c)
                    print(f"[{args.tag}] sweep nbits={nbits} m={m} k={k} "
                          f"n={n}: decode {1e3 * c['decode_ms']:.2f} us, "
                          f"tensor cores {1e3 * c['tc_ms']:.2f} us", flush=True)
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
                     "kernels": cs.profile_kernels(call, dev)}
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
             "kernels": cs.profile_kernels(call, dev)}
        rec["flash"].append(c)
        print(f"[{args.tag}] flash B*H=144 S={s} d=64 window={window}: "
              f"{1e3 * c['ms']:.2f} us; kernels {c['kernels']}", flush=True)
    for m in (1, 8, 128):
        for k, n in cs.PATH_SHAPES:
            x = torch.randn((m, k), generator=gen, device=dev)
            z = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.int8).T
            s = (torch.rand(k, generator=gen, device=dev) * 0.2 + 0.01) \
                / k ** 0.5 / 30
            t = torch.rand(n, generator=gen, device=dev) + 0.5

            def call():
                return dequant_matmul_int8_cuda(x, z, s, t)
            c = {"m": m, "k": k, "n": n,
                 "ms": cs.device_ms(call, dev, flush=flush),
                 "kernels": cs.profile_kernels(call, dev)}
            rec["int8"].append(c)
            print(f"[{args.tag}] int8 m={m} k={k} n={n}: {1e3 * c['ms']:.2f}"
                  f" us; kernels {c['kernels']}", flush=True)
    rec["int8_m8_mixed_serve_mix_ms"] = next(
        c["ms"] for c in rec["int8"] if c["m"] == 8 and c["k"] == c["n"])
    zcases = [(a, 128) for a in cs.ZSIC_ROWS] \
        + [(2304, bn) for bn in ZSIC_BN_SWEEP]
    for a, bn in zcases:
        (y, l, alphas), _ = cs.zsic_operands(a, bn, dev, seed=a + bn)

        def call():
            return zsic_block_cuda(y, l, alphas)
        c = {"a": a, "bn": bn, "ms": cs.device_ms(call, dev, flush=flush),
             "warm_ms": cs.device_ms(call, dev),
             "kernels": cs.profile_kernels(call, dev)}
        rec["zsic"].append(c)
        print(f"[{args.tag}] zsic a={a} bn={bn}: {1e3 * c['ms']:.2f} us "
              f"(L2 warm {1e3 * c['warm_ms']:.2f}); kernels {c['kernels']}",
              flush=True)
    by_a = {c["a"]: c for c in rec["zsic"] if c["bn"] == 128}
    rec["zsic_ptq_mix_ms"] = sum(n * by_a[a]["ms"] for a, n
                                 in ZSIC_PTQ_MIX.items()) \
        / sum(ZSIC_PTQ_MIX.values())
    print(f"[{args.tag}] int8 m=8 mixed-serve mix: "
          f"{1e3 * rec['int8_m8_mixed_serve_mix_ms']:.2f} us; zsic PTQ mix: "
          f"{1e3 * rec['zsic_ptq_mix_ms']:.2f} us", flush=True)
    (out / f"kernel_bench_{args.tag}.json").write_text(json.dumps(rec,
                                                                  indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
