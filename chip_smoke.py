#!/usr/bin/env python3
"""Chip smoke of the PyTorch + CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any mismatch raises and the run exits non-zero:

1. the card's name and power limit, and the build of every CUDA kernel
   from the sources in this checkout (``kernels/_build.py``, one ``nvcc``
   per source, all in parallel);
2. kernel phase: the packed dequant-matmul kernel against its plain
   PyTorch twin for int4/int3/int2 payloads at the serving path's shapes
   (m ∈ {1, 8}; (k, n) ∈ {(2304, 2304), (2304, 5760), (5760, 2304)}), plus
   a ragged-k case and an escape case, each kernel call run twice (equal
   bits: the split-K sums are added in a fixed order; the escapes'
   ``index_add_`` is not); each case prints the kernel time,
   the twin's time, one library call's time (``F.linear`` against the
   pre-dequantized f32 weight) and the least time the card could take
   (``bound_ms``, the larger of the bytes over 3.35 TB/s and the 2·m·n·k
   multiply-adds done exactly on the bf16 tensor cores: codes are exact in
   bf16 and f32 x·s splits into three bf16 terms, 3 products at 989
   TFLOP/s; the f32 CUDA-core time of the same count, at 67 TFLOP/s, is
   ``f32_cuda_core_ms`` in the detail file);
2b. int8 kernel phase: the int8 dequant-matmul kernel against its twin
   (``ref.dequant_matmul_ref``) at (k, n) ∈ the three shapes above and
   m ∈ {1, 8, 128}, with the codes stored (k, n) as a serving leaf stores
   them and read in place through their transposed view, and in an (n,
   k)-contiguous matrix (copied by the wrapper into that layout), plus the
   ragged (2300, 5757); each run twice (equal bits).  The
   serving layout is timed with L2 cold: the kernel, the twin, ``F.linear``
   against the pre-dequantized weight and the plain product the serving
   path ran before the kernel (``before_ms``), with the bound (bytes
   against 2·m·n·k f32 multiply-adds on the CUDA cores);
3. the ZSIC block kernel against its twin, bit for bit, at bn = 128 and the
   PTQ path's row counts (230, 576, 2304, 5760), with its bound (bytes of
   y, codes, residual and the L block against the a·bn·(bn+1)/2 unfused
   multiply-subtracts, 2 f32 instructions each, and the a·bn divisions and
   roundings on the CUDA cores; no library call computes ZSIC), its event
   time (L2 cold) beside its device time (``torch.profiler``, warm); then one
   full ``zsic_quantize`` at (2304, 2304), which launches the kernel on
   strided column slices as the PTQ path does, against the same run through
   the twin (bit for bit) and against ``zsic_numpy`` in float64 (≥ 99.9 %
   of the codes equal, Lemma 3.2);
4. the flash attention kernel against its twin at minicpm-2b's heads
   (B·H = 4·36, d = 64), S ∈ {128, 256, 200}, window ∈ {0, 64}, causal,
   with ``F.scaled_dot_product_attention`` timed as the library call (never
   called by the port); untimed, d = 128 and d = 256 (B·H = 4), S = 1, S
   below one query tile and a ragged S without the causal mask;
5. serve phase: minicpm-2b at full width and depth, packed int4,
   ``ContinuousEngine`` with 8 slots serving 8 requests (prompt 32, 16 new
   tokens, max_len 64, prefill chunk 16).  First-step logits through the
   kernel are held against the dequantized-weight model, and the kernel
   must have been launched 7 × 40 times per decode step; then a few
   decode steps at that batch are timed on the host clock and traced with
   ``torch.profiler`` for the device's busy and idle share of the step and
   the packed kernels' device time; one decode step captured in a CUDA
   graph must hold one device kernel per packed dense (its kernel nodes
   counted by name: the profiler now and then drops the record of a
   kernel launched as a thread-block cluster);
6. ladder phase: the same at full width and 4 layers for int3 and int2;
7. PTQ phase: minicpm-2b at full width cut to 2 layers, weights from the
   port's ``init_params`` (seed 0), calibration 2 batches of 4 × 128 and
   evaluation 1 batch of 4 × 257 numpy tokens.  ``quantize_model`` runs
   ``watersic`` (the LMMSE column loop) and ``hptq`` (the ZSIC kernel) at
   3 bits; each prints its realized rate (within 0.05 of 3), seconds per
   matrix, ZSIC-kernel launches (> 0 for hptq) and, from the same run, the
   synchronized host time of its main spans; ``model_ppl`` of the
   float, watersic and hptq models runs through the flash kernel (2 layers
   × 1 batch launches per call) and through the twin;
8. serve-after-PTQ phase: the watersic codes installed as packed int4
   leaves (``from_watersic``, escapes included) serve 4 requests (prompt
   16, 8 new tokens); first-step logits against the model with
   ``QuantizedLinear.dequant()`` weights;
9. plan phase: ``python -m repro_torch.launch.plan build`` in process
   (minicpm-2b at full width cut to 2 layers, numpy weights and tokens
   from seed 0, 2 calibration batches of 32 × 128, ``output`` weighting,
   5.0 bits per parameter): the snapped plan must hold int8 and sub-byte
   payloads, reload equal and ``inspect``; ``plan_inputs_for_model`` +
   ``execute_plan(quantize_kwargs={"lmmse": False})`` (WaterSIC spacing,
   ZSIC through its kernel) runs the snapped plan on 1 and on 4 worker
   threads (codes, α, γ and t equal tensor for tensor), then the
   continuous waterfilled optimum and ``even_plan`` at the same budget:
   realized bits within 0.05 of planned each, and the waterfilled
   weighted output distortion below the even spread's;
10. mixed serve phase: ``serving_formats_from_plan`` of that plan on
   minicpm-2b at full width and depth (40 layers): the int8 types through
   the int8 kernel, the others through the packed one (each kernel once
   per layer of each of its leaves per decode step, and a decode step
   captured in a CUDA graph holding one device kernel per int8 and per
   packed call),
   first-step logits against the dequantized-weight model, the serve
   phase's 8 requests;
   then a 2-layer copy's greedy streams from ``ServeEngine`` and
   ``ContinuousEngine`` must be identical.

The second-to-last line is the kernel summary JSON (six entries: the
packed kernel per payload, the int8 kernel, ZSIC and flash), the last
line ``{"ok": true, "device": {...}}``.  Per-case numbers also go to
``chiprun_out/chip_smoke_detail.json``.  Tolerances:

* dequant kernels (packed and int8) vs twin: |Δ| ≤ 1e-4 + 1e-4·|twin|
  (inputs scaled so outputs are O(1); f32 sums over k ≤ 5760 in another
  order differ by ≈ eps·√k);
* ZSIC kernel vs twin: equal bit for bit (the same divisions, roundings
  and unfused products and subtractions);
* flash kernel vs twin: |Δ| ≤ 2e-5 + 2e-5·|twin| (f32 sums of the same
  terms in another order: online against materialized softmax);
* ``model_ppl`` through the kernel vs through the twin: 1e-5 relative;
* logits vs the float-weight model: max|Δ| ≤ 1e-3 · max|logits|
  (f32 sums in another order over 40 layers).
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (CODE_RANGE, chol_lower,  # noqa: E402
                              random_covariance, zsic_numpy)
from repro_torch.core.packing import pack_codes  # noqa: E402
from repro_torch.kernels import _build, flash  # noqa: E402
from repro_torch.kernels.flash import (attention_ref,  # noqa: E402
                                       flash_attention_cuda)
from repro_torch.kernels.flash import \
    reset_launches as reset_flash_launches  # noqa: E402
from repro_torch.kernels.zsic import ops as zsic_ops  # noqa: E402
from repro_torch.kernels.zsic import (zsic_block_cuda,  # noqa: E402
                                      zsic_block_ref, zsic_quantize)
from repro_torch.kernels.zsic import \
    reset_launches as reset_zsic_launches  # noqa: E402
from repro_torch.kernels.dequant import (LAUNCHES, PLANE_GROUPS,  # noqa: E402
                                         dequant_matmul,
                                         dequant_matmul_int8_cuda,
                                         dequant_matmul_packed_cuda,
                                         dequant_matmul_packed_ref,
                                         dequant_matmul_ref,
                                         dequantize_leaf_ref, dequantize_ref,
                                         payload_nbits, reset_launches,
                                         unpack_payload_ref)
from repro_torch.launch import plan as launch_plan  # noqa: E402
from repro_torch.launch.serve import quantize_for_wbits  # noqa: E402
from repro_torch.models import decode_chunk, decode_step  # noqa: E402
from repro_torch.models import (init_cache, init_params,  # noqa: E402
                                split_layers)
from repro_torch.models.layers import unembed  # noqa: E402
from repro_torch.plan import (QuantPlan, build_plan, even_plan,  # noqa: E402
                              execute_plan, model_sensitivities,
                              plan_inputs_for_model)
from repro_torch.quant import (from_watersic, is_qweight,  # noqa: E402
                               leaf_format_histogram, quantize_params_tree,
                               qweight_bytes, serving_formats_from_plan)
from repro_torch.quant.pipeline import (PTQConfig, model_ppl,  # noqa: E402
                                        quantize_model)
from repro_torch.serve import (ContinuousEngine, EngineConfig,  # noqa: E402
                               Request, ServeEngine)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
F32_INSTR_PER_S = F32_FLOP_PER_S / 2  # f32 instructions/s (an FMA is 2 flops)
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
#: bf16 tensor-core products per f32 product done exactly (x·s in 3 terms)
BF16_TERMS = 3
PATH_SHAPES = [(2304, 2304), (2304, 5760), (5760, 2304)]
#: per decoder layer: wq wk wv wo at (2304, 2304), w_gate w_up at
#: (2304, 5760), w_out at (5760, 2304)
PER_LAYER = {(2304, 2304): 4, (2304, 5760): 2, (5760, 2304): 1}
KERNEL_TOL = 1e-4
LOGIT_TOL = 1e-3
#: flash kernel vs twin: f32 sums of the same terms in another order
#: (online softmax against the materialized one) on O(1) outputs
FLASH_TOL = 2e-5
#: model_ppl through the kernel vs through the twin, relative
PPL_TOL = 1e-5
#: rows of the ZSIC block launches on the PTQ path at minicpm-2b's widths:
#: the secant search's 10 % subsamples of 2304 and 5760 rows, and the
#: full matrices
ZSIC_ROWS = (230, 576, 2304, 5760)
_HI = {4: 8, 3: 4, 2: 2}
SOURCE = "src/repro_torch/kernels/dequant/csrc/dequant_packed.cu"
REPLACES = "src/repro/kernels/dequant/dequant_matmul.py:179"
ZSIC_SOURCE = "src/repro_torch/kernels/zsic/csrc/zsic_block.cu"
ZSIC_REPLACES = "src/repro/kernels/zsic/zsic_block.py:111"
FLASH_SOURCE = "src/repro_torch/kernels/flash/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash/flash_attention.py:99"
INT8_SOURCE = "src/repro_torch/kernels/dequant/csrc/dequant_int8.cu"
INT8_REPLACES = "src/repro/kernels/dequant/dequant_matmul.py:79"
#: the int8 kernel's rows: decode at 1 and 8 slots, a 16-token prefill
#: chunk of 8 slots
INT8_M = (1, 8, 128)
#: the ragged int8 case (k, n): neither a multiple of the kernel's tiles
INT8_RAGGED = (2300, 5757)
#: the plan phase's global budget, bits per parameter: between the grid's
#: int4 and int8 rungs, so the snapped plan must mix sub-byte and int8
PLAN_BITS = 5.0
#: rows of each of the plan phase's 2 calibration batches of 128 tokens:
#: 8192 tokens, so every Σ_X (up to 5760 wide) can have full rank.  With
#: fewer tokens than in-features the planner's curves promise near-zero
#: distortion in Σ_X's null space, which the damped quantizer does not
#: deliver (at 2 × 4 × 128 tokens the waterfilled allocation realized
#: 1.85× the even spread's weighted distortion on the card)
PLAN_CALIB_ROWS = 32
#: (k, n) of each matrix type of a minicpm-2b layer, by (block, name)
TYPE_SHAPES = {("attn", "wq"): (2304, 2304), ("attn", "wk"): (2304, 2304),
               ("attn", "wv"): (2304, 2304), ("attn", "wo"): (2304, 2304),
               ("mlp", "w_gate"): (2304, 5760), ("mlp", "w_up"): (2304, 5760),
               ("mlp", "w_out"): (5760, 2304)}


def device_ms(fn, dev, *, reps=25, flush=None):
    """Median device time of ``fn`` (CUDA events), launches queued behind
    a spin kernel so host overhead never shows; ``flush`` (a > 50 MB
    buffer) is read between launches so each finds L2 cold (read, not
    written: the evicted lines are clean, as they are between the weight
    reads of a decode step)."""
    fn()
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(20_000_000)
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.sum()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize(dev)
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def profile_kernels(fn, dev, calls=10):
    """Device kernels of ``calls`` warm calls of ``fn`` in a
    ``torch.profiler`` trace: name → {"per_call": launches per call,
    "us_per_call": device µs per call}."""
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


def operands(m, k, n, nbits, dev, gen, *, esc=False):
    """x (m, k), planar payload of codes (n, k), s, t and escapes."""
    x = torch.randn((m, k), generator=gen, device=dev)
    hi = _HI[nbits] + (5 if esc else 0)
    z = torch.randint(-hi, hi, (n, k), generator=gen, device=dev,
                      dtype=torch.int32)
    s = (torch.rand(k, generator=gen, device=dev) * 0.2 + 0.01) / k ** 0.5
    t = torch.rand(n, generator=gen, device=dev) + 0.5
    payload, er, ec, ev = pack_codes(z, nbits=nbits)
    return x, payload, s, t, (er, ec, ev)


def check(got, want, what, *, atol, rtol):
    """Raise unless got is finite and |got − want| ≤ atol + rtol·|want|;
    returns max |got − want|."""
    bad = (got - want).abs() > atol + rtol * want.abs()
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(f"{what}: max |Δ| {err:.3e} beyond atol {atol}"
                             f" rtol {rtol} ({int(bad.sum())} entries)")
    return err


def kernel_case(nbits, m, k, n, dev, gen, flush):
    """Kernel vs twin at one shape, with times and bound."""
    x, payload, s, t, _ = operands(m, k, n, nbits, dev, gen)
    g, kg = PLANE_GROUPS[nbits], payload.shape[-1]
    xp = F.pad(x, (0, g * kg - k)).contiguous()
    sp = F.pad(s, (0, g * kg - k)).contiguous()
    xg, sg = xp.view(m, g, kg), sp.view(g, kg)
    got = dequant_matmul_packed_cuda(xg, payload, sg, t, nbits=nbits)
    want = dequant_matmul_packed_ref(xp, payload, sp, t, nbits=nbits)
    torch.cuda.synchronize(dev)
    err = check(got, want, f"int{nbits} m={m} k={k} n={n}",
                atol=KERNEL_TOL, rtol=KERNEL_TOL)
    # split-K sums added across the cluster in rank order: equal bits
    if not torch.equal(got, dequant_matmul_packed_cuda(xg, payload, sg, t,
                                                       nbits=nbits)):
        raise AssertionError(f"int{nbits} m={m} k={k} n={n}: two runs differ")
    w_hat = (t[:, None] * unpack_payload_ref(payload, nbits)[:, :k]
             .to(torch.float32) * s[None, :])            # (n, k)
    lib = F.linear(x, w_hat)
    check(lib, want, f"library int{nbits} m={m} k={k} n={n}",
          atol=KERNEL_TOL, rtol=KERNEL_TOL)
    nbytes = (payload.numel() + 4 * (x.numel() + s.numel() + t.numel()
                                     + m * n))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = BF16_TERMS * 2 * m * n * k / BF16_FLOP_PER_S * 1e3
    return {
        "nbits": nbits, "m": m, "k": k, "n": n, "max_abs_err": err,
        "ms": device_ms(lambda: dequant_matmul_packed_cuda(
            xg, payload, sg, t, nbits=nbits), dev, flush=flush),
        "plain_ms": device_ms(lambda: dequant_matmul_packed_ref(
            xp, payload, sp, t, nbits=nbits), dev, flush=flush, reps=10),
        "library_ms": device_ms(lambda: F.linear(x, w_hat), dev,
                                flush=flush),
        "bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
        "operations_ms": t_ops,
        "f32_cuda_core_ms": 2 * m * n * k / F32_FLOP_PER_S * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "payload_bytes": int(payload.numel())}


def kernel_phase(dev, gen):
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)  # 64 MB
    # the first timing of a process reads slow (seen at 37-90 us for a
    # 12 us kernel); take it on a throwaway
    device_ms(lambda: flush.max(), dev, flush=flush)
    cases = []
    for nbits in (4, 3, 2):
        for m in (1, 8):
            for k, n in PATH_SHAPES:
                c = kernel_case(nbits, m, k, n, dev, gen, flush)
                cases.append(c)
                print(f"kernel int{nbits} m={m} k={k} n={n}: "
                      f"ms={c['ms']:.5f} plain_ms={c['plain_ms']:.5f} "
                      f"library_ms={c['library_ms']:.5f} "
                      f"bound_ms={c['bound_ms']:.5f} ({c['bound_by']}) "
                      f"max_abs_err={c['max_abs_err']:.3e}", flush=True)
        # ragged in-features (unaligned rows) and escapes, through ops
        for m, k, n, esc in ((3, 301, 37, False), (8, 2304, 2304, True)):
            x, payload, s, t, escs = operands(m, k, n, nbits, dev, gen,
                                              esc=esc)
            got = dequant_matmul(x, payload, s, t, escapes=escs)
            # the kernel's part gives equal bits on a rerun; the escapes'
            # index_add_ adds duplicate rows with atomics, so the escaped
            # sum is held to the twin only
            if not torch.equal(dequant_matmul(x, payload, s, t),
                               dequant_matmul(x, payload, s, t)):
                raise AssertionError(f"ops int{nbits} m={m} k={k} n={n}: "
                                     "two runs differ")
            w_hat = dequantize_leaf_ref({"codes": payload, "s": s, "t": t,
                                         "esc_row": escs[0],
                                         "esc_col": escs[1],
                                         "esc_dval": escs[2]})
            err = check(got, x @ w_hat,
                        f"ops int{nbits} m={m} k={k} n={n} esc={esc}",
                        atol=KERNEL_TOL, rtol=KERNEL_TOL)
            cases.append({"nbits": nbits, "m": m, "k": k, "n": n,
                          "escapes": int(escs[0].numel()),
                          "max_abs_err": err})
            print(f"ops int{nbits} m={m} k={k} n={n} "
                  f"escapes={int(escs[0].numel())}: max_abs_err={err:.3e}",
                  flush=True)
    return cases


def int8_case(m, k, n, layout, dev, gen, flush, *, timed):
    """The int8 kernel against its twin at one shape: codes stored (k, n)
    as a serving leaf stores them and read in place through their (n, k)
    view ("kn", the serving path), or an (n, k)-contiguous matrix ("nk",
    which the wrapper copies into the leaf's layout first).  With
    ``timed``: the kernel, the twin, one library call (``F.linear``
    against the pre-dequantized f32 weight) and the plain product the
    serving path ran before the kernel existed, with the bound."""
    x = torch.randn((m, k), generator=gen, device=dev)
    codes = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
    s = (torch.rand(k, generator=gen, device=dev) * 0.2 + 0.01) / k ** 0.5 \
        / 30
    t = torch.rand(n, generator=gen, device=dev) + 0.5
    z = codes.T if layout == "kn" else codes.T.contiguous()
    got = dequant_matmul_int8_cuda(x, z, s, t)
    want = dequant_matmul_ref(x, z, s, t)
    torch.cuda.synchronize(dev)
    what = f"int8 {layout} m={m} k={k} n={n}"
    err = check(got, want, what, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    if not torch.equal(got, dequant_matmul_int8_cuda(x, z, s, t)):
        raise AssertionError(f"{what}: two runs differ")
    rec = {"layout": layout, "m": m, "k": k, "n": n, "max_abs_err": err}
    if not timed:
        return rec
    w_hat = dequantize_ref(z, s, t)                          # (n, k) f32
    check(F.linear(x, w_hat), want, f"library {what}", atol=KERNEL_TOL,
          rtol=KERNEL_TOL)

    def before():
        return ((x * s) @ codes.to(torch.float32)) * t
    check(before(), want, f"plain product {what}", atol=KERNEL_TOL,
          rtol=KERNEL_TOL)
    # bytes: the codes once, x, s, t in and out once; operations: 2·m·n·k
    # f32 multiply-adds on the CUDA cores (the tensor-core time of a 3-term
    # bf16 split is tensor_core_ms)
    t_bytes = (n * k + 4 * (m * k + k + n + m * n)) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * n * k / F32_FLOP_PER_S * 1e3
    rec.update({
        "ms": device_ms(lambda: dequant_matmul_int8_cuda(x, z, s, t), dev,
                        flush=flush),
        "plain_ms": device_ms(lambda: dequant_matmul_ref(x, z, s, t), dev,
                              flush=flush, reps=10),
        "library_ms": device_ms(lambda: F.linear(x, w_hat), dev,
                                flush=flush),
        "before_ms": device_ms(before, dev, flush=flush, reps=10),
        "bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
        "operations_ms": t_ops,
        "tensor_core_ms": BF16_TERMS * 2 * m * n * k / BF16_FLOP_PER_S * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    return rec


def int8_phase(dev, gen, flush):
    """The int8 kernel at the serving path's shapes in both layouts (the
    serving layout timed) and the ragged case."""
    cases = []
    for m in INT8_M:
        for k, n in PATH_SHAPES:
            for layout in ("kn", "nk"):
                c = int8_case(m, k, n, layout, dev, gen, flush,
                              timed=layout == "kn")
                cases.append(c)
                if "ms" in c:
                    print(f"kernel int8 kn m={m} k={k} n={n}: "
                          f"ms={c['ms']:.5f} plain_ms={c['plain_ms']:.5f} "
                          f"library_ms={c['library_ms']:.5f} before_ms="
                          f"{c['before_ms']:.5f} bound_ms={c['bound_ms']:.5f}"
                          f" ({c['bound_by']}) max_abs_err="
                          f"{c['max_abs_err']:.3e}", flush=True)
    for layout in ("kn", "nk"):
        c = int8_case(8, *INT8_RAGGED, layout, dev, gen, flush,
                      timed=layout == "kn")
        cases.append(c)
        print(f"kernel int8 {layout} m=8 k={INT8_RAGGED[0]} "
              f"n={INT8_RAGGED[1]} (ragged): max_abs_err="
              f"{c['max_abs_err']:.3e}"
              + (f" ms={c['ms']:.5f}" if "ms" in c else ""), flush=True)
    print(f"int8 kernel vs twin: {len(cases)} cases in both layouts, max "
          f"|Δ| {max(c['max_abs_err'] for c in cases):.3e}", flush=True)
    return cases


def dequantized_model(params):
    """The same model with every quantized leaf replaced by its effective
    f32 weight (ref.dequantize_leaf_ref), served by plain matmuls."""
    if is_qweight(params):
        stack = params["s"].shape[0]
        return torch.stack([dequantize_leaf_ref(params, index=i)
                            for i in range(stack)])
    if isinstance(params, dict):
        return {k: dequantized_model(v) for k, v in params.items()}
    return params


def serve_path(cfg, wbits, dev, **kw):
    """Tree-quantized random weights at ``wbits``, served by serve_tree
    against the dequantized-weight model; returns (record, params)."""
    params = quantize_for_wbits(init_params(cfg, 0, device=dev), wbits)
    torch.cuda.synchronize(dev)
    return serve_tree(cfg, params, dequantized_model, f"int{wbits}", dev,
                      **kw), params


def launches_per_step(params, n_layers):
    """Dequant-kernel launches one decode step makes, by nbits (8: the int8
    kernel): one per layer of every quantized layer-stacked leaf."""
    want = {}

    def walk(node):
        if is_qweight(node):
            c = node["codes"]
            nb = 8 if c.dtype == torch.int8 else payload_nbits(c)
            want[nb] = want.get(nb, 0) + n_layers
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
    walk(params["layers"])
    return want


def serve_tree(cfg, params, oracle_of, label, dev, *, n_req, prompt_len,
               new_tokens, max_len, slots, chunk):
    """First-step logits of the quantized tree against
    ``oracle_of(params)`` (the same model with float weights), then
    ``ContinuousEngine`` serves ``n_req`` requests; each dequant kernel
    must run once per layer of each of its leaves per decode step (7 ×
    n_layers in all for a tree of one format).  Returns a record."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
               for _ in range(n_req)]
    # first-step logits: kernel-served model vs the float-weight model
    tok = torch.as_tensor(np.stack([p[:1] for p in prompts]),
                          dtype=torch.long, device=dev)
    got, _ = decode_step(cfg, params, init_cache(
        cfg, n_req, max_len, torch.float32, device=dev), tok)
    oracle = oracle_of(params)
    want, _ = decode_step(cfg, oracle, init_cache(
        cfg, n_req, max_len, torch.float32, device=dev), tok)
    del oracle
    torch.cuda.empty_cache()
    if got.shape != (n_req, cfg.vocab):
        raise AssertionError(f"logits shape {tuple(got.shape)}")
    scale = float(want.abs().max())
    logit_err = check(got, want, f"{cfg.name} {label} first-step logits",
                      atol=LOGIT_TOL * scale, rtol=0.0) / scale

    steps = {"n": 0}

    def step_fn(p, c, t):
        steps["n"] += 1
        return decode_step(cfg, p, c, t)

    def chunk_fn(p, c, t):
        steps["n"] += t.shape[1]        # decode_chunk = C decode steps
        return decode_chunk(cfg, p, c, t)

    eng = ContinuousEngine(cfg, params, config=EngineConfig(
        n_slots=slots, max_len=max_len, cache_dtype=torch.float32,
        prefill_chunk=chunk, decode_fn=step_fn, decode_chunk_fn=chunk_fn))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=new_tokens))
    torch.cuda.synchronize(dev)
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {nb: c for nb, c in LAUNCHES.items() if c}
    per_step = launches_per_step(params, cfg.n_layers)
    want_launches = {nb: c * steps["n"] for nb, c in per_step.items()}
    if launches != want_launches or sum(per_step.values()) != \
            7 * cfg.n_layers:
        raise AssertionError(f"dequant launches by nbits {launches}, "
                             f"expected {want_launches} = {per_step} per "
                             f"step x {steps['n']} decode steps")
    if sorted(r.rid for r in done) != list(range(n_req)) or any(
            len(r.out_tokens) != new_tokens
            or not all(0 <= x < cfg.vocab for x in r.out_tokens)
            for r in done):
        raise AssertionError("served streams have the wrong shape")
    tokens = sum(len(r.out_tokens) for r in done)
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers, "format": label,
           "requests": n_req, "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall, "decode_steps": steps["n"],
           "engine_decode_calls": eng.decode_calls,
           "decode_step_ms": 1e3 * eng.decode_s / max(eng.decode_calls, 1),
           "prefill_s": eng.prefill_s, "launches": launches,
           "launches_per_step": per_step,
           "weight_bytes": eng.weight_bytes,
           "weight_bytes_bf16": eng.weight_bytes_bf16,
           "first_step_logit_rel_err": logit_err}
    print(f"serve {cfg.name} L={cfg.n_layers} {label}: {tokens} tokens in "
          f"{wall:.3f}s = {rec['tokens_per_s']:.2f} tok/s, decode step "
          f"{rec['decode_step_ms']:.3f} ms (wall), {steps['n']} decode steps,"
          f" kernel launches by nbits {launches}, weight bytes "
          f"{eng.weight_bytes} (bf16 {eng.weight_bytes_bf16}), first-step "
          f"logits rel err {logit_err:.3e}", flush=True)
    return rec


def graph_kernel_names(fn):
    """Function names of the kernel nodes of a CUDA graph that captures one
    call of ``fn``: the device kernels the call launches, read through
    libcuda (``cuGraphGetNodes``, ``cuGraphKernelNodeGetParams``,
    ``cuFuncGetName``) rather than from a profiler's trace."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # first-use work off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:                    # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = (ctypes.c_byte * 256)()       # CUDA_KERNEL_NODE_PARAMS_v2
        name = ctypes.c_char_p()
        if cuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                              params) != 0 \
                or cuda.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(
                    ctypes.c_void_p.from_buffer(params, 0).value)) != 0:
            raise RuntimeError("cannot read a kernel node's function name")
        names.append(name.value.decode())
    del graph
    return names


def _device_busy_ms(prof):
    """Union of the traced device activities' intervals (ms) and their
    time by kind: packed kernel, int8 kernel, matrix products, everything
    else; and the count of each dequant kernel."""
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return None
    busy, end = 0.0, float("-inf")
    kinds = {"packed_ms": 0.0, "int8_ms": 0.0, "gemm_ms": 0.0,
             "other_ms": 0.0}
    packed = int8 = 0
    for a, b, name in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        low = name.lower()
        kind = ("packed_ms" if "dequant_packed" in low
                else "int8_ms" if "dequant_int8" in low
                else "gemm_ms" if "gemm" in low or "gemv" in low
                else "other_ms")
        packed += kind == "packed_ms"
        int8 += kind == "int8_ms"
        kinds[kind] += (b - a) / 1e3
    return {"busy_ms": busy / 1e3, "activities": len(spans),
            "packed_kernels": packed, "int8_kernels": int8, **kinds}


def step_breakdown(cfg, params, dev, slots, max_len, cases):
    """Decode steps at batch ``slots``: their wall time (host clock around
    a synchronize, median of 5) with the engines' pre-split layer views
    and with the stacked tree (split on every step); a ``torch.profiler``
    trace of 3 steps for the device's busy time and idle share; the
    unembed's device time; the packed kernels' device time per step from
    the kernel phase (m = 8, × n_layers).  The trace must hold one device
    kernel per quantized dense: one packed kernel per packed leaf and
    layer, one int8 kernel per int8 leaf and layer."""
    from torch.profiler import ProfilerActivity, profile

    cache = init_cache(cfg, slots, max_len, torch.float32, per_slot=True,
                       device=dev)
    tok = torch.zeros((slots, 1), dtype=torch.long, device=dev)
    split = split_layers(params)

    def wall_ms(p, n):
        walls = []
        for _ in range(n):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            decode_step(cfg, p, cache, tok)
            torch.cuda.synchronize(dev)
            walls.append(1e3 * (time.perf_counter() - t0))
        return walls

    wall_ms(split, 1)
    rec = {"decode_step_wall_ms": statistics.median(wall_ms(split, 5)),
           "decode_step_wall_ms_stacked": statistics.median(
               wall_ms(params, 5))}
    # one device kernel per quantized dense and layer, counted exactly in
    # a CUDA graph of one step (the profiler now and then drops the record
    # of a kernel launched as a thread-block cluster, as both dequant
    # kernels are)
    per_step = launches_per_step(params, cfg.n_layers)
    want = {"packed_kernels": sum(c for nb, c in per_step.items() if nb != 8),
            "int8_kernels": per_step.get(8, 0)}
    names = graph_kernel_names(lambda: decode_step(cfg, split, cache, tok))
    got = {"packed_kernels": sum("dequant_packed" in n for n in names),
           "int8_kernels": sum("dequant_int8" in n for n in names)}
    rec["graph_kernels_per_step"] = len(names)
    for key, n in want.items():
        rec[f"graph_{key}_per_step"] = got[key]
    if got != want:
        raise AssertionError(f"device kernels in a CUDA graph of one decode "
                             f"step {got}, expected {want}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = wall_ms(split, 3)
    busy = _device_busy_ms(prof)
    rec["traced_step_wall_ms"] = sum(traced) / 3
    if busy is None:
        rec["device_busy_ms_per_step"] = None      # no device activity seen
    else:
        rec["device_busy_ms_per_step"] = busy["busy_ms"] / 3
        rec["device_idle_share"] = 1 - busy["busy_ms"] / sum(traced)
        rec["device_activities_per_step"] = busy["activities"] / 3
        for k in ("packed_ms", "int8_ms", "gemm_ms", "other_ms",
                  "packed_kernels", "int8_kernels"):
            rec[f"traced_{k}_per_step"] = busy[k] / 3
    x = torch.randn((slots, 1, cfg.d_model), device=dev)
    rec["unembed_ms"] = device_ms(
        lambda: unembed(params["embed"], x, cfg.vocab), dev,
        flush=torch.ones(16 << 20, dtype=torch.float32, device=dev))
    rec["packed_kernels_ms_per_step"] = cfg.n_layers * sum(
        PER_LAYER[(c["k"], c["n"])] * c["ms"] for c in cases
        if c["nbits"] == 4 and c["m"] == slots and "ms" in c)
    return rec



# ---------------------------------------------------------------------------
# the quantizer's kernels: ZSIC block recursion and flash attention
# ---------------------------------------------------------------------------


def zsic_operands(a, bn, dev, seed):
    """(y (a, bn), lower-triangular L (bn, bn), WaterSIC spacings) f32 on
    the card, from a numpy seed; also the float64 numpy originals."""
    rng = np.random.default_rng(seed)
    sigma, _ = random_covariance(bn, condition=20.0, seed=seed + 1)
    l = chol_lower(sigma)
    y = rng.standard_normal((a, bn)) @ l
    ldiag = np.abs(np.diag(l))
    alphas = 0.05 * np.exp(np.mean(np.log(ldiag))) / ldiag
    f32 = [torch.as_tensor(v.astype(np.float32), device=dev)
           for v in (y, l, alphas)]
    return f32, (y, l, alphas)


def twin_block(y, l_block, alphas, *, out):
    """``kernels/zsic/ops.zsic_block`` with the twin in place of the
    kernel: the block's codes and residual copied into ``out``."""
    for dst, src in zip(out, zsic_block_ref(y, l_block, alphas)):
        dst.copy_(src)
    return out


def zsic_case(a, bn, dev, flush):
    """Kernel vs twin on one block, bit for bit, with times and bound."""
    (y, l, alphas), _ = zsic_operands(a, bn, dev, seed=a + bn)
    z, r = zsic_block_cuda(y, l, alphas)
    zt, rt = zsic_block_ref(y, l, alphas)
    torch.cuda.synchronize(dev)
    mismatches = int((z != zt).sum())
    err = float((r - rt).abs().max())
    if mismatches or not torch.equal(r, rt):
        raise AssertionError(f"zsic_block a={a} bn={bn}: {mismatches} code "
                             f"mismatches, max |Δ resid| {err:.3e}")
    # bytes: y in, codes and residual out, the L block and α once;
    # operations: a·bn·(bn+1)/2 multiply-subtracts, each an unfused f32
    # multiply and subtract (2 instructions), plus a·bn divisions and a·bn
    # roundings, on the CUDA cores (the recursion is exact f32: no tensor
    # cores)
    nbytes = 4 * (3 * a * bn + bn * bn + bn)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (a * bn * (bn + 1) + 2 * a * bn) / F32_INSTR_PER_S * 1e3
    kernels = profile_kernels(lambda: zsic_block_cuda(y, l, alphas), dev)
    return {"a": a, "bn": bn, "code_mismatches": mismatches,
            "max_abs_err": err,
            "ms": device_ms(lambda: zsic_block_cuda(y, l, alphas), dev,
                            flush=flush),
            "device_ms": sum(v["us_per_call"] for v in kernels.values())
            / 1e3,
            "device_kernels_per_call": sum(v["per_call"]
                                           for v in kernels.values()),
            "plain_ms": device_ms(lambda: zsic_block_ref(y, l, alphas), dev,
                                  flush=flush, reps=5),
            "bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
            "operations_ms": t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def zsic_phase(dev, flush):
    """The block kernel at the PTQ path's row counts (full rows of the
    (2304, ·) and (5760, ·) matrices, and the secant search's 10 % row
    subsamples), then one full zsic_quantize against float64 numpy."""
    cases = {}
    for a in ZSIC_ROWS:
        c = cases[a] = zsic_case(a, 128, dev, flush)
        print(f"zsic_block a={a} bn=128: ms={c['ms']:.5f} (L2 cold; "
              f"device {c['device_ms']:.5f} warm in "
              f"{c['device_kernels_per_call']:g} kernel per call) plain_ms="
              f"{c['plain_ms']:.5f} bound_ms={c['bound_ms']:.5f} "
              f"({c['bound_by']}) code_mismatches={c['code_mismatches']} "
              f"max_abs_err={c['max_abs_err']:.3e}", flush=True)
    (y, l, alphas), (y64, l64, a64) = zsic_operands(2304, 2304, dev, seed=7)
    z, r = zsic_quantize(y, l, alphas)
    # the same blocked run with the twin in place of the kernel: the PTQ
    # path's strided column slices of y and L, held bit for bit
    kernel_fn = zsic_ops.zsic_block
    zsic_ops.zsic_block = twin_block
    try:
        zt, rt = zsic_quantize(y, l, alphas)
    finally:
        zsic_ops.zsic_block = kernel_fn
    torch.cuda.synchronize(dev)
    strided_mismatches = int((z != zt).sum())
    if strided_mismatches or not torch.equal(r, rt):
        raise AssertionError(
            f"zsic_quantize (2304, 2304): {strided_mismatches} code "
            f"mismatches against the twin, max |Δ resid| "
            f"{float((r - rt).abs().max()):.3e}")
    print("zsic_quantize (2304, 2304) through the kernel equals the same run "
          "through the twin bit for bit", flush=True)
    t0 = time.perf_counter()
    z_ref, _ = zsic_numpy(y64, l64, a64)
    agree = float((z.cpu().numpy() == z_ref).mean())
    bound = 0.5 * a64 * np.abs(np.diag(l64))
    lemma = bool(np.all(np.abs(r.cpu().numpy())
                        <= bound[None, :] * (1 + 1e-4) + 1e-6))
    print(f"zsic_quantize (2304, 2304) vs zsic_numpy float64: code agreement "
          f"{agree:.6f}, Lemma 3.2 {'holds' if lemma else 'FAILS'} "
          f"(oracle {time.perf_counter() - t0:.1f}s)", flush=True)
    if agree < 0.999 or not lemma:
        raise AssertionError("full ZSIC disagrees with the float64 oracle")
    return {"cases": cases, "full_agreement": agree, "full_lemma": lemma,
            "full_twin_code_mismatches": strided_mismatches}


def flash_twin(q, k, v, *, causal=True, window=0):
    """The flash kernel's plain twin on (B, S, H, d) CUDA tensors."""
    b, s, h, d = q.shape
    fold = [x.transpose(1, 2).reshape(b * h, s, d) for x in (q, k, v)]
    out = attention_ref(*fold, causal=causal, window=window)
    return out.reshape(b, h, s, d).transpose(1, 2)


def _kept_pairs(s, causal, window):
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    keep = np.ones((s, s), bool)
    if causal:
        keep &= j <= i
    if window:
        keep &= i - j < window
    return int(keep.sum())


def flash_check(b, s, h, d, causal, window, dev, gen):
    """Kernel vs twin on one (B, S, H, d) case; returns (q, k, v, twin,
    max |Δ|)."""
    q, k, v = [torch.randn((b, s, h, d), generator=gen, device=dev)
               for _ in range(3)]
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = flash_twin(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize(dev)
    err = check(got, want, f"flash B*H={b * h} S={s} d={d} causal={causal} "
                f"window={window}", atol=FLASH_TOL, rtol=FLASH_TOL)
    return q, k, v, want, err


def flash_case(s, window, dev, gen, flush):
    """Kernel vs twin at minicpm-2b's heads (B·H = 4·36, d = 64), causal,
    with times and bound."""
    b, h, d = 4, 36, 64
    q, k, v, want, err = flash_check(b, s, h, d, True, window, dev, gen)
    mask = None
    if window:
        i = torch.arange(s, device=dev)[:, None]
        j = torch.arange(s, device=dev)[None, :]
        mask = (j <= i) & (i - j < window)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        if mask is None:
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    lib_err = float((library().transpose(1, 2) - want).abs().max())
    # bytes: q, k, v read and o written once; operations: 2·d for q·k and
    # 2·d for p·v per kept (query, key) pair, on the bf16 tensor cores with
    # an f32-accurate 3-term split (the f32 CUDA-core time is printed too)
    flops = 4 * d * _kept_pairs(s, True, window) * b * h
    t_bytes = 4 * 4 * b * s * h * d / HBM_BYTES_PER_S * 1e3
    t_ops = BF16_TERMS * flops / BF16_FLOP_PER_S * 1e3
    return {"bh": b * h, "s": s, "d": d, "window": window,
            "max_abs_err": err, "library_max_abs_err": lib_err,
            "ms": device_ms(lambda: flash_attention_cuda(
                q, k, v, causal=True, window=window), dev, flush=flush),
            "plain_ms": device_ms(lambda: flash_twin(
                q, k, v, causal=True, window=window), dev, flush=flush),
            "library_ms": device_ms(library, dev, flush=flush),
            "bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
            "operations_ms": t_ops,
            "f32_cuda_core_ms": flops / F32_FLOP_PER_S * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


#: untimed flash cases beside the path's heads: (B, S, H, d, causal,
#: window) for the other head dims, S = 1, an S below one query tile (of
#: 64 rows), and a ragged S without the causal mask
FLASH_EDGE_CASES = [(1, 256, 4, 128, True, 0), (1, 200, 4, 256, False, 64),
                    (4, 1, 36, 64, True, 0), (4, 40, 36, 64, True, 0),
                    (4, 200, 36, 64, False, 0)]


def flash_phase(dev, gen, flush):
    cases = []
    for b, s, h, d, causal, window in FLASH_EDGE_CASES:
        err = flash_check(b, s, h, d, causal, window, dev, gen)[-1]
        cases.append({"bh": b * h, "s": s, "d": d, "causal": causal,
                      "window": window, "max_abs_err": err})
        print(f"flash B*H={b * h} S={s} d={d} causal={causal} window="
              f"{window}: max_abs_err={err:.3e}", flush=True)
    for s in (128, 256, 200):
        for window in (0, 64):
            c = flash_case(s, window, dev, gen, flush)
            cases.append(c)
            print(f"flash B*H=144 S={s} d=64 window={window}: ms="
                  f"{c['ms']:.5f} plain_ms={c['plain_ms']:.5f} library_ms="
                  f"{c['library_ms']:.5f} bound_ms={c['bound_ms']:.5f} "
                  f"({c['bound_by']}; f32 CUDA cores "
                  f"{c['f32_cuda_core_ms']:.5f}) max_abs_err="
                  f"{c['max_abs_err']:.3e}", flush=True)
    return cases


# ---------------------------------------------------------------------------
# post-training quantization of minicpm-2b, then serving its codes
# ---------------------------------------------------------------------------


def ppl_pair(cfg, params, evalb, what):
    """model_ppl through the flash kernel (its launches counted) and
    through the plain twin; they must agree within PPL_TOL relative."""
    reset_flash_launches()
    ppl = model_ppl(cfg, params, evalb)
    launches = flash_attention_cuda.launches
    if launches != cfg.n_layers * len(evalb):
        raise AssertionError(f"{what}: {launches} flash launches, expected "
                             f"{cfg.n_layers} layers x {len(evalb)} batches")
    kernel_fn = flash.flash_attention
    flash.flash_attention = flash_twin
    try:
        ppl_twin = model_ppl(cfg, params, evalb)
    finally:
        flash.flash_attention = kernel_fn
    rel = abs(ppl - ppl_twin) / ppl_twin
    if not math.isfinite(ppl) or rel > PPL_TOL:
        raise AssertionError(f"{what}: model_ppl {ppl} (kernel) vs "
                             f"{ppl_twin} (twin)")
    print(f"model_ppl {what}: {ppl:.4f} through the flash kernel "
          f"({launches} launches), {ppl_twin:.4f} through the twin "
          f"(rel diff {rel:.2e})", flush=True)
    return {"ppl": ppl, "ppl_twin": ppl_twin, "rel_diff": rel,
            "flash_launches": launches}


#: (module, function) pairs whose host-clock time (synchronized on both
#: sides) the PTQ phase adds up, for where its time goes
PTQ_SPANS = (("repro_torch.quant.pipeline", "forward_with_taps"),
             ("repro_torch.quant.pipeline", "accumulate_stats"),
             ("repro_torch.core.watersic", "zsic_lmmse"),
             ("repro_torch.core.watersic", "zsic_quantize"),
             ("repro_torch.core.watersic", "find_optimal_rescalers"),
             ("repro_torch.core.entropy", "empirical_entropy"))


def timed_spans(dev, spans):
    """Wrap each (module, function) so its calls add their synchronized
    host-clock seconds to the returned dict, and count the calls and the
    columns of their first argument (``<name>_calls``, ``<name>_cols``)
    into a second; returns (seconds, counts, restore)."""
    import importlib
    took, counts, saved = {}, {}, []
    for modname, name in spans:
        mod = importlib.import_module(modname)
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def wrapper(*a, _fn=fn, _name=name, **kw):
            counts[f"{_name}_calls"] = counts.get(f"{_name}_calls", 0) + 1
            if isinstance(a[0], torch.Tensor) and a[0].ndim == 2:
                counts[f"{_name}_cols"] = counts.get(f"{_name}_cols", 0) \
                    + a[0].shape[1]
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                torch.cuda.synchronize(dev)
                took[_name] = took.get(_name, 0.0) + time.perf_counter() - t0
        setattr(mod, name, wrapper)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return took, counts, restore


def ptq_phase(cfg, dev):
    """quantize_model (watersic: the LMMSE column loop; hptq: the ZSIC
    kernel) at 3 bits, and model_ppl of the float and quantized models.
    One run per method gives its wall time, its ZSIC launches and, with
    the spans of PTQ_SPANS timed, where the time goes."""
    params = init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(1)
    calib = [rng.integers(0, cfg.vocab, (4, 128)).astype(np.int32)
             for _ in range(2)]
    evalb = [rng.integers(0, cfg.vocab, (4, 257)).astype(np.int32)]
    rec = {"calib": "2 x (4, 128)", "eval": "1 x (4, 257)",
           "ppl": {"float": ppl_pair(cfg, params, evalb, "float")}}
    results = {}
    for method in ("watersic", "hptq"):
        shapes = []
        record = zsic_ops.zsic_block_cuda

        def recorder(y, *a, **kw):
            shapes.append(int(y.shape[0]))
            return record(y, *a, **kw)
        zsic_ops.zsic_block_cuda = recorder
        took, counts, restore = timed_spans(dev, PTQ_SPANS)
        reset_zsic_launches()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        try:
            qp, qlin, budget, rows = quantize_model(
                cfg, params, calib, PTQConfig(target_bits=3.0, method=method))
            torch.cuda.synchronize(dev)
        finally:
            restore()
            zsic_ops.zsic_block_cuda = record
        wall = time.perf_counter() - t0
        launches = zsic_block_cuda.launches
        rate = budget.realized_rate
        if abs(rate - 3.0) > 0.05:
            raise AssertionError(f"{method}: realized rate {rate}")
        if method == "hptq" and launches == 0:
            raise AssertionError("hptq ran no ZSIC kernel launch")
        mix = {a: shapes.count(a) for a in sorted(set(shapes))}
        took["rest"] = wall - sum(took.values())
        print(f"ptq {method} where the time goes (s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in took.items())
              + "; " + ", ".join(f"{k} {v}" for k, v in counts.items()),
              flush=True)
        rec[method] = {"realized_rate": rate, "wall_s": wall,
                       "breakdown_s": took, "span_counts": counts,
                       "s_per_matrix": wall / len(qlin),
                       "matrices": len(qlin), "zsic_launches": launches,
                       "zsic_launch_rows": mix,
                       "rate_eff_mean": float(np.mean([r["rate"]
                                                       for r in rows]))}
        print(f"ptq {cfg.name} L={cfg.n_layers} {method}: realized rate "
              f"{rate:.4f} bits, {wall:.2f}s for {len(qlin)} matrices = "
              f"{wall / len(qlin):.3f} s/matrix, {launches} ZSIC kernel "
              f"launches (rows per launch: {mix})", flush=True)
        rec["ppl"][method] = ppl_pair(cfg, qp, evalb, method)
        results[method] = (qp, qlin)
    return rec, results


def install_codes(qparams, qlinears, n_layers, nbits=4):
    """Swap the dequantized float weights for stacked packed leaves
    (``from_watersic``); a path's escape capacity is its largest escape
    count over the layers.  Returns (tree, escapes installed)."""
    lo, hi = CODE_RANGE[nbits]
    groups = {}
    for name, q in qlinears.items():
        groups.setdefault(tuple(name.split("/")[1:]), {})[
            int(name.split("/")[0][1:])] = q
    p = {**qparams, "layers": {k: dict(v) for k, v in
                               qparams["layers"].items()}}
    escapes = 0
    for path, per_layer in groups.items():
        counts = [int(((q.codes < lo) | (q.codes > hi)).sum())
                  for q in per_layer.values()]
        escapes += sum(counts)
        leaves = [from_watersic(per_layer[l], nbits=nbits,
                                escape_capacity=max(counts))
                  for l in range(n_layers)]
        p["layers"][path[0]][path[1]] = {
            "w": {k: torch.stack([lf[k] for lf in leaves])
                  for k in leaves[0]}}
    return p, escapes


def serve_after_ptq(cfg, qp, qlin, dev):
    tree, escapes = install_codes(qp, qlin, cfg.n_layers)
    if escapes == 0:
        raise AssertionError("the installed WaterSIC codes carry no escapes")
    print(f"serve-after-ptq: watersic codes installed as packed int4 with "
          f"{escapes} escapes", flush=True)
    rec = serve_tree(cfg, tree, lambda _: qp, "int4", dev, n_req=4,
                     prompt_len=16, new_tokens=8, max_len=32, slots=4,
                     chunk=16)
    rec["escapes"] = escapes
    return rec


# ---------------------------------------------------------------------------
# the global planner: build → inspect → execute, then the mixed-rate serve
# ---------------------------------------------------------------------------


def weighted_distortion(plan):
    """Σ w_l·N_l·D_l over the realized distortions (the planner's
    objective, as ``launch/plan.py`` reports it)."""
    return sum(e.weight * e.n_params * e.realized_distortion for e in plan)


def execute(plan, weights, stats, dev, workers):
    """One execution of ``plan`` through the ZSIC kernel (WaterSIC spacing
    without LMMSE), with its wall time and kernel launches."""
    reset_zsic_launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    q, report = execute_plan(plan, weights, stats, n_workers=workers,
                             quantize_kwargs={"lmmse": False},
                             compute_distortion=True)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if report.retries:
        raise AssertionError(f"{workers}-worker execution retried "
                             f"{report.retries} task(s)")
    realized, planned = plan.realized_bits_per_param, \
        plan.planned_bits_per_param
    if abs(realized - planned) > 0.05:
        raise AssertionError(f"{plan.weighting} plan: realized {realized} "
                             f"bits against {planned} planned")
    return q, {"workers": workers, "wall_s": wall,
               "serial_s": report.serial_s,
               "zsic_launches": zsic_block_cuda.launches,
               "planned_bits": planned, "realized_bits": realized,
               "weighted_distortion": weighted_distortion(plan)}


def plan_phase(dev, out):
    """``launch.plan build`` (minicpm-2b at full width, 2 layers, numpy
    weights and tokens from seed 0, 2 × PLAN_CALIB_ROWS × 128 calibration
    tokens, output weighting, PLAN_BITS), the
    artifact reloaded and ``inspect``-ed, then the snapped plan executed on
    1 and 4 workers (identical results), and the continuous waterfilled
    optimum against the even spread at the same budget."""
    path = str(out / "plan.json")
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    plan = launch_plan.main([
        "build", "--arch", "minicpm-2b", "--n-layers", "2", "--seed", "0",
        "--target-bits", str(PLAN_BITS), "--weighting", "output",
        "--calib-batches", "2", "--seq-len", "128", "--global-batch",
        str(PLAN_CALIB_ROWS),
        "--out", path])
    torch.cuda.synchronize(dev)
    rec = {"build_s": time.perf_counter() - t0,
           "payloads": plan.payload_histogram()}
    if 8 not in rec["payloads"] or not set(rec["payloads"]) & {2, 3, 4}:
        raise AssertionError(f"the snapped plan at {PLAN_BITS} bits holds "
                             f"payloads {rec['payloads']}: it must mix int8 "
                             "and sub-byte")
    if QuantPlan.load(path) != plan:
        raise AssertionError("the plan artifact does not round-trip")
    launch_plan.main(["inspect", "--plan", path])
    cfg, params, calib = launch_plan.model_from_provenance(plan.provenance,
                                                           dev)
    weights, stats = plan_inputs_for_model(cfg, params, calib)
    q1, rec["snapped"] = execute(plan, weights, stats, dev, 1)
    if rec["snapped"]["zsic_launches"] == 0:
        raise AssertionError("plan execution ran no ZSIC kernel launch")
    q4, rec["snapped_4_workers"] = execute(QuantPlan.load(path), weights,
                                           stats, dev, 4)
    for name, a in q1.items():
        for f in ("codes", "alphas", "gamma", "t"):
            if not torch.equal(getattr(a, f), getattr(q4[name], f)):
                raise AssertionError(f"{name}.{f}: 4 workers differ from 1")
    print(f"plan execute: 4 workers equal 1 worker on all {len(q1)} "
          "matrices (codes, alphas, gamma, t)", flush=True)
    del q1, q4
    t0 = time.perf_counter()
    sens = model_sensitivities(cfg, params, calib, weighting="output")
    rec["sensitivities_s"] = time.perf_counter() - t0
    if build_plan(sens, PLAN_BITS, weighting="output").diff(plan):
        raise AssertionError("the library's snapped plan differs from the "
                             "artifact of launch.plan build")
    cont = build_plan(sens, PLAN_BITS, snap=False, weighting="output")
    even = even_plan(sens, PLAN_BITS)
    _, rec["waterfilled"] = execute(cont, weights, stats, dev, 1)
    _, rec["even"] = execute(even, weights, stats, dev, 1)
    d_wf = rec["waterfilled"]["weighted_distortion"]
    d_ev = rec["even"]["weighted_distortion"]
    if not d_wf < d_ev:
        raise AssertionError(f"waterfilled weighted distortion {d_wf} is not "
                             f"below the even spread's {d_ev}")
    for key in ("snapped", "snapped_4_workers", "waterfilled", "even"):
        r = rec[key]
        print(f"plan execute {key}: {r['wall_s']:.2f}s wall, "
              f"{r['zsic_launches']} ZSIC launches, realized "
              f"{r['realized_bits']:.4f} of {r['planned_bits']:.4f} bits, "
              f"weighted distortion {r['weighted_distortion']:.5e}",
              flush=True)
    print(f"plan: waterfilled/even weighted distortion "
          f"{d_wf / d_ev:.4f} at {PLAN_BITS} bits; snapped (planned "
          f"{plan.planned_bits_per_param:.4f}) "
          f"{rec['snapped']['weighted_distortion'] / d_ev:.4f} of even",
          flush=True)
    return plan, rec


def mixed_serve_phase(cfg, plan, dev):
    """The plan's per-type formats on full-width, full-depth minicpm-2b:
    int8 types through the int8 kernel, the rest through the packed one,
    held against the dequantized-weight model; then a 2-layer copy's
    greedy streams from the static and the continuous engine."""
    fmt = serving_formats_from_plan(plan)
    int8_types = [f"{b}/{k}" for b, k in TYPE_SHAPES
                  if fmt(("layers", b, k, "w")) == 8]
    mixed = quantize_params_tree(init_params(cfg, 0, device=dev),
                                 nbits_by_path=fmt)
    torch.cuda.synchronize(dev)
    hist = leaf_format_histogram(mixed)
    qb, fb = qweight_bytes(mixed)
    print(f"mixed serve formats {hist}, int8 types {int8_types}, param bytes "
          f"{qb} (bf16 {fb})", flush=True)
    rec = serve_tree(cfg, mixed, dequantized_model, "mixed", dev, n_req=8,
                     prompt_len=32, new_tokens=16, max_len=64, slots=8,
                     chunk=16)
    if rec["launches_per_step"].get(8) != len(int8_types) * cfg.n_layers:
        raise AssertionError(f"int8 launches per step "
                             f"{rec['launches_per_step']}, expected "
                             f"{len(int8_types)} x {cfg.n_layers}")
    # one device kernel per int8 call in a decode step, and a traced step
    traced = step_breakdown(cfg, mixed, dev, 8, 64, [])
    rec.update({k: traced[k] for k in traced if k.startswith("traced_")
                or k.startswith("graph_") or k.startswith("device_")
                or k.startswith("decode_step")})
    print(f"mixed serve decode step: {rec['graph_int8_kernels_per_step']} "
          f"int8 and {rec['graph_packed_kernels_per_step']} packed device "
          f"kernels of {rec['graph_kernels_per_step']} in a CUDA graph of "
          "the step"
          + ("" if rec.get("device_busy_ms_per_step") is None else
             f"; traced: int8 {rec['traced_int8_ms_per_step']:.3f} ms, "
             f"packed {rec['traced_packed_ms_per_step']:.3f} ms device per "
             f"step, device idle share {rec['device_idle_share']:.4f}"),
          flush=True)
    del mixed
    torch.cuda.empty_cache()
    rec.update({"formats": hist, "int8_types": int8_types,
                "qweight_bytes": qb, "bf16_bytes": fb})
    short = dataclasses.replace(cfg, n_layers=2)
    tree = quantize_params_tree(init_params(short, 0, device=dev),
                                nbits_by_path=fmt)
    rng = np.random.default_rng(5)
    work = [(rng.integers(0, cfg.vocab, int(rng.integers(3, 12)))
             .astype(np.int32), int(rng.integers(2, 9))) for _ in range(6)]
    streams = []
    for cls in (ServeEngine, ContinuousEngine):
        eng = cls(short, tree, config=EngineConfig(
            n_slots=4, max_len=24, cache_dtype=torch.float32,
            prefill_chunk=4))
        for i, (p, b) in enumerate(work):
            eng.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=b))
        streams.append({r.rid: list(r.out_tokens)
                        for r in eng.run_until_done()})
    if streams[0] != streams[1] or sorted(streams[0]) != list(range(6)):
        raise AssertionError(f"2-layer mixed streams differ: static "
                             f"{streams[0]}, continuous {streams[1]}")
    print(f"mixed serve 2 layers: static and continuous streams identical "
          f"({sum(len(v) for v in streams[0].values())} tokens)", flush=True)
    rec["two_layer_streams_equal"] = True
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    t0 = time.perf_counter()
    took = _build.build_all()
    print(f"build: {json.dumps(took)} ({time.perf_counter() - t0:.2f}s)",
          flush=True)
    for stem in _build.sources():
        for line in _build.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {stem}:", line.strip())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # half a second of matmuls so the first timed case finds the clocks up
    a = torch.randn((4096, 4096), device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        a = torch.tanh(a @ a)
    torch.cuda.synchronize(dev)
    del a

    cases = kernel_phase(dev, gen)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)  # 64 MB
    int8_cases = int8_phase(dev, gen, flush)
    zsic = zsic_phase(dev, flush)
    flash_cases = flash_phase(dev, gen, flush)
    del flush

    cfg = get_config("minicpm-2b")
    serve, params = serve_path(cfg, 4, dev, n_req=8, prompt_len=32,
                               new_tokens=16, max_len=64, slots=8, chunk=16)
    serve.update(step_breakdown(cfg, params, dev, 8, 64, cases))
    busy = serve["device_busy_ms_per_step"]
    print(f"step breakdown: decode step {serve['decode_step_wall_ms']:.3f} "
          f"ms wall ({serve['decode_step_wall_ms_stacked']:.3f} ms with the "
          f"stacked tree), traced step {serve['traced_step_wall_ms']:.3f} ms "
          "wall, device busy "
          + ("not measured (no device activity in the trace)" if busy is None
             else f"{busy:.3f} ms (idle share "
                  f"{serve['device_idle_share']:.4f}; packed kernels "
                  f"{serve['traced_packed_ms_per_step']:.3f} ms device in "
                  f"{serve['traced_packed_kernels_per_step']:.0f} traced "
                  f"launches per step ({serve['graph_packed_kernels_per_step']}"
                  f" in a CUDA graph of the step), gemm "
                  f"{serve['traced_gemm_ms_per_step']:.3f}, other "
                  f"{serve['traced_other_ms_per_step']:.3f} ms; "
                  f"{serve['device_activities_per_step']:.0f} activities)")
          + f", unembed {serve['unembed_ms']:.5f} ms device, packed kernels "
          f"(kernel phase) {serve['packed_kernels_ms_per_step']:.5f} ms "
          "device", flush=True)
    del params
    torch.cuda.empty_cache()
    ladder = {}
    short = dataclasses.replace(cfg, n_layers=4)
    for wbits in (3, 2):
        ladder[wbits], p = serve_path(short, wbits, dev, n_req=4,
                                      prompt_len=16, new_tokens=8,
                                      max_len=32, slots=4, chunk=16)
        del p
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ptq_cfg = dataclasses.replace(cfg, n_layers=2)
    ptq, results = ptq_phase(ptq_cfg, dev)
    ptq["serve"] = serve_after_ptq(ptq_cfg, *results["watersic"], dev)
    del results
    torch.cuda.empty_cache()
    print(f"ptq + serve-after-ptq phases: {time.perf_counter() - t0:.1f}s",
          flush=True)

    t0 = time.perf_counter()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    plan, planned = plan_phase(dev, out)
    torch.cuda.empty_cache()
    planned["serve"] = mixed_serve_phase(cfg, plan, dev)
    planned["phases_s"] = time.perf_counter() - t0
    print(f"plan + mixed-serve phases: {planned['phases_s']:.1f}s",
          flush=True)

    kernels, detail_mix = [], {}
    for nbits in (4, 3, 2):
        mix = {(c["k"], c["n"]): c for c in cases
               if c["nbits"] == nbits and c["m"] == 8 and "ms" in c}
        # one launch at the decode path's mix: per layer 7 launches over
        # the three shapes, at m = 8 (the 8-slot batch)
        per_launch = {key: sum(PER_LAYER[s] * mix[s][key] for s in mix) / 7
                      for key in ("ms", "plain_ms", "library_ms",
                                  "bound_ms", "bytes_ms", "operations_ms",
                                  "f32_cuda_core_ms")}
        kernels.append({
            "name": f"dequant_matmul_packed_int{nbits}", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "launches": serve["launches"][4] if nbits == 4
            else ladder[nbits]["launches"][nbits],
            "max_abs_err": max(c["max_abs_err"] for c in cases
                               if c["nbits"] == nbits),
            "ms": per_launch["ms"], "plain_ms": per_launch["plain_ms"],
            "bound_ms": per_launch["bound_ms"],
            "bound_by": "bytes" if per_launch["bytes_ms"]
            >= per_launch["operations_ms"] else "operations",
            "library_ms": per_launch["library_ms"]})
        detail_mix[nbits] = per_launch
    # one int8 launch at the mixed serve's mix: its int8 types at m = 8
    shapes = [TYPE_SHAPES[tuple(k.split("/"))]
              for k in planned["serve"]["int8_types"]]
    by_shape = {(c["k"], c["n"]): c for c in int8_cases
                if c["m"] == 8 and "ms" in c}
    int8_mix = {key: sum(by_shape[sh][key] for sh in shapes) / len(shapes)
                for key in ("ms", "plain_ms", "library_ms", "before_ms",
                            "bound_ms", "bytes_ms", "operations_ms")}
    kernels.append({
        "name": "dequant_matmul_int8", "route": "cuda",
        "source": INT8_SOURCE, "replaces": INT8_REPLACES,
        "launches": planned["serve"]["launches"][8],
        "max_abs_err": max(c["max_abs_err"] for c in int8_cases),
        "ms": int8_mix["ms"], "plain_ms": int8_mix["plain_ms"],
        "bound_ms": int8_mix["bound_ms"],
        "bound_by": "bytes" if int8_mix["bytes_ms"]
        >= int8_mix["operations_ms"] else "operations",
        "library_ms": int8_mix["library_ms"]})
    mix = ptq["hptq"]["zsic_launch_rows"]
    zmix = {key: sum(n * zsic["cases"][a][key] for a, n in mix.items())
            / sum(mix.values())
            for key in ("ms", "plain_ms", "bound_ms", "bytes_ms",
                        "operations_ms")}
    kernels.append({
        "name": "zsic_block", "route": "cuda", "source": ZSIC_SOURCE,
        "replaces": ZSIC_REPLACES,
        "launches": ptq["hptq"]["zsic_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in zsic["cases"].values()),
        "code_mismatches": sum(c["code_mismatches"]
                               for c in zsic["cases"].values())
        + zsic["full_twin_code_mismatches"],
        "ms": zmix["ms"], "plain_ms": zmix["plain_ms"],
        "bound_ms": zmix["bound_ms"],
        "bound_by": "bytes" if zmix["bytes_ms"] >= zmix["operations_ms"]
        else "operations",
        "library_ms": None})
    path = next(c for c in flash_cases if c["s"] == 256 and c["d"] == 64
                and not c["window"] and "ms" in c)
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": sum(p["flash_launches"] for p in ptq["ppl"].values()),
        "max_abs_err": max(c["max_abs_err"] for c in flash_cases),
        "ms": path["ms"], "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
        "library_ms": path["library_ms"]})
    detail = {"device": smi.stdout.strip(), "cases": cases, "serve": serve,
              "ladder": ladder, "kernels": kernels,
              "m8_decode_mix_per_launch": detail_mix, "zsic": zsic,
              "zsic_ptq_mix_per_launch": zmix, "flash": flash_cases,
              "ptq": ptq, "int8": int8_cases,
              "int8_mixed_serve_mix_per_launch": int8_mix, "plan": planned}
    (out / "chip_smoke_detail.json").write_text(json.dumps(detail, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
