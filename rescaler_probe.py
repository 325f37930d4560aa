#!/usr/bin/env python3
"""WaterSIC's rescaler fit on better-trained weights, on one card.

    python3 rescaler_probe.py [--lr 1e-2] [--steps 300]

Trains minicpm-2b at full width and 2 layers as ``chip_smoke.py``'s
lifecycle does (8 × 64 synthetic tokens per step, bf16 over f32 masters,
the cosine schedule with 10 warmup steps), but for ``--steps`` at peak
``--lr``, then quantizes the trained weights at 2.5 bits on 12
calibration batches with ``watersic`` and ``hptq`` and measures
``model_ppl`` of each.  When a Γ-step of ``find_optimal_rescalers``
cannot factor its matrix G = Σ_X̂ ∘ Ŵ₀ᵀdiag(t²)Ŵ₀, the probe records that
matrix's name and, in float64, the spectrum of its Σ_X̂ and of G at t = 1
against the step's jitter (1e-7 of G's mean diagonal), and goes on with
the next method.  Prints one JSON line and writes
``chiprun_out/rescaler_probe.json``.  Needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import watersic  # noqa: E402
from repro_torch.data import DataConfig, global_batch_for_step  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch.train import device_batch  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.quant import pipeline  # noqa: E402
from repro_torch.train import (AdamWConfig, init_train_state,  # noqa: E402
                               make_train_step)


def spectrum(w0_hat, sigma_xhat) -> dict:
    """Σ_X̂'s and G's (t = 1) eigenvalues in float64, against the jitter."""
    s = torch.linalg.eigvalsh(sigma_xhat.double())
    g = sigma_xhat.double() * (w0_hat.double().T @ w0_hat.double())
    e = torch.linalg.eigvalsh(g)
    jitter = 1e-7 * float(torch.diagonal(g).mean())
    return {"shape": list(w0_hat.shape),
            "sigma_max": float(s[-1]), "sigma_min": float(s[0]),
            "sigma_above_1e-7_of_max": int((s > 1e-7 * s[-1]).sum()),
            "g_max": float(e[-1]), "g_min": float(e[0]), "jitter": jitter,
            "g_max_over_jitter": float(e[-1]) / jitter}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rescaler_probe: torch.cuda is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    _build.build_all()
    cfg = dataclasses.replace(get_config("minicpm-2b"), n_layers=2)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)
    state = init_train_state(init_params(cfg, 0, device=dev))
    step = make_train_step(cfg, AdamWConfig(lr=args.lr,
                                            total_steps=args.steps,
                                            warmup_steps=10))
    t0 = time.perf_counter()
    losses = []
    for s in range(args.steps):
        state, m = step(state, device_batch(dcfg, s, dev))
        losses.append(float(m["loss"]))
    rec = {"lr": args.lr, "steps": args.steps,
           "train_s": time.perf_counter() - t0,
           "loss_first10": float(np.mean(losses[:10])),
           "loss_last10": float(np.mean(losses[-10:])),
           "ln_vocab": math.log(cfg.vocab), "card": card, "methods": {}}
    params = state.params
    del state
    calib = [global_batch_for_step(dcfg, 900 + i)["tokens"]
             for i in range(12)]
    evalb = [np.concatenate([b["tokens"], b["targets"][:, -1:]], axis=1)
             for b in (global_batch_for_step(dcfg, 1800 + i)
                       for i in range(2))]
    rec["ppl_float"] = pipeline.model_ppl(cfg, params, evalb)

    names = [r["name"] for r in pipeline.matrix_tap_map(cfg, params)]
    current = []
    quantize_matrix, fit = pipeline._quantize_matrix, \
        watersic.find_optimal_rescalers

    def named_quantize(*a, **kw):
        current.append(names[len(current)])
        return quantize_matrix(*a, **kw)

    def traced_fit(w0_hat, w, sx, sxh=None, *a, **kw):
        try:
            return fit(w0_hat, w, sx, sxh, *a, **kw)
        except torch.linalg.LinAlgError as e:
            raise RuntimeError(json.dumps({
                "matrix": current[-1], "error": str(e)[:160],
                **spectrum(w0_hat, sx if sxh is None else sxh)})) from e

    pipeline._quantize_matrix = named_quantize
    watersic.find_optimal_rescalers = traced_fit
    try:
        for method in ("watersic", "hptq"):
            current.clear()
            t0 = time.perf_counter()
            try:
                qp, _, budget, _ = pipeline.quantize_model(
                    cfg, params, calib,
                    pipeline.PTQConfig(target_bits=2.5, method=method))
            except RuntimeError as e:
                rec["methods"][method] = {"failed": json.loads(str(e))}
                continue
            rec["methods"][method] = {
                "realized_rate": budget.realized_rate,
                "ppl": pipeline.model_ppl(cfg, qp, evalb),
                "wall_s": time.perf_counter() - t0}
            del qp
    finally:
        pipeline._quantize_matrix = quantize_matrix
        watersic.find_optimal_rescalers = fit
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "rescaler_probe.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
