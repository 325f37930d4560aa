#!/usr/bin/env python3
"""How far one process's own Adam steps spread between two microbatch
splits of the same batch, on one card.

    python3 spread_probe.py

Runs the one-process train step of ``chip_smoke.py``'s rwkv6-7b FSDP × TP
cell (full width, 4 layers; 8 × 64 synthetic tokens per step, 3 steps,
AdamW as ``chip_smoke._fsdp_setup`` sets it, computed in float64,
deterministic) twice at lr 1e-4 and at 3e-3: in 2 and in 4
microbatches, which change nothing but the order of the grads' sums.
Prints each run's loss and clipped grad norm per step, and after each
step the relative distance of the two runs' Adam first moments (whole
tree and the worst leaf), sqrt(sum (a - b)²) / sqrt(sum a²), and of
their final params relative to how far the first run moved them,
sqrt(sum (a - b)²) / sqrt(sum (a - init)²).  This is the spread the FSDP
× TP ranks' reordered sums are held against.
Writes ``chiprun_out/spread_probe.json``.  Needs a card.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.launch.train import device_batch  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.train import (AdamWConfig, init_train_state,  # noqa: E402
                               make_train_step)
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

ARCH, LAYERS, LRS = "rwkv6-7b", 4, (1e-4, 3e-3)
STEPS, BATCH, SEQ = 3, 8, 64


def run(cfg, dev, lr, n_micro):
    """(loss and grad norm per step, first moments after each step, the
    final params; on the host) of one process from ``init_params(cfg,
    0)``."""
    opt = AdamWConfig(lr=lr, schedule=cfg.lr_schedule,
                      total_steps=STEPS + 1, warmup_steps=1)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    state = init_train_state(init_params(cfg, 0, device=dev))
    step = make_train_step(cfg, opt, n_micro=n_micro,
                           compute_dtype=torch.float64)
    info, moments = [], []
    for s in range(STEPS):
        state, m = step(state, device_batch(dcfg, s, dev))
        info.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])})
        moments.append({p: t.to("cpu", copy=True)
                        for p, t in tree_leaves_with_path(state.opt.m)})
    params = {p: t.to("cpu", copy=True)
              for p, t in tree_leaves_with_path(state.params)}
    del state
    torch.cuda.empty_cache()
    return info, moments, params


def spread(a, b, origin=None):
    """(whole-tree relative distance of ``b`` to ``a``, worst leaf, its
    distance), relative to ``a``'s distance to ``origin`` (default 0)."""
    num = den = worst = 0.0
    leaf = None
    for p, x in a.items():
        base = x if origin is None else x - origin[p]
        d, n = float((x - b[p]).norm()), float(base.norm())
        num, den = num + d * d, den + n * n
        if n > 0 and d / n > worst:
            worst, leaf = d / n, p
    return (num / den) ** 0.5, leaf, worst


def main() -> int:
    if not torch.cuda.is_available():
        print("spread_probe: torch.cuda is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=LAYERS)
    out = {"card": card, "arch": cfg.name, "n_layers": cfg.n_layers,
           "runs": []}
    init = {p: t.to("cpu", copy=True) for p, t in
            tree_leaves_with_path(init_params(cfg, 0, device=dev))}
    for lr in LRS:
        (ia, ma, pa), (ib, mb, pb) = run(cfg, dev, lr, 2), run(cfg, dev, lr, 4)
        rec = {"lr": lr, "n_micro_2": ia, "n_micro_4": ib, "m_spread": []}
        for s in range(STEPS):
            whole, leaf, worst = spread(ma[s], mb[s])
            rec["m_spread"].append({"step": s + 1, "whole": whole,
                                    "worst_leaf": leaf, "worst": worst})
            print(f"{cfg.name} L={cfg.n_layers} lr {lr:g} step {s + 1}: "
                  f"loss {ia[s]['loss']:.6f} / {ib[s]['loss']:.6f}, grad "
                  f"norm {ia[s]['grad_norm']:.4f} / "
                  f"{ib[s]['grad_norm']:.4f} (2 / 4 microbatches); first "
                  f"moments {whole:.3e} apart, worst {leaf} {worst:.3e} "
                  f"[{card}]", flush=True)
        whole, leaf, worst = spread(pa, pb, init)
        rec["params_spread"] = {"whole": whole, "worst_leaf": leaf,
                                "worst": worst}
        print(f"{cfg.name} L={cfg.n_layers} lr {lr:g}: final params "
              f"{whole:.3e} of the movement apart, worst {leaf} "
              f"{worst:.3e} [{card}]", flush=True)
        out["runs"].append(rec)
        del ma, mb, pa, pb
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "spread_probe.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps({"ok": True, "runs": len(out["runs"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
