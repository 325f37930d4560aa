"""Training driver (port of ``repro/launch/train.py``): data pipeline +
train step + checkpoint/restart, on one device.

Runs on the card unless ``--device cpu`` is given (and raises when there
is no card).  Wires the fault-tolerance pieces: atomic checkpoints,
restore-on-start, the heartbeat, the straggler monitor and save-every.
The reference runs its step under a host mesh; the mesh belongs to the
multi-device slice (ROADMAP item 11).

    python -m repro_torch.launch.train --arch minicpm-2b --reduced \\
        --steps 30 --ckpt ckpt --device cpu
    python -m repro_torch.launch.train --arch minicpm-2b --steps 4 \\
        --batch 8 --seq 64 --n-micro 2
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, global_batch_for_step
from repro_torch.dist.checkpoint import (latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.dist.fault import Heartbeat, StragglerMonitor
from repro_torch.models import init_params
from repro_torch.train import AdamWConfig, init_train_state, make_train_step

__all__ = ["main", "device_batch"]


def device_batch(dcfg: DataConfig, step: int, dev) -> dict:
    """The pipeline's global batch of ``step`` as tensors on ``dev``."""
    return {k: torch.as_tensor(v, device=dev)
            for k, v in global_batch_for_step(dcfg, step).items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = AdamWConfig(lr=args.lr, schedule=cfg.lr_schedule,
                          total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 1))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)

    state = init_train_state(init_params(cfg, 0, device=dev))
    start = 0
    if args.ckpt:
        last = latest_step(args.ckpt)
        if last is not None:
            state, _ = restore_checkpoint(args.ckpt, state, step=last)
            start = last
            print(f"restored step {start}")
    step_fn = make_train_step(cfg, opt_cfg, n_micro=args.n_micro)
    hb = Heartbeat(args.ckpt or os.path.join(tempfile.gettempdir(), "hb"),
                   "host0")
    mon = StragglerMonitor()
    metrics = None
    for step in range(start, args.steps):
        t0 = time.time()
        state, metrics = step_fn(state, device_batch(dcfg, step, dev))
        loss = float(metrics["loss"])          # waits for the step
        dt = time.time() - t0
        mon.observe("host0", dt)
        hb.beat(step)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{dt*1e3:.0f}ms", flush=True)
        if args.ckpt and ((step + 1) % args.save_every == 0
                          or step == args.steps - 1):
            save_checkpoint(args.ckpt, step + 1, state)
    return float(metrics["loss"]) if metrics is not None else None


if __name__ == "__main__":
    main()
