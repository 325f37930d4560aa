"""Training driver (port of ``repro/launch/train.py``): data pipeline +
train step + checkpoint/restart, under the host mesh.

Runs on the card unless ``--device cpu`` is given (and raises when there
is no card).  Wires the fault-tolerance pieces: atomic checkpoints,
restore-on-start, the heartbeat, the straggler monitor and save-every.
The step runs under ``launch.mesh.make_host_mesh``, as the reference's
runs under the mesh over its devices: one process is the ``(1, 1)`` mesh;
``--ranks N`` spawns N ranks laid out as ``(data = N, model = 1)``, each
stepping on its ``data.host_batch_for_step`` slice of the global batch
(host ``rank`` of N) with the grads averaged across the ranks, rank 0
saving the checkpoints and every rank restoring on start.  The ranks'
states are checked equal at every save and at the end
(``dist.fault.tree_checksum``), and each manifest records the checksum.

    python -m repro_torch.launch.train --arch minicpm-2b --reduced \\
        --steps 30 --ckpt ckpt --device cpu
    python -m repro_torch.launch.train --arch minicpm-2b --reduced \\
        --steps 30 --ckpt ckpt --ranks 2 --device cpu
    python -m repro_torch.launch.train --arch minicpm-2b --steps 4 \\
        --batch 8 --seq 64 --n-micro 2
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, global_batch_for_step, \
    host_batch_for_step
from repro_torch.dist.checkpoint import (latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.dist.fault import (Heartbeat, StragglerMonitor,
                                    tree_checksum)
from repro_torch.dist.sharding import use_mesh
from repro_torch.launch.mesh import launch_ranks, make_host_mesh
from repro_torch.models import init_params
from repro_torch.train import AdamWConfig, init_train_state, make_train_step

__all__ = ["main", "device_batch", "train_rank"]

#: seconds before the ranks of a ``--ranks`` run are killed
RANKS_TIMEOUT_S = 1800.0


def device_batch(dcfg: DataConfig, step: int, dev, host=None) -> dict:
    """The pipeline's global batch of ``step`` (or host ``host``'s slice
    of it) as tensors on ``dev``."""
    batch = global_batch_for_step(dcfg, step) if host is None \
        else host_batch_for_step(dcfg, step, host)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth (full width)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--stop-at", type=int, default=None,
                    help="end the run after this many steps, saving a "
                         "checkpoint there (a preemption: rerun to resume)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="data-parallel rank processes (gloo on one card "
                         "or the host, nccl with a card each)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked)")
    return ap


def train_rank(rank: int, argv, n_ranks: int):
    """One rank's run of the driver (``rank`` 0 of 1 without ``--ranks``);
    returns the last step's loss (the mean over the ranks), or None when
    no step ran."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    opt_cfg = AdamWConfig(lr=args.lr, schedule=cfg.lr_schedule,
                          total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 1))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, n_hosts=n_ranks)
    host = f"host{rank}"
    mesh = make_host_mesh(device=dev)
    with use_mesh(mesh):
        state = init_train_state(init_params(cfg, 0, device=dev))
        start = 0
        if args.ckpt:
            last = latest_step(args.ckpt)
            if last is not None:
                state, _ = restore_checkpoint(args.ckpt, state, step=last)
                start = last
                if rank == 0:
                    print(f"restored step {start}")
        step_fn = make_train_step(cfg, opt_cfg, n_micro=args.n_micro)
        hb = Heartbeat(args.ckpt or os.path.join(tempfile.gettempdir(),
                                                 "hb"), host)
        mon = StragglerMonitor()
        loss = None
        end = args.steps if args.stop_at is None else min(args.stop_at,
                                                          args.steps)
        for step in range(start, end):
            t0 = time.time()
            state, metrics = step_fn(state, device_batch(dcfg, step, dev,
                                                         rank))
            loss = float(metrics["loss"])          # waits for the step
            dt = time.time() - t0
            mon.observe(host, dt)
            hb.beat(step)
            if rank == 0 and (step % args.log_every == 0
                              or step == args.steps - 1):
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.0f}ms", flush=True)
            if args.ckpt and ((step + 1) % args.save_every == 0
                              or step == end - 1):
                checksum = _state_checksum(mesh, state)
                if rank == 0:
                    save_checkpoint(args.ckpt, step + 1, state,
                                    extra_meta={"checksum": checksum})
        if n_ranks > 1:
            checksum = _state_checksum(mesh, state)
            if rank == 0:
                print(f"ranks' states equal: checksum {checksum}",
                      flush=True)
    mesh.close()
    return loss


def _state_checksum(mesh, state) -> list:
    """``dist.fault.tree_checksum`` of (params, optimizer state), equal on
    every rank (each feeds the same averaged grads into the same update;
    raises if not).  Saved in each checkpoint's manifest (``meta``)."""
    sums = mesh.all_gather(tree_checksum((state.params, state.opt)), "data")
    if not all(torch.equal(sums[0], s) for s in sums):
        raise RuntimeError(f"the ranks' replicated states diverged: "
                           f"checksums {sums.tolist()}")
    return sums[0].tolist()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.ranks == 1:
        return train_rank(0, argv, 1)
    if dev.type == "cuda":
        from repro_torch.kernels._build import build_all
        build_all()           # here, before the ranks would race to build
    return launch_ranks(train_rank, args.ranks, (argv, args.ranks),
                        device=dev, timeout_s=RANKS_TIMEOUT_S)[0]


if __name__ == "__main__":
    main()
