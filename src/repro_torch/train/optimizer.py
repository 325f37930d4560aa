"""AdamW + LR schedules (cosine, WSD) on trees of tensors (port of
``repro/train/optimizer.py``).

Plain PyTorch, not ``torch.optim``: the reference adds the decoupled
weight decay into the Adam direction *before* the learning rate
(``delta = m̂/(√v̂+ε) + wd·p``, ``p ← p − lr·delta``), takes the schedule at
``step + 1`` and computes the bias corrections in float32; this module does
the same arithmetic in the same order (tests/test_torch_train.py holds it
to the reference within 1e-6 relative).

Trees are walked by ``repro_torch.tree`` (``jax.tree_util``'s order).
``AdamWState.step`` is a 0-d int32 tensor on the params' device, so a
checkpoint round-trips it.

:func:`adamw_update` runs under ``torch.no_grad`` and updates ``params``,
``m`` and ``v`` IN PLACE, returning the same tensors in the new state.
The reference's step is functional (its jitted step keeps its input
state); the port's is not because a full-width state holds three float32
copies of the model (minicpm-2b: 32.7 GB), which a second copy would not
leave room for.  Keep a ``clone`` of a state you still need;
``dist.fault.run_with_restarts`` commits a checkpoint of the initial
state for that reason.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "wsd_schedule", "global_norm", "clip_by_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"      # "cosine" | "wsd" | "const"
    warmup_steps: int = 100
    total_steps: int = 10_000
    stable_frac: float = 0.8      # WSD: fraction of steps at peak LR
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def _device(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def adamw_init(params) -> AdamWState:
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=_device(params)),
                      m=tree_map(torch.zeros_like, params),
                      v=tree_map(torch.zeros_like, params))


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def wsd_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Warmup-Stable-Decay (MiniCPM): linear warmup, flat plateau, then
    exponential-style decay over the final (1 − stable_frac) of steps."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    decay_start = cfg.stable_frac * cfg.total_steps
    t = torch.clamp((step - decay_start)
                    / max(cfg.total_steps - decay_start, 1), 0, 1)
    decay = torch.pow(_f32(cfg.min_lr_frac, t.device), t)
    return cfg.lr * warm * decay


def _lr(cfg: AdamWConfig, step) -> torch.Tensor:
    if cfg.schedule == "wsd":
        return wsd_schedule(cfg, step)
    if cfg.schedule == "const":
        return _f32(cfg.lr, torch.as_tensor(step).device)
    return cosine_schedule(cfg, step)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    total = _f32(0.0, _device(tree))
    for x in leaves:
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def _clip_scale(gn, max_norm) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


@torch.no_grad()
def clip_by_norm(tree, max_norm):
    gn = global_norm(tree)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: AdamWState, *,
                 grad_norm=None):
    """One AdamW step; returns (params, new_state, metrics).  ``params``,
    ``state.m`` and ``state.v`` are updated in place (module docstring);
    ``grads`` is read only.  Each leaf is clipped, upcast and updated in
    turn, so the temporaries are a few float32 copies of one leaf.
    ``grad_norm`` replaces ``global_norm(grads)`` where the grads are
    this rank's blocks of a larger tree (``train_loop._mesh_norm``)."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = _clip_scale(gnorm, cfg.clip_norm) if cfg.clip_norm else None
    step = state.step + 1
    lr = _lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(_f32(b1, step.device), step.to(torch.float32))
    bc2 = 1 - torch.pow(_f32(b2, step.device), step.to(torch.float32))
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        if scale is not None:
            g = g * scale.to(g.dtype)
        gf = g.to(torch.float32)
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * torch.square(gf))
        del g, gf
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        pf = p.to(torch.float32)
        delta.add_(cfg.weight_decay * pf)
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_(pf - delta.mul_(lr))
    return params, AdamWState(step=step, m=state.m, v=state.v), \
        {"lr": lr, "grad_norm": gnorm}
