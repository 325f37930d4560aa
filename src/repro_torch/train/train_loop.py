"""The train step on one device (port of ``repro/train/train_loop.py``).

``make_train_step`` — microbatched gradient accumulation, bf16 compute
                      over float32 master weights, AdamW; the step updates
                      the state's tensors in place (``optimizer`` module
                      docstring) and returns it.
``make_compressed_step`` — the reference's DP ``shard_map`` step with the
                      int8 error-feedback all-reduce: it belongs to the
                      multi-device slice (ROADMAP item 11) and raises.

The reference's step is ``jax.jit``-ed with sharded params (FSDP + TP +
EP); this one runs eagerly on the device of the params, and its
attention layers reach the flash kernel (B3) through ``models.loss_fn``.

TrainState is a plain NamedTuple so checkpointing (dist/checkpoint.py) can
treat it as a tree of tensors.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import loss_fn
from repro_torch.opts import enabled as _opt
from repro_torch.tree import tree_leaves, tree_map
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update

__all__ = ["TrainState", "init_train_state", "make_train_step",
           "make_compressed_step", "microbatch_grads"]

_ITEM_11 = ("belongs to the multi-device slice (ROADMAP item 11): the "
            "int8 error-feedback gradient all-reduce over the DP axes")


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    err: Any = None          # grad-compression error feedback (item 11)


def init_train_state(params, use_compression=False) -> TrainState:
    if use_compression:
        raise NotImplementedError(f"use_compression=True {_ITEM_11}")
    return TrainState(params=params, opt=adamw_init(params), err=None)


def _cast(params, compute_dtype):
    """The float32 leaves cast to ``compute_dtype`` (others as they are),
    each a fresh leaf that requires grad: the reference differentiates
    with respect to the cast tree, so its grads come out in the compute
    dtype."""
    def leaf(p):
        if p.dtype == torch.float32:
            p = p.detach().to(compute_dtype)
        else:
            p = p.detach()
        return p.requires_grad_(p.is_floating_point())
    return tree_map(leaf, params)


def _value_and_grad(cfg, cast, batch):
    """(loss, grads in ``cast``'s tree and dtypes); a leaf the loss does
    not reach gets zeros, as ``jax.grad`` gives it."""
    leaves = [t for t in tree_leaves(cast) if t.requires_grad]
    loss = loss_fn(cfg, cast, batch)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def take(t):
        if not t.requires_grad:
            return torch.zeros_like(t)
        g = next(grads)
        return torch.zeros_like(t) if g is None else g
    return loss.detach(), tree_map(take, cast)


def microbatch_grads(cfg: ArchConfig, params, batch, n_micro: int,
                     compute_dtype=torch.bfloat16):
    """Gradient accumulation over ``n_micro`` microbatches (the
    reference's ``lax.scan``, here a loop): each microbatch's grads with
    respect to the cast tree, optionally narrowed to bf16 (the
    ``bf16_grads`` opt), summed into a float32 accumulator; returns the
    mean loss and the mean grads (float32)."""
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"microbatches")
    per = b // n_micro
    cast = _cast(params, compute_dtype)
    bf16_grads = _opt("bf16_grads")
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
    for i in range(n_micro):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        loss, g = _value_and_grad(cfg, cast, mb)
        with torch.no_grad():
            for a, x in zip(tree_leaves(acc), tree_leaves(g)):
                a.add_(x.to(torch.bfloat16) if bf16_grads else x)
            loss_sum = loss_sum + loss
        del g
    with torch.no_grad():
        for a in tree_leaves(acc):
            a.div_(n_micro)
    return loss_sum / n_micro, acc


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                    n_micro: int = 1, compute_dtype=torch.bfloat16
                    ) -> Callable[[TrainState, Any], Tuple[TrainState, Any]]:
    """``step(state, batch) -> (state, {"loss", "lr", "grad_norm"})``;
    ``batch`` holds ``tokens`` and ``targets`` tensors on the params'
    device.  The returned state holds the input state's tensors, updated
    in place."""

    def step(state: TrainState, batch):
        if n_micro > 1:
            loss, grads = microbatch_grads(cfg, state.params, batch, n_micro,
                                           compute_dtype)
        else:
            loss, grads = _value_and_grad(
                cfg, _cast(state.params, compute_dtype), batch)
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, state.params, grads, state.opt)
        del grads
        metrics["loss"] = loss
        return TrainState(params=new_params, opt=new_opt, err=state.err), \
            metrics

    return step


def make_compressed_step(cfg: ArchConfig, opt_cfg: AdamWConfig, mesh, *,
                         compute_dtype=torch.bfloat16):
    """The reference's DP ``shard_map`` step with the int8 error-feedback
    all-reduce; not ported yet."""
    raise NotImplementedError(f"make_compressed_step {_ITEM_11}")
