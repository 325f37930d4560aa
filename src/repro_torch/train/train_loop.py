"""Train steps (port of ``repro/train/train_loop.py``).

``make_train_step`` — microbatched gradient accumulation, bf16 compute
                      over float32 master weights, AdamW; the step updates
                      the state's tensors in place (``optimizer`` module
                      docstring) and returns it.  Under an active mesh
                      whose DP axes hold more than one rank (each rank
                      stepping on its slice of the batch), the grads and
                      the loss are averaged across them by ``all_reduce``:
                      the reduction GSPMD inserts into the reference's
                      jitted step when its batch is sharded.
``make_compressed_step`` — the reference's DP ``shard_map`` step with the
                      int8 error-feedback all-reduce
                      (``train/grad_compress.py``): params replicated,
                      each rank on its slice of the batch.

The reference's step is ``jax.jit``-ed by the driver (its FSDP × TP
layout is lowered only by its dry-run tooling); this one runs eagerly on
the device of the params, and its attention layers reach the flash kernel
(B3) through ``models.loss_fn``.  Under an FSDP × TP layout
(``dist.sharding.use_layout`` of ``models.fsdp_tp_layout``) the state
holds this rank's blocks (``models.fsdp_tp_blocks``): the forward gathers
each layer's over the data axes and runs the layers tensor-parallel over
``model``; the backward's reduce-scatter has summed the blocks' grads over
the data axes, so the step divides them by the data ranks (the other
leaves' grads are averaged across them), clips by the norm summed over
every cut axis and runs AdamW on the blocks.  Under
``moe_a2a`` on a mesh whose ``model`` axis holds several ranks, params may
hold this rank's blocks of the expert stacks (``models.expert_specs``):
the step finds them by their size and sums their squared norms across
``model``, so every rank clips by the same global norm.

TrainState is a plain NamedTuple so checkpointing (dist/checkpoint.py) can
treat it as a tree of tensors.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import (batch_spec, current_layout,
                                       current_mesh)
from repro_torch.models import expert_specs, loss_fn
from repro_torch.opts import enabled as _opt
from repro_torch.tree import tree_leaves, tree_map
from .grad_compress import compressed_psum_tree, init_error_buf
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update

__all__ = ["TrainState", "init_train_state", "make_train_step",
           "make_compressed_step", "microbatch_grads"]


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    err: Any = None          # grad-compression error feedback (optional)


def init_train_state(params, use_compression=False) -> TrainState:
    return TrainState(params=params, opt=adamw_init(params),
                      err=init_error_buf(params) if use_compression else None)


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


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in batch_spec(mesh) if mesh.shape[a] > 1)


def _dp_slice(batch, mesh):
    """This rank's rows of ``batch`` along the mesh's DP axes (pod, data):
    the block at its row-major coordinate over them."""
    n, coord = 1, 0
    for a in batch_spec(mesh):
        n *= mesh.shape[a]
        coord = coord * mesh.shape[a] + mesh.axis_index(a)
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split over {n} DP ranks")
    per = b // n
    return {k: v[coord * per:(coord + 1) * per] for k, v in batch.items()}


@torch.no_grad()
def _mesh_norm(grads, specs, mesh) -> torch.Tensor:
    """The global norm of ``grads`` whose leaves may be this rank's block
    (a ``specs`` entry naming mesh axes): each block's squared sum is
    summed across its axes first, so every rank gets the same bits."""
    per_leaf = []
    tree_map(lambda _, s: per_leaf.append(s), grads, specs)
    total = None
    for g, spec in zip(tree_leaves(grads), per_leaf):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        axes = tuple(a for e in (spec or ()) if e is not None
                     for a in ((e,) if isinstance(e, str) else e))
        if axes:
            sq = mesh.all_reduce(sq, axes)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _block_specs(cfg: ArchConfig, params, mesh):
    """The specs of the leaves of ``params`` that hold this rank's block
    of an expert stack (``models.expert_specs``; every other leaf None),
    or None when none can: expert parallelism runs under ``moe_a2a`` on a
    mesh whose ``model`` axis holds more than one rank.  A leaf counts as
    a block by its size along ``model``: E/model experts, not E (a whole
    stack is cut on entry to the layer and its grad comes back whole)."""
    if not (cfg.n_experts and _opt("moe_a2a")
            and mesh.shape.get("model", 1) > 1):
        return None
    n = mesh.shape["model"]

    def spec_of(leaf, spec):
        if spec is None:
            return None
        return spec if leaf.shape[spec.index("model")] * n \
            == cfg.n_experts else None
    return tree_map(spec_of, params, expert_specs(cfg))


@torch.no_grad()
def _fsdp_tp_reduce(loss, grads, lay):
    """The loss and grads of an FSDP × TP rank averaged over the data
    axes: a block cut over them already holds the sum (the backward of
    ``fsdp_gather``), every other leaf is summed here."""
    mesh = lay.mesh
    dp = _dp_axes(mesh)
    if not dp:
        return loss, grads
    n = 1
    for a in dp:
        n *= mesh.shape[a]
    div = torch.full((), float(n), device=loss.device)

    def mean(g, spec):
        cut = {a for e in spec if e is not None
               for a in ((e,) if isinstance(e, str) else e)}
        if not cut.intersection(dp):
            g = mesh.all_reduce(g, dp)
        return g / div.to(g.dtype)
    return mesh.all_reduce(loss, dp) / div, tree_map(mean, grads, lay.specs)


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                    n_micro: int = 1, compute_dtype=torch.bfloat16
                    ) -> Callable[[TrainState, Any], Tuple[TrainState, Any]]:
    """``step(state, batch) -> (state, {"loss", "lr", "grad_norm"})``;
    ``batch`` holds ``tokens`` and ``targets`` tensors on the params'
    device (under a mesh: this rank's slice of the global batch).  The
    returned state holds the input state's tensors, updated in place.
    Under an FSDP × TP layout the state holds this rank's blocks (module
    docstring).
    Under expert parallelism the params may hold this rank's blocks of
    the expert stacks (``_block_specs``): the clip norm then sums each
    block's squares across ``model``, so every rank clips alike."""

    def step(state: TrainState, batch):
        mesh = current_mesh()
        if n_micro > 1:
            loss, grads = microbatch_grads(cfg, state.params, batch, n_micro,
                                           compute_dtype)
        else:
            loss, grads = _value_and_grad(
                cfg, _cast(state.params, compute_dtype), batch)
        gnorm = None
        lay = current_layout()
        if lay is not None:
            loss, grads = _fsdp_tp_reduce(loss, grads, lay)
            gnorm = _mesh_norm(grads, lay.specs, lay.mesh)
        elif mesh is not None:
            dp = _dp_axes(mesh)
            if dp:
                with torch.no_grad():
                    n = 1
                    for a in dp:
                        n *= mesh.shape[a]
                    div = torch.full((), float(n), device=loss.device)
                    loss = mesh.all_reduce(loss, dp) / div
                    grads = tree_map(
                        lambda g: mesh.all_reduce(g, dp) / div.to(g.dtype),
                        grads)
            specs = _block_specs(cfg, state.params, mesh)
            if specs is not None:
                gnorm = _mesh_norm(grads, specs, mesh)
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, state.params, grads, state.opt, grad_norm=gnorm)
        del grads
        metrics["loss"] = loss
        return TrainState(params=new_params, opt=new_opt, err=state.err), \
            metrics

    return step


def make_compressed_step(cfg: ArchConfig, opt_cfg: AdamWConfig, mesh, *,
                         compute_dtype=torch.bfloat16):
    """The reference's DP step with the int8 error-feedback all-reduce.

    ``step(state, batch)`` takes the global batch and steps on this
    rank's slice of it along the DP axes (``pod``, ``data``) of ``mesh``:
    grads of the cast tree, ``compressed_psum_tree`` over those axes (the
    errors in ``state.err`` updated in place), the loss averaged across
    them, then AdamW in place.  Params stay replicated: every rank feeds
    the same dequantized grads into the same update, so their params stay
    equal bit for bit.  ``state.err`` must hold the error buffers
    (``init_train_state(params, use_compression=True)``)."""
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    nper = 1
    for a in dp_axes:
        nper *= mesh.shape[a]

    def step(state: TrainState, batch):
        if state.err is None:
            raise ValueError("make_compressed_step needs the error buffers "
                             "(init_train_state(..., use_compression=True))")
        loss, grads = _value_and_grad(cfg, _cast(state.params, compute_dtype),
                                      _dp_slice(batch, mesh))
        grads, err = compressed_psum_tree(grads, state.err, dp_axes, mesh)
        with torch.no_grad():
            loss = mesh.all_reduce(loss, dp_axes) / torch.full(
                (), float(nper), device=loss.device)
        new_params, new_opt, metrics = adamw_update(opt_cfg, state.params,
                                                    grads, state.opt)
        del grads
        metrics["loss"] = loss
        return TrainState(new_params, new_opt, err), metrics

    return step
