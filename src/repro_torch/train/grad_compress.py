"""int8 gradient compression for the DP all-reduce, with error feedback
(port of ``repro/train/grad_compress.py``).

Each rank's local gradient leaf plus its error buffer is quantized to int8
at a per-leaf absmax scale common to the DP ranks; the int8 payloads are
exchanged, summed exactly into int32 and dequantized, and the
quantization residual stays in the error buffer, added back next step
(Karimireddy et al. 2019).  The reference runs these inside a
``shard_map`` over the DP axes; the port runs them on each rank
(``train.make_compressed_step``), through the mesh's collectives: one
scalar ``max`` per leaf and its int8 payload, 1 byte per parameter.

Arithmetic as the reference's: ``rint`` is ``torch.round`` (half to
even), the scale ``max|g + e| / 127 + 1e-12``, codes clipped to ±127.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.dist.sharding import HostMesh, current_mesh
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["init_error_buf", "compress_leaf", "compressed_psum_tree"]


def init_error_buf(grads_or_params):
    """Zero float32 error buffers shaped like ``grads_or_params``."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), grads_or_params)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true division (on CUDA, ``x / float`` multiplies by
    the reciprocal)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def compress_leaf(g: torch.Tensor, err: torch.Tensor):
    """Quantize ``g + err`` to int8 at its absmax scale; returns (int8
    payload, float32 scale, new error)."""
    gf = g.to(torch.float32) + err
    scale = _div(torch.max(torch.abs(gf)), 127.0) + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, gf - q.to(torch.float32) * scale


def compressed_psum_tree(grads, err_bufs, axis_names: Sequence[str],
                         mesh: Optional[HostMesh] = None) -> Tuple[Any, Any]:
    """Error-feedback int8 all-reduce-mean of ``grads`` over the mesh axes
    ``axis_names`` (``mesh``: the active mesh when None).

    Per leaf: the scale comes from the ``max`` of the ranks' ``max|g +
    e|`` (a scalar), so the int32 sum of the int8 payloads is exact and
    equal on every rank; it is dequantized, divided by the number of ranks
    and cast back to the grad's dtype.  Returns (mean grads, errors), both
    written IN PLACE: the means into ``grads``' tensors and the new
    float32 errors into ``err_bufs``' (at full width a second copy of
    either does not fit beside the optimizer state); the returned trees
    are the input trees."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise RuntimeError("compressed_psum_tree needs a mesh")
    axes = tuple(axis_names)
    nper = 1
    for a in axes:
        nper *= mesh.shape[a]

    def leaf(g, e):
        # the reference's arithmetic, with in-place temporaries: at full
        # width one leaf (the embedding) is 283 M entries
        gf = g.to(torch.float32) + e
        gmax = mesh.all_reduce(torch.max(torch.abs(gf)), axes, "max")
        scale = _div(gmax, 127.0) + 1e-12
        t = torch.div(gf, scale).round_().clamp_(-127, 127)
        q = t.to(torch.int8)
        torch.sub(gf, t.mul_(scale), out=e)          # gf − q·scale
        del gf, t
        summed = mesh.all_reduce(q, axes, acc_dtype=torch.int32)
        del q
        deq = summed.to(torch.float32)
        del summed
        deq.mul_(scale).div_(torch.full((), float(nper), device=deq.device))
        g.copy_(deq)

    with torch.no_grad():
        for g, e in zip(tree_leaves(grads), tree_leaves(err_bufs)):
            leaf(g, e)
    return grads, err_bufs
