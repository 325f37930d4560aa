"""Full ZSIC through the in-block kernel plus matmul trailing updates (port
of ``repro/kernels/zsic/ops.py``).

``zsic_quantize`` runs Alg. 1 on (a, n) block by block from the right: the
in-block recursion goes to the hand-written kernel (``zsic_block.py``) for
CUDA tensors and to its plain twin (``ref.py``) for CPU tensors — there is
no fallback between the two — and the cancellation onto the columns left
of each block is one ``torch.matmul``.  Each block's codes and residual
go straight into column slices of the full outputs (the kernel writes them
in place).  The reference pads the rows to its row tile; the kernel masks
ragged rows itself, so nothing is padded here.
"""
from __future__ import annotations

import torch

from .ref import zsic_block_ref
from .zsic_block import MAX_BLOCK, zsic_block_cuda

__all__ = ["zsic_quantize", "zsic_block"]


def zsic_block(y, l_block, alphas, *, out=None):
    """One column block: the kernel on CUDA, the twin on the CPU.  With
    ``out = (codes, residual)`` (column slices of the full outputs) the
    kernel writes them in place; on the CPU the twin's result is copied
    in."""
    if y.is_cuda:
        return zsic_block_cuda(y, l_block, alphas, out=out)
    res = zsic_block_ref(y, l_block, alphas)
    if out is None:
        return res
    for dst, src in zip(out, res):
        dst.copy_(src)
    return out


def zsic_quantize(y, l, alphas, *, block: int = MAX_BLOCK):
    """Full Alg. 1 on (a, n): per-block recursion + matmul trailing update.

    Matches ``core.zsic.zsic_numpy`` (float64 reference) up to dtype
    rounding.  Returns (codes int32 (a, n), residual (a, n)).
    """
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"block must lie in 1..{MAX_BLOCK}, got {block}")
    a, n = y.shape
    y = y.clone(memory_format=torch.contiguous_format)
    # the kernel reads L blocks row by row (a Cholesky factor from
    # torch.linalg comes column-major)
    l = l.contiguous()
    alphas = torch.as_tensor(alphas, dtype=y.dtype,
                             device=y.device).expand(n).contiguous()
    z = torch.empty((a, n), dtype=torch.int32, device=y.device)
    resid = torch.empty_like(y)
    for s in reversed(range(0, n, block)):
        e = min(s + block, n)
        zb, _ = zsic_block(y[:, s:e], l[s:e, s:e], alphas[s:e],
                           out=(z[:, s:e], resid[:, s:e]))
        if s > 0:
            scaled = zb.to(y.dtype) * alphas[s:e][None, :]
            y[:, :s] -= scaled @ l[s:e, :s]
    return z, resid
