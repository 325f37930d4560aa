"""Public wrapper of blockwise attention (port of
``repro/kernels/flash/ops.py``).

``flash_attention``: (B, S, H, d) q/k/v (GQA-expanded) → (B, S, H, d).
A CUDA tensor goes to the hand-written kernel (``flash_attention.py``),
which reads the (B, S, H, d) layout in place and masks a ragged S itself;
a CPU tensor goes to the materialized twin (``ref.py``) on the folded
(B·H, S, d) view.  There is no fallback between the two.

Both run inside one ``torch.autograd.Function``: the forward is the
kernel (or the twin) without a graph, and the backward recomputes the
attention through the materialized twin under ``enable_grad`` and takes
its vector-Jacobian product.  That is the recompute backward the
reference's docstring describes; there is no hand backward kernel.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_cuda
from .ref import attention_ref

__all__ = ["flash_attention"]


def _fold(x):  # (B, S, H, d) -> (B*H, S, d)
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _unfold(x, b, h):  # (B*H, S, d) -> (B, S, H, d)
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2)


def _twin(q, k, v, causal, window):
    b, s, h, d = q.shape
    out = attention_ref(_fold(q), _fold(k), _fold(v), causal=causal,
                        window=window)
    return _unfold(out, b, h)


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel on CUDA, the twin on the CPU.  Backward: the
    twin's gradient, recomputed from the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if q.is_cuda:
            return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=causal,
                                        window=window)
        return _twin(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = _twin(q, k, v, ctx.causal, ctx.window)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad_out)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    return _FlashAttention.apply(q, k, v, causal, window)
