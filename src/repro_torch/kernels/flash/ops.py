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

Half-width input (the train step's bf16 cast) is computed in float32 on
both sides: the forward casts q, k, v up for the kernel (whose contract is
float32) and its output back to ``q.dtype``; the backward recomputes the
twin in float32 and casts each gradient back to its input's dtype.

Cost hooks (``kernels._cost``): with a step cost counter active
(``launch.hlo_cost``) the forward reports its FLOPs over the pairs the
mask keeps (4·d per pair: QKᵀ and PV) and its bytes (q, k, v read and the
output written, f32 as the kernel takes them) and on ``meta`` tensors
returns an empty output, running neither the kernel nor the twin.  The
backward's recompute runs through the twin and is counted op by op.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cost

from .flash_attention import flash_attention_cuda
from .ref import attention_ref

__all__ = ["flash_attention", "kept_pairs"]


def kept_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs of one S × S attention that the mask keeps:
    ``j <= i`` when causal, ``i - j < window`` when windowed."""
    if causal:
        if window and window < s:
            return window * (window + 1) // 2 + (s - window) * window
        return s * (s + 1) // 2
    if window and window < s:
        return s * s - (s - window) * (s - window + 1) // 2
    return s * s


def _fold(x):  # (B, S, H, d) -> (B*H, S, d)
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _unfold(x, b, h):  # (B*H, S, d) -> (B, S, H, d)
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2)


def _wide(x):
    """``x`` in float32 when it is narrower (bf16, f16), else as it is."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


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
        if _cost.ACTIVE[0] is not None:
            b, s, h, d = q.shape
            _cost.report("flash_attention",
                         4.0 * d * b * h * kept_pairs(s, causal, window),
                         4 * 4 * q.numel())
            if q.device.type == "meta":
                return torch.empty_like(q)
        if q.is_cuda:
            out = flash_attention_cuda(
                _wide(q).contiguous(), _wide(k).contiguous(),
                _wide(v).contiguous(), causal=causal, window=window)
            return out.to(q.dtype)
        if _cost.ACTIVE[0] is None:
            return _twin(q, k, v, causal, window)
        with _cost.muted():
            return _twin(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        q, k, v = (_wide(t.detach()).requires_grad_() for t in saved)
        with torch.enable_grad():
            out = _twin(q, k, v, ctx.causal, ctx.window)
        grads = torch.autograd.grad(out, (q, k, v), grad_out.to(out.dtype))
        dq, dk, dv = (g.to(t.dtype) for g, t in zip(grads, saved))
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    return _FlashAttention.apply(q, k, v, causal, window)
