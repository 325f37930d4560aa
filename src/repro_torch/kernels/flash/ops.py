"""Public wrapper of blockwise attention (port of
``repro/kernels/flash/ops.py``).

``flash_attention``: (B, S, H, d) q/k/v (GQA-expanded) → (B, S, H, d).
A CUDA tensor goes to the hand-written kernel (``flash_attention.py``),
which reads the (B, S, H, d) layout in place and masks a ragged S itself;
a CPU tensor goes to the materialized twin (``ref.py``) on the folded
(B·H, S, d) view.  There is no fallback between the two.  Forward only:
the backward joins the training slice (ROADMAP queue A item 12).
"""
from __future__ import annotations

from .flash_attention import flash_attention_cuda
from .ref import attention_ref

__all__ = ["flash_attention"]


def _fold(x):  # (B, S, H, d) -> (B*H, S, d)
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _unfold(x, b, h):  # (B*H, S, d) -> (B, S, H, d)
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    b, s, h, d = q.shape
    if q.is_cuda:
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window)
    out = attention_ref(_fold(q), _fold(k), _fold(v), causal=causal,
                        window=window)
    return _unfold(out, b, h)
