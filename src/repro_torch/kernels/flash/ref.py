"""Plain PyTorch twin of the flash attention kernel (port of
``repro/kernels/flash/ref.py``): the materialized softmax.

The CPU path of ``ops`` runs it; ``chip_smoke.py`` holds the CUDA kernel
against it on the card.
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention_ref"]


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q, k, v: (BH, S, d) → (BH, S, d) with full S×S score materialization."""
    bh, s, d = q.shape
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (j <= i)
    if window > 0:
        mask = mask & (i - j < window)
    scores = torch.where(mask[None], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", probs, v.to(torch.float32))
    return out.to(q.dtype)
