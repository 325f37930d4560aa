"""Model building blocks, dense family (port of ``repro/models/layers.py``).

Plain functions on tensors over the reference's nested-dict param tree
(same keys, layer-stacked leaves sliced per layer by the caller).  The
decode attention updates the KV cache IN PLACE (the reference is
functional): the engines own their caches, and an in-place row write
saves a full cache copy per layer and step.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash

__all__ = ["rmsnorm", "layernorm", "dense", "rope", "KVCache",
           "attention_train", "attention_decode", "mlp", "embed", "unembed"]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(p, x, eps=1e-6):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def layernorm(p, x, eps=1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


def dense(p, x):
    """y = x @ W (+ b) for a raw (in, out) weight, an int8 code leaf, or a
    packed uint8 leaf (the fused dequant-matmuls: the hand-written kernels
    on CUDA, their plain twins on the CPU)."""
    w = p["w"]
    if isinstance(w, dict) and "kshard" in w:
        raise NotImplementedError("k-sharded serving leaves belong to the "
                                  "multi-device slice (ROADMAP item 11)")
    if isinstance(w, dict) and "codes" in w:
        from repro_torch.kernels.dequant import dequant_matmul
        lead = x.shape[:-1]
        x2d = x.reshape(-1, x.shape[-1])
        if w["codes"].dtype == torch.uint8:
            y = dequant_matmul(
                x2d, w["codes"], w["s"], w["t"],
                escapes=(w["esc_row"], w["esc_col"], w["esc_dval"]))
        else:
            # int8 codes stored (in, out): the kernel reads their (out, in)
            # view in place, y = ((x·s) @ codes)·t with the weight kept int8
            y = dequant_matmul(x2d, w["codes"].transpose(-1, -2), w["s"],
                               w["t"])
        y = y.reshape(lead + (y.shape[-1],)).to(x.dtype)
    else:
        y = x @ w.to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding. x: (..., seq, heads, head_dim); positions (..., seq)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs[None, :]
    cos = torch.cos(ang)[..., :, None, :]  # (..., seq, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (full sequence, decode)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Ring-buffered KV cache: buffer length = window (local attention) or
    max_len.  k, v: (B, buf, n_kv, hd), or layer-stacked (L, B, buf, n_kv,
    hd) inside a decode cache."""

    k: torch.Tensor
    v: torch.Tensor


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _attn_scores(q, k, scale):
    # q: (B, S, nq, hd), k: (B, T, nkv, hd) with nq = G*nkv; mixed dtypes
    # promote as in the reference (torch's einsum does not promote)
    dt = torch.promote_types(q.dtype, k.dtype)
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, s, nkv, nq // nkv, hd).to(dt)
    return torch.einsum("bsngh,btnh->bngst", qg, k.to(dt)) * scale


def _attn_out(scores, v):
    dt = torch.promote_types(scores.dtype, v.dtype)
    b, nkv, g, s, t = scores.shape
    out = torch.einsum("bngst,btnh->bsngh", scores.to(dt), v.to(dt))
    return out.reshape(b, s, nkv * g * v.shape[-1])


def attention_train(p, x, *, n_q, n_kv, head_dim, rope_theta=10000.0,
                    causal=True, window: Optional[int] = None,
                    return_kv: bool = False):
    """Full-sequence self-attention (train / evaluation forward, prefill).

    Rope at positions 0..S-1.  Where the reference's flash conditions hold
    (causal, ``n_q == n_kv``, head_dim ∈ {64, 128, 256}) it takes
    ``kernels/flash``: the hand-written kernel for CUDA tensors, its
    materialized twin for CPU tensors, differentiable either way (the
    backward recomputes through the twin).  Other shapes take the plain
    masked softmax over the (S, S) scores.  ``return_kv`` also returns the
    post-rope (K, V), each (B, S, n_kv, head_dim): what a decode cache
    holds.  Cross attention, explicit positions and prefix-LM masks belong
    to the other families (ROADMAP queue A item 12).
    """
    b, s, d = x.shape
    q = _split_heads(dense(p["wq"], x), n_q, head_dim)
    k = _split_heads(dense(p["wk"], x), n_kv, head_dim)
    v = _split_heads(dense(p["wv"], x), n_kv, head_dim)
    positions = torch.arange(s, device=x.device)[None, :]
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    if causal and n_q == n_kv and head_dim in flash.HEAD_DIMS:
        out = flash.flash_attention(q, k, v, causal=True, window=window or 0)
        out = out.reshape(b, s, n_q * head_dim)
    else:
        scores = _attn_scores(q, k, 1.0 / math.sqrt(head_dim))
        i = torch.arange(s, device=x.device)[:, None]
        j = torch.arange(s, device=x.device)[None, :]
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device)
        if causal:
            mask = j <= i
        if window is not None:
            mask = mask & (i - j < window)
        scores = torch.where(mask[None, None, None], scores,
                             torch.full_like(scores, -1e30))
        probs = torch.softmax(scores.to(torch.float32), dim=-1)
        out = _attn_out(probs.to(x.dtype), v)
    out = dense(p["wo"], out)
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(p, x_t, cache: KVCache, pos, *, n_q, n_kv, head_dim,
                     rope_theta=10000.0, window: Optional[int] = None,
                     use_rope=True):
    """Single-token decode against a (ring-buffered) cache.

    x_t: (B, 1, d); ``pos`` is the absolute position of this token — a
    0-d int tensor (lockstep) or a (B,) vector (continuous batching: each
    slot at its own offset).  Writes this token's K/V into ``cache`` in
    place and returns ``(out, cache)``.

    The reference's scatter semantics are reproduced explicitly: a
    per-slot row whose slot lies past the buffer (an idle serving slot
    stepped past max_len) is dropped, never clamped onto live data; a
    scalar write start is clamped into the buffer like
    ``dynamic_update_slice``.  Both without a device-to-host sync.
    """
    b = x_t.shape[0]
    buf = cache.k.shape[1]
    pos = torch.as_tensor(pos, device=x_t.device)
    per_slot = pos.ndim == 1
    q = _split_heads(dense(p["wq"], x_t), n_q, head_dim)
    k_t = _split_heads(dense(p["wk"], x_t), n_kv, head_dim)
    v_t = _split_heads(dense(p["wv"], x_t), n_kv, head_dim)
    posv = pos[:, None] if per_slot else pos.expand(b, 1)
    if use_rope:
        q = rope(q, posv, rope_theta)
        k_t = rope(k_t, posv, rope_theta)
    slot = pos % buf if window is not None else pos
    if per_slot:
        rows = torch.arange(b, device=x_t.device)
        valid = (slot >= 0) & (slot < buf)
        safe = torch.where(valid, slot, torch.zeros_like(slot)).long()
        for big, new in ((cache.k, k_t), (cache.v, v_t)):
            # dropped rows rewrite their slot-0 entry with its own value
            keep = torch.where(valid[:, None, None],
                               new[:, 0].to(big.dtype), big[rows, safe])
            big[rows, safe] = keep
    else:
        start = slot.clamp(0, buf - 1).reshape(1).long()
        for big, new in ((cache.k, k_t), (cache.v, v_t)):
            big.index_copy_(1, start, new.to(big.dtype))
    scores = _attn_scores(q, cache.k, 1.0 / math.sqrt(head_dim))
    idx = torch.arange(buf, device=x_t.device)
    if per_slot:
        if window is not None:
            age = (slot[:, None] - idx[None, :]) % buf
            valid = age < torch.clamp(pos[:, None] + 1, max=buf)
        else:
            valid = idx[None, :] <= pos[:, None]
        mask = valid[:, None, None, None, :]
    else:
        if window is not None:
            age = (slot - idx) % buf
            valid = age < torch.clamp(pos + 1, max=buf)
        else:
            valid = idx <= pos
        mask = valid[None, None, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores.to(torch.float32), dim=-1)
    out = _attn_out(probs.to(x_t.dtype), cache.v)
    return dense(p["wo"], out), cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


_ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda u: F.gelu(u, approximate="tanh"),   # jax.nn.gelu default
    "relu2": lambda u: torch.square(F.relu(u)),
}


def mlp(p, x, *, activation="silu"):
    act = _ACTIVATIONS[activation]
    if "w_gate" in p:
        h = act(dense(p["w_gate"], x)) * dense(p["w_up"], x)
    else:
        h = act(dense(p["w_in"], x))
    return dense(p["w_out"], h)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed(p, tokens):
    return p["w"][tokens]


def unembed(p, x, vocab: Optional[int] = None):
    """Logits against the tied embedding, a plain matmul (it reads the
    whole (padded_vocab, d) table every step); padded rows sliced off."""
    logits = x @ p["w"].to(x.dtype).T
    if vocab is not None and vocab != logits.shape[-1]:
        logits = logits[..., :vocab]
    return logits
