"""Model building blocks of the decoder families, the encoder–decoder's
cross attention and the prefix-LM mask (port of
``repro/models/layers.py``).

Plain functions on tensors over the reference's nested-dict param tree
(same keys, layer-stacked leaves sliced per layer by the caller).  The
decode attention updates the KV cache IN PLACE (the reference is
functional): the engines own their caches, and an in-place row write
saves a full cache copy per layer and step.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.dist import sharding as _sh
from repro_torch.dist.sharding import (all_gather, axis_index,
                                       manual_axis_info)
from repro_torch.kernels import flash
from repro_torch.opts import enabled as _opt

__all__ = ["rmsnorm", "layernorm", "dense", "rope", "sinusoidal_positions",
           "KVCache", "q8", "attention_train", "attention_decode",
           "cross_attention_decode", "mlp", "moe", "moe_experts", "embed",
           "unembed"]


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
    """y = x @ W (+ b) for a raw (in, out) weight, an int8 code leaf, a
    packed uint8 leaf (the fused dequant-matmuls: the hand-written kernels
    on CUDA, their plain twins on the CPU) or a k-sharded leaf.

    A k-sharded leaf (``serve/sharded.py``, DESIGN.md §13) carries an
    explicit shard axis, one contiguous in-feature block per entry.  On a
    rank's local view the ``manual_axes`` context names the mesh axis and
    the rank computes its one partial; with no context (the oracle) every
    partial is computed here.  Both combine the partials by the same
    ordered chain sum, so the two give the same bits."""
    w = p["w"]
    if isinstance(w, dict) and "kshard" in w:
        from repro_torch.kernels.dequant import dequant_matmul_sharded
        ctx = manual_axis_info()
        axis = ctx.get("axis") if ctx else None
        shards = ctx.get("shards") if ctx else None
        lead = x.shape[:-1]
        x2d = x.reshape(-1, x.shape[-1])
        if "codes" in w:
            esc = ((w["esc_row"], w["esc_col"], w["esc_dval"])
                   if "esc_row" in w else None)
            y = dequant_matmul_sharded(x2d, w["codes"], w["s"], w["t"],
                                       escapes=esc, axis_name=axis,
                                       shards=shards)
        else:
            y = dequant_matmul_sharded(x2d, w["wsh"], axis_name=axis,
                                       shards=shards)
        y = y.reshape(lead + (y.shape[-1],)).to(x.dtype)
    elif isinstance(w, dict) and "codes" in w:
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


def sinusoidal_positions(length, dim, dtype=torch.float32, device=None):
    """(length, dim) sin | cos table of the encoder's positions, computed in
    float64 numpy as the reference's is, then cast: the same bits."""
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / dim)
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(out, device=device).to(dtype)


# ---------------------------------------------------------------------------
# Attention (full sequence, decode, cross)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Ring-buffered KV cache: buffer length = window (local attention) or
    max_len.  k, v: (B, buf, n_kv, hd), or layer-stacked (L, B, buf, n_kv,
    hd) inside a decode cache.

    ``int8_kv`` (``repro_torch.opts``): k/v stored int8 with exact
    per-(position, head) scales ``k_scale``/``v_scale`` of shape (B, buf,
    n_kv, 1) f32 (layer-stacked likewise); () when the cache is float."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Any = ()
    v_scale: Any = ()


def q8(x: torch.Tensor):
    """Per-row int8 quantization over the last axis: ``(rint(x / s), s)``
    with ``s = max(max|x| / 127, 1e-12)`` (the reference's ``q8``).

    ``max|x| / 127`` is taken as XLA compiles the reference's jitted
    decode step: a multiply by the f32 reciprocal of 127 (the same bits on
    the CPU and the card).  ``x / s`` is a true division of tensor by
    tensor, and ``torch.round`` rounds half to even like ``jnp.rint``."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp_min(amax * torch.full_like(amax, 1.0 / 127.0), 1e-12)
    return torch.round(x / s).to(torch.int8), s.to(torch.float32)


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
                    prefix_len: Optional[int] = None,
                    kv_x: Optional[torch.Tensor] = None,
                    positions: Optional[torch.Tensor] = None,
                    use_rope=True, return_kv: bool = False):
    """Full-sequence attention (train / evaluation forward, prefill).

    Self attention ropes q and k at ``positions`` (default 0..S-1) unless
    ``use_rope`` is off; the mask is causal (or none), optionally windowed,
    and ``prefix_len`` opens the first ``prefix_len`` keys to every query
    (the prefix-LM mask ``causal | j < prefix_len``).  ``kv_x`` switches
    to cross attention: keys and values from ``kv_x`` (B, T, d), no mask
    and no rope.  Self attention without a prefix and with
    ``n_q == n_kv`` and head_dim ∈ {64, 128, 256}, causal or not, takes
    ``kernels/flash``: the hand-written kernel for CUDA tensors, its
    materialized twin for CPU tensors, differentiable either way (the
    backward recomputes through the twin).  Cross attention, prefix-LM
    and GQA take the plain masked softmax, as in the reference.
    ``return_kv`` also returns the post-rope (K, V), each (B, T, n_kv,
    head_dim): what a decode cache holds.

    Under an FSDP × TP layout (``dist.sharding.current_layout``) the
    weights are this rank's heads (``models.FsdpTpLayout``): q, k, v are
    column-parallel (their input enters through ``replicate_in``, whose
    backward sums the ranks' partial grads over ``model``), the rank
    attends over its own heads, and wo is row-parallel (its partial
    output summed over ``model`` by ``reduce_out``, its bias added once
    after).  With fewer kv heads than ``model`` ranks, wk and wv are
    whole on every rank and each rank takes the kv head of its q heads.
    """
    lay = _sh.current_layout()
    if lay is not None:
        n_q, n_kv = lay.q_loc, lay.kv_loc
        x = _sh.replicate_in(x, "model", mesh=lay.mesh)
        if kv_x is not None:
            kv_x = _sh.replicate_in(kv_x, "model", mesh=lay.mesh)
    b, s, d = x.shape
    src = x if kv_x is None else kv_x
    t = src.shape[1]
    q = _split_heads(dense(p["wq"], x), n_q, head_dim)
    if lay is not None and lay.kv_rep:
        # whole wk / wv, used in part: their grads sum over ``model``
        pk, pv = ({n: _sh.replicate_in(a, "model", mesh=lay.mesh)
                   for n, a in p[key].items()} for key in ("wk", "wv"))
        pick = lay.kv_pick()
        k = _split_heads(dense(pk, src), -1, head_dim)[:, :, pick:pick + 1]
        v = _split_heads(dense(pv, src), -1, head_dim)[:, :, pick:pick + 1]
    else:
        k = _split_heads(dense(p["wk"], src), n_kv, head_dim)
        v = _split_heads(dense(p["wv"], src), n_kv, head_dim)
    if use_rope and kv_x is None:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    if (kv_x is None and prefix_len is None and n_q == n_kv
            and head_dim in flash.HEAD_DIMS):
        out = flash.flash_attention(q, k, v, causal=causal,
                                    window=window or 0)
        out = out.reshape(b, s, n_q * head_dim)
    else:
        scores = _attn_scores(q, k, 1.0 / math.sqrt(head_dim))
        if kv_x is None:
            i = torch.arange(s, device=x.device)[:, None]
            j = torch.arange(t, device=x.device)[None, :]
            mask = torch.ones((s, t), dtype=torch.bool, device=x.device)
            if causal:
                mask = j <= i
            if window is not None:
                mask = mask & (i - j < window)
            if prefix_len is not None:
                mask = mask | (j < prefix_len)
            scores = torch.where(mask[None, None, None], scores,
                                 torch.full_like(scores, -1e30))
        probs = torch.softmax(scores.to(torch.float32), dim=-1)
        out = _attn_out(probs.to(x.dtype), v)
    if lay is None:
        out = dense(p["wo"], out)
    else:
        out = _row_parallel(p["wo"], out, lay)
    if return_kv:
        return out, (k, v)
    return out


def _row_parallel(p, h, lay):
    """A row-parallel product: this rank's partial ``h @ w`` summed over
    ``model``, then the (whole) bias added once."""
    y = _sh.reduce_out(h @ p["w"].to(h.dtype), "model", mesh=lay.mesh)
    if "b" in p:
        y = y + p["b"].to(h.dtype)
    return y


def attention_decode(p, x_t, cache: KVCache, pos, *, n_q, n_kv, head_dim,
                     rope_theta=10000.0, window: Optional[int] = None,
                     use_rope=True):
    """Single-token decode against a (ring-buffered) cache.

    x_t: (B, 1, d); ``pos`` is the absolute position of this token — a
    0-d int tensor (lockstep) or a (B,) vector (continuous batching: each
    slot at its own offset).  Writes this token's K/V into ``cache`` in
    place and returns ``(out, cache)``.  An int8 cache stores ``q8`` of
    K/V with their scales and attends to the dequantized buffers.

    The reference's scatter semantics are reproduced explicitly: a
    per-slot row whose slot lies past the buffer (an idle serving slot
    stepped past max_len) is dropped, never clamped onto live data; a
    scalar write start is clamped into the buffer like
    ``dynamic_update_slice``.  Both without a device-to-host sync.

    Sharded serving (DESIGN.md §13): under a ``manual_axes`` context with
    ``cache_sharded`` each rank holds one contiguous 1/S block of the
    buffer axis.  Slot arithmetic and masks stay global; a rank writes only
    the rows whose slot falls in its block (the others are dropped), and
    K/V (with the int8 scales) are re-assembled by a tiled all-gather
    before the scores: shard s holds global slots [s·buf_loc,
    (s+1)·buf_loc), so the gathered buffer is the oracle's.
    """
    q = _split_heads(dense(p["wq"], x_t), n_q, head_dim)
    k_t = _split_heads(dense(p["wk"], x_t), n_kv, head_dim)
    v_t = _split_heads(dense(p["wv"], x_t), n_kv, head_dim)
    with obs.span("decode.attention"):
        out = _attend_cache(q, k_t, v_t, cache, pos, x_t.dtype,
                            head_dim=head_dim, rope_theta=rope_theta,
                            window=window, use_rope=use_rope)
    return dense(p["wo"], out), cache


def _attend_cache(q, k_t, v_t, cache: KVCache, pos, dtype, *, head_dim,
                  rope_theta, window, use_rope):
    """The step's attention between its projections (span
    ``decode.attention``): rope on q and the new K/V row, the row's write
    into ``cache``, the int8 dequant, scores, mask, softmax and the
    product with V in ``dtype`` (the layer input's).  Returns the heads'
    output (B, 1, n_q · head_dim)."""
    ctx = manual_axis_info()
    kv_sharded = bool(ctx and ctx.get("cache_sharded"))
    b = q.shape[0]
    dev = q.device
    buf_loc = cache.k.shape[1]
    buf = buf_loc * ctx["shards"] if kv_sharded else buf_loc
    pos = torch.as_tensor(pos, device=dev)
    per_slot = pos.ndim == 1
    posv = pos[:, None] if per_slot else pos.expand(b, 1)
    if use_rope:
        q = rope(q, posv, rope_theta)
        k_t = rope(k_t, posv, rope_theta)
    slot = pos % buf if window is not None else pos
    int8_kv = cache.k.dtype == torch.int8
    if int8_kv:
        k_c, ks_t = q8(k_t)
        v_c, vs_t = q8(v_t)
        writes = ((cache.k, k_c), (cache.v, v_c),
                  (cache.k_scale, ks_t), (cache.v_scale, vs_t))
    else:
        writes = ((cache.k, k_t), (cache.v, v_t))
    if per_slot or kv_sharded:
        rows = torch.arange(b, device=dev)
        loc = slot if per_slot else slot.expand(b)
        if kv_sharded:
            loc = loc - axis_index(ctx["axis"]) * buf_loc
        valid = (loc >= 0) & (loc < buf_loc)
        safe = torch.where(valid, loc, torch.zeros_like(loc)).long()
        for big, new in writes:
            # dropped rows rewrite their slot-0 entry with its own value
            keep = torch.where(valid[:, None, None],
                               new[:, 0].to(big.dtype), big[rows, safe])
            big[rows, safe] = keep
    else:
        start = slot.clamp(0, buf - 1).reshape(1).long()
        for big, new in writes:
            big.index_copy_(1, start, new.to(big.dtype))
    kv = cache
    if kv_sharded:
        # this step's K/V are activations: the gather moves no weights
        kv = KVCache(*(all_gather(t, ctx["axis"], dim=1, tiled=True)
                       if isinstance(t, torch.Tensor) else t for t in cache))
    if int8_kv:
        k_eff = kv.k.to(q.dtype) * kv.k_scale.to(q.dtype)
        v_eff = kv.v.to(q.dtype) * kv.v_scale.to(q.dtype)
    else:
        k_eff, v_eff = kv.k, kv.v
    scores = _attn_scores(q, k_eff, 1.0 / math.sqrt(head_dim))
    idx = torch.arange(buf, device=dev)
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
    return _attn_out(probs.to(dtype), v_eff)


def cross_attention_decode(p, x_t, k, v, *, n_q, n_kv, head_dim):
    """Cross attention of x_t (B, S, d) against fixed encoder K/V (B, T,
    n_kv, head_dim): no mask, no rope.  Decode runs it at S = 1 against a
    cache's extras; the exact prefill at the prompt's S."""
    q = _split_heads(dense(p["wq"], x_t), n_q, head_dim)
    scores = _attn_scores(q, k, 1.0 / math.sqrt(head_dim))
    probs = torch.softmax(scores.to(torch.float32), dim=-1)
    out = _attn_out(probs.to(x_t.dtype), v)
    return dense(p["wo"], out)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


_ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda u: F.gelu(u, approximate="tanh"),   # jax.nn.gelu default
    "relu2": lambda u: torch.square(F.relu(u)),
}


def mlp(p, x, *, activation="silu"):
    """The (gated) MLP.  Under an FSDP × TP layout the gate/up (in)
    products are column-parallel over this rank's ff block and w_out is
    row-parallel, as in :func:`attention_train`."""
    act = _ACTIVATIONS[activation]
    lay = _sh.current_layout()
    if lay is not None:
        x = _sh.replicate_in(x, "model", mesh=lay.mesh)
    if "w_gate" in p:
        h = act(dense(p["w_gate"], x)) * dense(p["w_up"], x)
    else:
        h = act(dense(p["w_in"], x))
    if lay is not None:
        return _row_parallel(p["w_out"], h, lay)
    return dense(p["w_out"], h)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_router_logits(p_router, xt):
    """Router logits (T, E) in f32.  A raw router weight is a plain f32
    product, as in the reference; a quantized one (a code leaf: with 64
    experts the (d, E) router passes ``min_dim``) goes through ``dense``
    and so through the dequant kernel.  The reference multiplies the leaf
    dict itself there and raises (ROADMAP queue C)."""
    w = p_router["w"]
    if isinstance(w, dict):
        return dense({"w": w}, xt.to(torch.float32)).to(torch.float32)
    return xt.to(torch.float32) @ w.to(torch.float32)


def _moe_top_k(logits, top_k: int):
    """Softmax gates in f32, then the top ``top_k`` per token with equal
    gates ordered toward the lower expert index (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none), renormalized to sum 1."""
    gates = torch.softmax(logits.to(torch.float32), dim=-1)
    top_g, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_g, top_e = top_g[:, :top_k], top_e[:, :top_k]
    top_g = top_g / torch.clamp_min(top_g.sum(-1, keepdim=True), 1e-9)
    return top_g, top_e


class MoEDispatch(NamedTuple):
    """Where each routed (token, expert) pair went, in expert-sorted order:
    ``dest`` its flat buffer slot e·C + pos (0 for a dropped pair),
    ``keep`` whether it fit the capacity, ``weights`` its renormalized
    gate; ``pairs`` (T, k) holds each token's sorted positions in
    ascending order (ascending expert)."""

    dest: torch.Tensor
    keep: torch.Tensor
    weights: torch.Tensor
    pairs: torch.Tensor


def _moe_dispatch(top_e, top_g, capacity: int, top_k: int):
    """Where each routed pair goes: (:class:`MoEDispatch`, each sorted
    pair's token).  Pairs are sorted by expert with a stable sort (ties
    keep token order); a pair's position in its expert's segment comes
    from ``searchsorted(side="left")``; pairs past ``capacity`` are
    dropped."""
    t = top_e.shape[0]
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = torch.arange(t * top_k, device=top_e.device)
    pos_in_e = idx - torch.searchsorted(sorted_e, sorted_e, side="left")
    keep = pos_in_e < capacity
    dest = sorted_e * capacity + torch.where(keep, pos_in_e,
                                             torch.zeros_like(pos_in_e))
    inv = torch.empty_like(order)
    inv[order] = idx
    pairs = inv.reshape(t, top_k).sort(dim=1).values
    return (MoEDispatch(dest, keep, top_g.reshape(-1)[order], pairs),
            order // top_k)


def _moe_fill(xt, disp: MoEDispatch, src, n_slots: int, first_slot=0):
    """The capacity buffer (n_slots, d) of slots ``first_slot`` on: each
    kept pair's token copied to its slot.  A kept slot has exactly one
    writer, so the buffer is a plain indexed copy (other pairs write a
    scratch row past the buffer, cut off) instead of the reference's
    scatter-add of zeros: no atomics.  Returns (buffer, the dispatch with
    ``dest`` counted from ``first_slot`` and ``keep`` cleared for pairs
    outside the buffer)."""
    dest = disp.dest - first_slot
    keep = disp.keep & (dest >= 0) & (dest < n_slots)
    dest = torch.where(keep, dest, torch.zeros_like(dest))
    slot = torch.where(keep, dest, torch.full_like(dest, n_slots))
    buf = xt.new_zeros((n_slots + 1, xt.shape[1]))
    buf[slot] = xt[src]
    return buf[:-1], disp._replace(dest=dest, keep=keep)


def _moe_local_pack(xt, top_e, top_g, n_experts: int, capacity: int,
                    top_k: int):
    """Sort-based local dispatch: xt (T, d) → buf (E, C, d) + the pairs'
    :class:`MoEDispatch` (the reference's ``_moe_local_pack``;
    :func:`_moe_dispatch`, :func:`_moe_fill`)."""
    disp, src = _moe_dispatch(top_e, top_g, capacity, top_k)
    buf, disp = _moe_fill(xt, disp, src, n_experts * capacity)
    return buf.reshape(n_experts, capacity, xt.shape[1]), disp


def _moe_combine(out_buf, disp: MoEDispatch):
    """out_buf (E, C, d) → (T, d): each token's kept pairs weighted by
    their gates and summed one pair at a time in ascending expert order
    (the order the reference's scatter-add meets them), by gathering
    through the inverse permutation: a fixed order, no atomics."""
    d = out_buf.shape[-1]
    dt = out_buf.dtype
    gathered = out_buf.reshape(-1, d)[disp.dest] * disp.keep[:, None].to(dt)
    contrib = gathered * disp.weights[:, None].to(dt)
    per_token = contrib[disp.pairs]                          # (T, k, d)
    out = per_token[:, 0]
    for j in range(1, per_token.shape[1]):
        out = out + per_token[:, j]
    return out


def _expert_matmul(inp, w):
    """(E, C, din) × one expert leaf → (E, C, dout): a raw (E, din, dout)
    weight, an int8 code leaf (codes (E, din, dout), s (E, din), t (E,
    dout)) or a packed-int4 leaf (payload (E, dout, ceil(din/2)),
    escape-free), unpacked and multiplied by a batched product; the
    reference computes these outside any kernel, through XLA's einsum."""
    if not (isinstance(w, dict) and "codes" in w):
        return torch.bmm(inp, w.to(inp.dtype))
    codes = w["codes"]
    scaled = inp * w["s"].to(inp.dtype)[:, None, :]
    if codes.dtype == torch.uint8:
        if codes.ndim >= 3 and codes.shape[-2] in (1, 3):
            raise ValueError("int2/int3 expert leaves unsupported — serve "
                             "experts ≥ 4b (quantize_params_tree promotes "
                             "them automatically)")
        if w["esc_row"].shape[-1] != 0:
            raise ValueError("packed MoE escapes unsupported; use "
                             "escape_capacity=0")
        from repro_torch.core.packing import unpack_int4_planar
        z = unpack_int4_planar(codes)[..., :inp.shape[-1]]    # (E, dout, din)
        out = torch.bmm(scaled, z.to(inp.dtype).transpose(1, 2))
    else:
        out = torch.bmm(scaled, codes.to(inp.dtype))
    return out * w["t"].to(inp.dtype)[:, None, :]


def _expert_ffn(w, buf, activation):
    """The experts' (gated) FFNs on their capacity rows: buf (E', C, d)
    through the expert leaves ``w`` (E', …) → (hidden (E', C, ff), out
    (E', C, d))."""
    act = _ACTIVATIONS[activation]
    if "w_gate" in w:
        h = act(_expert_matmul(buf, w["w_gate"])) \
            * _expert_matmul(buf, w["w_up"])
    else:
        h = act(_expert_matmul(buf, w["w_in"]))
    return h, _expert_matmul(h, w["w_out"])


def moe_experts(p, xt, *, n_experts, top_k, capacity, activation="silu"):
    """Route ``xt`` (T, d) and run the experts at ``capacity`` slots each:
    (out (T, d), buf (E, C, d), hidden (E, C, ff), :class:`MoEDispatch`).
    ``moe``'s body; calibration calls it at its drop-free capacity and
    taps the buffers."""
    top_g, top_e = _moe_top_k(_moe_router_logits(p["router"], xt), top_k)
    buf, disp = _moe_local_pack(xt, top_e, top_g, n_experts, capacity, top_k)
    h, out = _expert_ffn(p, buf, activation)
    return _moe_combine(out, disp), buf, h, disp


def moe(p, x, *, n_experts, top_k, capacity_factor=1.25, activation="silu"):
    """Top-k token-choice MoE with a sort-based capacity buffer.

    Tokens are flattened, routed, sorted by expert and packed into an (E,
    C, d) buffer, pushed through the experts' FFNs as batched products and
    combined back with their gates.  Over-capacity pairs are dropped
    (GShard semantics), so the rows of one call share each expert's
    capacity.  ``moe_dispatch_shard`` is a sharding annotation of the
    reference, a no-op here.

    ``moe_a2a`` (``REPRO_OPTS``): under an active mesh with a ``model``
    axis that divides the experts and the sequence, and outside a
    ``manual_axes`` scope (k-sharded serving keeps the local path), the
    experts run expert-parallel with explicit all-to-alls
    (:func:`_moe_a2a`), the reference's conditions exactly.  Otherwise,
    under an FSDP × TP layout, the experts run expert-parallel inside the
    tensor-parallel layer (:func:`_moe_tp`).
    """
    if _opt("moe_a2a"):
        mesh = _sh.current_mesh()
        if mesh is not None and not _sh.in_manual_axes() \
                and "model" in mesh.axis_names \
                and n_experts % mesh.shape["model"] == 0 \
                and x.shape[1] % mesh.shape["model"] == 0:
            return _moe_a2a(p, x, mesh, n_experts=n_experts, top_k=top_k,
                            capacity_factor=capacity_factor,
                            activation=activation)
    b, s, d = x.shape
    t = b * s
    capacity = max(int(math.ceil(t * top_k / n_experts * capacity_factor)),
                   top_k)
    lay = _sh.current_layout()
    if lay is not None:
        return _moe_tp(p, x, lay, n_experts=n_experts, top_k=top_k,
                       capacity=capacity, activation=activation)
    out = moe_experts(p, x.reshape(t, d), n_experts=n_experts, top_k=top_k,
                      capacity=capacity, activation=activation)[0]
    return out.reshape(b, s, d)


def _moe_tp(p, x, lay, *, n_experts, top_k, capacity, activation):
    """The MoE layer of an FSDP × TP rank: ``x`` (B, S, d) replicated
    across ``model``, the router's and the expert stacks' ``experts`` dim
    cut over it (this rank holds E/model whole experts).

    Every rank routes the same tokens alike: its block of the router
    logits is gathered over ``model`` (backward: the ranks' partial
    grads summed, then its block), then the top-k and the capacity
    dispatch of the one-process layer.  The rank packs the capacity rows
    of its own experts only, runs them, combines the pairs routed to them
    and ``reduce_out`` sums the partial outputs over ``model``.  The same
    rows in a call give the same routing, capacity and drops as one
    process."""
    b, s, d = x.shape
    mesh = lay.mesh
    x = _sh.replicate_in(x, "model", mesh=mesh)
    xt = x.reshape(b * s, d)
    router = p["router"]["w"]
    if isinstance(router, dict):
        raise ValueError("the FSDP × TP MoE runs a float router")
    logits = _sh.fsdp_gather(_moe_router_logits({"w": router}, xt),
                             ("model",), -1, mesh=mesh)
    top_g, top_e = _moe_top_k(logits, top_k)
    disp, src = _moe_dispatch(top_e, top_g, capacity, top_k)
    n_loc = n_experts // lay.tp
    first = mesh.axis_index("model") * n_loc
    buf, disp = _moe_fill(xt, disp, src, n_loc * capacity, first * capacity)
    _, out = _expert_ffn(p, buf.reshape(n_loc, capacity, d), activation)
    part = _moe_combine(out, disp).reshape(b, s, d)
    return _sh.reduce_out(part, "model", mesh=mesh)


def _expert_block(w, mesh, n_experts: int):
    """This rank's (E/model, …) block of an expert leaf: the leaf itself
    when it already is one (as under an FSDP × TP layout), else cut from
    the whole stack by ``sharding.shard_in`` (its grad comes back whole
    on every rank)."""
    if isinstance(w, dict):
        raise ValueError("the expert-parallel MoE runs float expert "
                         "weights (the reference's a2a einsums take no "
                         "code leaves)")
    n = mesh.shape["model"]
    if w.shape[0] == n_experts:
        return _sh.shard_in(w, "model", 0, mesh=mesh)
    if w.shape[0] * n != n_experts:
        raise ValueError(f"expert leaf {tuple(w.shape)}: neither the "
                         f"{n_experts} experts nor this rank's "
                         f"{n_experts // n}")
    return w


def _moe_a2a(p, x, mesh, *, n_experts, top_k, capacity_factor, activation):
    """Expert parallelism with explicit all-to-alls (the reference's
    ``_moe_a2a``, whose ``shard_map`` region is entered and left here
    through ``dist.sharding``'s differentiable boundaries).

    ``x`` is this rank's rows of the batch (its block along the DP axes,
    as every layer under a DP mesh sees it), replicated across ``model``.
    On entry each rank takes its block of the sequence (:func:`shard_in`)
    and routes those tokens into an (E, C, d) buffer at the reference's
    local capacity, ``t_loc = b·s / (model · dp)`` of the global batch;
    the all-to-all over ``model`` sends each expert-major slice to the
    rank that owns those experts, which runs its E/model experts as
    batched products on all the tokens routed to them; the reverse
    all-to-all brings the outputs back, the local combine follows, and
    the blocks are gathered along the sequence on exit
    (:func:`gather_out`).  The router is replicated (its grad is summed
    across ``model``, :func:`replicate_in`); each expert leaf is this
    rank's block of the stacked (E, …) leaf (spec ``("model", None,
    None)``) or the whole stack, cut on entry.  Under an FSDP × TP layout
    the router holds this rank's block of the experts' columns, gathered
    over ``model`` on entry (its grad summed, then cut), and the expert
    leaves are this rank's blocks.  Grads across the DP axes are the
    train step's to average."""
    n_model = mesh.shape["model"]
    b, s, d = x.shape
    t_loc = (b * s) // n_model
    capacity = max(int(math.ceil(t_loc * top_k / n_experts
                                 * capacity_factor)), top_k)
    x_blk = _sh.shard_in(x, "model", 1, mesh=mesh)
    bb, ss, _ = x_blk.shape
    xt = x_blk.reshape(bb * ss, d)
    router = p["router"]["w"]
    if isinstance(router, dict):
        raise ValueError("the expert-parallel MoE runs a float router")
    if _sh.current_layout() is None:
        router = _sh.replicate_in(router, "model", mesh=mesh)
    else:
        router = _sh.fsdp_gather(router, ("model",), -1, mesh=mesh)
    top_g, top_e = _moe_top_k(_moe_router_logits({"w": router}, xt), top_k)
    buf, disp = _moe_local_pack(xt, top_e, top_g, n_experts, capacity, top_k)
    # (E, C, d) -> (E/model, model·C, d): expert-major slices to their owner
    ex = _sh.all_to_all(buf, "model", 0, 1, mesh=mesh)
    w = {k: _expert_block(p[k], mesh, n_experts)
         for k in ("w_gate", "w_up", "w_in", "w_out") if k in p}
    back = _sh.all_to_all(_expert_ffn(w, ex, activation)[1], "model", 1, 0,
                          mesh=mesh)                         # (E, C, d)
    out = _moe_combine(back, disp).reshape(bb, ss, d)
    return _sh.gather_out(out, "model", 1, mesh=mesh)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed(p, tokens):
    """Rows of the embedding table.  Under an FSDP × TP layout the table
    is this rank's block of vocab rows: tokens outside it give zero rows
    and ``reduce_out`` sums the ranks' rows over ``model``."""
    lay = _sh.current_layout()
    if lay is None:
        return p["w"][tokens]
    w = p["w"]
    n = w.shape[0]
    local = tokens.long() - _sh.axis_index("model") * n
    hit = (local >= 0) & (local < n)
    rows = w[local.clamp(0, n - 1)] * hit[..., None].to(w.dtype)
    return _sh.reduce_out(rows, "model", mesh=lay.mesh)


def unembed(p, x, vocab: Optional[int] = None):
    """Logits against the tied embedding, a plain matmul (it reads the
    whole (padded_vocab, d) table every step); padded rows sliced off.
    Under an FSDP × TP layout: this rank's block of the padded vocab's
    logits (``models.loss_fn`` masks the padded columns)."""
    lay = _sh.current_layout()
    if lay is not None:
        x = _sh.replicate_in(x, "model", mesh=lay.mesh)
        return x @ p["w"].to(x.dtype).T
    logits = x @ p["w"].to(x.dtype).T
    if vocab is not None and vocab != logits.shape[-1]:
        logits = logits[..., :vocab]
    return logits
