"""Decoder of the dense and MoE families: init, full-sequence forward,
slot KV cache and decode (port of those families of
``repro/models/transformer.py``; a MoE layer runs ``layers.moe`` where a
dense one runs ``layers.mlp``).

API (plain functions of (cfg, params, ...)):
  init_params(cfg, seed, device)             -> param tree (reference keys)
  forward_train(cfg, params, batch)          -> full-sequence logits
  loss_fn(cfg, params, batch)                -> mean next-token NLL
  init_cache(cfg, batch, max_len, dtype)     -> DecodeCache
  decode_step(cfg, params, cache, token)     -> (logits, cache)
  decode_chunk(cfg, params, cache, tokens)   -> (last logits, cache)
  prefill(cfg, params, batch, max_len)       -> (last logits, cache)
  cache_write_slot / cache_reset_slot        -> slot graft / eviction
  split_layers(params)                       -> params with per-layer views

The reference's ``jax.lax.scan`` over layers is a Python loop over the
first axis of the stacked leaves.  The decode functions take either the
stacked tree or one that :func:`split_layers` already cut into per-layer
views; a caller that steps many times (the engines) splits once.  K/V
buffers are updated in place; the returned cache shares them with the
input cache and carries a new position tensor.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.opts import enabled as _opt
from .layers import (KVCache, attention_decode, attention_train, embed,
                     kv_tensors, layernorm, mlp, moe, q8, rmsnorm, unembed)

__all__ = ["init_params", "forward_train", "loss_fn", "init_cache",
           "decode_step", "decode_chunk", "prefill", "cache_write_slot",
           "cache_reset_slot", "cache_rows", "layer_kv", "split_layers",
           "DecodeCache"]


def _check_family(cfg: ArchConfig):
    if cfg.family not in ("dense", "moe") or cfg.block_pattern \
            or (cfg.family == "moe") != bool(cfg.n_experts):
        raise NotImplementedError(
            f"{cfg.name}: only the dense and MoE families are ported "
            "(ROADMAP item 12)")


def _ffn(cfg, lp, x):
    """The layer's feed-forward block: the experts of a MoE layer, else
    the MLP."""
    if cfg.n_experts:
        return moe(lp["moe"], x, n_experts=cfg.n_experts, top_k=cfg.top_k,
                   capacity_factor=cfg.capacity_factor,
                   activation=cfg.activation)
    return mlp(lp["mlp"], x, activation=cfg.activation)


def _norm(cfg, p, x):
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None,
                dtype=torch.float32):
    """Random decoder params on ``device`` from a ``torch.Generator``.

    Same tree and shapes as the reference's ``init_params`` (after
    ``split_tree``); the values differ by design.  Weights are normal with
    std 1/sqrt(in_features), biases 0, norm scales 1, the embedding normal
    with std 0.02.  A MoE layer holds ``moe = {router: {w: (L, d, E)},
    w_gate, w_up: (L, E, d, ff), w_out: (L, E, ff, d)}`` (``w_in`` in
    place of the gate and up weights when the MLP is not gated) where a
    dense one holds ``mlp``.
    """
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.resolved_head_dim

    def normal(shape, std):
        # scaled in place: a full-width expert stack is 13 GB of f32
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).mul_(std).to(dtype)

    def lin(n_in, n_out, bias):
        p = {"w": normal((L, n_in, n_out), n_in ** -0.5)}
        if bias:
            p["b"] = torch.zeros((L, n_out), dtype=dtype, device=dev)
        return p

    def norm():
        p = {"scale": torch.ones((L, d), dtype=torch.float32, device=dev)}
        if cfg.norm == "layernorm":
            p["bias"] = torch.zeros((L, d), dtype=torch.float32, device=dev)
        return p

    attn = {"wq": lin(d, cfg.n_heads * hd, cfg.qkv_bias),
            "wk": lin(d, cfg.n_kv * hd, cfg.qkv_bias),
            "wv": lin(d, cfg.n_kv * hd, cfg.qkv_bias),
            "wo": lin(cfg.n_heads * hd, d, cfg.out_bias)}
    if cfg.n_experts:
        E, ff = cfg.n_experts, cfg.d_ff
        ffn = {"router": lin(d, E, False),
               "w_out": normal((L, E, ff, d), ff ** -0.5)}
        for key in (("w_gate", "w_up") if cfg.gated_mlp else ("w_in",)):
            ffn[key] = normal((L, E, d, ff), d ** -0.5)
    else:
        ffn = {"w_out": lin(cfg.d_ff, d, cfg.out_bias)}
        if cfg.gated_mlp:
            ffn["w_gate"] = lin(d, cfg.d_ff, cfg.out_bias)
            ffn["w_up"] = lin(d, cfg.d_ff, cfg.out_bias)
        else:
            ffn["w_in"] = lin(d, cfg.d_ff, cfg.out_bias)
    ln_f = {"scale": torch.ones((d,), dtype=torch.float32, device=dev)}
    if cfg.norm == "layernorm":
        ln_f["bias"] = torch.zeros((d,), dtype=torch.float32, device=dev)
    return {"embed": {"w": normal((cfg.padded_vocab, d), 0.02)},
            "layers": {"ln_attn": norm(), "attn": attn, "ln_mlp": norm(),
                       "moe" if cfg.n_experts else "mlp": ffn},
            "ln_f": ln_f}


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------


def _attn_kwargs(cfg):
    return dict(n_q=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.resolved_head_dim,
                rope_theta=cfg.rope_theta)


def _embed_tokens(cfg, params, tokens):
    x = embed(params["embed"], tokens)
    if cfg.embed_scale:
        x = x * cfg.d_model ** 0.5
    return x


def forward_train(cfg: ArchConfig, params, batch) -> torch.Tensor:
    """Full-sequence logits (B, S, vocab) of ``batch["tokens"]`` (B, S),
    causal, every layer's attention through ``attention_train``."""
    _check_family(cfg)
    x = _embed_tokens(cfg, params, batch["tokens"])
    for lp in split_layers(params)["layers"]:
        x = x + attention_train(lp["attn"], _norm(cfg, lp["ln_attn"], x),
                                causal=True,
                                window=cfg.local_window or None,
                                **_attn_kwargs(cfg))
        x = x + _ffn(cfg, lp, _norm(cfg, lp["ln_mlp"], x))
    x = _norm(cfg, params["ln_f"], x)
    return unembed(params["embed"], x, cfg.vocab)


def loss_fn(cfg: ArchConfig, params, batch) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``batch["targets"]``."""
    logits = forward_train(cfg, params, batch).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, batch["targets"][..., None].long())[..., 0]
    return -ll.mean()


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


class DecodeCache(NamedTuple):
    kv: Any                   # KVCache, each (L, B, buf, n_kv, hd) (+ the
                              # int8 scales (L, B, buf, n_kv, 1))
    pos: torch.Tensor         # int32: 0-d (lockstep) or (B,) per slot
    extras: Any = ()


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, per_slot: bool = False,
               device=None) -> DecodeCache:
    """Fresh decode cache; ``per_slot=True`` makes ``pos`` a (batch,)
    vector, one position counter per serving slot.  With ``REPRO_OPTS``
    holding ``int8_kv`` the K/V buffers are int8 with f32 scales (the
    reference's ``_kv_buf``) and ``dtype`` is not used."""
    _check_family(cfg)
    dev = resolve_device(device)
    buf = min(max_len, cfg.local_window) if cfg.local_window else max_len
    shape = (cfg.n_layers, batch, buf, cfg.n_kv, cfg.resolved_head_dim)
    if _opt("int8_kv"):
        sshape = shape[:-1] + (1,)
        kv = KVCache(k=torch.zeros(shape, dtype=torch.int8, device=dev),
                     v=torch.zeros(shape, dtype=torch.int8, device=dev),
                     k_scale=torch.zeros(sshape, dtype=torch.float32,
                                         device=dev),
                     v_scale=torch.zeros(sshape, dtype=torch.float32,
                                         device=dev))
    else:
        kv = KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                     v=torch.zeros(shape, dtype=dtype, device=dev))
    pos = torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                      device=dev)
    return DecodeCache(kv, pos)


def layer_kv(kv: KVCache, i: int) -> KVCache:
    """Layer ``i``'s views of a layer-stacked KV cache (scales included)."""
    return KVCache(*(t[i] if torch.is_tensor(t) else t for t in kv))


def cache_rows(cache: DecodeCache, i: int) -> DecodeCache:
    """Batch row ``i`` of a cache as a batch-1 cache of views."""
    return cache._replace(kv=KVCache(*(t[:, i:i + 1] if torch.is_tensor(t)
                                       else t for t in cache.kv)))


def _slot_index(slot, batch: int) -> int:
    # dynamic_update_slice clamps the start into range; so does this
    return min(max(int(slot), 0), batch - 1)


def cache_write_slot(cache: DecodeCache, sub: DecodeCache,
                     slot) -> DecodeCache:
    """Graft a batch-1 ``sub`` cache into row ``slot`` of a per-slot cache
    (in place): the admission primitive of the continuous engine."""
    if cache.pos.ndim != 1:
        raise ValueError("cache_write_slot needs a per-slot cache")
    i = _slot_index(slot, cache.pos.shape[0])
    for big, small in zip(kv_tensors(cache.kv), kv_tensors(sub.kv)):
        big[:, i:i + 1] = small.to(big.dtype)
    sub_pos = sub.pos if sub.pos.ndim == 0 else sub.pos[0]
    cache.pos[i] = sub_pos.to(torch.int32)
    return cache


def cache_reset_slot(cache: DecodeCache, slot) -> DecodeCache:
    """Zero row ``slot`` of a per-slot cache and its position (in place)."""
    if cache.pos.ndim != 1:
        raise ValueError("cache_reset_slot needs a per-slot cache")
    i = _slot_index(slot, cache.pos.shape[0])
    for big in kv_tensors(cache.kv):
        big[:, i:i + 1] = 0
    cache.pos[i] = 0
    return cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _layer_params(layers):
    """Stacked layer tree → list of per-layer trees (views)."""
    n_layers = next(iter(_leaves(layers))).shape[0]
    out = [dict() for _ in range(n_layers)]

    def split(node, dst):
        for k, v in node.items():
            if isinstance(v, dict):
                for i, sub in enumerate(dst):
                    sub[k] = {}
                split(v, [sub[k] for sub in dst])
            else:
                for sub, view in zip(dst, v.unbind(0)):
                    sub[k] = view

    split(layers, out)
    return out


def _leaves(node):
    for v in node.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def split_layers(params):
    """``params`` with its stacked ``layers`` tree cut into a list of
    per-layer trees of views (no copy); the other entries are shared."""
    if isinstance(params["layers"], list):
        return params
    return {**params, "layers": _layer_params(params["layers"])}


def decode_step(cfg: ArchConfig, params, cache: DecodeCache, token):
    """One decode step: token (B, 1) int → (logits (B, vocab), cache)."""
    _check_family(cfg)
    pos = cache.pos
    x = _embed_tokens(cfg, params, token)
    ak = dict(_attn_kwargs(cfg), window=cfg.local_window or None)
    layers = split_layers(params)["layers"]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"params hold {len(layers)} layers, "
                         f"{cfg.name} has {cfg.n_layers}")
    for i, lp in enumerate(layers):
        a_in = _norm(cfg, lp["ln_attn"], x)
        a_out, _ = attention_decode(
            lp["attn"], a_in, layer_kv(cache.kv, i), pos, **ak)
        x = x + a_out
        x = x + _ffn(cfg, lp, _norm(cfg, lp["ln_mlp"], x))
    x = _norm(cfg, params["ln_f"], x)
    logits = unembed(params["embed"], x, cfg.vocab)[:, 0, :]
    return logits, DecodeCache(cache.kv, pos + 1, cache.extras)


def decode_chunk(cfg: ArchConfig, params, cache: DecodeCache, tokens):
    """Step the cache ``tokens.shape[1]`` tokens: (B, C) → (logits of the
    LAST token (B, vocab), cache).  Exactly C :func:`decode_step` calls
    (the reference's scan body is decode_step too)."""
    params = split_layers(params)
    logits = None
    for j in range(tokens.shape[1]):
        logits, cache = decode_step(cfg, params, cache, tokens[:, j:j + 1])
    return logits, cache


def prefill(cfg: ArchConfig, params, batch, max_len: int,
            cache_dtype=torch.bfloat16):
    """Run the whole prompt in one full-sequence pass: (B, S) tokens →
    (logits of the LAST token (B, vocab), a lockstep cache at position S).

    Port of the dense family of the reference's ``prefill``
    (``_prefill_attn``), made exact: each layer's post-norm, post-rope K/V
    come out of the same ``attention_train`` that computes the layer (every
    dense over B·S rows, flash attention where its conditions hold) and go
    into the slot cache, so the cache is the one ``decode_chunk`` builds
    over the same prompt, up to f32 rounding (the reference's
    ``_capture_kv`` projects the raw embeddings instead; ROADMAP queue C).
    A windowed cache holds the last ``buf`` positions at slot p mod buf.
    An int8 cache (``int8_kv``) takes ``q8`` of each position's K/V with
    its scale, as a decode step writes them.  A MoE layer routes all B·S
    tokens in one call, as the reference's full-sequence forward does, so
    experts' capacities drop pairs differently from B-token decode steps:
    the cache equals ``decode_chunk``'s only where no pair is dropped
    (``capacity_factor`` ≥ E/k guarantees it).
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    cache = init_cache(cfg, b, max_len, cache_dtype, device=dev)
    buf = cache.kv.k.shape[2]
    if s > buf and not cfg.local_window:
        raise ValueError(f"prompt of {s} tokens exceeds the cache's "
                         f"{buf} positions")
    keep = torch.arange(max(0, s - buf), s, device=dev)
    slots = keep % buf
    ak = dict(_attn_kwargs(cfg), window=cfg.local_window or None)
    x = _embed_tokens(cfg, params, tokens)
    layers = split_layers(params)["layers"]
    for i, lp in enumerate(layers):
        a_out, (k, v) = attention_train(lp["attn"],
                                        _norm(cfg, lp["ln_attn"], x),
                                        causal=True, return_kv=True, **ak)
        kv_i = layer_kv(cache.kv, i)
        if kv_i.k.dtype == torch.int8:
            for (codes, scale), new in (((kv_i.k, kv_i.k_scale), k),
                                        ((kv_i.v, kv_i.v_scale), v)):
                codes[:, slots], scale[:, slots] = q8(new[:, keep])
        else:
            kv_i.k[:, slots] = k[:, keep].to(cache_dtype)
            kv_i.v[:, slots] = v[:, keep].to(cache_dtype)
        x = x + a_out
        x = x + _ffn(cfg, lp, _norm(cfg, lp["ln_mlp"], x))
    x = _norm(cfg, params["ln_f"], x[:, -1:])
    logits = unembed(params["embed"], x, cfg.vocab)[:, 0, :]
    return logits, DecodeCache(cache.kv,
                               torch.tensor(s, dtype=torch.int32, device=dev))
