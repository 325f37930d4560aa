"""Dense decoder: init, full-sequence forward, slot KV cache and decode
(port of the dense family of ``repro/models/transformer.py``).

API (plain functions of (cfg, params, ...)):
  init_params(cfg, seed, device)             -> param tree (reference keys)
  forward_train(cfg, params, batch)          -> full-sequence logits
  loss_fn(cfg, params, batch)                -> mean next-token NLL
  init_cache(cfg, batch, max_len, dtype)     -> DecodeCache
  decode_step(cfg, params, cache, token)     -> (logits, cache)
  decode_chunk(cfg, params, cache, tokens)   -> (last logits, cache)
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
from .layers import (KVCache, attention_decode, attention_train, embed,
                     layernorm, mlp, rmsnorm, unembed)

__all__ = ["init_params", "forward_train", "loss_fn", "init_cache",
           "decode_step", "decode_chunk", "cache_write_slot",
           "cache_reset_slot", "split_layers", "DecodeCache"]


def _check_family(cfg: ArchConfig):
    if cfg.family != "dense" or cfg.n_experts or cfg.block_pattern:
        raise NotImplementedError(
            f"{cfg.name}: only the dense family is ported (ROADMAP item 12)")


def _norm(cfg, p, x):
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None,
                dtype=torch.float32):
    """Random dense-decoder params on ``device`` from a ``torch.Generator``.

    Same tree and shapes as the reference's ``init_params`` (after
    ``split_tree``); the values differ by design.  Weights are normal with
    std 1/sqrt(in_features), biases 0, norm scales 1, the embedding normal
    with std 0.02.
    """
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.resolved_head_dim

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * std).to(dtype)

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
    mlp_p = {"w_out": lin(cfg.d_ff, d, cfg.out_bias)}
    if cfg.gated_mlp:
        mlp_p["w_gate"] = lin(d, cfg.d_ff, cfg.out_bias)
        mlp_p["w_up"] = lin(d, cfg.d_ff, cfg.out_bias)
    else:
        mlp_p["w_in"] = lin(d, cfg.d_ff, cfg.out_bias)
    ln_f = {"scale": torch.ones((d,), dtype=torch.float32, device=dev)}
    if cfg.norm == "layernorm":
        ln_f["bias"] = torch.zeros((d,), dtype=torch.float32, device=dev)
    return {"embed": {"w": normal((cfg.padded_vocab, d), 0.02)},
            "layers": {"ln_attn": norm(), "attn": attn, "ln_mlp": norm(),
                       "mlp": mlp_p},
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
        x = x + mlp(lp["mlp"], _norm(cfg, lp["ln_mlp"], x),
                    activation=cfg.activation)
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
    kv: Any                   # KVCache, each (L, B, buf, n_kv, hd)
    pos: torch.Tensor         # int32: 0-d (lockstep) or (B,) per slot
    extras: Any = ()


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, per_slot: bool = False,
               device=None) -> DecodeCache:
    """Fresh decode cache; ``per_slot=True`` makes ``pos`` a (batch,)
    vector, one position counter per serving slot."""
    _check_family(cfg)
    dev = resolve_device(device)
    buf = min(max_len, cfg.local_window) if cfg.local_window else max_len
    shape = (cfg.n_layers, batch, buf, cfg.n_kv, cfg.resolved_head_dim)
    kv = KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                 v=torch.zeros(shape, dtype=dtype, device=dev))
    pos = torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                      device=dev)
    return DecodeCache(kv, pos)


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
    for big, small in zip(cache.kv, sub.kv):
        big[:, i:i + 1] = small.to(big.dtype)
    sub_pos = sub.pos if sub.pos.ndim == 0 else sub.pos[0]
    cache.pos[i] = sub_pos.to(torch.int32)
    return cache


def cache_reset_slot(cache: DecodeCache, slot) -> DecodeCache:
    """Zero row ``slot`` of a per-slot cache and its position (in place)."""
    if cache.pos.ndim != 1:
        raise ValueError("cache_reset_slot needs a per-slot cache")
    i = _slot_index(slot, cache.pos.shape[0])
    for big in cache.kv:
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
            lp["attn"], a_in, KVCache(cache.kv.k[i], cache.kv.v[i]), pos,
            **ak)
        x = x + a_out
        x = x + mlp(lp["mlp"], _norm(cfg, lp["ln_mlp"], x),
                    activation=cfg.activation)
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
