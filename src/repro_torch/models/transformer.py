"""Models of every family of ``repro/models/transformer.py``: the dense,
MoE, ssm (RWKV6), hybrid (RG-LRU + local attention), encoder–decoder
(whisper: a non-causal encoder over stub frame embeddings, a causal
decoder with cross attention) and prefix-LM (paligemma: stub patch
embeddings before the text, the dense decoder under the prefix-LM mask)
families: init, full-sequence forward, decode caches, decode and prefill
(a MoE layer runs ``layers.moe`` where a dense one runs ``layers.mlp``).

API (plain functions of (cfg, params, ...)):
  init_params(cfg, seed, device)             -> param tree (reference keys)
  init_layer_params / init_shared_params     -> one dense layer's tree / the
                                                non-layer leaves, drawn alone
  forward_train(cfg, params, batch)          -> full-sequence logits
  loss_fn(cfg, params, batch)                -> mean next-token NLL
  init_cache(cfg, batch, max_len, dtype)     -> DecodeCache
  decode_step(cfg, params, cache, token)     -> (logits, cache)
  decode_chunk(cfg, params, cache, tokens)   -> (last logits, cache)
  prefill(cfg, params, batch, max_len)       -> (last logits, cache)
  encode / capture_cross_kv                  -> encoder states, cross K/V
  cache_write_slot / cache_reset_slot        -> slot graft / eviction
  split_layers(params)                       -> params with per-layer views
  fsdp_tp_layout / fsdp_tp_blocks / fsdp_tp_gather
                                             -> FSDP × TP params on a mesh

The reference's ``jax.lax.scan`` over layers is a Python loop over the
first axis of the stacked leaves (``layers``; the hybrid's ``groups`` of
one block pattern each, followed by its unstacked ``tail`` list; the
encoder–decoder's ``enc_layers`` and ``dec_layers``).
The decode functions take either the stacked tree or one that
:func:`split_layers` already cut into per-layer views; a caller that steps
many times (the engines) splits once.  Every cache leaf (K/V buffers,
int8 scales, RWKV shift and WKV states, RG-LRU h and conv states, the
encoder–decoder's cross K/V ``extras``) carries the layer on axis 0 and
the batch on axis 1, and is updated IN PLACE: the returned cache shares
its tensors with the input cache and carries a new position tensor.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import (NamedSharding, current_layout,
                                       default_rules, fsdp_gather,
                                       reduce_out, spec_for_axes)
from repro_torch.opts import enabled as _opt
from repro_torch.tree import tree_leaves, tree_map
from . import rglru as rg
from . import rwkv6 as rk
from .layers import (KVCache, _split_heads, attention_decode,
                     attention_train, cross_attention_decode, dense, embed,
                     layernorm, mlp, moe, q8, rmsnorm, sinusoidal_positions,
                     unembed)

__all__ = ["init_params", "init_layer_params", "init_shared_params",
           "forward_train", "loss_fn", "init_cache",
           "decode_step", "decode_chunk", "prefill", "cache_write_slot",
           "cache_reset_slot", "cache_rows", "layer_kv", "split_layers",
           "decode_layers", "prefill_layers", "encode", "capture_cross_kv",
           "DecodeCache", "param_axes", "param_specs_tree", "expert_specs",
           "FsdpTpLayout", "fsdp_tp_layout", "fsdp_tp_blocks",
           "fsdp_tp_gather"]

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
#: the stacked layer trees of a param tree
_STACKS = ("layers", "groups", "enc_layers", "dec_layers")


def _check_family(cfg: ArchConfig):
    if cfg.family not in _FAMILIES \
            or (cfg.family == "moe") != bool(cfg.n_experts) \
            or (cfg.family == "hybrid") != bool(cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not a family of the "
            f"reference (one of {', '.join(_FAMILIES)}; MoE exactly when "
            "n_experts is set, hybrid exactly when block_pattern is)")


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
    """Random params on ``device`` from a ``torch.Generator`` (on the
    ``meta`` device: the same tree of shapes, no values).

    Same tree and shapes as the reference's ``init_params`` (after
    ``split_tree``); the values differ by design.  Weights are normal with
    std 1/sqrt(in_features), biases 0, norm scales 1, the embedding normal
    with std 0.02.  A MoE layer holds ``moe = {router: {w: (L, d, E)},
    w_gate, w_up: (L, E, d, ff), w_out: (L, E, ff, d)}`` (``w_in`` in
    place of the gate and up weights when the MLP is not gated) where a
    dense one holds ``mlp``.  The ssm family stacks ``ln_tm``, ``ln_cm``
    and the RWKV6 ``tm``/``cm`` blocks (``rwkv6.rwkv6_init``) over its
    layers; the hybrid family stacks one block pattern per group under
    ``groups.b{i}`` (``ln_t``, ``ln_mlp``, ``mlp`` and ``attn`` or
    ``rec``) and keeps the ``n_layers mod len(pattern)`` last layers
    unstacked in the ``tail`` list.  The prefix-LM family (vlm) holds
    the dense tree.  The encoder–decoder family holds ``enc_layers``
    (``ln_attn``, ``attn``, ``ln_mlp``, ``mlp``) and ``enc_ln_f``,
    ``dec_layers`` (``ln_self``, ``self_attn``, ``ln_cross``,
    ``cross_attn``, ``ln_mlp``, ``mlp``), ``dec_pos`` (4096, d) normal with
    std 0.01 and ``ln_f``; all its attention and MLP denses carry biases
    and its MLPs are not gated, whatever the config says (the
    reference's).
    """
    _check_family(cfg)
    dev = resolve_device(device)
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.resolved_head_dim
    if dev.type == "meta":
        def normal(shape, std):
            return torch.empty(shape, dtype=dtype, device=dev)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def normal(shape, std):
            # scaled in place: a full-width expert stack is 13 GB of f32
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float32).mul_(std).to(dtype)

    def lin(n_in, n_out, bias, lead=(L,)):
        p = {"w": normal(lead + (n_in, n_out), n_in ** -0.5)}
        if bias:
            p["b"] = torch.zeros(lead + (n_out,), dtype=dtype, device=dev)
        return p

    def norm(lead=(L,)):
        p = {"scale": torch.ones(lead + (d,), dtype=torch.float32,
                                 device=dev)}
        if cfg.norm == "layernorm":
            p["bias"] = torch.zeros(lead + (d,), dtype=torch.float32,
                                    device=dev)
        return p

    def attn(lead=(L,), qkv_bias=cfg.qkv_bias, out_bias=cfg.out_bias):
        return {"wq": lin(d, cfg.n_heads * hd, qkv_bias, lead),
                "wk": lin(d, cfg.n_kv * hd, qkv_bias, lead),
                "wv": lin(d, cfg.n_kv * hd, qkv_bias, lead),
                "wo": lin(cfg.n_heads * hd, d, out_bias, lead)}

    def mlp_p(lead=(L,), bias=cfg.out_bias, gated=cfg.gated_mlp):
        p = {"w_out": lin(cfg.d_ff, d, bias, lead)}
        if gated:
            p["w_gate"] = lin(d, cfg.d_ff, bias, lead)
            p["w_up"] = lin(d, cfg.d_ff, bias, lead)
        else:
            p["w_in"] = lin(d, cfg.d_ff, bias, lead)
        return p

    params = {"embed": {"w": normal((cfg.padded_vocab, d), 0.02)}}
    if cfg.family == "ssm":
        params["layers"] = {
            "ln_tm": norm(), "ln_cm": norm(),
            **rk.rwkv6_init(normal, d, cfg.d_ff, head_dim=cfg.wkv_head_dim,
                            decay_lora=cfg.decay_lora, dtype=dtype, stack=L,
                            device=dev)}
    elif cfg.family == "hybrid":
        pat = cfg.block_pattern
        n_groups = L // len(pat)
        lru = cfg.lru_width or d

        def block(kind, lead):
            sub = {"ln_t": norm(lead), "ln_mlp": norm(lead),
                   "mlp": mlp_p(lead, bias=False)}
            if kind == "attn":
                sub["attn"] = attn(lead, qkv_bias=False, out_bias=False)
            else:
                sub["rec"] = rg.rglru_init(
                    normal, d, lru, conv_width=cfg.conv_width, dtype=dtype,
                    stack=lead[0] if lead else None, device=dev)
            return sub

        params["groups"] = {f"b{i}": block(kind, (n_groups,))
                            for i, kind in enumerate(pat)}
        params["tail"] = [block(pat[k], ())
                          for k in range(L - n_groups * len(pat))]
    elif cfg.n_experts:
        E, ff = cfg.n_experts, cfg.d_ff
        ffn = {"router": lin(d, E, False),
               "w_out": normal((L, E, ff, d), ff ** -0.5)}
        for key in (("w_gate", "w_up") if cfg.gated_mlp else ("w_in",)):
            ffn[key] = normal((L, E, d, ff), d ** -0.5)
        params["layers"] = {"ln_attn": norm(), "attn": attn(),
                            "ln_mlp": norm(), "moe": ffn}
    elif cfg.family == "encdec":
        enc = (cfg.enc_layers,)
        params["enc_layers"] = {
            "ln_attn": norm(enc), "attn": attn(enc, True, True),
            "ln_mlp": norm(enc), "mlp": mlp_p(enc, True, False)}
        params["enc_ln_f"] = norm(())
        params["dec_layers"] = {
            "ln_self": norm(), "self_attn": attn(qkv_bias=True,
                                                 out_bias=True),
            "ln_cross": norm(), "cross_attn": attn(qkv_bias=True,
                                                   out_bias=True),
            "ln_mlp": norm(), "mlp": mlp_p(bias=True, gated=False)}
        params["dec_pos"] = normal((4096, d), 0.01)
    else:
        params["layers"] = {"ln_attn": norm(), "attn": attn(),
                            "ln_mlp": norm(), "mlp": mlp_p()}
    params["ln_f"] = norm(())
    return params


def _seeded(dev, *key) -> torch.Generator:
    """A generator on ``dev`` seeded from the integers ``key`` (mixed by
    numpy's ``SeedSequence``: distinct keys give unrelated streams)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(np.random.SeedSequence(list(key))
                        .generate_state(1, np.uint64)[0]))
    return gen


def _draw_like(meta, gen, dev, std_of):
    """Values for a tree of ``meta`` tensors, drawn in the tree's order:
    each ``w`` normal with std ``std_of(w's shape)``, norm ``scale`` 1,
    biases 0 (``init_params``' rules)."""
    def draw(node, name):
        if isinstance(node, dict):
            return {k: draw(v, k) for k, v in node.items()}
        if name == "w":
            return torch.randn(node.shape, generator=gen, device=dev,
                               dtype=node.dtype).mul_(std_of(node.shape))
        fill = torch.ones if name == "scale" else torch.zeros
        return fill(node.shape, dtype=node.dtype, device=dev)
    return draw(meta, None)


def _dense_only(cfg: ArchConfig, what: str):
    _check_family(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(f"{what}: {cfg.name} is of the "
                                  f"{cfg.family} family; only dense layers "
                                  "are drawn one at a time")


def init_layer_params(cfg: ArchConfig, seed: int, layer: int, *,
                      device=None):
    """Layer ``layer`` of a dense config on its own: the tree of
    ``split_layers(init_params(cfg, device="meta"))["layers"][layer]``
    (``ln_attn``, ``attn`` with its biases, ``ln_mlp``, ``mlp`` gated or
    not), drawn by the rules of :func:`init_params` from a generator
    seeded from ``(seed, layer)``.  A model built layer by layer (the
    int4 serving tree of a config whose f32 tree does not fit the card,
    ``quant.quantize_params_by_layer``) holds one layer's f32 weights at
    a time; the values are not :func:`init_params`' (another stream)."""
    _dense_only(cfg, "init_layer_params")
    if not 0 <= layer < cfg.n_layers:
        raise IndexError(f"layer {layer} of {cfg.name}'s {cfg.n_layers}")
    dev = resolve_device(device)
    meta = split_layers(init_params(cfg, device="meta"))["layers"][layer]
    return _draw_like(meta, _seeded(dev, seed, 1, layer), dev,
                      lambda shape: shape[-2] ** -0.5)


def init_shared_params(cfg: ArchConfig, seed: int = 0, *, device=None):
    """The leaves of a dense config outside its layers (``embed``, normal
    with std 0.02, and ``ln_f``), drawn from a generator of their own
    (seeded from ``(seed, 0)``); with :func:`init_layer_params` they make
    up the whole tree."""
    _dense_only(cfg, "init_shared_params")
    dev = resolve_device(device)
    meta = {k: v for k, v in init_params(cfg, device="meta").items()
            if k != "layers"}
    return _draw_like(meta, _seeded(dev, seed, 0), dev, lambda _: 0.02)


def param_axes(cfg: ArchConfig):
    """The logical axes of every leaf of :func:`init_params`'s tree: the
    same tree, each leaf a tuple with one name (or None) per dim, as the
    reference's init attaches them to its ``Px`` leaves."""
    _check_family(cfg)
    L = ("layers",)

    def lin(a_in, a_out, bias, lead=L):
        p = {"w": lead + (a_in, a_out)}
        if bias:
            p["b"] = lead + (a_out,)
        return p

    def norm(lead=L):
        p = {"scale": lead + (None,)}
        if cfg.norm == "layernorm":
            p["bias"] = lead + (None,)
        return p

    def attn(lead=L, qkv_bias=cfg.qkv_bias, out_bias=cfg.out_bias):
        return {"wq": lin("d_model_w", "heads", qkv_bias, lead),
                "wk": lin("d_model_w", "kv_heads", qkv_bias, lead),
                "wv": lin("d_model_w", "kv_heads", qkv_bias, lead),
                "wo": lin("heads", "d_model_w", out_bias, lead)}

    def mlp_p(lead=L, bias=cfg.out_bias, gated=cfg.gated_mlp):
        p = {"w_out": lin("ff", "d_model_w", bias, lead)}
        for key in (("w_gate", "w_up") if gated else ("w_in",)):
            p[key] = lin("d_model_w", "ff", bias, lead)
        return p

    axes = {"embed": {"w": ("vocab", "d_model_w")}}
    if cfg.family == "ssm":
        axes["layers"] = {"ln_tm": norm(), "ln_cm": norm(), **rk.rwkv6_axes()}
    elif cfg.family == "hybrid":
        pat = cfg.block_pattern
        n_groups = cfg.n_layers // len(pat)

        def block(kind, lead):
            sub = {"ln_t": norm(lead), "ln_mlp": norm(lead),
                   "mlp": mlp_p(lead, bias=False)}
            if kind == "attn":
                sub["attn"] = attn(lead, qkv_bias=False, out_bias=False)
            else:
                sub["rec"] = rg.rglru_axes(stacked=bool(lead))
            return sub

        axes["groups"] = {f"b{i}": block(kind, L)
                          for i, kind in enumerate(pat)}
        axes["tail"] = [block(pat[k], ())
                        for k in range(cfg.n_layers - n_groups * len(pat))]
    elif cfg.n_experts:
        ffn = {"router": lin("d_model_w", "experts", False),
               "w_out": L + ("experts", None, "d_model_w")}
        for key in (("w_gate", "w_up") if cfg.gated_mlp else ("w_in",)):
            ffn[key] = L + ("experts", "d_model_w", None)
        axes["layers"] = {"ln_attn": norm(), "attn": attn(),
                          "ln_mlp": norm(), "moe": ffn}
    elif cfg.family == "encdec":
        axes["enc_layers"] = {"ln_attn": norm(), "attn": attn(L, True, True),
                              "ln_mlp": norm(),
                              "mlp": mlp_p(L, True, False)}
        axes["enc_ln_f"] = norm(())
        axes["dec_layers"] = {
            "ln_self": norm(), "self_attn": attn(L, True, True),
            "ln_cross": norm(), "cross_attn": attn(L, True, True),
            "ln_mlp": norm(), "mlp": mlp_p(L, True, False)}
        axes["dec_pos"] = (None, None)
    else:
        axes["layers"] = {"ln_attn": norm(), "attn": attn(),
                          "ln_mlp": norm(), "mlp": mlp_p()}
    axes["ln_f"] = norm(())
    return axes


def param_specs_tree(cfg: ArchConfig, rules=None):
    """The mesh spec of every leaf of :func:`init_params`'s tree (the
    reference's ``param_specs_tree(px)[1]``, each ``PartitionSpec`` a
    tuple): ``dist.sharding.spec_for_axes`` of :func:`param_axes`, under
    ``rules`` (default: the active mesh's, multi-pod iff it has a ``pod``
    axis).  The argument is the config, not the params: a tensor carries
    no axes.  The leaves are tuples, so walk the tree alongside the params
    (``tree.tree_map(fn, params, specs)``)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return spec_for_axes(node, rules)
    return walk(param_axes(cfg))


def expert_specs(cfg: ArchConfig, rules=None):
    """The expert-parallel cut of a MoE tree: each stacked expert leaf
    (``moe`` but not its router) keeps the ``model`` entry of its
    :func:`param_specs_tree` spec, so each rank holds E/model whole
    experts; every other leaf gets None (replicated)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        if "moe" in path and "router" not in path:
            return tuple(e if e == "model" else None for e in node)
        return None
    return walk(param_specs_tree(cfg, rules), ())


# ---------------------------------------------------------------------------
# FSDP × TP layout (the sharded train step; reference: the params'
# NamedShardings in ``launch/dryrun._lower_train``)
# ---------------------------------------------------------------------------

_ATTN_BLOCKS = ("attn", "self_attn", "cross_attn")
_FF_IN = ("w_gate", "w_up", "w_in")


@dataclasses.dataclass(eq=False)
class FsdpTpLayout:
    """How one model's params lie on ``mesh`` under FSDP × TP
    (:func:`fsdp_tp_layout`).

    ``specs`` holds each leaf's spec (``param_specs_tree`` under the
    mesh's rules: ``d_model_w`` over the data axes ``dp``; heads,
    ``kv_heads``, ``ff``, ``vocab``, ``experts`` and ``state`` over
    ``model``), of the PADDED leaf: a head count that does not divide
    ``model`` is padded with whole zero heads (``q_index`` / ``kv_index``
    map each padded head to its source head, -1 for a zero head whose
    wq/wk/wv columns and wo rows are zero: an exact no-op, whose grads
    stay zero), an MLP's ``d_ff`` with zero columns to ``ff``.  With fewer
    kv heads than ``model`` ranks (a divisor of it) the kv heads are whole
    on every rank instead (``kv_rep`` ranks per kv head; their specs
    replicate ``kv_heads``) and each kv head's q heads are padded to a
    multiple of ``kv_rep``.  The experts, the RWKV6 heads, its
    channel-mix ``d_ff`` and the RG-LRU width are not padded: they must
    divide ``model``.  The RG-LRU's ``w_in`` (d, 2·lru) has its columns
    reordered so that each rank's block is [its x channels | its y
    channels] (``rglru_train`` splits the product in two halves)."""

    mesh: Any
    dp: Tuple[str, ...]
    q_index: Tuple[int, ...]
    kv_index: Tuple[int, ...]
    kv_rep: int
    ff: int
    specs: Any

    @property
    def tp(self) -> int:
        return self.mesh.shape.get("model", 1)

    @property
    def q_loc(self) -> int:
        """q heads on one rank."""
        return len(self.q_index) // self.tp

    @property
    def kv_loc(self) -> int:
        """kv heads one rank attends with."""
        return 1 if self.kv_rep else len(self.kv_index) // self.tp

    def kv_pick(self) -> int:
        """With replicated kv heads: the kv head of this rank's q heads."""
        return self.mesh.axis_index("model") // self.kv_rep


def _spec_walk(axes, fn, path=()):
    if isinstance(axes, dict):
        return {k: _spec_walk(v, fn, path + (k,)) for k, v in axes.items()}
    if isinstance(axes, list):
        return [_spec_walk(v, fn, path) for v in axes]
    return fn(path, axes)


def _check_model_cut(cfg: ArchConfig, m: int):
    """``ValueError`` naming each dim that the layout cuts over ``model``
    without padding and that does not divide it."""
    dims = {}
    if cfg.family == "moe":
        dims["n_experts"] = cfg.n_experts
    elif cfg.family == "ssm":
        dims["the RWKV head count"] = cfg.d_model // cfg.wkv_head_dim
        dims["the channel-mix d_ff"] = cfg.d_ff
    elif cfg.family == "hybrid":
        dims["lru_width"] = cfg.lru_width or cfg.d_model
    bad = [f"{k} {v}" for k, v in dims.items() if v % m]
    if bad:
        raise ValueError(f"{cfg.name}: {', '.join(bad)} not divisible by "
                         f"the {m} ranks of the model axis")


def fsdp_tp_layout(cfg: ArchConfig, mesh) -> FsdpTpLayout:
    """The FSDP × TP layout of ``cfg`` on ``mesh`` (a ``HostMesh`` or a
    ``ShapeMesh`` with ``data`` (and ``pod``) and ``model`` axes), for
    every family of the registry."""
    _check_family(cfg)
    m = mesh.shape.get("model", 1)
    _check_model_cut(cfg, m)
    nq, nkv = cfg.n_heads, cfg.n_kv
    g = nq // nkv
    if nkv >= m or m % nkv:
        kv_pad = -(-nkv // m) * m
        kv_index = tuple(range(nkv)) + (-1,) * (kv_pad - nkv)
        q_index = tuple(i if i < nq else -1 for i in range(kv_pad * g))
        rep = 0
    else:
        rep = m // nkv
        g_pad = -(-g // rep) * rep
        kv_index = tuple(range(nkv))
        q_index = tuple(j * g + i if i < g else -1
                        for j in range(nkv) for i in range(g_pad))
    rules = default_rules("pod" in mesh.axis_names)

    def spec(path, axes):
        if rep and len(path) >= 2 and path[-2] in ("wk", "wv"):
            axes = tuple(None if a == "kv_heads" else a for a in axes)
        return spec_for_axes(axes, rules)

    return FsdpTpLayout(
        mesh=mesh, dp=tuple(a for a in ("pod", "data")
                            if a in mesh.axis_names),
        q_index=q_index, kv_index=kv_index, kv_rep=rep,
        ff=-(-cfg.d_ff // m) * m,
        specs=_spec_walk(param_axes(cfg), spec))


def _take_units(t, dim: int, index: Sequence[int], unit: int):
    """``t`` rebuilt along ``dim`` from ``unit``-wide blocks: block i of
    the result is source block ``index[i]``, zeros where it is -1 (runs
    of consecutive blocks are copied at once); ``t`` itself when ``index``
    is the identity."""
    n = t.shape[dim] // unit
    if tuple(index) == tuple(range(n)):
        return t
    parts, i = [], 0
    while i < len(index):
        j = i + 1
        if index[i] < 0:
            while j < len(index) and index[j] < 0:
                j += 1
            shape = list(t.shape)
            shape[dim] = (j - i) * unit
            parts.append(t.new_zeros(shape))
        else:
            while j < len(index) and index[j] == index[j - 1] + 1:
                j += 1
            parts.append(t.narrow(dim, index[i] * unit, (j - i) * unit))
        i = j
    return torch.cat(parts, dim)


def _leaf_index(cfg, lay: FsdpTpLayout, path, *, inverse: bool):
    """(dim, index, unit) of the padding or reorder of the leaf at
    ``path``, or None: q heads on wq's columns and wo's rows, kv heads on
    wk/wv's (sharded kv), ff on the MLP's, the RG-LRU's x and y channel
    blocks on ``w_in``'s columns.  ``inverse`` maps back to the source
    order."""
    hd = cfg.resolved_head_dim
    if len(path) < 3:
        return None
    block, name, leaf = path[-3], path[-2], path[-1]
    dim = -1
    if block in _ATTN_BLOCKS and name in ("wq", "wo"):
        index, unit = lay.q_index, hd
        if name == "wo":
            if leaf != "w":
                return None
            dim = -2
    elif block in _ATTN_BLOCKS and name in ("wk", "wv") and not lay.kv_rep:
        index, unit = lay.kv_index, hd
    elif block == "rec" and name == "w_in":
        m = lay.tp
        index = tuple(j for r in range(m) for j in (r, m + r))
        unit = (cfg.lru_width or cfg.d_model) // m
    elif block == "mlp" and (name in _FF_IN or name == "w_out"):
        index = tuple(range(cfg.d_ff)) + (-1,) * (lay.ff - cfg.d_ff)
        unit = 1
        if name == "w_out":
            if leaf != "w":
                return None
            dim = -2
    else:
        return None
    if inverse:
        index = tuple(index.index(i) for i in range(sum(1 for x in index
                                                        if x >= 0)))
    return dim, index, unit


def _repad(cfg, lay, params, *, inverse: bool):
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        how = _leaf_index(cfg, lay, path, inverse=inverse)
        if how is None:
            return node
        dim, index, unit = how
        return _take_units(node, dim, index, unit)
    return walk(params, ())


def fsdp_tp_blocks(cfg: ArchConfig, params, lay: FsdpTpLayout):
    """This rank's blocks of the whole tree ``params``: padded as ``lay``
    says, then cut by ``NamedSharding(lay.mesh, spec)`` and copied (the
    train step updates them in place)."""
    padded = _repad(cfg, lay, params, inverse=False)
    return tree_map(lambda x, spec: NamedSharding(lay.mesh, spec)
                    .block(x).clone(), padded, lay.specs)


def fsdp_tp_gather(cfg: ArchConfig, blocks, lay: FsdpTpLayout):
    """The whole tree from every rank's ``blocks`` (collectives: every
    rank calls it): each cut dim gathered over its mesh axes, then the
    padding taken off."""
    full = tree_map(lambda x, spec: NamedSharding(lay.mesh, spec).gather(x),
                    blocks, lay.specs)
    return _repad(cfg, lay, full, inverse=True)


def _gathered(lay: FsdpTpLayout, tree, specs):
    """``tree``'s blocks with each dim cut over the data axes gathered
    (``fsdp_gather``; the ``model`` cuts stay)."""
    def use(x, spec):
        for dim, entry in enumerate(spec):
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            dp = tuple(n for n in names if n in lay.dp)
            if dp:
                x = fsdp_gather(x, dp, dim, mesh=lay.mesh)
        return x
    return tree_map(use, tree, specs)


def _train_layers(cfg, params, key=None):
    """The per-layer trees the full-sequence forward walks: views of the
    stack, or under an FSDP × TP layout each layer's blocks gathered over
    the data axes when the loop reaches that layer."""
    key = key or ("dec_layers" if cfg.family == "encdec" else "layers")
    layers = _layers(cfg, params, key)
    lay = current_layout()
    if lay is None:
        return layers
    specs = _spec_walk(lay.specs[key], lambda _, s: s[1:])
    return (_gathered(lay, lp, specs) for lp in layers)


def _train_top(cfg, params):
    """``params`` with its unstacked leaves (embedding, final norms,
    position table) gathered under an FSDP × TP layout; the layer stacks
    and the hybrid's ``tail`` are gathered layer by layer."""
    lay = current_layout()
    if lay is None:
        return params
    return {**params, **{k: _gathered(lay, v, lay.specs[k])
                         for k, v in params.items()
                         if k not in _STACKS + ("tail",)}}


def _hybrid_train_layers(cfg, params):
    """(kind, layer tree) of every hybrid layer in order
    (:func:`_hybrid_layers`); under an FSDP × TP layout each layer's
    blocks, of a ``groups`` entry or of the ``tail``, gathered over the
    data axes when the loop reaches that layer."""
    layers = _hybrid_layers(cfg, params)
    lay = current_layout()
    if lay is None:
        return layers
    pat = cfg.block_pattern
    per_kind = [_spec_walk(lay.specs["groups"][f"b{i}"], lambda _, s: s[1:])
                for i in range(len(pat))]
    n_stacked = len(layers) - len(params["tail"])
    specs = [per_kind[i % len(pat)] for i in range(n_stacked)] \
        + list(lay.specs["tail"])
    return ((kind, _gathered(lay, sub, spec))
            for (kind, sub), spec in zip(layers, specs))


def _vocab_parallel_nll(logits, targets, lay: FsdpTpLayout, vocab: int):
    """Mean NLL from this rank's block of the padded vocab's logits: the
    max, the sum of exps and the target's logit, each reduced over
    ``model`` (the max without a grad); padded columns excluded."""
    mesh = lay.mesh
    n = logits.shape[-1]
    base = mesh.axis_index("model") * n
    col = torch.arange(n, device=logits.device) + base
    logits = torch.where(col < vocab, logits,
                         torch.full_like(logits, -1e30))
    top = mesh.all_reduce(logits.detach().amax(-1), "model", "max")
    shifted = logits - top[..., None]
    total = reduce_out(torch.exp(shifted).sum(-1), "model", mesh=mesh)
    local = targets.long() - base
    hit = (local >= 0) & (local < n)
    picked = torch.gather(shifted, -1, local.clamp(0, n - 1)[..., None])
    tgt = reduce_out(torch.where(hit, picked[..., 0],
                                 torch.zeros_like(picked[..., 0])),
                     "model", mesh=mesh)
    return (torch.log(total) - tgt).mean()


# ---------------------------------------------------------------------------
# layer views
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
    """``params`` with each stacked layer tree (``layers``, the hybrid's
    ``groups``, the encoder–decoder's ``enc_layers`` and ``dec_layers``)
    cut into a list of per-layer (per-group) trees of views (no copy); the
    other entries, the hybrid's ``tail`` list among them, are shared."""
    keys = [k for k in _STACKS
            if k in params and not isinstance(params[k], list)]
    if not keys:
        return params
    return {**params, **{k: _layer_params(params[k]) for k in keys}}


def _hybrid_layers(cfg, params):
    """(kind, layer tree) of every hybrid layer in order: each group's
    pattern, then the tail."""
    pat = cfg.block_pattern
    split = split_layers(params)
    out = [(kind, gp[f"b{i}"]) for gp in split["groups"]
           for i, kind in enumerate(pat)]
    out += [(pat[k], sub) for k, sub in enumerate(params["tail"])]
    if len(out) != cfg.n_layers:
        raise ValueError(f"params hold {len(out)} layers, {cfg.name} has "
                         f"{cfg.n_layers}")
    return out


def _layers(cfg, params, key=None):
    """Per-layer views of the decoder stack (the encoder–decoder's
    ``dec_layers``), or of the stack ``key``."""
    key = key or ("dec_layers" if cfg.family == "encdec" else "layers")
    layers = split_layers(params)[key]
    want = cfg.enc_layers if key == "enc_layers" else cfg.n_layers
    if len(layers) != want:
        raise ValueError(f"params hold {len(layers)} {key}, "
                         f"{cfg.name} has {want}")
    return layers


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


def _logits(cfg, params, x):
    x = _norm(cfg, params["ln_f"], x)
    return unembed(params["embed"], x, cfg.vocab)


def _dec_pos_rows(params, pos):
    """The decoder's learned position rows at ``pos`` mod 4096 (the
    reference's cyclic table): (B, 1, d) for a per-slot (B,) ``pos``,
    (1, 1, d) for a 0-d one (an index on the device: no host sync)."""
    table = params["dec_pos"]
    idx = (pos % table.shape[0]).reshape(-1).long()
    return torch.index_select(table, 0, idx)[:, None, :]


def _dec_pos_seq(params, s):
    """Rows 0..S-1 of the position table, repeated past its length."""
    table = params["dec_pos"]
    reps = -(-s // table.shape[0])
    return (table.repeat(reps, 1) if reps > 1 else table)[:s]


def encode(cfg: ArchConfig, params, frames) -> torch.Tensor:
    """The encoder–decoder's encoder (the reference's ``_encode``): frame
    embeddings (B, T, d) plus sinusoidal positions, non-causal attention
    without rope (B3 where its conditions hold), biased GELU MLPs, the
    final norm → encoder states (B, T, d)."""
    ak = _attn_kwargs(cfg)
    x = frames + sinusoidal_positions(frames.shape[1], cfg.d_model,
                                      frames.dtype, frames.device)[None]
    params = _train_top(cfg, params)
    for lp in _train_layers(cfg, params, "enc_layers"):
        x = x + attention_train(lp["attn"], _norm(cfg, lp["ln_attn"], x),
                                causal=False, use_rope=False, **ak)
        x = x + mlp(lp["mlp"], _norm(cfg, lp["ln_mlp"], x),
                    activation="gelu")
    return _norm(cfg, params["enc_ln_f"], x)


def capture_cross_kv(cfg: ArchConfig, params, enc,
                     cache_dtype=torch.bfloat16):
    """Each decoder layer's cross-attention K and V of the encoder states
    ``enc`` (B, T, d) through ``layers.dense`` (so a quantized tree runs
    its dequant kernel at m = B·T): a pair of (L, B, T, n_kv, hd) in
    ``cache_dtype``, the cache's ``extras``.  The reference's
    ``_capture_cross_kv`` multiplies the raw weight leaf and raises on a
    quantized tree (ROADMAP queue C)."""
    ks, vs = [], []
    hd = cfg.resolved_head_dim
    for lp in _layers(cfg, params):
        ca = lp["cross_attn"]
        ks.append(_split_heads(dense(ca["wk"], enc), cfg.n_kv, hd))
        vs.append(_split_heads(dense(ca["wv"], enc), cfg.n_kv, hd))
    return (torch.stack(ks).to(cache_dtype), torch.stack(vs).to(cache_dtype))


def _encdec_layer(cfg, lp, x, enc):
    """One decoder layer of the full-sequence forward: causal
    self-attention without rope, cross attention to ``enc``, GELU MLP."""
    ak = _attn_kwargs(cfg)
    x = x + attention_train(lp["self_attn"], _norm(cfg, lp["ln_self"], x),
                            causal=True, use_rope=False, **ak)
    x = x + attention_train(lp["cross_attn"], _norm(cfg, lp["ln_cross"], x),
                            kv_x=enc, use_rope=False, **ak)
    return x + mlp(lp["mlp"], _norm(cfg, lp["ln_mlp"], x), activation="gelu")


def _vlm_inputs(cfg, params, batch):
    """[patches; scaled token embeddings] (B, P + S, d): the patch
    embeddings enter unscaled, as in the reference."""
    tok = _embed_tokens(cfg, params, batch["tokens"])
    return torch.cat([batch["patches"].to(tok.dtype), tok], dim=1)


def forward_train(cfg: ArchConfig, params, batch) -> torch.Tensor:
    """Full-sequence logits (B, S, vocab) of ``batch["tokens"]`` (B, S),
    causal: every attention layer through ``attention_train``, the RWKV6
    and RG-LRU blocks through their full-sequence forwards.  The prefix-LM
    family also takes ``batch["patches"]`` (B, P, d), attends to them
    under the prefix-LM mask and returns the text positions' logits; the
    encoder–decoder family takes ``batch["frames"]`` (B, T, d), encodes
    them and decodes the tokens against the encoder states.

    Under an FSDP × TP layout (``dist.sharding.use_layout``) ``params``
    holds this rank's blocks: each layer's are gathered over the data axes
    as the loop reaches it, the layers run tensor-parallel over ``model``
    and the logits are this rank's block of the padded vocab."""
    _check_family(cfg)
    if cfg.family == "encdec":
        enc = encode(cfg, params, batch["frames"])
    params = _train_top(cfg, params)
    if cfg.family == "encdec":
        x = _embed_tokens(cfg, params, batch["tokens"])
        x = x + _dec_pos_seq(params, x.shape[1])[None].to(x.dtype)
        for lp in _train_layers(cfg, params):
            x = _encdec_layer(cfg, lp, x, enc)
        return _logits(cfg, params, x)
    if cfg.family == "vlm":
        x = _vlm_inputs(cfg, params, batch)
        for lp in _train_layers(cfg, params):
            x = x + attention_train(lp["attn"], _norm(cfg, lp["ln_attn"], x),
                                    causal=True,
                                    window=cfg.local_window or None,
                                    prefix_len=cfg.prefix_tokens,
                                    **_attn_kwargs(cfg))
            x = x + _ffn(cfg, lp, _norm(cfg, lp["ln_mlp"], x))
        return _logits(cfg, params, x)[:, cfg.prefix_tokens:, :]
    x = _embed_tokens(cfg, params, batch["tokens"])
    if cfg.family == "ssm":
        for lp in _train_layers(cfg, params):
            x = x + rk.rwkv_time_mix_train(
                lp["tm"], _norm(cfg, lp["ln_tm"], x),
                head_dim=cfg.wkv_head_dim)
            x = x + rk.rwkv_channel_mix_train(lp["cm"],
                                              _norm(cfg, lp["ln_cm"], x))
        return _logits(cfg, params, x)
    if cfg.family == "hybrid":
        for kind, sub in _hybrid_train_layers(cfg, params):
            t_in = _norm(cfg, sub["ln_t"], x)
            if kind == "attn":
                x = x + attention_train(sub["attn"], t_in, causal=True,
                                        window=cfg.local_window or None,
                                        **_attn_kwargs(cfg))
            else:
                x = x + rg.rglru_train(sub["rec"], t_in)
            x = x + mlp(sub["mlp"], _norm(cfg, sub["ln_mlp"], x),
                        activation=cfg.activation)
        return _logits(cfg, params, x)
    for lp in _train_layers(cfg, params):
        x = x + attention_train(lp["attn"], _norm(cfg, lp["ln_attn"], x),
                                causal=True,
                                window=cfg.local_window or None,
                                **_attn_kwargs(cfg))
        x = x + _ffn(cfg, lp, _norm(cfg, lp["ln_mlp"], x))
    return _logits(cfg, params, x)


def loss_fn(cfg: ArchConfig, params, batch) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``batch["targets"]``
    (under an FSDP × TP layout, from the vocab-parallel logits)."""
    logits = forward_train(cfg, params, batch).to(torch.float32)
    lay = current_layout()
    if lay is not None:
        return _vocab_parallel_nll(logits, batch["targets"], lay, cfg.vocab)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, batch["targets"][..., None].long())[..., 0]
    return -ll.mean()


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


class DecodeCache(NamedTuple):
    kv: Any                   # per-family state, layer-stacked, batch on
                              # axis 1: a KVCache (dense, MoE, vlm,
                              # encdec self attention), an RWKVState
                              # (ssm), {"kv": KVCache, "rec": RGLRUState}
                              # (hybrid)
    pos: torch.Tensor         # int32: 0-d (lockstep) or (B,) per slot
    extras: Any = ()          # encdec: (enc_k, enc_v), each (L, B, T,
                              # n_kv, hd), layer-stacked; else ()


def _kv_buf(cfg, batch, buf, dtype, n_layers, dev) -> KVCache:
    """Layer-stacked K/V buffers (n_layers, batch, buf, n_kv, hd); with
    ``REPRO_OPTS`` holding ``int8_kv`` int8 with f32 scales (the
    reference's ``_kv_buf``) and ``dtype`` not used."""
    shape = (n_layers, batch, buf, cfg.n_kv, cfg.resolved_head_dim)
    if _opt("int8_kv"):
        sshape = shape[:-1] + (1,)
        return KVCache(k=torch.zeros(shape, dtype=torch.int8, device=dev),
                       v=torch.zeros(shape, dtype=torch.int8, device=dev),
                       k_scale=torch.zeros(sshape, dtype=torch.float32,
                                           device=dev),
                       v_scale=torch.zeros(sshape, dtype=torch.float32,
                                           device=dev))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev))


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, per_slot: bool = False,
               device=None) -> DecodeCache:
    """Fresh decode cache; ``per_slot=True`` makes ``pos`` a (batch,)
    vector, one position counter per serving slot.  With ``REPRO_OPTS``
    holding ``int8_kv`` the K/V buffers are int8 with f32 scales.  The
    ssm cache is an ``RWKVState`` (shift states in ``dtype``, the WKV
    state f32); the hybrid's is ``{"kv": K/V of its attention layers,
    "rec": RGLRUState of its recurrent layers}``, the window's buffer
    ``min(max_len, local_window)`` long.  The encoder–decoder's adds
    ``extras = (enc_k, enc_v)``, zeros of (L, batch, enc_seq, n_kv, hd)
    in ``dtype`` (float under ``int8_kv`` too, as in the reference) that
    :func:`prefill` fills from the frames; the engines admit token-only
    requests, so their caches keep them zero, as the reference's do."""
    _check_family(cfg)
    dev = resolve_device(device)
    pos = torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                      device=dev)
    L, d = cfg.n_layers, cfg.d_model
    if cfg.family == "ssm":
        hd = cfg.wkv_head_dim
        st = rk.RWKVState(
            tm_shift=torch.zeros((L, batch, d), dtype=dtype, device=dev),
            cm_shift=torch.zeros((L, batch, d), dtype=dtype, device=dev),
            wkv=torch.zeros((L, batch, d // hd, hd, hd),
                            dtype=torch.float32, device=dev))
        return DecodeCache(st, pos)
    buf = min(max_len, cfg.local_window) if cfg.local_window else max_len
    if cfg.family == "hybrid":
        n_attn = sum(1 for t in cfg._layer_types() if t == "attn")
        lru = cfg.lru_width or d
        rec = rg.RGLRUState(
            h=torch.zeros((L - n_attn, batch, lru), dtype=dtype, device=dev),
            conv=torch.zeros((L - n_attn, batch, cfg.conv_width - 1, lru),
                             dtype=dtype, device=dev))
        return DecodeCache({"kv": _kv_buf(cfg, batch, buf, dtype, n_attn,
                                          dev), "rec": rec}, pos)
    if cfg.family == "encdec":
        shape = (L, batch, cfg.enc_seq, cfg.n_kv, cfg.resolved_head_dim)
        return DecodeCache(_kv_buf(cfg, batch, max_len, dtype, L, dev), pos,
                           (torch.zeros(shape, dtype=dtype, device=dev),
                            torch.zeros(shape, dtype=dtype, device=dev)))
    return DecodeCache(_kv_buf(cfg, batch, buf, dtype, L, dev), pos)


def layer_kv(kv: KVCache, i: int) -> KVCache:
    """Layer ``i``'s views of a layer-stacked KV cache (scales included)."""
    return KVCache(*(t[i] if torch.is_tensor(t) else t for t in kv))


def cache_rows(cache: DecodeCache, i: int) -> DecodeCache:
    """Batch row ``i`` of a cache (its extras too) as a batch-1 cache of
    views."""
    def row(t):
        return t[:, i:i + 1]
    return cache._replace(kv=tree_map(row, cache.kv),
                          extras=tree_map(row, cache.extras))


def _slot_index(slot, batch: int) -> int:
    # dynamic_update_slice clamps the start into range; so does this
    return min(max(int(slot), 0), batch - 1)


def cache_write_slot(cache: DecodeCache, sub: DecodeCache,
                     slot) -> DecodeCache:
    """Graft a batch-1 ``sub`` cache into row ``slot`` of a per-slot cache
    (in place): the admission primitive of the continuous engine.  Every
    state leaf, the extras included, carries the batch on axis 1."""
    if cache.pos.ndim != 1:
        raise ValueError("cache_write_slot needs a per-slot cache")
    i = _slot_index(slot, cache.pos.shape[0])
    for big, small in zip(tree_leaves((cache.kv, cache.extras)),
                          tree_leaves((sub.kv, sub.extras))):
        big[:, i:i + 1] = small.to(big.dtype)
    sub_pos = sub.pos if sub.pos.ndim == 0 else sub.pos[0]
    cache.pos[i] = sub_pos.to(torch.int32)
    return cache


def cache_reset_slot(cache: DecodeCache, slot) -> DecodeCache:
    """Zero row ``slot`` of a per-slot cache (its extras too) and its
    position (in place)."""
    if cache.pos.ndim != 1:
        raise ValueError("cache_reset_slot needs a per-slot cache")
    i = _slot_index(slot, cache.pos.shape[0])
    for big in tree_leaves((cache.kv, cache.extras)):
        big[:, i:i + 1] = 0
    cache.pos[i] = 0
    return cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _copy_state(dst, src):
    """Write a recurrent block's new state into its cache views."""
    for d_t, s_t in zip(dst, src):
        d_t.copy_(s_t)


def _rec_views(rec: rg.RGLRUState, i: int) -> rg.RGLRUState:
    return rg.RGLRUState(h=rec.h[i], conv=rec.conv[i])


def _layer_states(cfg, params, cache: DecodeCache):
    """(kind, layer params, the layer's views of the cache state) of every
    layer in order: kind ``dense`` (attention + FFN over a KV cache; the
    prefix-LM family's too), ``ssm`` (RWKV6 over an RWKVState), the
    hybrid's ``attn``/``rec`` or ``encdec`` (a decoder layer over its
    (KVCache, (cross K, cross V)))."""
    if cfg.family == "encdec":
        ek, ev = cache.extras
        return [("encdec", lp, (layer_kv(cache.kv, i), (ek[i], ev[i])))
                for i, lp in enumerate(_layers(cfg, params))]
    if cfg.family == "ssm":
        st = cache.kv
        return [("ssm", lp, rk.RWKVState(*(t[i] for t in st)))
                for i, lp in enumerate(_layers(cfg, params))]
    if cfg.family == "hybrid":
        kv, rec = cache.kv["kv"], cache.kv["rec"]
        out, a_i, r_i = [], 0, 0
        for kind, sub in _hybrid_layers(cfg, params):
            if kind == "attn":
                out.append((kind, sub, layer_kv(kv, a_i)))
                a_i += 1
            else:
                out.append((kind, sub, _rec_views(rec, r_i)))
                r_i += 1
        return out
    return [("dense", lp, layer_kv(cache.kv, i))
            for i, lp in enumerate(_layers(cfg, params))]


def _decode_layer(cfg, kind, lp, state, pos, x):
    """One layer of a decode step: x (B, 1, d) → its output; the layer's
    new state (K/V row, RWKV or RG-LRU state) is written into ``state``'s
    views in place."""
    ak = dict(_attn_kwargs(cfg), window=cfg.local_window or None)
    if kind == "ssm":
        t_out, tm_new, wkv_new = rk.rwkv_time_mix_decode(
            lp["tm"], _norm(cfg, lp["ln_tm"], x), state.tm_shift, state.wkv,
            head_dim=cfg.wkv_head_dim)
        x = x + t_out
        c_out, cm_new = rk.rwkv_channel_mix_decode(
            lp["cm"], _norm(cfg, lp["ln_cm"], x), state.cm_shift)
        _copy_state(state, (tm_new, cm_new, wkv_new))
        return x + c_out
    if kind == "encdec":
        kv, (ek, ev) = state
        ak = _attn_kwargs(cfg)
        a_out, _ = attention_decode(lp["self_attn"],
                                    _norm(cfg, lp["ln_self"], x), kv, pos,
                                    use_rope=False, **ak)
        x = x + a_out
        x = x + cross_attention_decode(
            lp["cross_attn"], _norm(cfg, lp["ln_cross"], x), ek, ev,
            n_q=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.resolved_head_dim)
        return x + mlp(lp["mlp"], _norm(cfg, lp["ln_mlp"], x),
                       activation="gelu")
    if kind == "dense":
        a_out, _ = attention_decode(lp["attn"], _norm(cfg, lp["ln_attn"], x),
                                    state, pos, **ak)
        x = x + a_out
        return x + _ffn(cfg, lp, _norm(cfg, lp["ln_mlp"], x))
    t_in = _norm(cfg, lp["ln_t"], x)
    if kind == "attn":
        h, _ = attention_decode(lp["attn"], t_in, state, pos, **ak)
    else:
        h, new = rg.rglru_decode(lp["rec"], t_in, state)
        _copy_state(state, new)
    x = x + h
    return x + mlp(lp["mlp"], _norm(cfg, lp["ln_mlp"], x),
                   activation=cfg.activation)


def decode_layers(cfg: ArchConfig, params, cache: DecodeCache):
    """The layers of one decode step at ``cache.pos``, in order, as
    callables x (B, 1, d) → the layer's output that write the layer's new
    state into ``cache`` in place.  :func:`decode_step` runs them in
    turn; a caller can also feed each one an input of its own (a
    layer-by-layer comparison of two weight trees)."""
    _check_family(cfg)
    return [functools.partial(_decode_layer, cfg, kind, lp, state, cache.pos)
            for kind, lp, state in _layer_states(cfg, params, cache)]


def decode_step(cfg: ArchConfig, params, cache: DecodeCache, token):
    """One decode step: token (B, 1) int → (logits (B, vocab), cache).
    The encoder–decoder adds the position table's row at each slot's
    ``pos`` mod 4096 to the token's embedding.  The final norm and the
    unembedding run in the span ``decode.unembed``."""
    x = _embed_tokens(cfg, params, token)
    if cfg.family == "encdec":
        x = x + _dec_pos_rows(params, cache.pos).to(x.dtype)
    for layer in decode_layers(cfg, params, cache):
        x = layer(x)
    with obs.span("decode.unembed"):
        logits = _logits(cfg, params, x)[:, 0, :]
    return logits, DecodeCache(cache.kv, cache.pos + 1, cache.extras)


def decode_chunk(cfg: ArchConfig, params, cache: DecodeCache, tokens):
    """Step the cache ``tokens.shape[1]`` tokens: (B, C) → (logits of the
    LAST token (B, vocab), cache).  Exactly C :func:`decode_step` calls
    (the reference's scan body is decode_step too)."""
    params = split_layers(params)
    logits = None
    for j in range(tokens.shape[1]):
        logits, cache = decode_step(cfg, params, cache, tokens[:, j:j + 1])
    return logits, cache


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def _write_kv(kv_i: KVCache, k, v, keep, slots, cache_dtype):
    """One layer's full-sequence post-rope K/V into its cache buffers at
    the kept positions' slots: ``q8`` codes with their scales into an
    int8 cache, else the values in ``cache_dtype``."""
    if kv_i.k.dtype == torch.int8:
        for (codes, scale), new in (((kv_i.k, kv_i.k_scale), k),
                                    ((kv_i.v, kv_i.v_scale), v)):
            codes[:, slots], scale[:, slots] = q8(new[:, keep])
    else:
        kv_i.k[:, slots] = k[:, keep].to(cache_dtype)
        kv_i.v[:, slots] = v[:, keep].to(cache_dtype)


def _prefill_layer(cfg, kind, lp, state, cache_dtype, prefix_len, x):
    """One layer of the full-sequence prefill: x (B, S, d) → its output;
    what decode steps over the S tokens would leave in the layer's state
    goes into ``state``'s views: the post-rope K/V of the last ``buf``
    positions at slot p mod buf (``q8`` with scales in an int8 cache),
    the RWKV shift states (each block's last normalized input) and final
    WKV state, the RG-LRU's final h and conv lookback.  ``prefix_len``
    opens the first positions to every query (the prefix-LM mask).  An
    encoder–decoder layer writes its self-attention K/V (no rope) and
    attends to the cross K/V already in its extras, as decode steps do."""
    ak = dict(_attn_kwargs(cfg), window=cfg.local_window or None)
    if kind == "encdec":
        kv, (ek, ev) = state
        s, buf = x.shape[1], kv.k.shape[1]
        if s > buf:
            raise ValueError(f"prompt of {s} tokens exceeds the cache's "
                             f"{buf} positions")
        keep = torch.arange(s, device=x.device)
        h, (k, v) = attention_train(lp["self_attn"],
                                    _norm(cfg, lp["ln_self"], x),
                                    causal=True, use_rope=False,
                                    return_kv=True, **_attn_kwargs(cfg))
        _write_kv(kv, k, v, keep, keep, cache_dtype)
        x = x + h
        x = x + cross_attention_decode(
            lp["cross_attn"], _norm(cfg, lp["ln_cross"], x), ek, ev,
            n_q=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.resolved_head_dim)
        return x + mlp(lp["mlp"], _norm(cfg, lp["ln_mlp"], x),
                       activation="gelu")
    if kind == "ssm":
        tm_in = _norm(cfg, lp["ln_tm"], x)
        t_out, wkv_f = rk.rwkv_time_mix_train(
            lp["tm"], tm_in, head_dim=cfg.wkv_head_dim, return_state=True)
        x = x + t_out
        cm_in = _norm(cfg, lp["ln_cm"], x)
        _copy_state(state, (tm_in[:, -1, :].to(cache_dtype),
                            cm_in[:, -1, :].to(cache_dtype), wkv_f))
        return x + rk.rwkv_channel_mix_train(lp["cm"], cm_in)
    if kind in ("dense", "attn"):
        s = x.shape[1]
        buf = state.k.shape[1]
        if s > buf and not cfg.local_window:
            raise ValueError(f"prompt of {s} tokens exceeds the cache's "
                             f"{buf} positions")
        keep = torch.arange(max(0, s - buf), s, device=x.device)
        norm_key = "ln_attn" if kind == "dense" else "ln_t"
        h, (k, v) = attention_train(lp["attn"], _norm(cfg, lp[norm_key], x),
                                    causal=True, prefix_len=prefix_len,
                                    return_kv=True, **ak)
        _write_kv(state, k, v, keep, keep % buf, cache_dtype)
        x = x + h
        if kind == "dense":
            return x + _ffn(cfg, lp, _norm(cfg, lp["ln_mlp"], x))
    else:
        h, st = rg.rglru_train(lp["rec"], _norm(cfg, lp["ln_t"], x),
                               return_state=True)
        _copy_state(state, st)
        x = x + h
    return x + mlp(lp["mlp"], _norm(cfg, lp["ln_mlp"], x),
                   activation=cfg.activation)


def prefill_layers(cfg: ArchConfig, params, cache: DecodeCache,
                   cache_dtype=torch.bfloat16, prefix_len=None):
    """The layers of the full-sequence prefill, in order, as callables
    x (B, S, d) → the layer's output that fill the layer's state in
    ``cache`` (a fresh cache of :func:`init_cache`; an encoder–decoder's
    with its extras filled) as S decode steps would; ``prefix_len`` is
    the prefix-LM family's image prefix."""
    _check_family(cfg)
    return [functools.partial(_prefill_layer, cfg, kind, lp, state,
                              cache_dtype, prefix_len)
            for kind, lp, state in _layer_states(cfg, params, cache)]


def prefill(cfg: ArchConfig, params, batch, max_len: int,
            cache_dtype=torch.bfloat16):
    """Run the whole prompt: (B, S) tokens → (logits of the LAST token
    (B, vocab), a lockstep cache at position S).

    Dense and MoE: one full-sequence pass (:func:`prefill_layers`), the
    port of the reference's ``_prefill_attn`` made exact: each layer's
    post-norm, post-rope K/V come out of the same ``attention_train``
    that computes the layer (every dense over B·S rows, flash attention
    where its conditions hold) and go into the slot cache, so the cache
    is the one ``decode_chunk`` builds over the same prompt, up to f32
    rounding (the reference's ``_capture_kv`` projects the raw embeddings
    instead; ROADMAP queue C).  A MoE layer routes all B·S tokens in one
    call, as the reference's full-sequence forward does, so experts'
    capacities drop pairs differently from B-token decode steps: the
    cache equals ``decode_chunk``'s only where no pair is dropped
    (``capacity_factor`` ≥ E/k guarantees it).

    ssm and hybrid: the reference's stepped baseline, :func:`decode_chunk`
    over the prompt, or with ``REPRO_OPTS`` holding ``parallel_prefill``
    the full-sequence pass (the reference's ``_prefill_ssm_parallel`` and
    ``_prefill_hybrid_parallel``: the WKV loop over time, the RG-LRU
    scan, the window's ring filled at slot p mod buf).  An int8 cache
    (``int8_kv``) takes ``q8`` of each kept position's K/V with its scale
    on either path; the reference's parallel hybrid path returns a float
    cache there (ROADMAP queue C).

    Encoder–decoder (``batch["frames"]`` (B, T, d) too): :func:`encode`,
    then each decoder layer's cross K/V through ``layers.dense``
    (:func:`capture_cross_kv`, the extras), then one pass over the tokens
    whose layers write their self K/V and attend to those extras: the
    cache ``capture_cross_kv`` + ``decode_chunk`` build, at position S.
    The reference's ``_capture_cross_kv`` raises on a quantized tree and
    its self K/V are ``_capture_kv``'s (ROADMAP queue C).

    Prefix-LM (``batch["patches"]`` (B, P, d), P = ``prefix_tokens``):
    one pass over [patches; tokens] under the prefix-LM mask writing the
    post-rope K/V of all P + S positions, at position P + S (a
    ``ValueError`` if they do not fit the cache); the reference's cache
    holds the S text rows only (ROADMAP queue C).
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    cache = init_cache(cfg, b, max_len, cache_dtype, device=dev)
    if cfg.family in ("ssm", "hybrid") and not _opt("parallel_prefill"):
        return decode_chunk(cfg, params, cache, tokens)
    prefix_len = None
    for key, family in (("frames", "encdec"), ("patches", "vlm")):
        if cfg.family == family and key not in batch:
            raise ValueError(f"{cfg.name}: prefill needs batch[{key!r}]")
    if cfg.family == "encdec":
        enc = encode(cfg, params, batch["frames"])
        for dst, src in zip(cache.extras,
                            capture_cross_kv(cfg, params, enc, cache_dtype)):
            dst.copy_(src)
        x = _embed_tokens(cfg, params, tokens)
        x = x + _dec_pos_seq(params, s)[None].to(x.dtype)
    elif cfg.family == "vlm":
        prefix_len = cfg.prefix_tokens
        if batch["patches"].shape[1] != prefix_len:
            raise ValueError(f"{cfg.name}: {batch['patches'].shape[1]} "
                             f"patches, the config has {prefix_len}")
        if prefix_len + s > cache.kv.k.shape[2]:
            raise ValueError(f"{prefix_len} patches and {s} tokens exceed "
                             f"the cache's {cache.kv.k.shape[2]} positions")
        x = _vlm_inputs(cfg, params, batch)
        s = prefix_len + s
    else:
        x = _embed_tokens(cfg, params, tokens)
    for layer in prefill_layers(cfg, params, cache, cache_dtype, prefix_len):
        x = layer(x)
    logits = _logits(cfg, params, x[:, -1:])[:, 0, :]
    return logits, DecodeCache(cache.kv,
                               torch.tensor(s, dtype=torch.int32, device=dev),
                               cache.extras)
