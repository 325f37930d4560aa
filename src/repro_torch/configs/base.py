"""Architecture config schema, shape grid and input specs (port of
``repro/configs/base.py``).

One ``ArchConfig`` per architecture; ``reduced()`` derives the CPU smoke
variant (same family and topology, tiny dims).

The four input shapes of the dry-run grid (the reference's):
    train_4k     seq 4096,   global_batch 256   (training)
    prefill_32k  seq 32768,  global_batch 32    (inference prefill)
    decode_32k   seq 32768,  global_batch 128   (decode: 1 new token, 32k KV)
    long_500k    seq 524288, global_batch 1     (long-context decode)

``long_500k`` runs only on ``subquadratic`` archs (rwkv6,
recurrentgemma).  :func:`input_specs` returns tensors on the ``meta``
device, the port's stand-ins for ``jax.ShapeDtypeStruct``: shape and
dtype, no storage.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "REGISTRY", "register",
           "get_config", "list_archs", "runnable_cells", "input_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 → d_model // n_heads
    qkv_bias: bool = False
    out_bias: bool = False
    activation: str = "silu"
    gated_mlp: bool = True
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    embed_scale: bool = False    # gemma-style sqrt(d) embedding scaling
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # hybrid (RG-LRU) / local attention
    block_pattern: Tuple[str, ...] = ()
    local_window: int = 0                 # 0 = global attention
    lru_width: int = 0
    conv_width: int = 4
    # rwkv6
    wkv_head_dim: int = 64
    decay_lora: int = 64
    # enc-dec / vlm
    enc_layers: int = 0
    enc_seq: int = 0
    prefix_tokens: int = 0
    frontend: str = ""
    subquadratic: bool = False
    lr_schedule: str = "cosine"
    source: str = ""
    microbatch: int = 0
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 256 (logits are sliced
        back to the true vocab)."""
        return ((self.vocab + 255) // 256) * 256

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), the
        reference's formula."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        attn = d * hd * self.n_heads * 2 + d * hd * self.n_kv * 2
        if self.family == "ssm":
            per_layer = d * d * 5 + d * self.decay_lora * 2 \
                + (d * ff + ff * d + d * d)
        else:
            if self.n_experts:
                mlp_p = self.n_experts * (2 * d * ff + ff * d) \
                    + d * self.n_experts
            else:
                mlp_p = (2 * d * ff + ff * d) if self.gated_mlp \
                    else (d * ff + ff * d)
            per_layer = attn + mlp_p
            if self.block_pattern:
                # hybrid: recurrent blocks replace attention with the LRU
                lw = self.lru_width or d
                rec = 2 * d * lw + lw * d + 2 * lw * lw // 8 + lw * 4
                n_attn = sum(1 for b in self._layer_types() if b == "attn")
                n_rec = self.n_layers - n_attn
                return v * d + n_attn * attn + n_rec * rec \
                    + self.n_layers * mlp_p
        total = v * d + self.n_layers * per_layer
        if self.enc_layers:
            total += self.enc_layers * (attn + 2 * d * ff)
        return total

    def active_param_count(self) -> int:
        """Parameters a token passes through (MoE: top-k of the experts):
        the basis of the 6·N·D and 2·N·D model FLOPs."""
        if not self.n_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        return self.param_count() \
            - self.n_layers * self.n_experts * (2 * d * ff + ff * d) \
            + self.n_layers * self.top_k * (2 * d * ff + ff * d)

    def _layer_types(self) -> Tuple[str, ...]:
        """Each layer's block kind in order: ``attn`` for every layer of a
        config without a block pattern, else the pattern repeated."""
        if not self.block_pattern:
            return ("attn",) * self.n_layers
        reps = self.n_layers // len(self.block_pattern) + 1
        return (self.block_pattern * reps)[: self.n_layers]

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (the reference's
        exact reduction, so both packages build the same shapes)."""
        changes = dict(
            n_layers=min(self.n_layers, 2 if not self.block_pattern else 3),
            d_model=64,
            n_heads=max(2, min(self.n_heads, 4)),
            n_kv=1 if self.n_kv == 1 else 2,
            d_ff=128,
            vocab=256,
            head_dim=16,
            lru_width=64 if self.lru_width else 0,
            wkv_head_dim=16,
            decay_lora=8,
            enc_layers=min(self.enc_layers, 2),
            enc_seq=min(self.enc_seq, 8) if self.enc_seq else 0,
            prefix_tokens=min(self.prefix_tokens, 4),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            name=self.name + "-smoke",
        )
        if self.block_pattern:
            changes["n_layers"] = len(self.block_pattern)
        return dataclasses.replace(self, **changes)


REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from . import _load_all  # lazy: populate registry
    _load_all()
    return REGISTRY[name]


def list_archs():
    from . import _load_all
    _load_all()
    return sorted(REGISTRY)


def runnable_cells():
    """All (arch, shape, skip reason) cells; the reason is empty for the
    cells that run."""
    cells = []
    for name in list_archs():
        cfg = REGISTRY[name]
        for sname in SHAPES:
            skip = ""
            if sname == "long_500k" and not cfg.subquadratic:
                skip = "full-attention arch: 500k dense-KV decode out of scope"
            cells.append((name, sname, skip))
    return cells


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shape and dtype, no storage)
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape: ShapeSpec
                ) -> Dict[str, torch.Tensor]:
    """Abstract model inputs for (cfg, shape), on the ``meta`` device.

    train:   token/target batch (+ stub frontend embeddings where the
             family has them)
    prefill: token batch (+ frames / patches)
    decode:  a single-token batch (the cache comes from the model).
    """
    b, s = shape.global_batch, shape.seq_len

    def sds(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    i32, emb = torch.int32, torch.bfloat16
    if cfg.family == "encdec":
        enc = sds((b, cfg.enc_seq, cfg.d_model), emb)   # stub conv frontend
        if shape.kind == "train":
            return {"frames": enc, "tokens": sds((b, s), i32),
                    "targets": sds((b, s), i32)}
        if shape.kind == "prefill":
            return {"frames": enc, "tokens": sds((b, s), i32)}
        return {"token": sds((b, 1), i32)}
    if cfg.family == "vlm":
        pre = sds((b, cfg.prefix_tokens, cfg.d_model), emb)  # stub SigLIP
        text = max(s - cfg.prefix_tokens, 1)
        if shape.kind == "train":
            return {"patches": pre, "tokens": sds((b, text), i32),
                    "targets": sds((b, text), i32)}
        if shape.kind == "prefill":
            return {"patches": pre, "tokens": sds((b, text), i32)}
        return {"token": sds((b, 1), i32)}
    if shape.kind == "train":
        return {"tokens": sds((b, s), i32), "targets": sds((b, s), i32)}
    if shape.kind == "prefill":
        return {"tokens": sds((b, s), i32)}
    return {"token": sds((b, 1), i32)}
