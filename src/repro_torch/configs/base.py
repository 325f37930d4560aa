"""Architecture config schema (port of ``repro/configs/base.py``).

One ``ArchConfig`` per architecture; ``reduced()`` derives the CPU smoke
variant (same family and topology, tiny dims).  The JAX-typed
``input_specs`` of the reference stays behind: the port has no abstract
shape tracing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["ArchConfig", "REGISTRY", "register", "get_config", "list_archs"]


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
