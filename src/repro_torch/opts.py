"""Beyond-baseline optimization flags (port of ``repro/opts.py``).

Optimizations are opt-in through the same ``REPRO_OPTS`` variable the
reference reads (comma-separated), so one environment drives both
packages the same way:

    REPRO_OPTS=int8_kv python -m repro_torch.launch.serve ...

Flags the port reads:
  int8_kv          — decode KV caches stored int8 with exact
                     per-(position, head) scales (``models.init_cache``,
                     ``layers.attention_decode``).
  parallel_prefill — the ssm and hybrid families prefill in one
                     full-sequence pass instead of decode steps over the
                     prompt (``models.prefill``).
  bf16_grads       — ``train.microbatch_grads`` narrows each microbatch's
                     grads to bf16 before the float32 accumulator adds
                     them (the reference narrows them ahead of the
                     cross-DP reduction; on one device it only rounds).
  moe_a2a          — under a mesh with a ``model`` axis that divides the
                     experts and the sequence, ``layers.moe`` runs
                     expert-parallel with explicit all-to-alls
                     (``layers._moe_a2a``).

The reference's other flags are sharding annotations or layout choices
of its GSPMD lowering (``kv_seq_shard``, ``moe_dispatch_shard``,
``flat_remat``, ``moe_bf16_dispatch``, ``seq_shard_train``); the port has
no GSPMD (``dist.sharding.logical_shard`` is the identity), so the parser
accepts them and nothing reads them.
"""
from __future__ import annotations

import os
from typing import FrozenSet

__all__ = ["enabled", "all_enabled"]


def all_enabled() -> FrozenSet[str]:
    raw = os.environ.get("REPRO_OPTS", "")
    return frozenset(x.strip() for x in raw.split(",") if x.strip())


def enabled(name: str) -> bool:
    return name in all_enabled()
