"""Deterministic, shardable, resumable synthetic token pipeline (port of
``repro/data/pipeline.py``).

The reference module is numpy at heart (its ``jax`` imports are unused),
so this copy draws the same rows from the same ``np.random.default_rng``
seeds: for the same ``DataConfig``, step and host, its batches are byte
for byte the reference's (tests/test_torch_data.py).

Properties needed at 1000-node scale (DESIGN.md §6):
  * stateless addressing: batch `i` for host `h` is a pure function of
    (seed, step, host) — exact skip-ahead on restart, no iterator state to
    checkpoint,
  * per-host disjoint shards: hosts draw disjoint slices of the global batch,
  * elastic: changing host count re-partitions the same global stream.

The synthetic stream is a Zipf-ish Markov token source — enough structure
for a small LM to learn (used by the end-to-end PTQ example: train → calib →
quantize → eval), while staying fully offline.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "global_batch_for_step",
           "host_batch_for_step"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1


class SyntheticLM:
    """Order-1 Markov chain with Zipf marginals and deterministic seeding.

    Each (step, row) sequence is generated from fold_in(seed, step, row) —
    addressable, so any host can compute any row (the basis of elastic
    resharding and skip-ahead).
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        # sparse-ish random transition structure with Zipf stationary bias
        zipf = 1.0 / np.arange(1, v + 1) ** 1.1
        zipf /= zipf.sum()
        self._stationary = zipf
        self._shift = rng.integers(1, v, size=16)  # cheap mixing offsets

    def _row(self, step: int, row: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + row)
        v = cfg.vocab
        out = np.empty(cfg.seq_len + 1, dtype=np.int32)
        out[0] = rng.choice(v, p=self._stationary)
        shifts = self._shift
        u = rng.random(cfg.seq_len)
        jump = rng.random(cfg.seq_len) < 0.15
        fresh = rng.choice(v, size=cfg.seq_len, p=self._stationary)
        for t in range(cfg.seq_len):
            if jump[t]:
                out[t + 1] = fresh[t]
            else:  # deterministic-ish successor: structure to learn
                s = shifts[int(u[t] * 16) % 16]
                out[t + 1] = (out[t] + s) % v
        return out

    def batch(self, step: int, rows: range) -> Dict[str, np.ndarray]:
        seqs = np.stack([self._row(step, r) for r in rows])
        return {"tokens": seqs[:, :-1], "targets": seqs[:, 1:]}


def global_batch_for_step(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    return SyntheticLM(cfg).batch(step, range(cfg.global_batch))


def host_batch_for_step(cfg: DataConfig, step: int, host: int
                        ) -> Dict[str, np.ndarray]:
    """Disjoint per-host slice of the global batch (elastic re-partition)."""
    per = cfg.global_batch // cfg.n_hosts
    lo = host * per
    return SyntheticLM(cfg).batch(step, range(lo, lo + per))
