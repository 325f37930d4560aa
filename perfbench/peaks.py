"""The yardstick's arithmetic: the H100 SXM's published peaks, the least
time of a B1 launch (its roofline bound), and the operations a decode step
and a WaterSIC quantization need, all counted from shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
700 W power limit.  A card set below it runs slower; every result names
the card's ``power.limit`` beside these shares.
"""
from __future__ import annotations

import math

#: bf16/fp16 tensor-core operations per second
BF16_FLOPS = 989e12
#: float32 outside the tensor cores (FP64 on the tensor cores is the same)
FP32_FLOPS = 67e12
#: HBM3 bytes per second
HBM_BYTES_S = 3.35e12

#: payload bytes per (row, column) of a packed sub-byte leaf, by nbits
_PAYLOAD_BYTES = {4: 0.5, 3: 3 / 8, 2: 0.25}


def b1_bound_s(m: int, k: int, n: int, nbits: int = 4) -> float:
    """Least seconds of one packed dequant-matmul (B1): x (m, k) f32 times
    an (n, k) planar payload, out (m, n) f32.

    Operations: x·s is split into three bf16 terms, each multiplied by the
    codes (exact in bf16) on the tensor cores: 3 · 2·m·n·k at the bf16
    peak.  Bytes: each input byte read once (payload, x, the column and
    row scales) and the output written once, at the HBM rate.  The larger
    of the two is the bound."""
    flops = 3 * 2.0 * m * n * k
    nbytes = (math.ceil(n * k * _PAYLOAD_BYTES[nbits]) + 4.0 * m * k
              + 4.0 * (k + n) + 4.0 * m * n)
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_S)


def dense_step_flops(linear_params: int, unembed_params: int, tokens: int,
                     attn_live_positions: int, n_heads: int,
                     head_dim: int) -> float:
    """Operations one decode step needs: 2 per parameter per token for the
    linear layers and the unembedding, plus q·k and p·v over each token's
    live positions (2 · 2 · heads · head_dim per position and layer;
    ``attn_live_positions`` sums positions over tokens and layers)."""
    return (2.0 * (linear_params + unembed_params) * tokens
            + 4.0 * n_heads * head_dim * attn_live_positions)


def watersic_least_flops(a: int, n: int) -> float:
    """The least work WaterSIC needs for an (a, n) matrix: one ZSIC pass
    over all rows (a·n² multiply-adds counted as a·n² operations, the
    column loop's cancellations of a lower-triangular L) and the Cholesky
    factorization of its (n, n) Σ (n³/3)."""
    return float(a) * n * n + n ** 3 / 3.0
