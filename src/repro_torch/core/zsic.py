"""ZSIC — successive interference cancellation quantizer (paper Alg. 1;
port of ``repro/core/zsic.py``).

Given Y ∈ R^{a×n}, a lower-triangular L (Cholesky of the activation
covariance) and a diagonal spacing matrix A = diag(α₁…α_n), ZSIC decides the
integer codes column-by-column from i=n down to 1:

    Z[:, i]  = round( Y[:, i] / (α_i ℓ_ii) )
    Y       -= α_i Z[:, i] ⊗ L[i, :]          (cancel interference on j ≤ i)

so that  Z·A·L ≈ argmin_Z ||Y − Z A L||²  (Babai's nearest plane on the
lattice Zⁿ·A·L).  Lemma 3.2 guarantees  e = Y − Z A L ∈ CUBE·A·diag(L).

Variants:
  * ``zsic_numpy``, ``zsic_lmmse_numpy`` — float64 numpy references,
  * ``zsic``         — Alg. 1 on tensors (the reference's ``zsic_jax``),
  * ``zsic_lmmse``   — Alg. 3 Phase 2 on tensors: per-column LMMSE shrinkage
                       γ_i; a Python loop over columns (the reference's
                       ``lax.fori_loop``; γ_i sums over ALL rows of column i,
                       so row tiles are not independent and no kernel runs
                       it),
  * ``zsic_blocked`` — the blocked form: the recursion runs inside a column
                       block, the trailing update is one matmul; exact
                       against the column recursion in float64.  It is
                       ``kernels/zsic/ops.zsic_quantize``.

Rounding is ``torch.round`` (half to even, as ``np.rint``/``jnp.rint``) of a
true division by the step α_i·ℓ_ii.  Only the columns j ≤ i of row i of L
are applied: L is lower-triangular, so the columns right of i would
subtract zeros.  Shapes: Y (a, n); L (n, n) lower-triangular; alphas (n,).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels.zsic.ops import zsic_quantize

__all__ = [
    "zsic_numpy",
    "zsic",
    "zsic_lmmse_numpy",
    "zsic_lmmse",
    "zsic_blocked",
    "ZSICResult",
]


class ZSICResult(NamedTuple):
    codes: torch.Tensor     # (a, n) integer codes (int32)
    gammas: torch.Tensor    # (n,) LMMSE shrinkage per column (ones if disabled)
    residual: torch.Tensor  # (a, n) final Y: e = Y₀ − Ŷ after all cancellation


# ---------------------------------------------------------------------------
# numpy reference (float64)
# ---------------------------------------------------------------------------


def zsic_numpy(y: np.ndarray, l: np.ndarray,
               alphas: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Reference Alg. 1. Returns (Z int64, residual).

    The reference's values, computed on the transposed layout and only on
    the columns j ≤ i that a lower-triangular L touches, so a (2304,
    2304) oracle takes seconds."""
    yt = np.array(y, dtype=np.float64).T.copy()           # (n, a)
    l = np.asarray(l, dtype=np.float64)
    alphas = np.asarray(alphas, dtype=np.float64)
    n, a = yt.shape
    zt = np.zeros((n, a), dtype=np.int64)
    buf = np.empty_like(yt)
    for i in range(n - 1, -1, -1):
        zi = np.rint(yt[i] / (alphas[i] * l[i, i]))
        zt[i] = zi.astype(np.int64)
        upd = np.multiply.outer(l[i, :i + 1], zi, out=buf[:i + 1])
        upd *= alphas[i]                                  # α_i·(ℓ_ij z_i)
        yt[:i + 1] -= upd
    return zt.T.copy(), yt.T.copy()


def zsic_lmmse_numpy(y: np.ndarray, l: np.ndarray, c: float
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference Alg. 3 Phase 2 (α_i = c/ℓ_ii so α_i ℓ_ii = c).

    Returns (Z int64, gammas, residual).  γ_i = z_iᵀY_i / (c‖z_i‖²), guarded
    to 1 when the column quantizes to all-zeros.
    """
    y = np.array(y, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    a, n = y.shape
    z = np.zeros((a, n), dtype=np.int64)
    gammas = np.ones(n, dtype=np.float64)
    for i in range(n - 1, -1, -1):
        alpha_i = c / l[i, i]
        zi = np.rint(y[:, i] / c)
        z[:, i] = zi.astype(np.int64)
        den = c * float(zi @ zi)
        gam = float(zi @ y[:, i]) / den if den > 0 else 1.0
        gammas[i] = gam
        y -= gam * alpha_i * np.outer(zi, l[i, :])
    return z, gammas, y


# ---------------------------------------------------------------------------
# tensor implementations (dtype and device follow y)
# ---------------------------------------------------------------------------


def _spacings(alphas, y: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(alphas, dtype=y.dtype,
                           device=y.device).expand(y.shape[1])


def zsic_lmmse(y: torch.Tensor, l: torch.Tensor, alphas,
               *, lmmse: bool = True) -> ZSICResult:
    """Alg. 3 Phase 2: ZSIC with per-column spacings + LMMSE shrinkage.

    ``alphas`` is the (n,) spacing vector: WaterSIC passes α_i = c/ℓ_ii
    (constant rounding step c), HPTQ passes α_i = α (uniform lattice).
    The rounding divisor is step_i = α_i·ℓ_ii in both cases.  Works on the
    transposed layout (n, a), so each column is a contiguous row; no value
    leaves the device inside the loop.
    """
    a, n = y.shape
    yt = y.T.clone(memory_format=torch.contiguous_format)  # (n, a)
    alphas = _spacings(alphas, y)
    step = alphas * torch.diagonal(l)
    z = torch.zeros((n, a), dtype=torch.int32, device=y.device)
    g = torch.ones((n,), dtype=y.dtype, device=y.device)
    one = torch.ones((), dtype=y.dtype, device=y.device)
    for i in range(n - 1, -1, -1):
        col = yt[i]
        zi = torch.round(col / step[i:i + 1])
        if lmmse:
            den = step[i] * torch.sum(zi * zi)
            gam = torch.where(den > 0, torch.sum(zi * col)
                              / torch.clamp(den, min=1e-30), one)
            g[i] = gam
            coef = gam * alphas[i]
        else:
            coef = alphas[i]
        yt[:i + 1] -= (coef * l[i, :i + 1])[:, None] * zi[None, :]
        z[i] = zi.to(torch.int32)
    return ZSICResult(codes=z.T.contiguous(), gammas=g,
                      residual=yt.T.contiguous())


def zsic(y: torch.Tensor, l: torch.Tensor, alphas) -> ZSICResult:
    """Alg. 1 as a loop over columns (reverse order); the reference's
    ``zsic_jax``."""
    return zsic_lmmse(y, l, alphas, lmmse=False)


# ---------------------------------------------------------------------------
# Blocked form — see DESIGN.md §4.1
# ---------------------------------------------------------------------------


def zsic_blocked(y: torch.Tensor, l: torch.Tensor, alphas,
                 *, block: int = 128) -> ZSICResult:
    """Blocked restructuring of Alg. 1, exact in float64.

    Columns are processed in blocks of ``block`` (at most 128) from the
    right: the SIC recursion inside a block needs only the block-diagonal
    square of L, and the trailing cancellation onto the columns left of the
    block is one dense matmul ``Y[:, :s] −= (αZ)_B · L[B, :s]``.  This is
    ``kernels/zsic/ops.zsic_quantize`` (the in-block kernel on the card,
    its plain twin on the CPU) with the reference's result type.
    """
    codes, resid = zsic_quantize(y, l, alphas, block=block)
    return ZSICResult(codes=codes, gammas=torch.ones(
        (y.shape[1],), dtype=y.dtype, device=y.device), residual=resid)
