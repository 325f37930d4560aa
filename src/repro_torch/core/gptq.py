"""GPTQ baselines (paper §2, §3.2; port of ``repro/core/gptq.py``).

Two mathematically equivalent implementations:

  * ``gptq_via_zsic``   — the paper's formulation: canonical GPTQ ≡ ZSIC with
                          uniform spacing A = αI on Y = WL (Chen et al. 2026;
                          Birnick 2026 — Babai's nearest plane).  numpy
                          inputs run in float64 through ``zsic_numpy`` (codes
                          byte-identical to the reference's); tensors run
                          ZSIC through ``zsic_blocked``, i.e. the in-block
                          kernel on the card.
  * ``gptq_frantar``    — the textbook OPTQ recursion (error propagation with
                          the upper factor U of H⁻¹ = UᵀU) in float64 numpy,
                          kept as the independent cross-check.  Frantar
                          processes columns first→last, ZSIC last→first;
                          they coincide after reversing the coordinate order
                          (flip W and Σ), code for code.

Rates:
  * GPTQ ("log-cardinality"): R = log₂(2·maxq + 1) for a clipped grid,
  * Huffman-GPTQ / HPTQ: R = empirical entropy of the (unclipped) codes —
    exactly PlainWaterSIC with α_i = α ∀i.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import entropy as ent
from .zsic import zsic_blocked, zsic_numpy

__all__ = ["gptq_via_zsic", "gptq_frantar", "huffman_gptq",
           "rate_log_cardinality"]


def _gptq_via_zsic_tensor(w: torch.Tensor, sigma_x: torch.Tensor,
                          alpha: float) -> Dict:
    a, n = w.shape
    sigma_x = sigma_x.to(w)
    l = torch.linalg.cholesky(sigma_x)
    alphas = torch.full((n,), float(alpha), dtype=w.dtype, device=w.device)
    res = zsic_blocked(w @ l, l, alphas)
    w_hat = res.codes.to(w.dtype) * alphas
    err = w - w_hat
    distortion = float(torch.einsum("ij,jk,ik->", err, sigma_x, err)
                       / (n * a))
    return {"codes": res.codes, "w_hat": w_hat,
            "entropy": ent.empirical_entropy(res.codes),
            "distortion": distortion, "residual": res.residual}


def gptq_via_zsic(w, sigma_x, alpha: float) -> Dict:
    """Canonical GPTQ = ZSIC(WL, L, αI); entropy-coded rate (HPTQ).

    numpy ``w``: float64 throughout, the reference's result.  A tensor
    ``w``: ZSIC in ``w``'s dtype on ``w``'s device, the codes int32."""
    if isinstance(w, torch.Tensor):
        return _gptq_via_zsic_tensor(w, torch.as_tensor(sigma_x), alpha)
    w = np.asarray(w, dtype=np.float64)
    sigma_x = np.asarray(sigma_x, dtype=np.float64)
    a, n = w.shape
    l = np.linalg.cholesky(sigma_x)
    alphas = np.full(n, float(alpha))
    z, resid = zsic_numpy(w @ l, l, alphas)
    w_hat = z * alpha
    err = w - w_hat
    distortion = float(np.einsum("ij,jk,ik->", err, sigma_x, err) / (n * a))
    return {
        "codes": z,
        "w_hat": w_hat,
        "entropy": ent.empirical_entropy(z),
        "distortion": distortion,
        "residual": resid,
    }


def _upper_factor_of_hinv(h: np.ndarray) -> np.ndarray:
    """Upper-triangular U with H⁻¹ = UᵀU.

    Via the flipped Cholesky: with P the reversal permutation,
    chol(P H P) = L̃ (lower) ⇒ H = R Rᵀ, R = P L̃ P (upper) ⇒
    H⁻¹ = R⁻ᵀ R⁻¹ = UᵀU with U = R⁻¹ (upper).
    """
    hf = h[::-1, ::-1]
    lt = np.linalg.cholesky(hf)
    r = lt[::-1, ::-1]           # upper, H = R Rᵀ
    return np.linalg.inv(r)      # upper


def gptq_frantar(w: np.ndarray, sigma_x: np.ndarray, alpha: float,
                 *, damp: float = 0.0, maxq: int = 0) -> Dict:
    """Textbook OPTQ (Frantar et al. 2023), column order 0..n−1, float64.

    ``maxq > 0`` clips codes to the symmetric range [−maxq, maxq] (the
    log-cardinality regime); ``maxq == 0`` leaves codes unbounded (the
    entropy-coded regime).  The recursion runs on the transposed layout
    (n, a), so each error-propagation step updates contiguous rows: the
    same products and subtractions as the reference, element for element,
    so the same bits, in a fraction of its time at (2304, 2304).
    """
    w = np.array(w, dtype=np.float64)
    sigma_x = np.asarray(sigma_x, dtype=np.float64)
    a, n = w.shape
    h = sigma_x
    if damp:
        h = h + damp * np.mean(np.diag(h)) * np.eye(n)
    u = _upper_factor_of_hinv(h)
    zt = np.zeros((n, a), dtype=np.int64)
    work = w.T.copy()                                     # (n, a)
    buf = np.empty_like(work)
    for i in range(n):
        zi = np.rint(work[i] / alpha)
        if maxq:
            zi = np.clip(zi, -maxq, maxq)
        zt[i] = zi.astype(np.int64)
        err = (work[i] - alpha * zi) / u[i, i]
        if i + 1 < n:
            work[i + 1:] -= np.multiply.outer(u[i, i + 1:], err,
                                              out=buf[i + 1:])
    z = zt.T.copy()
    w_hat = alpha * z
    errm = w - w_hat
    distortion = float(np.einsum("ij,jk,ik->", errm, sigma_x, errm) / (n * a))
    return {
        "codes": z,
        "w_hat": w_hat,
        "entropy": ent.empirical_entropy(z),
        "distortion": distortion,
    }


def huffman_gptq(w, sigma_x, alpha: float) -> Dict:
    """Huffman-GPTQ / HPTQ: GPTQ codes + entropy-coded rate."""
    out = gptq_via_zsic(w, sigma_x, alpha)
    out["rate"] = out["entropy"]
    out["huffman_bits"] = ent.huffman_bits(out["codes"])
    return out


def rate_log_cardinality(maxq: int) -> float:
    """GPTQ-style rate accounting: log₂ of the grid cardinality."""
    return math.log2(2 * maxq + 1)
