"""Information-theoretic limits for weight-only quantization (paper §3;
port of ``repro/core/theory.py``).

Implements:
  * the (reverse) waterfilling rate-distortion function R_WF(D, Σ_X) for a
    Gaussian source W ~ N(0, σ_W² I) observed through activations with
    covariance Σ_X  (eq. (2)),
  * the high-rate form R_HighRate(D, Σ) = ½ log₂(σ_W² |Σ|^{1/n} / D)  (eq. (3)),
  * the predicted high-rate gaps of Theorem 3.3:
        gap_WaterSIC = ½ log₂(2πe/12)  ≈ 0.2546 bits,
        gap_GPTQ     = ½ log₂(2πe/12) + ½ log₂( AM(ℓ_ii²) / GM(ℓ_ii²) ),
  * predicted high-rate distortions D_GPTQ / D_WaterSIC (§3 display eqs.),
  * random covariance generators used by tests/benchmarks (controlled
    conditioning so the GPTQ gap can be made arbitrarily large).

Everything is float64 numpy: these are exact reference quantities.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

__all__ = [
    "GAP_CUBE_BITS",
    "waterfilling_rate",
    "waterfilling_distortion",
    "high_rate_bound",
    "gptq_gap_bits",
    "watersic_gap_bits",
    "predicted_distortion_gptq",
    "predicted_distortion_watersic",
    "random_covariance",
    "chol_lower",
]

#: ½ log₂(2πe/12): rate loss of the scalar integer lattice vs an optimal
#: vector quantizer for a Gaussian — the entirety of WaterSIC's gap.
GAP_CUBE_BITS: float = 0.5 * math.log2(2.0 * math.pi * math.e / 12.0)


def chol_lower(sigma: np.ndarray, jitter: float = 0.0) -> np.ndarray:
    """Lower-triangular Cholesky factor with optional relative jitter."""
    sigma = np.asarray(sigma, dtype=np.float64)
    n = sigma.shape[0]
    if jitter:
        sigma = sigma + jitter * np.mean(np.diag(sigma)) * np.eye(n)
    return np.linalg.cholesky(sigma)


def waterfilling_distortion(tau: float, sigma_w2: float,
                            lambdas: np.ndarray) -> float:
    """D(τ) = (1/n) Σ min(σ_W² λ_i, τ)  — eq. (2) distortion at water level τ."""
    lambdas = np.asarray(lambdas, dtype=np.float64)
    return float(np.minimum(sigma_w2 * lambdas, tau).mean())


def waterfilling_rate(distortion: float, sigma_w2: float,
                      lambdas: np.ndarray, *, tol: float = 1e-14,
                      max_iter: int = 200) -> float:
    """R_WF(D, Σ) in bits/weight — eq. (2), τ found by bisection.

    ``lambdas`` are the eigenvalues of Σ_X.  Valid for
    0 < D ≤ σ_W² mean(λ).
    """
    lambdas = np.asarray(lambdas, dtype=np.float64)
    s = sigma_w2 * lambdas
    d_max = float(s.mean())
    if distortion <= 0:
        raise ValueError("distortion must be positive")
    if distortion >= d_max:
        return 0.0
    lo, hi = 0.0, float(s.max())
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        if waterfilling_distortion(mid, sigma_w2, lambdas) < distortion:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol * max(hi, 1.0):
            break
    tau = 0.5 * (lo + hi)
    ratio = np.maximum(1.0, s / max(tau, 1e-300))
    return float(0.5 * np.mean(np.log2(ratio)))


def high_rate_bound(distortion: float, sigma_w2: float,
                    sigma_x: np.ndarray) -> float:
    """Eq. (3): R_HighRate(D, Σ) = ½ log₂(σ_W² |Σ|^{1/n} / D).

    Equals R_WF whenever D < min_i σ_W² λ_i.  Uses a log-det for stability.
    """
    sigma_x = np.asarray(sigma_x, dtype=np.float64)
    n = sigma_x.shape[0]
    sign, logdet = np.linalg.slogdet(sigma_x)
    if sign <= 0:
        raise ValueError("Σ_X must be positive definite")
    logdet_n = logdet / n  # natural log of |Σ|^{1/n}
    return float(0.5 * (math.log2(sigma_w2) + logdet_n / math.log(2.0)
                        - math.log2(distortion)))


def gptq_gap_bits(l_diag: np.ndarray) -> float:
    """Theorem 3.3 (13): GPTQ's high-rate gap to waterfilling, in bits.

    gap = ½log₂(2πe/12) + ½log₂( mean(ℓ_ii²) / geomean(ℓ_ii²) ) — the AMGM
    term is ≥ 0 and unbounded (e.g. geometrically decaying ℓ_ii).
    """
    l2 = np.asarray(l_diag, dtype=np.float64) ** 2
    am = float(np.mean(l2))
    log_gm = float(np.mean(np.log(l2)))
    return GAP_CUBE_BITS + 0.5 * (math.log2(am) - log_gm / math.log(2.0))


def watersic_gap_bits() -> float:
    """Theorem 3.3 (14): WaterSIC's high-rate gap = ½log₂(2πe/12), ∀Σ_X."""
    return GAP_CUBE_BITS


def predicted_distortion_gptq(rate: float, sigma_w2: float,
                              l_diag: np.ndarray) -> float:
    """D*_GPTQ(R) = 2^{−2R} (2πe/12) (σ_W²/n) Σ ℓ_ii²  (§3 display eq.)."""
    l2 = np.asarray(l_diag, dtype=np.float64) ** 2
    return float(2.0 ** (-2.0 * rate) * (2.0 * math.pi * math.e / 12.0)
                 * sigma_w2 * np.mean(l2))


def predicted_distortion_watersic(rate: float, sigma_w2: float,
                                  l_diag: np.ndarray) -> float:
    """D*_WaterSIC(R) = 2^{−2R} (2πe/12) σ_W² Π ℓ_ii^{2/n}  (§3 display eq.)."""
    l2 = np.asarray(l_diag, dtype=np.float64) ** 2
    gm = math.exp(float(np.mean(np.log(l2))))
    return float(2.0 ** (-2.0 * rate) * (2.0 * math.pi * math.e / 12.0)
                 * sigma_w2 * gm)


def random_covariance(n: int, *, condition: float = 100.0,
                      decay: str = "log-linear",
                      seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Random PSD covariance with controlled spectrum.

    Returns (Σ, eigenvalues).  ``decay``:
      * "log-linear" — eigenvalues log-spaced between 1 and 1/condition,
      * "two-level"  — half the spectrum at 1, half at 1/condition (makes the
        AMGM term large → GPTQ gap blow-up of §3),
      * "flat"       — identity spectrum (GPTQ and WaterSIC coincide),
      * "heavy-tail" — power law λ_i = i^{-p} with p set so λ_n = 1/condition
        (a slowly decaying bulk with a long tail — the activation-covariance
        shape the rate-gap property tests sweep).
    Eigenvectors are a random rotation (Haar via QR).
    """
    rng = np.random.default_rng(seed)
    if decay == "log-linear":
        lam = np.logspace(0.0, -math.log10(condition), n)
    elif decay == "two-level":
        lam = np.where(np.arange(n) < n // 2, 1.0, 1.0 / condition)
    elif decay == "flat":
        lam = np.ones(n)
    elif decay == "heavy-tail":
        p = math.log(condition) / math.log(n)
        lam = np.arange(1, n + 1, dtype=np.float64) ** (-p)
    else:
        raise ValueError(f"unknown decay {decay!r}")
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    sigma = (q * lam) @ q.T
    sigma = 0.5 * (sigma + sigma.T)
    return sigma, lam
