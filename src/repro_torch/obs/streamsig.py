"""Streamed activation covariance — Welford/outer-product Σ_X estimators
(port of ``repro/obs/streamsig.py``, a numpy copy; DESIGN.md §14).

The paper's quality story is a function of the input-activation second
moment Σ_X = E[xxᵀ]; calibration measures it once (quant/calibrate's
``StatsAccumulator``) and the plan's distortion-rate curves are exact
only while live traffic still draws from that distribution.  This module
is the live half: a numerically stable streaming estimator updated from
engine activations, plus the divergence functionals the quality monitor
publishes as per-matrix gauges.

:class:`StreamingSigma` runs Welford's algorithm on (mean, centered M2)
and exposes the UNcentered second moment ``M2/n + mean·meanᵀ`` — the
same object ``StatsAccumulator.get("…/xx")`` returns (a plain ``Σxxᵀ/n``),
so live and calibration estimates are directly comparable.  Chunked
updates use the standard parallel-Welford merge, making the estimate
independent of how token batches were chunked.

Divergences (all scale-free):

* :func:`frobenius_shift` — ‖Σ_live − Σ_ref‖_F / ‖Σ_ref‖_F, the full
  matrix-level drift measure (needs the reference Σ).
* :func:`top_eig_shift` — |λ_max(live) − λ_max(ref)| / λ_max(ref),
  comparable against the plan's stored calibration SPECTRA alone
  (`plan/sensitivity.MatrixSensitivity.lambdas`) without the matrix.
* :func:`spectrum_shift` — relative ℓ₂ distance between the sorted
  eigenvalue spectra (the rotation-invariant middle ground).

numpy-only; nothing here imports torch or the obs facade.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["StreamingSigma", "SigmaTracker", "frobenius_shift",
           "top_eig_shift", "spectrum_shift"]


class StreamingSigma:
    """Welford-updated estimator of E[xxᵀ] over a stream of row batches."""

    def __init__(self, dim: int):
        self.dim = int(dim)
        self.n = 0.0
        self._mean = np.zeros(dim, np.float64)
        self._m2 = np.zeros((dim, dim), np.float64)   # Σ (x−μ)(x−μ)ᵀ

    def update(self, x: np.ndarray) -> None:
        """Fold a (T, dim) batch in (parallel-Welford chunk merge)."""
        x = np.asarray(x, np.float64).reshape(-1, self.dim)
        t = x.shape[0]
        if t == 0:
            return
        mean_b = x.mean(axis=0)
        xc = x - mean_b
        m2_b = xc.T @ xc
        if self.n == 0:
            self.n, self._mean, self._m2 = float(t), mean_b, m2_b
            return
        delta = mean_b - self._mean
        n_new = self.n + t
        self._m2 += m2_b + np.outer(delta, delta) * (self.n * t / n_new)
        self._mean += delta * (t / n_new)
        self.n = n_new

    @property
    def sigma(self) -> np.ndarray:
        """The uncentered second moment E[xxᵀ] (calibration convention)."""
        if self.n == 0:
            return np.zeros((self.dim, self.dim), np.float64)
        return self._m2 / self.n + np.outer(self._mean, self._mean)

    @property
    def mean(self) -> np.ndarray:
        return self._mean.copy()

    def spectrum(self) -> np.ndarray:
        """Ascending eigenvalues of the symmetrized estimate, clipped ≥ 0
        (the live counterpart of MatrixSensitivity.lambdas)."""
        s = self.sigma
        lam = np.linalg.eigvalsh(0.5 * (s + s.T))
        return np.maximum(lam, 0.0)


class SigmaTracker:
    """Keyed family of estimators — one per (layer, tap) activation site."""

    def __init__(self):
        self._est: Dict[str, StreamingSigma] = {}

    def update(self, key: str, x: np.ndarray) -> StreamingSigma:
        x = np.asarray(x, np.float64)
        x = x.reshape(-1, x.shape[-1])
        est = self._est.get(key)
        if est is None:
            est = self._est[key] = StreamingSigma(x.shape[-1])
        est.update(x)
        return est

    def get(self, key: str) -> Optional[StreamingSigma]:
        return self._est.get(key)

    def keys(self):
        return sorted(self._est)


def frobenius_shift(sigma_live: np.ndarray, sigma_ref: np.ndarray) -> float:
    """‖Σ_live − Σ_ref‖_F / ‖Σ_ref‖_F (0 = identical distributions)."""
    ref = np.asarray(sigma_ref, np.float64)
    live = np.asarray(sigma_live, np.float64)
    denom = float(np.linalg.norm(ref))
    return float(np.linalg.norm(live - ref)) / max(denom, 1e-30)


def top_eig_shift(spec_live: np.ndarray, spec_ref: np.ndarray) -> float:
    """|λ_max(live) − λ_max(ref)| / λ_max(ref) over eigenvalue arrays."""
    top_ref = float(np.max(np.asarray(spec_ref, np.float64), initial=0.0))
    top_live = float(np.max(np.asarray(spec_live, np.float64), initial=0.0))
    return abs(top_live - top_ref) / max(top_ref, 1e-30)


def spectrum_shift(spec_live: np.ndarray, spec_ref: np.ndarray) -> float:
    """‖sort(λ_live) − sort(λ_ref)‖₂ / ‖λ_ref‖₂ (padded with zeros when
    the spectra have different lengths — a dimensionality change is
    itself drift)."""
    a = np.sort(np.asarray(spec_live, np.float64))[::-1]
    b = np.sort(np.asarray(spec_ref, np.float64))[::-1]
    n = max(a.size, b.size)
    a = np.pad(a, (0, n - a.size))
    b = np.pad(b, (0, n - b.size))
    return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)),
                                              1e-30)
