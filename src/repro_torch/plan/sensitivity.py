"""Per-matrix distortion-rate curves for the global planner (port of
``repro/plan/sensitivity.py``, DESIGN.md §10).

WaterSIC waterfills the quantization rate over the in-features of one
matrix (paper §3).  The planner needs the matrix-level view of the same
object: for every linear layer l, the reverse-waterfilling curve

    D_l(R) = (1/n) Σ_i min(s_i, τ(R)),   s_i = σ_W² λ_i(Σ_X),

eq. (2) of the paper evaluated per matrix, with the closed-form marginal
dD_l/dR = −2·ln2·τ_l that makes the allocation across layers a second
waterfilling problem (``plan/waterfill.py``).

:func:`model_sensitivities` weights each matrix by its linearity-theorem
output-error coefficient: ``uniform`` (w_l = 1), ``output``
(w_l = 1/tr(W Σ_X Wᵀ)) or ``probe`` (a seeded weight perturbation per
matrix, measured as calibration-logits MSE per unit weight distortion).

The curve side is float64 numpy, as in the reference.  The model side runs
on the device of the params: the float64 Σ_X sums stay there, and so does
the spectrum (``torch.linalg.eigvalsh`` in float64, once per Σ_X, which
the matrices reading the same activations share).
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.theory import waterfilling_distortion

__all__ = [
    "MatrixSensitivity",
    "rate_at_level",
    "distortion_at_level",
    "level_at_rate",
    "distortion_at_rate",
    "rd_curve",
    "sensitivity_from_matrix",
    "sensitivity_from_streamed",
    "apply_constraints",
    "collect_sigma_x",
    "model_sensitivities",
]


@dataclasses.dataclass
class MatrixSensitivity:
    """Distortion-rate curve inputs for one (out, in) weight matrix.

    ``lambdas`` are the eigenvalues of the calibration Σ_X; with
    ``sigma_w2`` they determine D_l(R).  ``weight`` is the output-error
    coefficient w_l; the planner minimizes Σ_l w_l · n_params_l · D_l(R_l).
    ``floor_bits``/``ceil_bits`` are per-layer allocation constraints.
    """

    name: str
    out_features: int
    in_features: int
    sigma_w2: float
    lambdas: np.ndarray          # (n,) eigenvalues of Σ_X, float64
    weight: float = 1.0
    floor_bits: float = 0.0
    ceil_bits: float = 16.0
    provenance: str = ""

    @property
    def n_params(self) -> int:
        return self.out_features * self.in_features

    @property
    def spectrum(self) -> np.ndarray:
        """s_i = σ_W² λ_i — the per-dimension source variances of eq. (2)."""
        return self.sigma_w2 * np.asarray(self.lambdas, np.float64)


# ---------------------------------------------------------------------------
# Exact reverse-waterfilling curve evaluation
# ---------------------------------------------------------------------------


def rate_at_level(spectrum: np.ndarray, tau: float) -> float:
    """R(τ) = (1/2n) Σ log₂ max(1, s_i/τ) bits/weight (eq. (2))."""
    s = np.asarray(spectrum, np.float64)
    ratio = np.maximum(1.0, s / max(tau, 1e-300))
    return float(0.5 * np.mean(np.log2(ratio)))


def distortion_at_level(spectrum: np.ndarray, tau: float) -> float:
    """D(τ) = (1/n) Σ min(s_i, τ) (σ_W² folded into the spectrum)."""
    return waterfilling_distortion(tau, 1.0, np.asarray(spectrum, np.float64))


def level_at_rate(spectrum: np.ndarray, rate: float, *, tol: float = 1e-14,
                  max_iter: int = 200) -> float:
    """Inner water level τ with R(τ) = ``rate`` (bisection; R is monotone
    decreasing in τ).  rate ≤ 0 returns s_max (zero rate, D = mean(s))."""
    s = np.asarray(spectrum, np.float64)
    hi = float(s.max())
    if rate <= 0.0 or hi <= 0.0:
        return hi
    lo = 0.0
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        if rate_at_level(s, mid) > rate:
            lo = mid            # τ too low → too much rate
        else:
            hi = mid
        if hi - lo < tol * max(hi, 1.0):
            break
    return 0.5 * (lo + hi)


def distortion_at_rate(sens: MatrixSensitivity, rate: float) -> float:
    """Exact D_l(R): invert the rate to the water level, evaluate D(τ)."""
    s = sens.spectrum
    return distortion_at_level(s, level_at_rate(s, rate))


def rd_curve(sens: MatrixSensitivity,
             rates: Sequence[float]) -> np.ndarray:
    """Sampled D_l(R) over a rate grid (plan inspection)."""
    return np.array([distortion_at_rate(sens, r) for r in rates], np.float64)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def _f64(a, device=None) -> torch.Tensor:
    """A numpy array or tensor as a float64 tensor (on ``device`` if given,
    else where it lies; numpy lands on the CPU)."""
    t = a.detach() if isinstance(a, torch.Tensor) \
        else torch.as_tensor(np.asarray(a, np.float64))
    return t.to(device=device or t.device, dtype=torch.float64)


def _spectrum(sigma: torch.Tensor) -> np.ndarray:
    """Eigenvalues of the symmetrized float64 Σ_X, clipped at 0, computed
    on Σ_X's device."""
    lam = torch.linalg.eigvalsh(0.5 * (sigma + sigma.T))
    return lam.clamp_min(0.0).cpu().numpy()


def _output_weight(w: torch.Tensor, sigma: torch.Tensor) -> float:
    """1/tr(W Σ Wᵀ), the ``output`` weighting."""
    tr = float(((w @ sigma) * w).sum())
    return 1.0 / max(tr, 1e-30)


def _sensitivity(name, w: torch.Tensor, lam: np.ndarray, *, weight,
                 floor_bits, ceil_bits, provenance) -> MatrixSensitivity:
    return MatrixSensitivity(
        name=name, out_features=int(w.shape[0]), in_features=int(w.shape[1]),
        sigma_w2=float((w * w).mean()) + 1e-30, lambdas=lam,
        weight=float(weight), floor_bits=floor_bits, ceil_bits=ceil_bits,
        provenance=provenance)


def sensitivity_from_matrix(name: str, w, sigma_x, *, weight: float = 1.0,
                            floor_bits: float = 0.0,
                            ceil_bits: float = 16.0,
                            provenance: str = "matrix",
                            ) -> MatrixSensitivity:
    """Curve inputs from an (out, in) weight matrix and its Σ_X (numpy
    arrays or tensors; float64 on the device of ``w``)."""
    w = _f64(w)
    return _sensitivity(name, w, _spectrum(_f64(sigma_x, w.device)),
                        weight=weight, floor_bits=floor_bits,
                        ceil_bits=ceil_bits, provenance=provenance)


def sensitivity_from_streamed(name: str, w, est, *,
                              weight: Optional[float] = None,
                              floor_bits: float = 0.0,
                              ceil_bits: float = 16.0,
                              min_samples: int = 1,
                              provenance: str = "",
                              ) -> MatrixSensitivity:
    """Curve inputs from a live streamed-Σ estimator (DESIGN.md §15):
    anything exposing ``.sigma`` (the uncentered second moment E[xxᵀ]) and
    ``.n`` (samples).  ``weight=None`` recomputes the output weighting
    1/tr(WΣWᵀ) against the live Σ; ``min_samples`` guards against acting
    on a barely-warmed estimator."""
    n = float(getattr(est, "n"))
    if n < min_samples:
        raise ValueError(f"{name}: streamed Σ has {n:.0f} samples "
                         f"< min_samples={min_samples}")
    w = _f64(w)
    sigma = _f64(getattr(est, "sigma"), w.device)
    if weight is None:
        weight = _output_weight(w, sigma)
    return _sensitivity(name, w, _spectrum(sigma), weight=float(weight),
                        floor_bits=floor_bits, ceil_bits=ceil_bits,
                        provenance=provenance or f"streamed:{n:.0f}t")


def apply_constraints(sens: List[MatrixSensitivity],
                      floors: Optional[Dict[str, float]] = None,
                      ceils: Optional[Dict[str, float]] = None,
                      ) -> List[MatrixSensitivity]:
    """Set per-layer floor/ceiling bits by fnmatch pattern on the name
    (e.g. {"*/wo": 4.0} keeps every output projection ≥ 4 bits)."""
    for s in sens:
        for pat, b in (floors or {}).items():
            if fnmatch.fnmatch(s.name, pat):
                s.floor_bits = max(s.floor_bits, float(b))
        for pat, b in (ceils or {}).items():
            if fnmatch.fnmatch(s.name, pat):
                s.ceil_bits = min(s.ceil_bits, float(b))
        if s.floor_bits > s.ceil_bits:
            raise ValueError(f"{s.name}: floor {s.floor_bits} > ceiling "
                             f"{s.ceil_bits}")
    return sens


# ---------------------------------------------------------------------------
# Model-level collection (fp forward only: plans are built before any
# quantization, which is what lets the executor run matrices in parallel)
# ---------------------------------------------------------------------------


def collect_sigma_x(cfg, params, calib_batches):
    """One fp calibration pass; returns the StatsAccumulator with every
    (layer, tap) Σ_X (the fp taps stand in for both forward streams)."""
    from repro_torch.quant.calibrate import (StatsAccumulator,
                                             accumulate_stats,
                                             forward_with_taps)
    acc = StatsAccumulator()
    for tokens in calib_batches:
        _, taps = forward_with_taps(cfg, params, tokens)
        for l, t in enumerate(taps):
            accumulate_stats(acc, l, t, t)
    return acc


def _perturbed(params, l: int, path, w_new: torch.Tensor):
    """``params`` with layer ``l`` of the stacked leaf at ``path`` set to
    ``w_new`` (in, out): that leaf is cloned, everything else shared."""
    leaf = params["layers"]
    for k in path:
        leaf = leaf[k]
    w = leaf["w"].clone()
    w[l] = w_new.to(w.dtype)

    def swap(node, keys):
        if not keys:
            return {**node, "w": w}
        return {**node, keys[0]: swap(node[keys[0]], keys[1:])}
    return {**params, "layers": swap(params["layers"], tuple(path))}


def model_sensitivities(cfg, params, calib_batches, *,
                        weighting: str = "output",
                        probe_eps: float = 0.05,
                        seed: int = 0,
                        floors: Optional[Dict[str, float]] = None,
                        ceils: Optional[Dict[str, float]] = None,
                        ) -> List[MatrixSensitivity]:
    """Per-matrix sensitivities of a dense or MoE model, on the params'
    device.

    Names match ``quant.pipeline``'s budget keys ("L{l}/attn/wq",
    "L{l}/moe/w_up/e{e}"), so a plan built here drives either execution
    path.  ``weighting`` ∈ {"uniform", "output", "probe"}; ``probe``
    draws each matrix's perturbation from ``numpy.random.default_rng(seed)``
    in the reference's order, and is refused for a MoE model.  An expert
    matrix's curve comes from the Σ_X of the tokens routed to it.
    """
    from repro_torch.quant import pipeline as _pl
    from repro_torch.quant.calibrate import (check_ptq_family,
                                             forward_with_taps)
    check_ptq_family(cfg)
    if weighting == "probe" and cfg.n_experts:
        # probe coefficients (logits MSE per unit distortion) and any
        # fallback scale for experts are incomparable units inside one
        # waterfilling objective — refuse instead of silently mixing them
        raise ValueError("weighting='probe' is dense-only; use 'uniform' "
                         "or 'output' for moe models")
    if weighting not in ("uniform", "output", "probe"):
        raise ValueError(f"unknown weighting {weighting!r}")
    acc = collect_sigma_x(cfg, params, calib_batches)
    mats = _pl._mats_for(cfg, params)
    rng = np.random.default_rng(seed)
    base_logits = None
    if weighting == "probe":
        base_logits = [forward_with_taps(cfg, params, t)[0].to(torch.float64)
                       for t in calib_batches]

    def probe_weight(l, path, w, sigma):
        sw = float(torch.sqrt((w * w).mean())) + 1e-30
        delta = torch.as_tensor(rng.standard_normal(tuple(w.shape))
                                * (probe_eps * sw), device=w.device)
        d_inj = float(((delta @ sigma) * delta).sum()) / w.numel()
        pert = _perturbed(params, l, path, (w + delta).T)
        num = cnt = 0.0
        for tokens, lg0 in zip(calib_batches, base_logits):
            lg1, _ = forward_with_taps(cfg, pert, tokens)
            d = lg1.to(torch.float64) - lg0
            num += float((d ** 2).sum())
            cnt += d.numel()
        return num / max(cnt, 1.0) / max(w.numel() * d_inj, 1e-30)

    spectra: Dict[str, np.ndarray] = {}
    out: List[MatrixSensitivity] = []
    for l in range(_pl._layer_count(params)):
        for path, tap, _ in mats:
            name = f"L{l}/{'/'.join(path)}"
            w = _pl._get_w(params, l, path).T.to(torch.float64)
            key = f"L{l}/{tap}/xx"
            sigma = acc.get(key)
            if key not in spectra:
                spectra[key] = _spectrum(sigma)
            if weighting == "uniform":
                weight = 1.0
            elif weighting == "output":
                weight = _output_weight(w, sigma)
            else:
                weight = probe_weight(l, path, w, sigma)
            out.append(_sensitivity(
                name, w, spectra[key], weight=weight, floor_bits=0.0,
                ceil_bits=16.0,
                provenance=f"calib:{len(calib_batches)}b/{weighting}"))
        for key in _pl._expert_keys(cfg, params):
            tap = _pl._expert_tap(key)
            for e in range(cfg.n_experts):
                w = params["layers"]["moe"][key][l, e].T.to(torch.float64)
                skey = f"L{l}/e{e}/{tap}/xx"
                sigma = acc.get(skey)
                if skey not in spectra:      # w_gate and w_up share "in"
                    spectra[skey] = _spectrum(sigma)
                weight = (_output_weight(w, sigma) if weighting == "output"
                          else 1.0)
                out.append(_sensitivity(
                    f"L{l}/moe/{key}/e{e}", w, spectra[skey], weight=weight,
                    floor_bits=0.0, ceil_bits=16.0,
                    provenance=f"calib:{len(calib_batches)}b/routed"))
    return apply_constraints(out, floors, ceils)
