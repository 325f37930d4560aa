"""WaterSIC weight-only quantization (paper Algorithms 2 and 3; port of
``repro/core/watersic.py``).

``plain_watersic``    — Alg. 2: ZSIC with waterfilling spacings
                        α_i = α·|L|^{1/n}/ℓ_ii  + entropy coding (float64
                        numpy, the theory path).
``watersic_quantize`` — Alg. 3, the full production algorithm:
                          Phase 1  damped Hessian, Cholesky, drift/residual-
                                   corrected target  Y = (WΣ_{X,X̂}+Σ_{Δ,X̂})L⁻ᵀ,
                                   spacings α_k = c/ℓ_kk
                          Phase 2  ZSIC: with LMMSE shrinkage γ_i the
                                   column loop ``zsic_lmmse``; without it
                                   the blocked form through the in-block
                                   kernel (``kernels/zsic``)
                          Phase 3  effective rate  H(Z) + 16/a + 16/n
                          Phase 4  alternating diagonal rescalers T, Γ
                        plus dead-feature erasure (§4) wrapped around it.
``quantize_at_rate``  — secant search on log₂(c) hitting a target rate to
                        <0.005 bits in ~3 evaluations, on a row subsample
                        (paper §4 "Rate assignment").

Tensors stay on the device of ``w``; the dead-feature median, the row
subsample (``np.random.default_rng(seed)``, the same rows as the
reference) and the entropy are host numpy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.zsic import zsic_quantize
from . import entropy as ent
from .rescalers import find_optimal_rescalers
from .zsic import ZSICResult, zsic_lmmse, zsic_numpy

__all__ = [
    "CalibStats",
    "QuantizedLinear",
    "plain_watersic",
    "watersic_quantize",
    "quantize_at_rate",
    "initial_spacing",
    "layer_distortion",
]


def _index(keep: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(keep, dtype=torch.long, device=like.device)


@dataclasses.dataclass
class CalibStats:
    """Calibration statistics for one linear layer (paper §4).

    Defaults per Alg. 3: missing Σ_X̂ / Σ_{X,X̂} fall back to Σ_X (no drift
    correction), missing Σ_{Δ,X̂} falls back to 0 (no residual correction).
    """

    sigma_x: torch.Tensor                       # (n, n) E[X Xᵀ]
    sigma_xhat: Optional[torch.Tensor] = None   # (n, n) E[X̂ X̂ᵀ]
    sigma_x_xhat: Optional[torch.Tensor] = None  # (n, n) E[X X̂ᵀ]
    sigma_delta_xhat: Optional[torch.Tensor] = None  # (a, n) E[(R−R̂) X̂ᵀ]

    def resolved(self):
        sx = self.sigma_x
        sxh = self.sigma_xhat if self.sigma_xhat is not None else sx
        sxxh = self.sigma_x_xhat if self.sigma_x_xhat is not None else sx
        return sx, sxh, sxxh, self.sigma_delta_xhat

    def damped(self, delta: float) -> "CalibStats":
        """Appendix C damping: add δ·I to Σ_X, Σ_X̂ and Σ_{X,X̂} (note!),
        leave Σ_{Δ,X̂} untouched (not a typo — see paper App. C)."""
        n = self.sigma_x.shape[0]
        eye = torch.eye(n, dtype=self.sigma_x.dtype,
                        device=self.sigma_x.device)
        sx, sxh, sxxh, sdx = self.resolved()
        d = delta * torch.mean(torch.diagonal(sxh))
        return CalibStats(sigma_x=sx + d * eye, sigma_xhat=sxh + d * eye,
                          sigma_x_xhat=sxxh + d * eye, sigma_delta_xhat=sdx)

    def reduce(self, keep: np.ndarray) -> "CalibStats":
        """Restrict all statistics to the kept (live) input dimensions."""
        idx = _index(keep, self.sigma_x)

        def r(m):
            return None if m is None else m[idx][:, idx]
        sdx = self.sigma_delta_xhat
        return CalibStats(sigma_x=r(self.sigma_x),
                          sigma_xhat=r(self.sigma_xhat),
                          sigma_x_xhat=r(self.sigma_x_xhat),
                          sigma_delta_xhat=None if sdx is None
                          else sdx[:, idx])


@dataclasses.dataclass
class QuantizedLinear:
    """Result of quantizing one (a, n) weight matrix.

    Ŵ[o, i] = t[o] · Z[o, i] · α[i] · γ[i]   (zeros at dead columns).
    The tensors live on the device the matrix was quantized on.
    """

    codes: torch.Tensor        # (a, n_live) int32
    alphas: torch.Tensor       # (n_live,) grid spacings
    gamma: torch.Tensor        # (n_live,) column rescalers Γ (incl. LMMSE)
    t: torch.Tensor            # (a,) row rescalers, ‖t‖₁ = a
    dead_mask: np.ndarray      # (n,) bool — True where input feature erased
    c: float                   # final spacing constant
    entropy_bits: float        # H(Z) bits/weight (joint over matrix)
    rate_eff: float            # H + 16/a + 16/n
    out_features: int
    in_features: int

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        scale = (self.alphas * self.gamma)[None, :]
        w_live = (self.codes.to(dtype) * scale.to(dtype)
                  * self.t.to(dtype)[:, None])
        if not self.dead_mask.any():
            return w_live
        w = torch.zeros((self.out_features, self.in_features), dtype=dtype,
                        device=w_live.device)
        w[:, _index(np.nonzero(~self.dead_mask)[0], w)] = w_live
        return w

    @property
    def column_scale(self) -> torch.Tensor:
        """Fused per-column scale (α ⊙ γ), the 16/n overhead of Alg. 3."""
        return self.alphas * self.gamma


# ---------------------------------------------------------------------------
# Alg. 2 — PlainWaterSIC (theory path, float64 numpy)
# ---------------------------------------------------------------------------


def plain_watersic(w: np.ndarray, sigma_x: np.ndarray, alpha: float):
    """Alg. 2.  Returns dict with codes, alphas, w_hat, entropy (bits/weight),
    distortion D = (1/na)·tr((W−Ŵ)Σ(W−Ŵ)ᵀ)."""
    w = np.asarray(w, dtype=np.float64)
    sigma_x = np.asarray(sigma_x, dtype=np.float64)
    a, n = w.shape
    l = np.linalg.cholesky(sigma_x)
    ldiag = np.diagonal(l)
    log_gm = float(np.mean(np.log(np.abs(ldiag))))
    alphas = alpha * math.exp(log_gm) / np.abs(ldiag)
    z, resid = zsic_numpy(w @ l, l, alphas)
    w_hat = z * alphas[None, :]
    err = w - w_hat
    distortion = float(np.einsum("ij,jk,ik->", err, sigma_x, err) / (n * a))
    return {
        "codes": z,
        "alphas": alphas,
        "w_hat": w_hat,
        "entropy": ent.empirical_entropy(z),
        "distortion": distortion,
        "residual": resid,
    }


# ---------------------------------------------------------------------------
# Alg. 3 — full WaterSIC
# ---------------------------------------------------------------------------


def _dead_features(sigma_x, tau: float) -> np.ndarray:
    """§4 dead-feature erasure: [Σ_X]_ii < τ·median_j [Σ_X]_jj (median, not
    mean — high-variance SiLU dims would inflate the mean)."""
    d = torch.diagonal(sigma_x).detach().cpu().numpy()
    med = float(np.median(d))
    return d < tau * med


def initial_spacing(w, l_diag, target_bits: float) -> float:
    """High-rate initial guess: H ≈ ½log₂(2πe σ_W² GM(ℓ²)/c²) (eq. (9))."""
    sigma_w2 = float(torch.mean(w * w)) + 1e-30
    ld = l_diag.detach().cpu().numpy()
    log_gm = float(np.mean(np.log(np.abs(ld) + 1e-30)))
    c = math.sqrt(2.0 * math.pi * math.e * sigma_w2) * math.exp(log_gm) \
        * 2.0 ** (-target_bits)
    return max(c, 1e-12)


def watersic_quantize(
    w: torch.Tensor,
    stats: CalibStats,
    c: float,
    *,
    damp: float = 1e-4,
    lmmse: bool = True,
    rescalers: bool = True,
    rescaler_ridge: float = 0.0,
    dead_tau: float = 1e-3,
    erase_dead: bool = True,
    spacing: str = "waterfill",
    l_chol: Optional[torch.Tensor] = None,
) -> QuantizedLinear:
    """Alg. 3 (full WaterSIC) at fixed spacing constant ``c``.

    ``spacing="waterfill"`` → α_i = c/ℓ_ii (WaterSIC);
    ``spacing="uniform"``   → α_i = c/GM(ℓ) (same lattice density, uniform
    grid = the HPTQ/Huffman-GPTQ baseline of §3.2).

    ``lmmse=True`` runs the column loop ``zsic_lmmse``; ``lmmse=False``
    runs the blocked ZSIC (``kernels/zsic/ops.zsic_quantize``: the
    hand-written in-block kernel for CUDA tensors, its twin on the CPU) —
    the same codes as the column recursion, exactly so in float64.

    ``l_chol`` optionally supplies the Cholesky factor of the damped,
    dead-reduced Σ_X̂ — the caller must have computed it with the SAME
    damp/dead_tau/erase_dead settings (quantize_at_rate does, amortizing
    one factorization over every secant-search evaluation)."""
    a, n_full = w.shape
    dtype = w.dtype

    # -- dead-feature erasure (§4) -----------------------------------------
    dead = (_dead_features(stats.sigma_x, dead_tau) if erase_dead
            else np.zeros(n_full, dtype=bool))
    if dead.all():
        raise ValueError("all input features are dead")
    keep = np.nonzero(~dead)[0]
    if dead.any():
        stats = stats.reduce(keep)
        w_live = w[:, _index(keep, w)]
    else:
        w_live = w
    n = w_live.shape[1]

    # -- Phase 1: setup ------------------------------------------------------
    stats_d = stats.damped(damp)
    sx, sxh, sxxh, sdx = stats_d.resolved()
    if l_chol is not None:
        assert l_chol.shape == sxh.shape, (l_chol.shape, sxh.shape)
        l = l_chol
    else:
        l = torch.linalg.cholesky(sxh)
    ldiag = torch.diagonal(l)
    target = w_live @ sxxh
    if sdx is not None:
        target = target + sdx  # (a, n) residual-stream correction, eq. (18)
    # Y = target · L⁻ᵀ  via a triangular solve  L Yᵀ = targetᵀ
    y = torch.linalg.solve_triangular(l, target.T, upper=False).T
    # c as a tensor: a true division, as the reference's (a Python number
    # over a tensor would be a reciprocal times c)
    c_t = torch.full((n,), c, dtype=dtype, device=w.device)
    if spacing == "uniform":
        log_gm = torch.mean(torch.log(torch.abs(ldiag)))
        alphas = c_t / torch.exp(log_gm)
    else:
        alphas = c_t / ldiag

    # -- Phase 2: ZSIC (+ LMMSE) ----------------------------------------------
    if lmmse:
        res = zsic_lmmse(y, l, alphas, lmmse=True)
    else:
        codes, resid = zsic_quantize(y, l, alphas)
        res = ZSICResult(codes=codes, residual=resid,
                         gammas=torch.ones((n,), dtype=dtype,
                                           device=w.device))

    # -- Phase 3: rate ---------------------------------------------------------
    h_bits = ent.empirical_entropy(res.codes)
    rate_eff = h_bits + 16.0 / a + 16.0 / n

    # -- Phase 4: rescalers -----------------------------------------------------
    gamma = res.gammas
    t = torch.ones((a,), dtype=dtype, device=w.device)
    if rescalers:
        w0_hat = res.codes.to(dtype) * alphas[None, :]
        sx0, sxh0, sxxh0, sdx0 = stats.resolved()  # undamped for the objective
        rr = find_optimal_rescalers(
            w0_hat, w_live, sx0, sxh0, sxxh0, sdx0,
            gamma_init=res.gammas, ridge=rescaler_ridge)
        t, gamma = rr.t, rr.gamma

    return QuantizedLinear(
        codes=res.codes.to(torch.int32),
        alphas=alphas,
        gamma=gamma,
        t=t,
        dead_mask=dead,
        c=float(c),
        entropy_bits=float(h_bits),
        rate_eff=float(rate_eff),
        out_features=a,
        in_features=n_full,
    )


def layer_distortion(w, q: QuantizedLinear, sigma_x) -> float:
    """D = (1/na)·tr((W−Ŵ)Σ_X(W−Ŵ)ᵀ) — eq. (1)."""
    err = w - q.dequant(w.dtype)
    a, n = err.shape
    return float(((err @ sigma_x.to(err.dtype)) * err).sum() / (a * n))


# ---------------------------------------------------------------------------
# Rate targeting (§4 "Rate assignment")
# ---------------------------------------------------------------------------


def quantize_at_rate(
    w: torch.Tensor,
    stats: CalibStats,
    target_bits: float,
    *,
    subsample_rows: float = 0.1,
    min_rows: int = 64,
    max_iters: int = 6,
    tol_bits: float = 0.005,
    seed: int = 0,
    **kwargs,
) -> QuantizedLinear:
    """Secant search on log₂(c) so the *entropy* hits ``target_bits``.

    Entropy is ≈ linear in log₂(c) with slope −1 (paper: "approximately
    linear with a slope close to unity"), so the first correction is a unit
    step and a secant refinement converges in 2–3 evaluations.  Search
    evaluations quantize a random row subsample with rescalers disabled
    (rescalers don't change the codes); the final call uses all rows.
    """
    a, n_full = w.shape
    rng = np.random.default_rng(seed)
    nsub = max(min(min_rows, a), int(round(a * subsample_rows)))
    rows = np.sort(rng.choice(a, size=min(nsub, a), replace=False))
    ridx = _index(rows, w)
    wsub = w[ridx, :]
    # Σ_{Δ,X̂} is (a, n): subsample the same rows for search evaluations
    stats_sub = stats
    if stats.sigma_delta_xhat is not None and len(rows) < a:
        stats_sub = CalibStats(
            sigma_x=stats.sigma_x, sigma_xhat=stats.sigma_xhat,
            sigma_x_xhat=stats.sigma_x_xhat,
            sigma_delta_xhat=stats.sigma_delta_xhat[ridx, :])

    # One Cholesky of the damped, dead-reduced Σ_X̂ (Phase 1's
    # reduce-then-damp order), shared by the initial guess, every secant
    # evaluation and the final full-rows call.
    dead = (_dead_features(stats.sigma_x, kwargs.get("dead_tau", 1e-3))
            if kwargs.get("erase_dead", True) else np.zeros(n_full, bool))
    keep = np.nonzero(~dead)[0]
    stats_red = stats.reduce(keep) if dead.any() else stats
    sxh_red = stats_red.damped(kwargs.get("damp", 1e-4)).resolved()[1]
    l_live = torch.linalg.cholesky(sxh_red)
    ldiag = torch.diagonal(l_live)

    def eval_entropy(log2c: float) -> float:
        q = watersic_quantize(wsub, stats_sub, 2.0 ** log2c,
                              **{**kwargs, "rescalers": False,
                                 "l_chol": l_live})
        return q.entropy_bits

    x0 = math.log2(initial_spacing(w[:, _index(keep, w)], ldiag,
                                   target_bits))
    f0 = eval_entropy(x0) - target_bits
    # slope ≈ −1 ⇒ first corrected point
    x1 = x0 + f0
    f1 = eval_entropy(x1) - target_bits
    it = 2
    while abs(f1) > tol_bits and it < max_iters:
        if abs(f1 - f0) < 1e-9:
            break
        x2 = x1 - f1 * (x1 - x0) / (f1 - f0)
        x0, f0 = x1, f1
        x1 = x2
        f1 = eval_entropy(x1) - target_bits
        it += 1
    return watersic_quantize(w, stats, 2.0 ** x1, l_chol=l_live, **kwargs)
