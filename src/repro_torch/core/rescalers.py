"""Diagonal row/column rescaler optimization (paper Alg. 4, §4; port of
``repro/core/rescalers.py``).

After ZSIC produces Ŵ₀ = Z·diag(α), the final reconstruction is searched in
the form Ŵ = T·Ŵ₀·Γ with diagonal T (rows / out-channels, tr T = a) and Γ
(columns / in-channels).  Alternating exact coordinate minimization of

  J(T,Γ) = (1/an) tr( W Σ_X Wᵀ − 2 (W Σ_{X,X̂} + Σ_{Δ,X̂}) (T Ŵ₀ Γ)ᵀ
                      + T Ŵ₀ Γ Σ_X̂ Γ Ŵ₀ᵀ T )

  Γ-step:  γ = (G + λI)⁻¹ d,  G = Σ_X̂ ⊙ (Ŵ₀ᵀ diag(t²) Ŵ₀)   (PSD by Schur)
           d = diag( Ŵ₀ᵀ diag(t) (W Σ_{X,X̂} + Σ_{Δ,X̂}) )
  T-step:  t_i = p_i / (q_i + λ),
           p = diag( (W Σ_{X,X̂} + Σ_{Δ,X̂}) diag(γ) Ŵ₀ᵀ ),
           q = diag( Ŵ₀ diag(γ) Σ_X̂ diag(γ) Ŵ₀ᵀ )

with renormalization ‖t‖₁ = a after each round (scale invariance).  The
reference's ``solve(assume_a="pos")`` is a Cholesky solve here; diagonals
of products are row sums of elementwise products (no (n, n) product is
formed for d or p).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["RescalerResult", "rescaler_loss", "find_optimal_rescalers"]


class RescalerResult(NamedTuple):
    t: torch.Tensor        # (a,) row rescalers, ‖t‖₁ = a
    gamma: torch.Tensor    # (n,) column rescalers
    loss: torch.Tensor     # final J value
    iters: int


def _quad_rows(x, sigma):
    """diag(x Σ xᵀ) — one value per row of x."""
    return ((x @ sigma) * x).sum(dim=1)


def rescaler_loss(t, gamma, w0_hat, w, sigma_x, sigma_xhat, cross):
    """J(T,Γ) as defined above; ``cross`` = W Σ_{X,X̂} + Σ_{Δ,X̂} (a×n)."""
    a, n = w0_hat.shape
    twg = t[:, None] * (w0_hat * gamma[None, :])
    term_const = _quad_rows(w, sigma_x).sum()
    term_cross = (cross * twg).sum()
    term_quad = _quad_rows(twg, sigma_xhat).sum()
    return (term_const - 2.0 * term_cross + term_quad) / (a * n)


def find_optimal_rescalers(
    w0_hat: torch.Tensor,
    w: torch.Tensor,
    sigma_x: torch.Tensor,
    sigma_xhat: Optional[torch.Tensor] = None,
    sigma_x_xhat: Optional[torch.Tensor] = None,
    sigma_delta_xhat: Optional[torch.Tensor] = None,
    *,
    gamma_init: Optional[torch.Tensor] = None,
    ridge: float = 0.0,
    tol: float = 1e-8,
    max_iters: int = 50,
) -> RescalerResult:
    """Alg. 4.  Missing statistics default per Alg. 3: Σ_X̂ ← Σ_X,
    Σ_{X,X̂} ← Σ_X, Σ_{Δ,X̂} ← 0."""
    a, n = w0_hat.shape
    dtype, dev = w0_hat.dtype, w0_hat.device
    if sigma_xhat is None:
        sigma_xhat = sigma_x
    if sigma_x_xhat is None:
        sigma_x_xhat = sigma_x
    cross = w @ sigma_x_xhat
    if sigma_delta_xhat is not None:
        cross = cross + sigma_delta_xhat
    eye = torch.eye(n, dtype=dtype, device=dev)

    t = torch.ones((a,), dtype=dtype, device=dev)
    gamma = (torch.ones((n,), dtype=dtype, device=dev) if gamma_init is None
             else torch.as_tensor(gamma_init, dtype=dtype, device=dev))
    # normalize ‖t‖₁ = a (push scale into γ)
    s = torch.sum(torch.abs(t)) / a
    t, gamma = t / s, gamma * s

    loss_prev = rescaler_loss(t, gamma, w0_hat, w, sigma_x, sigma_xhat, cross)
    iters = 0
    for it in range(max_iters):
        # -- Γ-step ---------------------------------------------------------
        f = w0_hat.T @ (t[:, None] ** 2 * w0_hat)          # (n, n)
        g = sigma_xhat * f                                  # Hadamard
        d = ((t[:, None] * cross) * w0_hat).sum(dim=0)      # (n,)
        # relative jitter guards all-zero code columns (singular G) at low
        # rate; γ for such columns is irrelevant (they contribute nothing)
        jitter = ridge + 1e-7 * torch.mean(torch.diagonal(g)) + 1e-30
        chol = torch.linalg.cholesky(g + jitter * eye)
        gamma = torch.cholesky_solve(d[:, None], chol)[:, 0]
        # -- T-step ----------------------------------------------------------
        wg = w0_hat * gamma[None, :]
        p = ((cross * gamma[None, :]) * w0_hat).sum(dim=1)
        q = _quad_rows(wg, sigma_xhat)
        t = p / (q + ridge + 1e-7 * torch.mean(q) + 1e-30)
        # -- renormalize & converge ------------------------------------------
        s = torch.sum(torch.abs(t)) / a
        s = torch.where(s > 0, s, torch.ones_like(s))
        t, gamma = t / s, gamma * s
        loss = rescaler_loss(t, gamma, w0_hat, w, sigma_x, sigma_xhat, cross)
        iters = it + 1
        if abs(float(loss - loss_prev)) / (abs(float(loss_prev)) + 1e-12) \
                < tol:
            loss_prev = loss
            break
        loss_prev = loss
    return RescalerResult(t=t, gamma=gamma, loss=loss_prev, iters=iters)
