"""WaterSIC (paper Alg. 3 with LMMSE shrinkage, Alg. 4 rescalers, §4
dead-feature erasure and rate search) in plain PyTorch, float64 by
default: a frozen copy of the algorithm, written from the paper, that the
PTQ cell judges the port by.

For an (a, n) weight W and input covariance Σ_X (no drift or residual
statistics: Σ_X̂ = Σ_{X,X̂} = Σ_X):

1. erase the dead inputs ([Σ]_ii < 1e-3 · median_j [Σ]_jj) and damp the
   live Σ by δ·mean(diag Σ)·I (Σ and Σ_{X,X̂} alike, App. C);
2. L = chol(Σ_damped), Y = W Σ_damped L⁻ᵀ, spacings α_i = c / ℓ_ii;
3. ZSIC from the last column to the first: z_i = round(Y_i / c),
   γ_i = z_iᵀY_i / (c ‖z_i‖²) (1 for an all-zero column), then
   Y_{:, ≤i} −= γ_i α_i z_i L_{i, ≤i};
4. rate H(Z) + 16/a + 16/n, H the empirical entropy of all codes;
5. rescalers T (rows, ‖t‖₁ = a) and Γ (columns) by alternating exact
   minimization of the output distortion under the undamped Σ;
6. c by a secant search on log₂ c hitting the target entropy within
   0.005 bits (at most 6 evaluations) on a 10 % row subsample (at least
   64 rows, ``numpy.random.default_rng(seed)``), starting from the
   high-rate guess c = sqrt(2πe σ_W²)·GM(ℓ)·2^(-R); the last c quantizes
   all rows.

``dtype`` float32 with ``tf32=True`` is the control: the same reference
one precision below what the port computes in.

Step 3 decides each code from the codes after it, so a perturbation in
one rounding decision changes many of the later ones: two sound runs in
float32 and float64 agree on only 93–98 % of the codes, and their output
distortions on 1e-4–1e-3.  ``follow`` therefore judges an answer step by
step from its own state: it takes the answer's c and codes, works out Y
again in float64 from W and Σ, and reads at every code how far Y/c lies
from it beyond the half step that rounding allows; it then fits the
rescalers again (step 5) to the answer's codes.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


def entropy_bits(codes: torch.Tensor) -> float:
    z = codes.detach().cpu().numpy().ravel().astype(np.int64)
    _, counts = np.unique(z, return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log2(p)).sum())


def _damped(s: torch.Tensor, damp: float) -> torch.Tensor:
    n = s.shape[0]
    return s + damp * torch.mean(torch.diagonal(s)) * torch.eye(
        n, dtype=s.dtype, device=s.device)


def zsic_lmmse(y: torch.Tensor, l: torch.Tensor, c: float):
    """Step 3: (codes (a, n) int64, γ (n,))."""
    a, n = y.shape
    yt = y.T.contiguous()                                    # (n, a)
    ldiag = torch.diagonal(l)
    alphas = torch.full((n,), c, dtype=y.dtype, device=y.device) / ldiag
    step = alphas * ldiag
    z = torch.zeros((n, a), dtype=torch.int64, device=y.device)
    g = torch.ones((n,), dtype=y.dtype, device=y.device)
    one = torch.ones((), dtype=y.dtype, device=y.device)
    for i in range(n - 1, -1, -1):
        col = yt[i]
        zi = torch.round(col / step[i])
        den = step[i] * torch.sum(zi * zi)
        gam = torch.where(den > 0, torch.sum(zi * col)
                          / torch.clamp(den, min=1e-300), one)
        g[i] = gam
        yt[:i + 1] -= (gam * alphas[i] * l[i, :i + 1])[:, None] * zi[None, :]
        z[i] = zi.long()
    return z.T.contiguous(), g, alphas


def rescalers(w0_hat, w, sigma, gamma, *, tol=1e-8, max_iters=50):
    """Step 5 (Alg. 4) under the undamped Σ: (t, γ)."""
    a, n = w0_hat.shape
    cross = w @ sigma
    eye = torch.eye(n, dtype=w.dtype, device=w.device)
    t = torch.ones((a,), dtype=w.dtype, device=w.device)
    const = ((w @ sigma) * w).sum()

    def loss(t, gamma):
        twg = t[:, None] * w0_hat * gamma[None, :]
        return (const - 2 * (cross * twg).sum()
                + ((twg @ sigma) * twg).sum()) / (a * n)

    prev = loss(t, gamma)
    for _ in range(max_iters):
        f = w0_hat.T @ (t[:, None] ** 2 * w0_hat)
        gmat = sigma * f
        d = ((t[:, None] * cross) * w0_hat).sum(dim=0)
        jitter = 1e-7 * torch.mean(torch.diagonal(gmat)) + 1e-30
        gamma = torch.cholesky_solve(
            d[:, None], torch.linalg.cholesky(gmat + jitter * eye))[:, 0]
        wg = w0_hat * gamma[None, :]
        p = ((cross * gamma[None, :]) * w0_hat).sum(dim=1)
        q = ((wg @ sigma) * wg).sum(dim=1)
        t = p / (q + 1e-7 * torch.mean(q) + 1e-30)
        s = torch.sum(torch.abs(t)) / a
        s = torch.where(s > 0, s, torch.ones_like(s))
        t, gamma = t / s, gamma * s
        cur = loss(t, gamma)
        done = abs(float(cur - prev)) / (abs(float(prev)) + 1e-12) < tol
        prev = cur
        if done:
            break
    return t, gamma


@contextlib.contextmanager
def _precision(tf32: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def quantize_at_rate(w, sigma, target_bits: float, *, damp: float,
                     seed: int, dtype=torch.float64, tf32: bool = False,
                     dead_tau: float = 1e-3):
    """Steps 1–6 for W (a, n) and Σ_X (n, n).  Returns a dict: codes
    (a, n_live), alphas, gamma, t, dead_mask (numpy), c, entropy_bits,
    rate_eff and distortion (the float64 output distortion of its own
    reconstruction under the full Σ_X)."""
    with _precision(tf32):
        return _quantize(w.to(dtype), sigma.to(dtype), target_bits, damp,
                         seed, dead_tau)


def _quantize(w, sigma, target_bits, damp, seed, dead_tau):
    a, n_full = w.shape
    diag = torch.diagonal(sigma).cpu().numpy()
    dead = diag < dead_tau * float(np.median(diag))
    keep = torch.as_tensor(np.nonzero(~dead)[0], device=w.device)
    s_live = sigma[keep][:, keep]
    w_live = w[:, keep]
    n = w_live.shape[1]
    s_damp = _damped(s_live, damp)
    l = torch.linalg.cholesky(s_damp)
    ldiag = torch.diagonal(l)

    def codes_at(rows, c):
        target = w_live[rows] @ s_damp
        y = torch.linalg.solve_triangular(l, target.T, upper=False).T
        return zsic_lmmse(y, l, c)

    nsub = max(min(64, a), int(round(a * 0.1)))
    sub = torch.as_tensor(np.sort(np.random.default_rng(seed).choice(
        a, size=min(nsub, a), replace=False)), device=w.device)

    def excess(log2c):
        return entropy_bits(codes_at(sub, 2.0 ** log2c)[0]) - target_bits

    sigma_w2 = float(torch.mean(w_live * w_live)) + 1e-30
    log_gm = float(torch.mean(torch.log(torch.abs(ldiag) + 1e-30)))
    c0 = max(math.sqrt(2 * math.pi * math.e * sigma_w2) * math.exp(log_gm)
             * 2.0 ** (-target_bits), 1e-12)
    x0 = math.log2(c0)
    f0 = excess(x0)
    x1 = x0 + f0
    f1 = excess(x1)
    it = 2
    while abs(f1) > 0.005 and it < 6 and abs(f1 - f0) >= 1e-9:
        x0, x1, f0 = x1, x1 - f1 * (x1 - x0) / (f1 - f0), f1
        f1 = excess(x1)
        it += 1
    c = 2.0 ** x1
    codes, gamma, alphas = codes_at(torch.arange(a, device=w.device), c)
    h = entropy_bits(codes)
    t, gamma = rescalers(codes.to(w.dtype) * alphas[None, :], w_live,
                         s_live, gamma)
    w_hat = torch.zeros((a, n_full), dtype=torch.float64, device=w.device)
    w_hat[:, keep] = (t.double()[:, None] * codes.double()
                      * (alphas.double() * gamma.double())[None, :])
    err = w.double() - w_hat
    dist = float(((err @ sigma.double()) * err).sum() / (a * n_full))
    return {"codes": codes, "alphas": alphas, "gamma": gamma, "t": t,
            "dead_mask": dead, "c": c, "entropy_bits": h,
            "rate_eff": h + 16.0 / a + 16.0 / n, "distortion": dist}


def follow(w, sigma, codes, c: float, dead_mask, *, damp: float,
           dead_tau: float = 1e-3):
    """Judge an answer (its codes on the live columns, c and dead mask)
    step by step in float64.  Returns the float64 steps' own results:
    ``rounding_excess`` (the largest |Y_i/c - z_i| - 1/2 over every code,
    Y cancelled by the answer's own earlier codes: at most rounding error
    for a sound answer, at least 1/2 for a code that is not the nearest),
    ``dead_differ`` (columns whose dead flag differs), ``entropy_bits`` of
    the codes, and ``distortion`` of the answer's codes with float64
    rescalers fitted to them (for comparison with the answer's own)."""
    w, sigma = w.double(), sigma.double()
    a, n_full = w.shape
    diag = torch.diagonal(sigma).cpu().numpy()
    dead = diag < dead_tau * float(np.median(diag))
    dead_differ = int((dead != np.asarray(dead_mask)).sum())
    if dead_differ:
        return {"rounding_excess": float("inf"), "dead_differ": dead_differ,
                "entropy_bits": entropy_bits(codes), "distortion": 0.0}
    keep = torch.as_tensor(np.nonzero(~dead)[0], device=w.device)
    s_live = sigma[keep][:, keep]
    w_live = w[:, keep]
    s_damp = _damped(s_live, damp)
    l = torch.linalg.cholesky(s_damp)
    y = torch.linalg.solve_triangular(l, (w_live @ s_damp).T, upper=False)
    n = y.shape[0]                                      # y is (n, a)
    zt = codes.T.to(torch.float64).contiguous()
    ldiag = torch.diagonal(l)
    alphas = torch.full((n,), c, dtype=torch.float64, device=w.device) / ldiag
    excess = torch.zeros((), dtype=torch.float64, device=w.device)
    g = torch.ones((n,), dtype=torch.float64, device=w.device)
    one = torch.ones((), dtype=torch.float64, device=w.device)
    for i in range(n - 1, -1, -1):
        col, zi = y[i], zt[i]
        excess = torch.maximum(excess, (col / c - zi).abs().max())
        den = c * torch.sum(zi * zi)
        gam = torch.where(den > 0, torch.sum(zi * col)
                          / torch.clamp(den, min=1e-300), one)
        g[i] = gam
        y[:i + 1] -= (gam * alphas[i] * l[i, :i + 1])[:, None] * zi[None, :]
    t, gamma = rescalers(zt.T * alphas[None, :], w_live, s_live, g)
    w_hat = torch.zeros_like(w)
    w_hat[:, keep] = t[:, None] * zt.T * (alphas * gamma)[None, :]
    err = w - w_hat
    return {"rounding_excess": float(excess) - 0.5, "dead_differ": 0,
            "entropy_bits": entropy_bits(codes),
            "distortion": float(((err @ sigma) * err).sum() / (a * n_full))}
