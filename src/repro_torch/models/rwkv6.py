"""RWKV6 "Finch" blocks (arXiv:2404.05892), port of
``repro/models/rwkv6.py``: attention-free, with data-dependent decay.

Time mixing (per layer):
    Δ_t = x_{t−1} − x_t   (token shift)
    ξ_t = x_t + Δ_t ⊙ μ_ξ          for ξ ∈ {r, k, v, w, g}
    r, k, v = W_r ξ_r, W_k ξ_k, W_v ξ_v     (reshaped to H heads × 64)
    g = silu(W_g ξ_g)
    w_t = exp(−exp(w0 + tanh(ξ_w A) B))      data-dependent decay (LoRA)
    per head:  out_t = rᵀ_t (S_{t−1} + (u ⊙ k_t) v_tᵀ)
               S_t   = diag(w_t) S_{t−1} + k_t v_tᵀ
    y = W_o (norm_head(out) ⊙ g)

Channel mixing:
    k = relu(W_k ξ_k)²;  y = σ(W_r ξ_r) ⊙ (k W_v)

Every projection is ``layers.dense``, so a quantized leaf runs the
dequant kernels.  The WKV recurrence of the full-sequence forward is a
Python loop over time on an f32 state (B, H, dk, dv) (the reference's
``lax.scan``); decode carries (shift states, S) explicitly.

Under an FSDP × TP layout (``dist.sharding.current_layout``) the
full-sequence forwards run tensor-parallel over the WKV heads: the time
mix's r, k, v, g and decay (``decay_b``) products are column-parallel
and ``u`` is this rank's heads, so the WKV loop steps only those; ``w_o``
is row-parallel.  The channel mix's ``w_k`` is column-parallel over
``ff`` and ``w_v`` row-parallel.  The input and the replicated leaves
that the rank uses in part (the mix coefficients, ``decay_a``, ``w0`` of
which it takes its heads' channels, ``ln_out``) enter through
``replicate_in``, whose backward sums the ranks' partial grads; the
channel mix's gate ``σ(W_r ξ_r)``, replicated and used whole, is
computed outside that region, so its grads are whole on every rank.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as _sh
from .layers import _row_parallel, dense, rmsnorm

__all__ = ["rwkv6_init", "rwkv6_axes", "rwkv_time_mix_train",
           "rwkv_time_mix_decode", "rwkv_channel_mix_train",
           "rwkv_channel_mix_decode", "RWKVState"]


class RWKVState(NamedTuple):
    tm_shift: torch.Tensor   # (B, d) last input of time-mix
    cm_shift: torch.Tensor   # (B, d) last input of channel-mix
    wkv: torch.Tensor        # (B, H, dk, dv) recurrent state, f32


def rwkv6_init(normal, d_model, d_ff, *, head_dim=64, decay_lora=64,
               dtype=torch.float32, stack: Optional[int] = None,
               device=None):
    """The reference's ``rwkv6_init`` tree, values from ``normal(shape,
    std)`` (the caller's seeded generator): projections with std
    1/sqrt(in), the mix coefficients and ``u`` with std 0.02, ``w0`` at
    −2 (base decay e^{−e^{−2}}), ``ln_out`` scales 1."""
    n_heads = d_model // head_dim
    lead = () if stack is None else (stack,)

    def lin(n_in, n_out):
        return {"w": normal(lead + (n_in, n_out), n_in ** -0.5).to(dtype)}

    def vec(shape, init=None):
        if init is None:
            return normal(lead + shape, 0.02).to(dtype)
        return torch.full(lead + shape, init, dtype=dtype, device=device)

    tm = {
        "mu": vec((5, d_model)),                   # r,k,v,w,g mix coefs
        "w_r": lin(d_model, d_model), "w_k": lin(d_model, d_model),
        "w_v": lin(d_model, d_model), "w_g": lin(d_model, d_model),
        "w_o": lin(d_model, d_model),
        "decay_a": lin(d_model, decay_lora),
        "decay_b": lin(decay_lora, d_model),
        "w0": vec((d_model,), -2.0),
        "u": vec((n_heads, head_dim)),
        "ln_out": {"scale": torch.ones(lead + (head_dim,),
                                       dtype=torch.float32, device=device)},
    }
    cm = {"mu": vec((2, d_model)), "w_k": lin(d_model, d_ff),
          "w_v": lin(d_ff, d_model), "w_r": lin(d_model, d_model)}
    return {"tm": tm, "cm": cm}


def rwkv6_axes():
    """The logical axes of :func:`rwkv6_init`'s layer-stacked tree (the
    reference's ``Px`` axes)."""
    def lin(a_in, a_out):
        return {"w": ("layers", a_in, a_out)}

    tm = {"mu": ("layers", None, None),
          "w_r": lin("d_model_w", "heads"), "w_k": lin("d_model_w", "heads"),
          "w_v": lin("d_model_w", "heads"), "w_g": lin("d_model_w", "heads"),
          "w_o": lin("heads", "d_model_w"),
          "decay_a": lin("d_model_w", None), "decay_b": lin(None, "heads"),
          "w0": ("layers", None), "u": ("layers", "state", None),
          "ln_out": {"scale": ("layers", None)}}
    cm = {"mu": ("layers", None, None), "w_k": lin("d_model_w", "ff"),
          "w_v": lin("ff", "d_model_w"), "w_r": lin("d_model_w", None)}
    return {"tm": tm, "cm": cm}


def _token_shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1, :]


def _mix(x, x_prev, mu):
    return x + (x_prev - x) * mu.to(x.dtype)


def _decay(p, xw, w0=None):
    """The decay ∈ (0, 1) of ``xw``'s channels; ``w0`` defaults to the
    leaf (a tensor-parallel rank passes its heads' channels of it)."""
    lora = torch.tanh(dense(p["decay_a"], xw))
    w0 = p["w0"] if w0 is None else w0
    wlog = w0.to(torch.float32) \
        + dense(p["decay_b"], lora).to(torch.float32)
    return torch.exp(-torch.exp(wlog))  # (…, d) ∈ (0, 1)


def _tp_time_mix(p, x, lay):
    """(p, x, w0) of a tensor-parallel rank's time mix: ``x`` and the
    replicated leaves it uses in part through ``replicate_in``, ``w0``
    cut to this rank's heads' channels."""
    mesh = lay.mesh
    rep = {k: _sh.replicate_in(p[k], "model", mesh=mesh)
           for k in ("mu", "w0")}
    p = {**p, "mu": rep["mu"],
         "decay_a": {"w": _sh.replicate_in(p["decay_a"]["w"], "model",
                                           mesh=mesh)},
         "ln_out": {"scale": _sh.replicate_in(p["ln_out"]["scale"],
                                              "model", mesh=mesh)}}
    n = x.shape[-1] // lay.tp
    w0 = rep["w0"].narrow(-1, mesh.axis_index("model") * n, n)
    return p, _sh.replicate_in(x, "model", mesh=mesh), w0


def _wkv_out(r, k, v, state, u):
    """One WKV step on f32 (B, H, dk/dv) rows: (out (B, H, dv), kv).  The
    contraction over dk is an elementwise product and a sum, so each row's
    bits do not depend on the batch it is stepped in."""
    kv = k[..., :, None] * v[..., None, :]
    out = (r[..., :, None] * (state + u[None, :, :, None] * kv)).sum(-2)
    return out, kv


def rwkv_time_mix_train(p, x, *, head_dim=64, return_state=False):
    """x: (B, S, d) → (B, S, d); a loop over time for the WKV recurrence.

    ``return_state=True`` also returns the final WKV state (the parallel
    prefill's)."""
    lay = _sh.current_layout()
    w0 = None
    if lay is not None:
        p, x, w0 = _tp_time_mix(p, x, lay)
    b, s, d = x.shape
    if lay is not None:
        d //= lay.tp                      # this rank's heads' channels
    h = d // head_dim
    xp = _token_shift(x)
    mu = p["mu"]
    xr, xk, xv, xw, xg = (_mix(x, xp, mu[i]) for i in range(5))
    r = dense(p["w_r"], xr).reshape(b, s, h, head_dim).to(torch.float32)
    k = dense(p["w_k"], xk).reshape(b, s, h, head_dim).to(torch.float32)
    v = dense(p["w_v"], xv).reshape(b, s, h, head_dim).to(torch.float32)
    g = F.silu(dense(p["w_g"], xg))
    w = _decay(p, xw, w0).reshape(b, s, h, head_dim)      # f32
    u = p["u"].to(torch.float32)
    state = torch.zeros((b, h, head_dim, head_dim), dtype=torch.float32,
                        device=x.device)
    outs = []
    # one view per step (``unbind``: its backward stacks the steps' grads
    # once, where S indexings would each add a zero-padded full-length
    # grad, S² in all)
    steps = zip(*(a.unbind(1) for a in (r, k, v, w)))
    for r_t, k_t, v_t, w_t in steps:
        out_t, kv = _wkv_out(r_t, k_t, v_t, state, u)
        state = w_t[..., None] * state + kv
        outs.append(out_t)
    out = torch.stack(outs, dim=1)                         # (B,S,H,dv)
    out = rmsnorm(p["ln_out"], out.to(x.dtype))
    out = out.reshape(b, s, d) * g
    y = dense(p["w_o"], out) if lay is None \
        else _row_parallel(p["w_o"], out, lay)
    if return_state:
        return y, state
    return y


def rwkv_time_mix_decode(p, x_t, tm_shift, wkv, *, head_dim=64):
    """x_t: (B, 1, d).  Returns (out, new_shift, new_wkv)."""
    b, _, d = x_t.shape
    h = d // head_dim
    x = x_t[:, 0]
    mu = p["mu"]
    xr, xk, xv, xw, xg = (x + (tm_shift - x) * mu[i].to(x.dtype)
                          for i in range(5))
    r = dense(p["w_r"], xr).reshape(b, h, head_dim).to(torch.float32)
    k = dense(p["w_k"], xk).reshape(b, h, head_dim).to(torch.float32)
    v = dense(p["w_v"], xv).reshape(b, h, head_dim).to(torch.float32)
    g = F.silu(dense(p["w_g"], xg))
    w = _decay(p, xw).reshape(b, h, head_dim)
    u = p["u"].to(torch.float32)
    out, kv = _wkv_out(r, k, v, wkv, u)
    new_wkv = w[..., None] * wkv + kv
    out = rmsnorm(p["ln_out"], out.to(x.dtype).reshape(b, 1, h, head_dim))
    out = out.reshape(b, 1, d) * g[:, None, :]
    return (dense(p["w_o"], out), x.to(tm_shift.dtype),
            new_wkv.to(wkv.dtype))


def rwkv_channel_mix_train(p, x):
    xp = _token_shift(x)
    mu = p["mu"]
    xr = _mix(x, xp, mu[1])
    gate = torch.sigmoid(dense(p["w_r"], xr))
    lay = _sh.current_layout()
    if lay is not None:
        x = _sh.replicate_in(x, "model", mesh=lay.mesh)
        mu = _sh.replicate_in(mu, "model", mesh=lay.mesh)
        xp = _token_shift(x)
    xk = _mix(x, xp, mu[0])
    k = torch.square(F.relu(dense(p["w_k"], xk)))
    if lay is not None:
        return gate * _row_parallel(p["w_v"], k, lay)
    return gate * dense(p["w_v"], k)


def rwkv_channel_mix_decode(p, x_t, cm_shift):
    x = x_t[:, 0]
    mu = p["mu"]
    xk = x + (cm_shift - x) * mu[0].to(x.dtype)
    xr = x + (cm_shift - x) * mu[1].to(x.dtype)
    k = torch.square(F.relu(dense(p["w_k"], xk[:, None, :])))
    out = torch.sigmoid(dense(p["w_r"], xr[:, None, :])) * dense(p["w_v"], k)
    return out, x.to(cm_shift.dtype)
