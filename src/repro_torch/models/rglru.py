"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427), port of
``repro/models/rglru.py``.

Block structure:
    x, y = split(W_in · u)                      (d_model → 2·lru_width)
    x    = temporal_conv1d(x, width=4)
    x    = RG-LRU(x)
    out  = W_out · (x ⊙ gelu(y))                (lru_width → d_model)

RG-LRU recurrence (gated, data-dependent decay):
    r_t = σ(W_a x_t + b_a)         recurrence gate
    i_t = σ(W_x x_t + b_x)         input gate
    log a_t = −c · softplus(Λ) ⊙ r_t          (c = 8)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The full-sequence forward solves h_t = a_t·h_{t−1} + b_t with a
log-depth doubling scan over time (the reference's
``jax.lax.associative_scan``; the sums meet in another order, so results
agree to f32 rounding); decode carries (h, conv state) explicitly.

Under an FSDP × TP layout (``dist.sharding.current_layout``) the
full-sequence forward runs tensor-parallel over the RG-LRU width: the
rank's ``w_in`` block gives [its x channels | its y channels]
(``models.fsdp_tp_layout`` reorders the columns), its conv taps, Λ and
gate columns are those channels', and ``w_out`` is row-parallel.  The
gates read the whole conv output, so it is gathered over ``model``
before them (one all-gather per layer; backward: the ranks' partial
grads summed, then this rank's channels).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as _sh
from .layers import _row_parallel, dense

__all__ = ["rglru_init", "rglru_axes", "rglru_train", "rglru_decode",
           "rglru_init_state", "RGLRUState", "RG_LRU_C", "rglru_lambda"]

RG_LRU_C = 8.0


class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, lru_width) recurrent state
    conv: torch.Tensor       # (B, conv_width-1, lru_width) conv lookback


def rglru_lambda(lru_width: int, device=None) -> torch.Tensor:
    """Λ such that the decay exp(−c·softplus(Λ)) spans [0.9, 0.999] (the
    paper's init): log(expm1(−log(linspace(0.9, 0.999)) / c)) in f32.
    Equal to the reference's to f32 rounding (the two linspaces and
    log/expm1 round differently), amplified near a = 0.999 where −log(a)
    is small: about 1e-5 relative."""
    lin = torch.linspace(0.9, 0.999, lru_width, dtype=torch.float32,
                         device=device)
    return torch.log(torch.expm1(-torch.log(lin) / RG_LRU_C))


def rglru_init(normal, d_model, lru_width, *, conv_width=4,
               dtype=torch.float32, stack: Optional[int] = None,
               device=None):
    """The reference's ``rglru_init`` tree, values from ``normal(shape,
    std)``: projections with std 1/sqrt(in), the gate biases 0, the conv
    taps with std 0.02, Λ from :func:`rglru_lambda` (deterministic)."""
    lead = () if stack is None else (stack,)

    def lin(n_in, n_out, bias=False):
        p = {"w": normal(lead + (n_in, n_out), n_in ** -0.5).to(dtype)}
        if bias:
            p["b"] = torch.zeros(lead + (n_out,), dtype=dtype, device=device)
        return p

    lam = rglru_lambda(lru_width, device).expand(lead + (lru_width,))
    return {
        "w_in": lin(d_model, 2 * lru_width),
        "w_out": lin(lru_width, d_model),
        "conv_w": normal(lead + (conv_width, lru_width), 0.02).to(dtype),
        "w_a": lin(lru_width, lru_width, bias=True),
        "w_x": lin(lru_width, lru_width, bias=True),
        "lam": lam.to(dtype).contiguous(),
    }


def rglru_axes(stacked: bool):
    """The logical axes of :func:`rglru_init`'s tree, layer-stacked or
    not (the reference's ``Px`` axes)."""
    lead = ("layers",) if stacked else ()

    def lin(a_in, a_out, bias=False):
        p = {"w": lead + (a_in, a_out)}
        if bias:
            p["b"] = lead + (a_out,)
        return p

    return {"w_in": lin("d_model_w", "state"),
            "w_out": lin("state", "d_model_w"),
            "conv_w": lead + (None, "state"),
            "w_a": lin("d_model_w", "state", bias=True),
            "w_x": lin("d_model_w", "state", bias=True),
            "lam": lead + ("state",)}


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(p, x, x_in=None):
    """(a, gated x) of the channels ``x``; the gates read ``x_in``
    (default ``x``; a tensor-parallel rank's whole conv output)."""
    x_in = x if x_in is None else x_in
    r = torch.sigmoid(dense(p["w_a"], x_in))
    i = torch.sigmoid(dense(p["w_x"], x_in))
    log_a = -RG_LRU_C * _softplus(p["lam"].to(torch.float32)) \
        * r.to(torch.float32)
    a = torch.exp(log_a)
    gated_x = (i * x).to(torch.float32) * torch.sqrt(
        torch.clamp_min(1.0 - torch.square(a), 1e-12))
    return a, gated_x


def _conv1d(x, w):
    """Causal depthwise temporal conv.  x (B,S,D); w (conv_width, D)."""
    cw = w.shape[0]
    s = x.shape[1]
    out = x * w[-1][None, None, :].to(x.dtype)
    for k in range(1, cw):
        shifted = F.pad(x, (0, 0, k, 0))[:, :s, :]
        out = out + shifted * w[-1 - k][None, None, :].to(x.dtype)
    return out


def _linear_scan(a, b):
    """h_t = a_t·h_{t−1} + b_t over axis 1 from h_{−1} = 0, by doubling:
    after the round at offset o every position holds the composition of
    the 2o steps ending there (log2(S) rounds)."""
    s = a.shape[1]
    off = 1
    while off < s:
        a_prev = F.pad(a, (0, 0, off, 0), value=1.0)[:, :s]
        b_prev = F.pad(b, (0, 0, off, 0))[:, :s]
        a, b = a_prev * a, b_prev * a + b
        off *= 2
    return b


def rglru_train(p, u, *, return_state=False):
    """Full-sequence recurrent block.  u: (B, S, d_model).

    ``return_state=True`` also returns RGLRUState(final h, conv lookback):
    the parallel prefill's."""
    lay = _sh.current_layout()
    if lay is not None:
        u = _sh.replicate_in(u, "model", mesh=lay.mesh)
    xy = dense(p["w_in"], u)
    x, y = torch.chunk(xy, 2, dim=-1)
    xc = _conv1d(x, p["conv_w"])
    whole = None if lay is None \
        else _sh.fsdp_gather(xc, ("model",), -1, mesh=lay.mesh)
    a, gx = _gates(p, xc, whole)
    h = _linear_scan(a, gx).to(u.dtype)
    hy = h * F.gelu(y, approximate="tanh")
    out = dense(p["w_out"], hy) if lay is None \
        else _row_parallel(p["w_out"], hy, lay)
    if return_state:
        cw = p["conv_w"].shape[0]
        conv_hist = x[:, -(cw - 1):, :]
        pad = cw - 1 - conv_hist.shape[1]
        if pad > 0:
            conv_hist = F.pad(conv_hist, (0, 0, pad, 0))
        return out, RGLRUState(h=h[:, -1, :], conv=conv_hist)
    return out


def rglru_decode(p, u_t, state: RGLRUState
                 ) -> Tuple[torch.Tensor, RGLRUState]:
    """Single-token step.  u_t: (B, 1, d_model)."""
    xy = dense(p["w_in"], u_t)
    x, y = torch.chunk(xy, 2, dim=-1)
    x = x[:, 0].to(state.conv.dtype)  # (B, lru)
    # conv with lookback state (most recent last)
    hist = torch.cat([state.conv, x[:, None, :]], dim=1)  # (B,cw,lru)
    taps = hist.to(u_t.dtype)
    w = p["conv_w"].to(u_t.dtype)
    xc = taps[:, 0] * w[0]              # the taps summed in order, row-wise
    for k in range(1, w.shape[0]):
        xc = xc + taps[:, k] * w[k]
    a, gx = _gates(p, xc[:, None, :])
    h = (a[:, 0] * state.h.to(torch.float32) + gx[:, 0]).to(u_t.dtype)
    out = dense(p["w_out"],
                (h * F.gelu(y[:, 0], approximate="tanh"))[:, None, :])
    return out, RGLRUState(h=h.to(state.h.dtype), conv=hist[:, 1:, :])


def rglru_init_state(batch, lru_width, conv_width=4, dtype=torch.float32,
                     device=None):
    return RGLRUState(
        h=torch.zeros((batch, lru_width), dtype=dtype, device=device),
        conv=torch.zeros((batch, conv_width - 1, lru_width), dtype=dtype,
                         device=device))
