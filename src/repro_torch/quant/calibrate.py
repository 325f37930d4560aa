"""Calibration statistics for sequential model PTQ (paper §4, App. C; port
of the dense family of ``repro/quant/calibrate.py``).

Instrumented forward for the dense decoder family taps, per layer:

    x_attn   — input to wq/wk/wv (post ln_attn)
    ctx      — input to wo (pre-projection attention context)
    r_attn   — residual stream entering the attn block (the "R" of wo)
    x_mlp    — input to w_gate/w_up (post ln_mlp)
    hidden   — input to w_out (post-activation MLP hidden)
    r_mlp    — residual stream entering the MLP block (the "R" of w_out)
    attn_p   — per-key mean attention probability p_j  (eq. (19))

Running the same taps on the fp model (X, R) and the quantized-so-far model
(X̂, R̂) yields all covariances of eqs. (16)–(18):

    Σ_X = E[XXᵀ], Σ_X̂, Σ_{X,X̂} = E[XX̂ᵀ], Σ_{Δ,X̂} = W-free E[(R−R̂)X̂ᵀ]

The sums are float64, as in the reference, and stay on the device of the
taps.  The attention of the tapped forward is the plain masked softmax:
eq. (19) needs the probabilities, which the flash kernel never forms.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import CalibStats
from repro_torch.models.layers import (_ACTIVATIONS, _attn_scores,
                                       _split_heads, dense, embed, rope,
                                       unembed)
from repro_torch.models.transformer import (_attn_kwargs, _check_family,
                                            _norm, split_layers)

__all__ = ["forward_with_taps", "StatsAccumulator", "accumulate_stats",
           "stats_for_matrix"]


def forward_with_taps(cfg: ArchConfig, params, tokens
                      ) -> Tuple[torch.Tensor, List[Dict]]:
    """Layer-by-layer forward capturing per-layer tap tensors (dense
    family).  ``tokens`` (B, S) is an int array or tensor.  Returns
    (logits, taps list of dicts of tensors)."""
    _check_family(cfg)
    ak = _attn_kwargs(cfg)
    dev = params["embed"]["w"].device
    # the reference's tapped forward embeds without the gemma-style scale
    x = embed(params["embed"], torch.as_tensor(tokens, dtype=torch.long,
                                               device=dev))
    act = _ACTIVATIONS[cfg.activation]
    taps = []
    for lp in split_layers(params)["layers"]:
        t = {"r_attn": x}
        a_in = _norm(cfg, lp["ln_attn"], x)
        t["x_attn"] = a_in
        ctx, probs = _attention_with_probs(lp["attn"], a_in, **ak)
        t["ctx"] = ctx
        t["attn_p"] = probs
        x = x + dense(lp["attn"]["wo"], ctx)
        t["r_mlp"] = x
        m_in = _norm(cfg, lp["ln_mlp"], x)
        t["x_mlp"] = m_in
        if "w_gate" in lp["mlp"]:
            h = act(dense(lp["mlp"]["w_gate"], m_in)) \
                * dense(lp["mlp"]["w_up"], m_in)
        else:
            h = act(dense(lp["mlp"]["w_in"], m_in))
        t["hidden"] = h
        x = x + dense(lp["mlp"]["w_out"], h)
        taps.append(t)
    x = _norm(cfg, params["ln_f"], x)
    return unembed(params["embed"], x, cfg.vocab), taps


def _attention_with_probs(p, x, *, n_q, n_kv, head_dim, rope_theta):
    """Causal self-attention returning (pre-wo context, per-key mean
    attention mass)."""
    b, s, d = x.shape
    q = _split_heads(dense(p["wq"], x), n_q, head_dim)
    k = _split_heads(dense(p["wk"], x), n_kv, head_dim)
    v = _split_heads(dense(p["wv"], x), n_kv, head_dim)
    positions = torch.arange(s, device=x.device)[None, :]
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    scores = _attn_scores(q, k, 1.0 / math.sqrt(head_dim))
    i = torch.arange(s, device=x.device)[:, None]
    j = torch.arange(s, device=x.device)[None, :]
    scores = torch.where((j <= i)[None, None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores.to(torch.float32), dim=-1)
    out = torch.einsum("bngst,btnh->bsngh", probs.to(x.dtype), v)
    ctx = out.reshape(b, s, n_q * head_dim)
    # eq. (19): p_j = mean over heads/batch of attention into key j,
    # normalized by the (T - j) queries that can see it
    mass = probs.sum(dim=(0, 1, 2, 3))                      # (S,) over keys
    denom = (s - torch.arange(s, device=x.device)).to(torch.float32) \
        * b * n_q
    return ctx, mass / denom


# ---------------------------------------------------------------------------
# Covariance accumulation
# ---------------------------------------------------------------------------


class StatsAccumulator:
    """Accumulates Σ_X / Σ_X̂ / Σ_{X,X̂} / Σ_{Δ,X̂} (+ attention-weighted
    variants) across calibration batches for every (layer, tap), as
    float64 sums on the taps' device."""

    def __init__(self):
        self.sums: Dict[str, torch.Tensor] = {}
        self.counts: Dict[str, float] = {}

    def add(self, key: str, a, b=None, weights: Optional[torch.Tensor] = None):
        a = a.to(torch.float64)
        aw = a if weights is None else a * weights[:, None]
        other = a if b is None else b.to(torch.float64)
        m = aw.T @ other
        n = float(weights.sum()) if weights is not None else a.shape[0]
        if key not in self.sums:
            self.sums[key] = m
            self.counts[key] = n
        else:
            self.sums[key] += m
            self.counts[key] += n

    def get(self, key: str) -> torch.Tensor:
        return self.sums[key] / max(self.counts[key], 1e-9)

    def has(self, key: str) -> bool:
        return key in self.sums


def _flat(x) -> torch.Tensor:
    x = x.to(torch.float64)
    return x.reshape(-1, x.shape[-1])


def accumulate_stats(acc: StatsAccumulator, layer: int,
                     taps_fp: Dict, taps_q: Dict) -> None:
    """Update all covariance sums for one calibration batch at one layer."""
    pw = taps_fp["attn_p"].to(torch.float64)                # (S,)
    pw_tokens = pw.repeat(taps_fp["x_attn"].shape[0])
    for name in ("x_attn", "ctx", "x_mlp", "hidden"):
        x = _flat(taps_fp[name])
        xh = _flat(taps_q[name])
        acc.add(f"L{layer}/{name}/xx", x)
        acc.add(f"L{layer}/{name}/hh", xh)
        acc.add(f"L{layer}/{name}/xh", x, xh)
        if name == "x_attn":  # attention-weighted variants (QKV only)
            acc.add(f"L{layer}/{name}/xx_w", x, weights=pw_tokens)
            acc.add(f"L{layer}/{name}/hh_w", xh, weights=pw_tokens)
            acc.add(f"L{layer}/{name}/xh_w", x, xh, weights=pw_tokens)
    # residual-stream deltas for the two down-projections (eq. (18))
    for name, rname in (("ctx", "r_attn"), ("hidden", "r_mlp")):
        dr = _flat(taps_fp[rname]) - _flat(taps_q[rname])
        acc.add(f"L{layer}/{name}/dr_h", dr, _flat(taps_q[name]))


def stats_for_matrix(acc: StatsAccumulator, layer: int, tap: str, *,
                     use_drift=True, use_residual=False,
                     eps_qr: float = 0.0, eps_aw: float = 1.0,
                     weighted_available=False) -> CalibStats:
    """Assemble f32 CalibStats with adaptive mixing (eqs. (58)-(59)).

    eps_qr → 1 falls back to unquantized statistics; eps_aw → 1 disables
    attention weighting.  Σ_{Δ,X̂} enters as the Wᵀ-free cross term dr_h
    (d_resid × n; here a == d_resid).
    """
    def mix(suffix):
        base = acc.get(f"L{layer}/{tap}/{suffix}")
        if weighted_available and acc.has(f"L{layer}/{tap}/{suffix}_w"):
            w = acc.get(f"L{layer}/{tap}/{suffix}_w")
            return (1 - eps_aw) * w + eps_aw * base
        return base

    def f32(m):
        return m.to(torch.float32)

    sx = mix("xx")
    if not use_drift:
        return CalibStats(sigma_x=f32(sx))
    shh = mix("hh")
    sxh = mix("xh")
    # eq. (58): interpolate drift-corrected ↔ original statistics
    shh = (1 - eps_qr) * shh + eps_qr * sx
    sxh = (1 - eps_qr) * sxh + eps_qr * sx
    sdx = None
    if use_residual and acc.has(f"L{layer}/{tap}/dr_h"):
        sdx = f32(acc.get(f"L{layer}/{tap}/dr_h"))
    return CalibStats(sigma_x=f32(sx), sigma_xhat=f32(shh),
                      sigma_x_xhat=f32(sxh), sigma_delta_xhat=sdx)
