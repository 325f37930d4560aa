"""Sequential model PTQ pipeline (paper §4 + App. C/D; port of the dense
family of ``repro/quant/pipeline.py``).

Quantizes a dense-family LM layer by layer:

  for each layer l (first → last):
    1. run fp and quantized-so-far models over the calibration batches,
       accumulating Σ_X, Σ_X̂, Σ_{X,X̂}, Σ_{Δ,X̂} (+ attention-weighted)
    2. (optional) adaptive mixing: golden-section search over ε_qr then
       ε_aw minimizing the relative MSE at the wo input (eq. (60)),
       re-quantizing (wq, wk, wv) jointly per evaluation
    3. quantize the 7 block matrices at the global budget's per-layer
       target rate (secant-matched), with LMMSE + rescalers
    4. write dequantized weights back into the running quantized model

Methods: "watersic" (full), "watersic-plain" (no LMMSE/rescalers/drift),
"hptq" (uniform lattice + entropy = Huffman-GPTQ), "rtn" (per-row absmax).
Without LMMSE ("watersic-plain", "hptq") the ZSIC runs in its blocked form
through the in-block kernel on the card.

Rate allocation is the even-spread ``RateBudget``, or with ``plan=`` the
per-matrix targets of a ``repro_torch.plan.QuantPlan`` (``PlanBudget``,
achieved bits written back into the plan).  MoE models wait for their
family (ROADMAP queue A item 12).  Everything runs on the device of
``params``.

Returns (quantized params, per-matrix QuantizedLinear dict, budget
controller, report rows); ``from_watersic`` turns entries into serving
leaves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import (CalibStats, PlanBudget, QuantizedLinear,
                              RateBudget, quantize_at_rate, rtn_absmax)
from repro_torch.models.transformer import (_attn_kwargs, _check_family,
                                            loss_fn)
from .calibrate import (StatsAccumulator, _attention_with_probs,
                        accumulate_stats, forward_with_taps,
                        stats_for_matrix)

__all__ = ["PTQConfig", "quantize_model", "model_ppl", "matrix_tap_map"]

_BLOCK_MATS = [  # (param path inside layer, tap key, is down-projection)
    (("attn", "wq"), "x_attn", False),
    (("attn", "wk"), "x_attn", False),
    (("attn", "wv"), "x_attn", False),
    (("attn", "wo"), "ctx", True),
    (("mlp", "w_gate"), "x_mlp", False),
    (("mlp", "w_up"), "x_mlp", False),
    (("mlp", "w_out"), "hidden", True),
]


@dataclasses.dataclass
class PTQConfig:
    target_bits: float = 3.0
    method: str = "watersic"          # watersic | watersic-plain | hptq | rtn
    use_drift: bool = True
    use_residual: bool = True
    attention_weighting: bool = False
    adaptive_mix: bool = False
    golden_iters: int = 6
    # model-PTQ damping is deliberately much heavier than the core theory
    # path's 1e-4 default: Σ here are SAMPLE covariances from a handful of
    # calibration batches, and the drift/LMMSE cross terms overfit small
    # samples (layer-to-layer error compounding) without a strong ridge
    damp: float = 0.05
    hptq_damp: float = 0.1            # GPTQ default damping (paper App. D)
    seed: int = 0


def _layer_count(params) -> int:
    return params["layers"]["attn"]["wq"]["w"].shape[0]


def _leaf(params, path):
    node = params["layers"]
    for k in path:
        node = node[k]
    return node


def _get_w(params, l, path):
    return _leaf(params, path)["w"][l]


def _set_w(params, l, path, w_new):
    w = _leaf(params, path)["w"]
    w[l] = w_new.to(w.dtype)


def _mats_for(cfg, params):
    mats = list(_BLOCK_MATS)
    if "w_gate" not in params["layers"]["mlp"]:
        mats = [m for m in mats if m[0][1] not in ("w_gate", "w_up")]
        mats.append((("mlp", "w_in"), "x_mlp", False))
        # keep w_out last (depends on hidden tap)
        mats.sort(key=lambda m: m[0][1] == "w_out")
    return mats


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def matrix_tap_map(cfg, params) -> List[Dict]:
    """Public matrix ↔ activation-tap vocabulary for one model: one record
    per (layer, block matrix) with the budget ``name`` ("L{l}/attn/wq"),
    the param ``path`` inside a layer, the calibration ``tap`` feeding it,
    the ``sigma_key`` of its Σ_X in a StatsAccumulator and whether it is a
    down-projection."""
    out: List[Dict] = []
    for l in range(_layer_count(params)):
        for path, tap, is_down in _mats_for(cfg, params):
            out.append({"name": f"L{l}/{'/'.join(path)}", "layer": l,
                        "path": path, "tap": tap,
                        "sigma_key": f"L{l}/{tap}/xx", "down": is_down})
    return out


def _quantize_matrix(ptq: PTQConfig, w_alg, stats: CalibStats, target: float
                     ) -> QuantizedLinear:
    if ptq.method == "watersic":
        return quantize_at_rate(w_alg, stats, target, damp=ptq.damp,
                                seed=ptq.seed)
    if ptq.method == "watersic-plain":
        return quantize_at_rate(w_alg, stats, target, damp=ptq.damp,
                                lmmse=False, rescalers=False, seed=ptq.seed)
    if ptq.method == "hptq":
        return quantize_at_rate(w_alg, stats, target, damp=ptq.hptq_damp,
                                lmmse=False, rescalers=False,
                                spacing="uniform", erase_dead=False,
                                seed=ptq.seed)
    raise ValueError(ptq.method)


def _rtn_matrix(w_alg, target_bits: float) -> Tuple[np.ndarray, float]:
    bits = max(int(round(target_bits)), 2)
    out = rtn_absmax(w_alg.detach().cpu().numpy(), bits)
    return out["w_hat"], float(bits)


def quantize_model(cfg: ArchConfig, params, calib_batches: List[np.ndarray],
                   ptq: PTQConfig, plan=None):
    """Sequential PTQ of a dense-family model on the device of ``params``.
    calib_batches: token arrays (B, S).  Returns (qparams, qlinears,
    budget, rows).

    ``plan``: an optional ``repro_torch.plan.QuantPlan`` — per-matrix
    targets come from the plan instead of the even spread, and achieved
    bits are written back into its entries.  It must cover every budget
    key of this model ("L0/attn/wq", ...)."""
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE PTQ belongs to the MoE family's slice "
            "(ROADMAP queue A item 12)")
    _check_family(cfg)
    L = _layer_count(params)
    qparams = _clone(params)
    mats = _mats_for(cfg, params)
    layer_params = {f"L{l}/{'/'.join(path)}":
                    int(np.prod(_get_w(params, l, path).shape))
                    for l in range(L) for path, _, _ in mats}
    if plan is not None:
        missing = sorted(set(layer_params) - set(plan.names()))
        if missing:
            raise KeyError(f"plan is missing entries for {missing[:5]}"
                           f"{'...' if len(missing) > 5 else ''}")
        budget = PlanBudget(plan)
    else:
        budget = RateBudget(ptq.target_bits, layer_params)
    qlinears: Dict[str, QuantizedLinear] = {}
    rows = []

    for l in range(L):
        acc = StatsAccumulator()
        taps_q_cache = []
        for tokens in calib_batches:
            _, taps_fp = forward_with_taps(cfg, params, tokens)
            _, taps_q = forward_with_taps(cfg, qparams, tokens)
            accumulate_stats(acc, l, taps_fp[l], taps_q[l])
            taps_q_cache.append((taps_fp[l], taps_q[l]))

        eps_qr, eps_aw = 0.0, 1.0
        if ptq.adaptive_mix and ptq.method.startswith("watersic"):
            eps_qr, eps_aw = _optimize_mixing(cfg, params, l, acc,
                                              taps_q_cache, budget, ptq)
        for path, tap, is_down in mats:
            name = f"L{l}/{'/'.join(path)}"
            w_alg = _get_w(params, l, path).T    # algorithm layout (out, in)
            target = budget.next_target(name)
            if ptq.method == "rtn":
                w_hat, rate = _rtn_matrix(w_alg, target)
                budget.record(name, rate)
                _set_w(qparams, l, path, torch.as_tensor(w_hat).T)
                continue
            is_qkv = path[-1] in ("wq", "wk", "wv")
            stats = stats_for_matrix(
                acc, l, tap,
                use_drift=ptq.use_drift and ptq.method != "hptq",
                use_residual=ptq.use_residual and is_down
                and ptq.method.startswith("watersic"),
                eps_qr=eps_qr if is_qkv else 0.0,
                eps_aw=eps_aw if is_qkv else 1.0,
                weighted_available=ptq.attention_weighting and is_qkv)
            if ptq.method == "hptq":
                # HPTQ uses the quantized-model Hessian Σ_X̂ (paper App. D)
                stats = CalibStats(sigma_x=stats.sigma_xhat
                                   if stats.sigma_xhat is not None
                                   else stats.sigma_x)
            q = _quantize_matrix(ptq, w_alg, stats, target)
            # budget in entropy bits (the paper's rate convention); the
            # 16/a + 16/n side-info overhead is reported via rate_eff
            budget.record(name, q.entropy_bits)
            qlinears[name] = q
            _set_w(qparams, l, path, q.dequant().T)
            rows.append({"layer": l, "matrix": "/".join(path),
                         "rate": q.rate_eff, "entropy": q.entropy_bits,
                         "dead": int(q.dead_mask.sum())})
    return qparams, qlinears, budget, rows


# ---------------------------------------------------------------------------
# Adaptive mixing (golden-section, eq. (60))
# ---------------------------------------------------------------------------


def _attn_rel_mse(cfg, params, l, qkv_weights, taps_pairs):
    """Relative MSE at the wo input: Attn(X̂; ŵ) vs Attn(X; w)  (eq. 60)."""
    attn = {k: {kk: vv[l] for kk, vv in v.items()}
            for k, v in params["layers"]["attn"].items()}
    for k, wnew in qkv_weights.items():
        attn[k] = {**attn[k], "w": wnew}
    num = den = 0.0
    for taps_fp, taps_q in taps_pairs:
        ctx_fp = taps_fp["ctx"].to(torch.float64)
        ctx_hat, _ = _attention_with_probs(attn, taps_q["x_attn"],
                                           **_attn_kwargs(cfg))
        diff = ctx_hat.to(torch.float64) - ctx_fp
        num += float((diff ** 2).sum())
        den += float((ctx_fp ** 2).sum())
    return num / max(den, 1e-12)


def _quantize_qkv(params, l, acc, budget, ptq, eps_qr, eps_aw):
    out = {}
    for key in ("wq", "wk", "wv"):
        stats = stats_for_matrix(acc, l, "x_attn", use_drift=ptq.use_drift,
                                 eps_qr=eps_qr, eps_aw=eps_aw,
                                 weighted_available=ptq.attention_weighting)
        # match the budget's CURRENT per-layer rate without consuming it
        target = budget.next_target(f"L{l}/attn/{key}")
        q = _quantize_matrix(ptq, _get_w(params, l, ("attn", key)).T, stats,
                             target)
        out[key] = q.dequant().T
    return out


def _golden(f, lo=0.0, hi=1.0, iters=6):
    phi = (math.sqrt(5.0) - 1) / 2
    a, b = lo, hi
    c1 = b - phi * (b - a)
    c2 = a + phi * (b - a)
    f1, f2 = f(c1), f(c2)
    for _ in range(iters - 2):
        if f1 <= f2:
            b, c2, f2 = c2, c1, f1
            c1 = b - phi * (b - a)
            f1 = f(c1)
        else:
            a, c1, f1 = c1, c2, f2
            c2 = a + phi * (b - a)
            f2 = f(c2)
    return c1 if f1 <= f2 else c2


def _optimize_mixing(cfg, params, l, acc, taps_pairs, budget, ptq):
    """Two-stage golden-section: ε_qr (drift mixing) then ε_aw (attention
    weighting) per paper App. C step 1-2."""

    def eval_qr(eps_qr):
        w = _quantize_qkv(params, l, acc, budget, ptq, eps_qr, 0.0
                          if ptq.attention_weighting else 1.0)
        return _attn_rel_mse(cfg, params, l, w, taps_pairs)

    eps_qr = _golden(eval_qr, iters=ptq.golden_iters)
    if not ptq.attention_weighting:
        return eps_qr, 1.0

    def eval_aw(eps_aw):
        w = _quantize_qkv(params, l, acc, budget, ptq, eps_qr, eps_aw)
        return _attn_rel_mse(cfg, params, l, w, taps_pairs)

    eps_aw = _golden(eval_aw, iters=ptq.golden_iters)
    return eps_qr, eps_aw


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def model_ppl(cfg: ArchConfig, params, batches: List[np.ndarray]) -> float:
    """Perplexity over token batches (next-token, teacher-forced), on the
    device of ``params``."""
    dev = params["embed"]["w"].device
    tot, n = 0.0, 0
    for tokens in batches:
        t = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev)
        loss = float(loss_fn(cfg, params, {"tokens": t[:, :-1],
                                           "targets": t[:, 1:]}))
        tok = t[:, 1:].numel()
        tot += loss * tok
        n += tok
    return math.exp(tot / max(n, 1))
