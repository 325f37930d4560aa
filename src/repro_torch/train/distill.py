"""WaterSIC-FT: post-quantization finetuning of the rescaler vectors
(port of ``repro/train/distill.py``; paper §4 "Post-quantization
finetuning").

Only the continuous per-layer vectors t (rows) and γ (columns) are trained —
a+n params per matrix, negligible vs the frozen integer codes Z, which
stay on the device with their spacings α.  The dequantized weight
Ŵ = T·(Z⊙α)·Γ is fully differentiable in (t, γ), so no straight-through
estimator is needed; dead columns are placed by an out-of-place
``index_copy``, which is differentiable in the live block.  Objective:
KL(teacher ‖ student) on the float model's output distribution, the
teacher's log-softmax cached once per batch; optimizer AdamW + cosine
annealing configured as the reference's.  Each forward runs through
``models.forward_train``, so its attention layers reach the flash kernel
(B3) on the card.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import QuantizedLinear
from repro_torch.models import forward_train
from repro_torch.tree import tree_leaves, tree_map
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["finetune_rescalers"]


def _dequant_with(frozen, t, g):
    """Ŵ(in,out) from frozen codes/α and live (t, γ) — differentiable."""
    codes, alphas, live_idx, in_features = frozen
    w_live = codes.to(torch.float32) * (alphas * g)[None, :] * t[:, None]
    if live_idx is None:
        return w_live.T
    w = torch.zeros((w_live.shape[0], in_features), dtype=torch.float32,
                    device=w_live.device)
    return w.index_copy(1, live_idx, w_live).T


def _freeze(q: QuantizedLinear):
    live = None
    if q.dead_mask.any():
        live = torch.as_tensor(np.nonzero(~q.dead_mask)[0],
                               device=q.codes.device)
    return (q.codes.to(torch.int32), q.alphas.to(torch.float32), live,
            q.in_features)


def _apply_rescalers(qparams, qlinears, frozen, trainable):
    """``qparams`` with each quantized matrix's layer of its stacked leaf
    replaced by Ŵ(t, γ); the other layers and leaves are shared."""
    by_path: Dict[tuple, Dict[int, str]] = {}
    for name in qlinears:
        by_path.setdefault(tuple(name.split("/")[1:]), {})[
            int(name.split("/")[0][1:])] = name
    p = dict(qparams)
    p["layers"] = dict(qparams["layers"])
    for path, names in by_path.items():
        node = p["layers"]
        for k in path[:-1]:
            node[k] = dict(node[k])
            node = node[k]
        leaf = dict(node[path[-1]])
        old = leaf["w"]
        rows = [_dequant_with(frozen[names[l]], trainable[names[l]]["t"],
                              trainable[names[l]]["g"]).to(old.dtype)
                if l in names else old[l] for l in range(old.shape[0])]
        leaf["w"] = torch.stack(rows)
        node[path[-1]] = leaf
    return p


def _split(tokens, dev):
    t = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev)
    return {"tokens": t[:, :-1], "targets": t[:, 1:]}


def finetune_rescalers(cfg: ArchConfig, teacher_params, qparams,
                       qlinears: Dict[str, QuantizedLinear],
                       batches: List[np.ndarray], *, steps: int = 60,
                       lr: float = 5e-4, log_every: int = 20):
    """Returns (finetuned qparams, trainable dict, losses)."""
    dev = qparams["embed"]["w"].device
    frozen = {k: _freeze(q) for k, q in qlinears.items()}
    trainable = {k: {"t": q.t.detach().to(torch.float32).clone(),
                     "g": q.gamma.detach().to(torch.float32).clone()}
                 for k, q in qlinears.items()}

    # teacher log-probs cached once per batch (paper App. D)
    with torch.no_grad():
        teacher_logp = [torch.log_softmax(forward_train(
            cfg, teacher_params, _split(tokens, dev)).to(torch.float32), -1)
            for tokens in batches]

    def kl_loss(tr, tokens, t_logp):
        p = _apply_rescalers(qparams, qlinears, frozen, tr)
        s_logits = forward_train(cfg, p, _split(tokens, dev)) \
            .to(torch.float32)
        s_logp = torch.log_softmax(s_logits, -1)
        t_prob = torch.exp(t_logp)
        return torch.mean(torch.sum(t_prob * (t_logp - s_logp), dim=-1))

    opt_cfg = AdamWConfig(lr=lr, weight_decay=0.0, schedule="cosine",
                          warmup_steps=max(steps // 10, 1),
                          total_steps=steps, min_lr_frac=0.01,
                          clip_norm=1.0)
    opt = adamw_init(trainable)
    leaves = tree_leaves(trainable)
    losses = []
    for step in range(steps):
        i = step % len(batches)
        for x in leaves:
            x.requires_grad_(True)
        loss = kl_loss(trainable, batches[i], teacher_logp[i])
        grads = iter(torch.autograd.grad(loss, leaves))
        for x in leaves:
            x.requires_grad_(False)
        g = tree_map(lambda _: next(grads), trainable)
        trainable, opt, _ = adamw_update(opt_cfg, trainable, g, opt)
        losses.append(float(loss.detach()))
        if log_every and step % log_every == 0:
            print(f"  FT step {step:4d} KL {losses[-1]:.5f}", flush=True)
    with torch.no_grad():
        p_final = _apply_rescalers(qparams, qlinears, frozen, trainable)
    return p_final, trainable, losses
