"""A dense pre-norm decoder in plain PyTorch, float32 (TF32 off unless
asked), the architecture of Qwen2 (GQA attention with a q/k/v bias,
rotary positions on the two halves of each head, SwiGLU MLP, RMSNorm,
unembedding tied to the embedding), served with absmax int4 weights.

It follows the published description, not the port: the weights are the
benchmark's seeded float32 inputs, quantized again here (absmax int4: per
input row, codes round(w / max|w| · 7) clipped to ±7, scale max|w| / 7),
and the sequence runs as one causal forward pass, layer by layer, with no
cache.  ``served_logit_gaps`` reads, at each position of a served request,
how far the logit of the token that was served lies below the best logit.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

RMS_EPS = 1e-6


def absmax_int4(w: torch.Tensor) -> torch.Tensor:
    """w (in, out) → its absmax int4 reconstruction, per input row."""
    amax = w.abs().amax(dim=-1, keepdim=True)
    codes = torch.clamp(torch.round(w / amax * 7.0), -7.0, 7.0)
    return codes * (amax / 7.0 + 1e-12)


def rmsnorm(x, scale):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + RMS_EPS) \
        * scale


def rope(x, theta: float):
    """x (B, T, H, hd) at positions 0..T-1: each head's two halves
    rotated by position · θ^(-j/half)."""
    t, half = x.shape[1], x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freqs[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _linear(p, x):
    y = x @ absmax_int4(p["w"])
    return y + p["b"] if "b" in p else y


def layer(arch, lp, x):
    """One decoder layer over x (B, T, d), causal."""
    b, t, _ = x.shape
    nq, nkv = arch.n_heads, arch.n_kv
    hd = arch.resolved_head_dim
    h = rmsnorm(x, lp["ln_attn"]["scale"])
    a = lp["attn"]
    q = rope(_linear(a["wq"], h).view(b, t, nq, hd), arch.rope_theta)
    k = rope(_linear(a["wk"], h).view(b, t, nkv, hd), arch.rope_theta)
    v = _linear(a["wv"], h).view(b, t, nkv, hd)
    k = k.repeat_interleave(nq // nkv, dim=2)
    v = v.repeat_interleave(nq // nkv, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
    causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    out = torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, t, nq * hd)
    x = x + _linear(a["wo"], out)
    h = rmsnorm(x, lp["ln_mlp"]["scale"])
    m = lp["mlp"]
    return x + _linear(m["w_out"], torch.nn.functional.silu(
        _linear(m["w_gate"], h)) * _linear(m["w_up"], h))


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Matrix products in float32 (TF32 off) or in TF32."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def forward_logits(arch, layer_source, shared, tokens: torch.Tensor,
                   positions, precisions=(False,)):
    """Logits (float32) at ``positions`` of each row of ``tokens`` (B, T),
    once per entry of ``precisions`` (False: float32, True: TF32), the
    layers drawn one at a time from ``layer_source(l)``."""
    emb = shared["embed"]["w"]
    xs = [emb[tokens] for _ in precisions]
    for li in range(arch.n_layers):
        lp = layer_source(li)
        for i, tf32 in enumerate(precisions):
            with matmul_precision(tf32):
                xs[i] = layer(arch, lp, xs[i])
        del lp
    out = []
    for x, tf32 in zip(xs, precisions):
        with matmul_precision(tf32):
            h = rmsnorm(x[:, positions], shared["ln_f"]["scale"])
            out.append((h @ emb.T)[..., :arch.vocab])
    return out


def _batch(sample, device):
    """(tokens (B, T), first logit position, served ids (B, n)) of a
    sample of (prompt, served tokens), every prompt of one length; rows
    with fewer tokens are padded at the end (causal: harmless)."""
    plen = {len(p) for p, _ in sample}
    if len(plen) != 1:
        raise ValueError("the sample's prompts differ in length")
    plen = plen.pop()
    n = max(len(o) for _, o in sample)
    seqs = np.zeros((len(sample), plen + n - 1), np.int64)
    for i, (p, o) in enumerate(sample):
        s = np.concatenate([p, o[:-1]])
        seqs[i, :len(s)] = s
    return torch.as_tensor(seqs, device=device), plen, n


def served_logit_gaps(arch, layer_source, shared, sample):
    """For each (prompt, served tokens) of ``sample``: at every position
    that produced a served token, the reference's best logit minus its
    logit of the served token (≥ 0; 0 where they agree)."""
    dev = shared["embed"]["w"].device
    tokens, plen, n = _batch(sample, dev)
    pos = torch.arange(plen - 1, plen - 1 + n, device=dev)
    (logits,) = forward_logits(arch, layer_source, shared, tokens, pos)
    out = []
    for i, (_, o) in enumerate(sample):
        lg = logits[i, :len(o)]
        got = lg.gather(1, torch.as_tensor(o, device=dev)[:, None])[:, 0]
        out.append((lg.max(dim=1).values - got).cpu().numpy())
    return out


def control_logit_gaps(arch, layer_source, shared, sample):
    """The control: the same reference in TF32, in the program's place.
    At each position the reference's best logit minus its logit of the
    token the TF32 run puts first."""
    dev = shared["embed"]["w"].device
    tokens, plen, n = _batch(sample, dev)
    pos = torch.arange(plen - 1, plen - 1 + n, device=dev)
    ref, low = forward_logits(arch, layer_source, shared, tokens, pos,
                              precisions=(False, True))
    out = []
    for i, (_, o) in enumerate(sample):
        lg, lo = ref[i, :len(o)], low[i, :len(o)]
        got = lg.gather(1, lo.argmax(dim=1, keepdim=True))[:, 0]
        out.append((lg.max(dim=1).values - got).cpu().numpy())
    return out
