"""Inputs made from ``--seed``: the weights of a dense decoder, prompts,
and the PTQ cell's matrices and Σ_X.  Both sides get the same: the program
under test and the plain reference each ask for them here, and the same
(seed, key) gives the same values on the same device.

Everything large is drawn on the device by a ``torch.Generator`` in a few
large calls (one per layer), in float32.
"""
from __future__ import annotations

import numpy as np
import torch

# stream tags: one generator per (seed, tag, index)
_LAYER, _SHARED, _PROMPT, _MATRIX, _CALIB = 1, 2, 3, 4, 5


def generator(device, seed: int, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, *key), mixed by numpy's
    SeedSequence; any whole seed, negative or past 32 bits, is taken mod
    2**64."""
    words = [int(v) % 2 ** 64 for v in (seed, *key)]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))
    return gen


def rng(seed: int, *key: int) -> np.random.Generator:
    """A numpy generator of (seed, *key), for small host-side draws."""
    return np.random.default_rng([int(v) % 2 ** 64 for v in (seed, *key)])


def dense_layer_shapes(arch):
    """(block, name, (in, out)) of a dense layer's matrices in the order
    ``quant.pipeline.quantize_model`` takes them."""
    d, hd = arch.d_model, arch.resolved_head_dim
    return [("attn", "wq", (d, arch.n_heads * hd)),
            ("attn", "wk", (d, arch.n_kv * hd)),
            ("attn", "wv", (d, arch.n_kv * hd)),
            ("attn", "wo", (arch.n_heads * hd, d)),
            ("mlp", "w_gate", (d, arch.d_ff)),
            ("mlp", "w_up", (d, arch.d_ff)),
            ("mlp", "w_out", (arch.d_ff, d))]


def dense_layer(arch, seed: int, layer: int, device):
    """Layer ``layer`` of a dense gated-MLP decoder in float32, the tree
    of ``repro_torch.models.init_layer_params``: ``ln_attn``, ``attn``
    (wq, wk, wv with biases when ``arch.qkv_bias``; wo), ``ln_mlp``,
    ``mlp`` (w_gate, w_up, w_out).  One normal draw fills every leaf:
    weights get std 1/sqrt(in features), biases std 0.1, norm scales
    1 + 0.1 normal.  Weights are views of one buffer."""
    if arch.family != "dense" or not arch.gated_mlp or arch.out_bias:
        raise ValueError(f"{arch.name}: not a dense gated decoder")
    d = arch.d_model
    mats = dense_layer_shapes(arch)
    biases = [name for _, name, _ in mats[:3]] if arch.qkv_bias else []
    bias_n = {name: shape[1] for _, name, shape in mats}
    total = (sum(i * o for _, _, (i, o) in mats)
             + sum(bias_n[b] for b in biases) + 2 * d)
    flat = torch.randn(total, generator=generator(device, seed, _LAYER,
                                                  layer),
                       device=device, dtype=torch.float32)
    at = 0

    def take(shape):
        nonlocal at
        n = int(np.prod(shape))
        out = flat[at:at + n].view(shape)
        at += n
        return out

    tree = {"ln_attn": {"scale": take((d,)).mul_(0.1).add_(1.0)},
            "attn": {}, "ln_mlp": {"scale": take((d,)).mul_(0.1).add_(1.0)},
            "mlp": {}}
    for block, name, (i, o) in mats:
        tree[block][name] = {"w": take((i, o)).mul_(i ** -0.5)}
    for name in biases:
        tree["attn"][name]["b"] = take((bias_n[name],)).mul_(0.1)
    return tree


def dense_shared(arch, seed: int, device):
    """The leaves outside the layers: ``embed`` (padded vocab rows, std
    0.02, the padding rows zero) and ``ln_f`` (scale 1 + 0.1 normal)."""
    d, v, pv = arch.d_model, arch.vocab, arch.padded_vocab
    flat = torch.randn(v * d + d, generator=generator(device, seed,
                                                      _SHARED),
                       device=device, dtype=torch.float32)
    embed = torch.zeros((pv, d), dtype=torch.float32, device=device)
    embed[:v] = flat[:v * d].view(v, d).mul_(0.02)
    scale = flat[v * d:].mul_(0.1).add_(1.0)
    del flat
    return {"embed": {"w": embed}, "ln_f": {"scale": scale}}


def prompt(seed: int, client: int, index: int, length: int,
           vocab: int) -> np.ndarray:
    """Client ``client``'s ``index``-th prompt: ``length`` token ids drawn
    uniformly from the vocabulary."""
    return rng(seed, _PROMPT, client, index).integers(
        0, vocab, size=length).astype(np.int32)


def ptq_matrices(arch):
    """(layer, name, tap, (a, n)) of every linear matrix of a dense model
    in ``quantize_model``'s order: a out-features (rows), n in-features;
    matrices of one tap share its Σ_X."""
    out = []
    for layer in range(arch.n_layers):
        for _, name, (i, o) in dense_layer_shapes(arch):
            tap = {"wq": "attn_in", "wk": "attn_in", "wv": "attn_in",
                   "wo": "attn_out", "w_gate": "mlp_in", "w_up": "mlp_in",
                   "w_out": "mlp_act"}[name]
            out.append((layer, name, tap, (o, i)))
    return out


def ptq_weight(seed: int, layer: int, index: int, shape, device):
    """The (a, n) float32 matrix ``index`` of layer ``layer``: normal with
    std 1/sqrt(n)."""
    a, n = shape
    return torch.randn((a, n), generator=generator(device, seed, _MATRIX,
                                                   layer, index),
                       device=device).mul_(n ** -0.5)


_TAPS = {"attn_in": 0, "attn_out": 1, "mlp_in": 2, "mlp_act": 3}


def ptq_sigma(seed: int, layer: int, tap: str, n: int, device, *,
              tokens: int, decay: float, scale_sigma: float,
              dead_share: float) -> torch.Tensor:
    """Σ_X = XᵀX/N (n, n) float32 of N = ``tokens`` synthetic activations:
    X = G·diag(sqrt(λ))·Qᵀ·diag(s) with G standard normal (N, n), λ_i =
    i^-decay, Q a random rotation (QR of a normal matrix) and s_j =
    exp(scale_sigma·normal) channel scales; ``dead_share`` of the channels
    (at least one) are zero."""
    gen = generator(device, seed, _CALIB, layer, _TAPS[tap])
    q, r = torch.linalg.qr(torch.randn((n, n), generator=gen,
                                       device=device))
    q = q * torch.sign(torch.diagonal(r))[None, :]
    lam = torch.arange(1, n + 1, device=device,
                       dtype=torch.float32).pow_(-decay)
    s = torch.randn(n, generator=gen, device=device).mul_(scale_sigma).exp_()
    dead = torch.randperm(n, generator=gen, device=device)[
        :max(1, int(round(dead_share * n)))]
    s[dead] = 0.0
    mix = (lam.sqrt()[:, None] * q.T) * s[None, :]           # (n, n)
    x = torch.randn((tokens, n), generator=gen, device=device) @ mix
    return (x.T @ x).div_(tokens)
