"""Port of the dense ``prefill`` (``repro_torch.models.prefill``) held
against ``decode_chunk`` and the JAX package.

The port's prefill is exact: its cache is the cache ``decode_chunk``
builds over the same prompt (the port's and the reference's
``repro.models.decode_chunk``), and its last-token logits are the
reference's ``repro.models.prefill`` logits.  The reference's own prefill
cache is not held: its ``_capture_kv`` projects the raw embeddings, with
no layer input, norm or rope (ROADMAP queue C).

Tolerance: 1e-5 (rtol = atol) on values divided by their largest
magnitude: one full-sequence pass against per-token steps sums the same
f32 terms in another order (B·S-row products, attention over the prompt
against attention over the cache buffer).  Inputs come from numpy seeds;
the weights are the reference's ``init_params`` values.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, to_numpy
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.models import (decode_chunk, from_jax_params, init_cache,
                                prefill)
from repro_torch.quant import quantize_params_tree

TOL = 1e-5
#: head_dim 64 and n_q == n_kv: every layer takes the flash path; gqa takes
#: the plain softmax; win has a local window shorter than the prompt (ring
#: cache)
MODELS = {
    "mha64": dict(name="mha64", family="dense", n_layers=2, d_model=96,
                  n_heads=2, n_kv=2, d_ff=160, vocab=96, head_dim=64),
    "gqa": dict(name="gqa", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv=2, d_ff=128, vocab=80, head_dim=16),
    "win": dict(name="win", family="dense", n_layers=2, d_model=64,
                n_heads=2, n_kv=2, d_ff=96, vocab=64, head_dim=64,
                local_window=5),
}
MAX_LEN = 20


def _rel_close(got, want):
    want = to_numpy(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    assert_close(to_numpy(got) / scale, want / scale, tol=TOL)


_TREES = {}


def _tree(name):
    """(jax cfg, reference numpy params, port cfg, port tree on the CPU)."""
    if name not in _TREES:
        import jax
        from repro.configs.base import ArchConfig
        from repro.models import init_params, split_tree
        jcfg = ArchConfig(**MODELS[name])
        base = to_numpy(split_tree(init_params(jcfg,
                                               jax.random.PRNGKey(5)))[0])
        _TREES[name] = (jcfg, base, TArchConfig(**MODELS[name]),
                        from_jax_params(base, "cpu"))
    return _TREES[name]


def _prompt(vocab, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _chunked(cfg, params, toks):
    cache = init_cache(cfg, toks.shape[0], MAX_LEN, torch.float32,
                       device="cpu")
    return decode_chunk(cfg, params, cache, torch.as_tensor(toks))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prefill_cache_equals_decode_chunk(name):
    """vs the port's decode_chunk over the same prompt: cache, position
    and last logits."""
    _, _, tcfg, tp = _tree(name)
    toks = _prompt(tcfg.vocab)
    logits, cache = prefill(tcfg, tp, {"tokens": torch.as_tensor(toks)},
                            MAX_LEN, torch.float32)
    want_logits, want = _chunked(tcfg, tp, toks)
    assert cache.pos.ndim == 0 and int(cache.pos) == toks.shape[1]
    assert cache.kv.k.shape == want.kv.k.shape
    _rel_close(cache.kv.k, want.kv.k)
    _rel_close(cache.kv.v, want.kv.v)
    _rel_close(logits, want_logits)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prefill_matches_reference(name):
    """Last logits vs ``repro.models.prefill``; the cache vs the
    reference's ``decode_chunk`` over the same prompt."""
    import jax.numpy as jnp
    from repro.models import decode_chunk as jchunk
    from repro.models import init_cache as jinit
    from repro.models import prefill as jprefill
    jcfg, base, tcfg, tp = _tree(name)
    toks = _prompt(tcfg.vocab, seed=1)
    want_logits, _ = jprefill(jcfg, base, {"tokens": jnp.asarray(toks)},
                              MAX_LEN, jnp.float32)
    _, want = jchunk(jcfg, base, jinit(jcfg, 2, MAX_LEN, jnp.float32),
                     jnp.asarray(toks))
    logits, cache = prefill(tcfg, tp, {"tokens": torch.as_tensor(toks)},
                            MAX_LEN, torch.float32)
    _rel_close(logits, want_logits)
    _rel_close(cache.kv.k, want.kv.k)
    _rel_close(cache.kv.v, want.kv.v)


@pytest.mark.parametrize("fmt", ["int8", "int4", "int3", "mixed"])
def test_prefill_of_quantized_tree_equals_decode_chunk(fmt):
    """Served leaves (the dequant-matmuls over B·S rows) give the cache of
    decode_chunk; the greedy token after the prompt is the same."""
    _, _, tcfg, tp = _tree("mha64")
    kw = {"int8": dict(nbits=8), "int4": dict(nbits=4, packed=True),
          "int3": dict(nbits=3),
          "mixed": dict(nbits_by_path=lambda p: {"wq": 8, "wk": 4,
                                                 "w_up": 2}.get(p[-2], 3))}
    tree = quantize_params_tree(tp, min_dim=16, **kw[fmt])
    toks = _prompt(tcfg.vocab, b=3, s=9, seed=2)
    logits, cache = prefill(tcfg, tree, {"tokens": torch.as_tensor(toks)},
                            MAX_LEN, torch.float32)
    want_logits, want = _chunked(tcfg, tree, toks)
    _rel_close(cache.kv.k, want.kv.k)
    _rel_close(cache.kv.v, want.kv.v)
    _rel_close(logits, want_logits)
    assert torch.equal(logits.argmax(-1), want_logits.argmax(-1))


def test_prefill_cache_continues_like_decode_chunk():
    """Decoding on from the prefilled cache gives the logits of decoding on
    from decode_chunk's cache (the reference's prefill cache does not:
    ROADMAP queue C)."""
    _, _, tcfg, tp = _tree("gqa")
    toks = _prompt(tcfg.vocab, seed=3)
    nxt = torch.as_tensor(_prompt(tcfg.vocab, s=3, seed=4))
    _, cache = prefill(tcfg, tp, {"tokens": torch.as_tensor(toks)},
                       MAX_LEN, torch.float32)
    got, _ = decode_chunk(tcfg, tp, cache, nxt)
    _, ref_cache = _chunked(tcfg, tp, toks)
    want, _ = decode_chunk(tcfg, tp, ref_cache, nxt)
    _rel_close(got, want)


def test_prefill_rejects_prompt_longer_than_cache():
    _, _, tcfg, tp = _tree("gqa")
    with pytest.raises(ValueError, match="exceeds"):
        prefill(tcfg, tp, {"tokens": torch.as_tensor(
            _prompt(tcfg.vocab, s=MAX_LEN + 1))}, MAX_LEN)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int4", "mixed"])
def test_prefill_on_card_matches_decode_chunk(fmt):
    """On the card (B1/B2 over B·S rows, flash causal): the cache and last
    logits of decode_chunk over the same prompt, within the dequant
    kernels' tolerance relative to the largest value (the same products
    split over other launches), and each kernel launched once per layer
    of each of its leaves."""
    from _torch_parity import require_cuda
    from repro_torch.kernels.dequant import LAUNCHES, reset_launches
    from repro_torch.kernels.flash import flash_attention_cuda
    from repro_torch.models import init_params
    dev = require_cuda()
    tcfg = TArchConfig(**{**MODELS["mha64"], "d_model": 256, "d_ff": 512})
    kw = {"int4": dict(nbits=4, packed=True),
          "mixed": dict(nbits_by_path=lambda p: {"wq": 8, "w_up": 2}
                        .get(p[-2], 3))}[fmt]
    tree = quantize_params_tree(init_params(tcfg, 0, device=dev),
                                min_dim=16, **kw)
    toks = torch.as_tensor(_prompt(tcfg.vocab, b=4, s=16, seed=6),
                           device=dev)
    reset_launches()
    before = flash_attention_cuda.launches
    logits, cache = prefill(tcfg, tree, {"tokens": toks}, 24, torch.float32)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + tcfg.n_layers
    assert sum(LAUNCHES.values()) == 7 * tcfg.n_layers
    want_logits, want = decode_chunk(tcfg, tree, init_cache(
        tcfg, 4, 24, torch.float32, device=dev), toks)
    for got, ref in ((cache.kv.k, want.kv.k), (cache.kv.v, want.kv.v),
                     (logits, want_logits)):
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 1e-4 * scale
