"""The int8 KV cache (``REPRO_OPTS=int8_kv``) held against the JAX package.

One ``REPRO_OPTS`` setting drives both packages: ``repro.models.init_cache``
and ``repro_torch.models.init_cache`` then build int8 K/V buffers with f32
per-(position, head) scales.  After a chunked prefill and N greedy decode
steps the int8 codes must be byte-identical to the reference's, the
scales equal to f32 rounding, and the greedy tokens equal; the engines'
streams must match too.  The port's exact ``prefill`` writes ``q8`` of the same K/V the
f32 ``prefill`` writes.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_same_ints, to_numpy
from repro_torch import opts
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.models import (cache_reset_slot, cache_rows, decode_chunk,
                                decode_step, from_jax_params, init_cache,
                                prefill)
from repro_torch.models.layers import q8
from repro_torch.serve import ContinuousEngine, EngineConfig, Request

CFG = dict(name="kv8", family="dense", n_layers=2, d_model=32, n_heads=2,
           n_kv=2, d_ff=64, vocab=64, head_dim=16)
MAX_LEN = 24


@pytest.fixture
def int8_kv(monkeypatch):
    monkeypatch.setenv("REPRO_OPTS", "int8_kv")
    assert opts.enabled("int8_kv")


def _tree(fmt):
    import jax
    from repro.configs.base import ArchConfig
    from repro.models import init_params, split_tree
    from repro.quant import quantize_params_tree

    base, _ = split_tree(init_params(ArchConfig(**CFG),
                                     jax.random.PRNGKey(0)))
    if fmt == "int4":
        base = quantize_params_tree(base, nbits=4, packed=True, min_dim=16)
    return to_numpy(base)


def test_opts_reads_the_reference_variable(monkeypatch):
    from repro import opts as jopts
    monkeypatch.setenv("REPRO_OPTS", " int8_kv , kv_seq_shard,,")
    assert opts.all_enabled() == jopts.all_enabled() \
        == frozenset({"int8_kv", "kv_seq_shard"})
    monkeypatch.delenv("REPRO_OPTS")
    assert not opts.enabled("int8_kv") and opts.all_enabled() == frozenset()


def test_q8_matches_reference_rounding():
    """rint(x / s), s = max(max|x|/127, 1e-12) as the reference's jitted
    decode step computes it (XLA multiplies by the f32 reciprocal of 127):
    equal bytes on 4096 seeded rows, exact halves and an all-zero row."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    x = rng.standard_normal((4096, 3, 16)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 0] = np.arange(16, dtype=np.float32) - 7.5   # halves after /s

    @jax.jit
    def jq8(x_t):
        s_t = jnp.max(jnp.abs(x_t), axis=-1, keepdims=True) / 127.0
        s_t = jnp.maximum(s_t, 1e-12)
        return jnp.rint(x_t / s_t).astype(jnp.int8), s_t

    codes, scale = q8(torch.from_numpy(x))
    jc, js = jq8(jnp.asarray(x))
    assert_same_ints(codes, jc)
    assert scale.numpy().tobytes() == np.asarray(js).tobytes()
    assert torch.count_nonzero(codes[0, 0]) == 0


@pytest.mark.parametrize("fmt", ["fp", "int4"])
def test_int8_cache_bytes_and_tokens_match_reference(int8_kv, fmt):
    """Chunked prefill (3 + 3 + 1 tokens), then 6 greedy decode steps on a
    per-slot cache: int8 codes and positions byte-identical, tokens equal
    at every step.  The scales are max|K|/127 of f32 K/V that the two
    packages' matmuls round differently in the last bits (the f32 cache
    agrees only to a tolerance, tests/test_torch_models.py), so they are
    held to 8e-6 relative; ``q8`` itself gives the reference's bits on
    the same input (test_q8_matches_reference_rounding)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ArchConfig
    from repro.models import decode_chunk as jchunk
    from repro.models import decode_step as jstep
    from repro.models import init_cache as jinit

    tree = _tree(fmt)
    jcfg, tcfg = ArchConfig(**CFG), TArchConfig(**CFG)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = from_jax_params(tree, "cpu")
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, CFG["vocab"], (3, 7)).astype(np.int32)

    jc = jinit(jcfg, 3, MAX_LEN, jnp.float32, per_slot=True)
    tc = init_cache(tcfg, 3, MAX_LEN, torch.float32, per_slot=True,
                    device="cpu")
    assert tc.kv.k.dtype == torch.int8 and jc.kv.k.dtype == jnp.int8
    assert tuple(tc.kv.k_scale.shape) == jc.kv.k_scale.shape
    for s0 in range(0, 7, 3):
        seg = prompts[:, s0:s0 + 3]
        jl, jc = jchunk(jcfg, jparams, jc, jnp.asarray(seg))
        tl, tc = decode_chunk(tcfg, tparams, tc, torch.from_numpy(seg).long())
    for _ in range(6):
        jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        ttok = tl.argmax(-1).numpy().astype(np.int32)
        assert np.array_equal(jtok, ttok)
        jl, jc = jstep(jcfg, jparams, jc, jnp.asarray(jtok[:, None]))
        tl, tc = decode_step(tcfg, tparams, tc,
                             torch.from_numpy(ttok[:, None]).long())
    for name in ("k", "v"):
        assert_same_ints(getattr(tc.kv, name), getattr(jc.kv, name))
        got = getattr(tc.kv, name + "_scale").numpy()
        want = np.asarray(getattr(jc.kv, name + "_scale"))
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=8e-6, atol=0)
    assert_same_ints(tc.pos, jc.pos)


def test_int8_slot_graft_and_reset_carry_the_scales(int8_kv):
    """cache_write_slot / cache_reset_slot / cache_rows move and zero the
    scale rows with the codes (the reference maps over every leaf)."""
    import jax.numpy as jnp
    from repro.models import cache_write_slot as jwrite
    from repro.models import init_cache as jinit
    from repro.configs.base import ArchConfig
    from repro_torch.models import cache_write_slot

    tree = _tree("fp")
    tcfg = TArchConfig(**CFG)
    tparams = from_jax_params(tree, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, CFG["vocab"], (2, 5))).long()
    _, sub = decode_chunk(tcfg, tparams,
                          init_cache(tcfg, 2, MAX_LEN, device="cpu"), toks)
    big = init_cache(tcfg, 3, MAX_LEN, per_slot=True, device="cpu")
    row = cache_rows(sub, 1)
    big = cache_write_slot(big, row, 2)
    jbig = jinit(ArchConfig(**CFG), 3, MAX_LEN, per_slot=True)
    jrow = type(jbig)(
        kv=type(jbig.kv)(*(jnp.asarray(t.numpy()) for t in row.kv)),
        pos=jnp.asarray(row.pos.numpy()))
    jbig = jwrite(jbig, jrow, 2)
    for got, want in zip(big.kv, jbig.kv):
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
    assert torch.count_nonzero(big.kv.k_scale[:, 2]) > 0
    cache_reset_slot(big, 2)
    assert all(torch.count_nonzero(t) == 0 for t in big.kv)


def test_prefill_writes_q8_of_the_f32_cache(int8_kv, monkeypatch):
    """The port's exact prefill under int8_kv: codes and scales are q8 of
    the f32 prefill's K/V, bit for bit; the logits are unchanged."""
    tcfg = TArchConfig(**CFG)
    tparams = from_jax_params(_tree("int4"), "cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, CFG["vocab"], (2, 9))).long()
    logits8, c8 = prefill(tcfg, tparams, {"tokens": toks}, MAX_LEN,
                          torch.float32)
    monkeypatch.delenv("REPRO_OPTS")
    logits, c32 = prefill(tcfg, tparams, {"tokens": toks}, MAX_LEN,
                          torch.float32)
    assert torch.equal(logits8, logits)
    for codes, scale, f32 in ((c8.kv.k, c8.kv.k_scale, c32.kv.k),
                              (c8.kv.v, c8.kv.v_scale, c32.kv.v)):
        want_c, want_s = q8(f32[:, :, :9])
        assert torch.equal(codes[:, :, :9], want_c)
        assert torch.equal(scale[:, :, :9], want_s)
        assert torch.count_nonzero(codes[:, :, 9:]) == 0


def test_int8_engine_streams_match_reference(int8_kv):
    """Continuous engines of both packages on the int4 tree with the int8
    cache: identical greedy streams, request by request."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ArchConfig
    from repro.serve import ContinuousEngine as JCont
    from repro.serve import EngineConfig as JConfig
    from repro.serve import Request as JRequest

    tree = _tree("int4")
    rng = np.random.default_rng(21)
    work = [(rng.integers(0, CFG["vocab"], int(rng.integers(2, 8))
                          ).astype(np.int32), int(rng.integers(2, 7)))
            for _ in range(6)]

    def drive(eng, req):
        for i, (p, n) in enumerate(work):
            eng.submit(req(rid=i, prompt=p.copy(), max_new_tokens=n))
        return {r.rid: list(r.out_tokens) for r in eng.run_until_done()}

    want = drive(JCont(ArchConfig(**CFG), jax.tree.map(jnp.asarray, tree),
                       config=JConfig(n_slots=2, max_len=MAX_LEN,
                                      prefill_chunk=3)), JRequest)
    teng = ContinuousEngine(TArchConfig(**CFG), from_jax_params(tree, "cpu"),
                            config=EngineConfig(n_slots=2, max_len=MAX_LEN,
                                                prefill_chunk=3))
    assert teng.cache.kv.k.dtype == torch.int8
    assert drive(teng, Request) == want
