"""The port's encoder–decoder family (whisper-base) held against the JAX
package.

Reduced whisper-base (2 encoder and 2 decoder layers, d 64, 4 query heads
over 2 KV heads of 16, ``enc_seq`` 8) with the reference's weights,
converted with ``from_jax_params``: biases and norm scales perturbed with
numpy so they matter, and each stacked weight rescaled to std
1/sqrt(in_features) (the reference's stacked init takes the layer count
as fan-in, ROADMAP queue C, and its logits then amplify f32 rounding);
frames and tokens from numpy seeds.

Tolerances: attention, positions, forward, loss, cross K/V, caches and
decode logits rtol = atol = 1e-5 of the largest entry (f32 sums in
another order); weight grads 1e-4 of each leaf's largest entry;
quantized trees byte-identical; greedy streams identical.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_parity import (assert_trees_close, assert_trees_equal,
                           dequantize_tree, drive_engine, random_workload,
                           to_numpy, tree_leaves)
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import flash
from repro_torch.models import (cache_reset_slot, cache_rows,
                                cache_write_slot, capture_cross_kv,
                                decode_chunk, decode_step, encode,
                                forward_train, from_jax_params, init_cache,
                                init_params, loss_fn, prefill, split_layers)
from repro_torch.models import layers
from repro_torch.quant import quantize_params_tree
from repro_torch.serve import (ContinuousEngine, EngineConfig, Request,
                               ServeEngine)

ARCH = "whisper-base"
TOL = 1e-5
GRAD_TOL = 1e-4
FORMATS = {"fp": None, "int8": dict(nbits=8),
           "int4": dict(nbits=4, packed=True)}
MAX_LEN = 24


def _cfgs():
    from repro.configs import get_config
    return get_config(ARCH).reduced(), tget_config(ARCH).reduced()


@functools.lru_cache(maxsize=None)
def _tree(fmt="fp"):
    """The reference's value tree (numpy leaves), biases and norm scales
    perturbed, stacked weights at std 1/sqrt(in); quantized at min_dim 16 by the port's quantizer (whose
    bytes equal the reference's: test_quantize_inventory_matches)."""
    import jax
    from repro.models import init_params as jinit
    from repro.models import split_tree
    if FORMATS[fmt] is not None:
        return to_numpy(quantize_params_tree(
            from_jax_params(_tree(), "cpu"), min_dim=16, **FORMATS[fmt]))
    base = to_numpy(split_tree(jax.jit(functools.partial(
        jinit, _cfgs()[0]))(jax.random.PRNGKey(0)))[0])
    rng = np.random.default_rng(3)

    def perturb(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = perturb(v)
            elif k in ("b", "bias"):
                out[k] = (rng.standard_normal(v.shape) * 0.3).astype(v.dtype)
            elif k == "scale":
                out[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(
                    v.dtype)
            elif k == "w" and v.ndim == 3:
                out[k] = (v * np.sqrt(v.shape[0] / v.shape[1])).astype(
                    v.dtype)
            else:
                out[k] = v
        return out

    return perturb(base)


def _jnp(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close(got, want, tol=TOL):
    w = to_numpy(want).astype(np.float64)
    g = to_numpy(got).astype(np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale)


def _layer0(node):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in node.items()}


# -- layers -------------------------------------------------------------------


def test_sinusoidal_positions_match_reference():
    import jax.numpy as jnp
    from repro.models import layers as jl
    for length, dim in ((8, 64), (1500, 512), (3, 6)):
        got = layers.sinusoidal_positions(length, dim)
        want = np.asarray(jl.sinusoidal_positions(length, dim, jnp.float32))
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("case", ["cross", "non_causal", "non_causal_flash"])
def test_attention_train_matches_reference(case, monkeypatch):
    """Cross attention (K/V from ``kv_x``, no mask, no rope) and
    non-causal self attention without rope against the reference's
    ``attention_train``; at head_dim 64 with equal heads the port takes
    ``flash.flash_attention`` (the twin on the CPU), non-causal."""
    import jax.numpy as jnp
    from repro.models import layers as jl
    lp = _layer0(_tree()["dec_layers"]["cross_attn" if case == "cross"
                                       else "self_attn"])
    nq, nkv, hd = 4, 2, 16
    if case == "non_causal_flash":
        nq = nkv = 4
        lp = {k: {"w": _rand((64, 256) if k != "wo" else (256, 64), 7 + i)
                  * 0.125, "b": _rand((256,) if k != "wo" else (64,), i)}
              for i, k in enumerate(("wq", "wk", "wv", "wo"))}
        hd = 64
    calls = []
    real = flash.flash_attention
    monkeypatch.setattr(flash, "flash_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    x = _rand((2, 5, 64), 1)
    enc = _rand((2, 8, 64), 2)
    kw = dict(n_q=nq, n_kv=nkv, head_dim=hd, use_rope=False)
    if case == "cross":
        kw_t = dict(kw, kv_x=torch.from_numpy(enc))
        kw_j = dict(kw, kv_x=jnp.asarray(enc))
    else:
        kw_t = kw_j = dict(kw, causal=False)
    got = layers.attention_train(from_jax_params(lp, "cpu"),
                                 torch.from_numpy(x), **kw_t)
    want = jl.attention_train(_jnp(lp), jnp.asarray(x), **kw_j)
    _close(got, want)
    assert calls == ([{"causal": False, "window": 0}]
                     if case == "non_causal_flash" else [])


def test_cross_attention_decode_matches_reference():
    import jax.numpy as jnp
    from repro.models import layers as jl
    lp = _layer0(_tree()["dec_layers"]["cross_attn"])
    x = _rand((3, 1, 64), 4)
    k, v = _rand((3, 8, 2, 16), 5), _rand((3, 8, 2, 16), 6)
    kw = dict(n_q=4, n_kv=2, head_dim=16)
    got = layers.cross_attention_decode(
        from_jax_params(lp, "cpu"), torch.from_numpy(x), torch.from_numpy(k),
        torch.from_numpy(v), **kw)
    want = jl.cross_attention_decode(_jnp(lp), jnp.asarray(x), jnp.asarray(k),
                                     jnp.asarray(v), **kw)
    _close(got, want)


# -- the model ----------------------------------------------------------------


def test_init_params_has_the_reference_tree():
    """The port's init of reduced and full whisper-base: the reference's
    keys, shapes and dtypes (``enc_layers``, ``enc_ln_f``, ``dec_layers``,
    ``dec_pos`` (4096, d), ``ln_f``; biases everywhere); the reference's
    values carried across by ``from_jax_params`` byte for byte."""
    import jax
    from repro.models import init_params as jinit
    from repro.models import split_tree
    from repro.configs import get_config
    for jcfg, tcfg in (_cfgs(), (get_config(ARCH), tget_config(ARCH))):
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), split_tree(
            jax.eval_shape(lambda: jinit(jcfg, jax.random.PRNGKey(0))))[0])
        tparams = init_params(tcfg, 0, device="cpu")
        got = jax.tree.map(lambda a: (tuple(a.shape),
                                      str(a.dtype).replace("torch.", "")),
                           tparams)
        assert got == want
    assert tuple(tparams["dec_pos"].shape) == (4096, 512)
    assert_trees_equal(from_jax_params(_tree(), "cpu"), _tree())


def _batch(tcfg, b, s, seed):
    toks = _tokens(tcfg.vocab, b, s, seed)
    tgts = _tokens(tcfg.vocab, b, s, seed + 1)
    frames = _rand((b, tcfg.enc_seq, tcfg.d_model), seed + 2)
    return ({"tokens": torch.from_numpy(toks).long(),
             "targets": torch.from_numpy(tgts).long(),
             "frames": torch.from_numpy(frames)},
            {"tokens": toks, "targets": tgts, "frames": frames})


def test_forward_train_loss_and_grads_match_reference():
    """forward_train (the encoder, ``dec_pos`` rows, causal self and cross
    attention), loss_fn and every weight's gradient against jax.grad."""
    import jax
    import jax.numpy as jnp
    from repro.models import forward_train as jfwd
    from repro.models import loss_fn as jloss
    jcfg, tcfg = _cfgs()
    tree = _tree()
    tb, nb = _batch(tcfg, 2, 7, seed=2)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tp = from_jax_params(tree, "cpu")
    _close(forward_train(tcfg, tp, tb),
           jax.jit(functools.partial(jfwd, jcfg))(_jnp(tree), jb))
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    loss = loss_fn(tcfg, tp, tb)
    loss.backward()
    want_loss, want_g = jax.jit(jax.value_and_grad(
        functools.partial(jloss, jcfg)))(_jnp(tree), jb)
    assert abs(float(loss.detach()) - float(want_loss)) < TOL
    got_g = jax.tree.map(lambda t: t.grad, tp,
                         is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert_trees_close(got_g, want_g, tol=GRAD_TOL, relative=True)


def test_encode_and_capture_cross_kv_match_reference():
    """``encode`` and ``capture_cross_kv`` against ``_encode`` and
    ``_capture_cross_kv`` on the float tree, f32 and bf16 extras."""
    import jax.numpy as jnp
    from repro.models import transformer as jt
    jcfg, tcfg = _cfgs()
    tree = _tree()
    frames = _rand((3, 8, 64), 9)
    tp = from_jax_params(tree, "cpu")
    enc = encode(tcfg, tp, torch.from_numpy(frames))
    jenc = jt._encode(jcfg, _jnp(tree), jnp.asarray(frames))
    _close(enc, jenc)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = capture_cross_kv(tcfg, tp, enc, tdt)
        want = jt._capture_cross_kv(jcfg, _jnp(tree), jenc, jdt)
        assert got[0].shape == (2, 3, 8, 2, 16) and got[0].dtype == tdt
        assert_trees_close(got, want, tol=TOL if tdt == torch.float32
                           else 1e-2, relative=True)


def _jax_steps(jcfg, tree, cache, toks):
    import jax
    import jax.numpy as jnp
    from repro.models import decode_step as jstep
    step = jax.jit(lambda p, c, t: jstep(jcfg, p, c, t))
    out = []
    params = _jnp(tree)
    for j in range(toks.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(toks[:, j:j + 1]))
        out.append(np.asarray(logits))
    return out, cache


#: (per-slot positions, rows kept of the position table, start positions)
DECODE_CASES = {"lockstep": (False, 8, 6), "per_slot": (True, 8, [5, 9, 2]),
                "full_table": (False, 4096, 4094)}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_step_matches_reference(case):
    """Logits of every step and the final cache (self K/V; the extras the
    reference's prefill captured, carried unchanged) against the
    reference's decode_step on the packed int4 tree, lockstep and
    per-slot, with the position table cut to 8 rows, which positions 8
    and past wrap, and whole, which positions 4096 and past wrap (``pos``
    mod its length, as in the reference)."""
    import jax.numpy as jnp
    from repro.models import init_cache as jcache
    from repro.models import transformer as jt
    per_slot, rows, pos0 = DECODE_CASES[case]
    jcfg, tcfg = _cfgs()
    tree = dict(_tree("int4"), dec_pos=_tree()["dec_pos"][:rows])
    b = 3
    toks = _tokens(tcfg.vocab, b, 5, seed=4)
    jenc = jt._encode(jcfg, _jnp(_tree()), jnp.asarray(_rand((b, 8, 64), 8)))
    extras = jt._capture_cross_kv(jcfg, _jnp(_tree()), jenc, jnp.float32)
    jc = jcache(jcfg, b, 16, jnp.float32, per_slot=per_slot)._replace(
        pos=jnp.asarray(pos0, jnp.int32), extras=extras)
    want, jc = _jax_steps(jcfg, tree, jc, toks)
    tc = init_cache(tcfg, b, 16, torch.float32, per_slot=per_slot,
                    device="cpu")
    tc = tc._replace(pos=torch.tensor(pos0, dtype=torch.int32))
    for dst, src in zip(tc.extras, extras):
        dst.copy_(from_jax_params(np.asarray(src), "cpu"))
    params = split_layers(from_jax_params(tree, "cpu"))
    for j in range(toks.shape[1]):
        logits, tc = decode_step(tcfg, params, tc,
                                 torch.from_numpy(toks[:, j:j + 1]))
        _close(logits, want[j])
    assert_trees_close((tc.kv, tc.extras), (jc.kv, jc.extras), tol=TOL,
                       relative=True)
    np.testing.assert_array_equal(to_numpy(tc.pos), np.asarray(jc.pos))


def test_slot_graft_and_reset_carry_the_extras():
    """cache_write_slot grafts a batch-1 cache's extras into its row and
    cache_reset_slot zeroes them, as the reference's do; cache_rows cuts
    them with the K/V."""
    import jax.numpy as jnp
    from repro.models import cache_reset_slot as jreset
    from repro.models import cache_write_slot as jwrite
    from repro.models import init_cache as jcache
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(6)
    big = init_cache(tcfg, 3, 8, torch.float32, per_slot=True, device="cpu")
    sub = init_cache(tcfg, 2, 8, torch.float32, device="cpu")
    for t in tree_leaves((sub.kv, sub.extras)):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape)
                                 .astype(np.float32)))
    sub = sub._replace(pos=torch.tensor(4, dtype=torch.int32))
    row = cache_rows(sub, 1)
    assert row.extras[0].shape == (2, 1, 8, 2, 16)
    jbig = jcache(jcfg, 3, 8, jnp.float32, per_slot=True)
    jrow = jcache(jcfg, 1, 8, jnp.float32)._replace(
        pos=jnp.asarray(4, jnp.int32))
    jrow = jrow._replace(
        kv=jrow.kv._replace(k=jnp.asarray(row.kv.k.numpy()),
                            v=jnp.asarray(row.kv.v.numpy())),
        extras=tuple(jnp.asarray(t.numpy()) for t in row.extras))
    cache_write_slot(big, row, 2)
    jbig = jwrite(jbig, jrow, 2)
    assert_trees_equal([big.kv.k, big.kv.v, *big.extras, big.pos],
                       [jbig.kv.k, jbig.kv.v, *jbig.extras, jbig.pos])
    assert torch.equal(big.extras[1][:, 2:3], row.extras[1])
    cache_reset_slot(big, 2)
    jbig = jreset(jbig, 2)
    assert_trees_equal([big.kv.k, *big.extras, big.pos],
                       [jbig.kv.k, *jbig.extras, jbig.pos])
    assert not any(bool(t.any()) for t in big.extras)


# -- the exact prefill --------------------------------------------------------


def test_prefill_runs_on_a_quantized_tree_where_the_reference_raises():
    """The reference's prefill multiplies the raw weight leaf in
    ``_capture_cross_kv``/``_capture_kv`` and raises ``ValueError`` on a
    packed int4 tree; the port's runs (every dense through
    ``layers.dense``) and equals its prefill of the dequantized tree."""
    import jax.numpy as jnp
    from repro.models import prefill as jprefill
    jcfg, tcfg = _cfgs()
    tree = _tree("int4")
    tb, nb = _batch(tcfg, 2, 6, seed=11)
    with pytest.raises(ValueError):
        jprefill(jcfg, _jnp(tree), {k: jnp.asarray(nb[k])
                                    for k in ("tokens", "frames")}, 16,
                 jnp.float32)
    params = from_jax_params(tree, "cpu")
    got_l, got = prefill(tcfg, params, tb, 16, torch.float32)
    want_l, want = prefill(tcfg, dequantize_tree(params), tb, 16,
                           torch.float32)
    _close(got_l, want_l)
    assert_trees_close((got.kv, got.extras), (want.kv, want.extras),
                       tol=TOL, relative=True)
    assert int(got.pos) == 6


@pytest.mark.parametrize("fmt", ["fp", "int8"])
def test_prefill_equals_capture_cross_kv_and_decode_chunk(fmt):
    """The port's prefill: the last logits, self K/V and extras of
    ``capture_cross_kv`` + ``decode_chunk`` over the prompt, and the next
    step's logits (the reference's logits agree; its self K/V are
    ``_capture_kv``'s projection of the raw embeddings, ROADMAP queue
    C)."""
    import jax.numpy as jnp
    from repro.models import prefill as jprefill
    jcfg, tcfg = _cfgs()
    tree = _tree(fmt)
    tb, nb = _batch(tcfg, 2, 6, seed=12)
    params = from_jax_params(tree, "cpu")
    lg, cache = prefill(tcfg, params, tb, 16, torch.float32)
    ref = init_cache(tcfg, 2, 16, torch.float32, device="cpu")
    for dst, src in zip(ref.extras, capture_cross_kv(
            tcfg, params, encode(tcfg, params, tb["frames"]),
            torch.float32)):
        dst.copy_(src)
    want_l, ref = decode_chunk(tcfg, params, ref, tb["tokens"])
    _close(lg, want_l)
    assert_trees_close((cache.kv, cache.extras), (ref.kv, ref.extras),
                       tol=TOL, relative=True)
    nxt = torch.from_numpy(_tokens(tcfg.vocab, 2, 1, seed=13)).long()
    _close(decode_step(tcfg, params, cache, nxt)[0],
           decode_step(tcfg, params, ref, nxt)[0])
    if fmt == "fp":
        jl, jc = jprefill(jcfg, _jnp(tree), {k: jnp.asarray(nb[k]) for k in
                                             ("tokens", "frames")}, 16,
                          jnp.float32)
        _close(lg, jl)
        assert_trees_close(cache.extras, jc.extras, tol=TOL, relative=True)
        assert float(np.abs(np.asarray(jc.kv.k) - cache.kv.k.numpy()).max()
                     ) > 0.1


def test_int8_kv_prefill_writes_q8_of_the_f32_prefill(monkeypatch):
    """Under ``int8_kv`` the prefill's self K/V are ``q8`` of the f32
    prefill's, bit for bit, with their scales; the cross K/V stay float
    and equal, as the reference's ``init_cache`` keeps them."""
    from repro_torch.models.layers import q8
    _, tcfg = _cfgs()
    params = from_jax_params(_tree("int4"), "cpu")
    tb, _ = _batch(tcfg, 2, 6, seed=14)
    lg32, c32 = prefill(tcfg, params, tb, 16, torch.float32)
    monkeypatch.setenv("REPRO_OPTS", "int8_kv")
    lg8, c8 = prefill(tcfg, params, tb, 16, torch.float32)
    assert torch.equal(lg8, lg32)
    for codes, scale, f32 in ((c8.kv.k, c8.kv.k_scale, c32.kv.k),
                              (c8.kv.v, c8.kv.v_scale, c32.kv.v)):
        want_c, want_s = q8(f32[:, :, :6])
        assert codes.dtype == torch.int8
        assert torch.equal(codes[:, :, :6], want_c)
        assert torch.equal(scale[:, :, :6], want_s)
        assert not codes[:, :, 6:].any()
    assert all(a.dtype == torch.float32 and torch.equal(a, b)
               for a, b in zip(c8.extras, c32.extras))


# -- quantization -------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantize_inventory_matches_reference(fmt):
    """quantize_params_tree of the encoder–decoder tree against the
    reference's: byte-identical leaves, inventory and payload checksums;
    every ``w`` under ``enc_layers`` and ``dec_layers`` becomes a code
    leaf, ``dec_pos``, biases, norms and the embedding stay."""
    import jax
    from repro.kernels.dequant.ops import payload_checksums as jcrc
    from repro.quant import leaf_inventory as jinv
    from repro.quant import quantize_params_tree as jquant
    from repro_torch.kernels.dequant import payload_checksums
    from repro_torch.quant import leaf_inventory
    base = _tree()
    want = to_numpy(jquant(jax.tree.map(jax.numpy.asarray, base), min_dim=16,
                           **FORMATS[fmt]))
    got = quantize_params_tree(from_jax_params(base, "cpu"), min_dim=16,
                               **FORMATS[fmt])
    assert_trees_equal(got, want)
    assert leaf_inventory(got) == jinv(_jnp(want))
    paths = payload_checksums(got)
    assert paths == jcrc(_jnp(want))
    assert sorted(paths) == sorted(
        [f"enc_layers/attn/{w}/w" for w in ("wq", "wk", "wv", "wo")]
        + ["enc_layers/mlp/w_in/w", "enc_layers/mlp/w_out/w"]
        + [f"dec_layers/{blk}/{w}/w" for blk in ("self_attn", "cross_attn")
           for w in ("wq", "wk", "wv", "wo")]
        + ["dec_layers/mlp/w_in/w", "dec_layers/mlp/w_out/w"])
    assert torch.is_tensor(got["dec_pos"])


def test_ptq_refuses_the_family():
    """Calibration, PTQ and the planner refuse the encoder–decoder family,
    as the reference's do (dense or MoE only)."""
    from repro_torch.plan import model_sensitivities
    from repro_torch.quant.calibrate import (check_ptq_family,
                                             forward_with_taps)
    from repro_torch.quant.pipeline import PTQConfig, quantize_model
    _, tcfg = _cfgs()
    params = init_params(tcfg, 0, device="cpu")
    toks = _tokens(tcfg.vocab, 1, 4, seed=0)
    for call in (lambda: check_ptq_family(tcfg),
                 lambda: forward_with_taps(tcfg, params, toks),
                 lambda: quantize_model(tcfg, params, [toks], PTQConfig()),
                 lambda: model_sensitivities(tcfg, params, [toks])):
        with pytest.raises(NotImplementedError,
                           match="dense and MoE families only"):
            call()


# -- the engines --------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_fns():
    import jax
    from repro.models import decode_chunk as jchunk
    from repro.models import decode_step as jstep
    cfg = _cfgs()[0]
    return (jax.jit(lambda p, c, t: jstep(cfg, p, c, t)),
            jax.jit(lambda p, c, t: jchunk(cfg, p, c, t)))


def _engine_kw(continuous):
    return dict(n_slots=3 if continuous else 4, max_len=MAX_LEN,
                prefill_chunk=3)


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("fmt", ["int8", "int4", "int4_int8_kv"])
def test_engine_streams_match_reference(fmt, continuous, monkeypatch):
    """Token-only requests through both packages' engines (the caches'
    cross K/V stay zero, as in the reference): identical greedy streams
    on the int8 and packed int4 trees, and with the int8 KV cache."""
    import jax.numpy as jnp
    from repro import serve as jserve
    if fmt.endswith("int8_kv"):
        monkeypatch.setenv("REPRO_OPTS", "int8_kv")
    jcfg, tcfg = _cfgs()
    jstep, jchunk = _jax_fns()
    tree = _tree(fmt.split("_")[0])
    workload = random_workload(41, tcfg.vocab)
    kw = _engine_kw(continuous)
    jeng = (jserve.ContinuousEngine if continuous else jserve.ServeEngine)(
        jcfg, _jnp(tree), config=jserve.EngineConfig(
            cache_dtype=jnp.float32, decode_fn=jstep, decode_chunk_fn=jchunk,
            **kw))
    want = drive_engine(jeng, workload, continuous, jserve.Request)
    teng = (ContinuousEngine if continuous else ServeEngine)(
        tcfg, from_jax_params(tree, "cpu"),
        config=EngineConfig(cache_dtype=torch.float32, **kw))
    if continuous:
        assert teng.cache.extras[0].shape == (2, 3, 8, 2, 16)
        assert teng.cache.kv.k.dtype == (torch.int8 if "kv" in fmt
                                         else torch.float32)
    assert drive_engine(teng, workload, continuous, Request) == want


def test_continuous_equals_static_in_the_port():
    tcfg = _cfgs()[1]
    tree = from_jax_params(_tree("int4"), "cpu")
    workload = random_workload(42, tcfg.vocab)
    ref = drive_engine(ServeEngine(tcfg, tree, config=EngineConfig(
        **_engine_kw(False))), workload, False, Request)
    out = drive_engine(ContinuousEngine(tcfg, tree, config=EngineConfig(
        reset_on_evict=True, **_engine_kw(True))), workload, True, Request)
    assert out == ref


def test_snapshot_resume_gives_the_uninterrupted_streams(tmp_path):
    """A whisper continuous engine snapshots mid-run (self K/V and extras
    in the checkpoint); a fresh engine resumes it and finishes with the
    uninterrupted run's streams."""
    tcfg = _cfgs()[1]
    tree = from_jax_params(_tree("int4"), "cpu")
    workload = random_workload(43, tcfg.vocab)
    kw = dict(n_slots=2, max_len=MAX_LEN, prefill_chunk=3,
              cache_dtype=torch.float32)
    ref = drive_engine(ContinuousEngine(tcfg, tree, config=EngineConfig(
        **kw)), workload, True, Request)
    eng = ContinuousEngine(tcfg, tree, config=EngineConfig(**kw))
    for rid, (prompt, budget, _) in enumerate(workload):
        eng.submit(Request(rid=rid, prompt=prompt.copy(),
                           max_new_tokens=budget))
    delivered = {}
    for _ in range(4):
        delivered.update({r.rid: tuple(r.out_tokens) for r in eng.step()})
    # mark the extras so the restore is seen to bring them back
    eng.cache.extras[0][:, 0] = 0.5
    ckpt = str(tmp_path / "snap")
    eng.snapshot(ckpt)
    revived = ContinuousEngine.resume(ckpt, tcfg, tree,
                                      config=EngineConfig(**kw))
    assert torch.equal(revived.cache.extras[0], eng.cache.extras[0])
    revived.cache.extras[0].zero_()
    delivered.update({r.rid: tuple(r.out_tokens)
                      for r in revived.run_until_done()})
    assert delivered == ref


def test_serve_driver_runs_the_family_on_cpu():
    from repro_torch.launch import serve
    for wbits in ("4", "8"):
        done = serve.main(["--arch", ARCH, "--reduced", "--wbits", wbits,
                           "--requests", "3", "--max-new", "3",
                           "--continuous", "--device", "cpu"])
        assert len(done) == 3
        assert all(len(r.out_tokens) == 3 and max(r.out_tokens) < 256
                   for r in done)


def test_smoke_encdec_prefill_phases_on_cpu():
    """``chip_smoke``'s whisper and paligemma prefill phases at the reduced
    configs on the CPU (the twins serve; the launch counts are the
    card's): the prefill's cache against ``capture_cross_kv`` +
    ``decode_chunk``, and the prefill's and each greedy step's logits
    against the dequantized model's ``forward_train``; each family's B1
    count per decode step."""
    import pathlib
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    dev = torch.device("cpu")
    for arch in (ARCH, "paligemma-3b"):
        cfg = tget_config(arch).reduced()
        params = quantize_params_tree(init_params(cfg, 0, device=dev),
                                      min_dim=16, nbits=4, packed=True)
        assert chip_smoke.launches_per_step(params) == {
            4: chip_smoke.ENCDEC_PER_LAYER[arch] * cfg.n_layers}
        kw = dict(n_req=3, prompt_len=10, new_tokens=4)
        if arch == ARCH:
            rec = chip_smoke.whisper_prefill_phase(cfg, params, dev,
                                                   max_len=20, **kw)
            assert max(rec["prefill_vs_decode_chunk_rel_err"].values()) \
                < chip_smoke.LOGIT_TOL
        else:
            rec = chip_smoke.paligemma_prefill_phase(cfg, params, dev, **kw)
            assert rec["prefill_max_len"] == 4 + 10 + 4
        assert rec["steps_rel_err"] < chip_smoke.LOGIT_TOL
