"""The port's prefix-LM family (paligemma-3b) held against the JAX
package.

Reduced paligemma-3b (2 layers, d 64, 4 query heads over 1 KV head of
16, gated GELU, ``embed_scale``, 4 prefix tokens) with the reference's
weights, converted with ``from_jax_params``: norm scales perturbed with
numpy and each stacked weight rescaled to std 1/sqrt(in_features) (the
reference's stacked init takes the layer count as fan-in, ROADMAP queue
C); patch embeddings and tokens from numpy seeds.

Tolerances: attention, forward, loss, caches and logits rtol = atol =
1e-5 of the largest entry (f32 sums in another order); weight grads 1e-4
of each leaf's largest entry; quantized trees byte-identical; greedy
streams identical.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_parity import (assert_trees_close, assert_trees_equal,
                           drive_engine, random_workload, to_numpy,
                           tree_leaves)
from repro_torch.configs import get_config as tget_config
from repro_torch.models import (decode_step, forward_train,
                                from_jax_params, init_cache, init_params,
                                loss_fn, prefill, split_layers)
from repro_torch.models import layers
from repro_torch.quant import quantize_params_tree
from repro_torch.serve import (ContinuousEngine, EngineConfig, Request,
                               ServeEngine)

ARCH = "paligemma-3b"
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
    """The reference's value tree (numpy leaves), norm scales perturbed,
    stacked weights at std 1/sqrt(in); quantized at min_dim 16 by the
    port's quantizer (test_quantize_inventory_matches holds its bytes to
    the reference's)."""
    import jax
    from repro.models import init_params as jinit
    from repro.models import split_tree
    if FORMATS[fmt] is not None:
        return to_numpy(quantize_params_tree(
            from_jax_params(_tree(), "cpu"), min_dim=16, **FORMATS[fmt]))
    base = to_numpy(split_tree(jax.jit(functools.partial(
        jinit, _cfgs()[0]))(jax.random.PRNGKey(0)))[0])
    rng = np.random.default_rng(4)

    def perturb(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = perturb(v)
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


def _batch(tcfg, b, s, seed):
    toks = _tokens(tcfg.vocab, b, s, seed)
    tgts = _tokens(tcfg.vocab, b, s, seed + 1)
    patches = _rand((b, tcfg.prefix_tokens, tcfg.d_model), seed + 2)
    return ({"tokens": torch.from_numpy(toks).long(),
             "targets": torch.from_numpy(tgts).long(),
             "patches": torch.from_numpy(patches)},
            {"tokens": toks, "targets": tgts, "patches": patches})


@pytest.mark.parametrize("window", [None, 3])
def test_prefix_lm_attention_matches_reference(window):
    """``attention_train`` with ``prefix_len``: the mask ``causal | j <
    prefix_len`` (windowed too) under GQA, the plain softmax, against
    the reference's; the prefix positions attend to the whole prefix."""
    import jax.numpy as jnp
    from repro.models import layers as jl
    lp = {k: {"w": v["w"][0]} for k, v in _tree()["layers"]["attn"].items()}
    x = _rand((2, 9, 64), 1)
    kw = dict(n_q=4, n_kv=1, head_dim=16, prefix_len=4, window=window)
    got = layers.attention_train(from_jax_params(lp, "cpu"),
                                 torch.from_numpy(x), **kw)
    want = jl.attention_train(_jnp(lp), jnp.asarray(x), **kw)
    _close(got, want)
    plain = layers.attention_train(from_jax_params(lp, "cpu"),
                                   torch.from_numpy(x), **dict(
                                       kw, prefix_len=None))
    assert float((got[:, :3] - plain[:, :3]).abs().max()) > 1e-3
    if window is None:
        assert torch.equal(got[:, 4:], plain[:, 4:])


def test_init_params_has_the_reference_tree():
    """The prefix-LM family holds the dense tree (reduced widths); the
    reference's values carried across by ``from_jax_params`` byte for
    byte."""
    import jax
    from repro.models import init_params as jinit
    from repro.models import split_tree
    jcfg, tcfg = _cfgs()
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), split_tree(
        jax.eval_shape(lambda: jinit(jcfg, jax.random.PRNGKey(0))))[0])
    got = jax.tree.map(lambda a: (tuple(a.shape),
                                  str(a.dtype).replace("torch.", "")),
                       init_params(tcfg, 0, device="cpu"))
    assert got == want and sorted(got) == ["embed", "layers", "ln_f"]
    assert_trees_equal(from_jax_params(_tree(), "cpu"), _tree())


def test_forward_train_loss_and_grads_match_reference():
    """forward_train ([patches; scaled tokens] under the prefix-LM mask,
    the text positions' logits), loss_fn and every weight's gradient
    against jax.grad."""
    import jax
    import jax.numpy as jnp
    from repro.models import forward_train as jfwd
    from repro.models import loss_fn as jloss
    jcfg, tcfg = _cfgs()
    tree = _tree()
    tb, nb = _batch(tcfg, 2, 7, seed=2)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tp = from_jax_params(tree, "cpu")
    got = forward_train(tcfg, tp, tb)
    assert got.shape == (2, 7, tcfg.vocab)
    _close(got, jax.jit(functools.partial(jfwd, jcfg))(_jnp(tree), jb))
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


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_step_matches_reference(per_slot):
    """The prefix-LM family decodes as the dense one (scaled embeddings,
    GQA, rope at each slot's position): logits of every step and the
    final cache against the reference's decode_step on the packed int4
    tree, lockstep and per-slot."""
    import jax
    import jax.numpy as jnp
    from repro.models import decode_step as jstep
    from repro.models import init_cache as jcache
    jcfg, tcfg = _cfgs()
    tree = _tree("int4")
    toks = _tokens(tcfg.vocab, 3, 5, seed=4)
    pos0 = [0, 4, 9] if per_slot else 2
    jc = jcache(jcfg, 3, 16, jnp.float32, per_slot=per_slot)._replace(
        pos=jnp.asarray(pos0, jnp.int32))
    tc = init_cache(tcfg, 3, 16, torch.float32, per_slot=per_slot,
                    device="cpu")._replace(
        pos=torch.tensor(pos0, dtype=torch.int32))
    step = jax.jit(lambda p, c, t: jstep(jcfg, p, c, t))
    params, jparams = split_layers(from_jax_params(tree, "cpu")), _jnp(tree)
    for j in range(toks.shape[1]):
        want, jc = step(jparams, jc, jnp.asarray(toks[:, j:j + 1]))
        got, tc = decode_step(tcfg, params, tc,
                              torch.from_numpy(toks[:, j:j + 1]))
        _close(got, want)
    assert_trees_close(tc.kv, jc.kv, tol=TOL, relative=True)
    np.testing.assert_array_equal(to_numpy(tc.pos), np.asarray(jc.pos))


# -- the exact prefill --------------------------------------------------------


@pytest.mark.parametrize("fmt", ["fp", "int4"])
def test_prefill_caches_the_prefix_and_continues_forward_train(fmt):
    """The port's prefill writes the post-rope K/V of all P + S positions
    (P = 4 patches, S = 3 tokens) at position P + S; its last logits and
    the next step's are ``forward_train``'s over [patches; tokens + next]
    (every text position attends to the whole prefix, so decode steps
    continue the prefix-LM pass).  The reference's prefill
    caches only the S text rows, unnormed and unroped, so its next logits
    are far off (ROADMAP queue C)."""
    import jax.numpy as jnp
    from repro.models import decode_step as jstep
    from repro.models import prefill as jprefill
    jcfg, tcfg = _cfgs()
    tree = _tree(fmt)
    tb, nb = _batch(tcfg, 2, 3, seed=6)
    nxt = _tokens(tcfg.vocab, 2, 1, seed=7)
    params = from_jax_params(tree, "cpu")
    lg, cache = prefill(tcfg, params, tb, 16, torch.float32)
    assert int(cache.pos) == 7
    written = (cache.kv.k.abs().amax(dim=(0, 1, 3, 4)) > 0).tolist()
    assert written == [True] * 7 + [False] * 9
    nlg, _ = decode_step(tcfg, params, cache,
                         torch.from_numpy(nxt).long())
    ext = dict(tb, tokens=torch.cat([tb["tokens"],
                                     torch.from_numpy(nxt).long()], 1))
    full = forward_train(tcfg, params, ext)
    _close(lg, full[:, -2])
    _close(nlg, full[:, -1])
    if fmt == "fp":
        jl, jc = jprefill(jcfg, _jnp(tree), {
            "tokens": jnp.asarray(nb["tokens"]),
            "patches": jnp.asarray(nb["patches"])}, 16, jnp.float32)
        assert int(jc.pos) == 7
        assert int((np.abs(np.asarray(jc.kv.k)).max(axis=(0, 1, 3, 4)) > 0)
                   .sum()) == 3
        _close(lg, jl)
        jn, _ = jstep(jcfg, _jnp(tree), jc, jnp.asarray(nxt))
        full_np = full[:, -1].detach().numpy()
        assert float(np.abs(np.asarray(jn) - full_np).max()) \
            > 0.1 * float(np.abs(full_np).max())


def test_int8_kv_prefill_writes_q8_of_the_f32_prefill(monkeypatch):
    """Under ``int8_kv`` the prefill's K/V of all P + S positions are
    ``q8`` of the f32 prefill's, bit for bit, with their scales."""
    from repro_torch.models.layers import q8
    _, tcfg = _cfgs()
    params = from_jax_params(_tree("int4"), "cpu")
    tb, _ = _batch(tcfg, 2, 3, seed=9)
    lg32, c32 = prefill(tcfg, params, tb, 16, torch.float32)
    monkeypatch.setenv("REPRO_OPTS", "int8_kv")
    lg8, c8 = prefill(tcfg, params, tb, 16, torch.float32)
    assert torch.equal(lg8, lg32) and int(c8.pos) == 7
    for codes, scale, f32 in ((c8.kv.k, c8.kv.k_scale, c32.kv.k),
                              (c8.kv.v, c8.kv.v_scale, c32.kv.v)):
        want_c, want_s = q8(f32[:, :, :7])
        assert codes.dtype == torch.int8
        assert torch.equal(codes[:, :, :7], want_c)
        assert torch.equal(scale[:, :, :7], want_s)


def test_prefill_refuses_what_the_cache_cannot_hold():
    _, tcfg = _cfgs()
    params = init_params(tcfg, 0, device="cpu")
    tb, _ = _batch(tcfg, 1, 5, seed=8)
    with pytest.raises(ValueError, match="exceed"):
        prefill(tcfg, params, tb, 8, torch.float32)
    with pytest.raises(ValueError, match="patches"):
        prefill(tcfg, params, {"tokens": tb["tokens"]}, 16, torch.float32)


# -- quantization -------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantize_inventory_matches_reference(fmt):
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
    assert payload_checksums(got) == jcrc(_jnp(want))
    assert len(payload_checksums(got)) == 7


def test_ptq_refuses_the_family():
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
    """Token-only requests (no image prefix, as the reference's engines
    serve them): identical greedy streams on the int8 and packed int4
    trees, and with the int8 KV cache."""
    import jax.numpy as jnp
    from repro import serve as jserve
    if fmt.endswith("int8_kv"):
        monkeypatch.setenv("REPRO_OPTS", "int8_kv")
    jcfg, tcfg = _cfgs()
    jstep, jchunk = _jax_fns()
    tree = _tree(fmt.split("_")[0])
    workload = random_workload(51, tcfg.vocab)
    kw = _engine_kw(continuous)
    jeng = (jserve.ContinuousEngine if continuous else jserve.ServeEngine)(
        jcfg, _jnp(tree), config=jserve.EngineConfig(
            cache_dtype=jnp.float32, decode_fn=jstep, decode_chunk_fn=jchunk,
            **kw))
    want = drive_engine(jeng, workload, continuous, jserve.Request)
    teng = (ContinuousEngine if continuous else ServeEngine)(
        tcfg, from_jax_params(tree, "cpu"),
        config=EngineConfig(cache_dtype=torch.float32, **kw))
    assert drive_engine(teng, workload, continuous, Request) == want


def test_continuous_equals_static_in_the_port():
    tcfg = _cfgs()[1]
    tree = from_jax_params(_tree("int4"), "cpu")
    workload = random_workload(52, tcfg.vocab)
    ref = drive_engine(ServeEngine(tcfg, tree, config=EngineConfig(
        **_engine_kw(False))), workload, False, Request)
    out = drive_engine(ContinuousEngine(tcfg, tree, config=EngineConfig(
        **_engine_kw(True))), workload, True, Request)
    assert out == ref


def test_serve_driver_runs_the_family_on_cpu():
    from repro_torch.launch import serve
    done = serve.main(["--arch", ARCH, "--reduced", "--wbits", "4",
                       "--requests", "3", "--max-new", "3", "--device",
                       "cpu"])
    assert len(done) == 3
    assert all(len(r.out_tokens) == 3 and max(r.out_tokens) < 256
               for r in done)
