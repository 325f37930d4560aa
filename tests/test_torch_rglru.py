"""The port's RG-LRU block and the hybrid family held against the JAX
package.

Reduced recurrentgemma-2b (d 64, lru 64, the (rec, rec, attn) pattern
once, 4 query heads over 1 KV head of 16) and a 5-layer copy whose last
two recurrent layers form the unstacked ``tail``, with the reference's
weights (gate biases and norm scales perturbed with numpy so they
matter), converted with ``from_jax_params``; the engines serve
tests/test_continuous_batching.py's ``CFG_HYB`` (window 6).

Tolerances: block outputs rtol = atol = 1e-5 of their largest entry (the
doubling scan meets the reference's associative scan's sums in another
order), the gated input 1e-3 (√(1 − a²) cancels as a → 1); Λ 1e-5
relative (see ``rglru.rglru_lambda``); model logits and
states 1e-4 of their largest entry, 2e-2 with a bf16 cache; parallel
prefill against stepped at the reference's rtol 1e-4 / atol 1e-5, the
ring's next-step logits at its atol 1e-4 (tests/test_parallel_prefill.py);
token streams and quantized trees exactly equal.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_parity import (assert_close, assert_trees_close,
                           assert_trees_equal, drive_engine,
                           graph_kernel_names, random_workload, require_cuda,
                           to_numpy, tree_leaves)
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.models import (decode_chunk, decode_step, forward_train,
                                from_jax_params, init_cache, init_params,
                                loss_fn, prefill, rglru as rg, split_layers)
from repro_torch.models.layers import q8
from repro_torch.quant import quantize_params_tree
from repro_torch.serve import (ContinuousEngine, EngineConfig, Request,
                               ServeEngine)

ARCH = "recurrentgemma-2b"
TOL = 1e-4
BLOCK_TOL = 1e-5
BF16_TOL = 2e-2
GATE_TOL = 1e-3
CFG_HYB = dict(name="cbh", family="hybrid", n_layers=3, d_model=32,
               n_heads=2, n_kv=1, d_ff=64, vocab=64, head_dim=16,
               block_pattern=("rec", "rec", "attn"), local_window=6,
               lru_width=32, conv_width=4, activation="gelu",
               gated_mlp=True, embed_scale=True, subquadratic=True)
FORMATS = {"fp": None, "int8": dict(nbits=8),
           "int4": dict(nbits=4, packed=True)}
#: reduced (one group), 5 layers (one group + a 2-layer tail), and the
#: reference's ring test's window of 8
DEPTHS = {"reduced": {}, "tail": dict(n_layers=5),
          "ring": dict(local_window=8)}


def _cfgs(depth="reduced"):
    from repro.configs import get_config
    return (dataclasses.replace(get_config(ARCH).reduced(), **DEPTHS[depth]),
            dataclasses.replace(tget_config(ARCH).reduced(),
                                **DEPTHS[depth]))


@functools.lru_cache(maxsize=None)
def _tree(fmt="fp", depth="reduced"):
    """The reference's value tree (numpy leaves) with perturbed gate
    biases and norm scales, optionally quantized at min_dim 8.  One
    reference init per layer count: the window does not enter the
    weights, so the ring config shares the reduced one's."""
    import jax
    from repro.models import init_params as jinit
    from repro.models import split_tree

    if depth == "ring":
        return _tree(fmt, "reduced")
    if FORMATS[fmt] is not None:
        return _quantized(_tree("fp", depth), 8, fmt)
    base = to_numpy(split_tree(jax.jit(functools.partial(
        jinit, _cfgs(depth)[0]))(jax.random.PRNGKey(0)))[0])
    rng = np.random.default_rng(3)

    def perturb(node):
        if isinstance(node, list):
            return [perturb(v) for v in node]
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = perturb(v)
            elif k == "b":
                out[k] = (rng.standard_normal(v.shape) * 0.3).astype(v.dtype)
            elif k == "scale":
                out[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(
                    v.dtype)
            else:
                out[k] = v
        return out

    return perturb(base)


def _quantized(base, min_dim, fmt):
    """The served tree: the port's quantizer, whose bytes equal the
    reference's (tests/test_torch_models.py holds them), is much quicker
    on the CPU than the reference's eager one."""
    return to_numpy(quantize_params_tree(from_jax_params(base, "cpu"),
                                         min_dim=min_dim, **FORMATS[fmt]))


def _jnp(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


def _rec0(tree):
    """The first recurrent block of a tree (group 0's ``b0.rec``)."""
    def cut(node):
        if isinstance(node, dict):
            return {k: cut(v) for k, v in node.items()}
        return node[0]
    return cut(tree["groups"]["b0"]["rec"])


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close(got, want, tol):
    assert tuple(got.shape) == tuple(want.shape)
    w = to_numpy(want)
    assert_close(got, w, tol=tol * max(1.0, float(np.abs(w).max())))


# -- block functions ----------------------------------------------------------


def test_lambda_gates_and_conv_match_reference():
    """Λ from the linspace formula, _gates (the biased w_a/w_x through
    dense) and the causal depthwise _conv1d."""
    import jax
    import jax.numpy as jnp
    from repro.models import rglru as jrg
    lp = _rec0(_tree())
    want_lam = np.asarray(jnp.log(jnp.expm1(-jnp.log(jnp.linspace(
        0.9, 0.999, 64, dtype=jnp.float32)) / jrg.RG_LRU_C)))
    np.testing.assert_allclose(rg.rglru_lambda(64).numpy(), want_lam,
                               rtol=1e-5)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    tp = from_jax_params(lp, "cpu")
    a, gx = rg._gates(tp, torch.from_numpy(x))
    want_a, want_gx = jax.jit(jrg._gates)(_jnp(lp), jnp.asarray(x))
    _close(a, want_a, BLOCK_TOL)
    # √(1 − a²) cancels where a gate closes (a → 1): an ulp of a moves the
    # gated input by up to √(2·ulp) ≈ 3.5e-4 of |i·x|
    _close(gx, want_gx, GATE_TOL)
    _close(rg._conv1d(torch.from_numpy(x), tp["conv_w"]),
           jrg._conv1d(jnp.asarray(x), jnp.asarray(lp["conv_w"])), BLOCK_TOL)


@pytest.mark.parametrize("fmt", ["fp", "int4"])
@pytest.mark.parametrize("fn", ["train", "decode_float32", "decode_bfloat16"])
def test_block_functions_match_reference(fn, fmt):
    """rglru_train (with its final state) and rglru_decode from an f32 and
    a bf16 state, on the first recurrent block of the tree (fp, packed
    int4), against the reference on the same numpy inputs."""
    import jax
    import jax.numpy as jnp
    from repro.models import rglru as jrg
    lp = _rec0(_tree(fmt))
    jp, tp = _jnp(lp), from_jax_params(lp, "cpu")
    rng = np.random.default_rng(1)
    u = rng.standard_normal((3, 9, 64)).astype(np.float32)
    if fn == "train":
        want_y, want_st = jax.jit(functools.partial(
            jrg.rglru_train, return_state=True))(jp, jnp.asarray(u))
        got_y, got_st = rg.rglru_train(tp, torch.from_numpy(u),
                                       return_state=True)
        assert torch.equal(rg.rglru_train(tp, torch.from_numpy(u)), got_y)
        _close(got_y, want_y, BLOCK_TOL)
        for g, w in zip(got_st, want_st):
            _close(g, w, BLOCK_TOL)
        return
    dt = fn.split("_")[1]
    h = rng.standard_normal((3, 64)).astype(np.float32)
    conv = rng.standard_normal((3, 3, 64)).astype(np.float32)
    jst = jrg.RGLRUState(h=jnp.asarray(h, getattr(jnp, dt)),
                         conv=jnp.asarray(conv, getattr(jnp, dt)))
    tst = rg.RGLRUState(h=torch.from_numpy(h).to(getattr(torch, dt)),
                        conv=torch.from_numpy(conv).to(getattr(torch, dt)))
    want_y, want_st = jax.jit(jrg.rglru_decode)(jp, jnp.asarray(u[:, :1]),
                                                jst)
    got_y, got_st = rg.rglru_decode(tp, torch.from_numpy(u[:, :1]), tst)
    tol = BLOCK_TOL if dt == "float32" else BF16_TOL
    _close(got_y, want_y, tol)
    for g, w in zip(got_st, want_st):
        assert str(g.dtype) == f"torch.{dt}"
        _close(g.float(), np.asarray(w, np.float32), tol)


def test_rglru_init_and_state_have_the_reference_tree():
    """rglru_init unstacked and stacked, and rglru_init_state: the
    reference's keys, shapes and dtypes."""
    import jax
    from repro.models import rglru as jrg
    from repro.models import split_tree

    def shapes(tree, torch_side):
        if torch_side:
            return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)
                                           .replace("torch.", "")), tree)
        return jax.tree.map(lambda a: (a.shape, str(a.dtype)), tree)

    def normal(shape, std):
        return torch.randn(shape) * std
    for stack in (None, 2):
        want = shapes(split_tree(jax.eval_shape(lambda: jrg.rglru_init(
            jax.random.PRNGKey(0), 64, 48, stack=stack)))[0], False)
        assert shapes(rg.rglru_init(normal, 64, 48, stack=stack),
                      True) == want
    assert shapes(tuple(rg.rglru_init_state(3, 48)), True) == \
        shapes(tuple(jax.eval_shape(lambda: jrg.rglru_init_state(3, 48))),
               False)


# -- the model ----------------------------------------------------------------


def test_forward_train_and_loss_match_reference(depth="tail"):
    import jax
    import jax.numpy as jnp
    from repro.models import forward_train as jfwd
    from repro.models import loss_fn as jloss
    jcfg, tcfg = _cfgs(depth)
    tree = _tree("fp", depth)
    toks = _tokens(tcfg.vocab, 2, 9, seed=2)
    tgts = _tokens(tcfg.vocab, 2, 9, seed=3)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "targets": torch.from_numpy(tgts).long()}
    tp = from_jax_params(tree, "cpu")
    _close(forward_train(tcfg, tp, tb),
           jax.jit(functools.partial(jfwd, jcfg))(_jnp(tree), jb), TOL)
    want_loss = jax.jit(functools.partial(jloss, jcfg))(_jnp(tree), jb)
    assert abs(float(loss_fn(tcfg, tp, tb)) - float(want_loss)) < TOL


def test_port_init_holds_the_tail():
    """The port's init of the 5-layer hybrid and of recurrentgemma-2b's
    shape: one stacked group per pattern repetition, the rest in
    ``tail`` (26 layers: 8 groups and 2 recurrent tail layers)."""
    import jax
    from repro.models import init_params as jinit
    from repro.models import split_tree
    jcfg, tcfg = _cfgs("tail")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), split_tree(
        jax.eval_shape(lambda: jinit(jcfg, jax.random.PRNGKey(0))))[0])
    got = jax.tree.map(lambda a: (tuple(a.shape),
                                  str(a.dtype).replace("torch.", "")),
                       init_params(tcfg, 0, device="cpu"))
    assert got == want and len(got["tail"]) == 2
    full = tget_config(ARCH)
    assert full.n_layers // 3 == 8 and full._layer_types()[-2:] == \
        ("rec", "rec")


def _jax_steps(jcfg, tree, toks, max_len, dtype, pos0=None):
    import jax
    import jax.numpy as jnp
    from repro.models import decode_step as jstep
    from repro.models import init_cache as jcache
    cache = jcache(jcfg, toks.shape[0], max_len, dtype,
                   per_slot=pos0 is not None)
    if pos0 is not None:
        cache = cache._replace(pos=jnp.asarray(pos0, jnp.int32))
    step = jax.jit(lambda p, c, t: jstep(jcfg, p, c, t))
    out = []
    params = _jnp(tree)
    for j in range(toks.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(toks[:, j:j + 1]))
        out.append(np.asarray(logits))
    return out, cache


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype, per_slot, depth="tail"):
    """Logits of every step and the final cache ({"kv": the windowed
    ring, "rec": RG-LRU h and conv}) against the reference's decode_step,
    lockstep and per-slot (a slot wrapping the 8-slot ring); packed int4
    through B1's twin.  The 5-layer hybrid: the reduced 3-layer one is in
    tests/test_torch_models.py."""
    import jax.numpy as jnp
    jcfg, tcfg = _cfgs(depth)
    tcfg = dataclasses.replace(tcfg, local_window=8)
    jcfg = dataclasses.replace(jcfg, local_window=8)
    tree = _tree("int4", depth)
    toks = _tokens(tcfg.vocab, 3, 6, seed=4)
    pos0 = [0, 3, 9] if per_slot else None
    want, jc = _jax_steps(jcfg, tree, toks, 16, getattr(jnp, dtype), pos0)
    params = from_jax_params(tree, "cpu")
    cache = init_cache(tcfg, 3, 16, getattr(torch, dtype),
                       per_slot=per_slot, device="cpu")
    if per_slot:
        cache = cache._replace(pos=torch.tensor(pos0, dtype=torch.int32))
    tol = TOL if dtype == "float32" else BF16_TOL
    for j in range(toks.shape[1]):
        logits, cache = decode_step(tcfg, params, cache,
                                    torch.from_numpy(toks[:, j:j + 1]))
        assert_trees_close(logits, want[j], tol=tol, relative=True)
    assert sorted(cache.kv) == ["kv", "rec"]
    assert cache.kv["rec"].h.shape[0] == tcfg.n_layers - 1
    assert_trees_close(cache.kv, jc.kv, tol=tol, relative=True)
    np.testing.assert_array_equal(to_numpy(cache.pos), np.asarray(jc.pos))


def test_decode_chunk_matches_reference_and_its_steps(depth="tail"):
    import jax.numpy as jnp
    from repro.models import decode_chunk as jchunk
    from repro.models import init_cache as jcache
    jcfg, tcfg = _cfgs(depth)
    tree = _tree("int8", depth)
    toks = _tokens(tcfg.vocab, 2, 7, seed=5)
    want_l, want = jchunk(jcfg, _jnp(tree), jcache(jcfg, 2, 16, jnp.float32),
                          jnp.asarray(toks))
    params = from_jax_params(tree, "cpu")
    tt = torch.from_numpy(toks)
    la, a = decode_chunk(tcfg, params, init_cache(tcfg, 2, 16, torch.float32,
                                                  device="cpu"), tt)
    _close(la, want_l, TOL)
    assert_trees_close(a.kv, want.kv, tol=TOL, relative=True)
    b = init_cache(tcfg, 2, 16, torch.float32, device="cpu")
    split = split_layers(params)
    assert isinstance(split["groups"], list) and split["tail"] is \
        params["tail"]
    for j in range(toks.shape[1]):
        lb, b = decode_step(tcfg, split, b, tt[:, j:j + 1])
    assert torch.equal(la, lb)
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a.kv), tree_leaves(b.kv)))


@pytest.mark.parametrize("mode", ["stepped", "parallel"])
def test_prefill_matches_reference(mode, monkeypatch, depth="tail"):
    """Each prefill mode against the reference's same mode: last logits
    and every cache leaf."""
    import jax
    import jax.numpy as jnp
    from repro.models import prefill as jprefill
    if mode == "parallel":
        monkeypatch.setenv("REPRO_OPTS", "parallel_prefill")
    jcfg, tcfg = _cfgs(depth)
    tree = _tree("int4", depth)
    toks = _tokens(tcfg.vocab, 2, 11, seed=6)
    want_l, want = jax.jit(lambda p, t: jprefill(jcfg, p, {"tokens": t}, 16,
                                                 jnp.float32))(
        _jnp(tree), jnp.asarray(toks))
    logits, cache = prefill(tcfg, from_jax_params(tree, "cpu"),
                            {"tokens": torch.from_numpy(toks)}, 16,
                            torch.float32)
    _close(logits, want_l, TOL)
    assert_trees_close(cache.kv, want.kv, tol=TOL, relative=True)
    assert int(cache.pos) == int(want.pos) == 11


@pytest.mark.parametrize("depth", ["reduced", "tail"])
def test_parallel_prefill_equals_stepped(depth, monkeypatch):
    """In the port: parallel against stepped prefill, logits, cache and
    the next decode step (the reference's test and tolerance)."""
    _, tcfg = _cfgs(depth)
    params = from_jax_params(_tree("fp", depth), "cpu")
    toks = {"tokens": torch.from_numpy(_tokens(tcfg.vocab, 2, 12, seed=7))}
    lg_s, c_s = prefill(tcfg, params, toks, 16, torch.float32)
    monkeypatch.setenv("REPRO_OPTS", "parallel_prefill")
    lg_p, c_p = prefill(tcfg, params, toks, 16, torch.float32)
    monkeypatch.delenv("REPRO_OPTS")
    np.testing.assert_allclose(lg_p.numpy(), lg_s.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert_trees_close(c_p.kv, c_s.kv, tol=TOL, relative=True)
    tok = torch.zeros((2, 1), dtype=torch.long)
    l1, _ = decode_step(tcfg, params, c_s, tok)
    l2, _ = decode_step(tcfg, params, c_p, tok)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=1e-4, atol=1e-5)


def test_ring_fill_alignment(monkeypatch):
    """Window 8, 13 prompt tokens: the parallel prefill fills the ring at
    slot p mod 8 (positions 5..12), as decode steps do; the next step's
    logits agree (the reference's ring test), and so does the reference's
    own parallel ring."""
    import jax.numpy as jnp
    from repro.models import prefill as jprefill
    jcfg, tcfg = _cfgs("ring")
    params = from_jax_params(_tree("fp", "ring"), "cpu")
    toks = _tokens(tcfg.vocab, 1, 13, seed=8)
    batch = {"tokens": torch.from_numpy(toks)}
    _, c_s = prefill(tcfg, params, batch, 32, torch.float32)
    monkeypatch.setenv("REPRO_OPTS", "parallel_prefill")
    _, c_p = prefill(tcfg, params, batch, 32, torch.float32)
    _, jc = jprefill(jcfg, _jnp(_tree("fp", "ring")),
                     {"tokens": jnp.asarray(toks)}, 32, jnp.float32)
    monkeypatch.delenv("REPRO_OPTS")
    assert c_p.kv["kv"].k.shape[2] == 8
    assert_trees_close(c_p.kv, c_s.kv, tol=TOL, relative=True)
    assert_trees_close(c_p.kv, jc.kv, tol=TOL, relative=True)
    tok = torch.zeros((1, 1), dtype=torch.long)
    l1, _ = decode_step(tcfg, params, c_s, tok)
    l2, _ = decode_step(tcfg, params, c_p, tok)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=1e-4, atol=1e-4)


def test_int8_kv_parallel_prefill_keeps_the_int8_cache(monkeypatch):
    """Under ``int8_kv,parallel_prefill`` the reference's parallel hybrid
    prefill returns a float32 K/V cache without scales (ROADMAP queue C);
    the port's writes int8 codes with scales: ``q8`` of its f32 parallel
    prefill's K/V bit for bit, and the codes and scales of its stepped
    int8 prefill (the one attention layer sees the same inputs either
    way, up to f32 rounding)."""
    import jax.numpy as jnp
    from repro.models import prefill as jprefill
    jcfg, tcfg = _cfgs("ring")
    tree = _tree("int4", "ring")
    params = from_jax_params(tree, "cpu")
    toks = _tokens(tcfg.vocab, 2, 13, seed=9)
    batch = {"tokens": torch.from_numpy(toks)}
    monkeypatch.setenv("REPRO_OPTS", "int8_kv,parallel_prefill")
    _, jc = jprefill(jcfg, _jnp(tree), {"tokens": jnp.asarray(toks)}, 32,
                     jnp.float32)
    assert jc.kv["kv"].k.dtype == jnp.float32 and jc.kv["kv"].k_scale == ()
    lg8, c8 = prefill(tcfg, params, batch, 32, torch.float32)
    monkeypatch.setenv("REPRO_OPTS", "int8_kv")
    _, c8s = prefill(tcfg, params, batch, 32, torch.float32)
    monkeypatch.setenv("REPRO_OPTS", "parallel_prefill")
    lg, c32 = prefill(tcfg, params, batch, 32, torch.float32)
    kv8, kv8s, kv32 = c8.kv["kv"], c8s.kv["kv"], c32.kv["kv"]
    assert kv8.k.dtype == torch.int8 and kv8.k_scale.dtype == torch.float32
    assert torch.equal(lg8, lg)
    for codes, scale, f32 in ((kv8.k, kv8.k_scale, kv32.k),
                              (kv8.v, kv8.v_scale, kv32.v)):
        want_c, want_s = q8(f32)
        assert torch.equal(codes, want_c) and torch.equal(scale, want_s)
    for a, b in ((kv8.k, kv8s.k), (kv8.v, kv8s.v)):
        assert int((a.int() - b.int()).abs().max()) <= 1
        assert float((a != b).float().mean()) < 0.01
    assert_trees_close((kv8.k_scale, kv8.v_scale),
                       (kv8s.k_scale, kv8s.v_scale), tol=TOL, relative=True)
    assert_trees_close(c8.kv["rec"], c8s.kv["rec"], tol=TOL, relative=True)


def test_quantized_leaves_take_every_projection():
    """At min_dim 8 all 21 denses of the reduced hybrid are code leaves:
    per recurrent layer w_in w_a w_x w_out and the 3 MLP, on the
    attention layer wq wk wv wo and the 3 MLP; Λ, the conv taps and the
    gate biases stay float."""
    from repro_torch.kernels.dequant import payload_checksums
    tree = quantize_params_tree(from_jax_params(_tree(), "cpu"), min_dim=8,
                                nbits=4, packed=True)
    paths = payload_checksums(tree)
    mlp = ("mlp/w_gate/w", "mlp/w_up/w", "mlp/w_out/w")
    rec = ("rec/w_in/w", "rec/w_a/w", "rec/w_x/w", "rec/w_out/w")
    attn = ("attn/wq/w", "attn/wk/w", "attn/wv/w", "attn/wo/w")
    assert sorted(paths) == sorted(
        f"groups/{b}/{leaf}" for b, kinds in (("b0", rec), ("b1", rec),
                                              ("b2", attn))
        for leaf in kinds + mlp)
    tail = quantize_params_tree(from_jax_params(_tree("fp", "tail"), "cpu"),
                                min_dim=8, nbits=8)
    assert sum(p.startswith("tail/") for p in payload_checksums(tail)) == 14


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_tail_tree_quantizes_like_the_reference(fmt):
    """quantize_params_tree of the 5-layer hybrid (stacked groups and the
    unstacked tail list) against the reference's: byte-identical leaves,
    the same inventory and payload checksums."""
    import jax
    from repro.kernels.dequant.ops import payload_checksums as jcrc
    from repro.quant import leaf_inventory as jinv
    from repro.quant import quantize_params_tree as jquant
    from repro_torch.kernels.dequant import payload_checksums
    from repro_torch.quant import leaf_inventory
    base = _tree("fp", "tail")
    want = to_numpy(jquant(jax.tree.map(jax.numpy.asarray, base), min_dim=8,
                           **FORMATS[fmt]))
    got = quantize_params_tree(from_jax_params(base, "cpu"), min_dim=8,
                               **FORMATS[fmt])
    assert_trees_equal(got, want)
    jwant = _jnp(want)
    assert leaf_inventory(got) == jinv(jwant)
    assert payload_checksums(got) == jcrc(jwant)


# -- the engines --------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_fns():
    import jax
    from repro.configs.base import ArchConfig
    from repro.models import decode_chunk as jchunk
    from repro.models import decode_step as jstep
    cfg = ArchConfig(**CFG_HYB)
    return (cfg, jax.jit(lambda p, c, t: jstep(cfg, p, c, t)),
            jax.jit(lambda p, c, t: jchunk(cfg, p, c, t)))


@functools.lru_cache(maxsize=None)
def _engine_tree(fmt):
    import jax
    from repro.models import init_params as jinit
    from repro.models import split_tree
    if fmt != "fp":
        return _quantized(_engine_tree("fp"), 16, fmt)
    return to_numpy(split_tree(jax.jit(functools.partial(
        jinit, _jax_fns()[0]))(jax.random.PRNGKey(0)))[0])


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("fmt", ["fp", "int4"])
def test_engine_streams_match_reference(fmt, continuous):
    """vs repro.serve's engines on test_continuous_batching's hybrid
    config (window 6 over max_len 24: the ring wraps) and workload."""
    import jax.numpy as jnp
    from repro import serve as jserve
    jcfg, jstep, jchunk = _jax_fns()
    tree = _engine_tree(fmt)
    workload = random_workload(31, CFG_HYB["vocab"])
    kw = dict(n_slots=3 if continuous else 4, max_len=24, prefill_chunk=3)
    jeng = (jserve.ContinuousEngine if continuous else jserve.ServeEngine)(
        jcfg, _jnp(tree), config=jserve.EngineConfig(
            cache_dtype=jnp.float32, decode_fn=jstep, decode_chunk_fn=jchunk,
            **kw))
    want = drive_engine(jeng, workload, continuous, jserve.Request)
    teng = (ContinuousEngine if continuous else ServeEngine)(
        TArchConfig(**CFG_HYB), from_jax_params(tree, "cpu"),
        config=EngineConfig(cache_dtype=torch.float32, **kw))
    assert drive_engine(teng, workload, continuous, Request) == want


@pytest.mark.parametrize("reset", [False, True])
def test_continuous_equals_static_in_the_port(reset):
    """The port's continuous engine (2 slots, idle rows stepping on pad
    tokens, optional eviction hygiene) against its static oracle."""
    tree = from_jax_params(_engine_tree("int4"), "cpu")
    cfg = TArchConfig(**CFG_HYB)
    workload = random_workload(32, CFG_HYB["vocab"])
    ref = drive_engine(ServeEngine(cfg, tree, config=EngineConfig(
        n_slots=4, max_len=24, prefill_chunk=3)), workload, False, Request)
    out = drive_engine(ContinuousEngine(cfg, tree, config=EngineConfig(
        n_slots=2, max_len=24, prefill_chunk=3, reset_on_evict=reset)),
        workload, True, Request)
    assert out == ref


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_snapshot_resume_across_packages(writer, tmp_path):
    """A continuous engine snapshots its {"kv", "rec"} cache mid-run; the
    other package's engine resumes it and finishes with the
    uninterrupted run's streams."""
    import jax.numpy as jnp
    from repro import serve as jserve
    jcfg, jstep, jchunk = _jax_fns()
    tree = _engine_tree("fp")
    workload = random_workload(33, CFG_HYB["vocab"])
    kw = dict(n_slots=2, max_len=24, prefill_chunk=3)
    jkw = dict(cache_dtype=jnp.float32, decode_fn=jstep,
               decode_chunk_fn=jchunk, **kw)
    tcfg = TArchConfig(**CFG_HYB)
    ref = drive_engine(jserve.ContinuousEngine(
        jcfg, _jnp(tree), config=jserve.EngineConfig(**jkw)), workload,
        True, jserve.Request)
    ckpt = str(tmp_path / "snap")
    if writer == "jax":
        eng = jserve.ContinuousEngine(jcfg, _jnp(tree),
                                      config=jserve.EngineConfig(**jkw))
        req = jserve.Request
    else:
        eng = ContinuousEngine(tcfg, from_jax_params(tree, "cpu"),
                               config=EngineConfig(
                                   cache_dtype=torch.float32, **kw))
        req = Request
    for rid, (prompt, budget, _) in enumerate(workload):
        eng.submit(req(rid=rid, prompt=prompt.copy(), max_new_tokens=budget))
    delivered = {}
    for _ in range(4):
        delivered.update({r.rid: tuple(r.out_tokens) for r in eng.step()})
    eng.snapshot(ckpt)
    if writer == "jax":
        revived = ContinuousEngine.resume(
            ckpt, tcfg, from_jax_params(tree, "cpu"),
            config=EngineConfig(cache_dtype=torch.float32, **kw))
        assert isinstance(revived.cache.kv["rec"], rg.RGLRUState)
    else:
        revived = jserve.ContinuousEngine.resume(
            ckpt, jcfg, _jnp(tree), config=jserve.EngineConfig(**jkw))
    delivered.update({r.rid: tuple(r.out_tokens)
                      for r in revived.run_until_done()})
    assert delivered == ref


# -- on the card --------------------------------------------------------------


@pytest.mark.cuda
def test_decode_step_on_card_launches_b1_per_dense():
    """Packed int4 on CUDA, the 5-layer hybrid: one B1 launch per packed
    dense and layer per decode step (7 × 5), each a kernel node of a CUDA
    graph of the step; logits match the CPU twins'."""
    from repro_torch.kernels.dequant import LAUNCHES, reset_launches
    dev = require_cuda()
    tcfg = dataclasses.replace(tget_config(ARCH).reduced(), n_layers=5)
    tree = quantize_params_tree(init_params(tcfg, 0, device="cpu"),
                                min_dim=8, nbits=4, packed=True)
    gpu = split_layers(from_jax_params(to_numpy(tree), dev))
    tok = torch.from_numpy(_tokens(tcfg.vocab, 3, 1, seed=8)).long()
    want, _ = decode_step(tcfg, tree, init_cache(
        tcfg, 3, 16, torch.float32, device="cpu"), tok)
    cache = init_cache(tcfg, 3, 16, torch.float32, device=dev)
    reset_launches()
    tok_dev = tok.to(dev)
    got, _ = decode_step(tcfg, gpu, cache, tok_dev)
    torch.cuda.synchronize()
    assert dict(LAUNCHES)[4] == 7 * tcfg.n_layers
    assert_close(got.cpu(), want, tol=1e-3)
    names = graph_kernel_names(lambda: decode_step(tcfg, gpu, cache,
                                                   tok_dev))
    assert sum("dequant_packed" in n for n in names) == 7 * tcfg.n_layers


@pytest.mark.parametrize("wbits", [4, 8])
def test_serve_driver_serves_the_arch(wbits):
    """``launch.serve --arch recurrentgemma-2b --reduced`` on the CPU,
    continuous and static."""
    from repro_torch.launch import serve
    for extra in (["--continuous"], []):
        done = serve.main(["--arch", ARCH, "--reduced", "--wbits",
                           str(wbits), "--requests", "3", "--max-new", "3",
                           "--device", "cpu"] + extra)
        assert len(done) == 3
        assert all(len(r.out_tokens) == 3 and max(r.out_tokens) < 256
                   for r in done)


def test_ptq_and_planner_refuse_the_family():
    """Calibration, PTQ and the planner's sensitivities refuse the hybrid
    family, as the reference's do (dense or MoE only)."""
    from repro_torch.plan import model_sensitivities
    from repro_torch.quant.calibrate import forward_with_taps
    from repro_torch.quant.pipeline import PTQConfig, quantize_model
    _, tcfg = _cfgs()
    params = init_params(tcfg, 0, device="cpu")
    toks = _tokens(tcfg.vocab, 1, 4, seed=0)
    for call in (lambda: forward_with_taps(tcfg, params, toks),
                 lambda: quantize_model(tcfg, params, [toks], PTQConfig()),
                 lambda: model_sensitivities(tcfg, params, [toks])):
        with pytest.raises(NotImplementedError,
                           match="dense and MoE families only"):
            call()


def test_smoke_recurrent_phases_on_cpu(monkeypatch):
    """``chip_smoke``'s recurrent prefill and windowed-hybrid phases and
    its layer-by-layer decode check at the reduced configs on the CPU
    (the twins serve; the launch checks are the card's): parallel =
    stepped for both families, the packed tree = its dequantized model,
    the float model's rounding amplification below the tolerance,
    static = continuous with f32 and int8 KV, the int8 parallel cache q8
    of the f32 one."""
    import pathlib
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    monkeypatch.setattr(chip_smoke, "get_config",
                        lambda name: tget_config(name).reduced())
    monkeypatch.setattr(chip_smoke, "RG_WINDOW", 8)
    dev = torch.device("cpu")
    traffic = dict(n_req=3, prompt_len=12, new_tokens=4, max_len=24,
                   slots=3, chunk=4)
    for arch in ("rwkv6-7b", ARCH):
        cfg = tget_config(arch).reduced()
        params = quantize_params_tree(init_params(cfg, 0, device=dev),
                                      min_dim=8, nbits=4, packed=True)
        rec = chip_smoke.recurrent_prefill_phase(
            cfg, params, "int4", dev, n_req=3, prompt_len=12, max_len=24)
        assert rec["layerwise_rel_err"] < chip_smoke.LOGIT_TOL
        assert rec["max_end_to_end_rel_err"] < chip_smoke.LOGIT_TOL
        assert chip_smoke.launches_per_step(params) == {
            4: chip_smoke.RECURRENT_PER_LAYER[arch] * cfg.n_layers}
        tok = torch.from_numpy(_tokens(cfg.vocab, 3, 1, seed=2)).long()
        oracle = chip_smoke.dequantized_model(params)
        assert chip_smoke.layerwise_decode_check(
            cfg, params, oracle, tok, dev, 24, arch) < chip_smoke.LOGIT_TOL
        # three layers do not amplify rounding past the tolerance
        assert 0 < chip_smoke.rounding_amplification(
            cfg, oracle, tok, dev, 24) < chip_smoke.LOGIT_TOL
    win = chip_smoke.windowed_hybrid_phase(dev, **traffic)
    assert win["int8_kv"]["stepped_code_max_diff"] <= 1
    assert win["f32_streams"] and win["int8_streams"]
