"""Port of the MoE family (``repro_torch.models.layers.moe`` and the MoE
paths of ``models.transformer``, ``quant.qlinear`` and the engines) held
against the JAX package.

Models: reduced phi3.5-moe-42b-a6.6b and reduced moonshot-v1-16b-a3b
(4 experts, top-2), and moonshot cut as far but with 8 experts, top-3
(``moonshot-k3``: a token's three contributions summed in the reference's
order).  Weights are the reference's tree (``init_params`` after
``split_tree``: its keys and shapes) with every weight redrawn from numpy
at std 1/sqrt(in_features) (the reference's stacked init takes the layer
count as fan-in) and the norm scales perturbed, then converted with
``models.convert.from_jax_params``.

Tolerances: integer artifacts (payloads, codes, inventories, routing)
byte-identical; ``moe`` outputs, logits and f32 caches within 1e-5
(rtol = atol) of values divided by their largest magnitude (f32 products
summed in another order; routing decisions are equal, so no pair moves);
greedy streams identical.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_parity import (assert_close, assert_trees_equal, require_cuda,
                           to_numpy)
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels.dequant import dequantize_leaf_ref
from repro_torch.models import (decode_chunk, decode_step, forward_train,
                                from_jax_params, init_cache, init_params,
                                prefill)
from repro_torch.models.layers import moe
from repro_torch.quant import (leaf_format_histogram, leaf_inventory,
                               quantize_params_tree, qweight_bytes)
from repro_torch.quant.qlinear import _quantize_leaf_subbyte
from repro_torch.core.packing import pack_int2_planar, pack_int3_planar
from repro_torch.serve import (ContinuousEngine, EngineConfig, Request,
                               ServeEngine)

TOL = 1e-5
PHI = "phi3.5-moe-42b-a6.6b"
MOONSHOT = "moonshot-v1-16b-a3b"
ARCHS = [PHI, MOONSHOT, "moonshot-k3"]
MAX_LEN = 16


def _cfgs(arch):
    """(jax cfg, port cfg) of one test model."""
    from repro.configs import get_config
    if arch == "moonshot-k3":
        cut = dict(n_experts=8, top_k=3, name="moonshot-k3")
        return (dataclasses.replace(get_config(MOONSHOT).reduced(), **cut),
                dataclasses.replace(tget_config(MOONSHOT).reduced(), **cut))
    return get_config(arch).reduced(), tget_config(arch).reduced()


def _redraw(tree, seed):
    """The reference tree's leaves redrawn from numpy: weights normal with
    std 1/sqrt(in_features) (the embedding 0.02), norm scales 1 + 0.1·N."""
    rng = np.random.default_rng(seed)

    def draw(node, path):
        if isinstance(node, dict):
            return {k: draw(node[k], path + (k,)) for k in sorted(node)}
        shape = node.shape
        if path[-1] == "scale":
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if path[-1] == "b":
            return node
        std = 0.02 if path[0] == "embed" else shape[-2] ** -0.5
        return (rng.standard_normal(shape) * std).astype(np.float32)
    return draw(tree, ())


@functools.lru_cache(maxsize=None)
def jax_tree(arch):
    """The reference's MoE value tree (numpy leaves), redrawn."""
    import jax
    from repro.models import init_params as jinit
    from repro.models import split_tree
    jcfg, _ = _cfgs(arch)
    base = to_numpy(split_tree(jinit(jcfg, jax.random.PRNGKey(0)))[0])
    return _redraw(base, ARCHS.index(arch))


def _jnp(tree):
    import jax
    return jax.tree.map(jax.numpy.asarray, tree)


def _rel_close(got, want, tol=TOL):
    want = to_numpy(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert_close(to_numpy(got) / scale, want / scale, tol=tol)


def _tokens(vocab, b, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs, init, conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [PHI, MOONSHOT])
def test_moe_configs_match_jax(arch):
    """The port's registry holds the reference's MoE configs field for
    field, and reduces them the same way."""
    from repro.configs import get_config
    for j, t in ((get_config(arch), tget_config(arch)),
                 (get_config(arch).reduced(), tget_config(arch).reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.padded_vocab, t.resolved_head_dim) == \
            (j.padded_vocab, j.resolved_head_dim)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_params_has_the_reference_tree(arch):
    """The port's own init: the reference's keys, shapes and dtypes
    (``layers.moe`` with router, w_gate, w_up, w_out)."""
    import jax
    from repro.models import init_params as jinit
    from repro.models import split_tree
    jcfg, tcfg = _cfgs(arch)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        split_tree(jinit(jcfg, jax.random.PRNGKey(0)))[0])
    got = jax.tree.map(lambda a: (tuple(a.shape),
                                  str(a.dtype).replace("torch.", "")),
                       init_params(tcfg, 0, device="cpu"))
    assert got == want
    e, d, ff = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    assert got["layers"]["moe"]["w_up"][0] == (tcfg.n_layers, e, d, ff)
    assert got["layers"]["moe"]["w_out"][0] == (tcfg.n_layers, e, ff, d)


def test_from_jax_params_carries_the_moe_tree():
    """``from_jax_params`` moves a MoE tree unchanged: the same keys and
    the same bytes in every leaf, raw and quantized."""
    import jax
    from repro.quant import quantize_params_tree as jquant
    tree = jax_tree(PHI)
    assert_trees_equal(from_jax_params(tree, "cpu"), tree)
    unstacked = {k: v[0] for k, v in tree["layers"]["moe"].items()
                 if k != "router"}
    q = to_numpy(jquant(_jnp(unstacked), min_dim=16, nbits=4, packed=True))
    assert_trees_equal(from_jax_params(q, "cpu"), q)
    assert jax.tree.structure(_jnp(q)) == jax.tree.structure(
        _jnp(to_numpy(from_jax_params(q, "cpu"))))


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

#: (experts, top-k, capacity factor, zero router): drops forced by a low
#: factor; all gates equal (ties broken toward the lower expert index, and
#: those experts overflow); k = 3; 64 experts, top-6 (moonshot's routing)
MOE_CASES = {"drops": (4, 2, 0.5, False), "ties": (4, 2, 1.25, True),
             "k3": (8, 3, 0.9, False), "e64k6": (64, 6, 1.0, False)}


def _layer(n_experts, zero_router, seed, d=32, ff=48):
    """One unstacked MoE layer (3-D experts) and an input (3, 5, d)."""
    rng = np.random.default_rng(seed)
    p = {"router": {"w": (rng.standard_normal((d, n_experts)) * d ** -0.5
                          * (0.0 if zero_router else 1.0)).astype(
                              np.float32)},
         "w_gate": (rng.standard_normal((n_experts, d, ff)) * d ** -0.5
                    ).astype(np.float32),
         "w_up": (rng.standard_normal((n_experts, d, ff)) * d ** -0.5
                  ).astype(np.float32),
         "w_out": (rng.standard_normal((n_experts, ff, d)) * ff ** -0.5
                   ).astype(np.float32)}
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    return p, x


def _expert_qkw(fmt):
    return {"fp": None, "int8": dict(nbits=8),
            "int4": dict(nbits=4, packed=True)}[fmt]


@pytest.mark.parametrize("fmt", ["fp", "int8", "int4"])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_matches_reference(case, fmt):
    """vs repro.models.layers.moe with 3-D f32, int8 and packed-int4
    expert leaves (the leaves byte-identical to the reference's
    ``quantize_params_tree``): the same routing and drops, the output
    within TOL."""
    from repro.models.layers import moe as jmoe
    from repro.quant import quantize_params_tree as jquant
    e, k, cf, zero = MOE_CASES[case]
    p, x = _layer(e, zero, seed=sorted(MOE_CASES).index(case))
    kw = _expert_qkw(fmt)
    if kw is not None:
        experts = {k: v for k, v in p.items() if k != "router"}
        want_tree = to_numpy(jquant(_jnp(experts), min_dim=16, **kw))
        got_tree = quantize_params_tree(from_jax_params(experts, "cpu"),
                                        min_dim=16, **kw)
        assert_trees_equal(got_tree, want_tree)
        assert "codes" in want_tree["w_up"]
        p = {**want_tree, "router": p["router"]}
    want = jmoe(_jnp(p), _jnp(x), n_experts=e, top_k=k, capacity_factor=cf)
    got = moe(from_jax_params(p, "cpu"), torch.from_numpy(x), n_experts=e,
              top_k=k, capacity_factor=cf)
    assert got.shape == x.shape
    _rel_close(got, want)


def test_moe_ties_pick_the_lower_experts():
    """A zero router makes every gate 1/E: each token takes experts 0..k-1
    (jax.lax.top_k's order), so with capacity C only the first C tokens
    reach them and the output of every later token is exactly 0."""
    e, k = 4, 2
    p, x = _layer(e, True, seed=3)
    t = x.shape[0] * x.shape[1]
    out = moe(from_jax_params(p, "cpu"), torch.from_numpy(x), n_experts=e,
              top_k=k, capacity_factor=1.0).reshape(t, -1)
    cap = int(np.ceil(t * k / e))
    assert torch.count_nonzero(out[:cap].abs().sum(-1)) == cap
    assert torch.equal(out[cap:], torch.zeros_like(out[cap:]))


@pytest.mark.parametrize("nbits", [3, 2])
def test_moe_refuses_int2_int3_experts_and_packed_escapes(nbits):
    """int2/int3 expert leaves and packed expert escapes are refused, as
    the reference's asserts refuse them; ``quantize_params_tree`` serves
    an int2/int3 request for experts as packed int4 (byte-identical to the
    reference's promotion)."""
    from repro.models.layers import moe as jmoe
    from repro.quant import quantize_params_tree as jquant
    p, x = _layer(4, False, seed=7)
    tp = from_jax_params(p, "cpu")
    qmax, mult, packer = {3: (3.0, 8, pack_int3_planar),
                          2: (1.0, 4, pack_int2_planar)}[nbits]
    bad = {**tp, "w_up": _quantize_leaf_subbyte(tp["w_up"], qmax=qmax,
                                                 pad_mult=mult, packer=packer)}
    with pytest.raises(ValueError, match="int2/int3"):
        moe(bad, torch.from_numpy(x), n_experts=4, top_k=2)
    with pytest.raises(AssertionError, match="int2/int3"):
        jmoe(_jnp(to_numpy(bad)), _jnp(x), n_experts=4, top_k=2)
    promoted = quantize_params_tree(tp, min_dim=16, nbits=nbits)
    want = to_numpy(jquant(_jnp(p), min_dim=16, nbits=nbits))
    assert_trees_equal(promoted, want)
    assert leaf_format_histogram(promoted) == {"float32": 1,
                                               "packed-int4": 3}
    esc = dict(promoted["w_up"])
    esc["esc_row"] = torch.zeros((4, 1), dtype=torch.int32)
    esc["esc_col"] = torch.zeros((4, 1), dtype=torch.int32)
    esc["esc_dval"] = torch.zeros((4, 1), dtype=torch.float32)
    with pytest.raises(ValueError, match="escape"):
        moe({**promoted, "w_up": esc}, torch.from_numpy(x), n_experts=4,
            top_k=2)


def test_quantized_router_runs_through_dense():
    """With 64 experts the (d, 64) router passes min_dim and becomes a
    packed leaf.  The reference's ``moe`` then multiplies the leaf dict
    and raises AttributeError (ROADMAP queue C); the port computes the
    logits through ``layers.dense`` (B1 on the card) and equals the
    reference's ``moe`` given the dequantized router."""
    from repro.models.layers import moe as jmoe
    from repro.quant import quantize_params_tree as jquant
    d = 64
    p, x = _layer(64, False, seed=11, d=d)
    q = to_numpy(jquant(_jnp({"router": p["router"]}), min_dim=16, nbits=4,
                         packed=True))
    assert q["router"]["w"]["codes"].dtype == np.uint8
    qp = {**p, "router": q["router"]}
    with pytest.raises(AttributeError):
        jmoe(_jnp(qp), _jnp(x), n_experts=64, top_k=6)
    tq = from_jax_params(qp, "cpu")
    deq = {**p, "router": {"w": dequantize_leaf_ref(
        tq["router"]["w"]).numpy()}}
    want = jmoe(_jnp(deq), _jnp(x), n_experts=64, top_k=6)
    got = moe(tq, torch.from_numpy(x), n_experts=64, top_k=6)
    _rel_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["fp", "int8", "int4"])
def test_moe_on_card_equal_bits_and_matches_cpu(fmt):
    """On the card: two runs of ``moe`` give equal bits (no atomics in the
    dispatch or the combine), and the result matches the CPU's."""
    dev = require_cuda()
    p, x = _layer(16, False, seed=5, d=256, ff=320)
    tp = from_jax_params(p, "cpu")
    kw = _expert_qkw(fmt)
    if kw is not None:
        tp = {**quantize_params_tree(tp, min_dim=16, **kw),
              "router": tp["router"]}
    gp = from_jax_params(to_numpy(tp), dev)
    xc = torch.from_numpy(x)
    a = moe(gp, xc.to(dev), n_experts=16, top_k=2)
    b = moe(gp, xc.to(dev), n_experts=16, top_k=2)
    assert torch.equal(a, b)
    _rel_close(a, moe(tp, xc, n_experts=16, top_k=2), tol=1e-4)


# ---------------------------------------------------------------------------
# the model: forward, decode, prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_train_matches_reference(arch):
    """vs repro.models.forward_train: full-sequence logits (B·S tokens
    routed in one call per layer, with drops at the config's factor)."""
    from repro.models import forward_train as jfwd
    jcfg, tcfg = _cfgs(arch)
    tree = jax_tree(arch)
    toks = _tokens(tcfg.vocab, 2, 10, seed=1)
    want = jfwd(jcfg, _jnp(tree), {"tokens": _jnp(toks)})
    got = forward_train(tcfg, from_jax_params(tree, "cpu"),
                        {"tokens": torch.from_numpy(toks).long()})
    _rel_close(got, want)


def _jax_steps(jcfg, tree, toks, per_slot):
    import jax
    import jax.numpy as jnp
    from repro.models import decode_step as jstep
    from repro.models import init_cache as jcache
    b = toks.shape[0]
    cache = jcache(jcfg, b, MAX_LEN, jnp.float32, per_slot=per_slot)
    if per_slot:
        cache = cache._replace(pos=jnp.asarray([0, 3, 1][:b], jnp.int32))
    step = jax.jit(lambda p, c, t: jstep(jcfg, p, c, t))
    params = _jnp(tree)
    out = []
    for j in range(toks.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(toks[:, j:j + 1]))
        out.append(np.asarray(logits))
    return out, cache


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_step_matches_reference(arch, per_slot):
    """vs repro.models.decode_step, lockstep and per-slot positions:
    logits every step and the cache at the end (B tokens routed per step:
    capacity max(⌈3·k/E·1.25⌉, k))."""
    jcfg, tcfg = _cfgs(arch)
    tree = jax_tree(arch)
    toks = _tokens(tcfg.vocab, 3, 5, seed=2)
    want, jc = _jax_steps(jcfg, tree, toks, per_slot)
    params = from_jax_params(tree, "cpu")
    cache = init_cache(tcfg, 3, MAX_LEN, torch.float32, per_slot=per_slot,
                       device="cpu")
    if per_slot:
        cache = cache._replace(pos=torch.tensor([0, 3, 1], dtype=torch.int32))
    for j in range(toks.shape[1]):
        logits, cache = decode_step(tcfg, params, cache,
                                    torch.from_numpy(toks[:, j:j + 1]).long())
        _rel_close(logits, want[j])
    _rel_close(cache.kv.k, jc.kv.k)
    _rel_close(cache.kv.v, jc.kv.v)
    np.testing.assert_array_equal(to_numpy(cache.pos), np.asarray(jc.pos))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_chunk_matches_reference_and_steps(arch):
    """vs repro.models.decode_chunk; in the port, decode_chunk ≡ its
    decode_step calls bit for bit."""
    import jax.numpy as jnp
    from repro.models import decode_chunk as jchunk
    from repro.models import init_cache as jinit
    jcfg, tcfg = _cfgs(arch)
    tree = jax_tree(arch)
    params = from_jax_params(tree, "cpu")
    toks = _tokens(tcfg.vocab, 2, 7, seed=3)
    want_logits, want = jchunk(jcfg, _jnp(tree),
                               jinit(jcfg, 2, MAX_LEN, jnp.float32),
                               jnp.asarray(toks))
    tt = torch.from_numpy(toks).long()
    logits, cache = decode_chunk(tcfg, params, init_cache(
        tcfg, 2, MAX_LEN, torch.float32, device="cpu"), tt)
    _rel_close(logits, want_logits)
    _rel_close(cache.kv.k, want.kv.k)
    _rel_close(cache.kv.v, want.kv.v)
    c = init_cache(tcfg, 2, MAX_LEN, torch.float32, device="cpu")
    for j in range(tt.shape[1]):
        lj, c = decode_step(tcfg, params, c, tt[:, j:j + 1])
    assert torch.equal(lj, logits)
    assert torch.equal(c.kv.k, cache.kv.k) and torch.equal(c.kv.v,
                                                           cache.kv.v)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_matches_reference(arch):
    """Last logits vs ``repro.models.prefill`` at the config's capacity
    factor (both route the B·S prompt tokens in one call per layer)."""
    import jax.numpy as jnp
    from repro.models import prefill as jprefill
    jcfg, tcfg = _cfgs(arch)
    tree = jax_tree(arch)
    toks = _tokens(tcfg.vocab, 2, 9, seed=4)
    want, _ = jprefill(jcfg, _jnp(tree), {"tokens": jnp.asarray(toks)},
                       MAX_LEN, jnp.float32)
    got, cache = prefill(tcfg, from_jax_params(tree, "cpu"),
                         {"tokens": torch.from_numpy(toks).long()}, MAX_LEN,
                         torch.float32)
    _rel_close(got, want)
    assert int(cache.pos) == toks.shape[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_equals_decode_chunk_without_drops(arch):
    """With capacity_factor = E/k no pair is dropped (capacity ≥ tokens),
    so prefill's cache and last logits equal decode_chunk's over the same
    prompt (the port's, and the reference's decode_chunk)."""
    import jax.numpy as jnp
    from repro.models import decode_chunk as jchunk
    from repro.models import init_cache as jinit
    jcfg, tcfg = _cfgs(arch)
    cf = tcfg.n_experts / tcfg.top_k
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    tree = jax_tree(arch)
    params = from_jax_params(tree, "cpu")
    toks = _tokens(tcfg.vocab, 2, 9, seed=5)
    tt = torch.from_numpy(toks).long()
    logits, cache = prefill(tcfg, params, {"tokens": tt}, MAX_LEN,
                            torch.float32)
    want_logits, want = decode_chunk(tcfg, params, init_cache(
        tcfg, 2, MAX_LEN, torch.float32, device="cpu"), tt)
    jl, jc = jchunk(jcfg, _jnp(tree), jinit(jcfg, 2, MAX_LEN, jnp.float32),
                    jnp.asarray(toks))
    for ref_logits, ref in ((want_logits, want), (jl, jc)):
        _rel_close(logits, ref_logits)
        _rel_close(cache.kv.k, ref.kv.k)
        _rel_close(cache.kv.v, ref.kv.v)


# ---------------------------------------------------------------------------
# serving leaves and engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_moe_quantize_params_tree_inventory_matches_reference(fmt, stacked):
    """``quantize_params_tree`` over a MoE tree: stacked (L, E, in, out)
    experts stay f32 and only the attention projections are quantized (the
    reference's serving tree); a one-layer tree with 3-D experts quantizes
    them too.  Leaves, inventory, histogram and bytes equal the
    reference's."""
    import jax
    from repro.quant import (leaf_format_histogram as jhist,
                             leaf_inventory as jinv,
                             quantize_params_tree as jquant,
                             qweight_bytes as jqb)
    tree = jax_tree(PHI)
    if not stacked:
        tree = {**tree, "layers": jax.tree.map(lambda a: a[0],
                                               tree["layers"])}
    kw = _expert_qkw(fmt)
    want = to_numpy(jquant(_jnp(tree), min_dim=16, **kw))
    got = quantize_params_tree(from_jax_params(tree, "cpu"), min_dim=16,
                               **kw)
    assert_trees_equal(got, want)
    jwant = _jnp(want)
    assert leaf_inventory(got) == jinv(jwant)
    assert leaf_format_histogram(got) == jhist(jwant)
    assert qweight_bytes(got) == jqb(jwant)
    name = "packed-int4" if fmt == "int4" else "int8"
    hist = leaf_format_histogram(got)
    assert hist[name] == (4 if stacked else 7)
    # f32 ≥ 2-D arrays: embed and router; stacked, also the three expert
    # leaves and the two (L, d) norm scales
    assert hist["float32"] == (7 if stacked else 2)


def _workload(vocab, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(2, 8))).astype(np.int32),
             int(rng.integers(1, 6)), int(rng.integers(0, 4)))
            for _ in range(5)]


def _drive(eng, workload, continuous, request=Request):
    if not continuous:
        for rid, (prompt, budget, _) in enumerate(workload):
            eng.submit(request(rid=rid, prompt=prompt.copy(),
                               max_new_tokens=budget))
        done = eng.run_until_done()
    else:
        pending = sorted(enumerate(workload), key=lambda kv: kv[1][2])
        done, steps = [], 0
        while pending or eng.queue or eng.active_slots:
            while pending and pending[0][1][2] <= steps:
                rid, (prompt, budget, _) = pending.pop(0)
                eng.submit(request(rid=rid, prompt=prompt.copy(),
                                   max_new_tokens=budget))
            done.extend(eng.step())
            steps += 1
            assert steps < 500
    assert len(done) == len(workload)
    return {r.rid: tuple(r.out_tokens) for r in done}


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("fmt", ["fp", "int4"])
@pytest.mark.parametrize("arch", [PHI, "moonshot-k3"])
def test_moe_streams_match_jax_engines(arch, fmt, continuous):
    """Each port engine against the reference's same engine on the same
    tree (f32 or packed-int4 attention, f32 stacked experts): identical
    greedy streams.  The engines batch different rows and capacity couples
    the rows of a step, so only same-engine streams are compared."""
    import jax
    import jax.numpy as jnp
    from repro.models import decode_chunk as jdc
    from repro.models import decode_step as jds
    from repro.quant import quantize_params_tree as jquant
    from repro.serve import ContinuousEngine as JCont
    from repro.serve import EngineConfig as JConfig
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServe
    jcfg, tcfg = _cfgs(arch)
    tree = jax_tree(arch)
    if fmt == "int4":
        tree = to_numpy(jquant(_jnp(tree), min_dim=16, nbits=4, packed=True))
    workload = _workload(tcfg.vocab, seed=30 + ARCHS.index(arch))
    jeng = (JCont if continuous else JServe)(
        jcfg, _jnp(tree), config=JConfig(
            n_slots=3, max_len=MAX_LEN, cache_dtype=jnp.float32,
            prefill_chunk=3,
            decode_fn=jax.jit(lambda p, c, t: jds(jcfg, p, c, t)),
            decode_chunk_fn=jax.jit(lambda p, c, t: jdc(jcfg, p, c, t))))
    want = _drive(jeng, workload, continuous, JRequest)
    teng = (ContinuousEngine if continuous else ServeEngine)(
        tcfg, from_jax_params(tree, "cpu"), config=EngineConfig(
            n_slots=3, max_len=MAX_LEN, cache_dtype=torch.float32,
            prefill_chunk=3))
    assert _drive(teng, workload, continuous) == want
    assert teng.weight_bytes == jeng.weight_bytes
    assert teng.weight_formats == jeng.weight_formats
