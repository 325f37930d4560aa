"""Port of the MoE paths of PTQ and the planner (``quant.calibrate``'s
expert taps and statistics, ``quant.pipeline``'s per-expert quantization,
``quant.qlinear.serving_formats_from_plan``'s ``moe/`` groups,
``plan.sensitivity`` and ``plan.executor``'s expert entries) held against
the JAX package.

Model: reduced phi3.5-moe-42b-a6.6b (2 layers, d 64, 4 experts top-2, d_ff
128), the reference's tree with every weight redrawn from numpy at std
1/sqrt(in_features), untrained; calibration 2 numpy batches of 4 × 24
tokens.  The reference's own MoE PTQ tests train their model first and
``test_moe_method_ordering`` is red there, so artifacts are compared
instead.

Tolerances: taps and logits 1e-5 of values divided by their largest
magnitude (f32 products in another order), occupancy masks equal;
covariance sums 1e-10 relative (float64 sums of the same taps); ``hptq``
codes of the first layer and the ``rtn`` write-back byte-identical,
later layers' codes ≥ 99 % equal, realized rate and each matrix's
entropy within 0.01 bits (a later layer calibrates through the dequantized
write-back of the earlier ones, f32 in another order); sensitivities 1e-4
relative; plan execution in float64 byte-identical.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_trees_equal, to_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.core import CalibStats
from repro_torch.models import from_jax_params
from repro_torch.plan import (QuantPlan, execute_plan, model_sensitivities,
                              plan_inputs_for_model,
                              quantize_model_with_plan)
from repro_torch.quant import quantize_params_tree, serving_formats_from_plan
from repro_torch.quant.calibrate import (StatsAccumulator, accumulate_stats,
                                        forward_with_taps)
from repro_torch.quant.pipeline import (PTQConfig, matrix_tap_map,
                                        quantize_model)

ARCH = "phi3.5-moe-42b-a6.6b"
METHODS = ["watersic", "hptq", "rtn"]


class _x64:
    def __enter__(self):
        import jax
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        import jax
        jax.config.update("jax_enable_x64", False)


def _cfgs(n_layers=2):
    from repro.configs import get_config
    cut = dict(n_layers=n_layers)
    return (dataclasses.replace(get_config(ARCH).reduced(), **cut),
            dataclasses.replace(tget_config(ARCH).reduced(), **cut))


@functools.lru_cache(maxsize=None)
def _model():
    """(reference numpy tree, calibration batches)."""
    import jax
    from repro.models import init_params, split_tree
    base = to_numpy(split_tree(init_params(_cfgs()[0],
                                           jax.random.PRNGKey(0)))[0])
    rng = np.random.default_rng(40)

    def draw(node, path):
        if isinstance(node, dict):
            return {k: draw(node[k], path + (k,)) for k in sorted(node)}
        if path[-1] == "scale":
            return node
        std = 0.02 if path[0] == "embed" else node.shape[-2] ** -0.5
        return (rng.standard_normal(node.shape) * std).astype(np.float32)
    tree = draw(base, ())
    calib = [rng.integers(0, 256, (4, 24)).astype(np.int32)
             for _ in range(2)]
    return tree, calib


def _one_layer(tree):
    return {**tree, "layers": {k: _slice(v) for k, v in
                               tree["layers"].items()}}


def _slice(node):
    if isinstance(node, dict):
        return {k: _slice(v) for k, v in node.items()}
    return node[:1]


def _jnp(tree):
    import jax
    return jax.tree.map(jax.numpy.asarray, tree)


def _rel_close(got, want, tol=1e-5):
    want = to_numpy(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert_close(to_numpy(got) / scale, want / scale, tol=tol)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def test_moe_forward_with_taps_matches_reference():
    """Expert taps (routed inputs, hidden, occupancy) and the attention
    taps vs repro.quant.calibrate.forward_with_taps; no ``hidden`` tap on
    a MoE layer."""
    import jax.numpy as jnp
    from repro.quant.calibrate import forward_with_taps as jtaps
    tree, calib = _model()
    jcfg, tcfg = _cfgs()
    jl, jt = jtaps(jcfg, _jnp(tree), jnp.asarray(calib[0]))
    tl, tt = forward_with_taps(tcfg, from_jax_params(tree, "cpu"), calib[0])
    _rel_close(tl, jl)
    assert len(tt) == len(jt) == 2
    for got, want in zip(tt, jt):
        assert set(got) == set(want)
        assert "hidden" not in got and "expert_in" in got
        # drop-free capacity of 96 tokens, top-2 of 4: 48 slots
        assert tuple(got["expert_in"].shape) == (4, 48, 64)
        np.testing.assert_array_equal(to_numpy(got["expert_occ"]),
                                      np.asarray(want["expert_occ"]))
        for k in want:
            _rel_close(got[k], want[k])


def test_moe_accumulate_stats_matches_reference():
    """The same reference taps (fp and a perturbed "quantized" model)
    into both accumulators: the same keys (per-expert ``e{e}/in`` and
    ``e{e}/hid`` Σ_X weighted by occupancy, no ``hidden``), float64 sums
    within 1e-10 relative, identical counts."""
    import jax.numpy as jnp
    from repro.quant.calibrate import StatsAccumulator as JAcc
    from repro.quant.calibrate import accumulate_stats as jaccumulate
    from repro.quant.calibrate import forward_with_taps as jtaps
    tree, calib = _model()
    jcfg, _ = _cfgs()
    moe_q = {k: (v if k == "router" else v * 0.9)
             for k, v in tree["layers"]["moe"].items()}
    qtree = {**tree, "layers": {**tree["layers"], "moe": moe_q}}
    jacc, tacc = JAcc(), StatsAccumulator()
    for tokens in calib:
        _, fp = jtaps(jcfg, _jnp(tree), jnp.asarray(tokens))
        _, qq = jtaps(jcfg, _jnp(qtree), jnp.asarray(tokens))
        for layer in (0, 1):
            jaccumulate(jacc, layer, fp[layer], qq[layer])
            accumulate_stats(tacc, layer,
                             {k: torch.as_tensor(np.array(v))
                              for k, v in fp[layer].items()},
                             {k: torch.as_tensor(np.array(v))
                              for k, v in qq[layer].items()})
    assert sorted(tacc.sums) == sorted(jacc.sums)
    assert "L1/e3/hid/xx" in tacc.sums and "L0/hidden/xx" not in tacc.sums
    for k, want in jacc.sums.items():
        got = to_numpy(tacc.sums[k])
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
        assert tacc.counts[k] == pytest.approx(float(jacc.counts[k]),
                                               rel=1e-12)


# ---------------------------------------------------------------------------
# sequential PTQ
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _quantized(method):
    """Both packages' quantize_model at 3 bits (``watersic``, whose
    reference compiles a long LMMSE loop, on the first layer only)."""
    from repro.quant.pipeline import PTQConfig as JPTQConfig
    from repro.quant.pipeline import quantize_model as jquantize
    tree, calib = _model()
    n = 1 if method == "watersic" else 2
    jcfg, tcfg = _cfgs(n)
    if n == 1:
        tree = _one_layer(tree)
    want = jquantize(jcfg, _jnp(tree), calib,
                     JPTQConfig(target_bits=3.0, method=method))
    got = quantize_model(tcfg, from_jax_params(tree, "cpu"), calib,
                         PTQConfig(target_bits=3.0, method=method))
    return want, got, n


@pytest.mark.parametrize("method", METHODS)
def test_moe_quantize_model_matches_reference(method):
    """Budget keys ``L{l}/moe/{key}/e{e}`` and report rows equal to the
    reference's; layer 0's codes (every matrix, attention and experts) and
    ``rtn``'s dequantized write-back byte-identical; layer 1's codes ≥ 99 %
    equal (its Σ_X comes through layer 0's dequantized write-back, where
    f32 rounding compounds and may move a secant step's spacing by 1e-4
    relative); every matrix's entropy within 0.01 bits."""
    (jq, jlin, jbudget, jrows), (tq, tlin, tbudget, trows), n = \
        _quantized(method)
    names = [f"L{l}/moe/{k}/e{e}" for l in range(n)
             for k in ("w_gate", "w_up", "w_out") for e in range(4)]
    assert set(names) <= set(tbudget.layer_params) \
        and set(tbudget.layer_params) == set(jbudget.layer_params)
    assert abs(tbudget.realized_rate - jbudget.realized_rate) <= 0.01
    assert [(r["layer"], r["matrix"], r["dead"]) for r in trows] == \
        [(r["layer"], r["matrix"], r["dead"]) for r in jrows]
    assert sorted(tlin) == sorted(jlin)
    if method == "rtn":
        assert not tlin
        assert_trees_equal(tq, to_numpy(jq))
        return
    assert len(tlin) == n * (4 + 12)
    for name, q in jlin.items():
        got, want = to_numpy(tlin[name].codes), np.asarray(q.codes)
        assert got.shape == want.shape and got.dtype.itemsize == 4
        if name.startswith("L0/"):
            assert np.array_equal(got, want), name
        else:
            assert (got == want).mean() >= 0.99, name
        assert abs(tlin[name].entropy_bits - q.entropy_bits) <= 0.01, name
    _rel_close(tq["layers"]["moe"]["w_up"], jq["layers"]["moe"]["w_up"],
               tol=1e-4 if method == "hptq" else 0.1)


def test_moe_matrix_tap_map_lists_attention_only():
    """A MoE layer's public matrix ↔ tap vocabulary is its attention
    matrices (the experts' Σ_X are per-expert buffers), as the
    reference's."""
    from repro.quant.pipeline import matrix_tap_map as jmap
    tree, _ = _model()
    jcfg, tcfg = _cfgs()
    got = matrix_tap_map(tcfg, from_jax_params(tree, "cpu"))
    assert got == jmap(jcfg, _jnp(tree))
    assert [r["name"] for r in got[:4]] == [f"L0/attn/{k}" for k in
                                            ("wq", "wk", "wv", "wo")]


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_sens(weighting):
    from repro.plan import model_sensitivities as jms
    tree, calib = _model()
    return jms(_cfgs()[0], _jnp(tree), calib, weighting=weighting, seed=1)


@pytest.mark.parametrize("weighting", ["uniform", "output"])
def test_moe_sensitivities_match_reference(weighting):
    """vs repro.plan.model_sensitivities: names (attention then each
    expert matrix, per layer), shapes and provenance equal, weights and
    spectra within 1e-4."""
    tree, calib = _model()
    want = _jax_sens(weighting)
    got = model_sensitivities(_cfgs()[1], from_jax_params(tree, "cpu"),
                              calib, weighting=weighting, seed=1)
    assert [s.name for s in got] == [s.name for s in want]
    assert len(got) == 2 * (4 + 3 * 4)
    assert got[4].name == "L0/moe/w_gate/e0"
    for a, b in zip(got, want):
        assert (a.out_features, a.in_features, a.provenance) == \
            (b.out_features, b.in_features, b.provenance)
        assert a.weight == pytest.approx(b.weight, rel=1e-4)
        assert a.sigma_w2 == pytest.approx(b.sigma_w2, rel=1e-6)
        np.testing.assert_allclose(a.lambdas, b.lambdas, rtol=0,
                                   atol=1e-4 * b.lambdas.max())


def test_moe_probe_weighting_is_refused():
    """``probe`` on a MoE model raises the reference's ValueError."""
    from repro.plan import model_sensitivities as jms
    tree, calib = _model()
    jcfg, tcfg = _cfgs()
    with pytest.raises(ValueError, match="dense-only"):
        jms(jcfg, _jnp(tree), calib, weighting="probe")
    with pytest.raises(ValueError, match="dense-only"):
        model_sensitivities(tcfg, from_jax_params(tree, "cpu"), calib,
                            weighting="probe")


def test_moe_plan_execution_matches_reference():
    """``plan_inputs_for_model`` covers every expert entry with its routed
    Σ_X (names equal, weights byte-equal, Σ within 1e-5); the reference's
    inputs executed in float64 give byte-identical codes in both
    packages; ``quantize_model_with_plan`` writes every expert back and
    realizes the reference's bits within 0.01."""
    from repro.core import CalibStats as JCalibStats
    from repro.plan import QuantPlan as JPlan
    from repro.plan import build_plan as jbuild
    from repro.plan import execute_plan as jexecute
    from repro.plan import quantize_model_with_plan as jqmp
    from repro.plan.executor import plan_inputs_for_model as jinputs
    tree, calib = _model()
    jcfg, tcfg = _cfgs()
    text = jbuild(_jax_sens("output"), 3.0, weighting="output").to_json()
    jw, js = jinputs(jcfg, _jnp(tree), calib)
    tw, ts = plan_inputs_for_model(tcfg, from_jax_params(tree, "cpu"),
                                   calib)
    assert list(tw) == list(jw) and set(tw) == set(JPlan.from_json(text)
                                                  .names())
    for name in jw:
        assert np.array_equal(to_numpy(tw[name]), np.asarray(jw[name]))
        _rel_close(ts[name].sigma_x, js[name].sigma_x)
    w64 = {n: np.asarray(w, np.float64) for n, w in jw.items()}
    s64 = {n: np.asarray(s.sigma_x, np.float64) for n, s in js.items()}
    with _x64():
        import jax.numpy as jnp
        want = jexecute(JPlan.from_json(text),
                        {n: jnp.asarray(w) for n, w in w64.items()},
                        {n: JCalibStats(sigma_x=jnp.asarray(s))
                         for n, s in s64.items()}, damp=0.05)[0]
    got = execute_plan(QuantPlan.from_json(text),
                       {n: torch.as_tensor(w) for n, w in w64.items()},
                       {n: CalibStats(sigma_x=torch.as_tensor(s))
                        for n, s in s64.items()}, damp=0.05)[0]
    for name, q in want.items():
        assert np.array_equal(to_numpy(got[name].codes),
                              np.asarray(q.codes)), name
    jplan, tplan = JPlan.from_json(text), QuantPlan.from_json(text)
    jqmp(jcfg, _jnp(tree), calib, jplan)
    tq, tlin, tplan, _ = quantize_model_with_plan(
        tcfg, from_jax_params(tree, "cpu"), calib, tplan)
    assert tplan.realized_bits_per_param == pytest.approx(
        jplan.realized_bits_per_param, abs=0.01)
    e = tq["layers"]["moe"]["w_out"][1, 2]
    assert torch.equal(e, tlin["L1/moe/w_out/e2"].dequant().T.to(e.dtype))


def test_moe_serving_formats_from_plan_matches_reference():
    """``moe/`` plan entries group per expert leaf (the max over layers
    and experts): the same format for every path of a stacked and of a
    one-layer unstacked MoE tree, and the same served unstacked tree."""
    import jax
    from repro.plan import QuantPlan as JPlan
    from repro.plan import build_plan as jbuild
    from repro.quant import quantize_params_tree as jqtree
    from repro.quant import serving_formats_from_plan as jformats
    tree, _ = _model()
    text = jbuild(_jax_sens("output"), 3.0, weighting="output").to_json()
    jf = jformats(JPlan.from_json(text))
    tf = serving_formats_from_plan(QuantPlan.from_json(text))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    paths = [tuple(p.key for p in path) for path, _ in flat]
    assert [tf(p) for p in paths] == [jf(p) for p in paths]
    assert tf(("layers", "moe", "w_up")) is not None
    unstacked = {**tree, "layers": jax.tree.map(lambda a: a[0],
                                                tree["layers"])}
    got = quantize_params_tree(from_jax_params(unstacked, "cpu"),
                               min_dim=16, nbits_by_path=tf)
    assert_trees_equal(got, to_numpy(jqtree(_jnp(unstacked), min_dim=16,
                                            nbits_by_path=jf)))
    assert "codes" in got["layers"]["moe"]["w_up"]
