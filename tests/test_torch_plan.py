"""Port of the global planner (``plan/``, ``core/rate_alloc.PlanBudget``,
``quant.pipeline.quantize_model(plan=...)``, ``quant.qlinear.
serving_formats_from_plan``, ``dist/fault.py``'s executor primitives and
``launch/plan.py``) held against the JAX package.

Inputs are the ``synth_layers`` spectra and the tiny ``CFG`` model of
``tests/test_plan_executor.py``, made with numpy and handed to both
packages.  Tolerances: spectra within 1e-9 of the largest eigenvalue
(LAPACK's symmetric eigensolver through torch against numpy);
``waterfill_bits`` within 1e-12 (the same float64 arithmetic); snapped bits,
payload formats and plan JSON exactly equal; ``execute_plan`` in float64
gives byte-identical codes; model sensitivities, whose Σ_X come from f32
forwards in another summation order, within 1e-4 relative (``probe``:
1e-3, a difference of two f32 forwards); greedy streams identical.
"""
import dataclasses
import functools
import json
import math

import numpy as np
import pytest
import torch

from _torch_parity import assert_trees_equal, to_numpy
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.core import CalibStats, PlanBudget, RateBudget
from repro_torch.core.theory import random_covariance
from repro_torch.dist import Heartbeat, RestartPolicy, StragglerMonitor
from repro_torch.models import from_jax_params
from repro_torch.plan import (QuantPlan, allocation_distortion, build_plan,
                              even_plan, execute_plan, model_sensitivities,
                              payload_bits_for, rewaterfill_subset,
                              sensitivity_from_matrix,
                              sensitivity_from_streamed, snap_bits,
                              waterfill_bits)
from repro_torch.plan.sensitivity import MatrixSensitivity

CFG = dict(name="plx", family="dense", n_layers=2, d_model=48, n_heads=3,
           n_kv=3, d_ff=96, vocab=96, head_dim=16)
BUDGETS = [2.5, 3.0, 5.0]


class _x64:
    def __enter__(self):
        import jax
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        import jax
        jax.config.update("jax_enable_x64", False)


def _jcfg():
    from repro.configs.base import ArchConfig
    return ArchConfig(**CFG)


def synth_layers(n_layers=5, dim=28, out=20, seed=0):
    """(name, w (out, in), Σ_X) float64 numpy triples: heterogeneous
    spectra (tests/test_plan_executor.py's synth_layers)."""
    rng = np.random.default_rng(seed)
    decays = ["log-linear", "two-level", "flat", "heavy-tail"]
    layers = []
    for i in range(n_layers):
        sigma, _ = random_covariance(dim, decay=decays[i % 4],
                                     condition=10.0 ** (1 + i % 4),
                                     seed=seed + i)
        w = rng.standard_normal((out, dim)) * (0.3 + 0.4 * (i % 3))
        layers.append((f"syn{i}/mat", w, sigma))
    return layers


def _both_sens(layers):
    """(reference sensitivities, the port's) of the same layers."""
    from repro.plan import sensitivity_from_matrix as jsens
    return ([jsens(n, w, s) for n, w, s in layers],
            [sensitivity_from_matrix(n, w, s) for n, w, s in layers])


def _as_port(jsens):
    """A reference MatrixSensitivity as the port's, field for field."""
    return [MatrixSensitivity(**dataclasses.asdict(s)) for s in jsens]


# ---------------------------------------------------------------------------
# sensitivities, waterfilling, snapping, the artifact
# ---------------------------------------------------------------------------


def test_sensitivity_spectra_match_reference():
    """vs repro.plan.sensitivity_from_matrix / sensitivity_from_streamed:
    the port's float64 torch spectrum against numpy's eigvalsh."""
    from repro.plan import sensitivity_from_streamed as jstreamed
    layers = synth_layers()
    want, got = _both_sens(layers)
    for a, b in zip(got, want):
        assert (a.name, a.out_features, a.in_features) == \
            (b.name, b.out_features, b.in_features)
        assert a.sigma_w2 == pytest.approx(b.sigma_w2, rel=1e-14)
        assert a.lambdas.dtype == np.float64
        np.testing.assert_allclose(a.lambdas, b.lambdas, rtol=0,
                                   atol=1e-9 * b.lambdas.max())
    # tensors in, on their own device: the same curve inputs
    n, w, s = layers[1]
    t = sensitivity_from_matrix(n, torch.as_tensor(w), torch.as_tensor(s))
    np.testing.assert_array_equal(t.lambdas, got[1].lambdas)

    class Est:
        sigma, n = s, 50.0
    a, b = sensitivity_from_streamed(n, w, Est()), jstreamed(n, w, Est())
    assert a.weight == pytest.approx(b.weight, rel=1e-12)
    assert a.provenance == b.provenance == "streamed:50t"
    with pytest.raises(ValueError, match="min_samples"):
        sensitivity_from_streamed(n, w, Est(), min_samples=100)


@pytest.mark.parametrize("budget", BUDGETS)
def test_waterfill_bits_matches_reference(budget):
    """vs repro.plan.waterfill_bits / allocation_distortion on the same
    sensitivities, with and without a floor/ceiling box."""
    from repro.plan import allocation_distortion as jdist
    from repro.plan import apply_constraints as jconstrain
    from repro.plan import waterfill_bits as jwf
    from repro_torch.plan import apply_constraints
    jsens, _ = _both_sens(synth_layers(seed=3))
    for floors, ceils in ((None, None), ({"syn0/*": 3.0}, {"syn2/*": 4.0})):
        js = jconstrain([dataclasses.replace(s) for s in jsens], floors, ceils)
        ts = apply_constraints(_as_port(jsens), floors, ceils)
        want, got = jwf(js, budget), waterfill_bits(ts, budget)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        assert allocation_distortion(ts, got) == pytest.approx(
            jdist(js, want), rel=1e-12)


@pytest.mark.parametrize("budget", BUDGETS)
def test_snap_and_payload_bits_equal_reference(budget):
    """vs repro.plan.snap_bits / payload_bits_for: exactly equal."""
    from repro.plan import payload_bits_for as jpayload
    from repro.plan import snap_bits as jsnap
    from repro.plan import waterfill_bits as jwf
    jsens, _ = _both_sens(synth_layers(n_layers=7, seed=5))
    cont = jwf(jsens, budget)
    want, wover = jsnap(jsens, cont, budget_bits_per_param=budget)
    got, gover = snap_bits(_as_port(jsens), cont,
                           budget_bits_per_param=budget)
    np.testing.assert_array_equal(got, want)
    assert gover == wover
    for b in list(cont) + [2.0, 3.0, 4.0, 4.0001, 8.0]:
        assert payload_bits_for(float(b)) == jpayload(float(b))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_plan_json_crosses_packages(writer, tmp_path):
    """vs repro.plan.build_plan / QuantPlan: a plan written by either
    package loads in the other and compares equal, byte for byte in JSON;
    even_plan and rewaterfill_subset agree too."""
    from repro.plan import QuantPlan as JPlan
    from repro.plan import build_plan as jbuild
    from repro.plan import even_plan as jeven
    from repro.plan import rewaterfill_subset as jrewf
    jsens, _ = _both_sens(synth_layers())
    tsens = _as_port(jsens)
    prov = {"arch": "synth", "seed": 0}
    jplan = jbuild(jsens, 3.0, weighting="uniform", provenance=prov)
    tplan = build_plan(tsens, 3.0, weighting="uniform", provenance=prov)
    assert tplan.to_json() == jplan.to_json()
    path = str(tmp_path / "plan.json")
    (tplan if writer == "port" else jplan).save(path)
    assert QuantPlan.load(path) == tplan
    assert JPlan.load(path) == jplan
    assert QuantPlan.load(path).to_json() == JPlan.load(path).to_json()
    assert tplan.diff(QuantPlan.load(path)) == []
    assert even_plan(tsens, 3.0).to_json() == jeven(jsens, 3.0).to_json()
    sub_t, over_t = rewaterfill_subset(tplan, tsens[:2])
    sub_j, over_j = jrewf(jplan, jsens[:2])
    assert sub_t.to_json() == sub_j.to_json() and over_t == over_j
    bad = json.loads(tplan.to_json())
    bad["schema_version"] = 99
    with pytest.raises(ValueError, match="schema_version"):
        QuantPlan.from_dict(bad)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _f64_execution(quantize_kwargs):
    """The reference's execute_plan and the port's (1 and 4 workers) in
    float64 on the same plan: ((jax qlinears, plan), (port 1-worker
    qlinears, plan), (port 4-worker qlinears, plan))."""
    import jax.numpy as jnp
    from repro.core import CalibStats as JCalibStats
    from repro.plan import build_plan as jbuild
    from repro.plan import execute_plan as jexecute
    layers = synth_layers()
    jsens, _ = _both_sens(layers)
    kw = dict(quantize_kwargs)
    text = jbuild(jsens, 3.0, weighting="uniform").to_json()
    with _x64():
        from repro.plan import QuantPlan as JPlan
        jplan = JPlan.from_json(text)
        want = jexecute(jplan, {n: jnp.asarray(w) for n, w, _ in layers},
                        {n: JCalibStats(sigma_x=jnp.asarray(s))
                         for n, _, s in layers},
                        damp=1e-4, quantize_kwargs=kw)[0]
    weights = {n: torch.as_tensor(w) for n, w, _ in layers}
    stats = {n: CalibStats(sigma_x=torch.as_tensor(s)) for n, _, s in layers}
    runs = []
    for workers in (1, 4):
        plan = QuantPlan.from_json(text)
        q, report = execute_plan(plan, weights, stats, damp=1e-4,
                                 n_workers=workers, devices="all",
                                 quantize_kwargs=kw)
        assert report.n_workers == workers and report.retries == 0
        runs.append((q, plan))
    return (want, jplan), runs[0], runs[1]


@pytest.mark.parametrize("quantize_kwargs", [(), (("lmmse", False),)])
def test_execute_plan_f64_codes_identical(quantize_kwargs):
    """vs repro.plan.execute_plan in float64: every matrix's codes
    byte-identical, achieved bits and realized distortion equal; the
    port's 4-worker run equal to its 1-worker run, tensor for tensor."""
    (want, jplan), (got, tplan), (par, pplan) = \
        _f64_execution(quantize_kwargs)
    assert set(got) == set(want) == set(par)
    for name, q in want.items():
        g, p = got[name], par[name]
        assert np.array_equal(to_numpy(g.codes), np.asarray(q.codes))
        np.testing.assert_allclose(to_numpy(g.column_scale),
                                   np.asarray(q.column_scale), rtol=1e-6)
        np.testing.assert_allclose(to_numpy(g.t), np.asarray(q.t),
                                   rtol=1e-6, atol=1e-9)
        for field in ("codes", "alphas", "gamma", "t"):
            assert torch.equal(getattr(g, field), getattr(p, field))
        assert g.entropy_bits == p.entropy_bits
        a, b = tplan.entry(name), jplan.entry(name)
        assert a.achieved_bits == pytest.approx(b.achieved_bits, abs=1e-9)
        assert a.realized_distortion == pytest.approx(
            b.realized_distortion, rel=1e-6)
    assert tplan.realized_bits_per_param == pplan.realized_bits_per_param
    assert tplan.realized_bits_per_param == pytest.approx(3.0, abs=0.05)


def test_executor_retries_and_heartbeat(monkeypatch, tmp_path):
    """A transient failure is retried under the RestartPolicy and the
    heartbeat records completed-task progress (as the reference's
    test_executor_retries_transient_failures); an exhausted policy raises;
    missing inputs raise."""
    import repro_torch.plan.executor as ex
    layers = synth_layers(n_layers=3)
    plan = build_plan([sensitivity_from_matrix(n, w, s)
                       for n, w, s in layers], 3.0, weighting="uniform")
    weights = {n: torch.as_tensor(w, dtype=torch.float32)
               for n, w, _ in layers}
    stats = {n: CalibStats(sigma_x=torch.as_tensor(s, dtype=torch.float32))
             for n, _, s in layers}
    real = ex.quantize_at_rate
    fails = {"left": 2}

    def flaky(*a, **kw):
        if fails["left"] > 0:
            fails["left"] -= 1
            raise RuntimeError("injected transient failure")
        return real(*a, **kw)

    monkeypatch.setattr(ex, "quantize_at_rate", flaky)
    hb = Heartbeat(str(tmp_path), "executor")
    q, rep = execute_plan(plan, weights, stats, damp=1e-4, n_workers=2,
                          heartbeat=hb)
    assert rep.retries == 2 and len(q) == len(plan.entries)
    assert Heartbeat.alive_hosts(str(tmp_path)) == {"executor": 3}
    monkeypatch.setattr(ex, "quantize_at_rate", lambda *a, **kw: (
        _ for _ in ()).throw(RuntimeError("permanent")))
    with pytest.raises(RuntimeError, match="permanent"):
        execute_plan(plan, weights, stats,
                     policy=RestartPolicy(max_restarts=1, backoff_base_s=0.0))
    with pytest.raises(KeyError, match="without weights"):
        execute_plan(plan, {}, stats)


# ---------------------------------------------------------------------------
# the model path: sensitivities, quantize_model(plan=...), serving
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model():
    """(reference numpy params with every stacked weight rescaled to std
    1/sqrt(in) — the reference's stacked init takes the layer count as
    fan-in (ROADMAP queue C) — and two numpy calibration batches)."""
    import jax
    from repro.models import init_params, split_tree
    base = to_numpy(split_tree(init_params(_jcfg(),
                                           jax.random.PRNGKey(0)))[0])

    def fan_in(node):
        if "w" in node and not isinstance(node["w"], dict):
            w = node["w"]
            return {**node, "w": (w * np.sqrt(w.shape[0] / w.shape[1]))
                    .astype(w.dtype)}
        return {k: fan_in(v) if isinstance(v, dict) else v
                for k, v in node.items()}
    base = {**base, "layers": fan_in(base["layers"])}
    rng = np.random.default_rng(900)
    calib = [rng.integers(0, CFG["vocab"], (4, 24)).astype(np.int32)
             for _ in range(2)]
    return base, calib


@functools.lru_cache(maxsize=None)
def _jax_sens(weighting, n_batches=2):
    import jax
    import jax.numpy as jnp
    from repro.plan import model_sensitivities as jms
    base, calib = _model()
    return jms(_jcfg(), jax.tree.map(jnp.asarray, base), calib[:n_batches],
               weighting=weighting, seed=1)


@pytest.mark.parametrize("weighting", ["uniform", "output", "probe"])
def test_model_sensitivities_match_reference(weighting):
    """vs repro.plan.model_sensitivities on the same weights and tokens:
    names and shapes equal, weights and spectra close."""
    base, calib = _model()
    n = 1 if weighting == "probe" else 2
    want = _jax_sens(weighting, n)
    got = model_sensitivities(TArchConfig(**CFG), from_jax_params(base, "cpu"),
                              calib[:n], weighting=weighting, seed=1)
    assert [s.name for s in got] == [s.name for s in want]
    assert len(got) == 2 * 7
    tol = 1e-3 if weighting == "probe" else 1e-4
    for a, b in zip(got, want):
        assert (a.out_features, a.in_features, a.provenance) == \
            (b.out_features, b.in_features, b.provenance)
        assert a.weight == pytest.approx(b.weight, rel=tol)
        assert a.sigma_w2 == pytest.approx(b.sigma_w2, rel=1e-6)
        np.testing.assert_allclose(a.lambdas, b.lambdas, rtol=0,
                                   atol=tol * b.lambdas.max())
    if weighting == "probe":
        assert len({round(s.weight, 9) for s in got}) > 1


def test_quantize_model_with_plan_matches_reference():
    """vs repro.quant.pipeline.quantize_model(plan=...): the same plan
    (the reference's, crossed as JSON) drives both sequential pipelines;
    achieved bits are written back into the plan; a plan with missing
    entries raises KeyError up front."""
    import jax
    import jax.numpy as jnp
    from repro.plan import QuantPlan as JPlan
    from repro.plan import build_plan as jbuild
    from repro.quant.pipeline import PTQConfig as JPTQConfig
    from repro.quant.pipeline import quantize_model as jquantize
    from repro_torch.quant.pipeline import PTQConfig, quantize_model
    base, calib = _model()
    jsens = _jax_sens("output")
    text = jbuild(jsens, 3.0, weighting="output").to_json()
    jplan, tplan = JPlan.from_json(text), QuantPlan.from_json(text)
    _, _, jbudget, jrows = jquantize(
        _jcfg(), jax.tree.map(jnp.asarray, base), calib,
        JPTQConfig(target_bits=3.0, method="hptq"), plan=jplan)
    _, tlin, tbudget, trows = quantize_model(
        TArchConfig(**CFG), from_jax_params(base, "cpu"), calib,
        PTQConfig(target_bits=3.0, method="hptq"), plan=tplan)
    assert isinstance(tbudget, PlanBudget) and len(trows) == len(jrows) == 14
    assert tbudget.realized_rate == pytest.approx(jbudget.realized_rate,
                                                  abs=0.01)
    for e in tplan:
        assert e.achieved_bits == pytest.approx(
            jplan.entry(e.name).achieved_bits, abs=0.01)
        assert e.achieved_bits == pytest.approx(e.snapped_bits, abs=0.05)
    bad = build_plan(_as_port(jsens[:-1]), 3.0, weighting="output")
    with pytest.raises(KeyError, match="missing entries"):
        quantize_model(TArchConfig(**CFG), from_jax_params(base, "cpu"),
                       calib, PTQConfig(target_bits=3.0), plan=bad)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path


def test_serving_formats_from_plan_matches_reference():
    """vs repro.quant.serving_formats_from_plan on the same plan: the same
    format for every path of the param tree, and the same mixed tree."""
    from repro.plan import QuantPlan as JPlan
    from repro.plan import build_plan as jbuild
    from repro.quant import quantize_params_tree as jqtree
    from repro.quant import serving_formats_from_plan as jformats
    from repro_torch.quant import (quantize_params_tree,
                                   serving_formats_from_plan)
    base, _ = _model()
    text = jbuild(_jax_sens("output"), 3.0, weighting="output").to_json()
    jf = jformats(JPlan.from_json(text))
    tf = serving_formats_from_plan(QuantPlan.from_json(text))
    paths = list(_paths(base))
    assert [tf(p) for p in paths] == [jf(p) for p in paths]
    assert {tf(p) for p in paths} > {None}
    assert tf(("layers", "attn", "nope", "w")) is None
    assert serving_formats_from_plan(QuantPlan.from_json(text),
                                     default=8)(("x", "y", "w")) == 8
    assert_trees_equal(
        quantize_params_tree(from_jax_params(base, "cpu"), min_dim=32,
                             nbits_by_path=tf),
        jqtree(base, min_dim=32, nbits_by_path=jf))


def test_mixed_rate_serving_differential():
    """vs tests/test_plan_executor.py::test_mixed_rate_serving_differential:
    the plan's mixed per-leaf formats serve identical greedy streams from
    the JAX engines and the port's, static and continuous."""
    import jax
    import jax.numpy as jnp
    from repro.plan import QuantPlan as JPlan
    from repro.plan import build_plan as jbuild
    from repro.quant import quantize_params_tree as jqtree
    from repro.quant import serving_formats_from_plan as jformats
    from repro.serve import ContinuousEngine as JCont
    from repro.serve import EngineConfig as JConfig
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServe
    from repro_torch.quant import leaf_format_histogram, qweight_bytes
    from repro_torch.serve import (ContinuousEngine, EngineConfig, Request,
                                   ServeEngine)
    base, _ = _model()
    plan = jbuild(_jax_sens("output"), 3.0, weighting="output")
    mixed = to_numpy(jqtree(base, min_dim=32,
                            nbits_by_path=jformats(JPlan.from_json(
                                plan.to_json()))))
    tree = from_jax_params(mixed, "cpu")
    hist = leaf_format_histogram(tree)
    assert sum(v for k, v in hist.items()
               if k.startswith("packed") or k == "int8") >= 2, hist
    qb, fb = qweight_bytes(tree)
    assert qb < fb
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG["vocab"], 6).astype(np.int32)
               for _ in range(5)]
    budgets = [5, 3, 6, 2, 4]

    def run(eng, request):
        for i, (p, b) in enumerate(zip(prompts, budgets)):
            eng.submit(request(rid=i, prompt=p.copy(), max_new_tokens=b))
        return {r.rid: list(r.out_tokens) for r in eng.run_until_done()}

    jtree = jax.tree.map(jnp.asarray, mixed)
    jconf = JConfig(n_slots=3, max_len=16, prefill_chunk=3)
    want = run(JServe(_jcfg(), jtree, config=jconf), JRequest)
    assert run(JCont(_jcfg(), jtree, config=jconf), JRequest) == want
    tconf = EngineConfig(n_slots=3, max_len=16, prefill_chunk=3)
    static = run(ServeEngine(TArchConfig(**CFG), tree, config=tconf),
                 Request)
    continuous = run(ContinuousEngine(TArchConfig(**CFG), tree,
                                      config=tconf), Request)
    assert static == continuous == want


# ---------------------------------------------------------------------------
# budgets and fault primitives
# ---------------------------------------------------------------------------


def _rate_script(cls):
    """tests/test_rate_alloc.py's RateBudget steps: (targets, realized,
    overrun flags, overrun bits, summary has OVERRUN)."""
    out = []
    rb = cls(target_bits_per_param=3.0,
             layer_params={"a": 100, "b": 100, "c": 200})
    out.append(rb.next_target("a"))
    rb.record("a", 2.0)
    out.append(rb.next_target("b"))
    rb.record("b", 10 / 3)
    rb.record("c", rb.next_target("c"))
    out += [rb.realized_rate, rb.budget_overrun]
    rb = cls(1.0, {"a": 100, "b": 100})
    rb.record("a", 1.98)
    t = rb.next_target("b")
    rb.record("b", t)
    out += [t, rb.budget_overrun, rb.overrun_bits, rb.realized_rate,
            any("OVERRUN" in line for line in rb.summary())]
    with pytest.raises(KeyError):
        rb.next_target("a")
    return out


def test_rate_budget_matches_reference():
    """vs repro.core.RateBudget (tests/test_rate_alloc.py's cases)."""
    from repro.core import RateBudget as JRateBudget
    got, want = _rate_script(RateBudget), _rate_script(JRateBudget)
    assert got == want
    assert got[0] == pytest.approx(3.0) and got[1] == pytest.approx(1000 / 300)
    assert got[3] is False and got[5] is True and got[8] is True
    assert got[6] == pytest.approx(0.05 * 100 - (200 - 198))


def test_plan_budget_matches_reference():
    """vs repro.core.PlanBudget (test_plan_budget_delegates_to_plan)."""
    from repro.core import PlanBudget as JPlanBudget
    from repro.plan import MatrixSensitivity as JSens
    from repro.plan import build_plan as jbuild
    outs = []
    for pb_cls, sens_cls, build in ((PlanBudget, MatrixSensitivity,
                                     build_plan),
                                    (JPlanBudget, JSens, jbuild)):
        sens = [sens_cls(name=f"L0/m{i}", out_features=8, in_features=16,
                         sigma_w2=1.0, lambdas=np.full(16, v))
                for i, v in enumerate([16.0, 1.0])]
        plan = build(sens, 3.0, snap=False, weighting="uniform")
        pb = pb_cls(plan)
        t0, t1 = pb.next_target("L0/m0"), pb.next_target("L0/m1")
        pb.record("L0/m0", t0)
        pb.record("L0/m1", t1)
        with pytest.raises(KeyError):
            pb.next_target("L0/m0")
        with pytest.raises(KeyError):
            pb.next_target("L9/nope")
        outs.append((pb.target_bits_per_param, t0, t1, pb.realized_rate,
                     plan.entry("L0/m0").achieved_bits, pb.total_params,
                     pb.budget_overrun, pb.summary()))
    assert outs[0] == outs[1]
    assert outs[0][1] == pytest.approx(4.0, abs=1e-6)
    assert outs[0][2] == pytest.approx(2.0, abs=1e-6)


def _heartbeat(pkg, tmp):
    hb = pkg.Heartbeat(str(tmp), "h0")
    hb.beat(5)
    pkg.Heartbeat(str(tmp), "h1").beat(7)
    return pkg.Heartbeat.alive_hosts(str(tmp)), \
        pkg.Heartbeat.alive_hosts(str(tmp), max_age_s=60)


def _straggler(pkg, tmp):
    rng = np.random.default_rng(4)
    mon = pkg.StragglerMonitor(threshold=1.5, min_observations=3,
                               skip_first=1)
    for _ in range(6):
        for h, t in (("a", 1.0), ("b", 1.05), ("c", 2.5)):
            mon.observe(h, t + 0.01 * float(rng.random()))
    return mon.stragglers(), mon.means(min_count=3)


def _restart(pkg, tmp):
    pol = pkg.RestartPolicy(max_restarts=3, backoff_base_s=0.5,
                            backoff_max_s=1.5, reset_after=2)
    seq = [pol.next_delay(), pol.next_delay()]
    pol.record_success()
    pol.record_success()
    seq += [pol.restarts_used] + [pol.next_delay() for _ in range(4)]
    return seq


@pytest.mark.parametrize("case", [_heartbeat, _straggler, _restart],
                         ids=["heartbeat", "straggler", "restart"])
def test_fault_primitives_match_reference(case, tmp_path):
    """vs repro.dist.fault: the same operations give the same answers, and
    a heartbeat written by one package reads in the other."""
    import repro.dist.fault as jfault
    import repro_torch.dist.fault as tfault
    got = case(tfault, tmp_path / "port")
    want = case(jfault, tmp_path / "ref")
    assert got == want
    if case is _heartbeat:
        assert got[0] == {"h0": 5, "h1": 7}
        assert jfault.Heartbeat.alive_hosts(str(tmp_path / "port")) == got[0]
    if case is _straggler:
        assert got[0] == ["c"]
    if case is _restart:
        assert got == [0.5, 1.0, 0, 0.5, 1.0, 1.5, None]


# ---------------------------------------------------------------------------
# the command line (launch/plan.py)
# ---------------------------------------------------------------------------


def test_launch_plan_runs_and_refuses_foreign_provenance(tmp_path, capsys):
    """build → inspect → execute → serve on the CPU at the reduced
    minicpm-2b; a plan without the port's provenance (one the JAX package
    built) is refused instead of run against other weights."""
    from repro_torch.launch import plan as launch
    path = str(tmp_path / "p.json")
    plan = launch.main(["build", "--arch", "minicpm-2b", "--reduced",
                        "--target-bits", "5", "--seq-len", "16",
                        "--out", path, "--device", "cpu"])
    assert plan.provenance["init"] == launch.INIT
    assert set(plan.payload_histogram()) == {4, 8}
    launch.main(["inspect", "--plan", path, "--diff", path])
    out = capsys.readouterr().out
    assert "payloads: int4×" in out and "(allocations identical)" in out
    executed = launch.main(["execute", "--plan", path, "--workers", "2",
                            "--device", "cpu"])
    assert executed.realized_bits_per_param == pytest.approx(
        executed.planned_bits_per_param, abs=0.05)
    # the same plan rebuilds the same weights: execute twice, same bits
    again = launch.main(["execute", "--plan", path, "--out",
                         str(tmp_path / "again.json"), "--device", "cpu"])
    assert again.to_json() == executed.to_json()
    done = launch.main(["serve", "--plan", path, "--requests", "2",
                        "--max-new", "3", "--device", "cpu"])
    assert [len(r.out_tokens) for r in done] == [3, 3]
    foreign = QuantPlan.load(path)
    foreign.provenance.pop("init")
    foreign.save(path)
    with pytest.raises(ValueError, match="cannot be rebuilt"):
        launch.main(["execute", "--plan", path, "--device", "cpu"])
    with pytest.raises(ValueError, match="init=None"):
        launch.model_from_provenance({"arch": "minicpm-2b"}, "cpu")
    assert math.isfinite(sum(e.realized_distortion for e in executed))
