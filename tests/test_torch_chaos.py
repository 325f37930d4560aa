"""``repro_torch.chaos`` and the chaos matrix held against the JAX package.

The harness: for every fault kind and seed, ``seeded_plan`` gives the
reference's schedule (same sites, firing indices and knobs), and the
corrupt-payload fault flips the same bytes of the same leaf of the same
tree — in place on the port's tensors, so the dequant product reads them.
End to end: under every fault kind, at every firing index three seeds
produce, the port's continuous engine with the resilience layer on
emits the fault-free streams, which equal the reference engine's; the
port's ``launch.chaos`` artifacts pass ``benchmarks/check_chaos.py``
unchanged.
"""
import functools
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import to_numpy
from repro_torch import chaos
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.dist.fault import RestartPolicy
from repro_torch.kernels.dequant.ops import (_walk_qweights,
                                             payload_checksums,
                                             verify_payloads)
from repro_torch.launch import chaos as chaos_launch
from repro_torch.models import from_jax_params
from repro_torch.serve import (ContinuousEngine, EngineConfig, PayloadGuard,
                               Request, ResilienceConfig)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(name="chaos-t", family="dense", n_layers=2, d_model=32,
           n_heads=2, n_kv=2, d_ff=64, vocab=64, head_dim=16)
SEEDS = (0, 1, 2)


@functools.lru_cache(maxsize=None)
def _jtree():
    """The reference's seed-0 weights as packed int4, as numpy."""
    import jax
    from repro.configs.base import ArchConfig
    from repro.models import init_params, split_tree
    from repro.quant import quantize_params_tree
    base, _ = split_tree(init_params(ArchConfig(**CFG),
                                     jax.random.PRNGKey(0)))
    return to_numpy(quantize_params_tree(base, nbits=4, packed=True,
                                         min_dim=16))


def _ttree():
    return from_jax_params(_jtree(), "cpu")


def _workload(seed=0, n=5):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, CFG["vocab"], 5).astype(np.int32))
            for i in range(n)]


def _resilience(**over):
    kw = dict(retry=RestartPolicy(max_restarts=8, backoff_base_s=1e-4,
                                  backoff_max_s=1e-3, reset_after=2),
              retry_sleep=lambda s: None, integrity_every=1)
    kw.update(over)
    return ResilienceConfig(**kw)


def _engine(resilience=None, params=None):
    return ContinuousEngine(TArchConfig(**CFG),
                            _ttree() if params is None else params,
                            config=EngineConfig(n_slots=2, max_len=32,
                                                prefill_chunk=3,
                                                resilience=resilience))


def _run(resilience=None, plan=None):
    eng = _engine(resilience)
    for rid, p in _workload():
        eng.submit(Request(rid=rid, prompt=p.copy(), max_new_tokens=4))
    if plan is None:
        return eng, {r.rid: tuple(r.out_tokens)
                     for r in eng.run_until_done()}, None
    with chaos.active(plan) as rt:
        done = eng.run_until_done()
    return eng, {r.rid: tuple(r.out_tokens) for r in done}, rt


@functools.lru_cache(maxsize=None)
def _reference_streams():
    """The JAX package's continuous engine, fault-free, same workload."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ArchConfig
    from repro.serve import ContinuousEngine as JCont
    from repro.serve import EngineConfig as JConfig
    from repro.serve import Request as JRequest
    eng = JCont(ArchConfig(**CFG), jax.tree.map(jnp.asarray, _jtree()),
                config=JConfig(n_slots=2, max_len=32, prefill_chunk=3))
    for rid, p in _workload():
        eng.submit(JRequest(rid=rid, prompt=p.copy(), max_new_tokens=4))
    return {r.rid: tuple(r.out_tokens) for r in eng.run_until_done()}


# -- the harness against the reference's --------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", chaos.FAULT_KINDS)
def test_seeded_plan_matches_reference(kind, seed):
    """Same (kind, seed) → the same spec: site, firing indices, knobs —
    for the default plan and the chaos launcher's cell plans."""
    from repro import chaos as jchaos
    for kw in ({}, dict(horizon=4, n_faults=2, first=1, delay_s=0.25),
               dict(horizon=20, n_faults=2, first=2, delay_s=2.0)):
        got = chaos.seeded_plan(kind, seed, **kw)
        want = jchaos.seeded_plan(kind, seed, **kw)
        assert got.seed == want.seed
        assert [(s.kind, s.site, s.at, s.args) for s in got.specs] == \
            [(s.kind, s.site, s.at, s.args) for s in want.specs]
    with pytest.raises(ValueError, match="unknown fault kind"):
        chaos.seeded_plan("cosmic-ray", seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_corrupted_leaf_and_offsets_match_reference(seed):
    """The corrupt-payload fault picks the same leaf and XORs the same
    byte offsets as the reference's, on the port's tensors in place."""
    import jax
    import jax.numpy as jnp
    from repro import chaos as jchaos

    class JEng:
        params = jax.tree.map(jnp.asarray, _jtree())

    class TEng:
        params = _ttree()

    spec = dict(kind="corrupt-payload", site="serve.step", at=(0, 1),
                args=(("n_bytes", 5),))
    jeng, teng = JEng(), TEng()
    before = {p: leaf["codes"].clone() for p, leaf in
              _walk_qweights(teng.params)}
    jrt = jchaos.ChaosRuntime(jchaos.ChaosPlan(
        seed=seed, specs=(jchaos.FaultSpec(**spec),)))
    trt = chaos.ChaosRuntime(chaos.ChaosPlan(
        seed=seed, specs=(chaos.FaultSpec(**spec),)))
    for _ in range(2):
        jrt.fire("serve.step", engine=jeng)
        trt.fire("serve.step", engine=teng)
    assert trt.log == jrt.log
    jleaves = dict(_walk_qweights(to_numpy(jeng.params)))
    for path, leaf in _walk_qweights(teng.params):
        got, want = leaf["codes"].numpy(), jleaves[path]["codes"]
        assert got.tobytes() == np.asarray(want).tobytes(), path
        flipped = np.flatnonzero(got.reshape(-1).view(np.uint8)
                                 != before[path].numpy().reshape(-1)
                                 .view(np.uint8))
        assert flipped.size in (0, 5, 10), (path, flipped)


def test_corruption_reaches_the_product_and_heals_in_place():
    """The flipped bytes are the ones the dequant product reads (the
    engine's per-layer views share the codes tensor); PayloadGuard heals
    them in place and the product returns bit for bit."""
    from repro_torch.models.layers import dense
    from repro_torch.models.transformer import split_layers

    class Eng:
        params = _ttree()
    eng = Eng()
    views = split_layers(eng.params)
    guard = PayloadGuard(eng.params)
    plan = chaos.ChaosPlan(seed=5, specs=(chaos.FaultSpec(
        kind="corrupt-payload", site="serve.step", at=(0,),
        args=(("n_bytes", 64),)),))
    rt = chaos.ChaosRuntime(plan)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 64)).astype(np.float32))

    def products():
        """Every layer's product through the per-layer views, by path."""
        out = {}
        for path, _ in _walk_qweights(eng.params):
            ys = []
            for layer in views["layers"]:
                node = layer
                for k in path.split("/")[1:]:
                    node = node[k]
                ys.append(dense({"w": node}, x[:, :node["s"].shape[0]]))
            out[path] = torch.stack(ys)
        return out

    clean = products()
    rt.fire("serve.step", engine=eng)
    path = rt.log[0]["path"]
    bad = verify_payloads(eng.params, guard.checksums)
    assert bad == [path]
    dirty = products()
    assert not torch.equal(dirty[path], clean[path])
    assert all(torch.equal(dirty[p], clean[p]) for p in clean if p != path)
    codes_before = dict(_walk_qweights(eng.params))[path]["codes"]
    healed = guard.heal(eng.params, bad)
    assert healed is eng.params
    assert dict(_walk_qweights(eng.params))[path]["codes"] is codes_before
    assert verify_payloads(eng.params, guard.checksums) == []
    assert all(torch.equal(a, clean[p]) for p, a in products().items())
    assert payload_checksums(eng.params) == guard.checksums


def test_disabled_by_default_and_active_uninstalls():
    assert not chaos.enabled() and chaos.runtime() is None
    plan = chaos.seeded_plan("device-loss", 0)
    with pytest.raises(RuntimeError, match="boom"):
        with chaos.active(plan):
            assert chaos.enabled()
            raise RuntimeError("boom")
    assert not chaos.enabled()


def test_fire_counts_invocations_and_raises_on_schedule():
    plan = chaos.ChaosPlan(seed=0, specs=(
        chaos.FaultSpec(kind="device-loss", site="serve.decode", at=(1, 3)),
        chaos.FaultSpec(kind="clock-skew", site="serve.decode", at=(3,),
                        args=(("skew_s", 7.0),))))
    rt = chaos.ChaosRuntime(plan)

    class Eng:
        _clock_skew_s = 0.0
    eng = Eng()
    raised = []
    for i in range(5):
        try:
            rt.fire("serve.decode", engine=eng)
        except chaos.InjectedFault as e:
            raised.append(e.index)
    assert raised == [1, 3] and rt.counters == {"serve.decode": 5}
    assert eng._clock_skew_s == 7.0      # the sibling fired before the raise
    assert rt.injected() == 3 and rt.injected("clock-skew") == 1


# -- end to end ---------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", chaos.FAULT_KINDS)
def test_streams_identical_under_fault(kind, seed):
    """Recovered streams equal the fault-free run's and the reference
    engine's, at every firing index of three seeds; nothing dropped."""
    _, baseline, _ = _run()
    assert baseline == _reference_streams()
    horizon = 3 if kind == "admission-failure" else 12
    plan = chaos.seeded_plan(kind, seed=seed, horizon=horizon, n_faults=2,
                             first=1, delay_s=1e-3)
    eng, faulted, rt = _run(_resilience(), plan)
    assert rt.injected() >= 1, "plan injected nothing: test proves nothing"
    assert faulted == baseline
    assert eng.dropped == []
    if kind == "clock-skew":
        assert eng._clock_skew_s == 3600.0 * rt.injected()


def test_unretried_injection_propagates():
    plan = chaos.ChaosPlan(seed=0, specs=(
        chaos.FaultSpec(kind="device-loss", site="serve.decode", at=(0,)),))
    eng = _engine()
    for rid, p in _workload():
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=4))
    with chaos.active(plan):
        with pytest.raises(chaos.InjectedFault):
            eng.run_until_done()


def test_admission_failure_requeues_in_order_and_frees_slots():
    """Retry budget 0: the popped burst returns to the queue front in
    arrival order and its reserved slots are freed; then the engine
    finishes with the fault-free streams."""
    eng = _engine(ResilienceConfig(retry=RestartPolicy(max_restarts=0),
                                   retry_sleep=lambda s: None))
    rids = []
    for rid, p in _workload():
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=4))
        rids.append(rid)
    plan = chaos.ChaosPlan(seed=0, specs=(
        chaos.FaultSpec(kind="admission-failure", site="serve.admit",
                        at=(0,)),))
    with chaos.active(plan):
        with pytest.raises(chaos.InjectedFault):
            eng.step()
    assert [r.rid for r in eng.queue] == rids
    assert all(s is None for s in eng.slots)
    done = eng.run_until_done()
    assert {r.rid: tuple(r.out_tokens) for r in done} == _run()[1]


@pytest.mark.parametrize("kind", chaos.FAULT_KINDS)
def test_launcher_artifacts_pass_check_chaos(kind, tmp_path):
    """``repro_torch.launch.chaos`` on the CPU (the reference's small
    model, seed 0): ``benchmarks/check_chaos.py`` passes unchanged."""
    summary = tmp_path / "chaos.json"
    trace = tmp_path / "trace.json"
    out = chaos_launch.main(["--kind", kind, "--seed", "0", "--device",
                             "cpu", "--json-out", str(summary),
                             "--trace-out", str(trace)])
    assert out["streams_match"] and out["resume_match"]
    assert json.loads(summary.read_text())["kind"] == kind
    gate = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "check_chaos.py"),
         "--summary", str(summary), "--trace", str(trace)],
        capture_output=True, text=True, timeout=60)
    assert gate.returncode == 0, gate.stdout + gate.stderr
    assert "all recovery invariants hold" in gate.stdout
