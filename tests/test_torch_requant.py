"""Live requantization (``repro_torch.serve.requant``) held against the JAX
package.

``replan_from_sigma`` from the same plan (crossed as JSON) and the same Σ
snapshots gives the reference's re-plan — the same affected matrices and
snapped payloads, targets within float64 eigensolver rounding — and a
byte-identical served tree.  ``engine_from_plan`` closes the loop on the
port's engine: one actuation, the swap at the next step boundary, every
busy step emitting, the online swap equal to the offline re-plan byte for
byte, a device-loss fault during the re-plan retried to the same tree,
and the reference bench's requant cell passing ``check_requant.py``.
"""
import functools
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import assert_trees_equal, to_numpy
from repro_torch import chaos, obs
from repro_torch.chaos import ChaosPlan, FaultSpec, InjectedFault
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.dist.fault import RestartPolicy
from repro_torch.models import from_jax_params
from repro_torch.plan import (QuantPlan, build_plan, collect_sigma_x,
                              model_sensitivities)
from repro_torch.quant import quantize_params_tree
from repro_torch.quant.pipeline import matrix_tap_map
from repro_torch.serve import (ContinuousEngine, EngineConfig, QualityConfig,
                               Request, RequantConfig, ResilienceConfig,
                               SigmaSnapshot, engine_from_plan,
                               replan_from_sigma, sigma_threshold_detectors)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(name="rq", family="dense", n_layers=2, d_model=32, n_heads=2,
           n_kv=2, d_ff=64, vocab=64, head_dim=16)
TCFG = TArchConfig(**CFG)
QKW = {"min_dim": 16}


@pytest.fixture(autouse=True)
def _isolated_obs():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


@functools.lru_cache(maxsize=None)
def _jparams():
    import jax
    from repro.configs.base import ArchConfig
    from repro.models import init_params, split_tree
    return to_numpy(split_tree(init_params(ArchConfig(**CFG),
                                           jax.random.PRNGKey(0)))[0])


def _calib():
    rng = np.random.default_rng(1)
    return [rng.integers(0, CFG["vocab"], (2, 12)).astype(np.int32)
            for _ in range(2)]


def _fixture():
    """The port's plan-serving inputs (reference weights, port plan)."""
    params = from_jax_params(_jparams(), "cpu")
    sens = model_sensitivities(TCFG, params, _calib(), weighting="output")
    plan = build_plan(sens, 4.0, weighting="output")
    return params, sens, plan, collect_sigma_x(TCFG, params, _calib())


def _snapshots():
    """Seeded streamed-Σ snapshots for three taps (rank deficient, as a
    drift burst's are)."""
    rng = np.random.default_rng(8)
    out = {}
    for tap, d in (("L0/x_attn", 32), ("L1/hidden", 64), ("L1/ctx", 32)):
        x = rng.standard_normal((24, d)) * rng.uniform(0.5, 3.0, d)
        out[tap] = SigmaSnapshot(sigma=x.T @ x / 24, n=24.0)
    return out


def test_replan_from_sigma_matches_reference():
    """Same plan (JSON from the reference) and snapshots: same affected
    matrices and snapped payload bits, targets equal to 1e-9, and a served
    tree byte-identical to the reference's."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ArchConfig
    from repro.plan import build_plan as jbuild
    from repro.plan import model_sensitivities as jsens
    from repro.serve import SigmaSnapshot as JSnap
    from repro.serve import replan_from_sigma as jreplan
    jp = jax.tree.map(jnp.asarray, _jparams())
    jcfg = ArchConfig(**CFG)
    jplan = jbuild(jsens(jcfg, jp, _calib(), weighting="output"), 4.0,
                   weighting="output")
    tplan = QuantPlan.from_json(jplan.to_json())
    snaps = _snapshots()
    want_plan, want_tree, _, _, want_aff = jreplan(
        jcfg, jp, jplan, {t: JSnap(sigma=s.sigma, n=s.n)
                          for t, s in snaps.items()}, quantize_kwargs=QKW)
    got_plan, got_tree, qlin, report, got_aff = replan_from_sigma(
        TCFG, from_jax_params(_jparams(), "cpu"), tplan, snaps,
        quantize_kwargs=QKW)
    assert got_aff == want_aff and len(got_aff) == 5
    for g, w in zip(got_plan.entries, want_plan.entries):
        assert (g.name, g.payload_bits, g.floor_bits, g.ceil_bits) == \
            (w.name, w.payload_bits, w.floor_bits, w.ceil_bits)
        assert g.target_bits == pytest.approx(w.target_bits, abs=1e-9)
        assert g.weight == pytest.approx(w.weight, rel=1e-9)
    assert got_plan.budget_overrun == want_plan.budget_overrun
    assert_trees_equal(got_tree, want_tree)
    assert sorted(qlin) == got_aff and sorted(report.task_s) == got_aff
    assert all(got_plan.entry(n).achieved_bits is not None for n in got_aff)


def test_replan_is_a_pure_function_of_its_snapshots():
    params, _, plan, _ = _fixture()
    a = replan_from_sigma(TCFG, params, plan, _snapshots(),
                          quantize_kwargs=QKW)
    b = replan_from_sigma(TCFG, params, plan, _snapshots(),
                          quantize_kwargs=QKW)
    assert a[0].to_json() == b[0].to_json()
    assert_trees_equal(a[1], b[1])
    with pytest.raises(ValueError, match="no plan matrices"):
        replan_from_sigma(TCFG, params, plan, {"L9/x_attn": _snapshots()[
            "L0/x_attn"]})


def _drift_engine(params, sens, plan, acc, *, resilience=None):
    qc = QualityConfig(sigma_every=1, probe_every=10_000, slo_every=10_000,
                       detectors=sigma_threshold_detectors(
                           matrix_tap_map(TCFG, params), limit=2.0))
    ec = EngineConfig(n_slots=2, max_len=32, resilience=resilience,
                      requant=RequantConfig(min_samples=8, cooldown_steps=4,
                                            max_actuations=1))
    eng = engine_from_plan(TCFG, params, plan, calib=acc,
                           sensitivities=sens, quality_config=qc, config=ec,
                           quantize_kwargs=QKW)
    rng = np.random.default_rng(3)
    for phase, prompts, steps in (
            (0, [rng.integers(0, CFG["vocab"], 8).astype(np.int32)
                 for _ in range(4)], 30),
            (100, [np.full(8, 7, np.int32) for _ in range(10)], 70)):
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=phase + i, prompt=p, max_new_tokens=6))
        for _ in range(steps):
            eng.step()
    return eng


def _leaves(tree):
    return [leaf for _, leaf in sorted(_walk_flat(tree))]


def _walk_flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk_flat(v, path + (k,))
    else:
        yield path, tree


def test_engine_actuates_once_and_swaps_at_a_step_boundary():
    params, sens, plan, acc = _fixture()
    with obs.scoped(enable_obs=True):
        eng = _drift_engine(params, sens, plan, acc)
        snap = obs.counters_snapshot("repro_requant_")
    [a] = eng.requant.actuations
    assert a["taps"] and a["matrices"]
    assert [t for t, why in eng.swap_history if why == "requant"] == \
        [a["tick"] + 1]
    busy = [st for st in eng.step_stats if st.active or st.admitted]
    assert busy and all(st.new_tokens >= 1 for st in busy)
    assert not any(r.dropped for r in eng.finished)
    assert snap["repro_requant_actuations_total"] == 1
    for t in a["taps"]:
        assert np.array_equal(eng.requant.monitor._ref_sigma[f"{t}/xx"],
                              a["snapshots"][t].sigma)
    new_plan, tree, _, _, affected = replan_from_sigma(
        TCFG, params, a["plan_before"], a["snapshots"], quantize_kwargs=QKW)
    assert affected == a["matrices"]
    assert new_plan.entries == a["plan_after"].entries
    live, off = _leaves(eng.params), _leaves(tree)
    assert len(live) == len(off)
    assert all(torch.equal(x, y) for x, y in zip(live, off))
    # the decode reads the swapped tree through rebuilt per-layer views
    assert eng._step_params["layers"][0]["attn"]["wq"]["w"] is not None
    assert _leaves(eng._step_params["embed"]) == _leaves(eng.params["embed"])


def test_device_loss_during_requant_recovers_to_the_same_tree():
    params, sens, plan, acc = _fixture()
    res = ResilienceConfig(retry=RestartPolicy(max_restarts=2,
                                               backoff_base_s=0.0,
                                               backoff_max_s=0.0))
    fault = ChaosPlan(seed=0, specs=(FaultSpec(
        kind="device-loss", site="requant.execute", at=(0,)),))
    with obs.scoped(enable_obs=True):
        clean = _drift_engine(params, sens, plan, acc, resilience=res)
    with obs.scoped(enable_obs=True), chaos.active(fault) as rt:
        faulty = _drift_engine(params, sens, plan, acc, resilience=res)
    assert rt.injected() == 1
    assert len(clean.requant.actuations) == len(faulty.requant.actuations) \
        == 1
    assert all(torch.equal(x, y) for x, y in
               zip(_leaves(clean.params), _leaves(faulty.params)))
    with obs.scoped(enable_obs=True), chaos.active(fault):
        with pytest.raises(InjectedFault):
            _drift_engine(params, sens, plan, acc)


def test_payload_guard_rebaselines_after_hot_swap():
    """A legitimate swap re-snapshots the pristine bytes (the guard does
    not 'heal' the new tree back to the old one), and the decode then
    reads the new tree's views."""
    params = from_jax_params(_jparams(), "cpu")
    tree_a = quantize_params_tree(params, min_dim=16)
    tree_b = quantize_params_tree(params, nbits=4, packed=True, min_dim=16)
    eng = ContinuousEngine(TCFG, tree_a, config=EngineConfig(
        n_slots=2, max_len=32, resilience=ResilienceConfig(
            integrity_every=1)))
    rng = np.random.default_rng(5)
    eng.submit(Request(rid=0, prompt=rng.integers(0, 64, 8).astype(np.int32),
                       max_new_tokens=6))
    for _ in range(3):
        eng.step()
    before = dict(eng._guard.checksums)
    eng.request_swap(tree_b, reason="test")
    with obs.scoped(enable_obs=True):
        eng.submit(Request(rid=1, prompt=rng.integers(0, 64, 8).astype(
            np.int32), max_new_tokens=6))
        for _ in range(6):
            eng.step()
        healed = obs.counters_snapshot("repro_serve_integrity")
    assert eng.params is tree_b and not healed
    assert eng._guard.checksums != before
    assert eng._guard.verify(eng.params) == []
    assert set(eng.weight_formats) == {"float32", "packed-int4"}
    wq = eng._step_params["layers"][1]["attn"]["wq"]["w"]
    assert wq["codes"].data_ptr() == \
        tree_b["layers"]["attn"]["wq"]["w"]["codes"][1].data_ptr()


def test_requant_cell_passes_check_requant(tmp_path):
    """The reference bench's requant cell on the port
    (``chip_smoke.requant_cell``; the bench's quick model at half its
    width on the CPU):
    ``benchmarks/check_requant.py`` passes on the bench JSON unchanged."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from repro_torch.models import init_params
    cfg = TArchConfig(**dict(chip_smoke.BENCH_CFG, n_layers=2, d_model=64,
                             d_ff=128, head_dim=16))
    dev = torch.device("cpu")
    rq = chip_smoke.requant_cell(cfg, init_params(cfg, 0, device=dev), dev)
    path = tmp_path / "bench.json"
    path.write_text(json.dumps({**chip_smoke.bench_envelope(dev),
                                "requant": rq}, default=float))
    gate = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "check_requant.py"),
         "--bench", str(path)], capture_output=True, text=True, timeout=60)
    assert gate.returncode == 0, gate.stdout + gate.stderr
    assert "check_requant: OK" in gate.stdout
    assert rq["bit_identical"] and rq["actuations"] == 1


def test_smoke_full_width_requant_phase_on_cpu():
    """``chip_smoke.requant_full_phase`` at the reduced config on the CPU:
    the limit is fixed at 1.5x the clean phase's peak Frobenius shift and
    the repeated-token phase actuates exactly once."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from repro_torch.configs import get_config
    rec = chip_smoke.requant_full_phase(get_config("minicpm-2b").reduced(),
                                        torch.device("cpu"))
    assert rec["limit"] == pytest.approx(1.5 * rec["clean_peak_fro_shift"])
    assert rec["matrices"] and rec["tick"] > 0
