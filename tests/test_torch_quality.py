"""The quality observatory of ``repro_torch`` held against the JAX package.

``obs.drift``/``obs.slo``/``obs.streamsig`` are stdlib/numpy copies: the
same series raise the same drift flags, and burn rates and Σ shifts agree
within 1e-12 (float64).  ``serve.quality.QualityMonitor`` attached to the
port's engine, on the reference's weights and the same workload, gives
the reference monitor's summary within 1e-5 relative (float32 forwards
in two packages; the Σ spectra are float64 on the params' device).  With
obs off an attached monitor is never reached.  The reference bench's
quality cells, rebuilt on the port at half the bench's quick width, pass
``benchmarks/check_quality.py`` unchanged.
"""
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import to_numpy
from repro_torch import chaos, obs
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.models import from_jax_params
from repro_torch.obs import drift
from repro_torch.obs.metrics import Registry
from repro_torch.obs.slo import SloSpec, default_slos, evaluate_slos
from repro_torch.obs.streamsig import (SigmaTracker, StreamingSigma,
                                       frobenius_shift, spectrum_shift,
                                       top_eig_shift)
from repro_torch.serve import (ContinuousEngine, EngineConfig, QualityConfig,
                               QualityMonitor, Request, ResilienceConfig,
                               ServeEngine)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(name="q", family="dense", n_layers=2, d_model=32, n_heads=2,
           n_kv=2, d_ff=64, vocab=64, head_dim=16)
#: float32 forwards of two packages (sums in another order), carried into
#: float64 statistics: relative agreement of the monitor's summaries
SUMMARY_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _isolated_obs():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _series(seed=0):
    rng = np.random.default_rng(seed)
    x = list(rng.uniform(0.9, 1.1, 30)) + list(rng.uniform(4.0, 5.0, 10))
    x[12] = 9.0
    return x + list(rng.uniform(0.9, 1.1, 20))


# -- detectors, SLOs, streamed Σ ---------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drift_detectors_flag_the_same_samples(seed):
    from repro.obs import drift as jd
    series = _series(seed)
    for make in ((lambda m: m.PageHinkley()),
                 (lambda m: m.PageHinkley(delta=1.0, lam=8.0, burn_in=4)),
                 (lambda m: m.PageHinkley(direction="down", burn_in=4)),
                 (lambda m: m.Cusum()),
                 (lambda m: m.Cusum(k=1.0, h=8.0, burn_in=4,
                                    reset_on_flag=False)),
                 (lambda m: m.Threshold(limit=2.0))):
        a, b = make(drift), make(jd)
        assert [a.update(x) for x in series] == [b.update(x) for x in series]

    def monitor(m):
        mon = m.DriftMonitor(detectors={"integrity": lambda: m.Threshold(0.0)},
                             default=lambda: m.PageHinkley(lam=4.0,
                                                           burn_in=4))
        for i, x in enumerate(series):
            mon.observe("step_s", x)
            mon.observe("integrity", float(i == 25))
            mon.observe("sigma_fro:L0/x", x)
            if i == 30:
                mon.reset("sigma_fro:L0/x")
        return (mon.summary(), [(f.series, f.index) for f in
                                mon.flags_since(2, prefix="sigma_fro:")])

    assert monitor(drift) == monitor(jd)


def test_slo_burn_rates_match_reference():
    """The same observations in both packages' registries give the same
    verdict rows (floats within 1e-12)."""
    from repro.obs import metrics as jm
    from repro.obs import slo as js
    rng = np.random.default_rng(7)
    ttft = rng.exponential(0.2, 300)
    regs = (Registry(), jm.Registry())
    for reg in regs:
        for i, v in enumerate(ttft):
            reg.histogram("repro_serve_ttft_seconds",
                          engine="continuous" if i % 3 else "static") \
                .observe(float(v))
        reg.histogram("repro_serve_tpot_seconds").observe(0.01)
        reg.counter("repro_serve_dropped_total", reason="deadline").inc(3)
        reg.counter("repro_serve_finished_total").inc(97)
    specs = [default_slos(), default_slos(engine="continuous")]
    jspecs = [js.default_slos(), js.default_slos(engine="continuous")]
    for mine, theirs in zip(specs, jspecs):
        got = evaluate_slos(mine, regs[0], emit=False)
        want = js.evaluate_slos(theirs, regs[1], emit=False)
        assert [(r["slo"], r["kind"], r["ok"]) for r in got] == \
            [(r["slo"], r["kind"], r["ok"]) for r in want]
        for g, w in zip(got, want):
            for k in ("objective", "actual", "burn_rate"):
                assert g[k] == pytest.approx(w[k], rel=1e-12, abs=0)
    custom = SloSpec(name="p50", kind="quantile", quantile=0.5,
                     metric="repro_serve_ttft_seconds", objective=0.1)
    (row,) = evaluate_slos([custom], regs[0], emit=False)
    (jrow,) = js.evaluate_slos([js.SloSpec(**{
        k: getattr(custom, k) for k in ("name", "kind", "quantile",
                                        "metric", "objective")})],
        regs[1], emit=False)
    assert row["burn_rate"] == pytest.approx(jrow["burn_rate"], rel=1e-12)


def test_streamed_sigma_and_shifts_match_reference():
    from repro.obs import streamsig as jss
    rng = np.random.default_rng(1)
    x = rng.standard_normal((300, 7)) * np.arange(1, 8)
    a, b = StreamingSigma(7), jss.StreamingSigma(7)
    for chunk in np.array_split(x, 9):
        a.update(chunk)
        b.update(chunk)
    assert a.n == b.n == 300
    np.testing.assert_allclose(a.sigma, b.sigma, rtol=1e-12, atol=0)
    np.testing.assert_allclose(a.spectrum(), b.spectrum(), rtol=1e-12,
                               atol=1e-12)
    ref = x[:50].T @ x[:50] / 50
    for f, jf in ((frobenius_shift, jss.frobenius_shift),
                  (top_eig_shift, jss.top_eig_shift),
                  (spectrum_shift, jss.spectrum_shift)):
        args = ((a.sigma, ref) if f is frobenius_shift
                else (a.spectrum(), np.linalg.eigvalsh(ref)[:5]))
        assert f(*args) == pytest.approx(jf(*args), rel=1e-12)
    tr, jtr = SigmaTracker(), jss.SigmaTracker()
    for t in (tr, jtr):
        t.update("L0/x_attn", x[:40])
        t.update("L1/ctx", x[40:90, :4])
        t.update("L0/x_attn", x[90:])
    assert tr.keys() == jtr.keys()
    assert frobenius_shift(tr.get("L0/x_attn").sigma, ref) == \
        pytest.approx(jss.frobenius_shift(jtr.get("L0/x_attn").sigma, ref),
                      rel=1e-12)


# -- the monitor on served traffic --------------------------------------------


def _jparams():
    import jax
    from repro.configs.base import ArchConfig
    from repro.models import init_params, split_tree
    return to_numpy(split_tree(init_params(ArchConfig(**CFG),
                                           jax.random.PRNGKey(0)))[0])


def _quiet(mod, **kw):
    """Fast cadence over a 4-token window (one shadow shape per row
    count, so the reference jits few forwards); the wall-clock step_s
    series pinned out (the one nondeterministic series)."""
    kw.setdefault("window", 4)
    kw.setdefault("sigma_every", 2)
    kw.setdefault("probe_every", 4)
    kw.setdefault("slo_every", 4)
    kw.setdefault("detectors", {"step_s": lambda: mod.Threshold(math.inf),
                                "integrity": lambda: mod.Threshold(0.0)})
    return kw


def _prompts(n=4, plen=6, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab"], plen).astype(np.int32)
            for _ in range(n)]


def _calib_tokens():
    rng = np.random.default_rng(4)
    return [rng.integers(0, CFG["vocab"], (2, 12)).astype(np.int32)
            for _ in range(2)]


def _serve(eng, request_cls, plan=None, chaos_mod=None):
    for i, p in enumerate(_prompts()):
        eng.submit(request_cls(rid=i, prompt=p.copy(), max_new_tokens=6))
    if plan is None:
        return eng.run_until_done()
    with chaos_mod.active(plan):
        return eng.run_until_done()


def _reference_summary(faulted):
    import jax
    import jax.numpy as jnp
    from repro import chaos as jchaos
    from repro import obs as jobs
    from repro import serve as jserve
    from repro.configs.base import ArchConfig
    from repro.obs import drift as jd
    from repro.plan.sensitivity import collect_sigma_x
    from repro.quant import quantize_params_tree
    params = jax.tree.map(jnp.asarray, _jparams())
    qtree = quantize_params_tree(params, nbits=4, packed=True, min_dim=16)
    acc = collect_sigma_x(ArchConfig(**CFG), params,
                          [jnp.asarray(t) for t in _calib_tokens()])
    with jobs.scoped(enable_obs=True):
        mon = jserve.QualityMonitor(ArchConfig(**CFG), params, calib=acc,
                                    config=jserve.QualityConfig(
                                        **_quiet(jd)))
        eng = jserve.ContinuousEngine(
            ArchConfig(**CFG), qtree, config=jserve.EngineConfig(
                n_slots=2, max_len=16, prefill_chunk=4, quality=mon,
                resilience=jserve.ResilienceConfig(integrity_every=1)))
        plan = (jchaos.seeded_plan("corrupt-payload", seed=1, horizon=8,
                                   n_faults=2, first=1, n_bytes=3)
                if faulted else None)
        done = _serve(eng, jserve.Request, plan, jchaos)
        return mon.summary(), {r.rid: r.out_tokens for r in done}


def _port_summary(faulted, events_out=None):
    """The port's monitor summary and streams; ``events_out`` also writes
    the scope's JSONL metric log there."""
    from repro_torch.plan import collect_sigma_x
    from repro_torch.quant import quantize_params_tree
    cfg = TArchConfig(**CFG)
    params = from_jax_params(_jparams(), "cpu")
    qtree = quantize_params_tree(params, nbits=4, packed=True, min_dim=16)
    acc = collect_sigma_x(cfg, params, _calib_tokens())
    with obs.scoped(enable_obs=True):
        mon = QualityMonitor(cfg, params, calib=acc, config=QualityConfig(
            **_quiet(drift)))
        eng = ContinuousEngine(cfg, qtree, config=EngineConfig(
            n_slots=2, max_len=16, prefill_chunk=4, quality=mon,
            resilience=ResilienceConfig(integrity_every=1)))
        plan = (chaos.seeded_plan("corrupt-payload", seed=1, horizon=8,
                                  n_faults=2, first=1, n_bytes=3)
                if faulted else None)
        done = _serve(eng, Request, plan, chaos)
        if events_out:
            obs.write_jsonl(events_out)
        return mon.summary(), {r.rid: r.out_tokens for r in done}


def _close(a, b):
    if a is None or b is None:
        return a is b
    return a == pytest.approx(b, rel=SUMMARY_RTOL, abs=0)


@pytest.mark.parametrize("faulted", [False, True])
def test_monitor_summary_matches_reference(faulted):
    """The same served workload (clean, and under a seeded corrupt-payload
    plan that must flag ``integrity``): ticks, probes, per-matrix
    measured / expected / ratio / attribution, drift verdicts and Σ keys
    agree (floats within SUMMARY_RTOL); the streams are equal."""
    got, out = _port_summary(faulted)
    want, jout = _reference_summary(faulted)
    assert out == jout
    for k in ("ticks", "n_probes", "sigma_keys", "drift"):
        assert got[k] == want[k], k
    assert _close(got["logits_mse_mean"], want["logits_mse_mean"])
    assert len(got["matrices"]) == len(want["matrices"]) > 0
    for g, w in zip(got["matrices"], want["matrices"]):
        for k in ("matrix", "layer", "format", "n"):
            assert g[k] == w[k]
        for k in ("measured", "expected", "ratio", "attrib"):
            assert _close(g[k], w[k]), (g["matrix"], k, g[k], w[k])
    assert [r["slo"] for r in got["slo"]] == [r["slo"] for r in want["slo"]]
    assert got["drift"]["series"].get("integrity", 0) == (2 if faulted
                                                          else 0)


def test_metrics_summary_quality_tables_match_reference(tmp_path):
    """``launch.summarize --metrics`` of a log that holds the monitor's
    drift, SLO-burn and attribution series (the faulted run flags
    ``integrity``) prints the reference's ``metrics_summary`` text
    (``repro/launch/summarize.py``), its quality tables included."""
    from repro.launch.summarize import metrics_summary as jsummary
    from repro_torch.launch import summarize
    path = tmp_path / "events.jsonl"
    _port_summary(True, events_out=str(path))
    lines = path.read_text().splitlines()
    names = {json.loads(ln)["name"] for ln in lines}
    assert {"repro_quality_drift_total", "repro_slo_burn_rate",
            "repro_quality_attrib"} <= names
    text = summarize.metrics_summary(lines)
    assert text == jsummary(lines)
    for head in ("drift verdicts:", "slo burn rates", "quality attribution"):
        assert head in text
    assert "DRIFT x" in text


@pytest.mark.parametrize("cls", [ServeEngine, ContinuousEngine])
def test_disabled_obs_never_reaches_attached_monitor(cls):
    from repro_torch.quant import quantize_params_tree
    cfg = TArchConfig(**CFG)
    params = from_jax_params(_jparams(), "cpu")
    qtree = quantize_params_tree(params, nbits=4, packed=True, min_dim=16)

    def run(mon):
        eng = cls(cfg, qtree, config=EngineConfig(
            n_slots=2, max_len=16, prefill_chunk=4, quality=mon))
        return {r.rid: r.out_tokens for r in _serve(eng, Request)}

    base = run(None)
    mon = QualityMonitor(cfg, params, config=QualityConfig(
        **_quiet(drift)))
    assert run(mon) == base
    assert mon.tick == 0 and mon.probes == []
    assert obs.counters_snapshot() == {}


def test_on_swap_and_rebase_reset_the_caches():
    from repro_torch.plan import collect_sigma_x
    cfg = TArchConfig(**CFG)
    params = from_jax_params(_jparams(), "cpu")
    acc = collect_sigma_x(cfg, params, _calib_tokens())
    mon = QualityMonitor(cfg, params, calib=acc)
    mon._expected["L0/attn/wq"] = {"packed-int4": 1.0}
    mon.on_swap(reason="requant")
    assert mon._expected == {}
    mon.drift.observe("sigma_fro:L0/x_attn", 1.0)
    mon._attrib_w["L0/attn/wq"] = 3.0
    new = np.eye(32) * 2.0
    mon.rebase_sigma({"L0/x_attn": new})
    assert np.array_equal(mon._ref_sigma["L0/x_attn/xx"], new)
    np.testing.assert_allclose(mon._ref_spec["L0/x_attn/xx"], np.full(32, 2.))
    assert "L0/attn/wq" not in mon._attrib_w
    assert "sigma_fro:L0/x_attn" not in mon.drift._live


def test_quality_cells_pass_check_quality(tmp_path):
    """The reference bench's clean and chaos quality cells on the port
    (``chip_smoke.quality_cells``; the bench's quick model at half its
    width on the CPU):
    ``benchmarks/check_quality.py`` passes on the bench JSON unchanged."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from repro_torch.models import init_params
    cfg = TArchConfig(**dict(chip_smoke.BENCH_CFG, n_layers=2, d_model=64,
                             d_ff=128, head_dim=16))
    dev = torch.device("cpu")
    # the bench's 0.25 s step detector and 0.5 s sleep assume a dedicated
    # device; the twins on a shared CPU take a 1.5 s limit and a 3 s sleep
    quality = chip_smoke.quality_cells(cfg, init_params(cfg, 0, device=dev),
                                       dev, budget=16, step_limit_s=1.5,
                                       delay_s=3.0)
    path = tmp_path / "bench.json"
    path.write_text(json.dumps({**chip_smoke.bench_envelope(dev),
                                "quality": quality}, default=float))
    gate = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "check_quality.py"),
         "--bench", str(path)], capture_output=True, text=True, timeout=60)
    assert gate.returncode == 0, gate.stdout + gate.stderr
    assert "check_quality: OK" in gate.stdout
    assert quality["chaos"]["drift"]["series"]["integrity"] >= 1
