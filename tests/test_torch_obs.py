"""Port of the observability layer held against the JAX package.

* ``repro_torch.obs.metrics`` / ``trace`` against ``repro.obs.metrics`` /
  ``trace``: the same updates give the same Prometheus text and JSONL, the
  same spans the same Chrome trace apart from the timestamps.
* ``repro_torch.obs`` disabled is a strict no-op: shared null objects, an
  empty registry and tracer.
* The engines (``repro_torch.serve``) against ``repro.serve`` on one
  reduced run with obs on: the same span, instant, counter, gauge and
  histogram names, labels, arguments and per-slot lanes, and the same
  ``repro_kernel_hbm_bytes_total{format}`` (``weight_format_bytes`` +
  ``record_weight_traffic``).  Streams with obs on equal streams with it
  off.
* The executor's ``plan.task`` / ``plan.execute`` spans and counters.
* The serve driver's ``--trace-out/--metrics-out/--events-out`` files load
  in the reference's ``launch.summarize --metrics``, and
  ``chip_smoke.obs_serve_phase`` (on the CPU, at reduced widths) writes
  artifacts that ``benchmarks/check_obs.py`` and ``check_bytes.py`` pass,
  run unchanged as subprocesses.
"""
import collections
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from _torch_parity import to_numpy
from repro_torch import obs
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.models import from_jax_params
from repro_torch.serve import (ContinuousEngine, EngineConfig, Request,
                               ServeEngine)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(name="ob", family="dense", n_layers=2, d_model=32, n_heads=2,
           n_kv=2, d_ff=64, vocab=64, head_dim=16)


def _updates(reg):
    """One sequence of updates on a metrics Registry (either package's)."""
    reg.counter("repro_serve_tokens_total", engine="continuous").inc(3)
    reg.counter("repro_serve_tokens_total", engine="static").inc(2.5)
    reg.counter("repro_kernel_hbm_bytes_total", format='pa"ck\\ed').inc(7)
    reg.gauge("repro_serve_queue_depth", engine="static").set(4)
    reg.gauge("repro_serve_queue_depth", engine="static").add(-1.5)
    h = reg.histogram("repro_serve_ttft_seconds", engine="continuous")
    rng = np.random.default_rng(0)
    for v in rng.exponential(0.01, 3000):      # past the exact capacity
        h.observe(float(v))
    reg.histogram("repro_plan_task_seconds").observe(0.25)
    reg.histogram("repro_empty_seconds")


def test_metrics_export_equals_reference():
    from repro.obs.metrics import Registry as JRegistry
    from repro_torch.obs.metrics import Registry
    got, want = Registry(), JRegistry()
    _updates(got)
    _updates(want)
    assert got.to_prometheus() == want.to_prometheus()
    assert list(got.jsonl_lines()) == list(want.jsonl_lines())
    assert got.counters_snapshot("repro_serve_") \
        == want.counters_snapshot("repro_serve_")
    with pytest.raises(ValueError):
        got.counter("repro_bad_name")
    with pytest.raises(TypeError):
        got.gauge("repro_serve_tokens_total", engine="static")


def _spans(tr):
    tr.complete("serve.prefill", tr.epoch + 1e-3, tr.epoch + 2e-3,
                engine="continuous", slots=[0, 1], calls=2)
    with tr.span("plan.task", matrix="L0/attn/wq", bits=3.0):
        pass
    tr.complete("serve.admit", tr.epoch + 3e-3, tr.epoch + 4e-3, tid=1,
                slot=1, rid=7)
    tr.instant("serve.request.finish", rid=7, slot=1)


def test_trace_equals_reference_apart_from_timestamps():
    from repro.obs.trace import Tracer as JTracer
    from repro_torch.obs.trace import Tracer
    got, want = Tracer(), JTracer()
    _spans(got)
    _spans(want)
    a, b = got.to_chrome(), want.to_chrome()

    def strip(doc):
        return sorted(json.dumps({k: v for k, v in e.items()
                                  if k not in ("ts", "dur")}, sort_keys=True)
                      for e in doc["traceEvents"])
    assert a["displayTimeUnit"] == b["displayTimeUnit"]
    assert strip(a) == strip(b)
    assert sorted(e["ph"] for e in a["traceEvents"]) == ["X", "X", "X", "i"]
    ts = [e["ts"] for e in a["traceEvents"]]
    assert ts == sorted(ts)


def test_disabled_obs_is_a_strict_noop():
    with obs.scoped(enable_obs=False) as (reg, tr):
        assert not obs.enabled()
        s1, s2 = obs.span("serve.step"), obs.span("plan.task", x=1)
        assert s1 is s2
        with s1:
            pass
        c = obs.counter("repro_serve_tokens_total")
        assert c is obs.gauge("repro_x") is obs.histogram("repro_y_seconds")
        c.inc(5)
        c.set(1)
        c.observe(2)
        obs.complete("serve.decode", 0.0, 1.0)
        obs.instant("serve.request.arrival")
        assert reg.metrics() == [] and tr.events == []
        assert obs.prometheus_text() == "" and list(obs.jsonl_lines()) == []
    with obs.scoped(enable_obs=True) as (reg, tr):
        obs.counter("repro_serve_tokens_total").inc()
        assert len(reg.metrics()) == 1
    assert obs.registry() is not reg


# ---------------------------------------------------------------------------
# the engines against the reference's, obs on
# ---------------------------------------------------------------------------


def _workload():
    rng = np.random.default_rng(11)
    return [(rng.integers(0, CFG["vocab"], int(rng.integers(3, 9)))
             .astype(np.int32), int(rng.integers(1, 6))) for _ in range(6)]


_TREE = {}


def _tree(fmt):
    if fmt not in _TREE:
        import jax
        from repro.configs.base import ArchConfig
        from repro.models import init_params, split_tree
        from repro.quant import quantize_params_tree
        base, _ = split_tree(init_params(ArchConfig(**CFG),
                                         jax.random.PRNGKey(2)))
        kw = {"int4": dict(nbits=4, packed=True), "int8": dict(nbits=8),
              "mixed": dict(nbits_by_path=lambda p: {"wq": 8, "w_up": 2}
                            .get(p[-2], 3))}[fmt]
        _TREE[fmt] = to_numpy(quantize_params_tree(base, min_dim=16, **kw))
    return _TREE[fmt]


def _run(eng, request):
    for rid, (prompt, budget) in enumerate(_workload()):
        eng.submit(request(rid=rid, prompt=prompt.copy(),
                           max_new_tokens=budget))
    return {r.rid: list(r.out_tokens) for r in eng.run_until_done()}


def _canonical(events):
    """Multiset of (name, phase, lane, args) — the timestamps aside; the
    lane (tid) only where an event sets it to a slot."""
    out = collections.Counter()
    for e in events:
        lane = e["tid"] if e["name"] == "serve.admit" else None
        out[(e["name"], e["ph"], lane,
             json.dumps(e["args"], sort_keys=True))] += 1
    return out


def _port_side(fmt, cls_name):
    cls = {"static": ServeEngine, "continuous": ContinuousEngine}[cls_name]
    tree = from_jax_params(_tree(fmt), "cpu")
    ec = EngineConfig(n_slots=3, max_len=16, cache_dtype=torch.float32,
                      prefill_chunk=4)
    with obs.scoped(enable_obs=True) as (reg, tr):
        streams = _run(cls(TArchConfig(**CFG), tree, config=ec), Request)
        return streams, _canonical(tr.events), reg


def _jax_side(fmt, cls_name):
    import jax.numpy as jnp
    from repro import obs as jobs
    from repro.configs.base import ArchConfig
    from repro.serve import ContinuousEngine as JCont
    from repro.serve import EngineConfig as JConfig
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServe
    cls = {"static": JServe, "continuous": JCont}[cls_name]
    ec = JConfig(n_slots=3, max_len=16, cache_dtype=jnp.float32,
                 prefill_chunk=4)
    with jobs.scoped(enable_obs=True) as (reg, tr):
        streams = _run(cls(ArchConfig(**CFG), _tree(fmt), config=ec),
                       JRequest)
        return streams, _canonical(tr.events), reg


def _series(reg):
    """{(name, labels): value or histogram count} without the dispatch
    counter (the reference counts jit traces there, the port calls)."""
    out = {}
    for m in reg.metrics():
        if m.name == "repro_kernel_dispatch_total":
            continue
        out[(m.name, m.key)] = m.count if m.kind == "histogram" else m.value
    return out


@pytest.mark.parametrize("fmt,engine", [("int4", "continuous"),
                                        ("mixed", "continuous"),
                                        ("int8", "static")])
def test_engine_obs_matches_reference(fmt, engine):
    """Same streams, the same events (names, args, per-slot lanes) and the
    same counters, gauges and histogram counts as ``repro.serve`` with
    ``repro.obs`` on; hbm bytes by format included."""
    got_streams, got_events, got_reg = _port_side(fmt, engine)
    want_streams, want_events, want_reg = _jax_side(fmt, engine)
    assert got_streams == want_streams
    assert got_events == want_events
    got, want = _series(got_reg), _series(want_reg)
    assert got == want
    assert any(k[0] == "repro_kernel_hbm_bytes_total" for k in got)
    # the dispatch counter's formats: the port's int8 leaves go through the
    # int8 kernel's entry (counted); the reference serves them with a
    # plain matmul outside its dequant entry points (not counted)
    fmts = {dict(m.key)["format"] for m in got_reg.metrics()
            if m.name == "repro_kernel_dispatch_total"}
    want_fmts = {dict(m.key)["format"] for m in want_reg.metrics()
                 if m.name == "repro_kernel_dispatch_total"}
    assert fmts - {"int8"} == want_fmts
    assert ("int8" in fmts) == (fmt in ("int8", "mixed"))
    if engine == "continuous":
        lanes = {k[2] for k in got_events if k[0] == "serve.admit"}
        assert lanes == {0, 1, 2}


@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_streams_and_stats_identical_with_obs_off(engine):
    """Obs on or off: the same streams and the same dispatch counts."""
    tree = from_jax_params(_tree("int4"), "cpu")
    cls = {"static": ServeEngine, "continuous": ContinuousEngine}[engine]
    ec = EngineConfig(n_slots=3, max_len=16, cache_dtype=torch.float32,
                      prefill_chunk=4)
    runs = []
    for on in (False, True):
        with obs.scoped(enable_obs=on) as (reg, tr):
            eng = cls(TArchConfig(**CFG), tree, config=ec)
            runs.append((_run(eng, Request),
                         [(s.prefill_calls, s.decode_calls, s.new_tokens)
                          for s in eng.round_stats] if engine == "static"
                         else (eng.prefill_calls, eng.decode_calls),
                         len(reg.metrics()), len(tr.events)))
    (s_off, st_off, m_off, e_off), (s_on, st_on, m_on, e_on) = runs
    assert s_off == s_on and st_off == st_on
    assert m_off == e_off == 0 and m_on > 0 and e_on > 0


def test_weight_format_bytes_and_traffic_match_reference():
    from repro import obs as jobs
    from repro.kernels.dequant.ops import record_weight_traffic as jrecord
    from repro.kernels.dequant.ops import weight_format_bytes as jbytes
    from repro_torch.kernels.dequant import (record_weight_traffic,
                                             weight_format_bytes)
    for fmt in ("int4", "int8", "mixed"):
        got = weight_format_bytes(from_jax_params(_tree(fmt), "cpu"))
        want = jbytes(_tree(fmt))
        assert got == want
        with obs.scoped(enable_obs=True), jobs.scoped(enable_obs=True):
            record_weight_traffic(got, 3)
            jrecord(want, 3)
            assert obs.counters_snapshot("repro_kernel_") \
                == jobs.counters_snapshot("repro_kernel_")
    record_weight_traffic(got, 3)              # obs off: nothing recorded
    assert obs.counters_snapshot("repro_kernel_") == {}


def test_executor_spans_and_counters():
    """``execute_plan`` with obs on: one ``plan.task`` span per matrix (the
    reference's args), one ``plan.execute`` span, the task counter and
    histogram; with obs off, nothing."""
    from repro_torch.core import CalibStats, random_covariance
    from repro_torch.plan import (build_plan, execute_plan,
                                  sensitivity_from_matrix)
    rng = np.random.default_rng(0)
    layers = []
    for i in range(3):
        sigma, _ = random_covariance(24, condition=10.0 ** (1 + i), seed=i)
        layers.append((f"syn{i}/mat", rng.standard_normal((16, 24)), sigma))
    plan = build_plan([sensitivity_from_matrix(n, w, s)
                       for n, w, s in layers], 3.0, weighting="uniform")
    weights = {n: torch.as_tensor(w) for n, w, _ in layers}
    stats = {n: CalibStats(sigma_x=torch.as_tensor(s)) for n, _, s in layers}
    with obs.scoped(enable_obs=True) as (reg, tr):
        execute_plan(plan, weights, stats, damp=1e-4, n_workers=2)
        names = collections.Counter(e["name"] for e in tr.events)
        tasks = [e for e in tr.events if e["name"] == "plan.task"]
        snap = obs.counters_snapshot("repro_plan_")
        hist = reg.histogram("repro_plan_task_seconds")
    assert names == {"plan.task": 3, "plan.execute": 1}
    assert sorted(e["args"]["matrix"] for e in tasks) == [n for n, _, _
                                                          in layers]
    assert {tuple(sorted(e["args"])) for e in tasks} \
        == {("bits", "device", "matrix")}
    assert snap == {"repro_plan_tasks_total": 3.0} and hist.count == 3
    with obs.scoped(enable_obs=False) as (reg, tr):
        execute_plan(plan, weights, stats, damp=1e-4)
        assert tr.events == [] and reg.metrics() == []


# ---------------------------------------------------------------------------
# the serve driver's exports, and the smoke's obs phase through the gates
# ---------------------------------------------------------------------------


def test_serve_driver_exports_load_in_reference_summarize(tmp_path):
    from repro.launch.summarize import metrics_summary as jsummary
    from repro_torch.launch import serve, summarize
    paths = {k: str(tmp_path / f) for k, f in (
        ("trace", "t.json"), ("prom", "m.prom"), ("events", "e.jsonl"))}
    with obs.scoped():
        serve.main(["--arch", "minicpm-2b", "--reduced", "--requests", "3",
                    "--max-new", "3", "--wbits", "4", "--continuous",
                    "--slots", "2", "--device", "cpu",
                    "--trace-out", paths["trace"],
                    "--metrics-out", paths["prom"],
                    "--events-out", paths["events"]])
    assert not obs.enabled()
    lines = pathlib.Path(paths["events"]).read_text().splitlines()
    text = jsummary(lines)
    assert text == summarize.metrics_summary(lines)
    assert "repro_serve_ttft_seconds" in text
    assert "repro_kernel_hbm_bytes_total" in text
    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        import check_obs
        check_obs.check_trace(paths["trace"], 2)
        check_obs.check_prometheus(paths["prom"])
        check_obs.check_events(paths["events"])
    finally:
        sys.path.remove(str(ROOT / "benchmarks"))
    summarize.main(["--metrics", paths["events"]])


def test_smoke_obs_phase_passes_the_gates_on_cpu(tmp_path):
    """``chip_smoke.obs_serve_phase`` at reduced widths on the CPU: the
    int4 traffic with obs on gives the streams of obs off, and the
    artifacts pass ``benchmarks/check_obs.py`` and ``check_bytes.py``."""
    import dataclasses
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import quantize_for_wbits
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config("minicpm-2b").reduced(), n_layers=2)
    dev = torch.device("cpu")
    params = quantize_for_wbits(init_params(cfg, 0, device=dev), 4)
    rec = chip_smoke.obs_serve_phase(
        cfg, params, dev, tmp_path, n_req=3, prompt_len=6, new_tokens=4,
        max_len=16, slots=3, chunk=4, ladder_layers=2)
    assert rec["streams_equal"] and rec["gates"] == ["check_obs",
                                                    "check_bytes"]
    data = json.loads((tmp_path / "obs_bench.json").read_text())
    assert set(data["ladder"]) == {"int8", "int4_packed", "int3_packed",
                                   "int2_packed"}
    assert data["sched"]["n_slots"] == 3
