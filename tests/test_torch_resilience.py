"""``repro_torch.serve.resilience`` and the engines' hooks held against the
JAX package.

Both packages' engines serve the reference's weights (converted) under
the same ``ResilienceConfig``: queue-cap shedding and deadline drops are
reported with the same request ids and reasons, the degradation ladder
takes the same rung at the same tick for the same queue-depth trace and
emits the same streams, and a snapshot → kill → resume cycle (including
one across packages) reproduces the uninterrupted streams.  Deadlines
ride an injected monotonic clock; no test sleeps on the wall clock.
"""
import functools
import os
import types

import numpy as np
import pytest
import torch

from _torch_parity import to_numpy
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.dist.fault import RestartPolicy
from repro_torch.kernels.dequant.ops import _walk_qweights
from repro_torch.models import from_jax_params
from repro_torch.serve import (ContinuousEngine, DegradePolicy, EngineConfig,
                               EngineStalledError, PayloadGuard, Request,
                               ResilienceConfig, ServeEngine,
                               SlowStepDetector, build_bit_ladder)

CFG = dict(name="resil-t", family="dense", n_layers=2, d_model=32,
           n_heads=2, n_kv=2, d_ff=64, vocab=64, head_dim=16)


@functools.lru_cache(maxsize=None)
def _jbase():
    import jax
    from repro.configs.base import ArchConfig
    from repro.models import init_params, split_tree
    return to_numpy(split_tree(init_params(ArchConfig(**CFG),
                                           jax.random.PRNGKey(0)))[0])


@functools.lru_cache(maxsize=None)
def _jq4():
    import jax
    import jax.numpy as jnp
    from repro.quant import quantize_params_tree
    return to_numpy(quantize_params_tree(
        jax.tree.map(jnp.asarray, _jbase()), nbits=4, packed=True,
        min_dim=16))


def _tq4():
    return from_jax_params(_jq4(), "cpu")


def _prompt(rid):
    rng = np.random.default_rng(rid)
    return rng.integers(0, CFG["vocab"], 5, dtype=np.int64).astype(np.int32)


def _engine(params=None, resilience=None, cls=ContinuousEngine, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 32)
    return cls(TArchConfig(**CFG), _tq4() if params is None else params,
               config=EngineConfig(prefill_chunk=3, resilience=resilience,
                                   **kw))


def _jengine(params, resilience=None, cls_name="ContinuousEngine", **kw):
    import jax
    import jax.numpy as jnp
    from repro import serve as jserve
    from repro.configs.base import ArchConfig
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 32)
    return getattr(jserve, cls_name)(
        ArchConfig(**CFG), jax.tree.map(jnp.asarray, params),
        config=jserve.EngineConfig(prefill_chunk=3, resilience=resilience,
                                   **kw))


def _streams(done):
    return {r.rid: tuple(r.out_tokens) for r in done}


class Clock:
    """An injected monotonic clock: deadlines expire when a test says."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    import time
    import repro.serve.engine as jengine_mod
    import repro_torch.serve.engine as tengine_mod
    c = Clock()
    fake = types.SimpleNamespace(monotonic=c.monotonic,
                                 perf_counter=time.perf_counter)
    monkeypatch.setattr(tengine_mod, "time", fake)
    monkeypatch.setattr(jengine_mod, "time", fake)
    return c


# -- units --------------------------------------------------------------------


def test_slow_step_detector_matches_reference():
    """The same series of step times raises the same flags."""
    from repro.serve import SlowStepDetector as JDet
    rng = np.random.default_rng(3)
    series = list(rng.uniform(0.9, 1.1, 40))
    series[5] = series[17] = 30.0
    series[0] = 100.0
    series[25:34] = [50.0] * 9
    for kw in ({}, dict(threshold=4.0, window=8, warmup=3),
               dict(threshold=2.0, window=4, warmup=1)):
        a, b = SlowStepDetector(**kw), JDet(**kw)
        assert [a.observe(x) for x in series] == [b.observe(x)
                                                  for x in series]


def test_stall_error_matches_reference_message():
    from repro.serve import EngineStalledError as JErr
    eng = _engine(n_slots=1)
    for i in (7, 8):
        eng.submit(Request(rid=i, prompt=_prompt(i), max_new_tokens=6))
    with pytest.raises(EngineStalledError) as e:
        eng.run_until_done(max_steps=2)
    err = e.value
    assert err.max_steps == 2 and err.queue_depth == 1
    slot, rid, emitted, budget = err.stuck[0]
    assert rid == 7 and budget == 6 and 0 < emitted < budget
    assert str(err) == str(JErr(2, err.stuck, 1))


def test_payload_guard_heals_exactly_in_place():
    """A flipped byte is detected, restored in place (same tensor) to the
    pristine bytes; an unknown path is schema drift."""
    tree = _tq4()
    guard = PayloadGuard(tree)
    assert guard.checksums and guard.verify(tree) == []
    path, leaf = sorted(_walk_qweights(tree))[1]
    codes = leaf["codes"]
    pristine = codes.clone()
    codes.view(-1)[3] ^= 0x5A
    assert guard.verify(tree) == [path]
    assert guard.heal(tree, [path]) is tree
    assert dict(_walk_qweights(tree))[path]["codes"] is codes
    assert torch.equal(codes, pristine)
    assert codes.numpy().tobytes() == guard._pristine[path].tobytes()
    with pytest.raises(KeyError, match="schema drift"):
        guard.heal(tree, ["no/such/leaf"])


def test_checksums_match_reference():
    from repro.kernels.dequant.ops import payload_checksums as jsums
    from repro_torch.kernels.dequant.ops import payload_checksums
    assert payload_checksums(_tq4()) == jsums(_jq4())


def test_degrade_policy_and_ladder_validate():
    with pytest.raises(ValueError, match=">= 2 rungs"):
        DegradePolicy(ladder=[("only", object())])
    with pytest.raises(ValueError, match="below high_watermark"):
        DegradePolicy(ladder=[("a", 1), ("b", 2)], high_watermark=2,
                      low_watermark=2)
    with pytest.raises(ValueError, match="no serving rung"):
        build_bit_ladder(from_jax_params(_jbase(), "cpu"), rungs=(5,))


@pytest.mark.parametrize("rungs", [(None, 3, 2), (4, 3, 2)])
def test_build_bit_ladder_matches_reference(rungs):
    """Each rung's tree byte-identical to the reference's ladder."""
    import jax
    import jax.numpy as jnp
    from repro.serve import build_bit_ladder as jladder
    from _torch_parity import assert_trees_equal
    got = build_bit_ladder(from_jax_params(_jbase(), "cpu"), rungs=rungs,
                           min_dim=16)
    want = jladder(jax.tree.map(jnp.asarray, _jbase()), rungs=rungs,
                   min_dim=16)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert_trees_equal(g, w)


# -- engines against the reference's ----------------------------------------


def _drops(eng, req_cls, clock, continuous):
    reqs = [req_cls(rid=i, prompt=_prompt(i), max_new_tokens=3,
                    deadline_s=(5.0 if i in (0, 1, 2) else None))
            for i in range(6)]
    accepted = [eng.submit(r) for r in reqs]
    first = eng.step() if continuous else eng.run_round()
    clock.now += 10.0          # rids 0 (in flight or done), 1, 2 expired
    done = list(first) + eng.run_until_done()
    return (accepted, [(r.rid, r.drop_reason) for r in eng.dropped],
            _streams(done), [len(r.out_tokens) for r in reqs])


@pytest.mark.parametrize("engine", ["ContinuousEngine", "ServeEngine"])
def test_queue_cap_and_deadline_drops_match_reference(clock, engine):
    """Shedding at the cap and deadline expiry (queued, and in flight on
    the continuous engine) drop the same requests with the same reasons;
    the survivors' streams are equal."""
    import repro.serve as jserve
    continuous = engine == "ContinuousEngine"
    cls = ContinuousEngine if continuous else ServeEngine
    got = _drops(_engine(resilience=ResilienceConfig(queue_cap=4), cls=cls,
                         n_slots=1), Request, clock, continuous)
    want = _drops(_jengine(_jq4(), jserve.ResilienceConfig(queue_cap=4),
                           engine, n_slots=1), jserve.Request, clock,
                  continuous)
    assert got == want
    accepted, drops, _, emitted = got
    assert accepted == [True] * 4 + [False] * 2
    deadline = sorted(rid for rid, why in drops if why == "deadline")
    assert deadline == ([0, 1, 2] if continuous else [1, 2])
    if continuous:
        assert 0 < emitted[0] < 3          # partial stream kept, reported


def test_default_deadline_and_monotonic_only(clock):
    """The config's default deadline applies when a request has none, and
    a skewed wall clock (the chaos clock-skew fault) expires nothing."""
    eng = _engine(resilience=ResilienceConfig(default_deadline_s=9.0))
    r, explicit = (Request(rid=0, prompt=_prompt(0), max_new_tokens=3),
                   Request(rid=1, prompt=_prompt(1), max_new_tokens=3,
                           deadline_s=5.0))
    eng.submit(r)
    eng.submit(explicit)
    assert (r.deadline_s, explicit.deadline_s) == (9.0, 5.0)
    eng._clock_skew_s = 3600.0
    assert len(eng.run_until_done()) == 2 and eng.dropped == []


class _Flaky(RuntimeError):
    pass


def test_retry_transient_types_and_budget():
    calls = {"left": 2}

    def flaky():
        if calls["left"]:
            calls["left"] -= 1
            raise _Flaky("transient")
        return "ok"

    eng = _engine(resilience=ResilienceConfig(
        retry=RestartPolicy(max_restarts=4, backoff_base_s=1e-4),
        retry_sleep=lambda s: None, transient=(_Flaky,)))
    assert eng._retry("test.site", flaky) == "ok" and calls["left"] == 0
    with pytest.raises(ValueError, match="real bug"):
        eng._retry("test.site", lambda: (_ for _ in ()).throw(
            ValueError("a real bug")))
    tight = _engine(resilience=ResilienceConfig(
        retry=RestartPolicy(max_restarts=1, backoff_base_s=1e-4),
        retry_sleep=lambda s: None, transient=(_Flaky,)))
    with pytest.raises(_Flaky):
        tight._retry("test.site", lambda: (_ for _ in ()).throw(
            _Flaky("forever")))


def test_degrade_ladder_walk_matches_reference():
    """Under the same queue-depth trace both engines take the same rung
    at the same tick (down under overload, back up when drained), emit
    the same streams, and lose nothing in the swaps."""
    import jax
    import jax.numpy as jnp
    from repro import serve as jserve
    jl = jserve.build_bit_ladder(jax.tree.map(jnp.asarray, _jbase()),
                                 rungs=(None, 3, 2), min_dim=16)
    tl = build_bit_ladder(from_jax_params(_jbase(), "cpu"),
                          rungs=(None, 3, 2), min_dim=16)
    pol = dict(high_watermark=3, low_watermark=1, streak=1,
               cooldown_steps=1)
    teng = _engine(from_jax_params(_jbase(), "cpu"), ResilienceConfig(
        degrade=DegradePolicy(ladder=tl, **pol)), n_slots=1)
    jeng = _jengine(_jbase(), jserve.ResilienceConfig(
        degrade=jserve.DegradePolicy(ladder=jl, **pol)), n_slots=1)
    assert teng.params is tl[0][1]
    out = []
    for eng, req in ((teng, Request), (jeng, jserve.Request)):
        for i in range(8):
            eng.submit(req(rid=i, prompt=_prompt(i), max_new_tokens=2))
        done = eng.run_until_done()
        for _ in range(8):
            eng.step()
        out.append((eng.rung_history, _streams(done), eng._rung,
                    eng.swap_history))
    assert out[0] == out[1]
    hist, streams, rung, _ = out[0]
    assert {d for _, _, d in hist} == {"init", "down", "up"}
    assert rung == 0 and len(streams) == 8
    assert all(len(t) == 2 for t in streams.values())


def _run4(eng, req=Request):
    for i in range(4):
        eng.submit(req(rid=i, prompt=_prompt(i), max_new_tokens=4))
    return eng.run_until_done()


def test_snapshot_kill_resume_streams_equal(tmp_path):
    """Snapshot every 2 ticks, kill after 5 steps, resume from the last
    committed snapshot: the union of delivered streams equals the
    uninterrupted run's and the reference's."""
    import repro.serve as jserve
    reference = _streams(_run4(_engine()))
    assert reference == _streams(_run4(_jengine(_jq4()), jserve.Request))
    ckpt = str(tmp_path / "snap")
    eng = _engine(resilience=ResilienceConfig(snapshot_dir=ckpt,
                                              snapshot_every=2,
                                              snapshot_keep=2))
    for i in range(4):
        eng.submit(Request(rid=i, prompt=_prompt(i), max_new_tokens=4))
    delivered = {}
    for _ in range(5):
        delivered.update(_streams(eng.step()))
    tick = eng._tick
    del eng
    assert len([d for d in os.listdir(ckpt) if d.startswith("step_")]) == 2
    revived = ContinuousEngine.resume(ckpt, TArchConfig(**CFG), _tq4(),
                                      prefill_chunk=3)
    assert revived._tick <= tick and revived.n_slots == 2
    assert revived.max_len == 32 and revived.prefill_chunk == 3
    delivered.update(_streams(revived.run_until_done()))
    assert delivered == reference


def test_snapshot_resume_bf16_cache(tmp_path):
    """The same snapshot → kill → resume cycle with a bfloat16 slot cache
    (the checkpoint writes its raw 16-bit words): the resumed engine's
    cache is bf16 and the streams equal the uninterrupted bf16 run's."""
    bf16 = dict(cache_dtype=torch.bfloat16)
    reference = _streams(_run4(_engine(**bf16)))
    ckpt = str(tmp_path / "snap")
    eng = _engine(resilience=ResilienceConfig(snapshot_dir=ckpt,
                                              snapshot_every=2), **bf16)
    for i in range(4):
        eng.submit(Request(rid=i, prompt=_prompt(i), max_new_tokens=4))
    delivered = {}
    for _ in range(5):
        delivered.update(_streams(eng.step()))
    del eng
    revived = ContinuousEngine.resume(
        ckpt, TArchConfig(**CFG), _tq4(),
        config=EngineConfig(n_slots=2, max_len=32, prefill_chunk=3, **bf16))
    assert revived.cache.kv.k.dtype == torch.bfloat16
    delivered.update(_streams(revived.run_until_done()))
    assert delivered == reference


def test_resume_from_a_reference_snapshot(tmp_path):
    """A snapshot the JAX engine wrote resumes in the port (the manifest
    keys and the cache tree are shared) and finishes with the streams of
    the uninterrupted run."""
    import repro.serve as jserve
    reference = _streams(_run4(_engine()))
    ckpt = str(tmp_path / "jsnap")
    jeng = _jengine(_jq4())
    for i in range(4):
        jeng.submit(jserve.Request(rid=i, prompt=_prompt(i),
                                   max_new_tokens=4))
    delivered = {}
    for _ in range(3):
        delivered.update(_streams(jeng.step()))
    jeng.snapshot(ckpt)
    revived = ContinuousEngine.resume(ckpt, TArchConfig(**CFG), _tq4(),
                                      prefill_chunk=3)
    assert revived.cache.kv.k.dtype == torch.float32
    delivered.update(_streams(revived.run_until_done()))
    assert delivered == reference
    with pytest.raises(ValueError, match="geometry"):
        ContinuousEngine.resume(ckpt, TArchConfig(**CFG), _tq4(),
                                config=EngineConfig(n_slots=3, max_len=32))


def test_smoke_slice7_phases_on_cpu(tmp_path, monkeypatch):
    """``chip_smoke``'s resilience-serve, int8-KV, degrade and
    corrupt-payload phases at the reduced config on the CPU (the twins
    serve; the launch checks are the card's): streams equal with the
    layer on, the int8 prefill cache equal to q8 of the f32 one, every
    request through the ladder, the flipped bytes reaching the product."""
    import dataclasses
    import pathlib
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    from repro_torch.configs import get_config
    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    (tmp_path / "chiprun_out").mkdir()
    dev = torch.device("cpu")
    cfg = get_config("minicpm-2b").reduced()
    params = chip_smoke.quantize_for_wbits(
        chip_smoke.init_params(cfg, 0, device=dev), 4)
    traffic = dict(n_req=4, prompt_len=8, new_tokens=6, max_len=24, slots=4,
                   chunk=4)
    res = chip_smoke.resilience_serve_phase(cfg, params, dev, **traffic)
    assert res["streams_equal"] and res["snapshot_s"] > 0
    kv = chip_smoke.int8kv_phase(cfg, params, dev, **traffic)
    assert kv["prefill_cache_equals_q8"]
    assert kv["first_step_layer0_rows_equal_q8"]
    assert kv["kv_bytes_int8"] < kv["kv_bytes_f32"] / 3
    deg = chip_smoke.degrade_phase(cfg, dev)
    assert deg["finished"] == 12
    assert [d for _, _, d in deg["rungs"]][:3] == ["init", "down", "down"]
    bad = chip_smoke.corrupt_product_check(
        dataclasses.replace(cfg, n_layers=2), dev)
    assert bad["healed_bit_equal"] and bad["dirty_max_abs_diff"] > 0
