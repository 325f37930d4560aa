"""Port's serving engines held against the JAX package's engines.

``repro_torch.serve.ServeEngine`` / ``ContinuousEngine`` against
``repro.serve.ServeEngine`` / ``ContinuousEngine`` on the same converted
tree (fp, int8, packed int4/int3/int2 and a mixed-rate tree): mixed prompt
lengths and budgets, staggered arrivals, chunked prefill with ragged
tails.  Greedy token streams must be identical, request by request.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_parity import to_numpy
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.models import from_jax_params
from repro_torch.serve import (ContinuousEngine, EngineConfig, Request,
                               ServeEngine)

CFG = dict(name="cb", family="dense", n_layers=2, d_model=32, n_heads=2,
           n_kv=2, d_ff=64, vocab=64, head_dim=16)
MAX_LEN = 24
FORMATS = ["fp", "int8", "int4", "int3", "int2", "mixed"]


def _qkw(fmt):
    mixed = {"wq": 4, "wk": 8, "wv": 2, "wo": 3, "w_gate": 2, "w_up": 3,
             "w_out": 4}
    return {"int8": dict(nbits=8), "int4": dict(nbits=4, packed=True),
            "int3": dict(nbits=3), "int2": dict(nbits=2),
            "mixed": dict(nbits_by_path=lambda p: mixed.get(p[-2]))}[fmt]


@functools.lru_cache(maxsize=None)
def _jax_side():
    """(jax cfg, jitted decode_step, jitted decode_chunk), shared by all
    formats (jit caches one executable per tree structure)."""
    import jax
    from repro.configs.base import ArchConfig
    from repro.models import decode_chunk, decode_step

    cfg = ArchConfig(**CFG)
    return (cfg, jax.jit(lambda p, c, t: decode_step(cfg, p, c, t)),
            jax.jit(lambda p, c, t: decode_chunk(cfg, p, c, t)))


@functools.lru_cache(maxsize=None)
def _tree(fmt):
    import jax
    from repro.models import init_params, split_tree
    from repro.quant import quantize_params_tree

    cfg = _jax_side()[0]
    base, _ = split_tree(init_params(cfg, jax.random.PRNGKey(0)))
    if fmt != "fp":
        base = quantize_params_tree(base, min_dim=16, **_qkw(fmt))
    return to_numpy(base)


def _workload(seed):
    """(prompt, budget, arrival step) triples."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(rng.integers(5, 8))):
        out.append((rng.integers(0, CFG["vocab"],
                                 int(rng.integers(2, 9))).astype(np.int32),
                    int(rng.integers(1, 7)), int(rng.integers(0, 5))))
    return out


def _drive(eng, workload, continuous, request=Request):
    """Submit request i once ``arrival`` scheduler steps ran (continuous)
    or all up front (static rounds); return {rid: token stream}."""
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
            assert steps < 1000
    assert len(done) == len(workload)
    return {r.rid: tuple(r.out_tokens) for r in done}


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
def test_streams_match_jax_engines(fmt, continuous):
    """vs repro.serve.ServeEngine / ContinuousEngine: identical greedy
    streams on the same weights."""
    import jax
    import jax.numpy as jnp
    from repro.serve import ContinuousEngine as JCont
    from repro.serve import EngineConfig as JConfig
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServe

    jcfg, jstep, jchunk = _jax_side()
    tree = _tree(fmt)
    n_slots, chunk = 3, 3
    workload = _workload(seed=20 + FORMATS.index(fmt))
    jeng = (JCont if continuous else JServe)(
        jcfg, jax.tree.map(jnp.asarray, tree),
        config=JConfig(n_slots=n_slots, max_len=MAX_LEN,
                       cache_dtype=jnp.float32, prefill_chunk=chunk,
                       decode_fn=jstep, decode_chunk_fn=jchunk))
    want = _drive(jeng, workload, continuous, JRequest)
    teng = (ContinuousEngine if continuous else ServeEngine)(
        TArchConfig(**CFG), from_jax_params(tree, "cpu"),
        config=EngineConfig(n_slots=n_slots, max_len=MAX_LEN,
                            cache_dtype=torch.float32, prefill_chunk=chunk))
    got = _drive(teng, workload, continuous)
    assert got == want
    assert teng.weight_bytes == jeng.weight_bytes
    assert teng.weight_formats == jeng.weight_formats


@pytest.mark.parametrize("fmt", ["int4", "int2"])
def test_continuous_matches_static_in_the_port(fmt):
    """The port's continuous engine against its own static oracle, with
    per-token prefill and eviction hygiene on."""
    tree = from_jax_params(_tree(fmt), "cpu")
    cfg = TArchConfig(**CFG)
    workload = _workload(seed=40)
    ref = _drive(ServeEngine(cfg, tree, config=EngineConfig(
        n_slots=4, max_len=MAX_LEN)), workload, False)
    out = _drive(ContinuousEngine(cfg, tree, config=EngineConfig(
        n_slots=2, max_len=MAX_LEN, reset_on_evict=True)), workload, True)
    assert out == ref


def test_engine_config_rejects_later_slices_and_bad_kwargs():
    with pytest.raises(NotImplementedError, match="resilience"):
        EngineConfig(resilience=object())
    with pytest.raises(TypeError, match="unknown engine option"):
        ServeEngine(TArchConfig(**CFG), from_jax_params(_tree("fp"), "cpu"),
                    n_slot=2)
    with pytest.warns(DeprecationWarning):
        eng = ServeEngine(TArchConfig(**CFG),
                          from_jax_params(_tree("fp"), "cpu"), n_slots=2)
    assert eng.n_slots == 2
