"""Port of the model PTQ pipeline (``quant/calibrate.py``,
``quant/pipeline.py``, ``quant/qlinear.from_watersic``) held against the
JAX package, on the 2-layer dense model of ``tests/test_quant_pipeline.py``
with the reference's ``init_params`` weights and numpy tokens.  Each
stacked weight is rescaled to std 1/sqrt(in_features): the reference's
stacked init takes the layer count as fan-in (ROADMAP queue C), which
drives the residual stream to ~900 and makes every f32 comparison a
comparison of rounding noise.

Tolerances: taps and logits 1e-5 (rtol = atol, each tensor divided by
its largest magnitude first; f32 matmuls in another order);
covariance sums 1e-10 relative (float64 sums of the same taps); realized
rate and every matrix's entropy within 0.01 bits and ``model_ppl`` within
1e-3 relative (f32 quantization in another summation order may move a
rounding tie, and the sequential pipeline carries it on); serving leaves
built from the same quantizer record byte-identical; greedy streams
identical.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_same_ints, to_numpy
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.core import CODE_RANGE
from repro_torch.models import from_jax_params, from_jax_quantized_linear
from repro_torch.quant import from_watersic
from repro_torch.quant.calibrate import (StatsAccumulator, accumulate_stats,
                                        forward_with_taps)
from repro_torch.quant.pipeline import PTQConfig, model_ppl, quantize_model
from repro_torch.serve import ContinuousEngine, EngineConfig, Request

CFG = dict(name="q", family="dense", n_layers=2, d_model=48, n_heads=3,
           n_kv=3, d_ff=96, vocab=96, head_dim=16)
METHODS = ["watersic", "hptq", "rtn"]


def _jcfg():
    from repro.configs.base import ArchConfig
    return ArchConfig(**CFG)


@functools.lru_cache(maxsize=None)
def _setup():
    """(reference numpy params, calibration batches, evaluation batches)."""
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
    rng = np.random.default_rng(11)
    calib = [rng.integers(0, CFG["vocab"], (8, 40)).astype(np.int32)
             for _ in range(2)]
    evalb = [rng.integers(0, CFG["vocab"], (8, 41)).astype(np.int32)]
    return base, calib, evalb


@functools.lru_cache(maxsize=None)
def _quantized(method):
    """Both packages' quantize_model at 2.5 bits:
    ((qparams, qlinears, budget, rows) reference, the port's, evaluation
    batches)."""
    import jax
    import jax.numpy as jnp
    from repro.quant.pipeline import PTQConfig as JPTQConfig
    from repro.quant.pipeline import quantize_model as jquantize
    base, calib, evalb = _setup()
    want = jquantize(_jcfg(), jax.tree.map(jnp.asarray, base), calib,
                     JPTQConfig(target_bits=2.5, method=method))
    got = quantize_model(TArchConfig(**CFG), from_jax_params(base, "cpu"),
                         calib, PTQConfig(target_bits=2.5, method=method))
    return want, got


def _assert_close_scaled(got, want, tol=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert_close(to_numpy(got) / scale, want / scale, tol=tol)


def test_forward_with_taps_matches_reference():
    import jax.numpy as jnp
    from repro.quant.calibrate import forward_with_taps as jtaps
    base, calib, _ = _setup()
    jl, jt = jtaps(_jcfg(), base, jnp.asarray(calib[0]))
    tl, tt = forward_with_taps(TArchConfig(**CFG),
                               from_jax_params(base, "cpu"), calib[0])
    _assert_close_scaled(tl, jl)
    assert len(tt) == len(jt) == 2
    for got, want in zip(tt, jt):
        assert set(got) == set(want)
        for k in want:
            _assert_close_scaled(got[k], want[k])


def test_stats_accumulator_matches_reference():
    """The same (reference) taps into both accumulators: float64 sums
    within 1e-10 relative, identical counts."""
    import jax.numpy as jnp
    from repro.quant.calibrate import StatsAccumulator as JAcc
    from repro.quant.calibrate import accumulate_stats as jaccumulate
    from repro.quant.calibrate import forward_with_taps as jtaps
    base, calib, _ = _setup()
    qbase = dict(base, layers={**base["layers"], "attn": {
        k: {"w": v["w"] * 0.9} for k, v in base["layers"]["attn"].items()}})
    jacc, tacc = JAcc(), StatsAccumulator()
    for tokens in calib:
        _, fp = jtaps(_jcfg(), base, jnp.asarray(tokens))
        _, qq = jtaps(_jcfg(), qbase, jnp.asarray(tokens))
        for layer in (0, 1):
            jaccumulate(jacc, layer, fp[layer], qq[layer])
            accumulate_stats(tacc, layer,
                             {k: torch.as_tensor(np.array(v))
                              for k, v in fp[layer].items()},
                             {k: torch.as_tensor(np.array(v))
                              for k, v in qq[layer].items()})
    assert sorted(tacc.sums) == sorted(jacc.sums)
    for k, want in jacc.sums.items():
        got = to_numpy(tacc.sums[k])
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
        assert tacc.counts[k] == pytest.approx(float(jacc.counts[k]),
                                               rel=1e-12)


@pytest.mark.parametrize("method", METHODS)
def test_quantize_model_matches_reference(method):
    (jq, jlin, jbudget, jrows), (tq, tlin, tbudget, trows) = \
        _quantized(method)
    assert abs(tbudget.realized_rate - jbudget.realized_rate) <= 0.01
    assert abs(tbudget.realized_rate - 2.5) < 0.1 or method == "rtn"
    assert sorted(tlin) == sorted(jlin)
    for name, q in jlin.items():
        assert abs(tlin[name].entropy_bits - q.entropy_bits) <= 0.01, name
    assert [(r["layer"], r["matrix"], r["dead"]) for r in trows] == \
        [(r["layer"], r["matrix"], r["dead"]) for r in jrows]
    from repro.quant.pipeline import model_ppl as jppl
    _, _, evalb = _setup()
    want, got = jppl(_jcfg(), jq, evalb), model_ppl(TArchConfig(**CFG), tq,
                                                   evalb)
    assert abs(got - want) <= 1e-3 * want, (got, want)


def test_adaptive_mixing_matches_reference():
    """Golden-section mixing over ε_qr then ε_aw (attention weighting on):
    the same realized rate and ``model_ppl`` as the reference."""
    import jax
    import jax.numpy as jnp
    from repro.quant.pipeline import PTQConfig as JPTQConfig
    from repro.quant.pipeline import model_ppl as jppl
    from repro.quant.pipeline import quantize_model as jquantize
    base, calib, evalb = _setup()
    kw = dict(target_bits=2.5, method="watersic", adaptive_mix=True,
              attention_weighting=True, golden_iters=3)
    jq, _, jbudget, _ = jquantize(_jcfg(), jax.tree.map(jnp.asarray, base),
                                  calib[:1], JPTQConfig(**kw))
    tq, _, tbudget, _ = quantize_model(
        TArchConfig(**CFG), from_jax_params(base, "cpu"), calib[:1],
        PTQConfig(**kw))
    assert abs(tbudget.realized_rate - jbudget.realized_rate) <= 0.01
    want, got = jppl(_jcfg(), jq, evalb), model_ppl(TArchConfig(**CFG), tq,
                                                   evalb)
    assert abs(got - want) <= 1e-3 * want, (got, want)


def test_quantize_model_raises_on_unported_options():
    """PTQ covers the dense and MoE families only, as the reference's
    (``assert cfg.family in ("dense", "moe")``): the recurrent ``ssm``
    family, served by the port, is refused.  The planner's ``plan=`` and
    the MoE family, which this test checked before, are ported:
    tests/test_torch_plan.py and tests/test_torch_moe_ptq.py."""
    base, calib, _ = _setup()
    ssm = TArchConfig(**{**CFG, "family": "ssm"})
    with pytest.raises(NotImplementedError,
                       match="dense and MoE families only"):
        quantize_model(ssm, from_jax_params(base, "cpu"), calib,
                       PTQConfig())


@pytest.mark.parametrize("nbits", [8, 4, 3, 2])
def test_from_watersic_identical_to_reference(nbits):
    """The same reference QuantizedLinear (converted) into both packages'
    from_watersic: payload, scales and escape COO byte-identical."""
    from repro.quant import from_watersic as jfrom
    (_, jlin, _, _), _ = _quantized("watersic")
    escaped = 0
    for name, q in sorted(jlin.items()):
        cap = None if nbits == 8 else int(np.asarray(q.codes).size)
        want = to_numpy(jfrom(q, nbits=nbits, escape_capacity=cap))
        got = to_numpy(from_watersic(from_jax_quantized_linear(q, "cpu"),
                                     nbits=nbits, escape_capacity=cap))
        assert sorted(got) == sorted(want)
        for k in want:
            if want[k].dtype.kind in "iu":
                assert_same_ints(got[k], want[k])
            else:
                assert got[k].tobytes() == want[k].tobytes(), (name, k)
        if nbits != 8:
            escaped += int((want["esc_dval"] != 0).sum())
    if nbits in (3, 2):
        assert escaped > 0          # real WaterSIC codes leave the range


def _escapes(codes, nbits):
    lo, hi = CODE_RANGE[nbits]
    return int(((codes < lo) | (codes > hi)).sum())


def install_codes(qparams, qlinears, n_layers, leaf_fn, stack, nbits=4):
    """Swap the dequantized float weights for stacked packed leaves; the
    escape capacity of a path is its largest escape count over the
    layers."""
    groups = {}
    for name, q in qlinears.items():
        groups.setdefault(tuple(name.split("/")[1:]), {})[
            int(name.split("/")[0][1:])] = q
    p = {**qparams, "layers": {k: dict(v) for k, v in
                               qparams["layers"].items()}}
    for path, per_layer in groups.items():
        assert sorted(per_layer) == list(range(n_layers))
        cap = max(_escapes(to_numpy(q.codes), nbits)
                  for q in per_layer.values())
        leaves = [leaf_fn(per_layer[l], nbits=nbits, escape_capacity=cap)
                  for l in range(n_layers)]
        p["layers"][path[0]][path[1]] = {
            "w": {k: stack([lf[k] for lf in leaves]) for k in leaves[0]}}
    return p


@pytest.mark.parametrize("nbits", [4, 3])
def test_served_watersic_streams_match_jax_engine(nbits):
    """Real WaterSIC codes installed as packed leaves (int4: the chip
    smoke's format; int3: escapes at this model's 2.5 bits) serve the same
    greedy streams in both engines."""
    import jax
    import jax.numpy as jnp
    from repro.models import decode_chunk, decode_step
    from repro.quant import from_watersic as jfrom
    from repro.serve import ContinuousEngine as JCont
    from repro.serve import EngineConfig as JConfig
    from repro.serve import Request as JRequest
    (jq, jlin, _, _), _ = _quantized("watersic")
    jcfg = _jcfg()
    jtree = install_codes(jax.tree.map(jnp.asarray, jq), jlin, 2, jfrom,
                          jnp.stack, nbits)
    tlin = {k: from_jax_quantized_linear(q, "cpu") for k, q in jlin.items()}
    ttree = install_codes(from_jax_params(to_numpy(jq), "cpu"), tlin, 2,
                          from_watersic, torch.stack, nbits)
    escapes = sum(int((to_numpy(ttree["layers"][a][b]["w"]["esc_dval"])
                       != 0).sum())
                  for a, b in (k.split("/")[1:] for k in tlin if
                               k.startswith("L0/")))
    assert escapes > 0 or nbits == 4
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, CFG["vocab"], 6).astype(np.int32)
               for _ in range(3)]
    jeng = JCont(jcfg, jtree, config=JConfig(
        n_slots=3, max_len=16, cache_dtype=jnp.float32, prefill_chunk=4,
        decode_fn=jax.jit(lambda p, c, t: decode_step(jcfg, p, c, t)),
        decode_chunk_fn=jax.jit(lambda p, c, t: decode_chunk(jcfg, p, c,
                                                             t))))
    teng = ContinuousEngine(TArchConfig(**CFG), ttree, config=EngineConfig(
        n_slots=3, max_len=16, cache_dtype=torch.float32, prefill_chunk=4))
    for eng, req in ((jeng, JRequest), (teng, Request)):
        for i, p in enumerate(prompts):
            eng.submit(req(rid=i, prompt=p.copy(), max_new_tokens=5))
    want = {r.rid: tuple(r.out_tokens) for r in jeng.run_until_done()}
    got = {r.rid: tuple(r.out_tokens) for r in teng.run_until_done()}
    assert got == want
