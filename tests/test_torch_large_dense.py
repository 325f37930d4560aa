"""The registry's largest dense configs (qwen2.5-32b, qwen1.5-32b,
minitron-8b) built and served one layer at a time, held against the JAX
package at their reduced sizes.

``quant.quantize_params_by_layer`` fed layer by layer from the
reference's params (``models.from_jax_params_by_layer``) gives the bytes
of ``quantize_params_tree`` of the whole tree, the port's and the
reference's (``repro.quant.quantize_params_tree``), in every format; the
port's ``ContinuousEngine`` on that tree streams what the reference's
``ContinuousEngine`` streams; the smoke's layer-by-layer float oracle
(``chip_smoke.LayerByLayer``) gives the whole dequantized model's first
step; the build never holds a float tensor larger than one layer's
largest weight; the per-layer draw is a function of (seed, layer); the
serve driver builds these configs layer by layer and refuses a whole
f32 tree larger than the device's free memory before allocating it.
"""
import functools
import pathlib
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_parity import (assert_trees_equal, drive_engine,
                           random_workload, to_numpy)
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, from_jax_params,
                                from_jax_params_by_layer, init_cache,
                                init_layer_params, init_params,
                                init_shared_params, split_layers)
from repro_torch.quant import quantize_params_by_layer, quantize_params_tree
from repro_torch.serve import ContinuousEngine, EngineConfig, Request
from repro_torch.tree import tree_leaves, tree_leaves_with_path

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["qwen2.5-32b", "qwen1.5-32b", "minitron-8b"]
#: the reduced configs' narrowest weights are 32 wide (wk, wv): quantize
#: every weight of the tree
MIN_DIM = 16
FORMATS = {"int8": dict(nbits=8), "int4": dict(nbits=4, packed=True),
           "int3": dict(nbits=3), "int2": dict(nbits=2)}
#: the layer-by-layer float oracle against the whole dequantized model:
#: the same f32 ops on the same weights, relative to the largest logit
ORACLE_TOL = 1e-5
MAX_LEN = 24


@functools.lru_cache(maxsize=None)
def _jax_tree(arch):
    """The reference's reduced params of ``arch`` (split, numpy)."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import init_params as jinit
    from repro.models import split_tree
    base, _ = split_tree(jinit(jget(arch).reduced(), jax.random.PRNGKey(0)))
    return to_numpy(base)


def _by_layer(arch, **fmt):
    source, shared = from_jax_params_by_layer(_jax_tree(arch), "cpu")
    return quantize_params_by_layer(get_config(arch).reduced(), source,
                                    shared, min_dim=MIN_DIM, **fmt)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("arch", ARCHS)
def test_by_layer_build_equals_whole_tree_and_reference(arch, fmt):
    """vs ``quantize_params_tree`` of the whole converted tree (the
    port's) and ``repro.quant.quantize_params_tree``: equal bytes."""
    import jax
    import jax.numpy as jnp
    from repro.quant import quantize_params_tree as jquant
    got = _by_layer(arch, **FORMATS[fmt])
    tree = _jax_tree(arch)
    assert_trees_equal(got, quantize_params_tree(
        from_jax_params(tree, "cpu"), min_dim=MIN_DIM, **FORMATS[fmt]))
    assert_trees_equal(got, to_numpy(jquant(
        jax.tree.map(jnp.asarray, tree), min_dim=MIN_DIM, **FORMATS[fmt])))
    # every weight of the layers was quantized
    assert all("codes" in v["w"] for blk in ("attn", "mlp")
               for v in got["layers"][blk].values())


@pytest.mark.parametrize("arch", ARCHS)
def test_by_layer_tree_streams_match_jax_continuous_engine(arch):
    """vs ``repro.serve.ContinuousEngine`` on the reference's int4 tree
    (staggered arrivals, chunked prefill): equal greedy streams."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import decode_chunk as jchunk
    from repro.models import decode_step as jstep
    from repro.quant import quantize_params_tree as jquant
    from repro.serve import ContinuousEngine as JCont
    from repro.serve import EngineConfig as JConfig
    from repro.serve import Request as JRequest
    jcfg = jget(arch).reduced()
    jtree = jquant(jax.tree.map(jnp.asarray, _jax_tree(arch)),
                   min_dim=MIN_DIM, **FORMATS["int4"])
    workload = random_workload(ARCHS.index(arch), jcfg.vocab)
    jeng = JCont(jcfg, jtree, config=JConfig(
        n_slots=3, max_len=MAX_LEN, cache_dtype=jnp.float32,
        prefill_chunk=3,
        decode_fn=jax.jit(lambda p, c, t: jstep(jcfg, p, c, t)),
        decode_chunk_fn=jax.jit(lambda p, c, t: jchunk(jcfg, p, c, t))))
    want = drive_engine(jeng, workload, True, JRequest)
    teng = ContinuousEngine(get_config(arch).reduced(),
                            _by_layer(arch, **FORMATS["int4"]),
                            config=EngineConfig(
                                n_slots=3, max_len=MAX_LEN,
                                cache_dtype=torch.float32, prefill_chunk=3))
    assert drive_engine(teng, workload, True, Request) == want


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_by_layer_oracle_equals_dequantized_model(arch):
    """``chip_smoke.oracle_step`` of a ``LayerByLayer`` oracle (each
    layer dequantized when reached) against ``decode_step`` of the whole
    dequantized tree (``chip_smoke.dequantized_model``): the first-step
    logits within ORACLE_TOL of the largest; and layer by layer
    (``layerwise_decode_check``) against the int4 tree's own step."""
    cs = _chip_smoke()
    cfg = get_config(arch).reduced()
    tree = _by_layer(arch, **FORMATS["int4"])
    tok = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 1)), dtype=torch.long)
    dev = torch.device("cpu")

    def cache():
        return init_cache(cfg, 4, MAX_LEN, torch.float32, device=dev)
    got = cs.oracle_step(cfg, cs.LayerByLayer(tree), cache(), tok)
    want = decode_step(cfg, cs.dequantized_model(tree), cache(), tok)[0]
    assert got.shape == (4, cfg.vocab)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= ORACLE_TOL * scale
    err = cs.layerwise_decode_check(cfg, tree, cs.LayerByLayer(tree), tok,
                                    dev, MAX_LEN, arch)
    assert err <= cs.LOGIT_TOL


class _FloatSizes(TorchDispatchMode):
    """Records the element count of every floating-point tensor an op
    returns (``meta`` tensors, shapes without storage, aside)."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out if isinstance(out, (tuple, list))
                             else [out]):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and t.device.type != "meta":
                self.sizes.append(t.numel())
        return out


@pytest.mark.parametrize("arch", ARCHS)
def test_by_layer_build_never_holds_more_than_one_weight_in_float(arch):
    """Every floating-point tensor the build makes (the draw of each
    layer, the absmax codes, the stacked scales) has at most as many
    elements as one layer's largest weight; the whole-tree path, the
    control, makes larger ones."""
    cfg = get_config(arch).reduced()
    shared = init_shared_params(cfg, 0, device="cpu")
    layer = split_layers(init_params(cfg, device="meta"))["layers"][0]
    largest = max(x.numel() for p, x in tree_leaves_with_path(layer)
                  if p.endswith("['w']"))
    source = functools.partial(init_layer_params, cfg, 0, device="cpu")
    for fmt in FORMATS.values():
        with _FloatSizes() as seen:
            tree = quantize_params_by_layer(cfg, source, shared,
                                            min_dim=MIN_DIM, **fmt)
        assert seen.sizes and max(seen.sizes) <= largest
        assert tree["layers"]["mlp"]["w_out"]["w"]["s"].shape[0] \
            == cfg.n_layers
    with _FloatSizes() as seen:
        quantize_params_tree(init_params(cfg, 0, device="cpu"),
                             min_dim=MIN_DIM, nbits=4, packed=True)
    assert max(seen.sizes) > largest


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_draw_is_a_function_of_seed_and_layer(arch):
    """``init_layer_params``: the shapes and dtypes of the stacked tree's
    row l; the same (seed, l) twice gives equal values, another layer or
    seed other values; ``init_shared_params`` likewise."""
    cfg = get_config(arch).reduced()
    meta = split_layers(init_params(cfg, device="meta"))["layers"]

    def draw(seed, layer):
        return tree_leaves_with_path(init_layer_params(cfg, seed, layer,
                                                       device="cpu"))
    first = draw(0, 0)
    for layer in range(cfg.n_layers):
        assert [(p, x.shape, x.dtype) for p, x in draw(0, layer)] == \
            [(p, x.shape, x.dtype)
             for p, x in tree_leaves_with_path(meta[layer])]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(first,
                                                           draw(0, 0)))
    for other in (draw(0, 1), draw(1, 0)):
        weights = [(a, b) for (p, a), (_, b) in zip(first, other)
                   if p.endswith("['w']")]
        assert weights and not any(torch.equal(a, b) for a, b in weights)
    # weights of std ≈ 1/sqrt(in), norm scales 1, biases 0
    for p, x in first:
        if p.endswith("['w']"):
            assert abs(float(x.std()) * x.shape[0] ** 0.5 - 1) < 0.2
        elif p.endswith("['scale']"):
            assert bool((x == 1).all())
        else:
            assert not x.any()
    a = init_shared_params(cfg, 0, device="cpu")
    b = init_shared_params(cfg, 0, device="cpu")
    assert torch.equal(a["embed"]["w"], b["embed"]["w"])
    assert not torch.equal(a["embed"]["w"], init_shared_params(
        cfg, 1, device="cpu")["embed"]["w"])
    assert sorted(a) == ["embed", "ln_f"]
    with pytest.raises(IndexError):
        init_layer_params(cfg, 0, cfg.n_layers, device="cpu")
    with pytest.raises(NotImplementedError):
        init_layer_params(get_config("rwkv6-7b").reduced(), 0, 0,
                          device="cpu")


def test_serve_driver_builds_by_layer_and_refuses_a_whole_tree(monkeypatch):
    """``launch.serve --device cpu --reduced --arch qwen2.5-32b --wbits
    4`` serves without ever drawing the whole tree (``init_params`` is
    made to raise); ``--wbits 16`` with less free memory than the f32
    tree is refused before anything is allocated, both sizes in GB in
    the message."""
    from repro_torch.launch import serve

    def whole_tree(*a, **kw):
        if kw.get("device") == "meta":
            return init_params(*a, **kw)
        raise AssertionError("the whole f32 tree was drawn")
    monkeypatch.setattr(serve, "init_params", whole_tree)
    done = serve.main(["--arch", "qwen2.5-32b", "--reduced", "--wbits", "4",
                       "--continuous", "--requests", "3", "--max-new", "4",
                       "--device", "cpu"])
    assert [len(r.out_tokens) for r in done] == [4, 4, 4]
    cfg = get_config("qwen2.5-32b")
    need = serve.f32_tree_bytes(cfg)
    assert need == 4 * sum(x.numel() for x in tree_leaves(
        init_params(cfg, device="meta")))
    assert abs(need / 1e9 - 127.94) < 0.01
    with pytest.raises(SystemExit, match=r"127\.94 GB.* 80\.00 GB free"):
        serve.check_f32_tree_fits(cfg, 80 * 10 ** 9)
    serve.check_f32_tree_fits(cfg, need)
    monkeypatch.setattr(serve, "free_bytes", lambda device: 10 ** 5)
    with pytest.raises(SystemExit, match=r"GB and the device has 0\.00 GB"):
        serve.main(["--arch", "qwen2.5-32b", "--reduced", "--wbits", "16",
                    "--device", "cpu"])
