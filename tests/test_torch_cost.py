"""The step cost counter (``launch.hlo_cost.count_costs``) and the H100
roofline (``launch.roofline``), held against the reference's HLO parser
(``repro.launch.hlo_cost.parse_hlo_costs``) and ``RooflineReport``.

* The five probes of tests/test_hlo_cost.py (flat loop × 7, nested 3 × 5,
  unrolled = looped, slice bytes not inflated, the sharded product) as
  torch loops: dot FLOPs within 1e-6 relative of ``parse_hlo_costs`` on
  the JAX versions (the eager counter sees every iteration; the parser
  weights each loop body by its trip count).
* On the ``reduced()`` config of every family, the f32 ``loss_fn`` and
  ``decode_step`` dot FLOPs against ``parse_hlo_costs`` of the jitted
  reference, within 1e-6 relative, after the products one package
  computes as a contraction and the other elementwise: the RWKV6 WKV
  readout r·(state + u·kv) (an elementwise product and sum in the port,
  ``einsum`` in the reference: 2·B·H·dk·dv per layer and token) and the
  RG-LRU decode conv taps (elementwise in the port, ``einsum`` in the
  reference's decode: 2·B·conv_width·lru per recurrent layer).
* The kernels' reports: on meta tensors a packed / int8 dequant product
  counts one launch of 2·m·n·k FLOPs and the flash forward 4·d per kept
  (query, key) pair; the twins on the CPU are not counted twice.
* The roofline terms against the reference's ``RooflineReport`` on the
  same numbers and the same ``HW`` (exact), and the port's default
  ``HW`` is one H100 SXM's.
"""
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one intra-op thread)
from repro_torch.configs import get_config
from repro_torch.dist.sharding import ShapeMesh, use_mesh
from repro_torch.kernels.dequant import dequant_matmul
from repro_torch.kernels.flash import flash_attention
from repro_torch.launch import roofline
from repro_torch.launch.hlo_cost import count_costs
from repro_torch.models import decode_step, init_cache, init_params, loss_fn
from repro_torch.quant import quantize_params_tree

FLOPS_1 = 2 * 64 * 128 * 128
REL = 1e-6


def _ref(fn, *shapes):
    import jax
    from repro.launch.hlo_cost import parse_hlo_costs
    return parse_hlo_costs(jax.jit(fn).lower(*shapes).compile().as_text())


def _sds(*shape):
    import jax
    import jax.numpy as jnp
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _t(*shape, device="cpu"):
    return torch.randn(shape, generator=torch.Generator().manual_seed(0)) \
        if device == "cpu" else torch.empty(shape, device=device)


def test_flat_loop_counts_every_iteration():
    import jax
    import jax.numpy as jnp

    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=7)[0]

    def g(x, w):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x
    want = _ref(f, _sds(64, 128), _sds(128, 128))
    got = count_costs(g, _t(64, 128), _t(128, 128), trip_counts=(7,))
    assert got.dot_flops == pytest.approx(want.dot_flops, rel=REL)
    assert got.dot_flops == 7 * FLOPS_1
    assert 7 in got.trip_counts and got.multiplicity_ratio == 1.0


def test_nested_loops():
    import jax
    import jax.numpy as jnp

    def f(x, w):
        def outer(c, _):
            def inner(c2, _):
                return jnp.tanh(c2 @ w), None
            return jax.lax.scan(inner, c, None, length=5)[0], None
        return jax.lax.scan(outer, x, None, length=3)[0]

    def g(x, w):
        for _ in range(3):
            for _ in range(5):
                x = torch.tanh(x @ w)
        return x
    want = _ref(f, _sds(64, 128), _sds(128, 128))
    got = count_costs(g, _t(64, 128), _t(128, 128), trip_counts=(3, 5))
    assert got.dot_flops == pytest.approx(want.dot_flops, rel=REL)
    assert sorted(got.trip_counts) == [3, 5] == sorted(want.trip_counts)


def test_unrolled_equals_looped():
    import jax
    import jax.numpy as jnp

    def f_scan(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=6)[0]

    def g_loop(x, w):
        for _ in range(6):
            x = torch.tanh(x @ w)
        return x

    def g_unrolled(x, w):
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        return torch.tanh(x @ w)
    want = _ref(f_scan, _sds(64, 128), _sds(128, 128))
    args = (_t(64, 128), _t(128, 128))
    a, b = count_costs(g_loop, *args), count_costs(g_unrolled, *args)
    assert a.dot_flops == b.dot_flops
    assert a.hbm_bytes == b.hbm_bytes
    assert a.dot_flops == pytest.approx(want.dot_flops, rel=REL)


def test_slice_bytes_are_not_inflated():
    """A loop over the rows of a sequence reads one slice per iteration,
    never the whole buffer (a view moves no bytes)."""
    import jax
    import jax.numpy as jnp
    s = 512

    def f(x, w, seq):
        def body(c, r):
            return jnp.tanh(c @ w + r), c.sum()
        return jax.lax.scan(body, x, seq)

    def g(x, w, seq):
        outs = []
        for i in range(seq.shape[0]):
            outs.append(x.sum())
            x = torch.tanh(x @ w + seq[i])
        return x, torch.stack(outs)
    want = _ref(f, _sds(64, 128), _sds(128, 128), _sds(s, 64, 128))
    got = count_costs(g, _t(64, 128, device="meta"),
                      _t(128, 128, device="meta"),
                      _t(s, 64, 128, device="meta"))
    full_per_trip = s * (s * 64 * 128 * 4)
    assert got.hbm_bytes < full_per_trip / 20
    assert want.hbm_bytes < full_per_trip / 20
    assert got.dot_flops == pytest.approx(want.dot_flops, rel=REL)
    # per iteration: x and w read, c @ w written, read with the slice,
    # the sum, the tanh: a few (64, 128) f32 tensors, no (512, 64, 128)
    assert got.hbm_bytes < s * 12 * 64 * 128 * 4


def test_sharded_product_and_its_collective():
    """The reference's probe (x cut over a 1-device ``data`` axis): one
    rank's product is the whole one; on a 4-rank ``ShapeMesh`` each rank
    multiplies its quarter and sums the scalar across ``data``."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jax.make_mesh((1,), ("data",))
    with mesh:
        c = jax.jit(lambda x, w: (x @ w).sum(),
                    in_shardings=(NamedSharding(mesh, P("data", None)),
                                  NamedSharding(mesh, P()))).lower(
            _sds(64, 128), _sds(128, 128)).compile()
    from repro.launch.hlo_cost import parse_hlo_costs
    want = parse_hlo_costs(c.as_text())

    def rank(x, w, mesh):
        n = mesh.shape["data"]
        blk = x.narrow(0, mesh.axis_index("data") * (64 // n), 64 // n)
        return mesh.all_reduce((blk @ w).sum(), "data")
    for n in (1, 4):
        smesh = ShapeMesh({"data": n})
        with use_mesh(smesh):
            got = count_costs(rank, _t(64, 128, device="meta"),
                              _t(128, 128, device="meta"), smesh)
        assert got.dot_flops == pytest.approx(want.dot_flops / n, rel=REL)
        assert got.collective_bytes == (4.0 if n > 1 else 0.0)
        assert got.n_collectives == ({"all_reduce_sum": 1} if n > 1 else {})


ARCHS = ["minicpm-2b", "phi3.5-moe-42b-a6.6b", "rwkv6-7b",
         "recurrentgemma-2b", "whisper-base", "paligemma-3b"]
B, S = 2, 16


def _elementwise_products(cfg, tokens):
    """FLOPs of the products the port computes elementwise and the
    reference as a contraction, over ``tokens`` tokens per row (module
    docstring)."""
    if cfg.family == "ssm":
        h = cfg.d_model // cfg.wkv_head_dim
        return {"wkv_readout": 2.0 * B * tokens * h * cfg.wkv_head_dim ** 2
                * cfg.n_layers}
    if cfg.family == "hybrid" and tokens == 1:
        n_rec = sum(1 for t in cfg._layer_types() if t != "attn")
        return {"rglru_conv_taps": 2.0 * B * cfg.conv_width
                * (cfg.lru_width or cfg.d_model) * n_rec}
    return {}


@pytest.mark.parametrize("arch", ARCHS)
def test_model_dot_flops_match_the_hlo_parser(arch):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import decode_step as jdecode
    from repro.models import init_cache as jcache
    from repro.models import init_params as jinit
    from repro.models import loss_fn as jloss
    from repro.models import split_tree
    jc, tc = jget(arch).reduced(), get_config(arch).reduced()
    params = jax.eval_shape(lambda k: split_tree(jinit(jc, k))[0],
                            jax.random.PRNGKey(0))
    jb = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
          "targets": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    tb = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
          for k in jb}
    extra = {"encdec": ("frames", jc.enc_seq), "vlm": ("patches",
                                                       jc.prefix_tokens)}
    if jc.family in extra:
        key, n = extra[jc.family]
        jb[key] = _sds(B, n, jc.d_model)
        tb[key] = torch.empty((B, n, jc.d_model), device="meta")
    tp = init_params(tc, device="meta")

    want = _ref(lambda p, b: jloss(jc, p, b), params, jb).dot_flops
    got = count_costs(loss_fn, tc, tp, tb).dot_flops
    named = _elementwise_products(tc, S)
    assert got == pytest.approx(want - sum(named.values()), rel=REL), named

    csds = jax.eval_shape(lambda: jcache(jc, B, S, jnp.float32))
    want = _ref(lambda p, c, t: jdecode(jc, p, c, t), params, csds,
                jax.ShapeDtypeStruct((B, 1), jnp.int32)).dot_flops
    cache = init_cache(tc, B, S, torch.float32, device="meta")
    got = count_costs(decode_step, tc, tp, cache,
                      torch.empty((B, 1), dtype=torch.long,
                                  device="meta")).dot_flops
    named = _elementwise_products(tc, 1)
    assert got == pytest.approx(want - sum(named.values()), rel=REL), named


@pytest.mark.parametrize("nbits", [8, 4])
@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_dequant_wrappers_report_one_launch(nbits, device):
    """A dequant product reports one launch of 2·m·n·k FLOPs; on meta it
    computes nothing, on the CPU its twin's ops are not counted again."""
    m, k, n = 8, 96, 64
    w = torch.randn((1, k, n), generator=torch.Generator().manual_seed(1))
    leaf = quantize_params_tree({"l": {"w": w}}, nbits=nbits,
                                packed=nbits == 4, min_dim=16)["l"]["w"]
    leaf = {key: (torch.empty_like(v, device="meta") if device == "meta"
                  else v)[0] for key, v in leaf.items()}
    x = _t(m, k, device=device)
    z = leaf["codes"] if nbits == 4 else leaf["codes"].transpose(-1, -2)
    esc = ((leaf["esc_row"], leaf["esc_col"], leaf["esc_dval"])
           if nbits == 4 else None)
    got = count_costs(dequant_matmul, x, z, leaf["s"], leaf["t"],
                      escapes=esc)
    name = "dequant_matmul_packed_int4" if nbits == 4 else \
        "dequant_matmul_int8"
    assert got.kernel_launches == {name: 1}
    assert got.dot_flops == got.kernel_flops == 2.0 * m * n * k
    assert tuple(got.result.shape) == (m, n)
    assert got.result.device.type == device


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 5), (False, 5)])
def test_flash_reports_the_kept_pairs(causal, window):
    b, s, h, d = 2, 12, 3, 64
    q, k, v = (_t(b, s, h, d, device="meta") for _ in range(3))
    got = count_costs(flash_attention, q, k, v, causal=causal,
                      window=window)
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    keep = np.ones((s, s), bool)
    if causal:
        keep &= j <= i
    if window:
        keep &= i - j < window
    assert got.kernel_launches == {"flash_attention": 1}
    assert got.dot_flops == 4.0 * d * b * h * keep.sum()
    cpu = count_costs(flash_attention, *(_t(b, s, h, d) for _ in range(3)),
                      causal=causal, window=window)
    assert cpu.dot_flops == got.dot_flops


def test_roofline_terms_match_the_reference_report():
    from repro.launch.roofline import HW as JHW
    from repro.launch.roofline import RooflineReport as JReport
    kw = dict(arch="a", shape="s", mesh="single", chips=256,
              hlo_flops_per_device=3.2e14, hlo_bytes_per_device=7.5e11,
              collective_bytes_per_device=2.1e10,
              collective_breakdown={"all_gather": 2.1e10},
              model_flops_total=5.0e16, bytes_per_device_peak=3.0e10)
    jhw = JHW()
    hw = roofline.HW(peak_flops=jhw.peak_flops, hbm_bw=jhw.hbm_bw,
                     link_bw=jhw.link_bw, n_links=jhw.n_links)
    want = JReport(**kw).finalize()
    got = roofline.RooflineReport(**kw).finalize(hw)
    for field in ("compute_s", "memory_s", "collective_s", "dominant",
                  "useful_ratio", "bound_time_s"):
        assert getattr(got, field) == getattr(want, field), field
    # the fraction is taken against each package's own default peak
    assert got.roofline_fraction * roofline.HW().peak_flops \
        == pytest.approx(want.roofline_fraction * jhw.peak_flops, rel=1e-12)
    assert roofline.model_flops(10, 7, "train") == 420.0
    assert roofline.model_flops(10, 7, "decode") == 140.0


def test_default_hw_is_one_h100_sxm():
    hw = roofline.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.n_links) \
        == (989e12, 3.35e12, 450e9, 1)
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.BF16_FLOP_PER_S == 989e12


def test_collective_bytes_from_a_mesh_log():
    log = [("all_gather", "float32", (4, 8), 128),
           ("all_reduce_sum", "bfloat16", (8,), 16),
           ("all_gather", "float32", (4, 8), 128)]
    assert roofline.collective_bytes_from_log(log) == {
        "all_gather": 256.0, "all_reduce_sum": 16.0, "total": 272.0}
