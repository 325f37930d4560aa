"""Port of the decoder + tree quantizer held against the JAX package.

Reduced minicpm-2b (MHA), reduced qwen2.5-32b (GQA + QKV bias), a
local-window config, reduced rwkv6-7b (ssm) and reduced recurrentgemma-2b
(hybrid; quantized at ``min_dim`` 8 so the RWKV decay LoRA is too).
Weights come from the reference's ``init_params`` (biases and norm scales
perturbed with numpy so they matter), cross as numpy, and enter the port
through ``models.convert.from_jax_params``.

Tolerances: integer artifacts (payloads, escape COO, inventory records)
byte-identical; logits and f32 cache contents rtol = atol = 1e-4 (two
layers of f32 matmuls summed in another order); the RWKV WKV state,
whose entries reach a few hundred, and the hybrid's K/V, downstream of an
RG-LRU gate, relative to their largest entry; the port's
decode_chunk bit-exact against its own decode_step.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_parity import (assert_close, assert_trees_close,
                           assert_trees_equal, load_leaves, require_cuda,
                           to_numpy, tree_leaves)
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.kernels.dequant import payload_checksums, verify_payloads
from repro_torch.models.layers import dense, layernorm, rmsnorm, rope
from repro_torch.models import (cache_reset_slot, cache_write_slot,
                                decode_chunk, decode_step, from_jax_params,
                                init_cache, init_params, split_layers)
from repro_torch.quant import (leaf_format_histogram, leaf_inventory,
                               quantize_params_tree, qweight_bytes)

LOGIT_TOL = 1e-4
WINDOW = dict(name="win", family="dense", n_layers=2, d_model=32, n_heads=2,
              n_kv=2, d_ff=64, vocab=64, head_dim=16, local_window=6)
ARCHS = ["minicpm-2b", "qwen2.5-32b", "window", "rwkv6-7b",
         "recurrentgemma-2b"]
#: the recurrent archs quantize their narrow leaves too (the reduced decay
#: LoRA is (64, 8)): 10 code leaves on rwkv6, 21 on recurrentgemma
MIN_DIM = {"rwkv6-7b": 8, "recurrentgemma-2b": 8}
FORMATS = ["fp", "int8", "int4", "int3", "int2", "mixed"]


def _cfgs(arch):
    """(jax cfg, port cfg) of one test architecture."""
    from repro.configs import get_config
    from repro.configs.base import ArchConfig
    if arch == "window":
        return ArchConfig(**WINDOW), TArchConfig(**WINDOW)
    return get_config(arch).reduced(), tget_config(arch).reduced()


def _mixed(path):
    """Mixed-rate leaf formats: every rung of the ladder in one tree."""
    return {"wq": 4, "wk": 3, "wv": 2, "wo": 8, "w_gate": 2, "w_up": 4,
            "w_in": 3, "w_out": 3, "w_r": 2, "w_k": 4, "w_v": 8, "w_g": 3,
            "w_o": 4, "decay_a": 8, "decay_b": 4, "w_a": 2,
            "w_x": 8}.get(path[-2])


def _qkw(fmt):
    return {"int8": dict(nbits=8), "int4": dict(nbits=4, packed=True),
            "int3": dict(nbits=3), "int2": dict(nbits=2),
            "mixed": dict(nbits_by_path=_mixed)}[fmt]


@functools.lru_cache(maxsize=None)
def jax_tree(arch, fmt):
    """The reference's served value tree (numpy leaves)."""
    import jax
    from repro.models import init_params as jinit
    from repro.models import split_tree
    from repro.quant import quantize_params_tree as jquant

    jcfg, _ = _cfgs(arch)
    base = to_numpy(split_tree(jinit(jcfg, jax.random.PRNGKey(0)))[0])
    rng = np.random.default_rng(7)

    def perturb(node, path=()):
        if isinstance(node, dict):
            return {k: perturb(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [perturb(v, path + (str(i),)) for i, v in enumerate(node)]
        if path[-1] == "b":
            return (rng.standard_normal(node.shape) * 0.1).astype(node.dtype)
        if path[-1] == "scale":
            return (1 + rng.standard_normal(node.shape) * 0.1).astype(
                node.dtype)
        return node

    base = perturb(base)
    if fmt == "fp":
        return base
    return to_numpy(jquant(jax.tree.map(jax.numpy.asarray, base),
                           min_dim=MIN_DIM.get(arch, 16), **_qkw(fmt)))


@pytest.mark.parametrize("fmt", ["int8", "int4", "int3", "int2", "mixed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_tree_matches_jax(arch, fmt):
    """vs repro.quant.quantize_params_tree / leaf_inventory /
    leaf_format_histogram / qweight_bytes: byte-identical leaves."""
    import jax
    from repro.kernels.dequant.ops import payload_checksums as jcrc
    from repro.quant import (leaf_format_histogram as jhist,
                             leaf_inventory as jinv, qweight_bytes as jqb)

    want = jax_tree(arch, fmt)
    got = quantize_params_tree(from_jax_params(jax_tree(arch, "fp"), "cpu"),
                               min_dim=MIN_DIM.get(arch, 16), **_qkw(fmt))
    assert_trees_equal(got, want)
    jwant = jax.tree.map(jax.numpy.asarray, want)
    assert leaf_inventory(got) == jinv(jwant)
    assert leaf_format_histogram(got) == jhist(jwant)
    assert qweight_bytes(got) == jqb(jwant)
    crcs = payload_checksums(got)
    assert crcs == jcrc(jwant)
    assert verify_payloads(got, crcs) == []
    path = sorted(crcs)[0]
    leaf = got
    for k in path.split("/"):
        leaf = leaf[k]
    leaf["codes"].view(-1)[0] ^= 1                 # one flipped bit
    assert verify_payloads(got, crcs) == [path]


def _tokens(vocab, b, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(
        np.int32)


def _run_jax(jcfg, tree, pos0, toks, max_len):
    import jax
    import jax.numpy as jnp
    from repro.models import decode_step as jstep
    from repro.models import init_cache as jcache

    b = toks.shape[0]
    cache = jcache(jcfg, b, max_len, jnp.float32, per_slot=pos0 is not None)
    if pos0 is not None:
        cache = cache._replace(pos=jnp.asarray(pos0, jnp.int32))
    step = jax.jit(functools.partial(jstep, jcfg))
    params = jax.tree.map(jnp.asarray, tree)
    out = []
    for j in range(toks.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(toks[:, j:j + 1]))
        out.append(np.asarray(logits))
    return out, cache


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch, fmt, per_slot):
    """vs repro.models.decode_step, scalar and per-slot ``pos``.

    Per-slot positions start staggered; with max_len 8 and 5 steps the
    slot at position 6 steps past the global buffer (its write is
    dropped) and the window config wraps its ring buffer."""
    jcfg, tcfg = _cfgs(arch)
    tree = jax_tree(arch, fmt)
    max_len = 8
    toks = _tokens(tcfg.vocab, 3, 5, seed=1)
    pos0 = [0, 2, 6] if per_slot else None
    want, jcache = _run_jax(jcfg, tree, pos0, toks, max_len)
    params = from_jax_params(tree, "cpu")
    cache = init_cache(tcfg, 3, max_len, torch.float32, per_slot=per_slot,
                       device="cpu")
    if per_slot:
        cache = cache._replace(pos=torch.tensor(pos0, dtype=torch.int32))
    for j in range(toks.shape[1]):
        logits, cache = decode_step(tcfg, params, cache,
                                    torch.from_numpy(toks[:, j:j + 1]))
        assert logits.shape == (3, tcfg.vocab)
        assert_close(logits, want[j], tol=LOGIT_TOL)
    if arch == "rwkv6-7b":
        # the WKV state's entries reach a few hundred: it alone is held
        # relative to its largest entry; the shift states absolutely
        assert_trees_close(cache.kv.wkv, jcache.kv.wkv, tol=LOGIT_TOL,
                           relative=True)
        assert_trees_close(cache.kv._replace(wkv=None),
                           jcache.kv._replace(wkv=None), tol=LOGIT_TOL)
    elif arch == "recurrentgemma-2b":
        # the hybrid's attention reads an RG-LRU block's output, whose
        # sqrt(1 - a^2) input gate loses digits as a -> 1: its K/V (entries
        # up to ~24) relative to the largest entry; the recurrent state
        # absolutely
        assert_trees_close(cache.kv["kv"], jcache.kv["kv"], tol=LOGIT_TOL,
                           relative=True)
        assert_trees_close(cache.kv["rec"], jcache.kv["rec"], tol=LOGIT_TOL)
    else:
        assert_trees_close(cache.kv, jcache.kv, tol=LOGIT_TOL)
    np.testing.assert_array_equal(to_numpy(cache.pos), np.asarray(jcache.pos))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chunk_is_exactly_decode_steps(arch):
    """In the port: decode_chunk of C tokens ≡ C decode_step calls,
    bit for bit, logits and cache (per-slot and lockstep), with stacked
    or pre-split (``split_layers``) params."""
    _, tcfg = _cfgs(arch)
    params = quantize_params_tree(
        from_jax_params(jax_tree(arch, "fp"), "cpu"),
        min_dim=16, nbits=4, packed=True)
    split = split_layers(params)
    toks = torch.from_numpy(_tokens(tcfg.vocab, 2, 7, seed=3))
    for per_slot in (False, True):
        a, b, c = (init_cache(tcfg, 2, 12, torch.float32, per_slot=per_slot,
                              device="cpu") for _ in range(3))
        la, a = decode_chunk(tcfg, params, a, toks)
        for j in range(toks.shape[1]):
            lb, b = decode_step(tcfg, params, b, toks[:, j:j + 1])
        # pre-split layer views (what the engines pass) change nothing
        lc, c = decode_chunk(tcfg, split, c, toks)
        for other, lo in ((b, lb), (c, lc)):
            assert torch.equal(la, lo)
            for x, y in zip(tree_leaves(a.kv), tree_leaves(other.kv)):
                assert torch.equal(x, y)
            assert torch.equal(a.pos, other.pos)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_write_and_reset_slot_match_jax(arch):
    """vs repro.models.cache_write_slot / cache_reset_slot, every state
    leaf (K/V, RWKV shift and WKV states, RG-LRU h and conv)."""
    import jax
    import jax.numpy as jnp
    from repro.models import cache_reset_slot as jreset
    from repro.models import cache_write_slot as jwrite
    from repro.models import init_cache as jcache

    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(5)

    def noise(t):
        return jnp.asarray(rng.standard_normal(t.shape), jnp.float32)
    big = jcache(jcfg, 3, 8, jnp.float32, per_slot=True)
    big = big._replace(kv=jax.tree.map(noise, big.kv),
                       pos=jnp.asarray([4, 1, 7], jnp.int32))
    sub = jcache(jcfg, 1, 8, jnp.float32)
    sub = sub._replace(kv=jax.tree.map(noise, sub.kv),
                       pos=jnp.asarray(5, jnp.int32))
    want = jreset(jwrite(big, sub, 1), 2)

    tbig = init_cache(tcfg, 3, 8, torch.float32, per_slot=True,
                      device="cpu")
    load_leaves(tbig.kv, tree_leaves(to_numpy(big.kv)))
    tbig = tbig._replace(pos=torch.from_numpy(np.array(big.pos)))
    tsub = init_cache(tcfg, 1, 8, torch.float32, device="cpu")
    load_leaves(tsub.kv, tree_leaves(to_numpy(sub.kv)))
    tsub = tsub._replace(pos=torch.tensor(5, dtype=torch.int32))
    got = cache_reset_slot(cache_write_slot(tbig, tsub, 1), 2)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b))


def test_port_init_params_has_the_reference_tree():
    """The port's own init: the reference's keys, shapes and dtypes."""
    import jax
    from repro.models import init_params as jinit
    from repro.models import split_tree

    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            split_tree(jinit(jcfg, jax.random.PRNGKey(0)))[0])
        got = jax.tree.map(lambda a: (tuple(a.shape),
                                      str(a.dtype).replace("torch.", "")),
                           init_params(tcfg, 0, device="cpu"))
        assert got == want


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen1.5-32b", "qwen2.5-32b",
                                  "minitron-8b", "rwkv6-7b",
                                  "recurrentgemma-2b", "whisper-base",
                                  "paligemma-3b"])
def test_configs_match_jax(arch):
    """The port's registry holds the reference's configs, field for field,
    and reduces them the same way."""
    from repro.configs import get_config

    for j, t in ((get_config(arch), tget_config(arch)),
                 (get_config(arch).reduced(), tget_config(arch).reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.padded_vocab, t.resolved_head_dim) == \
            (j.padded_vocab, j.resolved_head_dim)


def test_norms_and_rope_match_jax():
    """vs repro.models.layers.rmsnorm / layernorm / rope (the same
    exp(-log θ·i/half) frequencies in f32), scalar and per-row positions."""
    import jax.numpy as jnp
    from repro.models import layers as jl

    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3
    p = {"scale": (1 + 0.1 * rng.standard_normal(48)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(48)).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    assert_close(rmsnorm(tp, torch.from_numpy(x)), jl.rmsnorm(jp, x),
                 tol=1e-5)
    assert_close(layernorm(tp, torch.from_numpy(x)), jl.layernorm(jp, x),
                 tol=1e-5)
    q = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (3, 5)).astype(np.int32)
    for theta in (1e4, 1e6):
        assert_close(rope(torch.from_numpy(q), torch.from_numpy(pos), theta),
                     jl.rope(jnp.asarray(q), jnp.asarray(pos), theta),
                     tol=1e-4)


def _int8_leaf(n_in, n_out, stack, seed, bias):
    """A stacked int8 serving leaf (codes (stack, in, out)) with numpy
    values, an optional bias, and x (2, 3, in)."""
    rng = np.random.default_rng(seed)
    p = {"w": {"codes": rng.integers(-127, 128, (stack, n_in, n_out))
               .astype(np.int8),
               "s": ((rng.random((stack, n_in)) + 0.5) / np.sqrt(n_in) / 60)
               .astype(np.float32),
               "t": (rng.random((stack, n_out)) + 0.5).astype(np.float32)}}
    if bias:
        p["b"] = rng.standard_normal((stack, n_out)).astype(np.float32)
    x = rng.standard_normal((2, 3, n_in)).astype(np.float32)
    return p, x


def _layer(p, i):
    return {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
                else v[i]) for k, v in p.items()}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("n_in,n_out", [(48, 40), (37, 53)])
def test_dense_int8_leaf_matches_jax(n_in, n_out, bias):
    """vs repro.models.layers.dense on an int8 serving leaf, one layer of
    a stacked leaf: the port's branch hands the (out, in) view of the
    stored (in, out) codes to the fused dequant-matmul (its plain twin on
    the CPU), the reference runs ((x·s) @ codes)·t."""
    import jax.numpy as jnp
    from repro.models import layers as jl

    p, x = _int8_leaf(n_in, n_out, 3, n_in + n_out, bias)
    tp = from_jax_params(p, "cpu")
    for i in range(3):
        want = jl.dense({k: (jnp.asarray(v) if not isinstance(v, dict) else
                             {kk: jnp.asarray(vv) for kk, vv in v.items()})
                         for k, v in _layer(p, i).items()}, jnp.asarray(x))
        got = dense(_layer(tp, i), torch.from_numpy(x))
        assert got.shape == (2, 3, n_out) and got.dtype == torch.float32
        assert_close(got, want, tol=1e-5)


@pytest.mark.cuda
def test_dense_int8_leaf_launches_the_int8_kernel_on_cuda():
    """On CUDA the int8 branch of dense launches the int8 kernel once per
    call, reads the stored codes in place, and matches the CPU branch."""
    from repro_torch.kernels.dequant import LAUNCHES
    dev = require_cuda()
    p, x = _int8_leaf(2304, 576, 2, 7, True)
    cpu = from_jax_params(p, "cpu")
    gpu = from_jax_params(p, dev)
    before = LAUNCHES[8]
    got = dense(_layer(gpu, 1), torch.from_numpy(x).to(dev))
    torch.cuda.synchronize()
    assert LAUNCHES[8] == before + 1
    assert_close(got, dense(_layer(cpu, 1), torch.from_numpy(x)), tol=1e-4)


def test_convert_keeps_bits_of_every_leaf_dtype():
    """from_jax_params: uint8/int8/int32/f32 and bf16 leaves cross byte for
    byte, keys and nesting kept."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    bf = np.asarray(jnp.asarray(rng.standard_normal((4, 3)), jnp.bfloat16))
    tree = {"a": {"codes": rng.integers(0, 256, (2, 5)).astype(np.uint8),
                  "esc_row": np.arange(3, dtype=np.int32)},
            "b": [rng.integers(-128, 128, 7).astype(np.int8),
                  rng.standard_normal(4).astype(np.float32)],
            "c": bf}
    got = from_jax_params(tree, "cpu")
    assert got["c"].dtype == torch.bfloat16
    assert got["c"].view(torch.int16).numpy().tobytes() == bf.tobytes()
    for a, b in ((got["a"]["codes"], tree["a"]["codes"]),
                 (got["a"]["esc_row"], tree["a"]["esc_row"]),
                 (got["b"][0], tree["b"][0]), (got["b"][1], tree["b"][1])):
        assert a.numpy().dtype == b.dtype
        assert a.numpy().tobytes() == b.tobytes()
