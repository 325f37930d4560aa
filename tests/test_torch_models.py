"""Port of the dense model + tree quantizer held against the JAX package.

Reduced minicpm-2b (MHA), reduced qwen2.5-32b (GQA + QKV bias) and a
local-window config.  Weights come from the reference's ``init_params``
(biases and norm scales perturbed with numpy so they matter), cross as
numpy, and enter the port through ``models.convert.from_jax_params``.

Tolerances: integer artifacts (payloads, escape COO, inventory records)
byte-identical; logits and f32 cache contents rtol = atol = 1e-4 (two
layers of f32 matmuls summed in another order); the port's decode_chunk
bit-exact against its own decode_step.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_trees_equal, to_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.kernels.dequant import payload_checksums, verify_payloads
from repro_torch.models.layers import layernorm, rmsnorm, rope
from repro_torch.models import (cache_reset_slot, cache_write_slot,
                                decode_chunk, decode_step, from_jax_params,
                                init_cache, init_params, split_layers)
from repro_torch.quant import (leaf_format_histogram, leaf_inventory,
                               quantize_params_tree, qweight_bytes)

LOGIT_TOL = 1e-4
WINDOW = dict(name="win", family="dense", n_layers=2, d_model=32, n_heads=2,
              n_kv=2, d_ff=64, vocab=64, head_dim=16, local_window=6)
ARCHS = ["minicpm-2b", "qwen2.5-32b", "window"]
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
            "w_in": 3, "w_out": 3}.get(path[-2])


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
                           min_dim=16, **_qkw(fmt)))


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
                               min_dim=16, **_qkw(fmt))
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
    assert_close(cache.kv.k, jcache.kv.k, tol=LOGIT_TOL)
    assert_close(cache.kv.v, jcache.kv.v, tol=LOGIT_TOL)
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
            assert torch.equal(a.kv.k, other.kv.k)
            assert torch.equal(a.kv.v, other.kv.v)
            assert torch.equal(a.pos, other.pos)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_write_and_reset_slot_match_jax(arch):
    """vs repro.models.cache_write_slot / cache_reset_slot."""
    import jax.numpy as jnp
    from repro.models import cache_reset_slot as jreset
    from repro.models import cache_write_slot as jwrite
    from repro.models import init_cache as jcache

    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(5)
    big = jcache(jcfg, 3, 8, jnp.float32, per_slot=True)
    big = big._replace(
        kv=type(big.kv)(*(jnp.asarray(rng.standard_normal(t.shape),
                                      jnp.float32)
                          if not isinstance(t, tuple) else t
                          for t in big.kv)),
        pos=jnp.asarray([4, 1, 7], jnp.int32))
    sub = jcache(jcfg, 1, 8, jnp.float32)
    sub = sub._replace(
        kv=type(sub.kv)(*(jnp.asarray(rng.standard_normal(t.shape),
                                      jnp.float32)
                          if not isinstance(t, tuple) else t
                          for t in sub.kv)),
        pos=jnp.asarray(5, jnp.int32))
    want = jreset(jwrite(big, sub, 1), 2)

    tbig = init_cache(tcfg, 3, 8, torch.float32, per_slot=True,
                      device="cpu")
    tbig = tbig._replace(kv=type(tbig.kv)(
        torch.from_numpy(np.array(big.kv.k)),
        torch.from_numpy(np.array(big.kv.v))),
        pos=torch.from_numpy(np.array(big.pos)))
    tsub = init_cache(tcfg, 1, 8, torch.float32, device="cpu")
    tsub = tsub._replace(kv=type(tsub.kv)(
        torch.from_numpy(np.array(sub.kv.k)),
        torch.from_numpy(np.array(sub.kv.v))),
        pos=torch.tensor(5, dtype=torch.int32))
    got = cache_reset_slot(cache_write_slot(tbig, tsub, 1), 2)
    for a, b in ((got.kv.k, want.kv.k), (got.kv.v, want.kv.v),
                 (got.pos, want.pos)):
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
                                  "minitron-8b"])
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
