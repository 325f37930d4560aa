"""The port's sharding rules and k-sharded artifacts held against the JAX
package (DESIGN.md §5, §13).

``dist.sharding``'s rules against ``repro.dist.sharding`` on every
architecture's logical axes; ``core.packing.shard_planar_codes`` and
``serve.sharded.shard_params_tree`` byte for byte against the reference
on its mesh test's six trees (fp, int8, int4, int3, int2, a crc32 mix) at
4 and 8 shards, with the inventory and byte counts; the oracle-mode
``dequant_matmul_sharded`` against the reference's and the unsharded
product; and the port's oracle engine (the default engine over a sharded
tree) against the reference's oracle engine on the reference script's
staggered arrivals.  The reference side is computed once per module.
"""
import functools
import zlib

import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_trees_equal, to_numpy
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.core.packing import shard_planar_codes, unpack_int2_planar, \
    unpack_int3_planar, unpack_int4_planar
from repro_torch.dist import sharding as tsh
from repro_torch.models import from_jax_params
from repro_torch.models.layers import dense
from repro_torch.quant import leaf_inventory, qweight_bytes
from repro_torch.serve import (ContinuousEngine, EngineConfig, Request,
                               params_pspecs, shard_params_tree)

CFG = dict(name="m", family="dense", n_layers=2, d_model=32, n_heads=2,
           n_kv=2, d_ff=64, vocab=64, head_dim=16)
TREES = ("fp", "int8", "int4", "int3", "int2", "mixed")
_UNPACK = {2: unpack_int2_planar, 3: unpack_int3_planar,
           4: unpack_int4_planar}
_QMAX = {2: 1, 3: 3, 4: 7}


def mixed_bits(path):
    """The reference mesh test's per-leaf format mix."""
    return [2, 3, 4, 8][zlib.crc32("/".join(path).encode()) % 4]


def workload():
    """The reference mesh script's staggered arrivals: (admit-at-step,
    rid, prompt, budget)."""
    rng = np.random.default_rng(3)
    return [(0, 0, rng.integers(0, CFG["vocab"], 5).astype(np.int32), 4),
            (0, 1, rng.integers(0, CFG["vocab"], 7).astype(np.int32), 3),
            (1, 2, rng.integers(0, CFG["vocab"], 4).astype(np.int32), 5),
            (3, 3, rng.integers(0, CFG["vocab"], 6).astype(np.int32), 4)]


def drain(eng, request):
    done, pending, steps = [], list(workload()), 0
    while pending or eng.queue or eng.active_slots:
        while pending and pending[0][0] <= steps:
            _, rid, prompt, budget = pending.pop(0)
            assert eng.submit(request(rid=rid, prompt=prompt.copy(),
                                      max_new_tokens=budget))
        done.extend(eng.step())
        steps += 1
        assert steps < 300
    return {r.rid: tuple(r.out_tokens) for r in done}


def _spec_tuples(tree):
    """A PartitionSpec tree as the port writes it: a tuple per leaf."""
    if isinstance(tree, dict):
        return {k: _spec_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's six trees (numpy), each sharded 4 and 8 ways, their
    inventories and byte counts, and its oracle engine's streams at 4
    shards."""
    import jax
    from repro.configs.base import ArchConfig
    from repro.models import init_params, split_tree
    from repro.quant import leaf_inventory as jinv
    from repro.quant import quantize_params_tree
    from repro.quant import qweight_bytes as jbytes
    from repro.serve import ContinuousEngine as JCont
    from repro.serve import EngineConfig as JConfig
    from repro.serve import Request as JRequest
    from repro.serve import params_pspecs as jspecs
    from repro.serve import shard_params_tree as jshard

    cfg = ArchConfig(**CFG)
    params, _ = split_tree(init_params(cfg, jax.random.PRNGKey(0)))
    trees = {
        "fp": params,
        "int8": quantize_params_tree(params, min_dim=16),
        "int4": quantize_params_tree(params, nbits=4, packed=True,
                                     min_dim=16),
        "int3": quantize_params_tree(params, nbits=3, min_dim=16),
        "int2": quantize_params_tree(params, nbits=2, min_dim=16),
        "mixed": quantize_params_tree(params, min_dim=16,
                                      nbits_by_path=mixed_bits)}
    out = {}
    for name, tree in trees.items():
        rec = {"tree": to_numpy(tree)}
        for s in (4, 8):
            sp = jshard(tree, s, min_dim=16)
            rec[s] = (to_numpy(sp), jinv(sp), jbytes(sp),
                      _spec_tuples(jspecs(sp)))
            if s == 4:
                rec["streams"] = drain(JCont(cfg, sp, config=JConfig(
                    n_slots=2, max_len=16, prefill_chunk=4)), JRequest)
        out[name] = rec
    return out


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
def test_rules_and_specs_match_reference_on_every_arch(multi_pod):
    """default_rules equal the reference's table and spec_for_axes gives
    the reference's PartitionSpec entries for every param leaf's logical
    axes of every architecture (collected by eval_shape, as
    tests/test_sharding.py does), with no mesh axis repeated."""
    import jax
    from repro.configs import get_config, list_archs
    from repro.dist.sharding import default_rules, spec_for_axes
    from repro.models import init_params, split_tree

    rules = default_rules(multi_pod)
    assert tsh.default_rules(multi_pod) == rules
    n = 0
    for arch in list_archs():
        cfg = get_config(arch).reduced()
        px = jax.eval_shape(lambda k: init_params(cfg, k),
                            jax.random.PRNGKey(0))
        _, axes = split_tree(px)
        flat = jax.tree.leaves(axes, is_leaf=lambda x: isinstance(x, tuple))
        for ax in flat:
            got = tsh.spec_for_axes(ax, tsh.default_rules(multi_pod))
            assert got == tuple(spec_for_axes(ax, rules)), (arch, ax)
            used = [a for e in got if e is not None
                    for a in (e if isinstance(e, tuple) else (e,))]
            assert len(used) == len(set(used)), (arch, ax, got)
            n += 1
    assert n > 100


def test_logical_shard_is_identity_with_and_without_a_mesh():
    """The port has no GSPMD: logical_shard returns its input itself."""
    x = torch.ones(4, 4)
    assert tsh.logical_shard(x, "batch", "d_model") is x
    assert tsh.current_mesh() is None and not tsh.in_manual_axes()
    with tsh.use_mesh("mesh"):
        assert tsh.current_mesh() == "mesh"
        assert tsh.logical_shard(x, "batch", "d_model") is x
        with tsh.manual_axes(axis="model", shards=4):
            assert tsh.in_manual_axes()
            assert tsh.manual_axis_info() == {"axis": "model", "shards": 4}
            assert tsh.logical_shard(x, "batch", None) is x
    assert tsh.current_mesh() is None and tsh.manual_axis_info() is None
    assert tsh.batch_spec() == ("data",)


# ---------------------------------------------------------------------------
# sharded artifacts, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbits", [2, 3, 4])
@pytest.mark.parametrize("k,shards", [(32, 8), (30, 8), (17, 4), (64, 2)])
def test_shard_planar_codes_bytes_match_reference(nbits, k, shards):
    """Per-shard planar payloads byte-identical to shard_planar_codes_jnp,
    and lossless: each shard's first k_loc columns reassemble the codes."""
    import jax.numpy as jnp
    from repro.core.packing import shard_planar_codes_jnp

    rng = np.random.default_rng(nbits * 100 + k)
    z = rng.integers(-_QMAX[nbits], _QMAX[nbits] + 1, (6, k)).astype(np.int8)
    got = shard_planar_codes(torch.from_numpy(z), shards, nbits=nbits)
    want = shard_planar_codes_jnp(jnp.asarray(z), shards, nbits=nbits)
    assert got.dtype == torch.uint8
    assert_trees_equal(got, want)
    k_loc = -(-k // shards)
    back = _UNPACK[nbits](got)[..., :k_loc]
    flat = torch.cat([back[s] for s in range(shards)], dim=-1)[:, :k]
    assert np.array_equal(flat.numpy(), z)


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("name", TREES)
def test_shard_params_tree_matches_reference(name, shards):
    """shard_params_tree of the reference's tree equals the reference's in
    every entry (codes, scales, escape partition, markers, fp blocks),
    params_pspecs names the same sharded entries, and leaf_inventory /
    qweight_bytes equal the reference's exactly."""
    ref = _reference()[name]
    want, inv, nbytes, specs = ref[shards]
    got = shard_params_tree(from_jax_params(ref["tree"], "cpu"), shards,
                            min_dim=16)
    assert_trees_equal(got, want)
    assert params_pspecs(got) == specs
    assert leaf_inventory(got) == inv
    assert qweight_bytes(got) == tuple(nbytes)
    if name != "fp":
        assert any(r.get("shards") == shards for r in inv)


def _packed_leaf_with_escapes(rng, n, k, nbits, n_esc):
    """The reference test's packed leaf whose codes overflow the clip
    range at ``n_esc`` sites (real escape-COO entries)."""
    import jax.numpy as jnp
    from repro.core.packing import pack_codes_jnp
    qmax = _QMAX[nbits]
    z = rng.integers(-qmax, qmax + 1, (n, k)).astype(np.int32)
    flat = rng.choice(n * k, size=n_esc, replace=False)
    z[np.unravel_index(flat, z.shape)] = qmax + rng.integers(1, 4, n_esc)
    payload, er, ec, ev = pack_codes_jnp(jnp.asarray(z), nbits=nbits,
                                         escape_capacity=n_esc + 3)
    return to_numpy({"codes": payload,
                     "s": rng.uniform(0.5, 1.5, k).astype(np.float32),
                     "t": rng.uniform(0.5, 1.5, n).astype(np.float32),
                     "esc_row": er, "esc_col": ec, "esc_dval": ev})


@pytest.mark.parametrize("fmt", [2, 3, 4, 8, 16])
@pytest.mark.parametrize("shards", [3, 8])
def test_oracle_sharded_dense_matches_reference_and_unsharded(fmt, shards):
    """dense() over a k-sharded leaf (the oracle loop: ragged k, escapes
    with local columns) within 1e-5 of the reference's, and within the
    reference test's 2e-5 of the port's unsharded product."""
    import jax.numpy as jnp
    from repro.models.layers import dense as jdense
    from repro.serve import shard_params_tree as jshard

    rng = np.random.default_rng(17 * fmt + shards)
    n, k = 24, 22                                    # k % shards != 0
    if fmt in _QMAX:
        leaf = _packed_leaf_with_escapes(rng, n, k, fmt, n_esc=5)
    elif fmt == 8:
        leaf = {"codes": rng.integers(-127, 128, (k, n)).astype(np.int8),
                "s": rng.uniform(0.5, 1.5, k).astype(np.float32) / 127,
                "t": rng.uniform(0.5, 1.5, n).astype(np.float32)}
    else:
        leaf = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((4, k)).astype(np.float32)
    jtree = jshard({"w": leaf if fmt == 16 else
                    {kk: jnp.asarray(v) for kk, v in leaf.items()}},
                   shards, min_dim=1)
    ttree = shard_params_tree({"w": from_jax_params(leaf, "cpu")}, shards,
                              min_dim=1)
    assert "kshard" in ttree["w"] and ttree["w"]["kshard"].shape == ()
    got = dense(ttree, torch.from_numpy(x))
    assert_close(got, jdense(jtree, jnp.asarray(x)), tol=1e-5)
    assert_close(got, dense({"w": from_jax_params(leaf, "cpu")},
                            torch.from_numpy(x)), tol=2e-5)


# ---------------------------------------------------------------------------
# the oracle engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TREES)
def test_oracle_engine_streams_match_reference_oracle(name):
    """The port's default engine over the 4-way sharded tree serves the
    reference script's staggered arrivals with the reference oracle's
    greedy streams, request by request."""
    ref = _reference()[name]
    sp = shard_params_tree(from_jax_params(ref["tree"], "cpu"), 4,
                           min_dim=16)
    eng = ContinuousEngine(TArchConfig(**CFG), sp, config=EngineConfig(
        n_slots=2, max_len=16, prefill_chunk=4))
    got = drain(eng, Request)
    assert got == ref["streams"]
    assert set(got) == {0, 1, 2, 3} and all(got.values())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 256])
@pytest.mark.parametrize("k,n", [(2304, 2304), (2304, 5760), (5760, 2304)])
@pytest.mark.parametrize("nbits", [4, 8])
def test_sharded_kernels_match_twins_at_the_shard_shapes(nbits, k, n, m):
    """minicpm-2b's leaves sharded 4 ways (k_loc = 576 / 1440): the
    oracle's dense on the card launches B1 (packed int4) or B2 (int8) once
    per shard and agrees with the same product through the twins on the
    CPU within 1e-4 + 1e-4·|twin|."""
    from _torch_parity import require_cuda
    from repro_torch.kernels.dequant import LAUNCHES
    from repro_torch.quant import quantize_params_tree
    dev = require_cuda()
    g = torch.Generator().manual_seed(k + n + m + nbits)
    w = torch.randn((k, n), generator=g) / k ** 0.5
    leaf = quantize_params_tree({"w": w}, nbits=nbits, packed=nbits == 4,
                                min_dim=1)
    tree = shard_params_tree(leaf, 4, min_dim=1)
    x = torch.randn((m, k), generator=g)
    want = dense(tree, x)
    on_card = {"w": {kk: v.to(dev) for kk, v in tree["w"].items()}}
    before = LAUNCHES[nbits]
    got = dense(on_card, x.to(dev))
    torch.cuda.synchronize()
    assert LAUNCHES[nbits] == before + 4
    bad = (got.cpu() - want).abs() > 1e-4 + 1e-4 * want.abs()
    assert not bool(bad.any())
