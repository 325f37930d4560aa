"""Elastic restore: a checkpoint written by one process restores onto a
``(2, 2)`` mesh of 4 gloo ranks (one spawned launch) with
``param_specs_tree``'s specs (the port's counterpart of
``tests/test_elastic_restore.py``, whose subprocess is red on the
installed JAX).

Reduced minicpm-2b is saved once by the port and once by the JAX package
(the reference's ``save_checkpoint`` of its ``init_params``); each rank
restores both through ``restore_checkpoint(shardings=...)`` and must hold
exactly the numpy slice of every leaf that its spec and its mesh
coordinate give (computed here, apart from ``NamedSharding``), with at
least one leaf really cut; the 4 ranks' blocks put back together equal
the saved tree bit for bit.  A ``None`` sharding leaf (``ln_f``) comes
back whole.
"""
import functools

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (one intra-op thread, for the ranks too)
from _torch_parity import to_numpy
from repro_torch.configs import get_config
from repro_torch.dist.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.dist.sharding import NamedSharding, default_rules, use_mesh
from repro_torch.launch.mesh import launch_ranks, make_host_mesh
from repro_torch.models import init_params, param_specs_tree
from repro_torch.tree import (tree_leaves_with_path, tree_map,
                               tree_map_with_path)

RANKS = 4
CFG = get_config("minicpm-2b").reduced()


def _rank(rank, dirs):
    mesh = make_host_mesh(model_parallel=2)       # (data = 2, model = 2)
    template = init_params(CFG, 1, device="cpu")
    with use_mesh(mesh):
        specs = param_specs_tree(CFG)
    shardings = tree_map(lambda _, s: NamedSharding(mesh, s), template,
                         specs)
    shardings["ln_f"] = None
    out = {"coord": (mesh.axis_index("data"), mesh.axis_index("model"))}
    for name, d in dirs.items():
        state, manifest = restore_checkpoint(d, template,
                                             shardings=shardings)
        out[name] = (manifest["step"],
                     {k: v.numpy() for k, v in
                      tree_leaves_with_path(state)})
    return out


@functools.lru_cache(maxsize=None)
def _saved(tmp):
    """{name: (dir, {leaf path: saved numpy value})}: the port's params
    saved at step 7, the reference's at step 9."""
    import jax
    from repro.dist.checkpoint import save_checkpoint as jsave
    from repro.configs import get_config as jget
    from repro.models import init_params as jinit, split_tree
    port = init_params(CFG, 0, device="cpu")
    save_checkpoint(f"{tmp}/port", 7, port)
    ref, _ = split_tree(jinit(jget("minicpm-2b").reduced(),
                              jax.random.PRNGKey(0)))
    jsave(f"{tmp}/ref", 9, ref)
    return {"port": (f"{tmp}/port", dict(tree_leaves_with_path(
        to_numpy(port)))),
            "ref": (f"{tmp}/ref", dict(tree_leaves_with_path(
                to_numpy(ref))))}


_LAUNCH = {}


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    saved = _saved(str(tmp_path_factory.mktemp("elastic")))
    if not _LAUNCH:
        try:
            _LAUNCH["ok"] = launch_ranks(
                _rank, RANKS, ({k: v[0] for k, v in saved.items()},),
                timeout_s=120)
        except Exception as e:
            _LAUNCH["err"] = e
    if "err" in _LAUNCH:
        raise _LAUNCH["err"]
    return saved, _LAUNCH["ok"]


@functools.lru_cache(maxsize=None)
def _specs():
    """{leaf path: spec} of the single-pod rules."""
    out = {}
    tree_map_with_path(lambda path, _, spec: out.__setitem__(path, spec),
                       init_params(CFG, 0, device="cpu"),
                       param_specs_tree(CFG, default_rules()))
    return out


def _want_block(full, spec, coord):
    """The slice of ``full`` that ``spec`` gives the rank at ``coord``
    (data, model) of the (2, 2) mesh."""
    idx = []
    for dim, entry in zip(full.shape, tuple(spec) + (None,) * full.ndim):
        names = () if entry is None else ((entry,) if isinstance(entry, str)
                                          else tuple(entry))
        n, c = 1, 0
        for a in names:
            n, c = n * 2, c * 2 + coord[("data", "model").index(a)]
        idx.append(slice(c * dim // n, (c + 1) * dim // n))
    return full[tuple(idx)]


@pytest.mark.parametrize("name,step", [("port", 7), ("ref", 9)])
def test_each_rank_holds_its_blocks(restored, name, step):
    saved, ranks = restored
    values = saved[name][1]
    specs = _specs()
    cut = 0
    for r in ranks:
        got_step, leaves = r[name]
        assert got_step == step
        assert set(leaves) == set(values)
        for path, block in leaves.items():
            full = values[path]
            if path.startswith("['ln_f']"):
                want = full                        # a None sharding leaf
            else:
                want = _want_block(full, specs[path], r["coord"])
            assert block.dtype == full.dtype and block.shape == want.shape
            assert np.array_equal(block, want), (path, r["coord"])
            cut += block.size < full.size
    assert cut > 0


@pytest.mark.parametrize("name", ["port", "ref"])
def test_blocks_put_together_equal_the_saved_tree(restored, name):
    saved, ranks = restored
    values = saved[name][1]
    specs = _specs()
    for path, full in values.items():
        back = np.zeros_like(full)
        seen = np.zeros(full.shape, bool)
        for r in ranks:
            block = r[name][1][path]
            if block.shape == full.shape:
                assert np.array_equal(block, full)
                continue
            idx = np.indices(full.shape)
            sel = tuple(_want_block(i, specs[path], r["coord"])
                        for i in idx)
            back[sel] = block
            seen[sel] = True
        if seen.any():
            assert seen.all(), path
            assert back.tobytes() == full.tobytes(), path
