"""``models.param_axes`` / ``param_specs_tree`` held against the
reference's ``param_specs_tree(init_params(cfg, key))[1]``.

For every registered architecture (``reduced()``), the port's spec tree
equals the reference's, each ``PartitionSpec`` as a tuple, under the
single-pod rules and the multi-pod ones (an active mesh with a ``pod``
axis, as both packages' ``spec_for_axes`` read it).  The axes tree has
``init_params``'s structure, one name per dim of each leaf.  No ranks:
the reference's params are traced with ``jax.eval_shape``.
"""
import types

import pytest

from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_archs
from repro_torch.dist.sharding import default_rules, use_mesh
from repro_torch.models import (expert_specs, init_params, param_axes,
                                param_specs_tree)
from repro_torch.tree import tree_map

ARCHS = sorted(list_archs())


def _flat(tree):
    """[(path, spec tuple)] of a spec tree (dicts sorted, lists indexed)."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out.append((path, None if node is None else tuple(node)))
    walk(tree, ())
    return out


def _fake_mesh(multi_pod):
    return types.SimpleNamespace(axis_names=("pod", "data", "model")
                                 if multi_pod else ("data", "model"))


def _reference(arch, multi_pod):
    import jax
    from repro.configs import get_config
    from repro.dist.sharding import use_mesh as juse
    from repro.models import init_params as jinit
    from repro.models.transformer import param_specs_tree as jspecs
    cfg = get_config(arch).reduced()
    with juse(_fake_mesh(multi_pod)):
        px = jax.eval_shape(lambda k: jinit(cfg, k), jax.random.PRNGKey(0))
        _, specs = jspecs(px)
    return _flat(jax.tree.map(tuple, specs, is_leaf=lambda x: not
                              isinstance(x, (dict, list))))


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["single-pod", "multi-pod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tree_matches_reference(arch, multi_pod):
    want = _reference(arch, multi_pod)
    cfg = tget_config(arch).reduced()
    with use_mesh(_fake_mesh(multi_pod)):
        got = _flat(param_specs_tree(cfg))
    assert got == want
    assert _flat(param_specs_tree(cfg, default_rules(multi_pod))) == want
    assert len(want) >= 10


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_tree_has_the_params_structure(arch):
    """One logical name per dim of every leaf of ``init_params``."""
    cfg = tget_config(arch).reduced()
    params = init_params(cfg, 0, device="cpu")
    ndims = []
    tree_map(lambda p, ax: ndims.append((p.ndim, len(ax))), params,
             param_axes(cfg))
    assert ndims and all(a == b for a, b in ndims)
    assert len(_flat(param_axes(cfg))) == len(ndims)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "moonshot-v1-16b-a3b"])
def test_expert_specs_cut_only_the_expert_stacks(arch):
    """The expert-parallel cut: the stacked expert leaves split E over
    ``model`` (nothing else), the router and every other leaf whole."""
    cfg = tget_config(arch).reduced()
    got = dict(_flat(expert_specs(cfg, default_rules())))
    experts = {("layers", "moe", k) for k in ("w_gate", "w_up", "w_out")}
    assert experts <= set(got)
    for path, spec in got.items():
        if path in experts:
            assert spec == (None, "model", None, None), path
        else:
            assert spec is None, path
