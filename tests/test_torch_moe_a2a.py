"""The expert-parallel MoE (``moe_a2a``) on 4 gloo ranks, held against the
reference's local ``moe``.

One spawned launch of 4 rank processes runs ``layers.moe`` under
``REPRO_OPTS=moe_a2a`` on a ``(1, 4)`` and a ``(2, 2)`` mesh at the
reference test's sizes (E 8, k 2, d 32, ff 64, x (4, 8, 32), capacity
factor 8: no pair is dropped).  Each rank holds its rows of the batch
(its block along ``data``); its output and x-grad are compared with the
same rows of the reference's, and the router and expert grads, summed
across ``data`` as the train step's DP reduction does, with the
reference's ``jax.grad`` of ``moe(...).sum()``.  The expert leaves enter
whole (cut on entry) and as the rank's block of the stack (spec
``("model", None, None)``).  The reference's own a2a test is red on the
installed JAX (ROADMAP queue C); its criterion stands: within 1e-4 of the
largest output (grads: of their largest entry).  The gate's three
fall-backs (indivisible sequence, no ``model`` axis, inside
``manual_axes``) must take the local path: bits equal to the port's local
``moe``, no collective.

The same launch takes two f32 ``make_train_step`` steps of reduced
phi3.5-moe (4 experts, capacity factor 8) on the ``(1, 4)`` mesh, each
rank holding its block of the expert stacks (``models.expert_specs``),
against the same steps in one process on the whole tree: losses, grad
norms and params within 1e-5 (relative; params to each leaf's largest
value, at eps 1e-6 as in tests/test_torch_train.py), the replicated params
equal bit for bit across the ranks.  The step finds the blocks itself, so
every rank clips by the one global norm.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one intra-op thread, for the ranks too)
from repro_torch.dist.sharding import (HostMesh, NamedSharding, manual_axes,
                                       use_mesh)
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, global_batch_for_step
from repro_torch.launch.mesh import launch_ranks, make_host_mesh
from repro_torch.models import expert_specs, init_params
from repro_torch.models.layers import moe
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.tree import tree_leaves, tree_map

E, K, D, FF = 8, 2, 32, 64
CF = 8.0
B, S = 4, 8
RANKS = 4
MESHES = (4, 2)            # model_parallel: (1, 4) and (2, 2)
TOL = 1e-4
EXPERT_KEYS = ("w_gate", "w_up", "w_out")
STEP_CFG = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b").reduced(),
                               capacity_factor=CF)
STEP_OPT = AdamWConfig(lr=5e-3, total_steps=10, warmup_steps=1, eps=1e-6)
STEP_DATA = DataConfig(vocab=STEP_CFG.vocab, seq_len=8, global_batch=4)
STEPS = 2


def _train_steps(mesh=None) -> dict:
    """STEPS f32 steps of STEP_CFG from seed 0: on ``mesh`` each rank
    holds its block of the expert stacks, without one the whole tree."""
    params = init_params(STEP_CFG, 0, device="cpu")
    if mesh is not None:
        params = tree_map(lambda leaf, spec: leaf if spec is None else
                          NamedSharding(mesh, spec).block(leaf).clone(),
                          params, expert_specs(STEP_CFG))
    state = init_train_state(params)
    step = make_train_step(STEP_CFG, STEP_OPT, compute_dtype=torch.float32)
    out = {"loss": [], "grad_norm": []}
    for s in range(STEPS):
        batch = {k: torch.as_tensor(v) for k, v in
                 global_batch_for_step(STEP_DATA, s).items()}
        if mesh is None:
            state, m = step(state, batch)
        else:
            with use_mesh(mesh):
                state, m = step(state, batch)
        for k in out:
            out[k].append(float(m[k]))
    out["params"] = [t.detach().numpy().copy()
                     for t in tree_leaves(state.params)]
    return out


def _inputs():
    """The reference's ``moe_init`` tree (numpy) and x from a seed."""
    import jax
    from repro.models.layers import moe_init, split_tree
    p, _ = split_tree(moe_init(jax.random.PRNGKey(0), D, FF, E))
    p = jax.tree.map(np.asarray, p)
    x = np.random.default_rng(1).standard_normal((B, S, D)).astype(
        np.float32)
    return p, x


def _tensors(p, grad=True):
    return {"router": {"w": torch.tensor(p["router"]["w"],
                                          requires_grad=grad)},
            **{k: torch.tensor(p[k], requires_grad=grad)
               for k in EXPERT_KEYS}}


def _moe(p, x):
    return moe(p, x, n_experts=E, top_k=K, capacity_factor=CF)


def _run_a2a(mesh, p, x, blocks: bool) -> dict:
    """One forward and backward of the a2a path on this rank's rows."""
    dp, i = mesh.shape["data"], mesh.axis_index("data")
    rows = slice(i * B // dp, (i + 1) * B // dp)
    tp = _tensors(p)
    if blocks:
        cut = NamedSharding(mesh, ("model", None, None))
        for k in EXPERT_KEYS:
            tp[k] = cut.block(tp[k].detach()).clone().requires_grad_(True)
    xl = torch.tensor(x[rows], requires_grad=True)
    start = len(mesh.log)
    with use_mesh(mesh):
        y = _moe(tp, xl)
        y.sum().backward()
    ops = [op for op, *_ in mesh.log[start:]]
    leaves = {"router": tp["router"]["w"], **{k: tp[k] for k in EXPERT_KEYS}}
    grads = {k: mesh.all_reduce(v.grad, "data").numpy()
             for k, v in leaves.items()}
    return {"rows": (rows.start, rows.stop), "y": y.detach().numpy(),
            "x_grad": xl.grad.numpy(), "grads": grads, "ops": ops}


def _fallbacks(rank, mesh, p, x) -> dict:
    """The gate's local-path cases: (y, collectives logged) each, and the
    port's local ``moe`` on the same inputs outside any mesh."""
    tp = _tensors(p, grad=False)
    short = torch.tensor(x[:, :6])                # 6 % 4 != 0
    full = torch.tensor(x)
    no_model = HostMesh({"data": RANKS}, rank, {}, backend="gloo",
                        staging="none")
    out = {}
    for name, m, xx, manual in (("indivisible_seq", mesh, short, False),
                                ("no_model_axis", no_model, full, False),
                                ("manual_axes", mesh, full, True)):
        start = len(m.log)
        with use_mesh(m):
            if manual:
                with manual_axes(axis="model", shards=RANKS):
                    y = _moe(tp, xx)
            else:
                y = _moe(tp, xx)
        out[name] = (y.numpy(), len(m.log) - start, _moe(tp, xx).numpy())
    return out


def _rank(rank, p, x):
    os.environ["REPRO_OPTS"] = "moe_a2a"
    out = {}
    for mp in MESHES:
        mesh = make_host_mesh(model_parallel=mp)
        for blocks in (False, True):
            out[(mp, blocks)] = _run_a2a(mesh, p, x, blocks)
        if mp == RANKS:
            out["fallbacks"] = _fallbacks(rank, mesh, p, x)
            out["train"] = _train_steps(mesh)
    return out


_LAUNCH = {}


def _ranks():
    """Every rank's results of one 4-rank launch (a failed launch is kept
    and re-raised: one launch per module)."""
    if not _LAUNCH:
        p, x = _inputs()
        try:
            _LAUNCH["ok"] = launch_ranks(_rank, RANKS, (p, x), timeout_s=120)
        except Exception as e:
            _LAUNCH["err"] = e
    if "err" in _LAUNCH:
        raise _LAUNCH["err"]
    return _LAUNCH["ok"]


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's local ``moe`` output and ``jax.grad`` of its sum
    with respect to x and the params."""
    import jax
    import jax.numpy as jnp
    from repro.models.layers import moe as jmoe
    p, x = _inputs()

    def f(pp, xx):
        return jmoe(pp, xx, n_experts=E, top_k=K, capacity_factor=CF)
    y = np.asarray(f(p, jnp.asarray(x)))
    gp, gx = jax.grad(lambda pp, xx: f(pp, xx).sum(), argnums=(0, 1))(
        p, jnp.asarray(x))
    grads = {"router": np.asarray(gp["router"]["w"]),
             **{k: np.asarray(gp[k]) for k in EXPERT_KEYS}}
    return y, np.asarray(gx), grads


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("blocks", [False, True], ids=["whole", "blocks"])
@pytest.mark.parametrize("mp", MESHES, ids=["1x4", "2x2"])
def test_a2a_output_matches_the_reference_local_moe(mp, blocks):
    want, _, _ = _reference()
    for r in _ranks():
        got = r[(mp, blocks)]
        lo, hi = got["rows"]
        _close(got["y"], want[lo:hi], ("y", mp, blocks))


@pytest.mark.parametrize("blocks", [False, True], ids=["whole", "blocks"])
@pytest.mark.parametrize("mp", MESHES, ids=["1x4", "2x2"])
def test_a2a_grads_match_the_reference(mp, blocks):
    """x-grad of the rank's rows; the router grad (summed across model in
    the backward, across data here); each expert leaf's grad: whole on
    every rank when it entered whole, the rank's block otherwise."""
    _, want_gx, want = _reference()
    ranks = _ranks()
    for rank, r in enumerate(ranks):
        got = r[(mp, blocks)]
        lo, hi = got["rows"]
        _close(got["x_grad"], want_gx[lo:hi], ("x grad", mp, rank))
        _close(got["grads"]["router"], want["router"], ("router", mp, rank))
        j = rank % mp
        for k in EXPERT_KEYS:
            w = want[k][j * E // mp:(j + 1) * E // mp] if blocks else want[k]
            _close(got["grads"][k], w, (k, mp, blocks, rank))
    # a grad replicated across the ranks holds the same bits on each
    for k in ("router",) + (() if blocks else EXPERT_KEYS):
        assert all(np.array_equal(r[(mp, blocks)]["grads"][k],
                                  ranks[0][(mp, blocks)]["grads"][k])
                   for r in ranks), k


@pytest.mark.parametrize("mp", MESHES, ids=["1x4", "2x2"])
def test_a2a_collectives(mp):
    """Forward: the two all-to-alls and the gather on exit; backward: the
    two reverse all-to-alls, the gather of the x-grad on entry and the
    router's sum (the whole-stack run adds a gather per expert leaf)."""
    for r in _ranks():
        blk = r[(mp, True)]["ops"]
        assert sorted(blk) == sorted(["all_to_all"] * 4 + ["all_gather"] * 2
                                     + ["all_reduce_sum"]), blk
        whole = r[(mp, False)]["ops"]
        assert sorted(whole) == sorted(blk + ["all_gather"] * 3), whole


@pytest.mark.parametrize("case", ["indivisible_seq", "no_model_axis",
                                  "manual_axes"])
def test_gate_falls_back_to_the_local_path(case):
    for r in _ranks():
        y, n_collectives, local = r["fallbacks"][case]
        assert n_collectives == 0
        assert np.array_equal(y, local)


def test_ep_train_step_matches_one_process():
    want = _train_steps()
    specs = []
    tree_map(lambda _, spec: specs.append(spec),
             init_params(STEP_CFG, 0, device="cpu"), expert_specs(STEP_CFG))
    assert any(specs)
    ranks = _ranks()
    for rank, r in enumerate(ranks):
        got = r["train"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0)
        for i, (spec, a, b) in enumerate(zip(specs, got["params"],
                                             want["params"])):
            if spec is None:
                assert np.array_equal(a, ranks[0]["train"]["params"][i])
            else:
                d = spec.index("model")
                n = b.shape[d] // RANKS
                b = np.take(b, range(rank * n, (rank + 1) * n), axis=d)
            scale = max(float(np.abs(b).max()), 1.0)
            assert float(np.abs(a - b).max()) <= 1e-5 * scale, i
