"""Training on a mesh of ranks (``train.make_compressed_step``,
``make_train_step`` under a DP mesh, ``launch.train --ranks``) held
against the JAX package on the 2-layer model of
``tests/test_train_loop.py`` (weights as in tests/test_torch_train.py).

Tolerances, each against the reference (tests/test_torch_train.py's):

* f32 steps: losses and params, m, v within 1e-5 (rtol = atol; params,
  m and v relative to each leaf's largest value), at eps 1e-6;
* the compressed step on the ``(1, 1)`` mesh against the reference's
  ``make_compressed_step`` on its ``(1, 1)`` mesh: three f32 steps, and
  on 4 gloo ranks (one spawned launch) against the reference's pieces
  composed: per-shard ``jax.value_and_grad(loss_fn)``, the vmapped
  ``compressed_psum_tree`` and ``adamw_update``; every rank's params, m
  and v equal bit for bit (each error buffer is its rank's residual).
  Here the f32 tolerance holds for all entries but those where the two
  packages' grads, equal to f32
  rounding, fall on the two sides of an int8 code boundary (``rint`` of
  g/scale near a half): there the grad moves by one code step,
  max|g|/127.  Such entries must be at most 0.5 % of a leaf (0.02–0.06 %
  seen), and each stays within the bound a one-code difference allows:
  params 2·lr per step (the Adam direction flips at most from +1 to −1),
  m within 1e-2 and v within 2e-2 of the leaf's largest value ((1 − b1)
  and (1 − b2)·2|g| times a code step), error buffers within one code
  step (2.5× the leaf's largest error);
* ``make_train_step`` under the same 4-rank mesh (each rank on its
  quarter of the batch, cut by the driver's ``device_batch`` with
  ``n_hosts = 4``, grads averaged by ``all_reduce``) against the
  reference's jitted one-device step over the whole batch: f32, three
  steps, the ranks' states equal bit for bit;
* the reference test's own property: 120 compressed steps, the windowed
  loss falls by 0.02 and the error buffers are non-zero;
* ``launch.train --ranks 2 --device cpu`` stopped at step 3 and resumed
  equals the uninterrupted 2-rank run bit for bit, and each rank of the
  uninterrupted run stepped on its own half of every step's global batch
  (its rows recorded where the driver fetches them: the two halves in
  rank order are the global batch);
* the same checkpoint resumed on one process (another N: the elastic
  restart) against the uninterrupted 2-rank run.  The driver computes in
  bf16 at AdamW's default eps 1e-8, as the reference's does (neither can
  be changed from its command line), so the f32 tolerance above cannot
  hold: the mean of two half-batch bf16 grads rounds otherwise than one
  whole-batch grad (2**-8 relative), and at eps 1e-8 grads at rounding
  level get Adam directions of order one (tests/test_torch_train.py).
  Held instead: each step's logged loss within 1e-2 relative, params
  within 1e-2 and m, v within 5e-2 of each leaf's largest value (seen:
  4.6e-3, and 1.8e-2 and 2.3e-2: a few bf16 rounding steps).  A resume
  that steps on other rows (the first two only) lands 0.34–0.93 of the
  leaf's largest value away in m and v, and up to 8.8e-2 in the params.
"""
import dataclasses
import functools
import os
import re
import shutil

import numpy as np
import torch

import _torch_parity  # noqa: F401  (one intra-op thread, for the ranks too)
from _torch_parity import (assert_trees_close, rescale_fan_in, to_numpy,
                           tree_leaves)
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.data import DataConfig, global_batch_for_step
from repro_torch.dist.checkpoint import read_manifest
from repro_torch.dist.sharding import use_mesh
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import launch_ranks, make_host_mesh
from repro_torch.models import from_jax_params
from repro_torch.train import (AdamWConfig, init_train_state,
                               make_compressed_step, make_train_step)

CFG = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=2,
           n_kv=2, d_ff=64, vocab=64, head_dim=16)
TCFG = TArchConfig(**CFG)
DCFG = DataConfig(vocab=64, seq_len=24, global_batch=8)
TOL = 1e-5
RANKS = 4
STEPS = 3
F32_KW = dict(lr=5e-3, total_steps=150, warmup_steps=1, eps=1e-6)


def _jcfg():
    from repro.configs.base import ArchConfig
    return ArchConfig(**CFG)


@functools.lru_cache(maxsize=None)
def _base(seed=0):
    """The reference's init_params (numpy), stacked weights rescaled."""
    import jax
    from repro.models import init_params, split_tree
    base = to_numpy(split_tree(init_params(_jcfg(),
                                           jax.random.PRNGKey(seed)))[0])
    return {**base, "layers": rescale_fan_in(base["layers"])}


def _tbatch(step):
    return {k: torch.as_tensor(v)
            for k, v in global_batch_for_step(DCFG, step).items()}


def _jbatch(step):
    import jax.numpy as jnp
    return {k: jnp.asarray(v)
            for k, v in global_batch_for_step(DCFG, step).items()}


def _steps(step, state, n):
    losses = []
    for s in range(n):
        state, m = step(state, _tbatch(s))
        losses.append(float(m["loss"]))
    return losses, state


def _rank(rank, base):
    """On the 4-rank (data = 4, model = 1) mesh: STEPS compressed f32
    steps, then STEPS f32 ``make_train_step`` steps from the same params;
    (losses, state as numpy) of each."""
    mesh = make_host_mesh()
    out = {}
    with use_mesh(mesh):
        state = init_train_state(from_jax_params(base, "cpu"),
                                 use_compression=True)
        step = make_compressed_step(TCFG, AdamWConfig(**F32_KW), mesh,
                                    compute_dtype=torch.float32)
        losses, state = _steps(step, state, STEPS)
        out["compressed"] = (losses, to_numpy(state),
                             [op for op, *_ in mesh.log])
        start = len(mesh.log)
        dcfg = dataclasses.replace(DCFG, n_hosts=RANKS)
        state = init_train_state(from_jax_params(base, "cpu"))
        step = make_train_step(TCFG, AdamWConfig(**F32_KW),
                               compute_dtype=torch.float32)
        losses = []
        for s in range(STEPS):
            batch = launch_train.device_batch(dcfg, s, "cpu", rank)
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        out["dp"] = (losses, to_numpy(state),
                     [op for op, *_ in mesh.log[start:]])
    return out


_LAUNCH = {}


def _ranks():
    if not _LAUNCH:
        try:
            _LAUNCH["ok"] = launch_ranks(_rank, RANKS, (_base(0),),
                                         timeout_s=120)
        except Exception as e:
            _LAUNCH["err"] = e
    if "err" in _LAUNCH:
        raise _LAUNCH["err"]
    return _LAUNCH["ok"]


@functools.lru_cache(maxsize=None)
def _ref_composed():
    """The reference's pieces on 4 shards of each batch: per-shard
    ``value_and_grad(loss_fn)`` of the f32 params, the vmapped
    ``compressed_psum_tree`` over ``data`` and ``adamw_update``."""
    import jax
    import jax.numpy as jnp
    from repro.models import loss_fn
    from repro.train import AdamWConfig as JAdamWConfig
    from repro.train import adamw_init, adamw_update
    from repro.train.grad_compress import compressed_psum_tree, \
        init_error_buf
    cfg, opt = _jcfg(), JAdamWConfig(**F32_KW)
    params = jax.tree.map(jnp.asarray, _base(0))
    ost, err = adamw_init(params), init_error_buf(params)
    err = jax.tree.map(lambda e: jnp.stack([e] * RANKS), err)
    vg = jax.value_and_grad(lambda p, b: loss_fn(cfg, p, b))
    psum = jax.vmap(lambda g, e: compressed_psum_tree(g, e, ("data",)),
                    axis_name="data")
    losses = []
    for s in range(STEPS):
        batch = _jbatch(s)
        shards = [vg(params, {k: v[r * 2:r * 2 + 2] for k, v in
                              batch.items()}) for r in range(RANKS)]
        grads = jax.tree.map(lambda *g: jnp.stack(g),
                             *[g for _, g in shards])
        mean, err = psum(grads, err)
        mean = jax.tree.map(lambda g: g[0], mean)
        params, ost, _ = adamw_update(opt, params, mean, ost)
        losses.append(float(np.mean([float(l) for l, _ in shards])))
    return losses, params, ost, err


def _ref_steps(n, compressed):
    """The reference's jitted one-device step (or its compressed step on
    the (1, 1) mesh) from the base params: (losses, final state)."""
    import jax
    import jax.numpy as jnp
    from repro.train import AdamWConfig as JAdamWConfig
    from repro.train import (TrainState, adamw_init, make_compressed_step
                             as jcompressed, make_train_step as jmake)
    from repro.train.grad_compress import init_error_buf
    params = jax.tree.map(jnp.asarray, _base(0))
    opt = JAdamWConfig(**F32_KW)
    if compressed:
        state = TrainState(params, adamw_init(params),
                           init_error_buf(params))
        step = jcompressed(_jcfg(), opt, jax.make_mesh((1, 1),
                                                       ("data", "model")),
                           compute_dtype=jnp.float32)
    else:
        state = TrainState(params, adamw_init(params), None)
        step = jax.jit(jmake(_jcfg(), opt, compute_dtype=jnp.float32))
    losses = []
    for s in range(n):
        state, m = step(state, _jbatch(s))
        losses.append(float(m["loss"]))
    return losses, state


def _assert_state_close(got, want):
    assert_trees_close(got.params, want.params, tol=TOL, relative=True)
    assert_trees_close((got.opt.m, got.opt.v), (want.opt.m, want.opt.v),
                       tol=TOL, relative=True)


#: the share of a leaf's entries that one int8 code step may separate
FLIP_SHARE = 5e-3


def _close_but_code_steps(got, want, bound):
    """Leaves within the f32 tolerance except on at most FLIP_SHARE of
    the entries, which stay within ``bound(leaf)`` (module docstring)."""
    la, lb = tree_leaves(got), tree_leaves(want)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = (np.asarray(t, np.float64) for t in (x, y))
        scale = max(float(np.abs(y).max(initial=0.0)), 1.0)
        off = ~np.isclose(x, y, rtol=TOL, atol=TOL * scale)
        assert off.mean() <= FLIP_SHARE, (off.sum(), off.size)
        assert np.all(np.abs(x - y) <= bound(y)), np.abs(x - y).max()


def _assert_compressed_close(got, want_params, want_m, want_v, want_err):
    lr = F32_KW["lr"]
    _close_but_code_steps(got.params, want_params, lambda y: 2 * lr * STEPS)
    _close_but_code_steps(got.opt.m, want_m,
                          lambda y: 1e-2 * np.abs(y).max())
    _close_but_code_steps(got.opt.v, want_v,
                          lambda y: 2e-2 * np.abs(y).max())
    _close_but_code_steps(got.err, want_err,
                          lambda y: 2.5 * np.abs(y).max())


def test_compressed_step_on_one_rank_matches_reference():
    """The ``(1, 1)`` mesh of one process (no process group): three f32
    compressed steps against the reference's on its (1, 1) mesh."""
    want_l, want = _ref_steps(STEPS, compressed=True)
    mesh = make_host_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    state = init_train_state(from_jax_params(_base(0), "cpu"),
                             use_compression=True)
    step = make_compressed_step(TCFG, AdamWConfig(**F32_KW), mesh,
                                compute_dtype=torch.float32)
    got_l, got = _steps(step, state, STEPS)
    np.testing.assert_allclose(got_l, want_l, rtol=TOL, atol=TOL)
    _assert_compressed_close(got, want.params, want.opt.m, want.opt.v,
                             want.err)
    assert mesh.log == []                        # nothing crossed


def test_compressed_step_trains_with_error_feedback():
    """The reference test's property on the port: 120 steps at the
    default bf16 compute, the windowed loss falls by 0.02 and the error
    buffers are used."""
    import jax
    from repro.models import init_params, split_tree
    mesh = make_host_mesh()
    opt = AdamWConfig(lr=5e-3, total_steps=120, warmup_steps=10)
    params = from_jax_params(to_numpy(split_tree(init_params(
        _jcfg(), jax.random.PRNGKey(2)))[0]), "cpu")
    state = init_train_state(params, use_compression=True)
    step = make_compressed_step(TCFG, opt, mesh)
    losses, state = _steps(step, state, 120)
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.02
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(state.err))


def test_compressed_step_on_four_ranks_matches_reference_pieces():
    want_l, params, ost, err = _ref_composed()
    ranks = _ranks()
    for r, out in enumerate(ranks):
        losses, state, ops = out["compressed"]
        np.testing.assert_allclose(losses, want_l, rtol=TOL, atol=TOL)
        _assert_compressed_close(state, params, ost.m, ost.v,
                                 _index_tree(err, r))
        n_leaves = len(tree_leaves(state.params))
        assert ops.count("all_reduce_sum") == STEPS * (n_leaves + 1)
        assert ops.count("all_reduce_max") == STEPS * n_leaves
    # params, m and v are replicated; each error buffer is its rank's own
    # residual of its own grads
    first = tree_leaves(ranks[0]["compressed"][1][:2])
    for out in ranks[1:]:
        assert all(np.array_equal(a, b) for a, b in
                   zip(first, tree_leaves(out["compressed"][1][:2])))


def _index_tree(tree, r):
    import jax
    return jax.tree.map(lambda x: np.asarray(x[r]), tree)


def test_dp_train_step_on_four_ranks_matches_the_full_batch_step():
    want_l, want = _ref_steps(STEPS, compressed=False)
    ranks = _ranks()
    for out in ranks:
        losses, state, ops = out["dp"]
        np.testing.assert_allclose(losses, want_l, rtol=TOL, atol=TOL)
        _assert_state_close(state, want)
        n_leaves = len(tree_leaves(state.params))
        assert ops == ["all_reduce_sum"] * (STEPS * (n_leaves + 1))
    first = tree_leaves(ranks[0]["dp"][1])
    for out in ranks[1:]:
        assert all(np.array_equal(a, b) for a, b in
                   zip(first, tree_leaves(out["dp"][1])))


def _final_leaves(ckpt, step):
    d = os.path.join(ckpt, f"step_{step:08d}")
    return [(rec["key"], np.load(os.path.join(d, rec["file"])))
            for rec in read_manifest(ckpt, step)["leaves"]]


def _logged_losses(out: str) -> dict:
    """{step: loss} of the driver's log lines."""
    return {int(s): float(x) for s, x in
            re.findall(r"^step\s+(\d+) loss (\S+)", out, re.M)}


def _recording_rank(rank, argv, n_ranks):
    """``launch.train``'s rank body (what ``main`` spawns for ``--ranks``)
    with its batch fetch recording each step's rows."""
    fetch, seen = launch_train.device_batch, []

    def recorded(*args, **kwargs):
        batch = fetch(*args, **kwargs)
        seen.append({k: v.numpy().copy() for k, v in batch.items()})
        return batch
    launch_train.device_batch = recorded
    launch_train.train_rank(rank, argv, n_ranks)
    return seen


def test_launch_train_ranks_resumes_bit_for_bit(tmp_path, capfd):
    argv = ["--arch", "minicpm-2b", "--reduced", "--steps", "6",
            "--batch", "4", "--seq", "16", "--save-every", "10",
            "--ranks", "2", "--device", "cpu", "--log-every", "1"]
    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    seen = launch_ranks(_recording_rank, 2, (argv + ["--ckpt", full], 2),
                        timeout_s=120)
    want_l = _logged_losses(capfd.readouterr().out)
    assert sorted(want_l) == list(range(6))
    # each rank stepped on its half of the global batch
    dcfg = DataConfig(vocab=get_config("minicpm-2b").reduced().vocab,
                      seq_len=16, global_batch=4)
    for s in range(6):
        want = global_batch_for_step(dcfg, s)
        for k, v in want.items():
            assert all(r[s][k].shape[0] == 2 for r in seen)
            assert np.array_equal(
                np.concatenate([r[s][k] for r in seen]), v), (s, k)
    launch_train.main(argv + ["--ckpt", cut, "--stop-at", "3"])
    launch_train.main(argv + ["--ckpt", cut])
    out = capfd.readouterr().out
    assert "restored step 3" in out
    a, b = _final_leaves(full, 6), _final_leaves(cut, 6)
    assert len(a) == len(b) and all(np.array_equal(x, y)
                                    for (_, x), (_, y) in zip(a, b))
    # elastic: the step-3 checkpoint resumed on one process
    one = str(tmp_path / "one")
    shutil.copytree(os.path.join(cut, "step_00000003"),
                    os.path.join(one, "step_00000003"))
    one_argv = [x for x in argv if x not in ("--ranks", "2")]
    launch_train.main(one_argv + ["--ckpt", one])
    got_l = _logged_losses(capfd.readouterr().out)
    assert sorted(got_l) == [3, 4, 5]
    for s, loss in got_l.items():
        assert abs(loss - want_l[s]) <= 1e-2 * abs(want_l[s]), (s, loss)
    c = _final_leaves(one, 6)
    for (key, x), (_, y) in zip(c, a):
        if x.dtype == np.float32 and x.ndim:
            tol = 1e-2 if key.startswith(".params") else 5e-2
            scale = float(np.abs(y).max())
            assert float(np.abs(x - y).max()) <= tol * scale, key
        else:
            assert np.array_equal(x, y), key


def test_tree_checksum_sees_one_flipped_bit():
    """``dist.fault.tree_checksum``: equal trees give equal digests; one
    bit flipped in any leaf (f32, bf16, int32, a 0-d step) changes them,
    and so do entries swapped within a row or rotated around a 2 x 2
    square."""
    from repro_torch.dist.fault import tree_checksum
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((5, 7), generator=g),
            "h": torch.randn((3, 4), generator=g).to(torch.bfloat16),
            "i": torch.arange(6, dtype=torch.int32),
            "step": torch.tensor(3, dtype=torch.int32)}
    base = tree_checksum(tree)
    assert torch.equal(base, tree_checksum({k: v.clone()
                                            for k, v in tree.items()}))
    for key in tree:
        other = {k: v.clone() for k, v in tree.items()}
        bits = other[key].view({4: torch.int32, 2: torch.int16}[
            other[key].element_size()]).reshape(-1)
        bits[-1] ^= 1
        assert not torch.equal(base, tree_checksum(other)), key
    # order: two unequal entries of a row swapped, and the four entries of
    # a 2 x 2 square rotated
    w = tree["w"]
    for swap in ([(0, 0), (0, 1)], [(0, 0), (1, 1), (0, 1), (1, 0)]):
        other = dict(tree, w=w.clone())
        src = swap[1:] + swap[:1]
        for (i, j), (k, l) in zip(swap, src):
            other["w"][i, j] = w[k, l]
        assert not torch.equal(base, tree_checksum(other)), swap
