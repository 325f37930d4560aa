"""The FSDP × TP train step (``models.fsdp_tp_layout`` /
``fsdp_tp_blocks``, ``dist.sharding.fsdp_gather`` / ``reduce_out``, the
tensor-parallel ``layers`` and the vocab-parallel ``loss_fn``) on 4 gloo
ranks laid out as a ``(data = 2, model = 2)`` mesh, held against the
one-process port step, the reference's ``make_train_step`` and the
``ShapeMesh`` trace of the cost counter.

Each rank holds its blocks of the params (``d_model_w`` over ``data``,
heads, ff and vocab over ``model``), steps on its half of every global
batch of 8 × 24 tokens in 2 microbatches, f32, three steps.  Cases, one
spawned launch for all:

* ``even``: the 2-layer dense model of tests/test_torch_train_mesh.py;
* ``uneven``: 3 heads and d_ff 63 over 2 ranks, padded to 4 heads (a
  whole zero head on rank 1) and 64 ff columns;
* ``mqa``: 4 q heads and 1 kv head: the kv head whole on both ranks;
* the registry's reduced whisper-base (encoder–decoder) and
  paligemma-3b (prefix-LM, 1 kv head).

Tolerances (f32, AdamW eps 1e-6 as in tests/test_torch_train.py):
losses within 1e-5 of the one-process step and of the reference (dense
cases); params, m and v within 1e-5 relative to each leaf's largest
value of the one-process step's, gathered from the ranks
(``fsdp_tp_gather``); the ranks' TP reorders each f32 sum into partials
over ``model``, the only difference.  Padded heads and ff columns stay
exactly zero.  Each rank's blocks equal its ``NamedSharding`` cut of the
gathered tree, and each rank's collective log of one step equals, op for
op, the log of the counter's trace of that rank's step on ``meta``
tensors under ``ShapeMesh(data=2, model=2)``.
"""
import functools

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one intra-op thread, for the ranks too)
from _torch_parity import (assert_trees_close, rescale_fan_in, to_numpy,
                           tree_leaves)
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.dist.sharding import (NamedSharding, ShapeMesh, use_layout,
                                       use_mesh)
from repro_torch.launch.hlo_cost import count_costs
from repro_torch.launch.mesh import launch_ranks, make_host_mesh
from repro_torch.models import (fsdp_tp_blocks, fsdp_tp_gather,
                                fsdp_tp_layout, from_jax_params,
                                init_params)
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.tree import tree_map

TOL = 1e-5
RANKS = 4
STEPS = 3
N_MICRO = 2
BATCH, SEQ = 8, 24
F32_KW = dict(lr=5e-3, total_steps=150, warmup_steps=1, eps=1e-6)
DENSE = dict(family="dense", n_layers=2, d_model=32, vocab=64, head_dim=16)
CASES = {
    "even": dict(DENSE, name="even", n_heads=2, n_kv=2, d_ff=64),
    "uneven": dict(DENSE, name="uneven", n_heads=3, n_kv=3, d_ff=63),
    "mqa": dict(DENSE, name="mqa", n_heads=4, n_kv=1, d_ff=64),
    "whisper": "whisper-base",
    "paligemma": "paligemma-3b",
}


def _tcfg(case):
    spec = CASES[case]
    if isinstance(spec, str):
        return get_config(spec).reduced()
    return TArchConfig(**spec)


def _jcfg(case):
    from repro.configs import get_config as jget
    from repro.configs.base import ArchConfig
    spec = CASES[case]
    if isinstance(spec, str):
        return jget(spec).reduced()
    return ArchConfig(**spec)


@functools.lru_cache(maxsize=None)
def _base(case):
    """The reference's init_params (numpy), stacked weights rescaled."""
    import jax
    from repro.models import init_params as jinit, split_tree
    base = to_numpy(split_tree(jinit(_jcfg(case),
                                     jax.random.PRNGKey(0)))[0])
    return {k: rescale_fan_in(v) if k in ("layers", "enc_layers",
                                          "dec_layers") else v
            for k, v in base.items()}


def _batch(case, step):
    """A global batch of ``BATCH`` rows from a seed (numpy): tokens and
    targets, and the family's frames / patches."""
    cfg = _tcfg(case)
    rng = np.random.default_rng(100 + step)
    text = SEQ
    out = {}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (BATCH, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
    out["tokens"] = rng.integers(0, cfg.vocab, (BATCH, text), np.int32)
    out["targets"] = rng.integers(0, cfg.vocab, (BATCH, text), np.int32)
    return out


def _rows(batch, mesh):
    """This rank's rows of a global batch: its block along ``data``."""
    n, i = mesh.shape["data"], mesh.axis_index("data")
    per = BATCH // n
    return {k: torch.as_tensor(v[i * per:(i + 1) * per])
            for k, v in batch.items()}


def _step(case):
    return make_train_step(_tcfg(case), AdamWConfig(**F32_KW),
                           n_micro=N_MICRO, compute_dtype=torch.float32)


def _rank(rank, bases, batches):
    """Every case on the (data = 2, model = 2) mesh: STEPS steps on this
    rank's blocks; (losses, blocks, gathered state, ops of step 1)."""
    mesh = make_host_mesh(model_parallel=2)
    out = {}
    for case in CASES:
        cfg = _tcfg(case)
        lay = fsdp_tp_layout(cfg, mesh)
        full = from_jax_params(bases[case], "cpu")
        state = init_train_state(fsdp_tp_blocks(cfg, full, lay))
        step = _step(case)
        losses, log = [], None
        with use_mesh(mesh), use_layout(lay):
            for s in range(STEPS):
                start = len(mesh.log)
                state, m = step(state, _rows(batches[case][s], mesh))
                losses.append(float(m["loss"]))
                if log is None:
                    log = list(mesh.log[start:])
            gathered = [fsdp_tp_gather(cfg, t, lay)
                        for t in (state.params, state.opt.m, state.opt.v)]
        out[case] = (losses, to_numpy(state.params), to_numpy(gathered), log)
    return out


_LAUNCH = {}


def _ranks():
    if not _LAUNCH:
        try:
            _LAUNCH["ok"] = launch_ranks(
                _rank, RANKS,
                ({c: _base(c) for c in CASES},
                 {c: [_batch(c, s) for s in range(STEPS)] for c in CASES}),
                timeout_s=180)
        except Exception as e:
            _LAUNCH["err"] = e
    if "err" in _LAUNCH:
        raise _LAUNCH["err"]
    return _LAUNCH["ok"]


@functools.lru_cache(maxsize=None)
def _oracle(case):
    """The one-process port step over the whole batches: (losses,
    (params, m, v) as numpy)."""
    state = init_train_state(from_jax_params(_base(case), "cpu"))
    step = _step(case)
    losses = []
    for s in range(STEPS):
        batch = {k: torch.as_tensor(v) for k, v in _batch(case, s).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, to_numpy([state.params, state.opt.m, state.opt.v])


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_match_the_one_process_step(case):
    want_losses, want = _oracle(case)
    for rank, out in enumerate(_ranks()):
        losses, _, gathered, _ = out[case]
        np.testing.assert_allclose(losses, want_losses, rtol=TOL, atol=TOL,
                                   err_msg=f"rank {rank}")
        assert_trees_close(gathered, want, tol=TOL, relative=True)


@pytest.mark.parametrize("case", ["even", "uneven", "mqa"])
def test_ranks_match_the_reference_loss(case):
    """The reference's jitted one-device ``make_train_step`` on the same
    numpy weights and batches: the losses of every step."""
    import jax
    import jax.numpy as jnp
    from repro.train import AdamWConfig as JAdamWConfig
    from repro.train import TrainState, adamw_init
    from repro.train import make_train_step as jmake
    params = jax.tree.map(jnp.asarray, _base(case))
    state = TrainState(params, adamw_init(params), None)
    step = jax.jit(jmake(_jcfg(case), JAdamWConfig(**F32_KW),
                         n_micro=N_MICRO, compute_dtype=jnp.float32))
    want = []
    for s in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in _batch(case, s).items()})
        want.append(float(m["loss"]))
    got = _ranks()[0][case][0]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_blocks_are_the_named_sharding_cuts_of_the_gathered_tree(case):
    """Each rank's blocks are its cut of the padded tree the ranks
    gather; the padding (zero heads, zero ff columns) stays zero."""
    cfg = _tcfg(case)
    ranks = _ranks()
    params = ranks[0][case][2][0]
    for rank, out in enumerate(ranks):
        mesh = ShapeMesh({"data": 2, "model": 2}, rank=rank)
        lay = fsdp_tp_layout(cfg, mesh)
        want = tree_map(lambda x, spec: NamedSharding(mesh, spec).block(x),
                        _padded(cfg, lay, params), lay.specs)
        for got, exp in zip(tree_leaves(out[case][1]), tree_leaves(want)):
            np.testing.assert_array_equal(got, exp.numpy())


def _padded(cfg, lay, params):
    """The whole padded tree of numpy ``params`` (``fsdp_tp_blocks``
    before its cut, on a one-rank view)."""
    from repro_torch.models.transformer import _repad
    return _repad(cfg, lay, tree_map(torch.as_tensor, params),
                  inverse=False)


def test_padding_stays_zero():
    """The uneven case's zero head (columns 48..63 of wq, wk, wv; rows of
    wo) and zero ff column stay exactly zero through the steps."""
    ranks = _ranks()
    for rank in (1, 3):                         # model coordinate 1
        blk = ranks[rank]["uneven"][1]["layers"]
        assert blk["attn"]["wq"]["w"].shape[-1] == 32
        for name in ("wq", "wk", "wv"):
            assert not blk["attn"][name]["w"][..., 16:].any()
        assert not blk["attn"]["wo"]["w"][:, 16:, :].any()
        for name in ("w_gate", "w_up"):
            assert not blk["mlp"][name]["w"][..., -1].any()
        assert not blk["mlp"]["w_out"]["w"][:, -1, :].any()


@pytest.mark.parametrize("case", list(CASES))
def test_collective_log_equals_the_shape_mesh_trace(case):
    """One step's collectives on each rank equal, op for op, those the
    cost counter logs tracing that rank's step on meta tensors."""
    cfg = _tcfg(case)
    for rank, out in enumerate(_ranks()):
        mesh = ShapeMesh({"data": 2, "model": 2}, rank=rank)
        lay = fsdp_tp_layout(cfg, mesh)
        blocks = fsdp_tp_blocks(cfg, init_params(cfg, device="meta"), lay)
        state = init_train_state(blocks)
        batch = {k: torch.empty(v[:BATCH // 2].shape,
                                dtype=torch.as_tensor(v).dtype,
                                device="meta")
                 for k, v in _batch(case, 0).items()}
        with use_mesh(mesh), use_layout(lay):
            costs = count_costs(_step(case), state, batch, mesh=mesh)
        assert list(mesh.log) == list(out[case][3])
        assert costs.n_collectives == _count(out[case][3])


def _count(log):
    out = {}
    for op, *_ in log:
        out[op] = out.get(op, 0) + 1
    return out
