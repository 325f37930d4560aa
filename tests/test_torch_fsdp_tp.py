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
  paligemma-3b (prefix-LM, 1 kv head);
* ``moe``: reduced moonshot-v1-16b-a3b (4 experts, top 2, capacity
  factor 1.25: pairs are dropped), its experts cut over ``model``;
* ``moe_a2a``: the same under ``REPRO_OPTS=moe_a2a`` (the all-to-all
  expert parallelism inside the layout) at capacity factor E / top_k,
  where no pair is dropped;
* ``rwkv``: reduced rwkv6-7b (ssm), its WKV heads cut over ``model``;
* ``rgemma``: reduced recurrentgemma-2b at 5 layers (hybrid: one (rec,
  rec, attn) group and a 2-layer tail), its RG-LRU width cut over
  ``model``, its attention MQA.

A MoE layer routes the rows of one call together (capacity and drops
depend on them), so the one-process step of the MoE cases runs
``data`` × the ranks' ``N_MICRO`` microbatches: each of its calls then
sees exactly the rows that one rank's call sees
(``train.microbatch_grads`` cuts contiguous rows).

Tolerances (f32, AdamW eps 1e-6 as in tests/test_torch_train.py):
losses within 1e-5 of the one-process step and of the reference (every
case but the encoder–decoder and prefix-LM ones); params, m and v within
1e-5 relative to each leaf's largest value of the one-process step's,
gathered from the ranks (``fsdp_tp_gather``); the ranks' TP reorders
each sum into partials over ``model``, the only difference.  The
``moe_a2a``, ``rwkv`` and ``rgemma`` cases run in float64 (params and
compute; the models keep their own f32 steps: the loss, the norms, the
WKV recurrence, the RG-LRU gates, the router): in f32 their three Adam
steps carry the reordered sums' rounding to 2–4e-5 in a few params, in
float64 to at most 7e-6, the WKV's f32 steps aside.  The ``rwkv`` params
are held within 1e-5 plus twice the largest change that the one-process
step itself makes to any of them between its two microbatch splits (1
and 2 rows per call, float64): 1.2e-5, so no reordering of its sums
meets 1e-5 alone.  Padded heads and ff columns stay
exactly zero.  Each rank's blocks equal its ``NamedSharding`` cut of the
gathered tree, and each rank's collective log of one step equals, op for
op, the log of the counter's trace of that rank's step on ``meta``
tensors under ``ShapeMesh(data=2, model=2)``.
"""
import contextlib
import dataclasses
import functools
import os

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
    "moe": "moonshot-v1-16b-a3b",
    # 4 experts, top 2: capacity factor E / top_k, no pair dropped
    "moe_a2a": ("moonshot-v1-16b-a3b", dict(capacity_factor=2.0)),
    "rwkv": "rwkv6-7b",
    "rgemma": ("recurrentgemma-2b", dict(n_layers=5)),
}
#: the REPRO_OPTS a case runs under (ranks, one process and trace alike)
OPTS = {"moe_a2a": "moe_a2a"}
#: the cases run in float64 (module docstring)
F64_CASES = ("moe_a2a", "rwkv", "rgemma")
#: the cases whose params are held within the one process's own spread
SPREAD_CASES = ("rwkv",)
#: the cases held against the reference's loss
REF_CASES = ["even", "uneven", "mqa", "moe", "moe_a2a", "rwkv", "rgemma"]


def _registry(get, spec):
    name, over = (spec, {}) if isinstance(spec, str) else spec
    return dataclasses.replace(get(name).reduced(), **over)


def _tcfg(case):
    spec = CASES[case]
    if isinstance(spec, dict):
        return TArchConfig(**spec)
    return _registry(get_config, spec)


def _jcfg(case):
    from repro.configs import get_config as jget
    from repro.configs.base import ArchConfig
    spec = CASES[case]
    if isinstance(spec, dict):
        return ArchConfig(**spec)
    return _registry(jget, spec)


def _dtype(case):
    return torch.float64 if case in F64_CASES else torch.float32


def _port_base(case):
    """:func:`_base` in the case's dtype (what the port's steps start
    from)."""
    base = _base(case)
    if case not in F64_CASES:
        return base
    return tree_map(lambda a: a.astype(np.float64)
                    if a.dtype == np.float32 else a, base)


def _oracle_micro(case):
    """The one-process step's microbatches: the ranks' rows per call for
    the MoE, ssm and hybrid cases (module docstring)."""
    if _tcfg(case).family in ("moe", "ssm", "hybrid"):
        return 2 * N_MICRO
    return N_MICRO


@contextlib.contextmanager
def _opts(case):
    """``REPRO_OPTS`` set to the case's flags for the block."""
    old = os.environ.get("REPRO_OPTS")
    os.environ["REPRO_OPTS"] = OPTS.get(case, "")
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_OPTS"]
        else:
            os.environ["REPRO_OPTS"] = old


def _rescale_experts(node):
    """The stacked expert leaves (L, E, in, out) of a numpy MoE layer
    tree rescaled to std 1/sqrt(in), as ``rescale_fan_in`` does the
    stacked ``w`` leaves."""
    return {k: (v * np.sqrt(v.shape[0] / v.shape[2])).astype(v.dtype)
            if k != "router" else v for k, v in node.items()}


@functools.lru_cache(maxsize=None)
def _base(case):
    """The reference's init_params (numpy), stacked weights rescaled."""
    import jax
    from repro.models import init_params as jinit, split_tree
    base = to_numpy(split_tree(jinit(_jcfg(case),
                                     jax.random.PRNGKey(0)))[0])
    base = {k: rescale_fan_in(v) if k in ("layers", "groups", "enc_layers",
                                          "dec_layers") else v
            for k, v in base.items()}
    if "moe" in base.get("layers", {}):
        base["layers"] = {**base["layers"],
                          "moe": _rescale_experts(base["layers"]["moe"])}
    return base


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


def _step(case, n_micro=N_MICRO):
    return make_train_step(_tcfg(case), AdamWConfig(**F32_KW),
                           n_micro=n_micro, compute_dtype=_dtype(case))


def _rank(rank, bases, batches):
    """Every case on the (data = 2, model = 2) mesh: STEPS steps on this
    rank's blocks; (losses, blocks, gathered state, ops of step 1, the
    initial blocks gathered back)."""
    mesh = make_host_mesh(model_parallel=2)
    out = {}
    for case in bases:
        cfg = _tcfg(case)
        lay = fsdp_tp_layout(cfg, mesh)
        full = from_jax_params(bases[case], "cpu")
        restored = to_numpy(fsdp_tp_gather(
            cfg, fsdp_tp_blocks(cfg, full, lay), lay))
        state = init_train_state(fsdp_tp_blocks(cfg, full, lay))
        step = _step(case)
        losses, log = [], None
        with use_mesh(mesh), use_layout(lay), _opts(case):
            for s in range(STEPS):
                start = len(mesh.log)
                state, m = step(state, _rows(batches[case][s], mesh))
                losses.append(float(m["loss"]))
                if log is None:
                    log = list(mesh.log[start:])
            gathered = [fsdp_tp_gather(cfg, t, lay)
                        for t in (state.params, state.opt.m, state.opt.v)]
        out[case] = (losses, to_numpy(state.params), to_numpy(gathered), log,
                     restored)
    return out


_LAUNCH = {}


def _ranks():
    if not _LAUNCH:
        try:
            _LAUNCH["ok"] = launch_ranks(
                _rank, RANKS,
                ({c: _port_base(c) for c in CASES},
                 {c: [_batch(c, s) for s in range(STEPS)] for c in CASES}),
                timeout_s=180)
        except Exception as e:
            _LAUNCH["err"] = e
    if "err" in _LAUNCH:
        raise _LAUNCH["err"]
    return _LAUNCH["ok"]


@functools.lru_cache(maxsize=None)
def _oracle(case, n_micro=None):
    """The one-process port step over the whole batches (in
    ``n_micro`` microbatches, default :func:`_oracle_micro`): (losses,
    (params, m, v) as numpy)."""
    state = init_train_state(from_jax_params(_port_base(case), "cpu"))
    step = _step(case, n_micro or _oracle_micro(case))
    losses = []
    with _opts(case):
        for s in range(STEPS):
            batch = {k: torch.as_tensor(v)
                     for k, v in _batch(case, s).items()}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    return losses, to_numpy([state.params, state.opt.m, state.opt.v])


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_match_the_one_process_step(case):
    want_losses, want = _oracle(case)
    spread = 0.0
    if case in SPREAD_CASES:
        spread = max(float(np.abs(a - b).max()) for a, b in zip(
            tree_leaves(_oracle(case, N_MICRO)[1][0]), tree_leaves(want[0])))
    for rank, out in enumerate(_ranks()):
        losses, _, gathered = out[case][:3]
        np.testing.assert_allclose(losses, want_losses, rtol=TOL, atol=TOL,
                                   err_msg=f"rank {rank}")
        assert_trees_close(gathered[1:], want[1:], tol=TOL, relative=True)
        for got, exp in zip(tree_leaves(gathered[0]), tree_leaves(want[0])):
            atol = TOL * max(float(np.abs(exp).max()), 1.0) + 2 * spread
            np.testing.assert_allclose(got, exp, rtol=TOL, atol=atol)


@pytest.mark.parametrize("case", REF_CASES)
def test_ranks_match_the_reference_loss(case):
    """The reference's jitted one-device ``make_train_step`` on the same
    numpy weights and batches (the MoE cases in the ranks' microbatches):
    the losses of every step."""
    import jax
    import jax.numpy as jnp
    from repro.train import AdamWConfig as JAdamWConfig
    from repro.train import TrainState, adamw_init
    from repro.train import make_train_step as jmake
    params = jax.tree.map(jnp.asarray, _base(case))
    state = TrainState(params, adamw_init(params), None)
    step = jax.jit(jmake(_jcfg(case), JAdamWConfig(**F32_KW),
                         n_micro=_oracle_micro(case),
                         compute_dtype=jnp.float32))
    want = []
    with _opts(case):
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


@pytest.mark.parametrize("case", list(CASES))
def test_gather_restores_the_source_tree(case):
    """``fsdp_tp_gather`` of the initial blocks is the source tree, bit
    for bit: the padding taken off, the RG-LRU's ``w_in`` columns back in
    their x | y order."""
    want = _port_base(case)
    for out in _ranks():
        for got, exp in zip(tree_leaves(out[case][4]), tree_leaves(want)):
            np.testing.assert_array_equal(got, exp)


def test_rglru_w_in_blocks_are_x_then_y():
    """Each rank's block of an RG-LRU ``w_in`` (d, 2·lru), stacked in a
    group or in the tail, is [its x channels | its y channels]: its
    ``model`` coordinate's block of each half, its ``data`` block of the
    rows."""
    cfg = _tcfg("rgemma")
    full = init_params(cfg, 3, device="cpu")
    lru = cfg.lru_width
    for rank in range(RANKS):
        mesh = ShapeMesh({"data": 2, "model": 2}, rank=rank)
        lay = fsdp_tp_layout(cfg, mesh)
        blocks = fsdp_tp_blocks(cfg, full, lay)
        r, dr = mesh.axis_index("model"), mesh.axis_index("data")
        n, rows = lru // 2, cfg.d_model // 2
        for src, blk in ((full["groups"]["b0"], blocks["groups"]["b0"]),
                         (full["tail"][0], blocks["tail"][0])):
            w = src["rec"]["w_in"]["w"]
            x, y = w[..., :lru], w[..., lru:]
            want = torch.cat([x[..., r * n:(r + 1) * n],
                              y[..., r * n:(r + 1) * n]], -1)
            want = want[..., dr * rows:(dr + 1) * rows, :]
            assert torch.equal(blk["rec"]["w_in"]["w"], want)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "phi3.5-moe-42b-a6.6b", "rwkv6-7b",
                                  "recurrentgemma-2b"])
@pytest.mark.parametrize("model", [2, 16])
def test_registry_layouts_divide(arch, model):
    """The registry's MoE, ssm and hybrid models lay out on the production
    mesh's model axis and on the smoke's: experts, RWKV heads and d_ff,
    RG-LRU width divide it, and every leaf's ``NamedSharding`` cut of
    the (meta) tree is a whole block."""
    cfg = get_config(arch)
    mesh = ShapeMesh({"data": 16, "model": model}, rank=model + 1)
    lay = fsdp_tp_layout(cfg, mesh)
    full = init_params(cfg, device="meta")
    blocks = fsdp_tp_blocks(cfg, full, lay)
    assert sum(b.numel() for b in tree_leaves(blocks)) * 16 * model \
        >= sum(x.numel() for x in tree_leaves(full))


def test_layout_refuses_model_cuts_that_do_not_divide():
    """Three model ranks: the reduced models' 4 experts, 4 RWKV heads and
    128-wide channel mix, 64-wide RG-LRU are refused, each dim named."""
    mesh = ShapeMesh({"data": 1, "model": 3})
    for case, dims in (("moe", ["n_experts 4"]),
                       ("rwkv", ["the RWKV head count 4",
                                 "the channel-mix d_ff 128"]),
                       ("rgemma", ["lru_width 64"])):
        with pytest.raises(ValueError) as err:
            fsdp_tp_layout(_tcfg(case), mesh)
        for dim in dims:
            assert dim in str(err.value)


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
        blocks = fsdp_tp_blocks(cfg, init_params(cfg, device="meta",
                                                 dtype=_dtype(case)), lay)
        state = init_train_state(blocks)
        batch = {k: torch.empty(v[:BATCH // 2].shape,
                                dtype=torch.as_tensor(v).dtype,
                                device="meta")
                 for k, v in _batch(case, 0).items()}
        with use_mesh(mesh), use_layout(lay), _opts(case):
            costs = count_costs(_step(case), state, batch, mesh=mesh)
        assert list(mesh.log) == list(out[case][3])
        assert costs.n_collectives == _count(out[case][3])


def _count(log):
    out = {}
    for op, *_ in log:
        out[op] = out.get(op, 0) + 1
    return out
