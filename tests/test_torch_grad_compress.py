"""The int8 error-feedback gradient all-reduce (``train/grad_compress.py``)
held against the reference's.

``compress_leaf`` against the reference's on seeded leaves: byte-identical
int8 payloads, equal scales and errors.  ``compressed_psum_tree`` on 4
gloo ranks (one spawned launch) against the reference's function run
under ``jax.vmap(..., axis_name="data")`` on the same 4 blocks, two
rounds (the second carries the first's error feedback): each rank's int8
payload and the int32 sum it gets back byte-identical to the reference's
arithmetic under the same ``vmap``, and the mean grads and new errors
equal to the reference's function's bit for bit (the tolerance found:
exact; the arithmetic is the same f32 operations in the same order, and
the sum is an exact integer sum).  The leaves include a bfloat16 grad, a
zero leaf (scale 1e-12) and a leaf whose ratios hit halves exactly
(``rint`` rounds half to even, as ``torch.round`` does).
"""
import functools

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one intra-op thread, for the ranks too)
from repro_torch.launch.mesh import launch_ranks, make_host_mesh
from repro_torch.train.grad_compress import (compress_leaf,
                                             compressed_psum_tree,
                                             init_error_buf)

RANKS = 4
ROUNDS = 2
LEAVES = ("a", "b", "c", "halves", "zero")


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 values exactly representable in bfloat16."""
    return torch.tensor(x).to(torch.bfloat16).float().numpy()


@functools.lru_cache(maxsize=None)
def _blocks():
    """Per round, per rank: {leaf: grad (numpy f32; ``b`` holds bf16
    values)}, and the initial error buffers per rank."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (3, 4, 8), "c": (65,), "halves": (4,),
              "zero": (3, 3)}
    rounds = []
    for _ in range(ROUNDS):
        per_rank = []
        for r in range(RANKS):
            g = {k: rng.standard_normal(s).astype(np.float32) * (r + 1)
                 for k, s in shapes.items()}
            g["b"] = _bf16(g["b"])
            g["halves"] = np.array([127.0, 63.5, -0.5, 2.5], np.float32)
            g["zero"] = np.zeros((3, 3), np.float32)
            per_rank.append(g)
        rounds.append(per_rank)
    err = [{k: (0.01 * rng.standard_normal(s)).astype(np.float32)
            if k in ("a", "c") else np.zeros(s, np.float32)
            for k, s in shapes.items()} for _ in range(RANKS)]
    return rounds, err


def _torch_grads(g):
    return {k: torch.tensor(v).to(torch.bfloat16) if k == "b"
            else torch.tensor(v) for k, v in g.items()}


def _rank(rank, rounds, err):
    mesh = make_host_mesh()                      # (data = 4, model = 1)
    payloads = []
    orig = mesh.all_reduce

    def spy(x, axis, op="sum", *, acc_dtype=None):
        out = orig(x, axis, op, acc_dtype=acc_dtype)
        if acc_dtype is not None:
            payloads.append((x.numpy().copy(), out.numpy().copy()))
        return out
    mesh.all_reduce = spy
    e = {k: torch.tensor(v) for k, v in err[rank].items()}
    out = []
    for per_rank in rounds:
        start = len(mesh.log)
        mean, e = compressed_psum_tree(_torch_grads(per_rank[rank]), e,
                                       ("data",), mesh)
        out.append({"mean": {k: v.float().numpy() for k, v in mean.items()},
                    "dtypes": {k: str(v.dtype) for k, v in mean.items()},
                    "err": {k: v.numpy().copy() for k, v in e.items()},
                    "payloads": payloads[-len(LEAVES):],
                    "log": mesh.log[start:]})
    return out


_LAUNCH = {}


def _ranks():
    if not _LAUNCH:
        rounds, err = _blocks()
        try:
            _LAUNCH["ok"] = launch_ranks(_rank, RANKS, (rounds, err),
                                         timeout_s=120)
        except Exception as e:
            _LAUNCH["err"] = e
    if "err" in _LAUNCH:
        raise _LAUNCH["err"]
    return _LAUNCH["ok"]


@functools.lru_cache(maxsize=None)
def _reference():
    """Per round: the reference's ``compressed_psum_tree`` under vmap over
    the 4 blocks (mean grads, errors), and the int8 payloads and int32
    sums of its arithmetic under the same vmap, leaves in tree order."""
    import jax
    import jax.numpy as jnp
    from repro.train.grad_compress import compressed_psum_tree as jpsum
    rounds, err = _blocks()

    def payload(gg, ee):
        def leaf(g, e):
            gf = g.astype(jnp.float32) + e
            gmax = jax.lax.pmax(jnp.max(jnp.abs(gf)), "data")
            scale = gmax / 127.0 + 1e-12
            q = jnp.clip(jnp.rint(gf / scale), -127, 127).astype(jnp.int8)
            return q, jax.lax.psum(q.astype(jnp.int32), "data")
        return {k: leaf(gg[k], ee[k]) for k in gg}

    e = {k: jnp.stack([err[r][k] for r in range(RANKS)]) for k in LEAVES}
    out = []
    for per_rank in rounds:
        g = {k: jnp.stack([per_rank[r][k] for r in range(RANKS)])
             for k in LEAVES}
        g["b"] = g["b"].astype(jnp.bfloat16)
        pay = jax.vmap(payload, axis_name="data")(g, e)
        mean, e = jax.vmap(lambda gg, ee: jpsum(gg, ee, ("data",)),
                           axis_name="data")(g, e)
        out.append({
            "mean": {k: np.asarray(v.astype(jnp.float32))
                     for k, v in mean.items()},
            "dtypes": {k: str(v.dtype) for k, v in mean.items()},
            "err": {k: np.asarray(v) for k, v in e.items()},
            "payloads": {k: (np.asarray(q), np.asarray(s))
                         for k, (q, s) in pay.items()}})
    return out


@pytest.mark.parametrize("leaf", LEAVES)
def test_compress_leaf_matches_reference(leaf):
    import jax.numpy as jnp
    from repro.train.grad_compress import compress_leaf as jcompress
    rounds, err = _blocks()
    g, e = rounds[0][1][leaf], err[1][leaf]
    jg = jnp.asarray(g).astype(jnp.bfloat16) if leaf == "b" \
        else jnp.asarray(g)
    tg = _torch_grads({leaf: g})[leaf]
    jq, js, je = jcompress(jg, jnp.asarray(e))
    tq, ts, te = compress_leaf(tg, torch.tensor(e))
    assert tq.dtype == torch.int8
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.item() == float(js)
    assert np.array_equal(te.numpy(), np.asarray(je))
    if leaf == "halves":                         # half to even
        assert tq.tolist() == [127, 64, 0, 2]


@pytest.mark.parametrize("leaf", LEAVES)
def test_compressed_psum_matches_reference_under_vmap(leaf):
    ref = _reference()
    for rank, rounds in enumerate(_ranks()):
        for rd, (got, want) in enumerate(zip(rounds, ref)):
            i = sorted(LEAVES).index(leaf)       # the tree's leaf order
            q, summed = got["payloads"][i]
            wq, ws = want["payloads"][leaf]
            assert q.dtype == np.int8 and summed.dtype == np.int32
            assert q.tobytes() == wq[rank].tobytes(), (leaf, rank, rd)
            assert summed.tobytes() == ws[rank].tobytes(), (leaf, rank, rd)
            assert got["dtypes"][leaf].replace("torch.", "") \
                == want["dtypes"][leaf]
            assert np.array_equal(got["mean"][leaf], want["mean"][leaf][rank])
            assert np.array_equal(got["err"][leaf], want["err"][leaf][rank])


def test_the_int8_payload_is_what_crosses():
    """Per leaf and round: one scalar f32 ``max`` and the int8 payload,
    1 byte per entry; every rank holds the same mean."""
    ranks = _ranks()
    rounds, _ = _blocks()
    sizes = {k: v.size for k, v in rounds[0][0].items()}
    for rounds_out in ranks:
        for got in rounds_out:
            ops = [(op, dt, nb) for op, dt, _, nb in got["log"]]
            want = []
            for k in sorted(LEAVES):
                want += [("all_reduce_max", "float32", 4),
                         ("all_reduce_sum", "int8", sizes[k])]
            assert ops == want
    for rd in range(ROUNDS):
        for k in LEAVES:
            first = ranks[0][rd]["mean"][k]
            assert all(np.array_equal(r[rd]["mean"][k], first)
                       for r in ranks)


def test_init_error_buf_is_float32_zeros():
    tree = {"w": torch.ones(3, 2, dtype=torch.bfloat16), "v": [torch.ones(4)]}
    err = init_error_buf(tree)
    assert err["w"].dtype == torch.float32 and err["w"].shape == (3, 2)
    assert not err["w"].any() and not err["v"][0].any()


def _mailbox_rank(rank):
    """On 2 ranks sharing the card: the mailbox route's sums (f32 in rank
    order, int8 widened to int32 in pieces smaller than the tensor), max
    and all-to-all against the values every rank can compute itself."""
    from repro_torch.dist import sharding
    mesh = make_host_mesh(model_parallel=2, device="cuda")
    assert mesh.staging == "device"
    sharding._CHUNK_BYTES = 1000                  # several pieces
    blocks = [torch.randn((37, 41), generator=torch.Generator()
                          .manual_seed(r)) for r in range(2)]
    codes = [(b * 40).clamp(-127, 127).to(torch.int8) for b in blocks]
    x, q = blocks[rank].cuda(), codes[rank].cuda()
    ok = torch.equal(mesh.all_reduce(x, "model").cpu(), blocks[0] + blocks[1])
    ok &= torch.equal(mesh.all_reduce(q, "model", acc_dtype=torch.int32)
                      .cpu(), codes[0].int() + codes[1].int())
    ok &= torch.equal(mesh.all_reduce(x, "model", "max").cpu(),
                      torch.maximum(blocks[0], blocks[1]))
    got = mesh.all_to_all(x[:36], "model", 0, 1).cpu()
    ok &= torch.equal(got, torch.cat([b[:36][rank * 18:(rank + 1) * 18]
                                      for b in blocks], 1))
    mesh.close()
    return bool(ok)


@pytest.mark.cuda
def test_device_mailboxes_reduce_and_all_to_all():
    from _torch_parity import require_cuda
    require_cuda()
    if torch.cuda.device_count() != 1:
        pytest.skip("the mailboxes serve ranks that share one card")
    assert launch_ranks(_mailbox_rank, 2, device="cuda",
                        timeout_s=120) == [True, True]
