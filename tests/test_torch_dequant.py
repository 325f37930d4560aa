"""Port of the packed dequant-matmul held against the JAX package.

CPU parity (tier-1): ``repro_torch.kernels.dequant.ops.dequant_matmul`` on
CPU tensors (the plain twin) against ``repro.kernels.dequant.ops.
dequant_matmul(..., interpret=True)`` (the Pallas kernel in interpret
mode), and ``dequantize_leaf_ref`` against ``repro.kernels.dequant.ref.
dequantize_leaf_ref``.  Inputs come from numpy seeds and are scaled so the
outputs are O(1); one f32 matmul is held to rtol = atol = 1e-5.

Card tests (marked ``cuda``, skipped without CUDA): the hand-written
kernel against its twin on the same CUDA tensors.  Sums over k ≤ 5760 in
another order: f32 eps·√k·|partial sum| ≈ 5e-6, so rtol = atol = 1e-4.
"""
import numpy as np
import pytest
import torch

from _torch_parity import (assert_close, assert_same_ints, graph_kernel_nodes,
                           require_cuda, to_numpy)
from repro_torch.core.packing import pack_codes_torch
from repro_torch.kernels.dequant import (LAUNCHES, dequant_matmul,
                                         dequant_matmul_int8_cuda,
                                         dequant_matmul_packed_cuda,
                                         dequant_matmul_packed_ref,
                                         dequant_matmul_ref,
                                         dequantize_leaf_ref, PLANE_GROUPS)

CPU_TOL = 1e-5
CUDA_TOL = 1e-4
_HI = {4: 8, 3: 4, 2: 2}      # codes in [-hi, hi) stay in range


def _case(m, k, n, nbits, esc, seed):
    """x (m, k), codes z (n, k), s (k,), t (n,); with ``esc`` some codes
    fall outside the nbits range and become COO escapes."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    hi = _HI[nbits] + (5 if esc else 0)
    z = rng.integers(-hi, hi, (n, k)).astype(np.int32)
    s = ((rng.random(k) * 0.2 + 0.01) / np.sqrt(k)).astype(np.float32)
    t = (rng.random(n) + 0.5).astype(np.float32)
    return x, z, s, t


@pytest.mark.parametrize("esc", [False, True])
@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("k", [37, 301])
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_packed_matmul_matches_jax(nbits, k, m, esc):
    """vs repro.kernels.dequant.ops.dequant_matmul(interpret=True)."""
    import jax.numpy as jnp
    from repro.core.packing import pack_codes_jnp
    from repro.kernels.dequant import ops as jops

    x, z, s, t = _case(m, k, 24, nbits, esc, seed=nbits * 1000 + k + m)
    jp = pack_codes_jnp(jnp.asarray(z), nbits=nbits)
    tp = pack_codes_torch(torch.from_numpy(z), nbits=nbits)
    for a, b in zip(jp, tp):                      # payload + COO, bytewise
        assert_same_ints(a, b)
    assert (tp[1].shape[0] > 0) == esc
    want = jops.dequant_matmul(jnp.asarray(x), jp[0], jnp.asarray(s),
                               jnp.asarray(t), escapes=tuple(jp[1:]),
                               interpret=True)
    got = dequant_matmul(torch.from_numpy(x), tp[0], torch.from_numpy(s),
                         torch.from_numpy(t), escapes=tuple(tp[1:]))
    assert got.dtype == torch.float32 and got.shape == (m, 24)
    assert_close(got, want, tol=CPU_TOL)


def test_int8_codes_match_jax():
    """int8 (n, k) code matrices: the plain product on the CPU vs
    repro.kernels.dequant.ops.dequant_matmul(interpret=True), and the
    materialized-weight oracle vs repro's dequant_matmul_ref."""
    import jax.numpy as jnp
    from repro.kernels.dequant import ops as jops
    from repro.kernels.dequant import ref as jref

    x, z, s, t = _case(3, 200, 40, 4, False, seed=5)
    z8 = z.astype(np.int8)
    want = jops.dequant_matmul(jnp.asarray(x), jnp.asarray(z8),
                               jnp.asarray(s), jnp.asarray(t), interpret=True)
    got = dequant_matmul(torch.from_numpy(x), torch.from_numpy(z8),
                         torch.from_numpy(s), torch.from_numpy(t))
    assert_close(got, want, tol=CPU_TOL)
    oracle = jref.dequant_matmul_ref(jnp.asarray(x), jnp.asarray(z8),
                                     jnp.asarray(s), jnp.asarray(t))
    got = dequant_matmul_ref(torch.from_numpy(x), torch.from_numpy(z8),
                             torch.from_numpy(s), torch.from_numpy(t))
    assert_close(got, oracle, tol=CPU_TOL)


@pytest.mark.parametrize("nbits", [2, 3, 4, 8])
def test_dequantize_leaf_matches_jax(nbits):
    """vs repro.kernels.dequant.ref.dequantize_leaf_ref on a stacked leaf
    (escapes with duplicate rows included)."""
    import jax.numpy as jnp
    from repro.kernels.dequant.ref import dequantize_leaf_ref as jref

    rng = np.random.default_rng(nbits)
    n_in, n_out, stack = 29, 18, 3
    s = (rng.random((stack, n_in)) + 0.1).astype(np.float32)
    t = (rng.random((stack, n_out)) + 0.5).astype(np.float32)
    if nbits == 8:
        codes = rng.integers(-127, 128, (stack, n_in, n_out)).astype(np.int8)
        leaf = {"codes": codes, "s": s, "t": t}
    else:
        parts = [pack_codes_torch(torch.from_numpy(
            rng.integers(-_HI[nbits] - 3, _HI[nbits] + 3,
                         (n_out, n_in)).astype(np.int32)),
            nbits=nbits, escape_capacity=n_in * n_out)
            for _ in range(stack)]
        leaf = {"codes": np.stack([to_numpy(p[0]) for p in parts]),
                "s": s, "t": t,
                "esc_row": np.stack([to_numpy(p[1]) for p in parts]),
                "esc_col": np.stack([to_numpy(p[2]) for p in parts]),
                "esc_dval": np.stack([to_numpy(p[3]) for p in parts])}
    tleaf = {k: torch.from_numpy(v) for k, v in leaf.items()}
    jleaf = {k: jnp.asarray(v) for k, v in leaf.items()}
    for i in range(stack):
        got = dequantize_leaf_ref(tleaf, index=i)
        assert got.shape == (n_in, n_out)
        np.testing.assert_array_equal(to_numpy(got), jref(jleaf, index=i))
    w = rng.standard_normal((n_in, n_out)).astype(np.float32)
    np.testing.assert_array_equal(
        to_numpy(dequantize_leaf_ref(torch.from_numpy(w))), jref(w))


@pytest.mark.parametrize("m,k,n", [(1, 64, 24), (3, 200, 40), (5, 37, 53)])
def test_int8_kn_view_matches_jax(m, k, n):
    """The serving leaf's layout: int8 codes stored (k, n) and handed over
    as their (n, k) transposed view, through the port's ops (the plain
    twin on the CPU) vs repro.kernels.dequant.ops.dequant_matmul(
    interpret=True) on the (n, k) matrix."""
    import jax.numpy as jnp
    from repro.kernels.dequant import ops as jops

    rng = np.random.default_rng(m * k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    codes = rng.integers(-127, 128, (k, n)).astype(np.int8)   # stored (k, n)
    s = ((rng.random(k) * 0.2 + 0.01) / np.sqrt(k) / 30).astype(np.float32)
    t = (rng.random(n) + 0.5).astype(np.float32)
    view = torch.from_numpy(codes).transpose(0, 1)
    assert not view.is_contiguous() and view.stride() == (1, n)
    want = jops.dequant_matmul(jnp.asarray(x), jnp.asarray(codes.T),
                               jnp.asarray(s), jnp.asarray(t),
                               interpret=True)
    got = dequant_matmul(torch.from_numpy(x), view, torch.from_numpy(s),
                         torch.from_numpy(t))
    assert got.shape == (m, n)
    assert_close(got, want, tol=CPU_TOL)


@pytest.mark.cuda
def test_int8_codes_on_cuda_name_the_roadmap_item():
    """An int8 code matrix on CUDA launches the int8 kernel (ROADMAP queue
    B item 2, ported) once per call, escapes applied after it, and never
    takes the plain twin."""
    dev = require_cuda()
    x, z, s, t = _case(4, 300, 70, 4, False, seed=9)
    z8 = torch.from_numpy(z.astype(np.int8))
    esc = (torch.tensor([0, 5, 5], dtype=torch.int32),
           torch.tensor([3, 7, 299], dtype=torch.int32),
           torch.tensor([200.0, -150.0, 3.0]))
    want = dequant_matmul(torch.from_numpy(x), z8, torch.from_numpy(s),
                          torch.from_numpy(t), escapes=esc)
    before = LAUNCHES[8]
    got = dequant_matmul(torch.from_numpy(x).to(dev), z8.to(dev),
                         torch.from_numpy(s).to(dev),
                         torch.from_numpy(t).to(dev),
                         escapes=tuple(e.to(dev) for e in esc))
    torch.cuda.synchronize()
    assert LAUNCHES[8] == before + 1 and got.is_cuda
    assert_close(got, want, tol=CUDA_TOL)


def _dense_escapes(n, k, per_row, seed):
    """A COO with ``per_row`` escapes in each of n rows at distinct
    columns, dvals spread over six decades (so the order of a row's sum
    shows in its last bits), and 5 (row 0, col 0, dval 0) capacity pads."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.concatenate([rng.choice(k, per_row, replace=False)
                           for _ in range(n)])
    dval = (rng.standard_normal(n * per_row)
            * 10.0 ** rng.integers(-3, 3, n * per_row))
    return (np.concatenate([rows, np.zeros(5, int)]).astype(np.int32),
            np.concatenate([cols, np.zeros(5, int)]).astype(np.int32),
            np.concatenate([dval, np.zeros(5)]).astype(np.float32))


@pytest.mark.parametrize("nbits", [2, 4])
def test_escape_sum_is_independent_of_coo_order(nbits):
    """A permuted escape COO gives the same output bits (the escapes are
    summed in (row, col) order, whatever order they come in), and the sum
    stays within the f32 tolerance of the reference's scatter-add
    (``repro.kernels.dequant.ops.dequant_matmul``, interpret mode)."""
    import jax.numpy as jnp
    from repro.kernels.dequant import ops as jops
    m, k, n = 4, 301, 24
    x, z, s, t = _case(m, k, n, nbits, False, seed=31 + nbits)
    payload = pack_codes_torch(torch.from_numpy(z), nbits=nbits)[0]
    coo = _dense_escapes(n, k, 40, seed=nbits)
    xs, ss, ts = map(torch.from_numpy, (x, s, t))
    got = dequant_matmul(xs, payload, ss, ts,
                         escapes=tuple(map(torch.from_numpy, coo)))
    for seed in range(3):
        perm = np.random.default_rng(seed).permutation(coo[0].shape[0])
        again = dequant_matmul(xs, payload, ss, ts, escapes=tuple(
            torch.from_numpy(np.ascontiguousarray(c[perm])) for c in coo))
        assert torch.equal(got, again)
    want = jops.dequant_matmul(jnp.asarray(x), jnp.asarray(to_numpy(payload)),
                               jnp.asarray(s), jnp.asarray(t),
                               escapes=tuple(map(jnp.asarray, coo)),
                               interpret=True)
    scale = float(np.abs(np.asarray(want)).max())
    assert_close(to_numpy(got) / scale, np.asarray(want) / scale,
                 tol=CPU_TOL)


# ---------------------------------------------------------------------------
# Card tests: the CUDA kernel against its twin
# ---------------------------------------------------------------------------


def _cuda_operands(m, k, n, nbits, esc, seed, dev):
    x, z, s, t = _case(m, k, n, nbits, esc, seed)
    payload, er, ec, ev = pack_codes_torch(torch.from_numpy(z), nbits=nbits)
    return (torch.from_numpy(x).to(dev), payload.to(dev),
            torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev),
            (er.to(dev), ec.to(dev), ev.to(dev)))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8, 16, 21])
@pytest.mark.parametrize("k,n", [(2304, 2304), (2304, 5760), (5760, 2304),
                                 (301, 37), (64, 1)])
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_kernel_matches_twin(nbits, k, n, m):
    dev = require_cuda()
    x, payload, s, t, _ = _cuda_operands(m, k, n, nbits, False,
                                         seed=m + k + n, dev=dev)
    g, kg = PLANE_GROUPS[nbits], payload.shape[-1]
    xp = torch.nn.functional.pad(x, (0, g * kg - k))
    sp = torch.nn.functional.pad(s, (0, g * kg - k))
    before = LAUNCHES[nbits]
    got = dequant_matmul_packed_cuda(xp.view(m, g, kg), payload,
                                     sp.view(g, kg), t, nbits=nbits)
    torch.cuda.synchronize()
    assert LAUNCHES[nbits] == before + 1
    want = dequant_matmul_packed_ref(xp, payload, sp, t, nbits=nbits)
    assert_close(got, want, tol=CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_ops_on_cuda_matches_cpu_with_escapes(nbits):
    """The CUDA route of ops (pad, group view, kernel, escape sum) against
    the CPU route on the same inputs."""
    dev = require_cuda()
    x, payload, s, t, esc = _cuda_operands(8, 301, 70, nbits, True, 3, dev)
    got = dequant_matmul(x, payload, s, t, escapes=esc)
    want = dequant_matmul(x.cpu(), payload.cpu(), s.cpu(), t.cpu(),
                          escapes=tuple(e.cpu() for e in esc))
    assert got.is_cuda
    assert_close(got, want, tol=CUDA_TOL)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_operands():
    dev = require_cuda()
    x, payload, s, t, _ = _cuda_operands(2, 64, 16, 4, False, 0, dev)
    xg, sg = x.view(2, 2, 32), s.view(2, 32)
    with pytest.raises(TypeError):
        dequant_matmul_packed_cuda(xg.double(), payload, sg, t)
    with pytest.raises(ValueError):
        dequant_matmul_packed_cuda(xg, payload.cpu(), sg, t)
    with pytest.raises(ValueError):
        dequant_matmul_packed_cuda(xg, payload[:, :16], sg, t)
    with pytest.raises(ValueError):
        dequant_matmul_packed_cuda(xg, payload, sg, t, nbits=2)


#: minicpm-2b's (k, n) of the packed serving path
SERVING_SHAPES = [(2304, 2304), (2304, 5760), (5760, 2304)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 16, 21])
@pytest.mark.parametrize("k,n", SERVING_SHAPES)
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_kernel_reruns_give_equal_bits(nbits, k, n, m):
    """The split-K sums are added across the cluster in rank order, so the
    same inputs give the same bits on every run."""
    dev = require_cuda()
    x, payload, s, t, _ = _cuda_operands(m, k, n, nbits, False,
                                         seed=m * k + n, dev=dev)
    g, kg = PLANE_GROUPS[nbits], payload.shape[-1]
    xg = torch.nn.functional.pad(x, (0, g * kg - k)).view(m, g, kg)
    sg = torch.nn.functional.pad(s, (0, g * kg - k)).view(g, kg)
    first = dequant_matmul_packed_cuda(xg, payload, sg, t, nbits=nbits)
    for _ in range(3):
        assert torch.equal(first, dequant_matmul_packed_cuda(
            xg, payload, sg, t, nbits=nbits))


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_kernel_is_one_device_kernel_per_call_without_workspace(nbits):
    """One call: one kernel node in a CUDA graph of the call, one count,
    and no device memory beyond the output (no split-K workspace)."""
    dev = require_cuda()
    m, k, n = 8, 5760, 2304
    x, payload, s, t, _ = _cuda_operands(m, k, n, nbits, False, 1, dev)
    g, kg = PLANE_GROUPS[nbits], payload.shape[-1]
    xg = torch.nn.functional.pad(x, (0, g * kg - k)).view(m, g, kg)
    sg = torch.nn.functional.pad(s, (0, g * kg - k)).view(g, kg)
    before = LAUNCHES[nbits]
    assert graph_kernel_nodes(lambda: dequant_matmul_packed_cuda(
        xg, payload, sg, t, nbits=nbits)) == [0]
    assert LAUNCHES[nbits] == before + 2
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = dequant_matmul_packed_cuda(xg, payload, sg, t, nbits=nbits)
    torch.cuda.synchronize()
    # the caching allocator rounds a block up to 512 bytes
    assert torch.cuda.max_memory_allocated() - held \
        <= -(-out.numel() * 4 // 512) * 512


#: the int8 phase's shapes of chip_smoke.py: (m, k, n) at minicpm-2b's
#: widths for m ∈ {1, 8, 128}, and the ragged case
INT8_SHAPES = [(m, k, n) for m in (1, 8, 128)
               for k, n in ((2304, 2304), (2304, 5760), (5760, 2304))] \
    + [(8, 2300, 5757), (3, 301, 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_kernel_matches_twin(m, k, n, layout):
    """The int8 kernel against its twin (ref.dequant_matmul_ref) on the
    same CUDA tensors: the serving leaf's (k, n) storage read in place
    through its transposed view ("kn"), and an (n, k)-contiguous matrix
    ("nk"), which the wrapper copies into that layout first."""
    dev = require_cuda()
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    s = torch.from_numpy(((rng.random(k) * 0.2 + 0.01) / np.sqrt(k) / 30)
                         .astype(np.float32))
    t = torch.from_numpy((rng.random(n) + 0.5).astype(np.float32))
    x, codes, s, t = (a.to(dev) for a in (x, codes, s, t))
    z = codes.transpose(0, 1) if layout == "kn" \
        else codes.transpose(0, 1).contiguous()
    before = LAUNCHES[8]
    got = dequant_matmul_int8_cuda(x, z, s, t)
    torch.cuda.synchronize()
    assert LAUNCHES[8] == before + 1
    assert_close(got, dequant_matmul_ref(x, z, s, t), tol=CUDA_TOL)
    # the same inputs give the same bits on every run (fixed-order sums)
    assert torch.equal(got, dequant_matmul_int8_cuda(x, z, s, t))


@pytest.mark.cuda
def test_int8_kernel_wrapper_rejects_bad_operands():
    dev = require_cuda()
    x = torch.zeros((2, 64), device=dev)
    z = torch.zeros((16, 64), dtype=torch.int8, device=dev)
    s, t = torch.ones(64, device=dev), torch.ones(16, device=dev)
    with pytest.raises(TypeError):
        dequant_matmul_int8_cuda(x.double(), z, s, t)
    with pytest.raises(TypeError):
        dequant_matmul_int8_cuda(x, z.to(torch.uint8), s, t)
    with pytest.raises(ValueError):
        dequant_matmul_int8_cuda(x, z.cpu(), s, t)
    with pytest.raises(ValueError):
        dequant_matmul_int8_cuda(x, z[:, :32], s, t)
    with pytest.raises(ValueError):
        dequant_matmul_int8_cuda(x[:, ::2], z[:, ::2], s[::2], t)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (1, 8, 128)
                                   for k, n in SERVING_SHAPES]
                         + [(8, 2300, 5757)])
def test_int8_kernel_is_one_device_kernel_per_call_without_workspace(m, k, n):
    """One int8 call: one kernel node in a CUDA graph of the call, one
    count, and no device memory beyond the output (the split-K partial
    sums are added inside a thread-block cluster)."""
    dev = require_cuda()
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    s = torch.from_numpy((rng.random(k) * 0.01).astype(np.float32))
    t = torch.from_numpy((rng.random(n) + 0.5).astype(np.float32))
    x, codes, s, t = (a.to(dev) for a in (x, codes, s, t))
    z = codes.transpose(0, 1)                  # the serving leaf's view
    before = LAUNCHES[8]
    assert graph_kernel_nodes(
        lambda: dequant_matmul_int8_cuda(x, z, s, t)) == [0]
    assert LAUNCHES[8] == before + 2
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = dequant_matmul_int8_cuda(x, z, s, t)
    torch.cuda.synchronize()
    # the caching allocator rounds a block up to 512 bytes
    assert torch.cuda.max_memory_allocated() - held \
        <= -(-out.numel() * 4 // 512) * 512


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_escaped_product_reruns_and_permutations_give_equal_bits(nbits):
    """On the card the escaped sum has no atomics: reruns and a permuted
    COO give the same bits, within CUDA_TOL of the CPU route."""
    dev = require_cuda()
    m, k, n = 8, 2304, 2304
    x, z, s, t = _case(m, k, n, nbits, False, seed=77 + nbits)
    payload = pack_codes_torch(torch.from_numpy(z), nbits=nbits)[0].to(dev)
    coo = _dense_escapes(n, k, 12, seed=nbits)
    xs, ss, ts = (torch.from_numpy(a).to(dev) for a in (x, s, t))
    esc = tuple(torch.from_numpy(c).to(dev) for c in coo)
    first = dequant_matmul(xs, payload, ss, ts, escapes=esc)
    perm = torch.as_tensor(np.random.default_rng(0).permutation(
        coo[0].shape[0]), device=dev)
    for escapes in (esc, esc, tuple(e[perm] for e in esc)):
        assert torch.equal(first, dequant_matmul(xs, payload, ss, ts,
                                                 escapes=escapes))
    want = dequant_matmul(xs.cpu(), payload.cpu(), ss.cpu(), ts.cpu(),
                          escapes=tuple(map(torch.from_numpy, coo)))
    assert_close(first, want, tol=CUDA_TOL)
