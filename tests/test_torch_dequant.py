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

from _torch_parity import (assert_close, assert_same_ints, require_cuda,
                           to_numpy)
from repro_torch.core.packing import pack_codes
from repro_torch.kernels.dequant import (LAUNCHES, dequant_matmul,
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
    tp = pack_codes(torch.from_numpy(z), nbits=nbits)
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
        parts = [pack_codes(torch.from_numpy(
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


@pytest.mark.cuda
def test_int8_codes_on_cuda_name_the_roadmap_item():
    """An int8 code matrix on CUDA has no kernel yet: it raises, naming
    the ROADMAP item (no silent plain-PyTorch fallback)."""
    dev = require_cuda()
    x = torch.zeros((1, 8), device=dev)
    z = torch.zeros((4, 8), dtype=torch.int8, device=dev)
    with pytest.raises(NotImplementedError, match="queue B item 2"):
        dequant_matmul(x, z, torch.ones(8, device=dev),
                       torch.ones(4, device=dev))


# ---------------------------------------------------------------------------
# Card tests: the CUDA kernel against its twin
# ---------------------------------------------------------------------------


def _cuda_operands(m, k, n, nbits, esc, seed, dev):
    x, z, s, t = _case(m, k, n, nbits, esc, seed)
    payload, er, ec, ev = pack_codes(torch.from_numpy(z), nbits=nbits)
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
    """The CUDA route of ops (pad, group view, kernel, escape index_add_)
    against the CPU route on the same inputs."""
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
