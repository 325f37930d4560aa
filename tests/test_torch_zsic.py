"""Port of ZSIC (``core/zsic.py``) and its in-block kernel (``kernels/zsic``)
held against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: in float64 (``jax_enable_x64`` on inside try/finally, as
``tests/test_zsic.py`` does) codes byte-identical and residuals within
1e-9; in f32 code agreement ≥ 99.9 % (rounding ties at knife edges move
with the summation order, as the reference's own tests allow).  The
kernel-vs-twin cases need the card (``cuda`` marker): codes and residual
bit for bit.
"""
import numpy as np
import pytest
import torch

from _torch_parity import require_cuda, to_numpy
from repro_torch.core import (chol_lower, random_covariance, zsic,
                              zsic_blocked, zsic_lmmse, zsic_lmmse_numpy,
                              zsic_numpy)
from repro_torch.kernels.zsic import (zsic_block, zsic_block_cuda,
                                      zsic_block_ref, zsic_quantize)


def _setup(n, a, seed=0, condition=20.0, alpha_spread=True):
    """(y, l, alphas) float64 numpy — the reference's kernel-test setup."""
    rng = np.random.default_rng(seed)
    sigma, _ = random_covariance(n, condition=condition, seed=seed + 1)
    l = chol_lower(sigma)
    w = rng.standard_normal((a, n))
    if alpha_spread:
        ldiag = np.abs(np.diag(l))
        alphas = 0.05 * np.exp(np.mean(np.log(ldiag))) / ldiag  # WaterSIC
    else:
        alphas = np.full(n, 0.05)                                # GPTQ
    return w @ l, l, alphas


class _x64:
    """``jax_enable_x64`` for the body of a ``with``, restored after."""

    def __enter__(self):
        import jax
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        import jax
        jax.config.update("jax_enable_x64", False)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_zsic_numpy_matches_reference():
    from repro.core import zsic_lmmse_numpy as jlmmse_np
    from repro.core import zsic_numpy as jzsic_np
    y, l, alphas = _setup(40, 24, seed=2)
    for got, want in zip(zsic_numpy(y, l, alphas), jzsic_np(y, l, alphas)):
        assert np.array_equal(got, want)
    for got, want in zip(zsic_lmmse_numpy(y, l, 0.3),
                         jlmmse_np(y, l, 0.3)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("spread", [True, False])
@pytest.mark.parametrize("lmmse", [None, False, True])
def test_zsic_f64_identical_to_reference(spread, lmmse):
    """zsic (lmmse None) and zsic_lmmse in float64: codes byte-identical,
    residual and γ within 1e-9."""
    import jax.numpy as jnp
    from repro.core import zsic_jax, zsic_lmmse_jax
    y, l, alphas = _setup(40, 24, seed=4, alpha_spread=spread)
    with _x64():
        args = [jnp.asarray(v, jnp.float64) for v in (y, l, alphas)]
        if lmmse is None:
            want = zsic_jax(*args)
            got = zsic(_t(y), _t(l), _t(alphas))
        else:
            want = zsic_lmmse_jax(*args, lmmse=lmmse)
            got = zsic_lmmse(_t(y), _t(l), _t(alphas), lmmse=lmmse)
        want = [np.asarray(v) for v in want]
    assert got.codes.dtype == torch.int32
    assert np.array_equal(to_numpy(got.codes), want[0])
    np.testing.assert_allclose(to_numpy(got.gammas), want[1], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(to_numpy(got.residual), want[2], rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("block", [8, 16, 40, 64])
def test_blocked_f64_identical_to_reference(block):
    import jax.numpy as jnp
    from repro.core import zsic_blocked as jblocked
    y, l, alphas = _setup(40, 24, seed=4)
    with _x64():
        want = jblocked(*[jnp.asarray(v, jnp.float64)
                          for v in (y, l, alphas)], block=block)
        want = [np.asarray(v) for v in want]
    got = zsic_blocked(_t(y), _t(l), _t(alphas), block=block)
    assert np.array_equal(to_numpy(got.codes), want[0])
    np.testing.assert_allclose(to_numpy(got.gammas), want[1], rtol=0, atol=0)
    np.testing.assert_allclose(to_numpy(got.residual), want[2], rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("lmmse", [None, False, True])
def test_zsic_f32_agrees_with_reference(lmmse):
    import jax.numpy as jnp
    from repro.core import zsic_jax, zsic_lmmse_jax
    y, l, alphas = _setup(64, 96, seed=6)
    args = [np.asarray(v, np.float32) for v in (y, l, alphas)]
    if lmmse is None:
        want = zsic_jax(*map(jnp.asarray, args))
        got = zsic(*[torch.as_tensor(v) for v in args])
    else:
        want = zsic_lmmse_jax(*map(jnp.asarray, args), lmmse=lmmse)
        got = zsic_lmmse(*[torch.as_tensor(v) for v in args], lmmse=lmmse)
    agree = (to_numpy(got.codes) == np.asarray(want.codes)).mean()
    assert agree >= 0.999, agree


@pytest.mark.parametrize("n,a,block,block_rows", [
    (64, 32, 64, 16),
    (96, 48, 32, 16),
    (128, 40, 128, 8),
    (60, 17, 16, 8),       # ragged rows: the reference pads, the port masks
    (130, 9, 128, 8),      # a ragged block of 2 columns left of a full one
])
def test_zsic_quantize_matches_reference_kernel(n, a, block, block_rows):
    """The port's blocked quantizer (twin on the CPU) against the Pallas
    kernel in interpret mode, on tests/test_kernels_zsic.py's shapes."""
    from repro.kernels.zsic import zsic_quantize as jzsic_quantize
    y, l, alphas = _setup(n, a, seed=n + a)
    args = [np.asarray(v, np.float32) for v in (y, l, alphas)]
    zj, rj = jzsic_quantize(*args, block=block, block_rows=block_rows,
                            interpret=True)
    z, r = zsic_quantize(*[torch.as_tensor(v) for v in args], block=block)
    assert z.shape == (a, n) and z.dtype == torch.int32
    mask = to_numpy(z) == np.asarray(zj)
    assert mask.mean() >= 0.999, mask.mean()
    assert np.abs(to_numpy(r) - np.asarray(rj))[mask].max() < 1e-4
    # Lemma 3.2 on the port's output
    bound = 0.5 * alphas * np.abs(np.diag(l))
    assert np.all(np.abs(to_numpy(r)) <= bound[None, :] * (1 + 1e-4) + 1e-6)


def test_zsic_block_twin_matches_reference_block():
    from repro.kernels.zsic import zsic_block_pallas
    y, l, alphas = _setup(32, 16, seed=9)
    args = [np.asarray(v, np.float32) for v in (y, l, alphas)]
    zj, _ = zsic_block_pallas(*args, block_rows=16, interpret=True)
    z, _ = zsic_block_ref(*[torch.as_tensor(v) for v in args])
    assert (to_numpy(z) == np.asarray(zj)).mean() >= 0.999
    with pytest.raises(ValueError, match="CUDA tensor"):
        zsic_block_cuda(*[torch.as_tensor(v) for v in args])


@pytest.mark.cuda
@pytest.mark.parametrize("a,bn", [(2304, 128), (5760, 128), (230, 128),
                                  (576, 128), (17, 60), (33, 1),
                                  # ragged block widths (a partial top
                                  # group of 4 columns, one column) and
                                  # fewer rows than one block's 32
                                  (2304, 1), (2304, 40), (2304, 127),
                                  (5, 128), (31, 77), (1, 128)])
def test_kernel_matches_twin_bit_for_bit(a, bn):
    dev = require_cuda()
    y, l, alphas = _setup(bn, a, seed=a + bn)
    args = [torch.as_tensor(np.asarray(v, np.float32), device=dev)
            for v in (y, l, alphas)]
    z, r = zsic_block(*args)
    zt, rt = zsic_block_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(z, zt)
    assert torch.equal(r, rt)


@pytest.mark.cuda
def test_kernel_full_quantize_against_float64():
    """zsic_quantize through the kernel on the card vs zsic_numpy in
    float64 (the chip smoke's full-ZSIC case, smaller)."""
    dev = require_cuda()
    y, l, alphas = _setup(384, 300, seed=11)
    z, r = zsic_quantize(*[torch.as_tensor(np.asarray(v, np.float32),
                                           device=dev)
                           for v in (y, l, alphas)])
    z_ref, _ = zsic_numpy(y, l, alphas)
    assert (to_numpy(z) == z_ref).mean() >= 0.999
    bound = 0.5 * alphas * np.abs(np.diag(l))
    assert np.all(np.abs(to_numpy(r)) <= bound[None, :] * (1 + 1e-4) + 1e-6)


def _twin_block(y, l_block, alphas, *, out):
    """``ops.zsic_block`` with the twin in place of the kernel."""
    for dst, src in zip(out, zsic_block_ref(y, l_block, alphas)):
        dst.copy_(src)
    return out


def test_block_writes_into_column_slices_on_cpu():
    """ops.zsic_block fills column slices of wider outputs (as
    zsic_quantize hands them) with the twin's result and leaves the other
    columns alone."""
    y, l, alphas = _setup(40, 11, seed=4)
    args = [torch.as_tensor(np.asarray(v, np.float32)) for v in (y, l, alphas)]
    z = torch.full((11, 70), -7, dtype=torch.int32)
    r = torch.full((11, 70), 3.5)
    got = zsic_block(*args, out=(z[:, 20:60], r[:, 20:60]))
    zt, rt = zsic_block_ref(*args)
    assert got[0].data_ptr() == z[:, 20:60].data_ptr()
    assert torch.equal(z[:, 20:60], zt) and torch.equal(r[:, 20:60], rt)
    assert (z[:, :20] == -7).all() and (z[:, 60:] == -7).all()
    assert (r[:, :20] == 3.5).all() and (r[:, 60:] == 3.5).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [128, 57])
def test_kernel_writes_strided_column_slices(bn):
    """The kernel reads y and L as column slices of wider matrices and
    writes codes and residual into column slices of wider outputs, bit
    for bit with the twin, leaving the other columns untouched."""
    dev = require_cuda()
    a, n, s = 300, 400, 136
    y, l, alphas = _setup(n, a, seed=bn)
    yd, ld, ad = [torch.as_tensor(np.asarray(v, np.float32), device=dev)
                  for v in (y, l, alphas)]
    ys, ls, als = yd[:, s:s + bn], ld[s:s + bn, s:s + bn], ad[s:s + bn]
    z = torch.full((a, n), -7, dtype=torch.int32, device=dev)
    r = torch.full((a, n), 3.5, device=dev)
    before = zsic_block_cuda.launches
    got = zsic_block_cuda(ys, ls, als, out=(z[:, s:s + bn], r[:, s:s + bn]))
    torch.cuda.synchronize()
    assert zsic_block_cuda.launches == before + 1
    assert got[0].data_ptr() == z[:, s:].data_ptr()
    zt, rt = zsic_block_ref(ys.contiguous(), ls.contiguous(), als)
    assert torch.equal(z[:, s:s + bn], zt) and torch.equal(r[:, s:s + bn], rt)
    assert (z[:, :s] == -7).all() and (z[:, s + bn:] == -7).all()
    assert (r[:, :s] == 3.5).all() and (r[:, s + bn:] == 3.5).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,a", [(2304, 2304), (300, 45)])
def test_kernel_quantize_equals_twin_quantize(n, a):
    """A full zsic_quantize on the card equals the same call with
    ops.zsic_block swapped for the twin, code for code and bit for bit."""
    from repro_torch.kernels.zsic import ops
    dev = require_cuda()
    y, l, alphas = _setup(n, a, seed=n + a)
    args = [torch.as_tensor(np.asarray(v, np.float32), device=dev)
            for v in (y, l, alphas)]
    z, r = zsic_quantize(*args)
    kernel_fn, ops.zsic_block = ops.zsic_block, _twin_block
    try:
        zt, rt = zsic_quantize(*args)
    finally:
        ops.zsic_block = kernel_fn
    assert torch.equal(z, zt)
    assert torch.equal(r, rt)
