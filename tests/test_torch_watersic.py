"""Port of WaterSIC (``core/watersic.py``, ``rescalers.py``, ``entropy.py``,
``theory.py``) held against the JAX package.

Statistics carry drift and residual terms and two dead input features, so
every branch the PTQ pipeline takes runs.  Tolerances: in float64
(``jax_enable_x64`` inside try/finally) codes byte-identical, ``c`` and the
entropy within 1e-9 relative, rescalers t and γ within 1e-6 relative (a
Cholesky solve against the reference's ``solve(assume_a="pos")``); in f32
the entropy within 0.005 bits (the secant search's own ``tol_bits``).
"""
import math

import numpy as np
import pytest
import torch

from _torch_parity import to_numpy
from repro_torch.core import (GAP_CUBE_BITS, column_entropies,
                              effective_rate, empirical_entropy,
                              find_optimal_rescalers, high_rate_bound,
                              huffman_bits, plain_watersic, quantize_at_rate,
                              random_covariance, watersic_quantize)
from repro_torch.models import from_jax_calib_stats

#: the (lmmse, rescalers, spacing, erase_dead, damp) of each pipeline method
METHODS = {
    "watersic": dict(damp=0.05),
    "watersic-plain": dict(damp=0.05, lmmse=False, rescalers=False),
    "hptq": dict(damp=0.1, lmmse=False, rescalers=False, spacing="uniform",
                 erase_dead=False),
}


class _x64:
    def __enter__(self):
        import jax
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        import jax
        jax.config.update("jax_enable_x64", False)


def _problem(n=48, a=40, seed=0, dead=(3, 17)):
    """(w (a, n), dict of numpy statistics) with drift, residual and dead
    features."""
    rng = np.random.default_rng(seed)
    sx, _ = random_covariance(n, condition=50.0, seed=seed + 1)
    for i in dead:
        sx[i, :] = sx[:, i] = 0.0
        sx[i, i] = 1e-9
    pert = rng.standard_normal((n, n)) * 0.02
    sxh = sx + pert @ pert.T
    sxxh = sx + 0.01 * (pert + pert.T)
    sdx = rng.standard_normal((a, n)) * 0.01
    w = rng.standard_normal((a, n)) / math.sqrt(n)
    return w, dict(sigma_x=sx, sigma_xhat=sxh, sigma_x_xhat=sxxh,
                   sigma_delta_xhat=sdx)


def _both_stats(stats, dtype):
    """(reference CalibStats of jnp arrays, the port's) in ``dtype``."""
    import jax.numpy as jnp
    from repro.core import CalibStats as JCalibStats
    jst = JCalibStats(**{k: jnp.asarray(v, dtype) for k, v in stats.items()})
    return jst, from_jax_calib_stats(jst, "cpu")


def test_entropy_and_rate_equal():
    from repro.core import effective_rate as jrate
    from repro.core import empirical_entropy as jent
    from repro.core import huffman_bits as jhuff
    rng = np.random.default_rng(1)
    for z in (rng.integers(-9, 9, (37, 23)),
              np.rint(rng.standard_normal((64, 48)) * 4).astype(np.int32),
              np.array([[5]]), rng.integers(-2 ** 20, 2 ** 20, (8, 9))):
        assert empirical_entropy(z) == jent(z)
        assert empirical_entropy(torch.as_tensor(z)) == jent(z)
        assert effective_rate(z) == jrate(z)
        assert huffman_bits(z) == jhuff(z)


def test_rescalers_f64_match_reference():
    import jax.numpy as jnp
    from repro.core import find_optimal_rescalers as jrescalers
    w, st = _problem(dead=())
    rng = np.random.default_rng(5)
    w0 = np.rint(w / 0.05) * 0.05
    g0 = 1 + 0.1 * rng.standard_normal(w.shape[1])
    with _x64():
        want = jrescalers(*[jnp.asarray(v, jnp.float64) for v in (
            w0, w, st["sigma_x"], st["sigma_xhat"], st["sigma_x_xhat"],
            st["sigma_delta_xhat"])], gamma_init=jnp.asarray(g0))
        want_t, want_g = np.asarray(want.t), np.asarray(want.gamma)
    got = find_optimal_rescalers(*[torch.as_tensor(v) for v in (
        w0, w, st["sigma_x"], st["sigma_xhat"], st["sigma_x_xhat"],
        st["sigma_delta_xhat"])], gamma_init=torch.as_tensor(g0))
    assert got.iters == want.iters
    np.testing.assert_allclose(to_numpy(got.t), want_t, rtol=1e-6)
    np.testing.assert_allclose(to_numpy(got.gamma), want_g, rtol=1e-6)


def _assert_same_quant(got, want, *, c_tol=1e-9):
    assert np.array_equal(to_numpy(got.codes), np.asarray(want.codes))
    assert np.array_equal(got.dead_mask, want.dead_mask)
    assert abs(got.c - want.c) <= c_tol * abs(want.c)
    assert abs(got.entropy_bits - want.entropy_bits) <= 1e-9
    assert abs(got.rate_eff - want.rate_eff) <= 1e-9
    np.testing.assert_allclose(to_numpy(got.t), np.asarray(want.t),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(to_numpy(got.column_scale),
                               np.asarray(want.column_scale), rtol=1e-6)


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("n", [48, 160])
def test_watersic_quantize_f64_identical(method, n):
    import jax.numpy as jnp
    from repro.core import watersic_quantize as jquant
    w, st = _problem(n=n)
    kw = METHODS[method]
    with _x64():
        jst, tst = _both_stats(st, jnp.float64)
        want = jquant(jnp.asarray(w), jst, 0.02, **kw)
        got = watersic_quantize(torch.as_tensor(w), tst, 0.02, **kw)
        _assert_same_quant(got, want)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_quantize_at_rate_f64_identical(method):
    import jax.numpy as jnp
    from repro.core import quantize_at_rate as jqar
    w, st = _problem(n=64, a=200, seed=3)
    kw = METHODS[method]
    with _x64():
        jst, tst = _both_stats(st, jnp.float64)
        want = jqar(jnp.asarray(w), jst, 2.5, seed=7, **kw)
        got = quantize_at_rate(torch.as_tensor(w), tst, 2.5, seed=7, **kw)
        _assert_same_quant(got, want)
        assert abs(got.entropy_bits - 2.5) < 0.05


@pytest.mark.parametrize("method", sorted(METHODS))
def test_quantize_at_rate_f32_entropy(method):
    import jax.numpy as jnp
    from repro.core import quantize_at_rate as jqar
    w, st = _problem(n=96, a=160, seed=4)
    jst, tst = _both_stats(st, jnp.float32)
    kw = METHODS[method]
    want = jqar(jnp.asarray(w, jnp.float32), jst, 3.0, **kw)
    got = quantize_at_rate(torch.as_tensor(w, dtype=torch.float32), tst,
                           3.0, **kw)
    assert abs(got.entropy_bits - want.entropy_bits) <= 0.005
    assert got.codes.dtype == torch.int32
    assert got.dequant().shape == (160, 96)


def test_watersic_gap_on_plain_watersic():
    """Theorem 3.3: the measured WaterSIC gap is ½log₂(2πe/12) whatever the
    conditioning (tests/test_theory_gap.py's check, on the port)."""
    rng = np.random.default_rng(0)
    for cond, seed in [(10.0, 1), (1000.0, 3)]:
        n, a = 48, 16384
        sigma, _ = random_covariance(n, condition=cond, seed=seed)
        w = rng.standard_normal((a, n))
        out = plain_watersic(w, sigma, alpha=0.05)
        rate = float(column_entropies(out["codes"]).mean())
        gap = rate - high_rate_bound(out["distortion"], 1.0, sigma)
        assert abs(gap - GAP_CUBE_BITS) < 0.03, (cond, gap)


def test_plain_watersic_identical_to_reference():
    from repro.core import plain_watersic as jplain
    rng = np.random.default_rng(2)
    sigma, _ = random_covariance(32, condition=100.0, seed=5)
    w = rng.standard_normal((256, 32))
    got, want = plain_watersic(w, sigma, 0.1), jplain(w, sigma, 0.1)
    assert np.array_equal(got["codes"], want["codes"])
    assert got["entropy"] == want["entropy"]
    assert got["distortion"] == want["distortion"]
