"""Port of the GPTQ baseline, the rANS coder and the host packing container
held against the JAX package.

* ``repro_torch.core.gptq`` against ``repro.core.gptq`` (the cases of
  tests/test_gptq_equiv.py): numpy inputs give byte-identical codes and
  equal distortions; the flip equivalence of ``gptq_frantar`` and
  ``gptq_via_zsic`` holds code for code; a float64 CPU tensor runs ZSIC
  blocked (the twin of the in-block kernel) and gives the numpy codes.
* ``repro_torch.core.rans.RansCodec`` against ``repro.core.rans``
  (tests/test_rans.py's cases): equal frequency tables, equal bytes from
  ``encode``, exact round trips, equal ``measure_bits_per_symbol``.
* ``repro_torch.core.packing`` host container against
  ``repro.core.packing`` (tests/test_packing.py's cases): byte-identical
  payloads, escape indices and values, COO lists and bits per entry.

Inputs come from numpy seeds.  The card test (``cuda``) runs GPTQ through
the ZSIC kernel in f32 and holds its codes to float64 ``gptq_frantar``.
"""
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container without hypothesis (see fallback)
    from _hypothesis_fallback import given, settings, st

from _torch_parity import assert_same_ints, require_cuda, to_numpy
from repro_torch.core import (escapes_to_coo, gptq_frantar, gptq_via_zsic,
                              huffman_gptq, pack_codes, pack_int4,
                              random_covariance, rate_log_cardinality,
                              unpack_codes, unpack_int4)
from repro_torch.core.rans import RansCodec


# ---------------------------------------------------------------------------
# GPTQ (tests/test_gptq_equiv.py)
# ---------------------------------------------------------------------------


def test_frantar_equals_zsic_flip():
    """Textbook OPTQ (cols 1..n) is code-exact with ZSIC on the reversed
    coordinate order, and each side equals the reference's."""
    from repro.core import gptq_frantar as jfrantar
    from repro.core import gptq_via_zsic as jzsic
    rng = np.random.default_rng(3)
    for seed in (0, 1, 2):
        n, a = 24, 8
        sigma, _ = random_covariance(n, condition=30.0, seed=seed + 10)
        w = rng.standard_normal((a, n))
        alpha = 0.1
        p = np.arange(n)[::-1]
        out_f = gptq_frantar(w, sigma, alpha)
        out_z = gptq_via_zsic(w[:, p], sigma[np.ix_(p, p)], alpha)
        np.testing.assert_array_equal(out_f["codes"],
                                      out_z["codes"][:, ::-1])
        assert abs(out_f["distortion"] - out_z["distortion"]) < 1e-12
        ref_f = jfrantar(w, sigma, alpha)
        ref_z = jzsic(w[:, p], sigma[np.ix_(p, p)], alpha)
        assert_same_ints(out_f["codes"], ref_f["codes"])
        assert_same_ints(out_z["codes"], ref_z["codes"])
        assert out_f["distortion"] == ref_f["distortion"]
        assert out_z["distortion"] == ref_z["distortion"]
        assert out_z["entropy"] == ref_z["entropy"]


def test_maxq_clipping_increases_distortion():
    from repro.core import gptq_frantar as jfrantar
    rng = np.random.default_rng(4)
    n, a = 16, 32
    sigma, _ = random_covariance(n, condition=10.0, seed=1)
    w = rng.standard_normal((a, n)) * 3
    free = gptq_frantar(w, sigma, 0.5, maxq=0)
    clip = gptq_frantar(w, sigma, 0.5, maxq=2)
    assert clip["distortion"] >= free["distortion"]
    assert np.abs(clip["codes"]).max() <= 2
    assert_same_ints(clip["codes"], jfrantar(w, sigma, 0.5, maxq=2)["codes"])
    assert rate_log_cardinality(2) == np.log2(5)


def test_damping_runs_and_regularizes():
    from repro.core import gptq_frantar as jfrantar
    rng = np.random.default_rng(5)
    n, a = 16, 8
    sigma, _ = random_covariance(n, condition=1e8, decay="two-level", seed=2)
    w = rng.standard_normal((a, n))
    out = gptq_frantar(w, sigma, 0.1, damp=0.1)
    assert np.isfinite(out["w_hat"]).all()
    assert_same_ints(out["codes"], jfrantar(w, sigma, 0.1, damp=0.1)["codes"])


def test_huffman_gptq_matches_reference():
    from repro.core.gptq import huffman_gptq as jhuff
    rng = np.random.default_rng(6)
    sigma, _ = random_covariance(40, condition=50.0, seed=3)
    w = rng.standard_normal((30, 40))
    got, want = huffman_gptq(w, sigma, 0.07), jhuff(w, sigma, 0.07)
    assert_same_ints(got["codes"], want["codes"])
    for key in ("rate", "huffman_bits", "distortion"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("n,a", [(24, 8), (200, 17)])
def test_tensor_path_runs_blocked_zsic_with_numpy_codes(n, a):
    """A float64 CPU tensor goes through ``zsic_blocked`` (the in-block
    twin, blocks of 128 columns): the codes of the float64 numpy path."""
    rng = np.random.default_rng(n)
    sigma, _ = random_covariance(n, condition=30.0, seed=n)
    w = rng.standard_normal((a, n))
    want = gptq_via_zsic(w, sigma, 0.05)
    got = gptq_via_zsic(torch.as_tensor(w), torch.as_tensor(sigma), 0.05)
    assert isinstance(got["codes"], torch.Tensor)
    np.testing.assert_array_equal(to_numpy(got["codes"]), want["codes"])
    assert abs(got["distortion"] - want["distortion"]) \
        <= 1e-9 * want["distortion"]
    assert got["entropy"] == want["entropy"]


# ---------------------------------------------------------------------------
# rANS (tests/test_rans.py)
# ---------------------------------------------------------------------------


def _same_codec(z):
    """Port and reference codecs of ``z``: equal tables, equal bytes, exact
    round trip; returns the port's payload."""
    from repro.core.rans import RansCodec as JRans
    c, jc = RansCodec.from_data(z), JRans.from_data(z)
    for f in ("symbols", "freqs", "starts"):
        np.testing.assert_array_equal(getattr(c, f), getattr(jc, f))
    payload = c.encode(z)
    assert payload == jc.encode(z)
    np.testing.assert_array_equal(c.decode(payload, z.size), z)
    assert c.measure_bits_per_symbol(z) == jc.measure_bits_per_symbol(z)
    assert c.table_bits == jc.table_bits
    return payload


def test_rans_roundtrip_and_rate():
    from repro_torch.core import empirical_entropy
    rng = np.random.default_rng(0)
    z = (rng.standard_normal(8192) * 1.2).round().astype(np.int64)
    payload = _same_codec(z)
    bits = 8 * len(payload) / z.size
    h = empirical_entropy(z)
    assert h - 1e-6 <= bits <= h + 0.05


def test_rans_beats_huffman_when_skewed():
    from repro_torch.core import huffman_bits
    rng = np.random.default_rng(1)
    z = (rng.standard_normal(16384) * 0.5).round().astype(np.int64)
    _same_codec(z)
    rb = RansCodec.from_data(z).measure_bits_per_symbol(z)
    assert rb < huffman_bits(z.reshape(-1, 1)) - 0.05


def test_rans_single_symbol_and_unknown_symbol():
    _same_codec(np.zeros(100, np.int64))
    c = RansCodec.from_data(np.array([0, 1, 2]))
    with pytest.raises(ValueError):
        c.encode(np.array([5]))


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1000), n=st.integers(1, 2000),
       scale=st.floats(0.1, 8.0))
def test_property_rans_equal_bytes(seed, n, scale):
    rng = np.random.default_rng(seed)
    _same_codec((rng.standard_normal(n) * scale).round().astype(np.int64))


# ---------------------------------------------------------------------------
# host packing container (tests/test_packing.py)
# ---------------------------------------------------------------------------


def _same_container(z, nbits):
    """Port and reference ``pack_codes``: byte-identical payload, escape
    indices and values, bits per entry and COO; exact unpack."""
    from repro.core import escapes_to_coo as jcoo
    from repro.core import pack_codes as jpack
    p, jp = pack_codes(z, nbits=nbits), jpack(z, nbits=nbits)
    assert p.shape == jp.shape and p.nbits == jp.nbits
    for f in ("payload", "escape_idx", "escape_val"):
        assert_same_ints(getattr(p, f), getattr(jp, f))
    assert p.storage_bits_per_entry == jp.storage_bits_per_entry
    for a, b in zip(escapes_to_coo(p), jcoo(jp)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(unpack_codes(p), z)
    return p


def test_int4_paired_roundtrip():
    from repro.core import pack_int4 as jpack4
    rng = np.random.default_rng(0)
    z = rng.integers(-8, 8, size=(16, 32))
    assert_same_ints(pack_int4(z), jpack4(z))
    np.testing.assert_array_equal(unpack_int4(pack_int4(z)), z)


@pytest.mark.parametrize("nbits,lo,hi", [(4, -8, 8), (3, -4, 4), (2, -2, 2)])
def test_pack_codes_with_escapes(nbits, lo, hi):
    rng = np.random.default_rng(1)
    z = rng.integers(lo, hi, size=(8, 10)).astype(np.int64)
    z[3, 4] = 1000
    z[7, 9] = -77
    p = _same_container(z, nbits)
    assert p.escape_idx.size == 2
    rows, cols, dval = escapes_to_coo(p)
    body = unpack_codes(pack_codes(np.clip(z, lo, hi - 1),
                                   nbits=nbits)).astype(np.float64)
    body[rows, cols] += dval
    np.testing.assert_array_equal(body, z)


def test_pack_codes_int8():
    rng = np.random.default_rng(2)
    z = rng.integers(-128, 128, size=(9, 7)).astype(np.int64)
    assert _same_container(z, 8).storage_bits_per_entry == 8.0


@pytest.mark.parametrize("nbits,n,payload_shape,bits", [
    (4, 5, (6, 3), 4.0), (3, 13, (6, 3, 2), 3.0), (2, 13, (6, 1, 4), 2.0)])
def test_storage_bits_exact_with_pad(nbits, n, payload_shape, bits):
    """Pad columns are not payload; small matrices get uint32 indices."""
    z = np.zeros((6, n), np.int64)
    p = _same_container(z, nbits)
    assert p.payload.shape == payload_shape
    assert p.storage_bits_per_entry == bits
    assert p.escape_idx.dtype == np.uint32
    z[1, 2] = 99
    p2 = _same_container(z, nbits)
    assert p2.storage_bits_per_entry == (6 * n * nbits + 64) / (6 * n)


def test_escapes_to_coo_matches_packed_delta():
    rng = np.random.default_rng(7)
    z = rng.integers(-30, 30, size=(12, 9)).astype(np.int64)
    p = _same_container(z, 4)
    rows, cols, dval = escapes_to_coo(p)
    body = unpack_codes(pack_codes(np.clip(z, -8, 7),
                                   nbits=4)).astype(np.float64)
    body[rows, cols] += dval
    np.testing.assert_array_equal(body, z)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), rows=st.integers(1, 32),
       cols=st.integers(1, 33), scale=st.floats(0.5, 50.0))
def test_property_container_equal_bytes(seed, rows, cols, scale):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((rows, cols)) * scale).round().astype(np.int64)
    for nbits in (2, 3, 4, 8):
        _same_container(z, nbits)


# ---------------------------------------------------------------------------
# card: GPTQ through the ZSIC kernel
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_gptq_through_kernel_agrees_with_frantar():
    """f32 GPTQ on the card (ZSIC through the in-block kernel) against
    float64 ``gptq_frantar`` on the flipped order: ≥ 99.9 % of the codes
    equal (f32 rounding flips a few near-ties), distortion within 1 %."""
    from repro_torch.kernels.zsic import reset_launches, zsic_block_cuda
    dev = require_cuda()
    n, a = 384, 96
    rng = np.random.default_rng(8)
    sigma, _ = random_covariance(n, condition=30.0, seed=9)
    w = rng.standard_normal((a, n))
    p = np.arange(n)[::-1]
    reset_launches()
    got = gptq_via_zsic(torch.as_tensor(w[:, p], dtype=torch.float32,
                                        device=dev),
                        torch.as_tensor(sigma[np.ix_(p, p)],
                                        dtype=torch.float32, device=dev),
                        0.05)
    assert zsic_block_cuda.launches == n // 128
    want = gptq_frantar(w, sigma, 0.05)
    agree = (to_numpy(got["codes"])[:, ::-1] == want["codes"]).mean()
    assert agree >= 0.999, agree
    assert abs(got["distortion"] - want["distortion"]) \
        <= 0.01 * want["distortion"]
