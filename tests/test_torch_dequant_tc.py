"""The arithmetic of the tensor-core path of B1/B2 (``csrc/dequant_tc.cuh``)
held against the JAX package on the CPU.

The path computes ``t ⊙ ((x ⊙ s) @ zᵀ)`` as bf16 products: every code is
exact in bf16, and f32 x·s splits into three bf16 terms with no
remainder, so three bf16 products into an f32 accumulator compute the
f32 product up to the order of summation.

(a) ``ref.split_bf16_terms`` is exact on f32 values of normal magnitude,
    and every int8/int4/int3/int2 code is exact in bf16;
(b) ``ref.dequant_matmul_split_ref``, the path's arithmetic spelled out
    (bf16 codes × the three bf16 terms, f32 sums per K-tile), within
    1e-4 + 1e-4·|ref| of ``repro.kernels.dequant.ops.dequant_matmul_xla``
    and ``dequant_matmul_packed{,3,2}_xla``; over a 2^±20 dynamic range of
    x the three terms stay within it, where one term does not;
(c) the path rule: a call takes the tensor-core kernel from ``TC_MIN_M``
    rows on, the decode kernels below.

The kernels themselves run on the card (the ``cuda`` cases of
``tests/test_torch_dequant.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container without hypothesis (see fallback)
    from _hypothesis_fallback import given, settings, st

from _torch_parity import to_numpy
from repro_torch.core.packing import pack_codes_torch
from repro_torch.kernels.dequant import (PLANE_GROUPS, TC_MIN_M,
                                         dequant_matmul_split_ref,
                                         split_bf16_terms, unpack_payload_ref,
                                         uses_tensor_cores)

#: the card's tolerance of the dequant kernels against their twins
TOL = 1e-4
#: codes of each format: int8 and the planar payloads' ranges
CODE_RANGE = {8: (-128, 127), 4: (-8, 7), 3: (-4, 3), 2: (-2, 1)}


def _normal_f32(seed, lo, hi, size=4096):
    """f32 values with random sign and mantissa bits and exponents in
    [lo, hi]: every normal magnitude in range, ties of bf16 rounding
    included."""
    rng = np.random.default_rng(seed)
    bits = (rng.integers(0, 2, size, dtype=np.uint32) << 31) \
        | ((rng.integers(lo, hi + 1, size) + 127).astype(np.uint32) << 23) \
        | rng.integers(0, 1 << 23, size, dtype=np.uint32)
    return torch.from_numpy(bits.view(np.float32))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2 ** 31 - 1),
       lo=st.integers(min_value=-100, max_value=0),
       hi=st.integers(min_value=0, max_value=100))
def test_three_bf16_terms_are_exact(seed, lo, hi):
    """hi + mid + lo == v for finite f32 v of normal magnitude, each a
    bf16 value, each remainder below the last term's half ulp."""
    v = _normal_f32(seed, lo, hi)
    parts = split_bf16_terms(v)
    assert len(parts) == 3 and all(p.dtype == torch.bfloat16 for p in parts)
    total = sum(p.to(torch.float64) for p in parts)
    assert torch.equal(total, v.to(torch.float64))
    # one or two terms leave a remainder on most values
    for terms in (1, 2):
        short = sum(p.to(torch.float64) for p in split_bf16_terms(v, terms))
        assert (short != v.to(torch.float64)).float().mean() > 0.9


@pytest.mark.parametrize("nbits", [8, 4, 3, 2])
def test_every_code_is_exact_in_bf16(nbits):
    lo, hi = CODE_RANGE[nbits]
    codes = torch.arange(lo, hi + 1, dtype=torch.int32)
    assert torch.equal(codes.to(torch.bfloat16).to(torch.int32), codes)
    if nbits < 8:                      # as the kernel reads them: unpacked
        z = codes[None, :].repeat(3, 1)
        payload, er, _, _ = pack_codes_torch(z, nbits=nbits)
        assert er.numel() == 0
        back = unpack_payload_ref(payload, nbits)[:, :z.shape[1]]
        assert torch.equal(back.to(torch.bfloat16).to(torch.int32), z)


def _operands(m, k, n, nbits, seed, spread=0):
    """x (m, k), codes (n, k), s, t from a numpy seed (outputs O(1)).
    ``spread`` > 0 makes x = |N(0, 1)|·2^u, u uniform in [-spread,
    spread], and the codes non-negative: no output then cancels, so the
    f32 sums of either side stay within k·eps of |ref| and only the split
    can miss the tolerance."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k))
    lo, hi = CODE_RANGE[nbits]
    if spread:
        x = np.abs(x) * 2.0 ** rng.uniform(-spread, spread, (m, k))
        lo = 0
    z = rng.integers(lo, hi + 1, (n, k)).astype(np.int32)
    s = (rng.random(k) * 0.2 + 0.01) / np.sqrt(k) / (30 if nbits == 8 else 1)
    t = rng.random(n) + 0.5
    return (x.astype(np.float32), z, s.astype(np.float32),
            t.astype(np.float32))


def _reference(x, z, s, t, nbits):
    """The JAX package's XLA twin of the format, and the same operands
    as the emulation takes them: (want, x, codes, s) in f32 / int."""
    import jax.numpy as jnp
    from repro.kernels.dequant import ops as jops
    if nbits == 8:
        want = jops.dequant_matmul_xla(jnp.asarray(x), jnp.asarray(
            z.astype(np.int8)), jnp.asarray(s), jnp.asarray(t))
        return np.asarray(want), torch.from_numpy(x), torch.from_numpy(z), \
            torch.from_numpy(s)
    xla = {4: jops.dequant_matmul_packed_xla,
           3: jops.dequant_matmul_packed3_xla,
           2: jops.dequant_matmul_packed2_xla}[nbits]
    payload = pack_codes_torch(torch.from_numpy(z), nbits=nbits)[0]
    width = PLANE_GROUPS[nbits] * payload.shape[-1]
    pad = width - x.shape[1]
    xp = np.pad(x, ((0, 0), (0, pad)))
    sp = np.pad(s, (0, pad))
    want = xla(jnp.asarray(xp), jnp.asarray(to_numpy(payload)),
               jnp.asarray(sp), jnp.asarray(t))
    codes = unpack_payload_ref(payload, nbits).to(torch.int32)
    return np.asarray(want), torch.from_numpy(xp), codes, \
        torch.from_numpy(sp)


def _held(got, want):
    """Whether |got − want| ≤ TOL + TOL·|want| everywhere."""
    got = to_numpy(got)
    return bool(np.all(np.abs(got - want) <= TOL + TOL * np.abs(want)))


@pytest.mark.parametrize("k,n", [(301, 37), (200, 53)])
@pytest.mark.parametrize("m", [17, 128, 256])
@pytest.mark.parametrize("nbits", [8, 4, 3, 2])
def test_split_arithmetic_matches_jax(nbits, m, k, n):
    """bf16 codes × the three bf16 terms of x·s, f32 sums per K-tile of
    64, within 1e-4 + 1e-4·|ref| of the reference's XLA twin at ragged k
    and n."""
    x, z, s, t = _operands(m, k, n, nbits, seed=nbits * 1000 + m + k + n)
    want, xe, codes, se = _reference(x, z, s, t, nbits)
    got = dequant_matmul_split_ref(xe, codes, se, torch.from_numpy(t))
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert _held(got, want)


@pytest.mark.parametrize("nbits", [8, 4, 3, 2])
def test_three_terms_hold_a_wide_dynamic_range_where_one_does_not(nbits):
    """x over 2^±20: the three-term split stays within the tolerance of
    the reference, a one-term split (x·s rounded to bf16) does not."""
    x, z, s, t = _operands(17, 301, 37, nbits, seed=7 + nbits, spread=20)
    want, xe, codes, se = _reference(x, z, s, t, nbits)
    three = dequant_matmul_split_ref(xe, codes, se, torch.from_numpy(t))
    one = dequant_matmul_split_ref(xe, codes, se, torch.from_numpy(t),
                                   terms=1)
    assert _held(three, want)
    assert not _held(one, want)


def test_path_rule():
    """The tensor-core kernel from TC_MIN_M rows on, the decode kernels
    (m tiles of at most 16 rows) below; a pure function of m."""
    assert TC_MIN_M > 16
    assert not uses_tensor_cores(TC_MIN_M - 1)
    assert uses_tensor_cores(TC_MIN_M)
    for m in (1, 8, 16):
        assert not uses_tensor_cores(m)
    for m in (128, 256, 2304, 12000):
        assert uses_tensor_cores(m)
