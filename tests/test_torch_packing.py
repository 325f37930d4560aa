"""Port of the planar packers held against ``repro.core.packing``.

Payloads and escape COO lists must be byte-identical to the reference's
(``pack_int{4,3,2}_planar_jnp``, ``pack_codes_jnp``); the unpackers must
invert the packers.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_same_ints
from repro_torch.core.packing import (pack_codes_torch, pack_int2_planar,
                                      pack_int3_planar, pack_int4_planar,
                                      unpack_int2_planar, unpack_int3_planar,
                                      unpack_int4_planar)

_PLANAR = {4: (pack_int4_planar, unpack_int4_planar, 2, (-8, 7)),
           3: (pack_int3_planar, unpack_int3_planar, 8, (-4, 3)),
           2: (pack_int2_planar, unpack_int2_planar, 4, (-2, 1))}


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_planar_pack_matches_jax(nbits, lead):
    """vs repro.core.packing.pack_/unpack_int{nbits}_planar_jnp, including
    a layer-stacked leading axis; every code of the range appears."""
    import jax.numpy as jnp
    from repro.core import packing as jp

    pack, unpack, mult, (lo, hi) = _PLANAR[nbits]
    jpack = getattr(jp, f"pack_int{nbits}_planar_jnp")
    junpack = getattr(jp, f"unpack_int{nbits}_planar_jnp")
    rng = np.random.default_rng(nbits)
    z = rng.integers(lo, hi + 1, lead + (7, 5 * mult)).astype(np.int8)
    z.reshape(-1)[: hi - lo + 1] = np.arange(lo, hi + 1)
    got = pack(torch.from_numpy(z))
    assert_same_ints(got, jpack(jnp.asarray(z)))
    assert_same_ints(unpack(got), junpack(jpack(jnp.asarray(z))))
    np.testing.assert_array_equal(unpack(got).numpy(), z)


@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_planar_pack_rejects_ragged_width(nbits):
    pack, _, mult, _ = _PLANAR[nbits]
    with pytest.raises(ValueError):
        pack(torch.zeros((2, mult + 1), dtype=torch.int8))


@pytest.mark.parametrize("capacity", [None, 40])
@pytest.mark.parametrize("n", [1, 9, 33])
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_pack_codes_matches_jax(nbits, n, capacity):
    """vs repro.core.packing.pack_codes_jnp: odd widths (capacity padding
    of the payload), saturated codes at both range ends, escapes in
    row-major COO order, fixed escape capacity."""
    import jax.numpy as jnp
    from repro.core.packing import pack_codes_jnp

    lo, hi = _PLANAR[nbits][3]
    rng = np.random.default_rng(100 * nbits + n)
    z = rng.integers(lo, hi + 1, (6, n)).astype(np.int32)
    z[0, 0] = lo                       # saturated, not an escape
    z[-1, -1] = hi
    z[2, n // 2] = hi + 9              # escapes, both signs
    z[4, 0] = lo - 30
    z[5, n - 1] = hi + 1
    want = pack_codes_jnp(jnp.asarray(z), nbits=nbits,
                          escape_capacity=capacity)
    got = pack_codes_torch(torch.from_numpy(z), nbits=nbits,
                     escape_capacity=capacity)
    for a, b in zip(got, want):
        assert_same_ints(a, b)
    assert got[3].dtype == torch.float32
    assert int((got[3] != 0).sum()) == 3


def test_pack_codes_rejects_short_capacity():
    z = torch.zeros((2, 4), dtype=torch.int32)
    z[0, 1] = 50
    z[1, 3] = -50
    with pytest.raises(ValueError, match="escape_capacity"):
        pack_codes_torch(z, nbits=4, escape_capacity=1)
    with pytest.raises(ValueError):
        pack_codes_torch(z, nbits=5)
