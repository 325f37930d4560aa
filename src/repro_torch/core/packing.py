"""Planar sub-byte packing of integer codes (port of ``repro/core/packing.py``).

The serving layouts (DESIGN.md §8/§10), byte-identical to the reference:

  * int4 — byte j holds column j (low nibble) and column j + K/2 (high
    nibble), two's complement; payload (..., K/2).
  * int3 — 8 planar column groups of width K/8; the biased value
    u = code + 4 spreads its three bits over three bytes: bit p of byte b
    is bit b of plane p's u; payload (..., 3, K/8).  Not sign-extended.
  * int2 — 4 planar column groups of width K/4; byte j carries group f's
    code at bits [2f, 2f+2), two's complement; payload (..., 1, K/4).

:func:`pack_codes` is the reference's ``pack_codes_jnp``: clip, pack, and
export the clipped-away deltas as a row-major COO list.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["pack_int4_planar", "unpack_int4_planar", "pack_int3_planar",
           "unpack_int3_planar", "pack_int2_planar", "unpack_int2_planar",
           "pack_codes", "PAD_MULT", "CODE_RANGE"]

#: payload nbits → (lo, hi) two's-complement code range
CODE_RANGE = {2: (-2, 1), 3: (-4, 3), 4: (-8, 7)}
#: payload nbits → in-feature multiple the planar layout pads to
PAD_MULT = {2: 4, 3: 8, 4: 2}


def pack_int4_planar(z: torch.Tensor) -> torch.Tensor:
    """``z`` (..., K), K even, values in [-8, 7] → uint8 (..., K/2)."""
    if z.shape[-1] % 2:
        raise ValueError("last dim must be even for planar int4 packing")
    kh = z.shape[-1] // 2
    zi = z.to(torch.int32)
    lo = zi[..., :kh] & 0xF
    hi = zi[..., kh:] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4_planar(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_planar` (sign-extended int8)."""
    p = packed.to(torch.int32)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def pack_int3_planar(z: torch.Tensor) -> torch.Tensor:
    """``z`` (..., K), K a multiple of 8, values in [-4, 3] → uint8
    (..., 3, K/8) bit planes."""
    if z.shape[-1] % 8:
        raise ValueError("last dim must be a multiple of 8 for int3 packing")
    k8 = z.shape[-1] // 8
    u = (z.to(torch.int32) + 4) & 0x7
    planes = u.reshape(z.shape[:-1] + (8, k8))              # (..., plane, i)
    pw = (1 << torch.arange(8, dtype=torch.int32, device=z.device))[:, None]
    bytes_ = [(((planes >> b) & 1) * pw).sum(dim=-2) for b in range(3)]
    return torch.stack(bytes_, dim=-2).to(torch.uint8)


def unpack_int3_planar(payload: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int3_planar` (int8 codes, u − 4)."""
    p = payload.to(torch.int32)
    b0, b1, b2 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    cols = [((b0 >> pl) & 1) | (((b1 >> pl) & 1) << 1)
            | (((b2 >> pl) & 1) << 2) for pl in range(8)]
    return (torch.cat(cols, dim=-1) - 4).to(torch.int8)


def pack_int2_planar(z: torch.Tensor) -> torch.Tensor:
    """``z`` (..., K), K a multiple of 4, values in [-2, 1] → uint8
    (..., 1, K/4); the singleton plane axis tags the format."""
    if z.shape[-1] % 4:
        raise ValueError("last dim must be a multiple of 4 for int2 packing")
    k4 = z.shape[-1] // 4
    u = z.to(torch.int32) & 0x3
    groups = u.reshape(z.shape[:-1] + (4, k4))              # (..., field, i)
    shifts = (2 * torch.arange(4, dtype=torch.int32,
                               device=z.device))[:, None]
    byte = (groups << shifts).sum(dim=-2)
    return byte[..., None, :].to(torch.uint8)


def unpack_int2_planar(payload: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int2_planar` (sign-extended int8)."""
    p = payload.to(torch.int32)[..., 0, :]
    u = torch.cat([(p >> (2 * f)) & 0x3 for f in range(4)], dim=-1)
    return torch.where(u > 1, u - 4, u).to(torch.int8)


_PACKERS = {4: pack_int4_planar, 3: pack_int3_planar, 2: pack_int2_planar}


def pack_codes(z: torch.Tensor, *, nbits: int = 4,
               escape_capacity: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Pack integer codes ``z`` (a, n) + export escapes as COO.

    Returns ``(payload, esc_row, esc_col, esc_dval)`` exactly as the
    reference's ``pack_codes_jnp``: the payload of the clipped codes (n
    zero-padded to the layout's group multiple), and the row-major list of
    entries the clip changed, with ``dval = z − clip(z)`` in f32.  With
    ``escape_capacity`` the COO arrays have that length, padded with
    (row 0, col 0, dval 0); a capacity below the escape count raises.
    """
    if nbits not in _PACKERS:
        raise ValueError("nbits must be 2, 3 or 4")
    a, n = z.shape
    lo, hi = CODE_RANGE[nbits]
    clipped = z.clamp(lo, hi)
    body = clipped.to(torch.int8)
    pad = (-n) % PAD_MULT[nbits]
    if pad:
        body = torch.cat([body, body.new_zeros((a, pad))], dim=1)
    payload = _PACKERS[nbits](body)
    delta = (z - clipped).to(torch.float32)
    rows, cols = torch.nonzero(delta != 0, as_tuple=True)   # row-major order
    dval = delta[rows, cols]
    if escape_capacity is not None:
        nnz = rows.shape[0]
        if nnz > escape_capacity:
            raise ValueError(
                f"escape_capacity={escape_capacity} < {nnz} escapes — "
                "the truncated corrections would serve corrupted weights")
        fill = escape_capacity - nnz
        rows = torch.cat([rows, rows.new_zeros(fill)])
        cols = torch.cat([cols, cols.new_zeros(fill)])
        dval = torch.cat([dval, dval.new_zeros(fill)])
    return (payload, rows.to(torch.int32), cols.to(torch.int32),
            dval.to(torch.float32))
