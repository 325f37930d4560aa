"""Planar sub-byte packing of integer codes (port of ``repro/core/packing.py``).

The serving layouts (DESIGN.md §8/§10), byte-identical to the reference:

  * int4 — byte j holds column j (low nibble) and column j + K/2 (high
    nibble), two's complement; payload (..., K/2).
  * int3 — 8 planar column groups of width K/8; the biased value
    u = code + 4 spreads its three bits over three bytes: bit p of byte b
    is bit b of plane p's u; payload (..., 3, K/8).  Not sign-extended.
  * int2 — 4 planar column groups of width K/4; byte j carries group f's
    code at bits [2f, 2f+2), two's complement; payload (..., 1, K/4).

:func:`pack_codes_torch` is the reference's ``pack_codes_jnp``: clip,
pack, and export the clipped-away deltas as a COO list in (row, col)
order, the order the serving leaves keep.

The host archival container (numpy, byte-identical to the reference's):
:class:`PackedCodes` with numpy :func:`pack_codes` / :func:`unpack_codes`,
:func:`escapes_to_coo` and the exact ``storage_bits_per_entry``; the
paired nibble layout :func:`pack_int4` / :func:`unpack_int4` (byte j
holds columns 2j, 2j+1) and the int3/int2 host packers (the planar
layouts above).  Escapes are flat indices (uint32 below 2³² entries) with
their true int32 values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["pack_int4_planar", "unpack_int4_planar", "pack_int3_planar",
           "unpack_int3_planar", "pack_int2_planar", "unpack_int2_planar",
           "pack_codes_torch", "PAD_MULT", "CODE_RANGE", "pack_int4",
           "unpack_int4", "PackedCodes", "pack_codes", "unpack_codes",
           "escapes_to_coo", "shard_pad_cols"]

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


def pack_codes_torch(z: torch.Tensor, *, nbits: int = 4,
                     escape_capacity: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Pack integer codes ``z`` (a, n) + export escapes as COO.

    Returns ``(payload, esc_row, esc_col, esc_dval)`` exactly as the
    reference's ``pack_codes_jnp``: the payload of the clipped codes (n
    zero-padded to the layout's group multiple), and the list of entries
    the clip changed in (row, col) order (``torch.nonzero`` is
    lexicographic), with ``dval = z − clip(z)`` in f32.  With
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


# ---------------------------------------------------------------------------
# Host archival container
# ---------------------------------------------------------------------------


def _pack_int3_np(body: np.ndarray) -> np.ndarray:
    """Host twin of :func:`pack_int3_planar`: (a, 8·k) → (a, 3, k)."""
    a, n = body.shape
    u = (body.astype(np.int32) + 4) & 0x7
    planes = u.reshape(a, 8, n // 8)
    pw = (1 << np.arange(8, dtype=np.int32))[None, :, None]
    return np.stack([(((planes >> b) & 1) * pw).sum(axis=1)
                     for b in range(3)], axis=1).astype(np.uint8)


def _unpack_int3_np(payload: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_pack_int3_np` (sign-extended int8)."""
    p = payload.astype(np.int32)
    b0, b1, b2 = p[:, 0, :], p[:, 1, :], p[:, 2, :]
    cols = [((b0 >> pl) & 1) | (((b1 >> pl) & 1) << 1)
            | (((b2 >> pl) & 1) << 2) for pl in range(8)]
    return (np.concatenate(cols, axis=-1) - 4).astype(np.int8)


def _pack_int2_np(body: np.ndarray) -> np.ndarray:
    """Host twin of :func:`pack_int2_planar`: (a, 4·k) → (a, 1, k)."""
    a, n = body.shape
    u = body.astype(np.int32) & 0x3
    groups = u.reshape(a, 4, n // 4)
    shifts = (2 * np.arange(4, dtype=np.int32))[None, :, None]
    return (groups << shifts).sum(axis=1)[:, None, :].astype(np.uint8)


def _unpack_int2_np(payload: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_pack_int2_np` (sign-extended int8)."""
    p = payload.astype(np.int32)[:, 0, :]
    u = np.concatenate([(p >> (2 * f)) & 0x3 for f in range(4)], axis=-1)
    return np.where(u > 1, u - 4, u).astype(np.int8)


_RANGE = {2: (-2, 1), 3: (-4, 3), 4: (-8, 7), 8: (-128, 127)}
_PAD_MULT = {2: 4, 3: 8, 4: 2, 8: 1}


def shard_pad_cols(n: int, nbits: int, shards: int = 1) -> int:
    """Total zero-filled pad columns when ``n`` in-features are split into
    ``shards`` contiguous blocks and each block is planar-packed on its own.

    Every shard holds ``k_loc = ceil(n/shards)`` columns (the last block's
    ragged tail is zero-filled up to ``k_loc``), then pads ``k_loc`` up to
    the format's planar group multiple.  With ``shards=1`` this reduces to
    the classic ``(-n) % _PAD_MULT[nbits]``.  Pad columns carry code 0 and
    scale 0, so they contribute nothing to the matmul — but they DO occupy
    payload bytes, which is why byte accounting must know about them.
    """
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    k_loc = -(-n // shards)
    mult = _PAD_MULT[nbits]
    return shards * mult * (-(-k_loc // mult)) - n


def pack_int4(z: np.ndarray) -> np.ndarray:
    """Pack int values in [-8, 7] into uint8 nibbles (pairs along axis -1)."""
    z = np.asarray(z)
    if z.shape[-1] % 2:
        raise ValueError("last dim must be even for int4 packing")
    if z.min() < -8 or z.max() > 7:
        raise ValueError("int4 range exceeded")
    u = (z.astype(np.int16) & 0xF).astype(np.uint8)
    lo, hi = u[..., 0::2], u[..., 1::2]
    return (lo | (hi << 4)).astype(np.uint8)


def unpack_int4(packed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_int4` (sign-extended)."""
    p = np.asarray(packed, dtype=np.uint8)
    lo = (p & 0xF).astype(np.int8)
    hi = (p >> 4).astype(np.int8)
    lo = np.where(lo > 7, lo - 16, lo).astype(np.int8)
    hi = np.where(hi > 7, hi - 16, hi).astype(np.int8)
    out = np.empty(p.shape[:-1] + (p.shape[-1] * 2,), dtype=np.int8)
    out[..., 0::2] = lo
    out[..., 1::2] = hi
    return out


@dataclass
class PackedCodes:
    """Packed code matrix + escape list for out-of-range entries."""

    payload: np.ndarray          # uint8 (int4/int3/int2 planes) or int8
    nbits: int                   # 2, 3, 4 or 8
    shape: Tuple[int, int]
    escape_idx: np.ndarray       # flat indices of escapes (uint32 when the
                                 # matrix has < 2³² entries, else int64)
    escape_val: np.ndarray       # their true values (int32)
    shards: int = 1              # in-feature shard count the payload was
                                 # packed for (each shard padded on its own)

    @property
    def storage_bits_per_entry(self) -> float:
        """Exact bits/entry: excludes pad columns (odd-n nibble for int4,
        the up-to-7 zero columns of the int3 8-group, up-to-3 of the int2
        4-group — per shard when the payload is k-sharded, since every
        shard zero-fills its own tail) and uses the actual escape-index
        width."""
        a, n = self.shape
        payload_bits = self.payload.size * 8
        pad_cols = shard_pad_cols(n, self.nbits, self.shards)
        payload_bits -= a * self.nbits * pad_cols    # pad is not payload
        idx_bits = self.escape_idx.dtype.itemsize * 8
        esc = self.escape_idx.size * (idx_bits + 32)
        return (payload_bits + esc) / (a * n)


def pack_codes(z: np.ndarray, nbits: int = 4) -> PackedCodes:
    z = np.asarray(z)
    a, n = z.shape
    if nbits not in _RANGE:
        raise ValueError("nbits must be 2, 3, 4 or 8")
    lo, hi = _RANGE[nbits]
    clipped = np.clip(z, lo, hi)
    esc = np.nonzero((z < lo) | (z > hi))
    idx_dtype = np.uint32 if z.size <= np.iinfo(np.uint32).max else np.int64
    flat_idx = np.ravel_multi_index(esc, z.shape).astype(idx_dtype)
    esc_val = z[esc].astype(np.int32)
    body = clipped.astype(np.int8)
    pad = (-n) % _PAD_MULT[nbits]
    if pad:
        body = np.concatenate([body, np.zeros((a, pad), np.int8)], axis=1)
    if nbits == 4:
        payload = pack_int4(body)
    elif nbits == 3:
        payload = _pack_int3_np(body)
    elif nbits == 2:
        payload = _pack_int2_np(body)
    else:
        payload = body
    return PackedCodes(payload=payload, nbits=nbits, shape=(a, n),
                       escape_idx=flat_idx, escape_val=esc_val)


def unpack_codes(p: PackedCodes) -> np.ndarray:
    a, n = p.shape
    if p.nbits == 4:
        body = unpack_int4(p.payload)[:, :n].astype(np.int32)
    elif p.nbits == 3:
        body = _unpack_int3_np(p.payload)[:, :n].astype(np.int32)
    elif p.nbits == 2:
        body = _unpack_int2_np(p.payload)[:, :n].astype(np.int32)
    else:
        body = p.payload.astype(np.int32)
    out = body.copy()
    if p.escape_idx.size:
        out.ravel()[p.escape_idx.astype(np.int64)] = p.escape_val
    return out


def escapes_to_coo(p: PackedCodes
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, cols, dval) of the escapes: the sparse *delta* correction.

    ``dval = true - clip(true, range)`` matches the convention of
    :func:`pack_codes_torch`, so the serving kernels apply escapes from either
    producer identically.
    """
    _, n = p.shape
    idx = p.escape_idx.astype(np.int64)
    rows = (idx // n).astype(np.int32)
    cols = (idx % n).astype(np.int32)
    lo, lim = _RANGE[p.nbits]
    dval = (p.escape_val - np.clip(p.escape_val, lo, lim)).astype(np.float32)
    return rows, cols, dval
