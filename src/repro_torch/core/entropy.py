"""Entropy estimation and lossless coding of integer code matrices (port
of ``repro/core/entropy.py``; numpy, host-side).

WaterSIC replaces range-limiting scaling with entropy coding (paper §1, §4
"Entropy coding"): the ZSIC output ``Z`` is an (a, n) matrix of (possibly
unbounded) integers; its description length is measured by empirical entropy
and realized by a standard lossless codec.  This module provides:

  * ``empirical_entropy``      — bits/entry from the value histogram,
  * ``column_entropies``       — per-in-channel rates (paper Fig. 5),
  * ``HuffmanCode``            — an exact Huffman codec (encode/decode round
                                 trip, measured bits), the "EC" of Alg. 2,
  * ``codec_bits_zlib/lzma``   — stdlib codecs on int8/int16-packed streams
                                 (paper Table 6 uses zstd/LZMA; we use
                                 zlib/LZMA which are available offline),
  * ``effective_rate``         — Alg. 3 Phase 3: H + 16/a + 16/n overhead for
                                 row/column BF16 rescalers.

All functions accept numpy arrays or tensors (copied to the host);
computation is host-side numpy (entropy coding is a host/storage concern —
see DESIGN.md §4.2).
"""
from __future__ import annotations

import heapq
import lzma
import zlib
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

__all__ = [
    "empirical_entropy",
    "column_entropies",
    "effective_rate",
    "HuffmanCode",
    "huffman_bits",
    "codec_bits_zlib",
    "codec_bits_lzma",
    "serialize_codes",
]


def _as_int_numpy(z) -> np.ndarray:
    if hasattr(z, "detach"):                      # a tensor, on any device
        z = z.detach().cpu().numpy()
    z = np.asarray(z)
    if not np.issubdtype(z.dtype, np.integer):
        zi = np.rint(z).astype(np.int64)
        if not np.allclose(z, zi, atol=1e-6):
            raise ValueError("entropy coding expects integer codes")
        z = zi
    return z.astype(np.int64)


def empirical_entropy(z) -> float:
    """Empirical Shannon entropy in bits/entry of the flattened codes."""
    z = _as_int_numpy(z).ravel()
    if z.size == 0:
        return 0.0
    lo, hi = int(z.min()), int(z.max())
    if hi - lo < 4 * z.size:
        # the counts of np.unique in the same (sorted) order, in O(size)
        counts = np.bincount(z - lo, minlength=hi - lo + 1)
        counts = counts[counts > 0]
    else:
        _, counts = np.unique(z, return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log2(p)).sum())


def column_entropies(z) -> np.ndarray:
    """Per-column entropy in bits/entry — the unequal-rate picture (Fig. 5)."""
    z = _as_int_numpy(z)
    if z.ndim != 2:
        raise ValueError("expected an (a, n) code matrix")
    return np.array([empirical_entropy(z[:, j]) for j in range(z.shape[1])])


def effective_rate(z, *, row_overhead_bits: int = 16,
                   col_overhead_bits: int = 16) -> float:
    """Alg. 3 Phase 3: R_eff = H(Z) + 16/a + 16/n (BF16 rescaler overheads)."""
    z = _as_int_numpy(z)
    a, n = z.shape
    return empirical_entropy(z) + row_overhead_bits / a + col_overhead_bits / n


# ---------------------------------------------------------------------------
# Huffman codec
# ---------------------------------------------------------------------------


@dataclass
class HuffmanCode:
    """Canonical Huffman code built from empirical symbol counts.

    The codebook itself (symbol list + code lengths) is the side information;
    its cost is negligible for a >> 1 (paper §3.2) but we report it anyway in
    ``table_bits``.
    """

    lengths: Dict[int, int]
    codes: Dict[int, Tuple[int, int]]  # symbol -> (bits, nbits)

    @staticmethod
    def from_counts(counts: Dict[int, int]) -> "HuffmanCode":
        if not counts:
            raise ValueError("empty alphabet")
        if len(counts) == 1:
            sym = next(iter(counts))
            return HuffmanCode(lengths={sym: 1}, codes={sym: (0, 1)})
        # Build Huffman tree with a heap of (count, tiebreak, node).
        heap = []
        for i, (sym, c) in enumerate(sorted(counts.items())):
            heapq.heappush(heap, (c, i, ("leaf", sym)))
        nxt = len(heap)
        while len(heap) > 1:
            c1, _, n1 = heapq.heappop(heap)
            c2, _, n2 = heapq.heappop(heap)
            heapq.heappush(heap, (c1 + c2, nxt, ("node", n1, n2)))
            nxt += 1
        lengths: Dict[int, int] = {}

        def walk(node, depth):
            if node[0] == "leaf":
                lengths[node[1]] = max(depth, 1)
            else:
                walk(node[1], depth + 1)
                walk(node[2], depth + 1)

        walk(heap[0][2], 0)
        # Canonicalize: assign codes by (length, symbol).
        codes: Dict[int, Tuple[int, int]] = {}
        code = 0
        prev_len = 0
        for sym in sorted(lengths, key=lambda s: (lengths[s], s)):
            L = lengths[sym]
            code <<= L - prev_len
            codes[sym] = (code, L)
            code += 1
            prev_len = L
        return HuffmanCode(lengths=lengths, codes=codes)

    @staticmethod
    def from_data(z) -> "HuffmanCode":
        z = _as_int_numpy(z).ravel()
        return HuffmanCode.from_counts(Counter(z.tolist()))

    # -- measurement ------------------------------------------------------
    def measure_bits(self, z) -> int:
        z = _as_int_numpy(z).ravel()
        syms, counts = np.unique(z, return_counts=True)
        total = 0
        for s, c in zip(syms.tolist(), counts.tolist()):
            total += self.codes[s][1] * c
        return total

    @property
    def table_bits(self) -> int:
        # symbol (32b) + length (8b) per alphabet entry
        return 40 * len(self.lengths)

    # -- encode / decode ----------------------------------------------------
    def encode(self, z) -> Tuple[bytes, int]:
        """Encode flattened codes; returns (payload bytes, bit length)."""
        z = _as_int_numpy(z).ravel()
        bits = np.empty(sum(self.codes[int(s)][1] for s in z), dtype=np.uint8)
        pos = 0
        for s in z.tolist():
            code, L = self.codes[s]
            for k in range(L - 1, -1, -1):
                bits[pos] = (code >> k) & 1
                pos += 1
        payload = np.packbits(bits).tobytes()
        return payload, int(pos)

    def decode(self, payload: bytes, nbits: int, count: int) -> np.ndarray:
        bits = np.unpackbits(np.frombuffer(payload, dtype=np.uint8))[:nbits]
        # Build decoding trie as dict of (code, len) -> symbol.
        rev = {v: k for k, v in self.codes.items()}
        out = np.empty(count, dtype=np.int64)
        acc, L, j = 0, 0, 0
        for b in bits.tolist():
            acc = (acc << 1) | b
            L += 1
            if (acc, L) in rev:
                out[j] = rev[(acc, L)]
                j += 1
                acc, L = 0, 0
                if j == count:
                    break
        if j != count:
            raise ValueError("truncated Huffman stream")
        return out


def huffman_bits(z, *, per_column: bool = False) -> float:
    """Measured Huffman bits/entry (joint over the matrix, or per-column sums).

    Paper §4 "Entropy coding": joint coding of the whole matrix loses
    negligible rate vs per-column coding; both are provided.
    """
    z = _as_int_numpy(z)
    total_entries = z.size
    if not per_column:
        hc = HuffmanCode.from_data(z)
        return hc.measure_bits(z) / total_entries
    bits = 0
    for j in range(z.shape[1]):
        hc = HuffmanCode.from_data(z[:, j])
        bits += hc.measure_bits(z[:, j])
    return bits / total_entries


# ---------------------------------------------------------------------------
# stdlib codecs (paper Table 6 cross-check)
# ---------------------------------------------------------------------------


def serialize_codes(z, *, column_major: bool = True) -> bytes:
    """Pack codes into the smallest sufficient int type, column-by-column.

    Mirrors the paper's Table 6 protocol: "serialize the integer codes
    column-by-column ... and pack them into the smallest sufficient integer
    type (int8 or int16)".
    """
    z = _as_int_numpy(z)
    lo, hi = z.min(), z.max()
    if -128 <= lo and hi <= 127:
        dt = np.int8
    elif -32768 <= lo and hi <= 32767:
        dt = np.int16
    else:
        dt = np.int32
    order = "F" if column_major else "C"
    return np.ascontiguousarray(z.astype(dt), dtype=dt).tobytes(order)


def codec_bits_zlib(z, level: int = 9) -> float:
    """zlib (DEFLATE) compressed bits/entry of the serialized code stream."""
    z = _as_int_numpy(z)
    raw = serialize_codes(z)
    return 8.0 * len(zlib.compress(raw, level)) / z.size


def codec_bits_lzma(z, preset: int = 9) -> float:
    """LZMA compressed bits/entry of the serialized code stream."""
    z = _as_int_numpy(z)
    raw = serialize_codes(z)
    return 8.0 * len(lzma.compress(raw, preset=preset)) / z.size
