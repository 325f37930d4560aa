"""Public wrapper of the fused dequant-matmul (port of
``repro/kernels/dequant/ops.py``).

``dequant_matmul`` dispatches on the payload dtype and shape: a uint8
planar payload selects the packed path at the nbits its shape encodes —

    (n, ceil(k/2))        planar int4 nibbles          → nbits=4
    (n, 3, ceil(k/8))     int3 bit-planes              → nbits=3
    (n, 1, ceil(k/4))     planar int2 fields           → nbits=2

The wrapper zero-pads the ragged in-features of x and s to the packed
width G·kg (pad columns then multiply zero activations, whatever their
code), takes the (m, G, kg) group view, and routes by the tensor's device:
a CPU tensor goes to the plain twin (``ref.py``), a CUDA tensor to the
hand-written kernel (``dequant_matmul.py``) — there is no fallback between
the two.  Out-of-range codes are applied after the matmul as a sparse COO
delta (``_apply_escapes``).  An int8 code matrix z (n, k) goes to the
int8 kernel on CUDA (``dequant_matmul_int8_cuda``, which reads the
transposed view of a (k, n) serving leaf in place) and to its plain twin
``ref.dequant_matmul_ref`` on the CPU.

Observability (DESIGN.md §11), as in the reference: with
``repro_torch.obs`` enabled, each public entry bumps
``repro_kernel_dispatch_total{format, path}`` (``path`` is ``cuda`` for
a kernel launch, ``ref`` for the twin; the port runs eagerly, so this
counts calls, where the reference's jitted graphs count traces), and the
engines charge every forward dispatch its modeled weight traffic with
:func:`record_weight_traffic` over :func:`weight_format_bytes` — the
``quant.leaf_inventory`` records that ``benchmarks/check_bytes.py``
audits.
"""
from __future__ import annotations

import zlib
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import obs

from .dequant_matmul import (PLANE_GROUPS, dequant_matmul_int8_cuda,
                             dequant_matmul_packed_cuda)
from .ref import dequant_matmul_packed_ref, dequant_matmul_ref, payload_nbits

__all__ = ["dequant_matmul", "dequant_matmul_packed", "payload_nbits",
           "payload_checksums", "verify_payloads", "weight_format_bytes",
           "record_weight_traffic"]

#: payload nbits → the leaf-format label shared with quant.leaf_inventory
#: and benchmarks/check_bytes.py
FORMAT_OF_NBITS = {8: "int8", 4: "packed-int4", 3: "packed-int3",
                   2: "packed-int2"}


def _count_dispatch(fmt: str, z: torch.Tensor) -> None:
    if obs.enabled():
        obs.counter("repro_kernel_dispatch_total", format=fmt,
                    path="cuda" if z.is_cuda else "ref").inc()


def weight_format_bytes(tree) -> Dict[str, int]:
    """Serving format → total stored bytes over a param tree, grouped from
    ``quant.leaf_inventory`` (the records check_bytes.py audits)."""
    from repro_torch.quant import leaf_inventory  # lazy: avoids a cycle
    out: Dict[str, int] = {}
    for rec in leaf_inventory(tree):
        out[rec["format"]] = out.get(rec["format"], 0) + int(rec["bytes"])
    return out


def record_weight_traffic(format_bytes: Dict[str, int],
                          dispatches: int = 1) -> None:
    """Model ``dispatches`` forward passes' weight reads: every dispatch
    (prefill chunk or decode step) streams the whole tree once, so each
    format's ``repro_kernel_hbm_bytes_total`` grows by its stored bytes ×
    dispatches and ``repro_kernel_weight_dispatch_total`` by dispatches."""
    if not obs.enabled() or dispatches <= 0:
        return
    for fmt, nbytes in format_bytes.items():
        obs.counter("repro_kernel_hbm_bytes_total", format=fmt) \
            .inc(nbytes * dispatches)
        obs.counter("repro_kernel_weight_dispatch_total", format=fmt) \
            .inc(dispatches)


def _apply_escapes(out, x, col_scale, row_scale, escapes):
    """out[b, r] += x[b, c]·s[c]·dval·t[r] for each COO escape (r, c, dval).

    ``dval = true_code − clipped_code``, so the correction is exact on top
    of the clipped body; duplicate rows accumulate.  The sum is the same
    bits on every run and for every order of the COO, with no atomics:
    the entries are put in (row, col) order by a stable sort, each row's
    run of contributions is summed by a segmented scan of ⌈log2 cap⌉
    doubling steps (a fixed tree per run length), and each run's total is
    written once, at its last entry, into a per-column delta (the other
    entries write into a spare column that is dropped).
    """
    esc_row, esc_col, esc_dval = escapes
    cap = esc_row.shape[0]
    if cap == 0:
        return out
    m, n = out.shape
    order = torch.sort(esc_row.long() * x.shape[1] + esc_col.long(),
                       stable=True).indices
    er = esc_row.long()[order]
    ec = esc_col.long()[order]
    coef = (col_scale[ec].to(torch.float32)
            * esc_dval[order].to(torch.float32)
            * row_scale[er].to(torch.float32))
    run = x[:, ec].to(torch.float32) * coef[None, :]          # (m, cap)
    step = 1
    while step < cap:
        same = (er[step:] == er[:-step])[None, :]
        run = torch.cat([run[:, :step], run[:, step:] + torch.where(
            same, run[:, :-step], torch.zeros_like(run[:, :-step]))], dim=1)
        step *= 2
    last = torch.ones_like(er, dtype=torch.bool)
    last[:-1] = er[1:] != er[:-1]
    target = torch.where(last, er, torch.full_like(er, n))
    delta = run.new_zeros((m, n + 1)).index_copy_(1, target, run)
    return out + delta[:, :n].to(out.dtype)


def dequant_matmul(x, z, col_scale, row_scale, *, escapes=None):
    """x (m, k) · dequant(z, s, t)ᵀ → (m, n) f32, padding + escapes here.

    ``z`` uint8 is a planar payload (``payload_nbits`` reads its nbits);
    ``z`` int8 is an (n, k) code matrix.  ``escapes`` is an optional COO
    triple (rows, cols, dvals) applied after the matmul.
    """
    if z.dtype == torch.uint8:
        return dequant_matmul_packed(x, z, col_scale, row_scale,
                                     nbits=payload_nbits(z), escapes=escapes)
    _count_dispatch("int8", z)
    if z.is_cuda:
        out = dequant_matmul_int8_cuda(
            x.to(torch.float32).contiguous(), z,
            col_scale.to(torch.float32).contiguous(),
            row_scale.to(torch.float32).contiguous())
    else:
        out = dequant_matmul_ref(x, z, col_scale, row_scale)
    if escapes is not None:
        out = _apply_escapes(out, x, col_scale, row_scale, escapes)
    return out


def dequant_matmul_packed(x, payload, col_scale, row_scale, *,
                          nbits: int = 4, escapes=None):
    """Packed serving matmul: x (m, k) × planar sub-byte payload → (m, n).

    Requires ``G·kg − G < k ≤ G·kg`` (the payload's pad columns are fewer
    than one group row).
    """
    _count_dispatch(FORMAT_OF_NBITS[nbits], payload)
    g = PLANE_GROUPS[nbits]
    m, k = x.shape
    n, kg = payload.shape[0], payload.shape[-1]
    k_packed = g * kg
    if not k_packed - g < k <= k_packed:
        raise ValueError(f"x {tuple(x.shape)} does not match the nbits={nbits}"
                         f" payload {tuple(payload.shape)}")
    xp = x.to(torch.float32)
    sp = col_scale.to(torch.float32)
    if k < k_packed:
        xp = F.pad(xp, (0, k_packed - k))
        sp = F.pad(sp, (0, k_packed - k))
    if payload.is_cuda:
        out = dequant_matmul_packed_cuda(
            xp.contiguous().view(m, g, kg), payload.contiguous(),
            sp.contiguous().view(g, kg),
            row_scale.to(torch.float32).contiguous(), nbits=nbits)
    else:
        out = dequant_matmul_packed_ref(xp, payload, sp, row_scale,
                                        nbits=nbits)
    if escapes is not None:
        out = _apply_escapes(out, x, col_scale, row_scale, escapes)
    return out


def _walk_qweights(tree):
    """(path-string, qweight-dict) pairs in ``quant.leaf_inventory``'s
    path vocabulary."""
    from repro_torch.quant import is_qweight  # lazy: avoids an import cycle
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            if is_qweight(node):
                out.append(("/".join(path), node))
                return
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))

    walk(tree, ())
    return out


def payload_checksums(tree) -> Dict[str, int]:
    """crc32 over every quantized leaf's ``codes`` bytes as stored, keyed
    by the ``leaf_inventory`` path (the same values as the reference's)."""
    return {path: zlib.crc32(leaf["codes"].detach().contiguous().cpu()
                             .numpy().tobytes())
            for path, leaf in _walk_qweights(tree)}


def verify_payloads(tree, checksums: Dict[str, int]):
    """Sorted paths whose payload crc32 no longer matches ``checksums``
    (paths missing from the baseline count as mismatches)."""
    current = payload_checksums(tree)
    return sorted(p for p, crc in current.items()
                  if checksums.get(p) != crc)
