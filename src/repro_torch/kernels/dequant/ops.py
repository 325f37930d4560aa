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
delta (``_apply_escapes``).  int8 code matrices take the plain product on
the CPU; their CUDA kernel is still to be ported (ROADMAP queue B item 2).
"""
from __future__ import annotations

import zlib
from typing import Dict

import torch
import torch.nn.functional as F

from .dequant_matmul import PLANE_GROUPS, dequant_matmul_packed_cuda
from .ref import dequant_matmul_packed_ref, payload_nbits

__all__ = ["dequant_matmul", "dequant_matmul_packed", "payload_nbits",
           "payload_checksums", "verify_payloads"]


def _apply_escapes(out, x, col_scale, row_scale, escapes):
    """out[b, r] += x[b, c]·s[c]·dval·t[r] for each COO escape (r, c, dval).

    ``dval = true_code − clipped_code``, so the correction is exact on top
    of the clipped body; duplicate rows accumulate.  On CUDA ``index_add_``
    adds with atomics, so the order of duplicate-row additions (and the
    last bits of the sum) may vary from run to run.
    """
    esc_row, esc_col, esc_dval = escapes
    if esc_row.shape[0] == 0:
        return out
    ec = esc_col.long()
    er = esc_row.long()
    coef = (col_scale[ec].to(torch.float32) * esc_dval.to(torch.float32)
            * row_scale[er].to(torch.float32))
    contrib = x[:, ec].to(torch.float32) * coef[None, :]
    return out.index_add_(1, er, contrib.to(out.dtype))


def dequant_matmul(x, z, col_scale, row_scale, *, escapes=None):
    """x (m, k) · dequant(z, s, t)ᵀ → (m, n) f32, padding + escapes here.

    ``z`` uint8 is a planar payload (``payload_nbits`` reads its nbits);
    ``z`` int8 is an (n, k) code matrix.  ``escapes`` is an optional COO
    triple (rows, cols, dvals) applied after the matmul.
    """
    if z.dtype == torch.uint8:
        return dequant_matmul_packed(x, z, col_scale, row_scale,
                                     nbits=payload_nbits(z), escapes=escapes)
    if z.is_cuda:
        raise NotImplementedError(
            "the int8 dequant-matmul CUDA kernel is not ported yet "
            "(ROADMAP queue B item 2: dequant_matmul_pallas); int8 serving "
            "leaves take the plain product in models.layers.dense")
    xs = x.to(torch.float32) * col_scale.to(torch.float32)[None, :]
    out = (xs @ z.to(torch.float32).T) * row_scale.to(torch.float32)[None, :]
    if escapes is not None:
        out = _apply_escapes(out, x, col_scale, row_scale, escapes)
    return out


def dequant_matmul_packed(x, payload, col_scale, row_scale, *,
                          nbits: int = 4, escapes=None):
    """Packed serving matmul: x (m, k) × planar sub-byte payload → (m, n).

    Requires ``G·kg − G < k ≤ G·kg`` (the payload's pad columns are fewer
    than one group row).
    """
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
