"""Plain PyTorch twins of the fused dequant-matmul (port of
``repro/kernels/dequant/ref.py``).

``dequant_matmul_ref`` materializes the f32 weight — the ground-truth
oracle.  ``unpack_payload_ref`` / ``dequant_matmul_packed_ref`` are the
twins of the hand-written packed kernel (``csrc/dequant_packed.cu``): they
unpack a planar int4/int3/int2 payload and run the scale-the-activations
formulation.  The CPU path of ``ops`` runs them; ``chip_smoke.py`` holds
the CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import (unpack_int2_planar, unpack_int3_planar,
                                      unpack_int4_planar)

__all__ = ["dequant_matmul_ref", "dequantize_ref", "unpack_payload_ref",
           "dequant_matmul_packed_ref", "dequantize_leaf_ref",
           "payload_nbits"]


def payload_nbits(payload: torch.Tensor) -> int:
    """Payload nbits from the uint8 payload shape: a plane axis of size 3
    is int3, of size 1 is int2, a 2-D payload is int4 nibbles."""
    if payload.ndim >= 3 and payload.shape[-2] == 3:
        return 3
    if payload.ndim >= 3 and payload.shape[-2] == 1:
        return 2
    return 4


def dequantize_ref(z, col_scale, row_scale, dtype=torch.float32):
    """Ŵ[o, i] = t[o] · Z[o, i] · s[i]."""
    return (z.to(dtype) * col_scale.to(dtype)[None, :]
            * row_scale.to(dtype)[:, None])


def dequant_matmul_ref(x, z, col_scale, row_scale):
    """out = x @ Ŵᵀ with the weight materialized in f32 (the oracle)."""
    w_hat = dequantize_ref(z, col_scale, row_scale)
    return x.to(torch.float32) @ w_hat.T


def unpack_payload_ref(payload: torch.Tensor, nbits: int) -> torch.Tensor:
    """Planar payload → int8 codes (…, G·kg), by nbits."""
    if nbits == 4:
        return unpack_int4_planar(payload)
    if nbits == 3:
        return unpack_int3_planar(payload)
    if nbits == 2:
        return unpack_int2_planar(payload)
    raise ValueError(f"no packed payload for nbits={nbits}")


def dequant_matmul_packed_ref(x, payload, col_scale, row_scale, *,
                              nbits: int = 4):
    """Twin of the packed kernel.  ``x`` (m, G·kg) and ``col_scale``
    (G·kg,) must already span the packed width (ops pads; pad columns hold
    x = 0 so any pad code contributes nothing)."""
    z = unpack_payload_ref(payload, nbits).to(torch.float32)  # (n, G·kg)
    xs = x.to(torch.float32) * col_scale.to(torch.float32)[None, :]
    return (xs @ z.T) * row_scale.to(torch.float32)[None, :]


def dequantize_leaf_ref(leaf, index=None) -> torch.Tensor:
    """One served leaf's EFFECTIVE f32 weight as (in, out).

    ``leaf`` is a raw fp weight, an int8 code dict (codes (…, in, out)),
    or a packed dict (payload (…, out, [plane,] kg) with escape COO
    indexed (row=out, col=in)); ``index`` picks one matrix of a stacked
    leaf.
    """
    if not (isinstance(leaf, dict) and "codes" in leaf):
        w = leaf.to(torch.float32)
        return w if index is None else w[index]
    codes, s, t = leaf["codes"], leaf["s"], leaf["t"]
    esc = None
    if "esc_row" in leaf:
        esc = (leaf["esc_row"], leaf["esc_col"], leaf["esc_dval"])
    if index is not None:
        codes, s, t = codes[index], s[index], t[index]
        if esc is not None:
            esc = tuple(e[index] for e in esc)
    s = s.to(torch.float32)
    t = t.to(torch.float32)
    if s.ndim != 1:
        raise ValueError("dequantize_leaf_ref wants one matrix — pass "
                         f"index for stacked leaves (s shape {tuple(s.shape)})")
    if codes.dtype == torch.uint8:                     # packed planar
        z = unpack_payload_ref(codes, payload_nbits(codes)).to(
            torch.float32)[..., :s.shape[0]]           # (out, in)
        if esc is not None and esc[0].shape[-1]:
            z = z.index_put((esc[0].long(), esc[1].long()),
                            esc[2].to(torch.float32), accumulate=True)
        return (t[:, None] * z * s[None, :]).T         # → (in, out)
    return s[:, None] * codes.to(torch.float32) * t[None, :]
