"""Quantized-weight serving leaves (port of ``repro/quant/qlinear.py``).

``quantize_params_tree`` walks a model param tree and replaces every
eligible weight leaf W (…, in, out) with

    {"codes": int8 (…, in, out), "s": (…, in), "t": (…, out)}       [int8]

or, for the packed sub-byte rungs, a planar uint8 payload in kernel
orientation plus an escape COO (DESIGN.md §8/§10):

    {"codes": uint8 (…, out, ceil(in/2))      int4 nibbles
            | uint8 (…, out, 3, ceil(in/8))   int3 bit planes
            | uint8 (…, out, 1, ceil(in/4)),  int2 fields
     "s": (…, in), "t": (…, out),
     "esc_row"/"esc_col": int32 (…, cap), "esc_dval": f32 (…, cap)}

``quantize_params_tree`` makes symmetric absmax codes (escape-free,
cap = 0), the same bytes the reference produces from the same weights.
``from_watersic`` turns a quantizer result (``core.QuantizedLinear``, real
WaterSIC codes, which do escape the narrow ranges) into one leaf.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.packing import (pack_codes, pack_int2_planar,
                                      pack_int3_planar, pack_int4_planar)

__all__ = ["quantize_params_tree", "from_watersic", "is_qweight",
           "is_packed_qweight",
           "is_packed3_qweight", "is_packed2_qweight", "qweight_bytes",
           "leaf_format", "leaf_format_histogram", "leaf_inventory",
           "serving_formats_from_plan"]

#: param-dict keys eligible for weight quantization (the big matmuls; the
#: reference's raw MoE expert tensors come with the MoE family, item 12)
_WEIGHT_KEYS = ("w",)


def is_qweight(x) -> bool:
    return isinstance(x, dict) and "codes" in x


def is_packed3_qweight(x) -> bool:
    """Int3 bit-plane leaf: uint8 payload (…, out, 3, ceil(in/8))."""
    return (is_qweight(x) and x["codes"].dtype == torch.uint8
            and x["codes"].ndim >= 3 and x["codes"].shape[-2] == 3)


def is_packed2_qweight(x) -> bool:
    """Int2 planar leaf: uint8 payload (…, out, 1, ceil(in/4))."""
    return (is_qweight(x) and x["codes"].dtype == torch.uint8
            and x["codes"].ndim >= 3 and x["codes"].shape[-2] == 1)


def is_packed_qweight(x) -> bool:
    """Packed-int4 leaf: uint8 planar payload (…, out, ceil(in/2))."""
    return is_qweight(x) and x["codes"].dtype == torch.uint8 \
        and not is_packed3_qweight(x) and not is_packed2_qweight(x)


def leaf_format(node) -> str:
    """Serving format name of a quantized weight leaf."""
    if is_packed2_qweight(node):
        return "packed-int2"
    if is_packed3_qweight(node):
        return "packed-int3"
    if is_packed_qweight(node):
        return "packed-int4"
    return "int8"


def _absmax_codes(w: torch.Tensor, qmax: float):
    absmax = w.abs().amax(dim=-1, keepdim=True)            # (…, in, 1)
    s = absmax[..., 0] / qmax + 1e-12
    codes = torch.clamp(torch.round(w / absmax * qmax), -qmax, qmax)
    return codes, s.to(torch.float32)


def _quantize_leaf(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric int8 codes of (…, in, out) weights, per-in-row scale s and
    unit t."""
    codes, s = _absmax_codes(w, 127.0)
    t = torch.ones(w.shape[:-2] + (w.shape[-1],), dtype=torch.float32,
                   device=w.device)
    return {"codes": codes.to(torch.int8), "s": s, "t": t}


def _quantize_leaf_subbyte(w: torch.Tensor, *, qmax: float, pad_mult: int,
                           packer) -> Dict[str, torch.Tensor]:
    """Packed sub-byte leaf for (…, in, out) weights: absmax codes clipped
    to [-qmax, qmax], transposed to kernel orientation (…, out, in),
    zero-padded to the layout's group multiple and packed; escape-free, so
    the COO arrays have length 0."""
    codes, s = _absmax_codes(w, qmax)
    codes = codes.to(torch.int8).transpose(-1, -2)           # (…, o, i)
    pad = (-codes.shape[-1]) % pad_mult
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    lead = w.shape[:-2]
    dev = w.device
    return {"codes": packer(codes.contiguous()),
            "s": s,
            "t": torch.ones(lead + (w.shape[-1],), dtype=torch.float32,
                            device=dev),
            "esc_row": torch.zeros(lead + (0,), dtype=torch.int32, device=dev),
            "esc_col": torch.zeros(lead + (0,), dtype=torch.int32, device=dev),
            "esc_dval": torch.zeros(lead + (0,), dtype=torch.float32,
                                    device=dev)}


def _leaf_for_nbits(node: torch.Tensor, nbits: int, packed: bool):
    if nbits == 2:
        return _quantize_leaf_subbyte(node, qmax=1.0, pad_mult=4,
                                      packer=pack_int2_planar)
    if nbits == 3:
        return _quantize_leaf_subbyte(node, qmax=3.0, pad_mult=8,
                                      packer=pack_int3_planar)
    if nbits == 4 and packed:
        return _quantize_leaf_subbyte(node, qmax=7.0, pad_mult=2,
                                      packer=pack_int4_planar)
    if nbits == 4:
        raise ValueError("unpacked int4 code leaves need a 4-bit integer "
                         "dtype; serve 4 bits as packed=True")
    return _quantize_leaf(node)


def _eligible(path_keys: Tuple[str, ...], leaf, min_dim: int) -> bool:
    if not path_keys or not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    if path_keys[-1] not in _WEIGHT_KEYS:
        return False
    return min(leaf.shape[-1], leaf.shape[-2]) >= min_dim


def quantize_params_tree(params, *, min_dim: int = 64,
                         skip_embed: bool = True, nbits: int = 8,
                         packed: bool = False,
                         nbits_by_path: Optional[
                             Callable[[Tuple[str, ...]], Optional[int]]
                         ] = None):
    """Replace eligible weight leaves with int8/int4/int3/int2 code dicts.

    ``nbits_by_path`` picks the format per leaf (mixed-rate serving): it
    gets the leaf's path and returns 2 | 3 | 4 | 8, or None/16 to leave the
    leaf full precision; 4 bits always means the packed leaf.  Weights
    smaller than ``min_dim`` in either matrix dim stay as they are.
    """
    if packed and nbits != 4:
        raise ValueError("packed leaves require nbits=4")

    def fmt_for(path):
        if nbits_by_path is None:
            return nbits, packed
        b = nbits_by_path(path)
        if b in (None, 16):
            return None, False
        if b not in (2, 3, 4, 8):
            raise ValueError(f"nbits_by_path({path}) = {b!r}; expected "
                             "2, 3, 4, 8, 16 or None")
        return b, (b == 4)

    def walk(node, path):
        if isinstance(node, dict):
            if is_qweight(node):
                return node
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),))
                              for i, v in enumerate(node))
        if skip_embed and "embed" in path:
            return node
        if _eligible(path, node, min_dim):
            b, pk = fmt_for(path)
            if b is None:
                return node
            return _leaf_for_nbits(node, b, pk)
        return node

    return walk(params, ())


def from_watersic(q, *, nbits: int = 8,
                  escape_capacity: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
    """``core.QuantizedLinear`` → serving leaf, on the device of its codes.

    ``nbits=8``: codes (in, out) = Zᵀ as int8 (codes beyond ±127 clipped,
    as in the reference), s = α⊙γ over the in-features, t (out,).

    ``nbits`` 4 / 3 / 2: the planar payload in kernel orientation
    (``pack_codes``) plus the exact escape COO of the codes outside the
    layout's range; ``escape_capacity`` fixes the COO length (stackable
    across layers).  Dead input features get code 0 and scale 0.
    """
    codes = q.codes.to(torch.int32)
    dev = codes.device
    s = q.column_scale.to(torch.float32)
    if q.dead_mask.any():
        live = torch.as_tensor(np.nonzero(~q.dead_mask)[0], device=dev)
        full = torch.zeros((q.out_features, q.in_features),
                           dtype=codes.dtype, device=dev)
        full[:, live] = codes
        codes = full
        s_full = torch.zeros(q.in_features, dtype=torch.float32, device=dev)
        s_full[live] = s
        s = s_full
    t = q.t.to(torch.float32)
    if nbits in (2, 3, 4):
        payload, er, ec, ev = pack_codes(codes, nbits=nbits,
                                         escape_capacity=escape_capacity)
        return {"codes": payload, "s": s, "t": t,
                "esc_row": er, "esc_col": ec, "esc_dval": ev}
    if nbits != 8:
        raise ValueError(f"nbits must be 2, 3, 4 or 8, got {nbits}")
    # clip escapes (negligible mass; the exact path uses packing escapes)
    return {"codes": codes.clamp(-127, 127).T.to(torch.int8).contiguous(),
            "s": s, "t": t}


def _nbytes(a: torch.Tensor) -> int:
    return a.numel() * a.element_size()


def qweight_bytes(tree) -> Tuple[int, int]:
    """(quantized bytes, would-be bf16 bytes) over the tree.

    A ``codes`` leaf counts one byte per element; its bf16 stand-in is two
    bytes per logical weight (2 weights per int4 byte, 8/3 per int3 byte,
    4 per int2 byte).  Every other array counts its own bytes on both
    sides."""
    qb = fb = 0

    def walk(node, path):
        nonlocal qb, fb
        if isinstance(node, dict):
            for k, v in node.items():
                if k != "kshard":
                    walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif isinstance(node, torch.Tensor):
            if "codes" in path:
                qb += node.numel()
                if node.dtype == torch.uint8:
                    if node.ndim >= 3 and node.shape[-2] == 3:
                        fb += (node.numel() // 3) * 8 * 2
                    elif node.ndim >= 3 and node.shape[-2] == 1:
                        fb += node.numel() * 4 * 2
                    else:
                        fb += node.numel() * 4
                else:
                    fb += node.numel() * 2
            else:
                qb += _nbytes(node)
                fb += _nbytes(node)

    walk(tree, ())
    return qb, fb


def leaf_format_histogram(tree) -> Dict[str, int]:
    """Weight-leaf serving formats → leaf count (raw ≥ 2-D arrays count
    under their dtype name, e.g. ``float32``)."""
    out: Dict[str, int] = {}

    def bump(k):
        out[k] = out.get(k, 0) + 1

    def walk(node):
        if isinstance(node, dict):
            if is_qweight(node):
                bump(leaf_format(node))
                return
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, torch.Tensor) and node.ndim >= 2:
            bump(str(node.dtype).replace("torch.", ""))

    walk(tree)
    return dict(sorted(out.items()))


def leaf_inventory(tree) -> list:
    """JSON-able per-weight-leaf storage records (the reference's
    vocabulary, audited by ``benchmarks/check_bytes.py``): one
    ``{path, format, in, out, stack, esc_capacity, payload_bytes,
    scale_bytes, esc_bytes, bytes}`` per quantized leaf, then one
    ``{"path": "<other>"}`` record for every remaining array."""
    records: list = []
    other = 0

    def walk(node, path):
        nonlocal other
        if isinstance(node, dict):
            if is_qweight(node):
                n_in = int(node["s"].shape[-1])
                stack = 1
                for d in node["s"].shape[:-1]:
                    stack *= int(d)
                cap = int(node["esc_row"].shape[-1]) if "esc_row" in node \
                    else 0
                payload = int(node["codes"].numel())
                scale = _nbytes(node["s"]) + _nbytes(node["t"])
                esc = sum(_nbytes(node[k]) for k in
                          ("esc_row", "esc_col", "esc_dval") if k in node)
                records.append({
                    "path": "/".join(path), "format": leaf_format(node),
                    "in": n_in, "out": int(node["t"].shape[-1]),
                    "stack": stack, "esc_capacity": cap,
                    "payload_bytes": payload, "scale_bytes": scale,
                    "esc_bytes": esc, "bytes": payload + scale + esc})
                return
            for k, v in node.items():
                if k != "kshard":
                    walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif isinstance(node, torch.Tensor):
            other += _nbytes(node)

    walk(tree, ())
    records.append({"path": "<other>", "format": "raw", "bytes": other})
    return records


def serving_formats_from_plan(plan, *, default: Optional[int] = None
                              ) -> Callable[[Tuple[str, ...]], Optional[int]]:
    """QuantPlan → ``nbits_by_path`` for :func:`quantize_params_tree`.

    Serving leaves stack every layer of one matrix type, so the per-layer
    payloads of the plan aggregate to per-leaf formats: each group takes
    the MAX payload bits across its layers (never serve a matrix below its
    planned format).  A leaf with no matching plan entries gets
    ``default`` (None = leave full precision).
    """
    groups: Dict[str, int] = {}
    for e in plan:
        groups[e.matrix] = max(groups.get(e.matrix, 0), int(e.payload_bits))

    def nbits_by_path(path: Tuple[str, ...]) -> Optional[int]:
        # (…, "attn", "wq", "w") → "attn/wq"
        return groups.get("/".join(path[-3:-1]), default)

    return nbits_by_path
