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

``dequant_matmul_sharded`` serves the k-sharded leaves of tensor-parallel
serving (``serve/sharded.py``): one kernel call per in-feature shard and
an ordered chain sum of the partials, in one process (the oracle) or one
shard per rank with the partials gathered (``path="kshard"`` in the
dispatch counter).

Cost hooks (``kernels._cost``): with a step cost counter active
(``launch.hlo_cost``) each kernel product reports its name, 2·m·n·k
FLOPs and the bytes it streams (payload once, x, scales, out), and on
``meta`` tensors (the dry run) returns an empty output, running neither
the kernel nor the twin.  With no counter active the cost is one ``is
None`` check.
"""
from __future__ import annotations

import zlib
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import _cost

from .dequant_matmul import (PLANE_GROUPS, dequant_matmul_int8_cuda,
                             dequant_matmul_packed_cuda)
from .ref import dequant_matmul_packed_ref, dequant_matmul_ref, payload_nbits

__all__ = ["dequant_matmul", "dequant_matmul_packed",
           "dequant_matmul_sharded", "payload_nbits",
           "payload_checksums", "verify_payloads", "weight_format_bytes",
           "record_weight_traffic"]

#: payload nbits → the leaf-format label shared with quant.leaf_inventory
#: and benchmarks/check_bytes.py
FORMAT_OF_NBITS = {8: "int8", 4: "packed-int4", 3: "packed-int3",
                   2: "packed-int2"}


def _count_dispatch(fmt: str, path: str) -> None:
    if obs.enabled():
        obs.counter("repro_kernel_dispatch_total", format=fmt,
                    path=path).inc()


def _path(z: torch.Tensor) -> str:
    return "cuda" if z.is_cuda else "ref"


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
    _count_dispatch("int8", _path(z))
    return _int8(x, z, col_scale, row_scale, escapes)


def _report(name, x, z, n, k, extra=0):
    """Charge one kernel product (x (m, k) against n outputs) to the
    active cost counter: 2·m·n·k FLOPs; bytes: the payload once, x, the
    column and row scales, the f32 output (and ``extra``)."""
    m = x.shape[0]
    nbytes = (z.numel() * z.element_size() + x.numel() * x.element_size()
              + 4 * (k + n) + 4 * m * n + extra)
    _cost.report(name, 2.0 * m * n * k, nbytes)


def _int8(x, z, col_scale, row_scale, escapes=None):
    """The int8 product of :func:`dequant_matmul`, not counted."""
    if _cost.ACTIVE[0] is not None:
        _report("dequant_matmul_int8", x, z, z.shape[0], x.shape[1])
        if z.device.type == "meta":
            return x.new_empty((x.shape[0], z.shape[0]), dtype=torch.float32)
    if z.is_cuda:
        out = dequant_matmul_int8_cuda(
            x.to(torch.float32).contiguous(), z,
            col_scale.to(torch.float32).contiguous(),
            row_scale.to(torch.float32).contiguous())
    elif _cost.ACTIVE[0] is None:
        out = dequant_matmul_ref(x, z, col_scale, row_scale)
    else:
        with _cost.muted():
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
    _count_dispatch(FORMAT_OF_NBITS[nbits], _path(payload))
    return _packed(x, payload, col_scale, row_scale, nbits, escapes)


def _packed(x, payload, col_scale, row_scale, nbits, escapes=None):
    """The packed product of :func:`dequant_matmul_packed`, not counted."""
    g = PLANE_GROUPS[nbits]
    m, k = x.shape
    n, kg = payload.shape[0], payload.shape[-1]
    k_packed = g * kg
    if not k_packed - g < k <= k_packed:
        raise ValueError(f"x {tuple(x.shape)} does not match the nbits={nbits}"
                         f" payload {tuple(payload.shape)}")
    if _cost.ACTIVE[0] is not None:
        _report(f"dequant_matmul_packed_int{nbits}", x, payload, n, k)
        if payload.device.type == "meta":
            out = x.new_empty((m, n), dtype=torch.float32)
            if escapes is not None:
                out = _apply_escapes(out, x, col_scale, row_scale, escapes)
            return out
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
    elif _cost.ACTIVE[0] is None:
        out = dequant_matmul_packed_ref(xp, payload, sp, row_scale,
                                        nbits=nbits)
    else:
        with _cost.muted():
            out = dequant_matmul_packed_ref(xp, payload, sp, row_scale,
                                            nbits=nbits)
    if escapes is not None:
        out = _apply_escapes(out, x, col_scale, row_scale, escapes)
    return out


def _chain_sum(stacked: torch.Tensor) -> torch.Tensor:
    """Fixed-order chain sum over the leading axis: s0 + s1 + … + s_{S-1}.

    The k-sharded matmul's epilogue: explicit adds (never ``torch.sum``,
    whose reduction order is the library's), so the oracle's local loop
    and the ranks' gathered stack reduce the same partials through the
    same op sequence and give the same bits."""
    acc = stacked[0]
    for i in range(1, stacked.shape[0]):
        acc = acc + stacked[i]
    return acc


def _shard_partial(x_loc, z_s, s_s, t, *, nbits, esc_s):
    """One in-feature shard's (m, n) partial product.

    A packed shard goes through the packed kernel with its row scale and
    its escapes (local columns); every shard's ragged tail carries code 0
    and scale 0 at the END of its own block (``shard_planar_codes``), so
    the single-shard pad is exact.  An int8 shard goes through the int8
    kernel with t = 1, the shared row scale applied once after the chain
    sum, where the reference applies it; a raw fp shard is a plain
    product."""
    if z_s.dtype == torch.uint8:
        return _packed(x_loc, z_s, s_s, t, nbits, esc_s)
    if z_s.dtype == torch.int8:
        return _int8(x_loc, z_s.transpose(-1, -2), s_s, torch.ones_like(t))
    return x_loc @ z_s.to(x_loc.dtype)


def dequant_matmul_sharded(x, z, col_scale=None, row_scale=None, *,
                           escapes=None, axis_name=None, shards=None):
    """k-sharded matmul with an ordered chain-sum epilogue (DESIGN.md §13).

    ``z`` stacks per-shard weight blocks on a leading shard axis: uint8
    planar payloads ``(S, n, …, kg_loc)``, int8 codes ``(S, k_loc, n)``
    or raw fp blocks ``(S, k_loc, n)``; ``col_scale`` is ``(S, k_loc)``,
    ``row_scale`` ``(n,)`` and ``escapes`` an optional COO triple of
    ``(S, cap_loc)`` arrays with local column indices.  ``x`` (m, k) is
    zero-padded to S·k_loc and cut into contiguous per-shard blocks.

    * ``axis_name=None``: the single-process oracle loops over the S
      shards, stacks the partials and chain-sums them.
    * ``axis_name`` set (a rank's local view, ``shards`` = S): ``z`` et al.
      hold this rank's shard on a shard axis of size 1; the rank computes
      only its partial, and the all-gather of the active mesh
      (``dist.sharding.all_gather``) rebuilds the oracle's (S, m, n) stack
      for the same chain sum.  Only (m, n) activation partials cross
      ranks, never weights.
    """
    if axis_name is None:
        shards = z.shape[0]
    elif shards is None:
        raise ValueError("axis_name given but shards is None: the mesh path "
                         "needs the shard count (the local shard axis is 1)")
    nbits = payload_nbits(z) if z.dtype == torch.uint8 else None
    if z.dtype == torch.uint8:
        k_loc = col_scale.shape[-1]
        _count_dispatch(FORMAT_OF_NBITS[nbits], "kshard")
    else:
        k_loc = z.shape[-2]
        if z.dtype == torch.int8:
            _count_dispatch("int8", "kshard")
    m, k = x.shape
    xp = F.pad(x, (0, shards * k_loc - k)) if k < shards * k_loc else x
    xg = xp.reshape(m, shards, k_loc)

    def partial(i_x, i_w):
        esc = None if escapes is None else tuple(e[i_w] for e in escapes)
        return _shard_partial(
            xg[:, i_x].contiguous(), z[i_w],
            None if col_scale is None else col_scale[i_w], row_scale,
            nbits=nbits, esc_s=esc)

    if axis_name is None:
        stacked = torch.stack([partial(i, i) for i in range(shards)])
    else:
        from repro_torch.dist.sharding import all_gather, axis_index
        stacked = all_gather(partial(axis_index(axis_name), 0), axis_name,
                             dim=0, tiled=False)
    out = _chain_sum(stacked)
    if z.dtype == torch.int8:
        out = out * row_scale.to(out.dtype)
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
