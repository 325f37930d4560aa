"""Tensor-parallel k-sharded serving over ``torch.distributed`` ranks
(port of ``repro/serve/sharded.py``, DESIGN.md §13).

Every big-matmul weight leaf is split along its IN-features into S
shards; rank s of the mesh's ``model`` axis holds the contiguous
in-feature block s of every payload (planar-packed sub-byte codes, int8
codes or raw fp), its slice of the column scales, and the escape-COO
entries whose columns fall in its block.  A decode step moves NO weight
bytes between ranks: the only collectives are the (m, n) activation-partial
all-gathers of the ordered chain-sum epilogue
(``kernels.dequant.dequant_matmul_sharded``) and the K/V gather of sharded
attention (``models.layers.attention_decode``).

The sharded leaf is tagged by a ``kshard`` marker whose SHAPE is the
leaf's lead (layer-stack) dims and whose value is the shard count:

=============  ===============================  ==========================
entry          unsharded                        sharded (S shards)
=============  ===============================  ==========================
codes (int4)   uint8 (L, n, ceil(k/2))          uint8 (L, S, n, kg_loc)
codes (int3)   uint8 (L, n, 3, ceil(k/8))       uint8 (L, S, n, 3, k8_loc)
codes (int2)   uint8 (L, n, 1, ceil(k/4))       uint8 (L, S, n, 1, k4_loc)
codes (int8)   int8  (L, k, n)                  int8  (L, S, k_loc, n)
s              f32   (L, k)                     f32   (L, S, k_loc)
t              f32   (L, n)                     f32   (L, n)   [replicated]
esc_row/col/d  (L, cap)                         (L, S, cap_loc), col LOCAL
w (raw fp)     (L, k, n)                        {"wsh": (L, S, k_loc, n)}
=============  ===============================  ==========================

with ``k_loc = ceil(k/S)``: the last shard's ragged tail is zero-filled to
``k_loc`` and each shard is then packed on its own
(``core.packing.shard_planar_codes``), so pad columns sit at the end of
each shard's own block.  Code 0 × scale 0 keeps every pad column an exact
no-op, so the single-process oracle (the default engine over the sharded
tree) and the ranks run the SAME chain sum over the SAME partials: their
token streams are equal bit for bit.

The reference runs the decode step under one ``shard_map``; the port runs
one process per rank (``launch.mesh.launch_ranks``), each with the same
engine over its :func:`local_view` and the dispatches of
:func:`build_sharded_decode_fns`, which enter ``manual_axes`` around
``decode_step`` / ``decode_chunk``.  Those dispatches also carry the
engine's cache factory (each rank's cache is its block of the buffer axis
under :func:`cache_pspecs`' rule) and a :class:`MeshClock` (rank 0's clock
readings, broadcast once per step, so deadlines expire at the same step on
every rank).  In place of the reference's HLO audit,
:func:`integer_allgathers` reads the mesh's collective log.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import chaos, obs, resolve_device
from repro_torch.core.packing import (shard_planar_codes, unpack_int2_planar,
                                      unpack_int3_planar, unpack_int4_planar)
from repro_torch.dist.sharding import manual_axes, use_mesh
from repro_torch.kernels.dequant.ref import payload_nbits
from repro_torch.models import decode_chunk, decode_step, init_cache
from repro_torch.quant.qlinear import _eligible, is_kshard_qweight, is_qweight
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["shard_params_tree", "params_pspecs", "cache_pspecs",
           "local_view", "MeshClock", "build_sharded_decode_fns",
           "build_sharded_engine", "integer_allgathers", "MeshJob",
           "drain", "run_oracle", "serve_mesh_jobs"]

_UNPACK = {2: unpack_int2_planar, 3: unpack_int3_planar,
           4: unpack_int4_planar}


def _marker(lead: Tuple[int, ...], shards: int, device) -> torch.Tensor:
    """The ``kshard`` tag: value = shard count, shape = the leaf's lead
    dims (``split_layers`` slices it per layer like every other leaf)."""
    return torch.full(lead, shards, dtype=torch.int32, device=device)


def _pad_rows(a: torch.Tensor, total: int, axis: int) -> torch.Tensor:
    """``a`` zero-filled along ``axis`` to length ``total``."""
    k = a.shape[axis]
    if total == k:
        return a
    shape = list(a.shape)
    shape[axis] = total - k
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def _shard_scale(s: torch.Tensor, shards: int, k: int) -> torch.Tensor:
    """(…, k) → (…, S, k_loc), the ragged tail zero-filled (scale 0: pad
    columns contribute exactly nothing)."""
    k_loc = -(-k // shards)
    s = _pad_rows(s, shards * k_loc, -1)
    return s.reshape(s.shape[:-1] + (shards, k_loc))


def _partition_escapes(er, ec, ev, shards: int, k_loc: int):
    """Split escape-COO arrays (…, cap) by owner shard → (…, S, cap_loc)
    with LOCAL column indices (on the host, at load time).

    The owner of column c is ``c // k_loc``, its local index ``c % k_loc``.
    ``cap_loc`` is the largest per-(lead, shard) population; slack slots
    carry (row 0, col 0, dval 0), an exact no-op in the correction.  On
    ``meta`` arrays (the dry run: no values) ``cap_loc`` is the static
    bound ``cap``, as a shape trace of the partition would give it."""
    device = er.device
    if device.type == "meta":
        shape = tuple(er.shape[:-1]) + (shards, er.shape[-1])
        return tuple(torch.empty(shape, dtype=a.dtype, device=device)
                     for a in (er, ec, ev))
    er, ec, ev = (a.detach().cpu().numpy() for a in (er, ec, ev))
    lead = er.shape[:-1]
    cap = er.shape[-1]
    n_lead = int(np.prod(lead, dtype=np.int64))
    er2, ec2, ev2 = (a.reshape(n_lead, cap) for a in (er, ec, ev))
    buckets = []
    cap_loc = 0
    for l in range(er2.shape[0]):
        live = ev2[l] != 0
        owner = ec2[l] // k_loc
        row = []
        for sh in range(shards):
            pick = live & (owner == sh)
            row.append((er2[l, pick], ec2[l, pick] % k_loc, ev2[l, pick]))
            cap_loc = max(cap_loc, int(pick.sum()))
        buckets.append(row)
    out_r = np.zeros((er2.shape[0], shards, cap_loc), np.int32)
    out_c = np.zeros((er2.shape[0], shards, cap_loc), np.int32)
    out_v = np.zeros((er2.shape[0], shards, cap_loc), np.float32)
    for l, row in enumerate(buckets):
        for sh, (r, c, v) in enumerate(row):
            out_r[l, sh, :len(r)] = r
            out_c[l, sh, :len(c)] = c
            out_v[l, sh, :len(v)] = v
    shape = lead + (shards, cap_loc)
    return tuple(torch.from_numpy(a.reshape(shape)).to(device)
                 for a in (out_r, out_c, out_v))


def _shard_packed_leaf(leaf: Dict[str, torch.Tensor], shards: int):
    """Sub-byte planar leaf → kshard leaf: unpack, split the true-k
    blocks, re-pack each shard (pad columns at each shard's own tail)."""
    s = leaf["s"]
    k = s.shape[-1]
    lead = tuple(s.shape[:-1])
    k_loc = -(-k // shards)
    nbits = payload_nbits(leaf["codes"])
    z = _UNPACK[nbits](leaf["codes"])[..., :k]           # (…, n, k) int8
    z2 = z.reshape((-1,) + tuple(z.shape[len(lead):]))
    packed = torch.stack([shard_planar_codes(z2[i], shards, nbits=nbits)
                          for i in range(z2.shape[0])])
    packed = packed.reshape(lead + tuple(packed.shape[1:]))
    er, ec, ev = _partition_escapes(leaf["esc_row"], leaf["esc_col"],
                                    leaf["esc_dval"], shards, k_loc)
    return {"codes": packed, "s": _shard_scale(s, shards, k), "t": leaf["t"],
            "esc_row": er, "esc_col": ec, "esc_dval": ev,
            "kshard": _marker(lead, shards, s.device)}


def _shard_int8_leaf(leaf: Dict[str, torch.Tensor], shards: int):
    """Int8 code leaf (…, k, n) → (…, S, k_loc, n); zero code rows at the
    ragged tail are exact no-ops."""
    s = leaf["s"]
    k = s.shape[-1]
    lead = tuple(s.shape[:-1])
    k_loc = -(-k // shards)
    codes = _pad_rows(leaf["codes"], shards * k_loc, -2)
    codes = codes.reshape(codes.shape[:-2] + (shards, k_loc, codes.shape[-1]))
    return {"codes": codes, "s": _shard_scale(s, shards, k), "t": leaf["t"],
            "kshard": _marker(lead, shards, s.device)}


def _shard_fp_leaf(w: torch.Tensor, shards: int):
    """Raw fp weight (…, k, n) → {"wsh": (…, S, k_loc, n), "kshard"}."""
    k = w.shape[-2]
    lead = tuple(w.shape[:-2])
    k_loc = -(-k // shards)
    w = _pad_rows(w, shards * k_loc, -2)
    w = w.reshape(w.shape[:-2] + (shards, k_loc, w.shape[-1]))
    return {"wsh": w, "kshard": _marker(lead, shards, w.device)}


def shard_params_tree(params, shards: int, *, min_dim: int = 64,
                      skip_embed: bool = True):
    """In-feature-shard every big-matmul weight leaf of ``params``.

    Quantized leaves (packed uint8, int8 codes) become kshard leaves;
    eligible raw fp ``"w"`` leaves become ``{"wsh", "kshard"}`` so the fp
    rung shards too.  Everything else (embeds, norms, biases, MoE expert
    stacks) stays replicated, and so does a leaf with fewer in-features
    than shards.
    """
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")

    def walk(node, path):
        if isinstance(node, dict):
            if is_kshard_qweight(node) or "kshard" in node:
                return node
            if is_qweight(node):
                if node["s"].shape[-1] < shards:
                    return node
                if node["codes"].dtype == torch.uint8:
                    return _shard_packed_leaf(node, shards)
                return _shard_int8_leaf(node, shards)
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            vals = [walk(v, path + (str(i),)) for i, v in enumerate(node)]
            return vals if isinstance(node, list) else tuple(vals)
        if skip_embed and "embed" in path:
            return node
        if (path and path[-1] == "w" and _eligible(path, node, min_dim)
                and node.shape[-2] >= shards):
            return _shard_fp_leaf(node, shards)
        return node

    return walk(params, ())


# ---------------------------------------------------------------------------
# Specs and the local view
# ---------------------------------------------------------------------------

#: kshard-leaf entries that carry the shard axis (at position = lead ndim)
_SHARDED_ENTRIES = ("codes", "wsh", "s", "esc_row", "esc_col", "esc_dval")


def params_pspecs(params, *, axis_name: str = "model"):
    """Spec tree of a sharded param tree (one mesh-axis entry per dim, the
    reference's ``PartitionSpec`` entries): the shard axis of every kshard
    entry maps to ``axis_name``; everything else replicates (``()``)."""

    def walk(node):
        if isinstance(node, dict):
            if "kshard" in node:
                sharded = (None,) * node["kshard"].ndim + (axis_name,)
                return {k: (sharded if k in _SHARDED_ENTRIES else ())
                        for k in node}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            vals = [walk(v) for v in node]
            return vals if isinstance(node, list) else tuple(vals)
        return ()

    return walk(params)


def _kv_buffers(cache) -> list:
    """The K/V buffers of a decode cache (the int8 scale buffers too): the
    leaves of the ``KVCache`` it holds (dense, MoE, prefix-LM, the
    encoder–decoder's self attention, the hybrid's ``kv`` entry), not the
    recurrent states nor the encoder–decoder's cross K/V extras."""
    from repro_torch.models.layers import KVCache
    kv = cache.kv
    if isinstance(kv, dict):
        kv = kv.get("kv")
    if not isinstance(kv, KVCache):
        return []
    return [x for x in kv if isinstance(x, torch.Tensor)]


def cache_pspecs(cache, *, axis_name: str = "model", shards: int):
    """(spec tree, cache_sharded) of a (global) decode cache.

    The K/V buffers (``(L, B, buf, n_kv, hd)``, the int8 scale buffers
    too) shard their buffer axis over ``axis_name`` when every one's
    length divides by ``shards``; otherwise the whole cache replicates
    (correct either way: attention gathers the buffer before scoring).
    The reference takes every 5-D leaf for a K/V buffer, which would cut
    rwkv6's WKV state along its heads and the encoder–decoder's cross
    K/V along the frames; the port cuts the ``KVCache`` leaves only."""
    leaves = _kv_buffers(cache)
    sharded = bool(leaves) and all(x.shape[2] % shards == 0 for x in leaves)
    cut = {id(x) for x in leaves} if sharded else set()
    spec = tree_map(lambda x: (None, None, axis_name) if id(x) in cut
                    else (), cache)
    return spec, sharded


def local_view(params, mesh, *, axis_name: str = "model"):
    """This rank's view of a sharded tree (views, no copy): every kshard
    entry narrowed to the rank's shard along its shard axis, kept at size
    1 (the counterpart of the reference's ``in_specs``); the rest
    shared."""
    idx = mesh.axis_index(axis_name)

    def walk(node):
        if isinstance(node, dict):
            if "kshard" in node:
                nd = node["kshard"].ndim
                return {k: (v.narrow(nd, idx, 1) if k in _SHARDED_ENTRIES
                            else v) for k, v in node.items()}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            vals = [walk(v) for v in node]
            return vals if isinstance(node, list) else tuple(vals)
        return node

    return walk(params)


def _shard_counts(params) -> set:
    counts = set()

    def walk(node):
        if isinstance(node, dict):
            if "kshard" in node:
                # the shard axis' length (the marker's value, read from
                # the shape: a meta tree has no values)
                body = node["codes"] if "codes" in node else node["wsh"]
                counts.add(int(body.shape[node["kshard"].ndim]))
                return
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(params)
    return counts


# ---------------------------------------------------------------------------
# The ranks' dispatches
# ---------------------------------------------------------------------------


class MeshClock:
    """Rank 0's clock, broadcast to every rank once per engine step.

    :meth:`sync` (one broadcast of rank 0's ``perf_counter`` and
    ``monotonic`` readings) is called by the engine at the top of each
    step.  :meth:`monotonic`, the clock of every engine decision
    (deadlines, arrival stamps), returns the step's reading itself, the
    same number on every rank; :meth:`perf_counter`, the clock of the
    stats, is rank 0's reading plus the local time elapsed since the
    sync."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._mono: Optional[float] = None
        self._perf_offset = 0.0

    def sync(self) -> None:
        t = torch.tensor([time.perf_counter(), time.monotonic()],
                         dtype=torch.float64)
        t = self.mesh.broadcast(t, src=0)
        self._perf_offset = float(t[0]) - time.perf_counter()
        self._mono = float(t[1])

    def monotonic(self) -> float:
        if self._mono is None:
            self.sync()
        return self._mono

    def perf_counter(self) -> float:
        return time.perf_counter() + self._perf_offset


def _cache_key(cache) -> tuple:
    """A cache's leaf shapes with the batch axis (1) dropped: one engine's
    caches of every batch share it."""
    return tuple((x.shape[:1] + x.shape[2:], str(x.dtype))
                 for x in tree_leaves(cache) if x.ndim >= 2)


class _MeshState:
    """What a rank's step and chunk dispatches share: the mesh, the cache
    layouts their factory made, the memo of dispatch keys, the clock."""

    def __init__(self, mesh, axis_name: str, shards: int):
        self.mesh = mesh
        self.axis_name = axis_name
        self.shards = shards
        self.layouts: Dict[tuple, bool] = {}
        self.keys: Dict[tuple, bool] = {}
        self.clock = MeshClock(mesh)

    def init_cache(self, cfg, batch: int, max_len: int,
                   dtype=torch.bfloat16, *, per_slot: bool = False,
                   device=None):
        """This rank's block of the cache ``models.init_cache`` makes:
        the K/V buffer axis cut to ``buf/S`` when :func:`cache_pspecs`
        shards it, everything else whole (all zeros, as there)."""
        shape_of = init_cache(cfg, batch, max_len, dtype, per_slot=per_slot,
                              device="meta")
        spec, sharded = cache_pspecs(shape_of, axis_name=self.axis_name,
                                     shards=self.shards)
        dev = resolve_device(device)

        def block(x, entry):
            shape = list(x.shape)
            if entry:
                shape[2] //= self.shards
            return torch.zeros(shape, dtype=x.dtype, device=dev)

        cache = tree_map(block, shape_of, spec)
        key = _cache_key(cache)
        if self.layouts.setdefault(key, sharded) != sharded:
            raise ValueError("two cache layouts share one block shape; "
                             "serve one max_len per dispatch")
        return cache


class _Dispatch:
    """One rank's ``decode_step`` (``tag="step"``) or ``decode_chunk``
    (``"chunk"``) on its local view, under ``manual_axes``; carries the
    cache factory (``init_cache``) and ``clock`` the engine reads."""

    def __init__(self, fn, tag: str, cfg, state: _MeshState):
        self.fn, self.tag, self.cfg, self.state = fn, tag, cfg, state
        self.init_cache = state.init_cache
        self.clock = state.clock

    def __call__(self, p, cache, tok):
        st = self.state
        key = (self.tag,
               tuple((tuple(x.shape), str(x.dtype))
                     for x in tree_leaves(cache)), tuple(tok.shape))
        sharded = st.keys.get(key)
        if sharded is None:
            t0 = time.perf_counter()
            layout = _cache_key(cache)
            if layout not in st.layouts:
                raise ValueError("a sharded dispatch takes only caches made "
                                 "by its own init_cache")
            sharded = st.keys[key] = st.layouts[layout]
            if obs.enabled():
                # the reference's compile span and counter: one per
                # (tag, cache and token shapes) seen first
                obs.complete("serve.mesh.compile", t0, time.perf_counter(),
                             tag=self.tag, shards=st.shards,
                             tok_shape=list(tok.shape))
                obs.counter("repro_serve_mesh_compile_total",
                            tag=self.tag).inc()
        if obs.enabled():
            obs.counter("repro_serve_mesh_dispatch_total", tag=self.tag,
                        shards=str(st.shards)).inc()
        with use_mesh(st.mesh), manual_axes(axis=st.axis_name,
                                            shards=st.shards,
                                            cache_sharded=sharded):
            return self.fn(self.cfg, p, cache, tok)


def build_sharded_decode_fns(cfg, params, mesh, *, axis_name: str = "model"):
    """(decode_fn, decode_chunk_fn) of this rank: drop-ins for the
    engines' ``EngineConfig.decode_fn`` / ``decode_chunk_fn`` hooks.

    ``params`` is the sharded tree (:func:`shard_params_tree`) with the
    mesh's ``axis_name`` size as its shard count; the engine hands the
    dispatches its :func:`local_view`.  The single-process oracle is the
    default engine over the same sharded tree."""
    shards = int(mesh.shape[axis_name])
    counts = _shard_counts(params)
    if counts and counts != {shards}:
        raise ValueError(f"tree sharded {sorted(counts)}-way on a "
                         f"{shards}-way {axis_name!r} axis")
    state = _MeshState(mesh, axis_name, shards)
    return (_Dispatch(decode_step, "step", cfg, state),
            _Dispatch(decode_chunk, "chunk", cfg, state))


def build_sharded_engine(cfg, params, mesh, *, config=None,
                         continuous: bool = True, axis_name: str = "model"):
    """This rank's engine over its :func:`local_view` of the sharded tree
    ``params``, with the dispatches of :func:`build_sharded_decode_fns`
    injected into ONE :class:`EngineConfig` (any resilience wiring on the
    caller's config rides along)."""
    from .config import EngineConfig
    from .engine import ContinuousEngine, ServeEngine
    step_fn, chunk_fn = build_sharded_decode_fns(cfg, params, mesh,
                                                 axis_name=axis_name)
    config = dataclasses.replace(config or EngineConfig(),
                                 decode_fn=step_fn, decode_chunk_fn=chunk_fn)
    cls = ContinuousEngine if continuous else ServeEngine
    return cls(cfg, local_view(params, mesh, axis_name=axis_name),
               config=config)


# ---------------------------------------------------------------------------
# The collective audit: the no-weight-all-gather gate
# ---------------------------------------------------------------------------

_INT_DTYPES = ("uint8", "int8", "int16", "uint16", "int32", "int64")


def integer_allgathers(log) -> List[str]:
    """All-gathers of a mesh's collective log whose RESULT is an integer
    tensor of ≥ 2 dims (the reference's rule for the HLO): weight payloads
    are u8/s8, activations and K/V floating point, so any such gather
    means weight bytes crossed ranks.  Token and position gathers (1-D)
    are excluded."""
    return [f"{op} {dtype}{list(shape)} {nbytes} B"
            for op, dtype, shape, nbytes in log
            if op == "all_gather" and dtype in _INT_DTYPES
            and len(shape) >= 2]


# ---------------------------------------------------------------------------
# Serving jobs, in one process (the oracle) and on the ranks
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MeshJob:
    """One serve run over a sharded tree.

    ``workload`` holds ``(arrival step, rid, prompt, max_new_tokens,
    deadline_s)``: request rid is submitted once ``arrival step`` engine
    steps (rounds) ran.  ``chaos`` = ``(kind, seed)`` installs
    ``chaos.seeded_plan(kind, seed)`` around the run (the record's
    ``faults`` counts the injected ones); ``obs`` enables
    ``repro_torch.obs`` for it; ``measure`` times one more decode step
    after the run and counts its kernel launches and collectives."""

    name: str
    cfg: Any
    params: Any
    config: Any
    workload: list
    continuous: bool = True
    chaos: Optional[Tuple[str, int]] = None
    obs: bool = False
    measure: bool = False


def drain(eng, workload, *, max_steps: int = 100_000) -> list:
    """Drive ``eng`` through ``workload`` (:class:`MeshJob`'s tuples)
    until it is idle; returns the finished requests."""
    from .engine import Request
    pending = sorted(workload, key=lambda w: w[0])
    done, steps = [], 0
    while pending or eng.queue or getattr(eng, "active_slots", 0):
        while pending and pending[0][0] <= steps:
            _, rid, prompt, budget, deadline = pending.pop(0)
            eng.submit(Request(rid=rid, prompt=np.asarray(prompt).copy(),
                               max_new_tokens=budget, deadline_s=deadline))
        if hasattr(eng, "step"):
            done.extend(eng.step())
        else:
            done.extend(eng.run_round())
        steps += 1
        if steps > max_steps:
            raise RuntimeError("the engine did not drain")
    return done


def _result(eng, done) -> dict:
    return {"streams": {r.rid: list(r.out_tokens) for r in done},
            "dropped": sorted((r.rid, r.drop_reason) for r in eng.dropped),
            "decode_calls": getattr(eng, "decode_calls", 0),
            "prefill_calls": getattr(eng, "prefill_calls", 0),
            "weight_bytes": int(eng.weight_bytes)}


def _run(job: MeshJob, make_engine) -> Tuple[dict, Any]:
    if job.obs:
        obs.reset()
        obs.enable()
    try:
        eng = make_engine()
        faults = 0
        if job.chaos is not None:
            with chaos.active(chaos.seeded_plan(*job.chaos)) as rt:
                done = drain(eng, job.workload)
            faults = rt.injected()
        else:
            done = drain(eng, job.workload)
        out = _result(eng, done)
        out["faults"] = faults
        if hasattr(eng, "step_stats"):
            out["step_s"] = [s.step_s for s in eng.step_stats
                             if s.admitted == 0 and s.active]
        if job.obs:
            out["counters"] = obs.counters_snapshot("repro_serve_")
            out["compile_spans"] = [
                e["args"] for e in obs.tracer().to_chrome()["traceEvents"]
                if e["name"] == "serve.mesh.compile"]
    finally:
        if job.obs:
            obs.disable()
            obs.reset()
    return out, eng


def run_oracle(job: MeshJob) -> dict:
    """``job`` in this process: the default engine over the sharded tree
    (every shard's partial computed here, no mesh)."""
    from .engine import ContinuousEngine, ServeEngine
    cls = ContinuousEngine if job.continuous else ServeEngine
    out, _ = _run(job, lambda: cls(job.cfg, job.params, config=job.config))
    return out


def _measure_step(eng, mesh) -> dict:
    """One more decode step on the drained engine's cache: host seconds,
    kernel launches and the collectives it ran (their count and bytes,
    and the step's ``(op, dtype, shape, bytes)`` log itself)."""
    from repro_torch.kernels.dequant import LAUNCHES, reset_launches
    tok = torch.zeros((eng.n_slots, 1), dtype=torch.long, device=eng.device)
    n_log = len(mesh.log)
    reset_launches()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    t0 = time.perf_counter()
    eng._decode(eng._step_params, eng.cache, tok)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return {"host_s": time.perf_counter() - t0, "launches": dict(LAUNCHES),
            "log": [tuple(r) for r in mesh.log[n_log:]],
            **_gathers(mesh.log[n_log:])}


def _gathers(log) -> dict:
    """Count, bytes and dtypes of the all-gathers in a collective log."""
    g = [r for r in log if r[0] == "all_gather"]
    return {"allgathers": len(g), "allgather_bytes": sum(r[3] for r in g),
            "allgather_dtypes": sorted({r[1] for r in g})}


def serve_mesh_jobs(rank: int, jobs: List[MeshJob], shards: int) -> list:
    """Rank body (:func:`launch.mesh.launch_ranks`): every job through a
    ``shards``-wide mesh engine on this rank's local view; per job the
    :func:`run_oracle` record plus the collective audit, this rank's
    kernel launches, and with ``measure`` one timed decode step."""
    from repro_torch.kernels.dequant import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    device = next(x.device for x in tree_leaves(jobs[0].params))
    mesh = make_host_mesh(model_parallel=shards, device=device)
    outs = []
    for job in jobs:
        n_log = len(mesh.log)
        reset_launches()
        out, eng = _run(job, lambda: build_sharded_engine(
            job.cfg, job.params, mesh, config=job.config,
            continuous=job.continuous))
        log = mesh.log[n_log:]
        out.update(rank=rank, backend=mesh.backend, staging=mesh.staging,
                   launches=dict(LAUNCHES),
                   integer_allgathers=integer_allgathers(log),
                   broadcasts=sum(1 for r in log if r[0] == "broadcast"),
                   **_gathers(log))
        if job.measure:
            out["step"] = _measure_step(eng, mesh)
        out["cache_sharded"] = sorted(
            set(eng.config.decode_fn.state.layouts.values()))
        outs.append(out)
        del eng
    mesh.close()
    return outs
