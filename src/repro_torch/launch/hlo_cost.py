"""Step cost counter over the port's own execution (the port of
``repro/launch/hlo_cost.py``, kept at its path; ``parse_hlo_costs``
becomes :func:`count_costs`).

The reference parses XLA's post-partitioning HLO and weights each
while-loop body by its trip count.  The port has no HLO: it runs eagerly,
op by op, so the counter watches the ops themselves.  :func:`count_costs`
runs ``fn`` under a ``TorchDispatchMode`` and counts

  * dot FLOPs     by the reference's rule, 2 · prod(result dims) ·
                  contracted size, over ``mm``, ``addmm``, ``bmm``,
                  ``baddbmm``, ``mv``, ``dot`` (what ``matmul``,
                  ``einsum`` and ``linear`` decompose into) and the SDPA
                  ops; elementwise FLOPs are ignored, as there;
  * HBM bytes     each op's tensor inputs read once and its outputs
                  written once (views and ``empty`` move nothing): the
                  port runs unfused, so this is the traffic it moves;
  * collectives   the ``(op, dtype, shape, bytes)`` records the active
                  mesh (``HostMesh`` or ``ShapeMesh``) logs during the
                  run, result bytes per rank as the reference counts them;
  * memory        the bytes of the arguments' storages and the peak of the
                  storages created during the run that are alive at once
                  (finalizers on the output storages);
  * kernel launches by name: the hand-written kernels are bound through
                  ``ctypes``, below the dispatcher, so each wrapper
                  reports its own FLOPs and bytes (``kernels._cost``).

The counts are kept in an op log (:attr:`CostCounter.oplog`): per op
name its calls, FLOPs and bytes, and per collective record its count.
:func:`costs_from_log` turns a log into :class:`StepCosts`, the same
function for a live count and for a saved log (``launch.reparse``), so
both give the same numbers.  ``trip_counts`` holds the loop counts the
caller's program ran (layers, microbatches, time steps); an eager program
counts every iteration, so ``multiplicity_ratio`` is 1.0.

Works on any device: on ``meta`` tensors (the dry run) no op computes
anything and the kernel wrappers return empty outputs.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.dist.sharding import current_mesh
from repro_torch.kernels import _cost

__all__ = ["StepCosts", "CostCounter", "count_costs", "costs_from_log"]

_aten = torch.ops.aten

#: products whose FLOPs are counted: op → index of the operand whose last
#: dim is contracted
_DOT_OPS = {
    _aten.mm.default: 0, _aten.bmm.default: 0, _aten.mv.default: 0,
    _aten.dot.default: 0, _aten.addmm.default: 1,
    _aten.baddbmm.default: 1,
}
_SDPA = tuple(getattr(_aten, n).default for n in (
    "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_cudnn_attention",
    "_scaled_dot_product_flash_attention_for_cpu") if hasattr(_aten, n))
#: ops that allocate without writing
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_like.default,
               _aten.empty_strided.default, _aten.new_empty.default,
               _aten.new_empty_strided.default}


@dataclasses.dataclass
class StepCosts:
    """What one run of a step did on this rank (fields named as the
    reference's ``HloCosts``, then the port's own)."""

    dot_flops: float
    hbm_bytes: float                   # inputs read + outputs written
    collective_bytes: float
    collective_breakdown: Dict[str, float]
    multiplicity_ratio: float          # 1.0: every iteration was counted
    n_whiles: int                      # loops the caller declared
    trip_counts: List[int]
    kernel_launches: Dict[str, int]
    kernel_flops: float                # of the dot FLOPs, the kernels'
    n_collectives: Dict[str, int]
    n_ops: int
    argument_bytes: int
    peak_temp_bytes: int


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` addresses (a broadcast dim, stride 0,
    counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors in nested dicts, lists and tuples.  Iterative: a
    recursive closure would be a reference cycle holding the tensors
    until the garbage collector runs, which keeps every op's output
    storage alive far past its last use."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return out


def _dot_flops(func, args, out) -> float:
    idx = _DOT_OPS.get(func)
    if idx is not None:
        return 2.0 * out.numel() * args[idx].shape[-1]
    if func in _SDPA:
        q, k = args[0], args[1]
        b, h, s, d = q.shape
        t = k.shape[-2]
        pairs = s * t
        causal = bool(args[4] if len(args) > 4 and isinstance(args[4], bool)
                      else False)
        if causal and s == t:
            pairs = s * (s + 1) // 2
        return 4.0 * b * h * pairs * d
    return 0.0


class CostCounter(TorchDispatchMode):
    """The dispatch mode of :func:`count_costs` (also usable as a context
    manager around several calls).  ``oplog`` holds the counts."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.muted = 0
        self.ops: Dict[str, List[float]] = {}      # name → [calls, flops, bytes]
        self.kernels: Dict[str, List[float]] = {}  # name → [launches, flops, bytes]
        self.collectives: List[Tuple] = []
        self._seen: Dict[int, int] = {}            # storage id → bytes
        self.argument_bytes = 0
        self.live = 0
        self.peak = 0
        self._log0 = 0

    # -- storages ----------------------------------------------------------

    def _track(self, t: torch.Tensor, argument: bool) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        if argument:
            self.argument_bytes += n
        else:
            self.live += n
            self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, argument)

    def _free(self, key: int, argument: bool) -> None:
        n = self._seen.pop(key, 0)
        if not argument:
            self.live -= n

    def track_arguments(self, *trees) -> None:
        for t in _tensors(trees):
            self._track(t, True)

    # -- the mode ----------------------------------------------------------

    def __enter__(self):
        self._prev = _cost.ACTIVE[0]
        _cost.ACTIVE[0] = self
        mesh = self.mesh if self.mesh is not None else current_mesh()
        self.mesh = mesh
        self._log0 = len(mesh.log) if mesh is not None else 0
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        _cost.ACTIVE[0] = self._prev
        if self.mesh is not None:
            self.collectives.extend(self.mesh.log[self._log0:])
            self._log0 = len(self.mesh.log)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.muted:
            return out
        outs = _tensors(out)
        if func.is_view or func in _NO_TRAFFIC:
            nbytes = 0
        else:
            nbytes = sum(_nbytes(t) for t in _tensors((args, kwargs))) \
                + sum(_nbytes(t) for t in outs)
        flops = _dot_flops(func, args, outs[0]) if outs else 0.0
        rec = self.ops.setdefault(func.name(), [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        for t in outs:
            self._track(t, False)
        return out

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One launch of a hand-written kernel (``kernels._cost.report``)."""
        rec = self.kernels.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes

    @property
    def oplog(self) -> Dict[str, Any]:
        """The counts as plain JSON data (what ``<tag>.ops.zz`` holds)."""
        coll: Dict[str, int] = {}
        for op, dtype, shape, nbytes in self.collectives:
            key = _key(op, dtype, shape, nbytes)
            coll[key] = coll.get(key, 0) + 1
        return {"ops": {k: list(v) for k, v in sorted(self.ops.items())},
                "kernels": {k: list(v)
                            for k, v in sorted(self.kernels.items())},
                "collectives": dict(sorted(coll.items())),
                "argument_bytes": self.argument_bytes,
                "peak_temp_bytes": self.peak}


def _key(op: str, dtype: str, shape: Sequence[int], nbytes: int) -> str:
    """One collective record as a string key: ``op|dtype|d0,d1|bytes``."""
    return f"{op}|{dtype}|{','.join(str(d) for d in shape)}|{nbytes}"


def costs_from_log(oplog: Dict[str, Any],
                   trip_counts: Sequence[int] = ()) -> StepCosts:
    """:class:`StepCosts` of an op log (a live :attr:`CostCounter.oplog`
    or one read back from ``<tag>.ops.zz``): sums in the log's key
    order, so a saved log gives the same bits.  A log extrapolated over
    a loop's trips (``launch.dryrun``) carries its ``multiplicity_ratio``;
    a counted one has 1.0."""
    ops, kernels = oplog["ops"], oplog["kernels"]
    kflops = math.fsum(v[1] for v in kernels.values())
    flops = math.fsum(v[1] for v in ops.values()) + kflops
    nbytes = math.fsum(v[2] for v in ops.values()) \
        + math.fsum(v[2] for v in kernels.values())
    by_kind: Dict[str, float] = {}
    n_coll: Dict[str, int] = {}
    for key, count in oplog["collectives"].items():
        op, _, _, b = key.split("|")
        by_kind[op] = by_kind.get(op, 0.0) + count * float(b)
        n_coll[op] = n_coll.get(op, 0) + count
    total = math.fsum(by_kind.values())
    trips = sorted({int(t) for t in trip_counts}, reverse=True)
    return StepCosts(
        dot_flops=flops, hbm_bytes=nbytes, collective_bytes=total,
        collective_breakdown={**by_kind, "total": total},
        multiplicity_ratio=oplog.get("multiplicity_ratio", 1.0),
        n_whiles=len(trip_counts),
        trip_counts=trips[:8],
        kernel_launches={k: int(v[0]) for k, v in kernels.items()},
        kernel_flops=kflops, n_collectives=n_coll,
        n_ops=int(sum(v[0] for v in ops.values())),
        argument_bytes=int(oplog["argument_bytes"]),
        peak_temp_bytes=int(oplog["peak_temp_bytes"]))


def count_costs(fn, *args, mesh=None, trip_counts: Sequence[int] = (),
                **kw) -> StepCosts:
    """Run ``fn(*args, **kw)`` once under a :class:`CostCounter` and
    return its :class:`StepCosts`; ``.result`` holds ``fn``'s return
    value and ``.oplog`` the counter's log.  ``mesh`` is the mesh whose
    collective log is read (default: the active one when the run
    starts); ``trip_counts`` the loop counts the caller's program ran."""
    counter = CostCounter(mesh)
    counter.track_arguments(args, kw)
    with counter:
        result = fn(*args, **kw)
    costs = costs_from_log(counter.oplog, trip_counts)
    costs.result = result
    costs.oplog = counter.oplog
    return costs
