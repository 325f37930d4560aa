"""Logical-axis sharding rules and the port's SPMD seam (port of
``repro/dist/sharding.py``).

The rules are the reference's: model code names *logical* per-dim axes
(``d_model_w``, ``heads``, ``ff``, …), and :func:`default_rules` maps them
to the physical ``(data, model)`` mesh axes (``(pod, data, model)``
multi-pod).  :func:`spec_for_axes` turns one tensor's logical axes into a
tuple with one mesh-axis entry per dim (the reference's ``PartitionSpec``
entries: ``None``, an axis name or a tuple of names), never repeating a
mesh axis.

The port has no GSPMD, so nothing re-lays a tensor out behind the
program's back: :func:`logical_shard` returns its input itself, exactly
what the reference's does with no mesh or inside a ``shard_map`` body, the
only two cases the port has.  In place of ``shard_map`` the port runs one
process per rank (``launch.mesh``), each executing the body on its local
view of the weights; :class:`HostMesh` is that seam.  It knows the rank's
coordinate on each mesh axis (:meth:`HostMesh.axis_index`) and carries
every collective of the port (:meth:`HostMesh.all_gather`,
:meth:`HostMesh.broadcast`, :meth:`HostMesh.all_reduce` for the
reference's ``psum``/``pmax``/``pmean``, :meth:`HostMesh.all_to_all`),
appending ``(op, dtype, shape, bytes)`` of each one to its collective
log, which ``serve.sharded.integer_allgathers`` audits.  Model code
reaches the active mesh through :func:`current_mesh` (thread-local, like
the reference's) and the module-level :func:`axis_index` /
:func:`all_gather`.

A region that runs on a rank's block (the body of the reference's
``shard_map`` inside a differentiated function: the expert-parallel MoE)
enters and leaves through differentiable collectives: :func:`shard_in` /
:func:`gather_out` (slice on entry, gather on exit; backward gather on
entry, slice on exit, so a grad replicated across the axis stays
replicated and no rank sums a redundant copy), :func:`replicate_in` (the
identity, whose backward sums the rank's partial grad across the axis)
and :func:`all_to_all` (backward: the reverse all-to-all).  The FSDP × TP
train step (``models``, ``train``) adds :func:`fsdp_gather` (a weight
block gathered over the data axes just before use, or an activation
block over ``model``; backward: the sum over those axes, then the rank's
slice) and :func:`reduce_out` (the
row-parallel product's all-reduce over ``model``; backward: the
identity).

:class:`ShapeMesh` is a mesh of shapes only, for the cost tooling
(``launch.dryrun``, ``launch.hlo_cost``): rank 0's view of a mesh whose
other ranks do not exist.  Its collectives return empty tensors of the
result's shape and log exactly what :class:`HostMesh` logs.

:class:`NamedSharding` pairs a mesh with a spec and cuts a rank's block
out of a full array (``dist.checkpoint``'s elastic restore).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "Axis", "default_rules", "spec_for_axes", "batch_spec",
    "use_mesh", "current_mesh", "use_layout", "current_layout",
    "logical_shard",
    "manual_axes", "in_manual_axes", "manual_axis_info",
    "HostMesh", "ShapeMesh", "NamedSharding", "axis_index", "all_gather",
    "shard_in", "gather_out", "replicate_in", "all_to_all", "fsdp_gather",
    "reduce_out",
]

# A rule value: one mesh axis, a tuple of mesh axes, or None (replicate).
Axis = Optional[Union[str, Tuple[str, ...]]]

_DP_SINGLE = ("data",)
_DP_MULTI = ("pod", "data")


def default_rules(multi_pod: bool = False) -> Dict[str, Axis]:
    """Logical-name → mesh-axis table of the production meshes: the
    ``(data, model)`` pod, or with ``multi_pod`` the ``(pod, data,
    model)`` slice.  Unknown logical names (and ``None``) replicate."""
    dp: Axis = _DP_MULTI if multi_pod else "data"
    return {
        # activations
        "batch": dp,
        "seq": None,
        "frames": None,
        "d_model": None,
        "capacity": dp,
        "kv_seq": "model",
        # weights (and the activation dims that mirror them)
        "d_model_w": dp,
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "state": "model",
        "layers": None,
        # the explicit shard axis of k-sharded serving payloads
        # (serve/sharded.py): pure tensor parallelism
        "kshard": "model",
    }


# ---------------------------------------------------------------------------
# Active-mesh and manual-axes contexts (thread-local)
# ---------------------------------------------------------------------------

_LOCAL = threading.local()


def _stack(name: str) -> list:
    stack = getattr(_LOCAL, name, None)
    if stack is None:
        stack = []
        setattr(_LOCAL, name, stack)
    return stack


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh of this thread (nestable)."""
    _stack("meshes").append(mesh)
    try:
        yield mesh
    finally:
        _stack("meshes").pop()


def current_mesh():
    """The innermost :func:`use_mesh` mesh, or None outside any."""
    s = _stack("meshes")
    return s[-1] if s else None


def batch_spec(mesh=None) -> Tuple[str, ...]:
    """The data-parallel axis tuple of ``mesh`` (pod axis first when
    present): what the leading batch dim of inputs shards over."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return _DP_SINGLE
    return tuple(a for a in _DP_MULTI if a in mesh.axis_names)


def spec_for_axes(axes: Sequence[Optional[str]],
                  rules: Optional[Dict[str, Axis]] = None) -> tuple:
    """Per-dim logical names → one mesh-axis entry per dim.

    A mesh axis goes to the first dim that claims it; later claims in the
    same tensor replicate (a square ``(lru, lru)`` weight whose dims both
    map to ``model``).  With ``rules=None`` the table follows the active
    mesh (multi-pod iff it has a ``pod`` axis)."""
    if rules is None:
        mesh = current_mesh()
        rules = default_rules(mesh is not None and "pod" in mesh.axis_names)
    used = set()
    entries = []
    for name in axes:
        rule = rules.get(name) if name is not None else None
        if rule is None:
            entries.append(None)
            continue
        names = rule if isinstance(rule, tuple) else (rule,)
        free = tuple(n for n in names if n not in used)
        used.update(free)
        entries.append(free[0] if len(free) == 1 else (free or None))
    return tuple(entries)


@contextlib.contextmanager
def manual_axes(**info):
    """Mark that the code runs on a rank's local view (the body of the
    reference's ``shard_map``).  ``info`` is read back by
    :func:`manual_axis_info`: k-sharded serving stores the mesh axis name,
    the shard count and whether the KV cache arrives shard-local."""
    _stack("manual").append(dict(info))
    try:
        yield
    finally:
        _stack("manual").pop()


def in_manual_axes() -> bool:
    """True inside a :func:`manual_axes` scope."""
    return bool(_stack("manual"))


def manual_axis_info() -> Optional[Dict[str, object]]:
    """The innermost :func:`manual_axes` metadata, or None."""
    s = _stack("manual")
    return s[-1] if s else None


@contextlib.contextmanager
def use_layout(layout):
    """Make ``layout`` (``models.FsdpTpLayout``) the parameter layout of
    this thread (nestable): the params the model code sees are this
    rank's FSDP × TP blocks, gathered over the data axes just before use,
    with heads, ff, vocab, experts and the recurrent state cut over
    ``model``."""
    _stack("layouts").append(layout)
    try:
        yield layout
    finally:
        _stack("layouts").pop()


def current_layout():
    """The innermost :func:`use_layout` layout, or None (params whole)."""
    s = _stack("layouts")
    return s[-1] if s else None


def logical_shard(x, *axes: Optional[str]):
    """The reference's layout pin; returns ``x`` itself (not a copy).

    The reference's is the strict identity with no mesh and inside a
    ``shard_map`` body; the port only ever runs in those two cases (no
    GSPMD: each rank computes on its own local view)."""
    del axes
    return x


# ---------------------------------------------------------------------------
# The SPMD seam
# ---------------------------------------------------------------------------


class HostMesh:
    """One rank's view of a mesh laid out over the ranks of an initialized
    ``torch.distributed`` process group (built by
    ``launch.mesh.make_host_mesh``).

    ``shape`` maps axis name → size in layout order; rank r sits at the
    row-major coordinate of r over that shape.  ``groups`` holds, per
    axis, the process group of the ranks that differ from this one only
    along it.  ``backend`` is the group's backend and ``staging`` how a
    CUDA tensor crosses it (``launch.mesh.staging_rule``): ``"none"``
    (nccl, or host tensors: the backend moves it), ``"host"`` (gloo across
    cards: copied to the host, gathered, copied back) or ``"device"``
    (gloo, every rank on one card: :class:`_Mailboxes` in device memory,
    gloo carrying only a barrier).  A mesh whose axes all hold one rank
    (``make_host_mesh`` without a process group) needs no groups: its
    collectives move nothing.
    """

    def __init__(self, shape: Dict[str, int], rank: int, groups: Dict,
                 *, backend: str, staging: str, device=None):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank
        self.size = 1
        for n in self.shape.values():
            self.size *= n
        self._groups = dict(groups)
        self.backend = backend
        self.staging = staging
        self.device = torch.device("cpu" if device is None else device)
        self._mail: Dict[str, _Mailboxes] = {}
        self._coord = {}
        rest = rank
        for name in reversed(self.axis_names):
            self._coord[name] = rest % self.shape[name]
            rest //= self.shape[name]
        #: (op, dtype, shape, bytes) of every collective this rank ran
        self.log: List[Tuple[str, str, Tuple[int, ...], int]] = []

    def __repr__(self) -> str:
        dims = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return (f"HostMesh({dims}; rank {self.rank}, {self.backend}, "
                f"staging {self.staging})")

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self._coord[axis]

    def _record(self, op: str, t: torch.Tensor) -> None:
        self.log.append((op, str(t.dtype).replace("torch.", ""),
                         tuple(t.shape), t.numel() * t.element_size()))

    def _staged(self, x: torch.Tensor) -> bool:
        return self.staging == "host" and x.is_cuda

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0,
                   tiled: bool = False) -> torch.Tensor:
        """Every rank's ``x`` along ``axis``, in axis order: stacked on a
        new ``dim`` (``tiled=False``) or concatenated along ``dim``."""
        import torch.distributed as dist
        n = self.shape[axis]
        src = x.contiguous()
        if n == 1:
            parts = [src]
        elif self.staging == "device" and src.is_cuda:
            parts = self._box(axis, src.device).exchange(src)
        else:
            if self._staged(src):
                src = src.cpu()
            parts = [torch.empty_like(src) for _ in range(n)]
            dist.all_gather(parts, src, group=self._groups[axis])
        out = torch.cat(parts, dim) if tiled else torch.stack(parts, dim)
        if out.device != x.device:
            out = out.to(x.device)
        self._record("all_gather", out)
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Global rank ``src``'s ``x`` on every rank of the mesh."""
        import torch.distributed as dist
        buf = x.contiguous().clone()
        if self.size == 1:
            return buf
        buf = self._via_backend(buf)
        dist.broadcast(buf, src)
        out = buf.to(x.device)
        self._record("broadcast", out)
        return out

    def _box(self, axis: str, device) -> "_Mailboxes":
        box = self._mail.get(axis)
        if box is None:
            box = self._mail[axis] = _Mailboxes(
                self._groups[axis], self.shape[axis], self.axis_index(axis),
                device)
        return box

    def _via_backend(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where the backend can move it: on the card for nccl, on
        the host for gloo across cards."""
        if self.backend == "nccl" and not x.is_cuda:
            return x.cuda()
        return x.cpu() if self._staged(x) else x

    def all_reduce(self, x: torch.Tensor, axis: Union[str, Sequence[str]],
                   op: str = "sum", *, acc_dtype=None) -> torch.Tensor:
        """Every rank's ``x`` summed (``op="sum"``) or maxed (``"max"``)
        along ``axis`` (a name, or a tuple of names reduced one after the
        other), in the same bits on every rank: the reference's ``psum``
        and ``pmax`` (``pmean`` is the sum over the axis size).  ``x``
        crosses in its own dtype; with ``acc_dtype`` the receiving rank
        widens each block and adds it in that dtype (an int8 payload
        summed exactly into int32).  With one rank on the axes, ``x``
        itself (in ``acc_dtype``) comes back.

        Routes: nccl's ``all_reduce``, gloo's on the host (CUDA blocks
        staged through it across cards); ranks sharing the card
        (``staging == "device"``) read the peers' blocks from the
        mailboxes and add them in rank order into one accumulator, 256 MB
        at a time, so no (n, …) stack is built.  With ``acc_dtype`` the
        nccl and gloo routes gather the blocks and add them in rank
        order."""
        if op not in ("sum", "max"):
            raise ValueError(f"all_reduce op {op!r}: 'sum' or 'max'")
        for name in ((axis,) if isinstance(axis, str) else tuple(axis)):
            if self.shape[name] > 1:
                x = self._all_reduce_axis(x, name, op, acc_dtype)
        return x if acc_dtype is None else x.to(acc_dtype)

    def _all_reduce_axis(self, x, axis, op, acc_dtype):
        import torch.distributed as dist
        src = x.contiguous()
        dt = acc_dtype or src.dtype
        if self.staging == "device" and src.is_cuda:
            box = self._box(axis, src.device)
            flat = src.reshape(-1)
            out = torch.empty(flat.shape, dtype=dt, device=src.device)
            step = max(1, _CHUNK_BYTES // src.element_size())
            for lo in range(0, flat.numel(), step):
                parts = box.exchange(flat[lo:lo + step])
                acc = out[lo:lo + step]
                acc.copy_(parts[0])
                for part in parts[1:]:
                    if op == "sum":
                        acc.add_(part)
                    else:
                        torch.maximum(acc, part.to(dt), out=acc)
            out = out.view(src.shape)
        elif dt != src.dtype:
            sent = self._via_backend(src)
            parts = [torch.empty_like(sent) for _ in range(self.shape[axis])]
            dist.all_gather(parts, sent, group=self._groups[axis])
            out = parts[0].to(dt)
            for part in parts[1:]:
                if op == "sum":
                    out.add_(part)
                else:
                    torch.maximum(out, part.to(dt), out=out)
            out = out.to(x.device)
        else:
            buf = self._via_backend(src)
            buf = buf.clone() if buf is src else buf
            dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum"
                            else dist.ReduceOp.MAX,
                            group=self._groups[axis])
            out = buf.to(x.device)
        self._record(f"all_reduce_{op}", src)
        return out

    def all_to_all(self, x: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """``jax.lax.all_to_all(x, axis, split_dim, concat_dim,
        tiled=True)``: ``x`` is cut into n equal blocks along
        ``split_dim``, block j goes to the rank at coordinate j of
        ``axis``, and the blocks received are concatenated along
        ``concat_dim`` in axis order.  Routes: nccl's and gloo's
        ``all_to_all_single`` (CUDA blocks through the host across cards);
        ranks sharing the card read their block of each peer's mailbox."""
        import torch.distributed as dist
        n = self.shape[axis]
        if n == 1:
            return x
        size = x.shape[split_dim]
        if size % n:
            raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)}"
                             f" does not split into {n} blocks")
        moved = x.movedim(split_dim, 0)
        send = moved.reshape((n, size // n) + tuple(moved.shape[1:]))
        send = send.contiguous()
        if self.staging == "device" and send.is_cuda:
            me = self.axis_index(axis)
            recv = [part[me] for part in self._box(axis, send.device)
                    .exchange(send)]
        else:
            sent = self._via_backend(send)
            got = torch.empty_like(sent)
            dist.all_to_all_single(got, sent, group=self._groups[axis])
            recv = list(got.to(x.device).unbind(0))
        self._record("all_to_all", send)
        return torch.cat([r.movedim(0, split_dim) for r in recv], concat_dim)


    def close(self) -> None:
        """Wait until every rank is done reading this rank's device
        mailboxes (call before the process lets them go)."""
        for box in self._mail.values():
            box.close()
        self._mail.clear()


#: the largest piece of one mailbox exchange of ``HostMesh.all_reduce``
_CHUNK_BYTES = 1 << 28


class _Mailboxes:
    """All-gather among the ranks of one group that share one card.

    Each rank owns two byte buffers in device memory, which every rank of
    the group maps through CUDA IPC.  An exchange copies this rank's block
    into its buffer of the turn, waits for its stream, meets the others at
    a barrier of the group (gloo, host) and reads every rank's block
    straight from device memory.  The two buffers alternate: a rank writes
    a buffer again two exchanges later, after the next barrier, which
    every rank reaches only once its stream has finished the reads of this
    exchange.  The buffers grow (all ranks together: they exchange the
    same shapes in the same order) to the largest block seen."""

    def __init__(self, group, n: int, me: int, device):
        self.group, self.n, self.me, self.device = group, n, me, device
        self.cap = 0
        self.boxes = None             # [turn][rank] uint8 (cap,)
        self.turn = 0

    def _sync_all(self) -> None:
        import torch.distributed as dist
        torch.cuda.current_stream(self.device).synchronize()
        dist.barrier(group=self.group)

    def _grow(self, nbytes: int) -> None:
        import torch.distributed as dist
        from torch.multiprocessing.reductions import reduce_tensor
        if self.boxes is not None:
            self._sync_all()          # nobody reads the old buffers now
        cap = max(nbytes, 2 * self.cap, 1 << 20)
        mine = [torch.empty(cap, dtype=torch.uint8, device=self.device)
                for _ in range(2)]
        handles = [reduce_tensor(b) for b in mine]
        every = [None] * self.n
        dist.all_gather_object(every, [h[1] for h in handles],
                               group=self.group)
        rebuild = handles[0][0]
        self.boxes = [[mine[t] if r == self.me else rebuild(*every[r][t])
                       for r in range(self.n)] for t in range(2)]
        self.cap = cap

    def exchange(self, x: torch.Tensor) -> List[torch.Tensor]:
        import torch.distributed as dist
        flat = x.reshape(-1).view(torch.uint8)
        nbytes = flat.numel()
        if nbytes > self.cap:
            self._grow(nbytes)
        boxes = self.boxes[self.turn]
        self.turn ^= 1
        boxes[self.me][:nbytes].copy_(flat)
        torch.cuda.current_stream(self.device).synchronize()
        dist.barrier(group=self.group)
        return [b[:nbytes].view(x.dtype).view(x.shape) for b in boxes]

    def close(self) -> None:
        """Let the buffers go: after every rank's last read, every rank
        drops its mappings of the others' before any owner frees one."""
        import torch.distributed as dist
        if self.boxes is not None:
            self._sync_all()
            self.boxes = None
            dist.barrier(group=self.group)


class ShapeMesh:
    """A mesh of axis sizes and rank ``rank``'s coordinates, with no
    process group: the production meshes (``launch.mesh.
    make_production_mesh``) whose 256 or 512 ranks exist only as shapes.

    Tracing one rank's program under it (on ``meta`` tensors, or any
    device) runs the rank's code path as a :class:`HostMesh` rank would,
    with each collective (``all_gather``, ``all_reduce``, ``all_to_all``,
    ``broadcast``) returning an empty tensor of the result's shape on the
    input's device and appending to :attr:`log` the same ``(op, dtype,
    shape, bytes)`` record that :class:`HostMesh` appends (the bytes of
    the result on this rank, as the reference's ``collective_bytes``
    counts them)."""

    backend = "none"
    staging = "none"

    def __init__(self, shape: Dict[str, int], rank: int = 0):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank
        self.size = 1
        for n in self.shape.values():
            self.size *= n
        self.device = torch.device("meta")
        self._coord = {}
        rest = rank
        for name in reversed(self.axis_names):
            self._coord[name] = rest % self.shape[name]
            rest //= self.shape[name]
        self.log: List[Tuple[str, str, Tuple[int, ...], int]] = []

    def __repr__(self) -> str:
        dims = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"ShapeMesh({dims}; rank {self.rank})"

    axis_index = HostMesh.axis_index
    _record = HostMesh._record

    def _empty(self, x, shape, dtype=None) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=dtype or x.dtype,
                           device=x.device)

    def all_gather(self, x, axis, dim=0, tiled=False):
        n = self.shape[axis]
        shape = list(x.shape)
        if tiled:
            shape[dim] *= n
        else:
            shape.insert(dim % (x.ndim + 1), n)
        out = self._empty(x, shape)
        self._record("all_gather", out)
        return out

    def broadcast(self, x, src=0):
        out = self._empty(x, x.shape)
        if self.size > 1:
            self._record("broadcast", out)
        return out

    def all_reduce(self, x, axis, op="sum", *, acc_dtype=None):
        if op not in ("sum", "max"):
            raise ValueError(f"all_reduce op {op!r}: 'sum' or 'max'")
        dtype = x.dtype
        for name in ((axis,) if isinstance(axis, str) else tuple(axis)):
            if self.shape[name] > 1:
                self._record(f"all_reduce_{op}", self._empty(x, x.shape,
                                                             dtype))
                dtype = acc_dtype or dtype
        return self._empty(x, x.shape, acc_dtype or x.dtype)

    def all_to_all(self, x, axis, split_dim, concat_dim):
        n = self.shape[axis]
        if n == 1:
            return x
        size = x.shape[split_dim]
        if size % n:
            raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)}"
                             f" does not split into {n} blocks")
        moved = x.movedim(split_dim, 0)
        self._record("all_to_all", self._empty(
            x, (n, size // n) + tuple(moved.shape[1:])))
        shape = list(x.shape)
        shape[split_dim] //= n
        shape[concat_dim] *= n
        return self._empty(x, shape)


class NamedSharding:
    """The port's ``jax.sharding.NamedSharding``: a :class:`HostMesh` and
    a spec, one entry per leading dim (``None``, a mesh axis name or a
    tuple of names; dims past the spec replicate).  :meth:`block` cuts
    this rank's block out of a full array: along a dim whose entry names
    axes, the block at this rank's row-major coordinate over them (the
    dim must divide evenly)."""

    def __init__(self, mesh: HostMesh, spec: Sequence):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec})"

    def index(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """The slices of this rank's block of an array of ``shape``."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"shape {tuple(shape)} has dims")
        out = []
        for dim, entry in zip(shape, self.spec + (None,) * len(shape)):
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            n, coord = 1, 0
            for name in names:
                n *= self.mesh.shape[name]
                coord = coord * self.mesh.shape[name] \
                    + self.mesh.axis_index(name)
            if dim % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"split {n} ways (spec {self.spec})")
            per = dim // n
            out.append(slice(coord * per, (coord + 1) * per))
        return tuple(out)

    def block(self, full):
        """This rank's block of ``full`` (a tensor or numpy array: a view
        of it)."""
        return full[self.index(full.shape)]

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The whole array from every rank's ``block``, the inverse of
        :meth:`block` (collective: every rank calls it): each cut dim
        gathered over its axes, the minor axis first."""
        for dim, entry in enumerate(self.spec):
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            for name in reversed(names):
                block = self.mesh.all_gather(block.contiguous(), name, dim,
                                             tiled=True)
        return block


def _mesh() -> HostMesh:
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("no active mesh: run inside use_mesh(...)")
    return mesh


def axis_index(axis: str) -> int:
    """This rank's coordinate along ``axis`` of the active mesh."""
    return _mesh().axis_index(axis)


def all_gather(x: torch.Tensor, axis: str, dim: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """:meth:`HostMesh.all_gather` on the active mesh."""
    return _mesh().all_gather(x, axis, dim, tiled)


# ---------------------------------------------------------------------------
# Differentiable region boundaries
# ---------------------------------------------------------------------------


def _block_of(x: torch.Tensor, mesh: HostMesh, axis: str, dim: int):
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {n} blocks along {axis!r}")
    per = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axis) * per, per)


class _ShardIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _block_of(x, mesh, axis, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_gather(g.contiguous(), ctx.axis, ctx.dim,
                                    tiled=True), None, None, None)


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x.contiguous(), axis, dim, tiled=True)

    @staticmethod
    def backward(ctx, g):
        return (_block_of(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(),
                None, None, None)


class _ReplicateIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), ctx.axis), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.split_dim, ctx.concat_dim = split_dim, concat_dim
        return mesh.all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_to_all(g.contiguous(), ctx.axis, ctx.concat_dim,
                                    ctx.split_dim), None, None, None, None)


def shard_in(x: torch.Tensor, axis: str, dim: int, *,
             mesh: Optional[HostMesh] = None) -> torch.Tensor:
    """This rank's block of ``x`` (replicated across ``axis``) along
    ``dim``; backward: the block grads gathered along ``axis``, so the
    grad of ``x`` is whole and equal on every rank."""
    return _ShardIn.apply(x, mesh or _mesh(), axis, dim)


def gather_out(x: torch.Tensor, axis: str, dim: int, *,
               mesh: Optional[HostMesh] = None) -> torch.Tensor:
    """Every rank's block ``x`` concatenated along ``dim`` in ``axis``
    order; backward: this rank's block of the (replicated) grad, not a
    sum of the ranks' copies."""
    return _GatherOut.apply(x, mesh or _mesh(), axis, dim)


def replicate_in(x: torch.Tensor, axis: str, *,
                 mesh: Optional[HostMesh] = None) -> torch.Tensor:
    """``x`` (replicated across ``axis``) itself, for use on this rank's
    block; backward: the ranks' partial grads summed across ``axis``."""
    return _ReplicateIn.apply(x, mesh or _mesh(), axis)


def all_to_all(x: torch.Tensor, axis: str, split_dim: int, concat_dim: int,
               *, mesh: Optional[HostMesh] = None) -> torch.Tensor:
    """:meth:`HostMesh.all_to_all`, differentiable: its backward is the
    reverse all-to-all (``concat_dim`` split, ``split_dim`` joined)."""
    return _AllToAll.apply(x, mesh or _mesh(), axis, split_dim, concat_dim)


def _axes_block(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(count, index) of this rank's block over ``axes`` taken together:
    the product of their sizes and the rank's row-major coordinate over
    them (the first axis major), as a spec entry naming ``axes`` cuts a
    dim."""
    n, coord = 1, 0
    for name in axes:
        n *= mesh.shape[name]
        coord = coord * mesh.shape[name] + mesh.axis_index(name)
    return n, coord


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        out = x
        for name in reversed(axes):          # the minor axis first
            out = mesh.all_gather(out.contiguous(), name, dim, tiled=True)
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.mesh, ctx.axes, ctx.dim
        total = mesh.all_reduce(g.contiguous(), axes)
        n, coord = _axes_block(mesh, axes)
        per = total.shape[dim] // n
        return (total.narrow(dim, coord * per, per).contiguous(),
                None, None, None)


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.contiguous(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def fsdp_gather(x: torch.Tensor, axes: Sequence[str], dim: int, *,
                mesh=None) -> torch.Tensor:
    """The whole of a weight whose ``dim`` is cut over the data ``axes``
    (``("data",)`` or ``("pod", "data")``), from this rank's block ``x``:
    tiled all-gathers, the minor axis first.  Backward: the grads of the
    whole weight summed over ``axes`` (each data rank's batch rows), then
    this rank's slice: the reduce-scatter of FSDP, as a sum and a cut.
    The same holds for a tensor cut over ``("model",)`` that each rank
    uses whole but differentiates in part (the RG-LRU's conv output
    before its gates, the MoE router's logits)."""
    axes = tuple(a for a in axes if (mesh or _mesh()).shape[a] > 1)
    if not axes:
        return x
    return _FsdpGather.apply(x, mesh or _mesh(), axes, dim)


def reduce_out(x: torch.Tensor, axis: str, *, mesh=None) -> torch.Tensor:
    """The sum over ``axis`` of the ranks' partial ``x`` (a row-parallel
    product's output); backward: the identity, since the loss downstream
    is the same on every rank of ``axis``."""
    mesh = mesh or _mesh()
    if mesh.shape[axis] == 1:
        return x
    return _ReduceOut.apply(x, mesh, axis)
