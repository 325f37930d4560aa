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
:meth:`HostMesh.broadcast`), appending ``(op, dtype, shape, bytes)`` of
each one to its collective log, which ``serve.sharded.integer_allgathers``
audits.  Model code reaches the active mesh through :func:`current_mesh`
(thread-local, like the reference's) and the module-level
:func:`axis_index` / :func:`all_gather`.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "Axis", "default_rules", "spec_for_axes", "batch_spec",
    "use_mesh", "current_mesh", "logical_shard",
    "manual_axes", "in_manual_axes", "manual_axis_info",
    "HostMesh", "axis_index", "all_gather",
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
    gloo carrying only a barrier).
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
        if self.staging == "device" and src.is_cuda:
            box = self._mail.get(axis)
            if box is None:
                box = self._mail[axis] = _Mailboxes(
                    self._groups[axis], n, self.axis_index(axis), src.device)
            parts = box.exchange(src)
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
        if self.backend == "nccl" and not buf.is_cuda:
            buf = buf.cuda()
        elif self._staged(buf):
            buf = buf.cpu()
        dist.broadcast(buf, src)
        out = buf.to(x.device)
        self._record("broadcast", out)
        return out


    def close(self) -> None:
        """Wait until every rank is done reading this rank's device
        mailboxes (call before the process lets them go)."""
        for box in self._mail.values():
            box.close()
        self._mail.clear()


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
