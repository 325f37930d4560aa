"""Host meshes over ``torch.distributed`` ranks, and the rank launcher
(port of ``repro/launch/mesh.py``).

:func:`make_host_mesh` lays the ranks of an initialized process group out
as the reference's ``(data, model)`` mesh.  :func:`launch_ranks` starts N
rank processes (the ``spawn`` start method: every rank gets a fresh CUDA
context), joins them under a timeout and returns each rank's result.  :func:`make_production_mesh` describes the
16 × 16 pod (2 × 16 × 16 multi-pod) that the dry run traces one rank of:
a ``ShapeMesh``, since those ranks do not exist.

The collective backend is chosen by one rule, :func:`backend_rule`:
``nccl`` when every rank has a card of its own, ``gloo`` otherwise (NCCL
refuses two ranks on one device).  Under gloo a CUDA tensor crosses ranks
through device memory shared by CUDA IPC when every rank is on the one
card, else through the host (:func:`staging_rule`); the weights never
cross at all, only activation partials and K/V rows (``serve.sharded``);
training sends grads (``train``) and MoE token blocks (``layers.moe``).
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence, Tuple

import torch

from repro_torch.dist.sharding import HostMesh, ShapeMesh

__all__ = ["backend_rule", "staging_rule", "make_production_mesh",
           "make_host_mesh", "launch_ranks"]


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """Rank 0's view of the production mesh: ``(data=16, model=16)``, or
    ``(pod=2, data=16, model=16)`` with ``multi_pod`` (the reference builds
    the same 256 / 512 ranks from forced host devices).
    ``dist.sharding.default_rules(multi_pod=True)`` maps the pod axis."""
    if multi_pod:
        return ShapeMesh({"pod": 2, "data": 16, "model": 16})
    return ShapeMesh({"data": 16, "model": 16})


def backend_rule(world_size: int, device) -> Tuple[str, str]:
    """(backend, why) for ``world_size`` ranks computing on ``device``:
    ``nccl`` iff the ranks run on CUDA and each has a card of its own,
    else ``gloo``."""
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and cards >= world_size:
        return "nccl", f"{world_size} ranks on {cards} cards: one card each"
    if dev.type == "cuda":
        return "gloo", (f"{world_size} ranks share {cards} card(s): NCCL "
                        "takes one rank per card")
    return "gloo", f"{world_size} ranks on the host"


def staging_rule(backend: str, device) -> str:
    """How a tensor on ``device`` crosses a ``backend`` collective:
    ``"none"`` (nccl, or host tensors: the backend moves it), ``"device"``
    (gloo with every rank on the one card: the blocks meet in device
    memory shared through CUDA IPC, gloo carries a barrier) or ``"host"``
    (gloo across cards: to the host and back)."""
    if backend != "gloo" or torch.device(device).type != "cuda":
        return "none"
    return "device" if torch.cuda.device_count() == 1 else "host"


def make_host_mesh(model_parallel: int = 1, *, device=None) -> HostMesh:
    """``(data, model)`` mesh over the ranks of the initialized default
    process group: ``model`` is ``min(model_parallel, world)`` wide, rank r
    at ``(r // model, r % model)``.  ``device`` is where the rank's
    tensors live (default: its CUDA device when the group runs nccl, else
    the host).  With no process group, the ``(1, 1)`` mesh of this
    process (the reference's mesh over its one device): its collectives
    move nothing."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return HostMesh({"data": 1, "model": 1}, 0, {}, backend="none",
                        staging="none",
                        device=torch.device(device or "cpu"))
    n, rank = dist.get_world_size(), dist.get_rank()
    mp = min(model_parallel, n)
    if n % mp:
        raise ValueError(f"{n} ranks do not split into model axes of {mp}")
    dp = n // mp
    groups = {}
    # every rank creates every group, in the same order
    for d in range(dp):
        g = dist.new_group([d * mp + j for j in range(mp)])
        if rank // mp == d:
            groups["model"] = g
    for j in range(mp):
        g = dist.new_group([d * mp + j for d in range(dp)])
        if rank % mp == j:
            groups["data"] = g
    backend = dist.get_backend()
    if device is None:
        device = "cuda" if backend == "nccl" else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return HostMesh({"data": dp, "model": mp}, rank, groups,
                    backend=backend, staging=staging_rule(backend, device),
                    device=device)


def _rank_main(rank: int, n: int, fn: Callable, args: Sequence[Any],
               rdzv: str, backend: str, device: str, threads: int,
               deterministic: bool, timeout_s: float, results) -> None:
    """One rank: join the group, run ``fn(rank, *args)``, report.  A
    failure is reported (with its wall time) before the group is torn
    down, whose teardown then fails the peers' collectives too."""
    import torch.distributed as dist
    torch.set_num_threads(threads)
    torch.use_deterministic_algorithms(deterministic)
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=rdzv, world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, *args)
    except BaseException as e:  # reported to the caller, which re-raises
        when, tb = time.time(), traceback.format_exc()
        try:
            pickle.dumps(e)
        except Exception:
            e = RuntimeError(repr(e))
        results.put(("err", rank, e, tb, when))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put(("ok", rank, out, "", 0.0))


def launch_ranks(fn: Callable, n: int, args: Sequence[Any] = (), *,
                 device="cpu", timeout_s: float = 120.0) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``n`` spawned rank processes joined in
    one process group; returns the ranks' results in rank order.

    ``fn`` is a module-level function and its result picklable; tensors in
    ``args`` are shared with the ranks (host tensors through shared
    memory, CUDA tensors through CUDA IPC: the weights are not copied).
    The group meets through a ``file://`` rendezvous in a fresh temporary
    directory (no TCP port to collide on) with the backend of
    :func:`backend_rule`; each rank runs with this process's intra-op
    thread count (a CPU matmul's bits can depend on it) and its
    ``torch.use_deterministic_algorithms`` setting.  A rank's
    exception is re-raised here with its traceback as a note, after the
    other ranks are killed; past ``timeout_s`` every rank is killed and
    ``TimeoutError`` raised.
    """
    import torch.multiprocessing as tmp
    backend, _ = backend_rule(n, device)
    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    tmpdir = tempfile.mkdtemp(prefix="repro_torch_rdzv_")
    rdzv = "file://" + os.path.join(tmpdir, "rendezvous")
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(r, n, fn, tuple(args), rdzv, backend, str(device),
              torch.get_num_threads(),
              torch.are_deterministic_algorithms_enabled(), timeout_s,
              results))
        for r in range(n)]
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(n)) - set(out))}"
                                   f" of {n} still running after "
                                   f"{timeout_s:.0f} s; killed")
            try:
                kind, rank, payload, tb, when = results.get(
                    timeout=min(left, 0.5))
            except queue_mod.Empty:
                gone = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if gone:
                    time.sleep(0.5)          # a last report may be in flight
                    if results.empty():
                        raise RuntimeError(
                            f"rank {gone[0]} of {n} died with exit code "
                            f"{procs[gone[0]].exitcode} and no report")
                continue
            if kind == "err":
                # the first failure in time is the cause: the others are
                # peers whose collectives it broke
                errors = [(when, rank, payload, tb)]
                grace = time.monotonic() + 2.0
                while time.monotonic() < grace:
                    try:
                        k, r, p, t, w = results.get(timeout=0.2)
                    except queue_mod.Empty:
                        continue
                    if k == "err":
                        errors.append((w, r, p, t))
                _, rank, payload, tb = min(errors, key=lambda e: e[0])
                payload.add_note(f"raised on rank {rank} of {n}:\n{tb}")
                raise payload
            out[rank] = payload
        return [out[r] for r in range(n)]
    finally:
        for p in procs:
            if p.pid is not None:
                p.join(timeout=5 if len(out) == n else 0.1)
                if p.is_alive():
                    p.kill()
                    p.join()
        results.close()
        shutil.rmtree(tmpdir, ignore_errors=True)
