"""Atomic step-directory checkpoints (port of ``repro/dist/checkpoint.py``,
DESIGN.md §5): written whole by one process, restored whole or as a rank's
blocks on a mesh.

Layout (one directory per step, rename-committed):

    <ckpt_dir>/step_00000042/
        manifest.json            # step, per-leaf key/file/shape/dtype
        leaf_00000.npy ...       # one host array per tree leaf

Atomicity: everything is written into ``step_XXXXXXXX.tmp.<nonce>`` and the
directory is ``os.replace``-renamed into place only after the manifest (the
last file) is flushed — a crash mid-save leaves a ``.tmp.`` directory that
``list_steps``/``latest_step`` never report and a later save
garbage-collects once it is stale.

Keys are the strings ``jax.tree_util.keystr`` prints for the same tree of
dicts (``['name']``, sorted keys), NamedTuples (``.field``) and
lists/tuples (``[i]``), with ``None`` and ``()`` holding no leaf, so a
checkpoint written by either package restores through the other
(tests/test_torch_checkpoint.py).  A template leaf with no saved
counterpart raises ``KeyError`` (schema drift fails loudly instead of
silently re-initializing).  Leaves are torch tensors (saved from their
device), numpy arrays or scalars; a restored leaf takes the template
leaf's kind: a tensor on the template tensor's device, else a numpy
array.  A bfloat16 leaf is written as the reference writes it through
numpy's ``bfloat16`` extension type: its raw 16-bit words under the
``.npy`` descriptor ``'<V2'``, with ``"bfloat16"`` in the manifest; it
restores only onto a tensor template (numpy has no bfloat16).  With
``shardings`` (the elastic restart on another mesh) each rank reads only
its block of every sharded leaf (the file is memory-mapped) and places it
on its mesh's device.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.dist.sharding import NamedSharding
from repro_torch.tree import tree_leaves_with_path, tree_map_with_path

__all__ = ["save_checkpoint", "restore_checkpoint", "read_manifest",
           "latest_step", "list_steps", "cleanup_old"]

_PREFIX = "step_"
_MANIFEST = "manifest.json"
#: read-protection marker: every manifest read records its step here so a
#: concurrent retention pass never deletes the step a resume is loading
_READ_MARKER = ".last_read"
#: staging dirs / read markers older than this are considered abandoned
#: (crashed writer, dead reader) and eligible for garbage collection
_STALE_SECONDS = 3600.0


def _step_dirname(step: int) -> str:
    return f"{_PREFIX}{step:08d}"


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, _step_dirname(step))


def list_steps(ckpt_dir: str) -> List[int]:
    """Sorted steps with a *committed* checkpoint (manifest present;
    ``.tmp.`` staging directories from crashed saves are invisible)."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith(_PREFIX):
            continue
        suffix = name[len(_PREFIX):]
        if not suffix.isdigit():
            continue  # staging dirs: step_XXXXXXXX.tmp.<nonce>
        if os.path.isfile(os.path.join(ckpt_dir, name, _MANIFEST)):
            steps.append(int(suffix))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _note_read(ckpt_dir: str, step: int) -> None:
    """Record that ``step``'s manifest was just read (atomic marker write).

    Retention (:func:`cleanup_old`) refuses to delete the recorded step or
    anything newer, closing the race where ``save_checkpoint(keep=...)``
    on one actor deletes the very step a concurrent resume is mid-way
    through loading.  Best-effort: a read-only checkpoint dir must not
    make restores fail."""
    path = os.path.join(ckpt_dir, _READ_MARKER)
    tmp = f"{path}.tmp.{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "w") as f:
            json.dump({"step": int(step), "time": time.time()}, f)
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass


def _read_protected_step(ckpt_dir: str) -> Optional[int]:
    """The step floor retention must not cross, or None.  A marker older
    than ``_STALE_SECONDS`` is a dead reader and stops pinning steps."""
    try:
        with open(os.path.join(ckpt_dir, _READ_MARKER)) as f:
            marker = json.load(f)
        if time.time() - float(marker.get("time", 0.0)) > _STALE_SECONDS:
            return None
        return int(marker["step"])
    except (OSError, ValueError, KeyError):
        return None


def _gc_stale_staging(ckpt_dir: str) -> None:
    """Remove ``.tmp.`` staging dirs whose mtime is older than
    ``_STALE_SECONDS`` — crashed writers leak these forever otherwise.
    Young staging dirs are left alone: they may belong to a live
    concurrent writer."""
    if not os.path.isdir(ckpt_dir):
        return
    now = time.time()
    for name in os.listdir(ckpt_dir):
        if not (name.startswith(_PREFIX) and ".tmp." in name):
            continue
        path = os.path.join(ckpt_dir, name)
        try:
            age = now - os.path.getmtime(path)
        except OSError:
            continue
        if age > _STALE_SECONDS:
            shutil.rmtree(path, ignore_errors=True)


def cleanup_old(ckpt_dir: str, keep: int) -> List[int]:
    """Delete all but the ``keep`` newest committed checkpoints (and any
    stale ``.tmp.`` staging directories).  Steps at or above the latest
    recorded manifest read (``.last_read`` marker) are never deleted —
    a concurrent resume holds them.  Returns the deleted steps."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    removed = []
    protected = _read_protected_step(ckpt_dir)
    for step in list_steps(ckpt_dir)[:-keep]:
        if protected is not None and step >= protected:
            continue
        shutil.rmtree(_step_path(ckpt_dir, step), ignore_errors=True)
        removed.append(step)
    _gc_stale_staging(ckpt_dir)
    return removed


_BF16 = "bfloat16"


def _host(leaf) -> Tuple[np.ndarray, str]:
    """The leaf as a host array and the dtype name the manifest records
    (a bfloat16 tensor as its raw 16-bit words)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != _BF16:
        np.save(path, arr)
        return
    # the bytes numpy writes for an ml_dtypes bfloat16 array
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def save_checkpoint(ckpt_dir: str, step: int, state,
                    *, keep: Optional[int] = None,
                    extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``state`` (any tree of tensors/arrays) as step ``step``;
    returns the committed directory.  ``keep`` applies :func:`cleanup_old`
    retention after the commit, so a retention pass can never eat the
    newest save."""
    os.makedirs(ckpt_dir, exist_ok=True)
    _gc_stale_staging(ckpt_dir)
    final = _step_path(ckpt_dir, step)
    tmp = f"{final}.tmp.{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp)
    try:
        manifest: Dict[str, Any] = {
            "step": int(step), "format": 1, "time": time.time(),
            "leaves": [],
        }
        if extra_meta:
            manifest["meta"] = extra_meta
        for i, (key, leaf) in enumerate(tree_leaves_with_path(state)):
            arr, dtype = _host(leaf)
            fname = f"leaf_{i:05d}.npy"
            _save_leaf(os.path.join(tmp, fname), arr, dtype)
            manifest["leaves"].append({
                "key": key, "file": fname,
                "shape": list(arr.shape), "dtype": dtype,
            })
        mpath = os.path.join(tmp, _MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        old = None
        if os.path.isdir(final):
            # re-save of an existing step: swap via rename rather than
            # rmtree-then-rename (an O(size) crash window)
            old = f"{final}.old.{uuid.uuid4().hex[:8]}"
            os.replace(final, old)
        os.replace(tmp, final)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if keep is not None:
        cleanup_old(ckpt_dir, keep)
    return final


def read_manifest(ckpt_dir: str, step: Optional[int] = None
                  ) -> Dict[str, Any]:
    """The committed manifest for ``step`` (latest when None) — metadata
    only, no array loads.  This is how a consumer reads ``extra_meta``
    (e.g. the serving engine's scheduler state) to decide HOW to build
    the restore template before paying for :func:`restore_checkpoint`.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {ckpt_dir!r}")
    with open(os.path.join(_step_path(ckpt_dir, step), _MANIFEST)) as f:
        manifest = json.load(f)
    _note_read(ckpt_dir, step)
    return manifest


def _place(arr: np.ndarray, dtype: str, key: str, template_leaf,
           sharding: Optional[NamedSharding] = None):
    """The saved ``arr`` as a leaf like ``template_leaf``; with a
    ``sharding``, only this rank's block, on its mesh's device."""
    if sharding is not None:
        arr = np.array(sharding.block(arr))       # read from the map
        device = sharding.mesh.device
    elif isinstance(template_leaf, torch.Tensor):
        device = template_leaf.device
    else:
        device = None
    if dtype == _BF16:
        if device is None:
            raise TypeError(f"bfloat16 leaf {key!r} needs a tensor "
                            f"template (numpy has no bfloat16)")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    if device is not None:
        return torch.from_numpy(arr).to(device)
    return arr


def restore_checkpoint(ckpt_dir: str, template, *,
                       step: Optional[int] = None,
                       shardings=None) -> Tuple[Any, Dict[str, Any]]:
    """Restore onto the structure of ``template``; returns
    ``(state, manifest)``.

    ``step=None`` picks the latest committed step.  Template leaves
    missing from the checkpoint raise ``KeyError``.  ``shardings`` is an
    optional tree, shaped like ``template``, of
    :class:`~repro_torch.dist.sharding.NamedSharding` leaves (``None``
    keeps a leaf whole, placed as without shardings): the elastic path,
    on which each saved array is re-laid out onto the *current* mesh
    whatever mesh wrote it, this rank reading and placing only its block.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {ckpt_dir!r}")
    d = _step_path(ckpt_dir, step)
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    _note_read(ckpt_dir, step)
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    shard_by_key = dict(tree_leaves_with_path(shardings))

    def load(key, leaf):
        if key not in by_key:
            raise KeyError(
                f"checkpoint step {step} has no leaf {key!r} "
                f"(template/schema drift)")
        rec = by_key[key]
        sharding = shard_by_key.get(key)
        arr = np.load(os.path.join(d, rec["file"]),
                      mmap_mode="r" if sharding is not None else None)
        return _place(arr, rec["dtype"], key, leaf, sharding)

    return tree_map_with_path(load, template), manifest
