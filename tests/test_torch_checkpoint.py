"""``repro_torch.dist.checkpoint`` held against ``repro.dist.checkpoint``.

Both packages write the same step-directory layout: manifests with equal
keys (the strings ``jax.tree_util.keystr`` prints), dtypes and shapes,
and ``.npy`` files with equal bytes, for the same tree of dicts,
NamedTuples, tuples, ``None`` and ``()``.  A checkpoint written by either
package restores through the other.  Staging (``.tmp.``) directories and
directories without a manifest are invisible; a missing key raises
``KeyError``; retention, stale-staging GC and the read-protected step
behave as the reference's.
"""
import json
import os
from typing import Any, NamedTuple

import numpy as np
import pytest
import torch

from repro_torch.dist.checkpoint import (cleanup_old, latest_step,
                                         list_steps, read_manifest,
                                         restore_checkpoint, save_checkpoint)


class Inner(NamedTuple):
    k: Any
    v: Any
    k_scale: Any = ()
    v_scale: Any = ()


class Outer(NamedTuple):
    kv: Any
    pos: Any
    extras: Any = ()


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"k": rng.standard_normal((2, 3, 4, 2, 8)).astype(np.float32),
            "v": rng.standard_normal((2, 3, 4, 2, 8)).astype(np.float32),
            "ks": rng.integers(-127, 128, (2, 3, 4, 2, 8)).astype(np.int8),
            "sc": rng.random((2, 3, 4, 2, 1)).astype(np.float32),
            "pos": rng.integers(0, 9, (3,)).astype(np.int32),
            "last": rng.integers(0, 64, (3,)).astype(np.int32),
            "w": rng.standard_normal((8, 16)).astype(np.float32)}


def _tree(a, leaf, int8=False):
    """The serving snapshot's shape of tree plus a nested dict, a list, a
    None and a scalar; ``leaf`` wraps each array."""
    kv = (Inner(leaf(a["ks"]), leaf(a["ks"][::-1].copy()), leaf(a["sc"]),
                leaf(a["sc"] * 2)) if int8
          else Inner(leaf(a["k"]), leaf(a["v"])))
    return {"cache": Outer(kv, leaf(a["pos"])),
            "last": leaf(a["last"]),
            "params": {"w": leaf(a["w"]), "b": [leaf(a["pos"]), None]},
            "step": leaf(np.asarray(7, np.int32))}


def _jax_tree(a, int8=False):
    import jax.numpy as jnp
    from repro.models.layers import KVCache
    from repro.models.transformer import DecodeCache
    t = _tree(a, jnp.asarray, int8)
    kv = KVCache(*t["cache"].kv)
    return {**t, "cache": DecodeCache(kv, t["cache"].pos)}


def _torch_tree(a, int8=False):
    from repro_torch.models.layers import KVCache
    from repro_torch.models.transformer import DecodeCache
    t = _tree(a, torch.from_numpy, int8)
    return {**t, "cache": DecodeCache(KVCache(*t["cache"].kv),
                                      t["cache"].pos)}


def _leaf_files(d):
    with open(os.path.join(d, "manifest.json")) as f:
        m = json.load(f)
    return m, {leaf["key"]: open(os.path.join(d, leaf["file"]), "rb").read()
               for leaf in m["leaves"]}


@pytest.mark.parametrize("int8", [False, True])
def test_manifest_and_bytes_match_reference(tmp_path, int8):
    """Same tree, both packages: equal leaf keys, order, shapes, dtypes,
    meta, and byte-identical ``.npy`` files."""
    from repro.dist.checkpoint import save_checkpoint as jsave
    a = _arrays()
    meta = {"engine": {"tick": 3}, "queue": [[1, 2]]}
    dj = jsave(str(tmp_path / "jax"), 5, _jax_tree(a, int8), extra_meta=meta)
    dt = save_checkpoint(str(tmp_path / "torch"), 5, _torch_tree(a, int8),
                         extra_meta=meta)
    mj, fj = _leaf_files(dj)
    mt, ft = _leaf_files(dt)
    assert mt["leaves"] == mj["leaves"]
    assert mt["meta"] == mj["meta"] == meta
    assert mt["step"] == mj["step"] == 5 and mt["format"] == mj["format"]
    assert fj == ft
    keys = [leaf["key"] for leaf in mt["leaves"]]
    assert "['cache'].kv.k" in keys and "['params']['b'][0]" in keys
    assert ("['cache'].kv.k_scale" in keys) == int8


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """Written by one package, restored through the other onto its own
    template kinds (torch tensors / numpy; jax arrays / numpy)."""
    import jax
    from repro.dist.checkpoint import restore_checkpoint as jrestore
    from repro.dist.checkpoint import save_checkpoint as jsave
    a, zero = _arrays(1), {k: np.zeros_like(v) for k, v in _arrays(1).items()}
    if writer == "jax":
        jsave(str(tmp_path), 2, _jax_tree(a, True))
        got, manifest = restore_checkpoint(str(tmp_path),
                                           _torch_tree(zero, True))
        assert isinstance(got["cache"].kv.k, torch.Tensor)
        flat = [t.numpy() for t in (got["cache"].kv.k, got["cache"].kv.v_scale,
                                    got["cache"].pos, got["last"],
                                    got["params"]["b"][0])]
        assert got["params"]["b"][1] is None
        assert got["cache"].extras == ()
    else:
        save_checkpoint(str(tmp_path), 2, _torch_tree(a, True))
        got, manifest = jrestore(str(tmp_path), _jax_tree(zero, True))
        flat = [np.asarray(t) for t in (got["cache"].kv.k,
                                        got["cache"].kv.v_scale,
                                        got["cache"].pos, got["last"],
                                        got["params"]["b"][0])]
        assert isinstance(got["last"], jax.Array)
    want = [a["ks"], a["sc"] * 2, a["pos"], a["last"], a["pos"]]
    for g, w in zip(flat, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert manifest["step"] == 2


def test_bf16_leaves_match_reference_and_restore(tmp_path):
    """A bfloat16 leaf (the serving cache's default dtype): the manifest
    and the ``.npy`` bytes equal the reference's, which writes it through
    numpy's bfloat16 extension type; the port restores either package's
    file onto a bf16 tensor template bit for bit, and refuses a numpy
    template (numpy has no bfloat16)."""
    import jax.numpy as jnp
    from repro.dist.checkpoint import save_checkpoint as jsave
    x = np.random.default_rng(4).standard_normal((2, 3, 5)) \
        .astype(np.float32)
    want = torch.from_numpy(x).to(torch.bfloat16)
    dj = jsave(str(tmp_path / "jax"), 1,
               {"k": jnp.asarray(x, jnp.bfloat16), "n": jnp.asarray(x)})
    dt = save_checkpoint(str(tmp_path / "torch"), 1,
                         {"k": want, "n": torch.from_numpy(x)})
    mj, fj = _leaf_files(dj)
    mt, ft = _leaf_files(dt)
    assert mt["leaves"] == mj["leaves"] and fj == ft
    assert mt["leaves"][0]["dtype"] == "bfloat16"
    template = {"k": torch.zeros(2, 3, 5, dtype=torch.bfloat16),
                "n": torch.zeros(2, 3, 5)}
    for d in ("jax", "torch"):
        got, _ = restore_checkpoint(str(tmp_path / d), template)
        assert got["k"].dtype == torch.bfloat16
        assert torch.equal(got["k"].view(torch.int16),
                           want.view(torch.int16))
        assert torch.equal(got["n"], torch.from_numpy(x))
    with pytest.raises(TypeError, match="bfloat16"):
        restore_checkpoint(str(tmp_path / "torch"),
                           {"k": np.zeros((2, 3, 5)), "n": np.zeros(1)})


def test_roundtrip_numpy_template_and_device(tmp_path):
    """Tensors restore onto the template tensor's device and dtype kind;
    a numpy template gives numpy arrays (the engine's resume path)."""
    a = _arrays(2)
    save_checkpoint(str(tmp_path), 10, _torch_tree(a))
    assert latest_step(str(tmp_path)) == 10
    got, _ = restore_checkpoint(str(tmp_path), _torch_tree(_arrays(3)))
    assert torch.equal(got["params"]["w"], torch.from_numpy(a["w"]))
    assert got["params"]["w"].device.type == "cpu"
    as_np, _ = restore_checkpoint(str(tmp_path), _tree(_arrays(3), np.asarray))
    assert isinstance(as_np["cache"].kv.k, np.ndarray)
    assert np.array_equal(as_np["cache"].kv.k, a["k"])
    assert read_manifest(str(tmp_path))["step"] == 10


def test_staging_and_manifestless_dirs_are_skipped(tmp_path):
    st = _torch_tree(_arrays())
    save_checkpoint(str(tmp_path), 1, st)
    os.makedirs(tmp_path / "step_00000002.tmp.deadbeef")
    os.makedirs(tmp_path / "step_00000003")              # no manifest
    (tmp_path / "step_notanumber").mkdir()
    assert list_steps(str(tmp_path)) == [1]
    assert latest_step(str(tmp_path)) == 1
    got, m = restore_checkpoint(str(tmp_path), st)
    assert m["step"] == 1
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), st)


def test_restore_missing_key_raises(tmp_path):
    st = _torch_tree(_arrays())
    save_checkpoint(str(tmp_path), 1, st)
    with pytest.raises(KeyError, match="extra"):
        restore_checkpoint(str(tmp_path), {**st, "extra": torch.zeros(3)})


def test_retention_gc_and_protected_read(tmp_path):
    """keep=2 retention; a stale staging dir is swept, a young one kept;
    the step a reader last loaded (and newer) survives cleanup."""
    st = _torch_tree(_arrays())
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path / "r"), s, st, keep=2)
    assert list_steps(str(tmp_path / "r")) == [4, 5]
    d = str(tmp_path / "g")
    save_checkpoint(d, 1, st)
    stale, young = (tmp_path / "g" / "step_00000002.tmp.deadbeef",
                    tmp_path / "g" / "step_00000003.tmp.cafef00d")
    stale.mkdir()
    young.mkdir()
    old = os.path.getmtime(stale) - 2 * 3600.0
    os.utime(stale, (old, old))
    save_checkpoint(d, 4, st)
    assert not stale.exists() and young.exists()
    for s in (5, 6, 7):
        save_checkpoint(d, s, st)
    restore_checkpoint(d, st, step=5)                  # a reader pins 5
    assert cleanup_old(d, keep=1) == [1, 4]
    assert list_steps(d) == [5, 6, 7]
    with pytest.raises(ValueError):
        cleanup_old(d, keep=0)
