"""Weight conversion from the JAX package's value trees.

``from_jax_params`` maps the reference's param tree — after ``split_tree``
and ``np.asarray`` on every leaf, so no JAX type crosses — to the port's
tree: the same nested keys, each array copied byte for byte into a tensor
on ``device`` (uint8 payloads, int8 codes, int32 escape indices, f32
scales and weights; bf16 arrays keep their bits).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["from_jax_params"]


def _tensor(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16: move the bits
        return torch.from_numpy(a.view(np.int16).copy()) \
            .view(torch.bfloat16).to(device)
    if a.dtype.kind not in "biuf" or a.dtype.itemsize not in (1, 2, 4, 8):
        raise TypeError(f"no torch dtype for a {a.dtype} leaf")
    return torch.from_numpy(a.copy()).to(device)


def from_jax_params(tree, device=None):
    """Reference value tree of numpy arrays → the port's tree of tensors on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""
    return _convert(tree, resolve_device(device))


def _convert(tree, dev):
    if isinstance(tree, dict):
        return {k: _convert(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, dev) for v in tree)
    return _tensor(tree, dev)
