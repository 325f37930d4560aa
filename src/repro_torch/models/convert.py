"""Conversion from the JAX package's values.

``from_jax_params`` maps the reference's param tree — after ``split_tree``
and ``np.asarray`` on every leaf, so no JAX type crosses — to the port's
tree: the same nested keys, each array copied byte for byte into a tensor
on ``device`` (uint8 payloads, int8 codes, int32 escape indices, f32
scales and weights; bf16 arrays keep their bits).

``from_jax_quantized_linear`` and ``from_jax_calib_stats`` do the same for
the quantizer's records (``repro.core.QuantizedLinear`` and
``CalibStats``): every array field goes through ``np.asarray``, so any
array type the reference holds converts without this package importing
it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["from_jax_params", "from_jax_quantized_linear",
           "from_jax_calib_stats"]


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


def from_jax_quantized_linear(q, device=None):
    """A reference ``QuantizedLinear`` → the port's, tensors on ``device``."""
    from repro_torch.core import QuantizedLinear
    dev = resolve_device(device)
    return QuantizedLinear(
        codes=_tensor(np.asarray(q.codes), dev),
        alphas=_tensor(np.asarray(q.alphas), dev),
        gamma=_tensor(np.asarray(q.gamma), dev),
        t=_tensor(np.asarray(q.t), dev),
        dead_mask=np.asarray(q.dead_mask, dtype=bool).copy(),
        c=float(q.c), entropy_bits=float(q.entropy_bits),
        rate_eff=float(q.rate_eff), out_features=int(q.out_features),
        in_features=int(q.in_features))


def from_jax_calib_stats(stats, device=None):
    """A reference ``CalibStats`` → the port's, tensors on ``device``."""
    from repro_torch.core import CalibStats
    dev = resolve_device(device)

    def conv(m):
        return None if m is None else _tensor(np.asarray(m), dev)
    return CalibStats(sigma_x=conv(stats.sigma_x),
                      sigma_xhat=conv(stats.sigma_xhat),
                      sigma_x_xhat=conv(stats.sigma_x_xhat),
                      sigma_delta_xhat=conv(stats.sigma_delta_xhat))
