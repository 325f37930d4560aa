"""repro_torch — the PyTorch + CUDA port of the WaterSIC serving system.

Mirrors the JAX package ``repro`` path for path (``repro_torch/<path>.py``
ports ``repro/<path>.py``) and keeps its public names and param-tree keys,
so the same numpy inputs can be pushed through both and compared.  This
package imports ``torch`` and never ``jax`` nor anything of ``repro``.

Entry points run on ``cuda`` unless the caller asks for the CPU; without a
card and without that request they raise (:func:`resolve_device`) — there
is no silent CPU fallback.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    ``None`` means ``cuda``.  A CUDA device requested on a host without a
    card raises instead of falling back to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    return dev
