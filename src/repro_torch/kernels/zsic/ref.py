"""Plain PyTorch twin of the in-block ZSIC kernel (port of
``repro/kernels/zsic/ref.py``).

``zsic_block_ref`` is Alg. 1 restricted to one column block (rows
independent, L block lower-triangular), written with the kernel's exact
arithmetic: true division, round half to even, and the update as a
rounded product then a rounded subtraction.  It is ``core.zsic.zsic`` on
the block.  The CPU path of ``ops`` runs it; ``chip_smoke.py`` holds the
CUDA kernel against it on the card, bit for bit.
"""
from __future__ import annotations

import torch

__all__ = ["zsic_block_ref"]


def zsic_block_ref(y: torch.Tensor, l_block: torch.Tensor,
                   alphas: torch.Tensor):
    """Alg. 1 on a single column block: (codes int32 (a, bn), residual)."""
    # imported here: core.zsic builds its blocked form on this package
    from repro_torch.core.zsic import zsic
    res = zsic(y, l_block, alphas)
    return res.codes, res.residual
