"""Launcher of the hand-written packed dequant-matmul CUDA kernel.

Port of ``repro/kernels/dequant/dequant_matmul.py::
dequant_matmul_packed_pallas``: the kernel itself is
``csrc/dequant_packed.cu`` (its header note says what bounds it and how it
is designed).  This module checks the operands, allocates the output and
the split-K scratch, launches on the current stream, raises on a launch
error, and counts the launches (``LAUNCHES[nbits]``, one per call that
launches, bumped nowhere else; a split call also runs the kernel's
fixed-order reduction) so a run can show that its main path went through
the kernel.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["PLANE_GROUPS", "LAUNCHES", "reset_launches",
           "dequant_matmul_packed_cuda"]

#: column groups per payload byte-column, by payload nbits
PLANE_GROUPS = {2: 4, 3: 8, 4: 2}
#: payload planes per row, by payload nbits
_PLANES = {2: 1, 3: 3, 4: 1}

#: kernel launches per payload nbits since the last :func:`reset_launches`
LAUNCHES = {2: 0, 3: 0, 4: 0}

_lib = None
#: k splits of a launch, by (device index, m, n, kg): the library picks
#: them, this module sizes the workspace from them
_SPLITS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernel():
    """(launch, splits) C functions of the built library."""
    global _lib
    if _lib is None:
        from repro_torch.kernels._build import load
        lib = load("dequant_packed")
        launch = lib.dequant_matmul_packed_f32
        launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        launch.restype = ctypes.c_int
        splits = lib.dequant_matmul_packed_splits
        splits.argtypes = [ctypes.c_int] * 3
        splits.restype = ctypes.c_int
        _lib = (launch, splits)
    return _lib


def dequant_matmul_packed_cuda(x_groups: torch.Tensor, payload: torch.Tensor,
                               s_groups: torch.Tensor,
                               row_scale: torch.Tensor, *,
                               nbits: int = 4) -> torch.Tensor:
    """x_groups (m, G, kg) f32 · planar payload → (m, n) f32 on the card.

    ``payload`` is uint8 (n, kg) for int4, (n, 3, kg) for int3 and
    (n, 1, kg) for int2; ``s_groups`` (G, kg) and ``row_scale`` (n,) are
    f32.  Every operand must be a contiguous CUDA tensor on one device.
    """
    if nbits not in PLANE_GROUPS:
        raise ValueError(f"no packed kernel for nbits={nbits}")
    g, planes = PLANE_GROUPS[nbits], _PLANES[nbits]
    ops = {"x_groups": x_groups, "payload": payload, "s_groups": s_groups,
           "row_scale": row_scale}
    dev = payload.device
    for name, a in ops.items():
        if a.device.type != "cuda" or a.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, "
                             f"got {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = torch.uint8 if name == "payload" else torch.float32
        if a.dtype != want:
            raise TypeError(f"{name} must be {want}, got {a.dtype}")
    m, g2, kg = x_groups.shape
    n = payload.shape[0]
    pshape = (n, kg) if nbits == 4 else (n, planes, kg)
    if g2 != g or tuple(payload.shape) != pshape \
            or tuple(s_groups.shape) != (g, kg) \
            or tuple(row_scale.shape) != (n,):
        raise ValueError(
            f"shape mismatch for nbits={nbits}: x_groups "
            f"{tuple(x_groups.shape)}, payload {tuple(payload.shape)}, "
            f"s_groups {tuple(s_groups.shape)}, row_scale "
            f"{tuple(row_scale.shape)}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    launch, splits_fn = _kernel()
    key = (dev.index, m, n, kg)
    splits = _SPLITS.get(key)
    if splits is None:
        splits = _SPLITS[key] = splits_fn(m, n, kg)
    # split-K partial sums, added in a fixed order by the kernel's reduction
    partial = torch.empty((splits, m, n), dtype=torch.float32, device=dev) \
        if splits > 1 else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(x_groups.data_ptr(), payload.data_ptr(),
                 s_groups.data_ptr(), row_scale.data_ptr(), out.data_ptr(),
                 None if partial is None else partial.data_ptr(),
                 m, n, kg, nbits, splits, stream)
    if err != 0:
        raise RuntimeError(f"dequant_packed kernel launch failed: "
                           f"cudaError_t {err}")
    LAUNCHES[nbits] += 1
    return out
