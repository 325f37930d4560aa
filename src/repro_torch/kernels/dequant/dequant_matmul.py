"""Launchers of the hand-written dequant-matmul CUDA kernels.

Ports of ``repro/kernels/dequant/dequant_matmul.py``:
``dequant_matmul_packed_pallas`` is ``csrc/dequant_packed.cu`` and
``dequant_matmul_pallas`` (int8 codes) is ``csrc/dequant_int8.cu`` (their
header notes say what bounds them and how they are designed).  This module
checks the operands, allocates the output (and the int8 kernel's split-K
scratch), launches on the current stream, raises on a launch error, and
counts the launches (``LAUNCHES[nbits]``, 8 for the int8 kernel; one per
call that launches, bumped nowhere else) so a run can show that its main
path went through the kernels.  A packed call is one kernel launch: its
split-K partial sums are added inside a thread-block cluster.  An int8
call with more than one k split also runs that kernel's fixed-order
reduction.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["PLANE_GROUPS", "LAUNCHES", "reset_launches",
           "dequant_matmul_packed_cuda", "dequant_matmul_int8_cuda"]

#: column groups per payload byte-column, by payload nbits
PLANE_GROUPS = {2: 4, 3: 8, 4: 2}
#: payload planes per row, by payload nbits
_PLANES = {2: 1, 3: 3, 4: 1}

#: kernel launches per payload nbits (8: the int8 kernel) since the last
#: :func:`reset_launches`
LAUNCHES = {2: 0, 3: 0, 4: 0, 8: 0}

_lib = None
_lib8 = None
#: k splits of an int8 launch, by (device index, m, n, k): the library
#: picks them, this module sizes the workspace from them
_SPLITS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernel():
    """The launch C function of the built packed library."""
    global _lib
    if _lib is None:
        from repro_torch.kernels._build import load
        launch = load("dequant_packed").dequant_matmul_packed_f32
        launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        launch.restype = ctypes.c_int
        _lib = launch
    return _lib


def dequant_matmul_packed_cuda(x_groups: torch.Tensor, payload: torch.Tensor,
                               s_groups: torch.Tensor,
                               row_scale: torch.Tensor, *,
                               nbits: int = 4) -> torch.Tensor:
    """x_groups (m, G, kg) f32 · planar payload → (m, n) f32 on the card,
    in one kernel launch and no memory beyond the output.

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
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(x_groups.data_ptr(), payload.data_ptr(),
                    s_groups.data_ptr(), row_scale.data_ptr(), out.data_ptr(),
                    m, n, kg, nbits, stream)
    if err != 0:
        raise RuntimeError(f"dequant_packed kernel launch failed: "
                           f"cudaError_t {err}")
    LAUNCHES[nbits] += 1
    return out


def _kernel8():
    """(launch, splits) C functions of the built int8 library."""
    global _lib8
    if _lib8 is None:
        from repro_torch.kernels._build import load
        lib = load("dequant_int8")
        launch = lib.dequant_matmul_int8_f32
        launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        launch.restype = ctypes.c_int
        splits = lib.dequant_matmul_int8_splits
        splits.argtypes = [ctypes.c_int] * 3
        splits.restype = ctypes.c_int
        _lib8 = (launch, splits)
    return _lib8


def dequant_matmul_int8_cuda(x: torch.Tensor, z: torch.Tensor,
                             col_scale: torch.Tensor,
                             row_scale: torch.Tensor) -> torch.Tensor:
    """x (m, k) f32 · int8 codes z (n, k) → (m, n) f32 on the card:
    ``out = t ⊙ ((x ⊙ s) @ zᵀ)``.

    The kernel reads the codes as a serving leaf stores them, (k, n) with
    the n index at stride 1, so ``z`` as that leaf's transposed view is
    read in place; any other layout (an (n, k)-contiguous matrix) is first
    copied into it, which the serving path never does.  ``x``,
    ``col_scale`` (k,) and ``row_scale`` (n,) must be contiguous f32;
    every operand a CUDA tensor on one device.
    """
    ops = {"x": x, "z": z, "col_scale": col_scale, "row_scale": row_scale}
    dev = z.device
    for name, a in ops.items():
        if a.device.type != "cuda" or a.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, "
                             f"got {a.device}")
        want = torch.int8 if name == "z" else torch.float32
        if a.dtype != want:
            raise TypeError(f"{name} must be {want}, got {a.dtype}")
        if name != "z" and not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, k = x.shape
    n = z.shape[0]
    if z.ndim != 2 or z.shape[1] != k or tuple(col_scale.shape) != (k,) \
            or tuple(row_scale.shape) != (n,):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, z {tuple(z.shape)}, "
            f"col_scale {tuple(col_scale.shape)}, row_scale "
            f"{tuple(row_scale.shape)}")
    if n > 1 and z.stride(0) != 1:
        z = z.T.contiguous().T
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    launch, splits_fn = _kernel8()
    key = (dev.index, m, n, k)
    splits = _SPLITS.get(key)
    if splits is None:
        splits = _SPLITS[key] = splits_fn(m, n, k)
    partial = torch.empty((splits, m, n), dtype=torch.float32, device=dev) \
        if splits > 1 else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(x.data_ptr(), z.data_ptr(), col_scale.data_ptr(),
                 row_scale.data_ptr(), out.data_ptr(),
                 None if partial is None else partial.data_ptr(),
                 m, n, k, z.stride(1) if k > 1 else n, splits, stream)
    if err != 0:
        raise RuntimeError(f"dequant_int8 kernel launch failed: "
                           f"cudaError_t {err}")
    LAUNCHES[8] += 1
    return out
