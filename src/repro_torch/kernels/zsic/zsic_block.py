"""Launcher of the hand-written in-block ZSIC CUDA kernel.

Port of ``repro/kernels/zsic/zsic_block.py::zsic_block_pallas``; the kernel
itself is ``csrc/zsic_block.cu`` (its header note says what bounds it and
how it is designed).  This module checks the operands, allocates the
outputs (or takes the caller's column slices), launches on the current stream, raises on a launch error, and
counts the launches (``zsic_block_cuda.launches``, bumped once per call
that launches and nowhere else, under a lock: the plan executor launches
it from several threads) so a run can show that its main path went
through the kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

__all__ = ["zsic_block_cuda", "reset_launches", "MAX_BLOCK"]

#: widest column block the kernel takes
MAX_BLOCK = 128

_launch = None
_count_lock = threading.Lock()


def reset_launches() -> None:
    zsic_block_cuda.launches = 0


def _kernel():
    global _launch
    if _launch is None:
        from repro_torch.kernels._build import load
        fn = load("zsic_block").zsic_block_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def zsic_block_cuda(y: torch.Tensor, l_block: torch.Tensor,
                    alphas: torch.Tensor, *, out=None):
    """Quantize one column block on the card: y (a, bn), l_block (bn, bn),
    alphas (bn,), all f32 CUDA tensors on one device, bn ≤ 128 →
    (codes int32 (a, bn), residual f32 (a, bn)).

    ``y`` and ``l_block`` may be column slices of larger matrices (unit
    column stride, any row stride); ``alphas`` must be contiguous.  With
    ``out=(codes, residual)`` (int32 and f32 (a, bn) on the same device,
    unit column stride, any row stride: column slices of the caller's full
    outputs) the kernel writes there and nothing is allocated.
    """
    a, bn = y.shape
    dev = y.device
    for name, t in (("y", y), ("l_block", l_block), ("alphas", alphas)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype} (the "
                            "kernel runs the recursion in f32)")
    if tuple(l_block.shape) != (bn, bn) or tuple(alphas.shape) != (bn,):
        raise ValueError(f"shape mismatch: y {tuple(y.shape)}, l_block "
                         f"{tuple(l_block.shape)}, alphas "
                         f"{tuple(alphas.shape)}")
    if not 1 <= bn <= MAX_BLOCK:
        raise ValueError(f"block width {bn} outside 1..{MAX_BLOCK}")
    if (a > 1 and y.stride(1) != 1) or l_block.stride(1) != 1 \
            or not alphas.is_contiguous():
        raise ValueError("y and l_block need unit column stride and "
                         "alphas must be contiguous")
    if out is None:
        z = torch.empty((a, bn), dtype=torch.int32, device=dev)
        resid = torch.empty((a, bn), dtype=torch.float32, device=dev)
    else:
        z, resid = out
        for name, t, dt in (("codes", z, torch.int32),
                            ("residual", resid, torch.float32)):
            if t.device != dev or t.dtype != dt or tuple(t.shape) != (a, bn):
                raise ValueError(f"out {name} must be {dt} {(a, bn)} on "
                                 f"{dev}, got {t.dtype} {tuple(t.shape)} "
                                 f"on {t.device}")
            if a > 1 and bn > 1 and t.stride(1) != 1:
                raise ValueError(f"out {name} needs unit column stride")
    if a == 0:
        return z, resid
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(y.data_ptr(), y.stride(0), l_block.data_ptr(),
                    l_block.stride(0), alphas.data_ptr(), z.data_ptr(),
                    z.stride(0), resid.data_ptr(), resid.stride(0), a, bn,
                    stream)
    if err != 0:
        raise RuntimeError(f"zsic_block kernel launch failed: cudaError_t "
                           f"{err}")
    with _count_lock:
        zsic_block_cuda.launches += 1
    return z, resid


zsic_block_cuda.launches = 0
