"""Launcher of the hand-written flash attention forward CUDA kernel.

Port of ``repro/kernels/flash/flash_attention.py::flash_attention_pallas``;
the kernel itself is ``csrc/flash_attention.cu`` (its header note says
what bounds it and how it is designed: TF32 tensor cores with a 3-term
split, K and V tiles staged with ``cp.async``).  It reads q, k, v in the
model's (B, S, H, d) layout directly, so nothing is folded or padded: the
kernel masks a ragged S itself.  This module checks the operands,
allocates the output, launches the one kernel on the current stream,
raises on a launch error, and counts the launches
(``flash_attention_cuda.launches``, bumped once per call that launches and
nowhere else).
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["flash_attention_cuda", "reset_launches", "HEAD_DIMS"]

#: head dims the kernel is built for (the reference's MXU-aligned set)
HEAD_DIMS = (64, 128, 256)

_launch = None


def reset_launches() -> None:
    flash_attention_cuda.launches = 0


def _kernel():
    global _launch
    if _launch is None:
        from repro_torch.kernels._build import load
        fn = load("flash_attention").flash_attention_fwd_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q, k, v: (B, S, H, d) contiguous f32 CUDA tensors on one device,
    16-byte aligned (the kernel copies 16-byte chunks), d ∈ {64, 128, 256}
    → (B, S, H, d) f32 attention output."""
    b, s, h, d = q.shape
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != (b, s, h, d):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(b, s, h, d)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, s, h, d, int(causal), int(window),
                    1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
