"""Hand-written Hopper kernels of the port, with their plain twins.

  dequant/  — fused packed (int4/int3/int2) dequantize-matmul, the
              decode-time kernel of the serving path (CUDA C++, sm_90a)

Each kernel ships ``csrc/*.cu`` (built by ``_build.py`` at first use),
a launcher module, ``ops.py`` (padding, dispatch by device) and ``ref.py``
(the plain PyTorch twin).
"""
