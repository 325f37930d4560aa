// In-block ZSIC recursion (paper Alg. 1 on one column block) for Hopper
// (sm_90a), f32.
//
// Replaces the TPU kernel zsic_block_pallas
// (src/repro/kernels/zsic/zsic_block.py, bodies _kernel and _kernel_masked,
// which compute the same function).  For one block of bn <= 128 columns and
// every row r of y (a, bn), from the last column down:
//
//     z[r, i]  = rint( y[r, i] / (alpha_i * L[i, i]) )      (half to even)
//     y[r, j] -= z[r, i] * (alpha_i * L[i, j])              for j <= i
//
// and the kernel returns the int32 codes z and the residual y.  L is the
// block's lower-triangular square of a Cholesky factor; entries above its
// diagonal are never read.  The trailing update onto the columns left of
// the block is a dense matmul outside the kernel (kernels/zsic/ops.py).
//
// Arithmetic is that of the plain version (core/zsic.py) to the bit: true
// division (__fdiv_rn), rintf, and the update as a rounded product followed
// by a rounded subtraction (__fmul_rn, __fsub_rn), never contracted into an
// FMA.  Build without --use_fast_math.
//
// What bounds it: rows are independent, but inside a row the 128 columns
// form a chain of dependent steps (each code needs the residual that all
// later columns left behind).  The bytes (y in, codes and residual out, the
// L block) take a few microseconds at 3.35 TB/s.  The a*bn*(bn+1)/2
// multiply-subtracts are two f32 instructions each (unfused, so at half the
// 67 TFLOP/s FMA rate) and, with the a*bn divisions, take slightly longer
// than the bytes at a = 5760 (the recursion must be exact in f32, so the
// tensor cores do not apply); the dependent chain of 128
// divide-round-broadcast steps per row decides the time.  The design:
//   * 4 threads share a row and each keeps 32 of its columns in registers,
//     interleaved (column j lives in thread j % 4 at slot j / 4), so the
//     update work of a step is spread evenly over the 4 threads and a step
//     costs one division in the owner thread plus one shuffle;
//   * the alpha-scaled rows alpha_i * L[i, :] are computed once per block
//     into shared memory, laid out by owner thread with each thread's 32
//     slots padded to 36 floats, so the 16-byte loads of the 4 owners fall
//     into distinct banks and the 8 rows of a warp read them as broadcasts;
//   * the column loop and the per-thread slot loop are fully unrolled, so
//     every register index is a compile-time constant;
//   * 32 rows per block of 128 threads, so a = 5760 gives 180 blocks; rows
//     past a are computed on zeros and never stored.
//
// Built by src/repro_torch/kernels/_build.py with plain nvcc (no PyTorch
// headers) and called through ctypes from kernels/zsic/zsic_block.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBn = 128;                        // columns of a full block
constexpr int kTpr = 4;                         // threads per row
constexpr int kSlots = kBn / kTpr;              // columns per thread (32)
constexpr int kSeg = kSlots + 4;                // padded slots per thread
constexpr int kRows = 32;                       // rows per block
constexpr int kThreads = kRows * kTpr;          // 128
constexpr int kSmemBytes = (kBn * kTpr * kSeg + kBn) * sizeof(float);

__global__ void __launch_bounds__(kThreads)
zsic_block_kernel(const float* __restrict__ y, int ldy,
                  const float* __restrict__ l, int ldl,
                  const float* __restrict__ alpha,
                  int32_t* __restrict__ z, int ldz,
                  float* __restrict__ resid, int ldr, int a, int bn) {
  extern __shared__ float smem[];
  float* sl = smem;                             // [i][owner][slot], padded
  float* step = smem + kBn * kTpr * kSeg;       // alpha_i * L[i, i]

  for (int idx = threadIdx.x; idx < kBn * kBn; idx += kThreads) {
    const int i = idx / kBn, j = idx % kBn;
    float v = 0.0f;
    if (i < bn && j <= i) v = __fmul_rn(alpha[i], l[(size_t)i * ldl + j]);
    sl[(i * kTpr + j % kTpr) * kSeg + j / kTpr] = v;
  }
  for (int i = threadIdx.x; i < kBn; i += kThreads)
    step[i] = i < bn ? __fmul_rn(alpha[i], l[(size_t)i * ldl + i]) : 1.0f;
  __syncthreads();

  const int t = threadIdx.x % kTpr;
  const int row = blockIdx.x * kRows + threadIdx.x / kTpr;
  const bool live = row < a;

  float yr[kSlots];
  float zr[kSlots];
#pragma unroll
  for (int c = 0; c < kSlots; ++c) {
    const int j = c * kTpr + t;
    yr[c] = (live && j < bn) ? y[(size_t)row * ldy + j] : 0.0f;
    zr[c] = 0.0f;
  }

#pragma unroll
  for (int i = kBn - 1; i >= 0; --i) {
    if (i < bn) {                               // uniform over the block
      const int owner = i % kTpr, ci = i / kTpr;
      // the owner's slot ci is column i; the other threads compute a value
      // that the shuffle discards
      const float zl = rintf(__fdiv_rn(yr[ci], step[i]));
      const float zi = __shfl_sync(0xffffffffu, zl, owner, kTpr);
      if (t == owner) zr[ci] = zi;
      const float* srow = sl + (i * kTpr + t) * kSeg;
#pragma unroll
      for (int c = 0; c <= ci; c += 4) {
        const float4 s4 = *reinterpret_cast<const float4*>(srow + c);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = c + e;
          // slot < ci: column 4*slot + t < i; slot == ci: column i - owner
          // + t, which is <= i only for t <= owner; slot > ci: right of i
          if (slot < ci || (slot == ci && t <= owner))
            yr[slot] = __fsub_rn(yr[slot], __fmul_rn(zi, sv[e]));
        }
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int c = 0; c < kSlots; ++c) {
    const int j = c * kTpr + t;
    if (j < bn) {
      z[(size_t)row * ldz + j] = __float2int_rn(zr[c]);
      resid[(size_t)row * ldr + j] = yr[c];
    }
  }
}

}  // namespace

extern "C" {

// Largest block width the kernel takes.
int zsic_block_max_bn() { return kBn; }

// y (a, bn) with row stride ldy, L block (bn, bn) with row stride ldl,
// alpha (bn,); writes z (a, bn) int32 and resid (a, bn) with row strides
// ldz, ldr.  Launches on `stream`; returns the cudaError_t of the launch.
int zsic_block_f32(const float* y, int ldy, const float* l, int ldl,
                   const float* alpha, int32_t* z, int ldz, float* resid,
                   int ldr, int a, int bn, void* stream) {
  if (bn < 1 || bn > kBn || a < 0) return (int)cudaErrorInvalidValue;
  if (a == 0) return 0;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        zsic_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int blocks = (a + kRows - 1) / kRows;
  zsic_block_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      y, ldy, l, ldl, alpha, z, ldz, resid, ldr, a, bn);
  return (int)cudaGetLastError();
}

}  // extern "C"
