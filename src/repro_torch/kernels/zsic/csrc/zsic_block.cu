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
// and the kernel writes the int32 codes z and the residual y, with any row
// strides (the caller passes column slices of its full outputs).  L is the
// block's lower-triangular square of a Cholesky factor; entries above its
// diagonal are never read.  The trailing update onto the columns left of
// the block is a dense matmul outside the kernel (kernels/zsic/ops.py).
//
// Arithmetic is that of the plain version (core/zsic.py) to the bit: true
// division (__fdiv_rn), rintf, and the update as a rounded product followed
// by a rounded subtraction (__fmul_rn, __fsub_rn), never contracted into an
// FMA, each element updated in descending i.  Build without
// --use_fast_math.
//
// What bounds it: rows are independent, but inside a row the 128 columns
// form a chain of dependent steps (each code needs the residual that all
// later columns left behind).  The bytes and the a*bn*(bn+1)/2 unfused
// multiply-subtracts take a few microseconds at most; the chain of 128
// divide-round-broadcast steps per row decides the time.  The design:
//   * 4 threads share a row and each keeps 32 of its columns in registers,
//     interleaved (column j lives in thread j % 4 at slot j / 4), so a
//     step costs one division in the owner thread plus one shuffle;
//   * the columns are walked in groups of 4 (one slot of each thread) by a
//     runtime loop whose body (4 steps) is unrolled: the thread's slots are
//     shifted down one register at the end of every group, so the group's
//     slot is always register 31 and every register index is a
//     compile-time constant, without unrolling all 128 columns (the code
//     the instruction cache must hold is one group body per phase);
//   * four phases of 8 groups each update only the registers that can
//     still hold a live slot (32, 24, 16, 8);
//   * in a step, the update of column i - 1 comes first and the next
//     step's division right after it; the other columns' updates fill the
//     division's latency (issuing the next shuffle before them, dividing
//     by a reciprocal made in the set-up, or staging L through registers
//     while the chain runs all measured slower);
//   * a column is final once its step is done: its code and residual are
//     stored at the end of its group, so no code array is held;
//   * the block's alpha-scaled rows alpha_i * L[i, :] are laid out in
//     shared memory as each thread reads them, already shifted to its
//     registers (zeros above the diagonal and below slot 0), brought in by
//     one 4-byte cp.async per entry, all in flight before a single wait,
//     and scaled in place in batches of 16 rows whose loads are all issued
//     before their stores (one read-modify-write at a time made the pass
//     take most of the block's time); each thread's 32 entries of a row
//     are padded to 36 floats, so the 16-byte loads of the 4 threads of a
//     row fall into distinct banks and the 8 rows of a warp read them as
//     broadcasts;
//   * 32 rows per block of 128 threads, so a = 5760 gives 180 blocks; rows
//     past a, columns past bn and slots below 0 are computed on ones (a
//     zero would take the division's slow path) and never stored.
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
constexpr int kScaleRows = 16;                 // rows scaled per batch
constexpr int kSmemFloats = kBn * kTpr * kSeg + 2 * kBn;
constexpr int kSmemBytes = kSmemFloats * sizeof(float);
static_assert(kThreads == kBn, "the prologue maps one thread to each (t, k)");

// 4 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

// One group g: the steps of columns 4g + 3 .. 4g (owner threads 3 .. 0).
// r[31] is slot g, r[31 - d] slot g - d; NL registers from the top can be
// live.  zl carries the division of the group's first column in and the
// next group's first column out.
template <int NL>
__device__ __forceinline__ void group(float (&r)[kSlots], float& zl, float& zmine,
                                      const float* __restrict__ sl,
                                      const float* __restrict__ step, int g, int t) {
#pragma unroll
  for (int o = kTpr - 1; o >= 0; --o) {
    const int i = kTpr * g + o;
    const float* srow = sl + (i * kTpr + t) * kSeg;
    float sv[kSlots];
#pragma unroll
    for (int k = kSlots - NL; k < kSlots; k += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(srow + k);
      sv[k] = s4.x;
      sv[k + 1] = s4.y;
      sv[k + 2] = s4.z;
      sv[k + 3] = s4.w;
    }
    const float zi = __shfl_sync(0xffffffffu, zl, o, kTpr);
    if (t == o) zmine = zi;
    // column i - 1: slot g of thread o - 1, or slot g - 1 of thread 3
    const int crit = o > 0 ? kSlots - 1 : kSlots - 2;
    r[crit] = __fsub_rn(r[crit], __fmul_rn(zi, sv[crit]));
    // the next step's division (its result matters in the owner of i - 1)
    zl = rintf(__fdiv_rn(r[crit], step[i > 0 ? i - 1 : 0]));
#pragma unroll
    for (int k = kSlots - NL; k < kSlots; ++k) {
      if (k != crit) r[k] = __fsub_rn(r[k], __fmul_rn(zi, sv[k]));
    }
  }
}

// Stores the group's finished column (4g + t) and shifts the slots down.
__device__ __forceinline__ void retire(float (&r)[kSlots], float zmine, int g, int t,
                                      bool live, int row, int bn, int32_t* __restrict__ z,
                                      int ldz, float* __restrict__ resid, int ldr) {
  const int j = kTpr * g + t;
  if (live && j < bn) {
    z[(size_t)row * ldz + j] = __float2int_rn(zmine);
    resid[(size_t)row * ldr + j] = r[kSlots - 1];
  }
#pragma unroll
  for (int k = kSlots - 1; k > 0; --k) r[k] = r[k - 1];
  r[0] = 1.0f;
}

__global__ void __launch_bounds__(kThreads)
zsic_block_kernel(const float* __restrict__ y, int ldy,
                  const float* __restrict__ l, int ldl,
                  const float* __restrict__ alpha,
                  int32_t* __restrict__ z, int ldz,
                  float* __restrict__ resid, int ldr, int a, int bn) {
  extern __shared__ float4 smem4[];
  float* sl = reinterpret_cast<float*>(smem4);  // [i][t][k]: alpha_i L[i, 4(g_i-31+k)+t]
  float* alpha_s = sl + kBn * kTpr * kSeg;      // alpha, 0 past bn
  float* step = alpha_s + kBn;                  // alpha_i * L[i, i], 1 past bn

  const int tid = threadIdx.x;
  const int t = tid % kTpr;
  const int row = blockIdx.x * kRows + tid / kTpr;
  const bool live = row < a;
  const int g_top = (bn - 1) / kTpr;

  // the L block's lower triangle, scattered into the thread-by-register
  // layout with all copies in flight before one wait; thread tid fills
  // register k = tid % 32 of thread slot t = tid / 32 for every row i
  {
    const int tk = tid / kSlots, k = tid % kSlots;
    cp_async4(alpha_s + tid, alpha + (tid < bn ? tid : 0), tid < bn);
#pragma unroll 8
    for (int i = 0; i < kBn; ++i) {
      const int c = i / kTpr - (kSlots - 1) + k;
      const int j = kTpr * c + tk;
      const bool ok = i < bn && c >= 0 && j <= i;
      cp_async4(sl + (i * kTpr + tk) * kSeg + k, l + (ok ? (size_t)i * ldl + j : 0), ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // the row's slots, shifted so that slot g_top is register 31, load while
  // the L block is in flight.  Registers that hold no column of a live row
  // hold 1: a zero numerator would send the division down its slow path,
  // and what they compute is never stored (their rows of the scaled L
  // block are 0, so a code they make moves nothing)
  float r[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int c = g_top - (kSlots - 1) + k;
    const int j = kTpr * c + t;
    r[k] = (live && c >= 0 && j < bn) ? y[(size_t)row * ldy + j] : 1.0f;
  }

  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // scale by alpha in place, 16 rows' loads issued before their stores
  {
    const int tk = tid / kSlots, k = tid % kSlots;
#pragma unroll 1
    for (int i0 = 0; i0 < kBn; i0 += kScaleRows) {
      float v[kScaleRows], al[kScaleRows];
#pragma unroll
      for (int u = 0; u < kScaleRows; ++u) {
        v[u] = sl[((i0 + u) * kTpr + tk) * kSeg + k];
        al[u] = alpha_s[i0 + u];
      }
#pragma unroll
      for (int u = 0; u < kScaleRows; ++u) {
        const int i = i0 + u;
        const int c = i / kTpr - (kSlots - 1) + k;
        const int j = kTpr * c + tk;
        if (i < bn && c >= 0 && j <= i) v[u] = __fmul_rn(al[u], v[u]);
        sl[(i * kTpr + tk) * kSeg + k] = v[u];
        if (k == kSlots - 1 && tk == i % kTpr) step[i] = i < bn ? v[u] : 1.0f;
      }
    }
  }
  __syncthreads();

  float zl = rintf(__fdiv_rn(r[kSlots - 1], step[kTpr * g_top + kTpr - 1]));
  float zmine = 0.0f;
  int g = g_top;
  for (; g >= 24; --g) {
    group<32>(r, zl, zmine, sl, step, g, t);
    retire(r, zmine, g, t, live, row, bn, z, ldz, resid, ldr);
  }
  for (; g >= 16; --g) {
    group<24>(r, zl, zmine, sl, step, g, t);
    retire(r, zmine, g, t, live, row, bn, z, ldz, resid, ldr);
  }
  for (; g >= 8; --g) {
    group<16>(r, zl, zmine, sl, step, g, t);
    retire(r, zmine, g, t, live, row, bn, z, ldz, resid, ldr);
  }
  for (; g >= 0; --g) {
    group<8>(r, zl, zmine, sl, step, g, t);
    retire(r, zmine, g, t, live, row, bn, z, ldz, resid, ldr);
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
  static cudaError_t attr = cudaFuncSetAttribute(
      zsic_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const int blocks = (a + kRows - 1) / kRows;
  zsic_block_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      y, ldy, l, ldl, alpha, z, ldz, resid, ldr, a, bn);
  return (int)cudaGetLastError();
}

}  // extern "C"
