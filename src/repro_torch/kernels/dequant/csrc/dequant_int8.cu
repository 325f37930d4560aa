// Fused int8 dequantize-matmul for Hopper (sm_90a), f32 accumulation.
//
// Replaces the TPU kernel dequant_matmul_pallas
// (src/repro/kernels/dequant/dequant_matmul.py, body _kernel).  It computes
//
//     out[m, n] = t[n] * sum_k (x[m, k] * s[k]) * z[n, k]
//
// for int8 codes z, f32 x, s and t.  The TPU kernel walks K in a sequential
// grid with a VMEM accumulator; here blocks run in no order, so the k range
// is split across blocks and a second small kernel adds the per-split
// partial sums in a fixed order (the same result on every run).
//
// z is read in place as the serving leaf stores it: codes (in, out) =
// (k, n) (src/repro_torch/quant/qlinear.py), element (n, k) at
// z[k * ldz + n]; models/layers.dense hands the wrapper that leaf's
// transposed (n, k) view, so no code matrix is copied on the serving path.
//
// What bounds it: at decode m (the slot count) is 1..16 and every code is
// used by m rows of x only, so the n * k code bytes (1 per weight) are the
// bound up to m of about 20; above that the 2*m*n*k f32 multiply-adds on
// the CUDA cores are.  The design streams the codes:
//   * a block owns 128 consecutive columns n and one k range (split-K:
//     the launcher splits k until the grid has about 4 blocks per SM);
//   * a warp's 32 lanes read 4 neighbouring code bytes each (one 32-bit
//     load), so a warp reads one 128-byte line of a k row; the block's 8
//     warps walk the k range interleaved, 4 rows per lane per step, and
//     the next step's rows are loaded while the current ones are used
//     (the first step's while x * s is staged);
//   * x * s of the block's k range and m tile is staged once in shared
//     memory as [k][m] (8 loads per thread in flight), read back as
//     broadcast float4s;
//   * a code byte becomes a float without an integer conversion: the
//     byte's sign bit flipped is b + 128 in [0, 255], which placed in the
//     mantissa of 2^23 is exactly 2^23 + b + 128;
//   * the 8 warps' sums are added through shared memory in warp order; t
//     scales the result in the epilogue (or in the split reduction);
//   * ragged n (columns past n, or a row whose codes are not 4-byte
//     aligned) and ragged k are masked in the kernel.
//
// Built by src/repro_torch/kernels/_build.py with plain nvcc (no PyTorch
// headers) and called through ctypes from kernels/dequant/dequant_matmul.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;                        // column groups of 4 per block
constexpr int kWarps = kThreads / kLanes;         // 8 k lanes
constexpr int kCols = 4 * kLanes;                 // 128 columns per block
constexpr int kUnroll = 4;                        // k rows per lane per step
constexpr int kKStep = kWarps * kUnroll;          // 32: k range granule
constexpr int kStageUnroll = 8;                   // x * s loads per thread in flight
constexpr int kBlocksPerSm = 4;                   // split-K target
constexpr int kMaxStage = 24576;                  // staged x * s floats per block (96 KB)
constexpr float kBias = 8388736.0f;               // 2^23 + 128

// Byte i of w (an int8 code) as a float.
__device__ __forceinline__ float code_float(uint32_t w, int i) {
  return __int_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540u | (uint32_t)i)) -
         kBias;
}

// The 4 codes of columns n0..n0+3 in k row kk (0 where a column is past n).
__device__ __forceinline__ uint32_t load_codes(const int8_t* z, long long ldz, int kk, int n0,
                                               int n, bool vec4) {
  const int8_t* src = z + (long long)kk * ldz + n0;
  if (vec4 && n0 + 4 <= n) return __ldg(reinterpret_cast<const uint32_t*>(src));
  uint32_t w = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (n0 + c < n) w |= (uint32_t)(uint8_t)__ldg(src + c) << (8 * c);
  }
  return w;
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
int8_kernel(const float* __restrict__ x, const int8_t* __restrict__ z,
               const float* __restrict__ s, const float* __restrict__ t,
               float* __restrict__ out, float* __restrict__ partial, int m, int n, int k,
               long long ldz, int k_per_split, bool vec4) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);    // [kpad][MT], then [kWarps][MT][kCols]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kCols + 4 * lane;
  const int m0 = blockIdx.y * MT;
  const int kb = blockIdx.z * k_per_split;
  const int kl = min(k, kb + k_per_split) - kb;
  const int kpad = (kl + kKStep - 1) / kKStep * kKStep;

  // the first rows' codes are in flight while x * s is staged
  uint32_t w[kUnroll], nxt[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int kk = warp + u * kWarps;
    w[u] = kk < kl ? load_codes(z, ldz, kb + kk, n0, n, vec4) : 0u;
  }

  // x * s of this k range and m tile (rows past kl and m hold 0), 8 loads
  // per thread in flight
  for (int i0 = threadIdx.x; i0 < MT * kpad; i0 += kThreads * kStageUnroll) {
    float v[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * kThreads;
      const int mi = i / kpad, kk = i % kpad;
      v[u] = (i < MT * kpad && kk < kl && m0 + mi < m)
                 ? x[(size_t)(m0 + mi) * k + kb + kk] * s[kb + kk]
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < MT * kpad) xs[(i % kpad) * MT + i / kpad] = v[u];
    }
  }
  __syncthreads();

  float acc[MT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[mi][c] = 0.0f;
  }

  for (int k0 = warp; k0 < kpad; k0 += kKStep) {
    // the next rows' codes are in flight while these are used
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kk = k0 + kKStep + u * kWarps;
      nxt[u] = kk < kl ? load_codes(z, ldz, kb + kk, n0, n, vec4) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float* xr = xs + (k0 + u * kWarps) * MT;
      float c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = code_float(w[u], j);
      if constexpr (MT % 4 == 0) {
#pragma unroll
        for (int q = 0; q < MT / 4; ++q) {
          const float4 xv = reinterpret_cast<const float4*>(xr)[q];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[4 * q + 0][j] = fmaf(xv.x, c[j], acc[4 * q + 0][j]);
            acc[4 * q + 1][j] = fmaf(xv.y, c[j], acc[4 * q + 1][j]);
            acc[4 * q + 2][j] = fmaf(xv.z, c[j], acc[4 * q + 2][j]);
            acc[4 * q + 3][j] = fmaf(xv.w, c[j], acc[4 * q + 3][j]);
          }
        }
      } else {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float xv = xr[mi];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][j] = fmaf(xv, c[j], acc[mi][j]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) w[u] = nxt[u];
  }

  // the 8 warps' sums, added in warp order
  __syncthreads();
  float* red = xs;                                // [kWarps][MT][kCols]
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    *reinterpret_cast<float4*>(red + ((size_t)warp * MT + mi) * kCols + 4 * lane) =
        make_float4(acc[mi][0], acc[mi][1], acc[mi][2], acc[mi][3]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MT * kCols; i += kThreads) {
    const int mi = i / kCols, col = i % kCols;
    const int row = m0 + mi, nn = blockIdx.x * kCols + col;
    if (row >= m || nn >= n) continue;
    float a = 0.0f;
#pragma unroll
    for (int wq = 0; wq < kWarps; ++wq) a += red[((size_t)wq * MT + mi) * kCols + col];
    if (gridDim.z == 1) {
      out[(size_t)row * n + nn] = a * t[nn];
    } else {
      partial[((size_t)blockIdx.z * m + row) * n + nn] = a;
    }
  }
}

// out[i] = t[i % n] * sum over splits of partial[split][i], in split order.
__global__ void reduce_int8_splits(const float* __restrict__ partial,
                                   const float* __restrict__ t, float* __restrict__ out,
                                   int m, int n, int splits) {
  const size_t mn = (size_t)m * n;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float a = 0.0f;
  for (int zi = 0; zi < splits; ++zi) a += partial[zi * mn + i];
  out[i] = a * t[i % n];
}

int pick_mt(int m) { return m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : m <= 8 ? 8 : 16; }

int sm_count() {
  static int count = [] {
    int dev = 0, c = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      return 132;
    }
    return c;
  }();
  return count;
}

// k rows per split (a multiple of kKStep): enough blocks for kBlocksPerSm
// per SM, at least 2 granules per split, at most kMaxStage staged floats.
int k_per_split_for(int m, int n, int k) {
  const int mt = pick_mt(m);
  const long blocks = (long)((n + kCols - 1) / kCols) * ((m + mt - 1) / mt);
  const int granules = (k + kKStep - 1) / kKStep;
  const long want = ((long)kBlocksPerSm * sm_count() + blocks - 1) / blocks;
  const int splits = (int)std::max<long>(1, std::min<long>(want, granules / 2));
  const int per = (granules + splits - 1) / splits;
  return std::min(per * kKStep, kMaxStage / mt / kKStep * kKStep);
}

template <int MT>
cudaError_t launch(const float* x, const int8_t* z, const float* s, const float* t,
                   float* out, float* partial, int splits, int m, int n, int k, long long ldz,
                   cudaStream_t stream) {
  int per = k_per_split_for(m, n, k);
  int grid_z = (k + per - 1) / per;
  if (grid_z > splits) {                          // fewer splits than asked for: widen
    per = ((k + splits - 1) / splits + kKStep - 1) / kKStep * kKStep;
    grid_z = (k + per - 1) / per;
  }
  const size_t smem = sizeof(float) * std::max<size_t>((size_t)per * MT,
                                                       (size_t)kWarps * MT * kCols);
  auto kernel = int8_kernel<MT>;
  if (smem > 48 * 1024) {
    static cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * std::max(kMaxStage, kWarps * MT * kCols)));
    if (attr != cudaSuccess) return attr;
  }
  const bool vec4 = (ldz % 4 == 0) && (reinterpret_cast<uintptr_t>(z) % 4 == 0);
  const dim3 grid((n + kCols - 1) / kCols, (m + MT - 1) / MT, grid_z);
  kernel<<<grid, kThreads, smem, stream>>>(x, z, s, t, out, partial, m, n, k, ldz, per, vec4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || grid_z == 1) return err;
  const size_t mn = (size_t)m * n;
  reduce_int8_splits<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(partial, t, out, m, n,
                                                                       grid_z);
  return cudaGetLastError();
}

}  // namespace

// Number of k splits of an (m, n, k) product; the caller keeps it per
// shape and provides a workspace of splits * m * n floats when it is
// above 1.
extern "C" int dequant_matmul_int8_splits(int m, int n, int k) {
  if (m <= 0 || n <= 0 || k <= 0) return 1;
  const int per = k_per_split_for(m, n, k);
  return (k + per - 1) / per;
}

// x (m, k) f32, z int8 codes with element (n, k) at z[k * ldz + n] (ldz
// >= n), s (k) f32, t (n) f32, out (m, n) f32, partial (splits, m, n) f32
// scratch when splits > 1; x, s, t and out contiguous on the current
// device.  Any splits >= 1 is safe: the launch uses at most that many k
// ranges.  Returns the cudaError_t of the launches (0 on success);
// launches nothing when m or n is 0.
extern "C" int dequant_matmul_int8_f32(const void* x, const void* z, const void* s,
                                       const void* t, void* out, void* partial, int m, int n,
                                       int k, long long ldz, int splits, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || ldz < n || splits < 1 || (splits > 1 && partial == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* xf = static_cast<const float*>(x);
  const int8_t* zb = static_cast<const int8_t*>(z);
  const float* sf = static_cast<const float*>(s);
  const float* tf = static_cast<const float*>(t);
  float* of = static_cast<float*>(out);
  float* pf = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pick_mt(m)) {
    case 1: return (int)launch<1>(xf, zb, sf, tf, of, pf, splits, m, n, k, ldz, st);
    case 2: return (int)launch<2>(xf, zb, sf, tf, of, pf, splits, m, n, k, ldz, st);
    case 4: return (int)launch<4>(xf, zb, sf, tf, of, pf, splits, m, n, k, ldz, st);
    case 8: return (int)launch<8>(xf, zb, sf, tf, of, pf, splits, m, n, k, ldz, st);
    default: return (int)launch<16>(xf, zb, sf, tf, of, pf, splits, m, n, k, ldz, st);
  }
}
