// Fused packed dequantize-matmul for Hopper (sm_90a), f32 accumulation.
//
// Replaces the TPU kernel dequant_matmul_packed_pallas
// (src/repro/kernels/dequant/dequant_matmul.py, body _packed_kernel and
// _unpack_planes).  It computes
//
//     out[m, n] = t[n] * sum_g sum_j (x[m, g*kg + j] * s[g*kg + j]) * Z_g[n, j]
//
// where Z_g is column group g of a planar payload (src/repro_torch/core/
// packing.py): int4 = two sign-extended nibbles per byte (G = 2), int2 =
// four 2-bit fields (G = 4, range [-2, 1]), int3 = three bit-plane bytes
// carrying eight biased codes u - 4 (G = 8).  Escapes are applied outside
// the kernel (ops.py), as on the TPU.
//
// What bounds it: at decode m (the slot count) is 1..16, so each payload
// byte is used by at most 16 rows of x.  The kernel must stream
// n * kg * planes payload bytes from device memory once; at m = 1 those
// bytes are the bound, and from m of about 4 up the f32 multiply-adds on
// the CUDA cores are (2*m*n*k operations against 67 TFLOP/s).  Both are a
// few microseconds at the serving shapes, so what decides the time is how
// many bytes are in flight.  The design:
//   * each block owns 16 output rows and a contiguous range of k (split-K):
//     the launcher splits k until the grid has about 8 blocks per SM, so
//     every block runs only a few stages and all SMs stream at once; the
//     per-split partial sums go to a workspace and a second small kernel
//     adds them in a fixed order (deterministic) and applies t;
//   * in a warp, 8 lanes share a row and each lane loads 16 contiguous
//     payload bytes per plane (one 16-byte load where the row is 16-byte
//     aligned), so a warp reads 4 rows x 128 bytes per stage, coalesced;
//   * the next stage's payload is loaded into registers before the current
//     stage is staged and computed, so device-memory latency overlaps both;
//   * x * s for the stage's 128 byte-columns, all G groups and all m rows
//     of the tile is staged once per block in shared memory (padded every
//     16 floats, so the 8 lanes of a row read 16-byte vectors without bank
//     conflicts; the 4 rows of a warp read the same addresses);
//   * codes are unpacked in registers without int-to-float conversions:
//     a biased code b in [0, 255] placed in the mantissa of 2^23 is exactly
//     2^23 + b, so one byte permute and one subtraction give the code;
//   * the 8 lanes of a row reduce their f32 sums with warp shuffles; t
//     scales the result in the epilogue (or in the split reduction);
//   * ragged n (rows past n) and ragged kg (byte-columns past kg, or a row
//     that is not 16-byte aligned) are masked in the kernel.
//
// Built by src/repro_torch/kernels/_build.py with plain nvcc (no PyTorch
// headers) and called through ctypes from kernels/dequant/dequant_matmul.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;                                // 4 warps
constexpr int kLanesPerRow = 8;
constexpr int kRowsPerWarp = 32 / kLanesPerRow;              // 4
constexpr int kRowsPerBlock = (kThreads / 32) * kRowsPerWarp;  // 16
constexpr int kChunk = kLanesPerRow * 16;                    // byte-columns per stage
constexpr int kChunkPad = kChunk + kChunk / 4;               // 4 pad floats per 16
constexpr int kBlocksPerSm = 8;                              // split-K target
static_assert(kChunk == kThreads, "staging maps one byte-column to each thread");

template <int NBITS> struct Layout;
template <> struct Layout<4> { static constexpr int G = 2, P = 1; static constexpr float kBias = 8388616.0f; };
template <> struct Layout<3> { static constexpr int G = 8, P = 3; static constexpr float kBias = 8388612.0f; };
template <> struct Layout<2> { static constexpr int G = 4, P = 1; static constexpr float kBias = 8388610.0f; };

__device__ __forceinline__ int swizzle(int jj) { return jj + (jj >> 4) * 4; }

__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Byte i of w (a biased code) as the float 2^23 + byte.
__device__ __forceinline__ float biased_float(uint32_t w, int i) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | (uint32_t)i));
}

// Biased codes of column group g for the 4 byte-columns of one payload word
// per plane; byte i holds the code of byte-column i plus the layout's bias.
template <int NBITS>
__device__ __forceinline__ uint32_t group_bytes(const uint32_t (&w)[Layout<NBITS>::P], int g);

template <>
__device__ __forceinline__ uint32_t group_bytes<4>(const uint32_t (&w)[1], int g) {
  // nibble u sign-extends to (u ^ 8) - 8
  return ((w[0] ^ 0x88888888u) >> (4 * g)) & 0x0F0F0F0Fu;
}

template <>
__device__ __forceinline__ uint32_t group_bytes<2>(const uint32_t (&w)[1], int g) {
  // 2-bit field u sign-extends to (u ^ 2) - 2
  return ((w[0] ^ 0xAAAAAAAAu) >> (2 * g)) & 0x03030303u;
}

template <>
__device__ __forceinline__ uint32_t group_bytes<3>(const uint32_t (&w)[3], int g) {
  // bit g of bit-plane byte b is bit b of group g's biased code u = code + 4
  return ((w[0] >> g) & 0x01010101u) | (((w[1] >> g) & 0x01010101u) << 1) |
         (((w[2] >> g) & 0x01010101u) << 2);
}

template <int P>
__device__ __forceinline__ void load_stage(uint4 (&dst)[P], const uint8_t* prow,
                                           int kg, int j, bool row_ok, bool vec16) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const uint8_t* src = prow + (size_t)p * kg + j;
    if (row_ok && vec16 && j + 16 <= kg) {
      dst[p] = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (row_ok) {
        for (int b = 0; b < 16; ++b) {
          if (j + b < kg) w[b >> 2] |= (uint32_t)__ldg(src + b) << (8 * (b & 3));
        }
      }
      dst[p] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <int NBITS, int MT>
__global__ void __launch_bounds__(kThreads)
dequant_packed_kernel(const float* __restrict__ x, const uint8_t* __restrict__ payload,
                      const float* __restrict__ s, const float* __restrict__ t,
                      float* __restrict__ out, float* __restrict__ partial,
                      int m, int n, int kg, int stages_per_split, bool vec16) {
  constexpr int G = Layout<NBITS>::G;
  constexpr int P = Layout<NBITS>::P;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);               // [MT][G][kChunkPad]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rg = lane / kLanesPerRow;
  const int cl = lane % kLanesPerRow;
  const int row = blockIdx.x * kRowsPerBlock + (tid >> 5) * kRowsPerWarp + rg;
  const int m0 = blockIdx.y * MT;
  const bool row_ok = row < n;
  const int kx = G * kg;
  const uint8_t* prow = payload + (size_t)(row_ok ? row : 0) * P * kg;

  float acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0.0f;

  uint4 cur[P], nxt[P];
  const int n_stages = (kg + kChunk - 1) / kChunk;
  const int c_begin = blockIdx.z * stages_per_split;
  const int c_end = min(n_stages, c_begin + stages_per_split);
  load_stage<P>(cur, prow, kg, c_begin * kChunk + cl * 16, row_ok, vec16);

  for (int c = c_begin; c < c_end; ++c) {
    const int j0 = c * kChunk;
    // the next stage's payload is in flight while x * s is staged
    if (c + 1 < c_end) load_stage<P>(nxt, prow, kg, j0 + kChunk + cl * 16, row_ok, vec16);
    {
      // kChunk == kThreads: thread tid stages byte-column j0 + tid of every
      // group and every row; s is read once per group, all loads unrolled
      const int j = j0 + tid;
      const bool j_ok = j < kg;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int col = g * kg + j;
        const float sv = j_ok ? s[col] : 0.0f;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float xv = (j_ok && m0 + mi < m) ? x[(size_t)(m0 + mi) * kx + col] : 0.0f;
          xs[(mi * G + g) * kChunkPad + swizzle(tid)] = xv * sv;
        }
      }
    }
    __syncthreads();

    const float* xb = xs + swizzle(cl * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t w[P];
#pragma unroll
      for (int p = 0; p < P; ++p) w[p] = word(cur[p], q);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const uint32_t u = group_bytes<NBITS>(w, g);
        const float c0 = biased_float(u, 0) - Layout<NBITS>::kBias;
        const float c1 = biased_float(u, 1) - Layout<NBITS>::kBias;
        const float c2 = biased_float(u, 2) - Layout<NBITS>::kBias;
        const float c3 = biased_float(u, 3) - Layout<NBITS>::kBias;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float4 xv = *reinterpret_cast<const float4*>(xb + (mi * G + g) * kChunkPad + 4 * q);
          float a = acc[mi];
          a = fmaf(xv.x, c0, a);
          a = fmaf(xv.y, c1, a);
          a = fmaf(xv.z, c2, a);
          a = fmaf(xv.w, c3, a);
          acc[mi] = a;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < P; ++p) cur[p] = nxt[p];
  }

#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    float v = acc[mi];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    acc[mi] = v;
  }
  if (row_ok && cl == 0) {
    if (gridDim.z == 1) {
      const float tr = t[row];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (m0 + mi < m) out[(size_t)(m0 + mi) * n + row] = acc[mi] * tr;
      }
    } else {
      float* dst = partial + (size_t)blockIdx.z * m * n;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (m0 + mi < m) dst[(size_t)(m0 + mi) * n + row] = acc[mi];
      }
    }
  }
}

// out[i] = t[i % n] * sum over splits of partial[split][i], in split order.
__global__ void reduce_splits_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ t, float* __restrict__ out,
                                     int m, int n, int splits) {
  const size_t mn = (size_t)m * n;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float a = 0.0f;
  for (int z = 0; z < splits; ++z) a += partial[z * mn + i];
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

// Number of k splits: enough blocks for kBlocksPerSm per SM, whole stages
// per split, and no split without a stage.
int splits_for(int m, int n, int kg) {
  const int mt = pick_mt(m);
  const long blocks = (long)((n + kRowsPerBlock - 1) / kRowsPerBlock) * ((m + mt - 1) / mt);
  const int n_stages = (kg + kChunk - 1) / kChunk;
  const long want = ((long)kBlocksPerSm * sm_count() + blocks - 1) / blocks;
  const int splits = (int)std::min<long>(n_stages, std::max<long>(1, want));
  const int per = (n_stages + splits - 1) / splits;
  return (n_stages + per - 1) / per;
}

template <int NBITS, int MT>
cudaError_t launch(const float* x, const uint8_t* payload, const float* s, const float* t,
                   float* out, float* partial, int splits, int m, int n, int kg,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * MT * Layout<NBITS>::G * kChunkPad;
  auto kernel = dequant_packed_kernel<NBITS, MT>;
  if (smem > 48 * 1024) {
    static cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
  }
  const bool vec16 = (kg % 16 == 0) && (reinterpret_cast<uintptr_t>(payload) % 16 == 0);
  const int n_stages = (kg + kChunk - 1) / kChunk;
  const int per = (n_stages + splits - 1) / splits;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, (m + MT - 1) / MT,
                  (n_stages + per - 1) / per);
  kernel<<<grid, kThreads, smem, stream>>>(x, payload, s, t, out, partial, m, n, kg, per,
                                           vec16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || grid.z == 1) return err;
  const size_t mn = (size_t)m * n;
  reduce_splits_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(partial, t, out, m,
                                                                        n, (int)grid.z);
  return cudaGetLastError();
}

template <int NBITS>
cudaError_t launch_nbits(const float* x, const uint8_t* payload, const float* s,
                         const float* t, float* out, float* partial, int splits, int m,
                         int n, int kg, cudaStream_t stream) {
  switch (pick_mt(m)) {
    case 1: return launch<NBITS, 1>(x, payload, s, t, out, partial, splits, m, n, kg, stream);
    case 2: return launch<NBITS, 2>(x, payload, s, t, out, partial, splits, m, n, kg, stream);
    case 4: return launch<NBITS, 4>(x, payload, s, t, out, partial, splits, m, n, kg, stream);
    case 8: return launch<NBITS, 8>(x, payload, s, t, out, partial, splits, m, n, kg, stream);
    default: return launch<NBITS, 16>(x, payload, s, t, out, partial, splits, m, n, kg, stream);
  }
}

}  // namespace

// Number of k splits to launch an (m, n, kg) product with; the caller
// keeps it per shape and provides a workspace of splits * m * n floats
// when it is above 1.
extern "C" int dequant_matmul_packed_splits(int m, int n, int kg) {
  if (m <= 0 || n <= 0 || kg <= 0) return 1;
  return splits_for(m, n, kg);
}

// x (m, G*kg) f32, payload uint8 (n, planes, kg), s (G*kg) f32, t (n) f32,
// out (m, n) f32, partial (splits, m, n) f32 scratch when splits > 1; all
// contiguous on the current device.  Any splits >= 1 is safe: the launch
// uses at most that many k ranges.  Returns the cudaError_t of the
// launches (0 on success); launches nothing when m or n is 0.
extern "C" int dequant_matmul_packed_f32(const void* x, const void* payload, const void* s,
                                         const void* t, void* out, void* partial, int m,
                                         int n, int kg, int nbits, int splits,
                                         void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (kg <= 0 || splits < 1 || (splits > 1 && partial == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* xf = static_cast<const float*>(x);
  const uint8_t* pb = static_cast<const uint8_t*>(payload);
  const float* sf = static_cast<const float*>(s);
  const float* tf = static_cast<const float*>(t);
  float* of = static_cast<float*>(out);
  float* pf = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 4: return (int)launch_nbits<4>(xf, pb, sf, tf, of, pf, splits, m, n, kg, st);
    case 3: return (int)launch_nbits<3>(xf, pb, sf, tf, of, pf, splits, m, n, kg, st);
    case 2: return (int)launch_nbits<2>(xf, pb, sf, tf, of, pf, splits, m, n, kg, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
