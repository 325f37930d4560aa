// Fused packed dequantize-matmul for Hopper (sm_90a), f32 accumulation, one
// launch per call: split-K across the blocks of a thread-block cluster.
//
// Replaces the TPU kernel dequant_matmul_packed_pallas
// (src/repro/kernels/dequant/dequant_matmul.py, body _packed_kernel and
// _unpack_planes).  It computes
//
//     out[m, n] = t[n] * sum_g sum_j x[m, g*kg + j] * s[g*kg + j] * Z_g[n, j]
//
// where Z_g is column group g of a planar payload (src/repro_torch/core/
// packing.py): int4 = two sign-extended nibbles per byte (G = 2), int2 =
// four 2-bit fields (G = 4, range [-2, 1]), int3 = three bit-plane bytes
// carrying eight biased codes u - 4 (G = 8).  Escapes are applied outside
// the kernel (ops.py), as on the TPU.
//
// Two kernels, chosen by the wrapper by m (kernels/dequant/dequant_matmul.py,
// TC_MIN_M): from TC_MIN_M rows of x on (prefill, encode, cross K/V) the
// tensor-core kernel of dequant_tc.cuh, whose header note says what bounds
// it and how it is designed (codes decoded in registers into wgmma's A
// fragments, x * s split into three exact bf16 terms, split-K over a
// cluster); this file gives it its code decoder (the end of the file).
// Below TC_MIN_M the decode kernel, described from here on.
//
// What bounds it: at decode m (the slot count) is 1..16, so each payload
// byte is used by at most 16 rows of x.  The kernel must stream
// n * kg * planes payload bytes from device memory once (0.4 to 2 us at
// minicpm-2b's shapes), and the 2*m*n*k f32 operations on the CUDA cores
// take 1.3 to 3.2 us at m = 8.  What costs time beyond those is shared
// memory (x values read for every multiply-add), dependent round trips,
// and launches.  The design:
//   * one launch per call: each block owns 64 output rows (32 for int3)
//     and a contiguous range of k, and the k ranges of one row tile are
//     the blocks of one thread-block cluster (at most 8, the portable
//     limit), so there is no workspace and no second kernel;
//   * 8 lanes share a row group: each lane loads 16 contiguous payload
//     bytes per plane, stage (128 byte-columns) and row, for 4 rows 16
//     apart (2 for int3), so a warp reads 4 x 128 bytes per row set, and
//     every x value read from shared memory feeds 4 rows (a register tile
//     over n: the shared-memory reads, not the bytes, bound the previous
//     one-row design);
//   * per stage, a block issues its payload loads and the s values it
//     needs, copies x for the same byte-columns into shared memory with
//     cp.async (zero-filled past kg and m), and waits once; each thread
//     scales its own copies by s, so x * s is staged once.  The registers
//     go to the row tile rather than to more stages in flight (that ran
//     slower); a block has 1 to 3 stages at the serving shapes;
//   * codes are unpacked in registers without int-to-float conversions: a
//     biased code b in [0, 255] placed in the mantissa of 2^23 is exactly
//     2^23 + b, so one byte permute and one subtraction give the code
//     (x * s is padded every 16 floats in shared memory, so the 8 lanes of
//     a row group read 16-byte vectors without bank conflicts);
//   * the 8 lanes of a row group reduce their sums with warp shuffles, and
//     each block leaves its (m tile x rows) partial sums in its own shared
//     memory; after cluster.sync() every block reduces a disjoint
//     slice of the output tile, loading the partials of every rank of the
//     cluster through distributed shared memory at once and adding them in
//     rank order (equal bits on every run), applies t and stores;
//   * ragged n (rows past n) and ragged kg (byte-columns past kg, or a row
//     that is not 16-byte aligned) are masked in the kernel.
//
// Built by src/repro_torch/kernels/_build.py with plain nvcc (no PyTorch
// headers) and called through ctypes from kernels/dequant/dequant_matmul.py.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "dequant_tc.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;                                // 4 warps
constexpr int kLanesPerRow = 8;
constexpr int kRowGroup = kThreads / kLanesPerRow;          // 16 rows side by side
constexpr int kChunk = kLanesPerRow * 16;                    // byte-columns per stage
constexpr int kChunkPad = kChunk + kChunk / 4;               // 4 pad floats per 16
constexpr int kBlocksPerSm = 4;                              // split-K target
constexpr int kMaxCluster = 8;                               // portable cluster size
static_assert(kChunk == kThreads, "staging maps one byte-column to each thread");

// G column groups per byte-column, P planes per row, R rows per lane (the
// register tile over n: 4, and 2 for int3, whose three planes and eight
// groups per row take the registers), the 2^23 bias of a biased code
template <int NBITS> struct Layout;
template <> struct Layout<4> {
  static constexpr int G = 2, P = 1, R = 4;
  static constexpr float kBias = 8388616.0f;
};
template <> struct Layout<3> {
  static constexpr int G = 8, P = 3, R = 2;
  static constexpr float kBias = 8388612.0f;
};
template <> struct Layout<2> {
  static constexpr int G = 4, P = 1, R = 4;
  static constexpr float kBias = 8388610.0f;
};

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

// 4 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

template <int NBITS, int MT>
__global__ void __launch_bounds__(kThreads)
dequant_packed_kernel(const float* __restrict__ x, const uint8_t* __restrict__ payload,
                      const float* __restrict__ s, const float* __restrict__ t,
                      float* __restrict__ out, int m, int n, int kg, int stages_per_split,
                      bool vec16) {
  constexpr int G = Layout<NBITS>::G;
  constexpr int P = Layout<NBITS>::P;
  constexpr int R = Layout<NBITS>::R;
  constexpr int kRowsPerBlock = kRowGroup * R;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [MT][G][kChunkPad]
  float* part = xs + MT * G * kChunkPad;         // [MT][kRowsPerBlock]

  const int tid = threadIdx.x;
  const int cl = tid % kLanesPerRow;
  const int row0 = blockIdx.y * kRowsPerBlock + tid / kLanesPerRow;  // rows row0 + 16 i
  const int m0 = blockIdx.z * MT;
  const int kx = G * kg;
  const float* xb = xs + swizzle(cl * 16);

  float acc[MT][R];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[mi][i] = 0.0f;
  }

  const int n_stages = (kg + kChunk - 1) / kChunk;
  const int c_begin = blockIdx.x * stages_per_split;
  const int c_end = min(n_stages, c_begin + stages_per_split);
  for (int c = c_begin; c < c_end; ++c) {
    // the stage's payload (R rows) and s of this thread's byte-column into
    // registers, x into shared memory: every load issued before the wait
    uint4 pay[R][P];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = row0 + i * kRowGroup;
      const bool row_ok = row < n;
      load_stage<P>(pay[i], payload + (size_t)(row_ok ? row : 0) * P * kg, kg,
                    c * kChunk + cl * 16, row_ok, vec16);
    }
    // thread tid owns byte-column c * kChunk + tid of every group and row
    // of x (copied asynchronously, zero past kg and m) and scales its own
    // copies by s once they land
    const int j = c * kChunk + tid;
    float sv[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sv[g] = j < kg ? __ldg(s + g * kg + j) : 0.0f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const bool ok = j < kg && m0 + mi < m;
        cp_async4(xs + (mi * G + g) * kChunkPad + swizzle(tid),
                  x + (ok ? (size_t)(m0 + mi) * kx + g * kg + j : 0), ok);
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) xs[(mi * G + g) * kChunkPad + swizzle(tid)] *= sv[g];
    }
    __syncthreads();

#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        // codes of byte-columns 4q .. 4q+3 of each of the R rows
        float cd[R][4];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          uint32_t pw[P];
#pragma unroll
          for (int p = 0; p < P; ++p) pw[p] = word(pay[i][p], q);
          const uint32_t u = group_bytes<NBITS>(pw, g);
#pragma unroll
          for (int b = 0; b < 4; ++b) cd[i][b] = biased_float(u, b) - Layout<NBITS>::kBias;
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xb + (mi * G + g) * kChunkPad + 4 * q);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            float a = acc[mi][i];
            a = fmaf(xv.x, cd[i][0], a);
            a = fmaf(xv.y, cd[i][1], a);
            a = fmaf(xv.z, cd[i][2], a);
            a = fmaf(xv.w, cd[i][3], a);
            acc[mi][i] = a;
          }
        }
      }
    }
    __syncthreads();                             // the next stage refills x
  }

#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float v = acc[mi][i];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      if (cl == 0) part[mi * kRowsPerBlock + i * kRowGroup + tid / kLanesPerRow] = v;
    }
  }

  // split-K reduction over the cluster's blocks through distributed shared
  // memory: rank r sums a disjoint slice of the tile, the ranks' partials
  // loaded together and added in rank order
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  cluster.sync();
  constexpr int kTile = MT * kRowsPerBlock;
  const int per = (kTile + splits - 1) / splits;
  const int e_end = min(kTile, (rank + 1) * per);
  for (int e = rank * per + tid; e < e_end; e += kThreads) {
    const int mi = e / kRowsPerBlock;
    const int orow = blockIdx.y * kRowsPerBlock + e % kRowsPerBlock;
    float v[kMaxCluster];
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z) {
      v[z] = z < splits ? cluster.map_shared_rank(part, z)[e] : 0.0f;
    }
    float a = 0.0f;
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z) {
      if (z < splits) a += v[z];
    }
    if (m0 + mi < m && orow < n) out[(size_t)(m0 + mi) * n + orow] = a * t[orow];
  }
  cluster.sync();                                // partials stay until all have read
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

// Stages per k split: enough blocks for kBlocksPerSm per SM, at most
// kMaxCluster splits (one cluster per row tile), whole stages per split.
int stages_per_split(int m, int n, int kg, int rows) {
  const int mt = pick_mt(m);
  const long blocks = (long)((n + rows - 1) / rows) * ((m + mt - 1) / mt);
  const int n_stages = (kg + kChunk - 1) / kChunk;
  const long want = ((long)kBlocksPerSm * sm_count() + blocks - 1) / blocks;
  const int splits = (int)std::min<long>(std::min(n_stages, kMaxCluster),
                                         std::max<long>(1, want));
  return (n_stages + splits - 1) / splits;
}

template <int NBITS, int MT>
cudaError_t launch(const float* x, const uint8_t* payload, const float* s, const float* t,
                   float* out, int m, int n, int kg, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kRowGroup * Layout<NBITS>::R;
  constexpr size_t smem = sizeof(float) * (MT * Layout<NBITS>::G * kChunkPad + MT * kRowsPerBlock);
  auto kernel = dequant_packed_kernel<NBITS, MT>;
  if (smem > 48 * 1024) {
    static cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
  }
  const bool vec16 = (kg % 16 == 0) && (reinterpret_cast<uintptr_t>(payload) % 16 == 0);
  const int n_stages = (kg + kChunk - 1) / kChunk;
  const int per = stages_per_split(m, n, kg, kRowsPerBlock);
  const int splits = (n_stages + per - 1) / per;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (n + kRowsPerBlock - 1) / kRowsPerBlock, (m + MT - 1) / MT);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, payload, s, t, out, m, n, kg, per, vec16);
}

template <int NBITS>
cudaError_t launch_nbits(const float* x, const uint8_t* payload, const float* s,
                         const float* t, float* out, int m, int n, int kg,
                         cudaStream_t stream) {
  switch (pick_mt(m)) {
    case 1: return launch<NBITS, 1>(x, payload, s, t, out, m, n, kg, stream);
    case 2: return launch<NBITS, 2>(x, payload, s, t, out, m, n, kg, stream);
    case 4: return launch<NBITS, 4>(x, payload, s, t, out, m, n, kg, stream);
    case 8: return launch<NBITS, 8>(x, payload, s, t, out, m, n, kg, stream);
    default: return launch<NBITS, 16>(x, payload, s, t, out, m, n, kg, stream);
  }
}

}  // namespace

// x (m, G*kg) f32, payload uint8 (n, planes, kg), s (G*kg) f32, t (n) f32,
// out (m, n) f32; all contiguous on the current device.  One kernel launch
// on `stream`, no scratch memory.  Returns the cudaError_t of the launch
// (0 on success); launches nothing when m or n is 0.
extern "C" int dequant_matmul_packed_f32(const void* x, const void* payload, const void* s,
                                         const void* t, void* out, int m, int n, int kg,
                                         int nbits, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (kg <= 0) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const uint8_t* pb = static_cast<const uint8_t*>(payload);
  const float* sf = static_cast<const float*>(s);
  const float* tf = static_cast<const float*>(t);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 4: return (int)launch_nbits<4>(xf, pb, sf, tf, of, m, n, kg, st);
    case 3: return (int)launch_nbits<3>(xf, pb, sf, tf, of, m, n, kg, st);
    case 2: return (int)launch_nbits<2>(xf, pb, sf, tf, of, m, n, kg, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path (m >= TC_MIN_M): dequant_tc.cuh's main loop with the
// codes unpacked from the planar payload by the decoders above.
// ---------------------------------------------------------------------------

namespace {

// A thread owns payload rows row .. row + 3 (row = n0 + 32 warp + 4 g) and,
// per chunk of 4 LW byte-columns, the LW bytes j0 + LW c .. + LW - 1 of each
// plane: 16 bytes for int4 and int2 (2 and 4 slabs of 64 codes per chunk, one
// per column group), 4 for int3 (its 3 planes' registers; 2 slabs per
// chunk, each 4 column groups of 16).  Step sigma of the chunk reads word
// q = sigma % (LW / 4) of column group sigma / (LW / 4).
template <int NBITS>
struct PackedCodes {
  static constexpr int G = Layout<NBITS>::G, P = Layout<NBITS>::P;
  static constexpr int LW = NBITS == 3 ? 4 : 16, W = LW / 4;
  static constexpr int SPC = G * LW / 16;
  struct Regs {
    uint32_t w[4][P][W];
  };

  __device__ static void load(Regs& r, const dequant_tc::Args& a, int j0, int n0, int warp,
                              int g, int c) {
    const int j = j0 + LW * c;
    const bool wide = a.vec && j + LW <= a.kg;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int row = n0 + 32 * warp + 4 * g + b;
      const bool row_ok = row < a.n;
      const uint8_t* prow = a.codes + (size_t)(row_ok ? row : 0) * a.ldz;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const uint8_t* src = prow + (size_t)p * a.kg + j;
        if (row_ok && wide) {
          if constexpr (W == 4) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
            r.w[b][p][0] = v.x;
            r.w[b][p][W > 1 ? 1 : 0] = v.y;
            r.w[b][p][W > 2 ? 2 : 0] = v.z;
            r.w[b][p][W > 3 ? 3 : 0] = v.w;
          } else {
            r.w[b][p][0] = __ldg(reinterpret_cast<const uint32_t*>(src));
          }
        } else {
#pragma unroll
          for (int q = 0; q < W; ++q) {
            uint32_t w = 0u;
            if (row_ok) {
              for (int e = 0; e < 4; ++e) {
                if (j + 4 * q + e < a.kg) w |= (uint32_t)__ldg(src + 4 * q + e) << (8 * e);
              }
            }
            r.w[b][p][q] = w;
          }
        }
      }
    }
  }

  // Row b of the thread's four is tile b / 2, row half b % 2.  A biased
  // code u < 16 is the bf16 128 + u with u in the low byte of its mantissa
  // (bits 0x4300 | u), so one byte permute packs two of them and one bf16
  // subtraction of 128 + bias leaves the codes, exactly.
  template <int I>
  __device__ static void frags(const Regs& r, uint32_t (&af)[4][2][4]) {
    constexpr uint32_t kOff = (0x4300u + (NBITS == 4 ? 8 : NBITS == 3 ? 4 : 2)) * 0x10001u;
    const __nv_bfloat162 off = *reinterpret_cast<const __nv_bfloat162*>(&kOff);
    auto pair = [&](uint32_t u, uint32_t sel) {
      const uint32_t v = __byte_perm(u, 0x43u, sel);
      const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), off);
      return *reinterpret_cast<const uint32_t*>(&d);
    };
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      const int sigma = 4 * I + st, grp = sigma / W, q = sigma % W;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        uint32_t p0[P], p1[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          p0[p] = r.w[2 * t][p][q];
          p1[p] = r.w[2 * t + 1][p][q];
        }
        const uint32_t u0 = group_bytes<NBITS>(p0, grp), u1 = group_bytes<NBITS>(p1, grp);
        af[st][t][0] = pair(u0, 0x4140);           // bytes 0, 1: columns 2c, 2c + 1
        af[st][t][1] = pair(u1, 0x4140);
        af[st][t][2] = pair(u0, 0x4342);           // bytes 2, 3: columns 2c + 8, 2c + 9
        af[st][t][3] = pair(u1, 0x4342);
      }
    }
  }
};

}  // namespace

// The tensor-core path of dequant_matmul_packed_f32, with the same operands
// and contract: one kernel launch on `stream`, no scratch memory.
extern "C" int dequant_matmul_packed_tc_f32(const void* x, const void* payload, const void* s,
                                            const void* t, void* out, int m, int n, int kg,
                                            int nbits, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (kg <= 0) return (int)cudaErrorInvalidValue;
  dequant_tc::Args a = {};
  a.x = static_cast<const float*>(x);
  a.codes = static_cast<const uint8_t*>(payload);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.out = static_cast<float*>(out);
  a.m = m;
  a.n = n;
  a.kg = kg;
  a.xvec = kg % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(s) % 16 == 0;
  const uintptr_t base = reinterpret_cast<uintptr_t>(payload);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 4:
      a.kx = 2LL * kg;
      a.ldz = kg;
      a.vec = kg % 16 == 0 && base % 16 == 0;
      return (int)dequant_tc::launch_any<PackedCodes<4>>(a, st);
    case 3:
      a.kx = 8LL * kg;
      a.ldz = 3LL * kg;
      a.vec = kg % 4 == 0 && base % 4 == 0;
      return (int)dequant_tc::launch_any<PackedCodes<3>>(a, st);
    case 2:
      a.kx = 4LL * kg;
      a.ldz = kg;
      a.vec = kg % 16 == 0 && base % 16 == 0;
      return (int)dequant_tc::launch_any<PackedCodes<2>>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
