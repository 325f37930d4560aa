// Fused int8 dequantize-matmul for Hopper (sm_90a), f32 accumulation, one
// launch per call: split-K across the blocks of a thread-block cluster.
//
// Replaces the TPU kernel dequant_matmul_pallas
// (src/repro/kernels/dequant/dequant_matmul.py, body _kernel).  It computes
//
//     out[m, n] = t[n] * sum_k (x[m, k] * s[k]) * z[n, k]
//
// for int8 codes z, f32 x, s and t.  The TPU kernel walks K in a sequential
// grid with a VMEM accumulator; here blocks run in no order, so the k range
// is split across the blocks of one cluster, which add their partial sums
// through distributed shared memory in a fixed order (the same bits on
// every run).
//
// z is read in place as the serving leaf stores it: codes (in, out) =
// (k, n) (src/repro_torch/quant/qlinear.py), element (n, k) at
// z[k * ldz + n]; models/layers.dense hands the wrapper that leaf's
// transposed (n, k) view, so no code matrix is copied on the serving path.
//
// Two kernels, chosen by the wrapper by m (kernels/dequant/dequant_matmul.py,
// TC_MIN_M): from TC_MIN_M rows of x on (prefill, encode, cross K/V) the
// tensor-core kernel of dequant_tc.cuh, whose header note says what bounds
// it and how it is designed (codes decoded in registers into wgmma's A
// fragments, x * s split into three exact bf16 terms, split-K over a
// cluster); this file gives it its code decoder (the end of the file).
// Below TC_MIN_M the decode kernel, described from here on.
//
// What bounds it: at decode m (the slot count) is 1..16 and every code is
// used by m rows of x only, so the n * k code bytes (1 per weight) are the
// bound up to m of about 20; above that the 2*m*n*k f32 multiply-adds on
// the CUDA cores are.  At decode the codes must be kept in flight: at
// 3.35 TB/s and about a microsecond of latency, some 25 KB per SM.  The
// design:
//   * one launch per call: a block owns 128 consecutive columns n, an m
//     tile of 1/2/4/8/16 rows and a contiguous k range; the k ranges of one
//     tile are the blocks of one thread-block cluster (at most 8, the
//     portable limit, or 16 for long k), so there is no workspace and no
//     second kernel;
//   * the block's codes stream through a ring of 4 tiles of 64 k rows x
//     128 bytes in shared memory (24 KB in flight), two 16-byte cp.async
//     per thread and tile, one barrier per tile; x * s of the block's k
//     range and m tile is copied in with the first tile, scaled once in
//     shared memory and read back as broadcast float4s;
//   * each lane owns 16 neighbouring columns at m <= 4, 8 at m = 8 and 4
//     at m = 16 (64 accumulators in every case), so one x * s value read
//     from shared memory feeds as many multiply-adds;
//   * a code byte becomes a float without an integer conversion: the
//     byte's sign bit flipped is b + 128 in [0, 255], which placed in the
//     mantissa of 2^23 is exactly 2^23 + b + 128;
//   * the lanes that share columns add their sums by shuffles, the 8 warps
//     through shared memory in warp order; then every block stores the
//     slices of its partial tile into the receive buffers of the ranks
//     that own them (remote stores, no round trips), and after one
//     cluster barrier each rank adds its slice in rank order, applies t
//     and stores (the barrier's first half is passed at the start, so the
//     wait before the remote stores costs nothing);
//   * ragged n (columns past n, or rows of codes that are not 16-byte
//     aligned, copied byte by byte) and ragged k and m are masked in the
//     kernel.
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;                        // columns per block
constexpr int kTileRows = 64;                     // k rows per ring tile
constexpr int kTileBytes = kTileRows * kCols;     // 8 KB: 2 x 16 bytes per thread
constexpr int kChunks = kTileBytes / 16 / kThreads;
constexpr int kStages = 4;                        // ring tiles, 3 in flight
constexpr int kBlocksPerSm = 4;                   // split-K target
constexpr int kMaxCluster = 16;                   // 8 is portable; 16 needs the opt-in
constexpr int kWideK = 64;                        // tiles of k from which 16 pays
constexpr int kSmemLimit = 200 * 1024;
constexpr float kBias = 8388736.0f;               // 2^23 + 128
static_assert(kTileBytes == 16 * kThreads * kChunks, "16-byte copies per thread and tile");

// Columns per lane by m tile: 64 accumulators in every case.
template <int MT>
__host__ __device__ constexpr int lane_cols() {
  return MT <= 4 ? 16 : MT == 8 ? 8 : 4;
}

// Byte i of w (an int8 code, sign bit already flipped) as a float.
__device__ __forceinline__ float code_float(uint32_t w, int i) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | (uint32_t)i)) - kBias;
}

// 4 or 16 bytes global -> shared, zero-filled past the valid bytes
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int valid) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-byte chunk q of code tile `dst` (k rows kr .. kr + 63 of the block's
// columns): bytes 16 * (q % 8) of row q / 8; zero past the k range's end
// and past n.
__device__ __forceinline__ void load_chunk(uint8_t* dst, const int8_t* __restrict__ z,
                                           long long ldz, int kr, int k_end, int col0, int n,
                                           bool vec16, int q) {
  const int r = q / 8, cb = 16 * (q % 8);
  const int kk = kr + r, col = col0 + cb;
  uint8_t* d = dst + r * kCols + cb;
  const int valid = kk < k_end ? min(16, max(0, n - col)) : 0;
  const int8_t* src = z + (valid > 0 ? (long long)kk * ldz + col : 0);
  if (vec16) {
    cp_async16(d, src, valid);
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      if (b < valid) w[b >> 2] |= (uint32_t)(uint8_t)__ldg(src + b) << (8 * (b & 3));
    }
    *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Thread tid's chunks of a code tile: q = tid + 256 p.
__device__ __forceinline__ void load_tile(uint8_t* dst, const int8_t* __restrict__ z,
                                          long long ldz, int kr, int k_end, int col0, int n,
                                          bool vec16) {
#pragma unroll
  for (int p = 0; p < kChunks; ++p) {
    load_chunk(dst, z, ldz, kr, k_end, col0, n, vec16, threadIdx.x + p * kThreads);
  }
}

// Float offset of the cluster reduction's receive buffer: past the ring,
// x * s and s of a block of `per` tiles, and past the warps' partial sums
// (the same in every block of a launch).
template <int MT>
__host__ __device__ constexpr int recv_offset(int per) {
  return (kStages * kTileBytes / 4 + per * kTileRows * (MT + 1)) > kWarps * MT * kCols
             ? kStages * kTileBytes / 4 + per * kTileRows * (MT + 1)
             : kWarps * MT * kCols;
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 2)
dequant_int8_kernel(const float* __restrict__ x, const int8_t* __restrict__ z,
                    const float* __restrict__ s, const float* __restrict__ t,
                    float* __restrict__ out, int m, int n, int k, long long ldz,
                    int tiles_per_split, bool vec16) {
  constexpr int VW = lane_cols<MT>();
  constexpr int S = kStages;
  constexpr int LPR = kCols / VW;                 // lanes per k row
  constexpr int RG = 32 / LPR;                    // k rows per warp instruction
  constexpr int NR = kTileRows / (kWarps * RG);   // k rows per thread and tile
  extern __shared__ float4 smem4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4);           // [S][64][128]
  float* xs = reinterpret_cast<float*>(ring + S * kTileBytes);  // [kpad][MT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.y * kCols;
  const int m0 = blockIdx.z * MT;
  const int n_tiles = (k + kTileRows - 1) / kTileRows;
  const int t_begin = blockIdx.x * tiles_per_split;
  const int nt = min(n_tiles, t_begin + tiles_per_split) - t_begin;
  const int kb = t_begin * kTileRows;
  const int kl = min(k, kb + nt * kTileRows) - kb;
  const int kpad = nt * kTileRows;
  float* ss = xs + kpad * MT;                                  // [kpad]

  // the cluster's first barrier phase: arrive now, wait before the first
  // access to another block's shared memory (all blocks have started)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // x and s of the block's k range and m tile (zero past kl and m) ride in
  // the first copy group with tile 0; then tiles 1 .. S-2
  for (int i = tid; i < MT * kpad; i += kThreads) {
    const int kk = i / MT, mi = i % MT;
    const bool ok = kk < kl && m0 + mi < m;
    cp_async4(xs + i, x + (ok ? (size_t)(m0 + mi) * k + kb + kk : 0), ok);
  }
  for (int kk = tid; kk < kpad; kk += kThreads) {
    cp_async4(ss + kk, s + (kk < kl ? kb + kk : 0), kk < kl);
  }
#pragma unroll
  for (int p = 0; p < S - 1; ++p) {
    if (p < nt) load_tile(ring + p * kTileBytes, z, ldz, kb + p * kTileRows, kb + kl, col0, n,
                          vec16);
    cp_commit();
  }

  float acc[MT][VW];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int j = 0; j < VW; ++j) acc[mi][j] = 0.0f;
  }
  const int cl = lane % LPR, rg = lane / LPR;

  for (int c = 0; c < nt; ++c) {
    cp_wait<S - 2>();                             // tile c (and x, s) landed
    __syncthreads();
    if (c == 0) {
      for (int i = tid; i < MT * kpad; i += kThreads) xs[i] *= ss[i / MT];
      __syncthreads();
    }
    // refill the slot that tile c - 1 used: every thread is past it
    if (c + S - 1 < nt) {
      load_tile(ring + ((c + S - 1) % S) * kTileBytes, z, ldz, kb + (c + S - 1) * kTileRows,
                kb + kl, col0, n, vec16);
    }
    cp_commit();
    const uint8_t* tile = ring + (c % S) * kTileBytes;
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      const int r = u * kWarps * RG + warp * RG + rg;
      const uint8_t* cp = tile + r * kCols + cl * VW;
      uint32_t w[VW / 4];
      if constexpr (VW == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(cp);
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      } else if constexpr (VW == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(cp);
        w[0] = v.x; w[1] = v.y;
      } else {
        w[0] = *reinterpret_cast<const uint32_t*>(cp);
      }
      float cd[VW];
#pragma unroll
      for (int q = 0; q < VW / 4; ++q) {
        const uint32_t b = w[q] ^ 0x80808080u;
#pragma unroll
        for (int e = 0; e < 4; ++e) cd[4 * q + e] = code_float(b, e);
      }
      const float* xr = xs + (c * kTileRows + r) * MT;
      if constexpr (MT % 4 == 0) {
#pragma unroll
        for (int q = 0; q < MT / 4; ++q) {
          const float4 xv = reinterpret_cast<const float4*>(xr)[q];
#pragma unroll
          for (int j = 0; j < VW; ++j) {
            acc[4 * q + 0][j] = fmaf(xv.x, cd[j], acc[4 * q + 0][j]);
            acc[4 * q + 1][j] = fmaf(xv.y, cd[j], acc[4 * q + 1][j]);
            acc[4 * q + 2][j] = fmaf(xv.z, cd[j], acc[4 * q + 2][j]);
            acc[4 * q + 3][j] = fmaf(xv.w, cd[j], acc[4 * q + 3][j]);
          }
        }
      } else {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float xv = xr[mi];
#pragma unroll
          for (int j = 0; j < VW; ++j) acc[mi][j] = fmaf(xv, cd[j], acc[mi][j]);
        }
      }
    }
  }
  cp_wait<0>();

  // the lanes of a warp that share columns, then the 8 warps in warp order
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int j = 0; j < VW; ++j) {
#pragma unroll
      for (int off = LPR; off < 32; off *= 2) {
        acc[mi][j] += __shfl_xor_sync(0xffffffffu, acc[mi][j], off);
      }
    }
  }
  __syncthreads();                                // the ring and x * s are done
  float* red = reinterpret_cast<float*>(smem4);  // [kWarps][MT][kCols]
  if (rg == 0) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int j = 0; j < VW; j += 4) {
        *reinterpret_cast<float4*>(red + (warp * MT + mi) * kCols + cl * VW + j) =
            make_float4(acc[mi][j], acc[mi][j + 1], acc[mi][j + 2], acc[mi][j + 3]);
      }
    }
  }
  __syncthreads();
  float* part = red;                              // [MT][kCols], over warp 0's sums
  for (int e = tid; e < MT * kCols; e += kThreads) {
    float a = red[e];
#pragma unroll
    for (int wq = 1; wq < kWarps; ++wq) a += red[wq * MT * kCols + e];
    part[e] = a;
  }

  // split-K reduction over the cluster's blocks through distributed shared
  // memory: rank r owns a disjoint slice of the tile; every rank stores its
  // partial sums of that slice into rank r's receive buffer, and after one
  // cluster barrier rank r adds them in rank order (equal bits on every
  // run), applies t and stores.  Only local shared memory is read after the
  // barrier, so no block waits for the others to leave.
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  constexpr int kTile = MT * kCols;
  const int per = (kTile + splits - 1) / splits;
  float* recv = part + recv_offset<MT>(tiles_per_split);  // [splits][per]
  __syncthreads();                                  // part is complete
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int e = tid; e < kTile; e += kThreads) {
    const int owner = e / per;
    cluster.map_shared_rank(recv, owner)[rank * per + e - owner * per] = part[e];
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  const int e0 = rank * per;
  for (int e = tid; e < per && e0 + e < kTile; e += kThreads) {
    float v[kMaxCluster];
#pragma unroll
    for (int zr = 0; zr < kMaxCluster; ++zr) v[zr] = zr < splits ? recv[zr * per + e] : 0.0f;
    float acc_e = 0.0f;
#pragma unroll
    for (int zr = 0; zr < kMaxCluster; ++zr) {
      if (zr < splits) acc_e += v[zr];
    }
    const int row = m0 + (e0 + e) / kCols, col = col0 + (e0 + e) % kCols;
    if (row < m && col < n) out[(size_t)row * n + col] = acc_e * t[col];
  }
}

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

// Shared memory of a block of `per` tiles: the ring and x * s with s, or
// the warps' partial sums, whichever is larger; then the receive buffer
// of the cluster reduction, which other blocks may fill while this one
// still runs its k loop.
template <int MT>
size_t smem_bytes(int per) {
  return sizeof(float) * ((size_t)recv_offset<MT>(per) + MT * kCols + kMaxCluster);
}

// Tiles per k split: enough blocks for kBlocksPerSm per SM, at most 8
// splits (16 from kWideK tiles of k, where the longer k ranges pay for the
// wider cluster; below that, 16 ran slower), more splits while a block's
// x * s would not fit.
template <int MT>
int tiles_per_split(int m, int n, int k) {
  const long blocks = (long)((n + kCols - 1) / kCols) * ((m + MT - 1) / MT);
  const int n_tiles = (k + kTileRows - 1) / kTileRows;
  const int most = std::min(n_tiles, n_tiles >= kWideK ? kMaxCluster : 8);
  const long want = ((long)kBlocksPerSm * sm_count() + blocks - 1) / blocks;
  int splits = (int)std::min<long>(most, std::max<long>(1, want));
  int per = (n_tiles + splits - 1) / splits;
  while (splits < most && smem_bytes<MT>(per) > (size_t)kSmemLimit) {
    ++splits;
    per = (n_tiles + splits - 1) / splits;
  }
  return per;
}

template <int MT>
cudaError_t launch(const float* x, const int8_t* z, const float* s, const float* t, float* out,
                   int m, int n, int k, long long ldz, cudaStream_t stream) {
  const int per = tiles_per_split<MT>(m, n, k);
  const size_t smem = smem_bytes<MT>(per);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = dequant_int8_kernel<MT>;
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return attr;
  static cudaError_t wide = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (wide != cudaSuccess) return wide;
  const int n_tiles = (k + kTileRows - 1) / kTileRows;
  const int splits = (n_tiles + per - 1) / per;
  const bool vec16 = (ldz % 16 == 0) && (reinterpret_cast<uintptr_t>(z) % 16 == 0);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (n + kCols - 1) / kCols, (m + MT - 1) / MT);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, z, s, t, out, m, n, k, ldz, per, vec16);
}

}  // namespace

// x (m, k) f32, z int8 codes with element (n, k) at z[k * ldz + n] (ldz
// >= n), s (k) f32, t (n) f32, out (m, n) f32; x, s, t and out contiguous
// on the current device.  One kernel launch on `stream`, no scratch
// memory.  Returns the cudaError_t of the launch (0 on success); launches
// nothing when m or n is 0.
extern "C" int dequant_matmul_int8_f32(const void* x, const void* z, const void* s,
                                       const void* t, void* out, int m, int n, int k,
                                       long long ldz, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || ldz < n) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const int8_t* zb = static_cast<const int8_t*>(z);
  const float* sf = static_cast<const float*>(s);
  const float* tf = static_cast<const float*>(t);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 1) return (int)launch<1>(xf, zb, sf, tf, of, m, n, k, ldz, st);
  if (m <= 2) return (int)launch<2>(xf, zb, sf, tf, of, m, n, k, ldz, st);
  if (m <= 4) return (int)launch<4>(xf, zb, sf, tf, of, m, n, k, ldz, st);
  if (m <= 8) return (int)launch<8>(xf, zb, sf, tf, of, m, n, k, ldz, st);
  return (int)launch<16>(xf, zb, sf, tf, of, m, n, k, ldz, st);
}

// ---------------------------------------------------------------------------
// Tensor-core path (m >= TC_MIN_M): dequant_tc.cuh's main loop with the
// int8 codes read in place, (k, n) as the serving leaf stores them.
// ---------------------------------------------------------------------------

namespace {

// A thread owns out-features col .. col + 3 (col = n0 + 32 warp + 4 g) and,
// per 64-row chunk, the 16 k rows kb .. kb + 15 (kb = j0 + 16 c): one
// 32-bit word of codes per k row, w[rho] for k = kb + rho = kb + 4 q + e.
struct Int8Codes {
  static constexpr int LW = 16, SPC = 1;
  struct Regs {
    uint32_t w[16];
  };

  __device__ static void load(Regs& r, const dequant_tc::Args& a, int j0, int n0, int warp,
                              int g, int c) {
    const int col = n0 + 32 * warp + 4 * g;
    const int kb = j0 + 16 * c;
    const bool wide = a.vec && col + 4 <= a.n;
#pragma unroll
    for (int rho = 0; rho < 16; ++rho) {
      const int kk = kb + rho;
      const uint8_t* p = a.codes + (size_t)(kk < a.kg ? kk : 0) * a.ldz + col;
      uint32_t w = 0u;
      if (kk < a.kg) {
        if (wide) {
          w = __ldg(reinterpret_cast<const uint32_t*>(p));
        } else {
          for (int b = 0; b < 4; ++b) {
            if (col + b < a.n) w |= (uint32_t)__ldg(p + b) << (8 * b);
          }
        }
      }
      r.w[rho] = w;
    }
  }

  // Byte b of each word is out-feature col + b = tile b / 2, row half b % 2.
  template <int I>
  __device__ static void frags(const Regs& r, uint32_t (&af)[4][2][4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t w0 = r.w[4 * q] ^ 0x80808080u, w1 = r.w[4 * q + 1] ^ 0x80808080u;
      const uint32_t w2 = r.w[4 * q + 2] ^ 0x80808080u, w3 = r.w[4 * q + 3] ^ 0x80808080u;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        af[q][t][0] = dequant_tc::pack_bf16(code_float(w0, 2 * t), code_float(w1, 2 * t));
        af[q][t][1] = dequant_tc::pack_bf16(code_float(w0, 2 * t + 1), code_float(w1, 2 * t + 1));
        af[q][t][2] = dequant_tc::pack_bf16(code_float(w2, 2 * t), code_float(w3, 2 * t));
        af[q][t][3] = dequant_tc::pack_bf16(code_float(w2, 2 * t + 1), code_float(w3, 2 * t + 1));
      }
    }
  }
};

}  // namespace

// The tensor-core path of dequant_matmul_int8_f32, with the same operands
// and contract: one kernel launch on `stream`, no scratch memory.
extern "C" int dequant_matmul_int8_tc_f32(const void* x, const void* z, const void* s,
                                          const void* t, void* out, int m, int n, int k,
                                          long long ldz, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || ldz < n) return (int)cudaErrorInvalidValue;
  dequant_tc::Args a = {};
  a.x = static_cast<const float*>(x);
  a.codes = static_cast<const uint8_t*>(z);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.out = static_cast<float*>(out);
  a.m = m;
  a.n = n;
  a.kg = k;
  a.kx = k;
  a.ldz = ldz;
  a.vec = ldz % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 4 == 0;
  a.xvec = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(s) % 16 == 0;
  return (int)dequant_tc::launch_any<Int8Codes>(a, static_cast<cudaStream_t>(stream));
}
