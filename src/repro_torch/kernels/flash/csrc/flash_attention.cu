// Flash attention forward for Hopper (sm_90a) on the TF32 tensor cores,
// with a 3-term split that keeps f32 accuracy.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash/flash_attention.py, body _kernel).  For every
// (batch, head) and query row i of q, k, v laid out (B, S, H, D):
//
//     o[i] = sum_j softmax_j( q[i]·k[j] / sqrt(D) ) v[j]
//
// over the keys j that the mask keeps: j < S, j <= i when causal, and
// i - j < window when window > 0.  Masked scores are -1e30, as in the
// reference; the running max m, sum l and accumulator stay in f32 and the
// output is acc / max(l, 1e-30).  Unlike the reference's wrapper, which
// pads a ragged S with zero keys, the kernel masks keys at or past S, so a
// ragged S is right whether or not the attention is causal.
//
// What bounds it: q, k, v and o are read or written once (4*B*S*H*D*4
// bytes at 3.35 TB/s), against 4*D multiply-adds per kept (i, j) pair.
// At the model_ppl shape (B*H = 144, S = 256, D = 64, causal) the bytes
// take 11.3 us; the f32 CUDA cores would take 18 us for the operations,
// the tensor cores with a 3-term split 3.7 us at the bf16 peak.  So the
// products go to the tensor cores, and the design keeps every other step
// off the critical path:
//   * 3xTF32: each f32 operand a splits into big = tf32(a) and small =
//     tf32(a - big); a product is big*small + small*big + big*big on
//     mma.sync.m16n8k8 (f32 accumulate), which matches f32 products to
//     about 2^-21 relative (plain TF32, about 1e-3, would not meet the
//     twin's 2e-5 tolerance); the three products and the operand splits
//     are most of the kernel's time;
//   * one block of 4 warps per (batch*head, tile of 64 query rows); each
//     warp owns 16 query rows, so a score tile S = Q K^T (16 x KEYS) and
//     the output accumulator (16 x D) live in mma accumulator registers;
//   * the block's Q tile and K and V tiles of KEYS keys (32 at D = 64, 16
//     above) are copied to shared memory with cp.async (16 bytes a
//     thread, read in place from (B, S, H, D) with row stride H*D,
//     zero-filled past S), rows padded by 4 floats so every fragment load
//     is conflict-free; the block splits each landed K and V tile into
//     big and small parts once, for all four warps, and the next tile's
//     copies are in flight while the current one computes;
//   * the online softmax runs once per tile in registers on the
//     accumulator layout (row max by two quad shuffles, one rescale of the
//     accumulator), in the log2 domain (the scale carries log2(e), so
//     exp2f is the reference's expf); the probabilities feed P V without
//     leaving registers: the key order inside each 8-key chunk is permuted
//     so that the score accumulator's (row, 2t), (row, 2t+1) pair is
//     exactly the A fragment of the P V product, and V's fragment rows
//     follow the same order;
//   * masks are evaluated only on tiles that need them (the diagonal, the
//     window's edge, keys past S); tiles wholly above the diagonal or
//     wholly left of the window are skipped by the block, and by a warp
//     when they are so for its own 16 rows (in the reference they add
//     exactly nothing);
//   * the grid runs the query tiles with the most key tiles first, so the
//     causal triangle's long tiles do not finish last.
// Shared memory: 70, 84 and 166 KB at D = 64, 128 and 256; at D = 256 a
// thread holds 128 accumulator floats.
//
// Built by src/repro_torch/kernels/_build.py with plain nvcc (no PyTorch
// headers) and called through ctypes from kernels/flash/flash_attention.py.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;              // query rows per block
constexpr float kNegInf = -1e30f;

template <int D>
struct Tile {
  static constexpr int kKeys = D == 64 ? 32 : 16;   // keys per K/V tile
  static constexpr int kStride = D + 4;             // padded smem row, floats
  static constexpr int kTileFloats = kKeys * kStride;
  static constexpr size_t kSmem =
      sizeof(float) * (size_t)kStride * (kRows + 6 * kKeys);
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32, a = ab + as and b = bb + bs: the small cross
// terms first, then big * big
__device__ __forceinline__ void mma3p(float (&c)[4], const uint32_t (&ab)[4],
                                      const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                      uint32_t bs0, uint32_t bs1) {
  mma(c, ab, bs0, bs1);
  mma(c, as, bb0, bb1);
  mma(c, ab, bb0, bb1);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0 .. r0+n-1 of one head into a padded smem tile, zero past S
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int r0, int n, int S,
                                           size_t row_stride) {
  constexpr int kVec = D / 4;                   // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < n * kVec; idx += kThreads) {
    const int r = idx / kVec, c = (idx % kVec) * 4;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * Tile<D>::kStride + c, src + (ok ? (size_t)(r0 + r) * row_stride + c : 0),
               ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S, int H,
                 int causal, int window, float scale) {
  using T = Tile<D>;
  constexpr int KEYS = T::kKeys, STR = T::kStride;
  constexpr int NT = KEYS / 8;                  // 8-key chunks of a tile
  constexpr int DT = D / 8;                     // 8-dim chunks of a row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][STR]
  float* raw = qs + kRows * STR;                // [K, V][KEYS][STR], as copied
  uint32_t* spl = reinterpret_cast<uint32_t*>(raw + 2 * T::kTileFloats);  // [Kb, Ks, Vb, Vs][KEYS][STR]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const size_t row_stride = (size_t)H * D;
  const size_t base = ((size_t)b * S * H + h) * D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + warp * 16 + g;          // this thread's rows: row0, row0 + 8

  const int n_tiles = (S + KEYS - 1) / KEYS;
  int kt_end = n_tiles;
  if (causal) kt_end = min(n_tiles, min(q0 + kRows - 1, S - 1) / KEYS + 1);
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / KEYS;

  stage_rows<D>(qs, q + base, q0, kRows, S, row_stride);
  stage_rows<D>(raw, k + base, kt_begin * KEYS, KEYS, S, row_stride);
  stage_rows<D>(raw + T::kTileFloats, v + base, kt_begin * KEYS, KEYS, S, row_stride);
  cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float* qw = qs + (warp * 16 + g) * STR + t;
  // scores scaled into the log2 domain, where exp2f is the reference's expf
  const float score_scale = scale * 1.4426950408889634f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    cp_async_wait<0>();
    __syncthreads();
    // split the landed K and V tile once for all warps
    for (int idx = threadIdx.x; idx < 2 * KEYS * (D / 4); idx += kThreads) {
      const int kv = idx / (KEYS * (D / 4)), r = (idx / (D / 4)) % KEYS, c = (idx % (D / 4)) * 4;
      const float4 x = *reinterpret_cast<const float4*>(raw + kv * T::kTileFloats + r * STR + c);
      uint4 bg, sm;
      split(x.x, bg.x, sm.x);
      split(x.y, bg.y, sm.y);
      split(x.z, bg.z, sm.z);
      split(x.w, bg.w, sm.w);
      *reinterpret_cast<uint4*>(spl + (2 * kv) * T::kTileFloats + r * STR + c) = bg;
      *reinterpret_cast<uint4*>(spl + (2 * kv + 1) * T::kTileFloats + r * STR + c) = sm;
    }
    __syncthreads();
    if (kt + 1 < kt_end) {
      stage_rows<D>(raw, k + base, (kt + 1) * KEYS, KEYS, S, row_stride);
      stage_rows<D>(raw + T::kTileFloats, v + base, (kt + 1) * KEYS, KEYS, S, row_stride);
      cp_async_commit();
    }
    const uint32_t* kb = spl;
    const uint32_t* ksm = spl + T::kTileFloats;
    const uint32_t* vb = spl + 2 * T::kTileFloats;
    const uint32_t* vsm = spl + 3 * T::kTileFloats;
    const int k0 = kt * KEYS;
    // a warp whose 16 rows the whole tile is masked for skips it
    const int w0 = q0 + warp * 16;
    if ((causal && k0 > w0 + 15) || (window > 0 && k0 + KEYS - 1 <= w0 - window)) {
      __syncthreads();
      continue;
    }

    // S = Q K^T: thread holds rows (g, g+8) x keys (8j + 2t, 8j + 2t + 1)
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      uint32_t ab[4], as[4];
      split(qw[kk * 8], ab[0], as[0]);
      split(qw[8 * STR + kk * 8], ab[1], as[1]);
      split(qw[kk * 8 + 4], ab[2], as[2]);
      split(qw[8 * STR + kk * 8 + 4], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int off = (8 * j + g) * STR + kk * 8 + t;
        mma3p(sc[j], ab, as, kb[off], kb[off + 4], ksm[off], ksm[off + 4]);
      }
    }

    // online softmax on the accumulator layout
    const bool masked = k0 + KEYS > S || (causal && k0 + KEYS - 1 > w0) ||
                        (window > 0 && w0 + 15 - k0 >= window);
    float mt0 = kNegInf, mt1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[j][e] * score_scale;
        if (masked) {
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          const int qi = row0 + (e >> 1) * 8;
          bool keep = kj < S;
          if (causal) keep = keep && kj <= qi;
          if (window > 0) keep = keep && qi - kj < window;
          if (!keep) s = kNegInf;
        }
        sc[j][e] = s;
        if (e < 2) mt0 = fmaxf(mt0, s); else mt1 = fmaxf(mt1, s);
      }
    }
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sc[j][0] = exp2f(sc[j][0] - mn0);
      sc[j][1] = exp2f(sc[j][1] - mn0);
      sc[j][2] = exp2f(sc[j][2] - mn1);
      sc[j][3] = exp2f(sc[j][3] - mn1);
      p0 += sc[j][0] + sc[j][1];
      p1 += sc[j][2] + sc[j][3];
    }
    l0 = l0 * c0 + p0;                          // this thread's columns only
    l1 = l1 * c1 + p1;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= c0;
      acc[j][1] *= c0;
      acc[j][2] *= c1;
      acc[j][3] *= c1;
    }

    // O += P V; in chunk j, k-index t is key 8j + 2t and t + 4 is key
    // 8j + 2t + 1, so the A fragment is the score accumulator as it lies
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t pb[4], ps[4];
      split(sc[j][0], pb[0], ps[0]);
      split(sc[j][2], pb[1], ps[1]);
      split(sc[j][1], pb[2], ps[2]);
      split(sc[j][3], pb[3], ps[3]);
      const int off = (8 * j + 2 * t) * STR + g;
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        mma3p(acc[dn], pb, ps, vb[off + dn * 8], vb[off + STR + dn * 8], vsm[off + dn * 8],
              vsm[off + STR + dn * 8]);
      }
    }
    __syncthreads();                            // the split tile is rewritten next
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = row0 + 8 * half;
    if (qi >= S) continue;
    const float den = half ? den1 : den0;
    float* orow = o + base + (size_t)qi * row_stride + 2 * t;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      *reinterpret_cast<float2*>(orow + dn * 8) =
          make_float2(acc[dn][2 * half] / den, acc[dn][2 * half + 1] / den);
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int B, int S, int H,
           int causal, int window, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<D>::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * H, (S + kRows - 1) / kRows);
  kernel<<<grid, kThreads, Tile<D>::kSmem, stream>>>(q, k, v, o, S, H, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, S, H, D) contiguous f32 on the card, 16-byte aligned;
// D in {64, 128, 256}; scale is the caller's f32 1/sqrt(D).  Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd_f32(const float* q, const float* k,
                                       const float* v, float* o, int B, int S,
                                       int H, int D, int causal, int window,
                                       float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, o, B, S, H, causal, window, scale, st);
    case 128: return launch<128>(q, k, v, o, B, S, H, causal, window, scale, st);
    case 256: return launch<256>(q, k, v, o, B, S, H, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
