// Flash attention forward for Hopper (sm_90a), f32 on the CUDA cores.
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
// At the path's shapes (D = 64, S = 256) the bytes bound it on the tensor
// cores; this first version computes in f32 on the CUDA cores, where the
// operations take about as long as the bytes, and its time is set by how
// well the CUDA cores are kept busy.  The design:
//   * one block of 128 threads per (batch*head, tile of query rows); each
//     query row has D/16 threads, each owning 16 of the D dims (in four
//     4-float chunks, spread so the owners' 16-byte shared-memory loads
//     fall into distinct banks), so a row's q and acc live in registers;
//   * K and V tiles of 4096/D keys are staged in shared memory by all 128
//     threads with 16-byte loads (32 KB), zero past S;
//   * a score is a 16-term partial dot per thread, summed over the row's
//     threads with an xor butterfly of shuffles (every thread of the row
//     ends with the same bits), and the online softmax runs redundantly in
//     each of them;
//   * tiles strictly above the diagonal (causal) and tiles wholly left of
//     the window are skipped: in the reference they add exactly nothing.
//
// Built by src/repro_torch/kernels/_build.py with plain nvcc (no PyTorch
// headers) and called through ctypes from kernels/flash/flash_attention.py.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

template <int D>
struct Tile {
  static constexpr int kTpr = D / 16;           // threads per query row
  static constexpr int kRows = kThreads / kTpr; // query rows per block
  static constexpr int kKeys = 4096 / D;        // keys per K/V tile (32 KB)
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int causal, int window, float scale) {
  using T = Tile<D>;
  constexpr int TPR = T::kTpr, ROWS = T::kRows, KEYS = T::kKeys;
  __shared__ __align__(16) float ks[KEYS * D];
  __shared__ __align__(16) float vs[KEYS * D];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t row_stride = (size_t)H * D;      // between sequence positions
  const size_t base = ((size_t)b * S * H + h) * D;
  const int t = threadIdx.x % TPR;
  const int q0 = blockIdx.x * ROWS;
  const int qi = q0 + threadIdx.x / TPR;
  const bool live = qi < S;

  // the 16 dims this thread owns: chunk c covers dims c*4*TPR + 4*t + 0..3
  float qr[16], acc[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int d0 = c * 4 * TPR + 4 * t;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) x = *reinterpret_cast<const float4*>(q + base + qi * row_stride + d0);
    qr[4 * c] = x.x; qr[4 * c + 1] = x.y; qr[4 * c + 2] = x.z; qr[4 * c + 3] = x.w;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  float m = kNegInf, lsum = 0.f;

  const int n_tiles = (S + KEYS - 1) / KEYS;
  int kt_end = n_tiles;
  if (causal) kt_end = min(n_tiles, (q0 + ROWS - 1) / KEYS + 1);
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / KEYS;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * KEYS;
    __syncthreads();                            // previous tile consumed
    for (int idx = threadIdx.x; idx < KEYS * D / 4; idx += kThreads) {
      const int j = idx / (D / 4), d0 = (idx % (D / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + j < S) {
        const size_t off = base + (size_t)(k0 + j) * row_stride + d0;
        kx = *reinterpret_cast<const float4*>(k + off);
        vx = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(ks + j * D + d0) = kx;
      *reinterpret_cast<float4*>(vs + j * D + d0) = vx;
    }
    __syncthreads();

    float s[KEYS];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 kx = *reinterpret_cast<const float4*>(ks + j * D + c * 4 * TPR + 4 * t);
        part = fmaf(qr[4 * c], kx.x, part);
        part = fmaf(qr[4 * c + 1], kx.y, part);
        part = fmaf(qr[4 * c + 2], kx.z, part);
        part = fmaf(qr[4 * c + 3], kx.w, part);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int kj = k0 + j;
      bool keep = kj < S;
      if (causal) keep = keep && kj <= qi;
      if (window > 0) keep = keep && qi - kj < window;
      s[j] = keep ? part * scale : kNegInf;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] *= corr;
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 vx = *reinterpret_cast<const float4*>(vs + j * D + c * 4 * TPR + 4 * t);
        acc[4 * c] = fmaf(p, vx.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, vx.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vx.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vx.w, acc[4 * c + 3]);
      }
    }
    lsum = lsum * corr + psum;
    m = m_new;
  }

  if (!live) return;
  const float den = fmaxf(lsum, 1e-30f);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int d0 = c * 4 * TPR + 4 * t;
    const float4 out = make_float4(acc[4 * c] / den, acc[4 * c + 1] / den,
                                   acc[4 * c + 2] / den, acc[4 * c + 3] / den);
    *reinterpret_cast<float4*>(o + base + qi * row_stride + d0) = out;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int S, int H, int causal, int window, float scale,
           cudaStream_t stream) {
  using T = Tile<D>;
  const dim3 grid((S + T::kRows - 1) / T::kRows, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      q, k, v, o, S, H, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, S, H, D) contiguous f32 on the card; D in {64, 128, 256};
// scale is the caller's f32 1/sqrt(D).  Launches on `stream`; returns the
// cudaError_t of the launch.
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
