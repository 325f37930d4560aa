// Tensor-core path of the fused dequantize-matmuls (B1, B2) for Hopper
// (sm_90a): the kernel shared by dequant_int8.cu and dequant_packed.cu,
// taken by their wrappers (kernels/dequant/dequant_matmul.py) from TC_MIN_M
// rows of x on, where the decode kernels' f32 multiply-adds on the CUDA
// cores are the bound.  It replaces, with those kernels, the TPU kernels
// dequant_matmul_pallas and dequant_matmul_packed_pallas
// (src/repro/kernels/dequant/dequant_matmul.py).
//
//     out[m, n] = t[n] * sum_k (x[m, k] * s[k]) * z[n, k]
//
// What makes the tensor cores exact enough: every code is a small integer
// (int8 or narrower), exact in bf16, and f32 x * s splits into three bf16
// terms hi + mid + lo with no remainder (3 x 8 significand bits = f32's
// 24).  A product of two bf16 values is exact in f32, so three bf16 wgmma
// products into one f32 accumulator compute what the CUDA-core kernels
// compute, up to the order of summation and the tensor cores' accumulation
// rounding.
//
// What bounds it: 3 * 2 m n k bf16 operations at 989 TFLOP/s, or the
// codes' bytes at 3.35 TB/s where m is small; in practice the CUDA cores'
// work around the products (decoding the codes, staging x * s as three
// bf16 tiles) and shared memory's rate, since every m64 product re-reads
// its B tile.  The design:
//   * roles: out-features n are wgmma's M side, the tokens m its N side
//     (NT = 32, 64 or 128 per block), in-features K; a block is two
//     warpgroups, each owning 128 out-features (two m64 tiles), so one B
//     tile feeds 256 out-features;
//   * the codes are decoded in registers straight into wgmma's register A
//     fragments (the mixed-input GEMM shape): they never pass through
//     shared memory, and one set of fragments feeds the three products.
//     Within a 64-wide slab of in-features the kernel permutes k (A and B
//     agree) so that each thread loads its codes in wide words: at step q
//     the lane with c = lane % 4 holds fragment columns {2c, 2c+1, 2c+8,
//     2c+9} = k of the slab's run LW * c + 4 q + {0, 1, 2, 3} (LW = 16
//     bytes, 4 for int3), and each thread owns 4 consecutive out-features
//     n0 + 32 warp + 4 g + {0..3} (tile b / 2, row half b % 2): an int8
//     thread loads one 32-bit word of codes per k (the serving leaf
//     stores codes (k, n)), a packed thread LW bytes of one payload row per
//     plane, one chunk ahead in registers;
//   * x * s: x and s of slab i + 2 are copied into a raw ring in shared
//     memory (x one bulk copy per row where a slab is one 64-column run of
//     16-byte-aligned rows: per-thread copies of that many 16-byte pieces
//     were the main cost beside the products; else cp.async, zero past kg
//     and m); each thread then scales its items, splits them into the three
//     terms and stores them as three B tiles in the 128-byte-swizzled
//     K-major layout a wgmma descriptor reads; the staging of slab i + 1 is
//     interleaved with the issue of slab i's products, a quarter after each
//     k16 step;
//   * the two warpgroups meet only at mbarriers (a full and an empty one
//     per B stage, two stages), so one decodes and stages while the
//     other's products run;
//   * split-K: the k range is split across the blocks of a thread-block
//     cluster (at most 8), chosen by cudaOccupancyMaxActiveClusters so the
//     clusters run in as few waves as the card holds; they add their
//     partial tiles through distributed shared memory in rank order (equal
//     bits on every run, no atomics, no workspace), one launch per call;
//   * ragged n, m, k or kg are masked in the kernel (zero codes and zero x
//     * s), and payload rows or code rows not aligned for the wide loads
//     are read byte by byte.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace dequant_tc {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;                  // two warpgroups
constexpr int kWgRows = 128;                   // out-features per warpgroup: two m64 tiles
constexpr int kRows = 2 * kWgRows;             // out-features per block
constexpr int kTerms = 3;                      // bf16 terms of x * s
constexpr int kStages = 2;                     // B stages and raw x * s slots
constexpr int kPartStride = kRows + 4;         // floats per token of the partial tile
constexpr int kMaxCluster = 16;                // 8 is portable; 16 needs the opt-in

// Operands of one call.  Element (n, j) of column group grp of the codes is
// read by the format; x (m, G * kg) with row stride kx, s (G * kg).
struct Args {
  const float* x;
  const uint8_t* codes;
  const float* s;
  const float* t;
  float* out;
  int m, n;
  int kg;               // byte-columns of a payload row (int8: k)
  long long kx;         // x row stride in floats
  long long ldz;        // int8: stride of a k row of codes; packed: of a payload row
  int chunks_per_split;
  int vec;              // code loads may be wide
  int xvec;             // x and s loads may be 16 bytes
};

// Shared memory of a block with NT tokens: the B stages (three terms of NT
// rows of 64 bf16 each) and the raw slots (a slab's x, NT rows of its 64
// columns, and each thread's s float4, copied in two slabs ahead), or,
// after the k loop, the partial tile; then the mbarriers.
template <int NT>
struct Smem {
  static constexpr int kTileBytes = NT * 128;
  static constexpr int kStageBytes = kTerms * kTileBytes;
  static constexpr int kItems = NT / 16;       // x float4s per thread and slab
  static constexpr int kRawX = NT * 64 * 4;    // x of a slab: NT rows of 64 floats
  static constexpr int kRawBytes = kRawX + kThreads * 16;  // then s, a float4 per thread
  static constexpr int kMain = kStages * (kStageBytes + kRawBytes);
  static constexpr int kPart = NT * kPartStride * 4;
  static constexpr int kBars = kMain > kPart ? kMain : kPart;  // offset of the mbarriers
  static constexpr size_t kBytes = 1024 + kBars + 3 * kStages * sizeof(uint64_t);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Descriptor of a K-major bf16 tile with the 128-byte swizzle: rows of 64
// elements (128 bytes), 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

// Byte offset of element (row r, column col < 64) of such a tile.
__device__ __forceinline__ int swz(int r, int col) {
  return r * 128 + ((((col >> 3) ^ (r & 7))) << 4) + (col & 7) * 2;
}

template <int NT>
__device__ __forceinline__ void wgmma_rs(float (&d)[NT / 2], const uint32_t (&a)[4],
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}


__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep a register's value where the asynchronous wgmma reads or writes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][2][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[q][t][i])::"memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// `bytes` (a multiple of 16) global -> shared by the bulk-copy engine,
// counted on `bar`'s transaction count
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// A thread's staging items are (row r, step sl, c) with r = tid / 16 + 16 it
// and (sl, c) fixed: k = grp * kg + j0 + LW * c + 4 q + e, e = 0..3, where
// step sigma = 4 I + sl of the chunk reads word q = sigma % (LW / 4) of
// column group grp = sigma / (LW / 4).  Its 4 floats sit at offset
// 4 (tid % 16) of the slab's 64 in a row of raw x (LW 16: 16 c + 4 sl,
// LW 4: 16 sl + 4 c), so a row of raw x is the slab's run of x in order.
template <class Fmt>
__device__ __forceinline__ int item_sl(int tid) {
  return Fmt::LW == 16 ? tid & 3 : (tid >> 2) & 3;
}
template <class Fmt>
__device__ __forceinline__ int item_c(int tid) {
  return Fmt::LW == 16 ? (tid >> 2) & 3 : tid & 3;
}

// Copy x and s of slab `idx` of the block's k range into raw slot `raw`
// (a shared address), s zero past kg.  Where a slab is one run of 64
// columns of x (LW 16) and x's rows are 16-byte aligned (xvec), each row's
// run is one bulk copy counted on `bar` (rows past m skipped, columns past
// kg beside zero s); else every thread copies its own items with cp.async
// (16 bytes, or 4 where x's rows are not aligned), zero past kg and m.
// Either way every thread arrives on `bar` once.  `xrow` is x's row
// tid / 16 of the block's tokens, `rows` the number of its rows inside m.
template <class Fmt, int NT>
__device__ __forceinline__ void fetch_xs(uint32_t raw, uint64_t* bar, const Args& a,
                                         const float* xrow, int rows, int m0, int ch0,
                                         int idx) {
  constexpr int W = Fmt::LW / 4;
  const int tid = threadIdx.x, sl = item_sl<Fmt>(tid), c = item_c<Fmt>(tid);
  const int ch = ch0 + idx / Fmt::SPC, i = idx % Fmt::SPC;
  const int j0 = ch * 4 * Fmt::LW;
  const int sigma = 4 * i + sl, grp = sigma / W, q = sigma % W;
  const int j = j0 + Fmt::LW * c + 4 * q;
  const long long col = (long long)grp * a.kg + j;
  const uint32_t ss = raw + Smem<NT>::kRawX + 16 * tid;
  const uint32_t xs = raw + 4 * (64 * (tid >> 4) + 4 * (tid & 15));
  constexpr uint32_t kRowStep = 4 * 64 * 16;     // 16 rows of raw x
  if (a.xvec) {
    const bool ok = j < a.kg;
    cp_async16(ss, a.s + (ok ? col : 0), ok ? 16 : 0);
    if constexpr (W == 4) {
      // row r's run: column group i at byte-columns j0 .. j0 + 63, cut at kg
      const uint32_t bytes = 4 * max(0, min(64, a.kg - j0));
      const bool mine = tid < NT && m0 + tid < a.m && bytes > 0;
      mbar_expect(bar, mine ? bytes : 0);
      if (mine) {
        bulk_copy(raw + 4 * 64 * tid,
                  a.x + (long long)(m0 + tid) * a.kx + (long long)i * a.kg + j0, bytes, bar);
      }
    } else {
#pragma unroll
      for (int it = 0; it < Smem<NT>::kItems; ++it) {
        const bool v = ok && 16 * it < rows;
        cp_async16(xs + kRowStep * it, v ? xrow + col + it * 16 * a.kx : a.x, v ? 16 : 0);
      }
      mbar_arrive(bar);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = j + e < a.kg;
      cp_async4(ss + 4 * e, a.s + (ok ? col + e : 0), ok);
#pragma unroll
      for (int it = 0; it < Smem<NT>::kItems; ++it) {
        const bool v = ok && 16 * it < rows;
        cp_async4(xs + kRowStep * it + 4 * e, v ? xrow + col + e + it * 16 * a.kx : a.x, v);
      }
    }
    mbar_arrive(bar);
  }
}

template <class Fmt, int NT>
__device__ __forceinline__ void stage_b(uint32_t stage, uint32_t raw, int it0, int it1) {
  const int tid = threadIdx.x, sl = item_sl<Fmt>(tid), c = item_c<Fmt>(tid);
  const float4 sv = lds128(raw + Smem<NT>::kRawX + 16 * tid);
  const uint32_t o0 = stage + swz(tid >> 4, 16 * sl + 2 * c);
  const uint32_t o1 = stage + swz(tid >> 4, 16 * sl + 2 * c + 8);
#pragma unroll
  for (int it = it0; it < it1; ++it) {
    const float4 xv = lds128(raw + 4 * (64 * ((tid >> 4) + 16 * it) + 4 * (tid & 15)));
    const float v0 = xv.x * sv.x, v1 = xv.y * sv.y, v2 = xv.z * sv.z, v3 = xv.w * sv.w;
    // hi + mid + lo == v exactly: each remainder is exact in f32
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(v0, v1);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(v2, v3);
    const float2 fh01 = __bfloat1622float2(h01), fh23 = __bfloat1622float2(h23);
    const float r0 = v0 - fh01.x, r1 = v1 - fh01.y, r2 = v2 - fh23.x, r3 = v3 - fh23.y;
    const __nv_bfloat162 m01 = __floats2bfloat162_rn(r0, r1);
    const __nv_bfloat162 m23 = __floats2bfloat162_rn(r2, r3);
    const float2 fm01 = __bfloat1622float2(m01), fm23 = __bfloat1622float2(m23);
    const __nv_bfloat162 l01 = __floats2bfloat162_rn(r0 - fm01.x, r1 - fm01.y);
    const __nv_bfloat162 l23 = __floats2bfloat162_rn(r2 - fm23.x, r3 - fm23.y);
    const uint32_t lo[kTerms] = {bits(h01), bits(m01), bits(l01)};
    const uint32_t hi[kTerms] = {bits(h23), bits(m23), bits(l23)};
    const uint32_t row = it * 16 * 128;          // 16 rows further: the same swizzle
#pragma unroll
    for (int u = 0; u < kTerms; ++u) {
      sts32(o0 + row + u * Smem<NT>::kTileBytes, lo[u]);
      sts32(o1 + row + u * Smem<NT>::kTileBytes, hi[u]);
    }
  }
}

template <class Fmt, int NT>
__global__ void __launch_bounds__(kThreads, 1) tc_kernel(const Args a) {
  using SM = Smem<NT>;
  constexpr int JC = 4 * Fmt::LW;               // byte-columns per chunk
  constexpr int SPC = Fmt::SPC;                 // slabs per chunk
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t stages = smem_u32(smem);                  // [kStages][kStageBytes]
  const uint32_t raws = stages + kStages * SM::kStageBytes;  // [kStages][kRawBytes]
  // full[b]: every thread staged its part of B stage b; empty[b]: every
  // thread's products that read stage b completed
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* landed = empty + kStages;                      // raw slot b's x copies landed

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int n0 = blockIdx.y * kRows, m0 = blockIdx.z * NT;
  const int nw = n0 + wg * kWgRows;                        // the warpgroup's out-features
  const int n_chunks = (a.kg + JC - 1) / JC;
  const int ch0 = blockIdx.x * a.chunks_per_split;
  const int nch = min(n_chunks, ch0 + a.chunks_per_split) - ch0;
  const int n_slabs = nch * SPC;
  const float* xrow = a.x + (long long)(m0 + (tid >> 4)) * a.kx;
  const int rows = a.m - m0 - (tid >> 4);                 // the thread's x rows in m: 16 apart

  float acc[2][NT / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[t][i] = 0.0f;

  // x * s two slabs ahead: slab 0 staged, slab 1 in flight
  if (tid == 0) {
    for (int b = 0; b < kStages; ++b) {
      mbar_init(full + b, kThreads);
      mbar_init(empty + b, kThreads);
      mbar_init(landed + b, kThreads);
    }
  }
  // raw x starts as zeros: rows past m and columns past kg are never
  // copied, and meet zero s or are never stored, so they must be finite
  for (int o = 16 * tid; o < kStages * SM::kRawBytes; o += 16 * kThreads) {
    asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(raws + o), "r"(0)
                 : "memory");
  }
  fence_async_smem();
  __syncthreads();
  typename Fmt::Regs cur, nxt;
  fetch_xs<Fmt, NT>(raws, landed, a, xrow, rows, m0, ch0, 0);
  cp_commit();
  if (n_slabs > 1) fetch_xs<Fmt, NT>(raws + SM::kRawBytes, landed + 1, a, xrow, rows, m0, ch0, 1);
  cp_commit();
  Fmt::load(cur, a, ch0 * JC, nw, warp, g, c);
  cp_wait_one();
  mbar_wait(landed, 0);
  stage_b<Fmt, NT>(stages, raws, 0, SM::kItems);
  fence_async_smem();
  mbar_arrive(full);

  int slab = 0;
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) Fmt::load(nxt, a, (ch0 + ch + 1) * JC, nw, warp, g, c);
    // The two warpgroups meet only at the stages' barriers, so one decodes
    // and stages while the other's products run.
    auto run = [&](auto slab_in_chunk) {
      constexpr int I = decltype(slab_in_chunk)::value;
      const int b = slab & 1, nb = b ^ 1;
      uint32_t af[4][2][4];
      Fmt::template frags<I>(cur, af);
      // every thread staged slab from raw slot b (full): copy slab + 2
      // into it; slab + 1's copies (issued one slab ago) are the ones to land
      mbar_wait(full + b, (slab >> 1) & 1);
      if (slab + 2 < n_slabs) {
        fetch_xs<Fmt, NT>(raws + b * SM::kRawBytes, landed + b, a, xrow, rows, m0, ch0,
                          slab + 2);
      }
      cp_commit();
      __syncwarp();
      wgmma_fence();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      const uint32_t sb = stages + b * SM::kStageBytes;
      const uint32_t next = stages + nb * SM::kStageBytes;
      const uint32_t next_raw = raws + nb * SM::kRawBytes;
      const bool more = slab + 1 < n_slabs;
      // each k16 step's products, then a quarter of slab + 1's staging (once
      // every product that read its stage, slab - 1's, completed), so the
      // CUDA cores work while the tensor cores drain the queue
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int u = 0; u < kTerms; ++u) {
          const uint64_t desc = desc_b128(sb + u * SM::kTileBytes + 32 * q);
          wgmma_rs<NT>(acc[0], af[q][0], desc);
          wgmma_rs<NT>(acc[1], af[q][1], desc);
        }
        if (q == 0) {
          cp_wait_one();
          if (more) mbar_wait(landed + nb, ((slab + 1) >> 1) & 1);
          if (more && slab > 0) mbar_wait(empty + nb, ((slab - 1) >> 1) & 1);
        }
        constexpr int kPer = (SM::kItems + 3) / 4;
        if (more && kPer * q < SM::kItems) {
          stage_b<Fmt, NT>(next, next_raw, kPer * q,
                      kPer * (q + 1) < SM::kItems ? kPer * (q + 1) : SM::kItems);
        }
      }
      wgmma_commit();
      if (more) {
        fence_async_smem();
        mbar_arrive(full + nb);
      }
      wgmma_wait_all();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      fence_regs(af);
      mbar_arrive(empty + b);
      ++slab;
    };
    run(std::integral_constant<int, 0>{});
    if constexpr (SPC > 1) run(std::integral_constant<int, (SPC > 1 ? 1 : 0)>{});
    if constexpr (SPC > 2) {
      run(std::integral_constant<int, (SPC > 2 ? 2 : 0)>{});
      run(std::integral_constant<int, (SPC > 2 ? 3 : 0)>{});
    }
    if (ch + 1 < nch) cur = nxt;
  }
  __syncthreads();                               // every product read its stage

  // the block's partial tile, token-major, into shared memory (free: every
  // wgmma has completed and every thread passed the barrier): thread
  // (wg, warp, g, c) holds out-features 128 wg + 32 warp + 4 g + 2 t + h of
  // tokens 8 j + 2 c + b
  float* part = reinterpret_cast<float*>(smem);  // [NT][kPartStride]
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      *reinterpret_cast<float4*>(part + (8 * j + 2 * c + b) * kPartStride + kWgRows * wg +
                                 32 * warp + 4 * g) =
          make_float4(acc[0][4 * j + b], acc[0][4 * j + 2 + b], acc[1][4 * j + b],
                      acc[1][4 * j + 2 + b]);
    }
  }

  // split-K over the cluster's blocks: rank r sums a disjoint slice of the
  // tile (float4s), the ranks' partials added in rank order, applies t
  // and stores
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  cluster.sync();
  constexpr int kTile4 = NT * kRows / 4;
  const int per = (kTile4 + splits - 1) / splits;
  const int e_end = min(kTile4, (rank + 1) * per);
  const bool out4 = (a.n % 4 == 0) && (reinterpret_cast<uintptr_t>(a.out) % 16 == 0);
  for (int e = rank * per + tid; e < e_end; e += kThreads) {
    const int tok = e / (kRows / 4), nl = 4 * (e % (kRows / 4));
    const int off = tok * kPartStride + nl;
    float4 v[kMaxCluster];
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z) {
      if (z < splits) {
        v[z] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, z) + off);
      }
    }
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z) {
      if (z < splits) {
        sum.x += v[z].x;
        sum.y += v[z].y;
        sum.z += v[z].z;
        sum.w += v[z].w;
      }
    }
    const int row = m0 + tok, col = n0 + nl;
    if (row >= a.m || col >= a.n) continue;
    float* o = a.out + (size_t)row * a.n + col;
    if (out4 && col + 4 <= a.n) {
      const float4 tv = __ldg(reinterpret_cast<const float4*>(a.t + col));
      *reinterpret_cast<float4*>(o) = make_float4(sum.x * tv.x, sum.y * tv.y, sum.z * tv.z,
                                                  sum.w * tv.w);
    } else {
      const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
      for (int b = 0; b < 4 && col + b < a.n; ++b) o[b] = sv[b] * a.t[col + b];
    }
  }
  cluster.sync();                                // partials stay until all have read
}

// Clusters of `splits` blocks the card holds at once, per kernel.
template <class Fmt, int NT>
int max_clusters(int splits) {
  static int known[kMaxCluster + 1] = {};
  if (known[splits] <= 0) {
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = splits;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, 1, 1);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = Smem<NT>::kBytes;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    int c = 0;
    if (cudaOccupancyMaxActiveClusters(&c, tc_kernel<Fmt, NT>, &cfg) != cudaSuccess) {
      (void)cudaGetLastError();                 // not sticky: a later launch is unaffected
      return 0;
    }
    known[splits] = c;
  }
  return known[splits];
}

// Chunks per k split: of 1 .. kMaxCluster splits (clusters of that many
// blocks), the one whose waves of resident clusters times the chunks of
// a block (plus one for its set-up and reduction) is least; fewer splits
// on a tie.
template <class Fmt, int NT, int JC>
int chunks_per_split(int m, int n, int kg) {
  const long tiles = (long)((n + kRows - 1) / kRows) * ((m + NT - 1) / NT);
  const int n_chunks = (kg + JC - 1) / JC;
  int best = n_chunks;
  long best_cost = -1;
  for (int splits = 1; splits <= std::min(kMaxCluster, n_chunks); ++splits) {
    const int per = (n_chunks + splits - 1) / splits;
    const int used = (n_chunks + per - 1) / per;
    const int fit = max_clusters<Fmt, NT>(used);
    if (fit <= 0) continue;
    const long cost = ((tiles + fit - 1) / fit) * (per + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = per;
    }
  }
  return best;
}

template <class Fmt, int NT>
cudaError_t launch(Args a, cudaStream_t stream) {
  constexpr int JC = 4 * Fmt::LW;
  auto kernel = tc_kernel<Fmt, NT>;
  constexpr size_t smem = Smem<NT>::kBytes;
  // before the occupancy queries, which read them
  static cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  static cudaError_t wide =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (wide != cudaSuccess) return wide;
  a.chunks_per_split = chunks_per_split<Fmt, NT, JC>(a.m, a.n, a.kg);
  const int n_chunks = (a.kg + JC - 1) / JC;
  const int splits = (n_chunks + a.chunks_per_split - 1) / a.chunks_per_split;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (a.n + kRows - 1) / kRows, (a.m + NT - 1) / NT);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// The token tile by m: the smallest of 32, 64, 128 that holds m, else 128.
template <class Fmt>
cudaError_t launch_any(const Args& a, cudaStream_t stream) {
  if (a.m <= 32) return launch<Fmt, 32>(a, stream);
  if (a.m <= 64) return launch<Fmt, 64>(a, stream);
  return launch<Fmt, 128>(a, stream);
}

}  // namespace dequant_tc
