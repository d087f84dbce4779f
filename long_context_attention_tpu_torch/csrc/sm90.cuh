// Hopper (sm_90a) building blocks shared by the wgmma/TMA kernels
// (flash_fwd_sm90.cu, flash_bwd_sm90.cu, flash_dq_sm90.cu,
// sage_fwd_sm90.cu): PTX wrappers for mbarriers, TMA, cp.async, wgmma and
// register allocation, the persistent blocks' snake order or host list, the
// forward kernels' kv walk and int8 widening, the block-sparse row items and
// walk, and the host's tensor-map encoder. Each source that includes it
// builds into its own library, so everything here lives in an anonymous
// namespace.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_quant.cuh"

namespace {

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// global[box at the coordinates] += shared (element type and swizzle from
// the map), asynchronous in the issuing thread's bulk group; elements
// outside the tensor are not written
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map,
                                                  uint32_t src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"((uint64_t)map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the issuing thread's bulk groups have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ... and completed their writes
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// 4 bytes from global to shared memory, asynchronously; src-size 0 writes
// zeros (and reads nothing)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// one arrival on the mbarrier once the issuing thread's cp.async copies so
// far have landed (.noinc: the barrier's expected count includes it)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// stores to a shared-memory address (32 bits: no 64-bit generic pointer
// for the compiler to keep live)
__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_v2f32(uint32_t addr, float x,
                                                float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x),
               "f"(y)
               : "memory");
}

// generic-proxy writes to shared memory become visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma reads or writes across its issue and its wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// ... 64-byte swizzle (a K-major operand of 64-byte rows: s8 rows of head
// dim 64, 8-row groups 512 bytes apart)
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (2ull << 62);
}

// wgmma accumulator operand lists: N read-write ("+f") or write-only ("=f")
// fp32 registers, and the matching "{%0, ..., %N-1}" of the instruction
#define LCA_ACC8(a, i)                                                 \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]),          \
      "+f"(a[i + 4]), "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])
#define LCA_ACC32(a) LCA_ACC8(a, 0), LCA_ACC8(a, 8), LCA_ACC8(a, 16), \
                     LCA_ACC8(a, 24)
#define LCA_ACC64(a)                                                   \
  LCA_ACC8(a, 0), LCA_ACC8(a, 8), LCA_ACC8(a, 16), LCA_ACC8(a, 24),    \
      LCA_ACC8(a, 32), LCA_ACC8(a, 40), LCA_ACC8(a, 48), LCA_ACC8(a, 56)
#define LCA_OUT8(a, i)                                                 \
  "=f"(a[i]), "=f"(a[i + 1]), "=f"(a[i + 2]), "=f"(a[i + 3]),          \
      "=f"(a[i + 4]), "=f"(a[i + 5]), "=f"(a[i + 6]), "=f"(a[i + 7])
#define LCA_OUT32(a) LCA_OUT8(a, 0), LCA_OUT8(a, 8), LCA_OUT8(a, 16), \
                     LCA_OUT8(a, 24)
#define LCA_OUT64(a)                                                   \
  LCA_OUT8(a, 0), LCA_OUT8(a, 8), LCA_OUT8(a, 16), LCA_OUT8(a, 24),    \
      LCA_OUT8(a, 32), LCA_OUT8(a, 40), LCA_OUT8(a, 48), LCA_OUT8(a, 56)
// the same for s32 accumulators (int8 products)
#define LCA_IACC8(a, i)                                                \
  "+r"(a[i]), "+r"(a[i + 1]), "+r"(a[i + 2]), "+r"(a[i + 3]),          \
      "+r"(a[i + 4]), "+r"(a[i + 5]), "+r"(a[i + 6]), "+r"(a[i + 7])
#define LCA_IACC64(a)                                                  \
  LCA_IACC8(a, 0), LCA_IACC8(a, 8), LCA_IACC8(a, 16), LCA_IACC8(a, 24), \
      LCA_IACC8(a, 32), LCA_IACC8(a, 40), LCA_IACC8(a, 48), LCA_IACC8(a, 56)
#define LCA_IOUT8(a, i)                                                \
  "=r"(a[i]), "=r"(a[i + 1]), "=r"(a[i + 2]), "=r"(a[i + 3]),          \
      "=r"(a[i + 4]), "=r"(a[i + 5]), "=r"(a[i + 6]), "=r"(a[i + 7])
#define LCA_IOUT64(a)                                                  \
  LCA_IOUT8(a, 0), LCA_IOUT8(a, 8), LCA_IOUT8(a, 16), LCA_IOUT8(a, 24), \
      LCA_IOUT8(a, 32), LCA_IOUT8(a, 40), LCA_IOUT8(a, 48), LCA_IOUT8(a, 56)
#define LCA_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define LCA_D64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128 fp32) += A (64 x 16 bf16 in registers, the accumulator
// fragment layout) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " LCA_D64
      ", {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : LCA_ACC64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db));
}

// d (64 x 64 fp32) += A (64 x 16 bf16 in registers) * B (16 x 64, shared,
// MN-major): O += P V at head dim 64
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LCA_D32
      ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : LCA_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db));
}

// d (64 x D fp32, N = D / 2 registers) += A (64 x 16 bf16 in registers) *
// B (16 x D, shared, MN-major) at head dim D = 128 or 64: O += P V, and the
// backward's dV, dK and dQ products
template <int N>
__device__ __forceinline__ void wgmma_rs_d(float (&d)[N], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db) {
  static_assert(N == 32 || N == 64, "head dim 64 or 128");
  if constexpr (N == 64)
    wgmma_rs(d, a0, a1, a2, a3, db);
  else
    wgmma_rs_n64(d, a0, a1, a2, a3, db);
}

// tanh(x) = 1 - 2 / (exp(2x) + 1) by the fast exp and reciprocal (|x|
// clamped at 15, where tanh rounds to 1): within a few ulp of 1 of tanhf,
// absolute, for the backward's softcap, whose capped score cap * t carries
// that times the cap, far below the bf16 casts of p and ds
__device__ __forceinline__ float tanh_fast(float x) {
  x = fminf(fmaxf(x, -15.f), 15.f);
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}

__device__ __forceinline__ unsigned short float_to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));  // nearest even
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)float_to_bf16_bits(lo) |
         ((uint32_t)float_to_bf16_bits(hi) << 16);
}

// two int8 (bytes `sel` of w) -> two bf16, exactly: with the bytes spread
// to the 16-bit halves, 0x4300 | (b & 0x7f) is the bf16 of 128 + (b & 0x7f),
// and subtracting 128 (b >= 0) or 256 (b < 0: bit 7, read into the
// subtrahend's exponent) leaves b; all values are integers below 256 in
// magnitude, so the bf16 subtraction is exact
__device__ __forceinline__ uint32_t widen2(uint32_t w, uint32_t sel) {
  const uint32_t x = __byte_perm(w, 0u, sel);
  const uint32_t t = (x & 0x007F007Fu) | 0x43004300u;
  const uint32_t sub = (x & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&t),
              *reinterpret_cast<const __nv_bfloat162*>(&sub));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// B3's kinds of K/V (the forward kernel's run-time Params::kv, read by its
// producers): bf16, or the quantized cache's int8, fp8 e4m3 or packed
// int4, widened to bf16 by the producers
constexpr int kKvBF16 = 0, kKvInt8 = 1, kKvFp8 = 2, kKvInt4 = 3;

// two e4m3 values (the low 16 bits of x) -> two bf16, exactly
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t x) {
  const float2 f = e4m3x2_to_float2(x);
  return pack_bf16(f.x, f.y);
}

// Widen rows [r0, r0 + ROWS) of a raw tile of 128 rows of head dim DH
// (int8 or fp8: DH bytes a row; int4: DH / 2) into the swizzled bf16 boxes
// at dst (DH / 64 of them: d 0-63, then 64-127; 128 rows of 128 bytes
// each, 128-byte swizzle), by the 128 threads of a warpgroup, two chunks
// of 16 values at a time (their loads first, for the warp of each SM
// sub-partition to overlap). Within each 8-thread phase of a 16-byte
// access, the threads read 128 contiguous bytes (DH = 128: four threads
// row r and four row r + 1, opposite halves of the rows; DH = 64: rows r
// and r + 1 whole), and their bf16 chunks land on distinct banks of the
// swizzled boxes. int4 chunks are 8 bytes, sign-extended to the int8 chunk
// first. r0 is a multiple of 8.
template <int ROWS, int KV = kKvInt8, int DH = 128>
__device__ __forceinline__ void widen_rows(const unsigned char* raw,
                                           unsigned char* dst, int r0,
                                           int ptid) {
  static_assert(DH == 64 || DH == 128, "head dim 64 or 128");
  constexpr int CPR = DH / 16;                  // 16-value chunks a row
  constexpr int CHUNKS = ROWS * CPR / 128;      // per thread
  constexpr int BATCH = 2;
#pragma unroll 1
  for (int it = 0; it < CHUNKS; it += BATCH) {
    uint4 w[BATCH];
    int row[BATCH], c[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int idx = (it + u) * 128 + ptid;
      if constexpr (DH == 128) {
        const int j = idx & 15;
        row[u] = r0 + 2 * (idx >> 4) + (((j >> 2) & 1) ^ (j >> 3));
        c[u] = j & 7;  // chunk of 16 values of the row
      } else {
        const int j = idx & 7;
        row[u] = r0 + 2 * (idx >> 3) + (j >> 2);
        c[u] = j & 3;
      }
      if constexpr (KV == kKvInt4) {
        const uint2 n = *reinterpret_cast<const uint2*>(
            raw + row[u] * (DH / 2) + c[u] * 8);
        s4x8_to_s8(n.x, w[u].x, w[u].y);
        s4x8_to_s8(n.y, w[u].z, w[u].w);
      } else {
        w[u] = *reinterpret_cast<const uint4*>(raw + row[u] * DH + c[u] * 16);
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      uint4 lo, hi;
      if constexpr (KV == kKvFp8) {
        lo.x = e4m3x2_to_bf16x2(w[u].x & 0xffffu);
        lo.y = e4m3x2_to_bf16x2(w[u].x >> 16);
        lo.z = e4m3x2_to_bf16x2(w[u].y & 0xffffu);
        lo.w = e4m3x2_to_bf16x2(w[u].y >> 16);
        hi.x = e4m3x2_to_bf16x2(w[u].z & 0xffffu);
        hi.y = e4m3x2_to_bf16x2(w[u].z >> 16);
        hi.z = e4m3x2_to_bf16x2(w[u].w & 0xffffu);
        hi.w = e4m3x2_to_bf16x2(w[u].w >> 16);
      } else {
        lo.x = widen2(w[u].x, 0x4140);
        lo.y = widen2(w[u].x, 0x4342);
        lo.z = widen2(w[u].y, 0x4140);
        lo.w = widen2(w[u].y, 0x4342);
        hi.x = widen2(w[u].z, 0x4140);
        hi.y = widen2(w[u].z, 0x4342);
        hi.z = widen2(w[u].w, 0x4140);
        hi.w = widen2(w[u].w, 0x4342);
      }
      unsigned char* drow = dst + (c[u] >> 2) * (128 * 128) + row[u] * 128;
      const int bc = (c[u] & 3) * 2;  // its first bf16 chunk in the box
      const int sw = row[u] & 7;
      *reinterpret_cast<uint4*>(drow + ((bc ^ sw) << 4)) = lo;
      *reinterpret_cast<uint4*>(drow + (((bc + 1) ^ sw) << 4)) = hi;
    }
  }
}

// A call's position descriptor in the kernels' local units. The host
// (ops/flash.py pair_masks) reduces the JAX kernels' (q_offsets,
// kv_offsets, stride) contract, position = offsets[l / chunk] + (l % chunk)
// * stride with one stride on both sides, to nqc q chunks of cq rows and nkc
// kv chunks of ckv columns (1 or 2 each; one chunk: the whole s_q or s_kv)
// and, per (q chunk, kv chunk) pair qc * 2 + kc, three integers over
// chunk-local rows i and columns j: the pair is seen when j - i <= hi (the
// causal or right window: floor((qo - ko + right) / stride)), and j - i >=
// lo (the left window: ceil((qo - ko - left) / stride)) or j < sk (the
// sinks: the columns at positions below sink_tokens); kOpenRel for an
// unbounded side. Then the global positions the features read (ALiBi, the
// dropout hash): each chunk's offset, qo[qc] and ko[kc] (a one-chunk side's
// in both), and the stride st, so that chunk-local row i of q chunk qc sits
// at qo[qc] + i * st. The layout on dims, from index `at`: nqc, nkc, cq,
// ckv, then hi, lo, sk of each of the 4 pairs, then qo[0], qo[1], ko[0],
// ko[1], st (kDescLen entries).
constexpr int kOpenRel = 1 << 29;
constexpr int kDescLen = 21;
struct Desc {
  int nqc, nkc, cq, ckv;
  int hi[4], lo[4], sk[4];
  int qo[2], ko[2], st;
};

inline Desc desc_from(const long long* dims, int at) {
  Desc d;
  d.nqc = (int)dims[at];
  d.nkc = (int)dims[at + 1];
  d.cq = (int)dims[at + 2];
  d.ckv = (int)dims[at + 3];
  for (int pr = 0; pr < 4; ++pr) {
    d.hi[pr] = (int)dims[at + 4 + 3 * pr];
    d.lo[pr] = (int)dims[at + 5 + 3 * pr];
    d.sk[pr] = (int)dims[at + 6 + 3 * pr];
  }
  for (int c = 0; c < 2; ++c) {
    d.qo[c] = (int)dims[at + 16 + c];
    d.ko[c] = (int)dims[at + 18 + c];
  }
  d.st = (int)dims[at + 20];
  return d;
}

// ---------------------------------------------------------------------------
// The features of B3, B2a and B2b (JAX's _seg_mask, _alibi_bias,
// _dropout_keep), at the global positions of the descriptor
// ---------------------------------------------------------------------------

// A call's features. Segment ids: q (b, s_q) and kv (b, kv_ld) int32,
// a pair of unequal ids dropped (kv_ld: the kv rows' stride, a multiple of
// 4 for TMA). ALiBi: per q head -slope * |row - col| added to the score
// (natural units). Dropout: a pair is kept when the lowbias32 hash of
// (seed, batch, q head, global row, global column) is >= thresh, and a kept
// p is scaled by inv = 1 / (1 - p). The layout on dims after the
// descriptor: seg, alibi, drop (flags), seed0, seed1 (the seed and its
// head base), thresh, kv_ld.
struct Feat {
  const int* qseg;
  const int* kvseg;
  const float* slopes;
  long long kv_ld;
  uint32_t seed0, seed1, thresh;
  float inv;
  int seg, alibi, drop;
};

#define LCA_FEAT_ARGS \
  const int *qseg, const int *kvseg, const float *slopes, float drop_inv

constexpr int kFeatLen = 7;  // the entries feat_from reads

inline Feat feat_from(const long long* dims, int at, const int* qseg,
                      const int* kvseg, const float* slopes, float inv) {
  Feat f;
  f.seg = (int)dims[at];
  f.alibi = (int)dims[at + 1];
  f.drop = (int)dims[at + 2];
  f.seed0 = (uint32_t)dims[at + 3];
  f.seed1 = (uint32_t)dims[at + 4];
  f.thresh = (uint32_t)dims[at + 5];
  f.kv_ld = dims[at + 6];
  f.qseg = qseg;
  f.kvseg = kvseg;
  f.slopes = slopes;
  f.inv = inv;
  return f;
}

// Whether a feature's operands are there (a flag without its pointer, or a
// segment call without its kv rows' stride, is refused)
inline bool feat_ok(const Feat& f) {
  return (!f.seg || (f.qseg && f.kvseg && f.kv_ld > 0 && f.kv_ld % 4 == 0)) &&
         (!f.alibi || f.slopes);
}

constexpr uint32_t kGold = 0x9E3779B9u;

// lowbias32 (Chris Wellons; the JAX kernels' _hash_u32)
__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The dropout hash's part of a (batch row, q head): h32 of the salt
__device__ __forceinline__ uint32_t drop_salt(const Feat& f, int ib, int ih) {
  return hash32(f.seed0 + (uint32_t)ib * 2654435761u +
                (f.seed1 + (uint32_t)ih) * kGold);
}

// ... and of a row at global position `row` (hoisted out of the columns)
__device__ __forceinline__ uint32_t drop_row(uint32_t salt_h, int row) {
  return kGold * hash32((uint32_t)row + salt_h);
}

// whether the pair of this row (drop_row) and the column at global position
// `col` is kept
__device__ __forceinline__ bool drop_keep(const Feat& f, uint32_t row_h,
                                          int col) {
  return hash32((uint32_t)col + row_h) >= f.thresh;
}

// The ALiBi bias of a pair: nslope (the head's -slope) * |row - col|
__device__ __forceinline__ float alibi_bias(float nslope, int row, int col) {
  return nslope * (float)abs(row - col);
}

// Whether a descriptor is one the kernels take: 1 or 2 chunks a side that
// tile the lengths, a multi-chunk side cut on `tile` boundaries (a tile
// never crosses a chunk: the JAX kernels' rule)
inline bool desc_ok(const Desc& d, int s_q, int s_kv, int tile) {
  if (d.nqc < 1 || d.nqc > 2 || d.nkc < 1 || d.nkc > 2) return false;
  if (d.nqc * d.cq != s_q || d.nkc * d.ckv != s_kv) return false;
  return (d.nqc == 1 || d.cq % tile == 0) && (d.nkc == 1 || d.ckv % tile == 0);
}

// The kv tiles of BKV columns that the chunk-local rows [i0, i1] of q chunk
// qc see, each once: kv chunk by kv chunk, the sink tiles that lie before
// the band, then the band [lo, hi] (the TPU kernels' _banded_gt). tile(jt)
// is the global kv tile of the jt-th, chunk(jt) its kv chunk. MULTI: up
// to two kv chunks (a kernel's instantiation for multi-chunk descriptors);
// else the one chunk, whose walk holds no second one's state.
template <int BKV, bool MULTI>
struct KvWalk {
  int n0, n;
  int lo[2], n_sink[2], base[2];
  __device__ KvWalk(const Desc& d, int qc, int i0, int i1) {
    n = 0;
    n0 = 0;
#pragma unroll
    for (int kc = 0; kc < (MULTI ? 2 : 1); ++kc) {
      lo[kc] = n_sink[kc] = 0;
      base[kc] = kc * (d.ckv / BKV);
      if (kc >= d.nkc) continue;
      const int pr = qc * 2 + kc;
      int hi = (d.ckv + BKV - 1) / BKV - 1;
      const int last = i1 + d.hi[pr];
      hi = last < 0 ? -1 : min(hi, last / BKV);
      lo[kc] = max(i0 + d.lo[pr], 0) / BKV;
      n_sink[kc] = min(min((d.sk[pr] + BKV - 1) / BKV, lo[kc]), hi + 1);
      n += n_sink[kc] + max(hi - lo[kc] + 1, 0);
      if (kc == 0) n0 = n;
    }
  }
  __device__ int chunk(int jt) const { return MULTI && jt >= n0; }
  __device__ int tile(int jt) const {
    const int c = chunk(jt);
    const int r = jt - (c ? n0 : 0);
    return base[c] + (r < n_sink[c] ? r : lo[c] + (r - n_sink[c]));
  }
};

// The C signature of every flash backward entry point (B2a in
// flash_dq_sm90.cu; B2b and B5 in flash_bwd_sm90.cu): dq, dk and dv are
// null where unused; dims: b, h, h_kv, s_q, s_kv, the (batch, seq, head)
// element strides of q, k, v, dout, dq and dk (dv shares dk's), q_start,
// causal, left, right, sink, the descriptor (Desc) and the features (Feat;
// B2a and B2b take their operands as LCA_FEAT_ARGS after the others).
#define LCA_BWD_ARGS                                                         \
  const void *q, const void *k, const void *v, const void *dout,             \
      const float *lse, const float *delta, float *dq, float *dk, float *dv, \
      const long long *dims, float scale, float softcap, void *stream

template <bool B>
struct Flag {  // a compile-time bool for a generic lambda's argument
  static constexpr bool value = B;
};

// The block's j-th item of a persistent grid: items in rows of gridDim.x,
// walked in a snake order (left to right, then right to left), so that
// under a longest-first order each block's two items of a pair of rows sum
// to about the same work
__device__ __forceinline__ int item_index(int j) {
  const int g = gridDim.x;
  return (j & 1) ? (j + 1) * g - 1 - (int)blockIdx.x
                 : j * g + (int)blockIdx.x;
}

// The items of this persistent block, its j-th turn for j in [j0, end), from
// a kernel's Params (n_items, sched_ptr, sched): LISTED, the host's list for
// the block (block i runs sched[sched_ptr[i] .. sched_ptr[i + 1]) in that
// order: ops/sparse.py SparsePlan's schedules, items longest first, each to
// the block with the least work so far); else item_index's snake over
// n_items.
template <bool LISTED>
struct BlockItems {
  int j0, end;
  template <class P>
  __device__ explicit BlockItems(const P& p) {
    if constexpr (LISTED) {
      j0 = p.sched_ptr[blockIdx.x];
      end = p.sched_ptr[blockIdx.x + 1];
    } else {
      j0 = 0;
      end = (p.n_items + (int)gridDim.x - 1) / (int)gridDim.x;
    }
  }
  // item t of the block's j-th turn, or -1 when the snake has none
  template <class P>
  __device__ int at(const P& p, int j) const {
    if constexpr (LISTED) return p.sched[j];
    const int t = item_index(j);
    return t < p.n_items ? t : -1;
  }
};

// ---------------------------------------------------------------------------
// Block-sparse row items (B9a, B9b)
// ---------------------------------------------------------------------------

constexpr int kRowStep = 128;   // kv columns per step of a row walk
constexpr int kMaskedFlag = 4;  // a sparse table entry's _F_MASKED

// Work item t of a row walk: 128 q rows (q0 on) of a mask row (head or 0,
// q tile), for one head and batch row. The host lists the items as (row,
// first q row in its q tile, steps, 0), longest first (ops/sparse.py
// SparsePlan.row_items); work item t is item t / reps, repeated over the
// batch rows and, for a mask shared by the heads, the heads (reps = b or b
// * h). The last item of a q tile that is an odd multiple of 64 owns 64
// rows.
struct RowItem {
  int ih, ib, q0, sub, rows, n, e0, e_end;
};

__device__ __forceinline__ RowItem row_item(const int4* items, const int* ptr,
                                            int t, int b, int h, int n_q,
                                            int bq, int per_head) {
  const int reps = per_head ? b : b * h;
  const int4 e = items[t / reps];
  const int r = t % reps;
  RowItem x;
  x.ib = r % b;
  x.ih = per_head ? e.x / n_q : r / b;
  x.sub = e.y;
  x.q0 = (e.x % n_q) * bq + e.y;
  x.rows = min(128, bq - e.y);
  x.n = e.z;
  x.e0 = ptr[e.x];
  x.e_end = ptr[e.x + 1];
  return x;
}

// A step of a row item's walk: kRowStep kv columns of its row's CSR entry e
// (kv tile, flags, q_first, kv_first), the j-th of the entry's block_kv /
// kRowStep (rounded up); on a MASKED entry the steps that lie wholly above
// the diagonal for the item's rows (a suffix) are passed over, which drops
// only zeros.
struct RowStep {
  int e, j, hi;
  int4 en;
};

struct RowWalk {
  const int4* ent;
  int e_end, sub, rows, bkv;
  __device__ RowWalk(const int4* ent_, const RowItem& x, int bkv_)
      : ent(ent_), e_end(x.e_end), sub(x.sub), rows(x.rows), bkv(bkv_) {}
  __device__ RowStep from(int e) const {
    const int nsub = (bkv + kRowStep - 1) / kRowStep;
    for (; e < e_end; ++e) {
      const int4 en = ent[e];
      int hi = nsub;
      if (en.y & kMaskedFlag) {  // the item's last q row less kv_first
        const int last = en.z + sub + rows - 1 - en.w;
        hi = last < 0 ? 0 : min(nsub, last / kRowStep + 1);
      }
      if (hi > 0) return RowStep{e, 0, hi, en};
    }
    return RowStep{e_end, 0, 0, make_int4(0, 0, 0, 0)};
  }
  __device__ RowStep next(const RowStep& s) const {
    if (s.j + 1 < s.hi) return RowStep{s.e, s.j + 1, s.hi, s.en};
    return from(s.e + 1);
  }
  __device__ int kv0(const RowStep& s) const {  // the step's first kv row
    return s.en.x * bkv + kRowStep * s.j;
  }
  // what the consumers need of a step: its first q position less its first
  // kv position (the layout's positions for ring shards), and its columns
  // inside the kv tile (kRowStep, or 64 for the last step of an odd
  // multiple of 64) | MASKED << 16
  __device__ int2 meta(const RowStep& s) const {
    return make_int2(
        s.en.z + sub - (s.en.w + kRowStep * s.j),
        min(kRowStep, bkv - kRowStep * s.j) |
            ((s.en.y & kMaskedFlag) ? 0x10000 : 0));
  }
};

// ---------------------------------------------------------------------------
// Host side: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime (the library links
// only the CUDA runtime)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &res);
#endif
    if (res == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// A tiled map over `rank` dims (innermost first) with element strides for
// dims 1.. (a size-1 dim takes the packed stride: TMA never steps it).
bool encode(CUtensorMap* map, const void* base, CUtensorMapDataType type,
            int esize, int rank, const long long* dims,
            const long long* strides, const cuuint32_t* box,
            CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t estride[4] = {1, 1, 1, 1};
  long long packed = dims[0] * esize;
  for (int i = 0; i < rank; ++i) gdim[i] = (cuuint64_t)dims[i];
  for (int i = 1; i < rank; ++i) {
    gstride[i - 1] =
        (cuuint64_t)(dims[i] == 1 ? packed : strides[i - 1] * esize);
    packed = (long long)gstride[i - 1] * dims[i];
  }
  return fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), gdim,
            gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace
