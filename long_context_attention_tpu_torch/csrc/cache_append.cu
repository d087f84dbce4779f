// KV-cache append for Hopper (sm_90a): new K/V rows quantized and written
// into the cache IN PLACE, K and V in one launch.
//
// Replaces the TPU kernel long_context_attention_tpu/ops/decode.py
// _append_kernel (wrapper cache_append) together with the quantizer that
// feeds it (long_context_attention_tpu/ops/kv_cache.py quantize_kv, an XLA
// fusion in the JAX model's decode step), for the dense cache and the paged
// pool. Token t of row b's new run lands at logical slot pos[b] + t, and
// only when that slot lies in [0, capacity) -- a negative or out-of-range
// position writes nothing. A dense row's slots are its own (capacity
// s_max); a paged row's logical slot s lives in pool page
// page_table[b, s / page] at offset s % page (capacity n_pages * page), so
// a run may straddle a page boundary. A live slot whose table entry lies
// outside the pool lands on the clamped page, as the TPU kernel's clamped
// index map does (the engines keep pool page 0 as scratch for that).
//
// Kinds (template KIND): kCopy writes rows already in the cache's storage
// (opaque bytes, and their scales: the public cache_append); kBf16, kInt8,
// kFp8 and kInt4 read bf16 rows of head_dim D (128, or 64 in a second
// library built with -DLCA_HEAD_DIM=64) and quantize each as
// quantize_kv does: scale = max(absmax, 1e-6) / qmax and q = x / scale,
// both IEEE divisions; int8 and int4 round half to even and clamp; fp8
// clamps to +-448 and casts with round-to-nearest; int4 packs element 2i in
// the low nibble of byte i, 2i + 1 in the high one.
//
// What bounds it on an H100: a decode step's append moves a few KB, far
// below what one launch costs, so it is bound by its launch; everything
// around one append is therefore one launch: the quantization, K and V,
// and (for an admission) every layer. A 2048-token prefill chunk at b = 4
// reads 34 MB of bf16 rows: bound by its bytes, in practice by the latency
// of each warp's loads.
//
// Design: one warp per (tensor, layer, row, head) and run of up to 4
// consecutive tokens, the token groups fastest, in blocks of 8 warps; the
// grid covers every item, which fills the card for a prefill chunk. A lane
// holds D / 32 values of each of the warp's rows (4 at d = 128, 2 at 64):
// the rows' 8-byte (4-byte) loads (the input read in place through its
// strides) are issued first, before the slot and page lookups they do not
// depend on, so a warp keeps up to 1 KB (512 bytes) in flight. The warp's
// max of |x| is exact in any order; lane 0 writes a row's scale and each
// lane its 8 (bf16), 4 (int8, fp8) or 2 (int4) bytes at d = 128, half that
// at 64 (int4: one byte, two nibbles).
// No shared memory, TMA or tensor cores: none helps work smaller than its
// launch.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef LCA_HEAD_DIM
#define LCA_HEAD_DIM 128
#endif

namespace {

enum Kind { kCopy = 0, kBf16 = 1, kInt8 = 2, kFp8 = 3, kInt4 = 4 };

constexpr int D = LCA_HEAD_DIM;
static_assert(D == 64 || D == 128, "head dim 64 or 128");
constexpr int kWarps = 8;          // warps a block
constexpr int kRows = 4;           // consecutive tokens (rows) a warp writes
constexpr int kLaneVals = D / 32;  // values a lane of a quantizing kind

// a lane's kLaneVals bf16 values (8 or 4 bytes), and the unsigned integer
// of n bytes
template <int N>
struct Bits;
template <>
struct Bits<1> { using T = uint8_t; };
template <>
struct Bits<2> { using T = uint16_t; };
template <>
struct Bits<4> { using T = uint32_t; };
template <>
struct Bits<8> { using T = uint2; };
using LaneRaw = Bits<2 * kLaneVals>::T;

// the int64 argument array's slots (ops/decode.py _A_*)
enum Arg {
  aKind = 0, aDst = 1, aDsc = 3, aSrc = 5, aSsc = 7, aPos = 9, aPt = 10,
  aSt = 11, aNl = 19, aLayer0, aB, aN, aHkv, aPos0, aCap, aPool, aPage,
  aNPages, aRowBytes, aCount
};

struct Params {
  char* dst[2];          // K, V values (L, P, h_kv, page, row_bytes);
                         // dense: P = b, page = s_max
  float* dsc[2];         // their scales (L, P, h_kv, 1, page), or null
  const char* src[2];    // new rows: element (l, b, t, h, e) at
                         // ((l, b, t, h) . st + e) elements
  const float* ssc[2];   // kCopy's new scales (b, h_kv, n), or null
  const int* pos;        // (b,) first slot per row, or null: pos0 for all
  const int* pt;         // (b, n_pages) page table, or null (dense)
  long long st[2][4];    // input strides (layer, row, token, head),
                         // elements (kCopy: bytes)
  int nl, layer0, b, n, h_kv, pos0, cap, pool, page, n_pages, row_bytes;
};

template <int KIND>
struct Quant;
template <>
struct Quant<kInt8> { static constexpr float qmax = 127.f; };
template <>
struct Quant<kFp8> { static constexpr float qmax = 448.f; };
template <>
struct Quant<kInt4> { static constexpr float qmax = 7.f; };

// The row index (in the values, row_bytes each, and in the scales) of
// logical slot `slot` of batch row ib, or -1 when the slot is outside
// [0, capacity) and nothing is written.
__device__ __forceinline__ long long slot_row(const Params& p, int li, int ib,
                                              int hh, int slot) {
  if (slot < 0 || slot >= p.cap) return -1;
  int pg = ib, off = slot;
  if (p.pt != nullptr) {
    pg = min(max(p.pt[(long long)ib * p.n_pages + slot / p.page], 0),
             p.pool - 1);
    off = slot % p.page;
  }
  return (((long long)(p.layer0 + li) * p.pool + pg) * p.h_kv + hh) *
             p.page + off;
}

// One bf16 row (kLaneVals values a lane in `raw`) quantized to KIND and
// stored at row `drow` of tensor t, with its scale.
template <int KIND>
__device__ __forceinline__ void store_row(const Params& p, int t,
                                          long long drow, LaneRaw raw,
                                          int lane) {
  char* dst = p.dst[t] + drow * p.row_bytes;
  if constexpr (KIND == kBf16) {
    reinterpret_cast<LaneRaw*>(dst)[lane] = raw;
  } else {
    constexpr float qmax = Quant<KIND>::qmax;
    const __nv_bfloat162* pair =
        reinterpret_cast<const __nv_bfloat162*>(&raw);
    float x[kLaneVals];
#pragma unroll
    for (int i = 0; i < kLaneVals / 2; ++i) {
      const float2 f = __bfloat1622float2(pair[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < kLaneVals; ++i) m = fmaxf(m, fabsf(x[i]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float scale = __fdiv_rn(fmaxf(m, 1e-6f), qmax);
    float q[kLaneVals];
#pragma unroll
    for (int i = 0; i < kLaneVals; ++i) {
      q[i] = __fdiv_rn(x[i], scale);
      if constexpr (KIND != kFp8) q[i] = rintf(q[i]);
      q[i] = fminf(fmaxf(q[i], -qmax), qmax);
    }
    using Word = Bits<kLaneVals>::T;      // a lane's int8 / fp8 bytes
    using Half = Bits<kLaneVals / 2>::T;  // ... its int4 bytes
    if constexpr (KIND == kInt8) {
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < kLaneVals; ++i)
        word |= (uint32_t)(uint8_t)(int8_t)q[i] << (8 * i);
      reinterpret_cast<Word*>(dst)[lane] = (Word)word;
    } else if constexpr (KIND == kFp8) {
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < kLaneVals; ++i)
        word |= (uint32_t)__nv_cvt_float_to_fp8(q[i], __NV_SATFINITE,
                                                __NV_E4M3)
                << (8 * i);
      reinterpret_cast<Word*>(dst)[lane] = (Word)word;
    } else {  // kInt4
      uint32_t half = 0;
#pragma unroll
      for (int i = 0; i < kLaneVals; ++i)
        half |= ((uint32_t)(int)q[i] & 0xFu) << (4 * i);
      reinterpret_cast<Half*>(dst)[lane] = (Half)half;
    }
    if (lane == 0) p.dsc[t][drow] = scale;
  }
}

template <int KIND>
__global__ void __launch_bounds__(kWarps * 32) append_rows(const Params p) {
  const int lane = threadIdx.x & 31;
  const int groups = (p.n + kRows - 1) / kRows;
  long long w = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int it0 = (int)(w % groups) * kRows;
  w /= groups;
  const int hh = (int)(w % p.h_kv);
  w /= p.h_kv;
  const int ib = (int)(w % p.b);
  w /= p.b;
  const int li = (int)(w % p.nl);
  const int t = (int)(w / p.nl);  // 0: K, 1: V
  if (t > 1) return;
  const int rows = min(kRows, p.n - it0);
  const long long* st = p.st[t];
  const long long se = li * st[0] + ib * st[1] + it0 * st[2] + hh * st[3];
  if constexpr (KIND == kCopy) {
    // the warp's rows as one run of 16-byte chunks over its lanes
    const int first = (p.pos != nullptr ? p.pos[ib] : p.pos0) + it0;
    const int chunks = p.row_bytes / 16;
    for (int i = lane; i < rows * chunks; i += 32) {
      const int r = i / chunks, c = i % chunks;
      const long long drow = slot_row(p, li, ib, hh, first + r);
      if (drow < 0) continue;
      reinterpret_cast<uint4*>(p.dst[t] + drow * p.row_bytes)[c] =
          reinterpret_cast<const uint4*>(p.src[t] + se + r * st[2])[c];
      if (c == 0 && p.dsc[t] != nullptr)
        p.dsc[t][drow] =
            p.ssc[t][((long long)ib * p.h_kv + hh) * p.n + it0 + r];
    }
  } else {
    // the rows' loads first: they wait on no slot lookup
    const LaneRaw* src = reinterpret_cast<const LaneRaw*>(
        reinterpret_cast<const __nv_bfloat16*>(p.src[t]) + se);
    LaneRaw raw[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows) raw[r] = src[r * st[2] / kLaneVals + lane];
    const int first = (p.pos != nullptr ? p.pos[ib] : p.pos0) + it0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows) break;
      const long long drow = slot_row(p, li, ib, hh, first + r);
      if (drow >= 0) store_row<KIND>(p, t, drow, raw[r], lane);
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

// a: the int64 argument array (the Arg slots). Returns
// cudaGetLastError() after the launch.
extern "C" int lca_cache_append(const long long* a, void* stream) {
  Params p;
  for (int t = 0; t < 2; ++t) {
    p.dst[t] = reinterpret_cast<char*>(a[aDst + t]);
    p.dsc[t] = reinterpret_cast<float*>(a[aDsc + t]);
    p.src[t] = reinterpret_cast<const char*>(a[aSrc + t]);
    p.ssc[t] = reinterpret_cast<const float*>(a[aSsc + t]);
    for (int j = 0; j < 4; ++j) p.st[t][j] = a[aSt + 4 * t + j];
  }
  p.pos = reinterpret_cast<const int*>(a[aPos]);
  p.pt = reinterpret_cast<const int*>(a[aPt]);
  p.nl = (int)a[aNl];
  p.layer0 = (int)a[aLayer0];
  p.b = (int)a[aB];
  p.n = (int)a[aN];
  p.h_kv = (int)a[aHkv];
  p.pos0 = (int)a[aPos0];
  p.cap = (int)a[aCap];
  p.pool = (int)a[aPool];
  p.page = (int)a[aPage];
  p.n_pages = (int)a[aNPages];
  p.row_bytes = (int)a[aRowBytes];
  const long long items =
      2LL * p.nl * p.b * ((p.n + kRows - 1) / kRows) * p.h_kv;
  if (items == 0) return 0;
  const unsigned blocks = (unsigned)((items + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((int)a[aKind]) {
    case kCopy: append_rows<kCopy><<<blocks, kWarps * 32, 0, s>>>(p); break;
    case kBf16: append_rows<kBf16><<<blocks, kWarps * 32, 0, s>>>(p); break;
    case kInt8: append_rows<kInt8><<<blocks, kWarps * 32, 0, s>>>(p); break;
    case kFp8: append_rows<kFp8><<<blocks, kWarps * 32, 0, s>>>(p); break;
    case kInt4: append_rows<kInt4><<<blocks, kWarps * 32, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// An empty kernel of `blocks` blocks of 256 threads: the launch floor a
// kernel of this size is held against (no count, no work).
extern "C" int lca_empty_launch(int blocks, void* stream) {
  empty_kernel<<<blocks, kWarps * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* lca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
