// Decode attention for Hopper (sm_90a): a run of n_tok query tokens per row
// (1 in the decode step, more in a teacher-forced run) against the layered
// KV cache, dense or paged, up to per-row lengths.
//
// Replaces the TPU kernel long_context_attention_tpu/ops/decode.py
// _decode_kernel (wrapper decode_attention), on its three paths: a bf16
// cache; the s8 x s8 path (mxu_int8) over an int8 or int4 cache; and the
// dequant-cast path over an int8, fp8 (e4m3) or int4 cache (template
// parameter KIND); with an optional sliding window, StreamingLLM sinks,
// logit softcap and ALiBi. `lengths` counts every visible slot
// including the run: token i of a run sits at position len - n_tok + i and
// sees the columns up to it (and its own window), so each query row has its
// own causal and window bounds, in logical positions.
//
// Paged cache: the cache arrays are a pool (L, P, h_kv, page, D) and row b's
// logical column c lives in pool page page_table[b, c / page] at offset
// c % page. The tile divides the page, so a tile never crosses a page: only
// the tile's base address changes, and the walk (logical tiles) and the
// masks are those of the dense cache. Entries past a row's live prefix are
// never read (the walk stops at its last live tile).
//
// What bounds it on an H100: for one token, memory. Every visible cache
// byte is read once: 2*b*h_kv*n*d values (2, 1 or 1/2 bytes each: bf16,
// int8 or fp8, int4) plus 8*b*h_kv*n scale bytes when quantized, where n
// is a row's visible columns (its length, or its sinks plus
// its window band), against 3.35 TB/s; the arithmetic is a few operations
// per byte. The wrapper (ops/decode.py decode_route) sends this kernel the
// calls whose query rows per kv head fit one group of MAXG (one token at
// the model's g = 2, runs of up to 4 tokens) and those whose tile is not a
// multiple of 128 dividing the slot axis; the runs of more rows take
// decode_run_sm90.cu, on the tensor cores.
//
// The kv walk takes a row's live tiles only, each once: the sink tiles
// that lie before the window's band, then the band from the tile of column
// len - 1 - left to that of len - 1 (the TPU's banded grid, decode.py
// :353-373, with its double-count guards). Tiles outside it are never read,
// nor are a sink tile's columns past the sinks or the band's first tile's
// columns left of the window.
//
// Design: one 256-thread block per (kv split, kv head and group of at most
// MAXG query rows, batch row). The query rows of a kv head (its g heads
// times the run's n_tok tokens, ordered (head, token)) fall into groups of
// MAXG; each group streams the kv head's tiles on its own (for the calls
// routed here, one group or a few). The kv range is cut
// into `bkv`-column tiles, and a split owns a contiguous run of them, so
// b*h_kv*splits blocks fill the 132 SMs where b*h_kv alone would not; the
// wrapper merges the splits' (out, lse) partials. Inside a tile:
//   1. scores: 16 lanes (bf16) or 8 (the other kinds) share one cache row,
//      each with 16 bytes of it (8 of an int4 row), so a lane always holds
//      8 or 16 of the row's d values; dp4a (s8: int4 nibbles sign-extended
//      to s8 words first) or fp32 FMA (bf16, and the cast path's values
//      widened exactly against bf16 q), and a shuffle reduction; then the
//      scales (s8: q's row scale, cast and safe bf16: the softmax scale;
//      quantized: k_scale[col]), the softcap, ALiBi's -slope * (q - col)
//      and the masks; the tile's scores land in shared memory;
//   2. softmax over the tile: p = exp2(min(s, 90)) (fast) or the online
//      exp form (safe), l += rowsum(p); quantized: p *= v_scale; s8: the
//      tile's per-row requantization ps = max(rowmax, 1e-20)/127, p8 =
//      rint(p/ps); bf16 and cast: p rounded to bf16;
//   3. PV: warp w takes columns w, w+8, ...; lane owns 4 output features
//      (a warp reads one whole V row); int32 (s8) or fp32 partials are
//      reduced across warps in shared memory and added to the fp32
//      accumulator, s8 as int32 * ps.
// Columns left of the window and not sinks score -inf (p = 0) inside a live
// tile; softcap (s = cap * tanh(s / cap)) runs before the mask, and the
// wrapper then takes the online form.
// With more than one split, a second small kernel merges the splits'
// partials (the -inf-safe LSE merge of ops/merge.py merge_partials), in the
// same entry point. Because the s8 path's P quantization is per tile, `bkv`
// is part of the semantics and the plain version takes the same value. The
// wrapper picks the split count, or takes the caller's (kv_splits, JAX's
// flash-decoding splits).

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_quant.cuh"

namespace {

constexpr int D = 128;
constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int MAXG = 8;
constexpr int UNROLL = 4;
constexpr float kClamp = 90.f;
constexpr float kNegInf = -1e30f;

// kinds of K/V (ops/decode.py _KIND_*): the bf16 path; the s8 path over
// int8 or int4; the dequant-cast path over int8, fp8 e4m3 or int4
constexpr int kBF16 = 0, kS8I8 = 1, kS8I4 = 2, kCastI8 = 3, kCastF8 = 4,
              kCastI4 = 5;

template <int KIND>
struct Kind {
  static constexpr bool S8 = KIND == kS8I8 || KIND == kS8I4;
  static constexpr bool CAST = KIND >= kCastI8;
  static constexpr bool QUANT = S8 || CAST;
  static constexpr bool I4 = KIND == kS8I4 || KIND == kCastI4;
  // bytes of a cache row, lanes sharing a row in the scores, bytes a lane
  // loads of it, q bytes per element and 16-byte q words a lane holds
  static constexpr int ROW = KIND == kBF16 ? 2 * D : (I4 ? D / 2 : D);
  static constexpr int CH = KIND == kBF16 ? 16 : 8;
  static constexpr int LB = ROW / CH;
  static constexpr int QEB = S8 ? 1 : 2;
  static constexpr int QP = CAST ? 2 : 1;
};

struct Params {
  const void* q;       // (b, h_kv, G, D) int8 (s8) or bf16
  const float* qs;     // (b, h_kv, G) s8 row scales (scale folded in)
  const void* k;       // (L, P, h_kv, page, row) (dense: P = b, page =
  const void* v;       //   s_max); row: D values of KIND
  const float* ks;     // (L, P, h_kv, 1, page) fp32, quantized kinds only
  const float* vs;
  const float* slopes; // (h_kv, G) ALiBi row slopes, or null
  const int* lengths;  // (b,)
  const int* pt;       // (b, n_pages) page table, or null (dense)
  float* out;          // (b, splits, h_kv, G, D) fp32 partials
  float* lse;          // (b, splits, h_kv, G)
  int b, h_kv, G, s_max, layer, bkv, splits, tiles_per_split;
  int left;            // window: a row at q sees columns >= q - left (-1: all)
  int sink;            // columns < sink stay visible (left >= 0)
  int n_tok;           // tokens of the run; row r is token r % n_tok
  int n_groups;        // groups of MAXG query rows per kv head
  int pool, page, n_pages;
  float sscale;        // safe bf16 form: score scale
  float cap;           // softcap (0: none)
};

// 16 bytes seen as 4 words (4 int8 or 2 bf16 values each)
union Pack16 {
  uint4 u;
  int i[4];
};

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// the cast path's 4 values in w (4 bytes of int8 or fp8, or the low 16
// bits of int4 nibbles), widened exactly to float
template <int KIND>
__device__ __forceinline__ void widen4(unsigned w, float (&x)[4]) {
  if constexpr (KIND == kCastF8) {
    const float2 a = e4m3x2_to_float2(w & 0xffffu);
    const float2 b = e4m3x2_to_float2(w >> 16);
    x[0] = a.x;
    x[1] = a.y;
    x[2] = b.x;
    x[3] = b.y;
  } else {
    if constexpr (KIND == kCastI4) w = s4x4_to_s8(w);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = (float)(int8_t)((w >> (8 * e)) & 0xff);
  }
}

// Reduce vals[0..G) over the block; results land in out[0..G) (shared).
template <bool MAX>
__device__ void block_reduce(float (&vals)[MAXG], int G, float* red,
                             float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < MAXG; ++r) {
    if (r < G) {
      float v = vals[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, v, off);
        v = MAX ? fmaxf(v, o) : v + o;
      }
      if (lane == 0) red[warp * MAXG + r] = v;
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < G) {
    float v = red[threadIdx.x];
    for (int w = 1; w < NW; ++w) {
      const float o = red[w * MAXG + threadIdx.x];
      v = MAX ? fmaxf(v, o) : v + o;
    }
    out[threadIdx.x] = v;
  }
  __syncthreads();
}

// ALIBI: p.slopes is set (an instantiation of its own, so the kinds
// without it keep their score loop)
template <int KIND, bool SAFE, bool ALIBI>
__global__ void __launch_bounds__(NT) decode_kernel(const Params p) {
  using K = Kind<KIND>;
  constexpr bool S8 = K::S8, QUANT = K::QUANT;
  constexpr int CH = K::CH;              // lanes per cache row (scores)
  constexpr int RPI = NT / CH;           // cache rows per block pass
  constexpr int QP = K::QP;
  extern __shared__ __align__(16) float smem[];
  const int sp = blockIdx.x, ib = blockIdx.z;
  const int hk = blockIdx.y / p.n_groups;
  const int r0 = (blockIdx.y % p.n_groups) * MAXG;  // the group's first row
  const int G = min(MAXG, p.G - r0);                // its rows
  float* sP = smem;                      // [G][bkv] scores, then p
  float* sPart = sP + G * p.bkv;         // [NW][G][D] PV partials
  float* sAcc = sPart + NW * G * D;      // [G][D] fp32 accumulator
  float* sRed = sAcc + G * D;            // [NW][MAXG] reduction scratch
  float* sM = sRed + NW * MAXG;          // running max (safe)
  float* sL = sM + MAXG;                 // running sum
  float* sAl = sL + MAXG;                // this tile's rescale (safe)
  float* sPs = sAl + MAXG;               // this tile's P scale (s8)
  float* sT = sPs + MAXG;                // tile reduction results

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = p.lengths[ib];
  const long long qrow0 = ((long long)ib * p.h_kv + hk) * p.G + r0;
  // each row's bounds: columns <= qlim[r], and >= wlo[r] unless a sink
  int qlim[MAXG], wlo[MAXG];
#pragma unroll
  for (int r = 0; r < MAXG; ++r) {
    qlim[r] = len - p.n_tok + (r0 + r) % p.n_tok;
    wlo[r] = p.left >= 0 ? qlim[r] - p.left : INT_MIN;
  }

  for (int i = tid; i < G * D; i += NT) sAcc[i] = 0.f;
  if (tid < MAXG) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  // this thread's slice of every query row: the d values its lane's cache
  // bytes hold (16 bytes of q; 32 of bf16 q on the cast path)
  const int ch = tid % CH;
  const int rsub = tid / CH;
  Pack16 qreg[MAXG][QP];
#pragma unroll
  for (int r = 0; r < MAXG; ++r)
#pragma unroll
    for (int c = 0; c < QP; ++c) {
      qreg[r][c].u = make_uint4(0, 0, 0, 0);
      if (r < G)
        qreg[r][c].u = *reinterpret_cast<const uint4*>(
            static_cast<const char*>(p.q) + ((qrow0 + r) * D) * K::QEB +
            (ch * QP + c) * 16);
    }
  float qscale[MAXG], slope[MAXG];
#pragma unroll
  for (int r = 0; r < MAXG; ++r) {
    qscale[r] = (S8 && r < G) ? p.qs[qrow0 + r] : 0.f;
    slope[r] = (ALIBI && r < G)
                   ? p.slopes[(long long)hk * p.G + r0 + r]
                   : 0.f;
  }
  __syncthreads();

  // the row's live tiles, each once: the sink tiles before the window's
  // band, then the band [start_t, last_t] from the run's first token's
  // window to its last token; a split takes a run of them
  const int nk = (p.s_max + p.bkv - 1) / p.bkv;
  const int last_t = len > 0 ? min((len - 1) / p.bkv, nk - 1) : -1;
  const int first_col = p.left >= 0 ? max(len - p.n_tok - p.left, 0) : 0;
  const int start_t = first_col / p.bkv;
  const int n_sink =
      p.left >= 0 ? min(min((p.sink + p.bkv - 1) / p.bkv, start_t), last_t + 1)
                  : 0;
  const int n_live = n_sink + max(last_t - start_t + 1, 0);
  const int i0 = sp * p.tiles_per_split;
  const int i1 = min(n_live, i0 + p.tiles_per_split);
  for (int it = i0; it < i1; ++it) {
    const bool sink_tile = it < n_sink;
    const int c0 = (sink_tile ? it : start_t + (it - n_sink)) * p.bkv;
    // the tile's columns to read, [c0 + lo, c0 + hi), all <= len - 1: a
    // sink tile ends at the last sink, the band's first tile starts at the
    // window's first column (or at 0 where it holds sinks)
    const int hi = min(p.bkv, (sink_tile ? min(p.sink, len) : len) - c0);
    const int lo = c0 < p.sink ? 0 : max(first_col - c0, 0);
    // the tile's storage: its pool page (paged) or the row's slab (dense)
    int pg = ib, off = c0;
    if (p.pt != nullptr) {
      pg = min(max(p.pt[(long long)ib * p.n_pages + c0 / p.page], 0),
               p.pool - 1);
      off = c0 % p.page;
    }
    const long long slab =
        ((long long)p.layer * p.pool + pg) * p.h_kv + hk;
    const long long base = slab * p.page + off;  // the tile's first slot
    const char* kt = static_cast<const char*>(p.k) + base * K::ROW;
    const char* vt = static_cast<const char*>(p.v) + base * K::ROW;
    const float* kst = QUANT ? p.ks + base : nullptr;
    const float* vst = QUANT ? p.vs + base : nullptr;

    // 1. scores
    for (int j0 = lo; j0 < hi; j0 += RPI * UNROLL) {
      Pack16 kr[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * RPI + rsub;
        kr[u].u = make_uint4(0, 0, 0, 0);
        if (j < hi) {
          const char* src = kt + (long long)j * K::ROW + ch * K::LB;
          if constexpr (K::LB == 16) {
            kr[u].u = *reinterpret_cast<const uint4*>(src);
          } else {
            const uint2 w = *reinterpret_cast<const uint2*>(src);
            kr[u].u.x = w.x;
            kr[u].u.y = w.y;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * RPI + rsub;
        // int4 on the s8 path: the lane's 16 nibbles as 4 s8 words
        Pack16 k8 = kr[u];
        if constexpr (KIND == kS8I4) {
          s4x8_to_s8(kr[u].u.x, k8.u.x, k8.u.y);
          s4x8_to_s8(kr[u].u.y, k8.u.z, k8.u.w);
        }
        // the cast path: the lane's 16 values widened
        float kf[K::CAST ? 16 : 1];
        if constexpr (K::CAST) {
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            float x[4];
            if constexpr (KIND == kCastI4)
              widen4<KIND>(kr[u].i[w / 2] >> (16 * (w & 1)), x);
            else
              widen4<KIND>((unsigned)kr[u].i[w], x);
#pragma unroll
            for (int e = 0; e < 4; ++e) kf[4 * w + e] = x[e];
          }
        }
#pragma unroll
        for (int r = 0; r < MAXG; ++r) {
          if (r >= G) break;
          float s;
          if constexpr (S8) {
            int acc = 0;
#pragma unroll
            for (int w = 0; w < 4; ++w)
              acc = __dp4a(k8.i[w], qreg[r][0].i[w], acc);
#pragma unroll
            for (int off = CH / 2; off > 0; off >>= 1)
              acc += __shfl_xor_sync(0xffffffffu, acc, off);
            s = (float)acc * qscale[r];
            if (j < hi) s *= kst[j];
          } else if constexpr (K::CAST) {
            float acc = 0.f;
#pragma unroll
            for (int e = 0; e < 16; e += 2) {
              const unsigned qw = (unsigned)qreg[r][e / 8].i[(e % 8) / 2];
              acc = fmaf(bf16_lo(qw), kf[e], acc);
              acc = fmaf(bf16_hi(qw), kf[e + 1], acc);
            }
#pragma unroll
            for (int off = CH / 2; off > 0; off >>= 1)
              acc += __shfl_xor_sync(0xffffffffu, acc, off);
            s = SAFE ? acc * p.sscale : acc;
            if (j < hi) s *= kst[j];
          } else {
            float acc = 0.f;
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const unsigned kw = (unsigned)kr[u].i[w];
              const unsigned qw = (unsigned)qreg[r][0].i[w];
              acc = fmaf(bf16_lo(qw), bf16_lo(kw), acc);
              acc = fmaf(bf16_hi(qw), bf16_hi(kw), acc);
            }
#pragma unroll
            for (int off = CH / 2; off > 0; off >>= 1)
              acc += __shfl_xor_sync(0xffffffffu, acc, off);
            s = SAFE ? acc * p.sscale : acc;
          }
          if (p.cap > 0.f) s = p.cap * tanhf(s / p.cap);
          const int col = c0 + j;
          // ALiBi, after the softcap: -slope * (q - col), the product
          // rounded on its own as in the plain version
          if constexpr (ALIBI)
            s = s - __fmul_rn(slope[r], (float)(qlim[r] - col));
          // per-row bounds: the run's causal limit and the row's window
          // (for one token, the masked columns are the gap between the
          // last sink and the window in the band's first tile)
          if (col > qlim[r] || (col < wlo[r] && col >= p.sink)) s = kNegInf;
          if (ch == 0 && j < hi) sP[r * p.bkv + j] = s;
        }
      }
    }
    __syncthreads();

    // 2. softmax over the tile
    float a[MAXG], bmax[MAXG];
    if (SAFE) {
#pragma unroll
      for (int r = 0; r < MAXG; ++r) {
        a[r] = kNegInf;
        if (r < G)
          for (int j = lo + tid; j < hi; j += NT)
            a[r] = fmaxf(a[r], sP[r * p.bkv + j]);
      }
      block_reduce<true>(a, G, sRed, sT);
      if (tid < G) {
        const float m_new = fmaxf(sM[tid], sT[tid]);
        sAl[tid] = expf(sM[tid] - m_new);
        sM[tid] = m_new;
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < MAXG; ++r) {
      a[r] = 0.f;
      bmax[r] = 0.f;
      if (r < G) {
        const float m = SAFE ? sM[r] : 0.f;
        for (int j = lo + tid; j < hi; j += NT) {
          const float s = sP[r * p.bkv + j];
          float pv = SAFE ? expf(s - m) : exp2f(fminf(s, kClamp));
          if (SAFE && s == kNegInf) pv = 0.f;  // masked column
          a[r] += pv;
          if (S8) {
            pv *= vst[j];
            bmax[r] = fmaxf(bmax[r], pv);
          } else {
            if (K::CAST) pv *= vst[j];
            pv = __bfloat162float(__float2bfloat16_rn(pv));
          }
          sP[r * p.bkv + j] = pv;
        }
      }
    }
    block_reduce<false>(a, G, sRed, sT);
    if (tid < G) sL[tid] = SAFE ? sL[tid] * sAl[tid] + sT[tid] : sL[tid] + sT[tid];
    if (S8) {
      __syncthreads();
      block_reduce<true>(bmax, G, sRed, sT);
      if (tid < G) sPs[tid] = fmaxf(sT[tid], 1e-20f) * (1.0f / 127.0f);
      __syncthreads();
      const int nl = hi - lo;
      for (int i = tid; i < G * nl; i += NT) {
        const int r = i / nl, j = lo + i % nl;
        sP[r * p.bkv + j] = rintf(sP[r * p.bkv + j] / sPs[r]);
      }
    }
    __syncthreads();

    // 3. PV
    float facc[MAXG][4];
    int iacc[MAXG][4];
#pragma unroll
    for (int r = 0; r < MAXG; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        facc[r][e] = 0.f;
        iacc[r][e] = 0;
      }
    for (int j0 = lo + warp; j0 < hi; j0 += NW * UNROLL) {
      uint2 vw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * NW;
        vw[u] = make_uint2(0, 0);
        if (j < hi) {
          // the lane's 4 features: 8 bytes (bf16), 4 (int8, fp8), 2 (int4)
          const char* row = vt + (long long)j * K::ROW + lane * (K::ROW / 32);
          if constexpr (KIND == kBF16)
            vw[u] = *reinterpret_cast<const uint2*>(row);
          else if constexpr (K::I4)
            vw[u].x = *reinterpret_cast<const unsigned short*>(row);
          else
            vw[u].x = *reinterpret_cast<const unsigned*>(row);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * NW;
        if (j >= hi) break;
        float ve[4];
        int vi[4];
        if constexpr (S8) {
          const unsigned w8 = KIND == kS8I4 ? s4x4_to_s8(vw[u].x) : vw[u].x;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            vi[e] = (int)(int8_t)((w8 >> (8 * e)) & 0xff);
        } else if constexpr (K::CAST) {
          widen4<KIND>(vw[u].x, ve);
        } else {
          ve[0] = bf16_lo(vw[u].x);
          ve[1] = bf16_hi(vw[u].x);
          ve[2] = bf16_lo(vw[u].y);
          ve[3] = bf16_hi(vw[u].y);
        }
#pragma unroll
        for (int r = 0; r < MAXG; ++r) {
          if (r >= G) break;
          const float pv = sP[r * p.bkv + j];
          if (S8) {
            const int p8 = (int)pv;
#pragma unroll
            for (int e = 0; e < 4; ++e) iacc[r][e] += p8 * vi[e];
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) facc[r][e] = fmaf(pv, ve[e], facc[r][e]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MAXG; ++r) {
      if (r >= G) break;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sPart[(warp * G + r) * D + lane * 4 + e] =
            S8 ? __int_as_float(iacc[r][e]) : facc[r][e];
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += NT) {
      const int r = i / D;
      float pv;
      if (S8) {
        int s = 0;
        for (int w = 0; w < NW; ++w) s += __float_as_int(sPart[w * G * D + i]);
        pv = (float)s * sPs[r];
      } else {
        pv = 0.f;
        for (int w = 0; w < NW; ++w) pv += sPart[w * G * D + i];
      }
      sAcc[i] = SAFE ? sAcc[i] * sAl[r] + pv : sAcc[i] + pv;
    }
    __syncthreads();
  }

  // emit this split's partial: out = acc / l (0 on a dead row), lse
  const long long obase =
      (((long long)ib * p.splits + sp) * p.h_kv + hk) * p.G + r0;
  for (int i = tid; i < G * D; i += NT) {
    const float l = sL[i / D];
    p.out[obase * D + i] = l == 0.f ? 0.f : sAcc[i] / l;
  }
  if (tid < G) {
    const float l = sL[tid];
    const float v = SAFE ? sM[tid] + logf(l) : logf(l);
    p.lse[obase + tid] = l == 0.f ? __int_as_float(0xff800000) : v;  // -inf
  }
}

// One block per (kv head, batch row), one thread per output feature: the
// -inf-safe N-way LSE merge of the splits (ops/merge.py merge_partials).
__global__ void __launch_bounds__(D)
    merge_kernel(const float* part_out, const float* part_lse, float* out,
                 float* lse, int h_kv, int G, int splits) {
  const int hk = blockIdx.x, ib = blockIdx.y, tid = threadIdx.x;
  const float neg_inf = __int_as_float(0xff800000);
  for (int r = 0; r < G; ++r) {
    float m = neg_inf;
    for (int s = 0; s < splits; ++s)
      m = fmaxf(m, part_lse[(((long long)ib * splits + s) * h_kv + hk) * G + r]);
    const bool dead = m == neg_inf;
    const float safe_m = dead ? 0.f : m;
    float denom = 0.f, acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const long long cell = (((long long)ib * splits + s) * h_kv + hk) * G + r;
      const float l = part_lse[cell];
      const float w = l == neg_inf ? 0.f : expf(l - safe_m);
      denom += w;
      acc += part_out[cell * D + tid] * w;
    }
    const long long o = ((long long)ib * h_kv + hk) * G + r;
    const float dn = fmaxf(denom, 1e-37f);
    out[o * D + tid] = dead ? 0.f : acc / dn;
    if (tid == 0) lse[o] = dead ? neg_inf : safe_m + logf(dn);
  }
}

template <int KIND, bool SAFE, bool ALIBI>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kern = decode_kernel<KIND, SAFE, ALIBI>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.splits, p.h_kv * p.n_groups, p.b);
  kern<<<grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Shared memory of decode_kernel: the tile's scores/p, the per-warp PV
// partials, the accumulator, the reduction scratch and the row statistics.
// A request above the card's opt-in limit fails in cudaFuncSetAttribute,
// and launch() returns that error to the caller.
size_t smem_bytes(int G, int bkv) {
  return sizeof(float) *
         ((size_t)G * bkv + (size_t)NW * G * D + (size_t)G * D +
          (size_t)NW * MAXG + 5 * MAXG);
}

}  // namespace

// dims: b, h_kv, G, s_max, layer, bkv, splits, tiles_per_split, left, sink,
// n_tok, pool, page, n_pages, kind (KIND: 0 bf16, 1 s8 int8, 2 s8 int4, 3
// cast int8, 4 cast fp8, 5 cast int4). s_max is a row's logical capacity
// (n_pages * page when paged); dense: pt null, pool = b, page = s_max,
// n_pages = 1.
// G = g * n_tok query rows per kv head, ordered (head, token). A split
// takes tiles_per_split of a row's live tiles.
// out (b, h_kv, G, D) and lse (b, h_kv, G) fp32; with splits > 1 the
// partials go to part_out (b, splits, h_kv, G, D) / part_lse first.
// slopes: ALiBi's (h_kv, G) row slopes (times log2e in the fast form), or
// null.
extern "C" int lca_decode_attention(const void* q, const float* qs,
                                    const void* k, const void* v,
                                    const float* ks, const float* vs,
                                    const int* lengths, const int* pt,
                                    float* part_out,
                                    float* part_lse, float* out, float* lse,
                                    const long long* dims, float sscale,
                                    float cap, int safe, void* stream,
                                    const float* slopes) {
  Params p;
  p.q = q;
  p.qs = qs;
  p.k = k;
  p.v = v;
  p.ks = ks;
  p.vs = vs;
  p.slopes = slopes;
  p.lengths = lengths;
  p.b = (int)dims[0];
  p.h_kv = (int)dims[1];
  p.G = (int)dims[2];
  p.s_max = (int)dims[3];
  p.layer = (int)dims[4];
  p.bkv = (int)dims[5];
  p.splits = (int)dims[6];
  p.tiles_per_split = (int)dims[7];
  p.left = (int)dims[8];
  p.sink = (int)dims[9];
  p.n_tok = (int)dims[10];
  p.pool = (int)dims[11];
  p.page = (int)dims[12];
  p.n_pages = (int)dims[13];
  p.pt = pt;
  p.sscale = sscale;
  p.cap = cap;
  if (p.G < 1 || p.n_tok < 1 || p.G % p.n_tok || p.bkv < 1 ||
      (pt != nullptr && p.page % p.bkv))
    return (int)cudaErrorInvalidValue;
  p.n_groups = (p.G + MAXG - 1) / MAXG;
  if ((long long)p.h_kv * p.n_groups > 65535) return (int)cudaErrorInvalidValue;
  const bool merge = p.splits > 1;
  if (merge && (part_out == nullptr || part_lse == nullptr))
    return (int)cudaErrorInvalidValue;
  p.out = merge ? part_out : out;
  p.lse = merge ? part_lse : lse;
  const size_t smem = smem_bytes(min(p.G, MAXG), p.bkv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kind = (int)dims[14];
  // scales exactly when quantized, q row scales exactly on the s8 path
  const bool s8 = kind == kS8I8 || kind == kS8I4;
  if ((kind == kBF16) != (ks == nullptr) || s8 != (qs != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool alibi = slopes != nullptr;
  int err;
  switch (kind) {
#define LCA_KIND(K)                                                   \
  case K:                                                             \
    err = safe ? (alibi ? launch<K, true, true>(p, smem, st)          \
                        : launch<K, true, false>(p, smem, st))        \
               : (alibi ? launch<K, false, true>(p, smem, st)         \
                        : launch<K, false, false>(p, smem, st));      \
    break;
    LCA_KIND(kBF16)
    LCA_KIND(kS8I8)
    LCA_KIND(kS8I4)
    LCA_KIND(kCastI8)
    LCA_KIND(kCastF8)
    LCA_KIND(kCastI4)
#undef LCA_KIND
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0 || !merge) return err;
  merge_kernel<<<dim3(p.h_kv, p.b), D, 0, st>>>(part_out, part_lse, out, lse,
                                                p.h_kv, p.G, p.splits);
  return (int)cudaGetLastError();
}

extern "C" const char* lca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
