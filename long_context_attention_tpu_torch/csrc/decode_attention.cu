// Decode attention for Hopper (sm_90a): one query token per row against the
// layered KV cache, up to per-row lengths.
//
// Replaces the TPU kernel long_context_attention_tpu/ops/decode.py
// _decode_kernel (wrapper decode_attention), for the dense layered cache with
// a bf16 cache or an int8 cache on the s8 x s8 path (mxu_int8), with an
// optional sliding window, StreamingLLM sinks and logit softcap.
//
// What bounds it on an H100: memory. Every visible cache byte is read
// once: 2*b*h_kv*n*d values plus 8*b*h_kv*n scale bytes for int8, where n
// is a row's visible columns (its length, or its sinks plus its window
// band), against 3.35 TB/s; the arithmetic is a few operations per byte.
//
// The kv walk takes a row's live tiles only, each once: the sink tiles
// that lie before the window's band, then the band from the tile of column
// len - 1 - left to that of len - 1 (the TPU's banded grid, decode.py
// :353-373, with its double-count guards). Tiles outside it are never read,
// nor are a sink tile's columns past the sinks or the band's first tile's
// columns left of the window.
//
// Design: one 256-thread block per (kv split, kv head, batch row). All g
// query heads of the group share the kv head's stream. The kv range is cut
// into `bkv`-column tiles, and a split owns a contiguous run of them, so
// b*h_kv*splits blocks fill the 132 SMs where b*h_kv alone would not; the
// wrapper merges the splits' (out, lse) partials. Inside a tile:
//   1. scores: 8 (int8) or 16 (bf16) lanes share one cache row with 16-byte
//      loads (a warp reads 4 or 2 whole rows), dp4a or fp32 FMA, and a
//      shuffle reduction; the tile's scores land in shared memory;
//   2. softmax over the tile: p = exp2(min(s, 90)) (fast) or the online
//      exp form (safe), l += rowsum(p); int8: p *= v_scale, then the tile's
//      per-row requantization ps = max(rowmax, 1e-20)/127, p8 = rint(p/ps);
//   3. PV: warp w takes columns w, w+8, ...; lane owns 4 output features
//      (a warp reads one 128-byte int8 row or 256-byte bf16 row); int32
//      (int8) or fp32 (bf16) partials are reduced across warps in shared
//      memory and added to the fp32 accumulator, int8 as int32 * ps.
// Columns left of the window and not sinks score -inf (p = 0) inside a live
// tile; softcap (s = cap * tanh(s / cap)) runs before the mask, and the
// wrapper then takes the online form.
// With more than one split, a second small kernel merges the splits'
// partials (the -inf-safe LSE merge of ops/merge.py merge_partials), in the
// same entry point. Because the int8 P quantization is per tile, `bkv` is part of the
// semantics and the plain version takes the same value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int MAXG = 8;
constexpr int UNROLL = 4;
constexpr float kClamp = 90.f;
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;       // (b, h_kv, G, D) int8 or bf16
  const float* qs;     // (b, h_kv, G) int8 row scales (scale folded in)
  const void* k;       // (L, b, h_kv, s_max, D) int8 or bf16
  const void* v;
  const float* ks;     // (L, b, h_kv, 1, s_max) fp32, int8 only
  const float* vs;
  const int* lengths;  // (b,)
  float* out;          // (b, splits, h_kv, G, D) fp32 partials
  float* lse;          // (b, splits, h_kv, G)
  int b, h_kv, G, s_max, layer, bkv, splits, tiles_per_split;
  int left;            // window: columns >= len - 1 - left (-1: all)
  int sink;            // columns < sink stay visible (left >= 0)
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

template <bool INT8, bool SAFE>
__global__ void __launch_bounds__(NT) decode_kernel(const Params p) {
  constexpr int EB = INT8 ? 1 : 2;       // bytes per cache element
  constexpr int CH = D * EB / 16;        // lanes per cache row (scores)
  constexpr int RPI = NT / CH;           // cache rows per block pass
  extern __shared__ __align__(16) float smem[];
  const int G = p.G;
  float* sP = smem;                      // [G][bkv] scores, then p
  float* sPart = sP + G * p.bkv;         // [NW][G][D] PV partials
  float* sAcc = sPart + NW * G * D;      // [G][D] fp32 accumulator
  float* sRed = sAcc + G * D;            // [NW][MAXG] reduction scratch
  float* sM = sRed + NW * MAXG;          // running max (safe)
  float* sL = sM + MAXG;                 // running sum
  float* sAl = sL + MAXG;                // this tile's rescale (safe)
  float* sPs = sAl + MAXG;               // this tile's P scale (int8)
  float* sT = sPs + MAXG;                // tile reduction results

  const int sp = blockIdx.x, hk = blockIdx.y, ib = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = p.lengths[ib];
  const long long slab = ((long long)p.layer * p.b + ib) * p.h_kv + hk;
  const char* kbase =
      static_cast<const char*>(p.k) + slab * (long long)p.s_max * D * EB;
  const char* vbase =
      static_cast<const char*>(p.v) + slab * (long long)p.s_max * D * EB;
  const float* ksb = INT8 ? p.ks + slab * p.s_max : nullptr;
  const float* vsb = INT8 ? p.vs + slab * p.s_max : nullptr;
  const long long qrow0 = ((long long)ib * p.h_kv + hk) * G;

  for (int i = tid; i < G * D; i += NT) sAcc[i] = 0.f;
  if (tid < MAXG) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  // this thread's 16-byte slice of every query row
  const int ch = tid % CH;
  const int rsub = tid / CH;
  Pack16 qreg[MAXG];
#pragma unroll
  for (int r = 0; r < MAXG; ++r) {
    qreg[r].u = make_uint4(0, 0, 0, 0);
    if (r < G)
      qreg[r].u = *reinterpret_cast<const uint4*>(
          static_cast<const char*>(p.q) + ((qrow0 + r) * D) * EB + ch * 16);
  }
  float qscale[MAXG];
#pragma unroll
  for (int r = 0; r < MAXG; ++r)
    qscale[r] = (INT8 && r < G) ? p.qs[qrow0 + r] : 0.f;
  __syncthreads();

  // the row's live tiles, each once: the sink tiles before the window's
  // band, then the band [start_t, last_t]; a split takes a run of them
  const int nk = (p.s_max + p.bkv - 1) / p.bkv;
  const int last_t = len > 0 ? min((len - 1) / p.bkv, nk - 1) : -1;
  const int first_col = p.left >= 0 ? max(len - 1 - p.left, 0) : 0;
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
    // only a tile that holds both sinks and the window's start has columns
    // to mask: those between the last sink and the window
    const bool gap = max(p.sink, c0 + lo) < min(first_col, c0 + hi);

    // 1. scores
    for (int j0 = lo; j0 < hi; j0 += RPI * UNROLL) {
      Pack16 kr[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * RPI + rsub;
        kr[u].u = make_uint4(0, 0, 0, 0);
        if (j < hi)
          kr[u].u = *reinterpret_cast<const uint4*>(
              kbase + (long long)(c0 + j) * D * EB + ch * 16);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * RPI + rsub;
#pragma unroll
        for (int r = 0; r < MAXG; ++r) {
          if (r >= G) break;
          float s;
          if (INT8) {
            int acc = 0;
#pragma unroll
            for (int w = 0; w < 4; ++w)
              acc = __dp4a(kr[u].i[w], qreg[r].i[w], acc);
#pragma unroll
            for (int off = CH / 2; off > 0; off >>= 1)
              acc += __shfl_xor_sync(0xffffffffu, acc, off);
            s = (float)acc * qscale[r];
            if (j < hi) s *= ksb[c0 + j];
          } else {
            float acc = 0.f;
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const unsigned kw = (unsigned)kr[u].i[w];
              const unsigned qw = (unsigned)qreg[r].i[w];
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
          if (gap && col < first_col && col >= p.sink) s = kNegInf;
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
          if (INT8) {
            pv *= vsb[c0 + j];
            bmax[r] = fmaxf(bmax[r], pv);
          } else {
            pv = __bfloat162float(__float2bfloat16_rn(pv));
          }
          sP[r * p.bkv + j] = pv;
        }
      }
    }
    block_reduce<false>(a, G, sRed, sT);
    if (tid < G) sL[tid] = SAFE ? sL[tid] * sAl[tid] + sT[tid] : sL[tid] + sT[tid];
    if (INT8) {
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
          const char* row = vbase + (long long)(c0 + j) * D * EB;
          if (INT8)
            vw[u].x = *reinterpret_cast<const unsigned*>(row + lane * 4);
          else
            vw[u] = *reinterpret_cast<const uint2*>(row + lane * 8);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * NW;
        if (j >= hi) break;
        float ve[4];
        int vi[4];
        if (INT8) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            vi[e] = (int)(int8_t)((vw[u].x >> (8 * e)) & 0xff);
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
          if (INT8) {
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
            INT8 ? __int_as_float(iacc[r][e]) : facc[r][e];
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += NT) {
      const int r = i / D;
      float pv;
      if (INT8) {
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
  const long long obase = (((long long)ib * p.splits + sp) * p.h_kv + hk) * G;
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

template <bool INT8, bool SAFE>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kern = decode_kernel<INT8, SAFE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.splits, p.h_kv, p.b);
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

// dims: b, h_kv, G, s_max, layer, bkv, splits, tiles_per_split, left, sink.
// A split takes tiles_per_split of a row's live tiles.
// out (b, h_kv, G, D) and lse (b, h_kv, G) fp32; with splits > 1 the
// partials go to part_out (b, splits, h_kv, G, D) / part_lse first.
extern "C" int lca_decode_attention(const void* q, const float* qs,
                                    const void* k, const void* v,
                                    const float* ks, const float* vs,
                                    const int* lengths, float* part_out,
                                    float* part_lse, float* out, float* lse,
                                    const long long* dims, float sscale,
                                    float cap, int safe, void* stream) {
  Params p;
  p.q = q;
  p.qs = qs;
  p.k = k;
  p.v = v;
  p.ks = ks;
  p.vs = vs;
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
  p.sscale = sscale;
  p.cap = cap;
  if (p.G < 1 || p.G > MAXG) return (int)cudaErrorInvalidValue;
  const bool merge = p.splits > 1;
  if (merge && (part_out == nullptr || part_lse == nullptr))
    return (int)cudaErrorInvalidValue;
  p.out = merge ? part_out : out;
  p.lse = merge ? part_lse : lse;
  const size_t smem = smem_bytes(p.G, p.bkv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool int8 = ks != nullptr;
  int err;
  if (int8)
    err = safe ? launch<true, true>(p, smem, st)
               : launch<true, false>(p, smem, st);
  else
    err = safe ? launch<false, true>(p, smem, st)
               : launch<false, false>(p, smem, st);
  if (err != 0 || !merge) return err;
  merge_kernel<<<dim3(p.h_kv, p.b), D, 0, st>>>(part_out, part_lse, out, lse,
                                                p.h_kv, p.G, p.splits);
  return (int)cudaGetLastError();
}

extern "C" const char* lca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
