// Decode attention for Hopper (sm_90a): one token per row, or a short run
// of tokens (at most 8 query rows per kv head in a group), against the
// layered KV cache, dense or paged, up to per-row lengths.
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
// What bounds it on an H100: memory. Every visible cache byte is read once:
// 2*b*h_kv*n*d values (2, 1 or 1/2 bytes each: bf16, int8 or fp8, int4)
// plus 8*b*h_kv*n scale bytes when quantized, where n is a row's visible
// columns (its length, or its sinks plus its window band), against 3.35
// TB/s; the arithmetic is a few operations per byte. So the design keeps
// many bytes in flight on every SM and little else in the way. The wrapper
// (ops/decode.py decode_route) sends this kernel the calls whose query rows
// per kv head fit one group of MAXG (one token at the model's g = 2, runs
// of up to 4 tokens) and those whose tile is not a multiple of 128
// dividing the slot axis; the runs of more rows take decode_run_sm90.cu.
//
// The kv walk takes a row's live tiles only, each once: the sink tiles
// that lie before the window's band, then the band from the tile of column
// len - 1 - left to that of len - 1 (the TPU's banded grid, decode.py
// :353-373, with its double-count guards). Tiles outside it are never read,
// nor are a sink tile's columns past the sinks or the band's first tile's
// columns left of the window.
//
// A sequence-sharded cache (serving/sharded.py) gives each row its slice
// of the global window instead (first_cols, sink_cols, decode.py
// :361-398): the row's first column fc, unclipped (token i's bound is
// fc + i), and the end of its sink slice. The walk then bands from
// max(fc, 0); the grid's tile slots stay sized on the host from the
// window, n_tok and the sink bound, which cover any rank's slice. A row
// whose length is 0 or less has no live tile (an empty partial), and a
// run's length past the slots keeps every column visible (the walk stops
// at the last tile).
//
// Design: the grid does not follow JAX's tile count. A JAX tile of `bkv`
// columns is cut into `cluster` spans (ops/decode.py decode_token_span:
// about 32 KB of K a span, at most 8 spans), each one 256-thread block; a
// tile's visible columns go to one span when they fit it (the other blocks
// write empty partials and leave), else evenly to all. The grid is (tile
// slots x cluster, h_kv x groups of MAXG query rows, b), a tile slot being
// the i-th live tile of a row's walk (a slot past a row's live tiles
// leaves at once); on the s8 path a tile's blocks are a thread block
// cluster. At the serving shape (b = 4, 8 kv heads, a 12288-slot int8
// cache in tiles of 2048) that is ~1100 busy blocks of 256 columns over
// the 132 SMs, four to an SM (a small ring and 46 KB of shared memory).
//   0. one thread issues the span's K and V rows (contiguous: a tile never
//      crosses a page) as 1-D bulk async copies (cp.async.bulk, no tensor
//      map) in chunks of 8 KB, each on its slot's mbarrier, through one
//      ring of RING slots: first the K chunks (at the common spans the
//      whole K span is in flight at once), then, once the scores are done,
//      the V chunks, which land while the softmax and the exchange run.
//      Only the span's visible columns are copied; the scales come by
//      4-byte cp.async, zeros outside them.
//   1. scores on the CUDA cores: LPR lanes share a cache row, 16 bytes
//      each (int4: 8), dp4a (s8: int4 nibbles sign-extended first) or fp32
//      FMA (bf16, and the cast path's values widened exactly against bf16
//      q); the GP rows' sums are reduced across the lanes by a transposing
//      butterfly that leaves each lane one row's score; then the scales,
//      softcap, ALiBi's -slope * (q - col) and the masks, into shared
//      memory;
//   2. softmax over the span. The s8 path requantizes P over the JAX tile,
//      so a cluster's spans exchange what that needs, once, through
//      distributed shared memory: each warp's (span max, max of p *
//      v_scale against it) is stored into every block of the cluster
//      (mapa, st.shared::cluster), one barrier.cluster, and each block
//      reads its own slots. The online form's m is then the tile's max (p
//      = exp(s - m), a factor common to the tile that cancels in p / ps),
//      the tile's p max the spans' rescaled to it, ps = max(pmax, 1e-20) /
//      127 and p8 = rint(p * v_scale / ps). bf16 and cast: each span's own
//      max, p * v_scale rounded to bf16, no exchange;
//   3. PV: warps take 4-column quads (s8: the quad's V bytes transposed in
//      registers and dp4a against the packed p8) or single columns (fp32
//      FMA), a lane 4 output features; the warps' partials are summed in
//      shared memory into the span's (out, lse) partial (s8: int32 * ps,
//      as the JAX kernel's per-tile product).
// A second small kernel in the same entry point merges the spans' partials
// in one pass (the -inf-safe LSE merge of ops/merge.py merge_partials).
// JAX's kv_splits, the flash-decoding split count, merges the same
// per-tile values in another fp32 order, so the grid takes no account of
// it. The s8 path's P quantization is per JAX tile, so `bkv` is part of the
// result and the plain version takes the same value.
//
// Head dim 64 (-DLCA_HEAD_DIM=64, a library of its own): the scores keep
// each lane's 16 bytes of a row where the group's rows allow (half the
// lanes a row: a 64-byte int8 row is 4 lanes), else as many lanes a row as
// the group has rows (8 at G = 8, 8 bytes a lane of int8), so the
// butterfly still leaves each lane one row's score; in PV a row's 64
// features take 16 lanes, and the two half-warps take turns at the warp's
// columns, each writing its own partial.
//
// LCA_TOKEN_PART (scripts/torch_decode_token_bound.py): 1 skips the
// arithmetic of phases 1-3 (the loads and barriers alone), 2 skips the
// loads (the arithmetic alone, over whatever shared memory holds), 3 skips
// both (the launch, barriers, exchanges and stores alone). Each gives
// wrong outputs; only their times count.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

#ifndef LCA_TOKEN_PART
#define LCA_TOKEN_PART 0
#endif
// The head dim: 128, or 64 for a second library built with
// -DLCA_HEAD_DIM=64 (ops/_build.py)
#ifndef LCA_HEAD_DIM
#define LCA_HEAD_DIM 128
#endif

namespace {

constexpr int D = LCA_HEAD_DIM;
static_assert(D == 64 || D == 128, "head dim 64 or 128");
// PV: a lane holds 4 output features, so a row's D features take D / 4
// lanes and a warp NSUB = 128 / D rows' columns at a time
constexpr int NSUB = 128 / D;
constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int MAXG = 8;          // query rows per group
constexpr int CHB = 8192;        // bytes of a chunk of K or V rows
constexpr int RING = 4;          // chunk slots: the span's K, then its V
constexpr int MINB = 4;          // blocks an SM holds at GP = 2
constexpr int MAXC = 8;          // spans a cluster (portable cluster size)
constexpr float kClamp = 90.f;
constexpr float kNegInf = -1e30f;
constexpr bool kLoads = LCA_TOKEN_PART == 0 || LCA_TOKEN_PART == 1;
constexpr bool kMath = LCA_TOKEN_PART == 0 || LCA_TOKEN_PART == 2;

// kinds of K/V (ops/decode.py _KIND_*): the bf16 path; the s8 path over
// int8 or int4; the dequant-cast path over int8, fp8 e4m3 or int4
constexpr int kBF16 = 0, kS8I8 = 1, kS8I4 = 2, kCastI8 = 3, kCastF8 = 4,
              kCastI4 = 5;

template <int KIND, int GP = 2>
struct Kind {
  static constexpr bool S8 = KIND == kS8I8 || KIND == kS8I4;
  static constexpr bool CAST = KIND >= kCastI8;
  static constexpr bool QUANT = S8 || CAST;
  static constexpr bool I4 = KIND == kS8I4 || KIND == kCastI4;
  // bytes of a cache row; lanes sharing a row in the scores, the bytes each
  // loads of it and the values they hold (the cast path at 8 rows takes 16
  // lanes a row at d = 128, so q's bf16 slices fit the registers; at d = 64
  // half as many, but never fewer than the group's rows, which the
  // butterfly hands one to a lane); q bytes per element, the q bytes a
  // lane holds and their 16-byte words (an 8-byte slice in the first);
  // rows of a chunk; V bytes a lane takes of a row in PV (4 features)
  static constexpr int ROW = KIND == kBF16 ? 2 * D : (I4 ? D / 2 : D);
  static constexpr int LPR128 = KIND == kBF16 || (CAST && GP == 8) ? 16 : 8;
  static constexpr int LPR = LPR128 * D / 128 > GP ? LPR128 * D / 128 : GP;
  static constexpr int LB = ROW / LPR;
  static constexpr int VPL = D / LPR;
  static constexpr int QEB = S8 ? 1 : 2;
  static constexpr int QB = VPL * QEB;
  static constexpr int QP = QB >= 16 ? QB / 16 : 1;
  static constexpr int CR = CHB / ROW;
  static constexpr int VB = ROW / (D / 4);
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
  const int* fc;       // (b,) sharded first columns, or null
  const int* scol;     // (b,) sharded sink ends, or null
  float* out;          // (b, tiles, h_kv, G, D) fp32 partials (tiles = 1:
  float* lse;          //   the output); (b, tiles, h_kv, G)
  int b, h_kv, G, s_max, layer, bkv, tiles, span, cluster;
  int left;            // window: a row at q sees columns >= q - left (-1: all)
  int sink;            // columns < sink stay visible (left >= 0)
  int n_tok;           // tokens of the run; row r is token r % n_tok
  int n_groups;        // groups of MAXG query rows per kv head
  int pool, page, n_pages;
  float sscale;        // safe bf16 and cast forms: score scale
  float cap;           // softcap (0: none)
};

// Byte offsets into dynamic shared memory, the same on host and device:
// the ring's chunk slots (at the end the PV warps' partials) and their
// barriers, the per-warp score max and l, the (span max, p max) pairs the
// cluster's blocks store per warp [MAXC][NW], the row statistics (m, ps),
// the span's scales, its scores / p [GP][SP] and (s8) p8 [GP][SP].
struct Layout {
  int bar, xm, xl, xr, st, ksc, vsc, sc, p8, bytes;
  __host__ __device__ Layout(int gp, int sp, bool s8) {
    bar = RING * CHB;
    xm = bar + 128;
    xl = xm + NW * 4;
    xr = xl + NW * 4;
    st = xr + MAXC * NW * 8;
    ksc = st + 2 * MAXG * 4;
    vsc = ksc + sp * 4;
    sc = vsc + sp * 4;
    p8 = sc + gp * sp * 4;
    bytes = p8 + (s8 ? gp * sp : 0);
  }
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

// ---------------------------------------------------------------------------
// PTX: bulk copies and the cluster
// ---------------------------------------------------------------------------

// `bytes` (a multiple of 16) from global to this block's shared memory,
// completing on the mbarrier's transaction count
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// every thread of every block of the cluster: this block's shared-memory
// writes (and its stores to other blocks') before it are visible to the
// cluster after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the two halves of a cluster barrier, apart: the arrival at the start
// says the block runs (its shared memory may take other blocks' stores
// once every block has arrived), the wait comes before the first store
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// a shared address of this block -> the same offset in block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_v2(uint32_t addr, float x,
                                              float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(x), "f"(y)
               : "memory");
}

// ---------------------------------------------------------------------------
// reductions
// ---------------------------------------------------------------------------

// Sums v[0..GP) over the LPR lanes that share a cache row: a butterfly
// that halves the values each lane holds at every step (each lane keeps
// one half and sends the other), then plain steps. Afterwards lane ch of
// the group holds the sum of row ch / (LPR / GP).
template <int GP, int LPR, typename T>
__device__ __forceinline__ T lane_row_sum(const T (&v)[GP], int ch) {
  constexpr int LOG = GP == 8 ? 3 : GP == 4 ? 2 : 1;
  static_assert(GP == 2 || GP == 4 || GP == 8, "GP");
  T w[GP];
#pragma unroll
  for (int i = 0; i < GP; ++i) w[i] = v[i];
#pragma unroll
  for (int s = 0; s < LOG; ++s) {
    const int off = LPR >> (s + 1);
    const bool upper = ch & off;
#pragma unroll
    for (int i = 0; i < (GP >> (s + 1)); ++i) {
      const int half = GP >> (s + 1);
      const T send = upper ? w[i] : w[i + half];
      const T keep = upper ? w[i + half] : w[i];
      w[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
#pragma unroll
  for (int off = LPR >> (LOG + 1); off > 0; off >>= 1)
    w[0] += __shfl_xor_sync(0xffffffffu, w[0], off);
  return w[0];
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 4 rows of 4 s8 values (w[j] = row j's features 0-3) -> per feature the 4
// rows' values (t[f] byte j = row j's feature f)
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&t)[4]) {
  const uint32_t a = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t b = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t c = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t d = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(a, b, 0x5410);
  t[1] = __byte_perm(a, b, 0x7632);
  t[2] = __byte_perm(c, d, 0x5410);
  t[3] = __byte_perm(c, d, 0x7632);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// GP: the group's query rows padded to 2, 4 or 8 (rows past the call's are
// zero and never stored)
template <int KIND, bool SAFE, int GP>
__global__ void __launch_bounds__(NT, GP == 2 ? MINB : 2)
    decode_span_kernel(const Params p) {
  using K = Kind<KIND, GP>;
  constexpr bool S8 = K::S8, QUANT = K::QUANT;
  constexpr int LPR = K::LPR, RPP = NT / LPR;  // rows per pass (scores)
  constexpr int CR = K::CR;
  constexpr int WPR = NW / GP;                 // warps per row (softmax)
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = p.span, SP = (S + 3) & ~3;
  const Layout lay(GP, SP, S8);
  // the block's span of its tile (its rank in the cluster on the s8 path,
  // whose spans exchange statistics; the other kinds launch no cluster)
  const int rank = blockIdx.x % p.cluster;
  const int tslot = blockIdx.x / p.cluster;
  const int hk = blockIdx.y / p.n_groups;
  const int r0 = (blockIdx.y % p.n_groups) * MAXG;  // the group's first row
  const int G = min(MAXG, p.G - r0);                // its rows (<= GP)
  const int ib = blockIdx.z;
  const int len = p.lengths[ib];
  const long long qrow0 = ((long long)ib * p.h_kv + hk) * p.G + r0;
  // this block's (out, lse) partial, one per span
  const long long obase =
      (((long long)ib * p.tiles * p.cluster + blockIdx.x) * p.h_kv + hk) *
          p.G + r0;

  // the row's live tiles, each once: the sink tiles before the window's
  // band, then the band [start_t, last_t] from the run's first token's
  // window (or its sharded first column) to its last token; this cluster
  // takes the tslot-th
  const bool sharded = p.fc != nullptr;
  const int fc = sharded ? p.fc[ib] : 0;
  const int sink = sharded ? (p.scol != nullptr ? p.scol[ib] : 0) : p.sink;
  const int nk = (p.s_max + p.bkv - 1) / p.bkv;
  const int last_t = len > 0 ? min((len - 1) / p.bkv, nk - 1) : -1;
  const int first_col =
      sharded ? max(fc, 0)
              : (p.left >= 0 ? max(len - p.n_tok - p.left, 0) : 0);
  const int start_t = first_col / p.bkv;
  const int n_sink =
      p.left >= 0 || sharded
          ? min(min((sink + p.bkv - 1) / p.bkv, start_t), last_t + 1)
          : 0;
  const int n_live = n_sink + max(last_t - start_t + 1, 0);
  // an empty partial: lse -inf (the merge reads no out beside it; the
  // output itself, out 0, when it is the only partial)
  auto empty = [&]() {
    if (p.tiles * p.cluster == 1)
      for (int i = tid; i < G * D; i += NT) p.out[obase * D + i] = 0.f;
    if (tid < G) p.lse[obase + tid] = __int_as_float(0xff800000);
  };
  if (tslot >= n_live) {  // the whole cluster: no column
    empty();
    return;
  }
  const bool sink_tile = tslot < n_sink;
  const int c0 = (sink_tile ? tslot : start_t + (tslot - n_sink)) * p.bkv;
  // the tile's columns to read, [c0 + lo, c0 + hi), all <= len - 1: a sink
  // tile ends at the last sink, the band's first tile starts at the
  // window's first column (or at 0 where it holds sinks). They go to one
  // span when they fit it (the cluster's other blocks have none, and
  // nothing is exchanged), else evenly to all: this block's span is
  // columns [s0, s0 + e) of the tile
  const int hi = min(p.bkv, (sink_tile ? min(sink, len) : len) - c0);
  const int lo = c0 < sink ? 0 : max(first_col - c0, 0);
  const int n_vis = max(hi - lo, 0);
  const bool one = n_vis <= S;
  const int per = one ? S : (n_vis + p.cluster - 1) / p.cluster;
  const int s0 = lo + (one ? 0 : rank * per);
  const int e = one ? (rank == 0 ? n_vis : 0)
                    : max(min(per, n_vis - rank * per), 0);
  if (one && rank > 0) {
    empty();
    return;
  }
  const bool xchg = S8 && !one;  // the cluster's exchange
  if (xchg) cluster_arrive_relaxed();
  // the tile's storage: its pool page (paged) or the row's slab (dense)
  int pg = ib, off = c0;
  if (p.pt != nullptr) {
    pg = min(max(p.pt[(long long)ib * p.n_pages + c0 / p.page], 0),
             p.pool - 1);
    off = c0 % p.page;
  }
  const long long base =
      (((long long)p.layer * p.pool + pg) * p.h_kv + hk) * p.page + off + s0;
  const char* kg = static_cast<const char*>(p.k) + base * K::ROW;
  const char* vg = static_cast<const char*>(p.v) + base * K::ROW;

  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar0 = sbase + lay.bar;  // a barrier per ring slot
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  float* ksc = reinterpret_cast<float*>(smem + lay.ksc);
  float* vsc = reinterpret_cast<float*>(smem + lay.vsc);
  float* st = reinterpret_cast<float*>(smem + lay.st);  // m, ps per row
  float* xm = reinterpret_cast<float*>(smem + lay.xm);
  float* xl = reinterpret_cast<float*>(smem + lay.xl);
  const float2* xr = reinterpret_cast<const float2*>(smem + lay.xr);
  unsigned char* p8 = smem + lay.p8;

  // the span's chunks of CR rows, nch of them. The ring takes them in the
  // order K chunk 0..nch-1, V chunk 0..nch-1: item i in slot i % RING, its
  // (i / RING)-th use; a slot takes its next item once every warp has read
  // it
  const int nch = (e + CR - 1) / CR;
  // chunk i's rows, [r_lo, r_hi) of the span
  auto chunk_rows = [&](int i, int& r_lo, int& r_hi) {
    r_lo = i * CR;
    r_hi = min(e, (i + 1) * CR);
  };
  auto issue = [&](int item) {  // one thread: ring item `item`, if any
    if (!kLoads || item >= 2 * nch) return;
    const bool is_v = item >= nch;
    const int i = item - (is_v ? nch : 0);
    int r_lo, r_hi;
    chunk_rows(i, r_lo, r_hi);
    const int slot = item % RING;
    const uint32_t bar = bar0 + 8 * slot;
    const int bytes = (r_hi - r_lo) * K::ROW;
    mbar_expect_tx(bar, bytes);
    bulk_load(sbase + slot * CHB, (is_v ? vg : kg) + (long long)r_lo * K::ROW,
              bytes, bar);
  };
  auto wait_item = [&](int item) {
    if (kLoads) mbar_wait(bar0 + 8 * (item % RING), (item / RING) & 1);
  };

  if (tid == 0) {
    for (int s = 0; s < RING; ++s) mbar_init(bar0 + 8 * s, 1);
    fence_barrier_init();
    for (int item = 0; item < RING; ++item) issue(item);
  }
  // the span's scales: zeros outside its visible columns (never read)
  if (QUANT) {
    const float* kst = p.ks + base;
    const float* vst = p.vs + base;
    for (int j = tid; j < SP; j += NT) {
      const bool ok = kLoads && j < e;
      cp_async4(sbase + lay.ksc + 4 * j, kst + (ok ? j : 0), ok);
      cp_async4(sbase + lay.vsc + 4 * j, vst + (ok ? j : 0), ok);
    }
  }

  // 1. scores. This thread's slice of every query row: the d values its
  // lane's cache bytes hold (QP 16-byte words of q)
  const int ch = tid % LPR, rsub = tid / LPR;
  Pack16 qreg[GP][K::QP];
#pragma unroll
  for (int r = 0; r < GP; ++r)
#pragma unroll
    for (int c = 0; c < K::QP; ++c) {
      qreg[r][c].u = make_uint4(0, 0, 0, 0);
      if (r >= G) continue;
      const char* qs = static_cast<const char*>(p.q) +
                       ((qrow0 + r) * D) * K::QEB + ch * K::QB + c * 16;
      if constexpr (K::QB >= 16) {
        qreg[r][c].u = *reinterpret_cast<const uint4*>(qs);
      } else {
        const uint2 w = *reinterpret_cast<const uint2*>(qs);
        qreg[r][c].u.x = w.x;
        qreg[r][c].u.y = w.y;
      }
    }
  // the row this lane scores after the butterfly, and its bounds: columns
  // <= qlim, and >= wlo unless a sink (sharded: fc + the row's token)
  const int myrow = ch / (LPR / GP);
  const bool store = ch % (LPR / GP) == 0 && myrow < G;
  const int tok = (r0 + myrow) % p.n_tok;
  const int qlim = len - p.n_tok + tok;
  const int wlo = sharded ? fc + tok : p.left >= 0 ? qlim - p.left : INT_MIN;
  const float qscale = (S8 && myrow < G) ? p.qs[qrow0 + myrow] : 0.f;
  // ALiBi's slope (0 when off: s - 0 * (q - col) is s)
  const float slope = (p.slopes != nullptr && myrow < G)
                          ? p.slopes[(long long)hk * p.G + r0 + myrow]
                          : 0.f;
  cp_async_wait_all();
  __syncthreads();

  for (int i = 0; i < nch; ++i) {
    int r_lo, r_hi;
    chunk_rows(i, r_lo, r_hi);
    wait_item(i);
    const unsigned char* kc = smem + (i % RING) * CHB;
#pragma unroll 2
    for (int jb = r_lo; jb < r_hi; jb += RPP) {
      if (!kMath) break;
      const int j = jb + rsub;
      const bool ok = j < r_hi;
      Pack16 kr;
      kr.u = make_uint4(0, 0, 0, 0);
      if (ok) {
        const unsigned char* src = kc + (j - r_lo) * K::ROW + ch * K::LB;
        if constexpr (K::LB == 16) {
          kr.u = *reinterpret_cast<const uint4*>(src);
        } else if constexpr (K::LB == 8) {
          const uint2 w = *reinterpret_cast<const uint2*>(src);
          kr.u.x = w.x;
          kr.u.y = w.y;
        } else {
          kr.u.x = *reinterpret_cast<const uint32_t*>(src);
        }
      }
      float s;
      if constexpr (S8) {
        // int4 on the s8 path: the lane's 16 nibbles as 4 s8 words
        Pack16 k8 = kr;
        if constexpr (KIND == kS8I4) {
          s4x8_to_s8(kr.u.x, k8.u.x, k8.u.y);
          s4x8_to_s8(kr.u.y, k8.u.z, k8.u.w);
        }
        int acc[GP];
#pragma unroll
        for (int r = 0; r < GP; ++r) {
          acc[r] = 0;
#pragma unroll
          for (int w = 0; w < K::VPL / 4; ++w)
            acc[r] = __dp4a(k8.i[w], qreg[r][0].i[w], acc[r]);
        }
        s = (float)lane_row_sum<GP, LPR>(acc, ch) * qscale;
      } else if constexpr (K::CAST) {
        // the lane's VPL values widened
        float kf[K::VPL];
#pragma unroll
        for (int w = 0; w < K::VPL / 4; ++w) {
          float x[4];
          if constexpr (KIND == kCastI4)
            widen4<KIND>(kr.i[w / 2] >> (16 * (w & 1)), x);
          else
            widen4<KIND>((unsigned)kr.i[w], x);
#pragma unroll
          for (int t = 0; t < 4; ++t) kf[4 * w + t] = x[t];
        }
        float acc[GP];
#pragma unroll
        for (int r = 0; r < GP; ++r) {
          acc[r] = 0.f;
#pragma unroll
          for (int t = 0; t < K::VPL; t += 2) {
            const unsigned qw = (unsigned)qreg[r][t / 8].i[(t % 8) / 2];
            acc[r] = fmaf(bf16_lo(qw), kf[t], acc[r]);
            acc[r] = fmaf(bf16_hi(qw), kf[t + 1], acc[r]);
          }
        }
        s = lane_row_sum<GP, LPR>(acc, ch);
        if (SAFE) s *= p.sscale;
      } else {
        float acc[GP];
#pragma unroll
        for (int r = 0; r < GP; ++r) {
          acc[r] = 0.f;
#pragma unroll
          for (int w = 0; w < K::VPL / 2; ++w) {
            const unsigned kw = (unsigned)kr.i[w];
            const unsigned qw = (unsigned)qreg[r][0].i[w];
            acc[r] = fmaf(bf16_lo(qw), bf16_lo(kw), acc[r]);
            acc[r] = fmaf(bf16_hi(qw), bf16_hi(kw), acc[r]);
          }
        }
        s = lane_row_sum<GP, LPR>(acc, ch);
        if (SAFE) s *= p.sscale;
      }
      if (ok && store) {
        if (QUANT) s *= ksc[j];
        if (p.cap > 0.f) s = p.cap * tanhf(s / p.cap);
        const int col = c0 + s0 + j;
        // ALiBi, after the softcap: -slope * (q - col), the product rounded
        // on its own as in the plain version
        s = s - __fmul_rn(slope, (float)(qlim - col));
        // per-row bounds: the run's causal limit and the row's window
        if (col > qlim || (col < wlo && col >= sink)) s = kNegInf;
        sc[myrow * SP + j] = s;
      }
    }
    if (i + RING < nch) {  // the slot's next K chunk
      __syncthreads();
      if (tid == 0) issue(i + RING);
    }
  }
  __syncthreads();
  // V's chunks into the slots the K chunks left: issued once the scores
  // are done, they land while the softmax and the exchange run (a slot
  // per K chunk as it is read measured slower: a barrier per chunk)
  if (tid == 0)
    for (int item = max(nch, RING); item < min(2 * nch, nch + RING); ++item)
      issue(item);

  // 2. softmax over the span: warps [rr * WPR, (rr + 1) * WPR) take row
  // rr's columns. The online form's m: the span's max score (bf16 and
  // cast), or the tile's (s8: the cluster's max of its spans' maxima)
  const int rr = warp / WPR;
  const int tr = (warp % WPR) * 32 + lane;  // thread within the row
  const bool row_ok = kMath && rr < G;
  float m = 0.f;
  if (SAFE) {
    float mx = kNegInf;
    if (row_ok)
      for (int j = tr; j < e; j += WPR * 32)
        mx = fmaxf(mx, sc[rr * SP + j]);
    mx = warp_max(mx);
    if (lane == 0) xm[warp] = mx;
    __syncthreads();
    m = kNegInf;
    for (int w = 0; w < WPR; ++w) m = fmaxf(m, xm[rr * WPR + w]);
  }
  // p as the JAX kernel forms it against the max m
  auto p_of = [&](float s, float mm) {
    const float pv = SAFE ? expf(s - mm) : exp2f(fminf(s, kClamp));
    return (SAFE && s == kNegInf) ? 0.f : pv;  // a masked column
  };
  float lsum = 0.f, ps = 0.f;
  if (S8) {
    // the span's max of p * v_scale against its own max; each warp's
    // (span max, p max) goes to every block of the cluster, whose tile
    // values are then m = the max of the span maxima and the p max
    // rescaled to it (the JAX kernel's rowmax(p * v_scale) over the tile)
    float pmax = 0.f;
    if (row_ok)
      for (int j = tr; j < e; j += WPR * 32)
        pmax = fmaxf(pmax, p_of(sc[rr * SP + j], m) * vsc[j]);
    pmax = warp_max(pmax);
    float tile_p = pmax;
    if (xchg) {
      cluster_wait();  // every block runs
      if (lane < p.cluster)
        st_cluster_v2(map_rank(sbase + lay.xr + 8 * (rank * NW + warp), lane),
                      m, pmax);
      cluster_sync();
      // slot l: block l / WPR's warp l % WPR of this row
      const int n_slots = p.cluster * WPR;
      auto slot = [&](int l) {
        return xr[(l / WPR) * NW + rr * WPR + l % WPR];
      };
      if (SAFE) {
        float mt = kNegInf;
        for (int l = lane; l < n_slots; l += 32) mt = fmaxf(mt, slot(l).x);
        m = warp_max(mt);
      }
      float tp = 0.f;
      for (int l = lane; l < n_slots; l += 32) {
        const float2 x = slot(l);
        tp = fmaxf(tp, !SAFE ? x.y
                             : x.x == kNegInf ? 0.f : x.y * expf(x.x - m));
      }
      tile_p = warp_max(tp);
    } else if (WPR > 1) {  // one span: the row's warps
      __syncthreads();
      if (lane == 0) xm[warp] = pmax;
      __syncthreads();
      for (int w = 0; w < WPR; ++w) tile_p = fmaxf(tile_p, xm[rr * WPR + w]);
    }
    ps = fmaxf(tile_p, 1e-20f) * (1.0f / 127.0f);
    // l and p8 over the span's 4-aligned quads against the tile's m and
    // ps, 0 outside its visible columns
    const int qe = (e + 3) & ~3;
    if (rr < G)
      for (int j = tr; j < qe; j += WPR * 32) {
        int q8 = 0;
        if (row_ok && j < e) {
          const float pv = p_of(sc[rr * SP + j], m);
          lsum += pv;
          q8 = (int)rintf(pv * vsc[j] / ps);
        }
        p8[rr * SP + j] = (unsigned char)q8;
      }
  } else if (row_ok) {
    for (int j = tr; j < e; j += WPR * 32) {
      float pv = p_of(sc[rr * SP + j], m);
      lsum += pv;
      if (K::CAST) pv *= vsc[j];
      sc[rr * SP + j] = __bfloat162float(__float2bfloat16_rn(pv));
    }
  }
  lsum = warp_sum(lsum);
  if (lane == 0) xl[warp] = lsum;
  if (warp % WPR == 0 && lane == 0) {
    st[rr] = m;
    st[MAXG + rr] = ps;
  }
  __syncthreads();

  // 3. PV: a lane's 4 output features, 4f..4f+3 (f = lane % (D / 4)), of
  // the columns of its sub-warp (lane / (D / 4): NSUB sub-warps a warp,
  // taking turns at the warp's columns)
  const int fl = lane % (D / 4), sub = lane / (D / 4);
  const int pw0 = warp * NSUB + sub;  // the partial's slot: NW * NSUB
  int iacc[GP][4];
  float facc[GP][4];
#pragma unroll
  for (int r = 0; r < GP; ++r)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      iacc[r][f] = 0;
      facc[r][f] = 0.f;
    }
  for (int i = 0; i < nch; ++i) {
    int r_lo, r_hi;
    chunk_rows(i, r_lo, r_hi);
    wait_item(nch + i);
    const unsigned char* vc = smem + ((nch + i) % RING) * CHB + fl * K::VB;
    if (kMath && S8) {
      // quads of columns: the 4 rows' bytes of the lane's features,
      // transposed, against the rows' packed p8 (0 from column e on: the
      // quad's rows past it hold bytes no copy wrote, and add nothing)
      for (int j = r_lo + 4 * pw0; j < r_hi; j += 4 * NW * NSUB) {
        uint32_t w[4], t[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if constexpr (K::I4)
            w[u] = s4x4_to_s8(*reinterpret_cast<const unsigned short*>(
                vc + (j + u - r_lo) * K::ROW));
          else
            w[u] = *reinterpret_cast<const uint32_t*>(
                vc + (j + u - r_lo) * K::ROW);
        }
        transpose4(w, t);
#pragma unroll
        for (int r = 0; r < GP; ++r) {
          const int pw = *reinterpret_cast<const int*>(p8 + r * SP + j);
#pragma unroll
          for (int f = 0; f < 4; ++f)
            iacc[r][f] = __dp4a((int)t[f], pw, iacc[r][f]);
        }
      }
    } else if (kMath) {
#pragma unroll 2
      for (int j = r_lo + pw0; j < r_hi; j += NW * NSUB) {
        float ve[4];
        const unsigned char* row = vc + (j - r_lo) * K::ROW;
        if constexpr (KIND == kBF16) {
          const uint2 w = *reinterpret_cast<const uint2*>(row);
          ve[0] = bf16_lo(w.x);
          ve[1] = bf16_hi(w.x);
          ve[2] = bf16_lo(w.y);
          ve[3] = bf16_hi(w.y);
        } else if constexpr (K::I4) {
          widen4<KIND>(*reinterpret_cast<const unsigned short*>(row), ve);
        } else {
          widen4<KIND>(*reinterpret_cast<const unsigned*>(row), ve);
        }
#pragma unroll
        for (int r = 0; r < GP; ++r) {
          const float pv = sc[r * SP + j];
#pragma unroll
          for (int f = 0; f < 4; ++f) facc[r][f] = fmaf(pv, ve[f], facc[r][f]);
        }
      }
    }
    if (nch + i + RING < 2 * nch) {
      __syncthreads();
      if (tid == 0) issue(nch + i + RING);
    }
  }
  // the sub-warps' partials [NW * NSUB][GP][D] in the ring, once every
  // warp's PV is done, summed into the span's: out = acc / l (s8: int32
  // sum * ps; 0 on a dead row), lse = m + log l
  static_assert(NW * NSUB * GP * D * 4 <= RING * CHB, "the warps' partials");
  __syncthreads();
  {
    int4* red = reinterpret_cast<int4*>(smem);
#pragma unroll
    for (int r = 0; r < GP; ++r) {
      int4 v;
      if (S8) {
        v = make_int4(iacc[r][0], iacc[r][1], iacc[r][2], iacc[r][3]);
      } else {
        v = make_int4(__float_as_int(facc[r][0]), __float_as_int(facc[r][1]),
                      __float_as_int(facc[r][2]), __float_as_int(facc[r][3]));
      }
      red[(pw0 * GP + r) * (D / 4) + fl] = v;
    }
  }
  __syncthreads();
  const int* red = reinterpret_cast<const int*>(smem);
  for (int i = tid; i < G * D; i += NT) {
    const int r = i / D;
    int is = 0;
    float fs = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < NW * NSUB; ++w) {
      const int v = red[w * GP * D + i];
      if (S8)
        is += v;
      else
        fs += __int_as_float(v);
    }
    for (int w = 0; w < WPR; ++w) l += xl[r * WPR + w];
    const float tot = S8 ? (float)is * st[MAXG + r] : fs;
    p.out[obase * D + i] = l == 0.f ? 0.f : tot / l;
    if (i % D == 0) {
      const float v = SAFE ? st[r] + logf(l) : logf(l);
      p.lse[obase + r] = l == 0.f ? __int_as_float(0xff800000) : v;  // -inf
    }
  }
}

// One block of MT threads per (query row, kv head, batch row): the
// -inf-safe N-way LSE merge (ops/merge.py merge_partials) of the spans'
// partials in one pass, in a fixed order: each of the 16 warps takes every
// 16th partial, a lane 4 features (the first D / 4 lanes), with a running
// max it rescales to;
// then the warps' sums are rescaled to the block's max and added in shared
// memory.
constexpr int MT = 512;

__global__ void __launch_bounds__(MT)
    merge_spans(const float* part_out, const float* part_lse, float* out,
                float* lse, int h_kv, int G, int n) {
  constexpr int MW = MT / 32;
  __shared__ float4 red[MW][32];
  __shared__ float wm[MW], wd[MW];
  const int r = blockIdx.x, hk = blockIdx.y, ib = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float neg_inf = __int_as_float(0xff800000);
  auto cell = [&](int t) -> long long {
    return (((long long)ib * n + t) * h_kv + hk) * G + r;
  };
  // exp(x - m), 0 for x = -inf (an empty partial)
  auto wexp = [&](float x, float m) {
    return x == neg_inf ? 0.f : expf(x - m);
  };
  float m = neg_inf, den = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int t = warp; t < n; t += MW) {
    const float lv = part_lse[cell(t)];
    const float4 o =
        4 * lane < D
            ? *reinterpret_cast<const float4*>(part_out + cell(t) * D +
                                               4 * lane)
            : make_float4(0.f, 0.f, 0.f, 0.f);
    // an empty partial adds nothing (its out is not written)
    const bool live = lv != neg_inf;
    const float mn = fmaxf(m, lv);
    const float a = wexp(m, mn), w = wexp(lv, mn);
    den = den * a + w;
    acc.x = acc.x * a + (live ? o.x * w : 0.f);
    acc.y = acc.y * a + (live ? o.y * w : 0.f);
    acc.z = acc.z * a + (live ? o.z * w : 0.f);
    acc.w = acc.w * a + (live ? o.w * w : 0.f);
    m = mn;
  }
  red[warp][lane] = acc;
  if (lane == 0) {
    wm[warp] = m;
    wd[warp] = den;
  }
  __syncthreads();
  if (tid >= D) return;
  float mx = neg_inf;
  for (int w = 0; w < MW; ++w) mx = fmaxf(mx, wm[w]);
  const bool dead = mx == neg_inf;
  float o = 0.f, dn = 0.f;
  for (int w = 0; w < MW; ++w) {
    const float sw = wexp(wm[w], mx);
    o += reinterpret_cast<const float*>(&red[w][0])[tid] * sw;
    dn += wd[w] * sw;
  }
  const long long c = ((long long)ib * h_kv + hk) * G + r;
  dn = fmaxf(dn, 1e-37f);
  out[c * D + tid] = dead ? 0.f : o / dn;
  if (tid == 0) lse[c] = dead ? neg_inf : mx + logf(dn);
}

template <int KIND, bool SAFE, int GP>
int launch(const Params& p, cudaStream_t stream) {
  auto kern = decode_span_kernel<KIND, SAFE, GP>;
  const Layout lay(GP, (p.span + 3) & ~3, Kind<KIND>::S8);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles * p.cluster, p.h_kv * p.n_groups, p.b);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = stream;
  // the s8 path's spans exchange their statistics: one cluster a tile
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = Kind<KIND>::S8 && p.cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_kind(const Params& p, bool safe, int gp, cudaStream_t st) {
  if (gp == 2)
    return safe ? launch<KIND, true, 2>(p, st) : launch<KIND, false, 2>(p, st);
  if (gp == 4)
    return safe ? launch<KIND, true, 4>(p, st) : launch<KIND, false, 4>(p, st);
  return safe ? launch<KIND, true, 8>(p, st) : launch<KIND, false, 8>(p, st);
}

}  // namespace

// dims: b, h_kv, G, s_max, layer, bkv, tiles, span, left, sink, n_tok,
// pool, page, n_pages, kind (KIND: 0 bf16, 1 s8 int8, 2 s8 int4, 3 cast
// int8, 4 cast fp8, 5 cast int4). s_max is a row's logical capacity
// (n_pages * page when paged); dense: pt null, pool = b, page = s_max,
// n_pages = 1. tiles: the tile slots (the most live tiles a row can
// have); span: a block's columns, dividing bkv into at most 8
// (ops/decode.py decode_launch).
// G = g * n_tok query rows per kv head, ordered (head, token).
// out (b, h_kv, G, D) and lse (b, h_kv, G) fp32; with tiles > 1 the tiles'
// partials go to part_out (b, tiles, h_kv, G, D) / part_lse first.
// slopes: ALiBi's (h_kv, G) row slopes (times log2e in the fast form), or
// null. first_cols, sink_cols: a sequence-sharded cache's (b,) first
// columns (unclipped, token 0's) and sink ends, or null; with them the
// sink entry of dims is unused, left and tiles still size the walk.
extern "C" int lca_decode_attention(const void* q, const float* qs,
                                    const void* k, const void* v,
                                    const float* ks, const float* vs,
                                    const int* lengths, const int* pt,
                                    float* part_out,
                                    float* part_lse, float* out, float* lse,
                                    const long long* dims, float sscale,
                                    float cap, int safe, void* stream,
                                    const float* slopes,
                                    const int* first_cols,
                                    const int* sink_cols) {
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
  p.tiles = (int)dims[6];
  p.span = (int)dims[7];
  p.left = (int)dims[8];
  p.sink = (int)dims[9];
  p.n_tok = (int)dims[10];
  p.pool = (int)dims[11];
  p.page = (int)dims[12];
  p.n_pages = (int)dims[13];
  p.pt = pt;
  p.fc = first_cols;
  p.scol = sink_cols;
  if (first_cols == nullptr && sink_cols != nullptr)
    return (int)cudaErrorInvalidValue;
  p.sscale = sscale;
  p.cap = cap;
  if (p.G < 1 || p.n_tok < 1 || p.G % p.n_tok || p.bkv < 1 || p.tiles < 1 ||
      p.span < 1 || p.bkv % p.span || (pt != nullptr && p.page % p.bkv))
    return (int)cudaErrorInvalidValue;
  p.cluster = p.bkv / p.span;
  p.n_groups = (p.G + MAXG - 1) / MAXG;
  if (p.cluster > MAXC || (long long)p.h_kv * p.n_groups > 65535 ||
      (long long)p.tiles * p.cluster > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const bool merge = p.tiles * p.cluster > 1;  // one partial per span
  if (merge && (part_out == nullptr || part_lse == nullptr))
    return (int)cudaErrorInvalidValue;
  p.out = merge ? part_out : out;
  p.lse = merge ? part_lse : lse;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kind = (int)dims[14];
  // scales exactly when quantized, q row scales exactly on the s8 path
  const bool s8 = kind == kS8I8 || kind == kS8I4;
  if ((kind == kBF16) != (ks == nullptr) || s8 != (qs != nullptr))
    return (int)cudaErrorInvalidValue;
  const int gp = p.G <= 2 ? 2 : p.G <= 4 ? 4 : 8;
  const bool sf = safe != 0;
  int err;
  switch (kind) {
#define LCA_KIND(K)                          \
  case K:                                    \
    err = launch_kind<K>(p, sf, gp, st);     \
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
  merge_spans<<<dim3(p.G, p.h_kv, p.b), MT, 0, st>>>(part_out, part_lse, out,
                                                     lse, p.h_kv, p.G,
                                                     p.tiles * p.cluster);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a block at these rows per group and span (the
// kernel's Layout), for the host's tests of the plan
extern "C" int lca_decode_attention_smem(int G, int span, int s8) {
  const int gp = G <= 2 ? 2 : G <= 4 ? 4 : 8;
  return Layout(gp, (span + 3) & ~3, s8 != 0).bytes;
}

extern "C" const char* lca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
