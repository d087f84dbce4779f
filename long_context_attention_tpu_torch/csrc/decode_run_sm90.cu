// Multi-token decode attention for Hopper (sm_90a only): a run's query rows
// of one kv head in 64-row wgmma blocks over one pass of the cache, TMA and a
// warp-specialised pipeline.
//
// Replaces the TPU kernel long_context_attention_tpu/ops/decode.py
// _decode_kernel (wrapper decode_attention) for the runs whose query rows
// per kv head (G = g * n_tok) do not fit decode_attention.cu's group of 8:
// a teacher-forced run, a prefix cache's suffix chunk or an interleaved
// admission's chunk, over a bf16, int8, fp8 or packed int4 cache, dense or
// paged, with the sliding window, StreamingLLM sinks, logit softcap and
// ALiBi. The wrapper (ops/decode.py decode_attention_core) routes a call here
// when G > 8 and its kv tile `bkv` is a multiple of CH = 128 columns that
// divides the slot axis; every other call stays on decode_attention.cu.
//
// It computes what decode_attention.cu and the plain version
// (decode_attention_core_plain) compute, in JAX's order of operations: per
// bkv tile and query row,
//   s = q . k (s32 on the s8 path, fp32 otherwise) times q's row scale (s8)
//       or the softmax scale (online bf16 and cast), times k_scale[col];
//       softcap; ALiBi's s - slope * (q - col) (the product rounded on its
//       own); the row's causal and window / sink masks (-1e30);
//   p = exp2(min(s, 90)) (fast form) or exp(s - m_new) with m_new the
//       running max over the whole tile (online form); l += rowsum(p);
//       p *= v_scale[col];
//   s8 path: P requantized per row over the whole tile, ps = max(rowmax,
//       1e-20) / 127, p8 = rint(p / ps), acc += (p8 . v8)_s32 * ps;
//   otherwise acc += bf16(p) . v in fp32;
// out = acc / l, lse = (m +) log l, a dead row 0 and -inf. Token i of the
// run sits at position len - n_tok + i; row r of a kv head is token r %
// n_tok of head r / n_tok, so each row has its own bounds. What differs
// from the plain version: the order of the sums (the s8 path's s32 PV sums
// go to fp32 per 128 columns, the tile's in one sum there); the fast form's
// exp2 is one MUFU.EX2 (a few ulp, results below 2^-126 flushed to 0, as
// sage_fwd_sm90.cu's); p / ps is the reciprocal's quotient with one
// correction step, rounded to nearest as the division is.
//
// What bounds it on an H100: the operations, 2 * d per (query row, visible
// column) for q.k and for p.v (int8 on the s8 path at 1979 TOP/s, bf16
// otherwise at 989 TFLOP/s); the cache bytes of a kv head are read once per
// block of 128 rows, which at the serving shapes is far below that
// (decode_attention.cu reads it once per 8 rows and multiplies on the CUDA
// cores, which suits one token). In practice the score arithmetic on the
// accumulator (a dozen to twenty instructions a score and sweep, the
// consumers' issue slots) and the producer's per-chunk handshakes bound it
// (PERF.md).
//
// Design. One block per (kv split, row block of BR = 128 query rows, kv
// head, batch row): the grid is (row blocks x splits, h_kv, b), and the
// wrapper picks the splits (ops/decode.py decode_launch: about four waves
// of blocks, one block an SM, so the block scheduler evens out rows of
// other lengths); a second kernel merges the splits' (out, lse) partials
// with the -inf-safe LSE merge (ops/merge.py merge_partials). The block
// walks its split's share of the row's live bkv tiles (the sink tiles
// before the band, then the band from the run's first token's window start
// to the last token, or from the row's first column on a sequence-sharded
// cache: decode_attention.cu's walk), each in chunks of CH = 128 columns, and skips the chunks that hold no column the walk reads (the
// band's first tile left of the window, a sink tile past the sinks, the
// last tile past the row's length). A block has one producer warpgroup and
// two consumer warpgroups of 64 rows each:
//   * the producer (setmaxnreg down to 56 registers) loads the block's Q
//     once and every chunk's K (and V in the last sweep) by TMA, through
//     the page table for a paged cache, with the chunk's k and v scales
//     (staged, then copied beside K: 1 for bf16, 0 past the row's length).
//     bf16 K/V and s8 int8 K land in their operand slot as wgmma reads them
//     (128-byte swizzle); the other kinds land raw and the producer makes
//     the operand: the cast kinds (int8, fp8, int4) widened exactly to bf16
//     (sm90.cuh's PRMT / bf16x2 and e4m3x2 conversions), s8 int4 K
//     sign-extended to s8, and s8 V transposed to V^T (wgmma's s8 path
//     takes both operands K-major). Rows past the row's length of a widened
//     or bf16 V are zeroed, so nothing there reaches the PV product. Warp 0
//     runs the issue loop in step: up to LANDS items in flight (RAWS of them
//     raw chunks), a direct item once its slot is released; the four warps
//     then finish the items in order and arrive on the slots' full
//     barriers.
//   * the consumers (setmaxnreg up to 224) run S = Q K^T on wgmma (s8:
//     m64n128k32 s32.s8.s8; otherwise m64n128k16 f32.bf16.bf16) and the
//     score arithmetic on the accumulator layout (a row across the 4 lanes
//     of a quad), with the mask only in chunks that some row of the warp
//     does not see whole, and the softcap and ALiBi only in calls that
//     have them (a run-time branch per score keeps ptxas from interleaving
//     the scores' chains). A tile statistic needs every column of the tile
//     before any column's p: the online form's tile max (for m_new) and the
//     s8 path's requantization max of p * v_scale. So a tile is swept over
//     its chunks once per statistic (the max sweep under SAFE, the stat
//     sweep on the s8 path), then a last sweep recomputes S (the same
//     bits), sums l, forms P and runs PV: O += bf16(P) V with P in
//     registers and V the MN-major B operand; or on the s8 path P8 through
//     shared memory (64 rows x 128 bytes a warpgroup, the K-major A
//     operand) times V^T, the s32 sum scaled by ps into the fp32 O. The
//     fast bf16 and cast paths take one sweep, the fast s8 path two, the
//     online s8 path three. An s8 tile of at most KEEP chunks (every tile
//     at bkv <= 512) keeps its K chunks in their slots across its sweeps,
//     so its K is loaded once. The s32 to fp32 conversions and p8's
//     rounding use the 2^23 binade's add, off the conversion unit.
//   * a consumer warpgroup whose 64 rows lie past G only waits and releases
//     its slots; rows past G in a live warpgroup read TMA's zero-filled Q
//     and are not written.
// Template parameters: S8 (the s8 path) and SAFE (the online form); the
// cache kind is a run-time value of the producer (the consumers see bf16 or
// s8 operands with scales), softcap and ALiBi are run-time flags.
//
// Shared memory (bytes): bf16 operands: Q 32768 + 2 K slots x 32768 + 2 x
// 1024 scales + 2 V slots x 32768 + 3 raw chunks x 16384 + 8 staged
// scales x 1024 = 223232; s8: Q 16384 + 6 K slots x 16384 + 6 x 1024 + 2
// V^T slots x 16384 + 3 x 16384 + 8 x 1024 + 2 P8 x 8192 = 227328; each +
// 256 of barriers and 1024 of alignment slack.
//
// Head dim 64 (-DLCA_HEAD_DIM=64, a library of its own): Q, K and V are
// one bf16 box a chunk; s8 Q and K rows are 64 bytes, loaded by TMA with
// the 64-byte swizzle that the s8 QK^T's descriptors name (4 k32 steps
// become 2); V^T is 64 d rows; PV is wgmma m64n64 (k16 bf16, k32 s8) into
// a 32-register O. Shared memory: bf16 118016, s8 130304, with the
// barriers and slack.
//
// The tensor maps are encoded on the host per call (sm90.cuh) and passed as
// __grid_constant__ kernel parameters.

#include <climits>

#include "sm90.cuh"

// The head dim: 128, or 64 for a second library built with
// -DLCA_HEAD_DIM=64 (ops/_build.py)
#ifndef LCA_HEAD_DIM
#define LCA_HEAD_DIM 128
#endif

namespace {

constexpr int D = LCA_HEAD_DIM;
static_assert(D == 64 || D == 128, "head dim 64 or 128");
constexpr int CH = 128;   // kv columns per chunk: one wgmma N
constexpr int BR = 128;   // query rows per block: 64 per consumer warpgroup
constexpr int NT = 384;   // one producer and two consumer warpgroups
constexpr int PRODUCER_REGS = 56;
// registers a thread holds at launch (168); the consumers take what the
// producer gives back (setmaxnreg.inc waits for them): 224
constexpr int REGS_AT_LAUNCH = 65536 / NT / 8 * 8;
constexpr int CONSUMER_REGS =
    (REGS_AT_LAUNCH * NT - 128 * PRODUCER_REGS) / 256 / 8 * 8;
constexpr float kClamp = 90.f;
constexpr float kNegInf = -1e30f;

// kinds of K/V (ops/decode.py _KIND_*, decode_attention.cu's): the bf16
// path; the s8 path over int8 or int4; the cast path over int8, fp8 or int4
constexpr int kBF16 = 0, kS8I8 = 1, kS8I4 = 2, kCastI8 = 3, kCastF8 = 4,
              kCastI4 = 5;

// A 64-column bf16 box of 128 rows (128 rows of 128 bytes, 1024-byte
// swizzle atoms of 8 rows); at d = 128 an s8 chunk or Q is one such box, a
// bf16 one two (d 0-63, then 64-127). At d = 64 a bf16 chunk or Q is one
// box, and an s8 one 128 rows of 64 bytes (64-byte swizzle, 512-byte atoms)
constexpr int BOX = 128 * 128;
constexpr int NBOX = D / 64;    // bf16 boxes of a row
constexpr int RAW = 128 * D;    // a raw chunk: int8 / fp8 rows (int4: half)
constexpr int KEEP = 4;         // s8: a tile of up to KEEP chunks keeps its K
constexpr int LANDS = 8;        // items in flight: landing barriers, scales
constexpr int RAWS = 3;         // raw chunks in flight
constexpr int P8 = 64 * CH;     // a consumer warpgroup's int8 P

// Builds that time one side of the pipeline alone (their results are
// wrong): 1 skips the consumers' products and score arithmetic, 2 the
// producer's operand making (widening, sign extension, transposition). 0,
// the kernel, does all.
#ifndef LCA_RUN_PART
#define LCA_RUN_PART 0
#endif
constexpr bool kMath = LCA_RUN_PART != 1;
constexpr bool kMake = LCA_RUN_PART != 2;

template <bool S8>
struct Smem {
  // Q, a K or a V operand (s8 V^T: D rows of 128 kv bytes)
  static constexpr int OP = S8 ? 128 * D : NBOX * BOX;
  static constexpr int KS = S8 ? 6 : 2;          // K slots
  static constexpr int VS = 2;                   // V (V^T) slots
  static constexpr int OFF_K = OP;               // after Q
  static constexpr int OFF_SC = OFF_K + KS * OP; // each K slot's scales
  static constexpr int OFF_V = OFF_SC + KS * 1024;
  static constexpr int OFF_RAW = OFF_V + VS * OP;
  static constexpr int OFF_STG = OFF_RAW + RAWS * RAW;  // staged scales
  static constexpr int OFF_P8 = OFF_STG + LANDS * 1024;
  static constexpr int OFF_BAR = OFF_P8 + (S8 ? 2 * P8 : 0);
  static constexpr int BYTES = OFF_BAR + 256 + 1024;  // barriers, alignment
  static_assert(OFF_V % 1024 == 0 && OFF_RAW % 1024 == 0 &&
                    OFF_P8 % 1024 == 0,
                "slots keep the 1024-byte swizzle atoms");
  static_assert(BYTES <= 232448, "over the 227 KB a block may use");
};

// mbarrier slots: Q; the K and V slots, full and empty; the landing
// barriers of the producer's TMA
constexpr int B_Q = 0, B_KFULL = 1, B_KEMPTY = 7, B_VFULL = 13,
              B_VEMPTY = 15, B_LAND = 17;
static_assert(Smem<true>::KS <= B_KEMPTY - B_KFULL &&
                  Smem<true>::VS <= B_VEMPTY - B_VFULL,
              "a barrier for every slot");
static_assert(B_LAND + LANDS <= 32, "32 barriers in 256 bytes");

// named barriers (0 is __syncthreads): the producer warpgroup; a consumer
// warpgroup's P8 (2 + cw)
constexpr int NB_PRODUCER = 1;
constexpr int NB_P8 = 2;

struct Maps {  // TMA descriptors, in the kernel's parameter space
  CUtensorMap q, k, v, ks, vs;  // ks, vs: quantized kinds only
};

struct Params {
  const float* qs;      // (b, h_kv, G) s8 row scales (scale folded in)
  const float* ks;      // (L, P, h_kv, 1, page) fp32, quantized kinds only
  const float* vs;
  const float* slopes;  // (h_kv, G) ALiBi row slopes, or null
  const int* lengths;   // (b,)
  const int* pt;        // (b, n_pages) page table, or null (dense)
  const int* fc;        // (b,) sharded first columns, or null
  const int* scol;      // (b,) sharded sink ends, or null
  float* out;           // (b, splits, h_kv, G, D) fp32 partials
  float* lse;           // (b, splits, h_kv, G)
  int b, h_kv, G, s_max, layer, bkv, splits, tps;
  int left;             // window: a row at q sees columns >= q - left (-1: all)
  int sink;             // columns < sink stay visible (left >= 0)
  int n_tok;            // tokens of the run; row r is token r % n_tok
  int pool, page, n_pages, kind, n_rb;
  float sscale;         // online form: score scale (bf16 and cast)
  float cap;            // softcap (0: none)
};

// K-major operand (Q, K, V^T, P8): 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// the s8 path's Q and K: rows of D bytes, 128-byte swizzle at d = 128,
// 64-byte at d = 64 (8-row groups 512 bytes apart)
__device__ __forceinline__ uint64_t desc_s8_qk(uint32_t addr) {
  if constexpr (D == 128)
    return desc_kmajor(addr);
  else
    return desc_sw64(addr, 16, 512);
}

// MN-major B operand (bf16 V, [kv, d] with d contiguous): 8 kv rows 1024
// bytes apart, the second 64-column d box BOX bytes after the first
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return desc_sw128(addr, BOX, 1024);
}

// d (64 x 128 fp32) += A (64 x 16 bf16, shared, K-major) * B (16 x 128,
// shared, K-major); _first: d written, not read
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " LCA_D64
      ", %64, %65, 1, 1, 1, 0, 0;\n"
      : LCA_ACC64(d)
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_ss_first(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " LCA_D64
      ", %64, %65, 0, 1, 1, 0, 0;\n"
      : LCA_OUT64(d)
      : "l"(da), "l"(db));
}

// d (64 x 128 s32) += A (64 x 32 s8, shared, K-major) * B (32 x 128 s8,
// shared, K-major); _first: d written, not read
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " LCA_D64
      ", %64, %65, 1;\n"
      : LCA_IACC64(d)
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_s8_first(uint32_t (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " LCA_D64
      ", %64, %65, 0;\n"
      : LCA_IOUT64(d)
      : "l"(da), "l"(db));
}

// S = Q K^T over d (s8: D / 32 k32 steps)
__device__ __forceinline__ void wgmma_s8_tile(uint32_t (&d)[64], uint32_t a,
                                              uint32_t b) {
  wgmma_s8_first(d, desc_s8_qk(a), desc_s8_qk(b));
#pragma unroll
  for (int kk = 1; kk < D / 32; ++kk)
    wgmma_s8(d, desc_s8_qk(a + 32 * kk), desc_s8_qk(b + 32 * kk));
  wgmma_commit();
}

// d (64 x 64 s32) = A (64 x 32 s8) * B (32 x 64 s8), both shared, K-major
// (the d = 64 build's PV; the d = 128 build leaves it unused)
__device__ __forceinline__ void wgmma_s8_n64(uint32_t (&d)[32], uint64_t da,
                                             uint64_t db, bool acc) {
  if (acc)
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " LCA_D32
        ", %32, %33, 1;\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db));
  else
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " LCA_D32
        ", %32, %33, 0;\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
          "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(d[8]), "=r"(d[9]),
          "=r"(d[10]), "=r"(d[11]), "=r"(d[12]), "=r"(d[13]), "=r"(d[14]),
          "=r"(d[15]), "=r"(d[16]), "=r"(d[17]), "=r"(d[18]), "=r"(d[19]),
          "=r"(d[20]), "=r"(d[21]), "=r"(d[22]), "=r"(d[23]), "=r"(d[24]),
          "=r"(d[25]), "=r"(d[26]), "=r"(d[27]), "=r"(d[28]), "=r"(d[29]),
          "=r"(d[30]), "=r"(d[31])
        : "l"(da), "l"(db));
}

// O8 = P8 V^T over a chunk's 128 kv columns (4 k32 steps, 128-byte
// swizzle): N = D, in N / 2 registers
template <int N>
__device__ __forceinline__ void wgmma_s8_pv(uint32_t (&d)[N], uint32_t a,
                                            uint32_t b) {
  static_assert(N == 32 || N == 64, "head dim 64 or 128");
  if constexpr (N == 64) {
    wgmma_s8_first(d, desc_kmajor(a), desc_kmajor(b));
#pragma unroll
    for (int kk = 1; kk < CH / 32; ++kk)
      wgmma_s8(d, desc_kmajor(a + 32 * kk), desc_kmajor(b + 32 * kk));
  } else {
#pragma unroll
    for (int kk = 0; kk < CH / 32; ++kk)
      wgmma_s8_n64(d, desc_kmajor(a + 32 * kk), desc_kmajor(b + 32 * kk),
                   kk > 0);
  }
  wgmma_commit();
}

// ... bf16: D / 16 k16 steps, 4 in each 64-column d box
__device__ __forceinline__ void wgmma_bf16_tile(float (&d)[64], uint32_t a,
                                                uint32_t b) {
  wgmma_ss_first(d, desc_kmajor(a), desc_kmajor(b));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss(d, desc_kmajor(a + (kk >> 2) * BOX + (kk & 3) * 32),
             desc_kmajor(b + (kk >> 2) * BOX + (kk & 3) * 32));
  wgmma_commit();
}

// An int of magnitude below 2^22 as float, and a float in [0, 2^22) rounded
// to the nearest int (half to even), exactly, by an add in the 2^23 binade:
// off the conversion unit, which the scores' exp2 already keeps busy
__device__ __forceinline__ float i2f_small(int x) {
  return __fsub_rn(__int_as_float(x + 0x4B400000), 12582912.f);
}

__device__ __forceinline__ int rint_small(float x) {
  return __float_as_int(__fadd_rn(x, 12582912.f)) - 0x4B400000;
}

// 2^x, one MUFU.EX2: results below 2^-126 flush to 0, as the TPU's fp32
// does (exp2f keeps them, at three more instructions per score)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// whether the phase of parity `parity` has completed, without waiting
__device__ __forceinline__ bool mbar_ready(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void st_shared_b16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr),
               "h"((unsigned short)v)
               : "memory");
}

// ---------------------------------------------------------------------------
// The producer's operand makers (128 threads, a chunk of 128 kv rows)
// ---------------------------------------------------------------------------

// A raw chunk of the cast path (int8 or fp8: D bytes a row; int4: D / 2)
// widened exactly to the swizzled bf16 boxes at dst; rows >= live (past
// the row's length) are zeros. sm90.cuh widen_rows' walk: within each
// 8-thread phase of a 16-byte access the threads read 128 contiguous
// bytes, and the bf16 chunks land on distinct banks.
template <int KV>
__device__ __forceinline__ void widen_chunk(const unsigned char* raw,
                                            unsigned char* dst, int live,
                                            int pt) {
  constexpr int BATCH = 2;
#pragma unroll 1
  for (int it = 0; it < CH * D / 16 / 128; it += BATCH) {
    uint4 w[BATCH];
    int row[BATCH], c[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int idx = (it + u) * 128 + pt;
      if constexpr (D == 128) {
        const int j = idx & 15;
        row[u] = 2 * (idx >> 4) + (((j >> 2) & 1) ^ (j >> 3));
        c[u] = j & 7;  // chunk of 16 values of the row
      } else {
        const int j = idx & 7;
        row[u] = 2 * (idx >> 3) + (j >> 2);
        c[u] = j & 3;
      }
      if constexpr (KV == kKvInt4) {
        const uint2 n = *reinterpret_cast<const uint2*>(raw + row[u] * (D / 2) +
                                                        c[u] * 8);
        s4x8_to_s8(n.x, w[u].x, w[u].y);
        s4x8_to_s8(n.y, w[u].z, w[u].w);
      } else {
        w[u] = *reinterpret_cast<const uint4*>(raw + row[u] * D + c[u] * 16);
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
      if (row[u] >= live) lo = hi = make_uint4(0, 0, 0, 0);
      unsigned char* drow = dst + (c[u] >> 2) * BOX + row[u] * 128;
      const int bc = (c[u] & 3) * 2;  // its first bf16 chunk in the box
      const int sw = row[u] & 7;
      *reinterpret_cast<uint4*>(drow + ((bc ^ sw) << 4)) = lo;
      *reinterpret_cast<uint4*>(drow + (((bc + 1) ^ sw) << 4)) = hi;
    }
  }
}

// s8 int4 K: a raw chunk (D / 2 bytes a row) sign-extended into 128
// swizzled s8 rows of D bytes (d = 128: a quarter warp reads a row's 64
// bytes and writes its 128, 128-byte swizzle; d = 64: an eighth warp its
// 32 and 64, 64-byte swizzle)
__device__ __forceinline__ void extend_rows(const unsigned char* raw,
                                            unsigned char* dst, int pt) {
  constexpr int CPR = D / 16;  // 16-byte s8 chunks a row
#pragma unroll 2
  for (int it = 0; it < CH * CPR / 128; ++it) {
    const int idx = it * 128 + pt;
    const int row = idx / CPR, c = idx % CPR;
    const uint2 n =
        *reinterpret_cast<const uint2*>(raw + row * (D / 2) + c * 8);
    uint4 w;
    s4x8_to_s8(n.x, w.x, w.y);
    s4x8_to_s8(n.y, w.z, w.w);
    // the swizzle: 16-byte chunk c of a row ^ address bits 7-9 (128-byte)
    // or 7-8 (64-byte) of the row's start
    const int sw = D == 128 ? (row & 7) : ((row >> 1) & 3);
    *reinterpret_cast<uint4*>(dst + row * D + ((c ^ sw) << 4)) = w;
  }
}

// s8 V: a raw chunk (128 kv rows of D d bytes, or D / 2 of int4 nibbles
// sign-extended on the way) into V^T (D d rows of 128 kv bytes, 128-byte
// swizzle), sage_fwd_sm90.cu transpose_v's 4 x 4 byte blocks by PRMT over
// the 128 producer threads: lane l takes kv rows 4l .. 4l + 3 and d word
// (l + warp + 4 jj) % (D / 4) at turn jj, so a warp reads 32 banks (d =
// 64: 16, each twice) and, with the swizzle, writes 32.
__device__ __forceinline__ void transpose_chunk(const unsigned char* raw,
                                                unsigned char* dst, int pt,
                                                bool i4) {
  const int lane = pt & 31;
  const int k = 4 * lane;  // the block's first kv row: a V^T byte column
#pragma unroll 2
  for (int jj = 0; jj < D / 16; ++jj) {
    const int dw = (lane + (pt >> 5) + 4 * jj) & (D / 4 - 1);
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = i4 ? s4x4_to_s8(*reinterpret_cast<const unsigned short*>(
                      raw + (k + i) * (D / 2) + 2 * dw))
                : *reinterpret_cast<const uint32_t*>(raw + (k + i) * D +
                                                     4 * dw);
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    const uint32_t o[4] = {__byte_perm(t0, t1, 0x5410),
                           __byte_perm(t0, t1, 0x7632),
                           __byte_perm(t2, t3, 0x5410),
                           __byte_perm(t2, t3, 0x7632)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 4 * dw + i;  // the V^T row: d
      *reinterpret_cast<uint32_t*>(dst + n * 128 +
                                   ((((k >> 4) ^ (n & 7)) << 4) | (k & 15))) =
          o[i];
    }
  }
}

// bf16 V rows [live, 128) of an operand slot (every d box) set to zero
__device__ __forceinline__ void zero_rows(unsigned char* dst, int live,
                                          int pt) {
  constexpr int CPR = D / 8;  // 16-byte chunks of a bf16 row
  for (int i = pt; i < (CH - live) * CPR; i += 128) {
    const int row = live + i / CPR, c = i % CPR;
    *reinterpret_cast<uint4*>(dst + (c >> 3) * BOX + row * 128 +
                              (c & 7) * 16) = make_uint4(0, 0, 0, 0);
  }
}

// ---------------------------------------------------------------------------
// The walk
// ---------------------------------------------------------------------------

// A row's live bkv tiles, each once: the sink tiles before the window's
// band, then the band [start_t, last_t] from the run's first token's window
// to its last token (decode_attention.cu's walk; a sequence-sharded cache's
// row bands from its first column fc, unclipped, with its own sink end);
// the block's split takes tiles [i0, i1) of them
struct Walk {
  int len, first_col, start_t, n_sink, i0, i1, bkv, sink, fc;
  bool sharded;
  __device__ Walk(const Params& p, int ib, int sp) {
    len = p.lengths[ib];
    bkv = p.bkv;
    sharded = p.fc != nullptr;
    fc = sharded ? p.fc[ib] : 0;
    sink = sharded ? (p.scol != nullptr ? p.scol[ib] : 0) : p.sink;
    const int nk = (p.s_max + p.bkv - 1) / p.bkv;
    const int last_t = len > 0 ? min((len - 1) / p.bkv, nk - 1) : -1;
    first_col = sharded ? max(fc, 0)
                        : (p.left >= 0 ? max(len - p.n_tok - p.left, 0) : 0);
    start_t = first_col / p.bkv;
    n_sink = p.left >= 0 || sharded
                 ? min(min((sink + p.bkv - 1) / p.bkv, start_t), last_t + 1)
                 : 0;
    const int n_live = n_sink + max(last_t - start_t + 1, 0);
    i0 = sp * p.tps;
    i1 = min(n_live, i0 + p.tps);
  }
  // the first column of the it-th live tile
  __device__ int c0(int it) const {
    return (it < n_sink ? it : start_t + (it - n_sink)) * bkv;
  }
  // the tile's chunks that hold a column to read, [ca, cz): a sink tile
  // ends at the last sink, the band's first tile starts at the window's
  // first column (or at 0 where it holds sinks), no tile reads past len - 1
  __device__ void chunks(int it, int& ca, int& cz) const {
    const int t0 = c0(it);
    const int hi = min(bkv, (it < n_sink ? min(sink, len) : len) - t0);
    const int lo = t0 < sink ? 0 : max(first_col - t0, 0);
    ca = lo / CH;
    cz = (hi + CH - 1) / CH;
  }
};

// A chunk's step: the live tile, the sweep, the chunk of the tile
struct Step {
  int it, sw, c, ca, cz;
};

template <int NSW>
__device__ __forceinline__ void step_next(const Walk& w, Step& s) {
  if (++s.c < s.cz) return;
  if (++s.sw < NSW) {
    s.c = s.ca;
    return;
  }
  s.sw = 0;
  if (++s.it < w.i1) {
    w.chunks(s.it, s.ca, s.cz);
    s.c = s.ca;
  }
}

template <int K>
struct Sweep {  // the kind of a sweep, for a generic lambda's argument
  static constexpr int value = K;
};
constexpr int kMaxSweep = 0, kStatSweep = 1, kLastSweep = 2;

template <bool S8>
struct Acc {
  using T = float;
};
template <>
struct Acc<true> {
  using T = uint32_t;
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <bool S8, bool SAFE>
__global__ void __launch_bounds__(NT, 1)
    decode_run_kernel(const __grid_constant__ Maps maps, const Params p) {
  using L = Smem<S8>;
  // sweeps over a tile's chunks: the online form's max, the s8 path's
  // requantization max (and l), then the last (P and PV)
  constexpr int NSW = (SAFE ? 1 : 0) + (S8 ? 1 : 0) + 1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 1024-byte aligned base as an offset into the shared array, so the
  // compiler keeps shared-memory instructions (an integer round trip of the
  // address makes them generic)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  auto bar = [&](int i) -> uint32_t { return sbase + L::OFF_BAR + 8 * i; };

  const int rb = blockIdx.x % p.n_rb, sp = blockIdx.x / p.n_rb;
  const int hk = blockIdx.y, ib = blockIdx.z;
  const Walk w(p, ib, sp);
  const bool any = w.i0 < w.i1;  // a split with no live tile writes 0, -inf

  if (threadIdx.x == 0) {
    mbar_init(bar(B_Q), 1);
    for (int s = 0; s < L::KS; ++s) {
      mbar_init(bar(B_KFULL + s), 1);
      mbar_init(bar(B_KEMPTY + s), 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < L::VS; ++s) {
      mbar_init(bar(B_VFULL + s), 1);
      mbar_init(bar(B_VEMPTY + s), 8);
    }
    for (int s = 0; s < LANDS; ++s) mbar_init(bar(B_LAND + s), 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int wtid = threadIdx.x & 127;

  if (wg == 0) {
    // ========================= producer warpgroup =========================
    setmaxnreg_dec<PRODUCER_REGS>();
    if (!any) return;
    const int kind = p.kind;
    const bool quant = kind != kBF16;
    // K lands in its operand slot for bf16 and s8 int8, V for bf16; the
    // other kinds land raw and are made into the operand here
    const bool k_direct = kind == kBF16 || kind == kS8I8;
    const bool v_direct = kind == kBF16;
    const int raw_bytes = (kind == kS8I4 || kind == kCastI4) ? RAW / 2 : RAW;
    // the storage of the chunk at column col: its pool page (paged; thread
    // 0 keeps the last page-table entry it read) or the row's slab
    // (dense), and its first slot there
    int pt_at = -1, pt_page = 0;
    auto where = [&](int col, int& off) -> int {
      int pg = ib;
      off = col;
      if (p.pt != nullptr) {
        if (col / p.page != pt_at) {
          pt_at = col / p.page;
          pt_page = min(max(p.pt[(long long)ib * p.n_pages + pt_at], 0),
                        p.pool - 1);
        }
        pg = pt_page;
        off = col % p.page;
      }
      return (p.layer * p.pool + pg) * p.h_kv + hk;
    };
    // The producer's stream of items: the K chunk of every step, then in
    // the last sweep the step's V chunk. r is an item's place in the
    // stream (landing barrier and staged scales r % LANDS), u its use of
    // the K or V ring, a the raw slots' use of a raw item (raw slot a %
    // RAWS); nk, nv, na the next uses.
    auto direct = [&](bool v) -> bool { return v ? v_direct : k_direct; };
    struct Item {
      Step s;
      bool v;
      int r, u, a, nk, nv, na;
    };
    // a kept tile (s8, at most KEEP chunks) loads its K chunks once, in
    // the first sweep, and its V chunks after them
    auto advance = [&](Item& x) {
      ++x.r;
      if (S8 && x.s.cz - x.s.ca <= KEEP) {
        if (++x.s.c >= x.s.cz) {
          if (!x.v) {  // the tile's V chunks
            x.s.c = x.s.ca;
            x.s.sw = NSW - 1;
            x.v = true;
          } else {  // the next tile
            x.v = false;
            step_next<NSW>(w, x.s);
          }
        }
      } else if (!x.v && x.s.sw == NSW - 1) {
        x.v = true;
      } else {
        x.v = false;
        step_next<NSW>(w, x.s);
      }
      x.u = x.v ? x.nv++ : x.nk++;
      if (!direct(x.v)) x.a = x.na++;
    };
    auto ring = [&](const Item& x) -> int { return x.v ? L::VS : L::KS; };
    auto slot = [&](const Item& x) -> int { return x.u % ring(x); };
    auto empty_of = [&](const Item& x) -> uint32_t {
      return bar((x.v ? B_VEMPTY : B_KEMPTY) + slot(x));
    };
    auto empty_parity = [&](const Item& x) -> int {
      return ((x.u / ring(x)) & 1) ^ 1;
    };
    auto operand = [&](const Item& x) -> int {
      return (x.v ? L::OFF_V : L::OFF_K) + slot(x) * L::OP;
    };
    // thread 0 starts the item's TMA: the chunk into its operand slot
    // (direct kinds, once the slot is free) or a landing slot, and a K
    // chunk's scales into the landing slot's staging
    auto issue = [&](const Item& x) {
      int off;
      const int slab = where(w.c0(x.s.it) + x.s.c * CH, off);
      const int li = x.r % LANDS;
      const uint32_t land = bar(B_LAND + li);
      const CUtensorMap* map = x.v ? &maps.v : &maps.k;
      const bool sc = !x.v && quant;
      if (direct(x.v)) {
        const uint32_t dst = sbase + operand(x);
        mbar_wait(empty_of(x), empty_parity(x));
        mbar_expect_tx(land, L::OP + (sc ? 2 * CH * 4 : 0));
        tma_load_3d(dst, map, land, 0, off, slab);
        if (!S8 && NBOX == 2) tma_load_3d(dst + BOX, map, land, 64, off, slab);
      } else {
        mbar_expect_tx(land, raw_bytes + (sc ? 2 * CH * 4 : 0));
        tma_load_3d(sbase + L::OFF_RAW + (x.a % RAWS) * RAW, map, land, 0,
                    off, slab);
      }
      if (sc) {
        const uint32_t stg = sbase + L::OFF_STG + li * 1024;
        tma_load_2d(stg, &maps.ks, land, off, slab);
        tma_load_2d(stg + CH * 4, &maps.vs, land, off, slab);
      }
    };
    // all 128 threads finish it: the operand made from the landing slot,
    // the scales beside K (1 for bf16, 0 past the row's length), then the
    // slot's full barrier
    auto complete = [&](const Item& x) {
      const int col = w.c0(x.s.it) + x.s.c * CH;
      const int live = min(CH, w.len - col);  // rows below the row's length
      const int li = x.r % LANDS;
      unsigned char* dst = smem + operand(x);
      const unsigned char* raw = smem + L::OFF_RAW + (x.a % RAWS) * RAW;
      mbar_wait(empty_of(x), empty_parity(x));
      mbar_wait(bar(B_LAND + li), (x.r / LANDS) & 1);
      if (!direct(x.v)) {
        if (!kMake) {
        } else if constexpr (S8) {
          if (x.v)
            transpose_chunk(raw, dst, wtid, kind == kS8I4);
          else
            extend_rows(raw, dst, wtid);
        } else {
          switch (kind) {
            case kCastF8:
              widen_chunk<kKvFp8>(raw, dst, live, wtid);
              break;
            case kCastI4:
              widen_chunk<kKvInt4>(raw, dst, live, wtid);
              break;
            case kCastI8:
            default:
              widen_chunk<kKvInt8>(raw, dst, live, wtid);
          }
        }
      } else if (!S8 && x.v && live < CH) {
        zero_rows(dst, live, wtid);
      }
      if (!x.v) {
        const float* stg =
            reinterpret_cast<const float*>(smem + L::OFF_STG + li * 1024);
        float* sc = reinterpret_cast<float*>(smem + L::OFF_SC +
                                             slot(x) * 1024);
        const bool in = wtid < live;
        sc[wtid] = in ? (quant ? stg[wtid] : 1.f) : 0.f;
        sc[CH + wtid] = in ? (quant ? stg[CH + wtid] : 1.f) : 0.f;
      }
      fence_proxy_async();
      named_sync(NB_PRODUCER, 128);
      if (threadIdx.x == 0)
        mbar_arrive(bar((x.v ? B_VFULL : B_KFULL) + slot(x)));
    };

    if (threadIdx.x == 0) {  // Q: the block's 128 rows of the kv head
      const int row = rb * BR, z = ib * p.h_kv + hk;
      mbar_expect_tx(bar(B_Q), L::OP);
      tma_load_3d(sbase, &maps.q, bar(B_Q), 0, row, z);
      if (!S8 && NBOX == 2)
        tma_load_3d(sbase + BOX, &maps.q, bar(B_Q), 64, row, z);
    }
    // ic: the next item thread 0 issues, cc: the next all complete. Up to
    // LANDS items are in flight, RAWS of them raw; a direct item goes once
    // its slot's last user is complete and the consumers have released it
    // (else thread 0 would wait on the consumers while they wait on the
    // items it holds back), except the next to complete, which may wait.
    // Warp 0 runs the issue loop in step (its lanes' decisions are thread
    // 0's), so no lane of it waits on a barrier while thread 0 issues.
    Item cc;
    cc.s.it = w.i0;
    cc.s.sw = 0;
    w.chunks(w.i0, cc.s.ca, cc.s.cz);
    cc.s.c = cc.s.ca;
    cc.v = false;
    cc.r = cc.u = cc.nv = 0;
    cc.nk = 1;
    cc.a = 0;
    cc.na = k_direct ? 0 : 1;
    Item ic = cc;
    int k_done = 0, v_done = 0;  // completed uses of the K and V rings
    int a_done = 0;              // completed raw items
    while (cc.s.it < w.i1) {
      while (wtid < 32) {
        bool go = ic.s.it < w.i1 && ic.r - cc.r < LANDS &&
                  (direct(ic.v)
                       ? ic.u < (ic.v ? v_done : k_done) + ring(ic) &&
                             (ic.r == cc.r ||
                              mbar_ready(empty_of(ic), empty_parity(ic)))
                       : ic.a < a_done + RAWS);
        if (!__shfl_sync(0xffffffffu, go, 0)) break;
        if (threadIdx.x == 0) issue(ic);
        __syncwarp();
        advance(ic);
      }
      complete(cc);
      if (cc.v)
        ++v_done;
      else
        ++k_done;
      if (!direct(cc.v)) ++a_done;
      advance(cc);
    }
  } else {
    // ========================= consumer warpgroups =========================
    setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;          // which 64 rows of the block
    const int warp = wtid >> 5;     // 16 rows each
    const int lane = wtid & 31;
    const int g = lane >> 2;        // accumulator row (and row + 8)
    const int cb = 2 * (lane & 3);  // accumulator column pair in each 8
    const int rbase = rb * BR + cw * 64;
    const bool idle = rbase >= p.G;  // no row of this warpgroup exists
    // this warpgroup's 64 rows of Q: rows of 128 bytes in each bf16 box,
    // of D bytes on the s8 path
    const uint32_t q_half = sbase + cw * 64 * (S8 ? D : 128);
    const bool alibi = p.slopes != nullptr;
    const float cap = p.cap;
    const bool feat = cap > 0.f || alibi;
    const int sink = w.sink;

    // the thread's rows g and g + 8: their positions' bounds (columns <=
    // qlim, and >= wlo unless a sink; sharded: wlo = fc + the row's token),
    // score multipliers and ALiBi slopes
    int qlim[2], wlo[2];
    float rs[2], slope[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rbase + warp * 16 + g + 8 * hh;
      const bool real = r < p.G;
      qlim[hh] = w.len - p.n_tok + r % p.n_tok;
      wlo[hh] = w.sharded     ? w.fc + r % p.n_tok
                : p.left >= 0 ? qlim[hh] - p.left
                              : INT_MIN;
      rs[hh] = S8 ? (real ? p.qs[((long long)ib * p.h_kv + hk) * p.G + r]
                          : 0.f)
                  : (SAFE ? p.sscale : 1.f);
      slope[hh] = alibi && real ? p.slopes[(long long)hk * p.G + r] : 0.f;
    }
    // a chunk that every row of the warp sees whole skips the mask
    const int qmin = __reduce_min_sync(0xffffffffu, min(qlim[0], qlim[1]));
    const int wmax = __reduce_max_sync(0xffffffffu, max(wlo[0], wlo[1]));

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    // the s8 tile's P scale of each row, and its reciprocal
    float ps[2] = {1.f, 1.f}, rps[2] = {1.f, 1.f};
    const uint32_t p8s = sbase + L::OFF_P8 + cw * P8;

    // the scores of 8-column group i8 (rows g, g + 8; columns cb, cb + 1)
    // handed to body(i8, v, v_scales) group by group
    // `masked`: the row bounds, in a chunk some row of the warp does not see
    // whole; `feat`: the softcap or ALiBi, run-time branches that the other
    // forms keep out of the loop (a branch per score keeps ptxas from
    // interleaving the scores' dependent chains)
    auto scores = [&](const typename Acc<S8>::T (&acc)[64], const float* sks,
                      int col0, auto masked, auto feat, auto&& body) {
#pragma unroll
      for (int i8 = 0; i8 < 16; ++i8) {
        const float2 ksc = *reinterpret_cast<const float2*>(sks + 8 * i8 + cb);
        const float2 vsc =
            *reinterpret_cast<const float2*>(sks + CH + 8 * i8 + cb);
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int col = col0 + 8 * i8 + cb + (e & 1);
          float s;
          if constexpr (S8)
            s = i2f_small((int)acc[4 * i8 + e]) * rs[hh];
          else
            s = acc[4 * i8 + e] * rs[hh];
          s *= (e & 1) ? ksc.y : ksc.x;
          if (decltype(feat)::value) {
            if (cap > 0.f) s = cap * tanhf(s / cap);
            // ALiBi, after the softcap: -slope * (q - col), the product
            // rounded on its own as in the plain version
            if (alibi) s = s - __fmul_rn(slope[hh], (float)(qlim[hh] - col));
          }
          if (decltype(masked)::value &&
              (col > qlim[hh] || (col < wlo[hh] && col >= sink)))
            s = kNegInf;
          v[e] = s;
        }
        body(i8, v, vsc);
      }
    };
    auto prob = [&](float s, int hh) -> float {
      if constexpr (SAFE)
        return s == kNegInf ? 0.f : expf(s - m[hh]);  // masked column: 0
      else
        return exp2_ftz(fminf(s, kClamp));
    };
    auto quad_max = [&](float x) -> float {
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    };
    auto quad_sum = [&](float x) -> float {
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      return x + __shfl_xor_sync(0xffffffffu, x, 2);
    };
    auto release = [&](uint32_t b) {
      if (lane == 0) mbar_arrive(b);
    };

    int kit = 0, vit = 0;
    if (any) mbar_wait(bar(B_Q), 0);
    // one sweep over the chunks [ca, cz) of the tile at column t0
    // `keep`: the tile's K chunks stay in their slots until the last sweep
    auto sweep = [&](auto kind, int t0, int ca, int cz, bool keep) {
      constexpr int SW = decltype(kind)::value;
      float st[2] = {SW == kMaxSweep ? kNegInf : 0.f,
                     SW == kMaxSweep ? kNegInf : 0.f};  // the row statistic
      float lp[2] = {0.f, 0.f};                         // the row sums of p
      for (int c = ca; c < cz; ++c, ++kit) {
        const int col0 = t0 + c * CH;
        const int ks = kit % L::KS;
        mbar_wait(bar(B_KFULL + ks), (kit / L::KS) & 1);
        typename Acc<S8>::T acc[64];
        [[maybe_unused]] uint32_t pa[S8 ? 1 : 32];  // bf16 P: PV's A
        if (!idle && kMath) {
          wgmma_fence();
          if constexpr (S8)
            wgmma_s8_tile(acc, q_half, sbase + L::OFF_K + ks * L::OP);
          else
            wgmma_bf16_tile(acc, q_half, sbase + L::OFF_K + ks * L::OP);
          wgmma_wait<0>();
          reg_fence(acc);
          const float* sks =
              reinterpret_cast<const float*>(smem + L::OFF_SC + ks * 1024);
          const bool full = __all_sync(
              0xffffffffu, col0 + CH - 1 <= qmin &&
                               (col0 >= wmax || col0 + CH - 1 < sink));
          auto body = [&](int i8, const float (&v)[4], float2 vsc) {
            if constexpr (SW == kMaxSweep) {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                st[e >> 1] = fmaxf(st[e >> 1], v[e]);
            } else if constexpr (SW == kStatSweep) {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                st[e >> 1] = fmaxf(st[e >> 1], prob(v[e], e >> 1) *
                                                   ((e & 1) ? vsc.y : vsc.x));
            } else if constexpr (S8) {
              // p8 = rint(p * v_scale / ps): bytes of columns cb, cb + 1
              uint32_t b2[2] = {0u, 0u};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int hh = e >> 1;
                const float pp = prob(v[e], hh);
                lp[hh] += pp;
                const float pe = pp * ((e & 1) ? vsc.y : vsc.x);
                // the division, rounded to nearest (one correction step of
                // the reciprocal's quotient), with no branch to a slow path
                const float q0 = pe * rps[hh];
                const float q =
                    __fmaf_rn(__fmaf_rn(-q0, ps[hh], pe), rps[hh], q0);
                b2[hh] |= (uint32_t)min(rint_small(q), 127) << (8 * (e & 1));
              }
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int r = warp * 16 + g + 8 * hh;
                st_shared_b16(p8s + r * 128 +
                                  ((((i8 >> 1) ^ (r & 7)) << 4) |
                                   ((i8 & 1) << 3) | cb),
                              b2[hh]);
              }
            } else {
              float pv[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float pe = prob(v[e], e >> 1);
                lp[e >> 1] += pe;
                pv[e] = pe * ((e & 1) ? vsc.y : vsc.x);
              }
              pa[2 * i8] = pack_bf16(pv[0], pv[1]);
              pa[2 * i8 + 1] = pack_bf16(pv[2], pv[3]);
            }
          };
          // the last PV has read P8 before it is written again
          if (S8 && SW == kLastSweep) named_sync(NB_P8 + cw, 128);
          if (full && !feat)
            scores(acc, sks, col0, Flag<false>(), Flag<false>(), body);
          else if (!feat)
            scores(acc, sks, col0, Flag<true>(), Flag<false>(), body);
          else if (full)
            scores(acc, sks, col0, Flag<false>(), Flag<true>(), body);
          else
            scores(acc, sks, col0, Flag<true>(), Flag<true>(), body);
        }
        if (!keep || SW == kLastSweep) release(bar(B_KEMPTY + ks));
        if constexpr (SW == kLastSweep) {
          const int vsl = vit % L::VS;
          mbar_wait(bar(B_VFULL + vsl), (vit / L::VS) & 1);
          const uint32_t vop = sbase + L::OFF_V + vsl * L::OP;
          if (!idle && kMath) {
            if constexpr (S8) {
              fence_proxy_async();
              named_sync(NB_P8 + cw, 128);  // every row's P8 is written
              // the scores' accumulator, done with, holds the product
              uint32_t(&pacc)[D / 2] =
                  *reinterpret_cast<uint32_t(*)[D / 2]>(&acc);
              wgmma_fence();
              wgmma_s8_pv(pacc, p8s, vop);
              wgmma_wait<0>();
              reg_fence(pacc);
#pragma unroll
              for (int k = 0; k < D / 2; ++k)
                o[k] += i2f_small((int)pacc[k]) * ps[(k >> 1) & 1];
            } else {
              wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < CH / 16; ++kk)
                wgmma_rs_d(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                           pa[4 * kk + 3], desc_mnmajor(vop + kk * 2048));
              wgmma_commit();
              wgmma_wait<0>();
              reg_fence(o);
              reg_fence(pa);
            }
          }
          release(bar(B_VEMPTY + vsl));
          ++vit;
        }
      }
      if (idle) return;
      // the tile's statistics, over the quad that holds each row
      if constexpr (SW == kMaxSweep) {
        float alpha[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float m_new = fmaxf(m[hh], quad_max(st[hh]));
          alpha[hh] = expf(m[hh] - m_new);
          m[hh] = m_new;
          l[hh] *= alpha[hh];
        }
#pragma unroll
        for (int k = 0; k < D / 2; ++k) o[k] *= alpha[(k >> 1) & 1];
      } else if constexpr (SW == kStatSweep) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          ps[hh] = fmaxf(quad_max(st[hh]), 1e-20f) * (1.0f / 127.0f);
          rps[hh] = __frcp_rn(ps[hh]);
        }
      } else {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l[hh] += quad_sum(lp[hh]);
      }
    };
    for (int it = w.i0; it < w.i1; ++it) {
      int ca, cz;
      w.chunks(it, ca, cz);
      const int t0 = w.c0(it);
      // a kept tile's sweeps read the same K uses again
      const bool keep = S8 && cz - ca <= KEEP;
      const int k0 = kit;
      if constexpr (SAFE) sweep(Sweep<kMaxSweep>(), t0, ca, cz, keep);
      if (keep) kit = k0;
      if constexpr (S8) sweep(Sweep<kStatSweep>(), t0, ca, cz, keep);
      if (keep) kit = k0;
      sweep(Sweep<kLastSweep>(), t0, ca, cz, keep);
    }

    // emit this split's partial: out = acc / l (0 on a dead row), lse
    if (!idle) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = rbase + warp * 16 + g + 8 * hh;
        if (r >= p.G) continue;
        const long long ob =
            (((long long)ib * p.splits + sp) * p.h_kv + hk) * p.G + r;
        const float lv = l[hh];
        float* orow = p.out + ob * D;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const float x0 = lv == 0.f ? 0.f : o[4 * i + 2 * hh] / lv;
          const float x1 = lv == 0.f ? 0.f : o[4 * i + 2 * hh + 1] / lv;
          *reinterpret_cast<float2*>(orow + 8 * i + cb) = make_float2(x0, x1);
        }
        if ((lane & 3) == 0)
          p.lse[ob] = lv == 0.f ? __int_as_float(0xff800000)  // -inf
                                : (SAFE ? m[hh] + logf(lv) : logf(lv));
      }
    }
  }
}

// One block per (query row, kv head, batch row), one thread per output
// feature: the -inf-safe N-way LSE merge of the splits (ops/merge.py
// merge_partials)
__global__ void __launch_bounds__(D)
    merge_rows(const float* part_out, const float* part_lse, float* out,
               float* lse, int h_kv, int G, int splits) {
  const int r = blockIdx.x, hk = blockIdx.y, ib = blockIdx.z;
  const int tid = threadIdx.x;
  const float neg_inf = __int_as_float(0xff800000);
  auto cell = [&](int s) -> long long {
    return (((long long)ib * splits + s) * h_kv + hk) * G + r;
  };
  float m = neg_inf;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_lse[cell(s)]);
  const bool dead = m == neg_inf;
  const float safe_m = dead ? 0.f : m;
  float denom = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float lv = part_lse[cell(s)];
    const float wt = lv == neg_inf ? 0.f : expf(lv - safe_m);
    denom += wt;
    acc += part_out[cell(s) * D + tid] * wt;
  }
  const long long o = ((long long)ib * h_kv + hk) * G + r;
  const float dn = fmaxf(denom, 1e-37f);
  out[o * D + tid] = dead ? 0.f : acc / dn;
  if (tid == 0) lse[o] = dead ? neg_inf : safe_m + logf(dn);
}

template <bool S8, bool SAFE>
int launch(const Maps& maps, const Params& p, cudaStream_t stream) {
  auto kern = decode_run_kernel<S8, SAFE>;
  constexpr int bytes = Smem<S8>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(p.n_rb * p.splits, p.h_kv, p.b), NT, bytes, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dims: b, h_kv, G, s_max, layer, bkv, splits, tiles_per_split, left, sink,
// n_tok, pool, page, n_pages, kind: decode_attention.cu's, and the same C
// signature (lca_decode_attention). bkv is a multiple of 128 that divides
// the page (dense: page = s_max, pool = b, pt null, n_pages = 1); d = D,
// the library's head dim.
// out (b, h_kv, G, D) and lse (b, h_kv, G) fp32; with splits > 1 the
// partials go to part_out (b, splits, h_kv, G, D) / part_lse first and a
// second kernel merges them. slopes: ALiBi's (h_kv, G) row slopes (times
// log2e in the fast form), or null. first_cols, sink_cols: a
// sequence-sharded cache's (b,) first columns and sink ends, or null
// (decode_attention.cu's).
extern "C" int lca_decode_run(const void* q, const float* qs, const void* k,
                              const void* v, const float* ks, const float* vs,
                              const int* lengths, const int* pt,
                              float* part_out, float* part_lse, float* out,
                              float* lse, const long long* dims, float sscale,
                              float cap, int safe, void* stream,
                              const float* slopes,
                              const int* first_cols,
                              const int* sink_cols) {
  Params p;
  p.qs = qs;
  p.ks = ks;
  p.vs = vs;
  p.slopes = slopes;
  p.lengths = lengths;
  p.pt = pt;
  p.fc = first_cols;
  p.scol = sink_cols;
  if (first_cols == nullptr && sink_cols != nullptr)
    return (int)cudaErrorInvalidValue;
  p.b = (int)dims[0];
  p.h_kv = (int)dims[1];
  p.G = (int)dims[2];
  p.s_max = (int)dims[3];
  p.layer = (int)dims[4];
  p.bkv = (int)dims[5];
  p.splits = (int)dims[6];
  p.tps = (int)dims[7];
  p.left = (int)dims[8];
  p.sink = (int)dims[9];
  p.n_tok = (int)dims[10];
  p.pool = (int)dims[11];
  p.page = (int)dims[12];
  p.n_pages = (int)dims[13];
  p.kind = (int)dims[14];
  p.sscale = sscale;
  p.cap = cap;
  if (p.b < 1 || p.h_kv < 1 || p.G < 1 || p.n_tok < 1 || p.G % p.n_tok ||
      p.bkv < CH || p.bkv % CH || p.page % p.bkv || p.layer < 0 ||
      p.splits < 1 || p.tps < 1 || p.kind < kBF16 || p.kind > kCastI4)
    return (int)cudaErrorInvalidValue;
  p.n_rb = (p.G + BR - 1) / BR;
  if (p.h_kv > 65535 || p.b > 65535) return (int)cudaErrorInvalidValue;
  const bool s8 = p.kind == kS8I8 || p.kind == kS8I4;
  // scales exactly when quantized, q row scales exactly on the s8 path
  if ((p.kind == kBF16) != (ks == nullptr) || s8 != (qs != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool merge = p.splits > 1;
  if (merge && (part_out == nullptr || part_lse == nullptr))
    return (int)cudaErrorInvalidValue;
  p.out = merge ? part_out : out;
  p.lse = merge ? part_lse : lse;

  // the tensor maps: q (b * h_kv, G, d); the cache's rows (L * P * h_kv
  // slabs of page rows), bf16 and s8 int8 K as wgmma's swizzled operand,
  // the other kinds raw
  Maps maps;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapDataType b16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long bh = (long long)p.b * p.h_kv;
  const long long q_dims[3] = {D, p.G, bh};
  const long long q_str[2] = {D, (long long)p.G * D};
  const cuuint32_t q_box[3] = {s8 ? (cuuint32_t)D : 64u, (cuuint32_t)BR, 1};
  // s8 rows of 64 bytes take the 64-byte swizzle
  const CUtensorMapSwizzle s8_sw =
      D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const bool i4 = p.kind == kS8I4 || p.kind == kCastI4;
  const long long row = p.kind == kBF16 ? D : (i4 ? D / 2 : D);  // elements
  // the slabs of layers [0, layer] (the C call carries no layer count;
  // the chunks read lie in the last of them)
  const long long slabs = ((long long)p.layer + 1) * p.pool * p.h_kv;
  const long long kv_dims[3] = {row, p.page, slabs};
  const long long kv_str[2] = {row, (long long)p.page * row};
  const cuuint32_t op_box[3] = {p.kind == kBF16 ? 64u : (cuuint32_t)D,
                                (cuuint32_t)CH, 1};
  const cuuint32_t raw_box[3] = {(cuuint32_t)row, (cuuint32_t)CH, 1};
  const bool k_direct = p.kind == kBF16 || p.kind == kS8I8;
  const bool v_direct = p.kind == kBF16;
  const CUtensorMapDataType kvt = p.kind == kBF16 ? b16 : u8;
  const int kve = p.kind == kBF16 ? 2 : 1;
  // the scales (L * P * h_kv slabs of page fp32), a chunk's 128 a box
  const long long sc_dims[2] = {p.page, slabs};
  const long long sc_str[1] = {p.page};
  const cuuint32_t sc_box[2] = {(cuuint32_t)CH, 1};
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const bool ok =
      (ks == nullptr ||
       (encode(&maps.ks, ks, f32, 4, 2, sc_dims, sc_str, sc_box,
               CU_TENSOR_MAP_SWIZZLE_NONE) &&
        encode(&maps.vs, vs, f32, 4, 2, sc_dims, sc_str, sc_box,
               CU_TENSOR_MAP_SWIZZLE_NONE))) &&
      encode(&maps.q, q, s8 ? u8 : b16, s8 ? 1 : 2, 3, q_dims, q_str, q_box,
             s8 ? s8_sw : CU_TENSOR_MAP_SWIZZLE_128B) &&
      encode(&maps.k, k, kvt, kve, 3, kv_dims, kv_str,
             k_direct ? op_box : raw_box,
             k_direct ? (s8 ? s8_sw : CU_TENSOR_MAP_SWIZZLE_128B)
                      : CU_TENSOR_MAP_SWIZZLE_NONE) &&
      encode(&maps.v, v, kvt, kve, 3, kv_dims, kv_str,
             v_direct ? op_box : raw_box,
             v_direct ? CU_TENSOR_MAP_SWIZZLE_128B
                      : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return (int)cudaErrorInvalidValue;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = s8 ? (safe ? launch<true, true>(maps, p, st)
                       : launch<true, false>(maps, p, st))
               : (safe ? launch<false, true>(maps, p, st)
                       : launch<false, false>(maps, p, st));
  if (err != 0 || !merge) return err;
  merge_rows<<<dim3(p.G, p.h_kv, p.b), D, 0, st>>>(part_out, part_lse, out,
                                                    lse, p.h_kv, p.G,
                                                    p.splits);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block (ptxas reports static memory only): the
// bf16 operands' (s8 0) or the s8 path's (1)
extern "C" int lca_decode_run_smem(int s8) {
  return s8 ? Smem<true>::BYTES : Smem<false>::BYTES;
}

extern "C" const char* lca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
