// Sage attention forward for Hopper (sm_90a only): int8 QK^T on wgmma's s8
// path, TMA and a warp-specialised pipeline.
//
// Replaces the TPU kernels of long_context_attention_tpu/ops/sage.py (shared
// step _sage_compute, emit _emit):
//   lca_sage_fwd_tri <- _sage_kernel_tri: causal self-attention, s_q == s_kv;
//   lca_sage_fwd_pos <- _sage_kernel_pos: q rows at global positions
//                       q_off + i against kv columns at j, causal (or
//                       bottom-right), sliding window (left, right) and
//                       StreamingLLM sinks.
// (_sage_kernel_rect, no mask, stays on mma.sync in flash_fwd.cu.)
//
// Inputs: int8 q8 (b, s_q, h, 128), k8 and v8 (b, s_kv, h_kv, 128), read by
// strides (16-byte aligned, unit stride along d), with fp32 per-token scales
// qs (b, h, s_q; the softmax scale times log2 e folded in), ks and vs (b,
// h_kv, s_kv), any strides. Out bf16 (b, s_q, h, 128) by strides, lse fp32
// (b, h, s_q) contiguous. The arithmetic of _sage_compute and of the
// mma.sync kernels before this one; only the order of the sums differs,
// and a p below 2^-126 is 0 (as on the TPU):
//   s = (float)(q8 . k8)_s32 * qs[row] * ks[col]   (exp2 units)
//   a masked s is -1e30; p = exp2(min(s, 90)); l += rowsum(p); then
//   p *= vs[col]; acc += bf16(p) @ bf16(v8); out = acc / l, lse = ln l;
//   a row with l == 0 (it sees no column) gives out 0 and lse -inf.
//   Masks (flash-attn semantics, global positions): drop col > row + right
//   (right = 0 when causal) and col < row - left unless col < sink.
//
// What bounds it on an H100: tensor-core operations. Each visible (row,
// column) pair costs 2*d int8 ops (QK, 1979 TOP/s) and 2*d bf16 FLOPs (PV,
// 989 TFLOP/s); the bytes (int8 q, k, v, the scales and the bf16 out once)
// are a few percent of that time at the prefill shapes.
//
// Design: B1's and B3's (flash_fwd_sm90.cu). One persistent block per SM
// walks (q tile of 128, head, batch) items, the longest rows first, dealt to
// the blocks in the snake order. A block has two producer warpgroups and two
// consumer warpgroups:
//   * QK^T is wgmma m64n128k32 s32.s8.s8. For 8-bit types wgmma has no
//     transpose, so both operands are K-major: q8 and k8 rows are
//     d-contiguous, and one int8 row of d = 128 is one 128-byte swizzle row,
//     so a q or k tile is one TMA box of 128 x 128 bytes and each k32 step
//     moves the descriptors 32 bytes. K needs no widening: TMA writes it
//     straight into the operand stage.
//   * The s32 accumulator has the fp32 fragment layout; the consumers (two
//     warpgroups of 64 q rows, setmaxnreg 200) convert it, scale, mask (an
//     unmasked copy runs the tiles every row of the warpgroup sees whole),
//     exponentiate, sum l, multiply by V's scale, and pack P to bf16 in
//     registers as the A operand of O += P V (wgmma m64n128k16 bf16, V the
//     MN-major B operand). QK(j) and PV(j - 1) issue together; the softmax
//     of tile j waits for both and packs P group by group into the A
//     registers PV(j - 1) read, so the scores' registers free as it goes.
//     FlashAttention-3's overlap of softmax(j) with PV(j - 1) keeps both P
//     buffers and the scores live: at this register budget it spilled and
//     ran slower; FA3's ping-pong of the two warpgroups' products (turns
//     passed at issue or at completion) and widening V in the consumers
//     while their products run did not run faster either. No accumulator
//     is carried across iterations (ptxas would serialize every wgmma,
//     C7515).
//   * V is int8 in memory and bf16 for PV. Each item re-reads every V tile of
//     its walk, so widening is the producers' main work: both producer
//     warpgroups (setmaxnreg 56) widen each V tile, 64 rows each, from a
//     ring of raw int8 slots that TMA fills ahead (B3's exact PRMT / LOP3 /
//     bf16x2 widening, sm90.cuh), into the 128-byte-swizzled bf16 stage.
//   * One thread issues the TMA of Q (once per item), of each K tile and
//     of the raw V tiles; the 128 lanes of warpgroup 1 copy each tile's 128
//     k and v scales by 4-byte cp.async (zeros past s_kv) beside K,
//     arriving on K's full barrier when they land: the scales take any
//     strides and any s_kv. The producers' instructions share the SM's
//     issue slots with the consumers' softmax: their cursor works out an
//     item's coordinates and walk once per item, and the two producer
//     warpgroups meet at a named barrier after each tile (letting them
//     drift apart measured slower).
//
// Shared memory (bytes): Q 16384 + 3 stages x (K 16384 + widened V 32768 +
// scales 1024) + 2 raw V slots x 16384 = 199680, + 256 of barriers and 1024
// of alignment slack.
//
// The kv walk is the TPU kernels' (_banded_gt) at BKV = 128: the sink tiles
// that lie before the band, then the band; a tile outside the walk is never
// read (TMA zero-fills rows past s_kv, which the mask also drops).
//
// The tensor maps are encoded on the host per call (sm90.cuh) and passed as
// __grid_constant__ kernel parameters.

#include "sm90.cuh"

namespace {

constexpr int D = 128;
constexpr int BQ = 128;   // q rows per item: 64 per consumer warpgroup
constexpr int BKV = 128;  // kv columns per tile
constexpr int PWG = 2;    // producer warpgroups
constexpr int NT = 128 * (PWG + 2);
constexpr int PRODUCER_REGS = 56;
// the consumers take what the producers give back (setmaxnreg.inc waits
// for them): 65536 registers over the block's 512 threads at launch
constexpr int CONSUMER_REGS = (65536 - 128 * PWG * PRODUCER_REGS) / 256 / 8 * 8;
constexpr float kClamp = 90.f;
constexpr float kNegInf = -1e30f;

// Builds that time one side of the pipeline alone (scripts/
// torch_sage_bound.py; their results are wrong): 1 skips the consumers'
// products and softmax, 2 the producers' widening. 0, the kernel, does all.
#ifndef LCA_SAGE_PART
#define LCA_SAGE_PART 0
#endif
constexpr bool kMath = LCA_SAGE_PART != 1;
constexpr bool kWiden = LCA_SAGE_PART != 2;

// Shared memory. An int8 q or k tile is 128 rows of 128 bytes, TMA-written
// with CU_TENSOR_MAP_SWIZZLE_128B (1024-byte atoms of 8 rows) as wgmma reads
// it; a widened V tile is two such boxes of 64 bf16 columns.
constexpr int T8 = BKV * D;          // an int8 tile: 16 KB
constexpr int BOX = 128 * 128;       // a bf16 box of 128 rows x 64 columns
constexpr int VW = 2 * BOX;          // a widened V tile
constexpr int SC = 2 * BKV * 4;      // a tile's k and v scales
constexpr int STAGES = 3;
constexpr int STAGE = T8 + VW + SC;  // K, V, scales: 49 KB
constexpr int RAW_SLOTS = 2;         // raw int8 V tiles
constexpr int OFF_STAGE = T8;        // after Q
constexpr int OFF_RAW = OFF_STAGE + STAGES * STAGE;
constexpr int OFF_BAR = OFF_RAW + RAW_SLOTS * T8;
constexpr int SMEM_BYTES = OFF_BAR + 256 + 1024;  // barriers, alignment
static_assert(STAGE % 1024 == 0, "stages keep the 1024-byte swizzle atoms");
static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block may use");

// mbarrier slots: Q; the K (with the scales) and V halves of the stages,
// full and empty (consumers release K after its softmax and V after PV);
// the raw V slots
constexpr int B_QFULL = 0, B_QEMPTY = 1, B_KFULL = 2, B_VFULL = 5,
              B_KEMPTY = 8, B_VEMPTY = 11, B_RAW = 14;
static_assert(B_RAW + RAW_SLOTS <= 32, "32 barriers in 256 bytes");

// named barrier (0 is __syncthreads): both producer warpgroups are done
// with a tile (and its raw V slot)
constexpr int NB_PRODUCERS = 1;

struct Maps {  // TMA descriptors, in the kernel's parameter space
  CUtensorMap q, k, v;
};

struct Params {
  const float* qs;
  const float* ks;
  const float* vs;
  void* out;
  float* lse;
  int b, h, h_kv, s_q, s_kv;
  long long o_sb, o_ss, o_sh;     // out element strides (batch, seq, head)
  long long qs_sb, qs_sh, qs_ss;  // scale strides (batch, head, seq)
  long long ks_sb, ks_sh, ks_ss;
  long long vs_sb, vs_sh, vs_ss;
  Desc dsc;  // the positions and masks in chunk-local units (sm90.cuh)
  int nq, n_items;
};

// K-major operand (q8, k8): 8-row groups 1024 bytes apart; a k32 step moves
// 32 bytes inside the 128-byte swizzle row
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// MN-major B operand (widened V, [kv, d] with d contiguous): 8 kv rows 1024
// bytes apart, the second 64-column d box BOX bytes after the first
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return desc_sw128(addr, BOX, 1024);
}

// 2^x, one MUFU.EX2: results below 2^-126 flush to 0, as the TPU's fp32
// does (exp2f keeps them, at three more instructions per score)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128 s32) += A (64 x 32 s8, shared, K-major) * B (32 x 128 s8,
// shared, K-major)
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " LCA_D64
      ", %64, %65, 1;\n"
      : LCA_IACC64(d)
      : "l"(da), "l"(db));
}

// d = A * B, as wgmma_s8 with d written, not read: the product's first k
// step does not depend on whatever last defined d's registers
__device__ __forceinline__ void wgmma_s8_first(uint32_t (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " LCA_D64
      ", %64, %65, 0;\n"
      : LCA_IOUT64(d)
      : "l"(da), "l"(db));
}

// ---------------------------------------------------------------------------
// The items and the kv walk
// ---------------------------------------------------------------------------

struct Item {
  int q0, ih, ib;
};

// item t: q tiles from the last (the longest causal rows) to the first,
// heads and batch rows inside
__device__ __forceinline__ Item item_of(const Params& p, int t) {
  const int bh = p.b * p.h;
  const int r = t % bh;
  Item x;
  x.q0 = (p.nq - 1 - t / bh) * BQ;
  x.ih = r % p.h;
  x.ib = r / p.h;
  return x;
}

// the q chunk of a q tile (a tile never crosses a chunk)
__device__ __forceinline__ int q_chunk(const Params& p, int q0) {
  return q0 / p.dsc.cq;
}

template <bool MULTI>
__device__ __forceinline__ KvWalk<BKV, MULTI> walk_of(const Params& p,
                                                      int q0) {
  const int qc = MULTI ? q_chunk(p, q0) : 0;
  const int c0 = qc * p.dsc.cq;
  return KvWalk<BKV, MULTI>(p.dsc, qc, q0 - c0,
                            min(q0 + BQ, p.s_q) - 1 - c0);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// TRI: causal self-attention with compile-time masks (B8a); else the masks
// of Params (B8b). MULTI: a descriptor of two chunks on a side (B8b on the
// ring's steps).
template <bool TRI, bool MULTI = false>
__global__ void __launch_bounds__(NT, 1)
    sage_fwd_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 1024-byte aligned base as an offset into the shared array, so the
  // compiler keeps the scale loads and the widening in shared-memory
  // instructions (an integer round trip of the address makes them generic)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  auto bar = [&](int i) -> uint32_t { return sbase + OFF_BAR + 8 * i; };
  // stage of the i-th tile of the block's stream, and the parity of its use
  // of that stage
  auto stage = [&](int i) -> int { return OFF_STAGE + (i % STAGES) * STAGE; };
  auto use = [&](int i) -> int { return (i / STAGES) & 1; };

  if (threadIdx.x == 0) {
    mbar_init(bar(B_QFULL), 1);
    mbar_init(bar(B_QEMPTY), 8);  // one arrival per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar(B_KFULL + s), 1 + 128);  // TMA's expect_tx, the lanes
      mbar_init(bar(B_VFULL + s), 128 * PWG);
      mbar_init(bar(B_KEMPTY + s), 8);
      mbar_init(bar(B_VEMPTY + s), 8);
    }
    for (int r = 0; r < RAW_SLOTS; ++r) mbar_init(bar(B_RAW + r), 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int wtid = threadIdx.x & 127;

  if (wg < PWG) {
    // ===================== producer warpgroups =====================
    setmaxnreg_dec<PRODUCER_REGS>();
    // the block's kv tiles in order: (j-th item, tile jt), items past the
    // end or with an empty walk skipped; an item's coordinates and walk are
    // worked out once, when the cursor enters it
    struct Cursor {
      int j, jt, ihk;
      Item x;
      KvWalk<BKV, MULTI> w;
    };
    auto enter = [&](int j) -> Cursor {  // the first tile of item j or later
      for (; j * (int)gridDim.x < p.n_items; ++j) {
        const int t = item_index(j);
        if (t >= p.n_items) continue;
        const Item x = item_of(p, t);
        const KvWalk<BKV, MULTI> w = walk_of<MULTI>(p, x.q0);
        if (w.n > 0) return {j, 0, x.ih / (p.h / p.h_kv), x, w};
      }
      return {j, 0, 0, Item{0, 0, 0}, walk_of<MULTI>(p, 0)};
    };
    auto valid = [&](const Cursor& c) -> bool {
      return c.j * (int)gridDim.x < p.n_items;
    };
    auto advance = [&](Cursor& c) {
      if (valid(c) && ++c.jt == c.w.n) c = enter(c.j + 1);
    };
    // the i-th raw V tile of the stream into slot i % RAW_SLOTS
    auto load_v = [&](const Cursor& c, int i) {
      const uint32_t b = bar(B_RAW + i % RAW_SLOTS);
      mbar_expect_tx(b, T8);
      tma_load_4d(sbase + OFF_RAW + (i % RAW_SLOTS) * T8, &maps.v, b, 0,
                  c.w.tile(c.jt) * BKV, c.ihk, c.x.ib);
    };
    Cursor cur = enter(0);
    // thread 0 issues the TMA of K, Q and the raw V tiles, the latter
    // RAW_SLOTS tiles ahead
    Cursor ahead = cur;
    if (threadIdx.x == 0)
      for (int i = 0; i < RAW_SLOTS; ++i) {
        if (valid(ahead)) load_v(ahead, i);
        advance(ahead);
      }
    for (int it = 0, qn = 0; valid(cur); ++it) {
      const int s = it % STAGES;
      const uint32_t full = bar(B_KFULL + s);
      const int kv0 = cur.w.tile(cur.jt) * BKV;
      if (threadIdx.x == 0) {  // K (and at an item's start its Q) by TMA
        mbar_wait(bar(B_KEMPTY + s), use(it) ^ 1);
        mbar_expect_tx(full, T8);
        tma_load_4d(sbase + stage(it), &maps.k, full, 0, kv0, cur.ihk,
                    cur.x.ib);
        if (cur.jt == 0) {
          mbar_wait(bar(B_QEMPTY), (qn & 1) ^ 1);
          mbar_expect_tx(bar(B_QFULL), T8);
          tma_load_4d(sbase, &maps.q, bar(B_QFULL), 0, cur.x.q0, cur.x.ih,
                      cur.x.ib);
        }
      }
      if (cur.jt == 0) ++qn;
      if (wg == PWG - 1) {  // K's scales by the lanes' cp.async
        mbar_wait(bar(B_KEMPTY + s), use(it) ^ 1);
        const int col = kv0 + wtid;
        const bool ok = col < p.s_kv;
        const long long c = ok ? col : 0;
        const uint32_t sc = sbase + stage(it) + T8 + VW + 4 * wtid;
        cp_async4(sc, p.ks + cur.x.ib * p.ks_sb + cur.ihk * p.ks_sh +
                          c * p.ks_ss, ok);
        cp_async4(sc + 4 * BKV, p.vs + cur.x.ib * p.vs_sb +
                                    cur.ihk * p.vs_sh + c * p.vs_ss, ok);
        cp_async_mbar_arrive(full);
      }
      // V: each warpgroup widens its 64 rows of the raw tile
      const int r = it % RAW_SLOTS;
      mbar_wait(bar(B_VEMPTY + s), use(it) ^ 1);
      mbar_wait(bar(B_RAW + r), (it / RAW_SLOTS) & 1);
      if (kWiden)
        widen_rows<BKV / PWG>(smem + OFF_RAW + r * T8, smem + stage(it) + T8,
                              wg * (BKV / PWG), wtid);
      fence_proxy_async();
      mbar_arrive(bar(B_VFULL + s));
      // both warpgroups are done with the tile: the slot is refilled, and
      // neither runs ahead to widen during more of the consumers' softmax
      // (measured faster than letting them drift apart)
      named_sync(NB_PRODUCERS, 128 * PWG);
      if (threadIdx.x == 0) {
        if (valid(ahead)) load_v(ahead, it + RAW_SLOTS);
        advance(ahead);
      }
      advance(cur);
    }
  } else {
    // ===================== consumer warpgroups =====================
    setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - PWG;        // which 64 q rows of the item
    const int warp = wtid >> 5;     // 16 rows each
    const int lane = wtid & 31;
    const int g = lane >> 2;        // accumulator row (and row + 8)
    const int cb = 2 * (lane & 3);  // accumulator column pair in each 8
    const uint32_t q_half = sbase + cw * 64 * D;  // this warpgroup's rows

    // S = Q8 K8^T of the i-th tile: 4 k32 steps
    auto issue_qk = [&](uint32_t (&sacc)[64], int i) {
      const uint32_t st = sbase + stage(i);
      wgmma_s8_first(sacc, desc_kmajor(q_half), desc_kmajor(st));
#pragma unroll
      for (int kk = 1; kk < D / 32; ++kk)
        wgmma_s8(sacc, desc_kmajor(q_half + 32 * kk),
                 desc_kmajor(st + 32 * kk));
      wgmma_commit();
    };
    // O += P V of the i-th tile: 8 k16 steps of 16 kv rows (2048 bytes of
    // V each)
    auto issue_pv = [&](float (&o)[64], const uint32_t (&pa)[32], int i) {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                 pa[4 * kk + 3],
                 desc_mnmajor(sbase + stage(i) + T8 + kk * 2048));
      wgmma_commit();
    };
    auto release = [&](int b, int i) {
      if (lane == 0) mbar_arrive(bar(b + i % STAGES));
    };

    int it = 0, qn = 0;
    for (int j = 0; j * (int)gridDim.x < p.n_items; ++j) {
      const int t = item_index(j);
      if (t >= p.n_items) continue;
      const Item x = item_of(p, t);
      const KvWalk<BKV, MULTI> w = walk_of<MULTI>(p, x.q0);
      const int r0 = x.q0 + cw * 64;  // first q row of this warpgroup
      const int qc = MULTI ? q_chunk(p, x.q0) : 0;
      const int q_first = r0 - qc * p.dsc.cq;  // chunk-local
      const int q_last = min(r0 + 64, p.s_q) - 1 - qc * p.dsc.cq;
      const int row_pos0 = q_first + warp * 16 + g;

      float qsr[2];  // the q scales of rows g and g + 8
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qi = r0 + warp * 16 + g + hh * 8;
        qsr[hh] = qi < p.s_q ? p.qs[x.ib * p.qs_sb + x.ih * p.qs_sh +
                                    (long long)qi * p.qs_ss]
                             : 0.f;
      }
      float o[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;
      float l_row[2] = {0.f, 0.f};
      // P in bf16, the A operand of the next PV: the accumulator (row, col
      // pair) of 8-column group i8 is the A fragment of k16 step i8 / 2,
      // rows g and g + 8
      uint32_t pa[32];

      // tile i's P from its s32 scores: scales, (`masked`) masks (over
      // chunk-local rows and columns, kv0 the tile's first column in its
      // chunk and pr the chunk pair: Desc), p = exp2(min(s, 90)) summed
      // into l, then p * v_scale packed into pa group by group, so the
      // scores' registers free as it goes
      auto scores = [&](const uint32_t (&sacc)[64], const float* sks,
                        int kv0, int pr, auto masked) {
        const float* svs = sks + BKV;
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i8 = 0; i8 < 16; ++i8) {
          const float2 ksc =
              *reinterpret_cast<const float2*>(sks + 8 * i8 + cb);
          const float2 vsc =
              *reinterpret_cast<const float2*>(svs + 8 * i8 + cb);
          float pv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = (float)(int)sacc[4 * i8 + e] * qsr[e >> 1] *
                      ((e & 1) ? ksc.y : ksc.x);
            if (decltype(masked)::value) {
              const int col = kv0 + 8 * i8 + cb + (e & 1);
              const int row = row_pos0 + (e >> 1) * 8;
              if (col >= p.dsc.ckv || col - row > (TRI ? 0 : p.dsc.hi[pr]) ||
                  (!TRI && col - row < p.dsc.lo[pr] && col >= p.dsc.sk[pr]))
                v = kNegInf;
            }
            const float pe = exp2_ftz(fminf(v, kClamp));  // exp2(-1e30) == 0
            rs[e >> 1] += pe;
            pv[e] = pe * ((e & 1) ? vsc.y : vsc.x);
          }
          pa[2 * i8] = pack_bf16(pv[0], pv[1]);
          pa[2 * i8 + 1] = pack_bf16(pv[2], pv[3]);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
          rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
          l_row[hh] += rs[hh];
        }
      };
      // a tile that every row of this warpgroup sees whole skips the mask;
      // jt: the tile's place in the item's walk
      auto softmax = [&](const uint32_t (&sacc)[64], int i, int jt) {
        const float* sks =
            reinterpret_cast<const float*>(smem + stage(i) + T8 + VW);
        const int kc = w.chunk(jt);
        const int pr = qc * 2 + kc;
        const int kv0 = w.tile(jt) * BKV - kc * p.dsc.ckv;
        const int kv_last = kv0 + BKV - 1;
        const bool interior =
            kv_last < p.dsc.ckv &&
            kv_last - q_first <= (TRI ? 0 : p.dsc.hi[pr]) &&
            (TRI || kv0 - q_last >= p.dsc.lo[pr] || kv_last < p.dsc.sk[pr]);
        if (interior)
          scores(sacc, sks, kv0, pr, Flag<false>());
        else
          scores(sacc, sks, kv0, pr, Flag<true>());
      };
      if (w.n > 0) {
        mbar_wait(bar(B_QFULL), qn & 1);
        // the first tile: QK, its softmax, no PV in flight yet
        {
          uint32_t sacc[64];
          mbar_wait(bar(B_KFULL + it % STAGES), use(it));
          if (kMath) {
            wgmma_fence();
            issue_qk(sacc, it);
            wgmma_wait<0>();
            reg_fence(sacc);
          }
          if (w.n == 1 && lane == 0) mbar_arrive(bar(B_QEMPTY));
          if (kMath) softmax(sacc, it, 0);
          release(B_KEMPTY, it);  // K and the scales
        }
        // then per tile: QK of this tile and PV of the one before issue
        // together, and this tile's softmax runs once both are done (it
        // writes pa, which that PV reads); the other warpgroup's products
        // run under it
        for (int jt = 1; jt < w.n; ++jt) {
          ++it;
          uint32_t sacc[64];
          mbar_wait(bar(B_KFULL + it % STAGES), use(it));
          mbar_wait(bar(B_VFULL + (it - 1) % STAGES), use(it - 1));
          if (kMath) {
            wgmma_fence();
            issue_qk(sacc, it);
            issue_pv(o, pa, it - 1);
            wgmma_wait<0>();
            reg_fence(sacc);
            reg_fence(o);
            reg_fence(pa);
          }
          release(B_VEMPTY, it - 1);
          if (jt == w.n - 1 && lane == 0) mbar_arrive(bar(B_QEMPTY));
          if (kMath) softmax(sacc, it, jt);
          release(B_KEMPTY, it);
        }
        // PV of the last tile
        mbar_wait(bar(B_VFULL + it % STAGES), use(it));
        if (kMath) {
          wgmma_fence();
          issue_pv(o, pa, it);
          wgmma_wait<0>();
          reg_fence(o);
          reg_fence(pa);
        }
        release(B_VEMPTY, it);
        ++it;
        ++qn;
      }

      // emit (_emit): out = acc / l, lse = ln l; a dead row gives 0, -inf
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qi = r0 + warp * 16 + g + hh * 8;
        if (qi >= p.s_q) continue;
        const float l = l_row[hh];
        __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.out) +
                              x.ib * p.o_sb + (long long)qi * p.o_ss +
                              x.ih * p.o_sh;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float x0 = l == 0.f ? 0.f : o[4 * i + 2 * hh] / l;
          const float x1 = l == 0.f ? 0.f : o[4 * i + 2 * hh + 1] / l;
          *reinterpret_cast<uint32_t*>(orow + 8 * i + cb) = pack_bf16(x0, x1);
        }
        if ((lane & 3) == 0)
          p.lse[((long long)x.ib * p.h + x.ih) * p.s_q + qi] =
              l == 0.f ? __int_as_float(0xff800000) : logf(l);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launch
// ---------------------------------------------------------------------------

// dims: b, h, h_kv, s_q, s_kv, q strides (b, s, h), k strides (b, s, h), v
// strides (b, s, h), out strides (b, s, h), q, k and v scale strides (b, h,
// s), q_off, left, right, sink (the layout of the mma.sync entry points),
// then the descriptor (sm90.cuh Desc), which holds the masks in local
// units, from index 30
template <bool TRI, bool MULTI = false>
int launch(const void* q, const float* qs, const void* k, const float* ks,
           const void* v, const float* vs, void* out, float* lse,
           const long long* dims, cudaStream_t stream) {
  Params p;
  p.qs = qs;
  p.ks = ks;
  p.vs = vs;
  p.out = out;
  p.lse = lse;
  p.b = (int)dims[0];
  p.h = (int)dims[1];
  p.h_kv = (int)dims[2];
  p.s_q = (int)dims[3];
  p.s_kv = (int)dims[4];
  p.o_sb = dims[14];
  p.o_ss = dims[15];
  p.o_sh = dims[16];
  long long* sc[] = {&p.qs_sb, &p.qs_sh, &p.qs_ss, &p.ks_sb, &p.ks_sh,
                     &p.ks_ss, &p.vs_sb, &p.vs_sh, &p.vs_ss};
  for (int i = 0; i < 9; ++i) *sc[i] = dims[17 + i];
  p.dsc = desc_from(dims, 30);
  p.nq = (p.s_q + BQ - 1) / BQ;
  p.n_items = p.nq * p.h * p.b;
  if (p.h_kv <= 0 || p.h % p.h_kv || !desc_ok(p.dsc, p.s_q, p.s_kv, BQ))
    return (int)cudaErrorInvalidValue;
  if ((TRI && (p.s_q != p.s_kv || dims[26] != 0)) ||
      (p.dsc.nqc * p.dsc.nkc > 1) != MULTI)
    return (int)cudaErrorInvalidValue;
  if (p.n_items == 0) return (int)cudaSuccess;

  Maps maps;
  const cuuint32_t box[4] = {D, BQ, 1, 1};  // BQ == BKV: 128 rows of 128 B
  const long long q_dims[4] = {D, p.s_q, p.h, p.b};
  const long long q_str[3] = {dims[6], dims[7], dims[5]};
  const long long kv_dims[4] = {D, p.s_kv, p.h_kv, p.b};
  const long long k_str[3] = {dims[9], dims[10], dims[8]};
  const long long v_str[3] = {dims[12], dims[13], dims[11]};
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const bool ok =
      encode(&maps.q, q, u8, 1, 4, q_dims, q_str, box,
             CU_TENSOR_MAP_SWIZZLE_128B) &&
      encode(&maps.k, k, u8, 1, 4, kv_dims, k_str, box,
             CU_TENSOR_MAP_SWIZZLE_128B) &&
      encode(&maps.v, v, u8, 1, 4, kv_dims, v_str, box,
             CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return (int)cudaErrorInvalidValue;

  auto kern = sage_fwd_sm90_kernel<TRI, MULTI>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int grid = p.n_items < num_sms() ? p.n_items : num_sms();
  kern<<<grid, NT, SMEM_BYTES, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernels B8a and B8b: sage attention over int8 q, k, v with fp32
// per-token scales (q's with scale*log2e folded in). One signature: q8, qs,
// k8, ks, v8, vs, out, lse, dims (see launch), stream.
// B8a: causal self-attention, s_q == s_kv, q_off 0 (dims' mask fields
// ignored).
extern "C" int lca_sage_fwd_tri(const void* q, const float* qs,
                                const void* k, const float* ks, const void* v,
                                const float* vs, void* out, float* lse,
                                const long long* dims, void* stream) {
  return launch<true>(q, qs, k, ks, v, vs, out, lse, dims,
                      static_cast<cudaStream_t>(stream));
}

// B8b: q rows at q_off + i against kv columns at j, with the causal /
// window (left, right) / sink masks of dims, walking the sink tiles and
// each q tile's band only.
extern "C" int lca_sage_fwd_pos(const void* q, const float* qs,
                                const void* k, const float* ks, const void* v,
                                const float* vs, void* out, float* lse,
                                const long long* dims, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dims[30] * dims[31] > 1)  // the ring's multi-chunk steps
    return launch<false, true>(q, qs, k, ks, v, vs, out, lse, dims, st);
  return launch<false>(q, qs, k, ks, v, vs, out, lse, dims, st);
}

// Dynamic shared memory per block (ptxas reports static memory only).
extern "C" int lca_sage_fwd_smem() { return SMEM_BYTES; }

extern "C" const char* lca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
