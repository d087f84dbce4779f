// Flash-attention prefill forward for Hopper (sm_90a only): wgmma, TMA and
// a warp-specialised pipeline.
//
// Replaces the TPU kernels of long_context_attention_tpu/ops/flash.py:
//   lca_flash_fwd_causal_self <- _fwd_kernel_tri / _fwd_kernel_tri_sqrt
//                                (shared body _tri_body): causal
//                                self-attention, s_q == s_kv, GQA;
//   lca_flash_fwd_static      <- _fwd_kernel_static: self-attention with
//                                positions from 0 (s_q == s_kv), causal or
//                                not, sliding window (left, right),
//                                StreamingLLM sinks and logit softcap; the
//                                masks of lca_flash_fwd_pos at q_off 0, its
//                                online form in exp2 units;
//   lca_flash_fwd_pos         <- _fwd_kernel: q rows at global positions
//                                q_off + i against kv columns at j, sliding
//                                window (left, right), StreamingLLM sinks
//                                and logit softcap, bf16 or int8 K/V with
//                                fp32 per-token scales (chunked prefill
//                                against the quantized cache, read in place
//                                as a strided view), and the features
//                                (_seg_mask, _alibi_bias, _dropout_keep):
//                                segment ids, ALiBi and the counter-hash
//                                dropout.
// and the TPU kernel of long_context_attention_tpu/ops/sparse.py:
//   lca_sparse_fwd            <- _sparse_fwd_kernel (B9a): out and lse of a
//                                block-sparse mask's rows over their live kv
//                                tiles.
//
// What bounds it on an H100: tensor-core operations. Each visible (row,
// column) pair costs 4*d FLOPs (QK and PV) against 989 TFLOP/s bf16; the
// bytes (q, k, v once) are a few percent of that time at the prefill
// shapes. Only wgmma reaches that rate, and a 128-row q tile re-reads each
// K/V tile from L2, so the kernel keeps the tensor cores fed from a ring of
// tiles that TMA fills while the products run.
//
// Design. One persistent block per SM walks (q tile, head, batch) items,
// the last q tile first, dealt to the blocks in a snake order. Under a
// causal mask, with or without a window, a q tile's walk is never shorter
// than an earlier tile's (its band ends at its own diagonal, and a window
// keeps it at the window's width once it is full), so that order is the
// longest walks first. A block has two consumer
// warpgroups and one producer warpgroup (bf16 K/V) or two (int8 K/V):
//   * the producer (setmaxnreg down to 24 registers) loads Q once per item
//     and every K/V tile of the item's walk by TMA into a ring of operand
//     stages; the K and V halves of a stage have their own full and empty
//     mbarriers, so a stage's K is refilled once its softmax is done,
//     before its V is free;
//   * the consumers (setmaxnreg up to 240 registers, 200 with int8) own 64
//     q rows each (BQ = 128). S = Q K^T is wgmma m64n128k16 with both
//     operands in shared memory (128-byte swizzle, K-major); the masks and
//     the softmax run in registers on the accumulator layout (a row is
//     reduced across the 4 lanes that hold it), in a copy without the mask
//     for the tiles every row sees whole; P goes to bf16 in registers and
//     is the register A operand of O += P V, wgmma m64n128k16 with V
//     row-major [kv, d] as the transposed (MN-major) B operand. QK(j) and
//     PV(j - 1) issue together and the softmax of tile j runs while PV(j -
//     1) is on the tensor cores (FlashAttention-3's order);
//   * quantized K/V (B3 over the int8, fp8 or int4 cache; the kind is a
//     run-time value that only the producers read, so the consumers'
//     code is compiled once for the three): one producer warpgroup widens
//     every K tile, the other every V tile, each at its own pace (56
//     registers). TMA brings the int8 tiles (half the bytes; K with the
//     tile's k and v scales) into a ring of 2 raw K and 1 raw V slots, each
//     load issued as soon as its slot is read; the warpgroup widens int8 ->
//     bf16 (exact) into the swizzled operand stage, copies the scales beside
//     K and arrives on the half's full barrier. Tile j + 1 is widened while
//     the consumers run wgmma on tile j; consumers read the scales from
//     shared memory only.
//
// Shared memory (bytes; the 227 KB a block may use):
//   bf16 K/V: Q 32768 + 3 stages x (K 32768 + V 32768) = 229376, + 256 of
//             barriers, 3 x 8 of B9a's step meta and 1024 of alignment
//             slack (230680);
//   int8 K/V: Q 32768 + 2 stages x (K 32768 + V 32768 + scales 1024)
//             = 133120 + 3 raw slots x (an int8 K or V tile 16384 + a K
//             tile's scales 1024) = 218112, + barriers and slack;
//   FEAT:     each stage's 128 kv segment ids (512) after the meta,
//             128-byte aligned (a TMA destination): 232320 with bf16 K/V.
//   d = 64:   every Q, K and V tile is one box (8192 bytes raw): bf16 K/V
//             Q 16384 + 3 x 32768 = 114688; quantized Q 16384 + 2 x
//             (32768 + 1024) + 3 x (8192 + 1024) = 111616; + barriers and
//             slack.
//
// Head dim 64 (-DLCA_HEAD_DIM=64, a library of its own): QK^T takes 4 k16
// steps in one box, PV is wgmma m64n64k16 into a 32-register O, and a
// quantized row is 64 bytes (int4: 32) widened into one bf16 box.
//
// The kv walk is the TPU kernels' (_banded_gt) at BKV = 128: the sink tiles
// that lie before the band, then the band; a tile outside the walk is never
// read (TMA zero-fills rows past s_kv, which the mask also drops). Only
// tiles that some row of a consumer's 64 does not see whole are masked.
//
// B9a's walk (template parameter SPARSE; the fast form, bf16 K/V): the
// producer, the consumers' products, softmax and write-out are the body
// above, and only the item, the steps and the mask's positions come from
// the walk. The host lists the items once per mask plan, longest first
// (ops/sparse.py SparsePlan.row_items), and deals them to the persistent
// blocks (SparsePlan.row_schedule, shared with B9b): an item is BQ = 128 q
// rows of a mask row (head or 0, q tile) for one head and batch row (block_q,
// a multiple of 64, holds one or more; the last of an odd multiple of 64 is
// 64 rows, and the consumer whose rows belong to the next q tile releases
// Q and every stage unread and writes nothing). The steps are the row's CSR
// range of (kv tile, flags, q_first, kv_first) entries, in the JAX tables'
// order, each cut into block_kv / 128 steps of 128 columns (rounded up: the
// last step of an odd multiple of 64 has 64 columns of its tile, and the
// mask drops the next tile's 64 that its box also loads); on a MASKED entry
// a step wholly above the diagonal for all of the item's rows is skipped,
// which drops only zeros (sm90.cuh RowWalk). The producer hands the
// consumers each step's first q position less its first kv position (the
// layout's for ring shards) and its columns beside the stage; unmasked
// steps run the softmax without the mask. A row item with no step writes out
// 0 and lse -inf: the TPU's DEAD zero-emit entries.
//
// Numerics are those of the TPU kernels and of the mma.sync kernels before
// this one; only the order of the sums differs:
//   fast form (B1 and B4 by default, B3 over a cache, B9a): scale*log2e is
//     folded into q in bf16 (one rounding, done in shared memory once per
//     item), p = exp2(min(s, 90)) with masked entries at -1e30, l +=
//     rowsum(p), acc += bf16(p * v_scale) @ v; out = acc / l, lse = log(l);
//     a row with l == 0 gives out 0, lse -inf.
//   online forms (safe softmax): B1 and B4 in exp2 units (s *=
//     scale*log2e, lse = m*ln2 + log l), B3 in natural units (s = dot *
//     k_scale * scale, lse = m + log l).
//   softcap (B3, B4): natural units, s = cap * tanh(dot * k_scale * scale /
//     cap), then the online form.
//   int8 K/V: s = dot(q, k_int8 as bf16) * k_scale[col]; l sums p before
//     V's scale; p *= v_scale[col] before the bf16 PV product.
//   masks (flash-attn semantics, global positions): drop col > row + right
//     (right = 0 when causal) and col < row - left unless col < sink.
//   features (B3, template parameter FEAT, each a uniform run-time flag;
//     sm90.cuh Feat): ALiBi adds -slope[head] * |row - col| at the global
//     positions of the descriptor after the softcap (times log2e in the
//     fast form, whose q carries scale*log2e); segments drop a pair of
//     unequal ids with the masks; dropout scales a kept p by 1 / (1 - p)
//     and zeroes the others after l has summed them and before V's scale
//     (the row part of the hash once per item, the column part per entry).
//     With segments every tile runs the masked body (JAX skips no tile by
//     segment). The kv ids of a tile reach shared memory beside its K:
//     with bf16 K/V a TMA box of 128 ids on K's full barrier, with int8
//     K/V a plain load by the K-widening warpgroup; each thread holds its
//     two rows' q ids, positions and hash parts in registers.
//
// The tensor maps are encoded on the host per call (sm90.cuh) and passed
// as __grid_constant__ kernel parameters.

#include "sm90.cuh"

// The head dim: 128, or 64 for a second library built with
// -DLCA_HEAD_DIM=64 (ops/_build.py), which holds B1 and B3 (quantized K/V
// neither at MULTI nor with FEAT); B4 and B9a return cudaErrorNotSupported
// there.
#ifndef LCA_HEAD_DIM
#define LCA_HEAD_DIM 128
#endif

namespace {

constexpr int D = LCA_HEAD_DIM;
static_assert(D == 64 || D == 128, "head dim 64 or 128");
constexpr int BQ = 128;        // q rows per item: 64 per consumer warpgroup
constexpr int BKV = 128;       // kv columns per tile
// producer warpgroups (the int8 path widens K in one and V in the other),
// their registers after setmaxnreg, and the block's threads
template <bool QUANT>
struct Roles {
  static constexpr int PWG = QUANT ? 2 : 1;
  static constexpr int PRODUCER_REGS = QUANT ? 56 : 24;
  static constexpr int NT = 128 * (PWG + 2);
};
constexpr float kClamp = 90.f;
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// a quantized kind as a type, for the producers' generic lambda
template <int K>
struct KvKind {
  static constexpr int value = K;
};

// softmax forms (template parameter FORM)
constexpr int kFast = 0;        // max-free clamped exp2, scale folded into q
constexpr int kOnlineExp2 = 1;  // online softmax in exp2 units
constexpr int kOnlineNat = 2;   // online softmax in natural units
constexpr int kSoftcap = 3;     // capped scores, online, natural units

// Shared memory. A 64-column bf16 box of 128 rows is 128 rows of 128
// bytes, swizzled in 1024-byte atoms of 8 rows: the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B and wgmma reads with a 128-byte-swizzle
// descriptor. d = 128 is two boxes, d = 64 one.
constexpr int BOX = 128 * 128;             // one box: 16 KB
constexpr int NBOX = D / 64;               // boxes of a row
constexpr int Q_BYTES = NBOX * BOX;        // Q: its d boxes, 128 rows
constexpr int KV_BYTES = NBOX * BOX;       // one bf16 K or V tile
constexpr int SC_BYTES = 2 * BKV * 4;      // a tile's k and v scales
constexpr int RAW_BYTES = BKV * D;         // one int8 / fp8 K or V tile
constexpr int RAW_SLOT = RAW_BYTES + SC_BYTES;  // ... and a K tile's scales
constexpr int RAW_K_SLOTS = 2;             // rings of raw int8 K and V
constexpr int RAW_V_SLOTS = 1;
constexpr int RAW_SLOTS = RAW_K_SLOTS + RAW_V_SLOTS;
constexpr int SEG_BYTES = BKV * 4;  // a tile's kv segment ids
// bf16 K/V: 3 operand stages that TMA fills; int8: 2 operand stages (with
// the tile's scales) that the producers widen into, fed by the raw rings.
// FEAT: each stage's kv segment ids after the meta
template <bool QUANT, bool FEAT = false>
struct Smem {
  static constexpr int STAGES = QUANT ? 2 : 3;
  static constexpr int STAGE = 2 * KV_BYTES + (QUANT ? 1024 : 0);
  static constexpr int OFF_W = Q_BYTES;
  static constexpr int OFF_RAW = OFF_W + STAGES * STAGE;
  static constexpr int OFF_BAR =
      OFF_RAW + (QUANT ? RAW_SLOTS * RAW_SLOT : 0);
  static constexpr int OFF_META = OFF_BAR + 256;  // B9a: each stage's int2
  // a TMA destination: 128-byte aligned
  static constexpr int OFF_SEG = (OFF_META + 32 + 127) / 128 * 128;
  static constexpr int BYTES =
      (FEAT ? OFF_SEG + STAGES * SEG_BYTES : OFF_META + STAGES * 8) +
      1024;  // + alignment
};
static_assert(Smem<true>::BYTES <= 232448 && Smem<false>::BYTES <= 232448 &&
                  Smem<true, true>::BYTES <= 232448 &&
                  Smem<false, true>::BYTES <= 232448,
              "shared memory over the 227 KB a block may use");

// mbarrier slots: Q; the K and V halves of the operand stages, full and
// empty (consumers release K, with the tile's scales, after its softmax and
// V after PV); the raw rings
constexpr int B_QFULL = 0, B_QEMPTY = 1, B_KFULL = 2, B_VFULL = 5,
              B_KEMPTY = 8, B_VEMPTY = 11, B_RAW = 14;
static_assert(B_RAW + RAW_SLOTS <= 32, "32 barriers in 256 bytes");

// named barriers (0 is __syncthreads): the producer warpgroups, each
// consumer's q fold
constexpr int NB_PRODUCER = 1, NB_FOLD = 3;

struct Maps {  // TMA descriptors, in the kernel's parameter space
  CUtensorMap q, k, v, ks, vs;
  CUtensorMap kseg;  // FEAT with bf16 K/V: the kv segment ids (b, kv_ld)
};

struct Params {
  void* out;
  float* lse;
  int b, h, h_kv, s_q, s_kv;
  long long o_sb, o_ss, o_sh;  // out element strides (batch, seq, head)
  Desc dsc;  // the positions and masks in chunk-local units (sm90.cuh)
  float qfold;   // fast form: scale*log2e folded into q
  float sscale;  // online forms: multiplier of the raw score
  float cap;     // softcap form: the cap
  int nq, n_items;
  // B9a: the row tables' CSR form, the host's items (row, first q row in its
  // q tile, steps, 0) and each block's work items, block i's at
  // sched[sched_ptr[i] .. sched_ptr[i + 1])
  const int* ptr;
  const int4* ent;
  const int4* items;
  const int* sched_ptr;
  const int* sched;
  int n_q, bq, bkv, per_head;
  Feat ft;  // FEAT: segments, ALiBi, dropout (sm90.cuh)
  int kv;   // B3's kind of quantized K/V (sm90.cuh kKv*), the producers'
};

// K-major operand (Q, K): 8-row groups 1024 bytes apart; a k16 step moves
// 32 bytes inside the 128-byte swizzle row
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// MN-major B operand (V, [kv, d] with d contiguous): 8 kv rows 1024 bytes
// apart, the second 64-column d box BOX bytes after the first
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return desc_sw128(addr, BOX, 1024);
}

// d (64 x 128 fp32) += A (64 x 16 bf16, shared, K-major) * B (16 x 128,
// shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " LCA_D64
      ", %64, %65, 1, 1, 1, 0, 0;\n"
      : LCA_ACC64(d)
      : "l"(da), "l"(db));
}

// d = A * B, as wgmma_ss with d written, not read: the product's first k
// step does not depend on whatever last defined d's registers
__device__ __forceinline__ void wgmma_ss_first(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " LCA_D64
      ", %64, %65, 0, 1, 1, 0, 0;\n"
      : LCA_OUT64(d)
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

template <bool TRI, bool MULTI>
__device__ __forceinline__ KvWalk<BKV, MULTI> walk_of(const Params& p,
                                                      int q0) {
  const int qc = MULTI ? q_chunk(p, q0) : 0;
  const int c0 = qc * p.dsc.cq;
  return KvWalk<BKV, MULTI>(p.dsc, qc, q0 - c0,
                            min(q0 + BQ, p.s_q) - 1 - c0);
}

// Work item t with its step count: dense, item_of's q tile and its kv walk;
// B9a, the host's row item (sm90.cuh row_item)
template <bool TRI, bool SPARSE, bool MULTI>
__device__ __forceinline__ RowItem item_at(const Params& p, int t) {
  if constexpr (SPARSE)
    return row_item(p.items, p.ptr, t, p.b, p.h, p.n_q, p.bq, p.per_head);
  const Item d = item_of(p, t);
  return RowItem{d.ih, d.ib, d.q0, 0, BQ, walk_of<TRI, MULTI>(p, d.q0).n, 0,
                 0};
}

// A multi-chunk step's meta, which the producer hands the consumers beside
// K so that they keep no walk of two chunks: its first kv column in its
// chunk, and the chunk pair (Desc)
template <bool MULTI>
__device__ __forceinline__ int2 dense_meta(const Params& p, int q0,
                                           const KvWalk<BKV, MULTI>& w,
                                           int jt) {
  const int kc = w.chunk(jt);
  return make_int2(w.tile(jt) * BKV - kc * p.dsc.ckv,
                   MULTI ? q_chunk(p, q0) * 2 + kc : 0);
}

// Where a tile's scores sit for the masks: its first kv column, the
// consumer's first and last q row and a lane's first row (chunk-local), the
// end of the columns, and the pair's masks (Desc: a column j of row i is
// seen when j - i <= hi, and j - i >= lo or j < sk); FEAT: the global
// position of the first kv column. B9a's steps use a frame of their own:
// columns from 0, rows from the step's relative position, hi 0 (causal) or
// open.
struct Frame {
  int kv0, q_first, q_last, row0, col_end, hi, lo, sk, kpos;
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// TRI: causal self-attention with compile-time masks (B1); else the masks
// of Params (B3, and B4 at q_off 0). FORM: the softmax form; QUANT: bf16
// K/V, or quantized K/V with fp32 scales, whose kind (int8, fp8 or packed
// int4: Params::kv) only the producers read. SPARSE: B9a's
// walk over a block-sparse row. MULTI: a descriptor of two chunks on a
// side (B3 on the ring's steps). FEAT: B3 with the features of Params
// (segments, ALiBi, dropout).
template <bool TRI, int FORM, bool QUANT, bool SPARSE = false,
          bool MULTI = false, bool FEAT = false>
__global__ void __launch_bounds__(Roles<QUANT>::NT, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  static_assert(!SPARSE || (!TRI && FORM == kFast && !QUANT),
                "B9a: bf16 K/V, the fast form, the masks of its steps");
  static_assert(!FEAT || !(TRI || SPARSE), "the features are B3's");
  constexpr int PWG = Roles<QUANT>::PWG;
  constexpr int PRODUCER_REGS = Roles<QUANT>::PRODUCER_REGS;
  // registers a thread holds at launch; the consumers take what the
  // producers give back (setmaxnreg.inc waits for them): 240 with bf16
  // K/V, 200 with int8
  constexpr int REGS_AT_LAUNCH = 65536 / Roles<QUANT>::NT / 8 * 8;
  constexpr int CONSUMER_REGS =
      (REGS_AT_LAUNCH * Roles<QUANT>::NT - 128 * PWG * PRODUCER_REGS) / 256 /
      8 * 8;
  constexpr bool ONLINE = FORM != kFast;
  constexpr bool EXP2 = FORM == kOnlineExp2;
  using L = Smem<QUANT, FEAT>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 1024-byte aligned base as an offset into the shared array, so the
  // compiler keeps the scale loads, the q fold and the widening in
  // shared-memory instructions (an integer round trip of the address makes
  // them generic)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bars = sbase + L::OFF_BAR;
  auto bar = [&](int i) -> uint32_t { return bars + 8 * i; };
  // stage of the i-th tile of the block's stream, and the parity of its
  // use of that stage
  auto stage = [&](int i) -> uint32_t {
    return sbase + L::OFF_W + (i % STAGES) * L::STAGE;
  };
  auto use = [&](int i) -> int { return (i / STAGES) & 1; };
  // B9a: the i-th step's meta (RowWalk::meta), beside its stage
  auto meta = [&](int i) -> int2* {
    return reinterpret_cast<int2*>(smem + L::OFF_META + (i % STAGES) * 8);
  };
  // FEAT: the kv segment ids of the i-th tile
  auto seg_slot = [&](int i) -> int* {
    return reinterpret_cast<int*>(smem + L::OFF_SEG + (i % STAGES) * SEG_BYTES);
  };
  const bool segs = FEAT && p.ft.seg;

  if (threadIdx.x == 0) {
    mbar_init(bar(B_QFULL), 1);
    mbar_init(bar(B_QEMPTY), 8);  // one arrival per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar(B_KFULL + s), QUANT ? 128 : 1);
      mbar_init(bar(B_VFULL + s), QUANT ? 128 : 1);
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
    if constexpr (!QUANT) {
      setmaxnreg_dec<PRODUCER_REGS>();
      if (wtid != 0) return;  // one thread issues every TMA
      int it = 0, qn = 0;
      const BlockItems<SPARSE> items(p);
      for (int j = items.j0; j < items.end; ++j) {
        const int t = items.at(p, j);
        if (t < 0) continue;
        const RowItem x = item_at<TRI, SPARSE, MULTI>(p, t);
        const KvWalk<BKV, MULTI> w = walk_of<TRI, MULTI>(p, x.q0);
        const RowWalk rw(p.ent, x, p.bkv);
        RowStep c{};
        if constexpr (SPARSE) c = rw.from(x.e0);
        const int ihk = x.ih / (p.h / p.h_kv);
        for (int jt = 0; jt < x.n; ++jt, ++it) {
          const int s = it % STAGES;
          const int kv0 = SPARSE ? rw.kv0(c) : w.tile(jt) * BKV;
          const uint32_t st = stage(it);
          mbar_wait(bar(B_KEMPTY + s), use(it) ^ 1);
          // the step's meta, released by K's full barrier
          if constexpr (SPARSE)
            *meta(it) = rw.meta(c);
          else if constexpr (MULTI)
            *meta(it) = dense_meta(p, x.q0, w, jt);
          mbar_expect_tx(bar(B_KFULL + s), KV_BYTES + (segs ? SEG_BYTES : 0));
#pragma unroll
          for (int bx = 0; bx < NBOX; ++bx)
            tma_load_4d(st + bx * BOX, &maps.k, bar(B_KFULL + s), 64 * bx,
                        kv0, ihk, x.ib);
          if (segs)  // the tile's kv ids, on K's barrier
            tma_load_2d(smem_u32(seg_slot(it)), &maps.kseg, bar(B_KFULL + s),
                        kv0, x.ib);
          if (jt == 0) {  // the item's Q, once its first K is in flight
            mbar_wait(bar(B_QEMPTY), (qn & 1) ^ 1);
            mbar_expect_tx(bar(B_QFULL), Q_BYTES);
#pragma unroll
            for (int bx = 0; bx < NBOX; ++bx)
              tma_load_4d(sbase + bx * BOX, &maps.q, bar(B_QFULL), 64 * bx,
                          x.q0, x.ih, x.ib);
            ++qn;
          }
          mbar_wait(bar(B_VEMPTY + s), use(it) ^ 1);
          mbar_expect_tx(bar(B_VFULL + s), KV_BYTES);
#pragma unroll
          for (int bx = 0; bx < NBOX; ++bx)
            tma_load_4d(st + KV_BYTES + bx * BOX, &maps.v, bar(B_VFULL + s),
                        64 * bx, kv0, ihk, x.ib);
          if constexpr (SPARSE) c = rw.next(c);
        }
      }
    } else {
      // warpgroup 0 widens every K tile (and loads Q and the scales),
      // warpgroup 1 every V tile, each from its own raw ring at its own pace
      setmaxnreg_dec<PRODUCER_REGS>();
      const bool is_v = wg == 1;
      const int nslots = is_v ? RAW_V_SLOTS : RAW_K_SLOTS;
      unsigned char* raw = smem + L::OFF_RAW + (is_v ? RAW_K_SLOTS * RAW_SLOT : 0);
      const int b_raw = B_RAW + (is_v ? RAW_K_SLOTS : 0);
      // the block's kv tiles in order: (j-th item, tile jt), items past the
      // end or with an empty walk skipped
      struct Cursor {
        int j, jt;
      };
      auto valid = [&](const Cursor& c) -> bool {
        return c.j * (int)gridDim.x < p.n_items;
      };
      auto seek = [&](int j, int jt) -> Cursor {
        for (; j * (int)gridDim.x < p.n_items; ++j, jt = 0) {
          const int t = item_index(j);
          if (t < p.n_items && jt < walk_of<TRI, MULTI>(p, item_of(p, t).q0).n)
            return {j, jt};
        }
        return {j, 0};
      };
      auto after = [&](const Cursor& c) -> Cursor {
        return valid(c) ? seek(c.j, c.jt + 1) : c;
      };
      // TMA of a tile's rows: the coordinates after the first
      auto tma = [&](uint32_t dst, const CUtensorMap* map, uint32_t b,
                     const Cursor& c, int d0) {
        const Item x = item_of(p, item_index(c.j));
        const int kv0 = walk_of<TRI, MULTI>(p, x.q0).tile(c.jt) * BKV;
        const int ihk = x.ih / (p.h / p.h_kv);
        if (d0 < 0)  // a scale map: (s_kv, h_kv, b)
          tma_load_3d(dst, map, b, kv0, ihk, x.ib);
        else
          tma_load_4d(dst, map, b, d0, kv0, ihk, x.ib);
      };
      // this warpgroup's stream of tiles for the call's kind (Params::kv,
      // read once): the loop is compiled once per kind, the consumers'
      // code once for every kind
      auto stream = [&](auto kind) {
        constexpr int KV = decltype(kind)::value;
        constexpr int raw_bytes = KV == kKvInt4 ? RAW_BYTES / 2 : RAW_BYTES;
        // the i-th raw tile of the stream (K with its scales, or V) into
        // slot i % nslots; an int4 tile fills half its slot
        auto load_raw = [&](const Cursor& c, int i) {
          const uint32_t b = bar(b_raw + i % nslots);
          const uint32_t dst = smem_u32(raw + (i % nslots) * RAW_SLOT);
          if (is_v) {
            mbar_expect_tx(b, raw_bytes);
            tma(dst, &maps.v, b, c, 0);
          } else {
            mbar_expect_tx(b, raw_bytes + SC_BYTES);
            tma(dst, &maps.k, b, c, 0);
            tma(dst + RAW_BYTES, &maps.ks, b, c, -1);
            tma(dst + RAW_BYTES + BKV * 4, &maps.vs, b, c, -1);
          }
        };
        Cursor cur = seek(0, 0);
        Cursor ahead = cur;  // the tile nslots after cur
        for (int i = 0; i < nslots; ++i) {
          if (wtid == 0 && valid(ahead)) load_raw(ahead, i);
          ahead = after(ahead);
        }
        for (int it = 0, qn = 0; valid(cur); ++it) {
          const int s = it % STAGES;
          unsigned char* st = smem + L::OFF_W + s * L::STAGE;
          const unsigned char* slot = raw + (it % nslots) * RAW_SLOT;
          mbar_wait(bar((is_v ? B_VEMPTY : B_KEMPTY) + s), use(it) ^ 1);
          mbar_wait(bar(b_raw + it % nslots), (it / nslots) & 1);
          unsigned char* op = st + (is_v ? KV_BYTES : 0);
          widen_rows<BKV, KV, D>(slot, op, 0, wtid);
          if (!is_v && wtid < SC_BYTES / 16)  // the scales, beside K
            reinterpret_cast<float4*>(st + 2 * KV_BYTES)[wtid] =
                reinterpret_cast<const float4*>(slot + RAW_BYTES)[wtid];
          if (!is_v && wtid == 0 && MULTI) {  // the step's meta, beside K
            const int q0 = item_of(p, item_index(cur.j)).q0;
            *meta(it) = dense_meta(p, q0, walk_of<TRI, MULTI>(p, q0), cur.jt);
          }
          if (segs && !is_v && wtid < BKV / 4) {  // the tile's kv ids
            const Item x = item_of(p, item_index(cur.j));
            const int c =
                walk_of<TRI, MULTI>(p, x.q0).tile(cur.jt) * BKV + 4 * wtid;
            int4 ids = make_int4(0, 0, 0, 0);  // past s_kv: masked anyway
            if (c < p.s_kv)
              ids = *reinterpret_cast<const int4*>(p.ft.kvseg +
                                                   x.ib * p.ft.kv_ld + c);
            reinterpret_cast<int4*>(seg_slot(it))[wtid] = ids;
          }
          fence_proxy_async();
          mbar_arrive(bar((is_v ? B_VFULL : B_KFULL) + s));
          named_sync(NB_PRODUCER + wg, 128);  // all are done with the slot
          if (wtid == 0) {
            if (valid(ahead)) load_raw(ahead, it + nslots);
            if (!is_v && cur.jt == 0) {  // the item's Q, once its first K
              mbar_wait(bar(B_QEMPTY), (qn & 1) ^ 1);  // is ready
              mbar_expect_tx(bar(B_QFULL), Q_BYTES);
              const Item x = item_of(p, item_index(cur.j));
  #pragma unroll
              for (int bx = 0; bx < NBOX; ++bx)
                tma_load_4d(sbase + bx * BOX, &maps.q, bar(B_QFULL), 64 * bx,
                            x.q0, x.ih, x.ib);
            }
          }
          if (cur.jt == 0) ++qn;
          cur = after(cur);
          ahead = after(ahead);
        }
      };
      if (p.kv == kKvFp8)
        stream(KvKind<kKvFp8>());
      else if (p.kv == kKvInt4)
        stream(KvKind<kKvInt4>());
      else
        stream(KvKind<kKvInt8>());
    }
  } else {
    // ===================== consumer warpgroups =====================
    setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - PWG;        // which 64 q rows of the item
    const int warp = wtid >> 5;     // 16 rows each
    const int lane = wtid & 31;
    const int g = lane >> 2;        // accumulator row (and row + 8)
    const int cb = 2 * (lane & 3);  // accumulator column pair in each 8
    // the left window and the sinks: B3, B4 (B1 and B9a have none); one
    // chunk a side, only when the call has a left window
    constexpr bool LEFT_MASK = !(TRI || SPARSE);
    const bool has_left = LEFT_MASK && (MULTI || p.dsc.lo[0] > -kOpenRel);
    const uint32_t q_half = sbase + cw * 64 * 128;  // this warpgroup's rows

    // S = Q K^T of the i-th tile: D / 16 k16 steps, 4 in each d box
    auto issue_qk = [&](float (&sacc)[64], int i) {
      const uint32_t st = stage(i);
      wgmma_ss_first(sacc, desc_kmajor(q_half), desc_kmajor(st));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss(sacc, desc_kmajor(q_half + (kk >> 2) * BOX + (kk & 3) * 32),
                 desc_kmajor(st + (kk >> 2) * BOX + (kk & 3) * 32));
      wgmma_commit();
    };
    // O += P V of the i-th tile: 8 k16 steps of 16 kv rows (2048 bytes of
    // V each)
    auto issue_pv = [&](float (&o)[D / 2], const uint32_t (&pa)[32], int i) {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs_d(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                   pa[4 * kk + 3],
                   desc_mnmajor(stage(i) + KV_BYTES + kk * 2048));
      wgmma_commit();
    };
    auto release = [&](int b, int i) {
      if (lane == 0) mbar_arrive(bar(b + i % STAGES));
    };

    int it = 0, qn = 0;
    const BlockItems<SPARSE> items(p);
    for (int j = items.j0; j < items.end; ++j) {
      const int t = items.at(p, j);
      if (t < 0) continue;
      const RowItem x = item_at<TRI, SPARSE, MULTI>(p, t);
      // one chunk a side: the consumers place each tile from the walk
      const KvWalk<BKV, MULTI> w = walk_of<TRI, MULTI>(p, x.q0);
      const int r0 = x.q0 + cw * 64;  // first q row of this warpgroup
      const int qc = MULTI ? q_chunk(p, x.q0) : 0;
      const int q_first = r0 - qc * p.dsc.cq;  // chunk-local
      const int q_last = min(r0 + 64, p.s_q) - 1 - qc * p.dsc.cq;
      // B9a: rows of the next q tile (the second half of a 64-row item)
      const bool idle = SPARSE && cw * 64 >= x.rows;
      // FEAT: the lane's rows g and g + 8: global positions, q segment ids
      // and the dropout hash's row part; the head's -slope
      int rpos[2] = {0, 0}, qsg[2] = {0, 0};
      uint32_t rh[2] = {0u, 0u};
      float nslope = 0.f;
      if constexpr (FEAT) {
        const uint32_t salt = p.ft.drop ? drop_salt(p.ft, x.ib, x.ih) : 0u;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          rpos[hh] =
              p.dsc.qo[qc] + (q_first + warp * 16 + g + hh * 8) * p.dsc.st;
          const int qi = r0 + warp * 16 + g + hh * 8;
          if (p.ft.seg && qi < p.s_q)
            qsg[hh] = p.ft.qseg[(long long)x.ib * p.s_q + qi];
          if (p.ft.drop) rh[hh] = drop_row(salt, rpos[hh]);
        }
        if (p.ft.alibi) nslope = -p.ft.slopes[x.ih];
      }

      // the frame of the i-th tile, the jt-th of the item: one chunk a
      // side, from the walk; else from the step's meta, read once its K is
      // full (dense_meta; B9a: RowWalk::meta)
      auto frame = [&](int i, int jt) -> Frame {
        const int row0 = q_first + warp * 16 + g;
        if constexpr (SPARSE) {
          const int2 m = *meta(i);
          const int qf = m.x + cw * 64;
          return Frame{0, qf, qf + 63, qf + warp * 16 + g, m.y & 0xffff,
                       (m.y >> 16) ? 0 : kOpenRel, -kOpenRel, 0, 0};
        } else if constexpr (MULTI) {
          const int2 m = *meta(i);
          return Frame{m.x, q_first, q_last, row0, p.dsc.ckv, p.dsc.hi[m.y],
                       p.dsc.lo[m.y], p.dsc.sk[m.y],
                       FEAT ? p.dsc.ko[m.y & 1] + m.x * p.dsc.st : 0};
        } else {
          const int kv0 = w.tile(jt) * BKV;
          return Frame{kv0, q_first, q_last, row0, p.dsc.ckv,
                       TRI ? 0 : p.dsc.hi[0], p.dsc.lo[0], p.dsc.sk[0],
                       FEAT ? p.dsc.ko[0] + kv0 * p.dsc.st : 0};
        }
      };

      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m_row[2] = {kNegInf, kNegInf};  // rows g and g + 8
      float l_row[2] = {0.f, 0.f};

      float alpha[2];  // the online forms' rescale of O by the new max
      // tile i's scores in place: k scale, scale, cap, ALiBi and
      // (`masked`) the masks and segments
      auto scores = [&](float (&sacc)[64], const float* sks, const int* sseg,
                        const Frame& f, float (&mx)[2], auto masked) {
#pragma unroll
        for (int i8 = 0; i8 < 16; ++i8) {
          float2 ksc = make_float2(1.f, 1.f);
          if (QUANT) ksc = *reinterpret_cast<const float2*>(sks + 8 * i8 + cb);
          int2 ksg = make_int2(0, 0);
          if (decltype(masked)::value && segs)
            ksg = *reinterpret_cast<const int2*>(sseg + 8 * i8 + cb);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = sacc[4 * i8 + e];
            if (QUANT) v *= (e & 1) ? ksc.y : ksc.x;
            if (ONLINE) v *= p.sscale;
            if (FORM == kSoftcap) v = tanhf(v / p.cap) * p.cap;
            if (FEAT && p.ft.alibi) {
              const float bias = alibi_bias(
                  nslope, rpos[e >> 1],
                  f.kpos + (8 * i8 + cb + (e & 1)) * p.dsc.st);
              v += ONLINE ? bias : bias * kLog2e;
            }
            if (decltype(masked)::value) {
              const int col = f.kv0 + 8 * i8 + cb + (e & 1);
              const int row = f.row0 + (e >> 1) * 8;
              if (col >= f.col_end || col - row > f.hi ||
                  (has_left && col - row < f.lo && col >= f.sk) ||
                  (segs && ((e & 1) ? ksg.y : ksg.x) != qsg[e >> 1]))
                v = kNegInf;
            }
            sacc[4 * i8 + e] = v;
            if (ONLINE) mx[e >> 1] = fmaxf(mx[e >> 1], v);
          }
        }
      };
      // scale, cap, mask and the softmax of tile i in registers, in place
      // (sacc becomes p * v_scale), updating m, l and alpha; a tile that
      // every row of this warpgroup sees whole skips the mask
      auto softmax = [&](float (&sacc)[64], int i, const Frame& f) {
        const float* sks = reinterpret_cast<const float*>(
            smem + L::OFF_W + (i % STAGES) * L::STAGE + 2 * KV_BYTES);
        const float* svs = sks + BKV;
        const int* sseg = FEAT ? seg_slot(i) : nullptr;
        const int kv_last = f.kv0 + BKV - 1;
        const bool interior =
            kv_last < f.col_end && kv_last - f.q_first <= f.hi &&
            (!has_left || f.kv0 - f.q_last >= f.lo || kv_last < f.sk) &&
            !segs;
        float mx[2] = {kNegInf, kNegInf};
        if (interior)
          scores(sacc, sks, sseg, f, mx, Flag<false>());
        else
          scores(sacc, sks, sseg, f, mx, Flag<true>());
        alpha[0] = alpha[1] = 1.f;
        if (ONLINE) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
            mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
            const float m_new = fmaxf(m_row[hh], mx[hh]);
            alpha[hh] =
                EXP2 ? exp2f(m_row[hh] - m_new) : expf(m_row[hh] - m_new);
            m_row[hh] = m_new;
          }
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i8 = 0; i8 < 16; ++i8) {
          float2 vsc = make_float2(1.f, 1.f);
          if (QUANT) vsc = *reinterpret_cast<const float2*>(svs + 8 * i8 + cb);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = sacc[4 * i8 + e];
            float pe;
            if (ONLINE) {
              const float m = m_row[e >> 1];
              pe = EXP2 ? exp2f(v - m) : expf(v - m);
              if (v == kNegInf) pe = 0.f;  // masked entry
            } else {
              pe = exp2f(fminf(v, kClamp));  // exp2(-1e30) == 0
            }
            rs[e >> 1] += pe;
            if (FEAT && p.ft.drop)  // after l, before V's scale
              pe = drop_keep(p.ft, rh[e >> 1],
                             f.kpos + (8 * i8 + cb + (e & 1)) * p.dsc.st)
                       ? pe * p.ft.inv
                       : 0.f;
            if (QUANT) pe *= (e & 1) ? vsc.y : vsc.x;
            sacc[4 * i8 + e] = pe;
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
          rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
          l_row[hh] =
              ONLINE ? l_row[hh] * alpha[hh] + rs[hh] : l_row[hh] + rs[hh];
        }
      };
      // O *= alpha (online forms), then P to bf16 as the A operand:
      // accumulator (row, col pair) of 8-column group i8 -> the A fragment
      // of k16 step i8 / 2, rows g and g + 8
      uint32_t pa[32];
      auto to_pa = [&](const float (&sacc)[64]) {
        if (ONLINE) {
#pragma unroll
          for (int i8 = 0; i8 < D / 8; ++i8) {
            o[4 * i8] *= alpha[0];
            o[4 * i8 + 1] *= alpha[0];
            o[4 * i8 + 2] *= alpha[1];
            o[4 * i8 + 3] *= alpha[1];
          }
        }
#pragma unroll
        for (int i8 = 0; i8 < 16; ++i8) {
          pa[2 * i8] = pack_bf16(sacc[4 * i8], sacc[4 * i8 + 1]);
          pa[2 * i8 + 1] = pack_bf16(sacc[4 * i8 + 2], sacc[4 * i8 + 3]);
        }
      };

      if (x.n > 0 && idle) {
        // B9a's 64-row item: this warpgroup's rows are the next q tile's;
        // it releases Q and every stage unread and writes nothing
        mbar_wait(bar(B_QFULL), qn & 1);
        if (lane == 0) mbar_arrive(bar(B_QEMPTY));
        for (int jt = 0; jt < x.n; ++jt, ++it) {
          mbar_wait(bar(B_KFULL + it % STAGES), use(it));
          release(B_KEMPTY, it);
          mbar_wait(bar(B_VFULL + it % STAGES), use(it));
          release(B_VEMPTY, it);
        }
        ++qn;
      } else if (x.n > 0) {
        mbar_wait(bar(B_QFULL), qn & 1);
        if (!ONLINE) {  // fold scale*log2e into this warpgroup's q rows
#pragma unroll
          for (int i = 0; i < D / 16; ++i) {
            const int c = i * 128 + wtid;  // 16-byte chunk of the d boxes
            unsigned char* ptr =
                smem + (c >> 9) * BOX + cw * 64 * 128 + (c & 511) * 16;
            uint4 val = *reinterpret_cast<uint4*>(ptr);
            unsigned short* hv = reinterpret_cast<unsigned short*>(&val);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              hv[e] = float_to_bf16_bits(
                  __uint_as_float(((uint32_t)hv[e]) << 16) * p.qfold);
            *reinterpret_cast<uint4*>(ptr) = val;
          }
          fence_proxy_async();
          named_sync(NB_FOLD + cw, 128);
        }

        // the first tile: QK, its softmax, no PV in flight yet
        {
          float sacc[64];
          mbar_wait(bar(B_KFULL + it % STAGES), use(it));
          const Frame f = frame(it, 0);
          wgmma_fence();
          issue_qk(sacc, it);
          wgmma_wait<0>();
          reg_fence(sacc);
          if (x.n == 1 && lane == 0) mbar_arrive(bar(B_QEMPTY));
          softmax(sacc, it, f);
          release(B_KEMPTY, it);  // K, the scales and the step's meta
          to_pa(sacc);
        }
        // then per tile: QK of this tile and PV of the one before issue
        // together; this tile's softmax runs while that PV is on the
        // tensor cores
        for (int jt = 1; jt < x.n; ++jt) {
          ++it;
          float sacc[64];
          mbar_wait(bar(B_KFULL + it % STAGES), use(it));
          const Frame f = frame(it, jt);
          mbar_wait(bar(B_VFULL + (it - 1) % STAGES), use(it - 1));
          wgmma_fence();
          issue_qk(sacc, it);
          issue_pv(o, pa, it - 1);
          wgmma_wait<1>();
          reg_fence(sacc);
          if (jt == x.n - 1 && lane == 0) mbar_arrive(bar(B_QEMPTY));
          softmax(sacc, it, f);
          release(B_KEMPTY, it);
          wgmma_wait<0>();
          reg_fence(o);
          reg_fence(pa);
          release(B_VEMPTY, it - 1);
          to_pa(sacc);
        }
        // PV of the last tile
        mbar_wait(bar(B_VFULL + it % STAGES), use(it));
        wgmma_fence();
        issue_pv(o, pa, it);
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(pa);
        release(B_VEMPTY, it);
        ++it;
        ++qn;
      }
      if (idle) continue;

      // emit: out = acc / l (0 on a dead row), lse in natural log units
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qi = r0 + warp * 16 + g + hh * 8;
        if (qi >= p.s_q) continue;
        const float l = l_row[hh];
        __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.out) +
                              x.ib * p.o_sb + (long long)qi * p.o_ss +
                              x.ih * p.o_sh;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const float x0 = l == 0.f ? 0.f : o[4 * i + 2 * hh] / l;
          const float x1 = l == 0.f ? 0.f : o[4 * i + 2 * hh + 1] / l;
          *reinterpret_cast<uint32_t*>(orow + 8 * i + cb) = pack_bf16(x0, x1);
        }
        if ((lane & 3) == 0) {
          float v = logf(l);
          if (ONLINE) v = EXP2 ? m_row[hh] * kLn2 + v : m_row[hh] + v;
          p.lse[((long long)x.ib * p.h + x.ih) * p.s_q + qi] =
              l == 0.f ? __int_as_float(0xff800000) : v;  // -inf: dead row
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launch
// ---------------------------------------------------------------------------

// dims: b, h, h_kv, s_q, s_kv, q strides (b, s, h), k strides (b, s, h),
// v strides (b, s, h), out strides (b, s, h), scale strides (b, h, s),
// q_off, left, right, sink (the layout of the mma.sync entry points; B4's
// entry reads them), then the descriptor (sm90.cuh Desc) from index 24 and
// B3's features (sm90.cuh Feat) after it
constexpr int kDimsDesc = 24;
constexpr int kDimsFeat = kDimsDesc + kDescLen;
constexpr int kDimsKind = kDimsFeat + kFeatLen;  // B3's kind of K/V

// kv: the kind of K/V (kKv*), bf16 exactly when !QUANT
template <bool TRI, int FORM, bool QUANT, bool MULTI = false,
          bool FEAT = false>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, void* out, float* lse, const long long* dims,
           float qfold, float sscale, float cap, const Feat& ft, int kv,
           cudaStream_t stream) {
  Params p = {};
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
  p.dsc = desc_from(dims, kDimsDesc);
  p.qfold = qfold;
  p.sscale = sscale;
  p.cap = cap;
  p.ft = ft;
  p.kv = kv;
  if (FEAT && !feat_ok(ft)) return (int)cudaErrorInvalidValue;
  p.nq = (p.s_q + BQ - 1) / BQ;
  p.n_items = p.nq * p.h * p.b;
  if (p.h_kv <= 0 || p.h % p.h_kv || !desc_ok(p.dsc, p.s_q, p.s_kv, BQ))
    return (int)cudaErrorInvalidValue;
  if ((p.dsc.nqc * p.dsc.nkc > 1) != MULTI) return (int)cudaErrorInvalidValue;
  if ((kv != kKvBF16) != QUANT || kv < kKvBF16 || kv > kKvInt4 ||
      (QUANT && dims[19] != 1))
    return (int)cudaErrorInvalidValue;
  if (p.n_items == 0) return (int)cudaSuccess;

  Maps maps;
  const CUtensorMapDataType kv_type = QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int kv_esize = QUANT ? 1 : 2;
  // a quantized K/V row is one box: d bytes (int8, fp8) or d / 2 (int4)
  const int kv_row = kv == kKvInt4 ? D / 2 : D;
  const cuuint32_t q_box[4] = {64, BQ, 1, 1};
  const cuuint32_t kv_box[4] = {(cuuint32_t)(QUANT ? kv_row : 64), BKV, 1, 1};
  const cuuint32_t sc_box[3] = {BKV, 1, 1};
  const CUtensorMapSwizzle kv_swizzle =
      QUANT ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  const long long q_dims[4] = {D, p.s_q, p.h, p.b};
  const long long q_str[3] = {dims[6], dims[7], dims[5]};
  const long long kv_dims[4] = {kv_row, p.s_kv, p.h_kv, p.b};
  const long long k_str[3] = {dims[9], dims[10], dims[8]};
  const long long v_str[3] = {dims[12], dims[13], dims[11]};
  bool ok = encode(&maps.q, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 4, q_dims,
                   q_str, q_box, CU_TENSOR_MAP_SWIZZLE_128B) &&
            encode(&maps.k, k, kv_type, kv_esize, 4, kv_dims, k_str, kv_box,
                   kv_swizzle) &&
            encode(&maps.v, v, kv_type, kv_esize, 4, kv_dims, v_str, kv_box,
                   kv_swizzle);
  maps.ks = maps.q;  // unused without scales
  maps.vs = maps.q;
  maps.kseg = maps.q;  // unused without segments (or with int8 K/V)
  if (FEAT && !QUANT && ft.seg) {
    const long long sg_dims[2] = {p.s_kv, p.b};
    const long long sg_str[1] = {ft.kv_ld};
    const cuuint32_t sg_box[2] = {BKV, 1};
    ok = ok && encode(&maps.kseg, ft.kvseg, CU_TENSOR_MAP_DATA_TYPE_INT32, 4,
                      2, sg_dims, sg_str, sg_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (QUANT) {
    const long long sc_dims[3] = {p.s_kv, p.h_kv, p.b};
    const long long sc_str[2] = {dims[18], dims[17]};
    ok = ok &&
         encode(&maps.ks, ks, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 3, sc_dims,
                sc_str, sc_box, CU_TENSOR_MAP_SWIZZLE_NONE) &&
         encode(&maps.vs, vs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 3, sc_dims,
                sc_str, sc_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (!ok) return (int)cudaErrorInvalidValue;

  auto kern = flash_fwd_sm90_kernel<TRI, FORM, QUANT, false, MULTI, FEAT>;
  const int smem = Smem<QUANT, FEAT>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = p.n_items < num_sms() ? p.n_items : num_sms();
  kern<<<grid, Roles<QUANT>::NT, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

// B9a. dims (the layout of every sparse entry point): b, h, h_kv, s_q,
// s_kv, then (batch, seq, head) element strides of q, k, v, dout (unused),
// out and dk (unused), then n_q, n_kv, block_q, block_kv, per_head, the
// number of items and of blocks.
int launch_sparse(const void* q, const void* k, const void* v, void* out,
                  float* lse, const int* ptr, const int* ent,
                  const int* items, const int* sched_ptr, const int* sched,
                  const long long* dims, float qfold, cudaStream_t stream) {
#if LCA_HEAD_DIM != 128
  return (int)cudaErrorNotSupported;  // B9a at head dim 128 only
#else
  Params p = {};
  p.out = out;
  p.lse = lse;
  p.b = (int)dims[0];
  p.h = (int)dims[1];
  p.h_kv = (int)dims[2];
  p.s_q = (int)dims[3];
  p.s_kv = (int)dims[4];
  p.o_sb = dims[17];
  p.o_ss = dims[18];
  p.o_sh = dims[19];
  p.dsc.cq = p.s_q;  // rows are not chunked: the steps carry the mask
  p.qfold = qfold;
  p.ptr = ptr;
  p.ent = reinterpret_cast<const int4*>(ent);
  p.items = reinterpret_cast<const int4*>(items);
  p.sched_ptr = sched_ptr;
  p.sched = sched;
  p.n_q = (int)dims[23];
  const int n_kv = (int)dims[24];
  p.bq = (int)dims[25];
  p.bkv = (int)dims[26];
  p.per_head = (int)dims[27];
  if (p.h_kv <= 0 || p.h % p.h_kv || p.bq <= 0 || p.bkv <= 0 || p.bq % 64 ||
      p.bkv % 64 || p.s_q != p.n_q * p.bq || p.s_kv != n_kv * p.bkv)
    return (int)cudaErrorInvalidValue;
  p.n_items = (int)dims[28] * (p.per_head ? p.b : p.b * p.h);
  const int n_blocks = (int)dims[29];
  if (p.n_items == 0) return (int)cudaSuccess;
  if (n_blocks <= 0 || n_blocks > p.n_items) return (int)cudaErrorInvalidValue;

  Maps maps;
  const cuuint32_t box[4] = {64, 128, 1, 1};
  const long long q_dims[4] = {D, p.s_q, p.h, p.b};
  const long long kv_dims[4] = {D, p.s_kv, p.h_kv, p.b};
  const long long q_str[3] = {dims[6], dims[7], dims[5]};
  const long long k_str[3] = {dims[9], dims[10], dims[8]};
  const long long v_str[3] = {dims[12], dims[13], dims[11]};
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!(encode(&maps.q, q, bf16, 2, 4, q_dims, q_str, box, sw) &&
        encode(&maps.k, k, bf16, 2, 4, kv_dims, k_str, box, sw) &&
        encode(&maps.v, v, bf16, 2, 4, kv_dims, v_str, box, sw)))
    return (int)cudaErrorInvalidValue;
  maps.ks = maps.vs = maps.kseg = maps.q;  // unused without scales

  auto kern = flash_fwd_sm90_kernel<false, kFast, false, true>;
  const int smem = Smem<false>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<n_blocks, Roles<false>::NT, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
#endif
}

}  // namespace

// Kernel B1: causal self-attention (dims' window fields: -1, 0, 0).
extern "C" int lca_flash_fwd_causal_self(const void* q, const void* k,
                                         const void* v, void* out, float* lse,
                                         const long long* dims, float qfold,
                                         float sscale, int safe,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dims[3] != dims[4]) return (int)cudaErrorInvalidValue;
  return safe ? launch<true, kOnlineExp2, false>(
                    q, k, v, nullptr, nullptr, out, lse, dims, qfold, sscale,
                    0.f, Feat{}, kKvBF16, st)
              : launch<true, kFast, false>(q, k, v, nullptr, nullptr, out,
                                           lse, dims, qfold, sscale, 0.f,
                                           Feat{}, kKvBF16, st);
}

namespace {

// B3's instantiation for a softmax form (0 fast, 1 online in natural
// units, 2 softcap)
template <bool QUANT, bool MULTI, bool FEAT, class Args>
int pos_form(int form, const Args& args) {
  switch (form) {
    case 0: return args(launch<false, kFast, QUANT, MULTI, FEAT>);
    case 1: return args(launch<false, kOnlineNat, QUANT, MULTI, FEAT>);
    case 2: return args(launch<false, kSoftcap, QUANT, MULTI, FEAT>);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ... and for the features and the K/V (bf16 or quantized: the kind itself
// is a run-time value of the producers); at head dim 64 quantized K/V
// neither at MULTI nor with FEAT
template <bool MULTI, class Args>
int pos_kind(bool quant, bool feat, int form, const Args& args) {
#if LCA_HEAD_DIM != 128
  if (quant)
    return MULTI || feat ? (int)cudaErrorNotSupported
                         : pos_form<true, false, false>(form, args);
  return feat ? pos_form<false, MULTI, true>(form, args)
              : pos_form<false, MULTI, false>(form, args);
#else
  if (feat)
    return quant ? pos_form<true, MULTI, true>(form, args)
                 : pos_form<false, MULTI, true>(form, args);
  return quant ? pos_form<true, MULTI, false>(form, args)
               : pos_form<false, MULTI, false>(form, args);
#endif
}

}  // namespace

// Kernel B3: q rows at q_off + i, bf16 K/V or int8, fp8 or packed int4 K/V
// with fp32 scales (the kind after the features on dims: 0 bf16, 1 int8, 2
// fp8, 3 int4; ks != null exactly when quantized), any window, sinks and
// softcap; form: 0 fast, 1 online (natural units), 2 softcap. A
// multi-chunk descriptor (the ring's steps) and the features (segments,
// ALiBi, dropout: their operands after the stream) each take
// instantiations of their own.
extern "C" int lca_flash_fwd_pos(const void* q, const void* k, const void* v,
                                 const float* ks, const float* vs, void* out,
                                 float* lse, const long long* dims,
                                 float qfold, float sscale, float cap,
                                 int form, void* stream, LCA_FEAT_ARGS) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Feat ft = feat_from(dims, kDimsFeat, qseg, kvseg, slopes, drop_inv);
  const bool feat = ft.seg || ft.alibi || ft.drop;
  const int kv = (int)dims[kDimsKind];
  const auto args = [&](auto launcher) {
    return launcher(q, k, v, ks, vs, out, lse, dims, qfold, sscale, cap, ft,
                    kv, st);
  };
  const bool quant = kv != kKvBF16;
  if (quant != (ks != nullptr)) return (int)cudaErrorInvalidValue;
  if (dims[kDimsDesc] * dims[kDimsDesc + 1] > 1)
    return pos_kind<true>(quant, feat, form, args);
  return pos_kind<false>(quant, feat, form, args);
}

// Kernel B4: self-attention (s_q == s_kv, q_off 0) with any window, sinks
// and softcap. form: 0 fast, 1 online (exp2 units), 2 softcap. A causal
// call whose left window drops no column (left >= s - 1, as a chunk
// narrower than the window is) is causal self-attention, and runs B1's
// instantiation with its compile-time masks.
extern "C" int lca_flash_fwd_static(const void* q, const void* k,
                                    const void* v, void* out, float* lse,
                                    const long long* dims, float qfold,
                                    float sscale, float cap, int form,
                                    void* stream) {
#if LCA_HEAD_DIM != 128
  return (int)cudaErrorNotSupported;  // B4 at head dim 128 only
#else
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dims[3] != dims[4] || dims[20] != 0) return (int)cudaErrorInvalidValue;
  const auto args = [&](auto launcher) {
    return launcher(q, k, v, nullptr, nullptr, out, lse, dims, qfold, sscale,
                    cap, Feat{}, kKvBF16, st);
  };
  const bool plain_causal =
      dims[22] == 0 && (dims[21] < 0 || dims[21] >= dims[4] - 1);
  if (plain_causal && form == 0) return args(launch<true, kFast, false>);
  if (plain_causal && form == 1)
    return args(launch<true, kOnlineExp2, false>);
  switch (form) {
    case 0: return args(launch<false, kFast, false>);
    case 1: return args(launch<false, kOnlineExp2, false>);
    case 2: return args(launch<false, kSoftcap, false>);
    default: return (int)cudaErrorInvalidValue;
  }
#endif
}

// Kernel B9a: out (b, s_q, h, d) bf16 and lse (b, h, s_q) of a block-sparse
// mask, over the row tables' CSR form (ptr, ent), with the host's items
// ((row, first q row in its q tile, steps, 0), longest first) and each
// block's work items (sched_ptr, sched); the fast form with scale*log2e
// (qfold) folded into q. The arguments are those of every sparse entry
// point (dout, delta, the -inf-safe lse and scale unused).
extern "C" int lca_sparse_fwd(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse_in,
                              const float* delta, void* out, float* lse,
                              const int* ptr, const int* ent,
                              const int* items, const int* sched_ptr,
                              const int* sched, const long long* dims,
                              float qfold, float scale, void* stream) {
  return launch_sparse(q, k, v, out, lse, ptr, ent, items, sched_ptr, sched,
                       dims, qfold, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory a block takes: bf16 K/V (B1, B3, B4, B9a), or
// quantized K/V (quant != 0); with B3's features (feat != 0).
extern "C" int lca_flash_fwd_smem(int quant, int feat) {
  if (feat) return quant ? Smem<true, true>::BYTES : Smem<false, true>::BYTES;
  return quant ? Smem<true>::BYTES : Smem<false>::BYTES;
}

extern "C" const char* lca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
