// Flash-attention backward for Hopper (sm_90a only), dk and dv with or
// without dq: wgmma, TMA and a warp-specialised pipeline.
//
// Replaces the TPU kernels of long_context_attention_tpu/ops/flash.py:
//   lca_flash_bwd_dkv   <- _dkv_kernel (B2b): dk and dv of one kv tile, the
//                          GQA group's query heads and their q tiles walked
//                          inside the block (the TPU grid (b, h_kv, nk, g,
//                          nq) with the group folded in, so dk and dv need
//                          no atomics);
//   lca_flash_bwd_fused <- _bwd_fused_kernel (B5): B2b's walk, plus dq. Per
//                          tile p and dp are computed once and feed all
//                          three gradients; dq is added into a zeroed fp32
//                          (b, s, h, d) buffer by TMA reduce-adds, in place
//                          of the TPU's aliased-HBM dq read-modify-write,
//                          which relies on a sequential grid that Hopper
//                          does not have.
// and the TPU kernel of long_context_attention_tpu/ops/sparse.py:
//   lca_sparse_bwd_dkv  <- _sparse_dkv_kernel (B9c): dk and dv of a
//                          block-sparse mask's kv tiles over each column's
//                          live (GQA group head, q tile) entries.
// (B2a, lca_flash_bwd_dq, and B9b are in flash_dq_sm90.cu; B9a in
// flash_fwd_sm90.cu.)
//
// B9c is B2b's pipeline with another walk, chosen by the kernel's template
// parameter SPARSE: the producer, the consumers' products, softmax and
// write-out are one body, and only the item, the steps and the mask's
// positions come from the walk.
//
// All take bf16 q, dout (b, s_q, h, d) and k, v (b, s_kv, h_kv, d), read by
// TMA through their strides (16-byte aligned, unit stride along d); fp32 lse
// and delta = rowsum(dout * out), (b, h, s_q) contiguous; and write fp32
// partials. q row i sits at position q_start + i and kv column j at j; the
// masks are the forward's (flash-attn semantics): a column past its row's
// position plus the right window (0: causal) is dropped, and so is one
// before the row's position less the left window unless it is a sink
// (column < sink). A row whose lse is -inf (it saw no column in the
// forward) contributes nothing.
//
// What bounds it on an H100: tensor-core operations. Per live (row, column)
// pair B2b does 4 products of depth d (S, dP, dV, dK), B5 5 (and dQ), at
// 989 TFLOP/s bf16; the bytes (q, k, v, dout once, fp32 grads once) are a
// few percent of that time at s = 8192. B5 also adds a 64 x 128 fp32 dq
// tile (32 KB) into device memory per (kv tile, q tile) pair: 2.1 GB at s =
// 8192 with 16 heads, which the L2 absorbs only in part.
//
// Design (FlashAttention-3's backward). One persistent block per SM walks
// (kv tile, kv head, batch) items, longest causal walk first, dealt to the
// blocks in a snake order (B9c: its own items and schedule, below). An
// item's kv tile is BKV = 128 rows; it walks its group's query heads and,
// for each, the q tiles of BQ = 64 rows from the causal (or right-window)
// diagonal on, up to the last q tile its left window reaches, or to the
// end for a kv tile that holds a sink column (the TPU's _q_band_static). A
// block has one producer warpgroup and two consumer warpgroups:
//   * producer warp 0 (setmaxnreg down to 24, 32 or 40 registers) loads K
//     and V once per item, and per step Q and dout by TMA into a ring of
//     stages, with lse (in exp2 units; +inf for a dead row or a row past
//     s_q, so its p is exp2(-inf) = 0) and delta beside them, loaded by its
//     32 lanes;
//   * B5: producer warp 1 adds each step's dq tile to the output by TMA
//     reduce-adds from shared memory (four 32-column fp32 boxes), off the
//     consumers' path, and frees the tile once TMA has read it;
//   * each consumer warpgroup (setmaxnreg up to 240 or 232) owns 64 kv rows.
//     S^T = K Q^T and dP^T = V dout^T are wgmma m64n64k16 with both
//     operands in shared memory (128-byte swizzle, K-major); P^T and dS^T
//     form in registers on the accumulator layout, then dV += P^T dout and
//     dK += dS^T Q are wgmma m64n128k16 with the register A operand and
//     dout and Q as the MN-major B operand. dK and dV stay in registers for
//     the whole item and are written once.
//   * B5's dq: each consumer writes its bf16 dS^T rows into shared memory
//     (double-buffered), and after one barrier of both warpgroups each
//     computes dQ = dS K for its half of d, wgmma m64n64k16 over the 128 kv
//     rows with both operands MN-major; the fp32 tile goes to shared memory
//     in the reduce-add's swizzled layout.
//
// Shared memory (bytes; the 227 KB a block may use): K 32768 + V 32768 +
// stages x (Q 16384 + dout 16384) + stages x 520 (lse, delta, B9c's step
// positions), and for B5 2 dS^T tiles (16384 each) + the dq tile 32768; 3
// stages for B5 (230936), 4 for B2b and B9c (198688), + 256 of barriers and
// 1024 of alignment slack.
//
// B9c's walk. The host lists the items once per mask plan, longest walk
// first (ops/sparse.py SparsePlan.dkv_items), and deals them to the
// persistent blocks (SparsePlan.dkv_schedule): an item is BKV = 128 rows of a
// mask column's kv tile (block_kv, a multiple of 64, holds one or more; the
// last of an odd multiple of 64 is 64 rows, and the consumer whose rows
// belong to the next column releases every stage unread and writes nothing),
// with its step count; the kernel repeats each over the batch rows and, for
// a mask shared by the heads, the kv heads. The steps are the column's CSR
// range of (group index << 4 | flags, q tile, q_first, kv_first) entries, in
// the JAX tables' order, each cut into block_q / 64 steps of BQ q rows; on a
// MASKED entry a step that lies wholly above the diagonal is skipped, which
// drops only zeros. The causal mask compares global positions (q_first,
// kv_first: the layout's for ring shards), which the producer hands the
// consumers beside lse as the step's first q position less the item's first
// kv position. A column with no live entry writes zeros.
//
// Masks (template parameter MASK). kDense, causal or no mask, is the body
// every training step of an unwindowed model runs; kBand adds the sliding
// window (left, right) and the sinks: the band walk above, the masks at run
// time, and the items in the order of their walks' length (band_tile);
// kCap is kBand with the softcap, an instantiation of its own so that the
// other two keep their registers.
//
// Numerics follow the TPU kernels (_recompute_p, _ds_to_dqk):
//   s = (q . k) * scale in fp32 from the raw q (no log2e fold);
//   softcap: t = tanh(s / cap), s = cap * t (the forward's natural-units
//     form, flash_fwd_sm90.cu; tanh by the fast exp, sm90.cuh tanh_fast);
//   p = exp(s - lse) (computed as exp2(s * scale * log2e - lse * log2e), or
//     exp2(s * log2e - lse * log2e) capped), 0 on masked entries and on
//     rows with lse -inf (B9c: the -inf-safe lse, +1e30 on dead rows);
//   dp = dout . v; ds = p * (dp - delta) * scale, softcap: p * (1 - t^2) *
//     (dp - delta) * scale (p * (1 - t^2) kept in place of p, and bf16(p)
//     packed for dV while t is live: no second 64 x 64 array);
//   dv += bf16(p) . dout; dk += bf16(ds) . q; dq += bf16(ds) . k.
//   B9c (_sparse_dkv_kernel) scales after the cast: ds = p * (dp - delta),
//   dk = scale * sum bf16(ds) . q.
//
// The tensor maps are encoded on the host per call (sm90.cuh) and passed as
// __grid_constant__ kernel parameters.

#include "sm90.cuh"

namespace {

constexpr int D = 128;
constexpr int BQ = 64;    // q rows per step
constexpr int BKV = 128;  // kv rows per item: 64 per consumer warpgroup
constexpr int NT = 384;   // a producer and two consumer warpgroups
// registers a thread holds at launch (168); the consumers take what the
// producer gives back (setmaxnreg.inc waits for it): B5's consumers hold
// one more accumulator (dq) and get 240, leaving the producer 24; B2b's
// producer keeps 32 (24 spill its loop), B9c's 40 (its column walk spills
// 32), their consumers 232 either way
constexpr int REGS_AT_LAUNCH = 65536 / NT / 8 * 8;
template <bool FUSED, bool SPARSE>
struct Regs {
  static constexpr int PRODUCER = FUSED ? 24 : SPARSE ? 40 : 32;
  static constexpr int CONSUMER =
      (REGS_AT_LAUNCH * NT - 128 * PRODUCER) / 256 / 8 * 8;
};
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMasked = 4;  // a sparse column entry's flag (_F_MASKED)
// masks (template parameter MASK): causal or none; the window and sinks;
// those and the softcap
constexpr int kDense = 0, kBand = 1, kCap = 2;
constexpr int kOpen = 1 << 20;  // an unbounded end of a row's columns

// Shared memory. A bf16 tile is stored as 64-column boxes of 128-byte rows,
// swizzled in 1024-byte atoms of 8 rows (CU_TENSOR_MAP_SWIZZLE_128B, read by
// wgmma with a 128-byte-swizzle descriptor); d = 128 is two boxes.
constexpr int KBOX = BKV * 128;      // a 64-column box of K or V: 16 KB
constexpr int KV_BYTES = 2 * KBOX;   // one K or V tile
constexpr int QBOX = BQ * 128;       // a 64-column box of Q or dout: 8 KB
constexpr int QT_BYTES = 2 * QBOX;   // one Q or dout tile
constexpr int DS_BYTES = BKV * BQ * 2;  // bf16 dS^T [kv][q]: 16 KB
constexpr int DQBOX = BQ * 128;      // 32 fp32 columns of the dq tile: 8 KB
constexpr int DQ_BYTES = 4 * DQBOX;  // the 64 x 128 fp32 dq tile
constexpr int LD_BYTES = 2 * BQ * 4;  // a step's lse and delta
constexpr int META_BYTES = 8;         // B9c: a step's positions (int2)

template <bool FUSED>
struct Smem {
  static constexpr int STAGES = FUSED ? 3 : 4;
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_ST = 2 * KV_BYTES;  // stages: Q, then dout
  static constexpr int OFF_DS = OFF_ST + STAGES * 2 * QT_BYTES;
  static constexpr int OFF_DQ = OFF_DS + (FUSED ? 2 * DS_BYTES : 0);
  static constexpr int OFF_LD = OFF_DQ + (FUSED ? DQ_BYTES : 0);
  static constexpr int OFF_META = OFF_LD + STAGES * LD_BYTES;
  static constexpr int OFF_BAR = OFF_META + STAGES * META_BYTES;
  static constexpr int BYTES = OFF_BAR + 256 + 1024;  // barriers, alignment
};
static_assert(Smem<true>::BYTES <= 232448 && Smem<false>::BYTES <= 232448,
              "shared memory over the 227 KB a block may use");

// mbarrier slots: K/V full and empty; each stage's full and empty; the dq
// tile full (written by the consumers) and empty (read by TMA)
constexpr int B_KVFULL = 0, B_KVEMPTY = 1, B_FULL = 2, B_EMPTY = 6,
              B_DQFULL = 10, B_DQEMPTY = 11;
// named barrier (0 is __syncthreads): both consumers' dS^T rows written
constexpr int NB_DS = 1;

struct Maps {  // TMA descriptors, in the kernel's parameter space
  CUtensorMap q, dout, k, v, dq;
};

struct Params {
  const float* lse;
  const float* delta;
  float* dk;
  float* dv;
  int b, h, h_kv, s_q, s_kv;
  long long dk_sb, dk_ss, dk_sh;  // dk and dv element strides
  Desc dsc;    // the positions and masks in chunk-local units (sm90.cuh)
  int causal;  // kDense: the causal mask (hi), else none
  // a multi-chunk descriptor's kv tiles in the order of their walks,
  // longest first (the host's: ops/flash.py), else null
  const int* order;
  float cap;        // kCap: the softcap
  float sc;         // kCap: scale / cap
  float scale;
  float sl2;  // scale * log2e
  int nq, nk, n_items;
  // B9c: the column tables' CSR form, the host's items (column, first row
  // in its kv tile, steps, 0) and each block's work items, block i's at
  // sched[sched_ptr[i] .. sched_ptr[i + 1])
  const int* ptr;
  const int4* ent;
  const int4* items;
  const int* sched_ptr;
  const int* sched;
  int n_kv, bq, bkv, per_head;
};

// K-major operand (K, V rows; Q, dout rows): 8-row groups 1024 bytes apart;
// a k16 step moves 32 bytes inside the 128-byte swizzle row
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// MN-major operand ([k][mn] with mn contiguous): 8 k rows 1024 bytes apart,
// the next 64-wide mn box `box` bytes on (unused for a 64-wide operand)
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, uint32_t box) {
  return desc_sw128(addr, box, 1024);
}

// d (64 x 64 fp32) += A (64 x 16 bf16) * B (16 x 64 bf16), both in shared
// memory, K-major (TRANS 0) or MN-major (TRANS 1)
template <int TRANS>
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t da,
                                        uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LCA_D32
      ", %32, %33, 1, 1, 1, %34, %34;\n"
      : LCA_ACC32(d)
      : "l"(da), "l"(db), "n"(TRANS));
}

// d = A * B, as wgmma64 with d written, not read
template <int TRANS>
__device__ __forceinline__ void wgmma64_first(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LCA_D32
      ", %32, %33, 0, 1, 1, %34, %34;\n"
      : LCA_OUT32(d)
      : "l"(da), "l"(db), "n"(TRANS));
}

// ---------------------------------------------------------------------------
// The items and the q walk
// ---------------------------------------------------------------------------

struct Item {
  int ik, ihk, ib;
  int k0;    // first kv row
  int n;     // steps
  int rows;  // rows of the 128 that the item owns (B9c: 64 for the last
             // item of an odd multiple of 64)
  int sub, e0, e_end;  // B9c: k0 in its kv tile; its column's CSR range
};

// The steps of a dense item: the group's query heads, each with, q chunk
// by q chunk, the q tiles from the first that sees the kv tile (all under
// no mask) to the last; with the band masks, to the last that its left
// window reaches (all for a kv tile that holds a sink column). kc and k0l:
// the kv tile's chunk and its first row in it. MULTI: a descriptor of two
// chunks on a side (B2b on the ring's steps).
template <bool BAND, bool MULTI = false>
struct QWalk {
  int kc, k0l, nqi, n;
  int lo[2], nq[2];
  __device__ QWalk(const Params& p, int ik) {
    kc = MULTI ? ik * BKV / p.dsc.ckv : 0;
    k0l = ik * BKV - kc * p.dsc.ckv;
    const int tiles = (p.dsc.cq + BQ - 1) / BQ;  // per q chunk
    nqi = 0;
#pragma unroll
    for (int qc = 0; qc < 2; ++qc) {
      lo[qc] = nq[qc] = 0;
      if (qc >= (MULTI ? p.dsc.nqc : 1)) continue;
      const int pr = qc * 2 + kc;
      int iq_lo = 0;
      if (BAND || p.causal != 0) {
        // the first row that sees it
        const int first_row = k0l - p.dsc.hi[pr];
        iq_lo = first_row <= 0 ? 0 : min(tiles, first_row / BQ);
      }
      int iq_hi = tiles - 1;
      if (BAND && k0l >= p.dsc.sk[pr]) {
        const int last_row = k0l + BKV - 1 - p.dsc.lo[pr];
        iq_hi = last_row < 0 ? -1 : min(iq_hi, last_row / BQ);
      }
      lo[qc] = iq_lo;
      nq[qc] = max(iq_hi - iq_lo + 1, 0);
      nqi += nq[qc];
    }
    n = (p.h / p.h_kv) * nqi;
  }
  __device__ int head(const Item& x, const Params& p, int js) const {
    return x.ihk * (p.h / p.h_kv) + js / nqi;
  }
  // the q chunk of step js, and its first q row (global)
  __device__ int qchunk(int js) const { return MULTI && js % nqi >= nq[0]; }
  __device__ int q0(const Params& p, int js) const {
    const int r = js % nqi;
    const int qc = MULTI && r >= nq[0];
    return qc * p.dsc.cq + (lo[qc] + r - (qc ? nq[0] : 0)) * BQ;
  }
};

// The kv tile of rank r in the band's longest-first order. Sink tiles walk
// to the last q tile, so they come first, in order. After them the walks
// rise while the first q tile is clamped at 0 (B, the tiles before P) and
// fall from there on (A: the first and last q tiles both move by 2 per kv
// tile until the last is clamped at the end), so the order merges A
// ascending and B descending; the r-th of the merge by a binary search over
// how many of the first r come from A (ties to A).
// One chunk a side (a multi-chunk descriptor takes the host's order).
__device__ __forceinline__ int band_tile(const Params& p, int r) {
  const int ns = min((p.dsc.sk[0] + BKV - 1) / BKV, p.nk);
  if (r < ns) return r;
  r -= ns;
  int P = p.nk;
  if (p.dsc.hi[0] < kOpenRel) {
    const int x = p.dsc.hi[0];  // lo >= 0 from tile ceil(x / BKV)
    P = x <= 0 ? ns : min(max((x + BKV - 1) / BKV, ns), p.nk);
  }
  const int na = p.nk - P, nb = P - ns;
  auto len_a = [&](int i) { return QWalk<true>(p, P + i).nqi; };
  auto len_b = [&](int j) { return QWalk<true>(p, P - 1 - j).nqi; };
  int lo = max(0, r - nb), hi = min(r, na);
  while (lo < hi) {  // the least i whose A[i] does not precede B[r - i - 1]
    const int i = (lo + hi) >> 1;
    if (len_a(i) >= len_b(r - i - 1))
      lo = i + 1;
    else
      hi = i;
  }
  const int j = r - lo;
  return lo < na && (j >= nb || len_a(lo) >= len_b(j)) ? P + lo : P - 1 - j;
}

// Item t. Dense: kv tiles outside, kv tile 0 (the longest causal walk)
// first, kv heads and batch rows inside; with the band masks the kv tiles
// in band_tile's order, longest walk first. The order with the kv heads
// outside, whose blocks running at once share fewer kv heads and dq rows,
// balanced the blocks' work worse and ran 1.7x slower
// (scripts/torch_bwd_order.py). B9c: the host's items in its order, each
// repeated over the batch rows (and the kv heads of a shared mask) inside.
template <bool SPARSE, bool BAND, bool MULTI>
__device__ __forceinline__ Item item_of(const Params& p, int t) {
  Item x;
  if constexpr (SPARSE) {
    const int reps = p.per_head ? p.b : p.b * p.h_kv;
    const int4 e = p.items[t / reps];
    const int r = t % reps;
    x.ib = r % p.b;
    x.ihk = p.per_head ? e.x / p.n_kv : r / p.b;
    x.ik = e.x % p.n_kv;
    x.sub = e.y;
    x.k0 = x.ik * p.bkv + e.y;
    x.n = e.z;
    x.rows = min(BKV, p.bkv - e.y);
    x.e0 = p.ptr[e.x];
    x.e_end = p.ptr[e.x + 1];
  } else {
    const int r = t % (p.b * p.h_kv);
    x.ik = t / (p.b * p.h_kv);
    if constexpr (MULTI)
      x.ik = p.order[x.ik];
    else if constexpr (BAND)
      x.ik = band_tile(p, x.ik);
    x.ihk = r % p.h_kv;
    x.ib = r / p.h_kv;
    x.k0 = x.ik * BKV;
    x.n = QWalk<BAND, MULTI>(p, x.ik).n;
    x.rows = BKV;
    x.sub = x.e0 = x.e_end = 0;
  }
  return x;
}

// The items of this persistent block (BlockItems, sm90.cuh): dense,
// item_index's snake over the longest-first order; B9c, the host's list for
// the block (ops/sparse.py SparsePlan.dkv_schedule: items longest first,
// each to the block with the least work so far, since a column seen by every
// q tile, such as StreamingLLM's sink, outweighs the rest several times and a
// snake leaves the blocks uneven). The band masks deal the snake with holes:
// a sink item (the first m of band_tile's order, one per sink tile, kv head
// and batch row, all in the snake's first row) walks every q tile, k times
// the steps of the longest band item, so its block's next k - 1 turns are
// holes, and the other blocks take those turns' items (at s = 8192, window
// 4096: 256 against 132 steps, k = 2; the most steps on a block 508 -> 392,
// the mean 391).
template <bool SPARSE, bool BAND, bool MULTI>
struct Deal : BlockItems<SPARSE> {
  int m = 0, k = 1, n_virtual = 0;
  __device__ explicit Deal(const Params& p) : BlockItems<SPARSE>(p) {
    if constexpr (BAND) {
      const int g = gridDim.x;
      // the host's order (a multi-chunk descriptor) deals no holes
      const int ns = MULTI ? 0 : min((p.dsc.sk[0] + BKV - 1) / BKV, p.nk);
      m = ns * p.b * p.h_kv;
      if (ns > 0 && ns < p.nk && m <= g) {
        const int ls = QWalk<true>(p, 0).nqi;
        const int lb = QWalk<true>(p, band_tile(p, ns)).nqi;
        if (lb > 0) k = max(1, (ls + lb / 2) / lb);
      }
      n_virtual = p.n_items + m * (k - 1);
      this->end = (n_virtual + g - 1) / g;
    }
  }
  // item t of the block's j-th turn, or -1 (none, or a hole)
  __device__ int at(const Params& p, int j) const {
    if constexpr (!BAND) {
      return BlockItems<SPARSE>::at(p, j);
    } else {
      const int g = gridDim.x;
      const int v = item_index(j);  // the turn's place in the snake
      if (v >= n_virtual) return -1;
      const int row = v / g, o = v - row * g;
      int holes = m * min(max(row - 1, 0), k - 1);  // in the rows before
      if (row >= 1 && row <= k - 1) {  // the sink blocks' places: a hole
        if (row & 1 ? o >= g - m : o < m) return -1;
        if (!(row & 1)) holes += m;
      }
      const int t = v - holes;
      return t < p.n_items ? t : -1;
    }
  }
};

// B9c: a step of a column's walk, q sub-tile j (of block_q / 64) of CSR
// entry e; entries with no step are passed over
struct ColStep {
  int e, j;
  int4 en;  // (group index << 4 | flags, q tile, q_first, kv_first)
};

__device__ __forceinline__ ColStep col_from(const Params& p, const Item& x,
                                            int e) {
  const int nsub = p.bq / BQ;
  for (; e < x.e_end; ++e) {
    const int4 en = p.ent[e];
    int lo = 0;
    if (en.x & kMasked) {  // skip j while q_first + 64 j + 63 < kv_first + sub
      const int d = en.w + x.sub - en.z - (BQ - 1);
      lo = d <= 0 ? 0 : (d + BQ - 1) / BQ;
    }
    if (lo < nsub) return ColStep{e, lo, en};
  }
  return ColStep{x.e_end, 0, make_int4(0, 0, 0, 0)};
}

__device__ __forceinline__ ColStep col_next(const Params& p, const Item& x,
                                            const ColStep& c) {
  if (c.j + 1 < p.bq / BQ) return ColStep{c.e, c.j + 1, c.en};
  return col_from(p, x, c.e + 1);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// FUSED: B5 (dq too); SPARSE: B9c's walk; neither: B2b. MASK: kDense,
// kBand or kCap (B2b, B5). MULTI: B2b at a multi-chunk descriptor.
template <bool FUSED, bool SPARSE, int MASK = kDense, bool MULTI = false>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  static_assert(!(FUSED && SPARSE), "B9c computes no dq");
  static_assert(!SPARSE || MASK == kDense, "B9c: the masks of its entries");
  constexpr bool BAND = MASK != kDense;
  constexpr bool CAP = MASK == kCap;
  static_assert(Regs<FUSED, SPARSE>::CONSUMER == (FUSED ? 240 : 232),
                "the consumers' register budget");
  using L = Smem<FUSED>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 1024-byte aligned base as an offset into the shared array (an
  // integer round trip of the address makes the shared loads generic)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  auto bar = [&](int i) -> uint32_t { return sbase + L::OFF_BAR + 8 * i; };
  // stage of the i-th step of the block's stream, and the parity of its use
  // of that stage
  auto stage = [&](int i) -> uint32_t {
    return sbase + L::OFF_ST + (i % STAGES) * 2 * QT_BYTES;
  };
  auto use = [&](int i) -> int { return (i / STAGES) & 1; };
  auto lse_delta = [&](int i) -> float* {  // lse[BQ] in exp2 units, delta[BQ]
    return reinterpret_cast<float*>(smem + L::OFF_LD +
                                    (i % STAGES) * LD_BYTES);
  };
  // the step's first q position less the item's first kv position, and B9c:
  // its entry's MASKED flag; dense: chunk-local rows (kDense adds the pair's
  // hi), and the item's first row in its kv chunk times 4 plus the chunk
  // pair
  auto meta = [&](int i) -> int2* {
    return reinterpret_cast<int2*>(smem + L::OFF_META +
                                   (i % STAGES) * META_BYTES);
  };

  if (threadIdx.x == 0) {
    mbar_init(bar(B_KVFULL), 1);
    mbar_init(bar(B_KVEMPTY), 8);  // one arrival per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar(B_FULL + s), 33);  // TMA's expect_tx and the 32 lanes
      mbar_init(bar(B_EMPTY + s), 8);
    }
    mbar_init(bar(B_DQFULL), 256);  // every consumer thread
    mbar_init(bar(B_DQEMPTY), 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int wtid = threadIdx.x & 127;
  const int warp = wtid >> 5;
  const int lane = wtid & 31;

  if (wg == 0) {
    // ======================= producer warpgroup =======================
    setmaxnreg_dec<Regs<FUSED, SPARSE>::PRODUCER>();
    if (warp == 0) {  // loads
      int it = 0, kvn = 0;
      const Deal<SPARSE, BAND, MULTI> items(p);
      for (int j = items.j0; j < items.end; ++j) {
        const int t = items.at(p, j);
        if (t < 0) continue;
        const Item x = item_of<SPARSE, BAND, MULTI>(p, t);
        if (x.n == 0) continue;
        if (lane == 0) {
          mbar_wait(bar(B_KVEMPTY), (kvn & 1) ^ 1);
          mbar_expect_tx(bar(B_KVFULL), 2 * KV_BYTES);
          for (int hb = 0; hb < 2; ++hb) {
            tma_load_4d(sbase + L::OFF_K + hb * KBOX, &maps.k, bar(B_KVFULL),
                        64 * hb, x.k0, x.ihk, x.ib);
            tma_load_4d(sbase + L::OFF_V + hb * KBOX, &maps.v, bar(B_KVFULL),
                        64 * hb, x.k0, x.ihk, x.ib);
          }
        }
        ++kvn;
        const QWalk<BAND, MULTI> w(p, x.ik);
        ColStep c{};
        if constexpr (SPARSE) c = col_from(p, x, x.e0);
        for (int js = 0; js < x.n; ++js, ++it) {
          const int s = it % STAGES;
          int ih, q0;
          if constexpr (SPARSE) {
            ih = x.ihk * (p.h / p.h_kv) + (c.en.x >> 4);
            q0 = c.en.y * p.bq + c.j * BQ;
          } else {
            ih = w.head(x, p, js);
            q0 = w.q0(p, js);
          }
          mbar_wait(bar(B_EMPTY + s), use(it) ^ 1);
          if (lane == 0) {
            const uint32_t st = stage(it);
            mbar_expect_tx(bar(B_FULL + s), 2 * QT_BYTES);
            for (int hb = 0; hb < 2; ++hb) {
              tma_load_4d(st + hb * QBOX, &maps.q, bar(B_FULL + s), 64 * hb,
                          q0, ih, x.ib);
              tma_load_4d(st + QT_BYTES + hb * QBOX, &maps.dout,
                          bar(B_FULL + s), 64 * hb, q0, ih, x.ib);
            }
            if constexpr (SPARSE) {
              *meta(it) = make_int2(c.en.z + c.j * BQ - (c.en.w + x.sub),
                                    c.en.x & kMasked);
            } else if constexpr (MULTI) {
              // the step's place, so the consumers keep no walk
              const int qc = w.qchunk(js);
              const int pr = qc * 2 + w.kc;
              *meta(it) = make_int2(
                  q0 - qc * p.dsc.cq - w.k0l + (BAND ? 0 : p.dsc.hi[pr]),
                  w.k0l * 4 + pr);
            }
          }
          float* ld = lse_delta(it);
          for (int r = lane; r < BQ; r += 32) {
            const int qi = q0 + r;
            float l = __int_as_float(0x7f800000), dl = 0.f;  // +inf: p = 0
            if (qi < p.s_q) {
              const long long at = ((long long)x.ib * p.h + ih) * p.s_q + qi;
              const float raw = p.lse[at];
              if (raw != __int_as_float(0xff800000)) l = raw * kLog2e;
              dl = p.delta[at];
            }
            ld[r] = l;
            ld[BQ + r] = dl;
          }
          mbar_arrive(bar(B_FULL + s));
          if constexpr (SPARSE) c = col_next(p, x, c);
        }
      }
    } else if (FUSED && warp == 1 && lane == 0) {  // dq reduce-adds
      int dn = 0;
      const Deal<false, BAND, MULTI> items(p);
      for (int j = items.j0; j < items.end; ++j) {
        const int t = items.at(p, j);
        if (t < 0) continue;
        const Item x = item_of<false, BAND, MULTI>(p, t);
        const QWalk<BAND, MULTI> w(p, x.ik);
        for (int js = 0; js < w.n; ++js, ++dn) {
          mbar_wait(bar(B_DQFULL), dn & 1);
          for (int bx = 0; bx < 4; ++bx)
            tma_reduce_add_4d(&maps.dq, sbase + L::OFF_DQ + bx * DQBOX,
                              32 * bx, w.q0(p, js), w.head(x, p, js), x.ib);
          bulk_commit();
          bulk_wait_read();
          mbar_arrive(bar(B_DQEMPTY));
        }
      }
      bulk_wait();
    }
    return;
  }

  // ======================= consumer warpgroups =======================
  setmaxnreg_inc<Regs<FUSED, SPARSE>::CONSUMER>();
  const int cw = wg - 1;          // which 64 kv rows of the item
  const int g = lane >> 2;        // accumulator row (and row + 8)
  const int cb = 2 * (lane & 3);  // accumulator column pair in each 8
  const uint32_t k_rows = sbase + L::OFF_K + cw * 64 * 128;
  const uint32_t v_rows = sbase + L::OFF_V + cw * 64 * 128;

  // this lane's first kv row in an item (and that + 8)
  const int r0 = cw * 64 + warp * 16 + g;

  int it = 0, kvn = 0, dn = 0;
  const Deal<SPARSE, BAND, MULTI> items(p);
  for (int j = items.j0; j < items.end; ++j) {
    const int t = items.at(p, j);
    if (t < 0) continue;
    const Item x = item_of<SPARSE, BAND, MULTI>(p, t);
    // one chunk a side: the consumers place each step from the walk
    const QWalk<BAND, MULTI> w(p, x.ik);
    const int k0 = x.k0 + cw * 64;  // first kv row of this warpgroup
    const int kv_row0 = x.k0 + r0;
    // B9c: rows of the next mask column (the second half of a 64-row item)
    const bool idle = SPARSE && cw * 64 >= x.rows;

    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

    // P^T of one step in place of S^T: p = exp2(s * scale * log2e - lse
    // * log2e), 0 where `masked` drops the (kv row, q row) pair: a row past
    // s_kv, or under the causal mask a kv row r of the item after q row c of
    // the step (position r > rel + c); with the band masks, r > rel + c +
    // right, or r < rel + c - left for a kv row at or past the sinks, which
    // leaves each kv row one interval of q columns, [lo, hi], set once per
    // step (the sink tile's walk masks most of its steps). kCap: s = cap *
    // tanh(s * scale / cap), P^T * (1 - t^2) in place and bf16(P^T) into pa
    auto probs = [&](float (&sacc)[32], uint32_t (&pa)[16], const float* ld,
                     int rel, bool causal, int pr, int k0l, auto masked) {
      int lo[2] = {0, 0}, hi[2] = {0, 0};  // less this lane's column cb
      if (BAND && decltype(masked)::value) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + hh * 8;
          lo[hh] = r - rel - p.dsc.hi[pr] - cb;
          hi[hh] = (k0l + r >= p.dsc.sk[pr] ? r - rel - p.dsc.lo[pr]
                                            : kOpen) - cb;
          if (x.k0 + r >= p.s_kv) hi[hh] = -kOpen;
        }
      }
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8) {
        const float2 l = *reinterpret_cast<const float2*>(ld + 8 * i8 + cb);
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe, dt = 1.f;
          if constexpr (CAP) {
            const float tc = tanh_fast(sacc[4 * i8 + e] * p.sc);
            pe = exp2f(tc * p.cap * kLog2e - ((e & 1) ? l.y : l.x));
            dt = 1.f - tc * tc;
          } else {
            pe = exp2f(sacc[4 * i8 + e] * p.sl2 - ((e & 1) ? l.y : l.x));
          }
          if (decltype(masked)::value) {
            if constexpr (BAND) {
              const int cc = 8 * i8 + (e & 1);
              if (cc < lo[e >> 1] || cc > hi[e >> 1]) pe = 0.f;
            } else {
              const int r = r0 + (e >> 1) * 8;
              const int c = 8 * i8 + cb + (e & 1);
              if (x.k0 + r >= p.s_kv || (causal && r > rel + c)) pe = 0.f;
            }
          }
          pv[e] = pe;
          sacc[4 * i8 + e] = CAP ? pe * dt : pe;
        }
        if constexpr (CAP) {
          pa[2 * i8] = pack_bf16(pv[0], pv[1]);
          pa[2 * i8 + 1] = pack_bf16(pv[2], pv[3]);
        }
      }
    };

    if (x.n > 0) {
      mbar_wait(bar(B_KVFULL), kvn & 1);
      for (int js = 0; js < x.n; ++js, ++it) {
        const int s = it % STAGES;
        const uint32_t st = stage(it);
        mbar_wait(bar(B_FULL + s), use(it));
        if (idle) {  // release the stage unread
          __syncwarp();
          if (lane == 0) mbar_arrive(bar(B_EMPTY + s));
          continue;
        }
        // the step's first q position less the item's first kv position
        // (dense: chunk-local rows, and kDense adds the pair's hi, so that
        // the causal mask drops r > rel + c), and the chunk pair
        int rel, pr = 0, k0l = 0;
        bool causal;
        if constexpr (SPARSE || MULTI) {
          const int2 m = *meta(it);
          rel = m.x;
          if constexpr (MULTI) {
            pr = m.y & 3;
            k0l = m.y >> 2;
          }
          causal = SPARSE ? m.y != 0 : p.causal != 0;
        } else {
          k0l = w.k0l;
          rel = w.q0(p, js) - k0l + (BAND ? 0 : p.dsc.hi[0]);
          causal = p.causal != 0;
        }

        // S^T = K Q^T, then dP^T = V dout^T: 8 k16 steps, 4 in each d box
        float sacc[32], dpacc[32];
        wgmma_fence();
        wgmma64_first<0>(sacc, desc_kmajor(k_rows), desc_kmajor(st));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma64<0>(sacc,
                     desc_kmajor(k_rows + (kk >> 2) * KBOX + (kk & 3) * 32),
                     desc_kmajor(st + (kk >> 2) * QBOX + (kk & 3) * 32));
        wgmma_commit();
        wgmma64_first<0>(dpacc, desc_kmajor(v_rows),
                         desc_kmajor(st + QT_BYTES));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma64<0>(dpacc,
                     desc_kmajor(v_rows + (kk >> 2) * KBOX + (kk & 3) * 32),
                     desc_kmajor(st + QT_BYTES + (kk >> 2) * QBOX +
                                 (kk & 3) * 32));
        wgmma_commit();

        // P^T while dP^T is on the tensor cores; only a tile that some pair
        // of this warpgroup's leaves is masked
        const float* ld = lse_delta(it);
        uint32_t pa[16], da[16];
        bool masked;
        if constexpr (BAND)  // a wholly-sink warpgroup is interior on the left
          masked = k0 + 63 >= p.s_kv ||
                   cw * 64 + 63 - rel > p.dsc.hi[pr] ||
                   (cw * 64 - rel - 63 < p.dsc.lo[pr] &&
                    k0l + cw * 64 + 63 >= p.dsc.sk[pr]);
        else
          masked = (causal && cw * 64 + 63 > rel) || k0 + 63 >= p.s_kv;
        wgmma_wait<1>();
        reg_fence(sacc);
        if (masked)
          probs(sacc, pa, ld, rel, causal, pr, k0l, Flag<true>());
        else
          probs(sacc, pa, ld, rel, causal, pr, k0l, Flag<false>());
        wgmma_wait<0>();
        reg_fence(dpacc);

        // dS^T = P^T (dP^T - delta) * scale (kCap: P^T (1 - t^2) in place of
        // P^T; B9c: the scale after the cast); P^T (but for kCap, packed
        // already) and dS^T to bf16 as the A operands: accumulator (row,
        // column pair) of 8-column group i8 -> the A fragment of k16 step
        // i8 / 2
#pragma unroll
        for (int i8 = 0; i8 < 8; ++i8) {
          const float2 dl =
              *reinterpret_cast<const float2*>(ld + BQ + 8 * i8 + cb);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dpacc[4 * i8 + e] = sacc[4 * i8 + e] *
                                (dpacc[4 * i8 + e] - ((e & 1) ? dl.y : dl.x));
            if constexpr (!SPARSE) dpacc[4 * i8 + e] *= p.scale;
          }
          if constexpr (!CAP) {
            pa[2 * i8] = pack_bf16(sacc[4 * i8], sacc[4 * i8 + 1]);
            pa[2 * i8 + 1] = pack_bf16(sacc[4 * i8 + 2], sacc[4 * i8 + 3]);
          }
          da[2 * i8] = pack_bf16(dpacc[4 * i8], dpacc[4 * i8 + 1]);
          da[2 * i8 + 1] = pack_bf16(dpacc[4 * i8 + 2], dpacc[4 * i8 + 3]);
        }
        const uint32_t ds_buf = sbase + L::OFF_DS + (it & 1) * DS_BYTES;
        if (FUSED) {  // this warpgroup's rows of bf16 dS^T [kv][q], swizzled
          const uint32_t row =
              ds_buf + (cw * 64 + warp * 16 + g) * 128 + cb * 2;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int i8 = 0; i8 < 8; ++i8)
              st_shared_b32(row + hh * 8 * 128 + ((i8 ^ g) << 4),
                            da[2 * i8 + hh]);
          fence_proxy_async();
        }

        // dV += P^T dout and dK += dS^T Q: 4 k16 steps of 16 q rows (2048
        // bytes of the MN-major tile each)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs(dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                   pa[4 * kk + 3],
                   desc_mnmajor(st + QT_BYTES + kk * 2048, QBOX));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs(dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                   da[4 * kk + 3], desc_mnmajor(st + kk * 2048, QBOX));
        wgmma_commit();

        if (FUSED) {
          // dQ = dS K for this warpgroup's 64 d columns: 8 k16 steps of 16
          // kv rows, dS (from dS^T) and K both MN-major
          named_sync(NB_DS, 256);  // both warpgroups' dS^T rows are in
          float dq[32];
          const uint32_t kb = sbase + L::OFF_K + cw * KBOX;
          wgmma64_first<1>(dq, desc_mnmajor(ds_buf, 0),
                           desc_mnmajor(kb, 0));
#pragma unroll
          for (int kk = 1; kk < BKV / 16; ++kk)
            wgmma64<1>(dq, desc_mnmajor(ds_buf + kk * 2048, 0),
                       desc_mnmajor(kb + kk * 2048, 0));
          wgmma_commit();
          wgmma_wait<0>();
          reg_fence(dk);
          reg_fence(dv);
          reg_fence(dq);
          reg_fence(pa);
          reg_fence(da);
          __syncwarp();
          if (lane == 0) mbar_arrive(bar(B_EMPTY + s));
          // the dq tile into the reduce-add's layout: four boxes of 32 fp32
          // columns, 128-byte rows, 16-byte chunks swizzled by row
          mbar_wait(bar(B_DQEMPTY), (dn & 1) ^ 1);
          const uint32_t row = sbase + L::OFF_DQ + 2 * cw * DQBOX +
                               (warp * 16 + g) * 128 + (cb & 3) * 4;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int i8 = 0; i8 < 8; ++i8) {
              const int chunk = 2 * (i8 & 3) + (cb >> 2);
              st_shared_v2f32(row + (i8 >> 2) * DQBOX + hh * 8 * 128 +
                                  ((chunk ^ g) << 4),
                              dq[4 * i8 + 2 * hh], dq[4 * i8 + 2 * hh + 1]);
            }
          fence_proxy_async();
          mbar_arrive(bar(B_DQFULL));
          ++dn;
        } else {
          wgmma_wait<0>();
          reg_fence(dk);
          reg_fence(dv);
          reg_fence(pa);
          reg_fence(da);
          __syncwarp();
          if (lane == 0) mbar_arrive(bar(B_EMPTY + s));
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(B_KVEMPTY));
      ++kvn;
    }

    // write dk and dv once (0 for a kv tile no q row sees; B9c: dk times
    // the scale)
    if (idle) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kv = kv_row0 + hh * 8;
      if (kv >= p.s_kv) continue;
      const long long at = x.ib * p.dk_sb + (long long)kv * p.dk_ss +
                           x.ihk * p.dk_sh;
#pragma unroll
      for (int i8 = 0; i8 < 16; ++i8) {
        float2 dk2 = make_float2(dk[4 * i8 + 2 * hh], dk[4 * i8 + 2 * hh + 1]);
        if constexpr (SPARSE) {
          dk2.x *= p.scale;
          dk2.y *= p.scale;
        }
        *reinterpret_cast<float2*>(p.dk + at + 8 * i8 + cb) = dk2;
        *reinterpret_cast<float2*>(p.dv + at + 8 * i8 + cb) =
            make_float2(dv[4 * i8 + 2 * hh], dv[4 * i8 + 2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launch
// ---------------------------------------------------------------------------

// The fields every walk reads from dims: b, h, h_kv, s_q, s_kv, then
// (batch, seq, head) element strides of q, k, v, dout, dq (B9c: unused) and
// dk (dv shares dk's); the layout of every backward and sparse entry
// point.
Params base_params(const float* lse, const float* delta, float* dk, float* dv,
                   const long long* dims, float scale) {
  Params p = {};
  p.lse = lse;
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  p.b = (int)dims[0];
  p.h = (int)dims[1];
  p.h_kv = (int)dims[2];
  p.s_q = (int)dims[3];
  p.s_kv = (int)dims[4];
  p.dk_sb = dims[20];
  p.dk_ss = dims[21];
  p.dk_sh = dims[22];
  p.scale = scale;
  p.sl2 = scale * kLog2e;
  p.nq = (p.s_q + BQ - 1) / BQ;
  p.dsc.cq = p.s_q;  // B9c: no chunks (its walk reads no descriptor)
  p.dsc.ckv = p.s_kv > 0 ? p.s_kv : 1;
  return p;
}

// n_blocks: B9c's persistent blocks (its schedule's); dense kernels take
// one per SM, at most one per item.
template <bool FUSED, bool SPARSE, int MASK = kDense, bool MULTI = false>
int launch(const void* q, const void* k, const void* v, const void* dout,
           float* dq, const long long* dims, const Params& p, int n_blocks,
           cudaStream_t stream) {
  if (p.h_kv <= 0 || p.h % p.h_kv) return (int)cudaErrorInvalidValue;
  if (FUSED && p.s_q != p.s_kv) return (int)cudaErrorInvalidValue;
  if (p.n_items == 0) return (int)cudaSuccess;

  Maps maps = {};
  if (p.nq > 0) {  // no q row: every item writes zeros and loads nothing
    const cuuint32_t q_box[4] = {64, BQ, 1, 1};
    const cuuint32_t kv_box[4] = {64, BKV, 1, 1};
    const cuuint32_t dq_box[4] = {32, BQ, 1, 1};
    const long long q_dims[4] = {D, p.s_q, p.h, p.b};
    const long long kv_dims[4] = {D, p.s_kv, p.h_kv, p.b};
    const long long q_str[3] = {dims[6], dims[7], dims[5]};
    const long long k_str[3] = {dims[9], dims[10], dims[8]};
    const long long v_str[3] = {dims[12], dims[13], dims[11]};
    const long long o_str[3] = {dims[15], dims[16], dims[14]};
    const long long dq_str[3] = {dims[18], dims[19], dims[17]};
    const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
    bool ok = encode(&maps.q, q, bf16, 2, 4, q_dims, q_str, q_box, sw) &&
              encode(&maps.dout, dout, bf16, 2, 4, q_dims, o_str, q_box, sw) &&
              encode(&maps.k, k, bf16, 2, 4, kv_dims, k_str, kv_box, sw) &&
              encode(&maps.v, v, bf16, 2, 4, kv_dims, v_str, kv_box, sw);
    if (FUSED)
      ok = ok && encode(&maps.dq, dq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 4,
                        q_dims, dq_str, dq_box, sw);
    if (!ok) return (int)cudaErrorInvalidValue;
  }

  auto kern = flash_bwd_sm90_kernel<FUSED, SPARSE, MASK, MULTI>;
  const int smem = Smem<FUSED>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid =
      SPARSE ? n_blocks : (p.n_items < num_sms() ? p.n_items : num_sms());
  kern<<<grid, NT, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

// B2b and B5: dims as base_params's, then q_start, causal, left, right,
// sink (the forward's masks: right 0 when causal, sink 0 without a left
// window), then the descriptor (sm90.cuh Desc) from index 28, which holds
// the masks in local units. The instantiation follows the masks: kDense for
// causal or none, kBand for a window (or sinks), kCap with a softcap.
// `order`: a multi-chunk descriptor's kv tiles, longest walk first.
template <bool FUSED>
int launch_dense(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 float* dq, float* dk, float* dv, const long long* dims,
                 float scale, float cap, const int* order,
                 cudaStream_t stream) {
  Params p = base_params(lse, delta, dk, dv, dims, scale);
  p.causal = (int)dims[24];
  const int left = (int)dims[25];
  const int right = p.causal ? 0 : (int)dims[26];
  p.dsc = desc_from(dims, 28);
  p.order = order;
  p.cap = cap;
  p.sc = cap > 0.f ? scale / cap : 0.f;
  p.nk = (p.s_kv + BKV - 1) / BKV;
  p.n_items = p.nk * p.h_kv * p.b;
  if (cap < 0.f || !desc_ok(p.dsc, p.s_q, p.s_kv, BKV) ||
      (p.dsc.nqc * p.dsc.nkc > 1) != (order != nullptr) ||
      (FUSED && order != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool band = left >= 0 || (!p.causal && right >= 0);
  if constexpr (!FUSED) {
    if (order != nullptr) {  // the ring's multi-chunk steps
      if (cap > 0.f)
        return launch<false, false, kCap, true>(q, k, v, dout, dq, dims, p,
                                                0, stream);
      if (band)
        return launch<false, false, kBand, true>(q, k, v, dout, dq, dims,
                                                 p, 0, stream);
      return launch<false, false, kDense, true>(q, k, v, dout, dq, dims, p,
                                                0, stream);
    }
  }
  if (cap > 0.f)
    return launch<FUSED, false, kCap>(q, k, v, dout, dq, dims, p, 0, stream);
  if (band)
    return launch<FUSED, false, kBand>(q, k, v, dout, dq, dims, p, 0, stream);
  return launch<FUSED, false>(q, k, v, dout, dq, dims, p, 0, stream);
}

}  // namespace

// Kernel B2b: dk, dv; `order`: the kv tiles of a multi-chunk descriptor,
// longest walk first (null for one chunk a side).
extern "C" int lca_flash_bwd_dkv(LCA_BWD_ARGS, const int* order) {
  return launch_dense<false>(q, k, v, dout, lse, delta, dq, dk, dv, dims,
                             scale, softcap, order,
                             static_cast<cudaStream_t>(stream));
}

// Kernel B5: self-attention (s_q == s_kv) dq (added into a zeroed buffer),
// dk, dv.
extern "C" int lca_flash_bwd_fused(LCA_BWD_ARGS) {
  return launch_dense<true>(q, k, v, dout, lse, delta, dq, dk, dv, dims,
                            scale, softcap, nullptr,
                            static_cast<cudaStream_t>(stream));
}

// Kernel B9c: dk, dv (b, s_kv, h_kv, d) fp32 of a block-sparse mask, over
// the column tables' CSR form (ptr, ent), with the host's items ((column,
// first row in its kv tile, steps, 0), longest first) and each block's work
// items (sched_ptr, sched). lse is the -inf-safe lse. dims: as
// base_params's, then n_q, n_kv, block_q, block_kv, per_head (the layout of
// every sparse entry point), the number of items and of blocks.
extern "C" int lca_sparse_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, float* dk, float* dv,
                                  const int* ptr, const int* ent,
                                  const int* items, const int* sched_ptr,
                                  const int* sched, const long long* dims,
                                  float scale, void* stream) {
  Params p = base_params(lse, delta, dk, dv, dims, scale);
  p.ptr = ptr;
  p.ent = reinterpret_cast<const int4*>(ent);
  p.items = reinterpret_cast<const int4*>(items);
  p.sched_ptr = sched_ptr;
  p.sched = sched;
  const int n_q = (int)dims[23];
  p.n_kv = (int)dims[24];
  p.bq = (int)dims[25];
  p.bkv = (int)dims[26];
  p.per_head = (int)dims[27];
  if (p.bq <= 0 || p.bkv <= 0 || p.bq % BQ || p.bkv % 64 ||
      p.s_q != n_q * p.bq || p.s_kv != p.n_kv * p.bkv || p.h_kv <= 0)
    return (int)cudaErrorInvalidValue;
  p.n_items = (int)dims[28] * (p.per_head ? p.b : p.b * p.h_kv);
  const int n_blocks = (int)dims[29];
  if (p.n_items > 0 && (n_blocks <= 0 || n_blocks > p.n_items))
    return (int)cudaErrorInvalidValue;
  return launch<false, true>(q, k, v, dout, nullptr, dims, p, n_blocks,
                             static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory a block of B5 (fused != 0) or B2b and B9c takes.
extern "C" int lca_flash_bwd_smem(int fused) {
  return fused ? Smem<true>::BYTES : Smem<false>::BYTES;
}

extern "C" const char* lca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
