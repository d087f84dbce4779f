// Flash-attention dq for Hopper (sm_90a only): wgmma, TMA and a
// warp-specialised pipeline, over a walk of q-row items given as a template
// parameter.
//
// Replaces the TPU kernels of long_context_attention_tpu/ops/flash.py:
//   lca_flash_bwd_dq  <- _dq_kernel (B2a): dq of q rows at positions q_start
//                        + i against kv columns at j, with the forward's
//                        masks (causal, sliding window, StreamingLLM sinks),
//                        softcap and features (segment ids, ALiBi, the
//                        counter-hash dropout), each row written once (no
//                        atomics: deterministic, as JAX's);
// and of long_context_attention_tpu/ops/sparse.py:
//   lca_sparse_bwd_dq <- _sparse_dq_kernel (B9b): dq of a block-sparse
//                        mask's rows over their live kv tiles, each row
//                        written once.
// (B2b and B5 are in flash_bwd_sm90.cu.)
//
// What bounds it on an H100: tensor-core operations. Per visible (row,
// column) pair 6*d FLOPs (S = Q K^T, dP = dout V^T, dQ += dS K) against 989
// TFLOP/s bf16; the bytes (q, dout, k, v, lse and delta once, fp32 dq once)
// are a few percent of that time at s = 8192 and s = 32768. Only wgmma
// reaches that rate, so the kernel keeps the tensor cores fed from rings of
// K and V tiles that TMA fills while the products run.
//
// Design (FlashAttention-2/3's dq kernel on this card). One persistent block
// per SM takes a share of items: B2a the snake deal of the forward's items
// (flash_fwd_sm90.cu: the last q tile first, heads and batch rows inside,
// which under a causal mask, with or without a window, is the longest walk
// first); B9b a host-dealt share (ops/sparse.py SparsePlan.row_schedule,
// shared with B9a's forward). An item is BQ = 128 q rows of one head and
// batch row (sm90.cuh RowItem). A block has one producer warpgroup and two
// consumer warpgroups:
//   * the producer (setmaxnreg down to 24 registers; one thread issues every
//     TMA) loads Q and dout once per item, and each step's K and V tiles of
//     128 rows into rings of 3 K and 2 V stages, with the step's positions
//     beside K. V is freed once dP is done, K only once dQ is, hence the
//     deeper K ring;
//   * the consumers (setmaxnreg up to 240) own 64 q rows each, with their
//     lse (in exp2 units: +inf on a dead row or a row past s_q, so p =
//     exp2(-inf) = 0) and
//     delta in registers. S = Q K^T and dP = dout V^T are wgmma m64n128k16
//     with both operands in shared memory (128-byte swizzle, K-major); p and
//     ds = p (dp - delta) form in registers on the accumulator layout; dQ +=
//     bf16(ds) K is wgmma m64n128k16 with the register A operand and K
//     ([kv, d], d contiguous) as the MN-major B operand. Per step, dQ of the
//     step before and S of this one issue together, then dP once that dQ is
//     done (its registers and S's and dP's are never live at once: 192
//     accumulator registers at most), and p is computed while dP is on the
//     tensor cores. dQ stays in registers for the whole item and is written
//     once as fp32.
//
// B2a's walk (DenseRows): the forward's kv walk (sm90.cuh KvWalk, the TPU's
// _banded_gt) at BKV = 128: the sink tiles that lie before the band, then
// the band from the left window's first tile to the causal (or right
// window's) last; a tile outside the walk is never read. The consumers
// place each step from the walk itself (its first kv column; the item's
// first q position less it), and only tiles that some row of a consumer's
// 64 does not see whole run the masks. The last q tile may be ragged: TMA
// zero-fills its rows past s_q, whose lse is +inf and whose dq is not
// written. A q tile whose walk is empty (its rows see nothing) writes 0.
//
// B9b's walk (SparseRows): the row items and steps of B9a's forward
// (flash_fwd_sm90.cu; sm90.cuh row_item, RowWalk): a row's CSR entries (kv
// tile, flags, q_first, kv_first) in the JAX tables' order, each cut into
// block_kv / 128 steps of 128 columns (rounded up: the last step of an odd
// multiple of 64 has 64 columns of its tile, and the mask drops the next
// tile's 64 that its box also loads), less on a MASKED entry the steps wholly
// above the diagonal for the item's rows. The causal mask compares global
// positions (the layout's for ring shards), which the producer hands the
// consumers as the step's first q position less its first kv position. The
// last item of a q tile that is an odd multiple of 64 owns 64 rows: the
// consumer whose rows belong to the next tile releases Q and every stage
// unread and writes nothing. A row item with no step writes dq 0: the TPU's
// DEAD zero-emit entries.
//
// Shared memory (bytes; the 227 KB a block may use): Q 32768 + dout 32768 +
// 3 K stages x 32768 + 2 V stages x 32768 = 229376, + 64 of step meta, 256 of
// barriers and 1024 of alignment slack (230720); with the features each K
// stage's 128 kv segment ids (512) after the barriers, 128-byte aligned
// (232320). d = 64 halves every tile: 116032 (117632 with the features).
//
// Numerics follow the TPU kernels (_dq_kernel, _sparse_dq_kernel,
// _recompute_p, _ds_to_dqk):
//   s = (q . k) * scale in fp32 from the raw q; softcap (B2a): t = tanh(s /
//   cap), s = cap * t (the forward's natural-units form; tanh by the fast
//   exp, sm90.cuh tanh_fast); p = exp(s - lse)
//   (B9b: with the -inf-safe lse, +1e30 on dead rows), computed as exp2(s *
//   scale * log2e - lse * log2e), or exp2(s * log2e - lse * log2e) capped, 0
//   on masked entries; dp = dout . v;
//   B2a: ds = p * (dp - delta) * scale, softcap: p * (1 - t^2) * (dp - delta)
//   * scale (p * (1 - t^2) kept in place of p), dq = sum bf16(ds) . k;
//   B9b: ds = p * (dp - delta), dq = scale * sum bf16(ds) . k (the scale
//   after the cast, as JAX). The order is a property of the walk.
//   Features (B2a, the walk's kFeat; each a uniform run-time flag, sm90.cuh
//   Feat): ALiBi adds -slope[head] * |row - col| (global positions) to s
//   before exp(s - lse), as bias * log2e in this kernel's exp2 units;
//   segments drop a pair of unequal ids (every step masked); dropout
//   replaces dp by dp / (1 - p) where the forward kept the pair and by 0
//   where it dropped it, before ds = p (dp - delta) (JAX's _dq_kernel). The
//   keep bits of a step are hashed beside p (the row part once per item)
//   and held in two registers until ds. The kv ids of a step come by TMA
//   beside its K, on K's full barrier.
//
// Head dim 64 (-DLCA_HEAD_DIM=64, a library of its own with B2a; B9b
// returns cudaErrorNotSupported there): every Q, dout, K and V tile is one
// box (a bf16 row is one 128-byte swizzle atom), S and dP take 4 k16 steps,
// and dQ += dS K is wgmma m64n64k16 into a 32-register dq (64 x 64 a
// consumer).
//
// The tensor maps are encoded on the host per call (sm90.cuh) and passed as
// __grid_constant__ kernel parameters.

#include "sm90.cuh"

// The head dim: 128, or 64 for a second library built with
// -DLCA_HEAD_DIM=64 (ops/_build.py)
#ifndef LCA_HEAD_DIM
#define LCA_HEAD_DIM 128
#endif

namespace {

constexpr int D = LCA_HEAD_DIM;
static_assert(D == 64 || D == 128, "head dim 64 or 128");
constexpr int BQ = 128;        // q rows per item: 64 per consumer warpgroup
constexpr int BKV = kRowStep;  // kv columns per step
constexpr int NT = 384;        // a producer and two consumer warpgroups
// registers a thread holds at launch (168); the consumers take what the
// producer gives back (setmaxnreg.inc waits for it)
constexpr int PRODUCER_REGS = 24;
constexpr int REGS_AT_LAUNCH = 65536 / NT / 8 * 8;
constexpr int CONSUMER_REGS =
    (REGS_AT_LAUNCH * NT - 128 * PRODUCER_REGS) / 256 / 8 * 8;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory. A 64-column bf16 box of 128 rows is 128 rows of 128
// bytes, swizzled in 1024-byte atoms of 8 rows (CU_TENSOR_MAP_SWIZZLE_128B,
// read by wgmma with a 128-byte-swizzle descriptor); d = 128 is two boxes,
// d = 64 one.
constexpr int BOX = 128 * 128;   // one box: 16 KB
constexpr int NBOX = D / 64;     // boxes of a row
constexpr int TILE = NBOX * BOX;  // a 128 x D tile of Q, dout, K or V
constexpr int K_STAGES = 3, V_STAGES = 2;
constexpr int OFF_Q = 0;
constexpr int OFF_DO = TILE;
constexpr int OFF_K = 2 * TILE;
constexpr int OFF_V = OFF_K + K_STAGES * TILE;
constexpr int OFF_META = OFF_V + V_STAGES * TILE;  // an int2 per K stage
constexpr int OFF_BAR = OFF_META + 64;
constexpr int SMEM_BYTES = OFF_BAR + 256 + 1024;  // barriers, alignment
// the features: each K stage's kv segment ids after the barriers (a TMA
// destination: 128-byte aligned)
constexpr int SEG_BYTES = BKV * 4;
constexpr int OFF_SEG = (OFF_BAR + 256 + 127) / 128 * 128;
template <bool FEAT>
constexpr int smem_bytes() {
  return FEAT ? OFF_SEG + K_STAGES * SEG_BYTES + 1024 : SMEM_BYTES;
}
static_assert(smem_bytes<true>() <= 232448,
              "shared memory over the 227 KB a block may use");

// mbarrier slots: Q and dout full and empty; each K and V stage's full and
// empty
constexpr int B_QFULL = 0, B_QEMPTY = 1, B_KFULL = 2, B_KEMPTY = 5,
              B_VFULL = 8, B_VEMPTY = 10;

struct Maps {  // TMA descriptors, in the kernel's parameter space
  CUtensorMap q, dout, k, v;
  CUtensorMap kseg;  // the features' kv segment ids (b, kv_ld)
};

struct Params {
  const float* lse;    // (b, h, s_q); B9b: the -inf-safe lse
  const float* delta;  // rowsum(dout * out), (b, h, s_q)
  float* dq;
  int b, h, h_kv, s_q, s_kv;
  long long dq_sb, dq_ss, dq_sh;  // dq element strides (batch, seq, head)
  float scale;
  float sl2;  // scale * log2e
  int n_items;
  // B2a: the positions and masks in chunk-local units (sm90.cuh Desc), the
  // softcap and the number of q tiles
  Desc dsc;
  float cap, sc;  // sc: scale / cap
  int nq;
  // the row tables' CSR form, the host's items (row, first q row in its q
  // tile, steps, 0) and each block's work items, block i's at
  // sched[sched_ptr[i] .. sched_ptr[i + 1])
  const int* ptr;
  const int4* ent;
  const int4* items;
  const int* sched_ptr;
  const int* sched;
  int n_q, bq, bkv, per_head;
  Feat ft;  // B2a: segments, ALiBi, dropout (sm90.cuh)
};

// K-major operand (Q, dout; K, V as the B of S and dP): 8-row groups 1024
// bytes apart; a k16 step moves 32 bytes inside the 128-byte swizzle row
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// MN-major B operand (K as the B of dQ, [kv, d] with d contiguous): 8 kv
// rows 1024 bytes apart, the second 64-column d box BOX bytes after the first
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

// d = A * B, as wgmma_ss with d written, not read
__device__ __forceinline__ void wgmma_ss_first(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " LCA_D64
      ", %64, %65, 0, 1, 1, 0, 0;\n"
      : LCA_OUT64(d)
      : "l"(da), "l"(db));
}

// ---------------------------------------------------------------------------
// The walks
// ---------------------------------------------------------------------------

// A walk gives the kernel: kListed (the host's list of items per block, or
// the snake over n_items), kBand (B2a's masks and the scale before the
// cast), kCap (the softcap), kFeat (B2a's features), an item, and the
// producer's steps: each step's
// first kv row, and the meta it hands the consumers beside K (B9b's
// RowWalk::meta; B2a's the item's first q row less the step's first kv
// column, both chunk-local, and that column times 4 plus the chunk pair),
// so the consumers keep no walk.

// B9b: the host's row items, listed per block, and each row's CSR steps
struct SparseRows {
  static constexpr bool kListed = true, kBand = false, kCap = false;
  static constexpr bool kMulti = false, kFeat = false;
  struct NoWalk {};
  __device__ static NoWalk consumer_walk(const Params&, const RowItem&) {
    return {};
  }
  __device__ static RowItem item(const Params& p, int t) {
    return row_item(p.items, p.ptr, t, p.b, p.h, p.n_q, p.bq, p.per_head);
  }
  struct Steps {
    RowWalk w;
    RowStep c;
    __device__ Steps(const Params& p, const RowItem& x)
        : w(p.ent, x, p.bkv), c(w.from(x.e0)) {}
    __device__ int kv0() const { return w.kv0(c); }
    __device__ int2 meta(const Params&, const RowItem&) const {
      return w.meta(c);
    }
    __device__ void next() { c = w.next(c); }
  };
};

// B2a: the forward's items (q tiles from the last to the first, heads and
// batch rows inside) and each q tile's kv walk; MULTI: a descriptor of two
// chunks on a side (the ring's steps); FEAT: the features of Params
template <bool CAP, bool MULTI, bool FEAT = false>
struct DenseRows {
  static constexpr bool kListed = false, kBand = true, kCap = CAP;
  static constexpr bool kMulti = MULTI, kFeat = FEAT;
  // the walk the consumers keep: one chunk a side (else the steps' meta)
  __device__ static KvWalk<BKV, MULTI> consumer_walk(const Params& p,
                                                     const RowItem& x) {
    return walk(p, x.q0);
  }
  __device__ static KvWalk<BKV, MULTI> walk(const Params& p, int q0) {
    const int qc = MULTI ? q0 / p.dsc.cq : 0;  // a tile never crosses one
    const int c0 = qc * p.dsc.cq;
    return KvWalk<BKV, MULTI>(p.dsc, qc, q0 - c0,
                              min(q0 + BQ, p.s_q) - 1 - c0);
  }
  __device__ static RowItem item(const Params& p, int t) {
    const int bh = p.b * p.h;
    const int r = t % bh;
    RowItem x;
    x.q0 = (p.nq - 1 - t / bh) * BQ;
    x.ih = r % p.h;
    x.ib = r / p.h;
    x.sub = x.e0 = x.e_end = 0;
    x.rows = min(BQ, p.s_q - x.q0);
    x.n = walk(p, x.q0).n;
    return x;
  }
  struct Steps {
    KvWalk<BKV, MULTI> w;
    int js;
    __device__ Steps(const Params& p, const RowItem& x)
        : w(walk(p, x.q0)), js(0) {}
    __device__ int kv0() const { return w.tile(js) * BKV; }
    __device__ int2 meta(const Params& p, const RowItem& x) const {
      const int qc = x.q0 / p.dsc.cq, kc = w.chunk(js);
      const int kv0l = kv0() - kc * p.dsc.ckv;
      return make_int2(x.q0 - qc * p.dsc.cq - kv0l, kv0l * 4 + qc * 2 + kc);
    }
    __device__ void next() { ++js; }
  };
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <class Walk>
__global__ void __launch_bounds__(NT, 1)
    flash_dq_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  static_assert(CONSUMER_REGS == 240, "the consumers' register budget");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 1024-byte aligned base as an offset into the shared array (an
  // integer round trip of the address makes the shared loads generic)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  auto bar = [&](int i) -> uint32_t { return sbase + OFF_BAR + 8 * i; };
  // the stages of the i-th step of the block's stream, and the parity of
  // its use of each
  auto k_stage = [&](int i) -> uint32_t {
    return sbase + OFF_K + (i % K_STAGES) * TILE;
  };
  auto v_stage = [&](int i) -> uint32_t {
    return sbase + OFF_V + (i % V_STAGES) * TILE;
  };
  auto k_use = [&](int i) -> int { return (i / K_STAGES) & 1; };
  auto v_use = [&](int i) -> int { return (i / V_STAGES) & 1; };
  // the i-th step's meta (RowWalk::meta), beside its K stage
  auto meta = [&](int i) -> int2* {
    return reinterpret_cast<int2*>(smem + OFF_META + (i % K_STAGES) * 8);
  };
  // the features: the kv segment ids of the i-th step, beside its K
  auto seg_slot = [&](int i) -> int* {
    return reinterpret_cast<int*>(smem + OFF_SEG + (i % K_STAGES) * SEG_BYTES);
  };
  const bool segs = Walk::kFeat && p.ft.seg;

  if (threadIdx.x == 0) {
    mbar_init(bar(B_QFULL), 1);
    mbar_init(bar(B_QEMPTY), 8);  // one arrival per consumer warp
    for (int s = 0; s < K_STAGES; ++s) {
      mbar_init(bar(B_KFULL + s), 1);
      mbar_init(bar(B_KEMPTY + s), 8);
    }
    for (int s = 0; s < V_STAGES; ++s) {
      mbar_init(bar(B_VFULL + s), 1);
      mbar_init(bar(B_VEMPTY + s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int wtid = threadIdx.x & 127;
  const BlockItems<Walk::kListed> items(p);

  if (wg == 0) {
    // ======================= producer warpgroup =======================
    setmaxnreg_dec<PRODUCER_REGS>();
    if (wtid != 0) return;  // one thread issues every TMA
    int it = 0, qn = 0;
    for (int j = items.j0; j < items.end; ++j) {
      const int t = items.at(p, j);
      if (t < 0) continue;
      const RowItem x = Walk::item(p, t);
      const int ihk = x.ih / (p.h / p.h_kv);
      typename Walk::Steps c(p, x);
      for (int js = 0; js < x.n; ++js, ++it) {
        const int ks = it % K_STAGES, vs = it % V_STAGES;
        const int kv0 = c.kv0();
        mbar_wait(bar(B_KEMPTY + ks), k_use(it) ^ 1);
        if constexpr (!Walk::kBand || Walk::kMulti)
          *meta(it) = c.meta(p, x);  // released by K's full barrier
        mbar_expect_tx(bar(B_KFULL + ks), TILE + (segs ? SEG_BYTES : 0));
        for (int hb = 0; hb < NBOX; ++hb)
          tma_load_4d(k_stage(it) + hb * BOX, &maps.k, bar(B_KFULL + ks),
                      64 * hb, kv0, ihk, x.ib);
        if (segs)  // the step's kv ids, on K's barrier
          tma_load_2d(smem_u32(seg_slot(it)), &maps.kseg, bar(B_KFULL + ks),
                      kv0, x.ib);
        if (js == 0) {  // the item's Q and dout, once its first K is in flight
          mbar_wait(bar(B_QEMPTY), (qn & 1) ^ 1);
          mbar_expect_tx(bar(B_QFULL), 2 * TILE);
          for (int hb = 0; hb < NBOX; ++hb) {
            tma_load_4d(sbase + OFF_Q + hb * BOX, &maps.q, bar(B_QFULL),
                        64 * hb, x.q0, x.ih, x.ib);
            tma_load_4d(sbase + OFF_DO + hb * BOX, &maps.dout, bar(B_QFULL),
                        64 * hb, x.q0, x.ih, x.ib);
          }
          ++qn;
        }
        mbar_wait(bar(B_VEMPTY + vs), v_use(it) ^ 1);
        mbar_expect_tx(bar(B_VFULL + vs), TILE);
        for (int hb = 0; hb < NBOX; ++hb)
          tma_load_4d(v_stage(it) + hb * BOX, &maps.v, bar(B_VFULL + vs),
                      64 * hb, kv0, ihk, x.ib);
        c.next();
      }
    }
    return;
  }

  // ======================= consumer warpgroups =======================
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;          // which 64 q rows of the item
  const int warp = wtid >> 5;     // 16 rows each
  const int lane = wtid & 31;
  const int g = lane >> 2;        // accumulator row (and row + 8)
  const int cb = 2 * (lane & 3);  // accumulator column pair in each 8
  const uint32_t q_rows = sbase + OFF_Q + cw * 64 * 128;
  const uint32_t do_rows = sbase + OFF_DO + cw * 64 * 128;

  // acc = A B^T over d: A this warpgroup's 64 rows of Q or dout, B a K or V
  // stage; D / 16 k16 steps, 4 in each d box
  auto issue_ss = [&](float (&acc)[64], uint32_t a, uint32_t b) {
    wgmma_ss_first(acc, desc_kmajor(a), desc_kmajor(b));
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      wgmma_ss(acc, desc_kmajor(a + (kk >> 2) * BOX + (kk & 3) * 32),
               desc_kmajor(b + (kk >> 2) * BOX + (kk & 3) * 32));
    wgmma_commit();
  };
  // dQ += dS K of the i-th step: 8 k16 steps of 16 kv rows (2048 bytes of
  // K each)
  auto issue_dq = [&](float (&dq)[D / 2], const uint32_t (&da)[32], int i) {
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_rs_d(dq, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                 da[4 * kk + 3], desc_mnmajor(k_stage(i) + kk * 2048));
    wgmma_commit();
  };
  auto release = [&](int b) {
    if (lane == 0) mbar_arrive(bar(b));
  };

  int it = 0, qn = 0;
  for (int j = items.j0; j < items.end; ++j) {
    const int t = items.at(p, j);
    if (t < 0) continue;
    const RowItem x = Walk::item(p, t);
    // B2a with one chunk a side places each step from the walk
    const auto kw = Walk::consumer_walk(p, x);
    const int r0 = x.q0 + cw * 64;  // first q row of this warpgroup
    // rows of the next q tile (the second half of a 64-row item)
    const bool idle = cw * 64 >= x.rows;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    if (x.n > 0 && idle) {  // release Q and every stage unread
      mbar_wait(bar(B_QFULL), qn & 1);
      release(B_QEMPTY);
      for (int js = 0; js < x.n; ++js, ++it) {
        mbar_wait(bar(B_KFULL + it % K_STAGES), k_use(it));
        release(B_KEMPTY + it % K_STAGES);
        mbar_wait(bar(B_VFULL + it % V_STAGES), v_use(it));
        release(B_VEMPTY + it % V_STAGES);
      }
      ++qn;
    } else if (x.n > 0) {
      // this lane's rows g and g + 8: lse in exp2 units (+inf on a dead
      // row or a row past s_q, so p = 0) and delta
      float lse2[2], dl[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qi = r0 + warp * 16 + g + hh * 8;
        const long long at = ((long long)x.ib * p.h + x.ih) * p.s_q + qi;
        const float raw =
            qi < p.s_q ? p.lse[at] : __int_as_float(0xff800000);
        lse2[hh] = raw == __int_as_float(0xff800000)
                       ? __int_as_float(0x7f800000)
                       : raw * kLog2e;
        dl[hh] = qi < p.s_q ? p.delta[at] : 0.f;
      }
      // the features: the rows' global positions, q segment ids and the
      // dropout hash's row part; the head's -slope; a step's keep bits
      int rpos[2] = {0, 0}, qsg[2] = {0, 0};
      uint32_t rh[2] = {0u, 0u}, kb[2] = {0u, 0u};
      float nslope = 0.f;
      if constexpr (Walk::kFeat) {
        const int qc = Walk::kMulti ? x.q0 / p.dsc.cq : 0;
        const uint32_t salt = p.ft.drop ? drop_salt(p.ft, x.ib, x.ih) : 0u;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int qi = r0 + warp * 16 + g + hh * 8;
          rpos[hh] = p.dsc.qo[qc] + (qi - qc * p.dsc.cq) * p.dsc.st;
          if (p.ft.seg && qi < p.s_q)
            qsg[hh] = p.ft.qseg[(long long)x.ib * p.s_q + qi];
          if (p.ft.drop) rh[hh] = drop_row(salt, rpos[hh]);
        }
        if (p.ft.alibi) nslope = -p.ft.slopes[x.ih];
      }

      // the i-th step's descriptor from its meta, read
      // once its K is full: B9b's; B2a's (item's first q row less the
      // step's first kv column, that kv column, both chunk-local, and the
      // chunk pair)
      auto step = [&](int i, int js) -> int4 {
        if constexpr (Walk::kBand && !Walk::kMulti) {
          const int kv0 = kw.tile(js) * BKV;
          return make_int4(x.q0 - kv0, kv0, 0, 0);
        }
        const int2 m = *meta(i);
        if constexpr (Walk::kBand)
          return make_int4(m.x, m.y >> 2, m.y & 3, 0);
        else
          return make_int4(m.x, m.y, 0, 0);
      };
      // P in place of S: p = exp2(s * scale * log2e - lse * log2e), 0
      // where `masked` drops a pair. B9b: a column past the step's (m.y &
      // 0xffff), or under the causal mask (m.y >> 16) a column after the
      // row (the step's q position less its kv position is m.x). B2a: a
      // column past its chunk, or, with the row's place less the step's
      // first column `row`, a column c with c - row > hi (the causal or
      // right window), or c - row < lo (the left window) unless a sink
      // (Desc); kCap: s = cap * tanh(s * scale / cap), and p * (1 - t^2)
      // in place. The features (kFeat): ALiBi joins s, segments the masks,
      // and the dropout's keep bits of the step go to kb
      auto probs = [&](float (&sacc)[64], int4 m, const int* sseg,
                       auto masked) {
        const int rel = m.x + cw * 64 + warp * 16 + g;
        const int cols = Walk::kBand ? min(BKV, p.dsc.ckv - m.y) : m.y & 0xffff;
        const bool causal = (m.y >> 16) != 0;
        const int hi = p.dsc.hi[m.z], lo = p.dsc.lo[m.z], sk = p.dsc.sk[m.z];
        // the global position of the step's first column (features)
        const int kpos = Walk::kFeat ? p.dsc.ko[m.z & 1] + m.y * p.dsc.st : 0;
        kb[0] = kb[1] = 0u;
#pragma unroll
        for (int i8 = 0; i8 < 16; ++i8) {
          int2 ksg = make_int2(0, 0);
          if (decltype(masked)::value && segs)
            ksg = *reinterpret_cast<const int2*>(sseg + 8 * i8 + cb);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kpos + (8 * i8 + cb + (e & 1)) * p.dsc.st;
            // ALiBi in exp2 units (features)
            const float ab =
                Walk::kFeat && p.ft.alibi
                    ? alibi_bias(nslope, rpos[e >> 1], col) * kLog2e
                    : 0.f;
            float pe, dt = 1.f;
            if constexpr (Walk::kCap) {
              const float tc = tanh_fast(sacc[4 * i8 + e] * p.sc);
              if constexpr (Walk::kFeat)
                pe = exp2f(tc * p.cap * kLog2e + ab - lse2[e >> 1]);
              else
                pe = exp2f(tc * p.cap * kLog2e - lse2[e >> 1]);
              dt = 1.f - tc * tc;
            } else {
              if constexpr (Walk::kFeat)
                pe = exp2f(sacc[4 * i8 + e] * p.sl2 + ab - lse2[e >> 1]);
              else
                pe = exp2f(sacc[4 * i8 + e] * p.sl2 - lse2[e >> 1]);
            }
            if (decltype(masked)::value) {
              const int c = 8 * i8 + cb + (e & 1);
              const int row = rel + (e >> 1) * 8;
              if constexpr (Walk::kBand) {
                if (c >= cols || c - row > hi ||
                    (c - row < lo && m.y + c >= sk) ||
                    (segs && ((e & 1) ? ksg.y : ksg.x) != qsg[e >> 1]))
                  pe = 0.f;
              } else {
                if (c >= cols || (causal && c > row)) pe = 0.f;
              }
            }
            if (Walk::kFeat && p.ft.drop && drop_keep(p.ft, rh[e >> 1], col))
              kb[i8 >> 3] |= 1u << ((4 * i8 + e) & 31);
            sacc[4 * i8 + e] = Walk::kCap ? pe * dt : pe;
          }
        }
      };
      // only a step that some pair of this warpgroup's drops is masked (a
      // wholly-sink step is interior on the left; with segments, all are)
      auto probs_of = [&](float (&sacc)[64], int4 m, int i) {
        bool masked;
        if constexpr (Walk::kBand) {
          const int rel = m.x + cw * 64;
          masked = m.y + BKV > p.dsc.ckv || BKV - 1 - rel > p.dsc.hi[m.z] ||
                   (-(rel + 63) < p.dsc.lo[m.z] &&
                    m.y + BKV - 1 >= p.dsc.sk[m.z]) ||
                   segs;
        } else {
          masked = (m.y & 0xffff) < BKV ||
                   ((m.y >> 16) && m.x + cw * 64 < BKV - 1);
        }
        const int* sseg = Walk::kFeat ? seg_slot(i) : nullptr;
        if (masked)
          probs(sacc, m, sseg, Flag<true>());
        else
          probs(sacc, m, sseg, Flag<false>());
      };
      // dS = P (dP - delta) to bf16 as the A operand (B2a: times the scale
      // before the cast): accumulator (row, col pair) of 8-column group i8
      // -> the A fragment of k16 step i8 / 2
      uint32_t da[32];
      auto to_ds = [&](const float (&sacc)[64], const float (&dpacc)[64]) {
#pragma unroll
        for (int i8 = 0; i8 < 16; ++i8) {
          float d4[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float dp = dpacc[4 * i8 + e];
            if (Walk::kFeat && p.ft.drop)  // the forward's dropout of p
              dp = (kb[i8 >> 3] >> ((4 * i8 + e) & 31)) & 1u ? dp * p.ft.inv
                                                            : 0.f;
            d4[e] = sacc[4 * i8 + e] * (dp - dl[e >> 1]);
            if constexpr (Walk::kBand) d4[e] *= p.scale;
          }
          da[2 * i8] = pack_bf16(d4[0], d4[1]);
          da[2 * i8 + 1] = pack_bf16(d4[2], d4[3]);
        }
      };

      mbar_wait(bar(B_QFULL), qn & 1);
      // the first step: S and dP, no dQ in flight yet
      {
        float sacc[64], dpacc[64];
        mbar_wait(bar(B_KFULL + it % K_STAGES), k_use(it));
        const int4 m = step(it, 0);
        wgmma_fence();
        issue_ss(sacc, q_rows, k_stage(it));
        mbar_wait(bar(B_VFULL + it % V_STAGES), v_use(it));
        wgmma_fence();
        issue_ss(dpacc, do_rows, v_stage(it));
        wgmma_wait<1>();
        reg_fence(sacc);
        probs_of(sacc, m, it);
        wgmma_wait<0>();
        reg_fence(dpacc);
        release(B_VEMPTY + it % V_STAGES);
        if (x.n == 1) release(B_QEMPTY);
        to_ds(sacc, dpacc);
      }
      // then per step: dQ of the step before and S of this one issue
      // together, dP once that dQ is done; p runs while dP is on the
      // tensor cores
      for (int js = 1; js < x.n; ++js) {
        ++it;
        float sacc[64];
        mbar_wait(bar(B_KFULL + it % K_STAGES), k_use(it));
        const int4 m = step(it, js);
        wgmma_fence();
        issue_dq(dq, da, it - 1);
        issue_ss(sacc, q_rows, k_stage(it));
        wgmma_wait<1>();
        reg_fence(dq);
        reg_fence(da);
        release(B_KEMPTY + (it - 1) % K_STAGES);
        float dpacc[64];
        mbar_wait(bar(B_VFULL + it % V_STAGES), v_use(it));
        wgmma_fence();
        issue_ss(dpacc, do_rows, v_stage(it));
        wgmma_wait<1>();
        reg_fence(sacc);
        probs_of(sacc, m, it);
        wgmma_wait<0>();
        reg_fence(dpacc);
        release(B_VEMPTY + it % V_STAGES);
        if (js == x.n - 1) release(B_QEMPTY);
        to_ds(sacc, dpacc);
      }
      // dQ of the last step
      wgmma_fence();
      issue_dq(dq, da, it);
      wgmma_wait<0>();
      reg_fence(dq);
      reg_fence(da);
      release(B_KEMPTY + it % K_STAGES);
      ++it;
      ++qn;
    }
    if (idle) continue;

    // write dq once (B9b: scale * the sum; 0 for rows that saw no tile)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = r0 + warp * 16 + g + hh * 8;
      if (qi >= p.s_q) continue;
      float* row = p.dq + x.ib * p.dq_sb + (long long)qi * p.dq_ss +
                   x.ih * p.dq_sh;
#pragma unroll
      for (int i8 = 0; i8 < D / 8; ++i8) {
        float2 v = make_float2(dq[4 * i8 + 2 * hh], dq[4 * i8 + 2 * hh + 1]);
        if constexpr (!Walk::kBand) {
          v.x *= p.scale;
          v.y *= p.scale;
        }
        *reinterpret_cast<float2*>(row + 8 * i8 + cb) = v;
      }
    }
  }
}

// The fields both entry points read from dims: b, h, h_kv, s_q, s_kv, then
// (batch, seq, head) element strides of q, k, v, dout, dq (B9b: out) and dk
// (unused).
Params base_params(const float* lse, const float* delta, void* dq,
                   const long long* dims, float scale) {
  Params p = {};
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<float*>(dq);
  p.b = (int)dims[0];
  p.h = (int)dims[1];
  p.h_kv = (int)dims[2];
  p.s_q = (int)dims[3];
  p.s_kv = (int)dims[4];
  p.dq_sb = dims[17];
  p.dq_ss = dims[18];
  p.dq_sh = dims[19];
  p.scale = scale;
  p.sl2 = scale * kLog2e;
  return p;
}

// Encode the tensor maps and launch Walk's kernel on n_blocks blocks.
template <class Walk>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const long long* dims, const Params& p, int n_blocks,
           cudaStream_t stream) {
  Maps maps;
  const cuuint32_t box[4] = {64, 128, 1, 1};
  const long long q_dims[4] = {D, p.s_q, p.h, p.b};
  const long long kv_dims[4] = {D, p.s_kv, p.h_kv, p.b};
  const long long q_str[3] = {dims[6], dims[7], dims[5]};
  const long long k_str[3] = {dims[9], dims[10], dims[8]};
  const long long v_str[3] = {dims[12], dims[13], dims[11]};
  const long long o_str[3] = {dims[15], dims[16], dims[14]};
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!(encode(&maps.q, q, bf16, 2, 4, q_dims, q_str, box, sw) &&
        encode(&maps.dout, dout, bf16, 2, 4, q_dims, o_str, box, sw) &&
        encode(&maps.k, k, bf16, 2, 4, kv_dims, k_str, box, sw) &&
        encode(&maps.v, v, bf16, 2, 4, kv_dims, v_str, box, sw)))
    return (int)cudaErrorInvalidValue;
  maps.kseg = maps.q;  // unused without segments
  if (Walk::kFeat && p.ft.seg) {
    const long long sg_dims[2] = {p.s_kv, p.b};
    const long long sg_str[1] = {p.ft.kv_ld};
    const cuuint32_t sg_box[2] = {BKV, 1};
    if (!encode(&maps.kseg, p.ft.kvseg, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, 2,
                sg_dims, sg_str, sg_box, CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
  }

  auto kern = flash_dq_sm90_kernel<Walk>;
  const int smem = smem_bytes<Walk::kFeat>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<n_blocks, NT, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

// B2a's walk for the descriptor (MULTI: two chunks on a side), the softcap
// and the features
template <bool MULTI, bool FEAT>
int launch_dense(const void* q, const void* k, const void* v,
                 const void* dout, const long long* dims, const Params& p,
                 int n_blocks, cudaStream_t st) {
  if (p.cap > 0.f)
    return launch<DenseRows<true, MULTI, FEAT>>(q, k, v, dout, dims, p,
                                                n_blocks, st);
  return launch<DenseRows<false, MULTI, FEAT>>(q, k, v, dout, dims, p,
                                               n_blocks, st);
}

}  // namespace

// Kernel B2a: dq (b, s_q, h, d) fp32 of q rows against kv columns at the
// positions of a descriptor, written once; dk and dv unused. dims: as
// base_params's, then q_start, causal, left, right, sink (the forward's
// masks, which the descriptor holds in local units), then the descriptor
// (sm90.cuh Desc) from index 28 and the features (sm90.cuh Feat) after it,
// whose operands follow the stream.
extern "C" int lca_flash_bwd_dq(LCA_BWD_ARGS, LCA_FEAT_ARGS) {
  (void)dk;
  (void)dv;
  Params p = base_params(lse, delta, dq, dims, scale);
  p.dsc = desc_from(dims, 28);
  p.ft = feat_from(dims, 28 + kDescLen, qseg, kvseg, slopes, drop_inv);
  p.cap = softcap;
  p.sc = softcap > 0.f ? scale / softcap : 0.f;
  p.nq = (p.s_q + BQ - 1) / BQ;
  if (p.h_kv <= 0 || p.h % p.h_kv || softcap < 0.f ||
      !desc_ok(p.dsc, p.s_q, p.s_kv, BKV) || !feat_ok(p.ft))
    return (int)cudaErrorInvalidValue;
  p.n_items = p.nq * p.h * p.b;
  if (p.n_items == 0) return (int)cudaSuccess;
  const int n_blocks = p.n_items < num_sms() ? p.n_items : num_sms();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool multi = p.dsc.nqc * p.dsc.nkc > 1;  // the ring's steps
  if (p.ft.seg || p.ft.alibi || p.ft.drop)
    return multi ? launch_dense<true, true>(q, k, v, dout, dims, p, n_blocks,
                                            st)
                 : launch_dense<false, true>(q, k, v, dout, dims, p,
                                             n_blocks, st);
  return multi ? launch_dense<true, false>(q, k, v, dout, dims, p, n_blocks,
                                           st)
               : launch_dense<false, false>(q, k, v, dout, dims, p, n_blocks,
                                            st);
}

// Kernel B9b: dq (b, s_q, h, d) fp32 of a block-sparse mask into `out`, over
// the row tables' CSR form (ptr, ent), with the host's items ((row, first q
// row in its q tile, steps, 0), longest first) and each block's work items
// (sched_ptr, sched), B9a's. lse is the -inf-safe lse. The arguments are
// those of every sparse entry point (out_lse and qfold unused); dims: as
// base_params's (out's strides in dq's place), then n_q, n_kv, block_q,
// block_kv, per_head, the number of items and of blocks.
extern "C" int lca_sparse_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* out,
                                 float* out_lse, const int* ptr,
                                 const int* ent, const int* items,
                                 const int* sched_ptr, const int* sched,
                                 const long long* dims, float qfold,
                                 float scale, void* stream) {
#if LCA_HEAD_DIM != 128
  return (int)cudaErrorNotSupported;  // B9b at head dim 128 only
#else
  Params p = base_params(lse, delta, out, dims, scale);
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
  return launch<SparseRows>(q, k, v, dout, dims, p, n_blocks,
                            static_cast<cudaStream_t>(stream));
#endif
}

// The dynamic shared memory a block takes (feat != 0: B2a's features).
extern "C" int lca_flash_dq_smem(int feat) {
  return feat ? smem_bytes<true>() : smem_bytes<false>();
}

extern "C" const char* lca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
