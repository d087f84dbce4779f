// Flash-attention prefill forward for Hopper (sm_90a only): wgmma, TMA and
// a warp-specialised pipeline.
//
// Replaces the TPU kernels of long_context_attention_tpu/ops/flash.py:
//   lca_flash_fwd_causal_self <- _fwd_kernel_tri / _fwd_kernel_tri_sqrt
//                                (shared body _tri_body): causal
//                                self-attention, s_q == s_kv, GQA;
//   lca_flash_fwd_pos         <- _fwd_kernel: q rows at global positions
//                                q_off + i against kv columns at j, sliding
//                                window (left, right), StreamingLLM sinks
//                                and logit softcap, bf16 or int8 K/V with
//                                fp32 per-token scales (chunked prefill
//                                against the quantized cache, read in place
//                                as a strided view).
//
// What bounds it on an H100: tensor-core operations. Each visible (row,
// column) pair costs 4*d FLOPs (QK and PV) against 989 TFLOP/s bf16; the
// bytes (q, k, v once) are a few percent of that time at the prefill
// shapes. Only wgmma reaches that rate, and a 128-row q tile re-reads each
// K/V tile from L2, so the kernel keeps the tensor cores fed from a ring of
// tiles that TMA fills while the products run.
//
// Design. One persistent block per SM walks (q tile, head, batch) items in
// the order of the TPU grid's longest rows first, dealt to the blocks in a
// snake order. A block has two consumer
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
//   * int8 K/V (B3 over the quantized cache): one producer warpgroup widens
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
//             barriers and 1024 of alignment slack;
//   int8 K/V: Q 32768 + 2 stages x (K 32768 + V 32768 + scales 1024)
//             = 133120 + 3 raw slots x (an int8 K or V tile 16384 + a K
//             tile's scales 1024) = 218112, + barriers and slack.
//
// The kv walk is the TPU kernels' (_banded_gt) at BKV = 128: the sink tiles
// that lie before the band, then the band; a tile outside the walk is never
// read (TMA zero-fills rows past s_kv, which the mask also drops). Only
// tiles that some row of a consumer's 64 does not see whole are masked.
//
// Numerics are those of the TPU kernels and of the mma.sync kernels before
// this one; only the order of the sums differs:
//   fast form: scale*log2e is folded into q in bf16 (one rounding, done in
//     shared memory once per item), p = exp2(min(s, 90)), l += rowsum(p),
//     acc += bf16(p * v_scale) @ v; out = acc / l, lse = log(l); a row with
//     l == 0 gives out 0, lse -inf.
//   online forms (safe softmax): B1 in exp2 units (s *= scale*log2e, lse =
//     m*ln2 + log l), B3 in natural units (s = dot * k_scale * scale, lse =
//     m + log l).
//   softcap (B3): natural units, s = cap * tanh(dot * k_scale * scale /
//     cap), then the online form.
//   int8 K/V: s = dot(q, k_int8 as bf16) * k_scale[col]; l sums p before
//     V's scale; p *= v_scale[col] before the bf16 PV product.
//   masks (flash-attn semantics, global positions): drop col > row + right
//     (right = 0 when causal) and col < row - left unless col < sink.
//
// The tensor maps are encoded on the host per call (sm90.cuh) and passed
// as __grid_constant__ kernel parameters.

#include "sm90.cuh"

namespace {

constexpr int D = 128;
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

// softmax forms (template parameter FORM)
constexpr int kFast = 0;        // max-free clamped exp2, scale folded into q
constexpr int kOnlineExp2 = 1;  // online softmax in exp2 units
constexpr int kOnlineNat = 2;   // online softmax in natural units
constexpr int kSoftcap = 3;     // capped scores, online, natural units

// Shared memory. A 64-column bf16 box of 128 rows is 128 rows of 128
// bytes, swizzled in 1024-byte atoms of 8 rows: the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B and wgmma reads with a 128-byte-swizzle
// descriptor. d = 128 is two boxes.
constexpr int BOX = 128 * 128;             // one box: 16 KB
constexpr int Q_BYTES = 2 * BOX;           // Q: d boxes 0 and 1, 128 rows
constexpr int KV_BYTES = 2 * BOX;          // one bf16 K or V tile
constexpr int SC_BYTES = 2 * BKV * 4;      // a tile's k and v scales
constexpr int RAW_BYTES = BKV * D;         // one int8 K or V tile
constexpr int RAW_SLOT = RAW_BYTES + SC_BYTES;  // ... and a K tile's scales
constexpr int RAW_K_SLOTS = 2;             // rings of raw int8 K and V
constexpr int RAW_V_SLOTS = 1;
constexpr int RAW_SLOTS = RAW_K_SLOTS + RAW_V_SLOTS;
// bf16 K/V: 3 operand stages that TMA fills; int8: 2 operand stages (with
// the tile's scales) that the producers widen into, fed by the raw rings
template <bool QUANT>
struct Smem {
  static constexpr int STAGES = QUANT ? 2 : 3;
  static constexpr int STAGE = 2 * KV_BYTES + (QUANT ? 1024 : 0);
  static constexpr int OFF_W = Q_BYTES;
  static constexpr int OFF_RAW = OFF_W + STAGES * STAGE;
  static constexpr int OFF_BAR =
      OFF_RAW + (QUANT ? RAW_SLOTS * RAW_SLOT : 0);
  static constexpr int BYTES = OFF_BAR + 256 + 1024;  // barriers, alignment
};
static_assert(Smem<true>::BYTES <= 232448 && Smem<false>::BYTES <= 232448,
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
};

struct Params {
  void* out;
  float* lse;
  int b, h, h_kv, s_q, s_kv;
  long long o_sb, o_ss, o_sh;  // out element strides (batch, seq, head)
  int q_off;                   // global position of q row 0
  int left, right;             // window; -1 = unbounded (right 0: causal)
  int sink;                    // columns < sink stay visible (left >= 0)
  float qfold;   // fast form: scale*log2e folded into q
  float sscale;  // online forms: multiplier of the raw score
  float cap;     // softcap form: the cap
  int nq, n_items;
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

// Widen one int8 tile [128 rows][128 bytes] into the two swizzled bf16
// boxes at dst, by the 128 threads of a producer warpgroup, two 16-byte
// chunks at a time (their loads first, for the producer warp of each SM
// sub-partition to overlap). Within each 8-thread phase of a 16-byte
// access, four threads read row r and four row r + 1 (opposite halves of
// the rows: conflict-free), and their bf16 chunks land on distinct banks of
// the swizzled boxes.
__device__ __forceinline__ void widen_tile(const unsigned char* raw,
                                           unsigned char* dst, int ptid) {
  constexpr int CHUNKS = BKV * D / 16 / 128;  // per thread
  constexpr int BATCH = 2;
#pragma unroll 1
  for (int it = 0; it < CHUNKS; it += BATCH) {
    uint4 w[BATCH];
    int row[BATCH], c[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int idx = (it + u) * 128 + ptid;
      const int j = idx & 15;
      row[u] = 2 * (idx >> 4) + (((j >> 2) & 1) ^ (j >> 3));
      c[u] = j & 7;  // 16-byte chunk of the int8 row
      w[u] = *reinterpret_cast<const uint4*>(raw + row[u] * D + c[u] * 16);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      uint4 lo, hi;
      lo.x = widen2(w[u].x, 0x4140);
      lo.y = widen2(w[u].x, 0x4342);
      lo.z = widen2(w[u].y, 0x4140);
      lo.w = widen2(w[u].y, 0x4342);
      hi.x = widen2(w[u].z, 0x4140);
      hi.y = widen2(w[u].z, 0x4342);
      hi.z = widen2(w[u].w, 0x4140);
      hi.w = widen2(w[u].w, 0x4342);
      unsigned char* drow = dst + (c[u] >> 2) * BOX + row[u] * 128;
      const int bc = (c[u] & 3) * 2;  // its first bf16 chunk in the box
      const int sw = row[u] & 7;
      *reinterpret_cast<uint4*>(drow + ((bc ^ sw) << 4)) = lo;
      *reinterpret_cast<uint4*>(drow + (((bc + 1) ^ sw) << 4)) = hi;
    }
  }
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

// The kv tiles a q tile of rows at positions [q_first, q_last] sees, each
// once: the sink tiles that lie before the band, then the band [lo, hi]
// (_banded_gt). left / right -1: unbounded; right 0: causal.
struct KvWalk {
  int lo, hi, n_sink, n;
  __device__ KvWalk(int q_first, int q_last, int s_kv, int left, int right,
                    int sink) {
    lo = 0;
    hi = (s_kv + BKV - 1) / BKV - 1;
    n_sink = 0;
    if (right >= 0) {
      const int last = q_last + right;
      hi = last < 0 ? -1 : min(hi, last / BKV);
    }
    if (left >= 0) {
      lo = max(q_first - left, 0) / BKV;
      n_sink = min(min((sink + BKV - 1) / BKV, lo), hi + 1);
    }
    n = n_sink + max(hi - lo + 1, 0);
  }
  __device__ int tile(int jt) const {
    return jt < n_sink ? jt : lo + (jt - n_sink);
  }
};

template <bool TRI>
__device__ __forceinline__ KvWalk walk_of(const Params& p, int q0) {
  const int q_off = TRI ? 0 : p.q_off;
  return KvWalk(q_off + q0, q_off + min(q0 + BQ, p.s_q) - 1, p.s_kv,
                TRI ? -1 : p.left, TRI ? 0 : p.right, TRI ? 0 : p.sink);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// TRI: causal self-attention with compile-time masks (B1); else the masks
// of Params (B3). FORM: the softmax form; QUANT: int8 K/V with fp32 scales.
template <bool TRI, int FORM, bool QUANT>
__global__ void __launch_bounds__(Roles<QUANT>::NT, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
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
  using L = Smem<QUANT>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bars = sbase + L::OFF_BAR;
  auto bar = [&](int i) -> uint32_t { return bars + 8 * i; };
  // stage of the i-th tile of the block's stream, and the parity of its
  // use of that stage
  auto stage = [&](int i) -> uint32_t {
    return sbase + L::OFF_W + (i % STAGES) * L::STAGE;
  };
  auto use = [&](int i) -> int { return (i / STAGES) & 1; };

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
      for (int j = 0; j * (int)gridDim.x < p.n_items; ++j) {
        const int t = item_index(j);
        if (t >= p.n_items) continue;
        const Item x = item_of(p, t);
        const KvWalk w = walk_of<TRI>(p, x.q0);
        const int ihk = x.ih / (p.h / p.h_kv);
        for (int jt = 0; jt < w.n; ++jt, ++it) {
          const int s = it % STAGES;
          const int kv0 = w.tile(jt) * BKV;
          const uint32_t st = stage(it);
          mbar_wait(bar(B_KEMPTY + s), use(it) ^ 1);
          mbar_expect_tx(bar(B_KFULL + s), KV_BYTES);
          tma_load_4d(st, &maps.k, bar(B_KFULL + s), 0, kv0, ihk, x.ib);
          tma_load_4d(st + BOX, &maps.k, bar(B_KFULL + s), 64, kv0, ihk,
                      x.ib);
          if (jt == 0) {  // the item's Q, once its first K is in flight
            mbar_wait(bar(B_QEMPTY), (qn & 1) ^ 1);
            mbar_expect_tx(bar(B_QFULL), Q_BYTES);
            tma_load_4d(sbase, &maps.q, bar(B_QFULL), 0, x.q0, x.ih, x.ib);
            tma_load_4d(sbase + BOX, &maps.q, bar(B_QFULL), 64, x.q0, x.ih,
                        x.ib);
            ++qn;
          }
          mbar_wait(bar(B_VEMPTY + s), use(it) ^ 1);
          mbar_expect_tx(bar(B_VFULL + s), KV_BYTES);
          tma_load_4d(st + KV_BYTES, &maps.v, bar(B_VFULL + s), 0, kv0, ihk,
                      x.ib);
          tma_load_4d(st + KV_BYTES + BOX, &maps.v, bar(B_VFULL + s), 64, kv0,
                      ihk, x.ib);
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
          if (t < p.n_items && jt < walk_of<TRI>(p, item_of(p, t).q0).n)
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
        const int kv0 = walk_of<TRI>(p, x.q0).tile(c.jt) * BKV;
        const int ihk = x.ih / (p.h / p.h_kv);
        if (d0 < 0)  // a scale map: (s_kv, h_kv, b)
          tma_load_3d(dst, map, b, kv0, ihk, x.ib);
        else
          tma_load_4d(dst, map, b, d0, kv0, ihk, x.ib);
      };
      // the i-th raw tile of this warpgroup's stream (K with its scales,
      // or V) into slot i % nslots
      auto load_raw = [&](const Cursor& c, int i) {
        const uint32_t b = bar(b_raw + i % nslots);
        const uint32_t dst = smem_u32(raw + (i % nslots) * RAW_SLOT);
        if (is_v) {
          mbar_expect_tx(b, RAW_BYTES);
          tma(dst, &maps.v, b, c, 0);
        } else {
          mbar_expect_tx(b, RAW_SLOT);
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
        widen_tile(slot, st + (is_v ? KV_BYTES : 0), wtid);
        if (!is_v && wtid < SC_BYTES / 16)  // the scales, beside K
          reinterpret_cast<float4*>(st + 2 * KV_BYTES)[wtid] =
              reinterpret_cast<const float4*>(slot + RAW_BYTES)[wtid];
        fence_proxy_async();
        mbar_arrive(bar((is_v ? B_VFULL : B_KFULL) + s));
        named_sync(NB_PRODUCER + wg, 128);  // all are done with the slot
        if (wtid == 0) {
          if (valid(ahead)) load_raw(ahead, it + nslots);
          if (!is_v && cur.jt == 0) {  // the item's Q, once its first K
            mbar_wait(bar(B_QEMPTY), (qn & 1) ^ 1);  // is ready
            mbar_expect_tx(bar(B_QFULL), Q_BYTES);
            const Item x = item_of(p, item_index(cur.j));
            tma_load_4d(sbase, &maps.q, bar(B_QFULL), 0, x.q0, x.ih, x.ib);
            tma_load_4d(sbase + BOX, &maps.q, bar(B_QFULL), 64, x.q0, x.ih,
                        x.ib);
          }
        }
        if (cur.jt == 0) ++qn;
        cur = after(cur);
        ahead = after(ahead);
      }
    }
  } else {
    // ===================== consumer warpgroups =====================
    setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - PWG;        // which 64 q rows of the item
    const int warp = wtid >> 5;     // 16 rows each
    const int lane = wtid & 31;
    const int g = lane >> 2;        // accumulator row (and row + 8)
    const int cb = 2 * (lane & 3);  // accumulator column pair in each 8
    const int q_off = TRI ? 0 : p.q_off;
    const int left = TRI ? -1 : p.left;
    const int right = TRI ? 0 : p.right;
    const int sink = TRI ? 0 : p.sink;
    const uint32_t q_half = sbase + cw * 64 * 128;  // this warpgroup's rows

    // S = Q K^T of the i-th tile: 8 k16 steps, 4 in each d box
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
    auto issue_pv = [&](float (&o)[64], const uint32_t (&pa)[32], int i) {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                 pa[4 * kk + 3], desc_mnmajor(stage(i) + KV_BYTES + kk * 2048));
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
      const KvWalk w = walk_of<TRI>(p, x.q0);
      const int r0 = x.q0 + cw * 64;  // first q row of this warpgroup
      const int q_first = q_off + r0;
      const int q_last = q_off + min(r0 + 64, p.s_q) - 1;
      const int row_pos0 = q_first + warp * 16 + g;

      float o[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;
      float m_row[2] = {kNegInf, kNegInf};  // rows g and g + 8
      float l_row[2] = {0.f, 0.f};

      float alpha[2];  // the online forms' rescale of O by the new max
      // tile i's scores in place: k scale, scale, cap and (`masked`) masks
      auto scores = [&](float (&sacc)[64], const float* sks, int kv0,
                        float (&mx)[2], auto masked) {
#pragma unroll
        for (int i8 = 0; i8 < 16; ++i8) {
          float2 ksc = make_float2(1.f, 1.f);
          if (QUANT) ksc = *reinterpret_cast<const float2*>(sks + 8 * i8 + cb);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = sacc[4 * i8 + e];
            if (QUANT) v *= (e & 1) ? ksc.y : ksc.x;
            if (ONLINE) v *= p.sscale;
            if (FORM == kSoftcap) v = tanhf(v / p.cap) * p.cap;
            if (decltype(masked)::value) {
              const int col = kv0 + 8 * i8 + cb + (e & 1);
              const int row = row_pos0 + (e >> 1) * 8;
              if (col >= p.s_kv || (right >= 0 && col > row + right) ||
                  (left >= 0 && col < row - left && col >= sink))
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
      auto softmax = [&](float (&sacc)[64], int i, int kv0) {
        const float* sks = reinterpret_cast<const float*>(
            smem + L::OFF_W + (i % STAGES) * L::STAGE + 2 * KV_BYTES);
        const float* svs = sks + BKV;
        const int kv_last = kv0 + BKV - 1;
        const bool interior =
            kv_last < p.s_kv && (right < 0 || kv_last <= q_first + right) &&
            (left < 0 || kv0 >= q_last - left || kv_last < sink);
        float mx[2] = {kNegInf, kNegInf};
        if (interior)
          scores(sacc, sks, kv0, mx, Flag<false>());
        else
          scores(sacc, sks, kv0, mx, Flag<true>());
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
          for (int i8 = 0; i8 < 16; ++i8) {
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

      if (w.n > 0) {
        mbar_wait(bar(B_QFULL), qn & 1);
        if (!ONLINE) {  // fold scale*log2e into this warpgroup's q rows
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int c = i * 128 + wtid;  // 16-byte chunk of the two halves
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
          wgmma_fence();
          issue_qk(sacc, it);
          wgmma_wait<0>();
          reg_fence(sacc);
          if (w.n == 1 && lane == 0) mbar_arrive(bar(B_QEMPTY));
          softmax(sacc, it, w.tile(0) * BKV);
          release(B_KEMPTY, it);  // K and the scales
          to_pa(sacc);
        }
        // then per tile: QK of this tile and PV of the one before issue
        // together; this tile's softmax runs while that PV is on the
        // tensor cores
        for (int jt = 1; jt < w.n; ++jt) {
          ++it;
          float sacc[64];
          mbar_wait(bar(B_KFULL + it % STAGES), use(it));
          mbar_wait(bar(B_VFULL + (it - 1) % STAGES), use(it - 1));
          wgmma_fence();
          issue_qk(sacc, it);
          issue_pv(o, pa, it - 1);
          wgmma_wait<1>();
          reg_fence(sacc);
          if (jt == w.n - 1 && lane == 0) mbar_arrive(bar(B_QEMPTY));
          softmax(sacc, it, w.tile(jt) * BKV);
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
        for (int i = 0; i < 16; ++i) {
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
// q_off, left, right, sink (the layout of the mma.sync entry points)
template <bool TRI, int FORM, bool QUANT>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, void* out, float* lse, const long long* dims,
           float qfold, float sscale, float cap, cudaStream_t stream) {
  Params p;
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
  p.q_off = (int)dims[20];
  p.left = (int)dims[21];
  p.right = (int)dims[22];
  p.sink = (int)dims[23];
  p.qfold = qfold;
  p.sscale = sscale;
  p.cap = cap;
  p.nq = (p.s_q + BQ - 1) / BQ;
  p.n_items = p.nq * p.h * p.b;
  if (p.h_kv <= 0 || p.h % p.h_kv) return (int)cudaErrorInvalidValue;
  if (QUANT && dims[19] != 1) return (int)cudaErrorInvalidValue;
  if (p.n_items == 0) return (int)cudaSuccess;

  Maps maps;
  const CUtensorMapDataType kv_type = QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int kv_esize = QUANT ? 1 : 2;
  const cuuint32_t q_box[4] = {64, BQ, 1, 1};
  const cuuint32_t kv_box[4] = {(cuuint32_t)(QUANT ? D : 64), BKV, 1, 1};
  const cuuint32_t sc_box[3] = {BKV, 1, 1};
  const CUtensorMapSwizzle kv_swizzle =
      QUANT ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  const long long q_dims[4] = {D, p.s_q, p.h, p.b};
  const long long q_str[3] = {dims[6], dims[7], dims[5]};
  const long long kv_dims[4] = {D, p.s_kv, p.h_kv, p.b};
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

  auto kern = flash_fwd_sm90_kernel<TRI, FORM, QUANT>;
  const int smem = Smem<QUANT>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = p.n_items < num_sms() ? p.n_items : num_sms();
  kern<<<grid, Roles<QUANT>::NT, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
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
  return safe ? launch<true, kOnlineExp2, false>(q, k, v, nullptr, nullptr,
                                                 out, lse, dims, qfold, sscale,
                                                 0.f, st)
              : launch<true, kFast, false>(q, k, v, nullptr, nullptr, out, lse,
                                           dims, qfold, sscale, 0.f, st);
}

// Kernel B3: q rows at q_off + i, bf16 or int8 K/V (ks != null), any
// window, sinks and softcap. form: 0 fast, 1 online (natural units), 2
// softcap.
extern "C" int lca_flash_fwd_pos(const void* q, const void* k, const void* v,
                                 const float* ks, const float* vs, void* out,
                                 float* lse, const long long* dims,
                                 float qfold, float sscale, float cap,
                                 int form, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launcher) {
    return launcher(q, k, v, ks, vs, out, lse, dims, qfold, sscale, cap, st);
  };
  if (ks != nullptr) {
    switch (form) {
      case 0: return args(launch<false, kFast, true>);
      case 1: return args(launch<false, kOnlineNat, true>);
      case 2: return args(launch<false, kSoftcap, true>);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (form) {
    case 0: return args(launch<false, kFast, false>);
    case 1: return args(launch<false, kOnlineNat, false>);
    case 2: return args(launch<false, kSoftcap, false>);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* lca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
