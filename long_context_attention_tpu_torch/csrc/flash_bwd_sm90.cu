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
// (B2a, lca_flash_bwd_dq, is in flash_bwd.cu.)
//
// Both take bf16 q, dout (b, s_q, h, d) and k, v (b, s_kv, h_kv, d), read by
// TMA through their strides (16-byte aligned, unit stride along d); fp32 lse
// and delta = rowsum(dout * out), (b, h, s_q) contiguous; and write fp32
// partials. q row i sits at position q_start + i and kv column j at j; with
// the causal mask a column past its row's position is dropped. A row whose
// lse is -inf (it saw no column in the forward) contributes nothing.
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
// blocks in a snake order. An item's kv tile is BKV = 128 rows; it walks
// its group's query heads and, for each, the q tiles of BQ = 64 rows from
// the causal diagonal on (the TPU's _q_band_static). A block has one
// producer warpgroup and two consumer warpgroups:
//   * producer warp 0 (setmaxnreg down to 24 or 32 registers) loads K and V
//     once per item, and per step Q and dout by TMA into a ring of stages, with
//     lse (in exp2 units; +inf for a dead row or a row past s_q, so its p is
//     exp2(-inf) = 0) and delta beside them, loaded by its 32 lanes;
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
// stages x (Q 16384 + dout 16384) + stages x 512 (lse, delta), and for B5
// 2 dS^T tiles (16384 each) + the dq tile 32768; 3 stages for B5 (230912),
// 4 for B2b (198656), + 256 of barriers and 1024 of alignment slack.
//
// Numerics follow the TPU kernels (_recompute_p, _ds_to_dqk):
//   s = (q . k) * scale in fp32 from the raw q (no log2e fold);
//   p = exp(s - lse) (computed as exp2(s * scale * log2e - lse * log2e)),
//     0 on masked entries and on rows with lse -inf;
//   dp = dout . v; ds = p * (dp - delta) * scale;
//   dv += bf16(p) . dout; dk += bf16(ds) . q; dq += bf16(ds) . k.
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
// producer keeps 32 (24 spill its loop), its consumers 232
constexpr int REGS_AT_LAUNCH = 65536 / NT / 8 * 8;
template <bool FUSED>
struct Regs {
  static constexpr int PRODUCER = FUSED ? 24 : 32;
  static constexpr int CONSUMER =
      (REGS_AT_LAUNCH * NT - 128 * PRODUCER) / 256 / 8 * 8;
};
constexpr float kLog2e = 1.4426950408889634f;

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

template <bool FUSED>
struct Smem {
  static constexpr int STAGES = FUSED ? 3 : 4;
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_ST = 2 * KV_BYTES;  // stages: Q, then dout
  static constexpr int OFF_DS = OFF_ST + STAGES * 2 * QT_BYTES;
  static constexpr int OFF_DQ = OFF_DS + (FUSED ? 2 * DS_BYTES : 0);
  static constexpr int OFF_LD = OFF_DQ + (FUSED ? DQ_BYTES : 0);
  static constexpr int OFF_BAR = OFF_LD + STAGES * LD_BYTES;
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
  int q_start;  // position of q row 0 (kv column j sits at j)
  int causal;
  float scale;
  float sl2;  // scale * log2e
  int nq, nk, n_items;
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
};

// item t: kv tiles outside, kv tile 0 (the longest causal walk) first, kv
// heads and batch rows inside. The order with the kv heads outside, whose
// blocks running at once share fewer kv heads and dq rows, balanced the
// blocks' work worse and ran 1.7x slower (scripts/torch_bwd_order.py).
__device__ __forceinline__ Item item_of(const Params& p, int t) {
  Item x;
  const int r = t % (p.b * p.h_kv);
  x.ik = t / (p.b * p.h_kv);
  x.ihk = r % p.h_kv;
  x.ib = r / p.h_kv;
  return x;
}

// The steps of an item: the group's query heads, each with the q tiles
// from the first that sees the kv tile (all under no mask) to the last.
struct QWalk {
  int iq_lo, nqi, n;
  __device__ QWalk(const Params& p, int ik) {
    iq_lo = 0;
    if (p.causal) {
      const int first_row = ik * BKV - p.q_start;  // first row that sees it
      iq_lo = first_row <= 0 ? 0 : min(p.nq, first_row / BQ);
    }
    nqi = p.nq - iq_lo;
    n = (p.h / p.h_kv) * nqi;
  }
  __device__ int head(const Item& x, const Params& p, int js) const {
    return x.ihk * (p.h / p.h_kv) + js / nqi;
  }
  __device__ int q0(int js) const { return (iq_lo + js % nqi) * BQ; }
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <bool FUSED>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  using L = Smem<FUSED>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
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
    setmaxnreg_dec<Regs<FUSED>::PRODUCER>();
    if (warp == 0) {  // loads
      int it = 0, kvn = 0;
      for (int j = 0; j * (int)gridDim.x < p.n_items; ++j) {
        const int t = item_index(j);
        if (t >= p.n_items) continue;
        const Item x = item_of(p, t);
        const QWalk w(p, x.ik);
        if (w.n == 0) continue;
        if (lane == 0) {
          mbar_wait(bar(B_KVEMPTY), (kvn & 1) ^ 1);
          mbar_expect_tx(bar(B_KVFULL), 2 * KV_BYTES);
          for (int hb = 0; hb < 2; ++hb) {
            tma_load_4d(sbase + L::OFF_K + hb * KBOX, &maps.k, bar(B_KVFULL),
                        64 * hb, x.ik * BKV, x.ihk, x.ib);
            tma_load_4d(sbase + L::OFF_V + hb * KBOX, &maps.v, bar(B_KVFULL),
                        64 * hb, x.ik * BKV, x.ihk, x.ib);
          }
        }
        ++kvn;
        for (int js = 0; js < w.n; ++js, ++it) {
          const int s = it % STAGES;
          const int ih = w.head(x, p, js);
          const int q0 = w.q0(js);
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
        }
      }
    } else if (FUSED && warp == 1 && lane == 0) {  // dq reduce-adds
      int dn = 0;
      for (int j = 0; j * (int)gridDim.x < p.n_items; ++j) {
        const int t = item_index(j);
        if (t >= p.n_items) continue;
        const Item x = item_of(p, t);
        const QWalk w(p, x.ik);
        for (int js = 0; js < w.n; ++js, ++dn) {
          mbar_wait(bar(B_DQFULL), dn & 1);
          for (int bx = 0; bx < 4; ++bx)
            tma_reduce_add_4d(&maps.dq, sbase + L::OFF_DQ + bx * DQBOX,
                              32 * bx, w.q0(js), w.head(x, p, js), x.ib);
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
  setmaxnreg_inc<Regs<FUSED>::CONSUMER>();
  const int cw = wg - 1;          // which 64 kv rows of the item
  const int g = lane >> 2;        // accumulator row (and row + 8)
  const int cb = 2 * (lane & 3);  // accumulator column pair in each 8
  const uint32_t k_rows = sbase + L::OFF_K + cw * 64 * 128;
  const uint32_t v_rows = sbase + L::OFF_V + cw * 64 * 128;

  int it = 0, kvn = 0, dn = 0;
  for (int j = 0; j * (int)gridDim.x < p.n_items; ++j) {
    const int t = item_index(j);
    if (t >= p.n_items) continue;
    const Item x = item_of(p, t);
    const QWalk w(p, x.ik);
    const int k0 = x.ik * BKV + cw * 64;  // first kv row of this warpgroup
    const int kv_row0 = k0 + warp * 16 + g;

    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

    // P^T of one step in place of S^T: p = exp2(s * scale * log2e - lse
    // * log2e), 0 where `masked` drops the (kv row, q row) pair
    auto probs = [&](float (&sacc)[32], const float* ld, int q0,
                     auto masked) {
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8) {
        const float2 l = *reinterpret_cast<const float2*>(ld + 8 * i8 + cb);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = exp2f(sacc[4 * i8 + e] * p.sl2 - ((e & 1) ? l.y : l.x));
          if (decltype(masked)::value) {
            const int kv = kv_row0 + (e >> 1) * 8;
            const int qpos = p.q_start + q0 + 8 * i8 + cb + (e & 1);
            if (kv >= p.s_kv || (p.causal && kv > qpos)) pe = 0.f;
          }
          sacc[4 * i8 + e] = pe;
        }
      }
    };

    if (w.n > 0) {
      mbar_wait(bar(B_KVFULL), kvn & 1);
      for (int js = 0; js < w.n; ++js, ++it) {
        const int s = it % STAGES;
        const int q0 = w.q0(js);
        const uint32_t st = stage(it);
        mbar_wait(bar(B_FULL + s), use(it));

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
        const bool masked =
            (p.causal && k0 + 63 > p.q_start + q0) || k0 + 63 >= p.s_kv;
        wgmma_wait<1>();
        reg_fence(sacc);
        if (masked)
          probs(sacc, ld, q0, Flag<true>());
        else
          probs(sacc, ld, q0, Flag<false>());
        wgmma_wait<0>();
        reg_fence(dpacc);

        // dS^T = P^T (dP^T - delta) * scale; P^T and dS^T to bf16 as the A
        // operands: accumulator (row, column pair) of 8-column group i8 ->
        // the A fragment of k16 step i8 / 2
        uint32_t pa[16], da[16];
#pragma unroll
        for (int i8 = 0; i8 < 8; ++i8) {
          const float2 dl =
              *reinterpret_cast<const float2*>(ld + BQ + 8 * i8 + cb);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpacc[4 * i8 + e] = sacc[4 * i8 + e] *
                                (dpacc[4 * i8 + e] - ((e & 1) ? dl.y : dl.x)) *
                                p.scale;
          pa[2 * i8] = pack_bf16(sacc[4 * i8], sacc[4 * i8 + 1]);
          pa[2 * i8 + 1] = pack_bf16(sacc[4 * i8 + 2], sacc[4 * i8 + 3]);
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

    // write dk and dv once (0 for a kv tile no q row sees)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kv = kv_row0 + hh * 8;
      if (kv >= p.s_kv) continue;
      const long long at = x.ib * p.dk_sb + (long long)kv * p.dk_ss +
                           x.ihk * p.dk_sh;
#pragma unroll
      for (int i8 = 0; i8 < 16; ++i8) {
        *reinterpret_cast<float2*>(p.dk + at + 8 * i8 + cb) =
            make_float2(dk[4 * i8 + 2 * hh], dk[4 * i8 + 2 * hh + 1]);
        *reinterpret_cast<float2*>(p.dv + at + 8 * i8 + cb) =
            make_float2(dv[4 * i8 + 2 * hh], dv[4 * i8 + 2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launch
// ---------------------------------------------------------------------------

// dims: b, h, h_kv, s_q, s_kv, then (batch, seq, head) element strides of
// q, k, v, dout, dq and dk (dv shares dk's), q_start, causal (the layout of
// flash_bwd.cu's entry points)
template <bool FUSED>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dq, float* dk,
           float* dv, const long long* dims, float scale,
           cudaStream_t stream) {
  Params p;
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
  p.q_start = (int)dims[23];
  p.causal = (int)dims[24];
  p.scale = scale;
  p.sl2 = scale * kLog2e;
  p.nq = (p.s_q + BQ - 1) / BQ;
  p.nk = (p.s_kv + BKV - 1) / BKV;
  p.n_items = p.nk * p.h_kv * p.b;
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

  auto kern = flash_bwd_sm90_kernel<FUSED>;
  const int smem = Smem<FUSED>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = p.n_items < num_sms() ? p.n_items : num_sms();
  kern<<<grid, NT, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

}  // namespace

#define LCA_BWD_ARGS                                                         \
  const void *q, const void *k, const void *v, const void *dout,             \
      const float *lse, const float *delta, float *dq, float *dk, float *dv, \
      const long long *dims, float scale, void *stream

// Kernel B2b: dk, dv.
extern "C" int lca_flash_bwd_dkv(LCA_BWD_ARGS) {
  return launch<false>(q, k, v, dout, lse, delta, dq, dk, dv, dims, scale,
                       static_cast<cudaStream_t>(stream));
}

// Kernel B5: self-attention (s_q == s_kv) dq (added into a zeroed buffer),
// dk, dv.
extern "C" int lca_flash_bwd_fused(LCA_BWD_ARGS) {
  return launch<true>(q, k, v, dout, lse, delta, dq, dk, dv, dims, scale,
                      static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory a block of B5 (fused != 0) or B2b takes.
extern "C" int lca_flash_bwd_smem(int fused) {
  return fused ? Smem<true>::BYTES : Smem<false>::BYTES;
}

extern "C" const char* lca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
