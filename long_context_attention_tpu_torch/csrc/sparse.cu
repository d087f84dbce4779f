// Block-sparse flash attention for Hopper (sm_90a): forward and dq over
// the live tiles of a static block mask. (dk and dv, kernel B9c, run on the
// wgmma/TMA backward pipeline: flash_bwd_sm90.cu lca_sparse_bwd_dkv.)
//
// Replaces the TPU kernels of long_context_attention_tpu/ops/sparse.py:
//   lca_sparse_fwd     <- _sparse_fwd_kernel (B9a): out and lse of one q
//                         sub-tile over its mask row's live kv tiles;
//   lca_sparse_bwd_dq  <- _sparse_dq_kernel (B9b): dq of one q sub-tile over
//                         the same row.
//
// The tables: the host enumerates the live tiles in the JAX package's order
// (ops/sparse.py _row_tables) and hands each kernel a CSR form. A row (head
// or 0, q tile) owns the range [ptr[r], ptr[r+1]) of int4 entries (kv tile,
// flags, q_first, kv_first). q_first and kv_first are the tiles' global
// first positions (for ring shards they come from the layout), and the
// in-tile causal mask compares them. A row with an empty range writes
// zeros (out 0, lse -inf; dq 0): the TPU's DEAD zero-emit entries.
//
// What bounds it on an H100: tensor-core operations. Per visible (row,
// column) pair B9a does 4*d FLOPs (QK, PV), B9b 6*d (S, dP, dQ), against
// 989 TFLOP/s bf16; the bytes are each tile's q, k, v (and dout) once per
// live tile.
//
// Design: the TPU's (b, h, live step) grid with its sequential step axis
// becomes one 128-thread block per 64-row q sub-tile (a mask tile of
// block_q rows, a multiple of 64, splits into several blocks), which walks
// its range in 64-wide kv sub-tiles inside the block: mma.sync m16n8k16
// (bf16 in, fp32 accumulate) fed by ldmatrix, scores and probabilities in
// registers and reused as the A operand of the next product, and a
// cp.async double buffer that loads the next sub-tile while this one
// computes. On a tile flagged MASKED, a sub-tile that lies wholly above the
// causal diagonal is skipped (its p would be exactly 0, so this is exact)
// and the others drop col > row by global position. Each block writes its
// own rows once: no atomics, deterministic. No TMA or wgmma yet.
//
// Numerics follow the TPU kernels:
//   B9a: scale*log2e is folded into q in bf16 (one rounding), s = q . k,
//     masked -> -1e30, p = exp2(min(s, 90)), l += rowsum(p), acc +=
//     bf16(p) @ v; out = acc / l, lse = ln l; l == 0 gives out 0, lse -inf.
//   B9b: s = (q . k) * scale from the raw q, masked -> -1e30, p = exp(s -
//     lse) with the -inf-safe lse (+1e30 on dead rows), ds = p * (dp -
//     delta); dq = scale * sum bf16(ds) @ k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int BT = 64;  // rows of a sub-tile, q and kv alike
constexpr int NTHREADS = 128;
constexpr int LD = D + 8;  // bf16 pitch of a tile: the 8 rows of an
                           // ldmatrix land in distinct banks
constexpr int TILE = BT * LD;  // bf16 elements of one tile
constexpr int TILE_BYTES = TILE * 2;
constexpr float kClamp = 90.f;
constexpr float kNegInf = -1e30f;
constexpr int kMasked = 4;  // the table's _F_MASKED flag

// B9a: q, 2 stages each of k and v
constexpr int FWD_SMEM = 5 * TILE_BYTES;
// B9b: q, dout, 2 stages each of k and v
constexpr int DQ_SMEM = 6 * TILE_BYTES;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // B9b, B9c: -inf-safe lse, (b, h, s_q)
  const float* delta;  // (b, h, s_q)
  void* out;           // B9a: bf16 out; B9b: fp32 dq
  float* out_lse;      // B9a: lse (b, h, s_q)
  const int* ptr;      // CSR ranges of the walk
  const int4* ent;     // CSR entries
  int h, h_kv, s_q, s_kv;
  long long q_sb, q_ss, q_sh;  // element strides (batch, seq, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;     // dout
  long long r_sb, r_ss, r_sh;     // out (B9a) or dq (B9b)
  int n_q, n_kv, bq, bkv, per_head;
  float qfold;  // B9a: scale*log2e folded into q
  float scale;  // B9b, B9c
};

__device__ __forceinline__ float bf16_bits_to_float(unsigned short x) {
  return __uint_as_float(((unsigned)x) << 16);
}

__device__ __forceinline__ unsigned short float_to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));  // nearest even
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)float_to_bf16_bits(lo) |
         ((unsigned)float_to_bf16_bits(hi) << 16);
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 64 x 128 bf16 tile, rows row0.. of a (seq, d) matrix with the given row
// stride, into shared memory at pitch LD (the wrapper checks that every
// sequence is a whole number of sub-tiles)
__device__ __forceinline__ void load_tile(unsigned short* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int tid) {
  for (int c = tid; c < BT * (D / 8); c += NTHREADS) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    cp_async16(smem_addr(dst + r * LD + col),
               src + (long long)(row0 + r) * row_stride + col);
  }
}

// ldmatrix operand addresses of a warp (as in csrc/flash_bwd.cu):
// A (16 x 16 block at rows m0, cols k0) of a row-major tile X[m][k]
__device__ __forceinline__ unsigned a_addr(const unsigned short* x, int m0,
                                           int k0, int lane) {
  return smem_addr(x + (m0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}
// B for two n-tiles (n0..n0+15) at depth k0 of a tile stored X[n][k]
__device__ __forceinline__ unsigned bn_addr(const unsigned short* x, int n0,
                                            int k0, int lane) {
  const int mi = lane >> 3;
  return smem_addr(x + (n0 + (lane & 7) + (mi >> 1) * 8) * LD + k0 +
                   (mi & 1) * 8);
}
// B (ldmatrix.trans) for two n-tiles (n0..n0+15) at depth k0 of a tile
// stored X[k][n]
__device__ __forceinline__ unsigned bt_addr(const unsigned short* x, int k0,
                                            int n0, int lane) {
  const int mi = lane >> 3;
  return smem_addr(x + (k0 + (lane & 7) + (mi & 1) * 8) * LD + n0 +
                   (mi >> 1) * 8);
}

// One step of a walk: entry e of the CSR range and the kv sub-tile j,
// which runs over [j, hi) for this entry.
struct Step {
  int e, j, hi;
  int4 en;
};

// The walk of a block over its row's CSR range [e, e_end): every entry's
// kv sub-tiles (bkv / 64 of them) in order, less those wholly above the
// causal diagonal on MASKED tiles; the block owns q rows at offset `own`
// in the entry's q tile.
struct Walk {
  const int4* ent;
  int e_end, own, nsub;

  __device__ Step from(int e) const {
    for (; e < e_end; ++e) {
      const int4 en = ent[e];
      int hi = nsub;
      if (en.y & kMasked) {  // kv sub-tile j is visible iff kf + 64j <= q_last
        const int x = en.z + own + BT - 1 - en.w;
        hi = x < 0 ? 0 : min(nsub, x / BT + 1);
      }
      if (0 < hi) return Step{e, 0, hi, en};
    }
    return Step{e_end, 0, 0, make_int4(0, 0, 0, 0)};
  }
  __device__ Step next(const Step& s) const {
    if (s.j + 1 < s.hi) return Step{s.e, s.j + 1, s.hi, s.en};
    return from(s.e + 1);
  }
};

// ---------------------------------------------------------------------------
// B9a: the forward, one block per (q sub-tile, head, batch row)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS) sparse_fwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned short* sQ = reinterpret_cast<unsigned short*>(smem);
  unsigned short* sK = sQ + TILE;      // 2 stages
  unsigned short* sV = sK + 2 * TILE;  // 2 stages

  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int ihk = ih / (p.h / p.h_kv);
  const int q0 = blockIdx.x * BT;
  const int iq = q0 / p.bq;
  const int qsub = q0 - iq * p.bq;
  const int row = (p.per_head ? ih : 0) * p.n_q + iq;
  const Walk walk{p.ent, p.ptr[row + 1], qsub, p.bkv / BT};
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair

  const __nv_bfloat16* kb = p.k + ib * p.k_sb + ihk * p.k_sh;
  const __nv_bfloat16* vb = p.v + ib * p.v_sb + ihk * p.v_sh;
  auto issue = [&](const Step& st, int s) {
    const int kv0 = st.en.x * p.bkv + st.j * BT;
    load_tile(sK + s * TILE, kb, p.k_ss, kv0, tid);
    load_tile(sV + s * TILE, vb, p.v_ss, kv0, tid);
    cp_async_commit();
  };
  Step cur = walk.from(p.ptr[row]);
  if (cur.e < walk.e_end) issue(cur, 0);

  // q with scale*log2e folded in, in bf16 (B1's fold)
  const __nv_bfloat16* qb = p.q + ib * p.q_sb + ih * p.q_sh;
  for (int c = tid; c < BT * (D / 8); c += NTHREADS) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    union {
      uint4 u;
      unsigned short h[8];
    } val;
    val.u = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * p.q_ss +
                                            col);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      val.h[i] = float_to_bf16_bits(bf16_bits_to_float(val.h[i]) * p.qfold);
    *reinterpret_cast<uint4*>(sQ + r * LD + col) = val.u;
  }
  __syncthreads();
  unsigned qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qa[kk], a_addr(sQ, warp * 16, kk * 16, lane));

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float l_row[2] = {0.f, 0.f};  // rows g and g + 8

  for (int it = 0; cur.e < walk.e_end; ++it) {
    const int stage = it & 1;
    const Step nxt = walk.next(cur);
    if (nxt.e < walk.e_end) {
      issue(nxt, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned short* tK = sK + stage * TILE;
    const unsigned short* tV = sV + stage * TILE;

    // S = Q K^T: 8 n-tiles of 8 kv columns; a lane holds rows g and g + 8
    float s[BT / 8][4];
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BT / 16; ++np) {
        unsigned b[4];
        ldsm_x4(b, bn_addr(tK, np * 16, kk * 16, lane));
        mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }

    // the in-tile causal mask on a straddling sub-tile, by global position
    const int row_pos0 = cur.en.z + qsub + warp * 16 + g;
    const int col_pos0 = cur.en.w + cur.j * BT;
    const bool need_mask =
        (cur.en.y & kMasked) && col_pos0 + BT - 1 > cur.en.z + qsub;
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[n][e];
        if (need_mask &&
            col_pos0 + n * 8 + 2 * t + (e & 1) > row_pos0 + (e >> 1) * 8)
          v = kNegInf;
        const float pv = exp2f(fminf(v, kClamp));  // exp2(-1e30) == 0
        rs[e >> 1] += pv;
        s[n][e] = pv;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
      l_row[hh] += rs[hh];
    }

    // O += bf16(P) V: the score fragments are the A operand; ldmatrix.trans
    // hands over V as the B operand
#pragma unroll
    for (int kc = 0; kc < BT / 16; ++kc) {
      unsigned pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned b[4];
        ldsm_x4_t(b, bt_addr(tV, kc * 16, dp * 16, lane));
        mma_bf16(o[2 * dp], pa, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // the next step overwrites this stage
    cur = nxt;
  }

  // emit: out = acc / l, lse = ln l; a row that saw nothing gives 0, -inf
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + warp * 16 + g + hh * 8;
    const float l = l_row[hh];
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.out) + ib * p.r_sb +
                          (long long)qi * p.r_ss + ih * p.r_sh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = l == 0.f ? 0.f : o[n][2 * hh] / l;
      const float x1 = l == 0.f ? 0.f : o[n][2 * hh + 1] / l;
      *reinterpret_cast<unsigned*>(orow + n * 8 + 2 * t) = pack_bf16(x0, x1);
    }
    if (t == 0)
      p.out_lse[((long long)ib * p.h + ih) * p.s_q + qi] =
          l == 0.f ? __int_as_float(0xff800000) : logf(l);
  }
}

// ---------------------------------------------------------------------------
// B9b: dq, one block per (q sub-tile, head, batch row)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
    sparse_bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned short* sQ = reinterpret_cast<unsigned short*>(smem);
  unsigned short* sO = sQ + TILE;
  unsigned short* sK = sO + TILE;      // 2 stages
  unsigned short* sV = sK + 2 * TILE;  // 2 stages

  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int ihk = ih / (p.h / p.h_kv);
  const int q0 = blockIdx.x * BT;
  const int iq = q0 / p.bq;
  const int qsub = q0 - iq * p.bq;
  const int row = (p.per_head ? ih : 0) * p.n_q + iq;
  const Walk walk{p.ent, p.ptr[row + 1], qsub, p.bkv / BT};
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  const __nv_bfloat16* kb = p.k + ib * p.k_sb + ihk * p.k_sh;
  const __nv_bfloat16* vb = p.v + ib * p.v_sb + ihk * p.v_sh;
  auto issue = [&](const Step& st, int s) {
    const int kv0 = st.en.x * p.bkv + st.j * BT;
    load_tile(sK + s * TILE, kb, p.k_ss, kv0, tid);
    load_tile(sV + s * TILE, vb, p.v_ss, kv0, tid);
    cp_async_commit();
  };
  Step cur = walk.from(p.ptr[row]);
  if (cur.e < walk.e_end) {
    load_tile(sQ, p.q + ib * p.q_sb + ih * p.q_sh, p.q_ss, q0, tid);
    load_tile(sO, p.dout + ib * p.o_sb + ih * p.o_sh, p.o_ss, q0, tid);
    issue(cur, 0);  // one commit group with q and dout
  }

  // this lane's two rows: the -inf-safe lse and delta
  float lse_r[2], del_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long long at =
        ((long long)ib * p.h + ih) * p.s_q + q0 + warp * 16 + g + hh * 8;
    lse_r[hh] = p.lse[at];
    del_r[hh] = p.delta[at];
  }

  for (int it = 0; cur.e < walk.e_end; ++it) {
    const int stage = it & 1;
    const Step nxt = walk.next(cur);
    if (nxt.e < walk.e_end) {
      issue(nxt, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned short* tK = sK + stage * TILE;
    const unsigned short* tV = sV + stage * TILE;

    // S = Q K^T and dP = dO V^T: 8 n-tiles of 8 kv columns each
    float s[BT / 8][4], dp[BT / 8][4];
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned qa[4], oa[4];
      ldsm_x4(qa, a_addr(sQ, warp * 16, kk * 16, lane));
      ldsm_x4(oa, a_addr(sO, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < BT / 16; ++np) {
        unsigned b[4];
        ldsm_x4(b, bn_addr(tK, np * 16, kk * 16, lane));
        mma_bf16(s[2 * np], qa, b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
        ldsm_x4(b, bn_addr(tV, np * 16, kk * 16, lane));
        mma_bf16(dp[2 * np], oa, b[0], b[1]);
        mma_bf16(dp[2 * np + 1], oa, b[2], b[3]);
      }
    }

    // p and ds in registers (s is overwritten with ds, unscaled)
    const int row_pos0 = cur.en.z + qsub + warp * 16 + g;
    const int col_pos0 = cur.en.w + cur.j * BT;
    const bool need_mask =
        (cur.en.y & kMasked) && col_pos0 + BT - 1 > cur.en.z + qsub;
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        float x = s[n][e] * p.scale;
        if (need_mask && col_pos0 + n * 8 + 2 * t + (e & 1) > row_pos0 + hh * 8)
          x = kNegInf;
        const float pv = expf(x - lse_r[hh]);
        s[n][e] = pv * (dp[n][e] - del_r[hh]);
      }
    }

    // dQ += bf16(dS) K: dS fragments are the A operand, ldmatrix.trans
    // hands over K as the B operand
#pragma unroll
    for (int kc = 0; kc < BT / 16; ++kc) {
      unsigned a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dpi = 0; dpi < D / 16; ++dpi) {
        unsigned b[4];
        ldsm_x4_t(b, bt_addr(tK, kc * 16, dpi * 16, lane));
        mma_bf16(dq[2 * dpi], a, b[0], b[1]);
        mma_bf16(dq[2 * dpi + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next step overwrites this stage
    cur = nxt;
  }

  // write dq = scale * sum once (0 for rows that saw no tile)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + warp * 16 + g + hh * 8;
    float* out = static_cast<float*>(p.out) + ib * p.r_sb +
                 (long long)qi * p.r_ss + ih * p.r_sh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + n * 8 + 2 * t) =
          make_float2(dq[n][2 * hh] * p.scale, dq[n][2 * hh + 1] * p.scale);
  }
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* out, float* out_lse, const int* ptr,
                   const int* ent, const long long* dims, float qfold,
                   float scale) {
  // dims: b, h, h_kv, s_q, s_kv, then (batch, seq, head) strides of q, k,
  // v, dout, out (or dq) and dk (unused), n_q, n_kv, bq, bkv, per_head
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.out = out;
  p.out_lse = out_lse;
  p.ptr = ptr;
  p.ent = reinterpret_cast<const int4*>(ent);
  p.h = (int)dims[1];
  p.h_kv = (int)dims[2];
  p.s_q = (int)dims[3];
  p.s_kv = (int)dims[4];
  long long* st[15] = {&p.q_sb, &p.q_ss, &p.q_sh, &p.k_sb, &p.k_ss,
                       &p.k_sh, &p.v_sb, &p.v_ss, &p.v_sh, &p.o_sb,
                       &p.o_ss, &p.o_sh, &p.r_sb, &p.r_ss, &p.r_sh};
  for (int i = 0; i < 15; ++i) *st[i] = dims[5 + i];
  p.n_q = (int)dims[23];
  p.n_kv = (int)dims[24];
  p.bq = (int)dims[25];
  p.bkv = (int)dims[26];
  p.per_head = (int)dims[27];
  p.qfold = qfold;
  p.scale = scale;
  return p;
}

// the shapes the kernels take: whole sub-tiles, GQA
bool valid(const Params& p) {
  return p.h_kv > 0 && p.h % p.h_kv == 0 && p.bq > 0 && p.bkv > 0 &&
         p.bq % BT == 0 && p.bkv % BT == 0 && p.s_q == p.n_q * p.bq &&
         p.s_kv == p.n_kv * p.bkv;
}

template <typename K>
int launch(K kern, dim3 grid, int smem, const Params& p, cudaStream_t stream) {
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (grid.x == 0) return 0;  // an empty sequence: nothing to write
  kern<<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

#define LCA_SPARSE_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *dout,               \
      const float *lse, const float *delta, void *out, float *out_lse,         \
      float *dk, float *dv, const int *ptr, const int *ent,                    \
      const long long *dims, float qfold, float scale, void *stream
#define LCA_SPARSE_PARAMS \
  make_params(q, k, v, dout, lse, delta, out, out_lse, ptr, ent, dims, qfold, \
              scale)

// B9a: out (b, s_q, h, d) bf16 and lse; walks the row ranges.
extern "C" int lca_sparse_fwd(LCA_SPARSE_ARGS) {
  const Params p = LCA_SPARSE_PARAMS;
  const dim3 grid(p.s_q / BT, p.h, (unsigned)dims[0]);
  return launch(sparse_fwd_kernel, grid, FWD_SMEM, p,
                static_cast<cudaStream_t>(stream));
}

// B9b: dq (b, s_q, h, d) fp32 into `out`; walks the row ranges.
extern "C" int lca_sparse_bwd_dq(LCA_SPARSE_ARGS) {
  const Params p = LCA_SPARSE_PARAMS;
  const dim3 grid(p.s_q / BT, p.h, (unsigned)dims[0]);
  return launch(sparse_bwd_dq_kernel, grid, DQ_SMEM, p,
                static_cast<cudaStream_t>(stream));
}

extern "C" const char* lca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
