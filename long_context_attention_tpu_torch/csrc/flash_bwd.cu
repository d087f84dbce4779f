// Flash-attention backward for Hopper (sm_90a): kernel B2a.
//
// Replaces the TPU kernel of long_context_attention_tpu/ops/flash.py:
//   lca_flash_bwd_dq    <- _dq_kernel (B2a): dq of one q tile, the kv tiles
//                          walked inside the block.
// (B2b and B5, dk and dv with or without dq, are in flash_bwd_sm90.cu.)
//
// It takes bf16 q, dout (b, s_q, h, d) and k, v (b, s_kv, h_kv, d), read by
// strides; fp32 lse and delta = rowsum(dout * out), (b, h, s_q) contiguous;
// and writes fp32 dq. q row i sits at position q_start + i and kv column j
// at j; with the causal mask a column past its row's position is dropped. A
// row whose lse is -inf (it saw no column in the forward) contributes
// nothing.
//
// What bounds it on an H100: tensor-core operations. Per live (row,
// column) pair it does 3 products of depth d (S, dP, dQ); the bytes (q, k,
// v, dout once, fp32 dq once) are a few percent of that time at s = 8192.
//
// Design: 128-thread blocks, tiles of 64 rows on both sides, each warp
// owning 16 q rows. Products run on mma.sync m16n8k16 (bf16 in, fp32
// accumulate) fed by ldmatrix from shared memory. Scores, probabilities and
// dS stay in registers and are reused as the A operand of the next product
// (FlashAttention-2's accumulator-to-operand reuse). The kv tiles arrive by
// cp.async into a double buffer, so the next tile loads while this one
// computes. Under the causal mask the walk stops at the diagonal, so fully
// masked tiles cost nothing.
//
// Numerics follow the TPU kernels (_recompute_p, _ds_to_dqk):
//   s = (q . k) * scale in fp32 from the raw q (no log2e fold);
//   p = exp(s - lse), 0 on masked entries and on rows with lse -inf;
//   dp = dout . v; ds = p * (dp - delta) * scale; dq += bf16(ds) . k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int BT = 64;  // rows of a tile, q and kv alike
constexpr int NTHREADS = 128;
constexpr int LD = D + 8;       // bf16 pitch of a tile: the 8 rows of an
                                // ldmatrix land in distinct banks
constexpr int TILE = BT * LD;   // bf16 elements of one tile
constexpr int TILE_BYTES = TILE * 2;

// q, dout, 2 stages each of k and v
constexpr int DQ_SMEM = 6 * TILE_BYTES;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;
  const float* delta;
  float* dq;
  int h, h_kv, s_q, s_kv;
  long long q_sb, q_ss, q_sh;  // element strides (batch, seq, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;     // dout
  long long dq_sb, dq_ss, dq_sh;
  int q_start;  // position of q row 0 (kv column j sits at j)
  int causal;
  float scale;
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros (rows past the sequence)
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
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

// A 64 x 128 bf16 tile, rows row0.. of a (seq, d) matrix with the given
// row stride, into shared memory at pitch LD; rows past n_rows read as 0.
__device__ __forceinline__ void load_tile(unsigned short* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int n_rows, int tid) {
  for (int c = tid; c < BT * (D / 8); c += NTHREADS) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    const bool ok = row0 + r < n_rows;
    const long long rr = ok ? row0 + r : 0;
    cp_async16(smem_addr(dst + r * LD + col), src + rr * row_stride + col, ok);
  }
}

// Operand addresses for the ldmatrix loads of a warp (lane = 0..31):
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
                                            int n0, int lane, int pitch) {
  const int mi = lane >> 3;
  return smem_addr(x + (k0 + (lane & 7) + (mi & 1) * 8) * pitch + n0 +
                   (mi >> 1) * 8);
}
// ---------------------------------------------------------------------------
// B2a: dq, one block per (q tile, head, batch row)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned short* sQ = reinterpret_cast<unsigned short*>(smem);
  unsigned short* sO = sQ + TILE;
  unsigned short* sK = sO + TILE;      // 2 stages
  unsigned short* sV = sK + 2 * TILE;  // 2 stages

  const int nq = (p.s_q + BT - 1) / BT;
  const int iq = nq - 1 - (int)blockIdx.x;  // the longest rows first
  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int ihk = ih / (p.h / p.h_kv);
  const int q0 = iq * BT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair

  // the kv tiles this q tile sees: all, or up to the causal diagonal
  const int q_first = p.q_start + q0;
  const int q_last = p.q_start + min(q0 + BT, p.s_q) - 1;
  int nk = (p.s_kv + BT - 1) / BT;
  if (p.causal) nk = q_last < 0 ? 0 : min(nk, q_last / BT + 1);

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  const __nv_bfloat16* kb = p.k + ib * p.k_sb + ihk * p.k_sh;
  const __nv_bfloat16* vb = p.v + ib * p.v_sb + ihk * p.v_sh;
  auto prefetch = [&](int jt, int s) {
    load_tile(sK + s * TILE, kb, p.k_ss, jt * BT, p.s_kv, tid);
    load_tile(sV + s * TILE, vb, p.v_ss, jt * BT, p.s_kv, tid);
    cp_async_commit();
  };

  if (nk > 0) {
    load_tile(sQ, p.q + ib * p.q_sb + ih * p.q_sh, p.q_ss, q0, p.s_q, tid);
    load_tile(sO, p.dout + ib * p.o_sb + ih * p.o_sh, p.o_ss, q0, p.s_q, tid);
    prefetch(0, 0);  // one commit group with q and dout
  }

  // this lane's two rows: lse (0 on a dead row) and delta
  float lse_r[2], del_r[2];
  bool dead[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + warp * 16 + g + hh * 8;
    float l = neg_inf(), dl = 0.f;
    if (qi < p.s_q) {
      const long long at = ((long long)ib * p.h + ih) * p.s_q + qi;
      l = p.lse[at];
      dl = p.delta[at];
    }
    dead[hh] = l == neg_inf();
    lse_r[hh] = dead[hh] ? 0.f : l;
    del_r[hh] = dl;
  }
  const int row_pos0 = q_first + warp * 16 + g;

  for (int jt = 0; jt < nk; ++jt) {
    const int kv0 = jt * BT;
    const int stage = jt & 1;
    if (jt + 1 < nk) {
      prefetch(jt + 1, stage ^ 1);
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

    // p and ds in registers (s is overwritten with ds)
    const int kv_last = kv0 + BT - 1;
    const bool masked = (p.causal && kv_last > q_first) || kv_last >= p.s_kv;
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int col = kv0 + n * 8 + 2 * t + (e & 1);
        bool bad = dead[hh];
        if (masked)
          bad = bad || col >= p.s_kv ||
                (p.causal && col > row_pos0 + hh * 8);
        const float pv = bad ? 0.f : expf(s[n][e] * p.scale - lse_r[hh]);
        s[n][e] = pv * (dp[n][e] - del_r[hh]) * p.scale;
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
        ldsm_x4_t(b, bt_addr(tK, kc * 16, dpi * 16, lane, LD));
        mma_bf16(dq[2 * dpi], a, b[0], b[1]);
        mma_bf16(dq[2 * dpi + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next tile overwrites this stage
  }

  // write dq once (0 for rows that saw no tile)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + warp * 16 + g + hh * 8;
    if (qi >= p.s_q) continue;
    float* row = p.dq + ib * p.dq_sb + (long long)qi * p.dq_ss + ih * p.dq_sh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + n * 8 + 2 * t) =
          make_float2(dq[n][2 * hh], dq[n][2 * hh + 1]);
  }
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   float* dq, const long long* dims, float scale) {
  // dims: b, h, h_kv, s_q, s_kv, then (batch, seq, head) strides of q, k,
  // v, dout, dq and dk (unused here), q_start, causal
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.h = (int)dims[1];
  p.h_kv = (int)dims[2];
  p.s_q = (int)dims[3];
  p.s_kv = (int)dims[4];
  long long* st[15] = {&p.q_sb, &p.q_ss, &p.q_sh, &p.k_sb,  &p.k_ss,
                       &p.k_sh, &p.v_sb, &p.v_ss, &p.v_sh,  &p.o_sb,
                       &p.o_ss, &p.o_sh, &p.dq_sb, &p.dq_ss, &p.dq_sh};
  for (int i = 0; i < 15; ++i) *st[i] = dims[5 + i];
  p.q_start = (int)dims[23];
  p.causal = (int)dims[24];
  p.scale = scale;
  return p;
}

template <typename K>
int launch(K kern, dim3 grid, int smem, const Params& p,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (grid.x == 0) return 0;  // an empty sequence: nothing to write
  kern<<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// the C signature of every backward entry point (dk, dv null here)
#define LCA_BWD_ARGS                                                         \
  const void *q, const void *k, const void *v, const void *dout,             \
      const float *lse, const float *delta, float *dq, float *dk, float *dv, \
      const long long *dims, float scale, void *stream

extern "C" int lca_flash_bwd_dq(LCA_BWD_ARGS) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, dims, scale);
  const dim3 grid((p.s_q + BT - 1) / BT, p.h, (unsigned)dims[0]);
  return launch(flash_bwd_dq_kernel, grid, DQ_SMEM, p,
                static_cast<cudaStream_t>(stream));
}

extern "C" const char* lca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
