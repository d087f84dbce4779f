// Sage attention forward without a mask for Hopper (sm_90a) on mma.sync.
// The flash forwards (B1, B3 and B4) are wgmma/TMA kernels in
// flash_fwd_sm90.cu, and the causal and global-position sage forwards (B8a,
// B8b) in sage_fwd_sm90.cu.
//
// Replaces the TPU kernel of long_context_attention_tpu/ops/sage.py (shared
// step _sage_compute, emit _emit):
//   lca_sage_fwd_rect <- _sage_kernel_rect: no mask, any s_q and s_kv.
// Inputs are int8 q, k, v with fp32 per-token scales (the quantization
// pass, sage_quant.cu; q's scales carry scale*log2e). s = (q8 . k8)_s32 *
// qs * ks in exp2 units, p = exp2(min(s, 90)) with no running max, l +=
// rowsum(p) before p *= vs, acc += bf16(p) @ bf16(v8); out = acc / l, lse =
// ln l.
//
// What bounds it on an H100: tensor-core operations, 2*d int8 ops (QK, 1979
// TOP/s) and 2*d bf16 FLOPs (PV, 989 TFLOP/s) per visible pair.
//
// Design: one 128-thread block per (q tile of 64 rows, head, batch row);
// each warp owns 16 q rows. QK runs on mma.sync m16n8k32 s8 (ldmatrix's b16
// view loads both int8 operands from row-major tiles), whose s32
// accumulator has the fp32 fragment layout of m16n8k16, so the scores stay
// in registers and become the A operand of the bf16 PV product (mma.sync
// m16n8k16), as in FlashAttention-2. K, V and their scales arrive by
// cp.async into a double buffer, so the next tile loads while this one
// computes. V is int8 in memory (half the bf16 bytes) and widened to bf16
// in shared memory per tile. No TMA or wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int NTHREADS = 128;
constexpr int LD = D + 8;  // bf16 pitch of q/k/v tiles: the 8 rows of an
                           // ldmatrix land in distinct banks
constexpr float kClamp = 90.f;
constexpr float kNegInf = -1e30f;

union Pack16 {  // 16 bytes as 8 bf16 bit patterns or 16 int8 values
  uint4 u;
  unsigned short h[8];
  int8_t b[16];
};

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

// ---------------------------------------------------------------------------
// Sage: int8 QK^T on the int8 tensor cores, max-free exp2 softmax, bf16 PV
// ---------------------------------------------------------------------------

constexpr int LD8 = D + 16;  // byte pitch of the int8 q and k tiles: the 8
                             // rows of an ldmatrix land in distinct banks
constexpr int S_K8 = BQ * LD8;                // after the q8 tile
constexpr int S_V8 = S_K8 + 2 * BKV * LD8;    // 2 stages of k8, then of v8
constexpr int S_VW = S_V8 + 2 * BKV * D;      // v widened to bf16
constexpr int S_SC = S_VW + BKV * LD * 2;     // 2 stages of k, v scales
constexpr int SAGE_SMEM = S_SC + 4 * BKV * 4;

struct SageParams {
  const int8_t* q;   // (b, s_q, h, d) int8
  const float* qs;   // (b, h, s_q) per-row scales, scale*log2e folded in
  const int8_t* k;   // (b, s_kv, h_kv, d) int8
  const float* ks;   // (b, h_kv, s_kv)
  const int8_t* v;
  const float* vs;
  void* out;         // (b, s_q, h, d) bf16
  float* lse;        // (b, h, s_q)
  int h, h_kv, s_q, s_kv;
  long long q_sb, q_ss, q_sh;  // element strides (batch, seq, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long qs_sb, qs_sh, qs_ss;  // scale strides (batch, head, seq)
  long long ks_sb, ks_sh, ks_ss;
  long long vs_sb, vs_sh, vs_ss;
};

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

// c += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulate: the
// accumulator fragment has the layout of mma_bf16's fp32 one
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Every q row sees every kv column; the last tile is cut at s_kv.
__global__ void __launch_bounds__(NTHREADS)
    sage_fwd_kernel(const SageParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sQ = smem;
  unsigned short* sV = reinterpret_cast<unsigned short*>(smem + S_VW);
  float* sSc = reinterpret_cast<float*>(smem + S_SC);  // [stage][k, v][BKV]

  const int iq = blockIdx.x;
  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int ihk = ih / (p.h / p.h_kv);
  const int q0 = iq * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int nk = (p.s_kv + BKV - 1) / BKV;

  const int8_t* kb = p.k + ib * p.k_sb + ihk * p.k_sh;
  const int8_t* vb = p.v + ib * p.v_sb + ihk * p.v_sh;
  const float* ksb = p.ks + ib * p.ks_sb + ihk * p.ks_sh;
  const float* vsb = p.vs + ib * p.vs_sb + ihk * p.vs_sh;
  auto issue = [&](int jt, int s) {
    const int kv0 = jt * BKV;
    unsigned char* dk = smem + S_K8 + s * BKV * LD8;
    unsigned char* dv = smem + S_V8 + s * BKV * D;
    for (int c = tid; c < BKV * (D / 16); c += NTHREADS) {
      const int r = c / (D / 16), col = (c % (D / 16)) * 16;
      const bool ok = kv0 + r < p.s_kv;
      const long long rr = ok ? kv0 + r : 0;
      cp_async16(smem_addr(dk + r * LD8 + col), kb + rr * p.k_ss + col, ok);
      cp_async16(smem_addr(dv + r * D + col), vb + rr * p.v_ss + col, ok);
    }
    if (tid < BKV) {
      const bool ok = kv0 + tid < p.s_kv;
      const long long j = ok ? kv0 + tid : 0;
      cp_async4(smem_addr(sSc + (2 * s) * BKV + tid), ksb + j * p.ks_ss, ok);
      cp_async4(smem_addr(sSc + (2 * s + 1) * BKV + tid), vsb + j * p.vs_ss,
                ok);
    }
    cp_async_commit();
  };
  if (nk > 0) issue(0, 0);

  // the q8 tile, and the per-row scales of this lane's rows g and g + 8
  const int8_t* qb = p.q + ib * p.q_sb + ih * p.q_sh;
  for (int c = tid; c < BQ * (D / 16); c += NTHREADS) {
    const int r = c / (D / 16), col = (c % (D / 16)) * 16;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < p.s_q)
      val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * p.q_ss +
                                            col);
    *reinterpret_cast<uint4*>(sQ + r * LD8 + col) = val;
  }
  float qsr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + warp * 16 + g + hh * 8;
    qsr[hh] = qi < p.s_q ? p.qs[ib * p.qs_sb + ih * p.qs_sh +
                                (long long)qi * p.qs_ss]
                         : 0.f;
  }
  __syncthreads();

  // the warp's 16 q rows as A fragments: d = 128 is four k32 steps
  unsigned qa[D / 32][4];
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk)
    ldsm_x4(qa[kk], smem_addr(sQ + (warp * 16 + (lane & 15)) * LD8 + kk * 32 +
                              (lane >> 4) * 16));

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float l_row[2] = {0.f, 0.f};
  const int mi = lane >> 3;

  for (int jt = 0; jt < nk; ++jt) {
    const int kv0 = jt * BKV;
    const int stage = jt & 1;
    if (jt + 1 < nk) {
      issue(jt + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // widen the v8 tile to bf16 (exact) for the bf16 PV product
    const unsigned char* rv = smem + S_V8 + stage * BKV * D;
    for (int c = tid; c < BKV * (D / 16); c += NTHREADS) {
      const int r = c / (D / 16), col = (c % (D / 16)) * 16;
      Pack16 vq, v0, v1;
      vq.u = *reinterpret_cast<const uint4*>(rv + r * D + col);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v0.h[i] = float_to_bf16_bits((float)vq.b[i]);
        v1.h[i] = float_to_bf16_bits((float)vq.b[8 + i]);
      }
      *reinterpret_cast<uint4*>(sV + r * LD + col) = v0.u;
      *reinterpret_cast<uint4*>(sV + r * LD + col + 8) = v1.u;
    }
    __syncthreads();
    const unsigned char* sK = smem + S_K8 + stage * BKV * LD8;
    const float* sKs = sSc + (2 * stage) * BKV;
    const float* sVs = sKs + BKV;

    // S = Q8 K8^T, exact in s32: 8 n-tiles of 8 kv columns
    int acc[BKV / 8][4];
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
#pragma unroll
      for (int np = 0; np < BKV / 16; ++np) {
        unsigned b[4];  // b0, b1 of n-tile 2np, then of n-tile 2np + 1
        ldsm_x4(b, smem_addr(sK + (np * 16 + (lane & 7) + (mi >> 1) * 8) * LD8 +
                             kk * 32 + (mi & 1) * 16));
        mma_s8(acc[2 * np], qa[kk], b[0], b[1]);
        mma_s8(acc[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }

    // s = s32 * q scale * k scale (exp2 units), columns past s_kv masked,
    // p = exp2(min(s, 90)); l sums p before V's scale multiplies it
    // (_sage_compute)
    const bool interior = kv0 + BKV <= p.s_kv;
    float sp[BKV / 8][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = n * 8 + 2 * t + (e & 1);
        float v = (float)acc[n][e] * qsr[e >> 1] * sKs[cl];
        if (!interior && kv0 + cl >= p.s_kv) v = kNegInf;
        const float pv = exp2f(fminf(v, kClamp));
        rs[e >> 1] += pv;
        sp[n][e] = pv * sVs[cl];
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
      l_row[hh] += rs[hh];
    }

    // O += bf16(P) V, the score fragments as the A operand
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      unsigned pa[4];
      pa[0] = pack_bf16(sp[2 * kc][0], sp[2 * kc][1]);
      pa[1] = pack_bf16(sp[2 * kc][2], sp[2 * kc][3]);
      pa[2] = pack_bf16(sp[2 * kc + 1][0], sp[2 * kc + 1][1]);
      pa[3] = pack_bf16(sp[2 * kc + 1][2], sp[2 * kc + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned b[4];
        ldsm_x4_t(b, smem_addr(sV + (kc * 16 + (lane & 7) + (mi & 1) * 8) * LD +
                               dp * 16 + (mi >> 1) * 8));
        mma_bf16(o[2 * dp], pa, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // the next tile overwrites this stage and sV
  }

  // emit (_emit): out = acc / l, lse = log l; a dead row gives 0 and -inf
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + warp * 16 + g + hh * 8;
    if (qi >= p.s_q) continue;
    const float l = l_row[hh];
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.out) + ib * p.o_sb +
                          (long long)qi * p.o_ss + ih * p.o_sh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = l == 0.f ? 0.f : o[n][2 * hh] / l;
      const float x1 = l == 0.f ? 0.f : o[n][2 * hh + 1] / l;
      *reinterpret_cast<unsigned*>(orow + n * 8 + 2 * t) = pack_bf16(x0, x1);
    }
    if (t == 0)
      p.lse[((long long)ib * p.h + ih) * p.s_q + qi] =
          l == 0.f ? __int_as_float(0xff800000) : logf(l);
  }
}

SageParams make_sage_params(const void* q, const float* qs, const void* k,
                            const float* ks, const void* v, const float* vs,
                            void* out, float* lse, const long long* dims) {
  // dims: b, h, h_kv, s_q, s_kv, q strides (b, s, h), k strides (b, s, h),
  // v strides (b, s, h), out strides (b, s, h), q, k and v scale strides
  // (b, h, s) (then the position entries' q_off, left, right, sink, unused)
  SageParams p;
  p.q = static_cast<const int8_t*>(q);
  p.qs = qs;
  p.k = static_cast<const int8_t*>(k);
  p.ks = ks;
  p.v = static_cast<const int8_t*>(v);
  p.vs = vs;
  p.out = out;
  p.lse = lse;
  p.h = (int)dims[1];
  p.h_kv = (int)dims[2];
  p.s_q = (int)dims[3];
  p.s_kv = (int)dims[4];
  long long* st[] = {&p.q_sb,  &p.q_ss,  &p.q_sh,  &p.k_sb,  &p.k_ss,
                     &p.k_sh,  &p.v_sb,  &p.v_ss,  &p.v_sh,  &p.o_sb,
                     &p.o_ss,  &p.o_sh,  &p.qs_sb, &p.qs_sh, &p.qs_ss,
                     &p.ks_sb, &p.ks_sh, &p.ks_ss, &p.vs_sb, &p.vs_sh,
                     &p.vs_ss};
  for (int i = 0; i < 21; ++i) *st[i] = dims[5 + i];
  return p;
}

int launch_sage(const void* q, const float* qs, const void* k,
                const float* ks, const void* v, const float* vs, void* out,
                float* lse, const long long* dims, void* stream) {
  const SageParams p = make_sage_params(q, qs, k, ks, v, vs, out, lse, dims);
  if (p.h_kv <= 0 || p.h % p.h_kv) return (int)cudaErrorInvalidValue;
  auto kern = sage_fwd_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SAGE_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.s_q + BQ - 1) / BQ, p.h, (int)dims[0]);
  kern<<<grid, NTHREADS, SAGE_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel B8c: sage attention over int8 q, k, v with fp32 per-token scales
// (q's with scale*log2e folded in), no mask (every kv column of every row),
// any s_q and s_kv. The signature of the sage entry points: q8, qs, k8, ks,
// v8, vs, out, lse, dims (make_sage_params), stream.
extern "C" int lca_sage_fwd_rect(const void* q, const float* qs,
                                 const void* k, const float* ks,
                                 const void* v, const float* vs, void* out,
                                 float* lse, const long long* dims,
                                 void* stream) {
  return launch_sage(q, qs, k, ks, v, vs, out, lse, dims, stream);
}

extern "C" const char* lca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
