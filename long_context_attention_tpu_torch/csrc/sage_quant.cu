// Sage attention's quantization pass on Hopper: int8 q, k, v per token in
// one sweep over device memory, with q's lse shift.
//
// The counterpart of the XLA fusion of long_context_attention_tpu/ops/sage.py
// ("Quantization pass (fused XLA, one sweep over HBM)": _quant_per_token, the
// K centring of sage_quantize_kv, the fold of scale*log2e into q's scales and
// the K-centring lse shift of sage_attention); no Pallas kernel.
//   lca_sage_quant_kv: K (centred by the given fp32 mean over its tokens) and
//                      V, one launch;
//   lca_sage_quant_q:  q, with scale*log2e folded into its scales and, given
//                      K's mean, each row's lse shift scale * (q . k_mean).
//
// Per row of d = 128 (one token of one head), as the plain version
// (ops/sage.py _quant_per_token), bit for bit: x in fp32 (k: x - k_mean in
// fp32), s = max|x| / 127 (IEEE division), v = rint(x / max(s, 1e-30)) (IEEE
// division, half to even) clamped to [-127, 127]. q's stored scale is s *
// qfold, one fp32 product; the shift is scale * (sum of q . k_mean in fp32),
// summed in another order than the plain version's einsum.
//
// What bounds it on an H100: bytes. Each element is read once (bf16) and
// written once (int8), with 4 bytes of scale (and shift) per row: at b=4,
// s=8192, 16/8 heads, d=128, 256 MiB read and 128 MiB written, 0.12 ms at
// 3.35 TB/s (K's mean, a torch reduction, reads K once more). The torch
// passes it replaces made an fp32 copy of each input and ten more sweeps.
//
// Design: half a warp per row, 8 elements (16 bytes) per lane, the absmax
// by shuffles within the half, each lane storing its 8 int8 values as one
// 8-byte word; a warp takes two row pairs and issues both pairs' loads
// before it computes. Rows are numbered in the scales' (batch, head,
// token) order, so neighbouring rows store neighbouring scales. Values are
// written (b, s, h, 128) contiguous, scales and shifts (b, h, s)
// contiguous: the layouts the sage kernels read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int WARPS = 8;   // warps per block
constexpr int STEPS = 2;   // row pairs per warp, their loads issued first
constexpr int ROWS_PER_WARP = 2 * STEPS;
constexpr unsigned FULL = 0xffffffffu;

struct Row {
  float x[8];
};

// 8 bf16 -> fp32 (exact)
__device__ __forceinline__ Row unpack(const uint4& w) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  Row r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r.x[2 * i] = __uint_as_float(u[i] << 16);
    r.x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
  return r;
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* src, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
}

// sum or max over the 16 lanes of a half-warp (the lanes of one row)
__device__ __forceinline__ float half_max(float m) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  return m;
}

__device__ __forceinline__ float half_sum(float m) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) m += __shfl_xor_sync(FULL, m, o);
  return m;
}

// Quantize a row held by a half-warp, 8 elements a lane (hl: the lane in
// the half): store its lane's 8 int8 values at dst (when `store`) and
// return the row's scale max|x| / 127. Every lane of the warp calls it.
__device__ __forceinline__ float quant_row(const Row& r, int8_t* dst, int hl,
                                           bool store) {
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(r.x[i]));
  m = half_max(m);
  const float s = __fdiv_rn(m, 127.f);
  const float safe = fmaxf(s, 1e-30f);
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float v =
        fminf(fmaxf(rintf(__fdiv_rn(r.x[i], safe)), -127.f), 127.f);
    packed[i >> 2] |= (uint32_t)(uint8_t)(int8_t)(int)v << (8 * (i & 3));
  }
  if (store)
    *reinterpret_cast<uint2*>(dst + 8 * hl) =
        make_uint2(packed[0], packed[1]);
  return s;
}

__device__ __forceinline__ void load_mean(const float* mean, int hl,
                                          float (&m)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(mean + 8 * hl);
  const float4 b = *reinterpret_cast<const float4*>(mean + 8 * hl + 4);
  m[0] = a.x, m[1] = a.y, m[2] = a.z, m[3] = a.w;
  m[4] = b.x, m[5] = b.y, m[6] = b.z, m[7] = b.w;
}

// row r of (b, h, s) in the scales' order -> (batch, head, token)
struct RowAt {
  int ib, ih, t;
  __device__ RowAt(long long r, int s, int h) {
    t = (int)(r % s);
    ih = (int)((r / s) % h);
    ib = (int)(r / ((long long)s * h));
  }
};

struct KvParams {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* k_mean;  // (b, h_kv, d)
  int8_t* k8;
  int8_t* v8;
  float* ks;
  float* vs;
  int b, s, h;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // element strides
};

// rows [0, n) are K's, [n, 2n) V's; a warp's lanes 0-15 and 16-31 take a
// row each, STEPS times
__global__ void __launch_bounds__(32 * WARPS)
    sage_quant_kv_kernel(const KvParams p) {
  const long long n = (long long)p.b * p.h * p.s;
  const int lane = threadIdx.x & 31, hl = lane & 15;
  const long long first =
      ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * ROWS_PER_WARP +
      (lane >> 4);
  uint4 w[STEPS];
#pragma unroll
  for (int u = 0; u < STEPS; ++u) {
    const long long row = first + 2 * u;
    const bool is_v = row >= n;
    const RowAt a(is_v ? row - n : row, p.s, p.h);
    const __nv_bfloat16* src =
        is_v ? p.v + a.ib * p.v_sb + a.t * p.v_ss + a.ih * p.v_sh
             : p.k + a.ib * p.k_sb + a.t * p.k_ss + a.ih * p.k_sh;
    w[u] = load16(src + 8 * hl, row < 2 * n);
  }
#pragma unroll
  for (int u = 0; u < STEPS; ++u) {
    const long long row = first + 2 * u;
    const bool is_v = row >= n;
    const long long r = is_v ? row - n : row;
    const RowAt a(r, p.s, p.h);
    Row x = unpack(w[u]);
    if (!is_v) {
      float m[8];
      load_mean(p.k_mean + ((long long)a.ib * p.h + a.ih) * D, hl, m);
#pragma unroll
      for (int i = 0; i < 8; ++i) x.x[i] -= m[i];
    }
    const long long out = (((long long)a.ib * p.s + a.t) * p.h + a.ih) * D;
    const bool ok = row < 2 * n;
    const float s = quant_row(x, (is_v ? p.v8 : p.k8) + out, hl, ok);
    if (ok && hl == 0) (is_v ? p.vs : p.ks)[r] = s;
  }
}

struct QParams {
  const __nv_bfloat16* q;
  const float* k_mean;  // (b, h_kv, d), or null: no shift
  int8_t* q8;
  float* qs;
  float* shift;
  int b, s, h, h_kv;
  long long q_sb, q_ss, q_sh;
  float qfold;  // scale * log2 e
  float scale;  // the softmax scale
};

__global__ void __launch_bounds__(32 * WARPS)
    sage_quant_q_kernel(const QParams p) {
  const long long n = (long long)p.b * p.h * p.s;
  const int lane = threadIdx.x & 31, hl = lane & 15;
  const long long first =
      ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * ROWS_PER_WARP +
      (lane >> 4);
  uint4 w[STEPS];
#pragma unroll
  for (int u = 0; u < STEPS; ++u) {
    const long long r = first + 2 * u;
    const RowAt a(r < n ? r : 0, p.s, p.h);
    w[u] = load16(p.q + a.ib * p.q_sb + a.t * p.q_ss + a.ih * p.q_sh + 8 * hl,
                  r < n);
  }
#pragma unroll
  for (int u = 0; u < STEPS; ++u) {
    const long long r = first + 2 * u;
    const bool ok = r < n;
    const RowAt a(ok ? r : 0, p.s, p.h);
    const Row x = unpack(w[u]);
    const float s = quant_row(
        x, p.q8 + (((long long)a.ib * p.s + a.t) * p.h + a.ih) * D, hl, ok);
    if (ok && hl == 0) p.qs[r] = s * p.qfold;
    if (p.k_mean != nullptr) {
      const int ihk = a.ih / (p.h / p.h_kv);
      float m[8];
      load_mean(p.k_mean + ((long long)a.ib * p.h_kv + ihk) * D, hl, m);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) dot += x.x[i] * m[i];
      dot = half_sum(dot);
      if (ok && hl == 0) p.shift[r] = p.scale * dot;
    }
  }
}

int blocks(long long rows) {
  const long long per = (long long)WARPS * ROWS_PER_WARP;
  return (int)((rows + per - 1) / per);
}

}  // namespace

// K (centred by k_mean) and V: bf16 (b, s, h_kv, 128) by strides with a unit
// stride along d, k_mean fp32 (b, h_kv, 128) contiguous -> k8, v8 int8 (b, s,
// h_kv, 128) and ks, vs fp32 (b, h_kv, s), contiguous. dims: b, s, h_kv, k
// strides (b, s, h), v strides (b, s, h).
extern "C" int lca_sage_quant_kv(const void* k, const void* v,
                                 const float* k_mean, void* k8, float* ks,
                                 void* v8, float* vs, const long long* dims,
                                 void* stream) {
  KvParams p;
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.k_mean = k_mean;
  p.k8 = static_cast<int8_t*>(k8);
  p.v8 = static_cast<int8_t*>(v8);
  p.ks = ks;
  p.vs = vs;
  p.b = (int)dims[0];
  p.s = (int)dims[1];
  p.h = (int)dims[2];
  p.k_sb = dims[3];
  p.k_ss = dims[4];
  p.k_sh = dims[5];
  p.v_sb = dims[6];
  p.v_ss = dims[7];
  p.v_sh = dims[8];
  const long long rows = 2LL * p.b * p.h * p.s;
  if (rows == 0) return (int)cudaSuccess;
  sage_quant_kv_kernel<<<blocks(rows), 32 * WARPS, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// q: bf16 (b, s, h, 128) by strides with a unit stride along d -> q8 int8
// (b, s, h, 128) and qs fp32 (b, h, s) (times qfold), contiguous; with
// k_mean (b, h_kv, 128) fp32 also shift fp32 (b, h, s). dims: b, s, h, h_kv,
// q strides (b, s, h).
extern "C" int lca_sage_quant_q(const void* q, const float* k_mean, void* q8,
                                float* qs, float* shift, const long long* dims,
                                float qfold, float scale, void* stream) {
  QParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k_mean = k_mean;
  p.q8 = static_cast<int8_t*>(q8);
  p.qs = qs;
  p.shift = shift;
  p.b = (int)dims[0];
  p.s = (int)dims[1];
  p.h = (int)dims[2];
  p.h_kv = (int)dims[3];
  p.q_sb = dims[4];
  p.q_ss = dims[5];
  p.q_sh = dims[6];
  p.qfold = qfold;
  p.scale = scale;
  if (p.h_kv <= 0 || p.h % p.h_kv || (k_mean != nullptr) != (shift != nullptr))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)p.b * p.h * p.s;
  if (rows == 0) return (int)cudaSuccess;
  sage_quant_q_kernel<<<blocks(rows), 32 * WARPS, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* lca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
