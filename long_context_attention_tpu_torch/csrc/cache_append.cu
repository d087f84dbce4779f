// In-place KV-cache append for Hopper (sm_90a).
//
// Replaces the TPU kernel long_context_attention_tpu/ops/decode.py
// _append_kernel (wrapper cache_append) for the dense cache, layered or not:
// token t of row b's new run lands at slot append_pos[b] + t, and only when
// that slot lies in [0, s_max) -- a negative or out-of-range position
// writes nothing.
//
// What bounds it on an H100: the bytes it writes (h_kv*d values and h_kv
// scales per token and tensor, a few KB per decode step), far below what
// one launch costs, so in practice it is bound by launch latency.
//
// Design: one 128-thread block per (row, token); all h_kv heads of the
// token ride one block, as on the TPU. 16-byte copies, no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  void* k;           // (L, b, h_kv, s_max, row_bytes)
  void* v;
  const void* kn;    // (b, h_kv, n, row_bytes)
  const void* vn;
  float* ks;         // (L, b, h_kv, 1, s_max) or null
  float* vs;
  const float* ksn;  // (b, h_kv, n)
  const float* vsn;
  const int* pos;    // (b,)
  int b, h_kv, n, s_max, layer, row_bytes;
};

__global__ void __launch_bounds__(128) append_kernel(const Params p) {
  const int ib = blockIdx.x, it = blockIdx.y;
  const int slot = p.pos[ib] + it;
  if (slot < 0 || slot >= p.s_max) return;
  const int chunks = p.row_bytes / 16;
  const long long slab = ((long long)p.layer * p.b + ib) * p.h_kv;
  for (int c = threadIdx.x; c < p.h_kv * chunks; c += blockDim.x) {
    const int hh = c / chunks, cc = c % chunks;
    const long long dst =
        ((slab + hh) * p.s_max + slot) * p.row_bytes + cc * 16;
    const long long src =
        (((long long)ib * p.h_kv + hh) * p.n + it) * p.row_bytes + cc * 16;
    *reinterpret_cast<uint4*>(static_cast<char*>(p.k) + dst) =
        *reinterpret_cast<const uint4*>(static_cast<const char*>(p.kn) + src);
    *reinterpret_cast<uint4*>(static_cast<char*>(p.v) + dst) =
        *reinterpret_cast<const uint4*>(static_cast<const char*>(p.vn) + src);
  }
  if (p.ks != nullptr && (int)threadIdx.x < p.h_kv) {
    const int hh = threadIdx.x;
    const long long dst = (slab + hh) * p.s_max + slot;
    const long long src = ((long long)ib * p.h_kv + hh) * p.n + it;
    p.ks[dst] = p.ksn[src];
    p.vs[dst] = p.vsn[src];
  }
}

}  // namespace

// dims: b, h_kv, n, s_max, layer, row_bytes
extern "C" int lca_cache_append(void* k, void* v, const void* kn,
                                const void* vn, float* ks, float* vs,
                                const float* ksn, const float* vsn,
                                const int* pos, const long long* dims,
                                void* stream) {
  Params p;
  p.k = k;
  p.v = v;
  p.kn = kn;
  p.vn = vn;
  p.ks = ks;
  p.vs = vs;
  p.ksn = ksn;
  p.vsn = vsn;
  p.pos = pos;
  p.b = (int)dims[0];
  p.h_kv = (int)dims[1];
  p.n = (int)dims[2];
  p.s_max = (int)dims[3];
  p.layer = (int)dims[4];
  p.row_bytes = (int)dims[5];
  dim3 grid(p.b, p.n);
  append_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* lca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
