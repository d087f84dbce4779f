"""Plain versions of the decode kernels B6 (cache append) and B7 (decode
attention) against the JAX package's Pallas kernels (interpret mode) on the
same numpy inputs, with the layer-stacked cache the serving loop uses.

Tolerances:
* cache_append is a copy: exact.
* decode attention, bf16 out 2e-2 / lse 1e-4: the int8 path's integer
  products (q8.k8 and p8.v8) are exact on both sides and the fp32 steps run
  in the same order, but exp2 and the tile sums differ in the last fp32
  bits, which can flip a rint of P at a .5 boundary (one P level of 1/127
  of the row max) or the final bf16 rounding (one bf16 ulp, 2^-8 relative,
  of outputs |x| < 4). The bf16 path's PV product differs only by fp32
  summation order before the same bf16 output rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu.ops import decode as jdec
from long_context_attention_tpu.ops import kv_cache as jkv
from long_context_attention_tpu_torch.ops import decode as tdec
from long_context_attention_tpu_torch.ops import kv_cache as tkv

torch.set_num_threads(1)

L, B, HKV, G, D = 2, 3, 2, 2, 32
OUT_TOL = dict(atol=2e-2, rtol=0)
LSE_TOL = dict(atol=1e-4, rtol=0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _filled_cache(rng, s_max, cache_dtype):
    """A layered cache filled with random tokens, built by each package's
    own KVCache.write_prompt from the same numpy values."""
    jc = jkv.KVCache.init(L, B, s_max, HKV, D, cache_dtype)
    tc = tkv.KVCache.init(L, B, s_max, HKV, D, cache_dtype, device="cpu")
    for layer in range(L):
        k = rng.standard_normal((B, s_max, HKV, D)).astype(np.float32)
        v = rng.standard_normal((B, s_max, HKV, D)).astype(np.float32)
        jc = jc.write_prompt(layer, jnp.asarray(k), jnp.asarray(v))
        tc.write_prompt(layer, torch.from_numpy(k), torch.from_numpy(v))
    return jc, tc


def _scales(c):
    return (None, None) if c.k_scale is None else (c.k_scale, c.v_scale)


@pytest.mark.parametrize("cache_dtype", ["int8", "bfloat16"])
def test_cache_append_exact(rng, cache_dtype):
    """One token per row into layer 1 at per-row slots; the row at -1
    writes nothing, the row at s_max - 1 writes the last slot. The port
    writes in place and returns the same tensors."""
    s_max = 128
    jc, tc = _filled_cache(rng, s_max, cache_dtype)
    k = rng.standard_normal((B, HKV, 1, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, 1, D)).astype(np.float32)
    jk, jks = jkv.quantize_kv(jnp.asarray(k), cache_dtype)
    jv, jvs = jkv.quantize_kv(jnp.asarray(v), cache_dtype)
    tk, tks = tkv.quantize_kv(torch.from_numpy(k), cache_dtype)
    tv, tvs = tkv.quantize_kv(torch.from_numpy(v), cache_dtype)
    pos = np.array([5, -1, s_max - 1], np.int32)
    before = [t.clone() for t in (tc.k, tc.v)]
    jres = jdec.cache_append(jc.k, jc.v, jk, jv, jnp.asarray(pos),
                             *_scales(jc), jks, jvs, layer=jnp.int32(1))
    tres = tdec.cache_append(tc.k, tc.v, tk, tv, torch.from_numpy(pos),
                             *_scales(tc), tks, tvs, layer=1)
    assert tres[0] is tc.k and tres[1] is tc.v
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(_np(b), _np(a))
    # the skipped row and the other layer are untouched
    np.testing.assert_array_equal(_np(tc.k[:, 1]), _np(before[0][:, 1]))
    np.testing.assert_array_equal(_np(tc.v[0]), _np(before[1][0]))


@pytest.mark.parametrize("safe", [False, True], ids=["fast", "safe"])
@pytest.mark.parametrize("cache_dtype", ["int8", "bfloat16"])
def test_decode_attention_matches_jax(rng, cache_dtype, safe):
    """Layered decode over ragged per-row lengths (1, 77, 128) of a
    128-slot cache: one kv tile on both sides, so the int8 path quantizes P
    over the same columns (mxu_int8, the default)."""
    s_max = 128
    jc, tc = _filled_cache(rng, s_max, cache_dtype)
    q = rng.standard_normal((B, HKV * G, D)).astype(np.float32)
    lens = np.array([1, 77, 128], np.int32)
    jo, jl = jdec.decode_attention(
        jnp.asarray(q, jnp.bfloat16), jc.k, jc.v, jnp.asarray(lens),
        *_scales(jc), layer=jnp.int32(1), return_lse=True,
        safe_softmax=safe)
    to, tl = tdec.decode_attention(
        torch.from_numpy(q).to(torch.bfloat16), tc.k, tc.v,
        torch.from_numpy(lens), *_scales(tc), layer=1, return_lse=True,
        safe_softmax=safe)
    assert to.dtype == torch.bfloat16 and to.shape == (B, HKV * G, D)
    np.testing.assert_allclose(_np(to), _np(jo), **OUT_TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **LSE_TOL)


def test_decode_attention_tiles_match_jax(rng):
    """int8 cache of 512 slots with block_kv=128 on both sides: four P
    requantization tiles, rows ending inside the first, third and last."""
    s_max = 512
    jc, tc = _filled_cache(rng, s_max, "int8")
    q = rng.standard_normal((B, HKV * G, D)).astype(np.float32)
    lens = np.array([100, 300, 512], np.int32)
    jo, jl = jdec.decode_attention(
        jnp.asarray(q, jnp.bfloat16), jc.k, jc.v, jnp.asarray(lens),
        jc.k_scale, jc.v_scale, layer=jnp.int32(0), block_kv=128,
        return_lse=True)
    to, tl = tdec.decode_attention(
        torch.from_numpy(q).to(torch.bfloat16), tc.k, tc.v,
        torch.from_numpy(lens), tc.k_scale, tc.v_scale, layer=0,
        block_kv=128, return_lse=True)
    np.testing.assert_allclose(_np(to), _np(jo), **OUT_TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **LSE_TOL)


def test_reference_block_kv_matches_jax_rule():
    """The port picks the JAX package's kv tile (it decides the int8 P
    quantization): 2048 for int8 and 1024 for bf16 at the serving model's
    8 kv heads x 128 dims, and the cache length when that is shorter."""
    assert tdec.reference_block_kv(4096, 12288, 8, 2, 128, 1) == 2048
    assert tdec.reference_block_kv(4096, 12288, 8, 2, 128, 2) == 1024
    assert tdec.reference_block_kv(4096, 128, 2, 2, 32, 1) == 128
