"""Plain versions of the flash kernels B1 (causal self-attention) and B3
(global positions against a bf16 or int8 cache) against the JAX package's
Pallas kernels (interpret mode) and against the fp32 oracle, on the same
numpy inputs.

Tolerances:
* fp32 inputs, 1e-5: both sides compute the same fp32 arithmetic; only the
  summation order and exp/log implementations differ (~1e-6 relative).
* bf16 inputs, 2e-2: the fast form folds scale*log2e into q with one bf16
  rounding and casts p to bf16 before the PV product on both sides; a score
  that lands on a bf16 rounding boundary can round the other way when the
  fp32 sums run in another order, which moves an output by up to one bf16
  ulp (2^-8 relative; outputs here are |x| < 4).
* int8 cache vs the fp32 oracle over the dequantized cache, 5e-2: the
  kernel computes on bf16 q and bf16 p, the oracle in fp32 (~2 bf16 ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu.ops import flash as jflash
from long_context_attention_tpu.ops import kv_cache as jkv
from long_context_attention_tpu.ops import reference as jref
from long_context_attention_tpu.utils.config import BlockSizes
from long_context_attention_tpu_torch.ops import flash as tflash
from long_context_attention_tpu_torch.ops import kv_cache as tkv
from long_context_attention_tpu_torch.ops import reference as tref

torch.set_num_threads(1)

B, S, H, HKV, D = 2, 64, 4, 2, 32
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=0)
INT8_ORACLE_TOL = dict(atol=5e-2, rtol=0)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x, dtype):
    jd, td = DTYPES[dtype]
    return (jnp.asarray(x, jd),
            torch.from_numpy(np.asarray(x, np.float32)).to(td))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(rng, s_q=S, s_kv=S):
    q = rng.standard_normal((B, s_q, H, D)).astype(np.float32)
    k = rng.standard_normal((B, s_kv, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, s_kv, HKV, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("safe", [False, True], ids=["fast", "safe"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_self_matches_jax(rng, dtype, safe):
    """B1's plain version == JAX flash_attention_fwd(causal=True), GQA g=2."""
    q, k, v = _qkv(rng)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    jo, jl = jflash.flash_attention_fwd(jq, jk, jv, causal=True,
                                        safe_softmax=safe)
    to, tl = tflash.flash_attention_fwd(tq, tk, tv, causal=True,
                                        safe_softmax=safe)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert to.dtype == tq.dtype and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), **tol)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32_TOL if
                               dtype == "float32" else dict(atol=1e-3))


@pytest.mark.parametrize("safe", [False, True], ids=["fast", "safe"])
def test_causal_self_matches_oracle(rng, safe):
    """fp32: the fast (clamped exp2) and online forms both equal the exact
    softmax for scores far inside the clamp."""
    q, k, v = _qkv(rng)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    to, tl = tflash.flash_fwd_causal_self(tq, tk, tv, scale=D ** -0.5,
                                          safe_softmax=safe)
    ro, rl = tref.xla_attention(tq, tk, tv, causal=True)
    jo, jl = jref.xla_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True)
    np.testing.assert_allclose(ro.numpy(), np.asarray(jo), **F32_TOL)
    np.testing.assert_allclose(rl.numpy(), np.asarray(jl), **F32_TOL)
    np.testing.assert_allclose(to.numpy(), ro.numpy(), **F32_TOL)
    np.testing.assert_allclose(tl.numpy(), rl.numpy(), **F32_TOL)


def _cache(rng, s_kv, cache_dtype):
    """(b, h_kv, s_kv, d) cache values (+ flat scales for int8) as both
    packages store them."""
    k = rng.standard_normal((B, HKV, s_kv, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, s_kv, D)).astype(np.float32)
    jk, jks = jkv.quantize_kv(jnp.asarray(k), cache_dtype)
    jv, jvs = jkv.quantize_kv(jnp.asarray(v), cache_dtype)
    tk, tks = tkv.quantize_kv(torch.from_numpy(k), cache_dtype)
    tv, tvs = tkv.quantize_kv(torch.from_numpy(v), cache_dtype)
    return (jk, jv, jks, jvs), (tk, tv, tks, tvs)


@pytest.mark.parametrize("safe", [False, True], ids=["fast", "safe"])
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_cache_forward_matches_jax(rng, cache_dtype, safe):
    """B3's plain version == JAX flash_attention_fwd_cache: a 32-row bf16
    chunk at q_start=48 against a 96-slot cache prefix, causal (rows see
    slots <= their global position), bf16 or int8 with per-token scales."""
    s_q, s_kv, q_start = 32, 96, 48
    q = rng.standard_normal((B, s_q, H, D)).astype(np.float32)
    jq, tq = _both(q, "bfloat16")
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _cache(rng, s_kv, cache_dtype)
    jo, jl = jflash.flash_attention_fwd_cache(
        jq, jk, jv, k_scale=jks, v_scale=jvs, q_start=q_start, causal=True,
        safe_softmax=safe)
    to, tl = tflash.flash_attention_fwd_cache(
        tq, tk, tv, k_scale=tks, v_scale=tvs, q_start=q_start, causal=True,
        safe_softmax=safe)
    np.testing.assert_allclose(_np(to), _np(jo), **BF16_TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-3)

    # and the fp32 oracle over the dequantized cache at the same positions
    kd = tkv.dequantize_kv(tk, tks, torch.float32).transpose(1, 2)
    vd = tkv.dequantize_kv(tv, tvs, torch.float32).transpose(1, 2)
    ro, rl = tref.xla_attention(
        tq.float(), kd, vd, causal=True,
        q_positions=torch.arange(s_q) + q_start, kv_positions=torch.arange(s_kv))
    np.testing.assert_allclose(_np(to), ro.numpy(), **INT8_ORACLE_TOL)
    np.testing.assert_allclose(tl.numpy(), rl.numpy(), atol=1e-2)


@pytest.mark.parametrize("safe", [False, True], ids=["fast", "safe"])
def test_cache_forward_dead_rows(rng, safe):
    """Rows at negative global positions see no cache slot under the causal
    mask: out 0, lse -inf on both sides, no NaN anywhere."""
    s_q, s_kv, q_start = 16, 32, -4
    q = rng.standard_normal((B, s_q, H, D)).astype(np.float32)
    jq, tq = _both(q, "bfloat16")
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _cache(rng, s_kv, "int8")
    jo, jl = jflash.flash_attention_fwd_cache(
        jq, jk, jv, k_scale=jks, v_scale=jvs, q_start=q_start, causal=True,
        safe_softmax=safe)
    to, tl = tflash.flash_attention_fwd_cache(
        tq, tk, tv, k_scale=tks, v_scale=tvs, q_start=q_start, causal=True,
        safe_softmax=safe)
    assert (_np(to)[:, :4] == 0).all() and np.isneginf(_np(tl)[:, :, :4]).all()
    assert np.isneginf(_np(jl)[:, :, :4]).all()
    assert not np.isnan(_np(to)).any()
    np.testing.assert_allclose(_np(to), _np(jo), **BF16_TOL)
    np.testing.assert_allclose(_np(tl)[:, :, 4:], _np(jl)[:, :, 4:], atol=1e-3)


def test_int8_kv_fwd_matches_jax(rng):
    """flash_attention_fwd with k_scale/v_scale (BSHD int8 K/V, bottom-right
    causal alignment) reaches B3 on both sides."""
    s_q, s_kv = 16, 48
    q = rng.standard_normal((B, s_q, H, D)).astype(np.float32)
    jq, tq = _both(q, "bfloat16")
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _cache(rng, s_kv, "int8")
    jo, jl = jflash.flash_attention_fwd(
        jq, jnp.swapaxes(jk, 1, 2), jnp.swapaxes(jv, 1, 2), k_scale=jks,
        v_scale=jvs, causal=True)
    to, tl = tflash.flash_attention_fwd(
        tq, tk.transpose(1, 2), tv.transpose(1, 2), k_scale=tks, v_scale=tvs,
        causal=True)
    np.testing.assert_allclose(_np(to), _np(jo), **BF16_TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-3)


# Shapes whose lengths, q_start, window edge and sink edge cut the Hopper
# kernels' 64- and 128-wide tiles, as chip_smoke.py's kernel phase runs them
# on the card: (s_q, s_kv, q_start, window, sinks); JAX tiles of 128 x 256
# (the function does not depend on them; smaller ones are slow to interpret).
STRADDLE_CASES = {
    "ragged_prefix": (100, 777, 700, -1, 0),
    "window_200_sinks_4": (100, 777, 677, 200, 4),
    "edges_inside_tiles": (75, 333, 258, 100, 70),
}
FORMS = {"fast": dict(), "safe": dict(safe_softmax=True),
         "softcap": dict(softcap=5.0)}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("case", sorted(STRADDLE_CASES))
def test_cache_forward_straddles_tiles(rng, case, cache_dtype, form):
    """B3's plain version == JAX flash_attention_fwd_cache (causal) where
    the prefix length, the chunk's rows, the window edge and the sink edge
    fall inside kv tiles: the shapes the card's kernel is held to its plain
    version at, tied here to the reference."""
    s_q, s_kv, q_start, window, sinks = STRADDLE_CASES[case]
    q = rng.standard_normal((B, s_q, H, D)).astype(np.float32)
    jq, tq = _both(q, "bfloat16")
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _cache(rng, s_kv, cache_dtype)
    kw = dict(q_start=q_start, causal=True, window_size=(window, -1),
              sink_tokens=sinks, **FORMS[form])
    jo, jl = jflash.flash_attention_fwd_cache(
        jq, jk, jv, k_scale=jks, v_scale=jvs, block_sizes=BlockSizes(128, 256),
        **kw)
    to, tl = tflash.flash_fwd_pos_plain(tq, tk, tv, tks, tvs,
                                        scale=D ** -0.5, **kw)
    np.testing.assert_allclose(_np(to), _np(jo), **BF16_TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-3)


@pytest.mark.parametrize("safe", [False, True], ids=["fast", "safe"])
@pytest.mark.parametrize("s", [200, 300])
def test_causal_self_straddles_tiles(rng, s, safe):
    """B1's plain version == JAX flash_attention_fwd(causal=True) at lengths
    that are not multiples of 64 or 128 (a partial last q and kv tile)."""
    q, k, v = _qkv(rng, s, s)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, "bfloat16") for x in (q, k, v))
    jo, jl = jflash.flash_attention_fwd(jq, jk, jv, causal=True,
                                        safe_softmax=safe,
                                        block_sizes=BlockSizes(128, 256))
    to, tl = tflash.flash_fwd_causal_self_plain(tq, tk, tv, scale=D ** -0.5,
                                                safe_softmax=safe)
    np.testing.assert_allclose(_np(to), _np(jo), **BF16_TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-3)
