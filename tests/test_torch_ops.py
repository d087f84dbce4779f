"""Merge, KV quantization and w8a8 weight quantization of the PyTorch port
against the JAX package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu.ops import kv_cache as jkv
from long_context_attention_tpu.ops import merge as jmerge
from long_context_attention_tpu.ops import wquant as jwq
from long_context_attention_tpu_torch.ops import kv_cache as tkv
from long_context_attention_tpu_torch.ops import merge as tmerge
from long_context_attention_tpu_torch.ops import wquant as twq

torch.set_num_threads(1)

# fp32 elementwise math on both sides; exp/log implementations differ by an
# ulp or two, so fp32 results agree to ~1e-6 relative.
F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def test_merge_attn_blocks_matches_jax(rng):
    """Pairwise LSE merge, with whole rows at -inf on one or both sides."""
    b, s, h, d = 2, 5, 3, 8
    acc = rng.standard_normal((b, s, h, d)).astype(np.float32)
    blk = rng.standard_normal((b, s, h, d)).astype(np.float32)
    acc_lse = rng.standard_normal((b, h, s)).astype(np.float32)
    blk_lse = rng.standard_normal((b, h, s)).astype(np.float32)
    acc_lse[0, 0, :] = -np.inf          # empty accumulator rows
    blk_lse[0, 1, 2] = -np.inf          # masked block row
    acc_lse[1, 2, 4] = blk_lse[1, 2, 4] = -np.inf  # dead on both sides
    jo, jl = jmerge.merge_attn_blocks(jnp.asarray(acc), jnp.asarray(acc_lse),
                                      jnp.asarray(blk), jnp.asarray(blk_lse))
    to, tl = tmerge.merge_attn_blocks(_t(acc), _t(acc_lse), _t(blk),
                                      _t(blk_lse))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    assert np.isneginf(tl.numpy()[1, 2, 4]) and not np.isnan(to.numpy()).any()


def test_merge_partials_matches_jax(rng):
    """N-way merge; a position dead in every partial gives out 0, lse -inf."""
    outs = rng.standard_normal((3, 2, 4, 6)).astype(np.float32)
    lses = rng.standard_normal((3, 2, 4)).astype(np.float32)
    lses[:, 1, 3] = -np.inf
    lses[0, 0, :] = -np.inf
    jo, jl = jmerge.merge_partials(jnp.asarray(outs), jnp.asarray(lses))
    to, tl = tmerge.merge_partials(_t(outs), _t(lses))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    assert (to.numpy()[1, 3] == 0).all() and np.isneginf(tl.numpy()[1, 3])


def test_init_merge_state():
    out, lse = tmerge.init_merge_state(2, 3, 4, 5, device="cpu")
    jo, jl = jmerge.init_merge_state(2, 3, 4, 5)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(lse.numpy(), np.asarray(jl))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_quantize_kv_exact(rng, dtype):
    """int8 values and scales are bit-identical (the same fp32 divide and
    round-half-even); the dequantized bf16 is identical too."""
    x = (rng.standard_normal((2, 3, 7, 16)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0  # absmax floor
    jq, js = jkv.quantize_kv(jnp.asarray(x), dtype)
    tq, ts = tkv.quantize_kv(_t(x), dtype)
    np.testing.assert_array_equal(tq.float().numpy(),
                                  np.asarray(jq, np.float32))
    if dtype == "int8":
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jkv.dequantize_kv(jq, js)
    td = tkv.dequantize_kv(tq, ts)
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd, np.float32))


def test_quantize_weight_exact(rng):
    w = rng.standard_normal((3, 19, 37)).astype(np.float32)
    jq = jwq.quantize_weight(jnp.asarray(w, jnp.bfloat16))
    tq = twq.quantize_weight(_t(w).to(torch.bfloat16))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert tq.padded.shape == (3, 24, 40)
    assert (tq.padded[:, 19:] == 0).all() and (tq.padded[:, :, 37:] == 0).all()


@pytest.mark.parametrize("rows", [1, 5, 40])
def test_qdot_matches_jax(rng, rows):
    """w8a8 at odd widths (in 19, out 37: both padded to multiples of 8) and
    row counts below and above the 16-row floor of the card's int8 product.
    The int32 sums are exact on both sides; the fp32 rescale runs in the
    same order, so the only difference is the final bf16 rounding of an
    identical fp32 value -- the results are bit-identical."""
    w = rng.standard_normal((19, 37)).astype(np.float32) / 4
    x = rng.standard_normal((rows, 19)).astype(np.float32)
    jy = jwq.qdot(jnp.asarray(x, jnp.bfloat16),
                  jwq.quantize_weight(jnp.asarray(w, jnp.bfloat16)))
    ty = twq.qdot(_t(x).to(torch.bfloat16),
                  twq.quantize_weight(_t(w).to(torch.bfloat16)))
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(jy, np.float32))
    plain = _t(x).to(torch.bfloat16) @ _t(w).to(torch.bfloat16)
    assert ty.shape == plain.shape == (rows, 37)
