"""The serving slice of the PyTorch port against the JAX package: the same
weights (JAX ``init_params`` through ``params_from_jax``), the same prompt,
and the port's plain kernel versions on the CPU against the JAX kernels in
interpret mode.

Tolerances, no looser than the JAX suite's own gates for the same
comparisons (tests/test_serving.py: 5e-2 for bf16-cache logits, 2e-1 for
chunked int8-cache prefill logits, 0.5 for int8-cache decode logits):
* bf16 prefill logits 5e-2: bf16 rounding of the activations at the same
  places on both sides, with fp32 sums in another order (matmuls, the
  fast-softmax row sums) -- a bf16 ulp here and there;
* int8 chunked prefill and int8-weight decode logits 1e-1: on top of that,
  per-tile requantization of P in decode and the int8 w8a8 products, whose
  int32 sums are exact but whose inputs inherit the bf16 differences, so an
  activation can land in the neighbouring int8 level (1/127 of the row's
  absmax).
* greedy tokens: equal, on a prompt whose top-2 logit gap stays above 0.17
  at every step (tie-free), far above the logit tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu.models import llama as jllama
from long_context_attention_tpu.serving import engine as jeng
from long_context_attention_tpu_torch.models import llama as tllama
from long_context_attention_tpu_torch.serving import engine as teng
from long_context_attention_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

SHAPE = dict(vocab=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=32, ffn_hidden=128, layout="basic")
JCFG = jllama.ModelConfig(**SHAPE)
TCFG = tllama.ModelConfig(**SHAPE)
B, S_PROMPT, S_MAX = 2, 16, 64
PROMPT_SEED = 2  # tie-free greedy decode for 6 steps (top-2 gap >= 0.17)
BF16_LOGITS = dict(atol=5e-2, rtol=0)
INT8_LOGITS = dict(atol=1e-1, rtol=0)


@pytest.fixture(scope="module")
def setup():
    jparams = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    prompt = np.random.default_rng(PROMPT_SEED).integers(
        0, SHAPE["vocab"], (B, S_PROMPT)).astype(np.int32)
    return jparams, tparams, prompt


def _engines(cache_dtype, weight_dtype="bfloat16", jcfg=JCFG, tcfg=TCFG):
    return (jeng.Engine(cfg=jcfg, s_max=S_MAX, cache_dtype=cache_dtype,
                        weight_dtype=weight_dtype),
            teng.Engine(cfg=tcfg, s_max=S_MAX, cache_dtype=cache_dtype,
                        weight_dtype=weight_dtype, device="cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_params_from_jax(setup):
    """Every leaf, stacked layer leaves included, keeps shape and value;
    bf16 leaves come through float32 exactly."""
    jparams, tparams, _ = setup
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(jflat) == 1 + 9 + 2
    for path, leaf in jflat:
        t = tparams
        for p in path:
            t = t[p.key]
        want = np.asarray(leaf)
        assert tuple(t.shape) == want.shape, path
        assert str(t.dtype).split(".")[-1] == want.dtype.name, path
        np.testing.assert_array_equal(_np(t), want.astype(np.float32))


def test_prefill_logits_match_jax(setup):
    """Engine.prefill (bf16 cache): last-token logits and the cache."""
    jparams, tparams, prompt = setup
    je, te = _engines("bfloat16")
    jl, jc = je.prefill(jparams, jnp.asarray(prompt))
    tl, tc = te.prefill(tparams, torch.from_numpy(prompt))
    assert tl.shape == (B, SHAPE["vocab"]) and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), **BF16_LOGITS)
    assert tc.length.tolist() == np.asarray(jc.length).tolist()
    np.testing.assert_allclose(_np(tc.k), _np(jc.k), **BF16_LOGITS)
    np.testing.assert_allclose(_np(tc.v), _np(jc.v), **BF16_LOGITS)


def test_prefill_chunked_int8_matches_jax(setup):
    """Engine.prefill_chunked over an int8 cache, chunk 8: the second chunk
    attends to the quantized first one (kernel B3) and merges by LSE."""
    jparams, tparams, prompt = setup
    je, te = _engines("int8", "int8")
    jl, jc = je.prefill_chunked(jparams, jnp.asarray(prompt), 8)
    tl, tc = te.prefill_chunked(tparams, torch.from_numpy(prompt), 8)
    np.testing.assert_allclose(_np(tl), _np(jl), **INT8_LOGITS)
    assert tc.length.tolist() == [S_PROMPT] * B
    # int8 cache values: the same level for nearly all, else a level or two
    # off where the bf16 K/V (and so the row's absmax scale) differ by an ulp
    diff = np.abs(_np(tc.k) - _np(jc.k))
    assert diff.max() <= 2 and (diff > 0).mean() < 0.05
    np.testing.assert_allclose(_np(tc.k_scale), _np(jc.k_scale), rtol=2e-2)


@pytest.mark.parametrize("cache_dtype,weight_dtype,safe",
                         [("int8", "int8", False),
                          ("bfloat16", "bfloat16", False),
                          ("bfloat16", "bfloat16", True)])
def test_decode_steps_teacher_forced(setup, cache_dtype, weight_dtype, safe):
    """Four decode_step calls fed the same (JAX-greedy) tokens from each
    package's own chunked prefill: per-step logits agree, in the fast and
    the online (safe_softmax) forms."""
    jparams, tparams, prompt = setup
    jcfg = dataclasses.replace(JCFG, safe_softmax=safe)
    tcfg = dataclasses.replace(TCFG, safe_softmax=safe)
    je, te = _engines(cache_dtype, weight_dtype, jcfg, tcfg)
    jl, jc = je.prefill_chunked(jparams, jnp.asarray(prompt), 8)
    _, tc = te.prefill_chunked(tparams, torch.from_numpy(prompt), 8)
    jdp, tdp = je.decode_params(jparams), te.decode_params(tparams)
    tol = INT8_LOGITS if cache_dtype == "int8" else BF16_LOGITS
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    for _ in range(4):
        jd, jc = jllama.decode_step(jdp, jc, tok, jcfg)
        td, tc = tllama.decode_step(tdp, tc, torch.from_numpy(np.array(tok)),
                                    tcfg)
        np.testing.assert_allclose(_np(td), _np(jd), **tol)
        tok = jnp.argmax(jd, -1).astype(jnp.int32)
    assert tc.length.tolist() == [S_PROMPT + 4] * B


def test_decode_scan_greedy_tokens_match_jax(setup):
    """The serving slice end to end: int8 cache, int8 decode weights,
    chunked prefill, then six greedy decode steps -- the same tokens."""
    jparams, tparams, prompt = setup
    je, te = _engines("int8", "int8")
    jl, jc = je.prefill_chunked(jparams, jnp.asarray(prompt), 8)
    tl, tc = te.prefill_chunked(tparams, torch.from_numpy(prompt), 8)
    jfirst = jnp.argmax(jl, -1).astype(jnp.int32)
    tfirst = torch.argmax(tl, -1).to(torch.int32)
    assert tfirst.tolist() == np.asarray(jfirst).tolist()
    jt, _ = je.decode_scan(je.decode_params(jparams), jc, 6, jfirst,
                           jeng.SamplingParams(), jax.random.PRNGKey(0))
    tt, tc = te.decode_scan(te.decode_params(tparams), tc, 6, tfirst)
    assert tt.shape == (B, 6) and tt.dtype == torch.int32
    assert tt.tolist() == np.asarray(jt).tolist()
    assert tc.length.tolist() == [S_PROMPT + 6] * B


def test_generate_shapes(setup):
    """generate: prefill + decode_scan, (b, max_new) tokens, the cache
    holding prompt + generated tokens, and the prefill logits."""
    _, tparams, prompt = setup
    _, te = _engines("bfloat16")
    res = te.generate(tparams, torch.from_numpy(prompt), 5)
    assert res.tokens.shape == (B, 5) and res.tokens.dtype == torch.int32
    assert res.cache.length.tolist() == [S_PROMPT + 5] * B
    assert res.prefill_logits.shape == (B, SHAPE["vocab"])
    assert torch.isfinite(res.prefill_logits).all()
    assert res.tokens[:, 0].tolist() == torch.argmax(
        res.prefill_logits, -1).tolist()
    sampled = te.generate(tparams, torch.from_numpy(prompt), 3,
                          sampling=teng.SamplingParams(temperature=1.0,
                                                       top_k=10, top_p=0.9),
                          generator=torch.Generator().manual_seed(0))
    assert sampled.tokens.shape == (B, 3)
    assert ((sampled.tokens >= 0) & (sampled.tokens < SHAPE["vocab"])).all()
