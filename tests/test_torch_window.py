"""Sliding windows, StreamingLLM sinks and softcap on the port's serving path
against the JAX package, on the same numpy inputs: the fp32 oracle, the
plain versions of kernels B4 (self-attention), B3 (a chunk against the
cache prefix) and B7 (decode) against the JAX kernels in interpret mode,
the forward routing, and a tiny windowed model served by both engines.

Tolerances (those of tests/test_torch_flash.py, test_torch_decode.py and
test_torch_engine.py, which state their reasons):
* fp32 against fp32, 1e-5: the same fp32 arithmetic in another summation
  order (softcap adds one tanh per score on both sides).
* bf16 outputs 2e-2, lse 1e-3: both sides fold scale*log2e into q with one
  bf16 rounding (fast form) and cast p to bf16 before the PV product; an
  element on a rounding boundary may round the other way (one bf16 ulp of
  outputs |x| < 4).
* decode outputs 2e-2, lse 1e-4: the int8 path's integer products are exact
  on both sides; a last-bit difference in exp2 can move one P level.
* model logits: bf16 cache 5e-2, int8 cache with int8 decode weights 1e-1
  (tests/test_serving.py's gates); greedy tokens equal on a prompt whose
  top-2 logit gap stays above 0.18 at every step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu.models import llama as jllama
from long_context_attention_tpu.ops import decode as jdec
from long_context_attention_tpu.ops import flash as jflash
from long_context_attention_tpu.ops import kv_cache as jkv
from long_context_attention_tpu.ops import reference as jref
from long_context_attention_tpu.serving import engine as jeng
from long_context_attention_tpu.utils.config import BlockSizes
from long_context_attention_tpu_torch.models import llama as tllama
from long_context_attention_tpu_torch.ops import decode as tdec
from long_context_attention_tpu_torch.ops import flash as tflash
from long_context_attention_tpu_torch.ops import kv_cache as tkv
from long_context_attention_tpu_torch.ops import reference as tref
from long_context_attention_tpu_torch.serving import engine as teng
from long_context_attention_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

B, S, H, HKV, D = 2, 128, 4, 2, 32
BS = BlockSizes(64, 64)
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=0)
LSE_TOL = dict(atol=1e-3, rtol=0)
DECODE_OUT_TOL = dict(atol=2e-2, rtol=0)
DECODE_LSE_TOL = dict(atol=1e-4, rtol=0)
BF16_LOGITS = dict(atol=5e-2, rtol=0)
INT8_LOGITS = dict(atol=1e-1, rtol=0)

# self-attention masks: (causal, window, sinks, softcap)
MASKS = {
    "causal_window_sinks": (True, (20, -1), 37, 0.0),
    "window_left_right": (False, (10, 7), 3, 0.0),
    "noncausal": (False, (-1, -1), 0, 0.0),
    "softcap": (True, (-1, -1), 0, 50.0),
    "softcap_window_sinks": (True, (30, -1), 4, 50.0),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pair(x, dtype):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    j = jnp.asarray(x, jd)
    return j, torch.from_numpy(_np(j)).to(td)


def _qkv(rng, dtype, s_q=S, s_kv=S):
    return [_pair(rng.standard_normal(shape).astype(np.float32), dtype)
            for shape in ((B, s_q, H, D), (B, s_kv, HKV, D),
                          (B, s_kv, HKV, D))]


def _kw(mask):
    causal, window, sinks, cap = mask
    return dict(causal=causal, window_size=window, sink_tokens=sinks,
                softcap=cap)


@pytest.mark.parametrize("case", ["window_sinks", "sinks_without_window",
                                  "window_left_right", "softcap_all",
                                  "bottom_right"])
def test_oracle_matches_jax(rng, case):
    """The port's fp32 oracle == JAX xla_attention with a window, sinks and
    softcap (GQA); sinks without a left window change nothing, as in JAX
    (flash.py:1794)."""
    kw = {"window_sinks": dict(causal=True, window_size=(20, -1),
                               sink_tokens=5),
          "sinks_without_window": dict(causal=True, sink_tokens=8),
          "window_left_right": dict(causal=False, window_size=(10, 7),
                                    sink_tokens=3),
          "softcap_all": dict(causal=True, window_size=(30, -1),
                              sink_tokens=4, softcap=3.0),
          "bottom_right": dict(causal=True, window_size=(16, -1),
                               sink_tokens=6)}[case]
    s_q = S // 2 if case == "bottom_right" else S
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, "float32", s_q=s_q)
    jo, jl = jref.xla_attention(jq, jk, jv, **kw)
    to, tl = tref.xla_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(_np(to), _np(jo), **F32_TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32_TOL)
    if case == "sinks_without_window":
        po, pl = tref.xla_attention(tq, tk, tv, causal=True)
        assert torch.equal(to, po) and torch.equal(tl, pl)
    elif case == "window_sinks":  # and with a window the sinks matter
        po, _ = tref.xla_attention(tq, tk, tv, causal=True,
                                   window_size=(20, -1))
        assert float((to - po).abs().max()) > 1e-2


@pytest.mark.parametrize("safe", [False, True], ids=["fast", "safe"])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_static_plain_matches_jax(rng, mask, safe):
    """B4's plain version (flash_attention without offsets and with a
    window, sinks, softcap or causal=False) == JAX flash_attention, whose
    self-attention takes the static kernel _fwd_kernel_static here, bf16,
    GQA g=2; and the fp32 oracle at the same masks."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, "bfloat16")
    kw = _kw(MASKS[mask])
    jo, jl = jflash.flash_attention(jq, jk, jv, block_sizes=BS,
                                    return_lse=True, safe_softmax=safe, **kw)
    to, tl = tflash.flash_attention(tq, tk, tv, return_lse=True,
                                    safe_softmax=safe, **kw)
    assert to.dtype == torch.bfloat16 and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), **BF16_TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **LSE_TOL)
    # the same plain version in fp32 against the oracle
    fq, fk, fv = (t.float() for t in (tq, tk, tv))
    po, pl = tflash.flash_fwd_static_plain(fq, fk, fv, scale=D ** -0.5,
                                           safe_softmax=safe, **kw)
    ro, rl = tref.xla_attention(fq, fk, fv, **kw)
    np.testing.assert_allclose(_np(po), _np(ro), **F32_TOL)
    np.testing.assert_allclose(_np(pl), _np(rl), **F32_TOL)


# a chunk of s_q rows at q_start against an s_kv-slot cache prefix:
# (s_q, s_kv, q_start, window, sinks, softcap); JAX tiles of 16 x 32
CACHE_CASES = {
    "band_mid_cache": (32, 192, 192, 40, 8, 0.0),
    "band_straddles_sinks": (32, 192, 48, 40, 37, 0.0),
    "chunk_longer_than_window": (32, 192, 192, 16, 0, 0.0),
    "softcap": (32, 192, 160, 40, 8, 5.0),
}


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_cache_plain_matches_jax(rng, case, cache_dtype):
    """B3's plain version == JAX flash_attention_fwd_cache (causal, as the
    chunked prefill calls it) with a window, sinks and softcap at q_start >
    0 over a bf16 or int8 cache: the band inside the cache, over the sink
    tiles, and a chunk longer than the window whose late rows see no cache
    slot (out 0, lse -inf on both sides)."""
    s_q, s_kv, q_start, window, sinks, cap = CACHE_CASES[case]
    q = rng.standard_normal((B, s_q, H, D)).astype(np.float32)
    k = rng.standard_normal((B, HKV, s_kv, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, s_kv, D)).astype(np.float32)
    jq, tq = _pair(q, "bfloat16")
    jk, jks = jkv.quantize_kv(jnp.asarray(k), cache_dtype)
    jv, jvs = jkv.quantize_kv(jnp.asarray(v), cache_dtype)
    tk, tks = tkv.quantize_kv(torch.from_numpy(k), cache_dtype)
    tv, tvs = tkv.quantize_kv(torch.from_numpy(v), cache_dtype)
    kw = dict(q_start=q_start, causal=True, window_size=(window, -1),
              sink_tokens=sinks, softcap=cap)
    jo, jl = jflash.flash_attention_fwd_cache(
        jq, jk, jv, k_scale=jks, v_scale=jvs,
        block_sizes=BlockSizes(16, 32), **kw)
    to, tl = tflash.flash_attention_fwd_cache(tq, tk, tv, k_scale=tks,
                                              v_scale=tvs, **kw)
    np.testing.assert_allclose(_np(to), _np(jo), **BF16_TOL)
    dead = np.isneginf(_np(jl))
    np.testing.assert_array_equal(np.isneginf(_np(tl)), dead)
    np.testing.assert_allclose(_np(tl)[~dead], _np(jl)[~dead], **LSE_TOL)
    if case == "chunk_longer_than_window":
        assert dead[:, :, window:].all() and not dead[:, :, :window].any()
        assert not _np(to)[:, window:].any()


@pytest.mark.parametrize("case", ["window_sinks_fast", "window_sinks_safe",
                                  "window_softcap"])
@pytest.mark.parametrize("cache_dtype", ["int8", "bfloat16"])
def test_decode_plain_matches_jax(rng, cache_dtype, case):
    """B7's plain version through decode_attention == the JAX decode kernel
    with a window and sinks (or softcap), a layered 512-slot cache in
    128-slot tiles (the int8 P requantization tiles, reference_block_kv),
    ragged lengths below, at and above window + sinks."""
    s_max, window, sinks = 512, 100, 8
    kw = dict(window_size=(window, -1), sink_tokens=sinks,
              safe_softmax=case == "window_sinks_safe",
              softcap=5.0 if case == "window_softcap" else 0.0)
    jc = jkv.KVCache.init(2, 4, s_max, HKV, D, cache_dtype)
    tc = tkv.KVCache.init(2, 4, s_max, HKV, D, cache_dtype, device="cpu")
    for layer in range(2):
        k = rng.standard_normal((4, s_max, HKV, D)).astype(np.float32)
        v = rng.standard_normal((4, s_max, HKV, D)).astype(np.float32)
        jc = jc.write_prompt(layer, jnp.asarray(k), jnp.asarray(v))
        tc.write_prompt(layer, torch.from_numpy(k), torch.from_numpy(v))
    q = rng.standard_normal((4, H, D)).astype(np.float32)
    lens = np.array([60, window + sinks, window + sinks + 1, s_max],
                    np.int32)
    scales = (jc.k_scale, jc.v_scale)
    jo, jl = jdec.decode_attention(
        jnp.asarray(q, jnp.bfloat16), jc.k, jc.v, jnp.asarray(lens),
        *scales, layer=jnp.int32(1), block_kv=128, return_lse=True, **kw)
    tscales = (tc.k_scale, tc.v_scale)
    to, tl = tdec.decode_attention(
        torch.from_numpy(q).to(torch.bfloat16), tc.k, tc.v,
        torch.from_numpy(lens), *tscales, layer=1, block_kv=128,
        return_lse=True, **kw)
    np.testing.assert_allclose(_np(to), _np(jo), **DECODE_OUT_TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **DECODE_LSE_TOL)
    if case == "window_sinks_fast":  # the sinks matter past the window
        no_sink = tdec.decode_attention(
            torch.from_numpy(q).to(torch.bfloat16), tc.k, tc.v,
            torch.from_numpy(lens), *tscales, layer=1, block_kv=128,
            window_size=(window, -1))
        moved = (to.float() - no_sink.float()).abs().amax(dim=(1, 2))
        assert moved[0] == 0 and (moved[2:] > 1e-3).all()


# ---------------------------------------------------------------------------
# the tiny windowed model (tests/test_sinks.py:110, test_serving.py:337)
# ---------------------------------------------------------------------------

SHAPE = dict(vocab=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=32, ffn_hidden=128, layout="basic")
MODELS = {"window_sinks": dict(window_left=24, sink_tokens=8),
          "window_softcap": dict(window_left=24, softcap=8.0)}
PROMPT_LEN, S_MAX, CHUNK = 48, 64, 16
# greedy decode of the sink model on the int8 path is tie-free on this
# prompt: top-2 logit gap >= 0.18 at every step (the softcapped model's
# bf16 logits tie often at this size, so it is held by its logits only)
PROMPT_SEED = 10


@pytest.fixture(scope="module")
def models():
    base = jllama.ModelConfig(**SHAPE)
    jparams = jllama.init_params(jax.random.PRNGKey(3), base)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    prompt = np.random.default_rng(PROMPT_SEED).integers(
        0, SHAPE["vocab"], (B, PROMPT_LEN)).astype(np.int32)
    return jparams, tparams, prompt


def _engines(model, cache_dtype, weight_dtype="bfloat16"):
    jcfg = jllama.ModelConfig(**SHAPE, **MODELS[model])
    tcfg = tllama.ModelConfig(**SHAPE, **MODELS[model])
    return (jcfg, tcfg,
            jeng.Engine(cfg=jcfg, s_max=S_MAX, cache_dtype=cache_dtype,
                        weight_dtype=weight_dtype),
            teng.Engine(cfg=tcfg, s_max=S_MAX, cache_dtype=cache_dtype,
                        weight_dtype=weight_dtype, device="cpu"))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_windowed_prefill_matches_jax(models, model):
    """Engine.prefill (B4 in every layer) and Engine.prefill_chunked in
    chunks of 16 (B4 on each chunk, B3 over the cache prefix; the chunks
    cross the sink line and the window edge) of a window-24 model with
    sinks or softcap: last-token logits and the cache against JAX, and
    chunked against one-shot prefill."""
    jparams, tparams, prompt = models
    _, _, je, te = _engines(model, "bfloat16")
    jl, jc = je.prefill(jparams, jnp.asarray(prompt))
    tl, tc = te.prefill(tparams, torch.from_numpy(prompt))
    np.testing.assert_allclose(_np(tl), _np(jl), **BF16_LOGITS)
    np.testing.assert_allclose(_np(tc.k), _np(jc.k), **BF16_LOGITS)
    jl2, _ = je.prefill_chunked(jparams, jnp.asarray(prompt), CHUNK)
    tl2, tc2 = te.prefill_chunked(tparams, torch.from_numpy(prompt), CHUNK)
    np.testing.assert_allclose(_np(tl2), _np(jl2), **BF16_LOGITS)
    np.testing.assert_allclose(_np(tl2), _np(tl), **BF16_LOGITS)
    assert tc2.length.tolist() == [PROMPT_LEN] * B


@pytest.mark.parametrize("model", sorted(MODELS))
def test_windowed_decode_matches_jax(models, model):
    """Four decode steps (B6, then B7 over the window band and the sinks)
    teacher-forced with the JAX-greedy tokens from each package's own
    chunked prefill, bf16 cache and weights."""
    jparams, tparams, prompt = models
    jcfg, tcfg, je, te = _engines(model, "bfloat16")
    jl, jc = je.prefill_chunked(jparams, jnp.asarray(prompt), CHUNK)
    _, tc = te.prefill_chunked(tparams, torch.from_numpy(prompt), CHUNK)
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    for _ in range(4):
        jd, jc = jllama.decode_step(jparams, jc, tok, jcfg)
        td, tc = tllama.decode_step(tparams, tc,
                                    torch.from_numpy(np.array(tok)), tcfg)
        np.testing.assert_allclose(_np(td), _np(jd), **BF16_LOGITS)
        tok = jnp.argmax(jd, -1).astype(jnp.int32)
    assert tc.length.tolist() == [PROMPT_LEN + 4] * B


def test_windowed_greedy_tokens_match_jax(models):
    """The windowed serving slice end to end, as the card runs it (window
    and sinks, int8 cache, int8 decode weights): chunked prefill, then
    decode_scan of 4 greedy tokens -- the same tokens as JAX, logits within
    the int8 gate."""
    jparams, tparams, prompt = models
    _, _, je, te = _engines("window_sinks", "int8", "int8")
    jl, jc = je.prefill_chunked(jparams, jnp.asarray(prompt), CHUNK)
    tl, tc = te.prefill_chunked(tparams, torch.from_numpy(prompt), CHUNK)
    np.testing.assert_allclose(_np(tl), _np(jl), **INT8_LOGITS)
    first = jnp.argmax(jl, -1).astype(jnp.int32)
    assert torch.argmax(tl, -1).tolist() == np.asarray(first).tolist()
    jt, _ = je.decode_scan(je.decode_params(jparams), jc, 4, first,
                           jeng.SamplingParams(), jax.random.PRNGKey(0))
    tt, tc = te.decode_scan(te.decode_params(tparams), tc, 4,
                            torch.from_numpy(np.array(first)))
    assert tt.tolist() == np.asarray(jt).tolist()
    assert tc.length.tolist() == [PROMPT_LEN + 4] * B


def test_chunk_longer_than_window_keeps_global_sinks(models):
    """A chunk longer than the window, past the sinks: its own tokens are
    not sinks (sinks are global positions), so chunked prefill equals the
    one-shot prefill -- which JAX's prefill_chunk_step misses (it passes
    sink_tokens to the chunk's self-attention at local positions, and
    misses its own one-shot prefill by more than the logit gate). Without
    sinks the rows whose window lies inside their chunk see no cache slot,
    and their dead cache-prefix lse (-inf) merges as a no-op."""
    jparams, tparams, prompt = models
    for sinks in (4, 0):
        kw = dict(window_left=8, sink_tokens=sinks)
        te = teng.Engine(cfg=tllama.ModelConfig(**SHAPE, **kw), s_max=S_MAX,
                         device="cpu")
        je = jeng.Engine(cfg=jllama.ModelConfig(**SHAPE, **kw), s_max=S_MAX)
        one, _ = te.prefill(tparams, torch.from_numpy(prompt))
        chunked, _ = te.prefill_chunked(tparams, torch.from_numpy(prompt),
                                        CHUNK)
        np.testing.assert_allclose(_np(chunked), _np(one), **BF16_LOGITS)
        jone, _ = je.prefill(jparams, jnp.asarray(prompt))
        np.testing.assert_allclose(_np(one), _np(jone), **BF16_LOGITS)
        if sinks:
            jchunked, _ = je.prefill_chunked(jparams, jnp.asarray(prompt),
                                             CHUNK)
            assert np.abs(_np(jchunked) - _np(jone)).max() > 5e-2


# ---------------------------------------------------------------------------
# routing and the gradient boundary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,want", [
    ("causal", "flash_fwd_causal_self"),
    ("causal_tri_grid_off", "flash_fwd_static"),
    ("causal_window", "flash_fwd_static"),
    ("causal_sinks_no_window", "flash_fwd_causal_self"),
    ("softcap", "flash_fwd_static"),
    ("noncausal", "flash_fwd_static"),
    ("offsets_window", "flash_fwd_pos"),
    ("bottom_right_window", "flash_fwd_pos")])
def test_forward_routing(monkeypatch, case, want):
    """flash_attention's forward takes B1 only for plain causal
    self-attention, B4 for any other self-attention without offsets, and B3
    with one-chunk offsets or s_q != s_kv (_flash_fwd_bhsd's rule)."""
    calls = []
    for name in ("flash_fwd_causal_self", "flash_fwd_static",
                 "flash_fwd_pos"):
        real = getattr(tflash, name)
        monkeypatch.setattr(tflash, name, (lambda real, name: (
            lambda *a, **k: calls.append(name) or real(*a, **k)))(real, name))
    q = torch.randn(1, 16, 2, 8)
    kw = {"causal": dict(causal=True),
          "causal_tri_grid_off": dict(causal=True, tri_grid=False),
          "causal_window": dict(causal=True, window_size=(4, -1)),
          "causal_sinks_no_window": dict(causal=True, sink_tokens=4),
          "softcap": dict(causal=True, softcap=5.0),
          "noncausal": dict(causal=False),
          "offsets_window": dict(causal=True, window_size=(4, -1),
                                 q_offsets=[0], kv_offsets=[0]),
          "bottom_right_window": dict(causal=True, window_size=(4, -1))}[case]
    qq = q[:, :8] if case == "bottom_right_window" else q
    out = tflash.flash_attention(qq, q, q, **kw)
    assert calls == [want]
    ref, _ = tref.xla_attention(qq, q, q, **{
        k: v for k, v in kw.items() if k not in ("tri_grid", "q_offsets",
                                                 "kv_offsets")})
    np.testing.assert_allclose(_np(out), _np(ref), **F32_TOL)


def test_gradient_boundary():
    """The gradient of a window, sinks with a window, or a softcap comes
    back through flash_attention_fwd (flash_attention:
    test_torch_flash_bwd.py) and equals the fp32 oracle's; make_train_step
    and loss_local train such a config, its grads equal to those of the
    same model on the xla oracle impl. The int8-KV path stays forward-only
    and raises under autograd."""
    q = torch.randn(1, 16, 2, 8)
    dout = torch.randn(1, 16, 2, 8)
    for kw in (dict(window_size=(4, -1)), dict(softcap=5.0),
               dict(window_size=(4, -1), sink_tokens=2)):
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, q * 0.5, -q))
        out, lse = tflash.flash_attention_fwd(qg, kg, vg, causal=True, **kw)
        (out * dout).sum().backward()
        oracle = tref.xla_attention_bwd(q, q * 0.5, -q, out.detach(),
                                        lse.detach(), dout, causal=True,
                                        **kw)
        for g, w in zip((qg.grad, kg.grad, vg.grad), oracle):
            np.testing.assert_allclose(_np(g), _np(w), **F32_TOL)
    scale = torch.ones(1, 2, 16)
    with pytest.raises(NotImplementedError, match="forward-only"):
        tflash.flash_attention_fwd(q.clone().requires_grad_(),
                                   q.to(torch.int8), q.to(torch.int8),
                                   k_scale=scale, v_scale=scale, causal=True)
    cfg = tllama.ModelConfig(**SHAPE, window_left=8, sink_tokens=2,
                             softcap=4.0, dtype=torch.float32)
    params = tllama.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    tokens = torch.randint(0, SHAPE["vocab"], (1, 24),
                           generator=torch.Generator().manual_seed(1))
    grads = {}
    for impl in ("pallas", "xla"):
        leaves = [t.detach().clone().requires_grad_()
                  for t in tllama.param_leaves(params)]
        it = iter(leaves)
        p = {k: ({kk: next(it) for kk in v} if isinstance(v, dict)
                 else next(it)) for k, v in params.items()}
        loss = tllama.loss_local(p, tokens, tokens, torch.ones(1, 24),
                                 dataclasses.replace(cfg, attn_impl=impl))
        loss.backward()
        grads[impl] = (float(loss.detach()), [t.grad for t in leaves])
    assert abs(grads["pallas"][0] - grads["xla"][0]) < 1e-5
    for g, w in zip(grads["pallas"][1], grads["xla"][1]):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    step = tllama.make_train_step(cfg, torch.optim.SGD, device="cpu")
    _, _, loss = step(params, None, tokens, tokens, torch.ones(1, 24))
    assert abs(float(loss) - grads["pallas"][0]) < 1e-5


def test_model_config_threads_the_attention_shape():
    """ModelConfig takes window_left, sink_tokens and softcap and hands
    every attention call the JAX model's kwargs."""
    cfg = tllama.ModelConfig(**SHAPE, window_left=4096, sink_tokens=4,
                             softcap=50.0)
    assert cfg.attention_kwargs() == dict(
        window_size=(4096, -1), softcap=50.0, sink_tokens=4,
        safe_softmax=False)
