"""Sage attention (int8 QK, bf16 PV) and the attention registry of the
PyTorch port against the JAX package, on the same numpy inputs: the
quantizers, the plain versions of kernels B8a (causal), B8c (no mask) and
B8b (positions, window, sinks) through ``sage_attention`` against the JAX
kernels in interpret mode (BlockSizes(64, 64)), the pre-quantized entry,
the registry's three impls, the straight-through gradient, and a tiny model
with ``attn_impl="sage"`` served and trained by both packages.

Tolerances:
* int8 values: the port divides by the same fp32 scale and rounds half to
  even, as JAX does, so q's and V's values are equal. K is centred by its
  fp32 mean over the tokens, summed in another order on the two sides: a
  last-bit difference can move an element across a rounding boundary, one
  int8 level on a share of the elements below 1e-3. Scales within 1e-6 of
  their size (fp32 division of the same absmax).
* attention: out 2e-2, with at most 1% of the elements more than 1e-4
  apart; lse 1e-4. Equal int8 operands and the same fp32 arithmetic, tile
  by tile, summed in another order; but the two exp2 implementations may
  differ in a last bit, and p is cast to bf16 before the PV product on
  both sides, so a p on a rounding boundary rounds the other way: 2^-8 of
  that term, up to 2^-8 of the row's largest |v| (< 4) when the term
  dominates its row; bf16 outputs add one bf16 ulp of |x| < 4.
* the registry's backward and the straight-through gradient (fp32): 1e-4
  of each gradient's largest value: the flash backward's fp32 sums in
  another order, anchored on (out, lse) that agree within the above.
* the tiny model (bf16 weights): logits 5e-2 (the bf16 gate of
  tests/test_torch_engine.py); greedy tokens equal on a tie-free prompt;
  loss 2e-3 and each gradient leaf 0.05 of its largest value (the bf16
  gate of tests/test_torch_train.py). The JAX model reaches kernel B8b
  (its ring passes offsets even at ring size 1), the port's B8a: both
  compute the same function.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from long_context_attention_tpu.models import llama as jllama
from long_context_attention_tpu.ops import kv_cache as jkv
from long_context_attention_tpu.ops import registry as jreg
from long_context_attention_tpu.ops import sage as jsage
from long_context_attention_tpu.parallel import make_usp_mesh
from long_context_attention_tpu.parallel.mesh import MeshAxes
from long_context_attention_tpu.serving import engine as jeng
from long_context_attention_tpu.utils.config import BlockSizes
from long_context_attention_tpu_torch.models import llama as tllama
from long_context_attention_tpu_torch.ops import kv_cache as tkv
from long_context_attention_tpu_torch.ops import reference as tref
from long_context_attention_tpu_torch.ops import registry as treg
from long_context_attention_tpu_torch.ops import sage as tsage
from long_context_attention_tpu_torch.parallel.layouts import (
    positions_from_descriptor,
)
from long_context_attention_tpu_torch.serving import engine as teng
from long_context_attention_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

B, S, H, HKV, D = 2, 128, 4, 2, 32
BS = BlockSizes(64, 64)
OUT_TOL, OUT_NEAR, OUT_NEAR_SHARE = 2e-2, 1e-4, 0.01
LSE_TOL = dict(atol=1e-4, rtol=0)
GRAD_TOL = 1e-4
FLIP_SHARE = 1e-3


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
    """q, k, v as (JAX, torch) pairs; K carries a +0.7 common mode, which
    the centring removes (tests/test_sage.py)."""
    q = rng.standard_normal((B, s_q, H, D))
    k = rng.standard_normal((B, s_kv, HKV, D)) + 0.7
    v = rng.standard_normal((B, s_kv, HKV, D))
    return [_pair(x.astype(np.float32), dtype) for x in (q, k, v)]


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _out_close(got, want):
    """Attention outputs: all within OUT_TOL, all but OUT_NEAR_SHARE of
    them within OUT_NEAR (see the module docstring)."""
    diff = np.abs(_np(got) - _np(want))
    assert diff.max() <= OUT_TOL, diff.max()
    assert (diff > OUT_NEAR).mean() <= OUT_NEAR_SHARE, (diff > OUT_NEAR).mean()


def _leaf_close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizers_match_jax(rng, dtype):
    """_quant_per_token: int8 values equal, scales within 1e-6;
    sage_quantize_kv: V equal, K's values within one level on under 1e-3
    of the elements (the fp32 mean's summation order), K's mean and
    scales within 1e-6."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, dtype)
    j8, js = jsage._quant_per_token(jq)
    t8, ts = tsage._quant_per_token(tq)
    assert t8.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    _close(ts, js, dict(atol=0, rtol=1e-6))
    jout = jsage.sage_quantize_kv(jnp.swapaxes(jk, 1, 2),
                                  jnp.swapaxes(jv, 1, 2))
    tout = tsage.sage_quantize_kv(tk.transpose(1, 2), tv.transpose(1, 2))
    (jk8, jks, jv8, jvs, jmean), (tk8, tks, tv8, tvs, tmean) = jout, tout
    assert tuple(tk8.shape) == (B, HKV, S, D) and tuple(tks.shape) == (
        B, HKV, S) and tuple(tmean.shape) == (B, HKV, 1, D)
    np.testing.assert_array_equal(tv8.numpy(), np.asarray(jv8))
    _close(tvs, jvs, dict(atol=0, rtol=1e-6))
    _close(tmean, jmean, dict(atol=1e-6, rtol=1e-6))
    _close(tks, jks, dict(atol=0, rtol=1e-6))
    diff = np.abs(tk8.numpy().astype(np.int32) - np.asarray(jk8, np.int32))
    assert diff.max() <= 1 and diff.mean() < FLIP_SHARE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_pass_plain_matches_jax(rng, dtype):
    """The plain versions of the quantization kernels, which the card holds
    the kernels to bit for bit, equal the JAX quantizers exactly given the
    same K mean: K (centred), V and q int8 values and scales, q's scales
    with scale * log2 e folded in; the lse shift within 1e-5 of JAX's
    scale * einsum (fp32 sums in another order)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, dtype)
    scale = 0.3
    jk8, jks, jv8, jvs, jmean = jsage.sage_quantize_kv(
        jnp.swapaxes(jk, 1, 2), jnp.swapaxes(jv, 1, 2))
    mean = torch.from_numpy(np.asarray(jmean)[:, :, 0])  # (b, h_kv, d)
    tk8, tks, tv8, tvs = tsage.sage_quant_kv_plain(tk, tv, mean)
    assert tk8.shape == (B, S, HKV, D) and tks.shape == (B, HKV, S)
    for got, want in ((tk8.transpose(1, 2), jk8), (tks, jks),
                      (tv8.transpose(1, 2), jv8), (tvs, jvs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jqb = jnp.swapaxes(jq, 1, 2)
    jq8, jqs = jsage._quant_per_token(jqb)
    tq8, tqs, shift = tsage.sage_quant_q_plain(tq, scale, mean)
    np.testing.assert_array_equal(tq8.transpose(1, 2).numpy(),
                                  np.asarray(jq8))
    np.testing.assert_array_equal(
        tqs.numpy(), np.asarray(jqs * (scale * jsage._LOG2E)))
    jshift = scale * jnp.einsum(
        "bhsd,bhd->bhs", jqb.astype(jnp.float32),
        jnp.repeat(jmean[:, :, 0], H // HKV, axis=1))
    _close(shift, jshift, dict(atol=1e-5, rtol=0))
    q8, qs, none = tsage.sage_quant_q_plain(tq, scale)
    assert none is None and torch.equal(q8, tq8) and torch.equal(qs, tqs)
    _close(tsage.sage_k_mean(tk), mean, dict(atol=1e-6, rtol=1e-6))


@pytest.mark.parametrize("entry", ["sage_attention", "prequant"])
def test_quant_pass_per_call(rng, monkeypatch, entry):
    """Each sage call quantizes through the pass: sage_attention runs one
    K/V and one q quantization (with K's mean, for the lse shift); the
    pre-quantized entry only the q one, without a mean."""
    calls = []
    for name in ("sage_quant_kv", "sage_quant_q"):
        real = getattr(tsage, name)
        monkeypatch.setattr(tsage, name, (lambda real, name: (
            lambda *a, **k: calls.append(
                (name, (a[2:] + (k.get("k_mean"),))[0] is not None))
            or real(*a, **k)))(real, name))
    (_, tq), (_, tk), (_, tv) = _qkv(rng, "float32")
    if entry == "sage_attention":
        tsage.sage_attention(tq, tk, tv, causal=True)
        assert calls == [("sage_quant_kv", True), ("sage_quant_q", True)]
    else:
        k8, ks = tkv.quantize_kv(tk, "int8")
        v8, vs = tkv.quantize_kv(tv, "int8")
        tsage.sage_attention_fwd_prequant(tq, k8, v8, ks.transpose(1, 2),
                                          vs.transpose(1, 2), causal=True)
        assert calls == [("sage_quant_q", False)]


# ---------------------------------------------------------------------------
# sage_attention: the plain versions of B8a, B8c, B8b against JAX
# ---------------------------------------------------------------------------

# case -> (kernel, s_q, kwargs)
CASES = {
    "causal": ("B8a", S, dict(causal=True)),
    "causal_scale": ("B8a", S, dict(causal=True, softmax_scale=0.25)),
    "noncausal": ("B8c", S, dict(causal=False)),
    "noncausal_cross": ("B8c", S // 2, dict(causal=False)),
    "offsets": ("B8b", S // 2, dict(causal=True, q_offsets=[64],
                                    kv_offsets=[0])),
    "bottom_right": ("B8b", S // 2, dict(causal=True)),
    "window": ("B8b", S, dict(causal=True, window_size=(64, -1))),
    "window_sinks": ("B8b", S, dict(causal=True, window_size=(64, -1),
                                    sink_tokens=4)),
    "dead_rows": ("B8b", S // 2, dict(causal=True, q_offsets=[0],
                                      kv_offsets=[32])),
}


def _jax_kw(kw):
    return {k: (jnp.asarray(v, jnp.int32) if k.endswith("offsets") else v)
            for k, v in kw.items()}


# bf16 inputs on one case per kernel
PARAMS = ([(case, "float32") for case in sorted(CASES)]
          + [(case, "bfloat16") for case in ("causal", "noncausal",
                                             "window_sinks")])


@pytest.mark.parametrize("case,dtype", PARAMS)
def test_sage_attention_matches_jax(rng, monkeypatch, case, dtype):
    """sage_attention (out and the K-centred lse) == JAX sage_attention,
    GQA g=2, through the JAX package's routing: B8a causal, B8c without a
    mask (s_q != s_kv included), B8b for one-chunk offsets, bottom-right
    s_q != s_kv, a window with and without sinks, and rows that see no
    column (out 0, lse -inf on both sides)."""
    kernel, s_q, kw = CASES[case]
    calls = []
    for name in ("sage_fwd_tri", "sage_fwd_rect", "sage_fwd_pos"):
        real = getattr(tsage, name)
        monkeypatch.setattr(tsage, name, (lambda real, name: (
            lambda *a, **k: calls.append(name) or real(*a, **k)))(real, name))
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, dtype, s_q=s_q)
    jo, jl = jsage.sage_attention(jq, jk, jv, block_sizes=BS,
                                  return_lse=True, **_jax_kw(kw))
    to, tl = tsage.sage_attention(tq, tk, tv, return_lse=True, **kw)
    assert calls == [{"B8a": "sage_fwd_tri", "B8c": "sage_fwd_rect",
                      "B8b": "sage_fwd_pos"}[kernel]]
    assert to.dtype == tq.dtype and tl.dtype == torch.float32
    _out_close(to, jo)
    dead = np.isneginf(_np(jl))
    np.testing.assert_array_equal(np.isneginf(_np(tl)), dead)
    _close(_np(tl)[~dead], _np(jl)[~dead], LSE_TOL)
    if case == "dead_rows":  # rows 0..31 sit before every kv column
        assert dead[:, :, :32].all() and not dead[:, :, 32:].any()
        assert not _np(to)[:, :32].any()


def test_sage_tracks_the_oracle(rng):
    """The port's sage output stays within the JAX suite's int8 gate
    (tests/test_sage.py: 5e-2) of the fp32 oracle, lse included, so the
    K-centring correction is in place."""
    (_, tq), (_, tk), (_, tv) = _qkv(rng, "float32")
    for kw in (dict(causal=True), dict(causal=True, window_size=(64, -1),
                                       sink_tokens=4)):
        to, tl = tsage.sage_attention(tq, tk, tv, return_lse=True, **kw)
        ro, rl = tref.xla_attention(tq, tk, tv, **kw)
        _close(to, ro, dict(atol=5e-2, rtol=0))
        _close(tl, rl, dict(atol=5e-2, rtol=0))


@pytest.mark.parametrize("case", ["causal", "bottom_right", "window_sinks"])
def test_prequant_matches_jax(rng, case):
    """sage_attention_fwd_prequant (B8b over K/V quantized by
    kv_cache.quantize_kv, no centring, no lse shift) == JAX's, on the same
    int8 inputs."""
    s_q = S // 2 if case == "bottom_right" else S
    kw = {"causal": dict(causal=True), "bottom_right": dict(causal=True),
          "window_sinks": dict(causal=True, window_size=(64, -1),
                               sink_tokens=4)}[case]
    (jq, tq), (jk, _), (jv, _) = _qkv(rng, "float32", s_q=s_q)
    jk8, jks = jkv.quantize_kv(jk, "int8")
    jv8, jvs = jkv.quantize_kv(jv, "int8")
    jks, jvs = (jnp.swapaxes(x, 1, 2) for x in (jks, jvs))  # (b, h_kv, s)
    t8 = [torch.from_numpy(np.asarray(x)) for x in (jk8, jv8, jks, jvs)]
    jo, jl = jsage.sage_attention_fwd_prequant(jq, jk8, jv8, jks, jvs,
                                               block_sizes=BS, **kw)
    to, tl = tsage.sage_attention_fwd_prequant(tq, *t8, **kw)
    _out_close(to, jo)
    _close(tl, jl, LSE_TOL)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_registry_names(monkeypatch):
    """The JAX package's three impls; an unknown name raises ValueError
    naming them; register_attn_impl adds one that get_attn_impl and
    ModelConfig then accept."""
    assert sorted(treg.ATTN_IMPLS) == sorted(jreg.ATTN_IMPLS)
    assert treg.get_attn_impl("sage").fwd is tsage.sage_attention_fwd
    with pytest.raises(ValueError, match="available"):
        treg.get_attn_impl("flashinfer")
    xla = treg.ATTN_IMPLS["xla"]
    mine = treg.AttnImpl("mine", xla.full, xla.fwd, xla.bwd)
    monkeypatch.setattr(treg, "ATTN_IMPLS", dict(treg.ATTN_IMPLS))
    treg.register_attn_impl(mine)
    assert treg.get_attn_impl("mine") is mine
    assert tllama.ModelConfig(attn_impl="mine").attn_impl == "mine"


def test_positions_from_descriptor():
    """The port's descriptor expansion == JAX's, one chunk and two, with a
    stride."""
    from long_context_attention_tpu.parallel import layouts as jlay

    for offsets, stride, n in (([5], 1, 8), ([0, 24], 1, 16), ([3, 7], 4,
                                                                  12)):
        want = jlay.positions_from_descriptor(jnp.asarray(offsets), stride, n)
        got = positions_from_descriptor(offsets, stride, n)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("impl", ["xla", "sage"])
def test_registry_fwd_bwd_match_jax(rng, impl):
    """fwd with one-chunk offsets (as a ring step passes them) and bwd on
    the same (out, lse, dout) == the JAX registry's, fp32; sage's bwd is
    the flash backward whatever pv_int8 says."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, "float32", s_q=S // 2)
    kw = dict(causal=True, q_offsets=[64], kv_offsets=[0])
    jkw = dict(_jax_kw(kw), block_sizes=BS) if impl == "sage" else _jax_kw(
        kw)
    jo, jl = jreg.get_attn_impl(impl).fwd(jq, jk, jv, **jkw)
    to, tl = treg.get_attn_impl(impl).fwd(tq, tk, tv, **kw)
    _out_close(to, jo)
    _close(tl, jl, LSE_TOL)
    dout = rng.standard_normal(tq.shape).astype(np.float32)
    bkw = dict(kw, pv_int8=False) if impl == "sage" else kw
    jg = jreg.get_attn_impl(impl).bwd(jq, jk, jv, jo, jl, jnp.asarray(dout),
                                      **dict(_jax_kw(bkw)))
    tg = treg.get_attn_impl(impl).bwd(tq, tk, tv, torch.from_numpy(_np(jo)),
                                      torch.from_numpy(_np(jl)),
                                      torch.from_numpy(dout), **bkw)
    for g, w in zip(tg, jg):
        assert g.dtype == torch.float32
        _leaf_close(g, w, GRAD_TOL)


def test_registry_full_is_differentiable(rng):
    """Each impl's full stage runs forward and backward under autograd; the
    pallas impl is flash_attention itself."""
    from long_context_attention_tpu_torch.ops import flash as tflash

    assert treg.get_attn_impl("pallas").full is tflash.flash_attention
    (_, tq), (_, tk), (_, tv) = _qkv(rng, "float32")
    for name in ("pallas", "xla", "sage"):
        q = tq.clone().requires_grad_()
        out = treg.get_attn_impl(name).full(q, tk, tv, causal=True)
        (g,) = torch.autograd.grad(out.square().sum(), (q,))
        assert torch.isfinite(g).all() and g.abs().max() > 0


# ---------------------------------------------------------------------------
# the straight-through gradient and the reference's full-stage fault
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s_q", [S, S // 2], ids=["self", "bottom_right"])
def test_sage_full_grad_matches_jax(rng, s_q):
    """The gradient of sum(sage_attention_full(q, k, v) * dout) ==
    jax.grad of JAX's (the straight-through flash backward: B5 for
    self-attention, B2a + B2b bottom-right), fp32, each of dq, dk, dv
    within 1e-4 of its largest value."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, "float32", s_q=s_q)
    dout = rng.standard_normal(tq.shape).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jsage.sage_attention_full(q, k, v, causal=True)
                       * dout)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = tsage.sage_attention_full(*leaves, causal=True)
    tg = torch.autograd.grad((out * torch.from_numpy(dout)).sum(), leaves)
    for g, w in zip(tg, jg):
        _leaf_close(g, w, GRAD_TOL)


def test_reference_full_drops_the_window(rng):
    """A fault of the reference the port does not copy: JAX's
    sage_attention_full takes window_size, sink_tokens and offsets but
    computes plain causal attention (sage.py:712-716). The port's full
    stage honours the window and the sinks, as its sage_attention does."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, "float32")
    win = dict(causal=True, window_size=(32, -1), sink_tokens=4)
    jfull = jsage.sage_attention_full(jq, jk, jv, **win)
    jplain = jsage.sage_attention_full(jq, jk, jv, causal=True)
    np.testing.assert_array_equal(np.asarray(jfull), np.asarray(jplain))
    tfull = tsage.sage_attention_full(tq, tk, tv, **win)
    want = tsage.sage_attention(tq, tk, tv, **win)
    assert torch.equal(tfull, want)
    assert float((tfull - tsage.sage_attention(tq, tk, tv, causal=True))
                 .abs().max()) > 1e-1
    ro, _ = tref.xla_attention(tq, tk, tv, **win)
    _close(tfull, ro, dict(atol=5e-2, rtol=0))


# ---------------------------------------------------------------------------
# the raises
# ---------------------------------------------------------------------------


def test_unsupported_raise(rng):
    """What sage does not implement raises rather than runs: softcap,
    dropout, segments (NotImplementedError, as in JAX), pv_int8=True (not
    ported), a gradient through the pre-quantized path, an unknown kwarg
    (TypeError). Position chunks and strides now compute. A gradient
    through a sliding window with sinks now comes back: the straight-through
    flash backward, equal to the fp32 oracle's on the op's own (out, lse)."""
    (_, tq), (_, tk), (_, tv) = _qkv(rng, "float32")
    for kw in (dict(softcap=30.0), dict(dropout_p=0.1),
               dict(q_segment_ids=torch.zeros(B, S, dtype=torch.int32),
                    kv_segment_ids=torch.zeros(B, S, dtype=torch.int32))):
        with pytest.raises(NotImplementedError, match="does not implement"):
            tsage.sage_attention_fwd(tq, tk, tv, **kw)
    k8, ks = tkv.quantize_kv(tk, "int8")
    for fn, args in ((tsage.sage_attention, ()), (tsage.sage_attention_fwd, ()),
                     (tsage.sage_attention_full, ()),
                     (tsage.sage_attention_fwd_prequant,
                      (k8, k8, ks.transpose(1, 2), ks.transpose(1, 2)))):
        with pytest.raises(NotImplementedError, match="pv_int8"):
            fn(tq, *(args or (tk, tv)), causal=True, pv_int8=True)
    # position chunks and strides (the ring layouts) now compute: the
    # identity descriptor in two chunks, or at a common stride, is causal
    # self-attention (B8b's masks against B8a's)
    want = tsage.sage_attention(tq, tk, tv, causal=True)
    for pos in (dict(q_offsets=[0, S // 2], kv_offsets=[0, S // 2]),
                dict(q_offsets=[0], kv_offsets=[0], q_stride=2,
                     kv_stride=2)):
        got = tsage.sage_attention(tq, tk, tv, causal=True, **pos)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    win = dict(causal=True, window_size=(16, -1), sink_tokens=3)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out, lse = tsage.sage_attention(*leaves, return_lse=True, **win)
    dout = torch.from_numpy(rng.standard_normal(tq.shape).astype(np.float32))
    got = torch.autograd.grad((out * dout).sum(), leaves)
    want = tref.xla_attention_bwd(tq, tk, tv, out.detach(), lse.detach(),
                                  dout, **win)
    for g, w in zip(got, want):
        _leaf_close(g, w, 1e-5)
    with pytest.raises(NotImplementedError, match="forward-only"):
        tsage.sage_attention_fwd_prequant(
            tq.clone().requires_grad_(), k8, k8, ks.transpose(1, 2),
            ks.transpose(1, 2))
    with pytest.raises(TypeError, match="unexpected"):
        tsage.sage_attention_full(tq, tk, tv, tri_grid=True)


def test_model_config_sage_raises():
    """attn_impl takes the registry's names (an unknown one raises
    ValueError); with sage, safe_softmax raises ValueError (ring.py:117)
    and softcap NotImplementedError (sage's _vet_kwargs); a windowed sage
    config serves and now trains too: loss_local's gradient comes back
    finite, and make_train_step's loss is loss_local's."""
    with pytest.raises(ValueError, match="available"):
        tllama.ModelConfig(attn_impl="flashinfer")
    with pytest.raises(ValueError, match="safe_softmax"):
        tllama.ModelConfig(attn_impl="sage", safe_softmax=True)
    with pytest.raises(NotImplementedError, match="softcap"):
        tllama.ModelConfig(attn_impl="sage", softcap=30.0)
    cfg = tllama.ModelConfig(attn_impl="sage", window_left=8, sink_tokens=2)
    params = tllama.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    tokens = torch.randint(0, cfg.vocab, (1, 16),
                           generator=torch.Generator().manual_seed(1))
    leaves = tllama.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = tllama.loss_local(params, tokens, tokens, torch.ones(1, 16), cfg)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in leaves)
    with torch.no_grad():
        want = float(tllama.loss_local(params, tokens, tokens,
                                       torch.ones(1, 16), cfg))
    step = tllama.make_train_step(cfg, torch.optim.SGD, device="cpu")
    _, _, got = step(params, None, tokens, tokens, torch.ones(1, 16))
    assert float(got) == want


# ---------------------------------------------------------------------------
# the tiny model with attn_impl="sage"
# ---------------------------------------------------------------------------

SHAPE = dict(vocab=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=32, ffn_hidden=128, layout="basic")
WINDOWED = dict(window_left=24, sink_tokens=8)
PROMPT_LEN, S_MAX, CHUNK, NEW = 48, 64, 16, 4
PROMPT_SEED = 11  # tie-free greedy decode of the sage model (see below)
BF16_LOGITS = dict(atol=5e-2, rtol=0)


@pytest.fixture(scope="module")
def models():
    jparams = jllama.init_params(jax.random.PRNGKey(3),
                                 jllama.ModelConfig(**SHAPE))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    prompt = np.random.default_rng(PROMPT_SEED).integers(
        0, SHAPE["vocab"], (B, PROMPT_LEN)).astype(np.int32)
    return jparams, tparams, prompt


def _cfgs(**kw):
    return (jllama.ModelConfig(**SHAPE, attn_impl="sage", **kw),
            tllama.ModelConfig(**SHAPE, attn_impl="sage", **kw))


def _jax_forward(jcfg, params, tokens):
    axes = MeshAxes()
    tok = P(axes.dp, axes.seq)

    def fwd(p, t):
        return jllama.forward_local(p, t, jcfg, ulysses_axis=axes.ulysses,
                                    ring_axis=axes.ring)

    f = jax.jit(jax.shard_map(fwd, mesh=make_usp_mesh(1, 1, 1),
                              in_specs=(P(), tok), out_specs=tok,
                              check_vma=False))
    return f(params, jnp.asarray(tokens))


@pytest.mark.parametrize("windowed", [False, True], ids=["dense", "window"])
def test_sage_model_prefill_matches_jax(models, windowed):
    """forward_local's logits at every position and Engine.prefill's
    last-token logits and cache, dense (B8a in every layer) and with window
    24 and 8 sinks (B8b), against the JAX model with attn_impl="sage"."""
    jparams, tparams, prompt = models
    jcfg, tcfg = _cfgs(**(WINDOWED if windowed else {}))
    jl = _jax_forward(jcfg, jparams, prompt)
    with torch.no_grad():
        tl = tllama.forward_local(tparams, torch.from_numpy(prompt), tcfg)
    _close(tl, jl, BF16_LOGITS)
    je = jeng.Engine(cfg=jcfg, s_max=S_MAX)
    te = teng.Engine(cfg=tcfg, s_max=S_MAX, device="cpu")
    jlast, jc = je.prefill(jparams, jnp.asarray(prompt))
    tlast, tc = te.prefill(tparams, torch.from_numpy(prompt))
    _close(tlast, jlast, BF16_LOGITS)
    _close(tc.k, jc.k, BF16_LOGITS)
    _close(tc.v, jc.v, BF16_LOGITS)


def test_sage_generate_matches_jax(models):
    """Engine.generate of the sage model (sage prefill, then decode on
    kernels B6 and B7, as in JAX): the same greedy tokens as JAX's engine
    on a prompt whose top-2 logit gap stays above 0.16 at every step (3x
    the logit gate), and prefill logits within the bf16 gate."""
    jparams, tparams, prompt = models
    jcfg, tcfg = _cfgs()
    jres = jeng.Engine(cfg=jcfg, s_max=S_MAX).generate(
        jparams, jnp.asarray(prompt), NEW, key=jax.random.PRNGKey(0))
    tres = teng.Engine(cfg=tcfg, s_max=S_MAX, device="cpu").generate(
        tparams, torch.from_numpy(prompt), NEW)
    _close(tres.prefill_logits, jres.prefill_logits, BF16_LOGITS)
    assert tres.tokens.tolist() == np.asarray(jres.tokens).tolist()


def test_sage_chunked_prefill_runs_the_flash_kernels(models, monkeypatch):
    """prefill_chunked and decode of a sage config run the flash and
    decode kernels, as the JAX package's do (prefill_chunk_step calls
    flash_attention_fwd directly): no sage kernel launches, and the logits
    equal the pallas config's bit for bit."""
    _, tparams, prompt = models
    calls = []
    for name in ("sage_fwd_tri", "sage_fwd_rect", "sage_fwd_pos"):
        monkeypatch.setattr(tsage, name,
                            lambda *a, **k: calls.append(1))
    tcfg = _cfgs()[1]
    got, gc = teng.Engine(cfg=tcfg, s_max=S_MAX, device="cpu").prefill_chunked(
        tparams, torch.from_numpy(prompt), CHUNK)
    pallas = dataclasses.replace(tcfg, attn_impl="pallas")
    want, wc = teng.Engine(cfg=pallas, s_max=S_MAX,
                           device="cpu").prefill_chunked(
        tparams, torch.from_numpy(prompt), CHUNK)
    tok = torch.argmax(got, -1).to(torch.int32)
    d1, _ = tllama.decode_step(tparams, gc, tok, tcfg)
    d2, _ = tllama.decode_step(tparams, wc, tok, pallas)
    assert calls == []
    assert torch.equal(got, want) and torch.equal(d1, d2)


def _jax_loss_and_grads(jcfg, params, tokens, labels, mask):
    axes = MeshAxes()
    tok = P(axes.dp, axes.seq)

    def lg(p, t, lab, m):
        def lf(pp):
            return jllama.loss_local(pp, t, lab, m, jcfg,
                                     ulysses_axis=axes.ulysses,
                                     ring_axis=axes.ring, dp_axis=axes.dp)
        return jax.value_and_grad(lf)(p)

    f = jax.jit(jax.shard_map(lg, mesh=make_usp_mesh(1, 1, 1),
                              in_specs=(P(), tok, tok, tok),
                              out_specs=(P(), P()), check_vma=False))
    return f(params, *map(jnp.asarray, (tokens, labels, mask)))


def _leaves(tree):
    """Leaves in jax.tree.leaves order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_sage_loss_and_grads_match_jax(models):
    """loss_local and every parameter gradient of the sage model (B8a
    forward, the straight-through B5 backward) == JAX's under a 1x1x1 USP
    mesh (B8b forward, B2a + B2b backward), bf16 weights."""
    jparams, tparams, prompt = models
    jcfg, tcfg = _cfgs()
    labels = np.roll(prompt, -1, axis=1)
    mask = np.ones(prompt.shape, np.float32)
    mask[:, -1] = 0
    jloss, jgrads = _jax_loss_and_grads(jcfg, jparams, prompt, labels, mask)
    params = {k: ({kk: vv.clone().requires_grad_() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.clone().requires_grad_())
              for k, v in tparams.items()}
    loss = tllama.loss_local(params, *map(torch.from_numpy,
                                          (prompt, labels, mask)), tcfg)
    loss.backward()
    assert abs(float(loss) - float(jloss)) < 2e-3
    got = [t.grad for t in _leaves(params)]
    want = jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _leaf_close(g, w, 0.05)


@pytest.mark.parametrize("remat,fwd_per_layer",
                         [("none", 1), ("full", 2), ("attn", 1)])
def test_sage_remat_attention_recompute(monkeypatch, remat, fwd_per_layer):
    """remat="attn" keeps the sage op's (out, lse), so the backward does
    not run kernel B8a again; "full" does: the launch counts the card
    checks."""
    calls = []
    real = tsage.sage_fwd_tri
    monkeypatch.setattr(tsage, "sage_fwd_tri",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = tllama.ModelConfig(**SHAPE, attn_impl="sage", remat=remat,
                             dtype=torch.float32)
    params = tllama.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    tokens = torch.randint(0, SHAPE["vocab"], (1, 16),
                           generator=torch.Generator().manual_seed(1))
    step = tllama.make_train_step(cfg, torch.optim.SGD, device="cpu")
    _, _, loss = step(params, torch.optim.SGD(tllama.param_leaves(params),
                                              lr=0.1),
                      tokens, torch.roll(tokens, -1, 1), torch.ones(1, 16))
    assert torch.isfinite(loss)
    assert len(calls) == fwd_per_layer * SHAPE["n_layers"]
