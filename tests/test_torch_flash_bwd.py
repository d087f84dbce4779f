"""The flash backward of the port against the JAX package, on the same numpy
inputs: the plain versions of kernels B2a (dq), B2b (dk, dv) and B5 (all
three in one pass), the autograd ``flash_attention`` in both of its
dispatches, ``flash_attention_bwd`` and ``xla_attention_bwd``. The JAX
kernels run in interpret mode: with one-chunk offsets the two-kernel path
(sites :1583 / :1707), without them the static pair (:1561 / :1684), which
is what JAX runs for B5's call on the CPU (B5 itself is compiled-only).

Tolerances (``tests/test_flash.py:139-141``):
* fp32 inputs, atol/rtol 1e-5: the same fp32 arithmetic on both sides, in
  another summation order.
* bf16 inputs, atol 2e-2: both sides cast p and ds to bf16 before the
  dV / dK / dQ products, and a product that lands on a bf16 rounding
  boundary can round the other way when its fp32 sum runs in another
  order; the autograd grads are rounded to bf16 at the end (one ulp is
  2^-8 relative, gradients here are |x| < 2). Against the fp32 oracle the
  bf16 casts themselves count, which the same limit covers at these sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu.ops import flash as jflash
from long_context_attention_tpu.ops import reference as jref
from long_context_attention_tpu.utils.config import BlockSizes
from long_context_attention_tpu_torch.ops import flash as tflash
from long_context_attention_tpu_torch.ops import reference as tref

torch.set_num_threads(1)

B, S, H, HKV, D = 1, 128, 4, 2, 32
BS = BlockSizes(64, 64)
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=0)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (causal, q_offset, kv_offset): one-chunk offsets of the ring step; "dead"
# puts the kv block half a sequence ahead, so the first half of the rows
# see no column (out 0, lse -inf, zero gradient)
OFFSET_CASES = {"causal": (True, 0, 0), "noncausal": (False, 0, 0),
                "dead": (True, 0, S // 2)}


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(x, np.float32)


def _inputs(rng, dtype):
    """q, k, v, dout as (jax, torch) pairs of the same values."""
    jd, td = DTYPES[dtype]
    shapes = ((B, S, H, D), (B, S, HKV, D), (B, S, HKV, D), (B, S, H, D))
    out = []
    for shape in shapes:
        x = rng.standard_normal(shape).astype(np.float32)
        j = jnp.asarray(x, jd)
        out.append((j, torch.from_numpy(_np(j)).to(td)))
    return out


def _delta(dout, out):
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _assert_grads(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **tol)


@pytest.mark.parametrize("case", sorted(OFFSET_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_kernel_plain_matches_jax(rng, dtype, case):
    """B2a's and B2b's plain versions == JAX flash_attention_bwd with
    one-chunk offsets (the dynamic two-kernel path), on the JAX forward's
    own out and lse; the port's flash_attention_bwd entry and its fp32
    oracle agree as well."""
    causal, q_off, kv_off = OFFSET_CASES[case]
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(rng, dtype)
    kw = dict(causal=causal, q_offsets=[q_off], kv_offsets=[kv_off])
    jo, jl = jflash.flash_attention_fwd(jq, jk, jv, block_sizes=BS, **kw)
    want = jflash.flash_attention_bwd(jq, jk, jv, jo, jl, jdo,
                                      block_sizes=BS, **kw)
    to = torch.from_numpy(_np(jo)).to(tq.dtype)
    tl = torch.from_numpy(_np(jl))
    args = (tq, tk, tv, tdo, tl, _delta(tdo, to))
    pkw = dict(scale=D ** -0.5, q_start=q_off - kv_off, causal=causal)
    dq = tflash.flash_bwd_dq_plain(*args, **pkw)
    dk, dv = tflash.flash_bwd_dkv_plain(*args, **pkw)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    _assert_grads((dq, dk, dv), want, _tol(dtype))
    _assert_grads(tflash.flash_attention_bwd(tq, tk, tv, to, tl, tdo, **kw),
                  want, _tol(dtype))
    pos = dict(q_positions=torch.arange(S) + q_off,
               kv_positions=torch.arange(S) + kv_off)
    oracle = tref.xla_attention_bwd(tq, tk, tv, to, tl, tdo, causal=causal,
                                    **pos)
    _assert_grads((dq, dk, dv), oracle, _tol(dtype))
    if case == "dead":  # rows that see nothing, kv rows nobody sees
        assert not dq[:, :kv_off].any()
        assert not dk[:, S - kv_off:].any() and not dv[:, S - kv_off:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_plain_matches_jax_vjp(rng, dtype):
    """B5's plain version == jax.vjp of flash_attention without offsets
    (JAX's static backward), on the JAX forward's out and lse."""
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(rng, dtype)
    (jo, jl), vjp = jax.vjp(
        lambda q, k, v: jflash.flash_attention(q, k, v, causal=True,
                                               block_sizes=BS,
                                               return_lse=True),
        jq, jk, jv)
    want = vjp((jdo, jnp.zeros_like(jl)))
    to = torch.from_numpy(_np(jo)).to(tq.dtype)
    tl = torch.from_numpy(_np(jl))
    got = tflash.flash_bwd_fused_plain(tq, tk, tv, tdo, tl, _delta(tdo, to),
                                       scale=D ** -0.5, causal=True)
    # JAX returns the grads in the inputs' dtype
    _assert_grads([g.to(tq.dtype) for g in got], want, _tol(dtype))
    oracle = tref.xla_attention_bwd(tq, tk, tv, to, tl, tdo, causal=True)
    _assert_grads(got, oracle, _tol(dtype))


@pytest.mark.parametrize("dispatch", ["static", "offsets", "dead"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_matches_jax_grad(rng, dtype, dispatch):
    """The port's differentiable flash_attention (static: B1 + B5; with
    offsets: B3 + B2a + B2b) == jax.grad through the JAX flash_attention,
    for the loss sum(out * dout)."""
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(rng, dtype)
    kw = {} if dispatch == "static" else dict(
        q_offsets=[0], kv_offsets=[S // 2 if dispatch == "dead" else 0])

    def jloss(q, k, v):
        out = jflash.flash_attention(q, k, v, causal=True, block_sizes=BS,
                                     **kw)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    out = tflash.flash_attention(q, k, v, causal=True, **kw)
    np.testing.assert_allclose(
        _np(out), _np(jflash.flash_attention(jq, jk, jv, causal=True,
                                             block_sizes=BS, **kw)),
        **_tol(dtype))
    (out.float() * tdo.float()).sum().backward()
    assert q.grad.dtype == tq.dtype
    _assert_grads((q.grad, k.grad, v.grad), want, _tol(dtype))


def test_bottom_right_alignment_matches_jax(rng):
    """s_q < s_kv without offsets aligns the causal mask bottom-right (the
    JAX API's rule): B3 + B2a + B2b with q_start = s_kv - s_q, fp32, against
    jax.grad and the port's fp32 oracle."""
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(rng, "float32")
    jq, tq, jdo, tdo = jq[:, S // 2:], tq[:, S // 2:], jdo[:, S // 2:], \
        tdo[:, S // 2:]

    def jloss(q, k, v):
        out = jflash.flash_attention(q, k, v, causal=True, block_sizes=BS)
        return jnp.sum(out * jdo)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    out, lse = tflash.flash_attention(q, k, v, causal=True, return_lse=True)
    (out * tdo).sum().backward()
    _assert_grads((q.grad, k.grad, v.grad), want, F32_TOL)
    oracle = tref.xla_attention_bwd(tq, tk, tv, out.detach(), lse.detach(),
                                    tdo, causal=True)
    _assert_grads((q.grad, k.grad, v.grad), oracle, F32_TOL)


def test_xla_attention_bwd_matches_jax(rng):
    """The port's fp32 oracle == JAX xla_attention_bwd, GQA, with global
    positions that leave rows dead."""
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(rng, "float32")
    pos = dict(q_positions=np.arange(S) - 16, kv_positions=np.arange(S))
    jo, jl = jref.xla_attention(jq, jk, jv, causal=True,
                                **{k: jnp.asarray(v) for k, v in pos.items()})
    want = jref.xla_attention_bwd(jq, jk, jv, jo, jl, jdo, causal=True,
                                  **{k: jnp.asarray(v)
                                     for k, v in pos.items()})
    tpos = {k: torch.from_numpy(v) for k, v in pos.items()}
    to, tl = tref.xla_attention(tq, tk, tv, causal=True, **tpos)
    got = tref.xla_attention_bwd(tq, tk, tv, to, tl, tdo, causal=True, **tpos)
    _assert_grads(got, want, F32_TOL)
    assert not got[0][:, :16].any()


def test_backward_unported_features_raise():
    """Offsets of more than one chunk (ring layouts) and non-causal
    self-attention without offsets (kernel B4) raise."""
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="position chunks"):
        tflash.flash_attention(q, q, q, causal=True, q_offsets=[0, 4],
                               kv_offsets=[0, 4])
    with pytest.raises(NotImplementedError, match="B4"):
        tflash.flash_attention(q, q, q, causal=False)
    with pytest.raises(NotImplementedError):
        tflash.flash_attention_bwd(q, q, q, q, torch.zeros(1, 2, 8), q,
                                   causal=True, window_size=(4, -1))
