"""The windowed backward of the port against the JAX package, on the same
numpy inputs: the plain versions of kernels B2a (dq), B2b (dk, dv) and B5
(all three) with sliding windows, StreamingLLM sinks and softcap against
JAX's ``flash_attention_bwd``; ``torch.autograd`` through ``flash_attention``
and ``flash_attention_fwd`` in both dispatches against ``jax.grad``; the sage
straight-through gradient under a window against the JAX registry's sage
stages; and a tiny windowed, sinked and softcapped model's ``loss_local``
gradients and two ``make_train_step`` steps against JAX's.

The JAX kernels run in interpret mode, as the JAX suite runs them on the
CPU: with one-chunk offsets the two-kernel path (sites :1583 / :1707),
without them the static pair (:1561 / :1684), which is what JAX runs for
B5's call on the CPU (B5 itself is compiled-only). Every case is GQA (4
query heads on 2 kv heads), S = 128 in tiles of 64, so each window drops
whole tiles and cuts others.

Tolerances:
* fp32, atol/rtol 1e-5 (model leaves: 1e-5 of the leaf's largest value):
  the same fp32 arithmetic on both sides, summed in another order; softcap
  adds one tanh per score on both sides, and a model adds two layers.
* bf16, atol 1e-1: both sides cast p and ds to bf16 before the dV / dK /
  dQ products, so an element on a rounding boundary may round the other
  way, and the autograd grads round to bf16 at the end (one ulp is 2^-8 of
  a value, the gradients here are |x| < 8).
* sage, 1e-4 of each gradient's largest value (tests/test_torch_sage.py's
  GRAD_TOL): each side's straight-through backward is anchored on its own
  int8 forward, whose outputs agree to the last int8 level; sage outputs,
  atol 2e-2 (tests/test_torch_sage.py's OUT_TOL, for the same reason).
* two train steps, fp32: losses within 1e-5 and each parameter's change
  within 2e-5 (tests/test_torch_train.py's limits and reasons).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from long_context_attention_tpu.models import llama as jllama
from long_context_attention_tpu.ops import flash as jflash
from long_context_attention_tpu.ops import registry as jreg
from long_context_attention_tpu.ops import sage as jsage
from long_context_attention_tpu.parallel import make_usp_mesh
from long_context_attention_tpu.parallel.mesh import MeshAxes
from long_context_attention_tpu.utils.config import BlockSizes
from long_context_attention_tpu_torch.models import llama as tllama
from long_context_attention_tpu_torch.ops import flash as tflash
from long_context_attention_tpu_torch.ops import sage as tsage
from long_context_attention_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

B, S, H, HKV, D = 1, 128, 4, 2, 32
BS = BlockSizes(64, 64)
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-1, rtol=0)
SAGE_TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the masks of the backward: flash_attention kwargs
CASES = {
    # tests/test_sinks.py:65's window and sinks
    "window_80_sinks_37": dict(causal=True, window_size=(80, -1),
                               sink_tokens=37),
    "causal_left_window": dict(causal=True, window_size=(50, -1)),
    "noncausal_window": dict(causal=False, window_size=(40, 30)),
    "softcap": dict(causal=True, softcap=5.0),
    "softcap_window": dict(causal=True, window_size=(50, -1), softcap=5.0),
}
# one-chunk offsets: the kv block half a sequence ahead, so the first half
# of the rows see nothing (dq 0) and the last half of kv rows no row sees
DEAD = dict(causal=True, window_size=(50, -1), sink_tokens=4, softcap=5.0,
            q_offsets=[0], kv_offsets=[S // 2])


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _inputs(rng, dtype):
    """q, k, v, dout as (jax, torch) pairs of the same values."""
    jd, td = DTYPES[dtype]
    out = []
    for shape in ((B, S, H, D), (B, S, HKV, D), (B, S, HKV, D), (B, S, H, D)):
        j = jnp.asarray(rng.standard_normal(shape).astype(np.float32), jd)
        out.append((j, torch.from_numpy(_np(j)).to(td)))
    return out


def _assert_grads(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **tol)


def _shape(kw):
    """The mask kwargs of a case, without its offsets."""
    return {n: v for n, v in kw.items()
            if n not in ("q_offsets", "kv_offsets")}


@pytest.mark.parametrize("dtype,case", [
    *(("float32", c) for c in sorted(CASES) + ["offsets_dead"]),
    ("bfloat16", "window_80_sinks_37"), ("bfloat16", "softcap_window"),
    ("bfloat16", "offsets_dead")])
def test_plain_backward_matches_jax(rng, dtype, case):
    """B2a's and B2b's plain versions (with one-chunk offsets) and B5's
    (static self-attention) == JAX flash_attention_bwd with the same masks,
    on the JAX forward's own out and lse; so does the port's
    flash_attention_bwd entry, which dispatches as JAX's does."""
    kw = DEAD if case == "offsets_dead" else CASES[case]
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(rng, dtype)
    pairs = [(kw, "pos")] if case == "offsets_dead" else [
        (dict(kw, q_offsets=[0], kv_offsets=[0]), "pos"), (kw, "static")]
    for ckw, route in pairs:
        jo, jl = jflash.flash_attention_fwd(jq, jk, jv, block_sizes=BS, **ckw)
        want = jflash.flash_attention_bwd(jq, jk, jv, jo, jl, jdo,
                                          block_sizes=BS, **ckw)
        to = torch.from_numpy(_np(jo)).to(tq.dtype)
        tl = torch.from_numpy(_np(jl))
        delta = (tdo.float() * to.float()).sum(-1).transpose(1, 2)
        args = (tq, tk, tv, tdo, tl, delta.contiguous())
        shape = dict(_shape(ckw), scale=D ** -0.5)
        if route == "pos":
            q0 = ckw["q_offsets"][0] - ckw["kv_offsets"][0]
            shape["sink_tokens"] = max(
                shape.get("sink_tokens", 0) - ckw["kv_offsets"][0], 0)
            got = (tflash.flash_bwd_dq_plain(*args, q_start=q0, **shape),
                   *tflash.flash_bwd_dkv_plain(*args, q_start=q0, **shape))
        else:
            got = tflash.flash_bwd_fused_plain(*args, **shape)
        assert all(g.dtype == torch.float32 for g in got)
        _assert_grads(got, want, _tol(dtype))
        _assert_grads(tflash.flash_attention_bwd(tq, tk, tv, to, tl, tdo,
                                                 **ckw), want, _tol(dtype))
    if case == "offsets_dead":
        half = S // 2
        assert not got[0][:, :half].any()
        assert not got[1][:, half:].any() and not got[2][:, half:].any()


@pytest.mark.parametrize("dtype,dispatch,entry", [
    *((d, c, "flash_attention") for d in ("float32", "bfloat16")
      for c in ("static", "offsets", "offsets_dead")),
    ("float32", "static", "flash_attention_fwd"),
    ("float32", "offsets", "flash_attention_fwd")])
def test_autograd_matches_jax_grad(rng, monkeypatch, dtype, dispatch, entry):
    """torch.autograd through the port's flash_attention and
    flash_attention_fwd, with the window, sinks and softcap (static: B4 +
    B5; with offsets: B3 + B2a + B2b, each launched once) == jax.grad
    through the JAX flash_attention, for the loss sum(out * dout)."""
    calls = []
    for name in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"):
        real = getattr(tflash, name)
        monkeypatch.setattr(tflash, name, (lambda real, name: (
            lambda *a, **k: calls.append(name) or real(*a, **k)))(real, name))
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(rng, dtype)
    kw = {"static": dict(CASES["window_80_sinks_37"], softcap=5.0),
          "offsets": dict(CASES["window_80_sinks_37"], softcap=5.0,
                          q_offsets=[0], kv_offsets=[0]),
          "offsets_dead": DEAD}[dispatch]

    def jloss(q, k, v):
        out = jflash.flash_attention(q, k, v, block_sizes=BS, **kw)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    if entry == "flash_attention":
        out = tflash.flash_attention(q, k, v, **kw)
    else:
        out, _ = tflash.flash_attention_fwd(q, k, v, **kw)
    np.testing.assert_allclose(
        _np(out), _np(jflash.flash_attention(jq, jk, jv, block_sizes=BS,
                                             **kw)), **_tol(dtype))
    (out.float() * tdo.float()).sum().backward()
    assert q.grad.dtype == tq.dtype
    _assert_grads((q.grad, k.grad, v.grad), want, _tol(dtype))
    assert calls == (["flash_bwd_fused"] if dispatch == "static"
                     else ["flash_bwd_dq", "flash_bwd_dkv"])


def test_sinks_are_global_positions_under_kv_offsets(rng):
    """With kv offsets, StreamingLLM's sinks are the kv columns at global
    positions below sink_tokens (JAX's masks compare global positions):
    with kv_offsets [32] and 40 sinks, the block's first 8 columns. The
    port's flash_attention (forward and gradient) and sage_attention ==
    JAX's."""
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(rng, "float32")
    kw = dict(causal=True, window_size=(24, -1), sink_tokens=40,
              q_offsets=[48], kv_offsets=[32])

    def jloss(q, k, v):
        return jnp.sum(jflash.flash_attention(q, k, v, block_sizes=BS, **kw)
                       * jdo)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    out = tflash.flash_attention(q, k, v, **kw)
    np.testing.assert_allclose(
        _np(out), _np(jflash.flash_attention(jq, jk, jv, block_sizes=BS,
                                             **kw)), **F32_TOL)
    (out * tdo).sum().backward()
    _assert_grads((q.grad, k.grad, v.grad), want, F32_TOL)
    np.testing.assert_allclose(
        _np(tsage.sage_attention(tq, tk, tv, **kw)),
        _np(jsage.sage_attention(jq, jk, jv, block_sizes=BS, **kw)),
        atol=2e-2, rtol=0)


def test_sage_straight_through_window_matches_jax(rng, monkeypatch):
    """The gradient of sum(sage_attention(q, k, v) * dout) with a window
    and sinks (the straight-through flash backward on the op's own out and
    lse) == the JAX registry's sage stages: its fwd, then its bwd (JAX's
    flash_attention_bwd with the same kwargs) on JAX's out and lse. A
    windowed self-attention call without offsets is static there, so the
    port runs B5, not B2a + B2b."""
    calls = []
    for name in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"):
        real = getattr(tflash, name)
        monkeypatch.setattr(tflash, name, (lambda real, name: (
            lambda *a, **k: calls.append(name) or real(*a, **k)))(real, name))
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(rng, "float32")
    kw = dict(causal=True, window_size=(80, -1), sink_tokens=37)
    sage = jreg.get_attn_impl("sage")
    jo, jl = sage.fwd(jq, jk, jv, block_sizes=BS, **kw)
    want = sage.bwd(jq, jk, jv, jo, jl, jdo, pv_int8=False, **kw)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = tsage.sage_attention(*leaves, **kw)
    got = torch.autograd.grad((out * tdo).sum(), leaves)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert np.abs(g - w).max() <= SAGE_TOL * np.abs(w).max()
    assert calls == ["flash_bwd_fused"]


# ---------------------------------------------------------------------------
# a tiny windowed, sinked and softcapped model
# ---------------------------------------------------------------------------

DIMS = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=8, ffn_hidden=64, layout="basic")
# the sequence (64) is longer than the window (16), so the window drops
# columns, and the sinks keep the first 4 positions in every row's view
SHAPE = dict(window_left=16, sink_tokens=4, softcap=5.0)
MB, MS = 2, 64
LR, WD = 1e-3, 1e-4  # optax.adamw(1e-3): weight decay 1e-4


def _cfgs():
    return (jllama.ModelConfig(**DIMS, **SHAPE, dtype=jnp.float32),
            tllama.ModelConfig(**DIMS, **SHAPE, dtype=torch.float32))


def _batch(rng):
    tokens = rng.integers(0, DIMS["vocab"], size=(MB, MS)).astype(np.int32)
    mask = np.ones((MB, MS), np.float32)
    mask[:, -1] = 0
    return tokens, np.roll(tokens, -1, axis=1), mask


def _leaves(tree):
    """Leaves in jax.tree.leaves order (dict keys sorted), as numpy."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().float().numpy()]
    return [np.asarray(tree, np.float32)]


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """(numpy params, batch, JAX loss, JAX gradient leaves) on seed 0,
    under a 1x1x1 USP mesh (the ring step's one-chunk offsets: B3 forward,
    B2a + B2b backward, interpret mode)."""
    jcfg, _ = _cfgs()
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch(np.random.default_rng(0))
    axes = MeshAxes()
    tok = P(axes.dp, axes.seq)

    def lg(p, t, lab, m):
        return jax.value_and_grad(lambda pp: jllama.loss_local(
            pp, t, lab, m, jcfg, ulysses_axis=axes.ulysses,
            ring_axis=axes.ring, dp_axis=axes.dp))(p)

    f = jax.jit(jax.shard_map(lg, mesh=make_usp_mesh(1, 1, 1),
                              in_specs=(P(), tok, tok, tok),
                              out_specs=(P(), P()), check_vma=False))
    jloss, jgrads = f(jparams, *map(jnp.asarray, batch))
    return (jax.tree.map(np.asarray, jparams), batch, float(jloss),
            _leaves(jgrads))


@pytest.mark.parametrize("remat", ["none", "attn"])
def test_windowed_loss_and_grads_match_jax(remat):
    """loss_local and every parameter gradient of the windowed model (B4
    forward and B5 backward, plain versions) == JAX's, fp32, each leaf
    within 1e-5 of its largest value, without remat and with remat="attn"
    (which keeps the windowed forward out of the recompute)."""
    params_np, batch, jloss, jgrads = _jax_reference()
    _, tcfg = _cfgs()
    params = params_from_jax(params_np, device="cpu")
    for p in tllama.param_leaves(params):
        p.requires_grad_(True)
    loss = tllama.loss_local(params, *map(torch.from_numpy, batch),
                             dataclasses.replace(tcfg, remat=remat))
    loss.backward()
    assert abs(float(loss.detach()) - jloss) < 1e-5
    got = _leaves({k: ({kk: vv.grad for kk, vv in v.items()}
                       if isinstance(v, dict) else v.grad)
                   for k, v in params.items()})
    assert len(got) == len(jgrads)
    for g, w in zip(got, jgrads):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


def test_windowed_train_step_matches_jax(rng):
    """Two make_train_step steps of the windowed model (AdamW lr 1e-3,
    weight decay 1e-4) == two steps of the JAX make_train_step with
    optax.adamw(1e-3), fp32: each step's loss, and each parameter's change
    over the two."""
    jcfg, tcfg = _cfgs()
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    p0 = jax.tree.map(np.asarray, jparams)
    batches = [_batch(rng), _batch(rng)]
    opt = optax.adamw(LR)
    jstep = jllama.make_train_step(jcfg, make_usp_mesh(1, 1, 1), opt)
    jstate, jlosses = opt.init(jparams), []
    for batch in batches:
        jparams, jstate, jloss = jstep(jparams, jstate,
                                       *map(jnp.asarray, batch))
        jlosses.append(float(jloss))
    step = tllama.make_train_step(
        tcfg, functools.partial(torch.optim.AdamW, lr=LR, weight_decay=WD),
        device="cpu")
    params, state, losses = params_from_jax(p0, device="cpu"), None, []
    for batch in batches:
        params, state, loss = step(params, state,
                                   *map(torch.from_numpy, batch))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=0)
    for p, jp, p_old in zip(_leaves(params), _leaves(jparams), _leaves(p0)):
        assert np.abs(jp - p_old).max() > LR  # the step moved this leaf
        np.testing.assert_allclose(p - p_old, jp - p_old, atol=2e-5, rtol=0)
