"""The port's training side against the JAX package on the same weights and
batch: ``loss_local`` and its gradients, one ``make_train_step`` step (AdamW,
weight decay set to optax's 1e-4 explicitly), the remat policies, and the
step's device rule.

The JAX side runs under ``make_usp_mesh(1, 1, 1)`` on the CPU, its attention
through the ring step's one-chunk offsets (B3 forward, B2a + B2b backward,
interpret mode); the port runs B1 + B5 (plain versions on the CPU): two
backward families for one function.

Tolerances:
* fp32 weights: loss and each gradient leaf (against its largest value)
  within 1e-5: fp32 sums in another order through two layers; the same
  under every remat policy, against no remat and against JAX;
* bf16 weights: loss within 2e-3, each leaf within 0.05 of its largest
  value, the JAX suite's sharded-vs-single gradient gate
  (``tests/test_model.py:181``): bf16 activations round at other places;
* two train steps, fp32: losses within 1e-5 and each parameter's change
  within 2e-5, 1% of the most two steps at lr 1e-3 can move it. A first
  AdamW step moves an element by about lr * sign(g), so a missing update
  or a gradient of the wrong sign fails; the second step's move depends on
  the ratio of the two steps' gradients. (Adam does not see a gradient's
  overall scale: the gradient tests hold that.) The worst element came to
  4.5e-6, where its gradient is near 0 and its sign is rounding noise.
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
from long_context_attention_tpu.parallel import make_usp_mesh
from long_context_attention_tpu.parallel.mesh import MeshAxes
from long_context_attention_tpu_torch.models import llama as tllama
from long_context_attention_tpu_torch.ops import flash as tflash
from long_context_attention_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

DIMS = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=8, ffn_hidden=64, layout="basic")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 64
LR, WD = 1e-3, 1e-4  # optax.adamw(1e-3): weight decay 1e-4


def _cfgs(dtype, **kw):
    jd, td = DTYPES[dtype]
    return (jllama.ModelConfig(**DIMS, dtype=jd, **kw),
            tllama.ModelConfig(**DIMS, dtype=td, **kw))


def _batch(rng):
    tokens = rng.integers(0, DIMS["vocab"], size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0
    return tokens, labels, mask


def _jax_params(jcfg):
    return jllama.init_params(jax.random.PRNGKey(0), jcfg)


def _torch(params_np):
    return params_from_jax(params_np, device="cpu")


def _leaves_np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _torch_leaves_np(params):
    # jax.tree.leaves orders dict keys sorted; so does this walk
    def walk(node):
        if isinstance(node, dict):
            return [x for k in sorted(node) for x in walk(node[k])]
        return [node.detach().float().numpy()]
    return walk(params)


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
    return f(params, jnp.asarray(tokens), jnp.asarray(labels),
             jnp.asarray(mask))


@functools.lru_cache(maxsize=None)
def _jax_reference(dtype):
    """(numpy params, batch, JAX loss, JAX gradient leaves) on seed 0."""
    jcfg, _ = _cfgs(dtype)
    jparams = _jax_params(jcfg)
    batch = _batch(np.random.default_rng(0))
    jloss, jgrads = _jax_loss_and_grads(jcfg, jparams, *batch)
    return (jax.tree.map(np.asarray, jparams), batch, float(jloss),
            _leaves_np(jgrads))


def _torch_loss_and_grads(tcfg, params_np, batch):
    params = _torch(params_np)
    for p in tllama.param_leaves(params):
        p.requires_grad_(True)
    loss = tllama.loss_local(params, *map(torch.from_numpy, batch), tcfg)
    loss.backward()
    grads = {k: ({kk: vv.grad for kk, vv in v.items()}
                 if isinstance(v, dict) else v.grad)
             for k, v in params.items()}
    return float(loss.detach()), _torch_leaves_np(grads)


def _assert_leaves_close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() / np.abs(w).max() < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype):
    """loss_local and every parameter gradient == the JAX loss_local's
    under a 1x1x1 USP mesh, on weights carried over by params_from_jax."""
    _, tcfg = _cfgs(dtype)
    params_np, batch, jloss, jgrads = _jax_reference(dtype)
    loss, grads = _torch_loss_and_grads(tcfg, params_np, batch)
    loss_tol, leaf_tol = (1e-5, 1e-5) if dtype == "float32" else (2e-3, 0.05)
    assert abs(loss - jloss) < loss_tol, (loss, jloss)
    _assert_leaves_close(grads, jgrads, leaf_tol)


def test_train_step_matches_jax(rng):
    """Two make_train_step steps (AdamW lr 1e-3, weight decay 1e-4) on two
    batches == two steps of the JAX make_train_step with optax.adamw(1e-3),
    fp32: each step's loss, and each parameter's change over the two."""
    jcfg, tcfg = _cfgs("float32")
    jparams = _jax_params(jcfg)
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
    params, state, losses = _torch(p0), None, []
    for batch in batches:
        params, state, loss = step(params, state,
                                   *map(torch.from_numpy, batch))
        losses.append(float(loss))
    assert isinstance(state, torch.optim.AdamW)
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=0)
    for p, jp, p_old in zip(_torch_leaves_np(params), _leaves_np(jparams),
                            _leaves_np(p0)):
        assert np.abs(jp - p_old).max() > LR  # the step moved this leaf
        np.testing.assert_allclose(p - p_old, jp - p_old, atol=2e-5, rtol=0)


@pytest.mark.parametrize("remat", ["full", "attn", "dots"])
def test_remat_matches_none(remat):
    """The loss and every gradient under remat full/attn/dots == those
    without remat and the JAX gradients, fp32, each leaf within 1e-5 of its
    largest value: remat changes only what the backward recomputes."""
    _, tcfg = _cfgs("float32")
    params_np, batch, jloss, jgrads = _jax_reference("float32")
    l0, g0 = _torch_loss_and_grads(tcfg, params_np, batch)
    l1, g1 = _torch_loss_and_grads(dataclasses.replace(tcfg, remat=remat),
                                   params_np, batch)
    assert abs(l1 - l0) < 1e-5 and abs(l1 - jloss) < 1e-5, (l0, l1, jloss)
    _assert_leaves_close(g1, g0, 1e-5)
    _assert_leaves_close(g1, jgrads, 1e-5)


@pytest.mark.parametrize("remat,fwd_per_layer",
                         [("none", 1), ("full", 2), ("attn", 1), ("dots", 2)])
def test_remat_attention_recompute(monkeypatch, remat, fwd_per_layer):
    """Every JAX remat value is accepted; "full" and "dots" run the
    attention forward (kernel B1) again in the backward, "attn" saves its
    (out, lse) and does not: the launch counts the card checks."""
    calls = []
    real = tflash.flash_fwd_causal_self

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tflash, "flash_fwd_causal_self", counting)
    _, tcfg = _cfgs("float32", remat=remat)
    params = tllama.init_params(torch.Generator().manual_seed(0), tcfg,
                                device="cpu")
    tokens = torch.randint(0, DIMS["vocab"], (1, 16),
                           generator=torch.Generator().manual_seed(1))
    step = tllama.make_train_step(tcfg, torch.optim.SGD, device="cpu")
    step(params, torch.optim.SGD(tllama.param_leaves(params), lr=0.1),
         tokens, torch.roll(tokens, -1, 1), torch.ones(1, 16))
    assert len(calls) == fwd_per_layer * DIMS["n_layers"]


def test_bogus_remat_raises():
    """A remat value the JAX package does not know raises ValueError naming
    remat (tests/test_remat.py:63-70)."""
    _, tcfg = _cfgs("float32", remat="bogus")
    params = tllama.init_params(torch.Generator().manual_seed(0), tcfg,
                                device="cpu")
    step = tllama.make_train_step(tcfg, torch.optim.SGD, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="remat"):
        step(params, torch.optim.SGD(tllama.param_leaves(params), lr=0.1),
             tokens, tokens, torch.ones(1, 8))


def test_train_step_device_rule(monkeypatch):
    """make_train_step runs on the card unless given device="cpu" (without
    CUDA it raises), over a mesh on the mesh's device (and no other),
    refuses params or batch on another device, and an optimizer built over
    other tensors."""
    from long_context_attention_tpu_torch.parallel import make_usp_mesh

    _, tcfg = _cfgs("float32")
    opt = functools.partial(torch.optim.SGD, lr=0.1)
    mesh = make_usp_mesh(device="cpu")
    try:
        with pytest.raises(ValueError, match="the mesh's"):
            tllama.make_train_step(tcfg, opt, mesh=mesh, device="meta")
        p_mesh = tllama.init_params(torch.Generator().manual_seed(0), tcfg,
                                    device="cpu")
        p_one = tllama.init_params(torch.Generator().manual_seed(0), tcfg,
                                   device="cpu")
        batch = (torch.zeros((1, 8), dtype=torch.int64),) * 2 + (
            torch.ones(1, 8),)
        _, _, l_mesh = tllama.make_train_step(tcfg, opt, mesh=mesh)(
            p_mesh, None, *batch)
        _, _, l_one = tllama.make_train_step(tcfg, opt, device="cpu")(
            p_one, None, *batch)
        assert float(l_mesh) == float(l_one)
    finally:
        torch.distributed.destroy_process_group()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tllama.make_train_step(tcfg, opt)
    params = tllama.init_params(torch.Generator().manual_seed(0), tcfg,
                                device="cpu")
    step = tllama.make_train_step(tcfg, opt, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    ones = torch.ones(1, 8)
    with pytest.raises(ValueError, match="tokens is on meta"):
        step(params, None, tokens.to("meta"), tokens, ones)
    with pytest.raises(ValueError, match="opt_state"):
        step(params, opt([torch.zeros(1)]), tokens, tokens, ones)
    _, state, loss = step(params, None, tokens, tokens, ones)
    assert torch.isfinite(loss) and not loss.requires_grad
    assert isinstance(state, torch.optim.SGD)
