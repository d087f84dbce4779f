"""Head dim 64 on the training path of the PyTorch port, against the JAX
package: a narrow Llama of head dim 64 with 8 query heads a kv head (G = 8,
TinyLlama-1.1B's grouping): ``loss_local`` and every gradient in fp32 and
bf16, and one ``make_train_step`` step; ``flash_attention`` at d = 64 on
packed segments with ALiBi and dropout, its dropout keep mask bit for bit;
the backward entry points (B2a, B2b, B5) and B3's two-chunk and featured
forms pick their d = 64 kernels and raise at other head dims (meta tensors
stand in for the card's: the wrappers take their kernel path); and
``build_all`` builds the backward sources at d = 64. The same model's mesh
step is a case of ``tests/test_torch_train_usp.py``.

The port runs its kernels' plain versions on the CPU; JAX runs its ``xla``
attention (the exact softmax) in the model, and its Pallas kernels in
interpret mode for ``flash_attention``, on the same numpy inputs.

Tolerances (``tests/test_torch_train.py``'s and
``tests/test_torch_dropout_alibi.py``'s):
* fp32 weights: loss and each gradient leaf (against its largest value)
  within 1e-5: fp32 sums in another order through two layers;
* bf16 weights: loss within 2e-3, each leaf within 0.05 of its largest
  value (``tests/test_model.py:181``): bf16 activations round at other
  places;
* one train step, fp32: the loss within 1e-5 and each parameter's change
  within 2e-5, 1% of the most one AdamW step at lr 1e-3 can move it. A
  first AdamW step moves an element by lr * g / (|g| + eps), eps = 1e-8,
  which is the sign of g times lr unless |g| is near eps: there a change
  of g by fp32 rounding (1e-9 here, far within the gradient gate) moves
  the element by up to lr * 0.4. So elements whose JAX gradient is below
  EPS_BAND (100 eps) but not 0 are held only to move less than lr, and may
  be at most 0.1% of a leaf;
* ``flash_attention``, fp32: out and lse within 1e-5 absolute and
  relative, gradients within 1e-5 of their largest value; the keep mask
  equal.
"""

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
from long_context_attention_tpu.parallel import make_usp_mesh
from long_context_attention_tpu.parallel.mesh import MeshAxes
from long_context_attention_tpu_torch.models import llama as tllama
from long_context_attention_tpu_torch.ops import _build
from long_context_attention_tpu_torch.ops import flash as tflash
from long_context_attention_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

D = 64
DIMS = dict(vocab=256, dim=256, n_layers=2, n_heads=8, n_kv_heads=1,
            head_dim=D, ffn_hidden=512, layout="basic")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 64
LR, WD = 1e-3, 1e-4  # optax.adamw(1e-3): weight decay 1e-4
EPS_BAND = 1e-6  # 100 x Adam's eps: a first update's size depends on g
F32 = dict(atol=1e-5, rtol=1e-5)
F32_GRAD = 1e-5  # of the gradient's largest value


def _batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, DIMS["vocab"], size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0
    return tokens, labels, mask


def _leaves_np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _torch_leaves_np(params):
    # jax.tree.leaves orders dict keys sorted; so does this walk
    def walk(node):
        if isinstance(node, dict):
            return [x for k in sorted(node) for x in walk(node[k])]
        return [node.detach().float().numpy()]
    return walk(params)


@functools.lru_cache(maxsize=None)
def _jax_reference(dtype):
    """(numpy params, JAX loss, JAX gradient leaves) on seed 0, JAX's xla
    attention under a 1 x 1 x 1 USP mesh."""
    jcfg = jllama.ModelConfig(**DIMS, dtype=DTYPES[dtype][0],
                              attn_impl="xla")
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    axes = MeshAxes()
    tok = P(axes.dp, axes.seq)

    def lg(p, t, lab, m):
        return jax.value_and_grad(lambda pp: jllama.loss_local(
            pp, t, lab, m, jcfg, ulysses_axis=axes.ulysses,
            ring_axis=axes.ring, dp_axis=axes.dp))(p)

    f = jax.jit(jax.shard_map(lg, mesh=make_usp_mesh(1, 1, 1),
                              in_specs=(P(), tok, tok, tok),
                              out_specs=(P(), P()), check_vma=False))
    loss, grads = f(params, *map(jnp.asarray, _batch()))
    return jax.tree.map(np.asarray, params), float(loss), _leaves_np(grads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype):
    """loss_local and every parameter gradient of the G = 8, head dim 64
    model (B1 + B5's plain versions) == JAX's loss_local on the same
    weights and batch."""
    params_np, jloss, jgrads = _jax_reference(dtype)
    tcfg = tllama.ModelConfig(**DIMS, dtype=DTYPES[dtype][1])
    params = params_from_jax(params_np, device="cpu")
    for p in tllama.param_leaves(params):
        p.requires_grad_(True)
    loss = tllama.loss_local(params, *map(torch.from_numpy, _batch()), tcfg)
    loss.backward()
    grads = {k: ({kk: vv.grad for kk, vv in v.items()}
                 if isinstance(v, dict) else v.grad)
             for k, v in params.items()}
    loss_tol, leaf_tol = (1e-5, 1e-5) if dtype == "float32" else (2e-3, 0.05)
    loss = float(loss.detach())
    assert abs(loss - jloss) < loss_tol, (loss, jloss)
    got = _torch_leaves_np(grads)
    assert len(got) == len(jgrads)
    for g, w in zip(got, jgrads):
        assert g.shape == w.shape
        assert np.abs(g - w).max() / np.abs(w).max() < leaf_tol


def test_train_step_matches_jax():
    """One make_train_step step (AdamW lr 1e-3, weight decay 1e-4) of the
    head dim 64 model == JAX's make_train_step with optax.adamw(1e-3),
    fp32: the loss, and each parameter's change (elements whose gradient
    lies within EPS_BAND of zero: less than lr)."""
    jcfg = jllama.ModelConfig(**DIMS, dtype=jnp.float32, attn_impl="xla")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    p0 = jax.tree.map(np.asarray, jparams)
    batch = _batch()
    opt = optax.adamw(LR)
    jstep = jllama.make_train_step(jcfg, make_usp_mesh(1, 1, 1), opt)
    jparams, _, jloss = jstep(jparams, opt.init(jparams),
                              *map(jnp.asarray, batch))
    step = tllama.make_train_step(
        tllama.ModelConfig(**DIMS, dtype=torch.float32),
        functools.partial(torch.optim.AdamW, lr=LR, weight_decay=WD),
        device="cpu")
    params, _, loss = step(params_from_jax(p0, device="cpu"), None,
                           *map(torch.from_numpy, batch))
    assert abs(float(loss) - float(jloss)) <= 1e-5, (float(loss),
                                                      float(jloss))
    _, _, jgrads = _jax_reference("float32")  # the step's gradient
    for p, jp, p_old, g in zip(_torch_leaves_np(params), _leaves_np(jparams),
                               _leaves_np(p0), jgrads):
        assert np.abs(jp - p_old).max() > LR / 2  # the step moved this leaf
        band = (np.abs(g) < EPS_BAND) & (g != 0)  # 0: unseen tokens' rows
        assert band.mean() <= 1e-3, band.mean()
        np.testing.assert_allclose((p - p_old)[~band], (jp - p_old)[~band],
                                   atol=2e-5, rtol=0)
        assert np.abs(p - p_old)[band].max(initial=0.0) < LR


# ---------------------------------------------------------------------------
# flash_attention at d = 64: packed segments, ALiBi, dropout
# ---------------------------------------------------------------------------

H, HKV = 8, 1
SLOPES = np.geomspace(1.0 / 2, 1.0 / 256, H).astype(np.float32)
DOCS = (70, 100, 33, 53)  # packed documents cutting the 64-row tiles
P_DROP = 0.1
SEED = (20240613, 3)


def _ids(s, b=1):
    """(b, s) segment ids of DOCS packed from each row's start (row r
    shifted by 17 r tokens, so the rows' boundaries differ)."""
    rows = []
    for r in range(b):
        ids = np.repeat(np.arange(len(DOCS) + 1, dtype=np.int32),
                        (17 * r,) + DOCS)[:s]
        rows.append(np.pad(ids, (0, s - len(ids)),
                           constant_values=len(DOCS) + 1))
    return np.stack(rows)


def _feature_kwargs(s, jax_side, b=1):
    ids = _ids(s, b)
    if jax_side:
        return dict(q_segment_ids=jnp.asarray(ids),
                    kv_segment_ids=jnp.asarray(ids),
                    alibi_slopes=jnp.asarray(SLOPES), dropout_p=P_DROP,
                    dropout_seed=jnp.asarray(SEED, jnp.int32))
    t = torch.from_numpy(ids)
    return dict(q_segment_ids=t, kv_segment_ids=t,
                alibi_slopes=torch.from_numpy(SLOPES), dropout_p=P_DROP,
                dropout_seed=SEED)


def test_flash_attention_features_match_jax():
    """flash_attention at d = 64, causal, G = 8, on packed segments with
    ALiBi and dropout 0.1: out, lse and the autograd gradients (B3 + B2a
    + B2b's plain versions) against JAX's flash_attention and its custom
    VJP, fp32."""
    s = 256
    rng = np.random.default_rng(5)
    q, dout = (rng.standard_normal((1, s, H, D)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((1, s, HKV, D)).astype(np.float32)
            for _ in range(2))
    jkw = dict(causal=True, **_feature_kwargs(s, True))

    def jfwd(q_, k_, v_):
        return jflash.flash_attention(q_, k_, v_, return_lse=True,
                                      interpret=True, **jkw)

    (jo, jl), vjp = jax.vjp(jfwd, *map(jnp.asarray, (q, k, v)))
    jg = vjp((jnp.asarray(dout), jnp.zeros_like(jl)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    to, tl = tflash.flash_attention(*leaves, causal=True, return_lse=True,
                                    **_feature_kwargs(s, False))
    (to * torch.from_numpy(dout)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **F32)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **F32)
    for g, w in zip(leaves, jg):
        w = np.asarray(w)
        assert np.abs(g.grad.numpy() - w).max() <= F32_GRAD * np.abs(w).max()


def test_keep_mask_matches_jax_at_head_dim_64():
    """The dropout keep mask at d = 64 with segments and ALiBi, bit for
    bit: V the identity over 64 kv columns, so out[i, h, j] != 0 exactly
    where pair (i, j) is visible (causal, same document) and kept; JAX's
    Pallas kernel, the port's flash_attention and the port's plain mask
    (flash.dropout_keep) give the same pairs."""
    s = 64
    rng = np.random.default_rng(6)
    q = (0.1 * rng.standard_normal((2, s, H, D))).astype(np.float32)
    k = (0.1 * rng.standard_normal((2, s, HKV, D))).astype(np.float32)
    v = np.broadcast_to(np.eye(s, D, dtype=np.float32)[None, :, None],
                        (2, s, HKV, D)).copy()
    jout = jflash.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                  interpret=True,
                                  **_feature_kwargs(s, True, 2))
    jkept = np.asarray(jout) != 0
    tout = tflash.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=True, **_feature_kwargs(s, False, 2))
    np.testing.assert_array_equal(tout.numpy() != 0, jkept)
    pos = torch.arange(s)
    keep = tflash.dropout_keep(SEED, pos, pos, 2, H, P_DROP)
    ids = torch.from_numpy(_ids(s, 2))
    seen = ((pos[None, :] <= pos[:, None])
            & (ids[:, :, None] == ids[:, None, :]))[:, None]
    np.testing.assert_array_equal((keep & seen).permute(0, 2, 1, 3).numpy(),
                                  jkept)
    dropped = float((~keep & seen).sum() / seen.expand_as(keep).sum())
    assert 0.5 * P_DROP < dropped < 2 * P_DROP, dropped


# ---------------------------------------------------------------------------
# the kernels each entry point takes at d = 64, 32 and 96 (meta tensors
# stand in for the card's: the wrappers take their kernel path)
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype, device="meta")


class _Recorder:
    """Stands in for a d = 64 kernel: records its launches."""

    def __init__(self, name):
        self.name, self.calls = name, 0

    def __call__(self, *args):
        self.calls += 1


TWO_CHUNKS = tflash.Positions((0, 1 << 20), (0, 1 << 20))


def _calls(d):
    """(kernel entry point, its call on meta tensors of head dim d): B2a,
    B2b and B5, and B3 at a two-chunk descriptor and with the features."""
    q, k = _meta(1, 256, 8, d), _meta(1, 256, 1, d)
    kv = _meta(1, 1, 512, d)
    lse = torch.zeros((1, 8, 256), device="meta")
    feat = tflash.Features(slopes=torch.ones(8, device="meta"),
                           dropout_p=0.1, seed=(1, 0))
    return (
        ("flash_bwd_dq", lambda: tflash.flash_bwd_dq(
            q, k, k, q, lse, lse, scale=1.0, pos=TWO_CHUNKS)),
        ("flash_bwd_dkv", lambda: tflash.flash_bwd_dkv(
            q, k, k, q, lse, lse, scale=1.0, pos=TWO_CHUNKS,
            features=feat)),
        ("flash_bwd_fused", lambda: tflash.flash_bwd_fused(
            q, k, k, q, lse, lse, scale=1.0)),
        ("flash_fwd_pos", lambda: tflash.flash_fwd_pos(
            q, kv, kv, scale=1.0, causal=True, pos=TWO_CHUNKS)),
        ("flash_fwd_pos", lambda: tflash.flash_fwd_pos(
            q, kv, kv, q_start=256, causal=True, scale=1.0, features=feat)))


def test_training_kernels_pick_head_dim_64(monkeypatch):
    """At d = 64 the backward entry points and B3 at two position chunks
    or with the features launch their <name>_d64 kernel, once a call, and
    no d = 128 kernel."""
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    fakes = {}
    for name in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused",
                 "flash_fwd_pos"):
        for n in (name, f"{name}_d64"):
            fakes[n] = _Recorder(n)
            monkeypatch.setitem(_build.KERNELS, n, fakes[n])
    for name, call in _calls(D):
        before = fakes[f"{name}_d64"].calls
        call()
        assert fakes[f"{name}_d64"].calls == before + 1, name
    assert all(fakes[n].calls == 0 for n in fakes if not n.endswith("_d64"))


@pytest.mark.parametrize("d", [32, 96])
def test_training_kernels_raise_at_other_head_dims(monkeypatch, d):
    """At head dims 32 and 96 each of those calls raises
    NotImplementedError naming 64 and 128, before any launch."""
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    for name, call in _calls(d):
        fake = _Recorder(name)
        monkeypatch.setitem(_build.KERNELS, name, fake)
        with pytest.raises(NotImplementedError,
                           match=f"head_dim 64 or 128, got d={d}"):
            call()
        assert fake.calls == 0


def test_build_all_builds_the_backward_at_head_dim_64(monkeypatch):
    """build_all's default list holds every d = 64 library: the backward
    sources (B2a; B2b and B5) beside the serving ones, and no d = 64 build
    of sage's sources."""
    monkeypatch.setattr(_build, "_start_build", lambda lib: None)
    built = _build.build_all()
    for lib in ("flash_bwd_sm90.cu:d64", "flash_dq_sm90.cu:d64",
                "flash_fwd_sm90.cu:d64", "flash_bwd_sm90.cu",
                "flash_dq_sm90.cu"):
        assert lib in built, lib
    assert not any(lib.startswith("sage") and lib.endswith(":d64")
                   for lib in built)
    for name in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused"):
        k = _build.kernel(name, 64)
        assert k.name == f"{name}_d64" and k.head_dim == 64
        assert k.lib == f"{_build.KERNELS[name].source}:d64"
