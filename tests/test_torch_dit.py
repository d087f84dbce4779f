"""The DiT family of the port against the JAX package: the timestep
embedding and the tanh GELU, the parameter dict, ``make_dit_forward`` on
one device and at dp 1 x ulysses 2 x ring 2, and two ``make_dit_train_step``
steps (AdamW) on one device and on that mesh (the cases of
``tests/test_dit.py``).

The weights are JAX's ``init_dit_params`` with ``mod`` and ``out`` drawn
non-zero (under adaLN-zero's zero init every block is the identity and
every block weight's gradient is 0), carried over by ``params_from_jax``.
JAX runs first, in the test process, on 1 and on 4 of the 8 virtual
devices of ``tests/conftest.py``, its attention through Pallas in
interpret mode (B3, and B2a + B2b in its backward; at this size each call
costs well under a second); then one spawn of 4 gloo ranks (its own
rendezvous, one torch thread each; workers never import JAX) runs the
port on the mesh, through the kernels' plain versions, and writes the
errors.

Tolerances (``tests/test_torch_train.py``'s): fp32 outputs and losses
within 1e-5 (the same fp32 arithmetic summed in another order); each
parameter's change over two AdamW steps (lr 1e-3, weight decay 1e-4)
within 2e-5, 1% of the most two steps can move it; bf16 outputs within
1e-1 (the bf16 gate), where the two sides round activations at other
places.
"""

import functools
import json
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from long_context_attention_tpu_torch.models import dit as tdit
from long_context_attention_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

WORLD = 4
SHAPE = dict(in_dim=8, dim=64, n_layers=2, n_heads=4, head_dim=16,
             ffn_hidden=128)
B, N = 2, 128
MESHES = {"1x1x1": (1, 1, 1), "ulysses 2 x ring 2": (1, 2, 2)}
LR, WD = 1e-3, 1e-4  # optax.adamw(1e-3): weight decay 1e-4
OUT_TOL, MOVE_TOL, BF16_TOL = 1e-5, 2e-5, 1e-1


def _jax_params(dtype):
    """JAX's init_dit_params with mod and out drawn non-zero, as numpy."""
    import jax

    from long_context_attention_tpu.models import dit as jdit

    params = jax.tree.map(np.asarray, jdit.init_dit_params(
        jax.random.PRNGKey(0), jdit.DiTConfig(**SHAPE, dtype=dtype)))
    rng = np.random.default_rng(5)
    for node, key, fan_in in ((params["layers"], "mod", SHAPE["dim"]),
                              (params, "out", SHAPE["dim"])):
        node[key] = (rng.standard_normal(node[key].shape)
                     / np.sqrt(fan_in)).astype(node[key].dtype)
    return params


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, N, SHAPE["in_dim"])).astype(np.float32)
    noise = rng.standard_normal((B, N, SHAPE["in_dim"])).astype(np.float32)
    t = rng.integers(0, 1000, size=(B,)).astype(np.int32)
    return x, noise, t


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for name in tree
                for k, v in _flat(tree[name], f"{prefix}{name}/").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().float()
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _tree(flat):
    tree = {}
    for path, x in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = x
    return tree


def _jax_references(path: pathlib.Path) -> None:
    """fp32: the params, and per mesh JAX's forward and its two train
    steps' losses and final params."""
    import jax
    import jax.numpy as jnp
    import optax

    from long_context_attention_tpu.models import dit as jdit
    from long_context_attention_tpu.parallel import make_usp_mesh

    cfg = jdit.DiTConfig(**SHAPE, dtype=jnp.float32)
    params = _jax_params(jnp.float32)
    saved = {f"p0/{k}": x for k, x in _flat(params).items()}
    x, noise, t = _data()
    for name, (dp, uly, ring) in MESHES.items():
        mesh = make_usp_mesh(dp=dp, ulysses=uly, ring=ring,
                             devices=jax.devices()[:dp * uly * ring])
        saved[f"{name}/out"] = np.asarray(
            jdit.make_dit_forward(cfg, mesh)(params, x, t))
        opt = optax.adamw(LR)
        step = jdit.make_dit_train_step(cfg, mesh, opt)
        p = jax.tree.map(jnp.asarray, params)
        state = opt.init(p)
        for i in range(2):
            p, state, loss = step(p, state, x, noise, t)
            saved[f"{name}/loss{i}"] = np.float32(loss)
        for k, leaf in _flat(p).items():
            saved[f"{name}/p/{k}"] = leaf
    np.savez(path / "ref.npz", **saved)


def _run_port(ref, mesh, shard, unshard):
    """The port's forward (gathered) and two train steps' losses and
    final params, from the saved params, on ``mesh`` (None: one device)."""
    p0 = {k[3:]: ref[k] for k in ref.files if k.startswith("p0/")}
    cfg = tdit.DiTConfig(**SHAPE, dtype=torch.float32)
    x, noise, t = (torch.from_numpy(a) for a in _data())
    kw = dict(device="cpu") if mesh is None else dict(mesh=mesh)
    out = unshard(tdit.make_dit_forward(cfg, **kw)(
        params_from_jax(_tree(p0), device="cpu"), shard(x), t))
    step = tdit.make_dit_train_step(
        cfg, functools.partial(torch.optim.AdamW, lr=LR, weight_decay=WD),
        **kw)
    params, state, losses = params_from_jax(_tree(p0), device="cpu"), None, []
    for _ in range(2):
        params, state, loss = step(params, state, shard(x), shard(noise), t)
        losses.append(float(loss))
    return out.numpy(), losses, _flat(params)


def _errors(ref, name, got):
    out, losses, flat = got
    p0 = {k[3:]: ref[k] for k in ref.files if k.startswith("p0/")}
    return {
        f"{name}/out": float(np.abs(out - ref[f"{name}/out"]).max()),
        f"{name}/loss": max(abs(a - float(ref[f"{name}/loss{i}"]))
                            for i, a in enumerate(losses)),
        f"{name}/move": max(float(np.abs(
            (flat[k] - p0[k]) - (ref[f"{name}/p/{k}"] - p0[k])).max())
            for k in p0),
        f"{name}/min_move": min(float(np.abs(
            ref[f"{name}/p/{k}"] - p0[k]).max()) for k in p0)}


def _worker(rank: int, tmp: str) -> None:
    from long_context_attention_tpu_torch.parallel import mesh as tmesh

    torch.set_num_threads(1)
    path = pathlib.Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{path}/rdzv",
                            rank=rank, world_size=WORLD)
    ref = np.load(path / "ref.npz")
    name = "ulysses 2 x ring 2"
    mesh = tmesh.make_usp_mesh(*MESHES[name], device="cpu")
    errs = _errors(ref, name, _run_port(
        ref, mesh, functools.partial(tmesh.seq_shard, mesh),
        functools.partial(tmesh.seq_unshard, mesh)))
    if rank == 0:
        (path / "results.json").write_text(json.dumps(errs))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def dit_errors(tmp_path_factory):
    path = tmp_path_factory.mktemp("dit")
    _jax_references(path)
    ref = np.load(path / "ref.npz")
    errs = _errors(ref, "1x1x1", _run_port(ref, None, lambda x: x,
                                           lambda x: x))
    mp.start_processes(_worker, args=(str(path),), nprocs=WORLD, join=True,
                       start_method="spawn")
    errs.update(json.loads((path / "results.json").read_text()))
    return errs


@pytest.mark.parametrize("mesh", MESHES)
def test_dit_forward_matches_jax(dit_errors, mesh):
    """make_dit_forward (gathered over the mesh) equals JAX's on the same
    weights, latents and timesteps."""
    assert dit_errors[f"{mesh}/out"] <= OUT_TOL, dit_errors


@pytest.mark.parametrize("mesh", MESHES)
def test_dit_train_step_matches_jax(dit_errors, mesh):
    """Two make_dit_train_step steps: each step's loss and each
    parameter's change equal JAX's with optax.adamw, and every leaf
    moved."""
    assert dit_errors[f"{mesh}/loss"] <= OUT_TOL, dit_errors
    assert dit_errors[f"{mesh}/move"] <= MOVE_TOL, dit_errors
    assert dit_errors[f"{mesh}/min_move"] > LR, dit_errors


def test_dit_bf16_forward_matches_jax():
    """The bf16 model (JAX's default dtype) on one device: the same
    casts (fp32 time MLP, modulation cast after its fp32 product, fp32
    GELU input, fp32 output) within the bf16 gate."""
    import jax
    import jax.numpy as jnp

    from long_context_attention_tpu.models import dit as jdit
    from long_context_attention_tpu.parallel import make_usp_mesh

    params = _jax_params(jnp.bfloat16)
    x, _, t = _data()
    want = np.asarray(jdit.make_dit_forward(
        jdit.DiTConfig(**SHAPE), make_usp_mesh(1, 1, 1,
                                               devices=jax.devices()[:1]))(
        params, x, t))
    got = tdit.make_dit_forward(tdit.DiTConfig(**SHAPE), device="cpu")(
        params_from_jax(params, device="cpu"), torch.from_numpy(x),
        torch.from_numpy(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_TOL, rtol=0)


@pytest.mark.parametrize("dim", [64, 1536])
def test_timestep_embedding_matches_jax(dim):
    """The sinusoidal embedding, fp32, at the tiny width and Wan2.1-1.3B's
    (1536). XLA's and torch's fp32 exp differ by an ulp on some
    frequencies, which t (up to 999) scales in the angle: 999 x 2^-23 x 2
    = 2.4e-4 of sin and cos at most."""
    import jax.numpy as jnp

    from long_context_attention_tpu.models import dit as jdit

    t = np.array([0, 1, 17, 500, 999], np.int32)
    want = np.asarray(jdit.timestep_embedding(jnp.asarray(t), dim))
    got = tdit.timestep_embedding(torch.from_numpy(t), dim)
    assert got.dtype == torch.float32 and got.shape == (5, dim)
    np.testing.assert_allclose(got.numpy(), want, atol=2.5e-4, rtol=0)


def test_tanh_gelu_matches_jax():
    """jax.nn.gelu's default is the tanh form: F.gelu(approximate="tanh")
    matches it in fp32, while the exact (erf) form is ~1e-3 away."""
    import jax
    import jax.numpy as jnp
    import torch.nn.functional as F

    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4


def test_dit_params_match_jax():
    """init_dit_params has JAX's keys, shapes and dtypes, zero mod and out,
    and the same init scale; params_from_jax carries JAX's DiT tree leaf
    for leaf."""
    import jax

    from long_context_attention_tpu.models import dit as jdit

    jp = jax.tree.map(np.asarray, jdit.init_dit_params(
        jax.random.PRNGKey(0), jdit.DiTConfig(**SHAPE)))
    tp = tdit.init_dit_params(torch.Generator().manual_seed(0),
                              tdit.DiTConfig(**SHAPE), device="cpu")
    jflat, tflat = _flat(jp), _flat(tp)
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        assert tflat[k].shape == jflat[k].shape, k
        assert _leaf(tp, k).dtype == torch.bfloat16, k
        if k in ("layers/mod", "out"):
            assert not tflat[k].any() and not jflat[k].any()
        else:
            np.testing.assert_allclose(tflat[k].std(), jflat[k].std(),
                                       rtol=0.1)
    carried = params_from_jax(jp, device="cpu")
    for k, x in jflat.items():
        assert _leaf(carried, k).dtype == torch.bfloat16
        np.testing.assert_array_equal(_flat(carried)[k], x)


def _leaf(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def test_dit_device_rule(monkeypatch):
    """The DiT entry points default to the card: without CUDA they raise
    unless given the CPU; params or data elsewhere than the step's device
    raise."""
    cfg = tdit.DiTConfig(**SHAPE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tdit.init_dit_params(torch.Generator(), cfg),
                 lambda: tdit.make_dit_forward(cfg),
                 lambda: tdit.make_dit_train_step(cfg, torch.optim.AdamW)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    params = tdit.init_dit_params(torch.Generator(), cfg, device="cpu")
    x, noise, t = (torch.from_numpy(a) for a in _data())
    out = tdit.make_dit_forward(cfg, device="cpu")(params, x, t)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert not out.any()  # adaLN-zero: the zero head
    with pytest.raises(ValueError, match="meta"):
        tdit.make_dit_forward(cfg, device="cpu")(params, x.to("meta"), t)
