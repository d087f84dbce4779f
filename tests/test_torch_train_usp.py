"""Training the port's model over a USP mesh against the JAX package.

A 2-layer tiny model in fp32, the JAX weights carried over by
``params_from_jax``. JAX runs ``make_train_step`` and ``make_forward`` on
its 4-device virtual mesh (``tests/conftest.py``), its attention through
the ring with impl ``xla`` (the fp32 oracle per step); the port runs
``make_train_step(mesh=...)`` on 4 gloo ranks (its attention through
``usp_attention_local``, the kernels' plain versions), at ulysses 2 x ring
2 (remat none and attn) and dp 2 x ring 2, the last also on a Llama of
head dim 64 with 8 query heads a kv head (G = 8, TinyLlama-1.1B's
grouping), and its own single-device step on the same batches (JAX
``tests/test_model.py:39``, ``:57``, ``:143``, ``:223``). One spawn of 4
workers runs every case and writes its results; workers never import JAX.

Tolerances (fp32 on both sides, ``tests/test_torch_train.py``'s): logits
and losses within 1e-5; each parameter's change over two AdamW steps (lr
1e-3, weight decay 1e-4) within 2e-5, 1% of the most two steps can move
it. AdamW moves an element by lr * g / (|g| + eps) (eps 1e-8), the sign
of g times lr unless |g| is near eps, where the fp32 rounding of g moves
it by a share of lr: in the head dim 64 case (its wider leaves hold such
elements) the elements whose JAX gradient at either step is not 0 but
below EPS_BAND (100 eps) are held only to move less than 2 lr against
JAX, and may be at most 0.1% of the parameters.
"""

import functools
import json
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)

WORLD = 4
DIMS = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=8, ffn_hidden=64, layout="zigzag")
HD64 = dict(DIMS, n_heads=8, n_kv_heads=1, head_dim=64)
B, S = 2, 64
LR, WD = 1e-3, 1e-4  # optax.adamw(1e-3): weight decay 1e-4
OUT_TOL, MOVE_TOL = 1e-5, 2e-5
EPS_BAND = 1e-6  # 100 x Adam's eps: a first update's size depends on g

# name: ((dp, ulysses, ring), remat, model dims); BANDED: the cases held
# to MOVE_TOL outside Adam's eps band (EPS_BAND)
BANDED = ("dp 2 x ring 2 head dim 64",)
CASES = {
    "ulysses 2 x ring 2": ((1, 2, 2), "none", DIMS),
    "ulysses 2 x ring 2 remat attn": ((1, 2, 2), "attn", DIMS),
    "dp 2 x ring 2": ((2, 1, 2), "none", DIMS),
    "dp 2 x ring 2 head dim 64": ((2, 1, 2), "none", HD64),
}


def _batches():
    rng = np.random.default_rng(3)
    out = []
    for _ in range(2):
        tokens = rng.integers(0, DIMS["vocab"], size=(B, S)).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        mask = np.ones((B, S), np.float32)
        mask[:, -1] = 0
        out.append((tokens, labels, mask))
    return out


def _flat(tree, prefix=""):
    """{key path: fp32 numpy leaf} of a params dict (JAX or torch)."""
    if isinstance(tree, dict):
        return {k: v for name in tree
                for k, v in _flat(tree[name], f"{prefix}{name}/").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _tree(flat):
    """The params dict of a {key path: leaf} mapping."""
    tree = {}
    for path, x in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = x
    return tree


def _jax_references(path: pathlib.Path) -> None:
    """The initial params, JAX's logits on the first batch and, per case,
    its two steps' losses and final params."""
    import jax
    import jax.numpy as jnp
    import optax

    from long_context_attention_tpu.models import llama as jllama
    from long_context_attention_tpu.parallel import make_usp_mesh
    from long_context_attention_tpu.parallel.layouts import (
        permute_for_layout, unpermute_from_layout)

    devs = jax.devices()[:WORLD]
    saved = {}
    batches = _batches()
    for name, ((dp, uly, ring), remat, dims) in CASES.items():
        params = jllama.init_params(jax.random.PRNGKey(0), jllama.ModelConfig(
            **dims, dtype=jnp.float32, attn_impl="xla"))
        saved.update({f"{name}/p0/{k}": x for k, x in _flat(params).items()})
        cfg = jllama.ModelConfig(**dims, dtype=jnp.float32, attn_impl="xla",
                                 remat=remat)
        mesh = make_usp_mesh(dp=dp, ulysses=uly, ring=ring, devices=devs)
        perm = functools.partial(permute_for_layout, layout=DIMS["layout"],
                                 ring_size=ring, axis=1)
        logits = jllama.make_forward(cfg, mesh)(params,
                                                perm(batches[0][0]))
        saved[f"{name}/logits"] = np.asarray(unpermute_from_layout(
            logits, DIMS["layout"], ring, axis=1))
        opt = optax.adamw(LR)
        step = jllama.make_train_step(cfg, mesh, opt)
        grad = _jax_grad(cfg, devs[:1]) if name in BANDED else None
        p, state = params, opt.init(params)
        for i, batch in enumerate(batches):
            if grad is not None:  # each step's gradient on one device
                g_all = grad(jax.device_get(p), *map(jnp.asarray, batch))
                for k, g in _flat(g_all).items():
                    band = (np.abs(g) < EPS_BAND) & (g != 0)
                    key = f"{name}/band/{k}"
                    saved[key] = saved[key] | band if i else band
            p, state, loss = step(p, state, *(perm(jnp.asarray(x))
                                              for x in batch))
            saved[f"{name}/loss{i}"] = np.float32(loss)
        for k, x in _flat(p).items():
            saved[f"{name}/p/{k}"] = x
    np.savez(path / "ref.npz", **saved)


def _jax_grad(cfg, devices):
    """JAX's gradient of the global loss on one device: (params, tokens,
    labels, mask) -> grads."""
    import jax
    from jax.sharding import PartitionSpec as P

    from long_context_attention_tpu.models import llama as jllama
    from long_context_attention_tpu.parallel import make_usp_mesh
    from long_context_attention_tpu.parallel.mesh import MeshAxes

    axes = MeshAxes()
    tok = P(axes.dp, axes.seq)

    def grad(p, t, lab, m):
        return jax.grad(lambda pp: jllama.loss_local(
            pp, t, lab, m, cfg, ulysses_axis=axes.ulysses,
            ring_axis=axes.ring, dp_axis=axes.dp))(p)

    return jax.jit(jax.shard_map(
        grad, mesh=make_usp_mesh(1, 1, 1, devices=devices),
        in_specs=(P(), tok, tok, tok), out_specs=P(), check_vma=False))


def _worker(rank: int, tmp: str) -> None:
    """One gloo rank: every case's two mesh steps (and the first batch's
    logits); rank 0 also runs the single-device steps and writes all."""
    from long_context_attention_tpu_torch.models import llama as tllama
    from long_context_attention_tpu_torch.parallel import layouts as tlay
    from long_context_attention_tpu_torch.parallel import mesh as tmesh
    from long_context_attention_tpu_torch.utils.convert import (
        params_from_jax)

    torch.set_num_threads(1)
    path = pathlib.Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{path}/rdzv",
                            rank=rank, world_size=WORLD)
    ref = np.load(path / "ref.npz")
    p0s = {name: {k[len(name) + 4:]: ref[k] for k in ref.files
                  if k.startswith(f"{name}/p0/")} for name in CASES}

    def params0(name):
        return params_from_jax(_tree(p0s[name]), device="cpu")

    opt = functools.partial(torch.optim.AdamW, lr=LR, weight_decay=WD)
    batches = [tuple(torch.from_numpy(x) for x in b) for b in _batches()]
    results = {}
    for name, ((dp, uly, ring), remat, dims) in CASES.items():
        cfg = tllama.ModelConfig(**dims, dtype=torch.float32, remat=remat)
        mesh = tmesh.make_usp_mesh(dp=dp, ulysses=uly, ring=ring,
                                   device="cpu")

        def shard(x):
            return tmesh.seq_shard(mesh, tlay.permute_for_layout(
                x, DIMS["layout"], ring))

        with torch.no_grad():
            logits = tllama.make_forward(cfg, mesh)(params0(name),
                                                    shard(batches[0][0]))
        logits = tlay.unpermute_from_layout(
            tmesh.seq_unshard(mesh, logits), DIMS["layout"], ring)
        step = tllama.make_train_step(cfg, opt, mesh=mesh)
        params, state, losses = params0(name), None, []
        for batch in batches:
            params, state, loss = step(params, state,
                                       *(shard(x) for x in batch))
            losses.append(float(loss))
        results[name] = (logits.numpy(), losses, _flat(params))
    if rank == 0:
        errs = {}
        for name, (logits, losses, flat) in results.items():
            _, remat, dims = CASES[name]
            p0 = p0s[name]
            # the port's single-device steps on the same batches
            step = tllama.make_train_step(
                tllama.ModelConfig(**dims, dtype=torch.float32, remat=remat),
                opt, device="cpu")
            params, state, slosses = params0(name), None, []
            for batch in batches:
                params, state, loss = step(params, state, *batch)
                slosses.append(float(loss))
            jlosses = [float(ref[f"{name}/loss{i}"]) for i in range(2)]
            jflat = {k: ref[f"{name}/p/{k}"] for k in p0}
            band = {k: (ref[f"{name}/band/{k}"] if name in BANDED
                        else np.zeros(p0[k].shape, bool)) for k in p0}
            errs[f"{name}/band_share"] = float(
                sum(b.sum() for b in band.values())
                / sum(b.size for b in band.values()))
            errs[f"{name}/band_move"] = float(max(
                np.abs((flat[k] - jflat[k])[band[k]]).max(initial=0.0)
                for k in p0))
            errs[f"{name}/logits"] = float(np.abs(
                logits - ref[f"{name}/logits"]).max())
            for who, (ls, fl) in (("jax", (jlosses, jflat)),
                                  ("single", (slosses, _flat(params)))):
                errs[f"{name}/{who}/loss"] = float(max(
                    abs(a - b) for a, b in zip(losses, ls)))
                # against JAX outside Adam's eps band (BANDED)
                out = {k: ~band[k] if who == "jax" else slice(None)
                       for k in p0}
                errs[f"{name}/{who}/move"] = float(max(
                    np.abs((flat[k] - fl[k])[out[k]]).max() for k in p0))
            errs[f"{name}/min_move"] = float(min(
                np.abs(jflat[k] - p0[k]).max() for k in p0))
        (path / "results.json").write_text(json.dumps(errs))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def train_errors(tmp_path_factory):
    path = tmp_path_factory.mktemp("train_usp")
    _jax_references(path)
    mp.start_processes(_worker, args=(str(path),), nprocs=WORLD, join=True,
                       start_method="spawn")
    return json.loads((path / "results.json").read_text())


@pytest.mark.parametrize("case", CASES)
def test_sharded_forward_matches_jax(train_errors, case):
    """make_forward over the mesh: the logits of the first batch (gathered,
    in the original order) equal JAX's make_forward on the same mesh."""
    assert train_errors[f"{case}/logits"] <= OUT_TOL, train_errors


@pytest.mark.parametrize("case", CASES)
def test_sharded_train_step_matches_jax(train_errors, case):
    """Two make_train_step(mesh=...) steps: each step's loss and each
    parameter's change equal JAX's make_train_step on the same mesh, and
    every leaf moved."""
    assert train_errors[f"{case}/jax/loss"] <= OUT_TOL, train_errors
    assert train_errors[f"{case}/jax/move"] <= MOVE_TOL, train_errors
    assert train_errors[f"{case}/min_move"] > LR, train_errors
    assert train_errors[f"{case}/band_share"] <= 1e-3, train_errors
    assert train_errors[f"{case}/band_move"] < 2 * LR, train_errors


@pytest.mark.parametrize("case", CASES)
def test_sharded_train_step_matches_single_device(train_errors, case):
    """The mesh step equals the port's own single-device step on the same
    batches (USP loss == DP loss, the reference's loss-curve check)."""
    assert train_errors[f"{case}/single/loss"] <= OUT_TOL, train_errors
    assert train_errors[f"{case}/single/move"] <= MOVE_TOL, train_errors
