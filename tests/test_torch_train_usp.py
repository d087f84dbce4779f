"""Training the port's model over a USP mesh against the JAX package.

A 2-layer tiny model in fp32, the JAX weights carried over by
``params_from_jax``. JAX runs ``make_train_step`` and ``make_forward`` on
its 4-device virtual mesh (``tests/conftest.py``), its attention through
the ring with impl ``xla`` (the fp32 oracle per step); the port runs
``make_train_step(mesh=...)`` on 4 gloo ranks (its attention through
``usp_attention_local``, the kernels' plain versions), at ulysses 2 x ring
2 (remat none and attn) and dp 2 x ring 2, and its own single-device step
on the same batches (JAX ``tests/test_model.py:39``, ``:57``, ``:143``,
``:223``). One spawn of 4 workers runs every case and writes its results;
workers never import JAX.

Tolerances (fp32 on both sides, ``tests/test_torch_train.py``'s): logits
and losses within 1e-5; each parameter's change over two AdamW steps (lr
1e-3, weight decay 1e-4) within 2e-5, 1% of the most two steps can move
it.
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
B, S = 2, 64
LR, WD = 1e-3, 1e-4  # optax.adamw(1e-3): weight decay 1e-4
OUT_TOL, MOVE_TOL = 1e-5, 2e-5

# name: ((dp, ulysses, ring), remat)
CASES = {
    "ulysses 2 x ring 2": ((1, 2, 2), "none"),
    "ulysses 2 x ring 2 remat attn": ((1, 2, 2), "attn"),
    "dp 2 x ring 2": ((2, 1, 2), "none"),
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
    params = jllama.init_params(jax.random.PRNGKey(0), jllama.ModelConfig(
        **DIMS, dtype=jnp.float32, attn_impl="xla"))
    saved = {f"p0/{k}": x for k, x in _flat(params).items()}
    batches = _batches()
    for name, ((dp, uly, ring), remat) in CASES.items():
        cfg = jllama.ModelConfig(**DIMS, dtype=jnp.float32, attn_impl="xla",
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
        p, state = params, opt.init(params)
        for i, batch in enumerate(batches):
            p, state, loss = step(p, state, *(perm(jnp.asarray(x))
                                              for x in batch))
            saved[f"{name}/loss{i}"] = np.float32(loss)
        for k, x in _flat(p).items():
            saved[f"{name}/p/{k}"] = x
    np.savez(path / "ref.npz", **saved)


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
    p0 = {k[3:]: ref[k] for k in ref.files if k.startswith("p0/")}

    def params0():
        return params_from_jax(_tree(p0), device="cpu")

    opt = functools.partial(torch.optim.AdamW, lr=LR, weight_decay=WD)
    batches = [tuple(torch.from_numpy(x) for x in b) for b in _batches()]
    results = {}
    for name, ((dp, uly, ring), remat) in CASES.items():
        cfg = tllama.ModelConfig(**DIMS, dtype=torch.float32, remat=remat)
        mesh = tmesh.make_usp_mesh(dp=dp, ulysses=uly, ring=ring,
                                   device="cpu")

        def shard(x):
            return tmesh.seq_shard(mesh, tlay.permute_for_layout(
                x, DIMS["layout"], ring))

        with torch.no_grad():
            logits = tllama.make_forward(cfg, mesh)(params0(),
                                                    shard(batches[0][0]))
        logits = tlay.unpermute_from_layout(
            tmesh.seq_unshard(mesh, logits), DIMS["layout"], ring)
        step = tllama.make_train_step(cfg, opt, mesh=mesh)
        params, state, losses = params0(), None, []
        for batch in batches:
            params, state, loss = step(params, state,
                                       *(shard(x) for x in batch))
            losses.append(float(loss))
        results[name] = (logits.numpy(), losses, _flat(params))
    if rank == 0:
        errs = {}
        single = {}
        for remat in ("none", "attn"):
            cfg = tllama.ModelConfig(**DIMS, dtype=torch.float32,
                                     remat=remat)
            step = tllama.make_train_step(cfg, opt, device="cpu")
            params, state, losses = params0(), None, []
            for batch in batches:
                params, state, loss = step(params, state, *batch)
                losses.append(float(loss))
            single[remat] = (losses, _flat(params))
        for name, (logits, losses, flat) in results.items():
            remat = CASES[name][1]
            jlosses = [float(ref[f"{name}/loss{i}"]) for i in range(2)]
            jflat = {k: ref[f"{name}/p/{k}"] for k in p0}
            errs[f"{name}/logits"] = float(np.abs(
                logits - ref[f"{name}/logits"]).max())
            for who, (ls, fl) in (("jax", (jlosses, jflat)),
                                  ("single", single[remat])):
                errs[f"{name}/{who}/loss"] = float(max(
                    abs(a - b) for a, b in zip(losses, ls)))
                errs[f"{name}/{who}/move"] = float(max(
                    np.abs((flat[k] - p0[k]) - (fl[k] - p0[k])).max()
                    for k in p0))
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


@pytest.mark.parametrize("case", CASES)
def test_sharded_train_step_matches_single_device(train_errors, case):
    """The mesh step equals the port's own single-device step on the same
    batches (USP loss == DP loss, the reference's loss-curve check)."""
    assert train_errors[f"{case}/single/loss"] <= OUT_TOL, train_errors
    assert train_errors[f"{case}/single/move"] <= MOVE_TOL, train_errors
