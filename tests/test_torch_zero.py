"""ZeRO-1/2 and ZeRO-3 of the port against the JAX package.

A 2-layer tiny model in fp32 (``tests/test_torch_train_usp.py``'s), the
JAX weights carried over by ``params_from_jax``. JAX runs on its virtual CPU devices
(``tests/conftest.py``) with attention impl ``xla``; the port runs on 4
gloo ranks (one spawn, workers never import JAX):

* ``zero_param_specs`` / ``zero3_param_specs`` pick JAX's dimensions,
  leaves that dp does not divide included (exact), on dp 4, dp 2 x ring 2
  and dp 2 x tp 2 meshes;
* ``make_zero_train_step`` over dp 2 x ring 2 and dp 2 x tp 2: two steps
  against JAX's ``make_zero_train_step`` on the same mesh, and each Adam
  moment holding 1/dp of its leaf (JAX ``tests/test_zero.py``);
* ``make_zero3_train_step`` over dp 2 x ring 2: two steps against JAX's
  ZeRO-3 trajectory, the params 1/dp at rest; and with ``remat="full"``
  over dp 4 (the backward gathers each layer again): the loss falls over
  three steps and equals the same mesh's remat-free steps.

Tolerances (``tests/test_torch_train_usp.py``'s): losses within 1e-5, each
parameter's change over two AdamW steps (lr 1e-3, weight decay 1e-4)
within 2e-5.
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
B, S = 4, 64
LR, WD = 1e-3, 1e-4
OUT_TOL, MOVE_TOL = 1e-5, 2e-5

# name: (make_usp_mesh kwargs, ZeRO-3?)
CASES = {
    "zero dp 2 x ring 2": (dict(dp=2, ring=2), False),
    "zero dp 2 x tp 2": (dict(dp=2, tp=2), False),
    "zero3 dp 2 x ring 2": (dict(dp=2, ring=2), True),
}
SPEC_MESHES = {"dp 4": dict(dp=4), "dp 2 x ring 2": dict(dp=2, ring=2),
               "dp 2 x tp 2": dict(dp=2, tp=2)}
# a params-shaped dict of leaves dp 4 divides on no dimension, on one
# dimension, or on two of the same size (the first wins)
ODD = {"w": (8, 6), "tiny": (3,), "tie": (4, 4), "pair": (2, 12)}


def _batches(n=2):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        tokens = rng.integers(0, DIMS["vocab"], size=(B, S)).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        mask = np.ones((B, S), np.float32)
        mask[:, -1] = 0
        out.append((tokens, labels, mask))
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for name in tree
                for k, v in _flat(tree[name], f"{prefix}{name}/").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
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


def _spec_json(tree):
    """A spec tree (PartitionSpecs or tuples) as {path: [entries]}."""
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else k: v for k in tree
                for p, v in _spec_json(tree[k]).items()}
    return {"": [e if e is None or isinstance(e, str) else list(e)
                 for e in tuple(tree)]}


def _jax_references(path: pathlib.Path) -> None:
    """The specs, the initial params, and per case JAX's two steps' losses
    and final params."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    from long_context_attention_tpu.models import llama as jllama
    from long_context_attention_tpu.parallel import make_usp_mesh
    from long_context_attention_tpu.parallel.layouts import (
        permute_for_layout)
    from long_context_attention_tpu.parallel.mesh import MeshAxes
    from long_context_attention_tpu.parallel import zero as jzero

    devs = jax.devices()[:WORLD]
    cfg = jllama.ModelConfig(**DIMS, dtype=jnp.float32, attn_impl="xla")
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    shapes = jax.eval_shape(lambda: params)
    specs = {}
    for name, kw in SPEC_MESHES.items():
        mesh = make_usp_mesh(**kw, devices=devs)
        base = jllama.param_specs(MeshAxes(), kw.get("tp", 1) > 1)
        specs[f"zero {name}"] = _spec_json(
            jzero.zero_param_specs(shapes, base, mesh))
        specs[f"zero3 {name}"] = _spec_json(
            jzero.zero3_param_specs(shapes, mesh))
        odd = {k: jax.ShapeDtypeStruct(v, jnp.float32)
               for k, v in ODD.items()}
        specs[f"odd {name}"] = _spec_json(
            jzero.zero_param_specs(odd, P(), mesh))
    saved = {f"p0/{k}": x for k, x in _flat(params).items()}
    batches = _batches()
    for name, (kw, three) in CASES.items():
        mesh = make_usp_mesh(**kw, devices=devs)
        ring = kw.get("ring", 1)
        opt = optax.adamw(LR)
        if three:
            zs = jzero.zero3_param_specs(params, mesh)
            p = jzero.shard_params_zero3(params, mesh, zs)
            step = jzero.make_zero3_train_step(cfg, mesh, opt)
        else:
            zs = jzero.zero_param_specs(
                params, jllama.param_specs(MeshAxes(), kw.get("tp", 1) > 1),
                mesh)
            p = params
            step = jzero.make_zero_train_step(cfg, mesh, opt)
        state = jzero.init_zero_opt_state(opt, p, mesh, zs)
        for i, batch in enumerate(batches):
            p, state, loss = step(p, state, *(permute_for_layout(
                jnp.asarray(x), DIMS["layout"], ring, axis=1)
                for x in batch))
            saved[f"{name}/loss{i}"] = np.float32(loss)
        saved.update({f"{name}/p/{k}": x for k, x in _flat(p).items()})
    np.savez(path / "ref.npz", **saved)
    (path / "specs.json").write_text(json.dumps(specs))


def _worker(rank: int, tmp: str) -> None:
    """One gloo rank: the specs, each case's two steps, the moments'
    sizes, ZeRO-3 under remat full; rank 0 writes the results."""
    import dataclasses

    from long_context_attention_tpu_torch.models import llama as tllama
    from long_context_attention_tpu_torch.parallel import layouts as tlay
    from long_context_attention_tpu_torch.parallel import mesh as tmesh
    from long_context_attention_tpu_torch.parallel import zero as tzero
    from long_context_attention_tpu_torch.utils.convert import (
        params_from_jax)

    torch.set_num_threads(1)
    path = pathlib.Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{path}/rdzv",
                            rank=rank, world_size=WORLD)
    ref = np.load(path / "ref.npz")
    p0 = {k[3:]: ref[k] for k in ref.files if k.startswith("p0/")}
    cfg = tllama.ModelConfig(**DIMS, dtype=torch.float32)

    def params0():
        return params_from_jax(_tree(p0), device="cpu")

    specs = {}
    for name, kw in SPEC_MESHES.items():
        mesh = tmesh.make_usp_mesh(**kw, device="cpu")
        shapes = tllama.param_shapes(cfg)
        base = tllama.param_specs(mesh.axes, mesh.tp > 1)
        specs[f"zero {name}"] = _spec_json(
            tzero.zero_param_specs(shapes, base, mesh))
        specs[f"zero3 {name}"] = _spec_json(
            tzero.zero3_param_specs(shapes, mesh))
        specs[f"odd {name}"] = _spec_json(
            tzero.zero_param_specs(ODD, (), mesh))

    opt = functools.partial(torch.optim.AdamW, lr=LR, weight_decay=WD)
    out = {"specs": specs}
    for name, (kw, three) in CASES.items():
        mesh = tmesh.make_usp_mesh(**kw, device="cpu")

        def shard(x):
            return tmesh.seq_shard(mesh, tlay.permute_for_layout(
                x, DIMS["layout"], mesh.ring))

        full = params0()
        if three:
            zs = tzero.zero3_param_specs(tllama.param_shapes(cfg), mesh)
            params = tzero.shard_params_zero3(full, mesh, zs)
            step = tzero.make_zero3_train_step(cfg, mesh, opt)
        else:
            zs = None
            params = tllama.shard_params(full, mesh)
            step = tzero.make_zero_train_step(cfg, mesh, opt)
        state, losses = None, []
        for b in _batches():
            params, state, loss = step(params, state, *(
                shard(torch.from_numpy(x)) for x in b))
            losses.append(float(loss))
        res = {"losses": losses}
        # the optimizer's moments: 1/dp of each leaf that dp divides
        moments, leaves = (state.optimizer.state, state.shards) if not three \
            else (state.state, tllama.param_leaves(params))
        local = tllama.param_leaves(tllama.shard_params(full, mesh)) \
            if not three else tllama.param_leaves(full)
        paths = [k for k, _ in tllama.named_leaves(full)]
        res["moment_fractions"] = {
            k: moments[s]["exp_avg"].numel() / t.numel()
            for k, s, t in zip(paths, leaves, local)}
        res["params"] = {k: v.tolist() for k, v in _flat(
            tllama.gather_params(params, mesh, zs)).items()}
        out[name] = res

    # ZeRO-3 under remat full at dp 4: three steps, against remat none
    mesh = tmesh.make_usp_mesh(dp=4, device="cpu")
    remat = {}
    for r in ("full", "none"):
        rcfg = dataclasses.replace(cfg, remat=r)
        zs = tzero.zero3_param_specs(tllama.param_shapes(rcfg), mesh)
        params = tzero.shard_params_zero3(params0(), mesh, zs)
        step = tzero.make_zero3_train_step(rcfg, mesh, opt)
        state, losses = None, []
        for b in _batches(3):
            params, state, loss = step(params, state, *(
                tmesh.seq_shard(mesh, torch.from_numpy(x)) for x in b))
            losses.append(float(loss))
        remat[r] = losses
    out["remat"] = remat
    gathered = [None] * WORLD
    dist.all_gather_object(gathered, out)
    if rank == 0:
        (path / "results.json").write_text(json.dumps(gathered))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def zero_results(tmp_path_factory):
    path = tmp_path_factory.mktemp("zero")
    _jax_references(path)
    mp.start_processes(_worker, args=(str(path),), nprocs=WORLD, join=True,
                       start_method="spawn")
    return (json.loads((path / "results.json").read_text()),
            json.loads((path / "specs.json").read_text()),
            np.load(path / "ref.npz"))


@pytest.mark.parametrize("kind", ["zero", "zero3", "odd"])
@pytest.mark.parametrize("mesh", SPEC_MESHES)
def test_zero_specs_match_jax(zero_results, kind, mesh):
    """zero_param_specs / zero3_param_specs give every leaf JAX's spec:
    the same dimension on dp (the largest free one that dp divides, the
    first on a tie; never the stacked layer axis for ZeRO-3), tp's entries
    kept, the leaves dp does not divide left as they were."""
    ranks, jspecs, _ = zero_results
    want = jspecs[f"{kind} {mesh}"]
    for out in ranks:
        assert out["specs"][f"{kind} {mesh}"] == want


@pytest.mark.parametrize("case", CASES)
def test_zero_steps_match_jax(zero_results, case):
    """Two ZeRO steps: each step's loss and each parameter's change equal
    JAX's step of the same stage on the same mesh."""
    ranks, _, ref = zero_results
    p0 = {k[3:]: ref[k] for k in ref.files if k.startswith("p0/")}
    jl = [float(ref[f"{case}/loss{i}"]) for i in range(2)]
    for out in ranks:
        res = out[case]
        assert max(abs(a - b) for a, b in zip(res["losses"], jl)) <= OUT_TOL
        move = max(np.abs((np.asarray(res["params"][k]) - p0[k])
                          - (ref[f"{case}/p/{k}"] - p0[k])).max()
                   for k in p0)
        assert move <= MOVE_TOL, (case, move)


@pytest.mark.parametrize("case", CASES)
def test_zero_moments_are_sharded(zero_results, case):
    """Each Adam moment holds 1/dp of its leaf where dp divides it (ZeRO-1;
    ZeRO-3's state lives on the rest-layout shards), the whole leaf where
    it does not; and the large leaves (embed, the attention and FFN
    weights) are all sharded."""
    ranks, jspecs, _ = zero_results
    kind = "zero3" if case.startswith("zero3") else "zero"
    mesh = case.split(" ", 1)[1]
    specs = jspecs[f"{kind} {mesh}"]
    for out in ranks:
        fracs = out[case]["moment_fractions"]
        assert fracs.keys() == specs.keys()
        for k, frac in fracs.items():
            assert frac == (0.5 if "dp" in specs[k] else 1.0), (k, frac)
        assert sum(f == 0.5 for f in fracs.values()) >= 8


def test_zero3_remat_full_trains(zero_results):
    """ZeRO-3 with remat full over dp 4 (the backward gathers each layer
    again): the loss falls over three steps, step for step the remat-free
    run's."""
    ranks, _, _ = zero_results
    for out in ranks:
        full, none = out["remat"]["full"], out["remat"]["none"]
        assert full[-1] < full[0], full
        assert max(abs(a - b) for a, b in zip(full, none)) <= OUT_TOL
