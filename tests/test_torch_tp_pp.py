"""Tensor and pipeline parallelism of the port against the JAX package.

A 2-layer tiny model in fp32, the JAX weights carried over by
``params_from_jax``. JAX runs on its virtual CPU devices
(``tests/conftest.py``), its attention through the ring with impl ``xla``
(the fp32 oracle per step); the port runs on 4 gloo ranks (the kernels'
plain versions). One spawn of 4 workers runs every case and writes its
results; workers never import JAX.

* the rank grids: ``usp_rank_grid`` and ``make_usp_mesh``'s against JAX's
  ``make_usp_mesh(devices=...)`` device grid, for each tp / pp / ep
  combination and both ``ulysses_low`` values (exact);
* tp 2 x ring 2: ``make_forward``'s logits and two ``make_train_step``
  steps against JAX's on the same mesh (JAX ``tests/test_model.py:103``,
  ``:118``), and the mesh's summed gradients against JAX's single-device
  gradients (not scaled by the world size, ``:143``);
* pp 2 x ulysses 2: two ``make_pp_train_step`` steps against JAX's on the
  same mesh (``:184``);
* the divisibility raises (heads, kv heads, FFN columns and MoE under tp;
  layers and microbatches under pp);
* the entry points that take whole params over a dp x ring x ulysses
  mesh (the serving engines, the DiT) raise on a tp, pp or ep mesh.

Tolerances (fp32 on both sides, ``tests/test_torch_train_usp.py``'s):
logits and losses within 1e-5; each parameter's change over two AdamW
steps (lr 1e-3, weight decay 1e-4) within 2e-5, 1% of the most two steps
can move it; each gradient leaf within 1e-4 of its largest value (fp32
sums in another order over ranks; a gradient scaled by a degree of 2 or 4
would be off by 100% or more).
"""

import functools
import json
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from long_context_attention_tpu_torch.parallel.mesh import usp_rank_grid

torch.set_num_threads(1)

WORLD = 4
DIMS = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=8, ffn_hidden=64, layout="zigzag")
B, S = 2, 64
LR, WD = 1e-3, 1e-4  # optax.adamw(1e-3): weight decay 1e-4
OUT_TOL, MOVE_TOL, GRAD_TOL = 1e-5, 2e-5, 1e-4
N_MICRO = 2
# meshes with one axis that splits the params (a 4-rank world each)
SEQ_ONLY_MESHES = (dict(tp=2, ring=2), dict(pp=2, ulysses=2),
                   dict(ep=2, ring=2))

# name: (make_usp_mesh kwargs, pipeline?)
CASES = {
    "tp 2 x ring 2": (dict(tp=2, ring=2), False),
    "pp 2 x ulysses 2": (dict(pp=2, ulysses=2), True),
}
# (dp, ulysses, ring, tp, pp, ep): every combination with a tp, pp or ep
# degree above 1 on at most the 8 virtual devices
GRIDS = [(dp, u, r, tp, pp, ep)
         for dp in (1, 2) for u in (1, 2) for r in (1, 2)
         for tp in (1, 2) for pp in (1, 2) for ep in (1, 2)
         if max(tp, pp, ep) > 1 and dp * u * r * tp * pp * ep <= 8]
GRIDS += [(1, 1, 1, 4, 1, 1), (1, 1, 1, 1, 4, 1), (1, 1, 1, 1, 1, 4),
          (1, 1, 2, 1, 4, 1), (2, 1, 1, 4, 1, 1), (1, 2, 1, 1, 1, 4)]
# the grids a 4-rank world builds with make_usp_mesh
WORLD_GRIDS = [g for g in GRIDS if int(np.prod(g)) == WORLD]


def _grid_key(g, low):
    return "grid/" + "_".join(map(str, g)) + f"/{int(low)}"


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
    """The device grids, the initial params, and per case JAX's logits on
    the first batch (tp), its two steps' losses and final params, and the
    single-device gradients of the first batch."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from long_context_attention_tpu.models import llama as jllama
    from long_context_attention_tpu.parallel import make_usp_mesh
    from long_context_attention_tpu.parallel.layouts import (
        permute_for_layout, unpermute_from_layout)

    devs = jax.devices()
    index = {d: i for i, d in enumerate(devs)}
    saved = {}
    for g in GRIDS:
        dp, u, r, tp, pp, ep = g
        for low in (True, False):
            mesh = make_usp_mesh(dp=dp, ulysses=u, ring=r, tp=tp, pp=pp,
                                 ep=ep, devices=devs[:int(np.prod(g))],
                                 ulysses_low=low)
            saved[_grid_key(g, low)] = np.vectorize(index.get)(mesh.devices)
    cfg = jllama.ModelConfig(**DIMS, dtype=jnp.float32, attn_impl="xla")
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    saved.update({f"p0/{k}": x for k, x in _flat(params).items()})
    batches = _batches()
    for name, (kw, pipe) in CASES.items():
        mesh = make_usp_mesh(**kw, devices=devs[:WORLD])
        ring = kw.get("ring", 1)
        perm = functools.partial(permute_for_layout, layout=DIMS["layout"],
                                 ring_size=ring, axis=1)
        if not pipe:
            logits = jllama.make_forward(cfg, mesh)(params,
                                                    perm(batches[0][0]))
            saved[f"{name}/logits"] = np.asarray(unpermute_from_layout(
                logits, DIMS["layout"], ring, axis=1))
        opt = optax.adamw(LR)
        step = (jllama.make_pp_train_step(cfg, mesh, opt, n_micro=N_MICRO)
                if pipe else jllama.make_train_step(cfg, mesh, opt))
        p, state = params, opt.init(params)
        for i, batch in enumerate(batches):
            p, state, loss = step(p, state, *(perm(jnp.asarray(x))
                                              for x in batch))
            saved[f"{name}/loss{i}"] = np.float32(loss)
        for k, x in _flat(p).items():
            saved[f"{name}/p/{k}"] = x

    # single-device gradients of the first batch (tests/test_model.py:143)
    one = make_usp_mesh(1, 1, 1, devices=devs[:1])
    tok = P("dp", ("ring", "ulysses"))

    def lg(p, t, lab, m):
        def lf(pp):
            return jllama.loss_local(pp, t, lab, m, cfg, ulysses_axis="ulysses",
                                     ring_axis="ring", dp_axis="dp")
        return jax.tree.map(lambda x: lax.psum(x, ("dp", "ring", "ulysses")),
                            jax.grad(lf)(p))

    grads = jax.jit(jax.shard_map(lg, mesh=one, in_specs=(P(), tok, tok, tok),
                                  out_specs=P(), check_vma=False))(
        params, *(jnp.asarray(x) for x in batches[0]))
    saved.update({f"grad/{k}": x for k, x in _flat(grads).items()})
    np.savez(path / "ref.npz", **saved)


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def _worker(rank: int, tmp: str) -> None:
    """One gloo rank: the 4-rank grids, each case's mesh steps (and the tp
    case's logits and gradients), the raises; rank 0 writes the errors."""
    import dataclasses

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

    errs = {}
    # make_usp_mesh's grid and this rank's place in it, on every combination
    for g in WORLD_GRIDS:
        dp, u, r, tp, pp, ep = g
        for low in (True, False):
            mesh = tmesh.make_usp_mesh(dp=dp, ulysses=u, ring=r, tp=tp, pp=pp,
                                       ep=ep, ulysses_low=low, device="cpu")
            want = ref[_grid_key(g, low)]
            idx = (mesh.dp_idx, mesh.pp_idx, mesh.ep_idx, mesh.ring_idx,
                   mesh.ulysses_idx, mesh.tp_idx)
            ok = (mesh.grid.shape == want.shape
                  and (mesh.grid == want).all()
                  and mesh.full_grid[idx] == rank
                  and mesh.seq_ranks[mesh.seq_idx] == rank)
            errs[f"{_grid_key(g, low)}/rank{rank}"] = bool(ok)

    opt = functools.partial(torch.optim.AdamW, lr=LR, weight_decay=WD)
    batches = [tuple(torch.from_numpy(x) for x in b) for b in _batches()]
    cfg = tllama.ModelConfig(**DIMS, dtype=torch.float32)
    results = {}
    for name, (kw, pipe) in CASES.items():
        mesh = tmesh.make_usp_mesh(**kw, device="cpu")
        ring = mesh.ring

        def shard(x):
            return tmesh.seq_shard(mesh, tlay.permute_for_layout(
                x, DIMS["layout"], ring))

        res = {}
        if not pipe:
            with torch.no_grad():
                logits = tllama.make_forward(cfg, mesh)(
                    tllama.shard_params(params0(), mesh),
                    shard(batches[0][0]))
            res["logits"] = tlay.unpermute_from_layout(
                tmesh.seq_unshard(mesh, logits), DIMS["layout"], ring).numpy()
            # the summed gradients of the first batch, gathered
            p = tllama.shard_params(params0(), mesh)
            for t in tllama.param_leaves(p):
                t.requires_grad_(True)
            tllama.loss_local(p, *(shard(x) for x in batches[0]), cfg,
                              mesh=mesh).backward()
            tllama.reduce_grads(p, mesh)
            res["grads"] = _flat(tllama.gather_params(
                tllama._map(lambda t: t.grad, p), mesh))
        step = (tllama.make_pp_train_step(cfg, mesh, opt, N_MICRO) if pipe
                else tllama.make_train_step(cfg, opt, mesh=mesh))
        params, state, losses = tllama.shard_params(params0(), mesh), None, []
        for batch in batches:
            params, state, loss = step(params, state,
                                       *(shard(x) for x in batch))
            losses.append(float(loss))
        res["losses"] = losses
        res["params"] = _flat(tllama.gather_params(params, mesh))
        results[name] = res

    # the divisibility raises
    mesh = tmesh.make_usp_mesh(tp=2, ring=2, device="cpu")
    raises = {f"tp {k}={v}": _raises(lambda kw={k: v}: tllama.make_forward(
        dataclasses.replace(cfg, **kw), mesh))
        for k, v in (("n_heads", 3), ("n_kv_heads", 1), ("ffn_hidden", 63))}
    raises["tp moe"] = _raises(lambda: tllama.make_train_step(
        dataclasses.replace(cfg, n_experts=4), opt, mesh=mesh))
    raises["tp shard_params"] = _raises(lambda: tllama.shard_params(
        tllama.init_params(torch.Generator().manual_seed(0),
                           dataclasses.replace(cfg, ffn_hidden=63),
                           device="cpu"), mesh))
    mesh = tmesh.make_usp_mesh(pp=2, ulysses=2, device="cpu")
    raises["pp n_layers=3"] = _raises(lambda: tllama.make_pp_train_step(
        dataclasses.replace(cfg, n_layers=3), mesh, opt, N_MICRO))
    raises["pp moe"] = _raises(lambda: tllama.make_pp_train_step(
        dataclasses.replace(cfg, n_experts=4), mesh, opt, N_MICRO))
    step = tllama.make_pp_train_step(cfg, mesh, opt, 3)
    raises["pp n_micro=3"] = _raises(lambda: step(
        tllama.shard_params(params0(), mesh), None,
        *(tmesh.seq_shard(mesh, x) for x in batches[0])))
    errs.update({f"raises/{k}/rank{rank}": v for k, v in raises.items()})

    # whole-params entry points refuse a mesh with a tp, pp or ep axis
    from long_context_attention_tpu_torch.models import dit as tdit
    from long_context_attention_tpu_torch import serving as tserve
    for kw in SEQ_ONLY_MESHES:
        mesh = tmesh.make_usp_mesh(**kw, device="cpu")
        tag = " x ".join(f"{k} {v}" for k, v in kw.items())
        makers = {
            "Engine": lambda: tserve.Engine(cfg, 64, mesh=mesh),
            "ShardedEngine": lambda: tserve.ShardedEngine(cfg, mesh, 64),
            "ShardedContinuousEngine": lambda: tserve.ShardedContinuousEngine(
                cfg, 64, 2, mesh=mesh),
            "make_dit_forward": lambda: tdit.make_dit_forward(
                tdit.DiTConfig(dtype=torch.float32), mesh)}
        errs.update({f"seq_only/{name} {tag}/rank{rank}": _raises(make)
                     for name, make in makers.items()})

    gathered = [None] * WORLD
    dist.all_gather_object(gathered, errs)
    if rank == 0:
        out = {k: v for e in gathered for k, v in e.items()}
        for name, res in results.items():
            jlosses = [float(ref[f"{name}/loss{i}"]) for i in range(2)]
            jflat = {k: ref[f"{name}/p/{k}"] for k in p0}
            if "logits" in res:
                out[f"{name}/logits"] = float(np.abs(
                    res["logits"] - ref[f"{name}/logits"]).max())
                out[f"{name}/grads"] = float(max(
                    np.abs(res["grads"][k] - ref[f"grad/{k}"]).max()
                    / np.abs(ref[f"grad/{k}"]).max() for k in p0))
            out[f"{name}/loss"] = float(max(
                abs(a - b) for a, b in zip(res["losses"], jlosses)))
            out[f"{name}/move"] = float(max(
                np.abs((res["params"][k] - p0[k]) - (jflat[k] - p0[k])).max()
                for k in p0))
            out[f"{name}/min_move"] = float(min(
                np.abs(jflat[k] - p0[k]).max() for k in p0))
        (path / "results.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def tp_pp_results(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp_pp")
    _jax_references(path)
    mp.start_processes(_worker, args=(str(path),), nprocs=WORLD, join=True,
                       start_method="spawn")
    return json.loads((path / "results.json").read_text()), np.load(
        path / "ref.npz")


@pytest.mark.parametrize("low", [True, False])
def test_rank_grid_matches_jax(tp_pp_results, low):
    """usp_rank_grid equals JAX's make_usp_mesh(devices=...) device grid,
    rank i for device i, shape included, for every combination."""
    _, ref = tp_pp_results
    for g in GRIDS:
        dp, u, r, tp, pp, ep = g
        got = usp_rank_grid(dp, u, r, tp, pp, ep, ulysses_low=low)
        want = ref[_grid_key(g, low)]
        assert got.shape == want.shape and (got == want).all(), g


def test_make_usp_mesh_grids_match_jax(tp_pp_results):
    """make_usp_mesh on 4 ranks: its grid equals JAX's, and each rank sits
    at its own indices (and its sequence group's place)."""
    out, _ = tp_pp_results
    keys = [k for k in out if k.startswith("grid/")]
    assert len(keys) == len(WORLD_GRIDS) * 2 * WORLD
    assert all(out[k] for k in keys), [k for k in keys if not out[k]]


def test_tp_forward_matches_jax(tp_pp_results):
    """make_forward over tp 2 x ring 2: the first batch's logits (gathered,
    in the original order) equal JAX's make_forward on the same mesh."""
    out, _ = tp_pp_results
    assert out["tp 2 x ring 2/logits"] <= OUT_TOL, out


@pytest.mark.parametrize("case", CASES)
def test_mesh_train_steps_match_jax(tp_pp_results, case):
    """Two steps (make_train_step over tp 2 x ring 2, make_pp_train_step
    over pp 2 x ulysses 2 in 2 microbatches): each step's loss and each
    parameter's change equal JAX's step on the same mesh, and every leaf
    moved."""
    out, _ = tp_pp_results
    assert out[f"{case}/loss"] <= OUT_TOL, out
    assert out[f"{case}/move"] <= MOVE_TOL, out
    assert out[f"{case}/min_move"] > LR, out


def test_tp_grads_not_scaled_by_world_size(tp_pp_results):
    """The tp 2 x ring 2 mesh's summed gradients (each leaf over the axes
    it is replicated on, none over tp) equal JAX's single-device gradients
    of the same batch."""
    out, _ = tp_pp_results
    assert out["tp 2 x ring 2/grads"] <= GRAD_TOL, out


def test_divisibility_raises(tp_pp_results):
    """ValueError where tp does not divide the heads, the kv heads or the
    FFN's columns, for an MoE model under tp, and where pp does not divide
    the layers or n_micro the local batch, and for an MoE model under pp."""
    out, _ = tp_pp_results
    keys = [k for k in out if k.startswith("raises/")]
    assert len(keys) == 8 * WORLD
    assert all(out[k] for k in keys), [k for k in keys if not out[k]]


def test_seq_only_entry_points_raise_on_tp_pp_ep_meshes(tp_pp_results):
    """Engine, ShardedEngine, the sharded continuous engines and the DiT
    take whole params and split only the batch and the sequence: on a
    mesh with a tp, pp or ep axis they raise ValueError (a tp mesh would
    sum whole outputs over tp, an ep mesh hand each rank every expert)."""
    out, _ = tp_pp_results
    keys = [k for k in out if k.startswith("seq_only/")]
    assert len(keys) == 4 * len(SEQ_ONLY_MESHES) * WORLD
    assert all(out[k] for k in keys), [k for k in keys if not out[k]]
