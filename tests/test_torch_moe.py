"""Expert parallelism and the MoE model of the port against the JAX package.

fp32 on both sides. In the test process: ``moe_mlp_local`` on one rank
(its output, and the gradients of sum(y^2) with respect to the router, the
experts and the input) against JAX's, at a capacity that drops tokens and
at one that drops most (no NaN); ``Engine.generate``'s greedy tokens for a
tiny MoE model with bf16 and int8 caches against JAX's ``Engine`` (JAX
``tests/test_moe_model.py:111``); int8 decode weights raise. Then one
spawn of 4 gloo workers (never importing JAX) against JAX's ``shard_map``
on its virtual CPU devices: ``moe_mlp_local`` over ep 2 and ep 4 in both
token modes, its output and gradients (JAX ``tests/test_moe.py``); and the
MoE model's forward and two AdamW steps over ep 2 x ring 2 (JAX
``tests/test_moe_model.py``).

Routing is discrete, so every input here is held to a clear router margin:
the top two router logits of every routed token differ by more than
``MARGIN``, far above the ~1e-6 that fp32 sums in another order move them
(the tests assert it). Over ep the capacity is 8.0, so that no token drops
and the ranks' routing equals one rank's, as JAX's tests do.

Tolerances: the MLP's output and gradients within 1e-5 (fp32; a gradient
leaf against its largest value); the model's logits and losses within
1e-5 and each parameter's change over two steps within 2e-5
(``tests/test_torch_train_usp.py``'s); greedy tokens equal, on prompts
whose top-2 logit gap stays above 1e-3 at every step.
"""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from long_context_attention_tpu.models import llama as jllama
from long_context_attention_tpu.parallel import moe as jmoe
from long_context_attention_tpu.serving import engine as jeng
from long_context_attention_tpu_torch.models import llama as tllama
from long_context_attention_tpu_torch.parallel import moe as tmoe
from long_context_attention_tpu_torch.serving import engine as teng
from long_context_attention_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

WORLD = 4
MLP = dict(dim=32, ffn_hidden=64, n_experts=8)
MLP_TOL = 1e-5
MARGIN = 1e-4
OUT_TOL, MOVE_TOL = 1e-5, 2e-5
LR, WD = 1e-3, 1e-4
DIMS = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=8, ffn_hidden=64, layout="zigzag", n_experts=4,
            moe_capacity_factor=8.0)
B, S = 2, 64
EP_CASES = [(ep, rep) for ep in (2, 4) for rep in (False, True)]
# serving: a tiny MoE model at its default capacity (2.0)
SERVE = dict(vocab=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=32, ffn_hidden=128, layout="basic", n_experts=4)
S_PROMPT, S_MAX, NEW = 16, 64, 6
PROMPT_SEED = 5
TOKEN_GAP = 1e-3


def _margin(x, router):
    """The least gap between the top two router logits over x's tokens."""
    top = np.sort(x.reshape(-1, x.shape[-1]) @ router, axis=-1)
    return float((top[:, -1] - top[:, -2]).min())


def _mlp_setup(seed, x_shape, cf):
    cfg = jmoe.MoEConfig(**MLP, capacity_factor=cf, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jmoe.init_moe_params(
        jax.random.PRNGKey(seed), cfg))
    x = np.random.default_rng(seed).normal(size=x_shape).astype(np.float32)
    return cfg, params, x


def _jax_mlp(params, x, cfg, **kw):
    """JAX's output and gradients of sum(y^2) (router, experts, x)."""
    def loss(p, xx):
        y = jmoe.moe_mlp_local(p, xx, cfg, **kw)
        return jnp.sum(y ** 2), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return np.asarray(y), {**jax.tree.map(np.asarray, gp), "x": np.asarray(gx)}


def _torch_mlp(params, x, cf, **kw):
    cfg = tmoe.MoEConfig(**MLP, capacity_factor=cf, dtype=torch.float32)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    y = tmoe.moe_mlp_local(p, xt, cfg, **kw)
    (y ** 2).sum().backward()
    return y.detach().numpy(), {**{k: v.grad.numpy() for k, v in p.items()},
                                "x": xt.grad.numpy()}


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("cf", [2.0, 1.0])
def test_moe_mlp_matches_jax(cf):
    """One rank: out and the gradients against JAX's moe_mlp_local; at
    capacity 1.0 tokens drop, in JAX's token order."""
    cfg, params, x = _mlp_setup(0, (2, 64, MLP["dim"]), cf)
    assert _margin(x, params["router"]) > MARGIN
    y, g = _jax_mlp(params, x, cfg)
    with tmoe.record_drops() as drops:
        ty, tg = _torch_mlp(params, x, cf)
    assert np.abs(ty - y).max() <= MLP_TOL
    for k in g:
        assert _rel(tg[k], g[k]) <= MLP_TOL, k
    assert drops[0]["tokens"] == 128 and float(drops[0]["margin"]) > MARGIN
    assert (int(drops[0]["dropped"]) > 0) == (cf == 1.0), drops


def test_init_moe_params_and_specs():
    """init_moe_params' leaves have JAX's shapes and the config's dtype;
    moe_param_specs is JAX's split (the experts' leading axis over ep)."""
    cfg = tmoe.MoEConfig(**MLP)
    p = tmoe.init_moe_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    want = jax.eval_shape(lambda: jmoe.init_moe_params(
        jax.random.PRNGKey(0), jmoe.MoEConfig(**MLP)))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    assert tmoe.moe_param_specs(None) == tuple(jmoe.moe_param_specs(None))
    jspecs = jmoe.moe_param_specs("ep")
    assert tmoe.moe_param_specs("ep") == {k: tuple(v)
                                          for k, v in jspecs.items()}


def test_moe_capacity_drops_no_nan():
    """Capacity 0.25: most tokens drop to a zero output, no NaN, and the
    output equals JAX's; record_drops gives each token's expert, the
    argmax of its router logits."""
    cfg, params, x = _mlp_setup(1, (1, 32, MLP["dim"]), 0.25)
    assert _margin(x, params["router"]) > MARGIN
    y, _ = _jax_mlp(params, x, cfg)
    with tmoe.record_drops() as drops:
        ty, _ = _torch_mlp(params, x, 0.25)
    assert not np.isnan(ty).any() and ty.shape == x.shape
    assert int(drops[0]["dropped"]) >= 16
    assert (np.abs(ty).max(-1) == 0).sum() == int(drops[0]["dropped"])
    assert np.abs(ty - y).max() <= MLP_TOL
    assert (drops[0]["expert"].numpy() == np.argmax(
        x.reshape(-1, x.shape[-1]) @ params["router"], axis=-1)).all()


# --- serving ---------------------------------------------------------------


@pytest.fixture(scope="module")
def serve_setup():
    jcfg = jllama.ModelConfig(**SERVE, dtype=jnp.float32)
    tcfg = tllama.ModelConfig(**SERVE, dtype=torch.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    prompt = np.random.default_rng(PROMPT_SEED).integers(
        0, SERVE["vocab"], (2, S_PROMPT)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, prompt


def test_params_from_jax_carries_experts(serve_setup):
    """params_from_jax keeps the 4-D expert leaves (and the router) whole."""
    _, _, jparams, tparams, _ = serve_setup
    for k in ("router", "moe_up", "moe_down"):
        want = np.asarray(jparams["layers"][k])
        got = tparams["layers"][k]
        assert tuple(got.shape) == want.shape
        assert np.array_equal(got.numpy(), want)
    assert tparams["layers"]["moe_up"].dim() == 4


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_moe_generate_matches_jax(serve_setup, cache_dtype):
    """Engine.generate's greedy tokens equal JAX's Engine on the same MoE
    weights and prompt (the decode steps route at full capacity), on a
    prompt whose greedy chain has a clear top-2 gap at every step."""
    jcfg, tcfg, jparams, tparams, prompt = serve_setup
    want = jeng.Engine(cfg=jcfg, s_max=S_MAX, cache_dtype=cache_dtype
                       ).generate(jparams, jnp.asarray(prompt), NEW).tokens
    got = teng.Engine(cfg=tcfg, s_max=S_MAX, cache_dtype=cache_dtype,
                      device="cpu").generate(
        tparams, torch.from_numpy(prompt), NEW).tokens
    # the chain's gaps, from the port's forward over prompt + tokens
    seq = torch.cat([torch.from_numpy(prompt), got.long()], dim=1)
    with torch.no_grad():
        logits = tllama.forward_local(tparams, seq, tcfg)
    top = torch.sort(logits[:, S_PROMPT - 1:-1], dim=-1).values
    assert float((top[..., -1] - top[..., -2]).min()) > TOKEN_GAP
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_moe_int8_weights_raise(serve_setup):
    """weight_dtype="int8" raises for an MoE model (its experts stay bf16,
    as JAX's engine asserts)."""
    _, tcfg, _, tparams, prompt = serve_setup
    eng = teng.Engine(cfg=tcfg, s_max=S_MAX, weight_dtype="int8",
                      device="cpu")
    with pytest.raises(ValueError):
        eng.decode_params(tparams)
    with pytest.raises(ValueError):
        eng.generate(tparams, torch.from_numpy(prompt), 2)


# --- expert parallelism over 4 gloo ranks ----------------------------------


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


def _jax_references(path: pathlib.Path) -> None:
    """Per ep case JAX's shard_map output and gradients; the MoE model's
    initial params, its logits over ep 2 x ring 2 and two steps' losses and
    final params."""
    import optax
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P

    from long_context_attention_tpu.parallel import make_usp_mesh
    from long_context_attention_tpu.parallel.layouts import (
        permute_for_layout, unpermute_from_layout)

    devs = jax.devices()
    saved = {}
    cfg, params, x = _mlp_setup(2, (4, 32, MLP["dim"]), 8.0)
    saved.update({f"mlp/p/{k}": v for k, v in params.items()})
    saved["mlp/x"] = x
    saved["mlp/margin"] = np.float32(_margin(x, params["router"]))
    for ep, rep in EP_CASES:
        mesh = Mesh(np.array(devs[:ep]), axis_names=("ep",))
        specs = jmoe.moe_param_specs("ep")
        xs = P() if rep else P("ep")

        def lg(p, xx, rep=rep):
            def lf(pp, xv):
                y = jmoe.moe_mlp_local(pp, xv, cfg, ep_axis="ep",
                                       tokens_replicated=rep)
                # replicated tokens: every rank holds the whole output
                return jnp.sum(y ** 2) / (lax.axis_size("ep") if rep else 1)
            y = jmoe.moe_mlp_local(p, xx, cfg, ep_axis="ep",
                                   tokens_replicated=rep)
            g, gx = jax.grad(lf, argnums=(0, 1))(p, xx)
            g = {**g, "router": lax.psum(g["router"], "ep")}
            if rep:
                gx = lax.psum(gx, "ep")
            return y, g, gx

        y, g, gx = jax.jit(jax.shard_map(
            lg, mesh=mesh, in_specs=(specs, xs),
            out_specs=(xs, specs, xs), check_vma=False))(params, x)
        tag = f"ep{ep}/{int(rep)}"
        saved[f"{tag}/y"] = np.asarray(y)
        saved[f"{tag}/x"] = np.asarray(gx)
        saved.update({f"{tag}/{k}": np.asarray(v) for k, v in g.items()})

    # the MoE model over ep 2 x ring 2
    mcfg = jllama.ModelConfig(**DIMS, dtype=jnp.float32, attn_impl="xla")
    mparams = jllama.init_params(jax.random.PRNGKey(0), mcfg)
    saved.update({f"p0/{k}": v for k, v in _flat(mparams).items()})
    batches = _batches()
    mesh = make_usp_mesh(ring=2, ep=2, devices=devs[:WORLD])
    perm = functools.partial(permute_for_layout, layout=DIMS["layout"],
                             ring_size=2, axis=1)
    logits = jllama.make_forward(mcfg, mesh)(mparams, perm(batches[0][0]))
    saved["model/logits"] = np.asarray(unpermute_from_layout(
        logits, DIMS["layout"], 2, axis=1))
    opt = optax.adamw(LR)
    step = jllama.make_train_step(mcfg, mesh, opt)
    p, state = mparams, opt.init(mparams)
    for i, batch in enumerate(batches):
        p, state, loss = step(p, state, *(perm(jnp.asarray(x))
                                          for x in batch))
        saved[f"model/loss{i}"] = np.float32(loss)
    saved.update({f"model/p/{k}": v for k, v in _flat(p).items()})
    np.savez(path / "ref.npz", **saved)


def _worker(rank: int, tmp: str) -> None:
    """One gloo rank: every ep case of moe_mlp_local, then the MoE model
    over ep 2 x ring 2; rank 0 writes the errors."""
    from long_context_attention_tpu_torch.parallel import layouts as tlay
    from long_context_attention_tpu_torch.parallel import mesh as tmesh

    torch.set_num_threads(1)
    path = pathlib.Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{path}/rdzv",
                            rank=rank, world_size=WORLD)
    ref = np.load(path / "ref.npz")
    out = {}
    cfg = tmoe.MoEConfig(**MLP, capacity_factor=8.0, dtype=torch.float32)
    x = ref["mlp/x"]
    for ep, rep in EP_CASES:
        mesh = tmesh.make_usp_mesh(dp=WORLD // ep, ep=ep, device="cpu")
        i = mesh.ep_idx
        p = {k: torch.tensor(ref[f"mlp/p/{k}"]) for k in ("router", "w_up",
                                                          "w_down")}
        for k in ("w_up", "w_down"):
            p[k] = p[k].chunk(ep)[i].clone()
        for v in p.values():
            v.requires_grad_(True)
        xl = torch.tensor(x if rep else np.split(x, ep)[i],
                          requires_grad=True)
        with tmoe.record_drops() as drops:
            y = tmoe.moe_mlp_local(p, xl, cfg, ep_axis=mesh.ep_group,
                                   tokens_replicated=rep)
        ((y ** 2).sum() / (ep if rep else 1)).backward()
        g = {k: v.grad for k, v in p.items()}
        gx = xl.grad
        dist.all_reduce(g["router"], group=mesh.ep_group)
        if rep:
            dist.all_reduce(gx, group=mesh.ep_group)
        else:  # every rank's tokens, in ep order
            y = torch.cat([t for t in _gather(y.detach(), mesh.ep_group)])
            gx = torch.cat(_gather(gx, mesh.ep_group))
        for k in ("w_up", "w_down"):
            g[k] = torch.cat(_gather(g[k], mesh.ep_group))
        tag = f"ep{ep}/{int(rep)}"
        errs = {"y": float(np.abs(y.detach().numpy()
                                  - ref[f"{tag}/y"]).max()),
                "x": _rel(gx.numpy(), ref[f"{tag}/x"]),
                **{k: _rel(g[k].numpy(), ref[f"{tag}/{k}"]) for k in g},
                "dropped": int(drops[0]["dropped"])}
        out[f"{tag}/rank{rank}"] = errs

    # the MoE model over ep 2 x ring 2 (capacity 8.0), against JAX
    from long_context_attention_tpu_torch.utils.convert import (
        params_from_jax)

    p0 = {k[3:]: ref[k] for k in ref.files if k.startswith("p0/")}
    tcfg = tllama.ModelConfig(**DIMS, dtype=torch.float32)
    mesh = tmesh.make_usp_mesh(ring=2, ep=2, device="cpu")

    def params0():
        return tllama.shard_params(params_from_jax(_tree(p0), device="cpu"),
                                   mesh)

    def shard(x):
        return tmesh.seq_shard(mesh, tlay.permute_for_layout(
            x, DIMS["layout"], 2))

    batches = [tuple(torch.from_numpy(x) for x in b) for b in _batches()]
    with torch.no_grad(), tmoe.record_drops() as drops:
        logits = tllama.make_forward(tcfg, mesh)(params0(),
                                                 shard(batches[0][0]))
    logits = tlay.unpermute_from_layout(tmesh.seq_unshard(mesh, logits),
                                        DIMS["layout"], 2).numpy()
    model_drops = sum(int(d["dropped"]) for d in drops)
    model_margin = min(float(d["margin"]) for d in drops)
    opt = functools.partial(torch.optim.AdamW, lr=LR, weight_decay=WD)
    step = tllama.make_train_step(tcfg, opt, mesh=mesh)
    params, state, losses = params0(), None, []
    for batch in batches:
        params, state, loss = step(params, state, *(shard(x) for x in batch))
        losses.append(float(loss))
    flat = _flat(tllama.gather_params(params, mesh))
    gathered = [None] * WORLD
    dist.all_gather_object(gathered, out)
    if rank == 0:
        res = {k: v for o in gathered for k, v in o.items()}
        jl = [float(ref[f"model/loss{i}"]) for i in range(2)]
        res["model/logits"] = float(np.abs(logits - ref["model/logits"]).max())
        res["model/loss"] = float(max(abs(a - b) for a, b in zip(losses, jl)))
        res["model/move"] = float(max(
            np.abs((flat[k] - p0[k]) - (ref[f"model/p/{k}"] - p0[k])).max()
            for k in p0))
        res["model/min_move"] = float(min(
            np.abs(ref[f"model/p/{k}"] - p0[k]).max() for k in p0))
        res["model/dropped"] = model_drops
        res["model/margin"] = model_margin
        (path / "results.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def _gather(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


@pytest.fixture(scope="module")
def ep_results(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe")
    _jax_references(path)
    mp.start_processes(_worker, args=(str(path),), nprocs=WORLD, join=True,
                       start_method="spawn")
    return json.loads((path / "results.json").read_text()), np.load(
        path / "ref.npz")


@pytest.mark.parametrize("ep,rep", EP_CASES)
def test_ep_moe_mlp_matches_jax(ep_results, ep, rep):
    """moe_mlp_local over an ep group (tokens sharded over ep, or
    replicated and routed 1/ep per rank) against JAX's shard_map: the
    output and the gradients (the experts' gathered over ep, the router's
    summed), with no token dropped at capacity 8.0."""
    res, ref = ep_results
    assert float(ref["mlp/margin"]) > MARGIN
    for rank in range(WORLD):
        errs = res[f"ep{ep}/{int(rep)}/rank{rank}"]
        assert errs.pop("dropped") == 0, errs
        assert errs["y"] <= MLP_TOL, errs
        assert max(errs.values()) <= MLP_TOL, errs


def test_moe_model_forward_matches_jax(ep_results):
    """The MoE model's make_forward over ep 2 x ring 2 (the experts split
    over ep) equals JAX's on the same mesh, no token dropped."""
    res, _ = ep_results
    assert res["model/margin"] > MARGIN, res
    assert res["model/dropped"] == 0, res
    assert res["model/logits"] <= OUT_TOL, res


def test_moe_model_train_steps_match_jax(ep_results):
    """Two make_train_step steps of the MoE model over ep 2 x ring 2: each
    step's loss and each parameter's change (experts, router and the rest)
    equal JAX's make_train_step on the same mesh, and every leaf moved."""
    res, _ = ep_results
    assert res["model/loss"] <= OUT_TOL, res
    assert res["model/move"] <= MOVE_TOL, res
    assert res["model/min_move"] > LR, res
