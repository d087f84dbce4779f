"""The sequence-sharded serving prefill and the async USP layer of the port
against the JAX package, on a dp 1 x ulysses 2 x ring 2 mesh.

JAX's ``Engine(mesh=make_usp_mesh(1, 2, 2))`` (zigzag and basic layouts)
and ``AsyncLongContextAttention`` run first, on 4 of the 8 virtual devices
of ``tests/conftest.py``, and save their results; then one spawn of 4 gloo
ranks (its own rendezvous, one torch thread each; workers never import
JAX) runs the port's ``Engine(mesh=...)`` with the same weights
(``params_from_jax``) and prompt, its meshless ``Engine`` (rank 0), and
the port's async layer against its ``LongContextAttention``, and writes
the errors; each case is its own test (the pattern of
``tests/test_serving.py::test_engine_usp_prefill_on_mesh`` and
``tests/test_torch_usp.py``).

Both engines run the bf16 tiny model of ``tests/test_serving.py`` (its
``ZCFG``) with the JAX kernels in interpret mode on one side and the plain
versions on the other. JAX's async layer runs its ring with impl ``xla``
(the fp32 oracle per step; Pallas interpret mode at four group counts
would cost minutes), the port's with ``pallas`` (the kernels' plain
versions), in fp32.

Tolerances: prefill logits and the cache's prompt rows 5e-2, greedy
tokens equal up to the first two (the JAX test's gates: bf16 activations
round at other places in the sharded forward); the async layer's out
2e-5 and grads 2e-4 against JAX (``tests/test_torch_usp.py``'s: the same
fp32 arithmetic in another order), and bit for bit against the port's
dense layer.
"""

import json
import pathlib

import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)

WORLD = 4
DP, ULYSSES, RING = 1, 2, 2
SHAPE = dict(vocab=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=32, ffn_hidden=128)
B, S_PROMPT, S_MAX, NEW = 2, 16, 64, 6
LAYOUTS = ("zigzag", "basic")
BF16_TOL = 5e-2
# the async layer: kv heads 8, so that 4 groups still hold one kv head per
# ulysses rank
A_B, A_S, A_H, A_HKV, A_D = 1, 128, 16, 8, 32
GROUPS = (None, 1, 2, 4)
OUT_TOL, GRAD_TOL = 2e-5, 2e-4


def _prompt():
    return np.random.default_rng(1).integers(
        0, SHAPE["vocab"], (B, S_PROMPT)).astype(np.int32)


def _attn_inputs():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((A_B, A_S, A_H, A_D), (A_B, A_S, A_HKV, A_D),
                               (A_B, A_S, A_HKV, A_D), (A_B, A_S, A_H, A_D)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for name in tree
                for k, v in _flat(tree[name], f"{prefix}{name}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _tree(flat):
    tree = {}
    for path, x in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = x
    return tree


def _f32(x):
    return np.asarray(x, np.float32)


def _jax_references(path: pathlib.Path) -> None:
    """The bf16 params (as fp32) and, per layout, JAX's mesh prefill logits,
    prompt cache rows and greedy tokens; per group count, the async
    layer's out and grads."""
    import jax
    import jax.numpy as jnp

    from long_context_attention_tpu.models import llama as jllama
    from long_context_attention_tpu.parallel import make_usp_mesh
    from long_context_attention_tpu.parallel.usp import (
        AsyncLongContextAttention)
    from long_context_attention_tpu.serving.engine import Engine

    mesh = make_usp_mesh(dp=DP, ulysses=ULYSSES, ring=RING,
                         devices=jax.devices()[:WORLD])
    params = jllama.init_params(jax.random.PRNGKey(0),
                                jllama.ModelConfig(**SHAPE))
    flat = _flat(params)
    saved = {f"p0/{k}": _f32(x) for k, x in flat.items()}
    saved["bf16_leaves"] = np.array(
        [k for k, x in flat.items() if x.dtype.name == "bfloat16"])
    prompt = jnp.asarray(_prompt())
    for layout in LAYOUTS:
        eng = Engine(cfg=jllama.ModelConfig(**SHAPE, layout=layout),
                     s_max=S_MAX, mesh=mesh)
        logits, cache = eng.prefill(params, prompt)
        saved[f"{layout}/logits"] = _f32(logits)
        saved[f"{layout}/k"] = _f32(cache.k[:, :, :, :S_PROMPT])
        saved[f"{layout}/v"] = _f32(cache.v[:, :, :, :S_PROMPT])
        saved[f"{layout}/tokens"] = np.asarray(
            eng.generate(params, prompt, NEW).tokens)
    q, k, v, dout = (jnp.asarray(x) for x in _attn_inputs())
    for g in GROUPS:
        layer = AsyncLongContextAttention(mesh, impl="xla", n_groups=g)
        out = layer(q, k, v, causal=True)
        grads = jax.grad(lambda *a: jnp.sum(layer(*a, causal=True) * dout),
                         argnums=(0, 1, 2))(q, k, v)
        for name, x in zip(("out", "dq", "dk", "dv"), (out, *grads)):
            saved[f"async {g}/{name}"] = _f32(x)
    np.savez(path / "ref.npz", **saved)


def _engine_errors(ref, mesh, params, prompt, cfg_cls, Engine):
    """Per layout: the mesh engine against JAX's, and (on rank 0) against
    the port's meshless engine; the logits and caches of every rank."""
    errs = {}
    for layout in LAYOUTS:
        cfg = cfg_cls(**SHAPE, layout=layout)
        eng = Engine(cfg=cfg, s_max=S_MAX, mesh=mesh)
        logits, cache = eng.prefill(params, prompt)
        got = {"logits": logits.float().numpy(),
               "k": cache.k[:, :, :, :S_PROMPT].float().numpy(),
               "v": cache.v[:, :, :, :S_PROMPT].float().numpy()}
        toks = eng.generate(params, prompt, NEW).tokens.numpy()
        for name, x in got.items():
            errs[f"{layout}/jax/{name}"] = float(np.abs(
                x - ref[f"{layout}/{name}"]).max())
        errs[f"{layout}/jax/tokens"] = toks.tolist()
        errs[f"{layout}/ref_tokens"] = ref[f"{layout}/tokens"].tolist()
        if mesh.rank == 0:
            one = Engine(cfg=cfg, s_max=S_MAX, device="cpu")
            ol, oc = one.prefill(params, prompt)
            want = {"logits": ol.float().numpy(),
                    "k": oc.k[:, :, :, :S_PROMPT].float().numpy(),
                    "v": oc.v[:, :, :, :S_PROMPT].float().numpy()}
            for name, x in got.items():
                errs[f"{layout}/single/{name}"] = float(np.abs(
                    x - want[name]).max())
            errs[f"{layout}/single/tokens"] = one.generate(
                params, prompt, NEW).tokens.numpy().tolist()
    return errs


def _async_errors(ref, mesh):
    """Per group count: the async layer's gathered out and grads against
    JAX's layer and against the port's LongContextAttention."""
    from long_context_attention_tpu_torch.parallel import mesh as tmesh
    from long_context_attention_tpu_torch.parallel.usp import (
        AsyncLongContextAttention, LongContextAttention)

    q, k, v, dout = (tmesh.seq_shard(mesh, torch.from_numpy(x))
                     for x in _attn_inputs())

    def run(layer):
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        out = layer(*args, causal=True)
        grads = torch.autograd.grad(out, args, dout)
        return [tmesh.seq_unshard(mesh, t.detach()).numpy()
                for t in (out, *grads)]

    dense = run(LongContextAttention(mesh))
    errs = {}
    for g in GROUPS:
        got = run(AsyncLongContextAttention(mesh, n_groups=g))
        for i, name in enumerate(("out", "dq", "dk", "dv")):
            errs[f"async {g}/jax/{name}"] = float(np.abs(
                got[i] - ref[f"async {g}/{name}"]).max())
            errs[f"async {g}/dense/{name}"] = float(np.abs(
                got[i] - dense[i]).max())
    return errs


def _worker(rank: int, tmp: str) -> None:
    from long_context_attention_tpu_torch.models import llama as tllama
    from long_context_attention_tpu_torch.parallel import mesh as tmesh
    from long_context_attention_tpu_torch.serving.engine import Engine
    from long_context_attention_tpu_torch.utils.convert import (
        params_from_jax)

    torch.set_num_threads(1)
    path = pathlib.Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{path}/rdzv",
                            rank=rank, world_size=WORLD)
    ref = np.load(path / "ref.npz")
    p0 = {k[3:]: ref[k] for k in ref.files if k.startswith("p0/")}
    bf16 = set(ref["bf16_leaves"].tolist())
    params = params_from_jax(_tree({
        k: x.astype(ml_dtypes.bfloat16) if k in bf16 else x
        for k, x in p0.items()}), device="cpu")
    mesh = tmesh.make_usp_mesh(dp=DP, ulysses=ULYSSES, ring=RING,
                               device="cpu")
    errs = _engine_errors(ref, mesh, params, torch.from_numpy(_prompt()),
                          tllama.ModelConfig, Engine)
    errs.update(_async_errors(ref, mesh))
    every = [None] * WORLD
    dist.all_gather_object(every, errs)
    if rank == 0:
        merged = dict(every[0])
        for other in every[1:]:
            for key, x in other.items():
                if isinstance(x, float):
                    merged[key] = max(merged[key], x)
                elif key.endswith("/jax/tokens"):
                    merged[key + " (all ranks)"] = merged.get(
                        key + " (all ranks)", [merged[key]]) + [x]
        (path / "results.json").write_text(json.dumps(merged))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def errors(tmp_path_factory):
    path = tmp_path_factory.mktemp("engine_mesh")
    _jax_references(path)
    mp.start_processes(_worker, args=(str(path),), nprocs=WORLD, join=True,
                       start_method="spawn")
    return json.loads((path / "results.json").read_text())


def _first_diff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return min(int(np.argmax(x != y)) if (x != y).any() else len(x)
               for x, y in zip(a, b))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_prefill_matches_jax(errors, layout):
    """Engine(mesh=(1, 2, 2)).prefill on every rank: the last token's
    logits and the cache's prompt rows equal JAX's mesh engine's."""
    for name in ("logits", "k", "v"):
        assert errors[f"{layout}/jax/{name}"] <= BF16_TOL, errors


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_generate_matches_jax(errors, layout):
    """generate over the mesh prefill's cache, on every rank: greedy tokens
    equal JAX's mesh engine's up to the first two."""
    ref = errors[f"{layout}/ref_tokens"]
    for toks in errors[f"{layout}/jax/tokens (all ranks)"]:
        assert _first_diff(toks, ref) >= 2, errors


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_engine_matches_single_device(errors, layout):
    """The mesh engine against the port's meshless Engine on the same
    weights and prompt: logits, prompt cache rows, greedy tokens."""
    for name in ("logits", "k", "v"):
        assert errors[f"{layout}/single/{name}"] <= BF16_TOL, errors
    assert _first_diff(errors[f"{layout}/jax/tokens"],
                       errors[f"{layout}/single/tokens"]) >= 2, errors


@pytest.mark.parametrize("n_groups", GROUPS)
def test_async_layer_matches_jax(errors, n_groups):
    """AsyncLongContextAttention(n_groups=...) at ulysses 2 x ring 2: out
    and grads equal JAX's layer on the same global inputs."""
    assert errors[f"async {n_groups}/jax/out"] <= OUT_TOL, errors
    for name in ("dq", "dk", "dv"):
        assert errors[f"async {n_groups}/jax/{name}"] <= GRAD_TOL, errors


@pytest.mark.parametrize("n_groups", GROUPS)
def test_async_layer_matches_dense_layer(errors, n_groups):
    """The async layer against the port's LongContextAttention, bit for
    bit: each head's arithmetic is the same (a group keeps its q heads'
    kv head), only the head groups and the order of the collectives
    differ."""
    for name in ("out", "dq", "dk", "dv"):
        assert errors[f"async {n_groups}/dense/{name}"] == 0.0, errors


def test_engine_mesh_rules(monkeypatch):
    """Engine(mesh=...) runs on the mesh's device (another device raises)
    and on a mesh of one equals the meshless engine; without a mesh and
    without CUDA the engine raises unless given the CPU."""
    from long_context_attention_tpu_torch.models import llama as tllama
    from long_context_attention_tpu_torch.parallel import mesh as tmesh
    from long_context_attention_tpu_torch.serving.engine import Engine

    cfg = tllama.ModelConfig(**SHAPE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg=cfg, s_max=S_MAX)
    mesh = tmesh.make_usp_mesh(device="cpu")
    try:
        eng = Engine(cfg=cfg, s_max=S_MAX, mesh=mesh)
        assert eng.device == torch.device("cpu")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Engine(cfg=cfg, s_max=S_MAX, mesh=mesh, device="cuda")
        params = tllama.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
        logits, cache = eng.prefill(params, torch.from_numpy(_prompt()))
        one, ocache = Engine(cfg=cfg, s_max=S_MAX, device="cpu").prefill(
            params, torch.from_numpy(_prompt()))
        # a mesh of one: the zigzag ring of one runs B3's plain version at
        # the two-chunk descriptor, against B1's on one device
        assert float((logits - one).abs().max()) <= BF16_TOL
        assert int(cache.length[0]) == S_PROMPT
    finally:
        dist.destroy_process_group()
