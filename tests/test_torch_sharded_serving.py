"""The sequence-sharded serving engines of the port against the JAX package's
and against the port's own single-device engines, on a dp 1 x ulysses 2 x
ring 2 mesh (4 sequence shards).

JAX's ``ShardedEngine`` (basic and zigzag layouts) and
``ShardedContinuousEngine`` run first, on 4 of the 8 virtual devices of
``tests/conftest.py``, and save their greedy tokens; then one spawn of 4
gloo ranks (its own rendezvous, one torch thread each; workers never import
JAX) runs the port's five sharded engines with the same weights
(``params_from_jax``) and requests and writes every rank's tokens; each
check is its own test. The tiny config of JAX's
``tests/test_paged_sharded.py`` in float32 (as
``tests/test_torch_continuous.py`` explains), s_max 512: a rank holds 128
slots, one page of 128, so the dense and paged sharded engines walk the
same kv tiles.

Gates: tokens equal exactly (JAX's sharded engines; the paged, prefix,
windowed and speculative sharded engines against the dense sharded one, as
JAX's tests hold them; every rank the same). Against the port's
single-device engines the sharded ones run a bf16 cache: a rank's kv tile
is its 128 slots, the single device's the whole 512, and only the s8
path's per-tile P requantization would make that a different result.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)

WORLD = 4
DP, ULYSSES, RING = 1, 2, 2
SHAPE = dict(vocab=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=32, ffn_hidden=128)
S_MAX, PAGE = 512, 128
B, S_PROMPT, NEW = 2, 64, 6
LAYOUTS = ("basic", "zigzag")
# (prompt, max_new) of the continuous cases (JAX's
# tests/test_paged_sharded.py requests, four of them)
CONT = ((24, 6), (40, 4), (100, 8), (60, 5))
# a shared two-page system prompt: the tails of three requests
PREFIX_TAILS = (30, 45, 10)
# window 100 and 16 sinks: request 1 grows a page past its admission's
# three and frees the page behind its window
WINDOWED = dict(window_left=100, sink_tokens=16)
WIN_REQS = ((150, 30), (130, 260), (40, 20))


def _requests(pkg, specs, seed):
    rng = np.random.default_rng(seed)
    return [pkg.Request(id=i, tokens=[int(t) for t in rng.integers(
        0, SHAPE["vocab"], n)], max_new=m) for i, (n, m) in enumerate(specs)]


def _prefix_requests(pkg):
    rng = np.random.default_rng(9)
    system = [int(t) for t in rng.integers(0, SHAPE["vocab"], 2 * PAGE)]
    return [pkg.Request(id=i, tokens=system + [int(t) for t in rng.integers(
        0, SHAPE["vocab"], n)], max_new=5)
        for i, n in enumerate(PREFIX_TAILS)]


def _prompt():
    return np.random.default_rng(1).integers(
        0, SHAPE["vocab"], (B, S_PROMPT)).astype(np.int32)


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


def _jax_references(path: pathlib.Path) -> None:
    """The fp32 params and JAX's sharded engines' greedy tokens."""
    import jax
    import jax.numpy as jnp

    from long_context_attention_tpu import serving as jserving
    from long_context_attention_tpu.models import llama as jllama
    from long_context_attention_tpu.parallel import make_usp_mesh

    mesh = make_usp_mesh(dp=DP, ulysses=ULYSSES, ring=RING,
                         devices=jax.devices()[:WORLD])
    cfg = jllama.ModelConfig(**SHAPE, dtype=jnp.float32)
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    saved = {f"p/{k}": x for k, x in _flat(params).items()}
    prompt = jnp.asarray(_prompt())
    for layout in LAYOUTS:
        c = jllama.ModelConfig(**SHAPE, dtype=jnp.float32, layout=layout)
        toks, _, _ = jserving.ShardedEngine(c, mesh, S_MAX, "int8").generate(
            params, prompt, NEW)
        saved[f"engine {layout}"] = np.asarray(toks)
    res = jserving.ShardedContinuousEngine(
        cfg, s_max=S_MAX, max_batch=2, cache_dtype="int8", mesh=mesh).serve(
            params, _requests(jserving, CONT, 3))
    saved["continuous"] = np.asarray([res[i].tokens + [-1] * (
        8 - len(res[i].tokens)) for i in range(len(CONT))])
    np.savez(path / "ref.npz", **saved)


def _tokens(res):
    return {str(i): r.tokens for i, r in sorted(res.items())}


class _Recording:
    """A partitioned allocator that counts its growth pages and releases."""

    def __init__(self, alloc, log):
        self._alloc, self._log = alloc, log

    def __getattr__(self, name):
        return getattr(self._alloc, name)

    def take_extra_range(self, bi, lo, hi):
        pages = self._alloc.take_extra_range(bi, lo, hi)
        self._log["grown"] += len(pages)
        return pages

    def release_pages(self, bi, pages):
        self._alloc.release_pages(bi, pages)
        self._log["released"] += len(pages)


def _port_results(mesh, params, T, L):
    """Every sharded engine's tokens on this rank, and the single-device
    engines' (bf16 cache) beside the sharded ones'."""
    out = {}
    cpu = dict(device="cpu")
    prompt = torch.from_numpy(_prompt()).long()
    for layout in LAYOUTS:
        cfg = L.ModelConfig(**SHAPE, dtype=torch.float32, layout=layout)
        eng = T.ShardedEngine(cfg, mesh, S_MAX, "int8")
        toks, cache, _ = eng.generate(params, prompt, NEW)
        out[f"engine {layout}"] = toks.tolist()
        out[f"engine {layout} cache"] = list(cache.k.shape)
        bf = T.ShardedEngine(cfg, mesh, S_MAX, "bfloat16").generate(
            params, prompt, NEW)[0]
        one = T.Engine(cfg, S_MAX, "bfloat16", **cpu).generate(
            params, prompt, NEW).tokens
        out[f"engine {layout} single"] = [bf.tolist(), one.tolist()]
    cfg = L.ModelConfig(**SHAPE, dtype=torch.float32)
    reqs = _requests(T, CONT, 3)
    kw = dict(s_max=S_MAX, max_batch=2, cache_dtype="int8")
    dense = T.ShardedContinuousEngine(cfg, mesh=mesh, **kw).serve(params,
                                                                  reqs)
    out["continuous"] = _tokens(dense)
    kwb = dict(kw, cache_dtype="bfloat16")
    dense_bf16 = _tokens(T.ShardedContinuousEngine(
        cfg, mesh=mesh, **kwb).serve(params, reqs))
    out["continuous single"] = [
        dense_bf16,
        _tokens(T.ContinuousEngine(cfg, **kwb, **cpu).serve(params, reqs))]
    paged_kw = dict(page_size=PAGE, pool_pages=4 * WORLD)
    for dtype, blk in (("int8", 1), ("bfloat16", 1), ("int8", 4)):
        args = dict(kw, cache_dtype=dtype, step_block=blk)
        # step_block only moves the host syncs: one dense run per dtype
        d = out["continuous"] if dtype == "int8" else dense_bf16
        p = T.ShardedPagedContinuousEngine(cfg, mesh=mesh, **args,
                                           **paged_kw).serve(params, reqs)
        out[f"paged {dtype} {blk}"] = [_tokens(p), d]
    pre = _prefix_requests(T)
    eng = T.ShardedPagedContinuousEngine(cfg, mesh=mesh, **kw,
                                         page_size=PAGE,
                                         pool_pages=6 * WORLD,
                                         prefix_cache=True)
    out["prefix"] = [_tokens(eng.serve(params, pre)),
                     _tokens(T.ShardedContinuousEngine(
                         cfg, mesh=mesh, **kw).serve(params, pre)),
                     eng.stats["prefix_hit_tokens"]]
    wcfg = L.ModelConfig(**SHAPE, dtype=torch.float32, **WINDOWED)
    wreqs = _requests(T, WIN_REQS, 31)
    log = {"grown": 0, "released": 0}
    base = T.ShardedPagedContinuousEngine

    class Rec(base):
        def _make_alloc(self):
            return _Recording(base._make_alloc(self), log)

    weng = Rec(wcfg, mesh=mesh, **kw, **paged_kw)
    out["windowed"] = [_tokens(weng.serve(params, wreqs)),
                       _tokens(T.ShardedContinuousEngine(
                           wcfg, mesh=mesh, **kw).serve(params, wreqs)),
                       weng._windowed_paging, log]
    spec = dict(draft_cfg=cfg, gamma=3)
    out["speculative dense"] = _tokens(T.ShardedSpeculativeContinuousEngine(
        cfg, mesh=mesh, **kw, **spec).serve(params, params, reqs))
    out["speculative paged"] = _tokens(
        T.ShardedPagedSpeculativeContinuousEngine(
            cfg, mesh=mesh, **kw, **spec, **paged_kw).serve(
                params, params, reqs))
    return out


def _worker(rank: int, tmp: str) -> None:
    from long_context_attention_tpu_torch import serving as T
    from long_context_attention_tpu_torch.models import llama as L
    from long_context_attention_tpu_torch.parallel import mesh as tmesh
    from long_context_attention_tpu_torch.utils.convert import (
        params_from_jax)

    torch.set_num_threads(1)
    path = pathlib.Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{path}/rdzv",
                            rank=rank, world_size=WORLD)
    ref = np.load(path / "ref.npz")
    params = params_from_jax(_tree({k[2:]: ref[k] for k in ref.files
                                    if k.startswith("p/")}), device="cpu")
    mesh = tmesh.make_usp_mesh(dp=DP, ulysses=ULYSSES, ring=RING,
                               device="cpu")
    out = _port_results(mesh, params, T, L)
    every = [None] * WORLD
    dist.all_gather_object(every, out)
    if rank == 0:
        (path / "results.json").write_text(json.dumps(every))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded_serving")
    _jax_references(path)
    mp.start_processes(_worker, args=(str(path),), nprocs=WORLD, join=True,
                       start_method="spawn")
    ranks = json.loads((path / "results.json").read_text())
    ref = np.load(path / "ref.npz")
    return ranks, {k: ref[k] for k in ref.files if not k.startswith("p/")}


def test_every_rank_serves_the_same_tokens(results):
    """The host schedulers on the four ranks make the same decisions: every
    rank's results are rank 0's, and a rank's cache holds s_max / 4
    slots."""
    ranks, _ = results
    for other in ranks[1:]:
        assert other == ranks[0]
    for layout in LAYOUTS:
        assert ranks[0][f"engine {layout} cache"][3] == S_MAX // WORLD


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_engine_matches_jax(results, layout):
    """ShardedEngine.generate (int8 cache) equals JAX's ShardedEngine token
    for token: the USP prefill in the layout, the K/V moved into each
    rank's slot block, greedy sharded decode steps."""
    ranks, ref = results
    assert ranks[0][f"engine {layout}"] == ref[f"engine {layout}"].tolist()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_engine_matches_single_device(results, layout):
    """With a bf16 cache, the sharded engine's tokens equal the port's
    single-device Engine's."""
    sharded, one = results[0][0][f"engine {layout} single"]
    assert sharded == one


def test_sharded_continuous_matches_jax(results):
    """ShardedContinuousEngine equals JAX's on four requests over two rows
    (queueing, re-admission into a freed row)."""
    ranks, ref = results
    got = ranks[0]["continuous"]
    for i, row in enumerate(ref["continuous"]):
        assert got[str(i)] == [int(t) for t in row if t >= 0], (i, got)


def test_sharded_continuous_matches_single_device(results):
    """With a bf16 cache, the sharded continuous engine's tokens equal the
    port's ContinuousEngine's."""
    sharded, one = results[0][0]["continuous single"]
    assert sharded == one


@pytest.mark.parametrize("case", ["int8 1", "bfloat16 1", "int8 4"])
def test_sharded_paged_matches_sharded_dense(results, case):
    """ShardedPagedContinuousEngine (pool partitions, a rank's rebased
    window of the global table) emits the dense sharded engine's tokens,
    at step_block 1 and 4."""
    paged, dense = results[0][0][f"paged {case}"]
    assert paged == dense


def test_sharded_paged_prefix_cache(results):
    """A two-page system prompt spans two partitions: requests 1 and 2 hit
    both pages (2 x 2 x 128 tokens) and their tokens equal the dense
    sharded engine's."""
    paged, dense, hits = results[0][0]["prefix"]
    assert paged == dense
    assert hits == 2 * 2 * PAGE


def test_sharded_paged_windowed_reclaim(results):
    """Rolling window pages across partitions (window 100, 16 sinks): a
    page behind the window frees from its owner partition, a growth page
    comes from the partition decode advances into, and the tokens equal
    the dense sharded windowed engine's."""
    paged, dense, windowed, log = results[0][0]["windowed"]
    assert windowed
    assert paged == dense
    assert log["released"] >= 1 and log["grown"] >= 1, log


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_sharded_speculative_matches_plain(results, kind):
    """The sharded speculative engines with a self-draft (gamma 3: the
    verify's runs of 4 straddle block boundaries) emit the plain sharded
    engine's tokens."""
    ranks, _ = results
    assert ranks[0][f"speculative {kind}"] == ranks[0]["continuous"]


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_partitioned_release_is_atomic(native):
    """A release naming a page the row does not own frees nothing in any
    partition; a release across partitions frees in each; growth routes
    each page to its partition; a row past the partitions' capacity is
    refused."""
    from long_context_attention_tpu_torch.serving import native as tnative
    from long_context_attention_tpu_torch.serving.continuous import (
        _PageAllocator)
    from long_context_attention_tpu_torch.serving.paged_sharded import (
        _PartitionedPageAllocator, _split_range)

    if native and not tnative.native_available():
        pytest.skip("the C++ host core does not build here")
    make = tnative.NativePageAllocator if native else _PageAllocator
    a = _PartitionedPageAllocator(16, 2, 2, make)
    owned = a.take(0, 4)            # logical pages 0-3 over both partitions
    assert [p // 8 for p in owned] == [0, 0, 1, 1]
    before = [a.parts[r].available(1) for r in range(2)]
    with pytest.raises(ValueError):
        a.release_pages(0, [owned[0], 999])  # good page first, bad second
    assert [a.parts[r].available(1) for r in range(2)] == before
    a.release_pages(0, [owned[0], owned[2]])
    assert [a.parts[r].available(1) for r in range(2)] == [
        x + 1 for x in before]
    grown = a.take_extra_range(0, 1, 3)
    assert [p // 8 for p in grown] == [0, 1]
    assert not a.available_for(0, 99)
    assert _split_range(1, 5, 2) == [(0, 1, 2), (1, 0, 2), (2, 0, 1)]


def test_sharded_engine_guards():
    """JAX's guards on a one-rank mesh: the windowed per-partition sizing,
    a request larger than a partition, the speculative paged engine's
    refusal of interleaved admission, prompt + max_new past s_max; the
    engines run on the mesh's device, another raises."""
    from long_context_attention_tpu_torch import serving as T
    from long_context_attention_tpu_torch.models import llama as L
    from long_context_attention_tpu_torch.parallel import mesh as tmesh

    cfg = L.ModelConfig(**SHAPE, dtype=torch.float32)
    mesh = tmesh.make_usp_mesh(device="cpu")
    try:
        wcfg = L.ModelConfig(**SHAPE, dtype=torch.float32, window_left=100)
        with pytest.raises(ValueError, match="partition"):
            T.ShardedPagedContinuousEngine(wcfg, s_max=S_MAX, max_batch=2,
                                           mesh=mesh, page_size=PAGE,
                                           pool_pages=3)
        eng = T.ShardedPagedContinuousEngine(cfg, s_max=S_MAX, max_batch=2,
                                             mesh=mesh, page_size=PAGE,
                                             pool_pages=3)
        with pytest.raises(ValueError, match="partition"):
            eng._check_request_fits(T.Request(id=0, tokens=[1] * 200,
                                              max_new=200))
        with pytest.raises(ValueError, match="interleave"):
            T.ShardedPagedSpeculativeContinuousEngine(
                cfg, s_max=S_MAX, max_batch=2, mesh=mesh, page_size=PAGE,
                pool_pages=8, draft_cfg=cfg, interleave_admission=True)
        with pytest.raises(ValueError, match="capacity"):
            T.ShardedEngine(cfg, mesh, 128).generate(
                None, torch.zeros((1, 120), dtype=torch.long), 16)
        assert T.ShardedEngine(cfg, mesh, S_MAX).device == torch.device(
            "cpu")
        with pytest.raises(ValueError, match="needs a mesh"):
            T.ShardedContinuousEngine(cfg, s_max=S_MAX)
        with pytest.raises((ValueError, RuntimeError)):
            T.ShardedEngine(cfg, mesh, S_MAX, device="cuda")
    finally:
        dist.destroy_process_group()


def test_windowed_rolling_set_past_the_row():
    """A windowed paged engine whose rolling working set (window 400: 5
    pages of 128) exceeds a row's 4 pages reserves the whole row at
    admission (it raised before) and gives the dense engine's tokens; its
    sharded form on a one-rank mesh gives them too."""
    from long_context_attention_tpu_torch import serving as T
    from long_context_attention_tpu_torch.models import llama as L
    from long_context_attention_tpu_torch.parallel import mesh as tmesh

    cfg = L.ModelConfig(**SHAPE, dtype=torch.float32, window_left=400)
    params = L.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    reqs = _requests(T, ((150, 20), (300, 30)), 5)
    kw = dict(s_max=S_MAX, max_batch=2, cache_dtype="int8")
    paged = T.PagedContinuousEngine(cfg, page_size=PAGE, pool_pages=9,
                                    device="cpu", **kw)
    assert paged._windowed_paging and paged._rolling_pages() > paged.n_pages
    assert paged._pages_needed(reqs[0]) == paged.n_pages
    want = _tokens(T.ContinuousEngine(cfg, device="cpu", **kw).serve(
        params, reqs))
    assert _tokens(paged.serve(params, reqs)) == want
    mesh = tmesh.make_usp_mesh(device="cpu")
    try:
        sh = T.ShardedPagedContinuousEngine(cfg, page_size=PAGE,
                                            pool_pages=9, mesh=mesh, **kw)
        assert _tokens(sh.serve(params, reqs)) == want
    finally:
        dist.destroy_process_group()
