"""Automatic prefix caching in the PyTorch port against the JAX package:
chain-hash digests, the prefix allocator's and the plain page allocator's
decisions under one scripted sequence, suffix prefill against cold
admission, and the prefix engine against the plain paged engine and JAX's
prefix engine (tokens and stats), with eviction under pressure.

Host decisions (digests, pages, refcounts, LRU order, stats) are held
exactly. Tokens are greedy on the tiny config in float32 (see
tests/test_torch_continuous.py for why float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu import serving as jserving
from long_context_attention_tpu.models import llama as jllama
from long_context_attention_tpu.serving import continuous as jcont
from long_context_attention_tpu.serving import prefix_cache as jpc
from long_context_attention_tpu_torch import serving as tserving
from long_context_attention_tpu_torch.models import llama as tllama
from long_context_attention_tpu_torch.serving import continuous as tcont
from long_context_attention_tpu_torch.serving import prefix_cache as tpc
from long_context_attention_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

SHAPE = dict(vocab=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=32, ffn_hidden=128, layout="basic")
JCFG = jllama.ModelConfig(**SHAPE, dtype=jnp.float32)
TCFG = tllama.ModelConfig(**SHAPE, dtype=torch.float32)
S_MAX, PAGE = 512, 128


def _tokens(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(
        0, SHAPE["vocab"], n)]


@pytest.mark.parametrize("page", [128, 256])
def test_chain_hashes_match_jax(page):
    """The same digests as JAX's for prompts sharing a prefix, diverging
    inside a page, shifted, and shorter than a page."""
    base = _tokens(700, 0)
    other = list(base)
    other[300] = (other[300] + 1) % SHAPE["vocab"]
    for toks in (base, other, base[page:] + base[:page], base[:page - 1],
                 list(np.asarray(base, np.int64))):
        assert tpc.chain_hashes(toks, page) == jpc.chain_hashes(toks, page)
    ha, hb = tpc.chain_hashes(base, page), tpc.chain_hashes(other, page)
    assert len(ha) == 700 // page
    k = 300 // page
    assert ha[:k] == hb[:k] and ha[k] != hb[k]


def _state(al):
    """Everything an allocator decides, in comparable form."""
    out = {"free": list(al.free), "rows": {k: list(v)
                                           for k, v in al.rows.items()}}
    if hasattr(al, "cache"):
        out.update(ref=dict(al.ref), cache=list(al.cache.items()),
                   page_hash=dict(al.page_hash), hit_pages=al.hit_pages,
                   evictions=al.evictions)
    return out


def test_prefix_allocator_matches_jax():
    """One scripted sequence of take (hits and misses), share, register,
    release and eviction on JAX's PrefixPageAllocator and the port's: the
    same results and the same state after every call."""
    h2 = jpc.chain_hashes(list(range(2 * PAGE)), PAGE)
    h3 = jpc.chain_hashes(list(range(3 * PAGE)), PAGE)
    hx = jpc.chain_hashes(list(range(5, 5 + 2 * PAGE)), PAGE)
    script = [("take", 0, h2, 3), ("register", h2, None),
              ("can_take", 1, h2, 3), ("take", 1, h2, 3),
              ("can_take", 2, h3, 4), ("take", 2, h3, 4),
              ("register", h3, None), ("release_row", 0),
              ("lookup", h3), ("take", 0, hx, 2), ("register", hx, None),
              ("release_row", 1), ("release_row", 2),
              ("can_take", 3, [], 8), ("take", 3, [], 8), ("lookup", h2),
              ("lookup", hx), ("can_take", 1, hx, 3), ("take", 1, hx, 3)]
    allocs = [jpc.PrefixPageAllocator(12), tpc.PrefixPageAllocator(12)]
    taken = [{}, {}]
    for step in script:
        res = []
        for al, tk in zip(allocs, taken):
            op, *args = step
            if op == "register":  # the pages of the last take with hashes
                args = [args[0], tk[id(args[0])][:len(args[0])]]
            out = getattr(al, op)(*args)
            if op == "take":
                tk[id(args[1])] = out[0]
            res.append(out)
        assert res[0] == res[1], step
        assert _state(allocs[0]) == _state(allocs[1]), step
    assert allocs[1].evictions > 0


def test_page_allocator_matches_jax():
    """The plain paged engine's allocator: take, availability, growth and
    release (the double release raising before any change), as JAX's."""
    allocs = [jcont._PageAllocator(8), tcont._PageAllocator(8)]
    script = [("take", 0, 3), ("available", 1), ("take", 1, 2),
              ("take_extra", 0, 1), ("available", 0), ("take", 0, 2),
              ("release_pages", 1, "first"), ("available", 2)]
    for step in script:
        res = []
        for al in allocs:
            op, *args = step
            if args[-1] == "first":
                args = [args[0], al.rows[args[0]][:1]]
            res.append(getattr(al, op)(*args))
        assert res[0] == res[1], step
        assert _state(allocs[0]) == _state(allocs[1]), step
    for al in allocs:
        before = _state(al)
        with pytest.raises(ValueError, match="double release"):
            al.release_pages(1, [al.rows[1][0]] * 2)
        with pytest.raises(RuntimeError, match="exhausted"):
            al.take_extra(0, 99)
        assert _state(al) == before


@pytest.fixture(scope="module")
def params():
    jparams = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_suffix_prefill_matches_cold_admission(params, dtype):
    """The same 300-token prompt admitted cold, then through a hit of its
    two full pages (its 44-token suffix prefilled by decode_multi_step
    against the shared pages): 256 hit tokens and the same greedy
    tokens."""
    _, tparams = params
    prompt = _tokens(300, 3)
    eng = tserving.PagedContinuousEngine(
        TCFG, s_max=S_MAX, max_batch=1, cache_dtype=dtype, page_size=PAGE,
        pool_pages=12, prefix_cache=True, device="cpu")
    reqs = [tserving.Request(id=0, tokens=prompt, max_new=4),
            tserving.Request(id=1, tokens=prompt, max_new=4)]
    res = eng.serve(tparams, reqs)
    assert eng.stats["prefix_hit_tokens"] == 2 * PAGE
    assert eng.stats["admitted_tokens"] == 2 * 300
    assert res[0].tokens == res[1].tokens


def _workload(pkg, n_sys_pages, tails):
    system = _tokens(n_sys_pages * PAGE, 7)
    reqs = [pkg.Request(id=i, tokens=system + _tokens(t, 20 + i),
                        max_new=m) for i, (t, m) in enumerate(tails)]
    return reqs + [pkg.Request(id=9, tokens=_tokens(50, 99), max_new=4)]


# (system pages, (tail, max_new) per request, rows, pool pages): a shared
# system prompt (the chip's serve_prefix at small pages), and a pool with
# no slack where admissions evict cached prefixes
WORKLOADS = {
    "shared": (2, [(30, 5), (70, 4), (5, 6), (140, 3)], 2, 14),
    "bench_prefix": (2, [(64, 4)] * 8, 4, 18),
    "pressure": (0, [(180, 4)] * 4, 2, 6),
}


@pytest.mark.parametrize("name,overlap", [
    ("shared", False), ("shared", True), ("bench_prefix", True),
    ("pressure", False)])
def test_prefix_engine_matches_jax(params, name, overlap):
    """The prefix engine against JAX's prefix engine on the same requests:
    the same greedy tokens (also the plain paged engine's) and the same
    stats. bench_prefix (8 requests sharing 2 system pages through 4 rows)
    hits all of them after the first: 7 x 256 tokens; the pressure pool
    evicts."""
    jparams, tparams = params
    sys_pages, tails, rows, pool = WORKLOADS[name]
    kw = dict(s_max=S_MAX, max_batch=rows, cache_dtype="int8",
              page_size=PAGE, pool_pages=pool, prefix_cache=True,
              prefill_chunk=64, host_overlap=overlap)
    jeng = jserving.PagedContinuousEngine(JCFG, native_runtime=False, **kw)
    jres = jeng.serve(jparams, _workload(jserving, sys_pages, tails))
    teng = tserving.PagedContinuousEngine(TCFG, device="cpu", **kw)
    treqs = _workload(tserving, sys_pages, tails)
    tres = teng.serve(tparams, treqs)
    assert {i: r.tokens for i, r in tres.items()} == {
        i: r.tokens for i, r in jres.items()}
    assert teng.stats == jeng.stats
    plain = tserving.PagedContinuousEngine(
        TCFG, device="cpu", **dict(kw, prefix_cache=False, pool_pages=32))
    assert {i: r.tokens for i, r in plain.serve(tparams, treqs).items()} \
        == {i: r.tokens for i, r in tres.items()}
    if name == "bench_prefix":
        assert teng.stats["prefix_hit_tokens"] == 7 * 2 * PAGE
    if name == "pressure":
        assert teng.stats["prefix_hit_tokens"] == 0
        assert teng.stats["evictions"] > 0
