"""The port's native host core (csrc/lca_host.cc through serving/native.py)
against the Python allocators of both packages.

The contract is the same decisions bit for bit: page ids, hit counts,
eviction order and counters. Randomized op sequences drive the port's
native allocators, the port's Python allocators and the JAX package's
Python ones (never JAX's own native build) in lockstep. The engine picks
the native core by default and serves the same tokens as the Python one and
as JAX's engine; a failed release changes nothing; and the port builds its
own copy of the source into the gitignored build/ without touching the
reference's native/ files.
"""

import hashlib
from pathlib import Path

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
from long_context_attention_tpu_torch.serving import native
from long_context_attention_tpu_torch.serving import prefix_cache as tpc
from long_context_attention_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _key(i: int) -> bytes:
    return hashlib.blake2b(str(i).encode(), digest_size=16).digest()


def _basic_allocators(pool):
    return [jcont._PageAllocator(pool), tcont._PageAllocator(pool),
            native.NativePageAllocator(pool)]


def _prefix_allocators(pool):
    return [jpc.PrefixPageAllocator(pool), tpc.PrefixPageAllocator(pool),
            native.NativePrefixPageAllocator(pool)]


def _same(values, step):
    assert all(v == values[0] for v in values[1:]), (step, values)
    return values[0]


def test_native_core_builds():
    assert native.native_available()


def test_basic_allocator_parity():
    rng = np.random.default_rng(0)
    allocs = _basic_allocators(64)
    for step in range(500):
        bi = int(rng.integers(0, 8))
        avail = _same([a.available(bi) for a in allocs], step)
        need = int(rng.integers(1, 9))
        if avail >= need:
            _same([a.take(bi, need) for a in allocs], step)


def test_windowed_ops_parity():
    """take_extra and release_pages (the rolling window pages): running
    rows grow and free with the same page ids and the same LIFO state."""
    rng = np.random.default_rng(2)
    allocs = _basic_allocators(48)
    py = allocs[1]
    rows = {}
    for step in range(1500):
        op = rng.integers(0, 4)
        bi = int(rng.integers(0, 6))
        _same([a.available(bi) for a in allocs], step)
        if op == 0 and len(py.free) >= 6:  # a fresh admission
            need = int(rng.integers(1, 5))
            rows[bi] = list(_same([a.take(bi, need) for a in allocs], step))
        elif op == 1 and rows.get(bi) and len(py.free) >= 3:  # growth
            extra = int(rng.integers(1, 3))
            rows[bi].extend(_same([a.take_extra(bi, extra) for a in allocs],
                                  step))
        elif op == 2 and rows.get(bi):  # pages behind the window
            k = int(rng.integers(1, len(rows[bi]) + 1))
            for a in allocs:
                a.release_pages(bi, rows[bi][:k])
            rows[bi] = rows[bi][k:]
    for bi, pages in rows.items():
        for a in allocs:
            a.release_pages(bi, pages)
    for bi in range(6):
        _same([a.available(bi) for a in allocs], bi)
    assert sorted(py.free) == list(range(1, 48))
    assert allocs[2].available(0) == 47
    # a double release raises on every allocator
    first = _same([a.take(0, 2) for a in allocs], "take")
    for a in allocs:
        a.release_pages(0, [first[0]])
        with pytest.raises(ValueError, match="double release"):
            a.release_pages(0, [first[0]])


def test_prefix_allocator_parity_randomized():
    rng = np.random.default_rng(1)
    allocs = _prefix_allocators(48)
    # a small universe of prompt prefixes, so hits and evictions happen
    prompts = [[_key(p * 100 + i) for i in range(int(rng.integers(1, 7)))]
               for p in range(12)]
    for step in range(2000):
        op = rng.integers(0, 10)
        bi = int(rng.integers(0, 6))
        hashes = prompts[int(rng.integers(0, len(prompts)))]
        span = len(hashes) + int(rng.integers(0, 3))
        if op < 2:
            _same([a.release_row(bi) for a in allocs], step)
        elif op < 4:
            _same([a.lookup(hashes) for a in allocs], step)
            _same([a.can_take(bi, hashes, span) for a in allocs], step)
        elif _same([a.can_take(bi, hashes, span) for a in allocs], step):
            pages, _ = _same([a.take(bi, hashes, span) for a in allocs],
                             step)
            for a in allocs:
                a.register(hashes, pages[:len(hashes)])
        _same([a.hit_pages for a in allocs], step)
        _same([a.evictions for a in allocs], step)
    assert allocs[2].evictions > 0 and allocs[2].hit_pages > 0


@pytest.mark.parametrize("which", ["jax", "python", "native"])
def test_prefix_allocator_eviction_order(which):
    """Eviction takes the oldest unreferenced cached page, and a hit makes
    its page the newest."""
    a = dict(zip(["jax", "python", "native"], _prefix_allocators(5)))[which]
    ha, hb = [_key(1)], [_key(2)]
    pa, _ = a.take(0, ha, 1)
    a.register(ha, pa)
    pb, _ = a.take(1, hb, 1)
    a.register(hb, pb)
    a.release_row(0)
    a.release_row(1)
    _, hits = a.take(2, ha, 1)  # A is used again: B is now the oldest
    assert hits == 1
    a.release_row(2)
    a.take(3, [], 2)  # the free list runs dry
    before = a.evictions
    a.take(4, [], 1)
    assert a.evictions == before + 1
    assert a.lookup(hb) == 0 and a.lookup(ha) == 1


def test_keys_must_be_16_bytes():
    keys = tpc.chain_hashes(list(range(512)), 128)
    assert len(keys) == 4 and all(len(k) == 16 for k in keys)
    assert native._pack_keys(keys) == b"".join(keys)
    cc = native.NativePrefixPageAllocator(8)
    assert cc.lookup(keys) == 0
    with pytest.raises(ValueError, match="16-byte"):
        cc.lookup([b"short"])


@pytest.mark.parametrize("which", ["python", "native"])
def test_release_pages_failure_is_atomic(which):
    """A release naming any page the row does not own raises and leaves
    the allocator as it was."""
    a = (tcont._PageAllocator if which == "python"
         else native.NativePageAllocator)(16)
    owned = a.take(0, 4)
    other = a.take(1, 2)
    before = (a.available(0), a.available(1), a.available(5))
    with pytest.raises(ValueError, match="double release"):
        a.release_pages(0, [owned[0], other[0]])
    assert (a.available(0), a.available(1), a.available(5)) == before
    a.release_pages(0, [owned[0]])
    assert a.available(5) == before[2] + 1
    with pytest.raises(ValueError):
        a.release_pages(3, [owned[1]])
    assert a.available(5) == before[2] + 1


def test_build_leaves_the_reference_untouched(tmp_path):
    """The port compiles its own csrc/lca_host.cc into build/host/ (listed
    in .gitignore), and the JAX package's native/lca_host.cc and its
    tracked native/lca_host.so keep their bytes and mtimes."""
    ref = [REPO / "native" / "lca_host.cc", REPO / "native" / "lca_host.so"]
    before = [(p.read_bytes(), p.stat().st_mtime_ns) for p in ref]
    assert native.SOURCE == (REPO / "long_context_attention_tpu_torch"
                             / "csrc" / "lca_host.cc")
    assert native.compile_to(tmp_path / "lca_host.so")
    assert native.native_available()
    so = native.library_path()
    assert so.exists() and so.parent == REPO / "build" / "host"
    assert "build/" in (REPO / ".gitignore").read_text().split()
    assert [(p.read_bytes(), p.stat().st_mtime_ns) for p in ref] == before


SHAPE = dict(vocab=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=32, ffn_hidden=128, layout="basic")


@pytest.fixture(scope="module")
def engine_setup():
    """JAX's prefix engine's tokens on its Python allocators, and the
    port's params from the same weights (float32: see
    tests/test_torch_continuous.py)."""
    jcfg = jllama.ModelConfig(**SHAPE, dtype=jnp.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    reqs = [dict(id=i, tokens=list(range(2 + 3 * i, 34 + 3 * i)), max_new=6)
            for i in range(4)]
    eng = jserving.PagedContinuousEngine(
        jcfg, s_max=256, max_batch=2, page_size=128, pool_pages=7,
        prefix_cache=True, native_runtime=False)
    want = {i: r.tokens for i, r in eng.serve(
        jparams, [jserving.Request(**r) for r in reqs]).items()}
    assert eng.last_alloc_kind == "python"
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return tparams, [tserving.Request(**r) for r in reqs], want


@pytest.mark.parametrize("native_runtime", [None, True, False])
def test_engine_allocator_choice(engine_setup, native_runtime):
    """native_runtime None takes the native core when it builds, True
    requires it, False forces Python; the tokens equal JAX's either way."""
    tparams, reqs, want = engine_setup
    eng = tserving.PagedContinuousEngine(
        tllama.ModelConfig(**SHAPE, dtype=torch.float32), s_max=256,
        max_batch=2, page_size=128, pool_pages=7, prefix_cache=True,
        native_runtime=native_runtime, device="cpu")
    assert eng.last_alloc_kind == "unused"
    got = {i: r.tokens for i, r in eng.serve(tparams, reqs).items()}
    assert got == want
    assert eng.last_alloc_kind == ("python" if native_runtime is False
                                   else "native")
    assert eng.stats["admitted_tokens"] == sum(len(r.tokens) for r in reqs)


def test_native_runtime_true_raises_without_the_core(monkeypatch):
    monkeypatch.setattr(native, "native_available", lambda: False)
    cfg = tllama.ModelConfig(**SHAPE, dtype=torch.float32)
    kw = dict(s_max=256, max_batch=2, page_size=128, pool_pages=7,
              device="cpu")
    eng = tserving.PagedContinuousEngine(cfg, native_runtime=True, **kw)
    params = {"embed": torch.zeros(1)}
    with pytest.raises(RuntimeError, match="native_runtime=True"):
        eng.serve(params, [])
    # None falls back to the Python allocators
    eng = tserving.PagedContinuousEngine(cfg, **kw)
    assert eng._make_alloc().__class__ is tcont._PageAllocator
    assert eng.last_alloc_kind == "python"
