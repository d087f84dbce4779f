"""Rolling window pages in the port's PagedContinuousEngine against the JAX
package's: a sliding-window row holds only its sink and window pages, frees
the pages behind its window while it runs and takes fresh pages as decode
crosses page boundaries.

Greedy tokens equal JAX's windowed paged engine's (JAX on its Python
allocator, the port on its native core and on its Python one), and the page
state of every row after every decode block (its page table, the pages
assigned, the first page still held) equals JAX's exactly; the card's page
table follows the host's. Then the tight-pool case that once overflowed
mid-serve, the interleaved scheduler, and the page-reuse hazard: every page
is overwritten with large finite values the moment it is released, and the
tokens must not change (NaN would be wrong: a reused page's unwritten tail
sits masked inside its new owner's last tile). The port's B7 tile divides
the page (``ops/decode.py`` raises otherwise), so no tile spans two pages.

The tiny config in float32, as tests/test_torch_continuous.py explains.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu import serving as jserving
from long_context_attention_tpu.models import llama as jllama
from long_context_attention_tpu_torch import serving as tserving
from long_context_attention_tpu_torch.models import llama as tllama
from long_context_attention_tpu_torch.ops import decode as tdecode
from long_context_attention_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

SHAPE = dict(vocab=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=32, ffn_hidden=128, layout="basic")
S_MAX, PAGE = 512, 128
# (window, sinks, step_block, pool, prompt, max_new): JAX's
# tests/test_paged.py cases (the reclaim-and-grow one with its small pool,
# window + sinks), shortened to fewer new tokens that still free pages and
# grow across two page boundaries
CASES = {"window": (96, 0, 1, 7, 100, 170),
         "sinks": (96, 8, 3, 10, 130, 260)}
INTERLEAVED = dict(prefill_chunk=64)


def _requests(pkg, n, max_new, seed, count=2):
    rng = np.random.default_rng(seed)
    return [pkg.Request(id=i, tokens=[int(t) for t in rng.integers(
        0, SHAPE["vocab"], n)], max_new=max_new) for i in range(count)]


def _recording(base):
    """An engine class that keeps a copy of every row's page state after
    each decode block (and, for the port, the card's page table)."""

    @dataclasses.dataclass(frozen=True)
    class Rec(base):
        def _post_block(self, cache, slot, emitted):
            cache = base._post_block(self, cache, slot, emitted)
            table = getattr(cache, "page_table", None)
            self.log.append((copy.deepcopy(self._rowwin),
                             None if table is None
                             else np.asarray(table).copy()))
            return cache

    return Rec


def _states(log):
    return [{bi: (st["pt"].tolist(), st["assigned"], st["next_free"],
                  st["prompt"]) for bi, st in rowwin.items()}
            for rowwin, _ in log]


@pytest.fixture(scope="module")
def setup():
    """JAX's windowed paged engines (Python allocator) on each case: tokens
    and the row page states after every block; the port's params."""
    jparams = None
    want = {}
    for name, (w, sinks, sb, pool, n, m) in {
            **CASES, "interleaved": CASES["window"]}.items():
        jcfg = jllama.ModelConfig(**SHAPE, dtype=jnp.float32, window_left=w,
                                  sink_tokens=sinks)
        if jparams is None:
            jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
        extra = INTERLEAVED if name == "interleaved" else {}
        eng = _recording(jserving.PagedContinuousEngine)(
            jcfg, s_max=S_MAX, max_batch=2, page_size=PAGE, pool_pages=pool,
            step_block=sb, native_runtime=False,
            interleave_admission=name == "interleaved", **extra)
        object.__setattr__(eng, "log", [])
        assert eng._windowed_paging
        res = eng.serve(jparams, _requests(jserving, n, m, seed=5))
        want[name] = ({i: r.tokens for i, r in res.items()},
                      _states(eng.log))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return tparams, want


def _engine(name, base=tserving.PagedContinuousEngine, **kw):
    w, sinks, sb, pool, _, _ = CASES["window" if name == "interleaved"
                                     else name]
    cfg = tllama.ModelConfig(**SHAPE, dtype=torch.float32, window_left=w,
                             sink_tokens=sinks)
    extra = INTERLEAVED if name == "interleaved" else {}
    args = dict(s_max=S_MAX, max_batch=2, page_size=PAGE, pool_pages=pool,
                step_block=sb, interleave_admission=name == "interleaved",
                device="cpu", **extra)
    args.update(kw)
    eng = _recording(base)(cfg, **args)
    object.__setattr__(eng, "log", [])
    return eng


def _serve(eng, tparams, name):
    n, m = CASES["window" if name == "interleaved" else name][4:]
    res = eng.serve(tparams, _requests(tserving, n, m, seed=5))
    return {i: r.tokens for i, r in res.items()}


@pytest.mark.parametrize("name,native_runtime", [
    ("window", None), ("window", False), ("sinks", None),
    ("interleaved", None)])
def test_windowed_paging_matches_jax(setup, name, native_runtime):
    """Tokens and every row's page state after every block equal JAX's;
    the card's table rows hold the host's assignments; pages were freed
    behind the window and grown; sink pages never freed."""
    tparams, want = setup
    eng = _engine(name, native_runtime=native_runtime)
    assert eng._windowed_paging
    got = _serve(eng, tparams, name)
    assert got == want[name][0]
    assert _states(eng.log) == want[name][1]
    assert eng.last_alloc_kind == ("python" if native_runtime is False
                                   else "native")
    for rowwin, table in eng.log:
        for bi, st in rowwin.items():
            held = slice(st["next_free"], st["assigned"])
            np.testing.assert_array_equal(table[bi, held], st["pt"][held])
    sink_pages = -(-eng.cfg.sink_tokens // PAGE)
    final = eng.log[-1][0]
    assert all(st["next_free"] > sink_pages for st in final.values())
    assert all(st["assigned"] > eng._pages_needed(tserving.Request(
        id=0, tokens=[0] * st["prompt"], max_new=1))
        for st in final.values())


def _no_window(base):
    @dataclasses.dataclass(frozen=True)
    class NoWin(base):
        @property
        def _windowed_paging(self):
            return False

    return NoWin


def test_rolling_reservation_and_whole_span_tokens(setup):
    """The windowed reservation is the rolling working set, below the
    whole span, and the same engine with whole-span reservations (the same
    kernels and tiles; only the physical pages differ) gives the same
    tokens over a pool of 48 pages."""
    tparams, want = setup
    eng = _engine("window")
    req = tserving.Request(id=0, tokens=[0] * 100, max_new=170)
    assert eng._pages_needed(req) == eng._rolling_pages() == 2
    whole = _engine("window", base=_no_window(tserving.PagedContinuousEngine),
                    pool_pages=48)
    assert whole._pages_needed(req) == 3 and not whole._windowed_paging
    assert _serve(whole, tparams, "window") == want["window"][0]
    assert whole.log[-1][0] == {}


@pytest.mark.parametrize("native_runtime", [None, False])
def test_tight_pool_does_not_overflow(native_runtime):
    """Window 124, step_block 2, pages of 128, a pool of 5 (JAX's
    tests/test_paged.py repro of growth run before reclaim): no row takes
    more than its admission reserved, so the serve completes."""
    cfg = tllama.ModelConfig(**SHAPE, dtype=torch.float32, window_left=124)
    params = tllama.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    eng = tserving.PagedContinuousEngine(
        cfg, s_max=S_MAX, max_batch=2, page_size=PAGE, pool_pages=5,
        step_block=2, native_runtime=native_runtime, device="cpu")
    reqs = _requests(tserving, 100, 300, seed=11)
    res = eng.serve(params, reqs)
    assert all(len(res[r.id].tokens) == r.max_new for r in reqs)


class _Poisoning:
    """Wraps an allocator: every page released from a running row is
    overwritten, at once, in every layer of the pool, with large finite
    values (int8: 127 with scales of 1e4; bf16: 1e4)."""

    def __init__(self, alloc, cache_ref, released):
        self._alloc, self._cache, self.released = alloc, cache_ref, released

    def __getattr__(self, name):
        return getattr(self._alloc, name)

    def release_pages(self, bi, pages):
        self._alloc.release_pages(bi, pages)
        cache, idx = self._cache[0], torch.tensor(pages)
        big = 127 if cache.k.dtype == torch.int8 else 1e4
        for t in (cache.k, cache.v):
            t[:, idx] = big
        for t in (cache.k_scale, cache.v_scale):
            if t is not None:
                t[:, idx] = 1e4
        self.released.extend(pages)


def _poisoned(base):
    @dataclasses.dataclass(frozen=True)
    class Poisoned(base):
        def init_cache(self):
            cache = base.init_cache(self)
            self.cache_ref[:] = [cache]
            return cache

        def _make_alloc(self):
            return _Poisoning(base._make_alloc(self), self.cache_ref,
                              self.released)

    return Poisoned


@pytest.mark.parametrize("name,cache_dtype", [
    ("window", "int8"), ("window", "bfloat16"), ("sinks", "int8")])
def test_released_pages_poisoned_leave_tokens(setup, name, cache_dtype):
    """The page-reuse hazard: pages freed behind a row's window are
    poisoned the moment they are released, while their row runs on and
    other rows reuse them; the tokens equal the unpoisoned run's. Pools of
    the rolling minimum force reuse. The paged B7 tile is the page or one
    of its divisors, never wider."""
    tparams, _ = setup
    _, _, sb, _, n, m = CASES[name]
    clean = _engine(name, cache_dtype=cache_dtype)
    pool = 2 * clean._rolling_pages() + 1
    clean = _engine(name, cache_dtype=cache_dtype, pool_pages=pool)
    want = _serve(clean, tparams, name)
    eng = _engine(name, base=_poisoned(tserving.PagedContinuousEngine),
                  cache_dtype=cache_dtype, pool_pages=pool)
    object.__setattr__(eng, "cache_ref", [])
    object.__setattr__(eng, "released", [])
    assert _serve(eng, tparams, name) == want
    assert len(eng.released) >= 2
    # released pages came back into use: growth took some of them
    grown = {int(p) for rowwin, _ in eng.log for st in rowwin.values()
             for p in st["pt"][st["next_free"]:st["assigned"]]}
    assert grown & set(eng.released)
    for i, e, bkv in tdecode.decode_run_plan(
            1, SHAPE["n_kv_heads"], 2, SHAPE["head_dim"], PAGE, 1,
            paged=True):
        assert PAGE % bkv == 0
