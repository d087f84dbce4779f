"""B7's multi-token kernel, ``decode_run`` (``csrc/decode_run_sm90.cu``), on
the CPU: the route that sends a CUDA call of ``decode_attention_core`` to it
(``decode_route``), the host side of its launch (``decode_launch``: the
grid, the splits of a row's live tiles, its shared memory), and the plain
version it is held to on the card against JAX's ``decode_attention``
(Pallas, interpret mode) at the route's edges: G = g * n = 10, 16, 64, 66
and 130 query rows per kv head at g = 2, a window whose rows span two of
the kernel's 128-row blocks, bf16, the s8 path over int8 and int4, fp8's
cast path, dense and paged.

Tolerances (tests/test_torch_paged.py's): out 2e-2 plus one bf16 ulp
(2^-7) of the value, lse 1e-4: integer products exact on both sides, exp2
and the tile sums in another order, which can move one P level of the s8
path's requantization or the output's bf16 rounding by one ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu.ops import decode as jdec
from long_context_attention_tpu.ops import kv_cache as jkv
from long_context_attention_tpu_torch.ops import _build
from long_context_attention_tpu_torch.ops import decode as tdec
from long_context_attention_tpu_torch.utils.convert import (
    cache_values_from_jax)

torch.set_num_threads(1)

OUT_TOL = dict(atol=2e-2, rtol=2.0 ** -7)
LSE_TOL = dict(atol=1e-4, rtol=0)
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100
# the serving model's heads (16 query, 8 kv) and head_dim
H_KV, GQA, D = 8, 2, 128


def _plans(itemsizes=(2, 1)):
    """Every (n, sub-run, slot axis, paged) of the tile rule for runs of 1
    to 300 tokens at the model's heads: pages of 2048 and dense caches of
    12288, 16384 and 20480 slots, bf16 (2 bytes) and int8, fp8 and packed
    int4 (the rule reads 1 byte for int4, as JAX's s4)."""
    for n in range(1, 301):
        for isz in itemsizes:
            for slot, paged in ((2048, True), (12288, False), (16384, False),
                                (20480, False)):
                for sub in tdec.decode_run_plan(n, H_KV, GQA, D, slot, isz,
                                                paged=paged):
                    yield n, sub, slot, paged


def test_route_sends_every_run_of_more_than_8_rows_to_decode_run():
    """Every sub-run whose g * n query rows per kv head exceed 8 takes
    decode_run (its tile a multiple of 128 that divides the slot axis), and
    one token never does; the rule is by shape alone."""
    seen = set()
    for n, (i, e, bkv), slot, _ in _plans():
        rows = GQA * (e - i)
        kernel = tdec.decode_route(rows, bkv, slot)
        seen.add(kernel)
        if rows > 8:
            assert kernel == "decode_run", (n, i, e, bkv, slot)
            assert bkv % 128 == 0 and slot % bkv == 0
        else:
            assert kernel == "decode_attention", (n, i, e, bkv, slot)
        if n == 1:
            assert kernel == "decode_attention"
    assert seen == {"decode_run", "decode_attention"}
    # odd tiles and tiles that do not divide the slot axis stay on the
    # first design, as do 8 rows
    assert tdec.decode_route(64, 192, 2048) == "decode_attention"
    assert tdec.decode_route(64, 1000, 3000) == "decode_attention"
    assert tdec.decode_route(64, 256, 1000) == "decode_attention"
    assert tdec.decode_route(8, 256, 2048) == "decode_attention"
    assert tdec.decode_route(9, 128, 128) == "decode_run"


def _live_tiles(length, n_tok, bkv, cap, left, sink):
    """The kernels' walk of a row (decode_run_sm90.cu Walk,
    decode_attention.cu's): its sink tiles before the window's band, then
    the band from the run's first token's window to its last token."""
    nk = -(-cap // bkv)
    last_t = min((length - 1) // bkv, nk - 1) if length > 0 else -1
    first_col = max(length - n_tok - left, 0) if left >= 0 else 0
    start_t = first_col // bkv
    n_sink = (min(-(-sink // bkv), start_t, last_t + 1) if left >= 0
              else 0)
    return list(range(n_sink)) + list(range(start_t, last_t + 1))


def _visible_tiles(length, n_tok, bkv, cap, left, sink):
    """The tiles holding a column some token of the run sees."""
    q = length - n_tok + np.arange(n_tok)[:, None]
    c = np.arange(cap)[None, :]
    vis = c <= q
    if left >= 0:
        vis &= (c >= q - left) | (c < sink)
    cols = np.flatnonzero(vis.any(0))
    return sorted(set((cols // bkv).tolist()))


@pytest.mark.parametrize("kernel", ["decode_run", "decode_attention"])
def test_launch_splits_cover_each_live_tile_once(kernel):
    """decode_launch's grid, and its splits: run sp of a row takes live
    tiles [sp * per, (sp + 1) * per), so the splits cover every live tile
    of every length once; the walk's tiles are exactly those holding a
    visible column. decode_run: row blocks of 128 rows, (row blocks x
    splits, h_kv, b); decode_attention: groups of 8, one partial per tile
    slot and span (per = 1: the cluster's spans of a tile slot take the
    same live tile), (splits, h_kv x groups, b)."""
    b = 2
    for rows, n_tok, bkv, cap, left, sink, kv_splits in (
            (352, 176, 256, 20480, -1, 0, None),
            (160, 80, 512, 20480, -1, 0, None),
            (128, 64, 512, 20480, -1, 0, None),
            (130, 65, 1024, 8192, 100, 4, None),
            (66, 33, 256, 2048, 300, 4, None),
            (10, 5, 2048, 16384, -1, 0, 4),
            (2, 1, 2048, 12288, -1, 0, None)):
        launch = tdec.decode_launch(kernel, b, H_KV, rows, cap, bkv, n_tok,
                                    left, sink, kv_splits)
        splits, per, grid = launch.splits, launch.per_split, launch.grid
        per_block = 128 if kernel == "decode_run" else 8
        groups = -(-rows // per_block)
        if kernel == "decode_run":
            assert grid == (groups * splits, H_KV, b)
            assert (launch.cluster, launch.span) == (1, bkv)
        else:
            assert per == 1
            assert grid == (splits, H_KV * groups, b)
            assert launch.cluster * launch.span == bkv
            splits //= launch.cluster  # tile slots
        lengths = sorted({n_tok, n_tok + 1, cap // 3, cap - 1, cap}
                         | set(range(n_tok, cap + 1, max(cap // 7, 1))))
        for length in lengths:
            live = _live_tiles(length, n_tok, bkv, cap, left, sink)
            assert live == _visible_tiles(length, n_tok, bkv, cap, left,
                                          sink), (length, rows)
            taken = [t for sp in range(splits)
                     for t in live[sp * per:(sp + 1) * per]]
            assert taken == live, (kernel, length, splits, per)


def test_one_token_splits_are_the_first_designs():
    """decode_attention's partials cover the live tiles the first design's
    split rule bounded, one partial per span of a tile slot now, whatever
    the card or kv_splits: a tile slot for each of the most live tiles a
    row can have (with a window, the band's exact bound, one fewer than
    the first design's where the band's columns fill whole tiles)."""
    def old(b, G, cap, bkv, n_tok, left, sink):
        nk = -(-cap // bkv)
        if left >= 0:
            nk = min(nk, -(-sink // bkv) + (left + n_tok - 1 + bkv) // bkv
                     + 1)
        cells = b * H_KV * -(-G // 8)
        splits = max(1, min(nk, -(-264 // cells)))
        per = -(-nk // splits)
        return -(-nk // per), per, nk

    for args in ((4, 2, 12288, 2048, 1, -1, 0), (4, 2, 12288, 2048, 1, 4096,
                                                  4),
                 (32, 2, 16384, 1024, 1, -1, 0), (1, 8, 2048, 128, 4, -1, 0)):
        splits, per, nk = old(*args)
        b, G, cap, bkv, n_tok, left, sink = args
        want = nk if left < 0 else min(
            nk, -(-sink // bkv) + (left + n_tok - 2) // bkv + 2)
        for kv_splits in (None, 4):
            launch = tdec.decode_launch("decode_attention", args[0], H_KV,
                                        *args[1:], kv_splits=kv_splits)
            assert (launch.splits // launch.cluster,
                    launch.per_split) == (want, 1)
            assert want <= nk <= splits * per


def test_decode_run_shared_memory_fits_every_tile():
    """decode_run's block takes the same shared memory at every tile (its
    chunks are 128 columns), within the 227 KB a block may use, for every
    tile the plan yields."""
    for s8 in (False, True):
        assert tdec.decode_run_smem(s8) <= SMEM_LIMIT
    tiles = {bkv for _, (_, _, bkv), _, _ in _plans((1,))}
    assert tiles and all(t % 128 == 0 for t in tiles)


def test_decode_run_is_registered():
    """decode_run binds lca_decode_run in decode_run_sm90.cu with
    decode_attention's C signature, replaces B7's Pallas kernel and has its
    own launch counter."""
    run, first = _build.KERNELS["decode_run"], _build.KERNELS[
        "decode_attention"]
    assert (run.source, run.symbol) == ("decode_run_sm90.cu",
                                        "lca_decode_run")
    assert run.argtypes == first.argtypes and run.replaces == first.replaces
    assert run is not first and run.launches == 0
    _build.reset_launch_counts()
    assert _build.launch_counts()["decode_run"] == 0


# ---------------------------------------------------------------------------
# the plain version against JAX at the route's edges
# ---------------------------------------------------------------------------

L, HKV, G, DS = 1, 2, 2, 32   # small: 2 kv heads, g = 2, head_dim 32
PAGE, N_PAGES = 128, 6


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _cache(rng, dtype, shape):
    """Random K/V of ``shape`` in ``dtype``'s storage, JAX's and the port's
    (k, v, k scales, v scales; scales in the cache's (.., 1, slots))."""
    vals = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    if dtype == "bfloat16":
        j = [jnp.asarray(v).astype(jnp.bfloat16) for v in vals] + [None,
                                                                  None]
        t = [torch.from_numpy(v).to(torch.bfloat16) for v in vals] + [None,
                                                                    None]
        return j, t
    (jk, jks), (jv, jvs) = (jkv.quantize_kv(jnp.asarray(v), dtype)
                            for v in vals)
    j = [jk, jv, jks[..., None, :], jvs[..., None, :]]
    return j, [cache_values_from_jax(np.asarray(x), "cpu") for x in j]


# (n, cache dtype, paged, window): G = 2n rows per kv head
EDGES = [(5, "int8", False, None), (8, "bfloat16", False, None),
         (32, "int4", True, None), (33, "int8", True, (40, 4)),
         (65, "float8_e4m3fn", True, (50, 4)),
         (65, "bfloat16", False, (100, 0))]
EDGE_IDS = [f"G={2 * n}-{dt}-{'paged' if pg else 'dense'}"
            for n, dt, pg, _ in EDGES]


@pytest.mark.parametrize("n,dtype,paged,window", EDGES, ids=EDGE_IDS)
def test_run_matches_jax_at_the_route_edges(rng, n, dtype, paged, window):
    """decode_attention over a run of n tokens (the port's plain version on
    the CPU; decode_run on the card) against JAX's decode_attention: rows
    of lengths 300, n (the run is the whole row) and 640, each token at its
    own position; the window of the n = 65 runs spans the two 128-row
    blocks of a kv head's 130 rows."""
    lens = np.array([300, n, 640], np.int32)
    if paged:
        pool = 3 * N_PAGES + 1
        jc, tc = _cache(rng, dtype, (L, pool, HKV, PAGE, DS))
        pt = (rng.permutation(pool - 1)[:3 * N_PAGES] + 1).reshape(
            3, N_PAGES).astype(np.int32)
        pt[1, 1:] = -1  # the row of n: its first page only
        extra_j = dict(page_table=jnp.asarray(pt))
        extra_t = dict(page_table=torch.from_numpy(pt))
    else:
        jc, tc = _cache(rng, dtype, (L, 3, HKV, N_PAGES * PAGE, DS))
        extra_j = extra_t = {}
    kw = {}
    if window is not None:
        kw = dict(window_size=(window[0], -1), sink_tokens=window[1])
    q = rng.standard_normal((3, n, HKV * G, DS)).astype(np.float32)
    jo, jl = jdec.decode_attention(
        jnp.asarray(q, jnp.bfloat16), jc[0], jc[1], jnp.asarray(lens),
        jc[2], jc[3], layer=jnp.int32(0), return_lse=True, **kw, **extra_j)
    _build.reset_launch_counts()
    to, tl = tdec.decode_attention(
        torch.from_numpy(q).to(torch.bfloat16), tc[0], tc[1],
        torch.from_numpy(lens), tc[2], tc[3], layer=0, return_lse=True, **kw,
        **extra_t)
    # CPU tensors take the plain version: no kernel launched
    assert sum(_build.launch_counts().values()) == 0
    assert to.shape == (3, n, HKV * G, DS) and tl.shape == (3, HKV * G, n)
    np.testing.assert_allclose(_np(to), _np(jo), **OUT_TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **LSE_TOL)
    slot = PAGE if paged else N_PAGES * PAGE
    elt = tc[0].element_size()
    for i, e, bkv in tdec.decode_run_plan(n, HKV, G, DS, slot, elt,
                                          paged=paged):
        # every sub-run of these would take decode_run on the card
        assert tdec.decode_route(G * (e - i), bkv, slot) == "decode_run"
