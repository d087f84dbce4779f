"""Kernel B7 with a sequence-sharded cache's columns, and the sharded decode
and append of ``serving/sharded.py``, against the JAX package.

The port's plain B7 takes ``first_cols`` (each row's unclipped first visible
column of a run's token 0), ``sink_cols`` (its slice of the sink prefix) and
``sink_band`` (the static bound that sizes the walk's sink tiles), with
negative lengths (a rank past the data) and, on a run, lengths past the
slots (an interior rank); JAX's ``decode_attention`` (Pallas in interpret
mode) takes the same arguments on the same numpy inputs, dense and paged,
in every cache dtype. Then the sub-run shift of a long run, the guards,
the kernel walk's reads (``decode_token_reads``, the arithmetic of
``csrc/decode_attention.cu``) against each row's visible columns, the
port's 4-rank split and merge (every rank's partial on one device, no
collective) against JAX's ``sharded_decode_attention`` under ``shard_map``
on 4 virtual devices, and a run that straddles a block boundary appended
rank by rank, bit for bit the unsharded append.

Tolerances: B7's (``tests/test_torch_paged.py``): out 2e-2 plus one bf16
ulp, lse 1e-4 (integer products exact on both sides, exp2 and the tile
sums in another fp32 order, which can move one P level or the output's
bf16 rounding by one ulp); the merged outputs are bf16 on both sides after
an fp32 merge in another order, so they take the same out tolerance.
Appends are copies: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from long_context_attention_tpu.ops import decode as jdec
from long_context_attention_tpu.ops import kv_cache as jkv
from long_context_attention_tpu.serving import sharded as jsh
from long_context_attention_tpu_torch.ops import decode as tdec
from long_context_attention_tpu_torch.ops import kv_cache as tkv
from long_context_attention_tpu_torch.serving import sharded as tsh
from long_context_attention_tpu_torch.utils.convert import (
    cache_values_from_jax)

torch.set_num_threads(1)

L, HKV, G, D = 2, 2, 2, 32
SLOTS, BKV, PAGE = 512, 128, 128
WINDOW, SINKS = 100, 8
N_RANKS = 4
OUT_TOL = dict(atol=2e-2, rtol=2.0 ** -7)
LSE_TOL = dict(atol=1e-4, rtol=0)
# (global length, rank) of each row of the columns cases: the window
# inside block 1, straddling blocks 0 and 1, a rank past the data, rank 0
# wholly left of the window (its sinks only) with a run past its slots,
# and rank 0 holding the window and the sinks
ROWS = ((700, 1), (530, 1), (300, 1), (1100, 0), (400, 0))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _port(x):
    return None if x is None else cache_values_from_jax(np.asarray(x), "cpu")


def _quantized(rng, shape, dtype):
    """Random values of ``shape`` (.., s, d) quantized by JAX in the cache
    layout, and their port form: [k, v, k scales, v scales] pairs."""
    out = []
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
        q, s = jkv.quantize_kv(x, dtype)
        out.append((q, None if s is None else s[..., None, :]))
    j = [out[0][0], out[1][0], out[0][1], out[1][1]]
    return j, [_port(x) for x in j]


def _columns(n_tok, slots=SLOTS):
    """Each row's local lengths, first columns and sink slice, from ROWS as
    ``serving/sharded.py`` derives them."""
    lens, fc, sc = [], [], []
    for length, r in ROWS:
        local = length - r * slots
        lens.append(local if n_tok > 1 else min(max(local, 0), slots))
        fc.append(length - n_tok - WINDOW - r * slots)
        sc.append(min(max(SINKS - r * slots, 0), slots))
    return (np.array(lens, np.int32), np.array(fc, np.int32),
            np.array(sc, np.int32))


def _query(rng, n_tok, b=len(ROWS), h=HKV * G, d=D):
    shape = (b, h, d) if n_tok == 1 else (b, n_tok, h, d)
    return rng.standard_normal(shape).astype(np.float32)


def _pair_call(q, j, t, lens, fc, sc, jextra=None, textra=None, **kw):
    """JAX's and the port's decode_attention on the same inputs: (out, lse)
    each."""
    jo, jl = jdec.decode_attention(
        jnp.asarray(q, jnp.bfloat16), j[0], j[1], jnp.asarray(lens), j[2],
        j[3], layer=jnp.int32(1), return_lse=True,
        first_cols=jnp.asarray(fc), sink_cols=jnp.asarray(sc),
        **(jextra or {}), **kw)
    to, tl = tdec.decode_attention(
        torch.from_numpy(q).to(torch.bfloat16), t[0], t[1],
        torch.from_numpy(lens), t[2], t[3], layer=1, return_lse=True,
        first_cols=torch.from_numpy(fc), sink_cols=torch.from_numpy(sc),
        **(textra or {}), **kw)
    return (jo, jl), (to, tl)


def _assert_close(j, t):
    np.testing.assert_allclose(_np(t[0]), _np(j[0]), **OUT_TOL)
    np.testing.assert_allclose(_np(t[1]), _np(j[1]), **LSE_TOL)


COLUMN_CASES = [("bfloat16", 1), ("bfloat16", 5), ("int8", 1), ("int8", 5),
                ("float8_e4m3fn", 1), ("int4", 5)]


@pytest.mark.parametrize("dtype,n_tok", COLUMN_CASES)
def test_sharded_columns_dense_match_jax(rng, dtype, n_tok):
    """The plain B7 with first_cols / sink_cols / sink_band over a dense
    cache (tiles of 128, so the window's walk is banded) against JAX's
    kernel: a row whose window straddles the block's start (a negative
    first column), a rank past the data (out 0, lse -inf), one whose run
    length passes its slots, one that sees only its sink slice."""
    j, t = _quantized(rng, (L, len(ROWS), HKV, SLOTS, D), dtype)
    lens, fc, sc = _columns(n_tok)
    q = _query(rng, n_tok)
    jres, tres = _pair_call(q, j, t, lens, fc, sc, block_kv=BKV,
                            window_size=(WINDOW, -1), sink_band=SINKS)
    _assert_close(jres, tres)
    lse = _np(tres[1])
    assert np.isneginf(lse[2]).all() and not _np(tres[0])[2].any()
    assert np.isfinite(lse[[0, 1, 3, 4]]).all()


def _paged(rng, dtype, rows):
    """A pool of 12 pages and a table of 4 logical pages a row: each row's
    pages from ``rows``, then negative rebased ids (-1 and lower) past
    them, as a rank's window of the global table holds."""
    j, t = _quantized(rng, (L, 12, HKV, PAGE, D), dtype)
    pt = np.full((len(rows), 4), -1, np.int32)
    for i, pages in enumerate(rows):
        pt[i, :len(pages)] = pages
        pt[i, len(pages):] -= 4 * np.arange(4 - len(pages), dtype=np.int32)
    return j, t, pt


@pytest.mark.parametrize("dtype,n_tok", [("bfloat16", 1), ("int8", 1),
                                         ("int8", 5)])
def test_sharded_columns_paged_match_jax(rng, dtype, n_tok):
    """The same columns through a rank's rebased page table, whose
    unallocated entries are negative ids (never read as a page)."""
    j, t, pt = _paged(rng, dtype, [[3, 7], [9], [], [1, 2, 4, 5],
                                   [6, 8, 10, 11]])
    lens, fc, sc = _columns(n_tok)
    q = _query(rng, n_tok)
    jres, tres = _pair_call(
        q, j, t, lens, fc, sc, jextra=dict(page_table=jnp.asarray(pt)),
        textra=dict(page_table=torch.from_numpy(pt)),
        window_size=(WINDOW, -1), sink_band=SINKS)
    _assert_close(jres, tres)
    # a negative id read as a page would change the result: poison page 0
    # (where a clamped id lands) and the columns the rows do not see
    poisoned = [x.clone() if x is not None else None for x in t]
    poisoned[0][:, 0] = poisoned[0][:, 0].flip(-1)
    again = tdec.decode_attention(
        torch.from_numpy(q).to(torch.bfloat16), poisoned[0], t[1],
        torch.from_numpy(lens), t[2], t[3], layer=1, return_lse=True,
        page_table=torch.from_numpy(pt), first_cols=torch.from_numpy(fc),
        sink_cols=torch.from_numpy(sc), window_size=(WINDOW, -1),
        sink_band=SINKS)
    assert torch.equal(again[0], tres[0]) and torch.equal(again[1], tres[1])


def test_sharded_columns_subrun_shift_matches_jax(rng):
    """A 200-token run at 8 kv heads x 2 x 128 over an int8 cache: JAX
    splits it into sub-runs of 176 and 24, the second's first columns
    shifted by 176; the port's plan is the same and its out and lse equal
    JAX's."""
    hkv, g, d, n = 8, 2, 128, 200
    plan = tdec.decode_run_plan(n, hkv, g, d, SLOTS, 1)
    assert [(i, e) for i, e, _ in plan] == [(0, 176), (176, 200)]
    rows = ((700, 1), (900, 1))
    j, t = _quantized(rng, (L, 2, hkv, SLOTS, d), "int8")
    lens = np.array([x - r * SLOTS for x, r in rows], np.int32)
    fc = np.array([x - n - 300 - r * SLOTS for x, r in rows], np.int32)
    sc = np.zeros(2, np.int32)
    q = _query(rng, n, b=2, h=hkv * g, d=d)
    jres, tres = _pair_call(q, j, t, lens, fc, sc, window_size=(300, -1),
                            sink_band=SINKS)
    _assert_close(jres, tres)


@pytest.mark.parametrize("case", ["sinks_with_first_cols",
                                  "sink_cols_alone", "no_sink_band"])
def test_sharded_column_guards(case):
    """JAX's ValueErrors: the global sink count beside first_cols,
    sink_cols without first_cols, and a banded windowed call with
    sink_cols but no sink_band (its sinks would drop out)."""
    q = torch.zeros((2, HKV * G, D), dtype=torch.bfloat16)
    k = torch.zeros((L, 2, HKV, SLOTS, D), dtype=torch.bfloat16)
    cols = torch.tensor([10, 20], dtype=torch.int32)
    kw = {"sinks_with_first_cols": dict(first_cols=cols, sink_tokens=4),
          "sink_cols_alone": dict(sink_cols=cols),
          "no_sink_band": dict(first_cols=cols, sink_cols=cols)}[case]
    with pytest.raises(ValueError, match="sink"):
        tdec.decode_attention(q, k, k, cols, layer=0, block_kv=BKV,
                              window_size=(WINDOW, -1), **kw)


@pytest.mark.parametrize("length,first,sink,n_tok", [
    (188, 88, 0, 1), (18, -83, 0, 1), (0, -513, 0, 1), (512, 995, 8, 1),
    (300, 199, 8, 1), (588, 483, 0, 4), (-212, -817, 0, 4)])
def test_kernel_walk_reads_every_visible_column(length, first, sink, n_tok):
    """decode_attention.cu's walk with a row's sharded columns (the
    emulation of its arithmetic, decode_token_reads) at a grid sized on
    the host from the window, n_tok and the sink bound: its spans read
    every column some token row sees, once, and no column at or past the
    row's length."""
    cap, row_bytes = SLOTS, D
    launch = tdec.decode_launch("decode_attention", 1, HKV, G * n_tok, cap,
                                BKV, n_tok, WINDOW, SINKS,
                                row_bytes=row_bytes)
    reads = tdec.decode_token_reads(launch, length, n_tok, cap, BKV, WINDOW,
                                    first_col=first, sink_col=sink)
    cols = [c for _, _, a, e in reads for c in range(a, e)]
    assert len(cols) == len(set(cols))
    seen = set()
    for i in range(n_tok):
        q = length - n_tok + i
        seen |= {c for c in range(min(cap, max(q + 1, 0)))
                 if c >= first + i or c < sink}
    assert seen <= set(cols) and all(c < min(length, cap) for c in cols)


def _jax_sharded(j, lens, q, pt=None, n=N_RANKS, **kw):
    """JAX's sharded_decode_attention under shard_map over ``n`` virtual
    devices: the cache's slot axis (dense) or its pool axis (paged)
    sharded, the query, lengths and table replicated."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("ring",))
    kv = (P(None, None, None, "ring", None) if pt is None
          else P(None, "ring", None, None, None))
    sc = (P(None, None, None, None, "ring") if pt is None
          else P(None, "ring", None, None, None))

    def fn(q, k, v, ks, vs, lens, pt):
        return jsh.sharded_decode_attention(
            q, k, v, lens, ks, vs, axis_name="ring", layer=jnp.int32(1),
            page_table=None if pt.shape[1] == 0 else pt, **kw)

    table = jnp.zeros((q.shape[0], 0), jnp.int32) if pt is None else pt
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P(), kv, kv, sc, sc, P(), P()),
        out_specs=P(), check_vma=False))(q, *j, lens, table)


def _port_sharded(t, lens, q, pt=None, n=N_RANKS, **kw):
    """Every rank's partial on one device (``axis_name=(rank, n)``), then
    the merge."""
    outs, lses = [], []
    for r in range(n):
        if pt is None:  # values (.., s, d), scales (.., 1, s)
            sl = slice(r * t[0].shape[3] // n, (r + 1) * t[0].shape[3] // n)
            blk = [x[:, :, :, sl].contiguous() for x in t[:2]] + [
                None if x is None else x[..., sl].contiguous()
                for x in t[2:]]
        else:
            p = t[0].shape[1] // n
            blk = [None if x is None else x[:, r * p:(r + 1) * p].contiguous()
                   for x in t]
        o, lse = tsh.sharded_decode_attention(
            q, *blk[:2], lens, *blk[2:], axis_name=(r, n), layer=1,
            page_table=pt, **kw)
        outs.append(o.float())
        lses.append(lse.transpose(1, 2) if q.dim() == 4 else lse)
    return tsh.merge_sharded_partials(torch.stack(outs), torch.stack(lses))


@pytest.mark.parametrize("paged,n_tok", [(False, 1), (False, 5),
                                         (True, 1)])
def test_emulated_split_and_merge_matches_jax(rng, paged, n_tok):
    """The port's 4-rank sharded decode, every rank's partial on one device
    and the n-way merge, against JAX's sharded_decode_attention on 4
    virtual devices: int8, window 100 and 8 sinks, one token or a run of
    5, rows whose windows straddle block boundaries and one past every
    block but the first. Paged: each rank's pool partition of 4 pages
    (local page 0 its scratch) under the global table."""
    b = 3
    lengths = np.array([700, 530, 90], np.int32)
    q = _query(rng, n_tok, b=b)
    kw = dict(window_left=WINDOW, sink_tokens=SINKS, block_kv=BKV)
    if paged:
        n_pages, p_local = 8, 4           # 2 logical pages a rank
        j, t = _quantized(rng, (L, N_RANKS * p_local, HKV, PAGE, D),
                          "int8")
        pt = np.full((b, n_pages), -1, np.int32)
        for i, length in enumerate(lengths):
            for lp in range(-(-int(length) // PAGE)):
                r = lp // 2
                pt[i, lp] = r * p_local + 1 + (lp % 2) + (i % 2)
        jpt, tpt = jnp.asarray(pt), torch.from_numpy(pt)
    else:
        j, t = _quantized(rng, (L, b, HKV, N_RANKS * 256, D), "int8")
        jpt = tpt = None
    want = _jax_sharded(j, jnp.asarray(lengths), jnp.asarray(
        q, jnp.bfloat16), jpt, **kw)
    got = _port_sharded(t, torch.from_numpy(lengths),
                        torch.from_numpy(q).to(torch.bfloat16), tpt, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **OUT_TOL)
    # the merge of the ranks equals the unsharded call over the whole cache
    if not paged:
        whole = tdec.decode_attention(
            torch.from_numpy(q).to(torch.bfloat16), t[0], t[1],
            torch.from_numpy(lengths), t[2], t[3], layer=1, block_kv=BKV,
            window_size=(WINDOW, -1), sink_tokens=SINKS)
        np.testing.assert_allclose(_np(got), _np(whole), **OUT_TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_straddling_append_is_the_unsharded_append(rng, paged):
    """A 5-token run per row appended rank by rank at each rank's local
    base (sharded_cache_append, int8 rows already quantized, and
    sharded_cache_append_rows, bf16 rows through B6's quantizing kind):
    runs that straddle a block boundary split between the two owners, a
    skipped row (-n) writes nothing on any rank; the blocks put together
    equal the unsharded append bit for bit."""
    n, b, s_max = 5, 3, N_RANKS * 128
    pos = np.array([126, -n, 254], np.int32)  # rows 0 and 2 straddle
    rows = [rng.standard_normal((b, n, HKV, D)).astype(np.float32)
            for _ in range(2)]
    if paged:
        p_local = 3
        pool = tkv.PagedKVCache.init(L, b, N_RANKS * p_local, PAGE,
                                     N_RANKS, HKV, D, "int8", device="cpu")
        pt = np.stack([np.arange(N_RANKS) * p_local + 1 + (i % 2)
                       for i in range(b)]).astype(np.int32)
        pool.page_table.copy_(torch.from_numpy(pt))
        whole = tkv.PagedKVCache(*(None if x is None else x.clone()
                                   for x in (pool.k, pool.v, pool.k_scale,
                                             pool.v_scale)),
                                 pool.page_table.clone(), pool.length.clone())
    else:
        pool = tkv.KVCache.init(L, b, s_max, HKV, D, "int8", device="cpu")
        whole = tkv.KVCache.init(L, b, s_max, HKV, D, "int8", device="cpu")
    k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in rows)
    tdec.cache_append_rows(whole, 1, k, v, torch.from_numpy(pos))
    kq, ks = tkv.quantize_kv(k.transpose(1, 2), "int8")
    vq, vs = tkv.quantize_kv(v.transpose(1, 2), "int8")
    shards = []
    for r in range(N_RANKS):
        if paged:
            part = slice(r * p_local, (r + 1) * p_local)
            blk = tkv.PagedKVCache(pool.k[:, part].clone(),
                                   pool.v[:, part].clone(),
                                   pool.k_scale[:, part].clone(),
                                   pool.v_scale[:, part].clone(),
                                   pool.page_table, pool.length)
        else:
            sl = slice(r * 128, (r + 1) * 128)
            blk = tkv.KVCache(pool.k[..., sl, :].clone(),
                              pool.v[..., sl, :].clone(),
                              pool.k_scale[..., sl].clone(),
                              pool.v_scale[..., sl].clone(), pool.length)
        copy = [x.clone() for x in (blk.k, blk.v, blk.k_scale, blk.v_scale)]
        pt = blk.page_table if paged else None
        tsh.sharded_cache_append_rows(blk, 1, k, v, torch.from_numpy(pos),
                                      axis_name=(r, N_RANKS))
        tsh.sharded_cache_append(*copy[:2], kq, vq, torch.from_numpy(pos),
                                 *copy[2:], ks, vs, axis_name=(r, N_RANKS),
                                 layer=1, page_table=pt)
        for a, c in zip((blk.k, blk.v, blk.k_scale, blk.v_scale), copy):
            assert torch.equal(a, c)
        shards.append(blk)
    for name in ("k", "v", "k_scale", "v_scale"):
        got = torch.cat([getattr(s, name) for s in shards],
                        dim=1 if paged else -1 if name.endswith("scale")
                        else -2)
        assert torch.equal(got, getattr(whole, name)), name
