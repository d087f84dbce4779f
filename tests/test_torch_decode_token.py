"""One-token B7, ``decode_attention`` (``csrc/decode_attention.cu``), on
the CPU: the host side of its launch (``decode_launch``: JAX's kv tiles
cut into spans, one block each, a thread block cluster per tile; the
columns each block reads, ``decode_token_reads``), and a plain emulation
of the kernel's span and cluster arithmetic (each span's scores, on the
s8 path the tile's max score and P scale exchanged between the spans, one
(out, lse) partial per span, merged) held against the plain version,
``decode_attention_core_plain``, and once against JAX's
``decode_attention`` (Pallas, interpret mode).

Tolerances: the emulation against the plain version, out 2^-7 of each
row's size (one bf16 ulp of its largest value; here both sides are fp32)
and lse 1e-4: the same fp32 products, summed per span and per tile in
another order; on the s8 path P's requantization is the plain version's,
equal wherever the plain value p / ps is not within 1e-3 of a rounding
tie (the online form's p = exp(s - m) takes the tile's max for m where
JAX takes the running max, a factor common to the tile that cancels in
p / ps up to exp's rounding, and the tile's p max comes from the spans'
maxima rescaled, equal up to the same rounding). Against JAX:
tests/test_torch_decode.py's out 2e-2 and lse 1e-4.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu.ops import decode as jdec
from long_context_attention_tpu.ops import kv_cache as jkv
from long_context_attention_tpu_torch.ops import decode as tdec
from long_context_attention_tpu_torch.ops import kv_cache as tkv
from long_context_attention_tpu_torch.ops.merge import merge_partials

torch.set_num_threads(1)

ROW_TOL = 2.0 ** -7
LSE_TOL = 1e-4
TIE = 1e-3


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

def _visible(length, n_tok, cap, left, sink):
    """Columns some token of the run sees."""
    q = length - n_tok + np.arange(n_tok)[:, None]
    c = np.arange(cap)[None, :]
    vis = c <= q
    if left >= 0:
        vis &= (c >= q - left) | (c < sink)
    return set(np.flatnonzero(vis.any(0)).tolist())


def _allowed(length, n_tok, bkv, left, sink):
    """Columns a block may read: below the row's length, and in a sink tile
    (below the sinks) or in the band from the tile of the run's first
    token's window to the tile of its last column."""
    if length <= 0:
        return set()
    first = max(length - n_tok - left, 0) if left >= 0 else 0
    band = set(range(first // bkv * bkv, length))
    sinks = set(range(min(sink, length))) if left >= 0 else set()
    return band | sinks


PLANS = [  # (cap, page or None, bkv, row bytes, n_tok, left, sink)
    (2048, None, 256, 128, 1, -1, 0),
    (2048, None, 512, 64, 1, 40, 4),
    (1536, None, 192, 128, 2, -1, 0),
    (1536, None, 192, 128, 1, 40, 4),
    (2048, None, 1024, 256, 3, 40, 4),
    (2048, None, 2048, 128, 4, -1, 0),
    (4096, 512, 512, 128, 1, -1, 0),      # paged: 8 pages of 512
    (4096, 512, 256, 256, 2, 40, 4),
    (4096, 1024, 1024, 64, 4, 300, 4),
]


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: "-".join(map(str, p)))
def test_spans_cover_each_live_column_once(plan):
    """For dense and paged caches, windows with sinks, 192-column tiles and
    runs of 1-4 tokens at g = 2 (G <= 8): every visible column of a row
    falls in exactly one block's span, no block reads past the row's length
    or outside its sink tiles and window band, the cluster is at most 8 and
    divides the grid and the tile, and kv_splits 2 and 4 do not change the
    launch."""
    cap, page, bkv, row_bytes, n_tok, left, sink = plan
    if page is not None:
        assert page % bkv == 0 and cap % page == 0
    b, h_kv, g = 3, 2, 2
    launch = tdec.decode_launch("decode_attention", b, h_kv, g * n_tok, cap,
                                bkv, n_tok, left, sink, row_bytes=row_bytes)
    assert 1 <= launch.cluster <= 8 and launch.cluster * launch.span == bkv
    assert launch.grid == (launch.splits, h_kv, b)  # a partial per block
    assert launch.grid[0] % launch.cluster == 0 and launch.per_split == 1
    for kv_splits in (2, 4):
        assert tdec.decode_launch("decode_attention", b, h_kv, g * n_tok, cap,
                                  bkv, n_tok, left, sink, kv_splits,
                                  row_bytes=row_bytes) == launch
    for length in sorted({n_tok, n_tok + 1, 37, bkv - 1, bkv, bkv + 1,
                          cap // 3, cap - 1, cap}):
        reads = tdec.decode_token_reads(launch, length, n_tok, cap, bkv, left,
                                        sink)
        cols = [c for _, _, lo, hi in reads for c in range(lo, hi)]
        assert len(cols) == len(set(cols)), (length, "a column read twice")
        assert _visible(length, n_tok, cap, left, sink) <= set(cols), length
        assert set(cols) <= _allowed(length, n_tok, bkv, left, sink), length
        blocks = [(slot, rank) for slot, rank, _, _ in reads]
        assert len(blocks) == len(set(blocks))
        for slot, rank, lo, hi in reads:
            assert slot < launch.splits // launch.cluster
            assert rank < launch.cluster
            # a span fits a block's shared memory, never leaves its tile
            # or page, and a tile's columns fill its spans from rank 0
            assert 0 < hi - lo <= launch.span
            t0 = lo // bkv * bkv
            assert hi - 1 < t0 + bkv
            if page is not None:
                assert lo // page == (hi - 1) // page
            assert rank == 0 or (slot, rank - 1) in blocks


def test_span_rule():
    """About 32 KB of K a span (256 columns of int8 or fp8, 128 of bf16,
    512 of packed int4), at most 8 spans a tile, the cluster dividing the
    tile; a tile that does not divide into spans is a cluster of one."""
    assert tdec.decode_token_span(2048, 128) == (8, 256)
    assert tdec.decode_token_span(1024, 256) == (8, 128)
    assert tdec.decode_token_span(2048, 64) == (4, 512)
    assert tdec.decode_token_span(4096, 128) == (8, 512)
    assert tdec.decode_token_span(192, 128) == (1, 192)
    assert tdec.decode_token_span(768, 128) == (3, 256)
    for bkv in (16, 64, 100, 128, 192, 384, 640, 1000, 2048, 8192):
        for row_bytes in (64, 128, 256):
            c, s = tdec.decode_token_span(bkv, row_bytes)
            assert 1 <= c <= 8 and c * s == bkv


# ---------------------------------------------------------------------------
# the plain emulation of the span and cluster arithmetic
# ---------------------------------------------------------------------------

def _rows(cache, layer, ib, cols, page_table, slot_dim, scales=False):
    """Cache rows (h_kv, n, d) or scales (h_kv, n) of row ib's logical
    columns ``cols`` (one tile: one page)."""
    c0 = int(cols[0])
    if page_table is None:
        pg, off = ib, c0
    else:
        pg = min(max(int(page_table[ib, c0 // slot_dim]), 0),
                 cache.shape[1] - 1)
        off = c0 % slot_dim
    n = len(cols)
    if scales:
        return cache[layer, pg, :, 0, off:off + n].float()
    return tkv._widen(cache[layer, pg, :, off:off + n], torch.float32)


def _emulate(q_in, q_rs, kc, vc, ks, vs, lengths, *, layer, block_kv, scale,
             safe=False, window_left=-1, sink_tokens=0, softcap=0.0,
             n_tok=1, page_table=None, alibi=None, row_bytes=None):
    """decode_attention.cu's arithmetic, span by span: each block scores
    its span; on the s8 path the cluster exchanges each span's (max score,
    max of p * v_scale against it), whose tile values (the max of the
    maxima, the p max rescaled to it) give m and P's requantization scale;
    the bf16 and cast kinds take each span's own max. Each span gives an
    (out, lse) partial (int32 PV times the scale on the s8 path), and
    merge_partials merges them in block order.
    ``row_bytes`` picks the spans (decode_token_span; by default the
    cache's row). Returns (out, lse, {(row, tile's first column): P8
    (h_kv, G, bkv)}, {the same: where P8 sits at a rounding tie})."""
    b, h_kv, G, d = q_in.shape
    slot_dim = kc.shape[3]
    cap = (page_table.shape[1] * slot_dim if page_table is not None
           else slot_dim)
    launch = tdec.decode_launch(
        "decode_attention", b, h_kv, G, cap, block_kv, n_tok, window_left,
        sink_tokens, row_bytes=row_bytes or kc.shape[-1] * kc.element_size())
    s8, quant = q_rs is not None, ks is not None
    sink = sink_tokens if window_left >= 0 else 0
    outs = torch.zeros((launch.splits, b, h_kv, G, d))
    lses = torch.full((launch.splits, b, h_kv, G), -math.inf)
    p8s, ties = {}, {}
    tok = torch.arange(G) % n_tok
    for ib in range(b):
        length = int(lengths[ib])
        qpos = (length - n_tok + tok)[None, :, None]  # (1, G, 1)
        reads = tdec.decode_token_reads(launch, length, n_tok, cap, block_kv,
                                        window_left, sink_tokens)
        for slot in sorted({r[0] for r in reads}):
            spans = [r for r in reads if r[0] == slot]  # rank order
            c0 = spans[0][2] // block_kv * block_kv
            scores = []
            for _, _, lo, hi in spans:
                cols = torch.arange(lo, hi)
                k = _rows(kc, layer, ib, cols, page_table, slot_dim)
                s = torch.einsum("hgd,hnd->hgn", q_in[ib].float(), k)
                if s8:
                    s = s * q_rs[ib][..., None]
                elif safe:
                    s = s * scale
                if quant:
                    s = s * _rows(ks, layer, ib, cols, page_table, slot_dim,
                                  True)[:, None]
                if softcap:
                    s = softcap * torch.tanh(s / softcap)
                if alibi is not None:
                    s = s - alibi[:, :, None] * (qpos - cols).float()
                masked = (cols > qpos) | ((cols < qpos - window_left)
                                          & (cols >= sink)
                                          if window_left >= 0 else
                                          torch.zeros_like(cols > qpos))
                scores.append((cols, s.masked_fill(masked, tdec.NEG_INF)))
            def p_of(s, m):  # exp against the max m, 0 where masked
                if not safe:
                    return torch.exp2(torch.clamp(s, max=tdec._CLAMP))
                return torch.exp(s - m[..., None]).masked_fill(
                    s == tdec.NEG_INF, 0.0)

            vsc = [_rows(vs, layer, ib, cols, page_table, slot_dim, True)[
                :, None] if quant else None for cols, _ in scores]
            # each span's max score (online form)
            ms = [s.amax(-1) if safe else torch.zeros((h_kv, G))
                  for _, s in scores]
            if s8:
                # the cluster's exchange of each span's (max, p max): the
                # tile's max and its p max rescaled to it
                m_t = torch.stack(ms).amax(0)
                pmax = torch.stack([
                    (p_of(s, m) * v).amax(-1) * (
                        torch.where(m == tdec.NEG_INF, 0.0,
                                    torch.exp(m - m_t)) if safe else 1.0)
                    for (_, s), m, v in zip(scores, ms, vsc)]).amax(0)
                ps = torch.clamp(pmax, min=1e-20)[..., None] * (1.0 / 127.0)
                ms = [m_t] * len(scores)
            p8 = torch.zeros((h_kv, G, block_kv))
            tie = torch.zeros((h_kv, G, block_kv), dtype=torch.bool)
            # one (out, lse) partial per span
            for (rank, cols), (_, s), m, vv in zip(
                    [(r[1], torch.arange(r[2], r[3])) for r in spans],
                    scores, ms, vsc):
                v = _rows(vc, layer, ib, cols, page_table, slot_dim)
                p = p_of(s, m)
                l = p.sum(-1)
                if quant:
                    p = p * vv
                if s8:
                    x = p / ps
                    q8 = torch.round(x)
                    p8[..., cols - c0] = q8
                    tie[..., cols - c0] = ((x - torch.floor(x)) - 0.5).abs() \
                        < TIE
                    acc = torch.einsum("hgn,hnd->hgd", q8.double(),
                                       v.double()).float() * ps
                else:
                    acc = torch.einsum(
                        "hgn,hnd->hgd", p.to(torch.bfloat16).float(), v)
                dead = l == 0
                part = slot * launch.cluster + rank
                outs[part, ib] = torch.where(
                    dead[..., None], 0.0,
                    acc / torch.where(dead, 1.0, l)[..., None])
                lse = torch.log(torch.where(dead, 1.0, l)) + m
                lses[part, ib] = torch.where(dead, -math.inf, lse)
            p8s[(ib, c0)] = p8
            ties[(ib, c0)] = tie
    out, lse = merge_partials(outs, lses)
    return out, lse, p8s, ties


def _cache(rng, dtype, L, rows, h_kv, slots, d):
    """Random K/V in ``dtype``'s storage with scales (.., h_kv, 1, slots)."""
    vals = [torch.from_numpy(rng.standard_normal((L, rows, h_kv, slots, d))
                             .astype(np.float32)) for _ in range(2)]
    if dtype == "bfloat16":
        return [vals[0].bfloat16(), vals[1].bfloat16(), None, None]
    (k, ks), (v, vs) = (tkv.quantize_kv(x, dtype) for x in vals)
    return [k, v, ks[..., None, :], vs[..., None, :]]


def _row_rel(got, want):
    diff = (got - want).abs().amax(-1)
    size = want.abs().amax(-1)
    return float(torch.where(size > 0, diff / size.clamp_min(1e-30),
                             torch.where(diff > 0, math.inf, 0.0)).max())


EMULATED = [  # (cache dtype, s8, safe, n_tok, bkv, window, sinks, softcap,
              #  alibi, paged)
    ("int8", True, False, 1, 128, -1, 0, 0.0, False, False),
    ("int8", True, True, 1, 128, 40, 4, 0.0, False, False),
    ("int8", True, True, 2, 192, -1, 0, 30.0, True, False),
    ("int4", True, False, 4, 256, 40, 4, 0.0, False, True),
    ("int8", True, True, 1, 256, -1, 0, 0.0, False, True),
    ("float8_e4m3fn", False, True, 1, 128, 40, 4, 0.0, True, False),
    ("bfloat16", False, False, 3, 192, -1, 0, 0.0, False, False),
]


@pytest.mark.parametrize("case", EMULATED, ids=lambda c: "-".join(map(str, c)))
def test_span_emulation_matches_plain(rng, case):
    """The span/cluster arithmetic against decode_attention_core_plain over
    ragged rows (one of them dead), fast and online, window and sinks,
    softcap, ALiBi, runs of 2-4 tokens, 192-column tiles, packed int4 and
    the paged pool, in spans of 64 columns (clusters of 2-4 at these
    tiles; the arithmetic does not depend on the span), and in one span
    a tile: P8 equal on the s8 path (but at rounding ties), out within
    2^-7 of each row's size, lse 1e-4."""
    dtype, s8, safe, n_tok, bkv, left, sink, cap, alibi, paged = case
    L, b, h_kv, g, d, slots = 2, 3, 2, 2, 32, 768
    G = g * n_tok
    if paged:
        page, n_pages, pool = 256, 3, 10
        cache = _cache(rng, dtype, L, pool, h_kv, page, d)
        pt = torch.tensor([[3, 7, 1], [5, 2, -1], [-1, -1, -1]],
                          dtype=torch.int32)
        lens = torch.tensor([768, 300, 0], dtype=torch.int32)
    else:
        cache = _cache(rng, dtype, L, b, h_kv, slots, d)
        pt = None
        lens = torch.tensor([slots, 401, n_tok], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((b, h_kv, G, d)).astype(
        np.float32))
    scale = d ** -0.5
    if s8:
        q_rs = torch.clamp(q.abs().amax(-1), min=1e-6) / 127.0
        q_in = torch.round(q / q_rs[..., None]).to(torch.int8)
        q_rs = q_rs * (scale if safe else scale * tdec._LOG2E)
    else:
        q_in = (q if safe else q * scale * tdec._LOG2E).bfloat16()
        q_rs = None
    slopes = (torch.linspace(0.05, 0.4, h_kv * G).reshape(h_kv, G)
              if alibi else None)
    kw = dict(layer=1, block_kv=bkv, scale=scale, safe_softmax=safe,
              window_left=left, sink_tokens=sink, softcap=cap, n_tok=n_tok,
              page_table=pt, alibi=slopes)
    log = []
    want_o, want_l = tdec.decode_attention_core_plain(
        q_in, q_rs, *cache, lens, p8_log=log, **kw)
    assert torch.isinf(want_l[2]).all() == (int(lens[2]) == 0)
    plain = {c0: p8 for c0, p8 in log}
    for row_bytes in (512, None):  # spans of 64 columns; the kernel's
        got_o, got_l, p8s, ties = _emulate(
            q_in, q_rs, *cache, lens, layer=1, block_kv=bkv, scale=scale,
            safe=safe, window_left=left, sink_tokens=sink, softcap=cap,
            n_tok=n_tok, page_table=pt, alibi=slopes, row_bytes=row_bytes)
        assert _row_rel(got_o, want_o) <= ROW_TOL
        both_inf = torch.isinf(got_l) & torch.isinf(want_l) & (
            got_l == want_l)
        assert float(torch.where(both_inf, 0.0,
                                 (got_l - want_l).abs()).max()) <= LSE_TOL
        if s8:
            assert p8s
            for (ib, c0), p8 in p8s.items():
                n = min(bkv, plain[c0].shape[-1])
                same = (p8[..., :n] == plain[c0][ib, ..., :n]) | ties[
                    ib, c0][..., :n]
                assert bool(same.all()), (ib, c0)
                if not safe:  # no max to differ by: equal everywhere
                    assert torch.equal(p8[..., :n], plain[c0][ib, ..., :n])


def test_span_emulation_matches_jax(rng):
    """One case through the emulation against JAX's decode_attention on
    the same numpy inputs (tests/test_torch_decode.py's way): the s8 path
    over an int8 cache of 512 slots in tiles of 128, window 100 with 4
    sinks, rows ending in the first, third and last tile."""
    L, b, h_kv, g, d, s_max = 2, 3, 2, 2, 32, 512
    jc = jkv.KVCache.init(L, b, s_max, h_kv, d, "int8")
    tc = tkv.KVCache.init(L, b, s_max, h_kv, d, "int8", device="cpu")
    for layer in range(L):
        k = rng.standard_normal((b, s_max, h_kv, d)).astype(np.float32)
        v = rng.standard_normal((b, s_max, h_kv, d)).astype(np.float32)
        jc = jc.write_prompt(layer, jnp.asarray(k), jnp.asarray(v))
        tc.write_prompt(layer, torch.from_numpy(k), torch.from_numpy(v))
    q = rng.standard_normal((b, h_kv * g, d)).astype(np.float32)
    lens = np.array([100, 300, 512], np.int32)
    jo, jl = jdec.decode_attention(
        jnp.asarray(q, jnp.bfloat16), jc.k, jc.v, jnp.asarray(lens),
        jc.k_scale, jc.v_scale, layer=jnp.int32(1), block_kv=128,
        window_size=(100, -1), sink_tokens=4, return_lse=True)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    q_in, q_rs, bkv = tdec.decode_query_operands(
        qt, tc.k, True, scale=d ** -0.5, block_kv=128)
    assert bkv == 128
    out, lse, _, _ = _emulate(q_in, q_rs, tc.k, tc.v, tc.k_scale, tc.v_scale,
                              torch.from_numpy(lens), layer=1, block_kv=bkv,
                              scale=d ** -0.5, window_left=100,
                              sink_tokens=4)
    out = out.to(torch.bfloat16).reshape(b, h_kv * g, d)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jo, np.float32), atol=2e-2, rtol=0)
    np.testing.assert_allclose(lse.reshape(b, h_kv * g).numpy(),
                               np.asarray(jl, np.float32), atol=1e-4, rtol=0)
