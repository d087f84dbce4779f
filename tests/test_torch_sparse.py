"""Block-sparse attention of the PyTorch port against the JAX package, on
the same numpy inputs: the tile-mask functions and the live-tile tables
(exact), the plain versions of kernels B9a (forward), B9b (dq) and B9c (dk, dv)
through ``block_sparse_attention`` against JAX's dense-bias oracle
(``xla_attention`` with the tile mask as an additive bias, the pattern of
``tests/test_sparse.py``) and, for a causal GQA per-head mask and the
ulysses head shard, against JAX's own kernels in interpret mode; and
the kernels' host item lists and block schedules, B9c's column items and
B9a's and B9b's row items (exact).

Tolerances (those of ``tests/test_sparse.py``):
* fp32 out and lse 2e-5, gradients 2e-4: the same fp32 arithmetic on both
  sides (the max-free exp2 softmax against the oracle's exact one, which
  agree to rounding at these scores), summed in another order.
* bf16 inputs 1e-1 against the fp32 oracle (the reference's bf16 gate).
* tables, masks and the uncovered rows' out 0 / lse -inf: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu.ops import sparse as jsp
from long_context_attention_tpu.ops.reference import xla_attention
from long_context_attention_tpu_torch.ops import sparse as tsp

torch.set_num_threads(1)

BQ = BKV = 64
B, S, H, HKV, D = 2, 512, 4, 2, 64
OUT_TOL = dict(atol=2e-5, rtol=0)
GRAD_TOL = dict(atol=2e-4, rtol=0)


def make_qkv(rng, b=B, s=S, h=H, hkv=HKV, d=D, s_kv=None):
    s_kv = s if s_kv is None else s_kv
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s_kv, hkv, d),
                               (b, s_kv, hkv, d)))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def dense_bias(block_mask, s_q, s_kv, h):
    """Tile mask -> (1, h, s_q, s_kv) additive bias for the oracle."""
    m = np.asarray(block_mask, dtype=bool)
    if m.ndim == 2:
        m = np.broadcast_to(m[None], (h,) + m.shape)
    bq, bkv = s_q // m.shape[1], s_kv // m.shape[2]
    dense = np.repeat(np.repeat(m, bq, axis=1), bkv, axis=2)
    return jnp.asarray(np.where(dense, 0.0, -1e30), jnp.float32)[None]


def oracle(q, k, v, block_mask, causal=False, softmax_scale=None):
    h = q.shape[2]
    return xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, softmax_scale=softmax_scale,
                         bias=dense_bias(block_mask, q.shape[1], k.shape[1],
                                         h))


def port(q, k, v, block_mask, **kw):
    return tsp.block_sparse_attention_fwd(_t(q), _t(k), _t(v), block_mask,
                                          block_q=BQ, block_kv=BKV, **kw)


# ---------------------------------------------------------------------------
# tile masks and tables (exact)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("causal_block_mask", (8, 8)),
    ("causal_block_mask", (4, 8)),
    ("sliding_window_block_mask", (8, 8, 2)),
    ("sliding_window_block_mask", (4, 8, 3)),
    ("global_local_block_mask", (8, 8, 2, 1)),
    ("strided_block_mask", (8, 8, 3, 1)),
    ("random_block_mask", (8, 8, 0.4, 7)),
    ("random_block_mask", (8, 8, 0.5, 3, 4)),
])
def test_tile_masks_match_jax(name, args):
    """Each mask function gives JAX's mask, and mask_density JAX's number."""
    got = getattr(tsp, name)(*args)
    want = getattr(jsp, name)(*args)
    np.testing.assert_array_equal(got, want)
    for causal in (False, True):
        assert tsp.mask_density(got, causal) == jsp.mask_density(want, causal)


TABLE_CASES = {
    # name: (mask, h, n_q, n_kv, causal, bq, bkv, g)
    "shared causal": (jsp.global_local_block_mask(8, 8, 2, 1), 4, 8, 8,
                      True, 64, 64, 2),
    "per-head causal": (jsp.random_block_mask(8, 8, 0.5, 11, heads=4), 4, 8,
                        8, True, 64, 64, 2),
    "rectangular causal": (jsp.sliding_window_block_mask(4, 8, 3), 4, 4, 8,
                           True, 64, 64, 2),
    "non-causal strided": (jsp.strided_block_mask(8, 4, 3, 1), 4, 8, 4,
                           False, 64, 128, 4),
}


@pytest.mark.parametrize("case", TABLE_CASES)
def test_tables_match_jax(case):
    """_normalize_mask, _row_tables and _col_tables give JAX's arrays entry
    for entry (the column order (group, q tile) included), and the plan's
    CSR form lists exactly the tables' non-DEAD entries, in order."""
    mask, h, n_q, n_kv, causal, bq, bkv, g = TABLE_CASES[case]
    got = tsp._normalize_mask(mask, h, n_q, n_kv, causal, bq, bkv)
    want = jsp._normalize_mask(mask, h, n_q, n_kv, causal, bq, bkv)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    mh, per_head, straddle = want
    shift = n_kv * bkv - n_q * bq
    rows = jsp._row_tables(mh, straddle, per_head, bq=bq, bkv=bkv, shift=shift)
    cols = jsp._col_tables(mh, straddle, per_head, g, bq=bq, bkv=bkv,
                           shift=shift)
    for a, b in zip(tsp._row_tables(mh, straddle, per_head, bq=bq, bkv=bkv,
                                    shift=shift), rows):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsp._col_tables(mh, straddle, per_head, g, bq=bq,
                                    bkv=bkv, shift=shift), cols):
        np.testing.assert_array_equal(a, b)

    mask = np.ascontiguousarray(mask)
    plan = tsp._plan(mask.tobytes(), mask.shape, h, n_q, n_kv, causal, bq,
                     bkv, g, 0, 1)
    for a, b in zip(plan.row_tables(), rows):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(plan.col_tables(), cols):
        np.testing.assert_array_equal(a, b)
    row_ptr, row_ent, col_ptr, col_ent = (t.numpy() for t in plan.csr("cpu"))
    ih, iq, ik, fl, qf, kf = rows
    live = (fl & tsp._F_DEAD) == 0
    np.testing.assert_array_equal(row_ent, np.stack([ik, fl, qf, kf], 1)[live])
    keys = (ih * n_q + iq)[live]
    np.testing.assert_array_equal(np.repeat(np.arange(row_ptr.size - 1),
                                            np.diff(row_ptr)), keys)
    ihk, ig, iqc, ikc, flc, qfc, kfc = cols
    live = (flc & tsp._F_DEAD) == 0
    np.testing.assert_array_equal(
        col_ent, np.stack([(ig << 4) | flc, iqc, qfc, kfc], 1)[live])
    np.testing.assert_array_equal(np.repeat(np.arange(col_ptr.size - 1),
                                            np.diff(col_ptr)),
                                  (ihk * n_kv + ikc)[live])


# B9c's item order: the usp_sparse path's masks (32768 tokens in tiles of
# 512, 16/8 heads) and a plan in tiles of 192
_USP_N, _USP_H = 64, 16
ITEM_CASES = {
    "streaming": (tsp.global_local_block_mask(_USP_N, _USP_N, 8, sink_tiles=1),
                  _USP_H, _USP_N, 512),
    "strided": (tsp.strided_block_mask(_USP_N, _USP_N, 8, local_tiles=4),
                _USP_H, _USP_N, 512),
    "per_head": (np.stack([tsp.global_local_block_mask(
        _USP_N, _USP_N, 4 + 2 * (i % 5), sink_tiles=1) for i in range(_USP_H)]),
        _USP_H, _USP_N, 512),
    "block 192": (tsp.global_local_block_mask(12, 12, 3, sink_tiles=1), 4, 12,
                  192),
}


@pytest.mark.parametrize("case", ITEM_CASES)
def test_dkv_item_order(case):
    """B9c's host item order (SparsePlan.dkv_items), causal: expanded as the
    kernel expands it over 2 batch rows and the kv heads, every (128-row
    sub-tile, column, batch row, kv head) appears exactly once; step counts
    do not increase along the order; and each item's count equals its
    column's live entries' 64-row q steps less those wholly above the
    diagonal, counted here one step at a time."""
    mask, h, n, blk = ITEM_CASES[case]
    g, b = 2, 2
    h_kv = h // g
    m = np.ascontiguousarray(mask)
    plan = tsp._plan(m.tobytes(), m.shape, h, n, n, True, blk, blk, g, 0, 1)
    items = plan.dkv_items()
    assert items.dtype == np.int32 and items.shape[1] == 4
    assert (np.diff(items[:, 2]) <= 0).all()
    n_cols = (h_kv if plan.per_head else 1) * n
    subs = list(range(0, blk, 128))
    assert sorted(map(tuple, items[:, :2].tolist())) == [
        (c, sub) for c in range(n_cols) for sub in subs]
    # the kernel's expansion of item t // reps (csrc/flash_bwd_sm90.cu
    # item_of): batch row t % reps % b, kv head from a per-head column or
    # (t % reps) // b
    reps = b if plan.per_head else b * h_kv
    seen = set()
    for t in range(items.shape[0] * reps):
        col, sub = items[t // reps, :2]
        r = t % reps
        ihk = col // n if plan.per_head else r // b
        seen.add((int(sub), int(col % n), r % b, int(ihk)))
    assert len(seen) == items.shape[0] * reps == len(subs) * n * b * h_kv
    # step counts, one 64-row q step at a time
    ihk, _, _, ik, fl, qf, kf = plan.col_tables()
    want = {}
    for e in np.flatnonzero((fl & tsp._F_DEAD) == 0):
        col = int(ihk[e]) * n + int(ik[e])
        for sub in subs:
            for j in range(blk // 64):
                above = qf[e] + 64 * j + 63 < kf[e] + sub
                if not (fl[e] & tsp._F_MASKED and above):
                    want[col, sub] = want.get((col, sub), 0) + 1
    for col, sub, steps, _ in items.tolist():
        assert steps == want.get((col, sub), 0), (col, sub)


@pytest.mark.parametrize("case", ITEM_CASES)
def test_dkv_schedule(case):
    """B9c's blocks (SparsePlan.dkv_schedule) over 2 batch rows and 132
    blocks (an H100's SMs): every work item runs exactly once; each block
    takes its items longest first; and no block's work (steps + the
    per-item cost) passes the average by more than the largest item's,
    the bound of greedy list scheduling."""
    mask, h, n, blk = ITEM_CASES[case]
    g, b, blocks = 2, 2, 132
    h_kv = h // g
    m = np.ascontiguousarray(mask)
    plan = tsp._plan(m.tobytes(), m.shape, h, n, n, True, blk, blk, g, 0, 1)
    ptr, work = plan.dkv_schedule(b, h_kv, blocks)
    reps = b if plan.per_head else b * h_kv
    n_work = plan.dkv_items().shape[0] * reps
    assert ptr.dtype == work.dtype == np.int32
    assert ptr.size == min(blocks, n_work) + 1 and ptr[0] == 0
    assert sorted(work.tolist()) == list(range(n_work))
    cost = np.repeat(plan.dkv_items()[:, 2], reps) + tsp._DKV_ITEM_COST
    loads = []
    for i in range(ptr.size - 1):
        mine = cost[work[ptr[i]:ptr[i + 1]]]
        assert (np.diff(mine) <= 0).all()
        loads.append(int(mine.sum()))
    assert max(loads) <= cost.sum() / (ptr.size - 1) + cost.max()


# B9a's and B9b's row items: 16 tiles of 512 (the usp_sparse tile) and 4
# heads, causal unless named, plus tiles of 192 and a non-causal
# rectangular call (4 q tiles at the end of 16 kv tiles)
_RN, _RH = 16, 4
_uncovered = tsp.global_local_block_mask(_RN, _RN, 8, sink_tiles=1)
_uncovered[3 * _RN // 4:] = False
ROW_CASES = {
    # name: (mask, h, n_q, n_kv, causal, block)
    "causal": (tsp.causal_block_mask(_RN, _RN), _RH, _RN, _RN, True, 512),
    "streaming": (tsp.global_local_block_mask(_RN, _RN, 8, sink_tiles=1),
                  _RH, _RN, _RN, True, 512),
    "strided": (tsp.strided_block_mask(_RN, _RN, 8, local_tiles=4), _RH, _RN,
                _RN, True, 512),
    "per_head": (np.stack([tsp.global_local_block_mask(
        _RN, _RN, 4 + 2 * (i % 5), sink_tiles=1) for i in range(_RH)]), _RH,
        _RN, _RN, True, 512),
    "uncovered rows": (_uncovered, _RH, _RN, _RN, True, 512),
    "block 192": (tsp.global_local_block_mask(12, 12, 3, sink_tiles=1), _RH,
                  12, 12, True, 192),
    "non-causal rectangular": (tsp.random_block_mask(4, _RN, 0.25, seed=2),
                               _RH, 4, _RN, False, 512),
}


def _row_plan(case):
    mask, h, n_q, n_kv, causal, blk = ROW_CASES[case]
    m = np.ascontiguousarray(mask)
    return tsp._plan(m.tobytes(), m.shape, h, n_q, n_kv, causal, blk, blk, 2,
                     0, 1), h


@pytest.mark.parametrize("case", ROW_CASES)
def test_row_item_steps(case):
    """B9a's and B9b's row items (SparsePlan.row_items): one per (row,
    128-row offset in its q tile), steps not increasing along the order,
    and each item's steps equal to a brute-force count over every (q row,
    kv column) pair of the 128 x 128 steps it may walk: a step of a live
    tile is walked when some pair of the item's rows and the step's columns
    inside the tile is visible (on a straddling tile, column position <=
    row position)."""
    plan, h = _row_plan(case)
    items = plan.row_items()
    assert items.dtype == np.int32 and items.shape[1] == 4
    assert (np.diff(items[:, 2]) <= 0).all()
    heads = h if plan.per_head else 1
    subs = list(range(0, plan.bq, 128))
    assert sorted(map(tuple, items[:, :2].tolist())) == [
        (r, sub) for r in range(heads * plan.n_q) for sub in subs]
    want = {}
    for ih in range(heads):
        for iq in range(plan.n_q):
            for sub in subs:
                rows = plan.q_first[iq] + np.arange(sub,
                                                    min(sub + 128, plan.bq))
                n = 0
                for ik in np.flatnonzero(plan.mh[ih, iq]):
                    for c0 in range(0, plan.bkv, 128):
                        cols = plan.kv_first[ik] + np.arange(
                            c0, min(c0 + 128, plan.bkv))
                        vis = np.ones((rows.size, cols.size), bool)
                        if plan.straddle[iq, ik]:
                            vis = cols[None, :] <= rows[:, None]
                        n += int(vis.any())
                want[ih * plan.n_q + iq, sub] = n
    got = {(r, sub): steps for r, sub, steps, _ in items.tolist()}
    assert got == want
    if case == "uncovered rows":  # 0-step items for the rows with no tile
        assert sum(v == 0 for v in got.values()) == len(subs) * _RN // 4


@pytest.mark.parametrize("case", ROW_CASES)
def test_row_items_cover_every_row(case):
    """Expanded as the kernels expand them (csrc/sm90.cuh row_item) over 2
    batch rows and the heads, the row items give every (q row, head, batch
    row) exactly once, the rows of a q tile with no live tile included."""
    plan, h = _row_plan(case)
    b = 2
    items = plan.row_items()
    reps = b if plan.per_head else b * h
    owned = np.zeros((b, h, plan.n_q * plan.bq), np.int64)
    for t in range(items.shape[0] * reps):
        row, sub, _, _ = items[t // reps]
        r = t % reps
        ih = row // plan.n_q if plan.per_head else r // b
        q0 = (row % plan.n_q) * plan.bq + sub
        owned[r % b, ih, q0:q0 + min(128, plan.bq - sub)] += 1
    assert (owned == 1).all()


@pytest.mark.parametrize("case", ROW_CASES)
def test_row_schedule(case):
    """B9a's and B9b's shared deal (SparsePlan.row_schedule) over 2 batch
    rows and 132 blocks: every work item runs exactly once; each block takes
    its items longest first; no block's work (steps + the per-item cost)
    passes the average by more than the largest item's; and the tensors on
    a device are the same arrays, cached."""
    plan, h = _row_plan(case)
    b, blocks = 2, 132
    ptr, work = plan.row_schedule(b, h, blocks)
    reps = b if plan.per_head else b * h
    n_work = plan.row_items().shape[0] * reps
    assert ptr.dtype == work.dtype == np.int32
    assert ptr.size == min(blocks, n_work) + 1 and ptr[0] == 0
    assert sorted(work.tolist()) == list(range(n_work))
    cost = np.repeat(plan.row_items()[:, 2], reps) + tsp._ROW_ITEM_COST
    loads = []
    for i in range(ptr.size - 1):
        mine = cost[work[ptr[i]:ptr[i + 1]]]
        assert (np.diff(mine) <= 0).all()
        loads.append(int(mine.sum()))
    assert max(loads) <= cost.sum() / (ptr.size - 1) + cost.max()
    on_dev = plan.row_schedule(b, h, blocks, "cpu")
    assert on_dev is plan.row_schedule(b, h, blocks, "cpu")
    assert all(np.array_equal(a.numpy(), w) for a, w in zip(on_dev,
                                                            (ptr, work)))


# ---------------------------------------------------------------------------
# forward against the dense-bias oracle
# ---------------------------------------------------------------------------

N = S // BQ
FWD_CASES = {
    # name: (mask, causal, extra kwargs, q/kv lengths)
    "banded causal": (jsp.sliding_window_block_mask(N, N, 2), True, {}, None),
    "banded non-causal": (jsp.sliding_window_block_mask(N, N, 2), False, {},
                          None),
    "global-local": (jsp.global_local_block_mask(N, N, 2, sink_tiles=1), True,
                     {}, None),
    "strided": (jsp.strided_block_mask(N, N, 3, local_tiles=1), True, {},
                None),
    "random": (jsp.random_block_mask(N, N, 0.4, seed=7), True, {}, None),
    "per-head": (jsp.random_block_mask(N, N, 0.5, seed=3, heads=H), True, {},
                 None),
    "rectangular": (jsp.sliding_window_block_mask(4, 8, 3), True, {},
                    (256, 512)),
    "softmax_scale": (np.ones((N, N), bool), True, {"softmax_scale": 0.25},
                      None),
}


@pytest.mark.parametrize("case", FWD_CASES)
def test_forward_matches_oracle(rng, case):
    """out and lse of the port (B9a's plain version) against JAX's
    dense-bias oracle: banded causal and not, the StreamingLLM, strided,
    random and per-head patterns, rectangular cross-attention (bottom
    aligned) and softmax_scale."""
    mask, causal, kw, lens = FWD_CASES[case]
    s, s_kv = lens or (S, S)
    q, k, v = make_qkv(rng, s=s, s_kv=s_kv)
    out, lse = port(q, k, v, mask, causal=causal, **kw)
    ref_out, ref_lse = oracle(q, k, v, mask, causal=causal,
                              softmax_scale=kw.get("softmax_scale"))
    np.testing.assert_allclose(_np(out), np.asarray(ref_out), **OUT_TOL)
    np.testing.assert_allclose(_np(lse), np.asarray(ref_lse), **OUT_TOL)


def test_full_mask_equals_dense_attention(rng):
    """An all-ones mask reproduces plain causal attention."""
    q, k, v = make_qkv(rng, s=256)
    n = 256 // BQ
    out, _ = port(q, k, v, np.ones((n, n), bool), causal=True)
    ref_out, _ = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True)
    np.testing.assert_allclose(_np(out), np.asarray(ref_out), **OUT_TOL)


def test_uncovered_rows_emit_merge_identity(rng):
    """Rows with no live tile: out exactly 0 and lse -inf, dq exactly 0
    there; the covered tile matches the oracle."""
    q, k, v = make_qkv(rng, s=256)
    n = 256 // BQ
    mask = np.zeros((n, n), dtype=bool)
    mask[0, 0] = True
    tq = _t(q).requires_grad_()
    out, lse = tsp.block_sparse_attention_fwd(tq, _t(k), _t(v), mask,
                                              block_q=BQ, block_kv=BKV)
    out.sum().backward()
    assert np.all(_np(out)[:, BQ:] == 0.0)
    assert np.all(_np(lse)[:, :, BQ:] == -np.inf)
    assert np.all(np.isfinite(_np(lse)[:, :, :BQ]))
    assert np.all(_np(tq.grad)[:, BQ:] == 0.0)
    ref_out, _ = xla_attention(jnp.asarray(q[:, :BQ]), jnp.asarray(k[:, :BKV]),
                               jnp.asarray(v[:, :BKV]))
    np.testing.assert_allclose(_np(out)[:, :BQ], np.asarray(ref_out),
                               **OUT_TOL)


def test_bf16_within_reference_gate(rng):
    """bf16 inputs (q folded in bf16, bf16 p) against the fp32 oracle."""
    q, k, v = make_qkv(rng)
    mask = jsp.sliding_window_block_mask(N, N, 2)
    out = tsp.block_sparse_attention(
        *(_t(x, torch.bfloat16) for x in (q, k, v)), mask, causal=True,
        block_q=BQ, block_kv=BKV)
    assert out.dtype == torch.bfloat16
    qb, kb, vb = (_np(_t(x, torch.bfloat16)) for x in (q, k, v))
    ref_out, _ = oracle(qb, kb, vb, mask, causal=True)
    np.testing.assert_allclose(_np(out), np.asarray(ref_out), atol=1e-1,
                               rtol=0)


# ---------------------------------------------------------------------------
# gradients; JAX's own kernels for a per-head GQA mask and the head shard
# ---------------------------------------------------------------------------


def _port_grads(q, k, v, dout, mask, block=BQ, **kw):
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = tsp.block_sparse_attention(tq, tk, tv, mask, block_q=block,
                                     block_kv=block, **kw)
    out.backward(_t(dout))
    return out, (tq.grad, tk.grad, tv.grad)


def test_grads_match_oracle(rng):
    """The sparse backward (B9b's and B9c's plain versions) against the
    oracle's gradients, StreamingLLM mask, causal, GQA."""
    q, k, v = make_qkv(rng, b=1, s=256)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    n = 256 // BQ
    mask = jsp.global_local_block_mask(n, n, 2, sink_tiles=1)
    _, grads = _port_grads(q, k, v, dout, mask, causal=True)

    def loss(q, k, v):
        o, _ = xla_attention(q, k, v, causal=True,
                             bias=dense_bias(mask, 256, 256, H))
        return jnp.sum(o * dout)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, w in zip(grads, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **GRAD_TOL)


def test_per_head_gqa_matches_jax_kernels(rng):
    """A causal per-head GQA mask: out, lse and all three gradients against
    JAX's block_sparse_attention (its Pallas kernels in interpret mode)."""
    q, k, v = make_qkv(rng, b=1, s=256)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    n = 256 // BQ
    mask = jsp.random_block_mask(n, n, 0.5, seed=11, heads=H)
    out, grads = _port_grads(q, k, v, dout, mask, causal=True)
    _, lse = port(q, k, v, mask, causal=True)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref_out, ref_lse = jsp.block_sparse_attention_fwd(
        jq, jk, jv, mask, causal=True, block_q=BQ, block_kv=BKV)
    np.testing.assert_allclose(_np(out), np.asarray(ref_out), **OUT_TOL)
    np.testing.assert_allclose(_np(lse), np.asarray(ref_lse), **OUT_TOL)

    def loss(q, k, v):
        return jnp.sum(jsp.block_sparse_attention(
            q, k, v, mask, causal=True, block_q=BQ, block_kv=BKV) * dout)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **GRAD_TOL)


def test_block_192_grads_match_jax_kernels(rng):
    """Tiles of 192 rows, an odd multiple of the kernels' 64 (B9c's last
    128-row item of each kv tile is half the next tile's): out and all
    three gradients of the port's plain versions against JAX's
    block_sparse_attention (its Pallas kernels in interpret mode), causal
    StreamingLLM mask, GQA."""
    s, blk = 576, 192
    q, k, v = make_qkv(rng, b=1, s=s)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    mask = jsp.global_local_block_mask(s // blk, s // blk, 1, sink_tiles=1)
    out, grads = _port_grads(q, k, v, dout, mask, block=blk, causal=True)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref_out = jsp.block_sparse_attention(jq, jk, jv, mask, causal=True,
                                         block_q=blk, block_kv=blk)
    np.testing.assert_allclose(_np(out), np.asarray(ref_out), **OUT_TOL)

    def loss(q, k, v):
        return jnp.sum(jsp.block_sparse_attention(
            q, k, v, mask, causal=True, block_q=blk, block_kv=blk) * dout)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **GRAD_TOL)


def test_head_shard_matches_jax(rng):
    """head_shard=(rank, 2): each rank's 2 local heads use their block of a
    4-head global mask, against JAX's rank-indexed call on the same local
    heads, and equal to the port's call on that block of the mask."""
    q, k, v = make_qkv(rng, b=1, s=256, h=2, hkv=1)
    n = 256 // BQ
    mask = jsp.random_block_mask(n, n, 0.4, seed=5, heads=4)
    for rank in range(2):
        out, lse = port(q, k, v, mask, causal=True, head_shard=(rank, 2))
        ref_out, ref_lse = jsp.block_sparse_attention_fwd(
            *map(jnp.asarray, (q, k, v)), mask, causal=True, block_q=BQ,
            block_kv=BKV, head_shard=(rank, 2))
        np.testing.assert_allclose(_np(out), np.asarray(ref_out), **OUT_TOL)
        np.testing.assert_allclose(_np(lse), np.asarray(ref_lse), **OUT_TOL)
        own, own_lse = port(q, k, v, mask[2 * rank:2 * rank + 2], causal=True)
        assert torch.equal(out, own) and torch.equal(lse, own_lse)


# ---------------------------------------------------------------------------
# the raises
# ---------------------------------------------------------------------------


def test_validation_errors(rng):
    """JAX's raises: a mask off the tile grid, a per-head mask of the wrong
    head count, no live tile, a head shard without a global per-head mask,
    ragged blocks, GQA mismatch; and a mask on a device (JAX's traced-mask
    TypeError)."""
    q, k, v = (_t(x) for x in make_qkv(rng, b=1, s=256))
    n = 256 // BQ
    kw = dict(block_q=BQ, block_kv=BKV)
    with pytest.raises(ValueError, match="tile grid"):
        tsp.block_sparse_attention(q, k, v, np.ones((n + 1, n), bool), **kw)
    with pytest.raises(ValueError, match="per-head"):
        tsp.block_sparse_attention(q, k, v, np.ones((3, n, n), bool), **kw)
    with pytest.raises(ValueError, match="no live tiles"):
        tsp.block_sparse_attention(q, k, v, np.zeros((n, n), bool),
                                   causal=True, **kw)
    with pytest.raises(ValueError, match="head_shard"):
        tsp.block_sparse_attention(q, k, v, np.ones((n, n), bool),
                                   head_shard=(0, 2), **kw)
    with pytest.raises(ValueError, match="multiples of the block sizes"):
        tsp.block_sparse_attention(q, k, v, np.ones((3, 3), bool),
                                   block_q=96, block_kv=96)
    with pytest.raises(ValueError, match="not a multiple"):
        tsp.block_sparse_attention(q, k[:, :, :1].expand(-1, -1, 3, -1),
                                   v[:, :, :1].expand(-1, -1, 3, -1),
                                   np.ones((n, n), bool), **kw)
    with pytest.raises(TypeError, match="static host array"):
        tsp.block_sparse_attention(q, k, v, torch.ones((n, n), dtype=torch.bool,
                                                       device="meta"), **kw)


def test_kernel_limits_raise():
    """What the card's kernels do not take raises before any launch: head
    dim other than 128 and block sizes that are not multiples of 64
    (NotImplementedError), operands that are not bf16 (ValueError). Meta
    tensors stand in for CUDA ones; the CPU runs all of these."""
    def qkv(d, dtype=torch.bfloat16):
        return [torch.zeros(shape, dtype=dtype, device="meta")
                for shape in ((1, 256, 4, d), (1, 256, 2, d), (1, 256, 2, d))]

    with pytest.raises(NotImplementedError, match="head_dim"):
        tsp.block_sparse_attention(*qkv(64), np.ones((4, 4), bool),
                                   block_q=64, block_kv=64)
    with pytest.raises(NotImplementedError, match="multiples of 64"):
        tsp.block_sparse_attention(*qkv(128), np.ones((8, 8), bool),
                                   block_q=32, block_kv=32)
    with pytest.raises(ValueError, match="bfloat16"):
        tsp.block_sparse_attention(*qkv(128, torch.float32),
                                   np.ones((4, 4), bool), block_q=64,
                                   block_kv=64)
    cpu = [torch.zeros(t.shape) for t in qkv(64)]
    out = tsp.block_sparse_attention(*cpu, np.ones((8, 8), bool), block_q=32,
                                     block_kv=32)
    assert out.shape == (1, 256, 4, 64)
