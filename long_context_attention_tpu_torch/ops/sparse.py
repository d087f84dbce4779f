"""Block-sparse flash attention over a static tile mask on Hopper: the mask
functions, the live-tile tables, the public API, and its three kernels.

Counterpart of ``long_context_attention_tpu/ops/sparse.py``, with its
names, BSHD layout, kwargs and ``(out, lse fp32)`` contract. The caller
gives a static block-level mask (sliding window, StreamingLLM sinks plus
window, dilated strides, per-head patterns); the host enumerates its live
tiles once per (mask, shapes) and the kernels walk only those. Three kernel
wrappers sit under the API, each with a plain PyTorch version of the same
arithmetic in this module:

* :func:`sparse_fwd` (kernel B9a, ``csrc/flash_fwd_sm90.cu``: the
  wgmma/TMA forward pipeline of B1 and B3 with a walk over the row
  tables): the forward, the TPU's ``_sparse_fwd_kernel``: max-free clamped
  exp2 softmax with scale*log2e folded into q in q's dtype, the in-tile
  causal mask from each tile's global first positions on straddling tiles;
* :func:`sparse_bwd_dq` (kernel B9b, ``csrc/flash_dq_sm90.cu``: a
  wgmma/TMA dq pipeline with the same walk): dq over the row-major live
  set, the TPU's ``_sparse_dq_kernel``;
* :func:`sparse_bwd_dkv` (kernel B9c, ``csrc/flash_bwd_sm90.cu``: the
  wgmma/TMA pipeline of B2b with a walk over the column tables): dk and dv
  over the column-major live set with the GQA group folded into each kv
  column, the TPU's ``_sparse_dkv_kernel``.

Every kernel runs one persistent block per SM over items listed on the
host, longest walk first, and dealt to the blocks (greedy, to the least
loaded): 128 q rows of a mask row for B9a and B9b, which share one list and
one deal (:meth:`SparsePlan.row_items`, ``row_schedule``), and 128 kv rows
of a mask column for B9c (``dkv_items``, ``dkv_schedule``).

The tables are JAX's (``_row_tables``, ``_col_tables``), built here in the
same order; the kernels read them in a CSR form, one ``[start, end)`` range
of live entries per (head or 0, q tile) or (kv head or 0, kv tile),
uploaded once per device (:class:`SparsePlan`). A row with no live tile
gives out 0 and lse -inf (the merge identity), as in JAX. JAX pads every
rank's tables to one length because ``shard_map`` traces one program, and
bounds them by the TPU's scalar memory; here each rank builds only its own
tables, and neither applies.

:func:`block_sparse_attention` is differentiable: a
``torch.autograd.Function`` whose backward is B9b then B9c, with delta =
rowsum(out * dout) and the -inf-safe lse computed in torch, as the JAX
host code does (``_sparse_bwd_bhsd``). A wrapper given CPU tensors runs
its plain version; given CUDA tensors it launches its kernel or raises. The kernels take head_dim 128
and block sizes that are multiples of 64; other shapes raise
``NotImplementedError`` on the card and run on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from long_context_attention_tpu_torch.ops import _build
from long_context_attention_tpu_torch.ops.flash import (
    _CLAMP,
    _LOG2E,
    _check_cuda_operand,
    _fold,
)
from long_context_attention_tpu_torch.utils.config import NEG_INF

__all__ = [
    "block_sparse_attention",
    "block_sparse_attention_fwd",
    "sliding_window_block_mask",
    "global_local_block_mask",
    "strided_block_mask",
    "random_block_mask",
    "causal_block_mask",
    "mask_density",
    "SparsePlan",
    "sparse_fwd",
    "sparse_fwd_plain",
    "sparse_bwd_dq",
    "sparse_bwd_dq_plain",
    "sparse_bwd_dkv",
    "sparse_bwd_dkv_plain",
    "sparse_bwd_operands",
    "sparse_bwd",
]

# flag bits of a table entry (the JAX package's)
_F_FIRST = 1   # this step starts a fresh accumulator (new output row/column)
_F_LAST = 2    # this step emits the accumulator
_F_MASKED = 4  # tile straddles the causal diagonal: apply the in-tile mask
_F_DEAD = 8    # FIRST|LAST|DEAD: a row or column with no live tile

_KERNEL_BLOCK = 64  # the kernels' sub-tile: block sizes must be multiples
# rows of an item (B9a, B9b: q rows; B9c: kv rows), and kv columns of a B9a
# or B9b step (csrc/sm90.cuh kRowStep, flash_bwd_sm90.cu BKV)
_ITEM_ROWS = 128
# the schedules: an item's cost in its steps plus this much for its loads
# once per item and its write-out (B9c: 64-row q steps; B9a, B9b:
# 128-column kv steps)
_DKV_ITEM_COST = 2
_ROW_ITEM_COST = 2
# tiles of the walked side the plain versions take at once (their memory)
_PLAIN_TILES = 16


# ---------------------------------------------------------------------------
# Tile masks (host-side numpy; tile granularity)
# ---------------------------------------------------------------------------


def causal_block_mask(n_q: int, n_kv: int) -> np.ndarray:
    """Lower-triangular tile mask (block_q == block_kv assumed by callers)."""
    return np.tril(np.ones((n_q, n_kv), dtype=bool), k=n_kv - n_q)


def sliding_window_block_mask(n_q: int, n_kv: int, window_tiles: int) -> np.ndarray:
    """Band mask: tile (i, j) live when |i - j| < window_tiles (plus the
    diagonal)."""
    i = np.arange(n_q)[:, None]
    j = np.arange(n_kv)[None, :]
    return np.abs(i - (j - (n_kv - n_q))) < window_tiles


def global_local_block_mask(
    n_q: int, n_kv: int, window_tiles: int, sink_tiles: int = 1
) -> np.ndarray:
    """StreamingLLM / Longformer shape: a local band plus always-attended
    leading "sink" tiles (attention sinks, arXiv:2309.17453)."""
    m = sliding_window_block_mask(n_q, n_kv, window_tiles)
    m[:, :sink_tiles] = True
    return m


def strided_block_mask(n_q: int, n_kv: int, stride: int, local_tiles: int = 1) -> np.ndarray:
    """Dilated pattern: every ``stride``-th kv tile globally, plus a local
    band of ``local_tiles`` (BigBird/dilated-attention shape)."""
    i = np.arange(n_q)[:, None]
    j = np.arange(n_kv)[None, :]
    return (j % stride == 0) | (np.abs(i - (j - (n_kv - n_q))) < local_tiles)


def random_block_mask(
    n_q: int, n_kv: int, density: float, seed: int = 0, heads: Optional[int] = None
) -> np.ndarray:
    """Random tile mask at the given density with a guaranteed diagonal
    (test/benchmark helper)."""
    rng = np.random.default_rng(seed)
    shape = (n_q, n_kv) if heads is None else (heads, n_q, n_kv)
    m = rng.random(shape) < density
    diag = np.arange(min(n_q, n_kv))
    m[..., diag + (n_q - min(n_q, n_kv)), diag + (n_kv - min(n_q, n_kv))] = True
    return m


def mask_density(block_mask: np.ndarray, causal: bool = False) -> float:
    """Fraction of live tiles (after causal intersection) over the full grid."""
    m = np.asarray(block_mask, dtype=bool)
    n_q, n_kv = m.shape[-2:]
    if causal:
        m = m & causal_block_mask(n_q, n_kv)
    return float(m.sum() / (np.prod(m.shape[:-2], initial=1) * n_q * n_kv))


# ---------------------------------------------------------------------------
# Host-side live-tile tables (the JAX package's, entry for entry)
# ---------------------------------------------------------------------------


def _normalize_mask(block_mask, h: int, n_q: int, n_kv: int, causal: bool,
                    bq: int, bkv: int):
    """Validate + expand the mask; returns (mask (H, n_q, n_kv), per_head,
    straddle (n_q, n_kv) bool of causal-diagonal tiles)."""
    m = np.asarray(block_mask)
    if m.dtype != np.bool_:
        m = m != 0
    if m.ndim == 2:
        per_head = False
        if m.shape != (n_q, n_kv):
            raise ValueError(
                f"block_mask shape {m.shape} != tile grid ({n_q}, {n_kv}) "
                f"(block_q={bq}, block_kv={bkv})")
        mh = m[None]
    elif m.ndim == 3:
        per_head = True
        if m.shape != (h, n_q, n_kv):
            raise ValueError(
                f"per-head block_mask shape {m.shape} != ({h}, {n_q}, {n_kv})")
        mh = m
    else:
        raise ValueError("block_mask must be (n_q, n_kv) or (h, n_q, n_kv)")

    # Causal tile classification against *global* positions (q row i covers
    # tokens [i*bq, i*bq+bq), kv col j covers [j*bkv, j*bkv+bkv);
    # bottom-aligned when s_q != s_kv, like the dense kernel's oracle).
    q_first = np.arange(n_q)[:, None] * bq + (n_kv * bkv - n_q * bq)
    q_last = q_first + bq - 1
    kv_first = np.arange(n_kv)[None, :] * bkv
    kv_last = kv_first + bkv - 1
    if causal:
        reach = kv_first <= q_last           # tile has >=1 causal element
        straddle = reach & (kv_last > q_first)  # needs the in-tile mask
        mh = mh & reach
    else:
        straddle = np.zeros((n_q, n_kv), dtype=bool)
    return mh, per_head, straddle


def _row_tables(mh: np.ndarray, straddle: np.ndarray, per_head: bool,
                q_first=None, kv_first=None, bq: int = 0, bkv: int = 0,
                shift: int = 0):
    """Row-major live-tile enumeration (forward + dq): steps ordered by
    (head, q-tile), kv inner. Returns (ih, iq, ik, flags, qf, kf) int32
    tables; qf/kf are the tile's global first positions (from the layout
    for ring shards). A fully-masked q row gets one FIRST|LAST|DEAD entry."""
    H, n_q, n_kv = mh.shape
    n_heads = H if per_head else 1
    if q_first is None:
        q_first = np.arange(n_q) * bq + shift
    if kv_first is None:
        kv_first = np.arange(n_kv) * bkv
    ih_l, iq_l, ik_l, fl_l, qf_l, kf_l = [], [], [], [], [], []

    def emit(ih, iq, ik, f):
        ih_l.append(ih)
        iq_l.append(iq)
        ik_l.append(int(ik))
        fl_l.append(f)
        qf_l.append(int(q_first[iq]))
        kf_l.append(int(kv_first[ik]))

    for ih in range(n_heads):
        for iq in range(n_q):
            live = np.flatnonzero(mh[ih, iq])
            if live.size == 0:
                emit(ih, iq, 0, _F_FIRST | _F_LAST | _F_DEAD)
                continue
            for pos, ik in enumerate(live):
                f = 0
                if pos == 0:
                    f |= _F_FIRST
                if pos == live.size - 1:
                    f |= _F_LAST
                if straddle[iq, ik]:
                    f |= _F_MASKED
                emit(ih, iq, ik, f)
    return tuple(np.asarray(t, np.int32)
                 for t in (ih_l, iq_l, ik_l, fl_l, qf_l, kf_l))


def _col_tables(mh: np.ndarray, straddle: np.ndarray, per_head: bool, g: int,
                q_first=None, kv_first=None, bq: int = 0, bkv: int = 0,
                shift: int = 0):
    """Column-major enumeration (dk/dv): steps ordered by (kv-head, kv-tile),
    with the GQA group x q-tile inner (in that order: the fp32 sums follow
    it). Returns (ihk, ig, iq, ik, flags, qf, kf) int32 tables; a fully
    masked kv column gets a FIRST|LAST|DEAD entry."""
    H, n_q, n_kv = mh.shape
    hk = (H // g) if per_head else 1
    if q_first is None:
        q_first = np.arange(n_q) * bq + shift
    if kv_first is None:
        kv_first = np.arange(n_kv) * bkv
    ihk_l, ig_l, iq_l, ik_l, fl_l, qf_l, kf_l = [], [], [], [], [], [], []

    def emit(ihk, ig, iq, ik, f):
        ihk_l.append(ihk)
        ig_l.append(ig)
        iq_l.append(iq)
        ik_l.append(ik)
        fl_l.append(f)
        qf_l.append(int(q_first[iq]))
        kf_l.append(int(kv_first[ik]))

    for ihk in range(hk):
        for ik in range(n_kv):
            steps = []
            for ig in range(g):
                ih = (ihk * g + ig) if per_head else 0
                for iq in np.flatnonzero(mh[ih, :, ik]):
                    steps.append((ig, int(iq)))
            if not steps:
                emit(ihk, 0, 0, ik, _F_FIRST | _F_LAST | _F_DEAD)
                continue
            for pos, (ig, iq) in enumerate(steps):
                f = 0
                if pos == 0:
                    f |= _F_FIRST
                if pos == len(steps) - 1:
                    f |= _F_LAST
                if straddle[iq, ik]:
                    f |= _F_MASKED
                emit(ihk, ig, iq, ik, f)
    return tuple(np.asarray(t, np.int32)
                 for t in (ihk_l, ig_l, iq_l, ik_l, fl_l, qf_l, kf_l))


def _csr(keys, n_rows: int, flags, fields):
    """(ptr (n_rows + 1,), entries (n, 4)) int32 of a table's live entries,
    grouped by ``keys`` in table order (DEAD entries dropped)."""
    live = (flags & _F_DEAD) == 0
    ptr = np.zeros(n_rows + 1, np.int32)
    ptr[1:] = np.cumsum(np.bincount(keys[live], minlength=n_rows))
    ent = np.stack([f[live] for f in fields], axis=1).astype(np.int32)
    return ptr, ent.reshape(-1, 4)


@dataclasses.dataclass(frozen=True, eq=False)
class SparsePlan:
    """The live tiles of one sparse call: ``mh`` (H, n_q, n_kv) bool (H the
    mask's heads, or 1 for a shared mask) after the causal cut, ``straddle``
    (n_q, n_kv) the tiles that need the in-tile causal mask, and each
    tile's global first position (``q_first`` (n_q,), ``kv_first``
    (n_kv,)). The plain versions read these; the kernels read the CSR form
    of the JAX tables (:meth:`csr`), uploaded once per device."""

    mh: np.ndarray
    straddle: np.ndarray
    q_first: np.ndarray
    kv_first: np.ndarray
    per_head: bool
    g: int
    bq: int
    bkv: int
    _on_device: Dict[str, Tuple[torch.Tensor, ...]] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def n_q(self) -> int:
        return self.mh.shape[1]

    @property
    def n_kv(self) -> int:
        return self.mh.shape[2]

    def row_tables(self):
        return _row_tables(self.mh, self.straddle, self.per_head,
                           q_first=self.q_first, kv_first=self.kv_first)

    def col_tables(self):
        return _col_tables(self.mh, self.straddle, self.per_head, self.g,
                           q_first=self.q_first, kv_first=self.kv_first)

    def csr(self, device) -> Tuple[torch.Tensor, ...]:
        """(row_ptr, row_ent, col_ptr, col_ent) int32 on ``device``. A row
        (head or 0, q tile) lists (kv tile, flags, q_first, kv_first); a
        column (kv head or 0, kv tile) lists (group index << 4 | flags, q
        tile, q_first, kv_first)."""
        def make():
            ih, iq, ik, fl, qf, kf = self.row_tables()
            heads = self.mh.shape[0] if self.per_head else 1
            row = _csr(ih * self.n_q + iq, heads * self.n_q, fl,
                       (ik, fl, qf, kf))
            ihk, ig, iqc, ikc, flc, qfc, kfc = self.col_tables()
            col = _csr(ihk * self.n_kv + ikc, (heads // self.g if
                                               self.per_head else 1)
                       * self.n_kv, flc, ((ig << 4) | flc, iqc, qfc, kfc))
            return (*row, *col)
        return self._cached("csr", device, make)

    def _cached(self, key: str, device, make):
        """make()'s numpy arrays, or (device given) tensors on the device,
        uploaded once."""
        if device is None:
            return make()
        key = f"{key} {device}"
        if key not in self._on_device:
            arrays = make()
            self._on_device[key] = (
                torch.from_numpy(arrays).to(device)
                if isinstance(arrays, np.ndarray)
                else tuple(torch.from_numpy(a).to(device) for a in arrays))
        return self._on_device[key]

    def row_items(self, device=None):
        """B9a's and B9b's items, longest walk first: (n, 4) int32 rows of
        (row, first q row in its q tile, steps, 0), one per row (head or 0,
        q tile) and 128-row offset, in a stable order of falling steps; a
        row with no live tile is listed with 0 steps (its rows write out 0,
        lse -inf and dq 0). An item's steps are, for each live entry of its
        row, its block_kv / 128 kv steps (rounded up) less, on a straddling
        tile, those wholly above the diagonal for the item's rows (their
        first kv position after the item's last q position). The kernels
        repeat item i over the batch rows and, for a mask shared by the
        heads, the heads: work item t is item t // r with r = b (per-head
        mask; the row's head) or b * h (head (t % r) // b), batch row t % r
        % b (:meth:`row_schedule` deals them to the blocks). A numpy array,
        or a tensor on ``device`` (cached)."""
        def make():
            ih, iq, ik, fl, qf, kf = self.row_tables()
            heads = self.mh.shape[0] if self.per_head else 1
            live = (fl & _F_DEAD) == 0
            subs = np.arange(0, self.bq, _ITEM_ROWS)
            rows = np.minimum(_ITEM_ROWS, self.bq - subs)
            n_steps = -(-self.bkv // _ITEM_ROWS)
            last = (qf[live, None].astype(np.int64) + subs[None, :]
                    + rows[None, :] - 1 - kf[live, None])
            steps = np.where((fl[live, None] & _F_MASKED) != 0,
                             np.clip(last // _ITEM_ROWS + 1, 0, n_steps),
                             n_steps)
            return _longest_first((ih * self.n_q + iq)[live], steps,
                                  heads * self.n_q)
        return self._cached("row_items", device, make)

    def dkv_items(self, device=None):
        """B9c's items, longest walk first: (n, 4) int32 rows of (column,
        first row in its kv tile, steps, 0), one per column (kv head or 0,
        kv tile) and 128-row offset, in a stable order of falling steps. An
        item's steps are, for each live entry of its column, its block_q /
        64 q sub-tiles less, on a straddling tile, those wholly above the
        diagonal (their last q position before the item's first kv
        position). The kernel repeats item i over the batch rows and, for a
        mask shared by the heads, the kv heads: its work item t is item t //
        r with r = b (per-head mask; the column's kv head) or b * h_kv (kv
        head (t % r) // b), batch row t % r % b (:meth:`dkv_schedule` deals
        them to the blocks). A numpy array, or a tensor on ``device``
        (cached)."""
        def make():
            ihk, _, _, ik, fl, qf, kf = self.col_tables()
            heads = self.mh.shape[0] // self.g if self.per_head else 1
            live = (fl & _F_DEAD) == 0
            subs = np.arange(0, self.bkv, _ITEM_ROWS)
            # q sub-tiles j < lo end before the item's first kv position
            gap = (kf[live, None].astype(np.int64) + subs[None, :]
                   - qf[live, None] - (_KERNEL_BLOCK - 1))
            lo = np.where((fl[live, None] & _F_MASKED) != 0,
                          np.clip(-(-gap // _KERNEL_BLOCK), 0, None), 0)
            steps = np.clip(self.bq // _KERNEL_BLOCK - lo, 0, None)
            return _longest_first((ihk * self.n_kv + ik)[live], steps,
                                  heads * self.n_kv)
        return self._cached("dkv_items", device, make)

    def row_schedule(self, b: int, h: int, n_blocks: int, device=None):
        """B9a's and B9b's work items (:meth:`row_items`, repeated over b
        batch rows and, for a shared mask, h heads) dealt to at most
        ``n_blocks`` persistent blocks, as :meth:`dkv_schedule` deals
        B9c's."""
        reps = b if self.per_head else b * h
        return self._cached(
            f"row_schedule {b} {h} {n_blocks}", device,
            lambda: _deal(self.row_items()[:, 2], reps, n_blocks,
                          _ROW_ITEM_COST))

    def dkv_schedule(self, b: int, h_kv: int, n_blocks: int, device=None):
        """B9c's work items (:meth:`dkv_items`, repeated over b batch rows
        and, for a shared mask, h_kv kv heads) dealt to at most
        ``n_blocks`` persistent blocks: (ptr (blocks + 1,), work (n,))
        int32, block i running work[ptr[i]:ptr[i + 1]] in that order.
        Longest first, each item goes to the block with the least work so
        far, its steps plus _DKV_ITEM_COST (greedy list scheduling: no block
        ends more than one item's work after the average). Numpy arrays, or
        tensors on ``device`` (cached)."""
        reps = b if self.per_head else b * h_kv
        return self._cached(
            f"dkv_schedule {b} {h_kv} {n_blocks}", device,
            lambda: _deal(self.dkv_items()[:, 2], reps, n_blocks,
                          _DKV_ITEM_COST))


def _longest_first(keys, steps, n_keys: int) -> np.ndarray:
    """(n_keys * subs, 4) int32 items (key, sub-tile offset, steps, 0), in
    a stable order of falling steps: ``steps`` (entries, subs) holds each
    live table entry's steps per 128-row sub-tile of its key (row or
    column), summed here per key."""
    total = np.zeros((n_keys, steps.shape[1]), np.int64)
    np.add.at(total, keys, steps)
    flat = total.reshape(-1)
    order = np.argsort(-flat, kind="stable")
    key, sub = np.divmod(order, steps.shape[1])
    return np.stack([key, sub * _ITEM_ROWS, flat[order],
                     np.zeros_like(key)], axis=1).astype(np.int32)


def _deal(steps, reps: int, n_blocks: int, item_cost: int):
    """(ptr, work) int32: the work items (each item's ``steps``, in order,
    repeated ``reps`` times) dealt to at most ``n_blocks`` blocks, longest
    first, each to the block with the least work so far (its steps plus
    ``item_cost``); block i runs work[ptr[i]:ptr[i + 1]] in that order."""
    cost = np.repeat(np.asarray(steps, np.int64), reps) + item_cost
    blocks = max(min(n_blocks, cost.size), 1)
    heap = [(0, i) for i in range(blocks)]
    owner = np.empty(cost.size, np.int64)
    for t, c in enumerate(cost.tolist()):
        load, i = heapq.heappop(heap)
        owner[t] = i
        heapq.heappush(heap, (load + c, i))
    ptr = np.zeros(blocks + 1, np.int32)
    ptr[1:] = np.cumsum(np.bincount(owner, minlength=blocks))
    return ptr, np.argsort(owner, kind="stable").astype(np.int32)


@functools.lru_cache(maxsize=None)
def _plan(mask_key: bytes, mask_shape, h: int, n_q: int, n_kv: int,
          causal: bool, bq: int, bkv: int, g: int, rank: int,
          n_ranks: int) -> SparsePlan:
    """The plan of one call, cached by the mask's bytes and the shapes (the
    JAX package's ``_make_sparse_op`` cache). ``n_ranks > 1``: the 3-D
    mask covers ``h * n_ranks`` global heads, and this call's heads are
    block ``rank`` (the ulysses all-to-all hands rank r heads [r*h,
    (r+1)*h))."""
    mask = np.frombuffer(mask_key, dtype=np.bool_).reshape(mask_shape)
    if n_ranks > 1:
        mh, _, straddle = _normalize_mask(mask[rank * h:(rank + 1) * h], h,
                                          n_q, n_kv, causal, bq, bkv)
        per_head, any_live = True, mask.any()
    else:
        mh, per_head, straddle = _normalize_mask(mask, h, n_q, n_kv, causal,
                                                 bq, bkv)
        any_live = mh.any()
    if not any_live:
        raise ValueError("block_mask has no live tiles")
    shift = n_kv * bkv - n_q * bq
    return SparsePlan(mh=mh, straddle=straddle,
                      q_first=np.arange(n_q) * bq + shift,
                      kv_first=np.arange(n_kv) * bkv, per_head=per_head,
                      g=g, bq=bq, bkv=bkv)


# ---------------------------------------------------------------------------
# Plain versions (one q tile or kv column at a time, its live tiles only)
# ---------------------------------------------------------------------------


def _chunks(tiles: np.ndarray):
    for i in range(0, tiles.size, _PLAIN_TILES):
        yield tiles[i:i + _PLAIN_TILES]


def _tokens(tiles: np.ndarray, block: int, device) -> torch.Tensor:
    """Token indices of the given tiles, in tile order."""
    idx = np.add.outer(tiles * block, np.arange(block)).reshape(-1)
    return torch.from_numpy(idx).to(device)


def _drop(plan: SparsePlan, iqs, iks, device) -> torch.Tensor:
    """(H, len(iqs) * bq, len(iks) * bkv) bool, True where a score is
    dropped: a dead tile of the head, or a column past its row on a
    straddling tile (global first positions, as the kernels compare)."""
    iqs, iks = np.asarray(iqs), np.asarray(iks)
    bq, bkv = plan.bq, plan.bkv
    live = torch.from_numpy(plan.mh[:, iqs][:, :, iks]).to(device)
    live = live.repeat_interleave(bq, 1).repeat_interleave(bkv, 2)
    strad = torch.from_numpy(plan.straddle[np.ix_(iqs, iks)]).to(device)
    strad = strad.repeat_interleave(bq, 0).repeat_interleave(bkv, 1)
    rows = torch.from_numpy(
        np.add.outer(plan.q_first[iqs], np.arange(bq)).reshape(-1)).to(device)
    cols = torch.from_numpy(
        np.add.outer(plan.kv_first[iks], np.arange(bkv)).reshape(-1)).to(device)
    return ~live | (strad & (cols[None, :] > rows[:, None]))[None]


def sparse_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     plan: SparsePlan, *, scale: float):
    """Plain version of kernel B9a (the same arithmetic, one q tile at a
    time over its live kv tiles).

    q (b, s_q, h, d); k, v (b, s_kv, h_kv, d) -> out (b, s_q, h, d) in q's
    dtype, lse (b, h, s_q) fp32. q is folded by scale*log2e in its own
    dtype, s = q . k in fp32, dropped scores -1e30, p = exp2(min(s, 90)), l
    = rowsum(p), acc = bf16(p) @ v (p cast to v's dtype); out = acc / l, lse
    = ln l, and a row with l == 0 gives out 0, lse -inf."""
    b, s_q, h, d = q.shape
    g = h // k.shape[2]
    bq = plan.bq
    qf = _fold(q, scale)
    out = torch.zeros_like(q)
    lse = torch.full((b, h, s_q), -math.inf, dtype=torch.float32,
                     device=q.device)
    for iq in range(plan.n_q):
        tiles = np.flatnonzero(plan.mh[:, iq].any(0))
        if tiles.size == 0:
            continue
        rows = slice(iq * bq, (iq + 1) * bq)
        qt = qf[:, rows].float()
        l = torch.zeros((b, h, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, bq, d), dtype=torch.float32, device=q.device)
        for part in _chunks(tiles):
            cols = _tokens(part, plan.bkv, q.device)
            kt = k[:, cols].float().repeat_interleave(g, dim=2)
            vt = v[:, cols].float().repeat_interleave(g, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", qt, kt)
            s.masked_fill_(_drop(plan, [iq], part, q.device), NEG_INF)
            p = s.clamp_(max=_CLAMP).exp2_()  # exp2(-1e30) == 0
            l += p.sum(dim=-1)
            acc += torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vt)
        dead = l == 0.0
        safe_l = torch.where(dead, torch.ones_like(l), l)
        o = torch.where(dead[..., None], torch.zeros_like(acc),
                        acc / safe_l[..., None])
        out[:, rows] = o.to(q.dtype).transpose(1, 2)
        lse[:, :, rows] = torch.where(dead, torch.full_like(l, -math.inf),
                                      torch.log(safe_l))
    return out, lse


def sparse_bwd_dq_plain(q, k, v, dout, lse, delta, plan: SparsePlan, *,
                        scale: float):
    """Plain version of kernel B9b: dq (b, s_q, h, d) fp32 over each q
    tile's live kv tiles. s = (q . k) * scale from the raw q, dropped
    scores -1e30, p = exp(s - lse) (``lse`` -inf-safe: +1e30 on dead rows),
    ds = p * (dp - delta), dq += scale * bf16(ds) @ k (ds cast to k's
    dtype). lse and delta are (b, h, s_q) fp32."""
    b, s_q, h, d = q.shape
    g = h // k.shape[2]
    bq = plan.bq
    dq = torch.zeros((b, s_q, h, d), dtype=torch.float32, device=q.device)
    for iq in range(plan.n_q):
        tiles = np.flatnonzero(plan.mh[:, iq].any(0))
        if tiles.size == 0:
            continue
        rows = slice(iq * bq, (iq + 1) * bq)
        qt, dot = q[:, rows].float(), dout[:, rows].float()
        lr, dr = lse[:, :, rows, None], delta[:, :, rows, None]
        acc = torch.zeros((b, h, bq, d), dtype=torch.float32, device=q.device)
        for part in _chunks(tiles):
            cols = _tokens(part, plan.bkv, q.device)
            kt = k[:, cols].float().repeat_interleave(g, dim=2)
            vt = v[:, cols].float().repeat_interleave(g, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", qt, kt).mul_(scale)
            s.masked_fill_(_drop(plan, [iq], part, q.device), NEG_INF)
            p = s.sub_(lr).exp_()
            ds = torch.einsum("bqhd,bkhd->bhqk", dot, vt).sub_(dr).mul_(p)
            acc += scale * torch.einsum("bhqk,bkhd->bhqd",
                                        ds.to(k.dtype).float(), kt)
        dq[:, rows] = acc.transpose(1, 2)
    return dq


def sparse_bwd_dkv_plain(q, k, v, dout, lse, delta, plan: SparsePlan, *,
                         scale: float):
    """Plain version of kernel B9c: dk, dv (b, s_kv, h_kv, d) fp32 over
    each kv tile's live q tiles, summed over the kv head's query heads: dv
    += bf16(p)^T @ dout (p cast to dout's dtype), dk += scale * bf16(ds)^T
    @ q (ds cast to q's dtype), with p and ds as in
    :func:`sparse_bwd_dq_plain`."""
    b, s_kv, h_kv, d = k.shape
    h = q.shape[2]
    g = h // h_kv
    bkv = plan.bkv
    dk = torch.zeros((b, s_kv, h_kv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for ik in range(plan.n_kv):
        tiles = np.flatnonzero(plan.mh[:, :, ik].any(0))
        if tiles.size == 0:
            continue
        cols = slice(ik * bkv, (ik + 1) * bkv)
        kt = k[:, cols].float().repeat_interleave(g, dim=2)
        vt = v[:, cols].float().repeat_interleave(g, dim=2)
        acc_k = torch.zeros((b, h, bkv, d), dtype=torch.float32,
                            device=q.device)
        acc_v = torch.zeros_like(acc_k)
        for part in _chunks(tiles):
            rows = _tokens(part, plan.bq, q.device)
            qt, dot = q[:, rows].float(), dout[:, rows].float()
            lr, dr = lse[:, :, rows, None], delta[:, :, rows, None]
            s = torch.einsum("bqhd,bkhd->bhqk", qt, kt).mul_(scale)
            s.masked_fill_(_drop(plan, part, [ik], q.device), NEG_INF)
            p = s.sub_(lr).exp_()
            acc_v += torch.einsum("bhqk,bqhd->bhkd", p.to(dout.dtype).float(),
                                  dot)
            ds = torch.einsum("bqhd,bkhd->bhqk", dot, vt).sub_(dr).mul_(p)
            acc_k += scale * torch.einsum("bhqk,bqhd->bhkd",
                                          ds.to(q.dtype).float(), qt)
        dk[:, cols] = acc_k.reshape(b, h_kv, g, bkv, d).sum(2).transpose(1, 2)
        dv[:, cols] = acc_v.reshape(b, h_kv, g, bkv, d).sum(2).transpose(1, 2)
    return dk, dv


# ---------------------------------------------------------------------------
# Kernel wrappers: B9a, B9b, B9c
# ---------------------------------------------------------------------------


def _check_shapes(q, k, v, plan: SparsePlan) -> None:
    b, s_q, h, d = q.shape
    if (k.dim() != 4 or k.shape[0] != b or k.shape[3] != d
            or v.shape != k.shape or h % k.shape[2]):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if (s_q != plan.n_q * plan.bq or k.shape[1] != plan.n_kv * plan.bkv
            or h // k.shape[2] != plan.g
            or (plan.per_head and plan.mh.shape[0] != h)):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)} do "
                         f"not match the plan's tile grid")


def _launch(kernel: str, q, k, v, plan: SparsePlan, *, scale: float,
            dout=None, lse=None, delta=None, out=None, out_lse=None,
            dk=None, dv=None) -> None:
    """Check a sparse kernel's operands and launch it on the current
    stream; the outputs are buffers made by the caller."""
    kern = _build.kernel(kernel, q.shape[3], "sparse")
    if plan.bq % _KERNEL_BLOCK or plan.bkv % _KERNEL_BLOCK:
        raise NotImplementedError(
            f"the sparse kernels take block sizes that are multiples of "
            f"{_KERNEL_BLOCK}, got ({plan.bq}, {plan.bkv})")
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        if t is not None:
            _check_cuda_operand(name, t, torch.bfloat16, q.device)
    b, s_q, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.shape != (b, h, s_q) or t.dtype != torch.float32
                              or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 (b, h, s_q) on "
                             f"{q.device}")

    def strides(t):
        return t.stride()[:3] if t is not None else (0, 0, 0)

    row_ptr, row_ent, col_ptr, col_ent = plan.csr(q.device)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    if kernel == "sparse_bwd_dkv":  # the column walk
        items = plan.dkv_items(q.device)
        sched = plan.dkv_schedule(b, k.shape[2], sms, q.device)
        operands = (dk, dv, col_ptr, col_ent)
        floats = (scale,)
    else:  # B9a, B9b: the row walk
        items = plan.row_items(q.device)
        sched = plan.row_schedule(b, h, sms, q.device)
        operands = (out, out_lse, row_ptr, row_ent)
        floats = (scale * _LOG2E, scale)
    dims = [b, h, k.shape[2], s_q, k.shape[1], *strides(q), *strides(k),
            *strides(v), *strides(dout), *strides(out), *strides(dk),
            plan.n_q, plan.n_kv, plan.bq, plan.bkv, int(plan.per_head),
            items.shape[0], sched[0].shape[0] - 1]
    kern(
        *(_build.ptr(t) for t in (q, k, v, dout, lse, delta, *operands,
                                  items, *sched)),
        _build.dims_array(dims), *floats, _build.stream_ptr(q.device))


def sparse_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               plan: SparsePlan, *, scale: float):
    """Kernel B9a wrapper: q (b, s_q, h, d) bf16, k, v (b, s_kv, h_kv, d)
    bf16 (read by strides) -> out (b, s_q, h, d) bf16, lse (b, h, s_q)
    fp32. One persistent block per SM takes its share of the plan's row
    items (:meth:`SparsePlan.row_schedule`), 128 q rows of a mask row each,
    and walks the row's live kv tiles in 128-column steps. CPU tensors take
    :func:`sparse_fwd_plain`."""
    _check_shapes(q, k, v, plan)
    if q.device.type == "cpu":
        return sparse_fwd_plain(q, k, v, plan, scale=scale)
    b, s_q, h, d = q.shape
    out = torch.empty((b, s_q, h, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    _launch("sparse_fwd", q, k, v, plan, scale=scale, out=out, out_lse=lse)
    return out, lse


def sparse_bwd_dq(q, k, v, dout, lse, delta, plan: SparsePlan, *,
                  scale: float):
    """Kernel B9b wrapper: dq (b, s_q, h, d) fp32 of bf16 q, k, v, dout
    with the -inf-safe lse and delta ((b, h, s_q) fp32, contiguous). One
    persistent block per SM takes its share of B9a's row items and walks
    each row's live tiles as B9a does; each item owns its rows and writes
    them once (no atomics: deterministic). CPU tensors take
    :func:`sparse_bwd_dq_plain`."""
    _check_shapes(q, k, v, plan)
    if q.device.type == "cpu":
        return sparse_bwd_dq_plain(q, k, v, dout, lse, delta, plan,
                                   scale=scale)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("sparse_bwd_dq", q, k, v, plan, scale=scale, dout=dout, lse=lse,
            delta=delta, out=dq)
    return dq


def sparse_bwd_dkv(q, k, v, dout, lse, delta, plan: SparsePlan, *,
                   scale: float):
    """Kernel B9c wrapper: dk, dv (b, s_kv, h_kv, d) fp32. One persistent
    block per SM takes its share of the plan's items
    (:meth:`SparsePlan.dkv_schedule`), 128 kv rows of a column each, and
    walks the column's live (group head, q tile) entries in 64-row q steps;
    each item owns its rows (no atomics: deterministic). CPU tensors take
    :func:`sparse_bwd_dkv_plain`."""
    _check_shapes(q, k, v, plan)
    if q.device.type == "cpu":
        return sparse_bwd_dkv_plain(q, k, v, dout, lse, delta, plan,
                                    scale=scale)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    _launch("sparse_bwd_dkv", q, k, v, plan, scale=scale, dout=dout, lse=lse,
            delta=delta, dk=dk, dv=dv)
    return dk, dv


def sparse_bwd_operands(out, lse, dout, dtype):
    """(dout in ``dtype``, the -inf-safe lse, delta) of the backward
    kernels, in torch as in the JAX host code ``_sparse_bwd_bhsd``: lse -inf
    (a dead row) becomes +1e30, so p == 0 there; delta = rowsum(out *
    dout), (b, h, s_q) fp32."""
    dout = dout.to(dtype).contiguous()
    lse_safe = torch.where(torch.isfinite(lse), lse,
                           torch.full_like(lse, -NEG_INF)).contiguous()
    delta = (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()
    return dout, lse_safe, delta


def sparse_bwd(q, k, v, out, lse, dout, plan: SparsePlan, *, scale: float):
    """fp32 (dq, dk, dv) of B9b and B9c."""
    ops = sparse_bwd_operands(out, lse, dout, q.dtype)
    dq = sparse_bwd_dq(q, k, v, *ops, plan, scale=scale)
    dk, dv = sparse_bwd_dkv(q, k, v, *ops, plan, scale=scale)
    return dq, dk, dv


class _SparseAttention(torch.autograd.Function):
    """(out, lse) of B9a; the backward is B9b then B9c. No gradient flows
    through the lse output (as in JAX)."""

    @staticmethod
    def forward(ctx, q, k, v, plan, scale):
        out, lse = sparse_fwd(q, k, v, plan, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.plan, ctx.scale = plan, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = sparse_bwd(q, k, v, out, lse, dout, ctx.plan,
                                scale=ctx.scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


# ---------------------------------------------------------------------------
# Public API (the JAX package's names and kwargs)
# ---------------------------------------------------------------------------


def _host_mask(block_mask) -> np.ndarray:
    if isinstance(block_mask, torch.Tensor):
        if block_mask.device.type != "cpu":
            raise TypeError("block_mask must be a static host array, not a "
                            f"tensor on {block_mask.device}")
        block_mask = block_mask.numpy()
    return np.ascontiguousarray(np.asarray(block_mask, dtype=np.bool_))


def block_sparse_attention_fwd(q, k, v, block_mask, **kw):
    """Forward-only entry: returns ``(out, lse)`` (ring-merge contract)."""
    kw["return_lse"] = True
    return block_sparse_attention(q, k, v, block_mask, **kw)


def block_sparse_attention(
    q: torch.Tensor,   # (b, s_q, h, d)
    k: torch.Tensor,   # (b, s_kv, h_kv, d)
    v: torch.Tensor,   # (b, s_kv, h_kv, d)
    block_mask,        # static bool array (n_q, n_kv) or (h, n_q, n_kv)
    *,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    block_q: int = 512,
    block_kv: int = 512,
    return_lse: bool = False,
    interpret: Optional[bool] = None,
    head_shard=None,
):
    """Block-sparse flash attention over a static tile mask (True = attend).

    ``block_mask`` is tile-granular: entry (i, j) gates the (block_q x
    block_kv) tile covering q tokens [i*block_q, (i+1)*block_q) and kv
    tokens [j*block_kv, (j+1)*block_kv). ``causal=True`` intersects the mask
    with the causal triangle and masks diagonal tiles exactly (positions
    bottom-aligned when s_q != s_kv). A 3-D mask gives every query head its
    own pattern. ``head_shard=(rank, n_ranks)`` (ints): the 3-D mask covers
    ``h * n_ranks`` global heads and this call's h heads are global block
    ``rank`` (the ulysses all-to-all's head split).

    Differentiable (B9b and B9c over the same live tiles). The mask must be
    a host array (numpy or a CPU tensor); it keys the cached tables.
    ``interpret`` is accepted for API parity."""
    del interpret
    mask = _host_mask(block_mask)
    b, s_q, h, d = q.shape
    s_kv, h_kv = k.shape[1], k.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    block_q = min(block_q, s_q)
    block_kv = min(block_kv, s_kv)
    if s_q % block_q or s_kv % block_kv:
        raise ValueError(
            f"sequence lengths ({s_q}, {s_kv}) must be multiples of the "
            f"block sizes ({block_q}, {block_kv})")
    n_q, n_kv = s_q // block_q, s_kv // block_kv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    rank, n_ranks = 0, 1
    if head_shard is not None:
        rank, n_ranks = (int(x) for x in head_shard)
        if n_ranks > 1 and (mask.ndim != 3 or mask.shape[0] != h * n_ranks):
            raise ValueError(
                f"head_shard needs a per-head mask of {h * n_ranks} global "
                f"heads; got shape {mask.shape} for {h} local heads x "
                f"{n_ranks} ranks")
        if not 0 <= rank < n_ranks:
            raise ValueError(f"head_shard rank {rank} not in [0, {n_ranks})")
        if n_ranks == 1:
            rank = 0
    plan = _plan(mask.tobytes(), mask.shape, h, n_q, n_kv, bool(causal),
                 block_q, block_kv, h // h_kv, rank, n_ranks)
    out, lse = _SparseAttention.apply(q, k, v, plan, float(scale))
    return (out, lse) if return_lse else out
