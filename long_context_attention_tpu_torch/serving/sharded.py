"""Sequence-sharded decode: a slot-sharded KV cache, merged partials.

Counterpart of ``long_context_attention_tpu/serving/sharded.py``. The cache
is sharded over the mesh's sequence ranks (ring x ulysses) in contiguous
slot blocks: rank r owns global slots [r * slots, (r + 1) * slots). Queries
are replicated; every rank runs kernel B7 (``ops/decode.py``) over its own
block with its slice of the global window as per-row columns
(``first_cols``, ``sink_cols``), and the partial (out, lse) pairs merge by
their LSE after one all-gather a call. A run's append goes to its owner
ranks through kernel B6 at each rank's local base; a run that straddles a
block boundary splits itself between the two owners (B6 writes only the
slots inside [0, slots)).

A call is three parts, each its own function, so that every rank's part
can also run on one device with no collective (the tests and
``chip_smoke.py`` do): :func:`sharded_decode_partial` (rank r of n: its
local lengths, first columns, sink slice and page-table window, then B7),
one all-gather of (out fp32, lse) over the sequence group, and
:func:`merge_sharded_partials` (the n-way LSE merge, a dead row 0).
``axis_name`` names the ranks: a ``make_usp_mesh`` mesh (its sequence
group), a process group, or an explicit ``(rank, n)`` pair, which runs the
rank's part alone and returns its partial.

Paged mode (``page_table``, replicated, GLOBAL physical ids): each rank's
arrays are its partition of the pool, [r * P_local, (r + 1) * P_local) in
global ids, and logical page j of a row lives on rank j // (n_pages / n):
the dense slot split, so the same per-rank slicing serves. Each rank takes
its (b, n_pages / n) window of the table and rebases it into its
partition; unallocated entries rebase to negative ids, which the kernels
clamp to the rank's scratch page 0 and never read for a visible column.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from long_context_attention_tpu_torch.ops.decode import (
    cache_append,
    cache_append_rows,
    decode_attention,
)

__all__ = ["sharded_decode_attention", "sharded_decode_partial",
           "merge_sharded_partials", "sharded_cache_append",
           "sharded_cache_append_rows", "seq_place", "ShardStep"]


def seq_place(axis_name) -> Tuple[int, int, Optional[dist.ProcessGroup]]:
    """(this rank's place, the shard count, the group to gather over) of
    ``axis_name``: a USP mesh (its sequence group, ring-major), a process
    group, or an explicit ``(rank, n)`` pair (no group: the rank's part
    alone)."""
    if isinstance(axis_name, tuple):
        r, n = (int(x) for x in axis_name)
        if not 0 <= r < n:
            raise ValueError(f"rank {r} is not one of {n} shards")
        return r, n, None
    if hasattr(axis_name, "seq_idx"):
        return axis_name.seq_idx, axis_name.n_seq, axis_name.seq_group
    return (dist.get_rank(axis_name), dist.get_world_size(axis_name),
            axis_name)


def _local_pages(page_table: torch.Tensor, p_local: int, page: int, r: int,
                 n: int) -> Tuple[torch.Tensor, int]:
    """(rank r's rebased (b, ppr) page table, its slot capacity): the
    blocked layout's window of the global table, ids rebased into the
    rank's partition of ``p_local`` pages (negative: unallocated)."""
    n_pages = page_table.shape[1]
    if n_pages % n:
        raise ValueError(f"{n_pages} pages a row do not divide over {n} "
                         f"shards")
    ppr = n_pages // n
    lt = page_table[:, r * ppr:(r + 1) * ppr] - r * p_local
    return lt.contiguous(), ppr * page


def _slots(k_shard, layered: bool, page_table, r: int, n: int):
    """(local page table or None, the rank's slot capacity)."""
    if page_table is None:
        return None, k_shard.shape[3 if layered else 2]
    return _local_pages(page_table, k_shard.shape[1 if layered else 0],
                        k_shard.shape[3 if layered else 2], r, n)


def _columns(global_lengths, n_tok: int, multi: bool, r: int, slots: int,
             window_left: int, sink_tokens: int):
    """Rank r's (lengths, first_cols, sink_cols) of a call: the lengths
    unclipped for a run (the per-row causal bound then lands on the
    boundary rank's local column, past every column of an interior rank,
    before column 0 beyond the data) and clipped to [0, slots) for one
    token; the window as the unclipped local first column of token 0;
    the rank's slice of the sink prefix."""
    local = global_lengths - r * slots
    if not multi:
        local = local.clamp(0, slots)
    first_cols = sink_cols = None
    if window_left >= 0:
        first_cols = global_lengths - n_tok - window_left - r * slots
        if sink_tokens > 0:
            sink_cols = torch.full_like(global_lengths, sink_tokens).sub_(
                r * slots).clamp_(0, slots)
    return local, first_cols, sink_cols


def sharded_decode_partial(q, k_shard, v_shard, global_lengths,
                           k_scale=None, v_scale=None, *, rank: int, n: int,
                           softmax_scale=None, block_kv: int = 4096,
                           layer=None, softcap: float = 0.0,
                           window_left: int = -1, sink_tokens: int = 0,
                           safe_softmax: bool = False, page_table=None):
    """Rank ``rank`` of ``n``'s partial of :func:`sharded_decode_attention`:
    (out (b, [n_tok,] h, d) bf16, lse (b, h[, n_tok]) fp32) over its own
    block of the cache, from the global lengths (and the global page
    table). A rank past the data, or wholly left of the window, gives out
    0 and lse -inf."""
    multi = q.dim() == 4
    n_tok = q.shape[1] if multi else 1
    local_pt, slots = _slots(k_shard, layer is not None, page_table, rank, n)
    lens, first_cols, sink_cols = _columns(
        global_lengths.to(torch.int32), n_tok, multi, rank, slots,
        window_left, sink_tokens)
    return decode_attention(
        q, k_shard, v_shard, lens, k_scale, v_scale,
        softmax_scale=softmax_scale, block_kv=block_kv, return_lse=True,
        layer=layer, softcap=softcap, window_size=(window_left, -1),
        sink_band=sink_tokens, first_cols=first_cols, sink_cols=sink_cols,
        safe_softmax=safe_softmax, page_table=local_pt)


def merge_sharded_partials(outs: torch.Tensor,
                           lses: torch.Tensor) -> torch.Tensor:
    """The n-way LSE merge of the ranks' partials (JAX's
    ``sharded.py:122-140``): outs (n, b, [n_tok,] h, d) fp32 and lses (n,
    b, [n_tok,] h) -> (b, [n_tok,] h, d) bf16, a row dead on every rank
    0."""
    m = lses.amax(dim=0)
    dead = torch.isneginf(m)
    safe_m = torch.where(dead, torch.zeros_like(m), m)
    w = torch.where(torch.isneginf(lses), torch.zeros_like(lses),
                    torch.exp(lses - safe_m[None]))
    denom = w.sum(dim=0)
    merged = (outs * w[..., None]).sum(dim=0) / denom.clamp(
        min=1e-37)[..., None]
    merged = torch.where(dead[..., None], torch.zeros_like(merged), merged)
    return merged.to(torch.bfloat16)


def _gather_merge(out, lse, multi: bool, n: int, group):
    """One all-gather of every rank's (out fp32, lse), then the merge."""
    if multi:
        lse = lse.transpose(1, 2)  # (b, h, n_tok) -> (b, n_tok, h)
    part = torch.cat([out.float(), lse[..., None]], dim=-1).contiguous()
    if n > 1:
        parts = [torch.empty_like(part) for _ in range(n)]
        dist.all_gather(parts, part, group=group)
        part = torch.stack(parts)
    else:
        part = part[None]
    return merge_sharded_partials(part[..., :-1], part[..., -1])


def sharded_decode_attention(q, k_shard, v_shard, global_lengths,
                             k_scale=None, v_scale=None, *, axis_name,
                             softmax_scale=None, block_kv: int = 4096,
                             interpret=None, layer=None,
                             softcap: float = 0.0, window_left: int = -1,
                             sink_tokens: int = 0,
                             safe_softmax: bool = False, page_table=None):
    """Decode attention over a sequence-sharded cache: (b, h, d) bf16, or
    (b, n_tok, h, d) for a run (the speculative verify).

    q (b, h, d) or (b, n_tok, h, d), replicated; ``k_shard`` / ``v_shard``
    this rank's block (b, h_kv, slots, d), or stacked (L, b, h_kv, slots,
    d) with ``layer``; ``global_lengths`` (b,) int32, the whole row's
    filled length; scales in the cache's layout. ``axis_name``: the mesh
    (its sequence group), a process group, or ``(rank, n)``, which returns
    this rank's partial (out bf16, lse) unmerged. ``page_table``: the
    replicated global table of the paged sharded cache (each rank's arrays
    its pool partition). A window reaches each rank as its slice of the
    global window (``first_cols``), sinks as its slice of the sink prefix
    (``sink_cols``), the grid banded by ``window_left`` and
    ``sink_tokens``. ``interpret`` is accepted for API parity."""
    del interpret
    r, n, group = seq_place(axis_name)
    out, lse = sharded_decode_partial(
        q, k_shard, v_shard, global_lengths, k_scale, v_scale, rank=r, n=n,
        softmax_scale=softmax_scale, block_kv=block_kv, layer=layer,
        softcap=softcap, window_left=window_left, sink_tokens=sink_tokens,
        safe_softmax=safe_softmax, page_table=page_table)
    if isinstance(axis_name, tuple):
        return out, lse
    return _gather_merge(out, lse, q.dim() == 4, n, group)


def _local_pos(global_pos, n_tok: int, r: int, slots: int):
    """Rank r's local append base: the global base minus its first slot; a
    skipped row (global base <= -n_tok) stays at -n_tok on every rank."""
    global_pos = global_pos.to(torch.int32)
    return torch.where(global_pos <= -n_tok,
                       torch.full_like(global_pos, -n_tok),
                       global_pos - r * slots)


def sharded_cache_append(k_shard, v_shard, k_new, v_new, global_pos,
                         k_scale=None, v_scale=None, ks_new=None,
                         vs_new=None, *, axis_name, layer=None,
                         interpret=None, page_table=None):
    """Write each row's run of new tokens (b, h_kv, n, d), already in the
    cache's dtype, into its owner ranks' blocks IN PLACE (kernel B6's
    copy): every rank writes at its local base ``global_pos - r * slots``
    and B6 keeps the slots inside [0, slots), so a run straddling a block
    boundary splits between the two owners; ``global_pos <= -n`` skips a
    row on every rank. ``page_table``: the paged sharded cache's global
    table (the same local rebase). Returns what :func:`cache_append`
    returns."""
    r, n, _ = seq_place(axis_name)
    local_pt, slots = _slots(k_shard, layer is not None, page_table, r, n)
    return cache_append(
        k_shard, v_shard, k_new, v_new,
        _local_pos(global_pos, k_new.shape[2], r, slots), k_scale, v_scale,
        ks_new, vs_new, layer=layer, interpret=interpret,
        page_table=local_pt)


def sharded_cache_append_rows(cache, layer, k, v, global_pos, *, axis_name,
                              page_table=None):
    """:func:`sharded_cache_append` for the model's bf16 rows (b, n, h_kv,
    d) (or (L, b, n, h_kv, d) with ``layer`` None): quantized to the
    cache's dtype and written by kernel B6 at each rank's local base.
    ``page_table`` overrides the cache's global table. Returns the
    cache."""
    r, n, _ = seq_place(axis_name)
    pt = page_table if page_table is not None else getattr(
        cache, "page_table", None)
    local_pt, slots = _slots(cache.k, True, pt, r, n)
    cache_append_rows(cache, layer, k, v,
                      _local_pos(global_pos, k.shape[-3], r, slots),
                      page_table=local_pt)
    return cache


class ShardStep:
    """One decode step's sharded operands, made once for every layer: the
    rank's place, its local append bases, lengths, first columns and sink
    slice, and (paged) its rebased page-table window. ``cache`` is this
    rank's block (a :class:`KVCache` of s_max / n slots, or a
    :class:`PagedKVCache` whose arrays are its pool partition and whose
    table is global); ``pos0`` (b,) the global lengths before the run,
    ``n`` its tokens, ``live`` (b,) 1 for a row that runs."""

    def __init__(self, mesh, cache, pos0, n: int, live, window_left: int,
                 sink_tokens: int):
        r, shards, self.group = seq_place(mesh)
        self.n, self.shards = n, shards
        pt = getattr(cache, "page_table", None)
        self.pt, slots = _slots(cache.k, True, pt, r, shards)
        append = torch.where(live > 0, pos0, torch.full_like(pos0, -n))
        self.append_pos = _local_pos(append, n, r, slots)
        self.lengths, self.first_cols, self.sink_cols = _columns(
            (pos0 + n * live).to(torch.int32), n, n > 1, r, slots,
            window_left, sink_tokens)
        self.window_left, self.sink_tokens = window_left, sink_tokens

    def append(self, cache, layer: int, k, v) -> None:
        """Kernel B6: the run's rows (b, n, h_kv, d) into this rank's
        block."""
        cache_append_rows(cache, layer, k, v, self.append_pos,
                          page_table=self.pt)

    def attention(self, q, cache, layer: int, *, scale: float,
                  softcap: float, safe_softmax: bool):
        """Kernel B7 over this rank's block, then the gather and merge: (b,
        n, h, d) bf16."""
        out, lse = decode_attention(
            q, cache.k, cache.v, self.lengths, cache.k_scale,
            cache.v_scale, softmax_scale=scale, return_lse=True,
            layer=layer, softcap=softcap,
            window_size=(self.window_left, -1), sink_band=self.sink_tokens,
            first_cols=self.first_cols, sink_cols=self.sink_cols,
            safe_softmax=safe_softmax, page_table=self.pt)
        return _gather_merge(out, lse, True, self.shards, self.group)
