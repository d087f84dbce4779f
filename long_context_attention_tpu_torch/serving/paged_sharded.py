"""Sharded x paged x prefix-cached continuous serving.

Counterpart of ``long_context_attention_tpu/serving/paged_sharded.py``: the
physical page pool is split over the mesh's sequence ranks, and each rank
pages its own block of a row's slots locally.

* A row's capacity ``s_max`` splits into n contiguous blocks of ``s_max /
  n`` slots, as the dense sharded cache's, so the per-rank lengths, window
  columns and sink slices are those of ``serving/sharded.py``.
* Logical page j of a row lives on rank j // ppr (ppr = n_pages / n), its
  physical page in that rank's partition of the pool: global ids [r *
  P_local, (r + 1) * P_local), local page 0 of every partition the rank's
  scratch page.
* The page table stays replicated (global ids, kept by the host); each rank
  takes its (b, ppr) window and rebases it into its partition.

The host's bookkeeping is n single-host allocators (Python, or the C++
host core of ``serving/native.py``), one a partition, behind the
single-host interface. Prefix caching composes: a shared prefix page is
reused at the logical index it was registered under, so it lives on the
right rank.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from long_context_attention_tpu_torch.ops.decode import cache_append_rows
from long_context_attention_tpu_torch.ops.kv_cache import PagedKVCache
from long_context_attention_tpu_torch.serving.continuous import (
    PagedContinuousEngine,
    PagedSpeculativeContinuousEngine,
    Request,
    ShardedContinuousEngine,
    ShardedSpeculativeContinuousEngine,
    _PageAllocator,
    _validate_release,
)
from long_context_attention_tpu_torch.serving.prefix_cache import (
    PrefixPageAllocator,
)

__all__ = ["ShardedPagedContinuousEngine",
           "ShardedPagedSpeculativeContinuousEngine"]


def _split_range(lo: int, hi: int, ppr: int) -> List[Tuple[int, int, int]]:
    """[(partition, local lo, local hi)] covering logical pages [lo, hi)
    under the blocked layout (partition = logical // ppr): the one place
    the blocked-range arithmetic lives, so the allocators and the engine's
    capacity gate agree."""
    out = []
    j = lo
    while j < hi:
        r = j // ppr
        e = min(hi, (r + 1) * ppr)
        out.append((r, j - r * ppr, e - r * ppr))
        j = e
    return out


class _PartitionedPageAllocator:
    """n per-partition free lists behind the single-host allocator API.

    Page ids crossing this interface are GLOBAL (partition r owns [r *
    p_local, (r + 1) * p_local)); each wrapped allocator works in local ids
    over its own ``p_local``-page pool (local 0 the scratch page). Logical
    page j belongs to partition j // ppr."""

    def __init__(self, pool_pages: int, n: int, ppr: int, make_one):
        if pool_pages % n:
            raise ValueError(f"pool_pages {pool_pages} do not divide over "
                             f"{n} partitions")
        self.n, self.ppr = n, ppr
        self.p_local = pool_pages // n
        self.parts = [make_one(self.p_local) for _ in range(n)]
        # each row's GLOBAL pages: a release validates its whole list here
        # before any partition frees a page, so a bad page cannot leave one
        # partition released and another not (each partition is atomic on
        # its own, not jointly)
        self._rows: dict = {}

    def available_for(self, bi: int, need: int) -> bool:
        """Can logical pages [0, need) be taken for row ``bi`` (counting its
        own reclaimable pages in each partition)?"""
        if need > self.n * self.ppr:
            return False
        return all(self.parts[r].available(bi) >= hi - lo
                   for r, lo, hi in _split_range(0, need, self.ppr))

    def take(self, bi: int, need: int) -> List[int]:
        """Pages for logical [0, need), in logical order. Frees row ``bi``'s
        old pages in every partition (an old request may have spanned more
        partitions than the new one)."""
        pages: List[int] = []
        touched = set()
        for r, lo, hi in _split_range(0, need, self.ppr):
            pages.extend(p + r * self.p_local
                         for p in self.parts[r].take(bi, hi - lo))
            touched.add(r)
        for r in range(self.n):
            if r not in touched:
                self.parts[r].take(bi, 0)  # free the old pages, take none
        self._rows[bi] = list(pages)
        return pages

    def take_extra_range(self, bi: int, lo: int, hi: int) -> List[int]:
        """Growth pages for logical [lo, hi) of a running row."""
        pages: List[int] = []
        for r, llo, lhi in _split_range(lo, hi, self.ppr):
            pages.extend(p + r * self.p_local
                         for p in self.parts[r].take_extra(bi, lhi - llo))
        self._rows.setdefault(bi, []).extend(pages)
        return pages

    def release_pages(self, bi: int, pages: List[int]) -> None:
        """Free given (global) pages of a running row, each in its owner
        partition; the whole list is checked against the row's pages
        first (ValueError, nothing freed)."""
        if not pages:
            return
        _validate_release(self._rows.get(bi, []), pages, bi)
        by_part: dict = {}
        for p in pages:
            by_part.setdefault(p // self.p_local, []).append(
                p % self.p_local)
        for r, local in sorted(by_part.items()):
            self.parts[r].release_pages(bi, local)
        row = self._rows[bi]
        for p in pages:
            row.remove(p)


class _PartitionedPrefixAllocator:
    """n per-partition prefix allocators (refcounts and a content LRU)
    behind the single-host prefix allocator's API. Key j (page j's chain
    hash) belongs to partition j // ppr; hits stay prefix-consecutive
    across partitions because the keys arrive in logical order."""

    def __init__(self, pool_pages: int, n: int, ppr: int, make_one):
        if pool_pages % n:
            raise ValueError(f"pool_pages {pool_pages} do not divide over "
                             f"{n} partitions")
        self.n, self.ppr = n, ppr
        self.p_local = pool_pages // n
        self.parts = [make_one(self.p_local) for _ in range(n)]

    def _key_slices(self, hashes: Sequence[bytes]):
        for r in range(self.n):
            ks = hashes[r * self.ppr:(r + 1) * self.ppr]
            if not ks and r * self.ppr >= len(hashes):
                break
            yield r, ks

    def lookup(self, hashes: Sequence[bytes]) -> int:
        hits = 0
        for r, ks in self._key_slices(hashes):
            h = self.parts[r].lookup(ks)
            hits += h
            if h < len(ks):
                break
        return hits

    def _plan(self, hashes, span_pages: int):
        """Each partition's (keys of the consecutive hit prefix, pages of
        the span): a partition past the first miss takes fresh pages (its
        stale cached pages stay evictable)."""
        hits = self.lookup(hashes)
        for r in range(self.n):
            lo, hi = r * self.ppr, (r + 1) * self.ppr
            span_r = max(0, min(span_pages, hi) - lo)
            ks = hashes[lo:min(hits, hi)] if hits > lo else []
            yield r, ks, span_r

    def can_take(self, bi: int, hashes: Sequence[bytes],
                 span_pages: int) -> bool:
        return all(self.parts[r].can_take(bi, ks, span_r)
                   for r, ks, span_r in self._plan(hashes, span_pages))

    def take(self, bi: int, hashes: Sequence[bytes],
             span_pages: int) -> Tuple[List[int], int]:
        pages: List[int] = []
        got = 0
        for r, ks, span_r in list(self._plan(hashes, span_pages)):
            if span_r == 0 and not ks:
                self.parts[r].release_row(bi)
                continue
            p_r, g_r = self.parts[r].take(bi, ks, span_r)
            if g_r != len(ks):
                raise RuntimeError(f"partition {r} hit {g_r} of {len(ks)} "
                                   f"looked-up pages")
            got += g_r
            pages.extend(p + r * self.p_local for p in p_r)
        return pages, got

    def register(self, hashes: Sequence[bytes],
                 pages: Sequence[int]) -> None:
        for r, ks in self._key_slices(hashes):
            lo = r * self.ppr
            if ks:
                self.parts[r].register(
                    ks, [p - r * self.p_local for p in pages[lo:lo + len(ks)]])

    @property
    def evictions(self) -> int:
        return sum(p.evictions for p in self.parts)

    @property
    def hit_pages(self) -> int:
        return sum(p.hit_pages for p in self.parts)


@dataclasses.dataclass(frozen=True)
class ShardedPagedContinuousEngine(PagedContinuousEngine,
                                   ShardedContinuousEngine):
    """Continuous batching over a mesh-sharded PAGED cache, with the prefix
    cache and rolling window pages.

    The paged host scheduler of :class:`PagedContinuousEngine` (admission
    backpressure, windowed reclaim and growth, prefix plans) over pool
    partitions, one a sequence rank: the USP-sharded admission prefill is
    written page by page into each rank's partition; a prefix hit's suffix
    runs in chunks of the sharded :func:`decode_multi_step` against the
    one-row pool view; decode is the sharded :func:`decode_step`, each rank
    slicing its (b, ppr) window of the replicated table. ``s_max``,
    ``n_pages`` and ``pool_pages`` must divide over the n ranks and a
    rank's slots into whole pages. Windowed paging: a row's band moves
    across partitions (reclaim frees on the one behind the window, growth
    takes from the one ahead), so each partition must hold max_batch x
    min(ppr, the rolling working set) pages."""

    def __post_init__(self):
        super().__post_init__()
        n = self.n_seq
        if self.n_pages % n:
            raise ValueError(f"n_pages ({self.n_pages}) must divide over {n} "
                             f"sequence shards")
        if self.pool_pages % n:
            raise ValueError(f"pool_pages ({self.pool_pages}) must divide "
                             f"over {n} partitions")
        if (self.s_max // n) % self.page_size:
            raise ValueError(f"a rank's {self.s_max // n} slots are not "
                             f"whole pages of {self.page_size}")
        if self._windowed_paging:
            per_row = min(self.ppr, self._rolling_pages())
            need = self.max_batch * per_row
            if self.p_local - 1 < need:
                raise ValueError(
                    f"windowed paging needs every pool partition to hold "
                    f"max_batch x min(ppr, rolling working set) = "
                    f"{self.max_batch} x {per_row} = {need} allocatable "
                    f"pages; partitions have {self.p_local - 1} "
                    f"(pool_pages {self.pool_pages} over {n} shards). Raise "
                    f"pool_pages to >= {n * (need + 1)}.")

    # --- layout ------------------------------------------------------------

    @property
    def n_seq(self) -> int:
        return self.mesh.n_seq

    @property
    def ppr(self) -> int:
        """Logical pages of a row per rank."""
        return self.n_pages // self.n_seq

    @property
    def p_local(self) -> int:
        """Pool pages per partition, its scratch page included."""
        return self.pool_pages // self.n_seq

    # --- capacity ----------------------------------------------------------

    def _check_request_fits(self, r: Request) -> None:
        for part, lo, hi in _split_range(0, self._pages_needed(r), self.ppr):
            if hi - lo > self.p_local - 1:
                raise ValueError(
                    f"request {r.id} needs {hi - lo} pages on partition "
                    f"{part}; each has {self.p_local - 1} allocatable")

    def _can_admit(self, req: Request, bi: int) -> bool:
        if not self.prefix_cache:
            return self._alloc.available_for(bi, self._pages_needed(req))
        return super()._can_admit(req, bi)

    def _take_growth(self, bi: int, lo: int, hi: int) -> List[int]:
        return self._alloc.take_extra_range(bi, lo, hi)

    def _make_alloc(self):
        """One allocator a partition: the C++ host core when it builds and
        ``native_runtime`` allows it, else the Python ones."""
        make_basic = make_prefix = None
        if self.native_runtime is None or self.native_runtime:
            from long_context_attention_tpu_torch.serving import native

            if native.native_available():
                object.__setattr__(self, "_alloc_kind", "native")
                make_basic = native.NativePageAllocator
                make_prefix = native.NativePrefixPageAllocator
            elif self.native_runtime:
                raise RuntimeError(
                    "native_runtime=True but csrc/lca_host.cc failed to "
                    "build (g++ missing?)")
        if make_basic is None:
            object.__setattr__(self, "_alloc_kind", "python")
            make_basic, make_prefix = _PageAllocator, PrefixPageAllocator
        if self.prefix_cache:
            return _PartitionedPrefixAllocator(
                self.pool_pages, self.n_seq, self.ppr, make_prefix)
        return _PartitionedPageAllocator(
            self.pool_pages, self.n_seq, self.ppr, make_basic)

    # --- device pieces -----------------------------------------------------

    def init_cache(self) -> PagedKVCache:
        """This rank's partition of the pool (p_local pages) under the
        replicated global table."""
        return PagedKVCache.init(self.cfg.n_layers, self.max_batch,
                                 self.p_local, self.page_size,
                                 self.n_pages, self.cfg.n_kv_heads,
                                 self.cfg.head_dim, self.cache_dtype,
                                 device=self.device)

    def _bucket_prefill(self, params, cache, req: Request, bi: int,
                        row_pt: np.ndarray):
        """Cold admission: the USP prefill, then this rank's block of the
        prompt's K/V written page by page into its partition through its
        rebased window of the row's table (one B6 launch for every
        layer)."""
        n = len(req.tokens)
        logits, (kv_k, kv_v) = self._prefill_block(params, req)
        cache.page_table[bi] = self._vec(row_pt, torch.int32)
        m = kv_k.shape[2]
        if m:
            r = self.mesh.seq_idx
            local = (row_pt[r * self.ppr:(r + 1) * self.ppr]
                     - r * self.p_local)[:-(-m // self.page_size)]
            cache_append_rows(cache, None, kv_k, kv_v, 0,
                              page_table=self._vec(local[None], torch.int32))
        cache.length[bi] = n
        return cache, logits


@dataclasses.dataclass(frozen=True)
class ShardedPagedSpeculativeContinuousEngine(
        PagedSpeculativeContinuousEngine,
        ShardedSpeculativeContinuousEngine,
        ShardedPagedContinuousEngine):
    """Speculative continuous batching over the mesh-sharded paged pool:
    the partitioned allocators and prefix cache of
    :class:`ShardedPagedContinuousEngine`, the sharded dense draft of
    :class:`ShardedSpeculativeContinuousEngine`, the verify overhang and
    the round loop of :class:`PagedSpeculativeContinuousEngine`; the verify
    runs the sharded :func:`decode_multi_step` against the pool through each
    rank's rebased window of the table."""
