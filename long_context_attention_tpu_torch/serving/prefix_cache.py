"""Automatic prefix caching over the paged KV pool (host-side bookkeeping).

Counterpart of ``long_context_attention_tpu/serving/prefix_cache.py``, the
same host code (it is pure Python and numpy): pages whose content is a pure
function of a token prefix are content-addressed by a rolling chain hash, so
a new request whose prompt shares a page-aligned prefix with an earlier one
reuses those pool pages verbatim, and its prefill computes only the suffix
(``serving/continuous.py`` runs the suffix as chunked multi-token decode
against the shared prefix). Digests and allocation decisions equal the JAX
package's for the same calls.

Why this is sound with no copy-on-write:

* only pages FULLY covered by prompt tokens are registered; decode appends
  land at positions >= the prompt length, past every registered page, so a
  shared page is never written again;
* the K/V of a full prompt page depend only on the token prefix up to its
  end (causal attention, absolute RoPE), so the chain hash
  ``h_i = H(h_{i-1}, tokens[i*ps:(i+1)*ps])`` is exactly the content key;
* pages are stored quantized; sharing reuses the identical bytes, so a hit
  equals the original computation bit for bit.

The allocator extends the plain free list with refcounts (several live rows
may share a page) and an LRU of unreferenced cached pages, evicted only
when the free list runs dry.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["chain_hashes", "PrefixPageAllocator"]


def chain_hashes(tokens: Sequence[int], page_size: int) -> List[bytes]:
    """Content keys of the prompt's FULL pages: ``h_i`` digests page i's
    tokens chained onto ``h_{i-1}``, so a key identifies the whole prefix
    up to that page boundary (two prompts share page i iff they agree on
    every token before ``(i+1)*page_size``)."""
    out: List[bytes] = []
    h = b"prefix-cache-v1"
    for lo in range(0, (len(tokens) // page_size) * page_size, page_size):
        chunk = np.asarray(tokens[lo:lo + page_size], np.int64).tobytes()
        h = hashlib.blake2b(h + chunk, digest_size=16).digest()
        out.append(h)
    return out


class PrefixPageAllocator:
    """Free-list + refcounts + LRU'd content cache over the physical pool.

    Page 0 is the reserved scratch page (never handed out). Page states:

    * **free** — on ``self.free``; content is garbage.
    * **referenced** — ``ref[p] >= 1`` live rows point at it (via their
      page tables). May additionally be content-registered.
    * **cached** — registered in ``self.cache`` (hash -> page) with
      ``ref == 0``: no live row uses it, but its bytes are a valid prompt
      prefix — reusable instantly, evictable LRU-first when the free list
      empties.

    Rows release their pages when a new request takes their slot (exactly
    when the old content becomes garbage *for that row*; shared pages
    merely drop a reference).
    """

    def __init__(self, pool_pages: int):
        self.free: List[int] = list(range(1, pool_pages))
        self.rows: Dict[int, List[int]] = {}
        self.ref: Dict[int, int] = {}
        self.cache: "OrderedDict[bytes, int]" = OrderedDict()
        self.page_hash: Dict[int, bytes] = {}
        # observability (tests / bench)
        self.hit_pages = 0
        self.evictions = 0

    # --- queries -----------------------------------------------------------

    def lookup(self, hashes: Sequence[bytes]) -> int:
        """Longest run of leading page keys currently materialized (cached
        or referenced). Read-only."""
        n = 0
        for h in hashes:
            if h not in self.cache:
                break
            n += 1
        return n

    def can_take(self, bi: int, hashes: Sequence[bytes],
                 span_pages: int) -> bool:
        """Dry-run of :meth:`take`: after releasing row ``bi``'s pages,
        can ``span_pages`` pages (prefix hits + fresh) be assembled?"""
        own = self.rows.get(bi, [])
        ref2 = dict(self.ref)
        freed_to_free = 0
        for p in own:
            ref2[p] -= 1
            if ref2[p] == 0 and p not in self.page_hash:
                freed_to_free += 1
        hits = self.lookup(hashes)
        hit_pages = {self.cache[h] for h in hashes[:hits]}
        evictable = sum(1 for p in self.cache.values()
                        if ref2.get(p, 0) == 0 and p not in hit_pages)
        return (len(self.free) + freed_to_free + evictable
                >= span_pages - hits)

    # --- mutations ----------------------------------------------------------

    def release_row(self, bi: int) -> None:
        for p in self.rows.pop(bi, []):
            self.ref[p] -= 1
            if self.ref[p] == 0:
                del self.ref[p]
                if p not in self.page_hash:
                    self.free.append(p)
                # else: stays cached (evictable) — the whole point

    def _alloc_fresh(self) -> int:
        if self.free:
            return self.free.pop()
        # evict the LRU cached page nobody references
        for h, p in self.cache.items():
            if p not in self.ref:
                del self.cache[h]
                del self.page_hash[p]
                self.evictions += 1
                return p
        raise AssertionError("pool exhausted: no free or evictable pages "
                             "(caller must gate on can_take)")

    def take(self, bi: int, hashes: Sequence[bytes],
             span_pages: int) -> Tuple[List[int], int]:
        """Assemble row ``bi``'s page table: release its old pages, pin the
        longest cached prefix of ``hashes``, allocate the rest fresh.
        Returns (pages, n_hits) with ``len(pages) == span_pages`` — the
        first ``n_hits`` are shared prefix pages (already holding valid
        KV), the rest are fresh."""
        self.release_row(bi)
        hits = self.lookup(hashes)
        pages: List[int] = []
        for h in hashes[:hits]:
            p = self.cache[h]
            self.cache.move_to_end(h)  # MRU
            self.ref[p] = self.ref.get(p, 0) + 1
            pages.append(p)
        self.hit_pages += hits
        for _ in range(span_pages - hits):
            p = self._alloc_fresh()
            self.ref[p] = self.ref.get(p, 0) + 1
            pages.append(p)
        self.rows[bi] = list(pages)
        return pages, hits

    def register(self, hashes: Sequence[bytes],
                 pages: Sequence[int]) -> None:
        """Content-register freshly-written full prompt pages (call after
        the prefill that filled them). A key already mapped keeps its
        established page — the duplicate page simply frees with its row."""
        for h, p in zip(hashes, pages):
            if h in self.cache:
                continue
            if p in self.page_hash:  # page re-registered under a new chain
                continue
            self.cache[h] = p
            self.cache.move_to_end(h)
            self.page_hash[p] = h
