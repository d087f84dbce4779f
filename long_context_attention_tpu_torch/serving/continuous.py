"""Continuous batching: request-level scheduling over a shared decode batch.

Counterpart of ``long_context_attention_tpu/serving/continuous.py`` on one
device. The engine keeps a fixed decode batch of ``max_batch`` rows; every
model step decodes all rows in one :func:`decode_step` (kernels B6 and B7
per layer); a row whose request finished is freed at once and the next
queued request is admitted into it while the other rows keep decoding
(iteration-level scheduling):

* scheduling state lives in per-row ``length`` and ``active`` tensors, not
  in shapes: attention is gated by the per-row lengths, and the append
  skips inactive rows (``append_pos = -1``);
* admission is one bucketed single-row prefill (``forward_local`` with
  ``last_index``, kernel B1) and one in-place row insert.

The decode loop brings one (max_batch,) token vector to the host per block
of ``step_block`` device steps (EOS and budget are tracked on the device
inside a block). ``host_overlap=True`` runs the host scheduler one block
behind the device: block i+1 is queued before block i's tokens reach the
host, through a non-blocking copy into pinned memory and a CUDA event, so
the host's bookkeeping runs under device work. Greedy results equal the
sequential loop's.

:class:`PagedContinuousEngine` serves from a :class:`PagedKVCache`: rows
reserve only the pages their prompt and budget need from one shared pool,
with admission backpressure, automatic prefix caching (``prefix_cache``,
``serving/prefix_cache.py``), decode-interleaved chunked admission
(``interleave_admission``) and, for a sliding-window model, rolling window
pages; its bookkeeping runs in the C++ host core (``serving/native.py``)
when that builds. :class:`SpeculativeContinuousEngine` and
:class:`PagedSpeculativeContinuousEngine` run draft-and-verify rounds
(``serving/speculative.py``) in place of single decode steps.
:class:`ShardedContinuousEngine` and
:class:`ShardedSpeculativeContinuousEngine` run the same schedulers over a
sequence-sharded cache (``serving/sharded.py``), every rank alike.

Sampling: JAX's PRNG keys become ``torch.Generator``s. Request r samples
from its own generator, seeded from ``(seed, r.id)`` (JAX folds the request
id into its key), so a request's draws do not depend on the scheduler: a
sampled run of ``host_overlap`` or ``step_block`` equals the sequential
loop's. Sampled tokens cannot equal the JAX engine's, whose keys differ.
"""

from __future__ import annotations

import collections
import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from long_context_attention_tpu_torch.models.llama import (
    ModelConfig,
    decode_multi_step,
    decode_step,
    forward_local,
    step_device,
)
from long_context_attention_tpu_torch.ops.decode import cache_append_rows
from long_context_attention_tpu_torch.ops.kv_cache import (
    KVCache,
    PagedKVCache,
)
from long_context_attention_tpu_torch.ops.wquant import quantize_decode_params
from long_context_attention_tpu_torch.parallel.mesh import (
    MeshAxes,
    check_seq_mesh,
)
from long_context_attention_tpu_torch.serving.engine import (
    SamplingParams,
    sample_token,
    sampling_probs,
    token_logprob,
)
from long_context_attention_tpu_torch.serving.prefix_cache import (
    PrefixPageAllocator,
    chain_hashes,
)
from long_context_attention_tpu_torch.serving.sharded_engine import (
    ShardedEngine,
)
from long_context_attention_tpu_torch.serving.speculative import (
    SpeculativeEngine,
    draw_rows,
)
from long_context_attention_tpu_torch.utils.config import resolve_device

__all__ = ["Request", "RequestResult", "ContinuousEngine",
           "PagedContinuousEngine", "SpeculativeContinuousEngine",
           "PagedSpeculativeContinuousEngine", "ShardedContinuousEngine",
           "ShardedSpeculativeContinuousEngine"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request. ``tokens``: 1-d int prompt."""

    id: int
    tokens: Sequence[int]
    max_new: int


@dataclasses.dataclass
class RequestResult:
    id: int
    tokens: List[int]          # generated ids (stops at eos, inclusive)
    prompt_len: int
    # log P(token) under softmax(raw logits) per generated token, aligned
    # with ``tokens``; populated when the engine has return_logprobs=True
    logprobs: Optional[List[float]] = None


def _bucket(n: int, quantum: int = 64, cap: int = 2048) -> int:
    """Prompt padding buckets: powers of two from ``quantum`` up to ``cap``,
    then multiples of ``cap`` (the JAX package's rule; a 16.4K prompt pads
    to 18432)."""
    b = quantum
    while b < min(n, cap):
        b *= 2
    if n <= b:
        return b
    return -(-n // cap) * cap


def _to_host(t: Optional[torch.Tensor]):
    """Start copying ``t`` to the host without waiting: (host tensor, CUDA
    event to wait on, or None when the copy is done)."""
    if t is None or t.device.type == "cpu":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return host, ev


def _numpy(pending) -> Optional[np.ndarray]:
    host, ev = pending
    if ev is not None:
        ev.synchronize()
    return None if host is None else host.numpy()


@dataclasses.dataclass(frozen=True)
class ContinuousEngine:
    """Iteration-level scheduler over a fixed ``max_batch`` decode batch.

    ``cache_dtype``: "bfloat16" | "int8" | "float8_e4m3fn" | "int4"
    (int4 packed two per byte along d). ``weight_dtype``: "bfloat16" |
    "int8" (w8a8 decode weights; admission prefill keeps the bf16 params).
    ``step_block``: decode steps per host sync. ``host_overlap``: pipeline
    the host scheduler one block behind the device. ``return_logprobs``:
    report log P(token) per generated token. ``device``: where the engine
    runs (None means the card, "cpu" runs every kernel's plain version);
    params elsewhere raise."""

    cfg: ModelConfig
    s_max: int
    max_batch: int = 8
    cache_dtype: str = "bfloat16"
    step_block: int = 1
    host_overlap: bool = False
    weight_dtype: str = "bfloat16"
    return_logprobs: bool = False
    device: Optional[object] = None

    def __post_init__(self):
        if self.weight_dtype not in ("bfloat16", "int8"):
            raise ValueError(f"weight_dtype {self.weight_dtype!r}")
        object.__setattr__(self, "device", resolve_device(self.device))

    def decode_params(self, params):
        """The params of the decode steps (int8 QTensor weights when
        ``weight_dtype="int8"``; admission prefill keeps ``params``)."""
        if self.weight_dtype == "bfloat16":
            return params
        return quantize_decode_params(params)

    def init_cache(self):
        return KVCache.init(self.cfg.n_layers, self.max_batch, self.s_max,
                            self.cfg.n_kv_heads, self.cfg.head_dim,
                            self.cache_dtype, device=self.device)

    # --- device pieces -----------------------------------------------------

    def _prefill_one(self, params, tokens: np.ndarray, last_index: int):
        """(1, bucket) padded prompt -> (next-token logits (1, vocab) fp32,
        (kv_k, kv_v) (L, 1, bucket, h_kv, d)). Only the true last token
        projects through lm_head."""
        toks = torch.as_tensor(tokens, device=self.device)
        with torch.no_grad():
            logits, kv = forward_local(params, toks, self.cfg,
                                       return_kv=True, last_index=last_index)
        return logits[:, 0], kv

    def _insert_row(self, cache, kv_k, kv_v, row: int, true_len: int):
        """Quantize a prefilled row's K/V (L, 1, bucket, h_kv, d) and write
        it into the cache at batch row ``row``, slots [0, bucket), IN
        PLACE: one B6 launch for every layer, through the one-entry table
        [[row]] (a dense cache is a pool of its rows)."""
        table = torch.tensor([[row]], dtype=torch.int32, device=cache.k.device)
        cache_append_rows(cache, None, kv_k, kv_v, 0, page_table=table)
        cache.length[row] = true_len
        return cache

    def _sample_rows(self, logits, sampling: SamplingParams, gens):
        """(B, vocab) logits -> (B,) int32: row i drawn from ``gens[i]``
        (rows without a request take the argmax, which nobody reads)."""
        if sampling.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return draw_rows(sampling_probs(logits, sampling), gens)

    @torch.no_grad()
    def _decode_block(self, dparams, cache, tok, act, left, eos: int,
                      sampling: SamplingParams, gens):
        """``step_block`` decode steps with per-row EOS and budget tracking
        on the device (no host sync): a row that finishes mid-block
        deactivates in place; the host replays the same rule on the
        emitted (B, K) tokens. Returns (tokens (B, K), logprobs (B, K) or
        None, the carried tokens, active mask and budget)."""
        toks, lps = [], []
        for _ in range(max(1, self.step_block)):
            logits, cache = decode_step(dparams, cache, tok, self.cfg,
                                        active=act, mesh=self._step_mesh)
            nxt = self._sample_rows(logits, sampling, gens)
            if self.return_logprobs:
                lps.append(token_logprob(logits, nxt))
            nxt = torch.where(act, nxt, tok)
            left = left - act.to(torch.int32)
            done = left <= 0
            if eos >= 0:
                done = done | (nxt == eos)
            act = act & ~done
            tok = nxt
            toks.append(nxt)
        lp = torch.stack(lps, dim=1) if self.return_logprobs else None
        return torch.stack(toks, dim=1), lp, tok, act, left

    @property
    def _step_mesh(self):
        """The mesh the decode steps' cache is sequence-sharded over (the
        sharded engines), or None."""
        return None

    def _can_admit(self, req: Request, bi: int) -> bool:
        """Backpressure hook: may ``req`` enter row ``bi`` now? (The paged
        engine refuses while its pool cannot cover the request.)"""
        return True

    def _sample_first(self, logits, sampling: SamplingParams, gen):
        """Admission epilogue: the first token from the prefill logits, and
        its logprob when asked for."""
        first = sample_token(logits, sampling, gen)
        lp = (float(token_logprob(logits, first)[0])
              if self.return_logprobs else None)
        return int(first[0]), lp

    def _admit_row(self, params, cache, req: Request, bi: int,
                   sampling: SamplingParams, gen):
        """Prefill one request and insert it at batch row ``bi``. Returns
        (cache, first token, its logprob or None)."""
        n = len(req.tokens)
        toks = np.zeros((1, _bucket(n)), np.int64)
        toks[0, :n] = np.asarray(req.tokens, np.int64)
        logits, (kv_k, kv_v) = self._prefill_one(params, toks, n - 1)
        cache = self._insert_row(cache, kv_k, kv_v, bi, n)
        first, lp = self._sample_first(logits, sampling, gen)
        return cache, first, lp

    # --- host-side scheduler ----------------------------------------------

    def _check_requests(self, params, requests: Sequence[Request]) -> None:
        if params["embed"].device != self.device:
            raise ValueError(f"params['embed'] is on "
                             f"{params['embed'].device}, but the engine "
                             f"runs on {self.device}")
        for r in requests:
            if len(r.tokens) + r.max_new > self.s_max:
                raise ValueError(
                    f"request {r.id}: prompt ({len(r.tokens)}) + max_new "
                    f"({r.max_new}) exceeds cache capacity s_max={self.s_max}")

    def _generator(self, seed: int, req: Request) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            seed * 1_000_003 + int(req.id))

    def _vec(self, values, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype,
                               device=self.device)

    def serve(self, params, requests: Sequence[Request], *,
              sampling: SamplingParams = SamplingParams(),
              eos_id: Optional[int] = None,
              seed: int = 0) -> Dict[int, RequestResult]:
        """Run all requests to completion; returns {request.id: result}.
        A request enters a row the moment one is free; decode keeps
        stepping for the rows still running."""
        self._check_requests(params, requests)
        if self.host_overlap:
            return self._serve_overlapped(params, requests,
                                          sampling=sampling, eos_id=eos_id,
                                          seed=seed)
        B = self.max_batch
        queue = deque(requests)
        cache = self.init_cache()
        dparams = self.decode_params(params)
        slot: List[Optional[Request]] = [None] * B
        gens: List[Optional[torch.Generator]] = [None] * B
        emitted: List[List[int]] = [[] for _ in range(B)]
        lps = [[] for _ in range(B)] if self.return_logprobs else None
        cur = np.zeros((B,), np.int32)
        results: Dict[int, RequestResult] = {}
        eos = -1 if eos_id is None else int(eos_id)

        def admit():
            nonlocal cache
            for bi in range(B):
                if slot[bi] is not None or not queue:
                    continue
                if not self._can_admit(queue[0], bi):
                    continue
                req = queue.popleft()
                gens[bi] = self._generator(seed, req)
                cache, first, flp = self._admit_row(params, cache, req, bi,
                                                    sampling, gens[bi])
                slot[bi] = req
                emitted[bi] = [first]
                if lps is not None:
                    lps[bi] = [flp]
                cur[bi] = first
                self._maybe_finish(bi, slot, emitted, results, eos_id, lps)

        while queue or any(s is not None for s in slot):
            admit()
            if not any(s is not None for s in slot):
                continue  # everything admitted finished at its first token
            budget = [slot[bi].max_new - len(emitted[bi])
                      if slot[bi] is not None else 0 for bi in range(B)]
            toks, lp, _, _, _ = self._decode_block(
                dparams, cache, self._vec(cur, torch.int32),
                self._vec([s is not None for s in slot], torch.bool),
                self._vec(budget, torch.int32), eos, sampling, gens)
            nxt = toks.cpu().numpy()
            lp = lp.cpu().numpy() if lps is not None else None
            self._consume(nxt, lp, slot, emitted, results, eos_id, lps,
                          cur=cur)
            # the paged engine's rolling window pages (a no-op here)
            cache = self._post_block(cache, slot, emitted)
        return results

    def _post_block(self, cache, slot, emitted):
        """Hook after each decode block, with the host's lengths current:
        the paged engine frees the pages that slid behind a row's window
        and assigns the pages the next block writes; dense engines do
        nothing. Not called on the ``host_overlap`` path, whose host
        lengths lag the device by a block."""
        return cache

    def _consume(self, nxt, lp, slot, emitted, results, eos_id, lps,
                 ids=None, cur=None):
        """Replay a block's (B, K) tokens on the host: append each live
        row's tokens until its request finishes. ``ids``: the row's request
        id at the block's dispatch (a row re-admitted since then skips the
        old request's tokens)."""
        for j in range(nxt.shape[1]):
            for bi in range(len(slot)):
                if slot[bi] is None or (ids is not None
                                        and slot[bi].id != ids[bi]):
                    continue
                emitted[bi].append(int(nxt[bi, j]))
                if lps is not None:
                    lps[bi].append(float(lp[bi, j]))
                if cur is not None:
                    cur[bi] = int(nxt[bi, j])
                self._maybe_finish(bi, slot, emitted, results, eos_id, lps)

    def _serve_overlapped(self, params, requests: Sequence[Request], *,
                          sampling: SamplingParams = SamplingParams(),
                          eos_id: Optional[int] = None,
                          seed: int = 0) -> Dict[int, RequestResult]:
        """One-block-deep software pipeline of :meth:`serve`: the scheduler
        state (tokens, active mask, budget) lives on the device, block i+1
        is queued before block i's tokens are fetched, and the host
        consumes block i's tokens while the device runs block i+1. A row
        that finishes mid-pipeline was already deactivated by the device's
        own done rule, so the block in flight writes nothing to it, and its
        re-admission is queued after that block."""
        B = self.max_batch
        queue = deque(requests)
        cache = self.init_cache()
        dparams = self.decode_params(params)
        slot: List[Optional[Request]] = [None] * B
        gens: List[Optional[torch.Generator]] = [None] * B
        emitted: List[List[int]] = [[] for _ in range(B)]
        lps = [[] for _ in range(B)] if self.return_logprobs else None
        results: Dict[int, RequestResult] = {}
        dev = self.device
        tok_d = torch.zeros((B,), dtype=torch.int32, device=dev)
        act_d = torch.zeros((B,), dtype=torch.bool, device=dev)
        left_d = torch.zeros((B,), dtype=torch.int32, device=dev)
        eos = -1 if eos_id is None else int(eos_id)

        def admit():
            nonlocal cache
            for bi in range(B):
                if slot[bi] is not None or not queue:
                    continue
                if not self._can_admit(queue[0], bi):
                    continue
                req = queue.popleft()
                gens[bi] = self._generator(seed, req)
                cache, first, flp = self._admit_row(params, cache, req, bi,
                                                    sampling, gens[bi])
                slot[bi] = req
                emitted[bi] = [first]
                if lps is not None:
                    lps[bi] = [flp]
                self._maybe_finish(bi, slot, emitted, results, eos_id, lps)
                if slot[bi] is not None:
                    tok_d[bi] = first
                    act_d[bi] = True
                    left_d[bi] = req.max_new - 1

        admit()
        # pending: block i-1's tokens on their way to the host, with the
        # row -> request id snapshot taken at its dispatch
        pending = None
        while queue or any(s is not None for s in slot) or pending:
            nxt_block = None
            if any(s is not None for s in slot):
                toks, lpb, tok_d, act_d, left_d = self._decode_block(
                    dparams, cache, tok_d, act_d, left_d, eos, sampling,
                    list(gens))
                nxt_block = (_to_host(toks), _to_host(lpb),
                             [s.id if s is not None else None for s in slot])
            if pending is not None:
                toks_h, lps_h, ids = pending
                self._consume(_numpy(toks_h), _numpy(lps_h), slot, emitted,
                              results, eos_id, lps, ids=ids)
            admit()  # after the tokens: the freshest finish knowledge
            pending = nxt_block
        return results

    @staticmethod
    def _maybe_finish(bi, slot, emitted, results, eos_id, lps=None):
        req = slot[bi]
        if req is None:
            return
        done = (len(emitted[bi]) >= req.max_new
                or (eos_id is not None and emitted[bi][-1] == eos_id))
        if done:
            results[req.id] = RequestResult(
                id=req.id, tokens=list(emitted[bi]),
                prompt_len=len(req.tokens),
                logprobs=(list(lps[bi]) if lps is not None else None))
            slot[bi] = None


@dataclasses.dataclass
class _Admission:
    """Host state of one in-flight chunked admission (paged engine,
    ``interleave_admission=True``): the prompt's unprefilled tokens staged
    as ``n_chunks`` chunks of ``cs``, the row's reserved page table, and
    the prefix-cache bookkeeping deferred to completion."""

    req: Request
    bi: int
    gen: Optional[torch.Generator]
    toks: np.ndarray          # (1, n_chunks*cs) zero-padded suffix tokens
    cs: int
    n_chunks: int
    ci: int
    last: int                 # final true token's offset in the last chunk
    row_pt: np.ndarray        # (n_pages,) the row's new page table
    pages: List[int]
    all_hashes: List[bytes]
    cached: int               # prefix-hit tokens already in shared pages


def _validate_release(owned, pages, bi: int) -> None:
    """Whole-list ownership check before any mutation (the allocator fails
    loudly and atomically on a double release)."""
    have = collections.Counter(owned)
    for p, c in collections.Counter(pages).items():
        if have[p] < c:
            raise ValueError(
                f"release_pages: row {bi} does not own page {p} "
                f"(double release?)")


class _PageAllocator:
    """Host-side free list over the physical page pool. Page 0 is the
    reserved scratch page. A row's pages free when a new request is
    admitted into that row (exactly when they become garbage)."""

    def __init__(self, pool_pages: int):
        self.free: List[int] = list(range(1, pool_pages))
        self.rows: Dict[int, List[int]] = {}

    def available(self, bi: int) -> int:
        return len(self.free) + len(self.rows.get(bi, []))

    def take(self, bi: int, need: int) -> List[int]:
        self.free.extend(self.rows.pop(bi, []))
        assert len(self.free) >= need, (need, len(self.free))
        pages = [self.free.pop() for _ in range(need)]
        self.rows[bi] = pages
        return list(pages)

    def take_extra(self, bi: int, need: int) -> List[int]:
        """Grow a running row by ``need`` fresh pages; raises (before
        mutating anything) when the free list cannot."""
        if len(self.free) < need:
            raise RuntimeError(
                f"page pool exhausted: row {bi} needs {need} growth pages, "
                f"{len(self.free)} free")
        pages = [self.free.pop() for _ in range(need)]
        self.rows.setdefault(bi, []).extend(pages)
        return pages

    def release_pages(self, bi: int, pages: List[int]) -> None:
        """Free given pages of a running row, in the given order; raises
        ValueError, before mutating, when any page is not the row's."""
        if not pages:
            return
        row = self.rows.get(bi)
        if not row:
            raise ValueError(
                f"release_pages: row {bi} owns no pages (double release?)")
        _validate_release(row, pages, bi)
        for p in pages:
            row.remove(p)
            self.free.append(p)


@dataclasses.dataclass(frozen=True)
class PagedContinuousEngine(ContinuousEngine):
    """Continuous batching over a paged cache (:class:`PagedKVCache`): rows
    reserve only the pages their prompt and decode budget need from one
    shared pool, so the pool holds ~pool / mean request length rows instead
    of ~pool / s_max. A request whose pages exceed the free pool waits at
    block boundaries (:meth:`_can_admit`) while the other rows decode.

    ``prefix_cache=True``: full prompt pages are registered by a chain
    hash; a new prompt sharing a page-aligned prefix with an earlier one
    reuses those pool pages (refcounted, evicted LRU only when the free
    list runs dry), and its prefill computes only the suffix, in chunks of
    ``prefill_chunk`` tokens through :func:`decode_multi_step` against the
    shared prefix. ``interleave_admission=True``: a prompt prefills one
    chunk at a time with one decode block of the running rows between
    chunks, so their stall is bounded by one chunk. Greedy results equal
    the batch-admission scheduler's.

    A sliding-window config without the prefix cache or host overlap
    pages by the window (:attr:`_windowed_paging`): a row holds only its
    sink pages and its window's, the pages behind the window free while it
    runs and fresh pages are assigned as decode crosses page boundaries.

    ``native_runtime``: the page and prefix bookkeeping runs in the C++
    host core (``csrc/lca_host.cc`` through ``serving/native.py``) when
    None and it builds, or the Python allocators; True requires the host
    core (RuntimeError when it does not build), False forces Python. The
    decisions are the same bit for bit either way
    (:attr:`last_alloc_kind` says which ran)."""

    page_size: int = 2048
    pool_pages: int = 0      # physical pages INCLUDING the scratch page 0
    prefix_cache: bool = False
    prefill_chunk: int = 256
    interleave_admission: bool = False
    native_runtime: Optional[bool] = None

    def __post_init__(self):
        super().__post_init__()
        if self.pool_pages < 2:
            raise ValueError("the pool needs the scratch page + 1")
        if self.s_max % self.page_size:
            raise ValueError(f"s_max {self.s_max} is not a multiple of the "
                             f"page size {self.page_size}")
        if self.prefill_chunk < 64 or self.prefill_chunk % 64:
            raise ValueError("prefill_chunk must be a multiple of the "
                             "bucket quantum (64)")
        if self.interleave_admission and self.host_overlap:
            raise ValueError(
                "interleave_admission does not compose with host_overlap "
                "yet -- pick one (both remove host/admission stalls)")

    @property
    def n_pages(self) -> int:
        return self.s_max // self.page_size

    @property
    def stats(self) -> Dict[str, int]:
        """Prefix-cache counters of the last `serve` call:
        ``prefix_hit_tokens`` (prompt tokens served from shared pages),
        ``admitted_tokens``, ``evictions``."""
        return getattr(self, "_stats", {})

    @property
    def _windowed_paging(self) -> bool:
        """Rolling window pages: rows hold only their sink and window pages;
        pages wholly behind the window free while the row runs and fresh
        pages are assigned on demand, so ``max_new`` does not enter the
        reservation. The kernels never read a tile behind the window (B7
        walks a row's sink tiles and its band), so freeing such a page, and
        another row's reuse of it, cannot change a result. Batch and
        interleaved admission only (host_overlap's host lengths lag the
        device); the prefix cache keeps whole-span reservations."""
        return (self.cfg.window_left >= 0 and not self.prefix_cache
                and not self.host_overlap)

    def _sink_pages(self) -> int:
        sink = self.cfg.sink_tokens
        return -(-sink // self.page_size) if sink else 0

    def _rolling_pages(self) -> int:
        """Pages a windowed row holds at steady state: the sink prefix, the
        window and the query's own column, a block of growth margin and
        one page of rounding slack."""
        band = self.cfg.window_left + 1 + self.step_block + 1
        return self._sink_pages() + -(-band // self.page_size) + 1

    def _note_windowed_row(self, bi: int, row_pt: np.ndarray,
                           assigned: int, n: int) -> None:
        """Record an admitted row's page state for the rolling window (a
        no-op unless the engine pages by the window)."""
        if self._windowed_paging:
            self._rowwin[bi] = {"pt": row_pt, "assigned": int(assigned),
                                "next_free": self._sink_pages(),
                                "prompt": int(n)}

    def _post_block(self, cache, slot, emitted):
        """The rolling window after each decode block:

        * reclaim first: free each row's pages wholly behind its window
          (the sink pages stay); no kernel reads them again, and the row's
          stale table entries are never followed, so they need no write;
        * then growth: assign the pages the next block writes, and write
          only those entries of the card's page table, in one indexed write.

        Reclaim comes before growth so that a row never holds more pages
        than its admission reserved; growth first overflows a pool that
        :meth:`_can_admit` accepted by one page in hundreds of (window,
        step_block, page_size) combinations."""
        if not self._windowed_paging or not self._rowwin:
            return cache
        psz, w = self.page_size, self.cfg.window_left
        sink_pages = self._sink_pages()
        upd = []
        for bi, req in enumerate(slot):
            st = self._rowwin.get(bi)
            if req is None or st is None:
                continue
            # the admission's first token is appended by the first decode
            # step: the row's length is prompt + emitted - 1
            length = st["prompt"] + len(emitted[bi]) - 1
            first_needed = max(length - 1 - w, 0) // psz
            lo = max(st["next_free"], sink_pages)
            if first_needed > lo:
                self._alloc.release_pages(
                    bi, [int(st["pt"][j]) for j in range(lo, first_needed)])
                st["next_free"] = first_needed
            # the next block appends up to step_block tokens
            need_upto = min(-(-(length + self.step_block + 1) // psz),
                            self.n_pages)
            if need_upto > st["assigned"]:
                pages = self._take_growth(bi, st["assigned"], need_upto)
                for j, pg in zip(range(st["assigned"], need_upto), pages):
                    st["pt"][j] = pg
                    upd.append((bi, j, pg))
                st["assigned"] = need_upto
        if upd:
            b, j, pg = self._vec(np.asarray(upd).T, torch.long)
            cache.page_table[b, j] = pg.to(torch.int32)
        return cache

    def _take_growth(self, bi: int, lo: int, hi: int) -> List[int]:
        """Physical pages for row ``bi``'s logical pages [lo, hi)."""
        return self._alloc.take_extra(bi, hi - lo)

    def _pages_needed(self, req: Request) -> int:
        if self._windowed_paging:
            return self._windowed_admit_pages(len(req.tokens))
        pad = _bucket(len(req.tokens))
        span = max(pad, len(req.tokens) + req.max_new)
        if self.prefix_cache or self.interleave_admission:
            # worst-case suffix-chunk padding (cached + ceil(suffix/cs)*cs
            # <= n + cs)
            span = max(span, len(req.tokens)
                       + min(self.prefill_chunk, pad))
        return -(-span // self.page_size)

    def _windowed_admit_pages(self, n: int, cs: Optional[int] = None) -> int:
        """A windowed row's admission reservation: the prefill's span (the
        bucket-padded prompt, or the chunk-rounded one when interleaved)
        and the first decode block, at least the rolling working set. One
        formula for :meth:`_pages_needed` and the interleaved
        :meth:`_admission_start`, so the gate and the take agree."""
        pad = _bucket(n)
        span = max(pad, n + self.step_block + 1)
        if self.interleave_admission:
            c = cs if cs is not None else min(self.prefill_chunk, pad)
            span = max(span, -(-n // c) * c)
        # a rolling set past the row's pages is the whole row
        return min(max(-(-span // self.page_size), self._rolling_pages()),
                   self.n_pages)

    def init_cache(self) -> PagedKVCache:
        return PagedKVCache.init(self.cfg.n_layers, self.max_batch,
                                 self.pool_pages, self.page_size,
                                 self.n_pages, self.cfg.n_kv_heads,
                                 self.cfg.head_dim, self.cache_dtype,
                                 device=self.device)

    # --- allocator lifecycle (per serve call) ------------------------------

    def _check_request_fits(self, r: Request) -> None:
        """Raise when ``r`` can never be admitted (the pool is too small)."""
        if self._pages_needed(r) > self.pool_pages - 1:
            raise ValueError(
                f"request {r.id} needs {self._pages_needed(r)} pages; "
                f"pool has {self.pool_pages - 1} allocatable")

    def _with_allocator(self, requests, run):
        """Run ``run()`` with a fresh allocator and row state: the
        allocator lifecycle of one serve call."""
        for r in requests:
            self._check_request_fits(r)
        alloc = self._make_alloc()
        object.__setattr__(self, "_alloc", alloc)
        object.__setattr__(self, "_rowwin", {})
        object.__setattr__(self, "_stats",
                           {"prefix_hit_tokens": 0, "admitted_tokens": 0,
                            "evictions": 0})
        try:
            return run()
        finally:
            if self.prefix_cache:
                self._stats["evictions"] = alloc.evictions
            object.__setattr__(self, "_alloc", None)

    def serve(self, params, requests, **kw):
        if self.interleave_admission:
            return self._with_allocator(
                requests, lambda: self._serve_interleaved(params, requests,
                                                          **kw))
        return self._with_allocator(
            requests, lambda: super(PagedContinuousEngine, self).serve(
                params, requests, **kw))

    def _make_alloc(self):
        """The page allocator of one serve call: the C++ host core when it
        builds and ``native_runtime`` allows it, else the Python one. The
        two decide the same bit for bit, so the choice changes only the
        host's speed."""
        if self.native_runtime is None or self.native_runtime:
            from long_context_attention_tpu_torch.serving import native

            if native.native_available():
                object.__setattr__(self, "_alloc_kind", "native")
                if self.prefix_cache:
                    return native.NativePrefixPageAllocator(self.pool_pages)
                return native.NativePageAllocator(self.pool_pages)
            if self.native_runtime:
                raise RuntimeError(
                    "native_runtime=True but csrc/lca_host.cc failed to "
                    "build (g++ missing?)")
        object.__setattr__(self, "_alloc_kind", "python")
        if self.prefix_cache:
            return PrefixPageAllocator(self.pool_pages)
        return _PageAllocator(self.pool_pages)

    @property
    def last_alloc_kind(self) -> str:
        """"native" or "python": the allocator of the last serve call
        ("unused" before the first)."""
        return getattr(self, "_alloc_kind", "unused")

    def _can_admit(self, req: Request, bi: int) -> bool:
        if not self.prefix_cache:
            return self._alloc.available(bi) >= self._pages_needed(req)
        _, lookup_hashes, _, _, span_pages = self._prefix_plan(req)
        return self._alloc.can_take(bi, lookup_hashes, span_pages)

    def _prefix_plan(self, req: Request):
        """(all full-page hashes, lookup hashes, hits, chunk size, table
        span in pages) for admitting ``req`` under the current allocator
        state. Hits are capped so at least one suffix token remains (the
        next-token logits come from a computed query), and dropped to 0
        when the chunk-padded span would overflow the row's table."""
        ps = self.page_size
        n = len(req.tokens)
        all_hashes = chain_hashes(req.tokens, ps)
        lookup_hashes = all_hashes[:(n - 1) // ps]
        hits = self._alloc.lookup(lookup_hashes)
        cs = None
        if hits > 0:
            cached = hits * ps
            suffix = n - cached
            cs = min(self.prefill_chunk, _bucket(suffix))
            span = max(n + req.max_new, cached + (-(-suffix // cs)) * cs)
            if span > self.s_max:
                hits, cs = 0, None
        if hits == 0:
            lookup_hashes = []
            if self.interleave_admission:
                # cold interleaved admissions chunk the whole prompt
                cs = min(self.prefill_chunk, _bucket(n))
                span = max(n + req.max_new, (-(-n // cs)) * cs)
            else:
                span = max(_bucket(n), n + req.max_new)
        return all_hashes, lookup_hashes, hits, cs, -(-span // ps)

    # --- paged admission ----------------------------------------------------

    def _insert_row_paged(self, cache, kv_k, kv_v, row: int, true_len: int,
                          n_chunks: int, pages: np.ndarray):
        """Quantize a prefilled row's K/V and write it page by page into the
        pool, IN PLACE: chunk i of the padded prompt lands in pool page
        ``pages[i]``, i < ``n_chunks``: one B6 launch for every layer
        through the first ``n_chunks`` entries of the row's table, which
        is installed first. Installs the row's length."""
        cache.page_table[row] = self._vec(pages, torch.int32)
        cache_append_rows(cache, None, kv_k, kv_v, 0,
                          page_table=cache.page_table[row:row + 1, :n_chunks])
        cache.length[row] = true_len
        return cache

    def _row_view(self, cache, row_pt: np.ndarray, length: int):
        """A one-row view of the pool: the same tensors with one page table
        row and a length, so appends through it land in the pool."""
        return PagedKVCache(
            k=cache.k, v=cache.v, k_scale=cache.k_scale,
            v_scale=cache.v_scale,
            page_table=self._vec(row_pt[None], torch.int32),
            length=self._vec([length], torch.int32))

    def _suffix_chunk(self, params, view, toks: np.ndarray, last_index: int):
        """One suffix-prefill chunk: teacher-force ``toks`` (1, cs) through
        :func:`decode_multi_step` against the one-row pool view; appends
        land in the row's fresh pages, attention reads the shared prefix,
        and only ``last_index`` projects through lm_head."""
        logits, view = decode_multi_step(
            params, view, torch.as_tensor(toks, device=self.device),
            self.cfg, last_index=last_index, mesh=self._step_mesh)
        return logits[:, 0], view

    def _bucket_prefill(self, params, cache, req: Request, bi: int,
                        row_pt: np.ndarray):
        """Cold admission (no prefix hit): bucket-padded prefill and the
        page-wise pool insert. Returns (cache, next-token logits)."""
        n = len(req.tokens)
        pad = _bucket(n)
        toks = np.zeros((1, pad), np.int64)
        toks[0, :n] = np.asarray(req.tokens, np.int64)
        logits, (kv_k, kv_v) = self._prefill_one(params, toks, n - 1)
        cache = self._insert_row_paged(cache, kv_k, kv_v, bi, n,
                                       -(-pad // self.page_size), row_pt)
        return cache, logits

    def _admit_row(self, params, cache, req: Request, bi: int,
                   sampling: SamplingParams, gen):
        n = len(req.tokens)
        if not self.prefix_cache:
            need = self._pages_needed(req)
            pages = self._alloc.take(bi, need)
            row_pt = np.full((self.n_pages,), -1, np.int32)
            row_pt[:need] = pages
            self._note_windowed_row(bi, row_pt, need, n)
            cache, logits = self._bucket_prefill(params, cache, req, bi,
                                                 row_pt)
            first, lp = self._sample_first(logits, sampling, gen)
            return cache, first, lp

        all_hashes, lookup_hashes, hits, cs, span_pages = \
            self._prefix_plan(req)
        pages, got = self._alloc.take(bi, lookup_hashes, span_pages)
        assert got == hits, (got, hits)
        row_pt = np.full((self.n_pages,), -1, np.int32)
        row_pt[:span_pages] = pages
        if hits == 0:
            cache, logits = self._bucket_prefill(params, cache, req, bi,
                                                 row_pt)
        else:
            cached = hits * self.page_size
            suffix = np.asarray(req.tokens[cached:], np.int64)
            n_chunks = -(-len(suffix) // cs)
            toks = np.zeros((1, n_chunks * cs), np.int64)
            toks[0, :len(suffix)] = suffix
            view = self._row_view(cache, row_pt, cached)
            last = (len(suffix) - 1) % cs
            for ci in range(n_chunks):
                logits, view = self._suffix_chunk(
                    params, view, toks[:, ci * cs:(ci + 1) * cs], last)
            # pad appends past the prompt are dead: the length caps at n
            # and later decode appends overwrite those slots
            cache.page_table[bi] = self._vec(row_pt, torch.int32)
            cache.length[bi] = n
            self._stats["prefix_hit_tokens"] += cached
        self._alloc.register(all_hashes, pages[:len(all_hashes)])
        self._stats["admitted_tokens"] += n
        first, lp = self._sample_first(logits, sampling, gen)
        return cache, first, lp

    # --- decode-interleaved chunked admission -------------------------------

    def _admission_start(self, req: Request, bi: int,
                         gen) -> "_Admission":
        """Reserve pages and stage ``req``'s prompt as suffix chunks; no
        device work happens here."""
        n = len(req.tokens)
        if self.prefix_cache:
            all_hashes, lookup_hashes, hits, cs, span_pages = \
                self._prefix_plan(req)
            pages, got = self._alloc.take(bi, lookup_hashes, span_pages)
            assert got == hits, (got, hits)
        else:
            all_hashes, hits = [], 0
            cs = min(self.prefill_chunk, _bucket(n))
            span = max(n + req.max_new, (-(-n // cs)) * cs)
            span_pages = -(-span // self.page_size)
            if self._windowed_paging:
                # growth pages come on demand: the prefill and one block
                span_pages = self._windowed_admit_pages(n, cs)
            pages = self._alloc.take(bi, span_pages)
        cached = hits * self.page_size
        suffix = np.asarray(req.tokens[cached:], np.int64)
        n_chunks = -(-len(suffix) // cs)
        toks = np.zeros((1, n_chunks * cs), np.int64)
        toks[0, :len(suffix)] = suffix
        row_pt = np.full((self.n_pages,), -1, np.int32)
        row_pt[:span_pages] = pages
        return _Admission(req=req, bi=bi, gen=gen, toks=toks, cs=cs,
                          n_chunks=n_chunks, ci=0,
                          last=(len(suffix) - 1) % cs, row_pt=row_pt,
                          pages=list(pages), all_hashes=all_hashes,
                          cached=cached)

    def _admission_advance(self, params, cache, st: "_Admission"):
        """Run one prefill chunk of the pending admission against the pool
        (in place, through a one-row view). Returns (cache, next-token
        logits); the logits are not None exactly when the admission
        finished, when the row's table and length are installed and (with
        the prefix cache) its full pages registered."""
        lo = st.ci * st.cs
        view = self._row_view(cache, st.row_pt, st.cached + lo)
        logits, view = self._suffix_chunk(
            params, view, st.toks[:, lo:lo + st.cs], st.last)
        st.ci += 1
        if st.ci < st.n_chunks:
            return cache, None
        n = len(st.req.tokens)
        cache.page_table[st.bi] = self._vec(st.row_pt, torch.int32)
        cache.length[st.bi] = n
        self._note_windowed_row(st.bi, st.row_pt,
                                int((st.row_pt >= 0).sum()), n)
        if self.prefix_cache:
            self._alloc.register(st.all_hashes,
                                 st.pages[:len(st.all_hashes)])
            self._stats["prefix_hit_tokens"] += st.cached
            self._stats["admitted_tokens"] += n
        return cache, logits

    def _serve_interleaved(self, params, requests: Sequence[Request], *,
                           sampling: SamplingParams = SamplingParams(),
                           eos_id: Optional[int] = None,
                           seed: int = 0) -> Dict[int, RequestResult]:
        """`serve` with chunked-prefill admission: at most one admission in
        flight, advanced one ``prefill_chunk`` per scheduler iteration,
        with one decode block of the running rows between chunks, so a
        running row's stall is bounded by one chunk. Greedy results equal
        the batch-admission loop's."""
        self._check_requests(params, requests)
        B = self.max_batch
        queue = deque(requests)
        cache = self.init_cache()
        dparams = self.decode_params(params)
        slot: List[Optional[Request]] = [None] * B
        gens: List[Optional[torch.Generator]] = [None] * B
        emitted: List[List[int]] = [[] for _ in range(B)]
        lps = [[] for _ in range(B)] if self.return_logprobs else None
        cur = np.zeros((B,), np.int32)
        results: Dict[int, RequestResult] = {}
        eos = -1 if eos_id is None else int(eos_id)
        pending: Optional[_Admission] = None

        while queue or any(s is not None for s in slot) or pending:
            if pending is None and queue:
                for bi in range(B):
                    if slot[bi] is None and self._can_admit(queue[0], bi):
                        req = queue.popleft()
                        pending = self._admission_start(
                            req, bi, self._generator(seed, req))
                        break
            if pending is not None:
                # admission prefill keeps the bf16 params, as batch
                # admission does
                cache, logits = self._admission_advance(params, cache,
                                                        pending)
                if logits is not None:
                    st, pending = pending, None
                    first, flp = self._sample_first(logits, sampling, st.gen)
                    slot[st.bi] = st.req
                    gens[st.bi] = st.gen
                    emitted[st.bi] = [first]
                    if lps is not None:
                        lps[st.bi] = [flp]
                    cur[st.bi] = first
                    self._maybe_finish(st.bi, slot, emitted, results,
                                       eos_id, lps)
            if not any(s is not None for s in slot):
                continue
            budget = [slot[bi].max_new - len(emitted[bi])
                      if slot[bi] is not None else 0 for bi in range(B)]
            toks, lp, _, _, _ = self._decode_block(
                dparams, cache, self._vec(cur, torch.int32),
                self._vec([s is not None for s in slot], torch.bool),
                self._vec(budget, torch.int32), eos, sampling, gens)
            nxt = toks.cpu().numpy()
            lp = lp.cpu().numpy() if lps is not None else None
            self._consume(nxt, lp, slot, emitted, results, eos_id, lps,
                          cur=cur)
            cache = self._post_block(cache, slot, emitted)
        return results


@dataclasses.dataclass(frozen=True)
class SpeculativeContinuousEngine(ContinuousEngine):
    """Continuous batching with speculative rounds: the scheduler's model
    step is a draft-propose and verify round instead of one decode step.

    Every round all ``max_batch`` rows run gamma + 1 draft steps and one
    target :func:`decode_multi_step` verify (both gated by the live-row
    mask); each row keeps its own accepted prefix, and a row whose request
    finishes (EOS or budget) frees its slot for the next queued request
    before the next round, so each live row emits up to ``gamma + 1``
    tokens a target forward. Greedy emits exactly the target-greedy chain;
    ``sampling.temperature > 0`` runs the Leviathan rule (exact target
    distribution, as :class:`SpeculativeEngine`), each request drawing with
    its own generator. The draft keeps a dense cache. Rollback is a reset
    of each cache's per-row length, each cache in its own tensor.

    ``step_block`` is not used: a round already spreads the host sync over
    up to ``gamma + 1`` tokens a row. :attr:`round_stats` counts the last
    serve call's rounds and drafted and accepted tokens."""

    draft_cfg: Optional[ModelConfig] = None
    gamma: int = 4

    def __post_init__(self):
        super().__post_init__()
        if self.draft_cfg is None:
            raise ValueError("draft_cfg is required")
        if self.cfg.vocab != self.draft_cfg.vocab:
            raise ValueError("the target's and the draft's vocabularies "
                             "differ")
        if self.gamma < 1:
            raise ValueError(f"gamma {self.gamma} < 1")
        if self.return_logprobs:
            raise ValueError(
                "speculative decoding does not report logprobs (accepted "
                "tokens come from the draft/verify rule, not one softmax) "
                "-- use a non-speculative engine for logprobs")

    @property
    def _draft_eng(self) -> ContinuousEngine:
        return ContinuousEngine(self.draft_cfg, self.s_max, self.max_batch,
                                self.cache_dtype, device=self.device)

    @property
    def _spec(self) -> SpeculativeEngine:
        return SpeculativeEngine(self.cfg, self.draft_cfg, self.s_max,
                                 self.gamma, self.cache_dtype,
                                 device=self.device)

    @property
    def round_stats(self) -> Dict[str, int]:
        """The last serve call's ``rounds``, ``drafted`` and ``accepted``
        draft tokens."""
        return getattr(self, "_round_stats", {})

    # --- round pieces ------------------------------------------------------

    def _draft_round(self, draft_params, dcache, t, active):
        return self._spec._draft_run(draft_params, dcache, t, active,
                                     mesh=self._step_mesh)

    def _verify_round(self, params, tcache, run, active):
        return self._spec._verify(params, tcache, run, active,
                                  mesh=self._step_mesh)

    def _draft_round_sampled(self, draft_params, dcache, t, sampling, gens,
                             active):
        return self._spec._draft_run_sampled(draft_params, dcache, t,
                                             sampling, gens, active,
                                             mesh=self._step_mesh)

    def _verify_round_sampled(self, params, tcache, run, drafts, qdist,
                              sampling, gens, active):
        return self._spec._verify_sampled(params, tcache, run, drafts,
                                          qdist, sampling, gens, active,
                                          mesh=self._step_mesh)

    def serve(self, params, draft_params, requests: Sequence[Request], *,
              sampling: SamplingParams = SamplingParams(),
              eos_id: Optional[int] = None,
              seed: int = 0) -> Dict[int, RequestResult]:
        """Run all requests to completion; returns {request.id: result}."""
        self._check_requests(params, [])
        if draft_params["embed"].device != self.device:
            raise ValueError(f"draft_params['embed'] is on "
                             f"{draft_params['embed'].device}, but the "
                             f"engine runs on {self.device}")
        for r in requests:
            if len(r.tokens) + r.max_new + self.gamma > self.s_max:
                raise ValueError(
                    f"request {r.id}: prompt ({len(r.tokens)}) + max_new "
                    f"({r.max_new}) + gamma ({self.gamma}) exceeds cache "
                    f"capacity s_max={self.s_max}")
        B, gamma = self.max_batch, self.gamma
        sampled = sampling.temperature > 0.0
        deng = self._draft_eng
        queue = deque(requests)
        tcache = self.init_cache()
        dcache = deng.init_cache()
        # the rounds run on the (optionally int8) decode weights; admission
        # prefill keeps the bf16 params
        tparams = self.decode_params(params)
        dparams = self.decode_params(draft_params)
        slot: List[Optional[Request]] = [None] * B
        gens: List[Optional[torch.Generator]] = [None] * B
        emitted: List[List[int]] = [[] for _ in range(B)]
        cur = np.zeros((B,), np.int32)
        results: Dict[int, RequestResult] = {}
        stats = {"rounds": 0, "drafted": 0, "accepted": 0}
        object.__setattr__(self, "_round_stats", stats)

        def admit():
            nonlocal tcache, dcache
            for bi in range(B):
                if slot[bi] is not None or not queue:
                    continue
                if not self._can_admit(queue[0], bi):
                    continue
                req = queue.popleft()
                gens[bi] = self._generator(seed, req)
                tcache, first, _ = self._admit_row(params, tcache, req, bi,
                                                   sampling, gens[bi])
                # the draft's own first token is not used: greedy, so it
                # draws nothing from the request's generator
                dcache, _, _ = deng._admit_row(draft_params, dcache, req, bi,
                                               SamplingParams(), None)
                slot[bi] = req
                emitted[bi] = [first]
                cur[bi] = first
                self._maybe_finish(bi, slot, emitted, results, eos_id)
                if slot[bi] is None:
                    # finished at its first token: the free row keeps no
                    # cache state
                    tcache.length[bi] = 0
                    dcache.length[bi] = 0

        while queue or any(s is not None for s in slot):
            admit()
            if not any(s is not None for s in slot):
                continue  # everything admitted finished at its first token
            live = [s is not None for s in slot]
            active = self._vec(live, torch.bool)
            t = self._vec(cur, torch.int32)
            base_len = tcache.length.cpu().numpy().copy()
            if sampled:
                row_gens = [g if on else None for g, on in zip(gens, live)]
                drafts, qdist, dcache = self._draft_round_sampled(
                    dparams, dcache, t, sampling, row_gens, active)
                run = torch.cat([t[:, None], drafts], dim=1)
                accept_m, fallback, tcache = self._verify_round_sampled(
                    tparams, tcache, run, drafts, qdist, sampling, row_gens,
                    active)
                acc_np = accept_m.cpu().numpy()
                c_np = fallback.cpu().numpy()
            else:
                drafts, dcache = self._draft_round(dparams, dcache, t,
                                                   active)
                run = torch.cat([t[:, None], drafts], dim=1)
                choices, tcache = self._verify_round(tparams, tcache, run,
                                                     active)
                c_np = choices.cpu().numpy()
                acc_np = drafts.cpu().numpy() == c_np[:, :gamma]
            d_np = drafts.cpu().numpy()
            stats["rounds"] += 1
            keep = base_len.copy()
            for bi in range(B):
                if slot[bi] is None:
                    continue
                a = 0
                while a < gamma and acc_np[bi, a]:
                    a += 1
                stats["drafted"] += gamma
                stats["accepted"] += a
                # emitted up to EOS or the budget; the slot frees either
                # way, and admission resets the row's lengths
                for tok in [int(x) for x in d_np[bi, :a]] + [int(c_np[bi, a])]:
                    emitted[bi].append(tok)
                    cur[bi] = tok
                    self._maybe_finish(bi, slot, emitted, results, eos_id)
                    if slot[bi] is None:
                        break
                if slot[bi] is not None:
                    keep[bi] = base_len[bi] + a + 1
            tcache.length.copy_(self._vec(keep, torch.int32))
            dcache.length.copy_(self._vec(keep, torch.int32))
        return results


@dataclasses.dataclass(frozen=True)
class PagedSpeculativeContinuousEngine(SpeculativeContinuousEngine,
                                       PagedContinuousEngine):
    """Speculative continuous batching over a paged target cache: the
    target's rows take pages from the pool through the allocator (the C++
    host core when it builds) and may share prefix pages
    (``prefix_cache``); the draft keeps a dense cache (it is small, and its
    appends and rollbacks stay on the dense path). Verify rounds run
    :func:`decode_multi_step` against the pool through the rows' page
    tables; rollback resets a row's length, and its reserved pages absorb
    the next round's run. Greedy tokens equal the dense speculative
    engine's. Rows keep whole-span reservations, with the verify's
    ``gamma + 1`` overhang (no rolling window pages here)."""

    def __post_init__(self):
        super().__post_init__()
        if self.interleave_admission or self.host_overlap:
            raise ValueError(
                "speculative rounds already spread the host sync; "
                "interleave_admission/host_overlap do not compose here")

    @property
    def _windowed_paging(self) -> bool:
        return False

    def _pages_needed(self, req: Request) -> int:
        # a verify may append gamma + 1 tokens past the kept prefix before
        # the rollback trims the length
        pad = _bucket(len(req.tokens))
        span = max(pad, len(req.tokens) + req.max_new + self.gamma + 1)
        if self.prefix_cache:
            span = max(span, len(req.tokens)
                       + min(self.prefill_chunk, pad))
        return -(-span // self.page_size)

    def serve(self, params, draft_params, requests: Sequence[Request],
              **kw) -> Dict[int, RequestResult]:
        return self._with_allocator(
            requests, lambda: SpeculativeContinuousEngine.serve(
                self, params, draft_params, requests, **kw))


@dataclasses.dataclass(frozen=True)
class ShardedContinuousEngine(ContinuousEngine):
    """Continuous batching over a sequence-sharded (multi-card) cache.

    The host scheduler of :class:`ContinuousEngine` runs on every rank of
    ``mesh`` (a ``make_usp_mesh`` mesh) and makes the same decisions from
    the same replicated tokens; each rank holds its block of ``s_max / n``
    slots of every row. Admission prefills one request USP-sharded
    (:meth:`ShardedEngine.prefill_block` with the true last token's index,
    any training layout) and writes the rank's block into the batch row in
    place (kernel B6 through the one-entry table [[row]]: only the batch
    axis moves); each decode step is the sharded :func:`decode_step`
    (owner-routed append, attention merged over the ranks), gated by the
    ``active`` rows. Prompt buckets are powers of two (then multiples of
    2048), so they divide over a power-of-two shard count. ``device``: the
    mesh's (None). Requests sample from generators seeded alike on every
    rank, so every rank draws the same tokens."""

    mesh: Optional[object] = None
    axes: Optional[MeshAxes] = None

    def __post_init__(self):
        if self.mesh is None:
            raise ValueError(f"{type(self).__name__} needs a mesh")
        check_seq_mesh(self.mesh, type(self).__name__)
        object.__setattr__(self, "device",
                           step_device(self.mesh, self.device))
        if self.axes is None:
            object.__setattr__(self, "axes", MeshAxes())
        super().__post_init__()
        if self.s_max % self.mesh.n_seq:
            raise ValueError(f"s_max {self.s_max} does not divide over the "
                             f"{self.mesh.n_seq} sequence ranks")

    @property
    def _sub(self) -> ShardedEngine:
        return ShardedEngine(self.cfg, self.mesh, self.s_max,
                             self.cache_dtype, self.axes,
                             device=self.device)

    @property
    def _step_mesh(self):
        return self.mesh

    def init_cache(self):
        return self._sub.init_cache(self.max_batch)

    def _prefill_block(self, params, req: Request):
        """The request's bucket-padded USP prefill: (the true last token's
        logits (1, vocab), this rank's block of its K/V (L, 1, m, h_kv,
        d))."""
        n = len(req.tokens)
        toks = np.zeros((1, _bucket(n)), np.int64)
        toks[0, :n] = np.asarray(req.tokens, np.int64)
        return self._sub.prefill_block(
            params, torch.as_tensor(toks, device=self.device), n - 1)

    def _admit_row(self, params, cache, req: Request, bi: int,
                   sampling: SamplingParams, gen):
        logits, (kv_k, kv_v) = self._prefill_block(params, req)
        if kv_k.shape[2]:
            cache = self._insert_row(cache, kv_k, kv_v, bi, len(req.tokens))
        cache.length[bi] = len(req.tokens)
        first, lp = self._sample_first(logits, sampling, gen)
        return cache, first, lp


@dataclasses.dataclass(frozen=True)
class ShardedSpeculativeContinuousEngine(SpeculativeContinuousEngine,
                                         ShardedContinuousEngine):
    """Speculative continuous batching over a sequence-sharded cache: the
    scheduler and acceptance rule of :class:`SpeculativeContinuousEngine`
    with the target's AND the draft's caches sharded over ``mesh``. The
    draft steps and the verify run the sharded steps; the verify's run of
    gamma + 1 tokens appends across the block boundary it straddles and
    merges its attention per token. Each request's generator is seeded
    alike on every rank, so every rank draws the same accept and fallback
    decisions."""

    @property
    def _draft_eng(self) -> ContinuousEngine:
        return ShardedContinuousEngine(
            self.draft_cfg, self.s_max, self.max_batch, self.cache_dtype,
            device=self.device, mesh=self.mesh, axes=self.axes)
