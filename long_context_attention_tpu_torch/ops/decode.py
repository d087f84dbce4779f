"""Decode on Hopper: in-place cache append and decode attention.

Counterpart of ``long_context_attention_tpu/ops/decode.py``, for the dense
KV cache (layer-stacked or not) and the paged pool, in the four cache
dtypes (bf16, int8, fp8 e4m3 and int4 packed two per byte along d):

* :func:`cache_append_rows` is the wrapper of kernel B6
  (``csrc/cache_append.cu``): it quantizes one run of new bf16 K/V rows per
  batch row to the cache's dtype and writes them, with their scales, into
  a :class:`KVCache` or :class:`PagedKVCache` IN PLACE, K and V (and every
  layer, for a row's insert) in one launch; the cache's checks and the
  kernel's constant arguments are made once per cache object.
  :func:`cache_append` (JAX's API) writes rows already quantized, through
  the same kernel's byte copy (rows of opaque bytes: d, 2d or d / 2).
* :func:`decode_attention` quantizes / folds the query as the JAX wrapper
  does and calls :func:`decode_attention_core`, the wrapper of kernel B7,
  which attends the query rows of every kv head to the cache up to per-row
  lengths: one token per row, or a run of n tokens per row (a
  teacher-forced run), each at its own position. B7 has two kernels,
  chosen by shape (:func:`decode_route`): ``csrc/decode_attention.cu``
  (one token, short runs and odd tiles: groups of 8 query rows on the
  CUDA cores, each JAX kv tile cut into spans of one block each, a thread
  block cluster per tile, K and V by bulk async copies) and
  ``csrc/decode_run_sm90.cu`` (the runs whose G = g * n rows per kv head
  exceed 8: 64-row wgmma blocks over one pass of the cache).

B7 has the JAX kernel's three paths: bf16 (a bf16 cache); the s8 path
(``mxu_int8``, an int8 or int4 cache: s8 x s8 products, q row-quantized,
P requantized per kv tile); and the dequant-cast path (fp8 always, int8 and
int4 under ``mxu_int8=False``: bf16 q against K and V widened exactly to
bf16, scales applied in fp32, P rounded to bf16 after V's scale).

Paged mode (``page_table``): the cache arrays are a pool of pages
(L, P, h_kv, page, d) and logical slot s of row b lives in pool page
``page_table[b, s // page]`` at offset ``s % page``; only the addressing
changes, the masks stay in logical positions.

Each wrapper runs its plain version (``*_plain``, same arithmetic) for CPU
tensors and launches its kernel, or raises, for CUDA tensors. Decode takes
a sliding window with StreamingLLM sinks, a logit softcap, ALiBi slopes and
an explicit kv split count (``kv_splits``, dense caches); the kernel walks
a row's sink tiles and window band only. A sequence-sharded cache
(``serving/sharded.py``) passes each rank's slice of the global window as
per-row columns instead (``first_cols``, ``sink_cols``, ``sink_band``).
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Tuple

import torch

from long_context_attention_tpu_torch.ops import _build
from long_context_attention_tpu_torch.ops.flash import _CLAMP, _LOG2E, _fold
from long_context_attention_tpu_torch.ops.kv_cache import (
    _STORAGE, _dtype_name, _widen, quantize_kv)
from long_context_attention_tpu_torch.ops.merge import merge_partials
from long_context_attention_tpu_torch.utils.config import NEG_INF

__all__ = ["cache_append", "cache_append_plain", "cache_append_rows",
           "cache_append_rows_plain", "decode_attention",
           "decode_attention_core", "decode_attention_core_plain",
           "decode_launch", "decode_query_operands", "decode_route",
           "decode_run_plan", "decode_run_smem", "decode_token_reads",
           "decode_token_span", "reference_block_kv", "DecodeLaunch"]

_GROUP_ROWS = 8        # query rows per block of decode_attention.cu (MAXG)
_RUN_ROWS = 128        # query rows per block of decode_run_sm90.cu (BR)
_RUN_CHUNK = 128       # kv columns per chunk of decode_run_sm90.cu (CH)
# decode_run's blocks a launch aims at: one block fills an SM, and several
# short waves let the block scheduler even out rows of other lengths
_RUN_TARGET_BLOCKS = 528
# decode_attention.cu: K bytes a span aims at (its ring's RING chunk slots
# of CHB bytes: the whole K span in flight at once) and the most spans a
# tile's cluster takes (the portable cluster size)
_SPAN_BYTES = 32768
_MAX_CLUSTER = 8


# ---------------------------------------------------------------------------
# B6: cache append
# ---------------------------------------------------------------------------


def cache_append_plain(k_cache, v_cache, k_new, v_new, append_pos,
                       k_scale=None, v_scale=None, ks_new=None, vs_new=None,
                       *, layer: int = 0, page_table=None):
    """Plain version of kernel B6, IN PLACE on the layered cache.

    k_cache, v_cache (L, b, h_kv, s_max, d), or the pool (L, P, h_kv, page,
    d) with ``page_table`` (b, n_pages); k_new, v_new (b, h_kv, n, d);
    scales (L, b or P, h_kv, 1, s_max or page) with new scales (b, h_kv,
    n). Token t of row b lands at logical slot append_pos[b] + t when that
    slot is in [0, capacity) (s_max, or n_pages * page); other tokens write
    nothing. A paged slot s lands in pool page page_table[b, s // page]
    (clamped into the pool) at offset s % page."""
    b, h_kv, n, d = k_new.shape
    slot_dim = k_cache.shape[3]
    cap = (page_table.shape[1] * slot_dim if page_table is not None
           else slot_dim)
    # rows are copied as bytes: an fp8 cache through its uint8 view
    k_cache, v_cache, k_new, v_new = (
        t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
        for t in (k_cache, v_cache, k_new, v_new))
    slots = (append_pos.to(torch.long)[:, None]
             + torch.arange(n, device=append_pos.device)[None])
    bi, ti = ((slots >= 0) & (slots < cap)).nonzero(as_tuple=True)
    si = slots[bi, ti]
    if page_table is not None:
        pg = page_table.to(device=si.device, dtype=torch.long)[
            bi, si // slot_dim].clamp(0, k_cache.shape[1] - 1)
        si = si % slot_dim
    else:
        pg = bi
    k_cache[layer, pg, :, si] = k_new[bi, :, ti]
    v_cache[layer, pg, :, si] = v_new[bi, :, ti]
    if k_scale is not None:
        ksn = ks_new.reshape(b, h_kv, n).float()
        vsn = vs_new.reshape(b, h_kv, n).float()
        k_scale[layer, pg, :, 0, si] = ksn[bi, :, ti]
        v_scale[layer, pg, :, 0, si] = vsn[bi, :, ti]


def cache_append(k_cache, v_cache, k_new, v_new, append_pos,
                 k_scale=None, v_scale=None, ks_new=None, vs_new=None, *,
                 layer=None, interpret=None, page_table=None):
    """Splice a run of n tokens per batch row into the cache IN PLACE
    (kernel B6).

    ``k_cache``/``v_cache``: (b, h_kv, s_max, d), or the stacked
    (L, b, h_kv, s_max, d) with ``layer`` (an int); bf16, int8, fp8 or
    packed int4 (uint8, d // 2 bytes a row).
    ``k_new``/``v_new``: (b, h_kv, n, d) in the cache's storage dtype.
    ``append_pos``: (b,) int32 first slot per row; slots outside
    [0, s_max) are skipped, so ``append_pos = -n`` skips a row.
    Quantized caches pass scales (.., b, h_kv, 1, s_max) and new scales
    (b, h_kv, n). ``page_table``: (b, n_pages) int32, the paged pool
    (P, h_kv, page, d) (stacked (L, P, ...) with ``layer``; scales
    (.., P, h_kv, 1, page)): logical slot s of row b lives in pool page
    ``page_table[b, s // page]`` at offset ``s % page``, the capacity is
    n_pages * page, and a run may straddle a page. ``interpret`` is
    accepted for API parity. Returns the same tensors it was given:
    ``(k_cache, v_cache)`` or with the scales."""
    del interpret
    layered = layer is not None
    li = int(layer) if layered else 0
    kc = k_cache if layered else k_cache[None]
    vc = v_cache if layered else v_cache[None]
    quant = k_scale is not None
    ks = None if not quant else (k_scale if layered else k_scale[None])
    vs = None if not quant else (v_scale if layered else v_scale[None])
    if k_cache.device.type == "cpu":
        cache_append_plain(kc, vc, k_new, v_new, append_pos, ks, vs,
                           ks_new, vs_new, layer=li, page_table=page_table)
    else:
        _cache_append_cuda(kc, vc, k_new, v_new, append_pos, ks, vs,
                           ks_new, vs_new, li, page_table)
    if quant:
        return k_cache, v_cache, k_scale, v_scale
    return k_cache, v_cache


# B6's argument array (csrc/cache_append.cu Arg): its int64 slots
_A_KIND, _A_DST, _A_DSC, _A_SRC, _A_SSC, _A_POS, _A_PT, _A_ST = (
    0, 1, 3, 5, 7, 9, 10, 11)
(_A_NL, _A_LAYER0, _A_B, _A_N, _A_HKV, _A_POS0, _A_CAP, _A_POOL, _A_PAGE,
 _A_NPAGES, _A_ROW_BYTES, _A_COUNT) = range(19, 31)
# B6's kinds (csrc/cache_append.cu Kind): the byte copy of stored rows, and
# one per cache dtype from bf16 rows
_B6_COPY = 0
_B6_KIND = {"bfloat16": 1, "int8": 2, "float8_e4m3fn": 3, "int4": 4}


def _b6_args(kind: int, kc, vc, ks, vs, h_kv: int, pool: int, page: int,
             row_bytes: int):
    """B6's argument array with the cache's slots filled."""
    a = (ctypes.c_longlong * _A_COUNT)()
    a[_A_KIND] = kind
    for t, (x, s) in enumerate(((kc, ks), (vc, vs))):
        a[_A_DST + t] = x.data_ptr()
        a[_A_DSC + t] = 0 if s is None else s.data_ptr()
    a[_A_HKV], a[_A_POOL], a[_A_PAGE] = h_kv, pool, page
    a[_A_ROW_BYTES] = row_bytes
    return a


def _page_table_operand(page_table, b: int, dev):
    """The (b, n_pages) int32 page table as the kernels take it."""
    pt = page_table.to(device=dev, dtype=torch.int32).contiguous()
    if pt.dim() != 2 or pt.shape[0] != b:
        raise ValueError(f"page_table must be (b={b}, n_pages), got "
                         f"{tuple(pt.shape)}")
    return pt


def _cache_append_cuda(kc, vc, k_new, v_new, append_pos, ks, vs, ks_new,
                       vs_new, layer: int, page_table=None) -> None:
    L, pool, h_kv, slot_dim, d = kc.shape
    b, n = k_new.shape[0], k_new.shape[2]
    dev = kc.device
    if kc.dtype not in _STORAGE.values():
        raise ValueError(f"a {kc.dtype} cache is no cache storage dtype")
    for name, t in (("k_cache", kc), ("v_cache", vc)):
        if t.shape != kc.shape or t.dtype != kc.dtype or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {kc.dtype} "
                             f"{tuple(kc.shape)} tensor on {dev}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} layers")
    row_bytes = d * kc.element_size()
    if row_bytes % 16:
        raise ValueError("cache rows must be a multiple of 16 bytes")
    k_new = k_new.to(kc.dtype).contiguous()
    v_new = v_new.to(kc.dtype).contiguous()
    if k_new.shape != (b, h_kv, n, d) or v_new.shape != k_new.shape:
        raise ValueError(f"new tokens must be (b, h_kv, n, d), got "
                         f"{tuple(k_new.shape)}")
    pt = None
    if page_table is not None:
        pt = _page_table_operand(page_table, b, dev)
        n_pages, cap = pt.shape[1], pt.shape[1] * slot_dim
    else:
        if pool != b:
            raise ValueError(f"a dense cache holds {pool} rows, the new "
                             f"tokens {b}")
        n_pages, cap = 1, slot_dim
    quant = ks is not None
    if quant:
        for name, t in (("k_scale", ks), ("v_scale", vs)):
            if t.shape != (L, pool, h_kv, 1, slot_dim) \
                    or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous fp32 "
                                 f"{(L, pool, h_kv, 1, slot_dim)}")
        ks_new = ks_new.reshape(b, h_kv, n).float().contiguous()
        vs_new = vs_new.reshape(b, h_kv, n).float().contiguous()
    pos = append_pos.to(device=dev, dtype=torch.int32).contiguous()
    if pos.shape != (b,):
        raise ValueError("append_pos must be (b,)")
    a = _b6_args(_B6_COPY, kc, vc, ks, vs, h_kv, pool, slot_dim,
                 row_bytes)
    # the new rows as bytes: (b, h_kv, n, row_bytes), one layer
    strides = (0, h_kv * n * row_bytes, row_bytes, n * row_bytes)
    a[_A_SRC:_A_ROW_BYTES] = (
        k_new.data_ptr(), v_new.data_ptr(),
        ks_new.data_ptr() if quant else 0, vs_new.data_ptr() if quant else 0,
        pos.data_ptr(), 0 if pt is None else pt.data_ptr(), *strides,
        *strides, 1, layer, b, n, h_kv, 0, cap, pool, slot_dim, n_pages)
    _build.KERNELS["cache_append"](ctypes.addressof(a),
                                   _build.stream_ptr(dev))


def _run_shape(k, v, layer, L: int, h_kv: int):
    """(b, n) of new rows (b, n, h_kv, d), or (L, b, n, h_kv, d) for every
    layer (``layer`` None)."""
    rank = 5 if layer is None else 4
    shape = k.shape
    if (v.shape != shape or len(shape) != rank or shape[-2] != h_kv
            or (rank == 5 and shape[0] != L)):
        lead = f"{L}, " if layer is None else ""
        raise ValueError(f"new K/V rows must be ({lead}b, n, h_kv={h_kv}, "
                         f"d), got {tuple(shape)} and {tuple(v.shape)}")
    return shape[-4], shape[-3]


class _RowsPlan:
    """B6's launch on one cache object: the cache's arrays checked, and the
    argument array's constant slots filled, once (the cache's tensors by
    identity: a cache whose arrays were replaced gets a new plan)."""

    def __init__(self, cache):
        kc, vc, ks, vs = cache.k, cache.v, cache.k_scale, cache.v_scale
        pt = getattr(cache, "page_table", None)
        L, pool, h_kv, page, dv = kc.shape
        dev = kc.device
        name = _dtype_name(kc)
        d = 2 * dv if name == "int4" else dv
        self.kernel = _build.kernel("cache_append", d, "B6")
        self.d = d
        for label, t in (("k", kc), ("v", vc)):
            if t.shape != kc.shape or t.dtype != kc.dtype \
                    or t.device != dev or not t.is_contiguous():
                raise ValueError(f"cache.{label} must be a contiguous "
                                 f"{kc.dtype} {tuple(kc.shape)} tensor on "
                                 f"{dev}")
        quant = name != "bfloat16"
        for label, t in (("k_scale", ks), ("v_scale", vs)):
            if not quant:
                if t is not None:
                    raise ValueError(f"a bf16 cache has no {label}")
            elif (t is None or t.shape != (L, pool, h_kv, 1, page)
                  or t.dtype != torch.float32 or t.device != dev
                  or not t.is_contiguous()):
                raise ValueError(f"cache.{label} must be contiguous fp32 "
                                 f"{(L, pool, h_kv, 1, page)} on {dev}")
        self.tensors = (kc, vc, ks, vs, pt)
        self.L, self.pool, self.h_kv, self.page = L, pool, h_kv, page
        self.device, self.index = dev, kc.get_device()
        self.pt = None if pt is None else _table(pt, dev)
        self.args = _b6_args(_B6_KIND[name], kc, vc, ks, vs, h_kv, pool,
                             page, dv * kc.element_size())
        self.addr = ctypes.addressof(self.args)
        self.stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)

    def holds(self, cache) -> bool:
        t = self.tensors
        return (cache.k is t[0] and cache.v is t[1]
                and cache.k_scale is t[2] and cache.v_scale is t[3]
                and (t[4] is None or cache.page_table is t[4]))

    def launch(self, layer, k, v, append_pos, page_table) -> None:
        shape, st, sv = k.shape, k.stride(), v.stride()
        if layer is None:
            nl, layer0, lk, lv = self.L, 0, st[0], sv[0]
        else:
            nl, layer0, lk, lv = 1, int(layer), 0, 0
            if not 0 <= layer0 < self.L:
                raise ValueError(f"layer {layer} out of range for {self.L} "
                                 f"layers")
        kp, vp = k.data_ptr(), v.data_ptr()
        if (k.dtype is not torch.bfloat16 or v.dtype is not torch.bfloat16
                or v.shape != shape or len(shape) != 4 + (layer is None)
                or (layer is None and shape[0] != self.L)
                or shape[-2] != self.h_kv or shape[-1] != self.d
                or st[-1] != 1 or sv[-1] != 1
                or (st[-2] | st[-3] | st[-4] | sv[-2] | sv[-3] | sv[-4]
                    | lk | lv) % 4 or (kp | vp) % 8
                or k.get_device() != self.index
                or v.get_device() != self.index):
            raise ValueError(
                f"new K/V rows must be bf16 ({'L, ' * (layer is None)}b, n, "
                f"h_kv={self.h_kv}, d={self.d}) on {self.device}, d "
                f"contiguous, rows 8-byte aligned; got {k.dtype} "
                f"{tuple(shape)} strides {st} and {v.dtype} "
                f"{tuple(v.shape)} strides {sv} on {k.device}")
        b, n = shape[-4], shape[-3]
        if isinstance(append_pos, int):
            pos_ptr, pos0 = 0, append_pos
        else:
            if (append_pos.dtype is not torch.int32
                    or append_pos.get_device() != self.index
                    or not append_pos.is_contiguous()):
                append_pos = append_pos.to(self.device,
                                           torch.int32).contiguous()
            if append_pos.shape != (b,):
                raise ValueError(f"append_pos must be (b={b},), got "
                                 f"{tuple(append_pos.shape)}")
            pos_ptr, pos0 = append_pos.data_ptr(), 0
        pt = self.pt if page_table is None else _table(page_table,
                                                       self.device)
        if pt is None:
            if b != self.pool:
                raise ValueError(f"a dense cache holds {self.pool} rows, "
                                 f"the new rows {b}")
            pt_ptr, n_pages = 0, 1
        else:
            if pt.shape[0] != b:
                raise ValueError(f"the page table has {pt.shape[0]} rows, "
                                 f"the new rows {b}")
            pt_ptr, n_pages = pt.data_ptr(), pt.shape[1]
        # slots _A_SRC .. _A_NPAGES in one store
        self.args[_A_SRC:_A_ROW_BYTES] = (
            kp, vp, 0, 0, pos_ptr, pt_ptr, lk, st[-4], st[-3], st[-2], lv,
            sv[-4], sv[-3], sv[-2], nl, layer0, b, n, self.h_kv, pos0,
            n_pages * self.page, self.pool, self.page, n_pages)
        stream = (self.stream(self.index) if self.stream is not None
                  else _build.stream_ptr(self.device))
        self.kernel(self.addr, stream)


def _table(page_table, dev):
    """A page table as B6 reads it: (b, n_pages) contiguous int32 on the
    cache's device (anything else raises: no copy on the call's path)."""
    if (page_table.dim() != 2 or page_table.dtype != torch.int32
            or page_table.device != dev or not page_table.is_contiguous()):
        raise ValueError(f"page_table must be a contiguous (b, n_pages) "
                         f"int32 tensor on {dev}, got {page_table.dtype} "
                         f"{tuple(page_table.shape)} on {page_table.device}")
    return page_table


def cache_append_rows_plain(cache, layer, k, v, append_pos, *,
                            page_table=None) -> None:
    """Plain version of :func:`cache_append_rows`: each layer's rows through
    :func:`quantize_kv`, then :func:`cache_append_plain`, IN PLACE."""
    L = cache.k.shape[0]
    b, _ = _run_shape(k, v, layer, L, cache.k.shape[2])
    dt = cache.dtype
    pt = page_table if page_table is not None else getattr(
        cache, "page_table", None)
    if isinstance(append_pos, int):
        append_pos = torch.full((b,), append_pos, dtype=torch.int32,
                                device=cache.k.device)
    layers = range(L) if layer is None else (int(layer),)
    for i, li in enumerate(layers):
        kl, vl = (k[i], v[i]) if layer is None else (k, v)
        kq, ks = quantize_kv(kl.transpose(1, 2), dt)  # (b, h_kv, n, d)
        vq, vs = quantize_kv(vl.transpose(1, 2), dt)
        cache_append_plain(cache.k, cache.v, kq, vq, append_pos,
                           cache.k_scale, cache.v_scale, ks, vs, layer=li,
                           page_table=pt)


def cache_append_rows(cache, layer, k, v, append_pos, *, page_table=None):
    """Quantize new K/V rows to the cache's dtype and write them into a
    :class:`KVCache` or :class:`PagedKVCache` IN PLACE: kernel B6, one
    launch for K and V (and for every layer with ``layer=None``).

    ``k``, ``v``: (b, n, h_kv, d) rows of ``layer`` as the projection gives
    them (any strides with d contiguous), or (L, b, n, h_kv, d) for every
    layer with ``layer=None``; bf16 on the card. Token t of row b lands at
    logical slot append_pos[b] + t when that slot is in [0, capacity), as
    in :func:`cache_append` (``append_pos = -n`` skips a row); an int
    ``append_pos`` starts every row there. ``page_table``: (b, n_pages)
    int32, the table to write through in place of the cache's own (a
    dense cache is then a pool of its rows, one page of s_max slots each:
    ``[[r]]`` writes one row into cache row r). What lands in the cache is
    :func:`quantize_kv`'s values and scales, bit for bit. On the card the
    cache's checks and the kernel's constant arguments are made once per
    cache object; the call passes the rows in place. Returns the cache."""
    if not cache.k.is_cuda:
        cache_append_rows_plain(cache, layer, k, v, append_pos,
                                page_table=page_table)
        return cache
    plan = cache._rows_plan
    if plan is None or not plan.holds(cache):
        plan = cache._rows_plan = _RowsPlan(cache)
    plan.launch(layer, k, v, append_pos, page_table)
    return cache


# ---------------------------------------------------------------------------
# B7: decode attention
# ---------------------------------------------------------------------------

# The JAX kernel's scoped-VMEM working set (decode.py _vmem_est and its
# budget): the int8 path requantizes P per kv tile, so the tile -- and the
# split of a long run into sub-runs -- is part of the result, and the port
# picks both by the same rule to give the same numbers.
_VMEM_BUDGET = 12 * 2 ** 20


def _vmem_est(h_kv: int, G: int, d: int, bkv: int, itemsize: int) -> int:
    return (4 * h_kv * bkv * d * itemsize + 8 * h_kv * G * bkv
            + 8 * h_kv * G * d + 8 * h_kv * G * 128)


def _fit_run_tokens(h_kv: int, g: int, d: int, bkv: int,
                    itemsize: int) -> int:
    """Longest multi-token run whose working set fits the budget at kv tile
    ``bkv`` (the JAX package's rule)."""
    kv = 4 * h_kv * bkv * d * itemsize
    per_g = 8 * h_kv * (bkv + d + 128)
    return max(1, (_VMEM_BUDGET - kv) // per_g // g)


def reference_block_kv(block_kv: int, s_max: int, h_kv: int, rows: int,
                       d: int, itemsize: int, *, paged: bool = False) -> int:
    """The kv tile the JAX package's decode kernel picks at these shapes
    (its VMEM-fitting rule, decode.py:731-765) for ``rows`` = g * n query
    rows per kv head. Dense: from min(block_kv, s_max), halve while the
    working set is too large, then until the tile divides s_max. Paged
    (``s_max`` is then the page): from the page, step down through the
    page's 128-multiple divisors. The int8 path requantizes P per tile, so
    the tile is part of the result; the port uses the same tile to give the
    same numbers."""
    if paged:
        bkv = s_max
        while bkv > 128 and _vmem_est(h_kv, rows, d, bkv,
                                      itemsize) > _VMEM_BUDGET:
            bkv = next((c for c in range(bkv - 128, 127, -128)
                        if s_max % c == 0), 128)
        return bkv
    bkv = min(block_kv, s_max)
    while bkv > 128 and _vmem_est(h_kv, rows, d, bkv,
                                  itemsize) > _VMEM_BUDGET:
        bkv //= 2
    while s_max % bkv:
        bkv //= 2
    return bkv


def decode_run_plan(n_tok: int, h_kv: int, g: int, d: int, slot_dim: int,
                    itemsize: int, *, block_kv: int = 4096,
                    paged: bool = False) -> List[Tuple[int, int, int]]:
    """How :func:`decode_attention` runs a run of ``n_tok`` tokens: its
    sub-runs [start, end) and each one's kv tile, as the JAX wrapper splits
    a run too long for its working set (decode.py:696-728) and fits each
    sub-run's tile from its own g * n_sub rows. ``slot_dim`` is the cache's
    slot axis (s_max, or the page when ``paged``)."""
    bounds = [(0, n_tok)]
    if n_tok > 1:
        fit = _fit_run_tokens(h_kv, g, d, min(256, slot_dim), itemsize)
        if fit < n_tok:
            bounds = [(i, min(i + fit, n_tok))
                      for i in range(0, n_tok, fit)]
    return [(i, e, reference_block_kv(block_kv, slot_dim, h_kv, g * (e - i),
                                      d, itemsize, paged=paged))
            for i, e in bounds]


def _tile_of(cache, layer: int, c0: int, n: int, page_table, page: int,
             scales: bool = False):
    """Columns [c0, c0 + n) of every row of one layer: values (b, h_kv, n,
    d) from the dense cache (L, b, h_kv, s, d) or through the page table
    from the pool (L, P, h_kv, page, d); ``scales``: (b, h_kv, 1, n) from
    (L, b or P, h_kv, 1, s or page)."""
    if page_table is None:
        pg, off = slice(None), c0
    else:
        pg = page_table[:, c0 // page].long().clamp(0, cache.shape[1] - 1)
        off = c0 % page
    if scales:
        return cache[layer][pg, :, :, off:off + n]
    return cache[layer][pg, :, off:off + n]


def decode_attention_core_plain(q_in, q_rs, k_cache, v_cache, k_scale,
                                v_scale, lengths, *, layer: int,
                                block_kv: int, scale: float,
                                safe_softmax: bool = False,
                                window_left: int = -1, sink_tokens: int = 0,
                                softcap: float = 0.0, n_tok: int = 1,
                                page_table=None, alibi=None, kv_splits=None,
                                p8_log=None, first_cols=None,
                                sink_cols=None):
    """Plain version of kernel B7, tile by tile on the kernel's tile grid.

    q_in (b, h_kv, G, d): G = g * n_tok query rows per kv head, ordered
    (head, token); the s8 path: int8 with fp32 row scales q_rs (b, h_kv, G)
    that already carry the softmax scale (and log2e in the fast form), over
    an int8 or packed int4 cache; else bf16 (folded in the fast form) with
    q_rs None: the bf16 path, or with scales the dequant-cast path (fp8,
    int8 or int4 values widened to bf16). Cache (L, b, h_kv, s_max, d) and
    scales (L, b, h_kv, 1, s_max), or with ``page_table`` (b, n_pages) the
    pool (L, P, h_kv, page, d) and its scales (L, P, h_kv, 1, page), whose
    page ``block_kv`` divides. ``lengths`` counts every visible slot
    including the run: token i sits at q = length - n_tok + i and sees the
    columns [q - window_left, q] (all up to q when window_left < 0) and
    those below ``sink_tokens``; ``softcap`` caps the scores before the mask
    and needs the online form (``safe_softmax``). ``alibi`` (h_kv, G) fp32:
    each row's slope (times log2e in the fast form); s -= slope * (q -
    column) after the softcap, before the masks. In JAX's order of
    operations: s = q . k (fp32), times q's row scale (s8) or the softmax
    scale (online bf16 or cast), times k_scale[col]; p = exp...; l +=
    rowsum(p); p *= v_scale[col]; s8: P requantized per tile, int32 PV;
    else acc += bf16(p) . v. ``kv_splits``: JAX's split count (None: one),
    the tiles cut in that many runs of ceil(tiles / splits), each run's
    (out, lse) merged by :func:`merge_partials`. ``first_cols`` (b,) int:
    the sequence-sharded columns (JAX's), the UNCLIPPED first visible
    column of each row's token 0, token i's bound being first_cols + i; it
    replaces the window's bound (``window_left`` and ``sink_tokens`` then
    only size the kernel's walk), and ``sink_cols`` (b,) keeps each row's
    columns below it visible through that bound. ``lengths`` may then be
    negative (no visible column: out 0, lse -inf) or, on a run, past the
    slots (every column up to the run's bound visible). Every tile is
    visited here; the kernel skips those with no visible column, which add
    nothing (columns at or past a row's length are zeroed before use, so a
    page past the live prefix, or a negative rebased page id, is never
    used). ``p8_log``: a list to which the s8
    path appends each tile's (first column, requantized P) for tests.
    Returns fp32 out (b, h_kv, G, d) and lse (b, h_kv, G)."""
    slot_dim = k_cache.shape[3]
    cap = (page_table.shape[1] * slot_dim if page_table is not None
           else slot_dim)
    nk = -(-cap // block_kv)
    per = -(-nk // max(1, min(int(kv_splits or 1), nk)))
    parts = [_plain_tiles(q_in, q_rs, k_cache, v_cache, k_scale, v_scale,
                          lengths, layer, block_kv, scale, safe_softmax,
                          window_left, sink_tokens, softcap, n_tok,
                          page_table, alibi, range(t0 * block_kv,
                                                   min(t0 + per, nk)
                                                   * block_kv, block_kv),
                          p8_log, first_cols, sink_cols)
             for t0 in range(0, nk, per)]
    if len(parts) == 1:
        return parts[0]
    return merge_partials(torch.stack([o for o, _ in parts]),
                          torch.stack([l for _, l in parts]))


def _plain_tiles(q_in, q_rs, k_cache, v_cache, k_scale, v_scale, lengths,
                 layer, block_kv, scale, safe_softmax, window_left,
                 sink_tokens, softcap, n_tok, page_table, alibi, tiles,
                 p8_log=None, first_cols=None, sink_cols=None):
    """(out, lse) of :func:`decode_attention_core_plain` over the tiles
    starting at the columns ``tiles``."""
    b, h_kv, G, d = q_in.shape
    slot_dim = k_cache.shape[3]
    cap = (page_table.shape[1] * slot_dim if page_table is not None
           else slot_dim)
    s8 = q_rs is not None
    quant = k_scale is not None
    dev = q_in.device
    if page_table is not None:
        page_table = page_table.to(dev)
    m = torch.full((b, h_kv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h_kv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h_kv, G, d), dtype=torch.float32, device=dev)
    lens = lengths.to(device=dev, dtype=torch.long)
    tok = torch.arange(G, device=dev) % n_tok
    qpos = (lens[:, None] - n_tok + tok[None])[:, None, :, None]
    if first_cols is not None:  # the sharded columns, per row
        fc = first_cols.to(device=dev, dtype=torch.long)
        first = (fc[:, None] + tok[None])[:, None, :, None]
        sink_tokens = (0 if sink_cols is None else sink_cols.to(
            device=dev, dtype=torch.long)[:, None, None, None])
    else:
        first = (qpos - window_left if window_left >= 0
                 else torch.zeros_like(qpos))
    qf = q_in.float()
    for c0 in tiles:
        n = min(block_kv, cap - c0)
        cols = torch.arange(c0, c0 + n, device=dev)
        live = (cols[None, :] < lens[:, None])[:, None, :]  # (b, 1, n)
        # the stored values widened exactly (fp32 holds every bf16 value)
        kt = _widen(_tile_of(k_cache, layer, c0, n, page_table, slot_dim),
                    torch.float32)
        vt = _widen(_tile_of(v_cache, layer, c0, n, page_table, slot_dim),
                    torch.float32)
        kt = torch.where(live[..., None], kt, torch.zeros_like(kt))
        vt = torch.where(live[..., None], vt, torch.zeros_like(vt))
        s = torch.einsum("bhgd,bhnd->bhgn", qf, kt)
        if s8:
            s = s * q_rs[..., None]
        elif safe_softmax:
            s = s * scale
        if quant:
            kst = _tile_of(k_scale, layer, c0, n, page_table, slot_dim, True)
            vst = _tile_of(v_scale, layer, c0, n, page_table, slot_dim, True)
            kst = torch.where(live[:, :, None], kst, torch.zeros_like(kst))
            vst = torch.where(live[:, :, None], vst, torch.zeros_like(vst))
            s = s * kst
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        if alibi is not None:
            s = s - alibi[None, :, :, None] * (qpos - cols).float()
        invisible = (cols > qpos) | ((cols < first) & (cols >= sink_tokens))
        s = s.masked_fill(invisible, NEG_INF)
        if safe_softmax:
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None]).masked_fill(invisible, 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            m = m_new
        else:
            p = torch.exp2(torch.clamp(s, max=_CLAMP))
            l = l + p.sum(dim=-1)
        if quant:
            p = p * vst
        if s8:
            ps = torch.clamp(p.amax(dim=-1, keepdim=True), min=1e-20) * (
                1.0 / 127.0)
            p8 = torch.round(p / ps)
            if p8_log is not None:
                p8_log.append((c0, p8))
            # int8 x int8 sums are exact in float64, as in the int32 kernel
            pv = torch.einsum("bhgn,bhnd->bhgd", p8.double(),
                              vt.double()).float() * ps
        else:
            pv = torch.einsum("bhgn,bhnd->bhgd", p.to(torch.bfloat16).float(),
                              vt)
        acc = acc * alpha[..., None] + pv if safe_softmax else acc + pv
    dead = l == 0.0
    safe_l = torch.where(dead, torch.ones_like(l), l)
    out = torch.where(dead[..., None], torch.zeros_like(acc),
                      acc / safe_l[..., None])
    lse = torch.log(safe_l) + (m if safe_softmax else 0.0)
    lse = torch.where(dead, torch.full_like(lse, -math.inf), lse)
    return out, lse


# B7's kinds of K/V (csrc/decode_attention.cu Kind): the bf16 path, the s8
# path over int8 or packed int4, the dequant-cast path over int8, fp8 or
# packed int4
_KIND_BF16, _KIND_S8_I8, _KIND_S8_I4 = 0, 1, 2
_KIND_CAST_I8, _KIND_CAST_F8, _KIND_CAST_I4 = 3, 4, 5
_S8_KINDS = {torch.int8: _KIND_S8_I8, torch.uint8: _KIND_S8_I4}
_CAST_KINDS = {torch.int8: _KIND_CAST_I8, torch.float8_e4m3fn: _KIND_CAST_F8,
               torch.uint8: _KIND_CAST_I4}


def _kv_kind(q_in, q_rs, k_cache, k_scale) -> int:
    """B7's kind of K/V for these operands (raises on a combination that
    has no path)."""
    quant = k_scale is not None
    table = (_S8_KINDS if q_rs is not None else _CAST_KINDS) if quant else {
        torch.bfloat16: _KIND_BF16}
    qdt = torch.int8 if q_rs is not None else torch.bfloat16
    if q_in.dtype != qdt or k_cache.dtype not in table:
        raise ValueError(
            f"q {q_in.dtype} with {'' if q_rs is not None else 'no '}row "
            f"scales over a {k_cache.dtype} cache "
            f"{'with' if quant else 'without'} scales has no B7 path")
    return table[k_cache.dtype]


def decode_route(rows: int, block_kv: int, slot_dim: int) -> str:
    """The B7 kernel a CUDA call of :func:`decode_attention_core` launches,
    by shape alone: ``"decode_run"`` (``csrc/decode_run_sm90.cu``) when the
    call's ``rows`` = g * n_tok query rows per kv head exceed one group of
    8 and its kv tile is a multiple of that kernel's 128-column chunk and
    divides the cache's slot axis (s_max, or the page); else
    ``"decode_attention"`` (``csrc/decode_attention.cu``: one token, short
    runs and odd tiles). The tile rule's tiles divide the slot axis, so
    every sub-run of a long run takes the first at the serving shapes."""
    if (rows > _GROUP_ROWS and block_kv % _RUN_CHUNK == 0
            and slot_dim % block_kv == 0):
        return "decode_run"
    return "decode_attention"


def decode_run_smem(s8: bool, d: int = 128) -> int:
    """Dynamic shared memory of a ``decode_run`` block at head dim ``d`` (its
    C layout, ``csrc/decode_run_sm90.cu`` Smem): Q, the K slots with their
    scales, the V (s8: V^T) slots, three raw chunks, eight items' staged
    scales and, on the s8 path, the two warpgroups' P8, then 256 bytes of
    barriers and 1024 of alignment."""
    op = _RUN_CHUNK * d * (1 if s8 else 2)  # Q, a K or a V chunk operand
    ks = 6 if s8 else 2                     # K slots
    raw = _RUN_CHUNK * d                    # a raw int8 / fp8 chunk
    return (op + ks * op + ks * 1024 + 2 * op + 3 * raw + 8 * 1024
            + (2 * 64 * _RUN_CHUNK if s8 else 0) + 256 + 1024)


def decode_token_span(block_kv: int, row_bytes: int) -> Tuple[int, int]:
    """How ``decode_attention.cu`` cuts a JAX kv tile: (cluster, span), the
    tile's ``cluster`` spans of ``span`` columns, one block each, the
    cluster's blocks exchanging the tile's statistics. A span aims at
    ``_SPAN_BYTES`` of K (every byte of it in flight at once: 256 columns of
    an int8 or fp8 cache, 128 of bf16, 512 of packed int4); the cluster is
    at most 8 and divides the tile (a tile that does not divide into
    spans, such as 192 columns of int8, is a cluster of one)."""
    target = max(1, _SPAN_BYTES // row_bytes)
    cluster = min(_MAX_CLUSTER, max(1, block_kv // target))
    while block_kv % cluster:
        cluster -= 1
    return cluster, block_kv // cluster


class DecodeLaunch(NamedTuple):
    """The host side of a B7 launch (:func:`decode_launch`). ``splits``:
    the partials per query row, which a second kernel merges
    (``decode_run``: runs of ``per_split`` live tiles; ``decode_attention``:
    one per span block, ``cluster`` of them a tile slot, ``per_split`` 1);
    ``grid``; ``cluster`` and ``span`` (``decode_attention``: the blocks of
    a tile and their columns; ``decode_run``: 1 and the tile)."""
    splits: int
    per_split: int
    grid: Tuple[int, int, int]
    cluster: int
    span: int


def decode_launch(kernel: str, b: int, h_kv: int, rows: int, cap: int,
                  block_kv: int, n_tok: int = 1, window_left: int = -1,
                  sink_tokens: int = 0, kv_splits=None,
                  row_bytes: int = 128) -> DecodeLaunch:
    """The host side of a B7 launch. A row's live tiles are its sink
    tiles, then its window band, or all up to its length; at most
    ``nk`` = ceil(cap / block_kv) of them, or with a window the most its
    band and sinks can hold.

    ``decode_attention``: every tile slot (the i-th live tile of a row) is
    cut into :func:`decode_token_span`'s spans (``row_bytes``: a cache
    row's bytes, which a call passes: the default is an int8 row of head
    dim 128), one block each over each group of 8 query rows (on the
    s8 path a thread block cluster, whose spans exchange the tile's
    statistics): grid (nk * cluster, h_kv * groups, b), one partial per
    span; ``kv_splits`` does not shape it (JAX's splits merge the same
    per-tile values in another fp32 order).

    ``decode_run``: row blocks of 128 rows, grid (row blocks * splits, h_kv,
    b), each block a run of ``per_split`` live tiles. Without ``kv_splits``
    the split count fills the card (``_RUN_TARGET_BLOCKS``: decode_run's
    block fills an SM) and is bounded by nk; ``kv_splits`` (dense caches)
    fixes it as JAX's: max(1, min(kv_splits, tiles)) runs of
    ceil(tiles / splits) tiles."""
    per_block = _RUN_ROWS if kernel == "decode_run" else _GROUP_ROWS
    groups = -(-rows // per_block)
    nk = -(-cap // block_kv)
    live = nk
    if window_left >= 0:  # the most live tiles a row can have
        # decode_attention's tile slots take the exact bound, a band of
        # w = window_left + n_tok columns touching at most (w - 2) // bkv
        # + 2 tiles; decode_run's split rule keeps the one its splits
        # were made with, one more where w - 1 fills whole tiles
        band = ((window_left + n_tok - 2) // block_kv + 2
                if kernel == "decode_attention"
                else (window_left + n_tok - 1 + block_kv) // block_kv + 1)
        live = min(nk, -(-sink_tokens // block_kv) + band)
    if kernel == "decode_attention":
        cluster, span = decode_token_span(block_kv, row_bytes)
        return DecodeLaunch(live * cluster, 1,
                            (live * cluster, h_kv * groups, b), cluster, span)
    if kv_splits is not None:  # JAX's splits of the whole tile range
        splits = max(1, min(int(kv_splits), nk))
        per_split = -(-nk // splits)
    else:
        splits = max(1, min(live, -(-_RUN_TARGET_BLOCKS
                                    // (b * h_kv * groups))))
        per_split = -(-live // splits)
        splits = -(-live // per_split)
    return DecodeLaunch(splits, per_split, (groups * splits, h_kv, b), 1,
                        block_kv)


def decode_token_reads(launch: DecodeLaunch, length: int, n_tok: int,
                       cap: int, block_kv: int, window_left: int = -1,
                       sink_tokens: int = 0, first_col=None,
                       sink_col=None) -> List[Tuple[int, int, int, int]]:
    """The cache columns each block of a ``decode_attention`` launch reads
    for one row of ``length``, as ``csrc/decode_attention.cu`` computes
    them: (tile slot, rank in the cluster, first column, end column) of
    every block with a non-empty span. A tile slot past the row's live
    tiles reads nothing; a live tile's columns [c0 + lo, c0 + hi) go to
    rank 0 when they fit one span, else evenly to the cluster's blocks
    (ceil((hi - lo) / cluster) each, the last ones fewer). ``first_col``
    and ``sink_col``: the row's sharded columns (:func:`decode_attention`'s
    ``first_cols`` / ``sink_cols``), which replace the window's bound and
    the sinks."""
    sharded = first_col is not None
    if sharded:
        sink = sink_col or 0
        first_col = max(first_col, 0)
    else:
        sink = sink_tokens if window_left >= 0 else 0
        first_col = (max(length - n_tok - window_left, 0)
                     if window_left >= 0 else 0)
    nk = -(-cap // block_kv)
    last_t = min((length - 1) // block_kv, nk - 1) if length > 0 else -1
    start_t = first_col // block_kv
    n_sink = (min(-(-sink // block_kv), start_t, last_t + 1)
              if window_left >= 0 or sharded else 0)
    n_live = n_sink + max(last_t - start_t + 1, 0)
    reads = []
    for slot in range(min(n_live, launch.splits // launch.cluster)):
        sink_tile = slot < n_sink
        c0 = (slot if sink_tile else start_t + slot - n_sink) * block_kv
        hi = min(block_kv, (min(sink, length) if sink_tile else length) - c0)
        lo = 0 if c0 < sink else max(first_col - c0, 0)
        n_vis = max(hi - lo, 0)
        if n_vis <= launch.span:
            if n_vis:
                reads.append((slot, 0, c0 + lo, c0 + hi))
            continue
        per = -(-n_vis // launch.cluster)
        for rank in range(launch.cluster):
            n = min(per, n_vis - rank * per)
            if n > 0:
                s0 = c0 + lo + rank * per
                reads.append((slot, rank, s0, s0 + n))
    return reads


def decode_attention_core(q_in, q_rs, k_cache, v_cache, k_scale, v_scale,
                          lengths, *, layer: int, block_kv: int, scale: float,
                          safe_softmax: bool = False, window_left: int = -1,
                          sink_tokens: int = 0, softcap: float = 0.0,
                          n_tok: int = 1, page_table=None, alibi=None,
                          kv_splits=None, first_cols=None, sink_cols=None):
    """Kernel B7 wrapper (arguments as :func:`decode_attention_core_plain`,
    but ``kv_splits`` None lets the wrapper choose the split of a run).
    With ``first_cols`` both kernels read each row's first column and sink
    end (``sink_cols``) from the device; ``window_left`` and
    ``sink_tokens`` (the static bound on ``sink_cols``) size the walk on
    the host, so the launch needs no device read.

    A CUDA call launches one of B7's two kernels by shape
    (:func:`decode_route`): ``decode_run`` (``csrc/decode_run_sm90.cu``)
    when G > 8 query rows per kv head and the tile is a multiple of 128
    that divides the slot axis, else ``decode_attention``
    (``csrc/decode_attention.cu``). Both walk a row's live ``block_kv``
    tiles (its sink tiles, then its window band, or all up to its length)
    (:func:`decode_launch`): ``decode_attention`` one cluster of span
    blocks per tile, ``decode_run`` one block per run of tiles, so small
    batches still fill the card; a second kernel in the same entry point
    merges the partials with the arithmetic of :func:`merge_partials`.
    ``kv_splits`` (dense caches) fixes ``decode_run``'s runs as JAX's
    splits: max(1, min(kv_splits, tiles)) of ceil(tiles / splits) tiles
    each; ``decode_attention``'s per-tile partials are the same values
    merged in another fp32 order. CPU tensors take the plain version."""
    if softcap and not safe_softmax:
        raise ValueError("softcap needs the online form (safe_softmax)")
    if kv_splits is not None and kv_splits > 1 and page_table is not None:
        raise ValueError("paged + kv_splits is unsupported (as in JAX)")
    if q_in.device.type == "cpu":
        return decode_attention_core_plain(
            q_in, q_rs, k_cache, v_cache, k_scale, v_scale, lengths,
            layer=layer, block_kv=block_kv, scale=scale,
            safe_softmax=safe_softmax, window_left=window_left,
            sink_tokens=sink_tokens, softcap=softcap, n_tok=n_tok,
            page_table=page_table, alibi=alibi, kv_splits=kv_splits,
            first_cols=first_cols, sink_cols=sink_cols)
    b, h_kv, G, d = q_in.shape
    L, pool, _, slot_dim, dv = k_cache.shape
    dev = q_in.device
    quant = k_scale is not None
    kind = _kv_kind(q_in, q_rs, k_cache, k_scale)
    kernel = decode_route(G, block_kv, slot_dim)
    kern = _build.kernel(kernel, d, "B7")
    if n_tok < 1 or G % n_tok:
        raise ValueError(f"{G} query rows do not hold runs of {n_tok}")
    if not q_in.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.shape != k_cache.shape or t.dtype != k_cache.dtype \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {k_cache.dtype} "
                             f"(L, b or P, h_kv, slots, d) tensor on {dev}")
    want_dv = d // 2 if k_cache.dtype == torch.uint8 else d
    if k_cache.shape[2] != h_kv or dv != want_dv:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q_in.shape)}")
    pt = None
    if page_table is not None:
        pt = _page_table_operand(page_table, b, dev)
        n_pages, cap = pt.shape[1], pt.shape[1] * slot_dim
        if slot_dim % block_kv:
            raise ValueError(f"the kv tile {block_kv} must divide the page "
                             f"{slot_dim}")
    else:
        if pool != b:
            raise ValueError(f"a dense cache holds {pool} rows, q {b}")
        n_pages, cap = 1, slot_dim
    if q_rs is not None:
        if q_rs.shape != (b, h_kv, G) or q_rs.dtype != torch.float32:
            raise ValueError("q row scales must be fp32 (b, h_kv, rows)")
        q_rs = q_rs.contiguous()
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.shape != (L, pool, h_kv, 1, slot_dim) \
                    or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous fp32 "
                                 f"{(L, pool, h_kv, 1, slot_dim)}")
    if alibi is not None:
        alibi = alibi.to(device=dev, dtype=torch.float32).contiguous()
        if alibi.shape != (h_kv, G):
            raise ValueError(f"ALiBi row slopes must be (h_kv, rows) = "
                             f"{(h_kv, G)}, got {tuple(alibi.shape)}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} layers")
    # a tile too large for shared memory fails in the launch (the C entry
    # point returns cudaErrorInvalidValue) and raises there
    lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
    fc = sc = None
    if first_cols is not None:
        fc, sc = (None if t is None else
                  t.to(device=dev, dtype=torch.int32).contiguous()
                  for t in (first_cols, sink_cols))
        if fc.shape != (b,) or (sc is not None and sc.shape != (b,)):
            raise ValueError(f"first_cols and sink_cols must be (b={b},)")
    elif sink_cols is not None:
        raise ValueError("sink_cols requires first_cols (the sharded path)")
    launch = decode_launch(kernel, b, h_kv, G, cap, block_kv, n_tok,
                           window_left, sink_tokens, kv_splits,
                           row_bytes=dv * k_cache.element_size())
    splits = launch.splits
    out = torch.empty((b, h_kv, G, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h_kv, G), dtype=torch.float32, device=dev)
    part_out = part_lse = None
    if splits > 1:
        part_out = torch.empty((b, splits, h_kv, G, d), dtype=torch.float32,
                               device=dev)
        part_lse = torch.empty((b, splits, h_kv, G), dtype=torch.float32,
                               device=dev)
    # decode_attention.cu reads (tile slots, span) where decode_run reads
    # (splits, tiles per split)
    run = kernel == "decode_run"
    dims = _build.dims_array([b, h_kv, G, cap, layer, block_kv,
                              splits if run else splits // launch.cluster,
                              launch.per_split if run else launch.span,
                              window_left,
                              sink_tokens if window_left >= 0 and fc is None
                              else 0,
                              n_tok, pool, slot_dim, n_pages, kind])
    p = _build.ptr
    kern(
        p(q_in), p(q_rs), p(k_cache), p(v_cache), p(k_scale), p(v_scale),
        p(lens), p(pt), p(part_out), p(part_lse), p(out), p(lse), dims,
        scale, float(softcap), int(safe_softmax), _build.stream_ptr(dev),
        p(alibi), p(fc), p(sc))
    return out, lse


def _check_sink_band(w_left: int, n_tok: int, bkv: int, nk: int,
                     kv_splits, has_sink_cols: bool, sink_band: int) -> None:
    """JAX's guard (decode.py:843-850): a windowed call whose walk is
    banded and takes ``sink_cols`` needs ``sink_band`` to size its sink
    tiles, or the sinks would silently drop out."""
    splits = max(1, min(int(kv_splits or 1), nk))
    band_ns = -(-sink_band // bkv) if sink_band > 0 else 0
    banded = (w_left >= 0 and splits == 1
              and band_ns + (w_left + n_tok) // bkv + 2 < nk)
    if banded and has_sink_cols and band_ns == 0:
        raise ValueError(
            "banded windowed decode with sink_cols needs sink_band (the "
            "static global sink_tokens bound) to size the walk's sink "
            "tiles; without it the sink attention would be dropped")


def decode_query_operands(q, k_cache, quant: bool, *, scale: float,
                          block_kv: int, safe_softmax: bool = False,
                          paged: bool = False):
    """The query operands of kernel B7, as :func:`decode_attention` makes
    them: q (b, h, d), or a run (b, n, h, d), bf16 and the layered cache
    (L, b or P, h_kv, slots, d) -> (q_in (b, h_kv, g * n, d) with rows
    ordered (head, token), q_rs (b, h_kv, g * n) or None, the kv tile).
    int8: q row-quantized (absmax/127, floor 1e-6, half to even) with the
    softmax scale (and log2e in the fast form) folded into the row scale;
    bf16: q folded by scale*log2e in its dtype (fast form) or as it is
    (safe); ``quant`` False is also the dequant-cast path's q. ``paged``:
    the cache's slot axis is a page (the paged tile rule). The tile rule
    reads the cache's element size, 1 for packed int4 as for JAX's s4."""
    if q.dim() == 3:
        q = q[:, None]
    b, n, h, d = q.shape
    h_kv, slot_dim = k_cache.shape[2], k_cache.shape[3]
    g = h // h_kv
    bkv = reference_block_kv(block_kv, slot_dim, h_kv, g * n, d,
                             k_cache.element_size(), paged=paged)
    qg = q.reshape(b, n, h_kv, g, d).permute(0, 2, 3, 1, 4).reshape(
        b, h_kv, g * n, d)
    if not quant:
        q_in = _fold(qg, scale) if not safe_softmax else qg
        return q_in.contiguous(), None, bkv
    qf = qg.float()
    q_rs = torch.clamp(qf.abs().amax(dim=-1), min=1e-6) * (1.0 / 127.0)
    q_in = torch.round(qf / q_rs[..., None]).to(torch.int8)
    return q_in, q_rs * (scale if safe_softmax else scale * _LOG2E), bkv


def decode_attention(q, k_cache, v_cache, lengths, k_scale=None,
                     v_scale=None, *, softmax_scale=None, block_kv=4096,
                     interpret=None, return_lse=False, layer=None,
                     kv_splits=None, window_size=(-1, -1), softcap=0.0,
                     alibi_slopes=None, sink_tokens=0, first_cols=None,
                     sink_cols=None, sink_band=0, page_table=None,
                     mxu_int8=True, safe_softmax=False):
    """Decode attention over a bf16, int8, fp8 or packed int4 cache, dense
    or paged.

    q (b, h, d), or a run (b, n, h, d); cache (b, h_kv, s_max, d) or the
    stacked (L, b, h_kv, s_max, d) with ``layer`` (an int), d // 2 packed
    bytes for int4; quantized caches pass scales in the cache's (.., h_kv,
    1, s_max) layout; ``lengths`` (b,)
    int32 is the visible prefix per row including the run's tokens, whose
    K/V already sit in the cache: token i of a run is at position
    ``lengths - n + i`` and sees the columns up to it. ``page_table`` (b,
    n_pages) int32: the cache arrays are the pool (P, h_kv, page, d)
    (stacked (L, P, ...)), row b's logical column c in pool page
    ``page_table[b, c // page]``; entries past a row's live prefix may be
    -1 and are never read. A left ``window_size`` keeps the last window + 1
    columns of each query row, and ``sink_tokens`` the first ones beside
    them (sinks act only with a window); ``softcap`` caps the scores and
    takes the online form; ``alibi_slopes`` (h,) adds -slope * (q_pos -
    kv_pos) after the softcap. The s8 path (int8 or int4 cache under
    ``mxu_int8``, the default) row-quantizes q (absmax/127, scale and log2e
    folded into the row scale) and runs s8 x s8 products, requantizing P
    per kv tile; fp8, and int8 / int4 with ``mxu_int8=False``, take the
    dequant-cast path (bf16 q against the widened cache). The tile and the
    split of a long run into sub-runs follow the JAX package's rule
    (:func:`decode_run_plan`), each sub-run one kernel launch.
    ``kv_splits``: JAX's flash-decoding split count (dense caches; paged +
    kv_splits > 1 raises ValueError, as JAX refuses it).

    A sequence-sharded cache (``serving/sharded.py``) passes each rank's
    slice of the global window: ``first_cols`` (b,) int32, the UNCLIPPED
    first visible local column of a run's token 0 (token i's is
    first_cols + i; it may be negative), which replaces the window's bound;
    ``sink_cols`` (b,) (needs ``first_cols``), the exclusive end of this
    rank's slice of the sink prefix, visible through that bound; and
    ``sink_band``, the static bound on ``sink_cols`` (the global sink
    count) that sizes the walk's sink tiles. ``window_size`` still bounds
    the walk's band, so the first columns must lie within the window of a
    run's lengths (as the sharded path's do). ``lengths`` may be negative
    (a rank past the data: out 0, lse -inf) and, for a run, exceed the
    slots (an interior rank: every column visible up to the run's bound).
    Returns out (b, h, d) bf16 (+ lse (b, h) fp32 with ``return_lse``);
    for a run out (b, n, h, d) and lse (b, h, n)."""
    del interpret
    multi = q.dim() == 4
    if softcap < 0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")
    paged = page_table is not None
    if paged and kv_splits not in (None, 1):
        raise ValueError("paged + kv_splits unsupported")
    layered = layer is not None
    li = int(layer) if layered else 0
    kc = k_cache if layered else k_cache[None]
    vc = v_cache if layered else v_cache[None]
    quant = k_scale is not None
    ks = None if not quant else (k_scale if layered else k_scale[None])
    vs = None if not quant else (v_scale if layered else v_scale[None])
    s8 = quant and bool(mxu_int8) and kc.dtype in (torch.int8, torch.uint8)
    qr = q if multi else q[:, None]
    b, n_tok, h, d = qr.shape
    h_kv = kc.shape[2]
    g = h // h_kv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    w_left = int(tuple(window_size)[0])
    sink = int(sink_tokens) if w_left >= 0 else 0
    sharded = first_cols is not None
    if sink > 0 and sharded:
        raise ValueError(
            "with explicit first_cols pass the rank-local sink slice as "
            "sink_cols, not the global sink_tokens")
    if sink_cols is not None and not sharded:
        raise ValueError("sink_cols requires first_cols (the sharded path)")
    if sharded:
        first_cols = torch.as_tensor(first_cols, device=q.device).to(
            torch.int32)
    online = bool(safe_softmax) or softcap > 0
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=q.device).reshape(h_kv, g, 1)
        if not online:
            slopes = slopes * _LOG2E  # the bias adds to exp2-unit scores
    cap = (page_table.shape[1] * kc.shape[3] if paged else kc.shape[3])
    outs, lses = [], []
    for i, e, _ in decode_run_plan(n_tok, h_kv, g, d, kc.shape[3],
                                   kc.element_size(), block_kv=block_kv,
                                   paged=paged):
        n = e - i
        q_in, q_rs, bkv = decode_query_operands(
            qr[:, i:e], kc, s8, scale=scale, block_kv=block_kv,
            safe_softmax=online, paged=paged)
        if sharded:
            _check_sink_band(w_left, n, bkv, cap // bkv, kv_splits,
                             sink_cols is not None, int(sink_band))
        # (h,) -> each (head, token) row's slope
        row_sl = (None if slopes is None
                  else slopes.expand(h_kv, g, n).reshape(h_kv, g * n))
        # a sub-run's token 0 is the run's token i: its first column
        # shifts by i (JAX's decode.py:719-720)
        out, lse = decode_attention_core(
            q_in, q_rs, kc, vc, ks, vs, lengths - (n_tok - e), layer=li,
            block_kv=bkv, scale=scale, safe_softmax=online,
            window_left=w_left,
            sink_tokens=int(sink_band) if sharded else sink,
            softcap=float(softcap), n_tok=n, page_table=page_table,
            alibi=row_sl, kv_splits=kv_splits,
            first_cols=first_cols + i if sharded else None,
            sink_cols=sink_cols)
        # rows (head, token) -> (token, head)
        outs.append(out.to(torch.bfloat16).reshape(b, h_kv, g, n, d)
                    .permute(0, 3, 1, 2, 4).reshape(b, n, h, d))
        lses.append(lse.reshape(b, h, n))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    lse = torch.cat(lses, dim=2) if len(lses) > 1 else lses[0]
    if not multi:
        out, lse = out[:, 0], lse[..., 0]
    return (out, lse) if return_lse else out
