"""Quantized KV-cache storage: per-token-per-head absmax scaling.

Counterpart of ``long_context_attention_tpu/ops/kv_cache.py``. Values are
stored BHSD, (n_layers, b, h_kv, s_max, d), the layout the decode kernel
streams; quantized caches keep fp32 scales (n_layers, b, h_kv, 1, s_max) in
the same unit-dim layout as the JAX package. The JAX cache is an immutable
pytree; this one is a mutable object whose ``write_prompt`` and ``advance``
update its tensors IN PLACE and return ``self``.

:class:`PagedKVCache` is the paged form: one pool of pages shared by the
rows, (n_layers, pool_pages, h_kv, page_size, d), and a page table per row.

Cache dtypes, the JAX package's four, each with its storage dtype:
"bfloat16" (``torch.bfloat16``), "int8" (``torch.int8``, qmax 127),
"float8_e4m3fn" (``torch.float8_e4m3fn``, qmax 448, clipped and cast with
no rounding step) and "int4" (qmax 7). torch has no usable int4 dtype, so
int4 values are PACKED two per byte along d (:func:`pack_int4`): element
2i in the low nibble, 2i + 1 in the high one, two's complement, stored as
``torch.uint8`` with a last dim of d // 2. A uint8 cache is an int4 cache
everywhere in the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from long_context_attention_tpu_torch.utils.config import resolve_device

__all__ = ["KVCache", "PagedKVCache", "quantize_kv", "dequantize_kv",
           "pack_int4", "unpack_int4", "CACHE_DTYPES"]

CACHE_DTYPES = ("bfloat16", "int8", "int4", "float8_e4m3fn")

# each cache dtype's storage dtype and the qmax of its absmax scale
_STORAGE = {"bfloat16": torch.bfloat16, "int8": torch.int8,
            "int4": torch.uint8, "float8_e4m3fn": torch.float8_e4m3fn}
_QMAX = {"int8": 127.0, "int4": 7.0, "float8_e4m3fn": 448.0}


def _check_dtype(dtype: str) -> None:
    if dtype not in CACHE_DTYPES:
        raise ValueError(f"cache dtype {dtype!r} not in {CACHE_DTYPES}")


def _dtype_name(values: torch.Tensor) -> str:
    """The cache dtype whose storage ``values`` are (uint8: packed int4)."""
    for name, st in _STORAGE.items():
        if values.dtype == st:
            return name
    raise ValueError(f"{values.dtype} is no cache storage dtype")


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int values in [-8, 7], (..., d) with d even -> (..., d // 2) uint8:
    element 2i in the low nibble, 2i + 1 in the high one (two's
    complement)."""
    n = q.to(torch.int16) & 0xF
    return (n[..., 0::2] | (n[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (..., d // 2) uint8 -> (..., d) int8."""
    w = p.to(torch.int16)
    n = torch.stack((w & 0xF, w >> 4), dim=-1).flatten(-2)
    return (n - ((n & 8) << 1)).to(torch.int8)


def _widen(values: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Stored cache values as ``dtype`` (exact for bf16 and wider): packed
    int4 unpacked, the other storage dtypes cast."""
    if values.dtype == torch.uint8:
        values = unpack_int4(values)
    return values.to(dtype)


def quantize_kv(x: torch.Tensor, dtype: str
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(..., d) float -> (values in ``dtype``'s storage, absmax scales
    (...,) fp32), as the JAX package's ``_qparams``: scale = max(absmax,
    1e-6) / qmax and x / scale, both IEEE divisions on every device (kernel
    B6 computes the same on the card); int8 and int4 round half to even,
    fp8 is clipped and cast with no rounding step; int4 comes packed
    (:func:`pack_int4`).

    bfloat16 passes through with scales None."""
    _check_dtype(dtype)
    if dtype == "bfloat16":
        return x.to(torch.bfloat16), None
    qmax = _QMAX[dtype]
    xf = x.float()
    # qmax as a tensor on x's device: CUDA turns a Python divisor into a
    # multiply by its reciprocal, which can miss the IEEE quotient by an ulp
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / xf.new_full(
        (), qmax)
    q = xf / scale[..., None]
    if dtype != "float8_e4m3fn":
        q = torch.round(q)
    q = torch.clamp(q, -qmax, qmax)
    if dtype == "int4":
        return pack_int4(q), scale
    return q.to(_STORAGE[dtype]), scale


def dequantize_kv(q: torch.Tensor, scale: Optional[torch.Tensor],
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (packed int4 included). Scales may be
    flat (..., s) or in the cache's (..., 1, s) layout."""
    if scale is None:
        return q.to(dtype)
    if scale.dim() == q.dim():
        scale = scale[..., 0, :]
    return (_widen(q, torch.float32) * scale[..., None]).to(dtype)


def _storage(dtype: str, d: int):
    """(storage dtype, stored last dim) of a cache of head dim ``d``."""
    if dtype == "int4" and d % 2:
        raise ValueError(f"an int4 cache packs pairs along d: d={d} is odd")
    return _STORAGE[dtype], d // 2 if dtype == "int4" else d


@dataclasses.dataclass
class KVCache:
    """Per-layer KV cache in BHSD: values (n_layers, b, h_kv, s_max, d)
    (d // 2 packed bytes for int4), scales (n_layers, b, h_kv, 1, s_max)
    fp32 for the quantized dtypes; ``length`` (b,) int32 is the filled
    prefix per batch row."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    length: torch.Tensor
    # B6's launch plan for this cache object (ops/decode.py _RowsPlan),
    # made by its first append on the card
    _rows_plan: Optional[object] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @staticmethod
    def init(n_layers: int, b: int, s_max: int, h_kv: int, d: int,
             dtype: str = "bfloat16", device=None) -> "KVCache":
        _check_dtype(dtype)
        dev = resolve_device(device)
        vdt, dv = _storage(dtype, d)
        shape = (n_layers, b, h_kv, s_max, dv)
        scales = (None if dtype == "bfloat16" else
                  torch.zeros((n_layers, b, h_kv, 1, s_max),
                              dtype=torch.float32, device=dev))
        return KVCache(
            k=torch.zeros(shape, dtype=vdt, device=dev),
            v=torch.zeros(shape, dtype=vdt, device=dev),
            k_scale=scales,
            v_scale=None if scales is None else torch.zeros_like(scales),
            length=torch.zeros((b,), dtype=torch.int32, device=dev),
        )

    @property
    def dtype(self) -> str:
        """The cache dtype's name, from the stored values' dtype."""
        return _dtype_name(self.k)

    @property
    def s_max(self) -> int:
        return self.k.shape[3]

    def write_prompt(self, layer: int, k: torch.Tensor, v: torch.Tensor,
                     start: int = 0) -> "KVCache":
        """Write a (b, s, h_kv, d) segment at positions [start, start+s) of
        ``layer``, quantized to the cache's dtype, IN PLACE (kernel B6,
        ``ops/decode.py`` :func:`cache_append_rows`). Returns self."""
        from long_context_attention_tpu_torch.ops.decode import (
            cache_append_rows)

        return cache_append_rows(self, layer, k, v, int(start))

    def advance(self, n: int = 1) -> "KVCache":
        """Advance every row's length by ``n``, IN PLACE. Returns self."""
        self.length += n
        return self

    def layer_view(self, layer: int):
        """(k, v, k_scale, v_scale) BHSD views of one layer."""
        sl = lambda a: None if a is None else a[layer]
        return self.k[layer], self.v[layer], sl(self.k_scale), sl(self.v_scale)


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV cache: one physical POOL of pages shared by the rows, and
    a page table per row (the JAX package's ``PagedKVCache``).

    Values ``(n_layers, pool_pages, h_kv, page_size, d)`` (d // 2 packed
    bytes for int4); scales ``(n_layers, pool_pages, h_kv, 1, page_size)``
    fp32 for the quantized dtypes;
    ``page_table`` (b, n_pages) int32 maps row b's logical page i to a pool
    page (-1: unallocated, never read live); ``length`` (b,) int32 is the
    logical filled prefix. Pool page 0 is the scratch page that allocators
    never hand out: a live append through a -1 entry lands there. Mutable,
    like :class:`KVCache`: the kernels update the pool IN PLACE, and a view
    with another page table and length (a one-row admission view) shares
    the pool's storage."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    page_table: torch.Tensor
    length: torch.Tensor
    # B6's launch plan for this cache object (ops/decode.py _RowsPlan),
    # made by its first append on the card
    _rows_plan: Optional[object] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @staticmethod
    def init(n_layers: int, b: int, pool_pages: int, page_size: int,
             n_pages: int, h_kv: int, d: int, dtype: str = "bfloat16",
             device=None) -> "PagedKVCache":
        _check_dtype(dtype)
        if page_size % 128:
            raise ValueError(f"page_size {page_size} must be a multiple of "
                             f"128")
        if pool_pages < 2:
            raise ValueError("the pool needs the scratch page + 1")
        dev = resolve_device(device)
        vdt, dv = _storage(dtype, d)
        shape = (n_layers, pool_pages, h_kv, page_size, dv)
        scales = (None if dtype == "bfloat16" else
                  torch.zeros((n_layers, pool_pages, h_kv, 1, page_size),
                              dtype=torch.float32, device=dev))
        return PagedKVCache(
            k=torch.zeros(shape, dtype=vdt, device=dev),
            v=torch.zeros(shape, dtype=vdt, device=dev),
            k_scale=scales,
            v_scale=None if scales is None else torch.zeros_like(scales),
            page_table=torch.full((b, n_pages), -1, dtype=torch.int32,
                                  device=dev),
            length=torch.zeros((b,), dtype=torch.int32, device=dev),
        )

    @property
    def dtype(self) -> str:
        """The cache dtype's name, from the stored values' dtype."""
        return _dtype_name(self.k)

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def s_max(self) -> int:
        """A row's logical capacity, n_pages * page_size."""
        return self.page_table.shape[1] * self.page_size
