"""Quantized KV-cache storage: int8 per-token-per-head absmax scaling.

Counterpart of ``long_context_attention_tpu/ops/kv_cache.py``. Values are
stored BHSD, (n_layers, b, h_kv, s_max, d), the layout the decode kernel
streams; int8 caches keep fp32 scales (n_layers, b, h_kv, 1, s_max) in the
same unit-dim layout as the JAX package. The JAX cache is an immutable
pytree; this one is a mutable object whose ``write_prompt`` and ``advance``
update its tensors IN PLACE and return ``self``.

Supported cache dtypes: "bfloat16" and "int8". "float8_e4m3fn", "int4" and
the paged cache are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from long_context_attention_tpu_torch.utils.config import (
    not_ported,
    resolve_device,
)

__all__ = ["KVCache", "PagedKVCache", "quantize_kv", "dequantize_kv",
           "CACHE_DTYPES"]

CACHE_DTYPES = ("bfloat16", "int8")
_LATER_DTYPES = ("int4", "float8_e4m3fn")


def _check_dtype(dtype: str) -> None:
    if dtype in _LATER_DTYPES:
        raise not_ported(f"cache dtype {dtype!r}")
    if dtype not in CACHE_DTYPES:
        raise ValueError(f"cache dtype {dtype!r} not in {CACHE_DTYPES}")


def quantize_kv(x: torch.Tensor, dtype: str
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(..., d) float -> (values in ``dtype``, absmax scales (...,) fp32).

    bfloat16 passes through with scales None."""
    _check_dtype(dtype)
    if dtype == "bfloat16":
        return x.to(torch.bfloat16), None
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: Optional[torch.Tensor],
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`. Scales may be flat (..., s) or in the
    cache's (..., 1, s) layout."""
    if scale is None:
        return q.to(dtype)
    if scale.dim() == q.dim():
        scale = scale[..., 0, :]
    return (q.float() * scale[..., None]).to(dtype)


@dataclasses.dataclass
class KVCache:
    """Per-layer KV cache in BHSD: values (n_layers, b, h_kv, s_max, d),
    scales (n_layers, b, h_kv, 1, s_max) fp32 for int8; ``length`` (b,)
    int32 is the filled prefix per batch row."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    length: torch.Tensor

    @staticmethod
    def init(n_layers: int, b: int, s_max: int, h_kv: int, d: int,
             dtype: str = "bfloat16", device=None) -> "KVCache":
        _check_dtype(dtype)
        dev = resolve_device(device)
        vdt = torch.bfloat16 if dtype == "bfloat16" else torch.int8
        shape = (n_layers, b, h_kv, s_max, d)
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
        return "bfloat16" if self.k_scale is None else "int8"

    @property
    def s_max(self) -> int:
        return self.k.shape[3]

    def write_prompt(self, layer: int, k: torch.Tensor, v: torch.Tensor,
                     start: int = 0) -> "KVCache":
        """Write a (b, s, h_kv, d) segment at positions [start, start+s) of
        ``layer``, IN PLACE. Returns self."""
        s = k.shape[1]
        dt = self.dtype
        kq, ks = quantize_kv(k.transpose(1, 2), dt)  # (b, h, s, d)
        vq, vs = quantize_kv(v.transpose(1, 2), dt)
        self.k[layer, :, :, start:start + s] = kq
        self.v[layer, :, :, start:start + s] = vq
        if ks is not None:
            self.k_scale[layer, :, :, 0, start:start + s] = ks
            self.v_scale[layer, :, :, 0, start:start + s] = vs
        return self

    def advance(self, n: int = 1) -> "KVCache":
        """Advance every row's length by ``n``, IN PLACE. Returns self."""
        self.length += n
        return self

    def layer_view(self, layer: int):
        """(k, v, k_scale, v_scale) BHSD views of one layer."""
        sl = lambda a: None if a is None else a[layer]
        return self.k[layer], self.v[layer], sl(self.k_scale), sl(self.v_scale)


class PagedKVCache:
    """The paged cache is not ported yet (it comes with paged serving)."""

    def __init__(self, *args, **kwargs):
        raise not_ported("PagedKVCache")

    @staticmethod
    def init(*args, **kwargs):
        raise not_ported("PagedKVCache")
