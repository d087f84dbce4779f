"""Attention implementation registry.

Counterpart of ``long_context_attention_tpu/ops/registry.py``: a small table
of implementations sharing one contract,

* ``full(q, k, v, **kw) -> out``: differentiable end-to-end attention;
* ``fwd(q, k, v, **kw) -> (out, lse)``: the per-block forward whose lse makes
  online merging possible;
* ``bwd(q, k, v, out, lse, dout, **kw) -> (dq, dk, dv)``: fp32 partial
  gradients of this kv block given the final merged out and lse.

Common ``**kw``: causal, softmax_scale, window_size, softcap, sink_tokens and
the global position descriptor (q_offsets, kv_offsets, q_stride, kv_stride).
Impls:

* ``pallas``: the flash kernels (``ops/flash.py``: B1, B3, B4 forward, B5 or
  B2a + B2b backward); the name is the JAX package's;
* ``xla``: the fp32 oracle (``ops/reference.py``), differentiable through
  torch autograd;
* ``sage``: the int8-QK forward (``ops/sage.py``: B8a, B8b, B8c) with the
  straight-through bf16 flash backward.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from long_context_attention_tpu_torch.ops import flash as _flash
from long_context_attention_tpu_torch.ops import reference as _ref
from long_context_attention_tpu_torch.ops import sage as _sage

__all__ = ["AttnImpl", "get_attn_impl", "register_attn_impl", "ATTN_IMPLS"]


@dataclasses.dataclass(frozen=True)
class AttnImpl:
    name: str
    full: Callable  # (q, k, v, **kw) -> out, differentiable
    fwd: Callable   # (q, k, v, **kw) -> (out, lse)
    bwd: Callable   # (q, k, v, out, lse, dout, **kw) -> (dq, dk, dv) fp32


def _xla_kw(q_len: int, kv_len: int, kw) -> dict:
    """The oracle's kwargs: the kernel-form position descriptor becomes
    per-token positions; kwargs the oracle has no use for are dropped."""
    out = dict(
        causal=kw.get("causal", False),
        softmax_scale=kw.get("softmax_scale"),
        window_size=kw.get("window_size", (-1, -1)),
        softcap=kw.get("softcap", 0.0),
        sink_tokens=kw.get("sink_tokens", 0),
    )
    for side, n in (("q", q_len), ("kv", kv_len)):
        off = kw.get(f"{side}_offsets")
        if off is not None:
            out[f"{side}_positions"] = _flash.expand_positions(
                _flash._offsets(off, f"{side}_offsets"),
                int(kw.get(f"{side}_stride", 1)), n)
    for key in ("q_segment_ids", "kv_segment_ids"):
        if kw.get(key) is not None:
            out[key] = kw[key]
    return out


def _xla_full(q, k, v, **kw):
    out, _ = _ref.xla_attention(q, k, v, **_xla_kw(q.shape[1], k.shape[1], kw))
    return out


def _xla_fwd(q, k, v, **kw):
    return _ref.xla_attention(q, k, v, **_xla_kw(q.shape[1], k.shape[1], kw))


def _xla_bwd(q, k, v, out, lse, dout, **kw):
    return _ref.xla_attention_bwd(
        q, k, v, out, lse, dout, **_xla_kw(q.shape[1], k.shape[1], kw))


def _sage_bwd(q, k, v, out, lse, dout, **kw):
    """Straight-through: the bf16 flash backward anchored on the quantized
    forward's (out, lse), as the JAX registry's ``_sage_bwd``."""
    kw.pop("pv_int8", None)
    return _flash.flash_attention_bwd(q, k, v, out, lse, dout, **kw)


ATTN_IMPLS: Dict[str, AttnImpl] = {
    "pallas": AttnImpl("pallas", _flash.flash_attention,
                       _flash.flash_attention_fwd, _flash.flash_attention_bwd),
    "xla": AttnImpl("xla", _xla_full, _xla_fwd, _xla_bwd),
    "sage": AttnImpl("sage", _sage.sage_attention_full,
                     _sage.sage_attention_fwd, _sage_bwd),
}


def register_attn_impl(impl: AttnImpl) -> None:
    ATTN_IMPLS[impl.name] = impl


def get_attn_impl(name: str) -> AttnImpl:
    try:
        return ATTN_IMPLS[name]
    except KeyError:
        raise ValueError(
            f"unknown attention impl {name!r}; available: {sorted(ATTN_IMPLS)}"
        ) from None
