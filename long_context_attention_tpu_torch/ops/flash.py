"""Flash attention forward on Hopper: the public API and its two kernels.

Counterpart of ``long_context_attention_tpu/ops/flash.py``, forward only.
The public functions keep the JAX package's names, BSHD layout, kwargs and
``(out, lse fp32)`` contract. Two kernel wrappers sit under them, each with
a plain PyTorch version of the same arithmetic in this module:

* :func:`flash_fwd_causal_self` (kernel B1, ``csrc/flash_fwd.cu``):
  causal self-attention with s_q == s_kv, the TPU's ``_fwd_kernel_tri``.
* :func:`flash_fwd_pos` (kernel B3, ``csrc/flash_fwd.cu``): q rows at
  global positions ``q_start + i`` against a BHSD kv (a cache slice, taken
  by strides), optionally causal, bf16 or int8 K/V with per-token scales,
  the TPU's ``_fwd_kernel`` as chunked prefill uses it.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Features the kernels do not take (sliding
windows, sinks, softcap, segments, ALiBi, dropout, position chunks and
strides, non-causal self-attention) raise ``NotImplementedError``; they and
the backward kernels come in later slices.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from long_context_attention_tpu_torch.ops import _build
from long_context_attention_tpu_torch.utils.config import NEG_INF, not_ported

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_cache", "flash_fwd_causal_self",
           "flash_fwd_causal_self_plain", "flash_fwd_pos",
           "flash_fwd_pos_plain"]

_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)
# Fast-softmax score clamp in exp2 units (raw score <= _CLAMP / log2(e)).
_CLAMP = 90.0
_HEAD_DIM = 128  # the head dim the Hopper kernels are built for


def _forward_only(*tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the PyTorch port is forward-only so far: the flash backward "
            "kernels (B2, B5) come with the training slice")


def _fold(q: torch.Tensor, scale: float) -> torch.Tensor:
    """scale*log2e folded into q in q's own dtype (one bf16 rounding)."""
    return (q.float() * (scale * _LOG2E)).to(q.dtype)


def _check_cuda_operand(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs a contiguous last dim")
    step = 16 // t.element_size()
    if any(s % step for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned in every row")


def _finish(acc, l, m, safe: bool, exp2_units: bool, out_dtype):
    """out = acc / l and lse, with the dead-row identity (out 0, lse -inf)."""
    dead = l == 0.0
    safe_l = torch.where(dead, torch.ones_like(l), l)
    out = torch.where(dead[..., None], torch.zeros_like(acc),
                      acc / safe_l[..., None])
    lse = torch.log(safe_l)
    if safe:
        lse = (m * _LN2 if exp2_units else m) + lse
    lse = torch.where(dead, torch.full_like(lse, -math.inf), lse)
    return out.to(out_dtype), lse


# ---------------------------------------------------------------------------
# B1: causal self-attention
# ---------------------------------------------------------------------------


def flash_fwd_causal_self_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, scale: float,
                                safe_softmax: bool = False):
    """Plain version of kernel B1 (same arithmetic, whole rows at once).

    q (b, s, h, d); k, v (b, s, h_kv, d) -> out (b, s, h, d) in q's dtype,
    lse (b, h, s) fp32. Fast form: q folded by scale*log2e in its dtype,
    p = exp2(min(s, 90)), out = (bf16(p) @ v) / rowsum(p). Safe form: the
    exact softmax in exp2 units (the kernel's online max gives the same
    values up to rounding)."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    qf = q.float() if safe_softmax else _fold(q, scale).float()
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if safe_softmax:
        sc = sc * (scale * _LOG2E)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).triu(1)
    sc = sc.masked_fill(mask, NEG_INF)
    m = None
    if safe_softmax:
        m = sc.amax(dim=-1)
        p = torch.exp2(sc - m[..., None]).masked_fill(mask, 0.0)
    else:
        p = torch.exp2(torch.clamp(sc, max=_CLAMP))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vf)
    out, lse = _finish(acc, l, m, safe_softmax, True, q.dtype)
    return out.transpose(1, 2), lse


def flash_fwd_causal_self(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, safe_softmax: bool = False):
    """Kernel B1 wrapper: causal self-attention forward, BSHD in and out.

    q (b, s, h, d) bf16; k, v (b, s, h_kv, d) bf16 with h % h_kv == 0 ->
    out (b, s, h, d) bf16 and lse (b, h, s) fp32. CPU tensors take
    :func:`flash_fwd_causal_self_plain`."""
    if q.device.type == "cpu":
        return flash_fwd_causal_self_plain(q, k, v, scale=scale,
                                           safe_softmax=safe_softmax)
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    if k.shape != (b, s, h_kv, d) or v.shape != k.shape or h % h_kv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not causal self-attention")
    if d != _HEAD_DIM:
        raise NotImplementedError(f"the B1 kernel is built for head_dim "
                                  f"{_HEAD_DIM}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda_operand(name, t, torch.bfloat16, q.device)
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dims = _build.dims_array([
        b, h, h_kv, s, s, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], 0, 0, 0, 0, 1])
    _build.KERNELS["flash_fwd_causal_self"](
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        _build.ptr(lse), dims, scale * _LOG2E, scale * _LOG2E,
        int(safe_softmax), _build.stream_ptr(q.device))
    return out, lse


# ---------------------------------------------------------------------------
# B3: global-position forward against a (quantized) BHSD kv
# ---------------------------------------------------------------------------


def flash_fwd_pos_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None, *,
                        q_start: int = 0, causal: bool = False,
                        scale: float, safe_softmax: bool = False):
    """Plain version of kernel B3 (same arithmetic, whole rows at once).

    q (b, s_q, h, d) at positions q_start + i; k, v (b, h_kv, s_kv, d) at
    positions j, bf16 or int8 with fp32 scales (b, h_kv, s_kv). Fast form:
    s = (q folded) . k * k_scale, p = exp2(min(s, 90)), l = rowsum(p) before
    V's scale, acc = bf16(p * v_scale) @ v. Safe form: s = q . k * k_scale *
    scale and the exact softmax in natural units."""
    b, s_q, h, d = q.shape
    s_kv = k.shape[2]
    g = h // k.shape[1]
    quant = k_scale is not None
    vdt = torch.bfloat16 if quant else v.dtype
    qf = q.float() if safe_softmax else _fold(q, scale).float()
    kf = k.to(vdt).float().repeat_interleave(g, dim=1)
    vf = v.to(vdt).float().repeat_interleave(g, dim=1)
    sc = torch.einsum("bqhd,bhkd->bhqk", qf, kf)
    if quant:
        sc = sc * k_scale.float().repeat_interleave(g, dim=1)[:, :, None, :]
    if safe_softmax:
        sc = sc * scale
    mask = None
    if causal:
        rows = q_start + torch.arange(s_q, device=q.device)
        cols = torch.arange(s_kv, device=q.device)
        mask = cols[None, :] > rows[:, None]
        sc = sc.masked_fill(mask, NEG_INF)
    m = None
    if safe_softmax:
        m = sc.amax(dim=-1)
        p = torch.exp(sc - m[..., None])
        if mask is not None:
            p = p.masked_fill(mask, 0.0)
    else:
        p = torch.exp2(torch.clamp(sc, max=_CLAMP))
    l = p.sum(dim=-1)
    if quant:
        p = p * v_scale.float().repeat_interleave(g, dim=1)[:, :, None, :]
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(vdt).float(), vf)
    out, lse = _finish(acc, l, m, safe_softmax, False, q.dtype)
    return out.transpose(1, 2), lse


def flash_fwd_pos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None, *,
                  q_start: int = 0, causal: bool = False, scale: float,
                  safe_softmax: bool = False):
    """Kernel B3 wrapper: q (b, s_q, h, d) bf16 against k, v (b, h_kv, s_kv,
    d), bf16 or int8 with fp32 scales (b, h_kv, s_kv). k, v and the scales
    may be strided views (a cache slice); they are read in place. Returns
    out (b, s_q, h, d) bf16 and lse (b, h, s_q) fp32. CPU tensors take
    :func:`flash_fwd_pos_plain`."""
    if q.device.type == "cpu":
        return flash_fwd_pos_plain(q, k, v, k_scale, v_scale,
                                   q_start=q_start, causal=causal,
                                   scale=scale, safe_softmax=safe_softmax)
    b, s_q, h, d = q.shape
    _, h_kv, s_kv, _ = k.shape
    if k.shape != (b, h_kv, s_kv, d) or v.shape != k.shape or h % h_kv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if d != _HEAD_DIM:
        raise NotImplementedError(f"the B3 kernel is built for head_dim "
                                  f"{_HEAD_DIM}, got {d}")
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("k_scale and v_scale must be passed together")
    kv_dtype = torch.int8 if quant else torch.bfloat16
    _check_cuda_operand("q", q, torch.bfloat16, q.device)
    _check_cuda_operand("k", k, kv_dtype, q.device)
    _check_cuda_operand("v", v, kv_dtype, q.device)
    if v.stride() != k.stride():
        raise ValueError("k and v must share strides")
    sc_strides = (0, 0, 0)
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (t.shape != (b, h_kv, s_kv) or t.dtype != torch.float32
                    or t.device != q.device):
                raise ValueError(f"{name} must be fp32 (b, h_kv, s_kv) on "
                                 f"{q.device}")
        if v_scale.stride() != k_scale.stride():
            raise ValueError("k_scale and v_scale must share strides")
        sc_strides = k_scale.stride()
    out = torch.empty((b, s_q, h, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    kst = (k.stride(0), k.stride(2), k.stride(1))  # (batch, seq, head)
    dims = _build.dims_array([
        b, h, h_kv, s_q, s_kv, *q.stride()[:3], *kst, *kst,
        *out.stride()[:3], *sc_strides, int(q_start), int(causal)])
    _build.KERNELS["flash_fwd_pos"](
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(k_scale),
        _build.ptr(v_scale), _build.ptr(out), _build.ptr(lse), dims,
        scale * _LOG2E, scale, int(safe_softmax),
        _build.stream_ptr(q.device))
    return out, lse


# ---------------------------------------------------------------------------
# Public API (the JAX package's names and kwargs)
# ---------------------------------------------------------------------------


# kwargs of the JAX API whose non-default values the port does not take yet
_FEATURE_DEFAULTS = dict(
    window_size=(-1, -1), softcap=0.0, q_offsets=None, kv_offsets=None,
    q_stride=1, kv_stride=1, q_segment_ids=None, kv_segment_ids=None,
    dropout_p=0.0, dropout_key=None, dropout_seed=None, alibi_slopes=None,
    sink_tokens=0, kv_lengths=None)


def _reject_features(where: str, features) -> None:
    """Raise for a kwarg the JAX API does not have, or for a feature kwarg
    (:data:`_FEATURE_DEFAULTS`) set to anything but its default."""
    for name, val in features.items():
        if name not in _FEATURE_DEFAULTS:
            raise TypeError(f"unexpected kwarg {name!r}")
        default = _FEATURE_DEFAULTS[name]
        if isinstance(val, list):
            val = tuple(val)
        if (val is not None) if default is None else (val != default):
            raise not_ported(f"{name} on {where}")


def _scale(q, softmax_scale) -> float:
    return (softmax_scale if softmax_scale is not None
            else 1.0 / math.sqrt(q.shape[-1]))


def flash_attention(q, k, v, *, causal: bool = False,
                    softmax_scale: Optional[float] = None,
                    block_sizes=None, interpret=None, return_lse: bool = False,
                    tri_grid=None, safe_softmax: bool = False, **features):
    """Flash attention forward, BSHD: q (b, s, h, d); k, v (b, s, h_kv, d).

    The port takes causal self-attention (s_q == s_kv), which runs kernel
    B1; the JAX API's feature kwargs (:data:`_FEATURE_DEFAULTS`) raise
    ``NotImplementedError`` unless left at their defaults. ``block_sizes``,
    ``interpret`` and ``tri_grid`` are accepted for API parity; the Hopper
    kernel picks its own tiles and always walks only the live ones. Forward
    only."""
    del block_sizes, interpret, tri_grid
    _forward_only(q, k, v)
    _reject_features("self-attention (kernels B3/B4 in full)", features)
    if not causal or q.shape[1] != k.shape[1]:
        raise not_ported("attention other than causal self-attention "
                         "(kernels B3/B4 in full)")
    out, lse = flash_fwd_causal_self(q, k, v, scale=_scale(q, softmax_scale),
                                     safe_softmax=safe_softmax)
    return (out, lse) if return_lse else out


def flash_attention_fwd(q, k, v, *, k_scale=None, v_scale=None,
                        causal: bool = False,
                        softmax_scale: Optional[float] = None,
                        safe_softmax: bool = False, block_sizes=None,
                        interpret=None, return_lse=None, tri_grid=None,
                        **features):
    """Forward-only entry: returns (out, lse).

    ``k_scale`` / ``v_scale`` ((b, h_kv, s_kv) fp32) switch on the int8-KV
    path (kernel B3, bottom-right aligned when s_q != s_kv)."""
    del return_lse
    if k_scale is None:
        return flash_attention(q, k, v, causal=causal,
                               softmax_scale=softmax_scale,
                               block_sizes=block_sizes, interpret=interpret,
                               return_lse=True, tri_grid=tri_grid,
                               safe_softmax=safe_softmax, **features)
    _forward_only(q, k, v)
    _reject_features("the int8-KV path (kernel B3 in full)", features)
    return flash_fwd_pos(q, k.transpose(1, 2), v.transpose(1, 2),
                         k_scale, v_scale, q_start=k.shape[1] - q.shape[1],
                         causal=causal, scale=_scale(q, softmax_scale),
                         safe_softmax=safe_softmax)


def flash_attention_fwd_cache(q, k_cache, v_cache, *, k_scale=None,
                              v_scale=None, softmax_scale=None, q_start=0,
                              block_sizes=None, interpret=None,
                              safe_softmax=False, causal=False, **features):
    """Forward-only attention of q (b, s_q, h, d) against a BHSD cache slice
    (b, h_kv, s_kv, d), bf16 or int8 with (b, h_kv, s_kv) fp32 scales: the
    chunked-prefill building block (kernel B3). q rows sit at global
    positions ``q_start + i`` and cache slots at ``j``; ``causal=True``
    masks slots past each row. Returns (out, lse), mergeable with the
    chunk's own causal attention through ``ops.merge``."""
    del block_sizes, interpret
    _forward_only(q, k_cache, v_cache)
    _reject_features("the cache path (kernel B3 in full)", features)
    return flash_fwd_pos(q, k_cache, v_cache, k_scale, v_scale,
                         q_start=int(q_start), causal=causal,
                         scale=_scale(q, softmax_scale),
                         safe_softmax=safe_softmax)
