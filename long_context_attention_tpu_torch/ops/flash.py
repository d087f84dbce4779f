"""Flash attention on Hopper: the public API, forward and backward, and its
five kernels.

Counterpart of ``long_context_attention_tpu/ops/flash.py``. The public
functions keep the JAX package's names, BSHD layout, kwargs and ``(out, lse
fp32)`` contract. Five kernel wrappers sit under them, each with a plain
PyTorch version of the same arithmetic in this module:

* :func:`flash_fwd_causal_self` (kernel B1, ``csrc/flash_fwd.cu``):
  causal self-attention with s_q == s_kv, the TPU's ``_fwd_kernel_tri``.
* :func:`flash_fwd_pos` (kernel B3, ``csrc/flash_fwd.cu``): q rows at
  global positions ``q_start + i`` against a BHSD kv (a cache slice, taken
  by strides), optionally causal, bf16 or int8 K/V with per-token scales,
  the TPU's ``_fwd_kernel``.
* :func:`flash_bwd_dq` (B2a), :func:`flash_bwd_dkv` (B2b) and
  :func:`flash_bwd_fused` (B5), ``csrc/flash_bwd.cu``: the TPU's
  ``_dq_kernel``, ``_dkv_kernel`` and ``_bwd_fused_kernel``, fp32 partials.

:func:`flash_attention` is differentiable. As in the JAX package
(``_flash_bwd_bhsd``), causal self-attention with no position offsets runs
B1 forward and the one-pass B5 backward; one-chunk ``q_offsets`` /
``kv_offsets`` (the ring step's call) run B3 forward and B2a + B2b
backward. The forward is one ``torch.library`` op, so a selective-
checkpoint policy can save its (out, lse) and skip it in the recompute.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Features the kernels do not take (sliding
windows, sinks, softcap, segments, ALiBi, dropout, position chunks and
strides, non-causal self-attention without offsets) raise
``NotImplementedError``; they come in later slices.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from long_context_attention_tpu_torch.ops import _build
from long_context_attention_tpu_torch.utils.config import NEG_INF, not_ported

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_fwd",
           "flash_attention_fwd_cache", "flash_bwd_dkv", "flash_bwd_dkv_plain",
           "flash_bwd_dq", "flash_bwd_dq_plain", "flash_bwd_fused",
           "flash_bwd_fused_plain", "flash_fwd_causal_self",
           "flash_fwd_causal_self_plain", "flash_fwd_pos",
           "flash_fwd_pos_plain", "FLASH_ATTENTION_OP"]

_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)
# Fast-softmax score clamp in exp2 units (raw score <= _CLAMP / log2(e)).
_CLAMP = 90.0
_HEAD_DIM = 128  # the head dim the Hopper kernels are built for


def _forward_only(*tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "this attention path is forward-only, as in the JAX package: "
            "the quantized-KV and cache paths have no backward")


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
# B2a, B2b, B5: the backward (fp32 partials)
# ---------------------------------------------------------------------------


def _p_ds(q, k, v, dout, lse, delta, *, q_start: int, causal: bool,
          scale: float):
    """p = exp(s - lse) and ds = p * (dp - delta) * scale, fp32 (b, h, s_q,
    s_kv), with s = (q . k) * scale from the raw q; p is 0 on masked
    entries and on rows whose lse is -inf (the TPU's _recompute_p and
    _ds_to_dqk). Also returns k and v repeated to h heads, in fp32."""
    s_q, h = q.shape[1], q.shape[2]
    s_kv = k.shape[1]
    g = h // k.shape[2]
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf).mul_(scale)
    lse4 = lse.float()[..., None]
    bad = torch.isneginf(lse4)
    s.sub_(torch.where(bad, torch.zeros_like(lse4), lse4))
    if causal:
        rows = q_start + torch.arange(s_q, device=q.device)
        cols = torch.arange(s_kv, device=q.device)
        bad = bad | (cols[None, :] > rows[:, None])
    p = s.exp_().masked_fill_(bad, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), vf)
    ds = dp.sub_(delta.float()[..., None]).mul_(p).mul_(scale)
    return p, ds, kf, vf


def _group_sum(x: torch.Tensor, h_kv: int) -> torch.Tensor:
    """(b, s, h, d) per query head -> (b, s, h_kv, d), summed over each
    kv head's group of query heads."""
    b, s, h, d = x.shape
    return x.reshape(b, s, h_kv, h // h_kv, d).sum(dim=3)


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, *, scale: float,
                       q_start: int = 0, causal: bool = True):
    """Plain version of kernel B2a (same arithmetic and casts, whole rows).

    q, dout (b, s_q, h, d); k, v (b, s_kv, h_kv, d); lse, delta (b, h, s_q)
    fp32; q row i at position q_start + i, kv column j at j. Returns dq
    (b, s_q, h, d) fp32 = bf16(ds) @ k (ds cast to k's dtype)."""
    _, ds, kf, _ = _p_ds(q, k, v, dout, lse, delta, q_start=q_start,
                         causal=causal, scale=scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kf)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, *, scale: float,
                        q_start: int = 0, causal: bool = True):
    """Plain version of kernel B2b: dk, dv (b, s_kv, h_kv, d) fp32, summed
    over each kv head's query heads; dv = bf16(p)^T @ dout (p cast to
    dout's dtype), dk = bf16(ds)^T @ q (ds cast to q's dtype)."""
    p, ds, _, _ = _p_ds(q, k, v, dout, lse, delta, q_start=q_start,
                        causal=causal, scale=scale)
    h_kv = k.shape[2]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(),
                      dout.float())
    del p
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return _group_sum(dk, h_kv), _group_sum(dv, h_kv)


def flash_bwd_fused_plain(q, k, v, dout, lse, delta, *, scale: float,
                          causal: bool = True):
    """Plain version of kernel B5: self-attention (s_q == s_kv, positions
    from 0 on both sides) -> dq, dk, dv fp32, with B2a's and B2b's casts."""
    p, ds, kf, _ = _p_ds(q, k, v, dout, lse, delta, q_start=0,
                         causal=causal, scale=scale)
    h_kv = k.shape[2]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(),
                      dout.float())
    del p
    ds16 = ds.to(q.dtype).float()
    del ds
    dq = torch.einsum("bhqk,bkhd->bqhd", ds16, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds16, q.float())
    return dq, _group_sum(dk, h_kv), _group_sum(dv, h_kv)


def _bwd_launch(kernel: str, q, k, v, dout, lse, delta, *, scale: float,
                q_start: int, causal: bool, dq=None, dk=None, dv=None):
    """Check the operands of a backward kernel and launch it on the
    current stream; the outputs are fp32 BSHD buffers made by the caller."""
    b, s_q, h, d = q.shape
    _, s_kv, h_kv, _ = k.shape
    if (dout.shape != q.shape or v.shape != k.shape or k.shape[0] != b
            or k.shape[3] != d or h % h_kv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, dout {tuple(dout.shape)} do "
                         f"not match")
    if d != _HEAD_DIM:
        raise NotImplementedError(f"the backward kernels are built for "
                                  f"head_dim {_HEAD_DIM}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        _check_cuda_operand(name, t, torch.bfloat16, q.device)
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, h, s_q) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 (b, h, s_q) on "
                             f"{q.device}")
    dq_st = dq.stride()[:3] if dq is not None else (0, 0, 0)
    dk_st = dk.stride()[:3] if dk is not None else (0, 0, 0)
    dims = _build.dims_array([
        b, h, h_kv, s_q, s_kv, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *dout.stride()[:3], *dq_st, *dk_st, int(q_start),
        int(causal)])
    _build.KERNELS[kernel](
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(dout),
        _build.ptr(lse), _build.ptr(delta), _build.ptr(dq), _build.ptr(dk),
        _build.ptr(dv), dims, scale, _build.stream_ptr(q.device))


def flash_bwd_dq(q, k, v, dout, lse, delta, *, scale: float,
                 q_start: int = 0, causal: bool = True):
    """Kernel B2a wrapper: dq (b, s_q, h, d) fp32 of bf16 BSHD q, k, v and
    dout (read by strides) with fp32 (b, h, s_q) lse and delta. One block
    per q tile walks the kv tiles up to the causal diagonal and writes once
    (no atomics: deterministic). CPU tensors take
    :func:`flash_bwd_dq_plain`."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, scale=scale,
                                  q_start=q_start, causal=causal)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _bwd_launch("flash_bwd_dq", q, k, v, dout, lse, delta, scale=scale,
                q_start=q_start, causal=causal, dq=dq)
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, *, scale: float,
                  q_start: int = 0, causal: bool = True):
    """Kernel B2b wrapper: dk, dv (b, s_kv, h_kv, d) fp32. One block per kv
    tile walks its group's query heads and their q tiles from the causal
    diagonal on. CPU tensors take :func:`flash_bwd_dkv_plain`."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, scale=scale,
                                   q_start=q_start, causal=causal)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    _bwd_launch("flash_bwd_dkv", q, k, v, dout, lse, delta, scale=scale,
                q_start=q_start, causal=causal, dk=dk, dv=dv)
    return dk, dv


def flash_bwd_fused(q, k, v, dout, lse, delta, *, scale: float,
                    causal: bool = True):
    """Kernel B5 wrapper: self-attention (s_q == s_kv) -> dq, dk, dv fp32
    in one pass. dq is summed with fp32 atomics into a zeroed buffer, so its
    last bits vary from run to run. CPU tensors take
    :func:`flash_bwd_fused_plain`."""
    if q.device.type == "cpu":
        return flash_bwd_fused_plain(q, k, v, dout, lse, delta, scale=scale,
                                     causal=causal)
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"B5 is self-attention: s_q {q.shape[1]} != s_kv "
                         f"{k.shape[1]}")
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    _bwd_launch("flash_bwd_fused", q, k, v, dout, lse, delta, scale=scale,
                q_start=0, causal=causal, dq=dq, dk=dk, dv=dv)
    return dq, dk, dv


def _flash_bwd(q, k, v, out, lse, dout, *, q_start: Optional[int],
               causal: bool, scale: float):
    """fp32 (dq, dk, dv) by the JAX package's dispatch (_flash_bwd_bhsd):
    static self-attention (q_start None) runs B5, positions run B2a +
    B2b. delta = rowsum(dout * out) is an fp32 torch pass, as XLA's."""
    dout = dout.contiguous()
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    lse = lse.contiguous()
    if q_start is None:
        return flash_bwd_fused(q, k, v, dout, lse, delta, scale=scale,
                               causal=causal)
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, scale=scale,
                      q_start=q_start, causal=causal)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, scale=scale,
                           q_start=q_start, causal=causal)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The differentiable forward: one torch.library op with its backward
# ---------------------------------------------------------------------------


@torch.library.custom_op("lca_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              positional: bool, q_start: int, causal: bool, scale: float,
              safe_softmax: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of BSHD q, k, v: B1 for causal self-attention, or B3 with
    q rows at positions q_start + i when ``positional``."""
    if positional:
        return flash_fwd_pos(q, k.transpose(1, 2), v.transpose(1, 2),
                             q_start=q_start, causal=causal, scale=scale,
                             safe_softmax=safe_softmax)
    return flash_fwd_causal_self(q, k, v, scale=scale,
                                 safe_softmax=safe_softmax)


def _flash_op_setup(ctx, inputs, output) -> None:
    q, k, v, positional, q_start, causal, scale, _ = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.q_start = q_start if positional else None
    ctx.causal = causal
    ctx.scale = scale


def _flash_op_backward(ctx, dout, dlse):
    del dlse  # the lse cotangent is not propagated (as in flash-attn)
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, q_start=ctx.q_start,
                            causal=ctx.causal, scale=ctx.scale)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            None, None, None, None, None)


_flash_op.register_autograd(_flash_op_backward, setup_context=_flash_op_setup)

# The op a selective-checkpoint policy names to keep the attention forward
# out of the recompute (models/llama.py, remat="attn").
FLASH_ATTENTION_OP = torch.ops.lca_torch.flash_attention.default


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


def _one_chunk(offsets, name: str) -> int:
    """The start position of a one-chunk ``q_offsets`` / ``kv_offsets``."""
    vals = torch.as_tensor(offsets).reshape(-1).tolist()
    if len(vals) != 1:
        raise not_ported(f"{name} with {len(vals)} position chunks (ring "
                         f"layouts)")
    return int(vals[0])


def _q_start(s_q: int, s_kv: int, features) -> Optional[int]:
    """Pop ``q_offsets`` / ``kv_offsets`` from ``features``. None means
    static self-attention (no offsets and s_q == s_kv); otherwise the
    position of q row 0 relative to kv column 0: the offsets' difference,
    or s_kv - s_q (bottom-right alignment) when only the lengths differ."""
    q_off = features.pop("q_offsets", None)
    kv_off = features.pop("kv_offsets", None)
    if q_off is None and kv_off is None:
        return None if s_q == s_kv else s_kv - s_q
    return ((0 if q_off is None else _one_chunk(q_off, "q_offsets"))
            - (0 if kv_off is None else _one_chunk(kv_off, "kv_offsets")))


def flash_attention(q, k, v, *, causal: bool = False,
                    softmax_scale: Optional[float] = None,
                    block_sizes=None, interpret=None, return_lse: bool = False,
                    tri_grid=None, safe_softmax: bool = False, **features):
    """Flash attention, BSHD: q (b, s_q, h, d); k, v (b, s_kv, h_kv, d).

    Differentiable. Causal self-attention with no offsets runs kernel B1
    forward and B5 backward; one-chunk ``q_offsets`` / ``kv_offsets``
    (token i at offset + i, stride 1), or s_q != s_kv (bottom-right
    aligned), run B3 forward and B2a + B2b backward, causal or not. The
    other feature kwargs (:data:`_FEATURE_DEFAULTS`) raise
    ``NotImplementedError`` unless left at their defaults. ``block_sizes``,
    ``interpret`` and ``tri_grid`` are accepted for API parity; the Hopper
    kernels pick their own tiles and walk only the live ones."""
    del block_sizes, interpret, tri_grid
    q_start = _q_start(q.shape[1], k.shape[1], features)
    _reject_features("flash_attention (kernels B3/B4 in full)", features)
    if q_start is None and not causal:
        raise not_ported("non-causal self-attention (kernel B4)")
    out, lse = _flash_op(q, k, v, q_start is not None, q_start or 0,
                         bool(causal), float(_scale(q, softmax_scale)),
                         bool(safe_softmax))
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = False,
                        softmax_scale: Optional[float] = None,
                        block_sizes=None, interpret=None,
                        safe_softmax: bool = False, **features):
    """Backward-only entry (the ring backward's per-step call), BSHD in and
    out: fp32 (dq, dk, dv) partials of this kv block. Static self-attention
    runs B5, one-chunk offsets (or s_q != s_kv) B2a + B2b. The backward
    recomputes in fp32 whatever the forward's softmax form was."""
    del block_sizes, interpret, safe_softmax
    q_start = _q_start(q.shape[1], k.shape[1], features)
    _reject_features("flash_attention_bwd (kernels B2/B5 in full)", features)
    return _flash_bwd(q, k, v, out, lse, dout, q_start=q_start,
                      causal=bool(causal), scale=_scale(q, softmax_scale))


def flash_attention_fwd(q, k, v, *, k_scale=None, v_scale=None,
                        causal: bool = False,
                        softmax_scale: Optional[float] = None,
                        safe_softmax: bool = False, block_sizes=None,
                        interpret=None, return_lse=None, tri_grid=None,
                        **features):
    """Forward entry: returns (out, lse), differentiable as
    :func:`flash_attention` is.

    ``k_scale`` / ``v_scale`` ((b, h_kv, s_kv) fp32) switch on the int8-KV
    path (kernel B3, bottom-right aligned when s_q != s_kv), which is
    forward-only."""
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
