"""Flash attention on Hopper: the public API, forward and backward, and its
six kernels.

Counterpart of ``long_context_attention_tpu/ops/flash.py``. The public
functions keep the JAX package's names, BSHD layout, kwargs and ``(out, lse
fp32)`` contract. Six kernel wrappers sit under them, each with a plain
PyTorch version of the same arithmetic in this module:

* :func:`flash_fwd_causal_self` (kernel B1, ``csrc/flash_fwd_sm90.cu``:
  wgmma and TMA, sm_90a only): causal self-attention with s_q == s_kv, the
  TPU's ``_fwd_kernel_tri``.
* :func:`flash_fwd_static` (kernel B4, ``csrc/flash_fwd.cu``): any other
  self-attention with s_q == s_kv and positions from 0 -- non-causal,
  sliding window, StreamingLLM sinks, softcap -- the TPU's
  ``_fwd_kernel_static``.
* :func:`flash_fwd_pos` (kernel B3, ``csrc/flash_fwd_sm90.cu``): q rows
  at global positions ``q_start + i`` against a BHSD kv (a cache slice,
  taken by strides), with the same masks and softcap, bf16 or int8 K/V
  with per-token scales, the TPU's ``_fwd_kernel``.
* :func:`flash_bwd_dq` (B2a, ``csrc/flash_bwd.cu``), :func:`flash_bwd_dkv`
  (B2b) and :func:`flash_bwd_fused` (B5, both ``csrc/flash_bwd_sm90.cu``:
  wgmma and TMA, sm_90a only): the TPU's ``_dq_kernel``, ``_dkv_kernel``
  and ``_bwd_fused_kernel``, fp32 partials.

:func:`flash_attention` routes its forward as the JAX package's
``_flash_fwd_bhsd`` does: B1 for plain causal self-attention, B4 for any
other self-attention without offsets, B3 with one-chunk offsets or s_q !=
s_kv (bottom-right aligned). It is differentiable: B5 is the backward of
B1 and B4, B2a + B2b that of B3. The forward is one ``torch.library`` op,
so a selective-checkpoint policy can save its (out, lse) and skip it in
the recompute. The backward of windows, sinks and softcap is not ported
yet: a gradient through them raises ``NotImplementedError``.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Features the kernels do not take (segments,
ALiBi, dropout, position chunks and strides) raise
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
           "flash_fwd_pos_plain", "flash_fwd_static",
           "flash_fwd_static_plain", "FLASH_ATTENTION_OP"]

_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)
# Fast-softmax score clamp in exp2 units (raw score <= _CLAMP / log2(e)).
_CLAMP = 90.0
_HEAD_DIM = 128  # the head dim the Hopper kernels are built for
# softmax forms of the forward kernels' C entry points
_FAST, _ONLINE, _SOFTCAP = 0, 1, 2

_QUANT_FORWARD_ONLY = ("this attention path is forward-only, as in the JAX "
                       "package: the quantized-KV and cache paths have no "
                       "backward")
_SHAPE_FORWARD_ONLY = str(not_ported(
    "the gradient of sliding windows, attention sinks and softcap (their "
    "masks in kernels B2a, B2b and B5, the windowed training slice)"))


def _forward_only(why: str, *tensors) -> None:
    """Raise ``NotImplementedError(why)`` when autograd would record a
    gradient through ``tensors``, which this path has no backward for."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(why)


def _fold(q: torch.Tensor, scale: float) -> torch.Tensor:
    """scale*log2e folded into q in q's own dtype (one bf16 rounding)."""
    return (q.float() * (scale * _LOG2E)).to(q.dtype)


_TMA_MAX_STRIDE = 1 << 40  # bytes: cuTensorMapEncodeTiled's limit


def strided_operand_problem(shape, strides, element_size: int,
                            data_ptr: int) -> Optional[str]:
    """Why a kernel cannot read an operand of this shape, element strides,
    element size and address, or None when it can.

    The kernels read rows of 16 bytes: by TMA (a tensor map over the view,
    ``csrc/sm90.cuh`` ``encode``) or by ``cp.async``. Both need a unit
    stride along the last dim, a 16-byte aligned base and, for every other
    dim of more than one entry (a dim of one is never stepped), a positive
    stride of a multiple of 16 bytes below TMA's 2^40."""
    if shape[-1] > 1 and strides[-1] != 1:
        return "needs a contiguous last dim"
    if data_ptr % 16:
        return "must start at a 16-byte aligned address"
    for n, st in zip(shape[:-1], strides[:-1]):
        nbytes = st * element_size
        if n > 1 and (nbytes <= 0 or nbytes % 16
                      or nbytes >= _TMA_MAX_STRIDE):
            return (f"must be 16-byte aligned in every row (a stride of "
                    f"{nbytes} bytes)")
    return None


def _check_cuda_operand(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    problem = strided_operand_problem(t.shape, t.stride(), t.element_size(),
                                      t.data_ptr())
    if problem is not None:
        raise ValueError(f"{name} {problem}")


def _tma_scales(k_scale: torch.Tensor, v_scale: torch.Tensor):
    """The k and v scales (b, h_kv, s) fp32 as B3's TMA loads read them: in
    place when both have unit stride along s and 16-byte aligned bases and
    strides (a cache slice), else copies whose rows are padded to 16
    bytes."""
    def ready(t):
        return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            st % 4 == 0 for st in t.stride()[:-1])

    if ready(k_scale) and ready(v_scale):
        return k_scale, v_scale
    b, h, s = k_scale.shape
    pad = -(-s // 4) * 4
    return tuple(torch.empty((b, h, pad), dtype=torch.float32,
                             device=t.device)[..., :s].copy_(t)
                 for t in (k_scale, v_scale))


def _masks(causal: bool, window_size, sink_tokens: int, softcap: float
           ) -> Tuple[int, int, int]:
    """(left, right, sink) of the forward kernels from the JAX kwargs:
    flash-attn semantics, causal overrides the right window to 0; -1 means
    unbounded; sinks act only through a left window (flash.py:1794)."""
    left, right = (int(w) for w in window_size)
    if softcap < 0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")
    if causal:
        right = 0
    return left, right, (int(sink_tokens) if left >= 0 else 0)


def _mask(q_pos: torch.Tensor, s_kv: int, left: int, right: int, sink: int
          ) -> Optional[torch.Tensor]:
    """Boolean (s_q, s_kv) mask over q rows at ``q_pos`` and kv columns at
    0..s_kv-1, True where the score is dropped (_tile_mask)."""
    if left < 0 and right < 0:
        return None
    rows = q_pos[:, None]
    cols = torch.arange(s_kv, device=q_pos.device)[None, :]
    mask = torch.zeros((rows.shape[0], s_kv), dtype=torch.bool,
                       device=q_pos.device)
    if right >= 0:
        mask |= cols > rows + right
    if left >= 0:
        mask |= (cols < rows - left) & (cols >= sink)
    return mask


def _form(safe_softmax: bool, softcap: float) -> int:
    return _SOFTCAP if softcap > 0 else (_ONLINE if safe_softmax else _FAST)


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


def _attend_plain(q, kf, vf, mask, *, scale: float, form: int,
                  exp2_units: bool, softcap: float, vdt, k_scale=None,
                  v_scale=None):
    """The forward kernels' arithmetic, whole rows at once.

    q (b, s_q, h, d); kf, vf (b, h, s_kv, d) fp32 holding the operand
    dtype's values, repeated to h heads; k_scale / v_scale (b, h, s_kv) or
    None; mask (s_q, s_kv), True = drop. Fast form: q folded by scale*log2e
    in its dtype, p = exp2(min(s, 90)). Online forms: the exact softmax
    (the kernels' running max gives the same values up to rounding), in
    exp2 units when ``exp2_units`` and natural units otherwise; softcap:
    s = cap * tanh(s * scale / cap) in natural units. l sums p before V's
    scale; the PV product takes p (times V's scale) cast to ``vdt``."""
    online = form != _FAST
    units2 = exp2_units and form != _SOFTCAP
    qf = (q if online else _fold(q, scale)).float()
    sc = torch.einsum("bqhd,bhkd->bhqk", qf, kf)
    if k_scale is not None:
        sc.mul_(k_scale[:, :, None, :])
    if online:
        sc.mul_(scale * _LOG2E if units2 else scale)
    if form == _SOFTCAP:
        sc = torch.tanh(sc.div_(softcap)).mul_(softcap)
    if mask is not None:
        sc.masked_fill_(mask, NEG_INF)
    m = None
    if online:
        m = sc.amax(dim=-1)
        sc.sub_(m[..., None])
        p = sc.exp2_() if units2 else sc.exp_()
        if mask is not None:
            p.masked_fill_(mask, 0.0)
    else:
        p = sc.clamp_(max=_CLAMP).exp2_()
    l = p.sum(dim=-1)
    if v_scale is not None:
        p.mul_(v_scale[:, :, None, :])
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(vdt).float(), vf)
    out, lse = _finish(acc, l, m, online, units2, q.dtype)
    return out.transpose(1, 2), lse


def _self_dims(q, k, v, out, left: int, right: int, sink: int):
    """The C entry points' dims for self-attention (no scales, q_off 0)."""
    b, s, h, _ = q.shape
    return _build.dims_array([
        b, h, k.shape[2], s, s, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], 0, 0, 0, 0, left, right, sink])


def _check_self(name: str, q, k, v) -> None:
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    if k.shape != (b, s, h_kv, d) or v.shape != k.shape or h % h_kv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not self-attention")
    if d != _HEAD_DIM:
        raise NotImplementedError(f"the {name} kernel is built for head_dim "
                                  f"{_HEAD_DIM}, got {d}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda_operand(arg, t, torch.bfloat16, q.device)


# ---------------------------------------------------------------------------
# B1: causal self-attention
# ---------------------------------------------------------------------------


def flash_fwd_causal_self_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, scale: float,
                                safe_softmax: bool = False):
    """Plain version of kernel B1: :func:`flash_fwd_static_plain` with the
    causal mask (the two kernels share their arithmetic).

    q (b, s, h, d); k, v (b, s, h_kv, d) -> out (b, s, h, d) in q's dtype,
    lse (b, h, s) fp32."""
    return flash_fwd_static_plain(q, k, v, scale=scale, causal=True,
                                  safe_softmax=safe_softmax)


def flash_fwd_causal_self(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, safe_softmax: bool = False):
    """Kernel B1 wrapper: causal self-attention forward, BSHD in and out.

    q (b, s, h, d) bf16; k, v (b, s, h_kv, d) bf16 with h % h_kv == 0 ->
    out (b, s, h, d) bf16 and lse (b, h, s) fp32. CPU tensors take
    :func:`flash_fwd_causal_self_plain`."""
    if q.device.type == "cpu":
        return flash_fwd_causal_self_plain(q, k, v, scale=scale,
                                           safe_softmax=safe_softmax)
    _check_self("B1", q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _build.KERNELS["flash_fwd_causal_self"](
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        _build.ptr(lse), _self_dims(q, k, v, out, -1, 0, 0),
        scale * _LOG2E, scale * _LOG2E, int(safe_softmax),
        _build.stream_ptr(q.device))
    return out, lse


# ---------------------------------------------------------------------------
# B4: self-attention with positions from 0, any mask
# ---------------------------------------------------------------------------


def flash_fwd_static_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, scale: float, causal: bool = False,
                           window_size=(-1, -1), sink_tokens: int = 0,
                           softcap: float = 0.0, safe_softmax: bool = False):
    """Plain version of kernel B4 (same arithmetic, whole rows at once).

    q (b, s, h, d); k, v (b, s, h_kv, d), row i and column j both at
    position i, j -> out (b, s, h, d) in q's dtype, lse (b, h, s) fp32. The
    online form works in exp2 units (_fwd_kernel_static), softcap in
    natural units."""
    s, h = q.shape[1], q.shape[2]
    g = h // k.shape[2]
    left, right, sink = _masks(causal, window_size, sink_tokens, softcap)
    mask = _mask(torch.arange(s, device=q.device), s, left, right, sink)
    kf, vf = (t.transpose(1, 2).float().repeat_interleave(g, dim=1)
              for t in (k, v))
    return _attend_plain(q, kf, vf, mask, scale=scale,
                         form=_form(safe_softmax, softcap), exp2_units=True,
                         softcap=softcap, vdt=v.dtype)


def flash_fwd_static(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float, causal: bool = False, window_size=(-1, -1),
                     sink_tokens: int = 0, softcap: float = 0.0,
                     safe_softmax: bool = False):
    """Kernel B4 wrapper: self-attention forward, BSHD in and out.

    q (b, s, h, d) bf16; k, v (b, s, h_kv, d) bf16 -> out (b, s, h, d) bf16
    and lse (b, h, s) fp32; causal or not, ``window_size`` (left, right),
    ``sink_tokens`` and ``softcap`` as in :func:`flash_attention`. The
    kernel walks the sink tiles and each q tile's band only. CPU tensors
    take :func:`flash_fwd_static_plain`."""
    if q.device.type == "cpu":
        return flash_fwd_static_plain(
            q, k, v, scale=scale, causal=causal, window_size=window_size,
            sink_tokens=sink_tokens, softcap=softcap,
            safe_softmax=safe_softmax)
    left, right, sink = _masks(causal, window_size, sink_tokens, softcap)
    _check_self("B4", q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    form = _form(safe_softmax, softcap)
    _build.KERNELS["flash_fwd_static"](
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        _build.ptr(lse), _self_dims(q, k, v, out, left, right, sink),
        scale * _LOG2E, scale * _LOG2E if form == _ONLINE else scale,
        float(softcap), form, _build.stream_ptr(q.device))
    return out, lse


# ---------------------------------------------------------------------------
# B3: global-position forward against a (quantized) BHSD kv
# ---------------------------------------------------------------------------


def flash_fwd_pos_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None, *,
                        q_start: int = 0, causal: bool = False,
                        window_size=(-1, -1), sink_tokens: int = 0,
                        softcap: float = 0.0, scale: float,
                        safe_softmax: bool = False):
    """Plain version of kernel B3 (same arithmetic, whole rows at once).

    q (b, s_q, h, d) at positions q_start + i; k, v (b, h_kv, s_kv, d) at
    positions j, bf16 or int8 with fp32 scales (b, h_kv, s_kv). Fast form:
    s = (q folded) . k * k_scale, p = exp2(min(s, 90)), l = rowsum(p) before
    V's scale, acc = bf16(p * v_scale) @ v. Online form: s = q . k * k_scale
    * scale and the exact softmax in natural units; softcap caps s first."""
    s_q, h = q.shape[1], q.shape[2]
    s_kv = k.shape[2]
    g = h // k.shape[1]
    quant = k_scale is not None
    vdt = torch.bfloat16 if quant else v.dtype
    left, right, sink = _masks(causal, window_size, sink_tokens, softcap)
    mask = _mask(q_start + torch.arange(s_q, device=q.device), s_kv, left,
                 right, sink)
    kf, vf = (t.to(vdt).float().repeat_interleave(g, dim=1) for t in (k, v))
    ks = vs = None
    if quant:
        ks, vs = (t.float().repeat_interleave(g, dim=1)
                  for t in (k_scale, v_scale))
    return _attend_plain(q, kf, vf, mask, scale=scale,
                         form=_form(safe_softmax, softcap), exp2_units=False,
                         softcap=softcap, vdt=vdt, k_scale=ks, v_scale=vs)


def flash_fwd_pos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None, *,
                  q_start: int = 0, causal: bool = False,
                  window_size=(-1, -1), sink_tokens: int = 0,
                  softcap: float = 0.0, scale: float,
                  safe_softmax: bool = False):
    """Kernel B3 wrapper: q (b, s_q, h, d) bf16 against k, v (b, h_kv, s_kv,
    d), bf16 or int8 with fp32 scales (b, h_kv, s_kv). k, v and the scales
    may be strided views (a cache slice); they are read in place. Masks and
    softcap as in :func:`flash_attention`, over q rows at ``q_start + i``;
    the kernel walks the sink tiles and each q tile's band only. Returns
    out (b, s_q, h, d) bf16 and lse (b, h, s_q) fp32. CPU tensors take
    :func:`flash_fwd_pos_plain`."""
    if q.device.type == "cpu":
        return flash_fwd_pos_plain(
            q, k, v, k_scale, v_scale, q_start=q_start, causal=causal,
            window_size=window_size, sink_tokens=sink_tokens,
            softcap=softcap, scale=scale, safe_softmax=safe_softmax)
    left, right, sink = _masks(causal, window_size, sink_tokens, softcap)
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
        k_scale, v_scale = _tma_scales(k_scale, v_scale)
        sc_strides = k_scale.stride()
    out = torch.empty((b, s_q, h, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    kst = (k.stride(0), k.stride(2), k.stride(1))  # (batch, seq, head)
    dims = _build.dims_array([
        b, h, h_kv, s_q, s_kv, *q.stride()[:3], *kst, *kst,
        *out.stride()[:3], *sc_strides, int(q_start), left, right, sink])
    _build.KERNELS["flash_fwd_pos"](
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(k_scale),
        _build.ptr(v_scale), _build.ptr(out), _build.ptr(lse), dims,
        scale * _LOG2E, scale, float(softcap), _form(safe_softmax, softcap),
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
    """Kernel B2b wrapper: dk, dv (b, s_kv, h_kv, d) fp32. Each 128-row kv
    tile walks its group's query heads and their q tiles from the causal
    diagonal on (persistent blocks, TMA, wgmma). CPU tensors take
    :func:`flash_bwd_dkv_plain`."""
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
    in one pass, B2b's walk plus dq. Each (kv tile, q tile) pair's dq is
    added into a zeroed buffer by a TMA reduce-add, in no fixed order, so
    its last bits vary from run to run. CPU tensors take
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

# kernels of the op's forward (argument ``route``)
_B1, _B4, _B3 = 0, 1, 2


@torch.library.custom_op("lca_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, route: int,
              q_start: int, causal: bool, window_left: int,
              window_right: int, sink_tokens: int, softcap: float,
              scale: float, safe_softmax: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of BSHD q, k, v through kernel B1, B4 or B3 (``route``);
    B3 puts q rows at positions q_start + i."""
    if route == _B1:
        return flash_fwd_causal_self(q, k, v, scale=scale,
                                     safe_softmax=safe_softmax)
    masks = dict(causal=causal, window_size=(window_left, window_right),
                 sink_tokens=sink_tokens, softcap=softcap, scale=scale,
                 safe_softmax=safe_softmax)
    if route == _B4:
        return flash_fwd_static(q, k, v, **masks)
    return flash_fwd_pos(q, k.transpose(1, 2), v.transpose(1, 2),
                         q_start=q_start, **masks)


def _flash_op_setup(ctx, inputs, output) -> None:
    (q, k, v, route, q_start, causal, left, right, _, softcap, scale,
     _) = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.q_start = q_start if route == _B3 else None
    ctx.causal = causal
    ctx.scale = scale
    ctx.shaped = left >= 0 or (right >= 0 and not causal) or softcap > 0


def _flash_op_backward(ctx, dout, dlse):
    del dlse  # the lse cotangent is not propagated (as in flash-attn)
    if ctx.shaped:  # flash_attention refuses these before the forward
        raise NotImplementedError(_SHAPE_FORWARD_ONLY)
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, q_start=ctx.q_start,
                            causal=ctx.causal, scale=ctx.scale)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)) + (None,) * 9


_flash_op.register_autograd(_flash_op_backward, setup_context=_flash_op_setup)

# The op a selective-checkpoint policy names to keep the attention forward
# out of the recompute (models/llama.py, remat="attn").
FLASH_ATTENTION_OP = torch.ops.lca_torch.flash_attention.default


# ---------------------------------------------------------------------------
# Public API (the JAX package's names and kwargs)
# ---------------------------------------------------------------------------


# kwargs of the JAX API whose non-default values the port does not take yet
# (the forward entries take window_size, softcap and sink_tokens)
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
                    window_size=(-1, -1), softcap: float = 0.0,
                    sink_tokens: int = 0, block_sizes=None, interpret=None,
                    return_lse: bool = False, tri_grid=None,
                    safe_softmax: bool = False, **features):
    """Flash attention, BSHD: q (b, s_q, h, d); k, v (b, s_kv, h_kv, d).

    ``window_size`` (left, right) is a sliding window over global
    positions (-1: unbounded; causal sets right to 0), ``sink_tokens``
    keeps positions below it visible through the left window, ``softcap``
    caps the scores (cap * tanh(s / cap), online softmax). Forward by the
    JAX package's routing: causal self-attention with no window, softcap or
    offsets runs B1 (``tri_grid=False`` sends it to B4 as in JAX), any other
    self-attention without offsets B4, one-chunk ``q_offsets`` /
    ``kv_offsets`` (token i at offset + i, stride 1) or s_q != s_kv
    (bottom-right aligned) B3. Differentiable without a window, sinks or
    softcap: B5 backward after B1 and B4, B2a + B2b after B3; with them a
    gradient raises ``NotImplementedError``. The other feature kwargs
    (:data:`_FEATURE_DEFAULTS`) raise unless left at their defaults.
    ``block_sizes`` and ``interpret`` are accepted for API parity; the
    Hopper kernels pick their own tiles and walk only the live ones."""
    del block_sizes, interpret
    q_start = _q_start(q.shape[1], k.shape[1], features)
    _reject_features("flash_attention (kernel B3 in full)", features)
    left, right, sink = _masks(causal, window_size, sink_tokens, softcap)
    if left >= 0 or (right >= 0 and not causal) or softcap > 0:
        _forward_only(_SHAPE_FORWARD_ONLY, q, k, v)
    if q_start is not None:
        route = _B3
    elif (causal and tuple(window_size) == (-1, -1) and not softcap
          and tri_grid is not False):
        route = _B1
    else:
        route = _B4
    out, lse = _flash_op(q, k, v, route, q_start or 0, bool(causal), left,
                         right, sink, float(softcap),
                         float(_scale(q, softmax_scale)), bool(safe_softmax))
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
                        window_size=(-1, -1), softcap: float = 0.0,
                        sink_tokens: int = 0, safe_softmax: bool = False,
                        block_sizes=None, interpret=None, return_lse=None,
                        tri_grid=None, **features):
    """Forward entry: returns (out, lse), differentiable as
    :func:`flash_attention` is.

    ``k_scale`` / ``v_scale`` ((b, h_kv, s_kv) fp32) switch on the int8-KV
    path (kernel B3, bottom-right aligned when s_q != s_kv, with the same
    window, sinks and softcap), which is forward-only."""
    del return_lse
    shape = dict(causal=causal, window_size=window_size, softcap=softcap,
                 sink_tokens=sink_tokens, safe_softmax=safe_softmax)
    if k_scale is None:
        return flash_attention(q, k, v, softmax_scale=softmax_scale,
                               block_sizes=block_sizes, interpret=interpret,
                               return_lse=True, tri_grid=tri_grid, **shape,
                               **features)
    _forward_only(_QUANT_FORWARD_ONLY, q, k, v)
    _reject_features("the int8-KV path (kernel B3 in full)", features)
    return flash_fwd_pos(q, k.transpose(1, 2), v.transpose(1, 2),
                         k_scale, v_scale, q_start=k.shape[1] - q.shape[1],
                         scale=_scale(q, softmax_scale), **shape)


def flash_attention_fwd_cache(q, k_cache, v_cache, *, k_scale=None,
                              v_scale=None, softmax_scale=None,
                              window_size=(-1, -1), softcap=0.0, q_start=0,
                              sink_tokens=0, block_sizes=None,
                              interpret=None, safe_softmax=False,
                              causal=False, **features):
    """Forward-only attention of q (b, s_q, h, d) against a BHSD cache slice
    (b, h_kv, s_kv, d), bf16 or int8 with (b, h_kv, s_kv) fp32 scales: the
    chunked-prefill building block (kernel B3). q rows sit at global
    positions ``q_start + i`` and cache slots at ``j``; ``causal=True``
    masks slots past each row, and ``window_size``, ``sink_tokens`` and
    ``softcap`` apply at those positions (the kernel walks only the sink
    tiles and each q tile's window band). A row that sees no slot gives out
    0 and lse -inf. Returns (out, lse), mergeable with the chunk's own
    attention through ``ops.merge``."""
    del block_sizes, interpret
    _forward_only(_QUANT_FORWARD_ONLY, q, k_cache, v_cache)
    _reject_features("the cache path (kernel B3 in full)", features)
    return flash_fwd_pos(q, k_cache, v_cache, k_scale, v_scale,
                         q_start=int(q_start), causal=causal,
                         window_size=window_size, sink_tokens=sink_tokens,
                         softcap=softcap, scale=_scale(q, softmax_scale),
                         safe_softmax=safe_softmax)
