"""SageAttention-role int8-QK prefill attention on Hopper: the quantization
pass, the public API, and its three kernels.

Counterpart of ``long_context_attention_tpu/ops/sage.py``, with its names,
BSHD layout, kwargs and ``(out, lse fp32)`` contract. Q is quantized per
(b, h, token) and K per (b, h_kv, token) after K is mean-centred over the
tokens (exact under softmax: it shifts each row's scores by a constant); V
is quantized per token and not centred. The JAX package leaves that pass to
one XLA fusion; here it is K's fp32 mean (one torch reduction) and two
kernels of ``csrc/sage_quant.cu``, one sweep over the inputs:
:func:`sage_quant_kv` (K and V) and :func:`sage_quant_q` (q, its scales
with scale * log2 e folded in, and each row's lse shift), each with a plain
version whose int8 values and scales are the kernel's bit for bit. Three
attention kernel wrappers sit under the API, each with a plain PyTorch
version of the same arithmetic:

* :func:`sage_fwd_tri` (kernel B8a, ``csrc/sage_fwd_sm90.cu``): causal
  self-attention, the TPU's ``_sage_kernel_tri``;
* :func:`sage_fwd_rect` (kernel B8c, ``csrc/flash_fwd.cu``): no mask, the
  TPU's ``_sage_kernel_rect``;
* :func:`sage_fwd_pos` (kernel B8b, ``csrc/sage_fwd_sm90.cu``): q rows and
  kv columns at the global positions of a descriptor (``ops.flash``
  ``Positions``: q at ``q_start + i``, or the ring layouts' chunks and
  stride), causal, sliding window and sinks, the TPU's
  ``_sage_kernel_pos``.

All three compute s = (q8 . k8)_int32 * qs * ks in exp2 units (the softmax
scale and log2 e folded into q's scales), p = exp2(min(s, 90)) with no
running max, l = rowsum(p) before V's scale multiplies p, and out =
(bf16(p * vs) @ v8) / l, lse = ln l; a row that sees nothing gives out 0
and lse -inf. :func:`sage_attention` adds the K-centring shift back to the
lse, so it merges with any other block.

:func:`sage_attention_full` is differentiable: one ``torch.library`` op
whose backward is the bf16 flash backward (kernel B5, or B2a + B2b with
offsets) on the unquantized inputs, anchored on the op's own (out, lse):
the straight-through recipe of the JAX registry. ``pv_int8=True`` (the int8
PV product) is not ported and raises ``NotImplementedError``, as do
softcap, segments, dropout and ALiBi (which raise in JAX too). A wrapper
given CPU tensors runs its plain version; given CUDA tensors it launches
its kernel or raises.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from long_context_attention_tpu_torch.ops import _build
from long_context_attention_tpu_torch.ops.flash import (
    _CLAMP,
    _HEAD_DIM,
    _LOG2E,
    _QUANT_FORWARD_ONLY,
    _check_cuda_operand,
    _finish,
    _flash_bwd,
    _forward_only,
    _mask,
    _masks,
    _pos,
    _scale,
    Positions,
    call_positions,
    legacy_dims,
    pair_masks,
)
from long_context_attention_tpu_torch.utils.config import NEG_INF, not_ported

__all__ = ["sage_attention", "sage_attention_fwd", "sage_attention_full",
           "sage_attention_fwd_prequant", "sage_quantize_kv", "sage_k_mean",
           "sage_quant_kv", "sage_quant_kv_plain", "sage_quant_q",
           "sage_quant_q_plain", "sage_fwd_tri", "sage_fwd_tri_plain",
           "sage_fwd_rect", "sage_fwd_rect_plain", "sage_fwd_pos",
           "sage_fwd_pos_plain", "SAGE_ATTENTION_OP"]


# ---------------------------------------------------------------------------
# The quantization pass: K's mean, then one kernel for K and V and one for q
# ---------------------------------------------------------------------------


def _quant_per_token(x: torch.Tensor):
    """(..., d) float -> int8 values and (...,) fp32 absmax/127 scales, as
    the JAX quantizer computes them: both divisions are IEEE divisions (on
    the card too, where torch would multiply by the reciprocal of a Python
    scalar divisor) and the rounding is half to even."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax / amax.new_full((), 127.0)
    safe = scale.clamp_min(1e-30)[..., None]
    vals = torch.round(xf / safe).clamp_(-127.0, 127.0).to(torch.int8)
    return vals, scale


def sage_k_mean(k: torch.Tensor) -> torch.Tensor:
    """K's fp32 mean over the tokens: k (b, s_kv, h_kv, d) -> (b, h_kv, d)
    contiguous, one reduction that accumulates in fp32 (no fp32 copy of
    k)."""
    return k.mean(dim=1, dtype=torch.float32).contiguous()


def sage_quant_kv_plain(k, v, k_mean):
    """Plain version of the K/V quantization kernel: k, v (b, s_kv, h_kv, d)
    float, k_mean (b, h_kv, d) fp32 -> k8, v8 int8 (b, s_kv, h_kv, d) and
    ks, vs fp32 (b, h_kv, s_kv); K is centred by k_mean in fp32 first."""
    k8, ks = _quant_per_token(k.float() - k_mean[:, None])
    v8, vs = _quant_per_token(v)
    return k8, ks.transpose(1, 2), v8, vs.transpose(1, 2)


def sage_quant_q_plain(q, scale: float, k_mean=None):
    """Plain version of the q quantization kernel: q (b, s, h, d) float ->
    q8 int8 (b, s, h, d), qs fp32 (b, h, s) with scale * log2 e folded in
    (the kernels' scores land in exp2 units), and, given K's mean (b, h_kv,
    d), the lse shift scale * (q_row . k_mean) fp32 (b, h, s) that undoes
    the K centring (else None)."""
    q8, qs = _quant_per_token(q)
    qs = (qs * (scale * _LOG2E)).transpose(1, 2)
    if k_mean is None:
        return q8, qs, None
    mean = k_mean.repeat_interleave(q.shape[2] // k_mean.shape[1], dim=1)
    return q8, qs, scale * torch.einsum("bshd,bhd->bhs", q.float(), mean)


def _check_quant_input(name, t, device) -> None:
    if t.shape[-1] != _HEAD_DIM:
        raise NotImplementedError(f"the sage quantization kernels are built "
                                  f"for head_dim {_HEAD_DIM}, got "
                                  f"{t.shape[-1]}")
    _check_cuda_operand(name, t, torch.bfloat16, device)


def _check_k_mean(k_mean, shape, device) -> None:
    if (k_mean.shape != shape or k_mean.dtype != torch.float32
            or k_mean.device != device or not k_mean.is_contiguous()):
        raise ValueError(f"k_mean must be contiguous fp32 {shape} on "
                         f"{device}")


def sage_quant_kv(k, v, k_mean):
    """K/V quantization kernel wrapper (``csrc/sage_quant.cu``, one launch):
    operands and results as in :func:`sage_quant_kv_plain`, which CPU
    tensors take; on the card k and v are bf16, the results contiguous."""
    if k.device.type == "cpu":
        return sage_quant_kv_plain(k, v, k_mean)
    b, s, hk, d = k.shape
    if v.shape != k.shape:
        raise ValueError(f"shapes k {tuple(k.shape)}, v {tuple(v.shape)} do "
                         f"not match")
    for name, t in (("k", k), ("v", v)):
        _check_quant_input(name, t, k.device)
    _check_k_mean(k_mean, (b, hk, d), k.device)
    k8, v8 = (torch.empty((b, s, hk, d), dtype=torch.int8, device=k.device)
              for _ in range(2))
    ks, vs = (torch.empty((b, hk, s), dtype=torch.float32, device=k.device)
              for _ in range(2))
    dims = _build.dims_array([b, s, hk, *k.stride()[:3], *v.stride()[:3]])
    _build.KERNELS["sage_quant_kv"](
        _build.ptr(k), _build.ptr(v), _build.ptr(k_mean), _build.ptr(k8),
        _build.ptr(ks), _build.ptr(v8), _build.ptr(vs), dims,
        _build.stream_ptr(k.device))
    return k8, ks, v8, vs


def sage_quant_q(q, scale: float, k_mean=None):
    """q quantization kernel wrapper (``csrc/sage_quant.cu``, one launch):
    operands and results as in :func:`sage_quant_q_plain`, which CPU
    tensors take; on the card q is bf16, the results contiguous."""
    if q.device.type == "cpu":
        return sage_quant_q_plain(q, scale, k_mean)
    b, s, h, d = q.shape
    _check_quant_input("q", q, q.device)
    hk = h
    if k_mean is not None:
        hk = k_mean.shape[1]
        if h % hk:
            raise ValueError(f"GQA requires h ({h}) % h_kv ({hk}) == 0")
        _check_k_mean(k_mean, (b, hk, d), q.device)
    q8 = torch.empty((b, s, h, d), dtype=torch.int8, device=q.device)
    qs = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    shift = None if k_mean is None else torch.empty_like(qs)
    dims = _build.dims_array([b, s, h, hk, *q.stride()[:3]])
    _build.KERNELS["sage_quant_q"](
        _build.ptr(q), _build.ptr(k_mean), _build.ptr(q8), _build.ptr(qs),
        _build.ptr(shift), dims, scale * _LOG2E, scale,
        _build.stream_ptr(q.device))
    return q8, qs, shift


def sage_quantize_kv(k_bhsd: torch.Tensor, v_bhsd: torch.Tensor):
    """Quantize BHSD K/V for the sage kernels (the JAX package's function):
    K mean-centred over the tokens per (b, h_kv, channel) in fp32 first.
    Returns (k8, ks, v8, vs, k_mean): values int8 (b, h_kv, s, d), scales
    fp32 (b, h_kv, s), the removed mean (b, h_kv, 1, d) fp32. Centring
    shifts q row i's scores by -scale * (q_i . k_mean), which
    :func:`sage_attention` adds back to the lse. On the card, one
    :func:`sage_quant_kv` launch (values are BSHD-contiguous views)."""
    k, v = k_bhsd.transpose(1, 2), v_bhsd.transpose(1, 2)
    k_mean = sage_k_mean(k)
    k8, ks, v8, vs = sage_quant_kv(k, v, k_mean)
    return k8.transpose(1, 2), ks, v8.transpose(1, 2), vs, k_mean[:, :, None]


# ---------------------------------------------------------------------------
# Plain versions of B8a, B8c, B8b (one arithmetic, three masks)
# ---------------------------------------------------------------------------


def _sage_plain(q8, qs, k8, ks, v8, vs, mask, out_dtype):
    """The kernels' arithmetic, whole rows at once, one batch row at a time
    (bounds the (h, s_q, s_kv) score tensor). q8 (b, s_q, h, d), qs (b, h,
    s_q); k8, v8 (b, s_kv, h_kv, d), ks, vs (b, h_kv, s_kv); mask (s_q,
    s_kv) True = drop, or None. The int32 product q8 . k8 is exact in fp32
    (127^2 * 128 < 2^24)."""
    g = q8.shape[2] // k8.shape[2]
    outs, lses = [], []
    for i in range(q8.shape[0]):
        qf = q8[i].transpose(0, 1).float()
        kf, vf = (t[i].transpose(0, 1).float().repeat_interleave(g, dim=0)
                  for t in (k8, v8))
        s = torch.matmul(qf, kf.transpose(1, 2))
        s.mul_(qs[i][:, :, None]).mul_(
            ks[i].repeat_interleave(g, dim=0)[:, None, :])
        if mask is not None:
            s.masked_fill_(mask, NEG_INF)
        p = s.clamp_(max=_CLAMP).exp2_()
        l = p.sum(dim=-1)
        p.mul_(vs[i].repeat_interleave(g, dim=0)[:, None, :])
        acc = torch.matmul(p.to(torch.bfloat16).float(), vf)
        del p, s
        out, lse = _finish(acc, l, None, False, False, out_dtype)
        outs.append(out.transpose(0, 1))
        lses.append(lse)
    return torch.stack(outs), torch.stack(lses)


def sage_fwd_tri_plain(q8, qs, k8, ks, v8, vs, *, out_dtype=torch.bfloat16):
    """Plain version of kernel B8a: causal self-attention (s_q == s_kv).

    q8 (b, s, h, d) int8 with qs (b, h, s) fp32 (scale * log2 e folded);
    k8, v8 (b, s, h_kv, d) int8 with ks, vs (b, h_kv, s) fp32 -> out (b, s,
    h, d) in ``out_dtype``, lse (b, h, s) fp32 (uncorrected for K's mean)."""
    s = q8.shape[1]
    ar = torch.arange(s, device=q8.device)
    mask = _mask(ar, ar, -1, 0, 0)
    return _sage_plain(q8, qs, k8, ks, v8, vs, mask, out_dtype)


def sage_fwd_rect_plain(q8, qs, k8, ks, v8, vs, *, out_dtype=torch.bfloat16):
    """Plain version of kernel B8c: every row sees every kv column (any
    s_q, s_kv); operands as in :func:`sage_fwd_tri_plain`."""
    return _sage_plain(q8, qs, k8, ks, v8, vs, None, out_dtype)


def sage_fwd_pos_plain(q8, qs, k8, ks, v8, vs, *, q_start: int = 0,
                       pos: Optional[Positions] = None, causal: bool = False,
                       window_size=(-1, -1), sink_tokens: int = 0,
                       out_dtype=torch.bfloat16):
    """Plain version of kernel B8b: q rows and kv columns at the global
    positions of ``pos`` (any descriptor), or q row i at ``q_start + i``
    and kv column j at j, with the causal mask, the window (left, right)
    and the sinks (positions below ``sink_tokens``) of ``flash_attention``
    (_sage_kernel_pos); operands as in :func:`sage_fwd_tri_plain`."""
    left, right, sink = _masks(causal, window_size, sink_tokens, 0.0)
    pos = _pos(pos, q_start)
    mask = _mask(pos.q_positions(q8.shape[1], q8.device),
                 pos.kv_positions(k8.shape[1], q8.device), left, right, sink)
    return _sage_plain(q8, qs, k8, ks, v8, vs, mask, out_dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _sage_launch(kernel: str, q8, qs, k8, ks, v8, vs, out_dtype, *,
                 pos: Optional[Positions] = None, left: int = -1,
                 right: int = -1, sink: int = 0):
    """Check the operands of a sage kernel and launch it on the current
    stream; int8 values and fp32 scales are read by strides."""
    b, s_q, h, d = q8.shape
    _, s_kv, h_kv, _ = k8.shape
    if (k8.shape != (b, s_kv, h_kv, d) or v8.shape != k8.shape
            or h % h_kv):
        raise ValueError(f"shapes q8 {tuple(q8.shape)}, k8 "
                         f"{tuple(k8.shape)}, v8 {tuple(v8.shape)} do not "
                         f"match")
    if d != _HEAD_DIM:
        raise NotImplementedError(f"the sage kernels are built for head_dim "
                                  f"{_HEAD_DIM}, got {d}")
    for name, t in (("q8", q8), ("k8", k8), ("v8", v8)):
        _check_cuda_operand(name, t, torch.int8, q8.device)
    for name, t, shape in (("qs", qs, (b, h, s_q)), ("ks", ks, (b, h_kv, s_kv)),
                           ("vs", vs, (b, h_kv, s_kv))):
        if (t.shape != shape or t.dtype != torch.float32
                or t.device != q8.device):
            raise ValueError(f"{name} must be fp32 {shape} on {q8.device}")
    if out_dtype != torch.bfloat16:
        raise ValueError(f"the sage kernels write bf16 (bf16 q), not "
                         f"{out_dtype}")
    out = torch.empty((b, s_q, h, d), dtype=out_dtype, device=q8.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q8.device)
    pos = pos or Positions.at(0)
    q0, sink0 = legacy_dims(pos, sink)
    dims = _build.dims_array([
        b, h, h_kv, s_q, s_kv, *q8.stride()[:3], *k8.stride()[:3],
        *v8.stride()[:3], *out.stride()[:3], *qs.stride(), *ks.stride(),
        *vs.stride(), q0, left, right, sink0,
        *pair_masks(pos, s_q, s_kv, left, right, sink)])
    _build.KERNELS[kernel](
        _build.ptr(q8), _build.ptr(qs), _build.ptr(k8), _build.ptr(ks),
        _build.ptr(v8), _build.ptr(vs), _build.ptr(out), _build.ptr(lse),
        dims, _build.stream_ptr(q8.device))
    return out, lse


def sage_fwd_tri(q8, qs, k8, ks, v8, vs, *, out_dtype=torch.bfloat16):
    """Kernel B8a wrapper: causal self-attention over int8 operands. Each q
    tile walks its kv tiles up to the diagonal, the last one masked.
    Operands and results as in :func:`sage_fwd_tri_plain`, which CPU
    tensors take."""
    if q8.device.type == "cpu":
        return sage_fwd_tri_plain(q8, qs, k8, ks, v8, vs, out_dtype=out_dtype)
    if q8.shape[1] != k8.shape[1]:
        raise ValueError(f"B8a is self-attention: s_q {q8.shape[1]} != s_kv "
                         f"{k8.shape[1]}")
    return _sage_launch("sage_fwd_tri", q8, qs, k8, ks, v8, vs, out_dtype,
                        right=0)


def sage_fwd_rect(q8, qs, k8, ks, v8, vs, *, out_dtype=torch.bfloat16):
    """Kernel B8c wrapper: no mask, every kv tile for every q tile. CPU
    tensors take :func:`sage_fwd_rect_plain`."""
    if q8.device.type == "cpu":
        return sage_fwd_rect_plain(q8, qs, k8, ks, v8, vs,
                                   out_dtype=out_dtype)
    return _sage_launch("sage_fwd_rect", q8, qs, k8, ks, v8, vs, out_dtype)


def sage_fwd_pos(q8, qs, k8, ks, v8, vs, *, q_start: int = 0,
                 pos: Optional[Positions] = None, causal: bool = False,
                 window_size=(-1, -1), sink_tokens: int = 0,
                 out_dtype=torch.bfloat16):
    """Kernel B8b wrapper: positions and masks as in
    :func:`sage_fwd_pos_plain`; each q tile walks, kv chunk by kv chunk,
    the sink tiles and its window band only (the walk of kernels B3 and
    B4). CPU tensors take :func:`sage_fwd_pos_plain`."""
    if q8.device.type == "cpu":
        return sage_fwd_pos_plain(q8, qs, k8, ks, v8, vs, q_start=q_start,
                                  pos=pos, causal=causal,
                                  window_size=window_size,
                                  sink_tokens=sink_tokens,
                                  out_dtype=out_dtype)
    left, right, sink = _masks(causal, window_size, sink_tokens, 0.0)
    return _sage_launch("sage_fwd_pos", q8, qs, k8, ks, v8, vs, out_dtype,
                        pos=_pos(pos, q_start), left=left, right=right,
                        sink=sink)


# ---------------------------------------------------------------------------
# The differentiable forward: one torch.library op with its backward
# ---------------------------------------------------------------------------

# kernels of the op's forward (argument ``route``)
_TRI, _RECT, _POS = 0, 1, 2


@torch.library.custom_op("lca_torch::sage_attention", mutates_args=())
def _sage_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, route: int,
             q_offsets: List[int], kv_offsets: List[int], q_stride: int,
             kv_stride: int, static: bool, causal: bool, window_left: int,
             window_right: int, sink_tokens: int, scale: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of BSHD q, k, v: the quantization pass, kernel B8a, B8c
    or B8b (``route``, B8b at the positions of the descriptor), and the
    K-centring correction of the lse. ``static`` (self-attention without
    offsets) picks the backward only."""
    k_mean = sage_k_mean(k)
    k8, ks, v8, vs = sage_quant_kv(k, v, k_mean)
    q8, qs, shift = sage_quant_q(q, scale, k_mean)
    args = (q8, qs, k8, ks, v8, vs)
    if route == _TRI:
        out, lse = sage_fwd_tri(*args, out_dtype=q.dtype)
    elif route == _RECT:
        out, lse = sage_fwd_rect(*args, out_dtype=q.dtype)
    else:
        pos = Positions(tuple(q_offsets), tuple(kv_offsets), q_stride,
                        kv_stride)
        out, lse = sage_fwd_pos(*args, pos=pos, causal=causal,
                                window_size=(window_left, window_right),
                                sink_tokens=sink_tokens, out_dtype=q.dtype)
    return out, lse + shift


def _sage_op_setup(ctx, inputs, output) -> None:
    (q, k, v, _, q_off, kv_off, q_stride, kv_stride, static, causal, left,
     right, sink, scale) = inputs
    ctx.save_for_backward(q, k, v, *output)
    # JAX's flash_attention_bwd: static self-attention takes B5, positions
    # B2a + B2b (_flash_bwd)
    ctx.pos = (None if static else
               Positions(tuple(q_off), tuple(kv_off), q_stride, kv_stride))
    ctx.shape = dict(causal=causal, scale=scale, window_size=(left, right),
                     sink_tokens=sink)


def _sage_op_backward(ctx, dout, dlse):
    """Straight-through: the bf16 flash backward on the unquantized inputs,
    anchored on the quantized forward's (out, lse) (registry _sage_bwd)."""
    del dlse  # the lse cotangent is not propagated (as in flash-attn)
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, pos=ctx.pos,
                            **ctx.shape)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)) + (None,) * 11


_sage_op.register_autograd(_sage_op_backward, setup_context=_sage_op_setup)

# The op a selective-checkpoint policy names to keep the sage forward out
# of the recompute (models/llama.py, remat="attn").
SAGE_ATTENTION_OP = torch.ops.lca_torch.sage_attention.default


# ---------------------------------------------------------------------------
# Public API (the JAX package's names and kwargs)
# ---------------------------------------------------------------------------


def _check_pv_int8(pv_int8: bool) -> None:
    if pv_int8:
        raise not_ported("pv_int8=True (sage's int8 PV product, whose P is "
                         "requantized per row and per JAX kv tile)")


def _route(s_q: int, s_kv: int, causal: bool, window, q_offsets,
           kv_offsets, q_stride: int, kv_stride: int
           ) -> Tuple[int, Positions]:
    """(kernel, positions) by the JAX package's routing: without offsets
    or strides, B8a for plain causal self-attention and B8c for no mask;
    B8b for the rest -- offsets and strides (the ring layouts'
    descriptor), a window, or causal s_q != s_kv (bottom-right aligned).
    The TPU's cap on B8a's tile table (_TRI_TABLE_MAX) is scalar memory the
    Hopper kernel does not use."""
    no_window = tuple(int(w) for w in window) == (-1, -1)
    trivial = (q_offsets is None and kv_offsets is None and q_stride == 1
               and kv_stride == 1)
    pos = call_positions(s_q, s_kv, q_offsets, kv_offsets, q_stride,
                         kv_stride) or Positions.at(0)
    if trivial and no_window and (causal and s_q == s_kv or not causal):
        return (_TRI if causal else _RECT), pos
    return _POS, pos


def sage_attention(q, k, v, *, causal: bool = False,
                   softmax_scale: Optional[float] = None,
                   pv_int8: bool = False, window_size=(-1, -1),
                   sink_tokens: int = 0, q_offsets=None, kv_offsets=None,
                   q_stride: int = 1, kv_stride: int = 1, block_sizes=None,
                   interpret=None, return_lse: bool = False):
    """INT8-QK attention, BSHD: q (b, s_q, h, d); k, v (b, s_kv, h_kv, d),
    h % h_kv == 0. Routing as the JAX package's: B8a for causal
    self-attention, B8c without a mask, B8b for offsets and strides (the
    ring layouts' position chunks), a window (with sinks) or causal s_q !=
    s_kv (bottom-right aligned). ``return_lse`` adds the (b, h, s_q) fp32
    lse, K-centring shift included. Differentiable, the window, sinks and
    positions included (the straight-through backward, dispatched as
    JAX's flash_attention_bwd: B5 for self-attention without offsets, else
    B2a + B2b). ``pv_int8=True`` raises ``NotImplementedError``.
    ``block_sizes`` and ``interpret`` are accepted for API parity; the
    Hopper kernels pick their own tiles."""
    del block_sizes, interpret
    _check_pv_int8(pv_int8)
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"GQA requires h ({q.shape[2]}) % h_kv "
                         f"({k.shape[2]}) == 0")
    route, pos = _route(q.shape[1], k.shape[1], causal, window_size,
                        q_offsets, kv_offsets, q_stride, kv_stride)
    left, right, sink = _masks(causal, window_size, sink_tokens, 0.0)
    static = call_positions(q.shape[1], k.shape[1], q_offsets, kv_offsets,
                            q_stride, kv_stride) is None
    out, lse = _sage_op(q, k, v, route, list(pos.q_offsets),
                        list(pos.kv_offsets), pos.q_stride, pos.kv_stride,
                        static, bool(causal), left, right, sink,
                        float(_scale(q, softmax_scale)))
    return (out, lse) if return_lse else out


# the kwargs the sage entries take, and those they refuse unless neutral
_SAGE_KWARGS = ("causal", "softmax_scale", "pv_int8", "block_sizes",
                "interpret", "return_lse", "window_size", "sink_tokens",
                "q_offsets", "kv_offsets", "q_stride", "kv_stride")
_NEUTRAL = {"softcap": 0.0, "dropout_p": 0.0, "q_segment_ids": None,
            "kv_segment_ids": None, "alibi_slopes": None, "dropout_key": None,
            "dropout_seed": None}


def _vet_kwargs(kw) -> dict:
    """The sage kwargs of ``kw``; a feature sage does not implement raises
    ``NotImplementedError`` unless neutral, an unknown kwarg ``TypeError``
    (the JAX package's ``_vet_kwargs``)."""
    rest = dict(kw)
    taken = {name: rest.pop(name) for name in _SAGE_KWARGS if name in rest}
    for name, ok in _NEUTRAL.items():
        val = rest.pop(name, ok)
        if (val is not None) if ok is None else (val != ok):
            raise NotImplementedError(f"sage_attention does not implement "
                                      f"{name}; use impl='pallas'")
    if rest:
        raise TypeError(f"unexpected kwargs {sorted(rest)}")
    return taken


def sage_attention_fwd(q, k, v, **kw):
    """Registry fwd-stage entry: (out, lse) with the common registry kwargs
    checked (:func:`_vet_kwargs`)."""
    return sage_attention(q, k, v, **dict(_vet_kwargs(kw), return_lse=True))


def sage_attention_full(q, k, v, **kw):
    """Registry full-stage entry: differentiable end to end (quantized
    forward, straight-through bf16 flash backward). Unlike the JAX
    package's, which drops them, it honours ``window_size``,
    ``sink_tokens`` and the offsets."""
    return sage_attention(q, k, v, **dict(_vet_kwargs(kw), return_lse=False))


def sage_attention_fwd_prequant(q, k8, v8, k_scale, v_scale, *,
                                causal: bool = False,
                                softmax_scale: Optional[float] = None,
                                pv_int8: bool = False, window_size=(-1, -1),
                                sink_tokens: int = 0, q_offsets=None,
                                kv_offsets=None, q_stride: int = 1,
                                kv_stride: int = 1, block_sizes=None,
                                interpret=None):
    """Sage forward (kernel B8b) over K/V already quantized by
    ``ops.kv_cache.quantize_kv``: k8, v8 (b, s_kv, h_kv, d) int8 with
    (b, h_kv, s_kv) fp32 scales, not centred, so the lse needs no shift.
    q (b, s_q, h, d) is quantized here (:func:`sage_quant_q` without K's
    mean). The positions (offsets and strides: ring x sage direct-int8)
    as in :func:`sage_attention`. Forward-only. Returns (out (b, s_q, h,
    d), lse (b, h, s_q) fp32)."""
    del block_sizes, interpret
    _check_pv_int8(pv_int8)
    if k8.dtype != torch.int8 or v8.dtype != torch.int8:
        raise ValueError(f"k8 and v8 must be int8, got {k8.dtype}, "
                         f"{v8.dtype}")
    _forward_only(_QUANT_FORWARD_ONLY, q)
    _, pos = _route(q.shape[1], k8.shape[1], causal, window_size, q_offsets,
                    kv_offsets, q_stride, kv_stride)
    q8, qs, _ = sage_quant_q(q, _scale(q, softmax_scale))
    return sage_fwd_pos(q8, qs, k8, k_scale.float(), v8, v_scale.float(),
                        pos=pos, causal=causal, window_size=window_size,
                        sink_tokens=sink_tokens, out_dtype=q.dtype)
