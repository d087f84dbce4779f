"""Flash attention on Hopper: the public API, forward and backward, and its
six kernels.

Counterpart of ``long_context_attention_tpu/ops/flash.py``. The public
functions keep the JAX package's names, BSHD layout, kwargs and ``(out, lse
fp32)`` contract. Six kernel wrappers sit under them, each with a plain
PyTorch version of the same arithmetic in this module:

* :func:`flash_fwd_causal_self` (kernel B1, ``csrc/flash_fwd_sm90.cu``:
  wgmma and TMA, sm_90a only): causal self-attention with s_q == s_kv, the
  TPU's ``_fwd_kernel_tri``.
* :func:`flash_fwd_static` (kernel B4, ``csrc/flash_fwd_sm90.cu``, B3's
  wgmma/TMA kernel at q position 0): any other self-attention with s_q ==
  s_kv and positions from 0 -- non-causal, sliding window, StreamingLLM
  sinks, softcap -- the TPU's ``_fwd_kernel_static``.
* :func:`flash_fwd_pos` (kernel B3, ``csrc/flash_fwd_sm90.cu``): q rows
  and kv columns at the global positions of a :class:`Positions`
  descriptor (one chunk each, q at ``q_start + i``, for a cache slice
  taken by strides; up to two chunks a side and a stride for the ring
  layouts), with the same masks and softcap, bf16 or int8 K/V with
  per-token scales, the TPU's ``_fwd_kernel``.
* :func:`flash_bwd_dq` (B2a, ``csrc/flash_dq_sm90.cu``: the wgmma/TMA dq
  pipeline), :func:`flash_bwd_dkv` (B2b) and :func:`flash_bwd_fused` (B5,
  both ``csrc/flash_bwd_sm90.cu``: wgmma and TMA), all sm_90a only: the
  TPU's ``_dq_kernel``, ``_dkv_kernel`` and ``_bwd_fused_kernel``, fp32
  partials, with the forward's masks and softcap.

:func:`flash_attention` routes its forward as the JAX package's
``_flash_fwd_bhsd`` does: B1 for plain causal self-attention, B4 for any
other self-attention without offsets, B3 with offsets (``q_offsets`` /
``kv_offsets`` and the strides: global position ``offsets[l // chunk] + (l
% chunk) * stride``) or s_q != s_kv (bottom-right aligned). It is
differentiable, windows, sinks and softcap included: B5 is the backward of
B1 and B4, B2a + B2b that of B3.
The forward is one ``torch.library`` op, so a selective-checkpoint policy
can save its (out, lse) and skip it in the recompute.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. The kernels take the position descriptor in
local units (:func:`pair_masks`): up to two chunks a side, each a multiple
of 128 tokens when there are two, and one stride on both sides; the plain
versions take any descriptor the JAX package takes. Features the kernels
do not take (segments, ALiBi, dropout) raise ``NotImplementedError``; they
come in later slices.
"""

from __future__ import annotations

import math
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from long_context_attention_tpu_torch.ops import _build
from long_context_attention_tpu_torch.utils.config import NEG_INF, not_ported

__all__ = ["Positions", "expand_positions", "pair_masks", "flash_attention",
           "flash_attention_bwd", "flash_attention_fwd",
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


class Positions(NamedTuple):
    """The global positions of a call's q rows and kv columns, the JAX
    kernels' (q_offsets, kv_offsets, q_stride, kv_stride) descriptor: the
    token at local index l of a side with offsets o (n chunks of length /
    n) and stride st sits at ``o[l // chunk] + (l % chunk) * st``."""

    q_offsets: Tuple[int, ...]
    kv_offsets: Tuple[int, ...]
    q_stride: int = 1
    kv_stride: int = 1

    @classmethod
    def at(cls, q_start: int) -> "Positions":
        """q row i at ``q_start + i``, kv column j at j."""
        return cls((int(q_start),), (0,))

    def q_positions(self, s_q: int, device=None) -> torch.Tensor:
        return expand_positions(self.q_offsets, self.q_stride, s_q, device)

    def kv_positions(self, s_kv: int, device=None) -> torch.Tensor:
        return expand_positions(self.kv_offsets, self.kv_stride, s_kv,
                                device)


def expand_positions(offsets: Sequence[int], stride: int, n: int,
                     device=None) -> torch.Tensor:
    """The global position of each of n tokens of a side with these chunk
    offsets and stride."""
    chunk = n // len(offsets)
    within = torch.arange(n, device=device) % chunk * stride
    return torch.tensor(offsets, device=device).repeat_interleave(chunk) + within


def _offsets(offsets, name: str) -> Tuple[int, ...]:
    """A host tuple of ints of ``q_offsets`` / ``kv_offsets`` (a sequence,
    numpy array or tensor; the ring passes them from its rank and step)."""
    if isinstance(offsets, torch.Tensor):
        offsets = offsets.tolist()
    vals = tuple(int(v) for v in np.asarray(offsets).reshape(-1))
    if not vals:
        raise ValueError(f"{name} is empty")
    return vals


# the local-units mask of an unbounded side (csrc/sm90.cuh kOpenRel)
_OPEN = 1 << 29


def _clamp_open(x: int) -> int:
    return max(-_OPEN, min(_OPEN, x))


def pair_masks(pos: Positions, s_q: int, s_kv: int, left: int, right: int,
               sink: int) -> List[int]:
    """The kernels' descriptor (``csrc/sm90.cuh`` ``Desc``): the masks of
    global positions (``_masks``' left, right, sink) in chunk-local units.

    With one stride s on both sides, a q chunk at qo and a kv chunk at ko,
    chunk-local row i and column j see each other when j - i <= hi =
    floor((qo - ko + right) / s), and j - i >= lo = ceil((qo - ko - left) /
    s) or j < sk = ceil((sink - ko) / s) (the sinks), clamped to the chunk.
    Returns nqc, nkc, the chunk lengths, then (hi, lo, sk) of each (q chunk,
    kv chunk) pair qc * 2 + kc of four. Raises for what the kernels do not
    take: more than two chunks a side, a multi-chunk side not cut in
    multiples of 128 tokens, or two strides."""
    nqc, nkc = len(pos.q_offsets), len(pos.kv_offsets)
    if nqc > 2 or nkc > 2:
        raise not_ported(f"{nqc} q and {nkc} kv position chunks in the "
                         f"kernels (the ring layouts use at most two)")
    if pos.q_stride != pos.kv_stride:
        raise not_ported(f"q_stride {pos.q_stride} != kv_stride "
                         f"{pos.kv_stride} in the kernels")
    if s_q % nqc or s_kv % nkc:
        raise ValueError(f"s_q {s_q} and s_kv {s_kv} must divide into "
                         f"{nqc} and {nkc} chunks")
    cq, ckv = s_q // nqc, s_kv // nkc
    if (nqc > 1 and cq % 128) or (nkc > 1 and ckv % 128):
        raise ValueError(
            f"the kernels' tiles of 128 must not cross a position chunk: "
            f"s_q {s_q} in {nqc} chunks of {cq}, s_kv {s_kv} in {nkc} "
            f"chunks of {ckv}")
    st = pos.q_stride
    tail = [nqc, nkc, cq, ckv]
    for pr in range(4):
        qc, kc = divmod(pr, 2)
        if qc >= nqc or kc >= nkc:
            tail += [0, 0, 0]
            continue
        d = pos.q_offsets[qc] - pos.kv_offsets[kc]
        ko = pos.kv_offsets[kc]
        hi = _clamp_open((d + right) // st) if right >= 0 else _OPEN
        lo = _clamp_open(-((left - d) // st)) if left >= 0 else -_OPEN
        sk = min(max(-((ko - sink) // st), 0), ckv) if left >= 0 else 0
        tail += [hi, lo, sk]
    return tail


def legacy_dims(pos: Positions, sink: int) -> Tuple[int, int]:
    """The one-chunk fields that the kernels' dims keep before the
    descriptor (the layout of the earlier entry points): the position of q
    row 0 less that of kv column 0, and the sinks less the kv offset; 0, 0
    for a multi-chunk or strided call, whose kernels read the descriptor
    alone."""
    if (len(pos.q_offsets), len(pos.kv_offsets), pos.q_stride,
            pos.kv_stride) != (1, 1, 1, 1):
        return 0, 0
    ko = pos.kv_offsets[0]
    return pos.q_offsets[0] - ko, max(sink - ko, 0)


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, left: int, right: int,
          sink: int) -> Optional[torch.Tensor]:
    """Boolean (s_q, s_kv) mask over q rows at ``q_pos`` and kv columns at
    ``kv_pos`` (global positions), True where the score is dropped
    (_tile_mask)."""
    if left < 0 and right < 0:
        return None
    rows = q_pos[:, None]
    cols = kv_pos[None, :]
    mask = torch.zeros((rows.shape[0], cols.shape[1]), dtype=torch.bool,
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
        *v.stride()[:3], *out.stride()[:3], 0, 0, 0, 0, left, right, sink,
        *pair_masks(Positions.at(0), s, s, left, right, sink)])


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
    ar = torch.arange(s, device=q.device)
    mask = _mask(ar, ar, left, right, sink)
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


def _pos(pos: Optional[Positions], q_start: int) -> Positions:
    """A call's descriptor: ``pos``, or one chunk a side with q row i at
    ``q_start + i`` and kv column j at j."""
    return Positions.at(q_start) if pos is None else pos


def flash_fwd_pos_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None, *,
                        q_start: int = 0, pos: Optional[Positions] = None,
                        causal: bool = False, window_size=(-1, -1),
                        sink_tokens: int = 0, softcap: float = 0.0,
                        scale: float, safe_softmax: bool = False):
    """Plain version of kernel B3 (same arithmetic, whole rows at once).

    q (b, s_q, h, d); k, v (b, h_kv, s_kv, d), bf16 or int8 with fp32
    scales (b, h_kv, s_kv); the masks compare the global positions of
    ``pos`` (any descriptor), or q row i at q_start + i and kv column j at
    j, with sinks at positions below ``sink_tokens``. Fast form:
    s = (q folded) . k * k_scale, p = exp2(min(s, 90)), l = rowsum(p) before
    V's scale, acc = bf16(p * v_scale) @ v. Online form: s = q . k * k_scale
    * scale and the exact softmax in natural units; softcap caps s first."""
    s_q, h = q.shape[1], q.shape[2]
    s_kv = k.shape[2]
    g = h // k.shape[1]
    quant = k_scale is not None
    vdt = torch.bfloat16 if quant else v.dtype
    left, right, sink = _masks(causal, window_size, sink_tokens, softcap)
    pos = _pos(pos, q_start)
    mask = _mask(pos.q_positions(s_q, q.device),
                 pos.kv_positions(s_kv, q.device), left, right, sink)
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
                  q_start: int = 0, pos: Optional[Positions] = None,
                  causal: bool = False, window_size=(-1, -1),
                  sink_tokens: int = 0, softcap: float = 0.0, scale: float,
                  safe_softmax: bool = False):
    """Kernel B3 wrapper: q (b, s_q, h, d) bf16 against k, v (b, h_kv, s_kv,
    d), bf16 or int8 with fp32 scales (b, h_kv, s_kv). k, v and the scales
    may be strided views (a cache slice); they are read in place. Masks and
    softcap as in :func:`flash_attention`, over the positions of ``pos``
    (or q rows at ``q_start + i``, kv columns at j); each q tile walks, kv
    chunk by kv chunk, the sink tiles and its band only. Returns out (b,
    s_q, h, d) bf16 and lse (b, h, s_q) fp32. CPU tensors take
    :func:`flash_fwd_pos_plain`."""
    if q.device.type == "cpu":
        return flash_fwd_pos_plain(
            q, k, v, k_scale, v_scale, q_start=q_start, pos=pos,
            causal=causal, window_size=window_size, sink_tokens=sink_tokens,
            softcap=softcap, scale=scale, safe_softmax=safe_softmax)
    left, right, sink = _masks(causal, window_size, sink_tokens, softcap)
    pos = _pos(pos, q_start)
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
    desc = pair_masks(pos, s_q, s_kv, left, right, sink)
    q0, sink0 = legacy_dims(pos, sink)
    dims = _build.dims_array([
        b, h, h_kv, s_q, s_kv, *q.stride()[:3], *kst, *kst,
        *out.stride()[:3], *sc_strides, q0, left, right, sink0, *desc])
    _build.KERNELS["flash_fwd_pos"](
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(k_scale),
        _build.ptr(v_scale), _build.ptr(out), _build.ptr(lse), dims,
        scale * _LOG2E, scale, float(softcap), _form(safe_softmax, softcap),
        _build.stream_ptr(q.device))
    return out, lse


# ---------------------------------------------------------------------------
# B2a, B2b, B5: the backward (fp32 partials)
# ---------------------------------------------------------------------------


def _p_ds(q, k, v, dout, lse, delta, *, pos: Positions, causal: bool,
          scale: float, window_size=(-1, -1), sink_tokens: int = 0,
          softcap: float = 0.0):
    """p = exp(s - lse) and ds = p * (dp - delta) [* (1 - t^2)] * scale,
    fp32 (b, h, s_q, s_kv), with s = (q . k) * scale from the raw q, capped
    to s = cap * t, t = tanh(s / cap), under a softcap; p is 0 where the
    masks (_mask at the positions of ``pos``) drop a pair and on rows whose
    lse is -inf (the TPU's _recompute_p and _ds_to_dqk). Also returns k and
    v repeated to h heads, in fp32."""
    s_q, h = q.shape[1], q.shape[2]
    s_kv = k.shape[1]
    g = h // k.shape[2]
    left, right, sink = _masks(causal, window_size, sink_tokens, softcap)
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf).mul_(scale)
    t = None
    if softcap > 0:
        t = torch.tanh(s.div_(softcap))
        s = t * softcap
    lse4 = lse.float()[..., None]
    bad = torch.isneginf(lse4)
    s.sub_(torch.where(bad, torch.zeros_like(lse4), lse4))
    mask = _mask(pos.q_positions(s_q, q.device),
                 pos.kv_positions(s_kv, q.device), left, right, sink)
    if mask is not None:
        bad = bad | mask
    p = s.exp_().masked_fill_(bad, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), vf)
    ds = dp.sub_(delta.float()[..., None]).mul_(p)
    if t is not None:
        ds.mul_(t.mul_(t).neg_().add_(1.0))
    return p, ds.mul_(scale), kf, vf


def _group_sum(x: torch.Tensor, h_kv: int) -> torch.Tensor:
    """(b, s, h, d) per query head -> (b, s, h_kv, d), summed over each
    kv head's group of query heads."""
    b, s, h, d = x.shape
    return x.reshape(b, s, h_kv, h // h_kv, d).sum(dim=3)


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, *, scale: float,
                       q_start: int = 0, pos: Optional[Positions] = None,
                       causal: bool = True, window_size=(-1, -1),
                       sink_tokens: int = 0, softcap: float = 0.0):
    """Plain version of kernel B2a (same arithmetic and casts, whole rows).

    q, dout (b, s_q, h, d); k, v (b, s_kv, h_kv, d); lse, delta (b, h, s_q)
    fp32; the positions of ``pos`` (any descriptor), or q row i at q_start
    + i and kv column j at j; masks and softcap as in
    :func:`flash_attention`. Returns dq (b, s_q, h, d) fp32 = bf16(ds) @ k
    (ds cast to k's dtype)."""
    _, ds, kf, _ = _p_ds(q, k, v, dout, lse, delta, pos=_pos(pos, q_start),
                         causal=causal, scale=scale, window_size=window_size,
                         sink_tokens=sink_tokens, softcap=softcap)
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kf)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, *, scale: float,
                        q_start: int = 0, pos: Optional[Positions] = None,
                        causal: bool = True, window_size=(-1, -1),
                        sink_tokens: int = 0, softcap: float = 0.0):
    """Plain version of kernel B2b: dk, dv (b, s_kv, h_kv, d) fp32, summed
    over each kv head's query heads; dv = bf16(p)^T @ dout (p cast to
    dout's dtype), dk = bf16(ds)^T @ q (ds cast to q's dtype); positions
    as in :func:`flash_bwd_dq_plain`."""
    p, ds, _, _ = _p_ds(q, k, v, dout, lse, delta, pos=_pos(pos, q_start),
                        causal=causal, scale=scale, window_size=window_size,
                        sink_tokens=sink_tokens, softcap=softcap)
    h_kv = k.shape[2]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(),
                      dout.float())
    del p
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return _group_sum(dk, h_kv), _group_sum(dv, h_kv)


def flash_bwd_fused_plain(q, k, v, dout, lse, delta, *, scale: float,
                          causal: bool = True, window_size=(-1, -1),
                          sink_tokens: int = 0, softcap: float = 0.0):
    """Plain version of kernel B5: self-attention (s_q == s_kv, positions
    from 0 on both sides) -> dq, dk, dv fp32, with B2a's and B2b's casts."""
    p, ds, kf, _ = _p_ds(q, k, v, dout, lse, delta, pos=Positions.at(0),
                         causal=causal, scale=scale, window_size=window_size,
                         sink_tokens=sink_tokens, softcap=softcap)
    h_kv = k.shape[2]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(),
                      dout.float())
    del p
    ds16 = ds.to(q.dtype).float()
    del ds
    dq = torch.einsum("bhqk,bkhd->bqhd", ds16, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds16, q.float())
    return dq, _group_sum(dk, h_kv), _group_sum(dv, h_kv)


@functools.lru_cache(maxsize=256)
def _dkv_order(desc: Tuple[int, ...], causal: bool, band: bool
               ) -> Tuple[int, ...]:
    """B2b's kv tiles under a multi-chunk descriptor, longest walk first
    (ties in tile order): each kv tile of 128 rows walks, q chunk by q
    chunk, the q tiles of 64 rows from the first that sees it to the last
    (band masks: the last its left window reaches, or every one for a tile
    that holds a sink), as csrc/flash_bwd_sm90.cu QWalk counts them."""
    nqc, nkc, cq, ckv = desc[:4]
    tiles = -(-cq // 64)
    lengths = []
    for ik in range(nkc * ckv // 128):
        kc, k0l = divmod(ik * 128, ckv)
        n = 0
        for qc in range(nqc):
            hi, lo, sk = desc[4 + 3 * (qc * 2 + kc):7 + 3 * (qc * 2 + kc)]
            first = 0
            if band or causal:
                fr = k0l - hi
                first = 0 if fr <= 0 else min(tiles, fr // 64)
            last = tiles - 1
            if band and k0l >= sk:
                lr = k0l + 127 - lo
                last = -1 if lr < 0 else min(last, lr // 64)
            n += max(last - first + 1, 0)
        lengths.append(n)
    return tuple(int(i) for i in np.argsort(-np.asarray(lengths),
                                            kind="stable"))


_ORDERS = {}


def _order_tensor(order: Tuple[int, ...], device) -> torch.Tensor:
    """The int32 device copy of an order, made once per order and card."""
    key = (order, str(device))
    t = _ORDERS.get(key)
    if t is None:
        t = _ORDERS[key] = torch.tensor(order, dtype=torch.int32,
                                        device=device)
    return t


def _bwd_launch(kernel: str, q, k, v, dout, lse, delta, *, scale: float,
                pos: Positions, causal: bool, window_size, sink_tokens: int,
                softcap: float, dq=None, dk=None, dv=None):
    """Check the operands of a backward kernel and launch it on the
    current stream; the outputs are fp32 BSHD buffers made by the caller."""
    left, right, sink = _masks(causal, window_size, sink_tokens, softcap)
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
    desc = pair_masks(pos, s_q, s_kv, left, right, sink)
    q0, sink0 = legacy_dims(pos, sink)
    dq_st = dq.stride()[:3] if dq is not None else (0, 0, 0)
    dk_st = dk.stride()[:3] if dk is not None else (0, 0, 0)
    dims = _build.dims_array([
        b, h, h_kv, s_q, s_kv, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *dout.stride()[:3], *dq_st, *dk_st, q0,
        int(causal), left, right, sink0, *desc])
    args = [_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(dout),
            _build.ptr(lse), _build.ptr(delta), _build.ptr(dq),
            _build.ptr(dk), _build.ptr(dv), dims, scale, float(softcap),
            _build.stream_ptr(q.device)]
    if kernel == "flash_bwd_dkv":  # a multi-chunk walk takes the host's order
        order = None
        if desc[0] * desc[1] > 1:
            band = softcap > 0 or left >= 0 or (not causal and right >= 0)
            order = _order_tensor(_dkv_order(tuple(desc), bool(causal), band),
                                  q.device)
        args.append(_build.ptr(order))
    _build.KERNELS[kernel](*args)


def flash_bwd_dq(q, k, v, dout, lse, delta, *, scale: float,
                 q_start: int = 0, pos: Optional[Positions] = None,
                 causal: bool = True, window_size=(-1, -1),
                 sink_tokens: int = 0, softcap: float = 0.0):
    """Kernel B2a wrapper: dq (b, s_q, h, d) fp32 of bf16 BSHD q, k, v and
    dout (read by strides) with fp32 (b, h, s_q) lse and delta; positions,
    masks and softcap as in :func:`flash_fwd_pos`. Persistent blocks take
    128-row q tiles in the forward's order, each walking, kv chunk by kv
    chunk, the sink tiles and its band (wgmma, TMA), and write dq once (no
    atomics: deterministic). CPU tensors take :func:`flash_bwd_dq_plain`."""
    shape = dict(scale=scale, pos=_pos(pos, q_start), causal=causal,
                 window_size=window_size, sink_tokens=sink_tokens,
                 softcap=softcap)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, **shape)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _bwd_launch("flash_bwd_dq", q, k, v, dout, lse, delta, dq=dq, **shape)
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, *, scale: float,
                  q_start: int = 0, pos: Optional[Positions] = None,
                  causal: bool = True, window_size=(-1, -1),
                  sink_tokens: int = 0, softcap: float = 0.0):
    """Kernel B2b wrapper: dk, dv (b, s_kv, h_kv, d) fp32. Each 128-row kv
    tile walks its group's query heads and, q chunk by q chunk, their q
    tiles over its band: from the causal or right-window diagonal to the
    last row its left window reaches, every row for a tile that holds a
    sink (persistent blocks, TMA, wgmma; a multi-chunk descriptor's kv
    tiles in the host's longest-first order). CPU tensors take
    :func:`flash_bwd_dkv_plain`."""
    shape = dict(scale=scale, pos=_pos(pos, q_start), causal=causal,
                 window_size=window_size, sink_tokens=sink_tokens,
                 softcap=softcap)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, **shape)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    _bwd_launch("flash_bwd_dkv", q, k, v, dout, lse, delta, dk=dk, dv=dv,
                **shape)
    return dk, dv


def flash_bwd_fused(q, k, v, dout, lse, delta, *, scale: float,
                    causal: bool = True, window_size=(-1, -1),
                    sink_tokens: int = 0, softcap: float = 0.0):
    """Kernel B5 wrapper: self-attention (s_q == s_kv) -> dq, dk, dv fp32
    in one pass, B2b's walk plus dq. Each (kv tile, q tile) pair's dq is
    added into a zeroed buffer by a TMA reduce-add, in no fixed order, so
    its last bits vary from run to run. CPU tensors take
    :func:`flash_bwd_fused_plain`."""
    shape = dict(scale=scale, causal=causal, window_size=window_size,
                 sink_tokens=sink_tokens, softcap=softcap)
    if q.device.type == "cpu":
        return flash_bwd_fused_plain(q, k, v, dout, lse, delta, **shape)
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"B5 is self-attention: s_q {q.shape[1]} != s_kv "
                         f"{k.shape[1]}")
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    _bwd_launch("flash_bwd_fused", q, k, v, dout, lse, delta,
                pos=Positions.at(0), dq=dq, dk=dk, dv=dv, **shape)
    return dq, dk, dv


def _flash_bwd(q, k, v, out, lse, dout, *, pos: Optional[Positions],
               causal: bool, scale: float, window_size=(-1, -1),
               sink_tokens: int = 0, softcap: float = 0.0):
    """fp32 (dq, dk, dv) by the JAX package's dispatch (_flash_bwd_bhsd):
    static self-attention (pos None) runs B5, positions run B2a + B2b.
    delta = rowsum(dout * out) is an fp32 torch pass, as XLA's."""
    dout = dout.contiguous()
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    lse = lse.contiguous()
    shape = dict(scale=scale, causal=causal, window_size=window_size,
                 sink_tokens=sink_tokens, softcap=softcap)
    if pos is None:
        return flash_bwd_fused(q, k, v, dout, lse, delta, **shape)
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, pos=pos, **shape)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, pos=pos, **shape)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The differentiable forward: one torch.library op with its backward
# ---------------------------------------------------------------------------

# kernels of the op's forward (argument ``route``)
_B1, _B4, _B3 = 0, 1, 2


@torch.library.custom_op("lca_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, route: int,
              q_offsets: List[int], kv_offsets: List[int], q_stride: int,
              kv_stride: int, causal: bool, window_left: int, window_right: int,
              sink_tokens: int, softcap: float, scale: float,
              safe_softmax: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of BSHD q, k, v through kernel B1, B4 or B3 (``route``);
    B3 puts q rows and kv columns at the positions of (q_offsets,
    kv_offsets, q_stride, kv_stride)."""
    if route == _B1:
        return flash_fwd_causal_self(q, k, v, scale=scale,
                                     safe_softmax=safe_softmax)
    masks = dict(causal=causal, window_size=(window_left, window_right),
                 sink_tokens=sink_tokens, softcap=softcap, scale=scale,
                 safe_softmax=safe_softmax)
    if route == _B4:
        return flash_fwd_static(q, k, v, **masks)
    return flash_fwd_pos(q, k.transpose(1, 2), v.transpose(1, 2),
                         pos=Positions(tuple(q_offsets), tuple(kv_offsets),
                                       q_stride, kv_stride), **masks)


def _flash_op_setup(ctx, inputs, output) -> None:
    (q, k, v, route, q_off, kv_off, q_stride, kv_stride, causal, left, right,
     sink, softcap, scale, _) = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.pos = (Positions(tuple(q_off), tuple(kv_off), q_stride, kv_stride)
               if route == _B3 else None)
    ctx.shape = dict(causal=causal, scale=scale, window_size=(left, right),
                     sink_tokens=sink, softcap=softcap)


def _flash_op_backward(ctx, dout, dlse):
    del dlse  # the lse cotangent is not propagated (as in flash-attn)
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, pos=ctx.pos,
                            **ctx.shape)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)) + (None,) * 12


_flash_op.register_autograd(_flash_op_backward, setup_context=_flash_op_setup)

# The op a selective-checkpoint policy names to keep the attention forward
# out of the recompute (models/llama.py, remat="attn").
FLASH_ATTENTION_OP = torch.ops.lca_torch.flash_attention.default


# ---------------------------------------------------------------------------
# Public API (the JAX package's names and kwargs)
# ---------------------------------------------------------------------------


# kwargs of the JAX API whose non-default values the port does not take yet
_FEATURE_DEFAULTS = dict(
    q_segment_ids=None, kv_segment_ids=None, dropout_p=0.0, dropout_key=None,
    dropout_seed=None, alibi_slopes=None, kv_lengths=None)


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


def call_positions(s_q: int, s_kv: int, q_offsets=None, kv_offsets=None,
                   q_stride: int = 1, kv_stride: int = 1
                   ) -> Optional[Positions]:
    """The positions of a JAX-API call: None for static self-attention (no
    offsets, unit strides and s_q == s_kv); else the descriptor, an absent
    side at offset 0 and, without offsets, q bottom-right aligned (offset
    s_kv - s_q), as the JAX package's ``flash_attention`` sets them."""
    if q_offsets is None and kv_offsets is None:
        if s_q == s_kv and q_stride == 1 and kv_stride == 1:
            return None
        q_offsets = (s_kv - s_q,)
    q_off = (0,) if q_offsets is None else _offsets(q_offsets, "q_offsets")
    kv_off = (0,) if kv_offsets is None else _offsets(kv_offsets,
                                                      "kv_offsets")
    if s_q % len(q_off) or s_kv % len(kv_off):
        raise ValueError(f"s_q {s_q} and s_kv {s_kv} must divide into "
                         f"{len(q_off)} and {len(kv_off)} position chunks")
    return Positions(q_off, kv_off, int(q_stride), int(kv_stride))


def _pop_positions(s_q: int, s_kv: int, features) -> Optional[Positions]:
    return call_positions(
        s_q, s_kv, features.pop("q_offsets", None),
        features.pop("kv_offsets", None), features.pop("q_stride", 1),
        features.pop("kv_stride", 1))


def flash_attention(q, k, v, *, causal: bool = False,
                    softmax_scale: Optional[float] = None,
                    window_size=(-1, -1), softcap: float = 0.0,
                    sink_tokens: int = 0, q_offsets=None, kv_offsets=None,
                    q_stride: int = 1, kv_stride: int = 1, block_sizes=None,
                    interpret=None, return_lse: bool = False, tri_grid=None,
                    safe_softmax: bool = False, **features):
    """Flash attention, BSHD: q (b, s_q, h, d); k, v (b, s_kv, h_kv, d).

    ``window_size`` (left, right) is a sliding window over global
    positions (-1: unbounded; causal sets right to 0), ``sink_tokens``
    keeps positions below it visible through the left window, ``softcap``
    caps the scores (cap * tanh(s / cap), online softmax). ``q_offsets`` /
    ``kv_offsets`` (the start positions of equal chunks) and ``q_stride`` /
    ``kv_stride`` place the tokens: local index l of a side sits at
    ``offsets[l // chunk] + (l % chunk) * stride`` (the ring layouts).
    Forward by the JAX package's routing: causal self-attention with no
    window, softcap or offsets runs B1 (``tri_grid=False`` sends it to B4
    as in JAX), any other self-attention without offsets B4, offsets,
    strides or s_q != s_kv (bottom-right aligned) B3. Differentiable with
    the same masks and softcap: B5 backward after B1 and B4, B2a + B2b
    after B3. The other feature kwargs (:data:`_FEATURE_DEFAULTS`) raise
    unless left at their defaults. ``block_sizes`` and ``interpret`` are
    accepted for API parity; the Hopper kernels pick their own tiles and
    walk only the live ones."""
    del block_sizes, interpret
    pos = call_positions(q.shape[1], k.shape[1], q_offsets, kv_offsets,
                         q_stride, kv_stride)
    _reject_features("flash_attention (kernel B3 in full)", features)
    left, right, sink = _masks(causal, window_size, sink_tokens, softcap)
    if pos is not None:
        route = _B3
    elif (causal and tuple(window_size) == (-1, -1) and not softcap
          and tri_grid is not False):
        route = _B1
    else:
        route = _B4
    pos = pos or Positions.at(0)
    out, lse = _flash_op(q, k, v, route, list(pos.q_offsets),
                         list(pos.kv_offsets), pos.q_stride, pos.kv_stride,
                         bool(causal),
                         left, right, sink, float(softcap),
                         float(_scale(q, softmax_scale)), bool(safe_softmax))
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = False,
                        softmax_scale: Optional[float] = None,
                        window_size=(-1, -1), softcap: float = 0.0,
                        sink_tokens: int = 0, block_sizes=None,
                        interpret=None, safe_softmax: bool = False,
                        **features):
    """Backward-only entry (the ring backward's per-step call), BSHD in and
    out: fp32 (dq, dk, dv) partials of this kv block, with the forward's
    positions (``q_offsets``, ``kv_offsets``, the strides), window, sinks
    and softcap. Static self-attention runs B5, positions (or s_q != s_kv)
    B2a + B2b. The backward recomputes in fp32 whatever the forward's
    softmax form was."""
    del block_sizes, interpret, safe_softmax
    pos = _pop_positions(q.shape[1], k.shape[1], features)
    _reject_features("flash_attention_bwd (kernels B2/B5 in full)", features)
    return _flash_bwd(q, k, v, out, lse, dout, pos=pos,
                      causal=bool(causal), scale=_scale(q, softmax_scale),
                      window_size=window_size, sink_tokens=sink_tokens,
                      softcap=float(softcap))


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
    path (kernel B3 at the call's positions, bottom-right aligned without
    offsets, with the same window, sinks and softcap; the ring's
    ``kv_quant``), which is forward-only."""
    del return_lse
    shape = dict(causal=causal, window_size=window_size, softcap=softcap,
                 sink_tokens=sink_tokens, safe_softmax=safe_softmax)
    if k_scale is None:
        return flash_attention(q, k, v, softmax_scale=softmax_scale,
                               block_sizes=block_sizes, interpret=interpret,
                               return_lse=True, tri_grid=tri_grid, **shape,
                               **features)
    _forward_only(_QUANT_FORWARD_ONLY, q, k, v)
    pos = _pop_positions(q.shape[1], k.shape[1], features)
    _reject_features("the int8-KV path (kernel B3 in full)", features)
    return flash_fwd_pos(q, k.transpose(1, 2), v.transpose(1, 2),
                         k_scale, v_scale, pos=pos or Positions.at(0),
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
