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
  layouts), with the same masks and softcap, bf16 K/V or int8, fp8 or
  packed int4 K/V (the cache dtypes, widened exactly to bf16 in the
  kernel) with per-token scales, the TPU's ``_fwd_kernel``.
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
versions take any descriptor the JAX package takes.

B3, B2a and B2b also take the JAX kernels' per-call features
(:class:`Features`): segment ids (packed varlen batches; ``kv_lengths`` on
the cache path), ALiBi slopes and the counter-hash attention dropout
(:func:`dropout_keep`), all at global positions, so a ring or USP shard
computes the single-device function. JAX routes any of them to its
position kernels, and so does :func:`flash_attention`: B3 forward, B2a +
B2b backward.
"""

from __future__ import annotations

import math
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from long_context_attention_tpu_torch.ops import _build
from long_context_attention_tpu_torch.ops.kv_cache import _widen
from long_context_attention_tpu_torch.utils.config import NEG_INF, not_ported

__all__ = ["Features", "Positions", "dropout_keep", "dropout_word",
           "expand_positions", "pair_masks", "flash_attention",
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
# softmax forms of the forward kernels' C entry points
_FAST, _ONLINE, _SOFTCAP = 0, 1, 2
# B3's kinds of K/V (csrc/sm90.cuh kKv*): bf16, then the quantized cache
# dtypes' storage (int4 packed two per byte along d, as uint8)
_KV_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2,
             torch.uint8: 3}

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
    kv chunk) pair qc * 2 + kc of four, then the global positions that the
    features read (ALiBi and the dropout hash): each side's chunk offsets
    (a one-chunk side's repeated) and the stride. Raises for what the
    kernels do not take: more than two chunks a side, a multi-chunk side
    not cut in multiples of 128 tokens, or two strides."""
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
    qo, ko = pos.q_offsets, pos.kv_offsets
    return tail + [qo[0], qo[-1], ko[0], ko[-1], st]


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


# ---------------------------------------------------------------------------
# The features: segment ids, ALiBi, the counter-hash dropout
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9  # the hash's golden-ratio constant
_BATCH_MUL = 2654435761  # the dropout salt's batch multiplier


class Features(NamedTuple):
    """A call's features beyond the masks, as the JAX kernels take them:
    segment ids (q (b, s_q) and kv (b, s_kv) int; a pair of unequal ids is
    dropped), ALiBi slopes of the call's q heads ((h,) fp32: -slope *
    |q_pos - kv_pos| is added to each score) and attention dropout with
    probability ``dropout_p`` keyed by ``seed`` = (seed, head base), the
    JAX package's ``dropout_seed``."""

    q_seg: Optional[torch.Tensor] = None
    kv_seg: Optional[torch.Tensor] = None
    slopes: Optional[torch.Tensor] = None
    dropout_p: float = 0.0
    seed: Tuple[int, int] = (0, 0)

    @property
    def any(self) -> bool:
        return (self.q_seg is not None or self.slopes is not None
                or self.dropout_p > 0.0)


def _mul32(x, m: int):
    """x * m mod 2^32 for x in [0, 2^32) (a tensor of int64 or a Python
    int): the product in 16-bit halves of m, so no partial product leaves
    int64."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & _M32


def _hash32(x):
    """lowbias32 (the JAX kernels' ``_hash_u32``) on uint32 values held in
    int64 tensors or Python ints."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _dropout_threshold(dropout_p: float) -> int:
    """The uint32 below which a pair's hash drops it (host double
    arithmetic, as JAX computes it)."""
    return min(int(dropout_p * 4294967296.0), 4294967295)


def dropout_keep(seed: Tuple[int, int], q_pos: torch.Tensor,
                 kv_pos: torch.Tensor, batch: int, heads: int,
                 dropout_p: float) -> torch.Tensor:
    """The keep mask (batch, heads, s_q, s_kv) of the JAX kernels'
    ``_dropout_keep``, bit for bit: per (batch row ib, q head ih) the salt
    ``seed0 + ib * 2654435761 + (head_base + ih) * 0x9E3779B9`` (uint32),
    and for the pair of global positions (row, col) ``h32(col + 0x9E3779B9
    * h32(row + h32(salt))) >= _dropout_threshold(p)``. Every plain version
    and test takes the mask from here."""
    seed0, base = (int(v) for v in seed)
    thresh = _dropout_threshold(dropout_p)
    rows = q_pos.to(torch.int64) & _M32
    cols = kv_pos.to(torch.int64) & _M32
    keep = torch.empty((batch, heads, rows.numel(), cols.numel()),
                       dtype=torch.bool, device=q_pos.device)
    for ib in range(batch):
        for ih in range(heads):
            salt = (seed0 + ib * _BATCH_MUL + (base + ih) * _GOLD) & _M32
            rh = _mul32(_hash32((rows + _hash32(salt)) & _M32), _GOLD)
            bits = _hash32((cols[None, :] + rh[:, None]) & _M32)
            keep[ib, ih] = bits >= thresh
    return keep


def _feature_terms(feat: Optional[Features], q_pos: torch.Tensor,
                   kv_pos: torch.Tensor, b: int, h: int):
    """The plain versions' view of a call's features at these global
    positions: the segments' drop mask (b, 1, s_q, s_kv), the ALiBi bias
    (1, h, s_q, s_kv) fp32 (natural units) and the dropout keep mask (b, h,
    s_q, s_kv), each None when off."""
    if feat is None or not feat.any:
        return None, None, None
    seg = bias = keep = None
    if feat.q_seg is not None:
        seg = (feat.q_seg[:, :, None] != feat.kv_seg[:, None, :])[:, None]
    if feat.slopes is not None:
        dist = (q_pos[:, None] - kv_pos[None, :]).abs().float()
        bias = (-feat.slopes.float())[None, :, None, None] * dist
    if feat.dropout_p > 0.0:
        keep = dropout_keep(feat.seed, q_pos, kv_pos, b, h, feat.dropout_p)
    return seg, bias, keep


def _join_masks(mask: Optional[torch.Tensor], seg: Optional[torch.Tensor]):
    """The position mask (s_q, s_kv) OR the segments' (b, 1, s_q, s_kv)."""
    if seg is None:
        return mask
    return seg if mask is None else seg | mask


def _inv_keep(dropout_p: float) -> float:
    """The kept values' factor 1 / (1 - p), fp32 on every side."""
    return float(np.float32(1.0 / (1.0 - dropout_p)))


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
                  v_scale=None, bias=None, keep=None, inv: float = 1.0):
    """The forward kernels' arithmetic, whole rows at once.

    q (b, s_q, h, d); kf, vf (b, h, s_kv, d) fp32 holding the operand
    dtype's values, repeated to h heads; k_scale / v_scale (b, h, s_kv) or
    None; mask (s_q, s_kv) or (b, 1, s_q, s_kv), True = drop. Fast form: q
    folded by scale*log2e in its dtype, p = exp2(min(s, 90)). Online forms:
    the exact softmax (the kernels' running max gives the same values up to
    rounding), in exp2 units when ``exp2_units`` and natural units
    otherwise; softcap: s = cap * tanh(s * scale / cap) in natural units.
    ``bias`` (the ALiBi term, natural units) joins the score after the
    softcap and before the masks, times log2e in exp2 units. l sums p
    before the dropout (``keep``: p * inv where kept, else 0) and V's scale;
    the PV product takes p (times V's scale) cast to ``vdt``."""
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
    if bias is not None:
        sc.add_(bias * _LOG2E if (units2 or not online) else bias)
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
    if keep is not None:
        p.masked_fill_(~keep, 0.0).mul_(inv)
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


def _check_self(name: str, entry: str, q, k, v) -> _build.Kernel:
    """Check self-attention operands; returns entry point ``entry``'s
    kernel at their head dim (raises on one it has none for)."""
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    if k.shape != (b, s, h_kv, d) or v.shape != k.shape or h % h_kv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not self-attention")
    kern = _build.kernel(entry, d, name)
    for arg, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda_operand(arg, t, torch.bfloat16, q.device)
    return kern


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
    kern = _check_self("B1", "flash_fwd_causal_self", q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    kern(
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
    kern = _check_self("B4", "flash_fwd_static", q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    form = _form(safe_softmax, softcap)
    kern(
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
                        scale: float, safe_softmax: bool = False,
                        features: Optional[Features] = None):
    """Plain version of kernel B3 (same arithmetic, whole rows at once).

    q (b, s_q, h, d); k, v (b, h_kv, s_kv, d), bf16, or int8, fp8 or
    packed int4 (uint8, (b, h_kv, s_kv, d // 2)) with fp32 scales (b, h_kv,
    s_kv), widened exactly to bf16; the masks compare the global positions of
    ``pos`` (any descriptor), or q row i at q_start + i and kv column j at
    j, with sinks at positions below ``sink_tokens``. Fast form:
    s = (q folded) . k * k_scale, p = exp2(min(s, 90)), l = rowsum(p) before
    V's scale, acc = bf16(p * v_scale) @ v. Online form: s = q . k * k_scale
    * scale and the exact softmax in natural units; softcap caps s first.
    ``features``: segments, ALiBi and dropout at the same positions
    (:func:`_attend_plain`)."""
    b, s_q, h = q.shape[:3]
    s_kv = k.shape[2]
    g = h // k.shape[1]
    quant = k_scale is not None
    vdt = torch.bfloat16 if quant else v.dtype
    left, right, sink = _masks(causal, window_size, sink_tokens, softcap)
    pos = _pos(pos, q_start)
    q_pos = pos.q_positions(s_q, q.device)
    kv_pos = pos.kv_positions(s_kv, q.device)
    seg, bias, keep = _feature_terms(features, q_pos, kv_pos, b, h)
    mask = _join_masks(_mask(q_pos, kv_pos, left, right, sink), seg)
    kf, vf = (_widen(t, vdt).float().repeat_interleave(g, dim=1)
              for t in (k, v))
    ks = vs = None
    if quant:
        ks, vs = (t.float().repeat_interleave(g, dim=1)
                  for t in (k_scale, v_scale))
    return _attend_plain(
        q, kf, vf, mask, scale=scale, form=_form(safe_softmax, softcap),
        exp2_units=False, softcap=softcap, vdt=vdt, k_scale=ks, v_scale=vs,
        bias=bias, keep=keep,
        inv=_inv_keep(features.dropout_p) if keep is not None else 1.0)


# the kernels' feature fields, after the descriptor on dims: segments,
# ALiBi, dropout (flags), the seed, its head base, the dropout threshold and
# the kv ids' row stride (csrc/sm90.cuh Feat)
_NO_FEATURE_DIMS = (0,) * 7


def _seg_operand(name: str, ids: torch.Tensor, b: int, s: int, device,
                 pad: int = 1) -> torch.Tensor:
    """Segment ids as the kernels read them: (b, s) int32 rows of a
    multiple of ``pad`` entries (TMA's 16-byte rows for kv ids), in place
    when they already are."""
    if tuple(ids.shape) != (b, s):
        raise ValueError(f"{name} must be (b, s) = {(b, s)}, got "
                         f"{tuple(ids.shape)}")
    if ids.device != device:
        raise ValueError(f"{name} is on {ids.device}, expected {device}")
    if ids.dtype != torch.int32:
        raise ValueError(f"{name} must be int32, got {ids.dtype}")
    width = -(-s // pad) * pad
    if ids.is_contiguous() and width == s and ids.data_ptr() % 16 == 0:
        return ids
    out = torch.zeros((b, width), dtype=torch.int32, device=device)
    out[:, :s] = ids
    return out


def _feature_launch(feat: Optional[Features], b: int, h: int, s_q: int,
                    s_kv: int, device):
    """A kernel launch's features: the dims fields (:data:`_NO_FEATURE_DIMS`
    when off) and the trailing C arguments (q ids, kv ids, slopes, 1 / (1 -
    p))."""
    if feat is None or not feat.any:
        return list(_NO_FEATURE_DIMS), [None, None, None, 1.0]
    qseg = kvseg = slopes = None
    if feat.q_seg is not None:
        qseg = _seg_operand("q_segment_ids", feat.q_seg, b, s_q, device)
        kvseg = _seg_operand("kv_segment_ids", feat.kv_seg, b, s_kv, device,
                             pad=4)
    if feat.slopes is not None:
        slopes = feat.slopes
        if (tuple(slopes.shape) != (h,) or slopes.dtype != torch.float32
                or slopes.device != device or not slopes.is_contiguous()):
            raise ValueError(f"alibi_slopes must be contiguous fp32 ({h},) "
                             f"on {device}")
    drop = feat.dropout_p > 0.0
    dims = [int(qseg is not None), int(slopes is not None), int(drop),
            feat.seed[0] & _M32, feat.seed[1] & _M32,
            _dropout_threshold(feat.dropout_p) if drop else 0,
            kvseg.shape[1] if kvseg is not None else 0]
    inv = _inv_keep(feat.dropout_p) if drop else 1.0
    return dims, [_build.ptr(qseg), _build.ptr(kvseg), _build.ptr(slopes),
                  inv]


def flash_fwd_pos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None, *,
                  q_start: int = 0, pos: Optional[Positions] = None,
                  causal: bool = False, window_size=(-1, -1),
                  sink_tokens: int = 0, softcap: float = 0.0, scale: float,
                  safe_softmax: bool = False,
                  features: Optional[Features] = None):
    """Kernel B3 wrapper: q (b, s_q, h, d) bf16 against k, v (b, h_kv, s_kv,
    d), bf16, or int8, fp8 or packed int4 (uint8, d // 2 bytes a row) with
    fp32 scales (b, h_kv, s_kv). k, v and the scales
    may be strided views (a cache slice); they are read in place. Masks and
    softcap as in :func:`flash_attention`, over the positions of ``pos``
    (or q rows at ``q_start + i``, kv columns at j); each q tile walks, kv
    chunk by kv chunk, the sink tiles and its band only. ``features``
    (segment ids int32 on the card, ALiBi slopes fp32 (h,), dropout) run the
    kernel's featured instantiation at the same positions. Returns out (b,
    s_q, h, d) bf16 and lse (b, h, s_q) fp32. CPU tensors take
    :func:`flash_fwd_pos_plain`."""
    if q.device.type == "cpu":
        return flash_fwd_pos_plain(
            q, k, v, k_scale, v_scale, q_start=q_start, pos=pos,
            causal=causal, window_size=window_size, sink_tokens=sink_tokens,
            softcap=softcap, scale=scale, safe_softmax=safe_softmax,
            features=features)
    left, right, sink = _masks(causal, window_size, sink_tokens, softcap)
    pos = _pos(pos, q_start)
    b, s_q, h, d = q.shape
    _, h_kv, s_kv, _ = k.shape
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("k_scale and v_scale must be passed together")
    kind = _KV_KINDS.get(k.dtype)
    if kind is None or (kind != 0) != quant:
        raise ValueError(f"{k.dtype} K/V {'with' if quant else 'without'} "
                         f"scales: B3 takes bf16 K/V, or int8, fp8 or "
                         f"packed int4 (uint8) K/V with scales")
    dk = d // 2 if k.dtype == torch.uint8 else d
    if k.shape != (b, h_kv, s_kv, dk) or v.shape != k.shape or h % h_kv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    kern = _build.kernel("flash_fwd_pos", d, "B3")
    _check_cuda_operand("q", q, torch.bfloat16, q.device)
    _check_cuda_operand("k", k, k.dtype, q.device)
    _check_cuda_operand("v", v, k.dtype, q.device)
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
    if d != 128 and quant and (desc[0] * desc[1] > 1
                               or (features is not None and features.any)):
        raise NotImplementedError(
            "the B3 kernel takes quantized K/V at two position chunks a "
            "side or with the features (segments, ALiBi, dropout) at "
            f"head_dim 128, got d={d}")
    q0, sink0 = legacy_dims(pos, sink)
    fdims, fargs = _feature_launch(features, b, h, s_q, s_kv, q.device)
    dims = _build.dims_array([
        b, h, h_kv, s_q, s_kv, *q.stride()[:3], *kst, *kst,
        *out.stride()[:3], *sc_strides, q0, left, right, sink0, *desc,
        *fdims, kind])
    kern(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(k_scale),
        _build.ptr(v_scale), _build.ptr(out), _build.ptr(lse), dims,
        scale * _LOG2E, scale, float(softcap), _form(safe_softmax, softcap),
        _build.stream_ptr(q.device), *fargs)
    return out, lse


# ---------------------------------------------------------------------------
# B2a, B2b, B5: the backward (fp32 partials)
# ---------------------------------------------------------------------------


def _p_ds(q, k, v, dout, lse, delta, *, pos: Positions, causal: bool,
          scale: float, window_size=(-1, -1), sink_tokens: int = 0,
          softcap: float = 0.0, features: Optional[Features] = None):
    """p = exp(s - lse) and ds = p * (dp - delta) [* (1 - t^2)] * scale,
    fp32 (b, h, s_q, s_kv), with s = (q . k) * scale from the raw q, capped
    to s = cap * t, t = tanh(s / cap), under a softcap, plus the ALiBi bias;
    p is 0 where the masks (_mask at the positions of ``pos``, and the
    segments) drop a pair and on rows whose lse is -inf; under dropout dp is
    dp * inv where kept, else 0 (the TPU's _recompute_p and _ds_to_dqk).
    Also returns p as dV takes it (dropped: p * inv where kept, else 0)
    and k repeated to h heads, in fp32."""
    b, s_q, h = q.shape[:3]
    s_kv = k.shape[1]
    g = h // k.shape[2]
    left, right, sink = _masks(causal, window_size, sink_tokens, softcap)
    q_pos = pos.q_positions(s_q, q.device)
    kv_pos = pos.kv_positions(s_kv, q.device)
    seg, bias, keep = _feature_terms(features, q_pos, kv_pos, b, h)
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf).mul_(scale)
    t = None
    if softcap > 0:
        t = torch.tanh(s.div_(softcap))
        s = t * softcap
    if bias is not None:
        s.add_(bias)
    lse4 = lse.float()[..., None]
    bad = torch.isneginf(lse4)
    s.sub_(torch.where(bad, torch.zeros_like(lse4), lse4))
    mask = _join_masks(_mask(q_pos, kv_pos, left, right, sink), seg)
    if mask is not None:
        bad = bad | mask
    p = s.exp_().masked_fill_(bad, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), vf)
    p_v = p
    if keep is not None:
        inv = _inv_keep(features.dropout_p)
        dp.masked_fill_(~keep, 0.0).mul_(inv)
        p_v = p.masked_fill(~keep, 0.0).mul_(inv)
    ds = dp.sub_(delta.float()[..., None]).mul_(p)
    if t is not None:
        ds.mul_(t.mul_(t).neg_().add_(1.0))
    return p_v, ds.mul_(scale), kf


def _group_sum(x: torch.Tensor, h_kv: int) -> torch.Tensor:
    """(b, s, h, d) per query head -> (b, s, h_kv, d), summed over each
    kv head's group of query heads."""
    b, s, h, d = x.shape
    return x.reshape(b, s, h_kv, h // h_kv, d).sum(dim=3)


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, *, scale: float,
                       q_start: int = 0, pos: Optional[Positions] = None,
                       causal: bool = True, window_size=(-1, -1),
                       sink_tokens: int = 0, softcap: float = 0.0,
                       features: Optional[Features] = None):
    """Plain version of kernel B2a (same arithmetic and casts, whole rows).

    q, dout (b, s_q, h, d); k, v (b, s_kv, h_kv, d); lse, delta (b, h, s_q)
    fp32; the positions of ``pos`` (any descriptor), or q row i at q_start
    + i and kv column j at j; masks, softcap and ``features`` as in
    :func:`flash_attention`. Returns dq (b, s_q, h, d) fp32 = bf16(ds) @ k
    (ds cast to k's dtype)."""
    _, ds, kf = _p_ds(q, k, v, dout, lse, delta, pos=_pos(pos, q_start),
                      causal=causal, scale=scale, window_size=window_size,
                      sink_tokens=sink_tokens, softcap=softcap,
                      features=features)
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kf)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, *, scale: float,
                        q_start: int = 0, pos: Optional[Positions] = None,
                        causal: bool = True, window_size=(-1, -1),
                        sink_tokens: int = 0, softcap: float = 0.0,
                        features: Optional[Features] = None):
    """Plain version of kernel B2b: dk, dv (b, s_kv, h_kv, d) fp32, summed
    over each kv head's query heads; dv = bf16(p)^T @ dout (p, dropped
    under dropout, cast to dout's dtype), dk = bf16(ds)^T @ q (ds cast to
    q's dtype); positions and features as in :func:`flash_bwd_dq_plain`."""
    p, ds, _ = _p_ds(q, k, v, dout, lse, delta, pos=_pos(pos, q_start),
                     causal=causal, scale=scale, window_size=window_size,
                     sink_tokens=sink_tokens, softcap=softcap,
                     features=features)
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
    p, ds, kf = _p_ds(q, k, v, dout, lse, delta, pos=Positions.at(0),
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
                softcap: float, dq=None, dk=None, dv=None,
                features: Optional[Features] = None):
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
    kern = _build.kernel(kernel, d, "backward")
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
    fdims, fargs = _feature_launch(features, b, h, s_q, s_kv, q.device)
    dims = _build.dims_array([
        b, h, h_kv, s_q, s_kv, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *dout.stride()[:3], *dq_st, *dk_st, q0,
        int(causal), left, right, sink0, *desc, *fdims])
    args = [_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(dout),
            _build.ptr(lse), _build.ptr(delta), _build.ptr(dq),
            _build.ptr(dk), _build.ptr(dv), dims, scale, float(softcap),
            _build.stream_ptr(q.device)]
    if kernel == "flash_bwd_dkv":  # a multi-chunk walk takes the host's order
        order = None
        if desc[0] * desc[1] > 1:
            band = softcap > 0 or left >= 0 or (not causal and right >= 0)
            order = _order_tensor(_dkv_order(tuple(desc[:16]), bool(causal),
                                             band), q.device)
        args.append(_build.ptr(order))
    if kernel != "flash_bwd_fused":  # B5 takes no features
        args += fargs
    kern(*args)


def flash_bwd_dq(q, k, v, dout, lse, delta, *, scale: float,
                 q_start: int = 0, pos: Optional[Positions] = None,
                 causal: bool = True, window_size=(-1, -1),
                 sink_tokens: int = 0, softcap: float = 0.0,
                 features: Optional[Features] = None):
    """Kernel B2a wrapper: dq (b, s_q, h, d) fp32 of bf16 BSHD q, k, v and
    dout (read by strides) with fp32 (b, h, s_q) lse and delta; positions,
    masks, softcap and features as in :func:`flash_fwd_pos`. Persistent
    blocks take 128-row q tiles in the forward's order, each walking, kv
    chunk by kv chunk, the sink tiles and its band (wgmma, TMA), and write
    dq once (no atomics: deterministic). CPU tensors take
    :func:`flash_bwd_dq_plain`."""
    shape = dict(scale=scale, pos=_pos(pos, q_start), causal=causal,
                 window_size=window_size, sink_tokens=sink_tokens,
                 softcap=softcap, features=features)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, **shape)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _bwd_launch("flash_bwd_dq", q, k, v, dout, lse, delta, dq=dq, **shape)
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, *, scale: float,
                  q_start: int = 0, pos: Optional[Positions] = None,
                  causal: bool = True, window_size=(-1, -1),
                  sink_tokens: int = 0, softcap: float = 0.0,
                  features: Optional[Features] = None):
    """Kernel B2b wrapper: dk, dv (b, s_kv, h_kv, d) fp32. Each 128-row kv
    tile walks its group's query heads and, q chunk by q chunk, their q
    tiles over its band: from the causal or right-window diagonal to the
    last row its left window reaches, every row for a tile that holds a
    sink (persistent blocks, TMA, wgmma; a multi-chunk descriptor's kv
    tiles in the host's longest-first order); features as in
    :func:`flash_fwd_pos`. CPU tensors take :func:`flash_bwd_dkv_plain`."""
    shape = dict(scale=scale, pos=_pos(pos, q_start), causal=causal,
                 window_size=window_size, sink_tokens=sink_tokens,
                 softcap=softcap, features=features)
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
               sink_tokens: int = 0, softcap: float = 0.0,
               features: Optional[Features] = None):
    """fp32 (dq, dk, dv) by the JAX package's dispatch (_flash_bwd_bhsd):
    static self-attention (pos None, no features) runs B5, positions or
    features run B2a + B2b. delta = rowsum(dout * out) is an fp32 torch
    pass, as XLA's."""
    dout = dout.contiguous()
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    lse = lse.contiguous()
    shape = dict(scale=scale, causal=causal, window_size=window_size,
                 sink_tokens=sink_tokens, softcap=softcap)
    if features is not None and features.any:
        pos = pos or Positions.at(0)
        shape["features"] = features
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


def _op_features(q_seg, kv_seg, slopes, dropout_p: float, seed: int,
                 head_base: int) -> Optional[Features]:
    """The op's feature arguments as a :class:`Features` (None when off)."""
    feat = Features(q_seg, kv_seg, slopes, float(dropout_p),
                    (int(seed), int(head_base)))
    return feat if feat.any else None


@torch.library.custom_op("lca_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, route: int,
              q_offsets: List[int], kv_offsets: List[int], q_stride: int,
              kv_stride: int, causal: bool, window_left: int, window_right: int,
              sink_tokens: int, softcap: float, scale: float,
              safe_softmax: bool, q_segment_ids: Optional[torch.Tensor],
              kv_segment_ids: Optional[torch.Tensor],
              alibi_slopes: Optional[torch.Tensor], dropout_p: float,
              seed: int, head_base: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of BSHD q, k, v through kernel B1, B4 or B3 (``route``);
    B3 puts q rows and kv columns at the positions of (q_offsets,
    kv_offsets, q_stride, kv_stride) and takes the features (segment ids,
    ALiBi slopes, dropout with its seed and head base)."""
    if route == _B1:
        return flash_fwd_causal_self(q, k, v, scale=scale,
                                     safe_softmax=safe_softmax)
    masks = dict(causal=causal, window_size=(window_left, window_right),
                 sink_tokens=sink_tokens, softcap=softcap, scale=scale,
                 safe_softmax=safe_softmax)
    if route == _B4:
        return flash_fwd_static(q, k, v, **masks)
    return flash_fwd_pos(
        q, k.transpose(1, 2), v.transpose(1, 2),
        pos=Positions(tuple(q_offsets), tuple(kv_offsets), q_stride,
                      kv_stride),
        features=_op_features(q_segment_ids, kv_segment_ids, alibi_slopes,
                              dropout_p, seed, head_base), **masks)


def _flash_op_setup(ctx, inputs, output) -> None:
    (q, k, v, route, q_off, kv_off, q_stride, kv_stride, causal, left, right,
     sink, softcap, scale, _, *features) = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.pos = (Positions(tuple(q_off), tuple(kv_off), q_stride, kv_stride)
               if route == _B3 else None)
    ctx.shape = dict(causal=causal, scale=scale, window_size=(left, right),
                     sink_tokens=sink, softcap=softcap,
                     features=_op_features(*features))


def _flash_op_backward(ctx, dout, dlse):
    del dlse  # the lse cotangent is not propagated (as in flash-attn)
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, pos=ctx.pos,
                            **ctx.shape)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)) + (None,) * 18


_flash_op.register_autograd(_flash_op_backward, setup_context=_flash_op_setup)

# The op a selective-checkpoint policy names to keep the attention forward
# out of the recompute (models/llama.py, remat="attn").
FLASH_ATTENTION_OP = torch.ops.lca_torch.flash_attention.default


# ---------------------------------------------------------------------------
# Public API (the JAX package's names and kwargs)
# ---------------------------------------------------------------------------


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


def dropout_word(dropout_key) -> int:
    """The 32-bit word a dropout key gives, as JAX draws
    ``jax.random.bits(key, (1,), uint32)``: one word drawn from a
    ``torch.Generator``, or an int taken as that word itself. The word is a
    host int the kernels take with their launch, so a CPU generator costs
    no device sync; a CUDA generator's word is read back to the host, one
    sync per call."""
    if isinstance(dropout_key, torch.Generator):
        return int(torch.randint(0, 1 << 32, (1,), generator=dropout_key,
                                 device=dropout_key.device,
                                 dtype=torch.int64))
    return int(dropout_key) & _M32


def _dropout_seed(dropout_p: float, dropout_key, dropout_seed
                  ) -> Tuple[int, int]:
    """(seed, head base), the JAX package's ``_resolve_dropout_seed``:
    ``dropout_seed`` ((2,) ints) as given, else the word of
    ``dropout_key`` and head base 0; (0, 0) without dropout."""
    if dropout_p <= 0.0:
        return 0, 0
    if dropout_seed is not None:
        if isinstance(dropout_seed, torch.Tensor):
            dropout_seed = dropout_seed.tolist()
        vals = np.asarray(dropout_seed).reshape(-1)
        if vals.shape != (2,):
            raise ValueError(f"dropout_seed must be (2,) [seed, head base], "
                             f"got shape {np.shape(dropout_seed)}")
        return int(vals[0]), int(vals[1])
    if dropout_key is None:
        raise ValueError("dropout_p > 0 requires dropout_key (a "
                         "torch.Generator, or its drawn 32-bit word) or "
                         "dropout_seed ((2,) int32)")
    return dropout_word(dropout_key), 0


def _ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, device=device).to(torch.int32).contiguous()


def call_features(q, *, q_segment_ids=None, kv_segment_ids=None,
                  dropout_p: float = 0.0, dropout_key=None,
                  dropout_seed=None, alibi_slopes=None
                  ) -> Optional[Features]:
    """The features of a JAX-API call on q's device (None when off), with
    the JAX package's guards: segment ids on both sides or neither, and 0
    <= dropout_p < 1."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids must be passed "
                         "together")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    q_seg = kv_seg = slopes = None
    if q_segment_ids is not None:
        q_seg, kv_seg = (_ids(t, q.device)
                         for t in (q_segment_ids, kv_segment_ids))
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=q.device).reshape(-1).contiguous()
        if slopes.numel() != q.shape[2]:
            raise ValueError(f"alibi_slopes must hold one slope per q head "
                             f"({q.shape[2]}), got {slopes.numel()}")
    feat = Features(q_seg, kv_seg, slopes, float(dropout_p),
                    _dropout_seed(dropout_p, dropout_key, dropout_seed))
    return feat if feat.any else None


def flash_attention(q, k, v, *, causal: bool = False,
                    softmax_scale: Optional[float] = None,
                    window_size=(-1, -1), softcap: float = 0.0,
                    sink_tokens: int = 0, q_offsets=None, kv_offsets=None,
                    q_stride: int = 1, kv_stride: int = 1,
                    q_segment_ids=None, kv_segment_ids=None,
                    dropout_p: float = 0.0, dropout_key=None,
                    dropout_seed=None, alibi_slopes=None, block_sizes=None,
                    interpret=None, return_lse: bool = False, tri_grid=None,
                    safe_softmax: bool = False):
    """Flash attention, BSHD: q (b, s_q, h, d); k, v (b, s_kv, h_kv, d).

    ``window_size`` (left, right) is a sliding window over global
    positions (-1: unbounded; causal sets right to 0), ``sink_tokens``
    keeps positions below it visible through the left window, ``softcap``
    caps the scores (cap * tanh(s / cap), online softmax). ``q_offsets`` /
    ``kv_offsets`` (the start positions of equal chunks) and ``q_stride`` /
    ``kv_stride`` place the tokens: local index l of a side sits at
    ``offsets[l // chunk] + (l % chunk) * stride`` (the ring layouts).
    ``q_segment_ids`` / ``kv_segment_ids`` ((b, s) ints, passed together):
    packed varlen batches, attention only within equal ids.
    ``alibi_slopes`` ((h,) per q head): -slope * |q_pos - kv_pos| added to
    each score at global positions (not differentiated). ``dropout_p``
    with ``dropout_key`` (a ``torch.Generator``, or the 32-bit word JAX
    would draw) or ``dropout_seed`` ((2,) [seed, global head base]): the
    counter-hash attention dropout (:func:`dropout_keep`), which the
    backward regenerates. Forward by the JAX package's routing: causal
    self-attention with no window, softcap, offsets or feature runs B1
    (``tri_grid=False`` sends it to B4 as in JAX), any other self-attention
    without offsets or features B4, offsets, strides, s_q != s_kv
    (bottom-right aligned) or any feature B3. Differentiable with the same
    masks and features: B5 backward after B1 and B4, B2a + B2b after B3.
    ``block_sizes`` and ``interpret`` are accepted for API parity; the
    Hopper kernels pick their own tiles and walk only the live ones."""
    del block_sizes, interpret
    pos = call_positions(q.shape[1], k.shape[1], q_offsets, kv_offsets,
                         q_stride, kv_stride)
    feat = call_features(q, q_segment_ids=q_segment_ids,
                         kv_segment_ids=kv_segment_ids, dropout_p=dropout_p,
                         dropout_key=dropout_key, dropout_seed=dropout_seed,
                         alibi_slopes=alibi_slopes) or Features()
    left, right, sink = _masks(causal, window_size, sink_tokens, softcap)
    if pos is not None or feat.any:
        route = _B3
    elif (causal and tuple(window_size) == (-1, -1) and not softcap
          and tri_grid is not False):
        route = _B1
    else:
        route = _B4
    pos = pos or Positions.at(0)
    out, lse = _flash_op(q, k, v, route, list(pos.q_offsets),
                         list(pos.kv_offsets), pos.q_stride, pos.kv_stride,
                         bool(causal), left, right, sink, float(softcap),
                         float(_scale(q, softmax_scale)), bool(safe_softmax),
                         feat.q_seg, feat.kv_seg, feat.slopes,
                         feat.dropout_p, *feat.seed)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = False,
                        softmax_scale: Optional[float] = None,
                        window_size=(-1, -1), softcap: float = 0.0,
                        q_offsets=None, kv_offsets=None, q_stride: int = 1,
                        kv_stride: int = 1, q_segment_ids=None,
                        kv_segment_ids=None, dropout_p: float = 0.0,
                        dropout_key=None, dropout_seed=None,
                        alibi_slopes=None, sink_tokens: int = 0,
                        block_sizes=None, interpret=None,
                        safe_softmax: bool = False):
    """Backward-only entry (the ring backward's per-step call), BSHD in and
    out: fp32 (dq, dk, dv) partials of this kv block, with the forward's
    positions (``q_offsets``, ``kv_offsets``, the strides), window, sinks,
    softcap and features (``dropout_seed`` must be the forward's: the
    kernels regenerate its mask from the seed and the positions). Static
    self-attention runs B5, positions, s_q != s_kv or any feature B2a +
    B2b. The backward recomputes in fp32 whatever the forward's softmax
    form was."""
    del block_sizes, interpret, safe_softmax
    pos = call_positions(q.shape[1], k.shape[1], q_offsets, kv_offsets,
                         q_stride, kv_stride)
    feat = call_features(q, q_segment_ids=q_segment_ids,
                         kv_segment_ids=kv_segment_ids, dropout_p=dropout_p,
                         dropout_key=dropout_key, dropout_seed=dropout_seed,
                         alibi_slopes=alibi_slopes)
    return _flash_bwd(q, k, v, out, lse, dout, pos=pos,
                      causal=bool(causal), scale=_scale(q, softmax_scale),
                      window_size=window_size, sink_tokens=sink_tokens,
                      softcap=float(softcap), features=feat)


def flash_attention_fwd(q, k, v, *, k_scale=None, v_scale=None,
                        causal: bool = False,
                        softmax_scale: Optional[float] = None,
                        window_size=(-1, -1), softcap: float = 0.0,
                        sink_tokens: int = 0, q_offsets=None,
                        kv_offsets=None, q_stride: int = 1,
                        kv_stride: int = 1, q_segment_ids=None,
                        kv_segment_ids=None, dropout_p: float = 0.0,
                        dropout_key=None, dropout_seed=None,
                        alibi_slopes=None, safe_softmax: bool = False,
                        block_sizes=None, interpret=None, return_lse=None,
                        tri_grid=None):
    """Forward entry: returns (out, lse), differentiable as
    :func:`flash_attention` is.

    ``k_scale`` / ``v_scale`` ((b, h_kv, s_kv) fp32) switch on the
    quantized-KV path (int8, fp8 or packed int4 k and v, (b, s_kv, h_kv, d
    or d // 2); kernel B3 at the call's positions, bottom-right aligned without
    offsets, with the same window, sinks, softcap and features; the ring's
    ``kv_quant``), which is forward-only."""
    del return_lse
    shape = dict(causal=causal, window_size=window_size, softcap=softcap,
                 sink_tokens=sink_tokens, safe_softmax=safe_softmax)
    feats = dict(q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                 dropout_p=dropout_p, dropout_key=dropout_key,
                 dropout_seed=dropout_seed, alibi_slopes=alibi_slopes)
    if k_scale is None:
        return flash_attention(
            q, k, v, softmax_scale=softmax_scale, q_offsets=q_offsets,
            kv_offsets=kv_offsets, q_stride=q_stride, kv_stride=kv_stride,
            block_sizes=block_sizes, interpret=interpret, return_lse=True,
            tri_grid=tri_grid, **shape, **feats)
    _forward_only(_QUANT_FORWARD_ONLY, q, k, v)
    pos = call_positions(q.shape[1], k.shape[1], q_offsets, kv_offsets,
                         q_stride, kv_stride)
    return flash_fwd_pos(q, k.transpose(1, 2), v.transpose(1, 2),
                         k_scale, v_scale, pos=pos or Positions.at(0),
                         scale=_scale(q, softmax_scale),
                         features=call_features(q, **feats), **shape)


def flash_attention_fwd_cache(q, k_cache, v_cache, *, k_scale=None,
                              v_scale=None, softmax_scale=None,
                              window_size=(-1, -1), softcap=0.0, q_start=0,
                              kv_lengths=None, sink_tokens=0,
                              block_sizes=None, interpret=None,
                              safe_softmax=False, causal=False):
    """Forward-only attention of q (b, s_q, h, d) against a BHSD cache slice
    (b, h_kv, s_kv, d), bf16, or int8, fp8 or packed int4 (d // 2 bytes a
    row) with (b, h_kv, s_kv) fp32 scales: the
    chunked-prefill building block (kernel B3). q rows sit at global
    positions ``q_start + i`` and cache slots at ``j``; ``causal=True``
    masks slots past each row, and ``window_size``, ``sink_tokens`` and
    ``softcap`` apply at those positions (the kernel walks only the sink
    tiles and each q tile's window band). ``kv_lengths`` ((b,) ints): each
    row's filled prefix; slots past it are masked, as segment ids (q ids 1,
    kv ids ``j < kv_lengths[b]``: the JAX package's construction). A row
    that sees no slot gives out 0 and lse -inf. Returns (out, lse),
    mergeable with the chunk's own attention through ``ops.merge``."""
    del block_sizes, interpret
    _forward_only(_QUANT_FORWARD_ONLY, q, k_cache, v_cache)
    feat = None
    if kv_lengths is not None:
        b, s_q = q.shape[:2]
        lengths = _ids(kv_lengths, q.device).reshape(-1)
        if lengths.numel() != b:
            raise ValueError(f"kv_lengths must be ({b},), got "
                             f"{lengths.numel()} entries")
        s_kv = k_cache.shape[2]
        kv_seg = (torch.arange(s_kv, device=q.device)[None, :]
                  < lengths[:, None]).to(torch.int32)
        feat = Features(torch.ones((b, s_q), dtype=torch.int32,
                                   device=q.device), kv_seg)
    return flash_fwd_pos(q, k_cache, v_cache, k_scale, v_scale,
                         q_start=int(q_start), causal=causal,
                         window_size=window_size, sink_tokens=sink_tokens,
                         softcap=softcap, scale=_scale(q, softmax_scale),
                         safe_softmax=safe_softmax, features=feat)
