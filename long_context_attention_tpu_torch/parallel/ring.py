"""Ring attention over a process group: K/V rotation with the LSE merge.

Counterpart of ``long_context_attention_tpu/parallel/ring.py``. Every
schedule is one loop: a layout is nothing but the global-position
descriptor of each rank's tokens (``parallel/layouts.py``), which the
position kernels take, so zigzag and stripe need no shape tricks.

* Forward: W steps; at step t this rank attends its q to the K/V of rank
  ``(r - t) % W`` through the registry impl's ``fwd`` (``pallas``: kernel
  B3 at the step's descriptor; ``sage`` with ``kv_quant="int8"``: the
  rotated int8 K/V straight into kernel B8b), and the per-step (out, lse)
  merge in fp32 (``ops/merge.py``). K/V ride W - 1 hops to the next rank.
* Backward, the two-ring backward: the registry's ``bwd`` (B2a + B2b) per
  step on the merged out and lse; dq, dk and dv accumulate in fp32; the
  dk/dv partial sums ride the ring all W hops, so each lands on its K/V's
  owner, and K/V ride W - 1.
* ``bidirectional``: each rank's K/V split in halves that travel opposite
  ways, one two-chunk kv descriptor per step (TokenRing, arXiv:2412.20501).
* ``kv_quant`` ("int8", "float8_e4m3fn" or "int4"): K/V quantized once
  per token at entry and rotated as the quantized bytes with fp32 scales
  (B3's quantized path, int4 packed two per byte: half of int8's bytes;
  B8b for sage, int8 only); the backward's K/V are the dequantized values
  the forward attended to, the gradient straight-through.
* Segment ids (packed varlen batches) rotate with K/V (halves of them in
  the bidirectional ring); ALiBi and dropout read global positions, so
  every step computes its part of the single-device function (the dropout
  pattern included: the kernels' counter hash of the seed and the
  positions). Both need the pallas impl.

Point-to-point transfers go through :class:`RingComm`
(``batch_isend_irecv``); with W = 1 nothing is sent. The whole ring is one
``torch.library`` op, :data:`RING_ATTENTION_OP`, so a selective-checkpoint
policy can keep its (out, lse) out of the recompute (the JAX model's
``ring_attn_out`` / ``ring_attn_lse`` names): ``models/llama.py``
``remat="attn"``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from long_context_attention_tpu_torch.ops.flash import (
    Features,
    call_features,
)
from long_context_attention_tpu_torch.ops.kv_cache import (
    dequantize_kv,
    quantize_kv,
)
from long_context_attention_tpu_torch.ops.merge import merge_attn_blocks
from long_context_attention_tpu_torch.ops.registry import get_attn_impl
from long_context_attention_tpu_torch.parallel.layouts import (
    LAYOUTS,
    bidir_position_descriptor,
    position_descriptor,
)
from long_context_attention_tpu_torch.parallel.ulysses import (
    group_rank,
    group_size,
)

__all__ = ["RingConfig", "RingComm", "ring_attention_local",
           "ring_step_kwargs", "RING_ATTENTION_OP"]


@dataclasses.dataclass(frozen=True)
class RingConfig:
    """Static ring-attention configuration (the JAX package's fields; the
    ring is a process group here, so ``ring_size`` stands for the axis)."""

    ring_size: int
    layout: str = "zigzag"
    causal: bool = False
    softmax_scale: Optional[float] = None
    window: Tuple[int, int] = (-1, -1)
    softcap: float = 0.0
    impl: str = "pallas"
    block_sizes: object = None
    interpret: Optional[bool] = None
    kv_quant: Optional[str] = None
    bidirectional: bool = False
    dropout_p: float = 0.0
    sink: int = 0
    safe_softmax: bool = False

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r}")
        if self.kv_quant is not None and self.impl not in ("pallas",
                                                            "sage"):
            raise ValueError("kv_quant requires the pallas or sage impl")
        if self.impl == "sage" and self.kv_quant not in (None, "int8"):
            raise ValueError(
                "impl='sage' consumes int8 rotated KV directly; fp8 KV has "
                "no int8 tensor-core path -- use kv_quant='int8'")
        if (self.impl == "sage" and self.kv_quant is not None
                and self.bidirectional):
            raise ValueError(
                "ring x sage direct-int8 does not compose with the "
                "bidirectional ring yet")
        if (self.impl == "sage" and self.kv_quant is not None
                and self.softcap != 0.0):
            raise NotImplementedError(
                "ring x sage direct-int8 does not implement softcap")
        if self.dropout_p > 0.0 and self.impl != "pallas":
            raise ValueError("dropout requires the pallas impl")
        if self.safe_softmax and self.impl == "sage":
            raise ValueError(
                "safe_softmax is a pallas-kernel knob (the sage kernels "
                "are max-free by construction; the xla oracle computes "
                "the exact softmax either way)")
        if self.kv_quant not in (None, "int8", "int4", "float8_e4m3fn"):
            raise ValueError(f"not a quantized cache dtype: "
                             f"{self.kv_quant!r}")

    def attn_kwargs(self, q_off, kv_off, q_stride, kv_stride, q_seg=None,
                    kv_seg=None, alibi_sl=None, seed=None):
        """The registry kwargs of one ring step at these descriptors, with
        this rank's q segment ids, those of the K/V held now, the slopes of
        the local heads and the dropout seed (seed, head base)."""
        kw = dict(causal=self.causal, softmax_scale=self.softmax_scale,
                  window_size=self.window, softcap=self.softcap,
                  q_offsets=q_off, kv_offsets=kv_off, q_stride=q_stride,
                  kv_stride=kv_stride)
        if q_seg is not None:
            kw["q_segment_ids"] = q_seg
            kw["kv_segment_ids"] = kv_seg
        if alibi_sl is not None:
            kw["alibi_slopes"] = alibi_sl
        if self.dropout_p > 0.0:
            kw["dropout_p"] = self.dropout_p
            kw["dropout_seed"] = seed
        if self.sink > 0:
            kw["sink_tokens"] = self.sink
        if self.safe_softmax and self.impl == "pallas":
            kw["safe_softmax"] = True
        if self.impl in ("pallas", "sage"):
            kw["block_sizes"] = self.block_sizes
            kw["interpret"] = self.interpret
        return kw


def ring_step_kwargs(cfg: RingConfig, rank: int, step: int, s_q: int,
                     s_kv: int, **features) -> dict:
    """The registry kwargs of ring rank ``rank``'s step ``step``: its q
    descriptor, and that of the K/V it holds then -- rank ``(rank - step) %
    W``'s, or for the bidirectional ring the halves of ranks ``(rank -
    step) % W`` and ``(rank + step) % W`` as one two-chunk descriptor;
    ``features``: :meth:`RingConfig.attn_kwargs`' q_seg, kv_seg (the held
    K/V's), alibi_sl and seed."""
    n = cfg.ring_size
    q_off, q_stride = position_descriptor(cfg.layout, rank, n, s_q)
    if cfg.bidirectional and n > 1:
        kv_off, kv_stride = bidir_position_descriptor(
            cfg.layout, (rank - step) % n, (rank + step) % n, n, s_kv)
    else:
        kv_off, kv_stride = position_descriptor(cfg.layout, (rank - step) % n,
                                                n, s_kv)
    return cfg.attn_kwargs(q_off.tolist(), kv_off.tolist(), q_stride,
                           kv_stride, **features)


class RingComm:
    """The ring's process group and this rank's neighbours (global ranks):
    the reference's ``RingComm`` (``ring/utils.py:118-161``) over
    ``batch_isend_irecv``. A group of None is a ring of one."""

    def __init__(self, group: Optional[dist.ProcessGroup]):
        self.group = group
        self.size = group_size(group)
        self.rank = group_rank(group)
        if self.size > 1:
            self.next = dist.get_global_rank(group, (self.rank + 1) % self.size)
            self.prev = dist.get_global_rank(group, (self.rank - 1) % self.size)

    def exchange(self, forward=(), back=()) -> Tuple[List, List]:
        """Send each of ``forward`` to the next rank and each of ``back`` to
        the previous one, and receive the matching tensors from the other
        side; on a ring of one, the tensors themselves."""
        forward, back = list(forward), list(back)
        if self.size == 1:
            return forward, back
        # fp8 travels as its bytes (a backend need not know the dtype)
        wire = [_wire(t) for t in forward + back]
        got = [torch.empty_like(t) for t in wire]
        nf = len(forward)
        ops = []
        for tag, (t, o) in enumerate(zip(wire, got)):
            to, frm = (self.next, self.prev) if tag < nf else (self.prev,
                                                              self.next)
            ops.append(dist.P2POp(dist.isend, t, to, self.group, tag))
            ops.append(dist.P2POp(dist.irecv, o, frm, self.group, tag))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        got = [g.view(t.dtype) for g, t in zip(got, forward + back)]
        return got[:nf], got[nf:]

    def rotate(self, *tensors):
        """Send each tensor to the next rank, receive the previous rank's."""
        return tuple(self.exchange(forward=tensors)[0])


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A tensor as it is sent: contiguous, fp8 as its uint8 bytes."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _quantize(x: torch.Tensor, dtype: str):
    """Quantized values (b, s, h_kv, d; int4 packed to d // 2) and their
    scales in the kernels' layout (b, h_kv, s)."""
    xq, xs = quantize_kv(x, dtype)
    return xq, xs.transpose(1, 2).contiguous()


def _merge(acc, blk, first: bool):
    """The running fp32 (out, lse) after one more block (the first block
    starts it: merging into the empty state returns the block itself)."""
    if first:
        return blk[0].float(), blk[1]
    return merge_attn_blocks(acc[0], acc[1], blk[0], blk[1])


def _block(cfg: RingConfig, impl, q, cur, kw):
    """One ring step's (out, lse) over the K/V held now: ``cur`` is (k, v)
    or, under ``kv_quant``, (k, v quantized, k scales, v scales)."""
    if len(cur) == 2:
        return impl.fwd(q, cur[0], cur[1], **kw)
    if cfg.impl == "sage":  # ring x sage direct-int8: B8b on the rotated K/V
        from long_context_attention_tpu_torch.ops.sage import (
            sage_attention_fwd_prequant)

        if any(key in kw for key in ("q_segment_ids", "alibi_slopes",
                                     "dropout_p")):
            raise NotImplementedError(
                "ring x sage direct-int8 does not implement segment_ids / "
                "alibi / dropout -- failing loudly instead of silently "
                "dropping them")
        kw = {key: val for key, val in kw.items() if key != "softcap"}
        return sage_attention_fwd_prequant(q, *cur, **kw)
    return impl.fwd(q, cur[0], cur[1], k_scale=cur[2], v_scale=cur[3], **kw)


def _kv_parts(cfg: RingConfig, k, v, seg=None):
    """The K/V a rank sends round the ring: (k, v), or quantized, then the
    kv segment ids when the call has them."""
    if cfg.kv_quant is None:
        parts = [k, v]
    else:
        (kq, ks), (vq, vs) = (_quantize(k, cfg.kv_quant),
                              _quantize(v, cfg.kv_quant))
        parts = [kq, vq, ks, vs]
    return parts if seg is None else parts + [seg]


def _cat(a, b):
    """Two halves' parts joined along the sequence (dim 1; the scales'
    (b, h_kv, s) dim 2)."""
    return [torch.cat([x, y], dim=2 if x.dim() == 3 else 1)
            for x, y in zip(a, b)]


def _split(parts, seg):
    """The held K/V parts and the step's feature kwargs: the kv segment
    ids ride last in ``parts``."""
    if seg is None:
        return parts, {}
    return parts[:-1], dict(q_seg=seg, kv_seg=parts[-1])


def _ring_fwd(cfg: RingConfig, comm: RingComm, q, k, v, seg=None,
              slopes=None, seed=None):
    """(out in q's dtype, lse fp32) of this rank's q over every rank's K/V;
    the bidirectional ring rotates K/V halves (and their segment ids) both
    ways."""
    n, rank = comm.size, comm.rank
    s_q, s_kv = q.shape[1], k.shape[1]
    impl = get_attn_impl(cfg.impl)
    bidir = cfg.bidirectional and n > 1
    if bidir:
        half = s_kv // 2
        part_a = _kv_parts(cfg, k[:, :half], v[:, :half],
                           None if seg is None else seg[:, :half])
        part_b = _kv_parts(cfg, k[:, half:], v[:, half:],
                           None if seg is None else seg[:, half:])
    else:
        cur = _kv_parts(cfg, k, v, seg)
    acc = None
    for step in range(n):
        held, feats = _split(_cat(part_a, part_b) if bidir else cur, seg)
        kw = ring_step_kwargs(cfg, rank, step, s_q, s_kv, alibi_sl=slopes,
                              seed=seed, **feats)
        blk = _block(cfg, impl, q, held, kw)
        acc = _merge(acc, blk, step == 0)
        if step < n - 1:
            if bidir:
                part_a, part_b = comm.exchange(part_a, part_b)
            else:
                cur = list(comm.rotate(*cur))
    return acc[0].to(q.dtype), acc[1]


def _ring_bwd(cfg: RingConfig, comm: RingComm, q, k, v, out, lse, dout,
              seg=None, slopes=None, seed=None):
    """fp32 (dq, dk, dv) of the two-ring backward: per step the impl's
    ``bwd`` on the merged out and lse; dk/dv partial sums ride all W hops
    (home to their K/V's owner), K/V (with their segment ids) W - 1
    (bidirectional: each half its own way)."""
    n, rank = comm.size, comm.rank
    s_q, s_kv = q.shape[1], k.shape[1]
    impl = get_attn_impl(cfg.impl)
    bidir = cfg.bidirectional and n > 1
    half = s_kv // 2

    def held(lo, hi):  # K/V rows [lo, hi), then their segment ids
        ids = [] if seg is None else [seg[:, lo:hi]]
        return [k[:, lo:hi], v[:, lo:hi]] + ids

    kv_a, kv_b, kv = held(0, half), held(half, s_kv), held(0, s_kv)
    dq = dkv = dkv_a = dkv_b = None
    for step in range(n):
        (kc, vc), feats = _split(_cat(kv_a, kv_b) if bidir else kv, seg)
        kw = ring_step_kwargs(cfg, rank, step, s_q, s_kv, alibi_sl=slopes,
                              seed=seed, **feats)
        dq_p, dk_p, dv_p = impl.bwd(q, kc, vc, out, lse, dout, **kw)
        dq = dq_p.float() if dq is None else dq + dq_p
        if bidir:
            pa = [dk_p[:, :half].float(), dv_p[:, :half].float()]
            pb = [dk_p[:, half:].float(), dv_p[:, half:].float()]
            dkv_a = pa if dkv_a is None else [x + y for x, y in zip(dkv_a, pa)]
            dkv_b = pb if dkv_b is None else [x + y for x, y in zip(dkv_b, pb)]
            dkv_a, dkv_b = comm.exchange(dkv_a, dkv_b)
            if step < n - 1:
                kv_a, kv_b = comm.exchange(kv_a, kv_b)
        else:
            part = [dk_p.float(), dv_p.float()]
            dkv = part if dkv is None else [x + y for x, y in zip(dkv, part)]
            dkv = list(comm.rotate(*dkv))
            if step < n - 1:
                kv = list(comm.rotate(*kv))
    if bidir:
        dkv = _cat(dkv_a, dkv_b)
    return dq, dkv[0], dkv[1]


# The ring configs and process groups the op's calls name by handle (a
# torch.library op takes no process group): one entry per (config, group).
_RINGS: Dict[int, Tuple[RingConfig, RingComm]] = {}
_HANDLES: Dict[Tuple[RingConfig, int], int] = {}


def _handle(cfg: RingConfig, group) -> int:
    key = (cfg, id(group))
    h = _HANDLES.get(key)
    if h is None:
        h = _HANDLES[key] = len(_RINGS)
        _RINGS[h] = (cfg, RingComm(group))
    return h


@torch.library.custom_op("lca_torch::ring_attention", mutates_args=())
def _ring_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, handle: int,
             segment_ids: Optional[torch.Tensor],
             alibi_slopes: Optional[torch.Tensor], seed: int, head_base: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of the ring named by ``handle`` over this rank's shards,
    with this rank's segment ids, its heads' ALiBi slopes and the dropout
    seed (seed, head base)."""
    cfg, comm = _RINGS[handle]
    return _ring_fwd(cfg, comm, q, k, v, seg=segment_ids, slopes=alibi_slopes,
                     seed=(seed, head_base))


def _ring_op_setup(ctx, inputs, output) -> None:
    q, k, v, handle, seg, slopes, seed, head_base = inputs
    cfg, _ = _RINGS[handle]
    if cfg.kv_quant is not None:
        # the backward recomputes p = exp(s - lse) from the forward's lse,
        # so it must see the K/V the forward attended to: the dequantized
        # values (the gradient w.r.t. k, v is straight-through)
        k = dequantize_kv(*quantize_kv(k, cfg.kv_quant), k.dtype)
        v = dequantize_kv(*quantize_kv(v, cfg.kv_quant), v.dtype)
    ctx.save_for_backward(q, k, v, *output)
    ctx.handle = handle
    ctx.features = dict(seg=seg, slopes=slopes, seed=(seed, head_base))


def _ring_op_backward(ctx, dout, dlse):
    del dlse  # the lse cotangent is not propagated (as in flash-attn)
    q, k, v, out, lse = ctx.saved_tensors
    cfg, comm = _RINGS[ctx.handle]
    dq, dk, dv = _ring_bwd(cfg, comm, q, k, v, out, lse, dout.contiguous(),
                           **ctx.features)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)) + (None,) * 5


_ring_op.register_autograd(_ring_op_backward, setup_context=_ring_op_setup)

# The op a selective-checkpoint policy names to keep the ring's (out, lse)
# out of the recompute (models/llama.py, remat="attn").
RING_ATTENTION_OP = torch.ops.lca_torch.ring_attention.default


def ring_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: Optional[dist.ProcessGroup] = None,
    ring_size: Optional[int] = None,
    layout: str = "zigzag",
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    impl: str = "pallas",
    segment_ids=None,
    kv_quant: Optional[str] = None,
    bidirectional: bool = False,
    dropout_p: float = 0.0,
    dropout_seed=None,
    alibi_slopes=None,
    sink_tokens: int = 0,
    block_sizes=None,
    interpret: Optional[bool] = None,
    return_lse: bool = False,
    safe_softmax: bool = False,
):
    """Ring attention on this rank's shards.

    q (b, s/W, h, d); k, v (b, s/W, h_kv, d) in ``layout`` order
    (``permute_for_layout`` of the global sequence, then contiguous
    shards); ``group`` is the ring's process group (None: a ring of one).
    ``segment_ids`` ((b, s/W) ints, this rank's tokens), ``alibi_slopes``
    ((h_local,) fp32) and ``dropout_p`` with ``dropout_seed`` ((2,) [seed,
    head base]) reach the kernels at global positions (pallas impl), so the
    ring computes the single-device function. Differentiable (the two-ring
    backward). Returns out (and the fp32 lse (b, h, s/W) with
    ``return_lse``). ``kv_quant`` ("int8", "float8_e4m3fn", "int4")
    rotates quantized K/V (pallas; sage: int8)."""
    n = group_size(group)
    if ring_size is not None and ring_size != n:
        raise ValueError(f"ring_size {ring_size} != the group's size {n}")
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError("dropout_p > 0 requires dropout_seed ((2,) int32)")
    if alibi_slopes is not None and impl != "pallas":
        raise ValueError(
            "ALiBi requires the pallas impl (the xla oracle and sage do not "
            "implement it) -- failing loudly instead of silently dropping it")
    cfg = RingConfig(
        ring_size=n, layout=layout, causal=bool(causal),
        softmax_scale=softmax_scale,
        window=(int(window_size[0]), int(window_size[1])),
        softcap=float(softcap), impl=impl, block_sizes=block_sizes,
        interpret=interpret, kv_quant=kv_quant,
        bidirectional=bool(bidirectional), dropout_p=float(dropout_p),
        sink=int(sink_tokens) if int(window_size[0]) >= 0 else 0,
        safe_softmax=bool(safe_softmax))
    if cfg.bidirectional and n > 1 and k.shape[1] % 2:
        raise ValueError(f"the bidirectional ring splits K/V in halves: "
                         f"s/W {k.shape[1]} is odd")
    feat = call_features(q, q_segment_ids=segment_ids,
                         kv_segment_ids=segment_ids, dropout_p=dropout_p,
                         dropout_seed=dropout_seed,
                         alibi_slopes=alibi_slopes) or Features()
    out, lse = _ring_op(q, k, v, _handle(cfg, group), feat.q_seg,
                        feat.slopes, *feat.seed)
    return (out, lse) if return_lse else out
