"""Block-sparse attention over the ring schedules.

Counterpart of ``long_context_attention_tpu/parallel/ring_sparse.py``. The
global block mask, the layout and the ring size are static, so every (rank,
ring step) pair's live tiles are known on the host. The JAX package builds
them for every rank and pads them to one length, because ``shard_map``
traces one program; here each rank builds only its own: for step t, its
local q tiles against the local kv tiles of source rank ``(r - t) % W``,
with each tile's liveness read off the global mask at the tiles' global
positions (and, under USP, only its ulysses head block of a per-head
mask). The results are the same.

Forward: one B9a per step, merged with ``ops/merge.py``; K and V rotate
W - 1 hops to the next rank (``batch_isend_irecv``). Backward: one B9b and
one B9c per step on the merged out and lse; dq accumulates locally, the
dk/dv partial sums ride the ring for W hops (landing back on their K/V's
owner) and K/V for W - 1, through the dense ring's ``RingComm``. With W =
1 every rotation is the identity and nothing is sent. The whole op is one
``torch.autograd.Function``.

Layouts ``basic`` and ``zigzag`` (chunk-aligned: each local tile is one
global tile); ``stripe`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from long_context_attention_tpu_torch.ops.merge import merge_attn_blocks
from long_context_attention_tpu_torch.ops.sparse import (
    SparsePlan,
    _host_mask,
    sparse_bwd_dkv,
    sparse_bwd_dq,
    sparse_bwd_operands,
    sparse_fwd,
)
from long_context_attention_tpu_torch.parallel.ring import RingComm

__all__ = ["ring_sparse_attention_local"]


def _rank_tile_firsts(layout: str, r: int, W: int, local_len: int, blk: int):
    """Global first position of each of rank ``r``'s local (size-``blk``)
    tiles, in local order. Requires chunk alignment: every local tile lies
    inside one layout chunk and starts on a ``blk`` boundary globally."""
    if layout == "basic":
        chunks = [(r * local_len, local_len)]
    elif layout == "zigzag":
        half = local_len // 2
        chunks = [(r * half, half), ((2 * W - 1 - r) * half, half)]
    else:
        raise NotImplementedError(
            f"ring-sparse supports layouts 'basic'/'zigzag', not {layout!r} "
            "(stripe interleaves tokens below tile granularity)")
    firsts = []
    for g0, ln in chunks:
        if ln % blk or g0 % blk:
            raise ValueError(
                f"layout chunk (start {g0}, len {ln}) not aligned to the "
                f"sparse block size {blk}; shrink block_q/block_kv")
        firsts.extend(g0 + t * blk for t in range(ln // blk))
    return np.asarray(firsts, np.int64)


@functools.lru_cache(maxsize=None)
def _ring_step_plans(mask_key: bytes, mask_shape, causal: bool, W: int,
                     r: int, layout: str, s_local_q: int, s_local_kv: int,
                     bq: int, bkv: int, g: int, uly_idx: int = 0,
                     n_hs: int = 1) -> Tuple[SparsePlan, ...]:
    """Ring rank ``r``'s plan for each step t (kv from rank (r - t) % W):
    the global mask read at its local tiles' global positions, causal tiles
    classified against those positions; a 3-D mask's head axis restricted
    to ulysses shard ``uly_idx`` of ``n_hs`` (its contiguous head block)."""
    mask = np.frombuffer(mask_key, dtype=np.bool_).reshape(mask_shape)
    per_head = mask.ndim == 3
    mh = mask if per_head else mask[None]
    h_loc = mh.shape[0] // n_hs
    mh = mh[uly_idx * h_loc:(uly_idx + 1) * h_loc]
    qf = _rank_tile_firsts(layout, r, W, s_local_q, bq)
    plans = []
    for t in range(W):
        kf = _rank_tile_firsts(layout, (r - t) % W, W, s_local_kv, bkv)
        sub = mh[:, qf[:, None] // bq, kf[None, :] // bkv]
        if causal:
            reach = kf[None, :] <= qf[:, None] + bq - 1
            straddle = reach & (kf[None, :] + bkv - 1 > qf[:, None])
            sub = sub & reach[None]
        else:
            straddle = np.zeros(sub.shape[1:], dtype=bool)
        plans.append(SparsePlan(mh=sub, straddle=straddle, q_first=qf,
                                kv_first=kf, per_head=per_head, g=g, bq=bq,
                                bkv=bkv))
    return tuple(plans)


def _ring_fwd(q, k, v, plans, scale, ring: RingComm):
    k_cur, v_cur = k, v
    for t, plan in enumerate(plans):
        out_t, lse_t = sparse_fwd(q, k_cur, v_cur, plan, scale=scale)
        # step 0 starts the accumulator: a merge with the empty state
        # (out 0, lse -inf) would return it unchanged
        if t == 0:
            acc_out, acc_lse = out_t, lse_t
        else:
            acc_out, acc_lse = merge_attn_blocks(acc_out, acc_lse, out_t,
                                                 lse_t)
        if t < ring.size - 1:
            k_cur, v_cur = ring.rotate(k_cur, v_cur)
    return acc_out.to(q.dtype), acc_lse


class _RingSparseAttention(torch.autograd.Function):
    """(out, lse) of the sparse ring; its backward does its own ring
    communication. No gradient flows through the lse output."""

    @staticmethod
    def forward(ctx, q, k, v, plans, scale, ring):
        out, lse = _ring_fwd(q, k, v, plans, scale, ring)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.plans, ctx.scale, ctx.ring = plans, scale, ring
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        ring = ctx.ring
        ops = sparse_bwd_operands(out, lse, dout, q.dtype)
        k_cur, v_cur = k, v
        for t, plan in enumerate(ctx.plans):
            dq_t = sparse_bwd_dq(q, k_cur, v_cur, *ops, plan, scale=ctx.scale)
            dk_t, dv_t = sparse_bwd_dkv(q, k_cur, v_cur, *ops, plan,
                                        scale=ctx.scale)
            if t == 0:  # the fp32 partial sums start at step 0's
                dq, dk, dv = dq_t, dk_t, dv_t
            else:
                dq += dq_t
                dk += dk_t
                dv += dv_t
            # dk/dv ride the ring every step (W hops) so each partial sum
            # lands back on its K/V's owner; K/V skip the final hop
            dk, dv = ring.rotate(dk, dv)
            if t < ring.size - 1:
                k_cur, v_cur = ring.rotate(k_cur, v_cur)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_sparse_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_mask,
    *,
    group: Optional[dist.ProcessGroup] = None,
    layout: str = "zigzag",
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    block_q: int = 512,
    block_kv: int = 512,
    interpret: Optional[bool] = None,
    return_lse: bool = False,
    head_shard=None,
):
    """Ring attention over a static global block mask, on this rank's
    shards.

    q (b, s/W, h, d); k, v (b, s/W, h_kv, d) in layout order (basic or
    zigzag); ``group`` is the ring's process group (None: a ring of one).
    ``block_mask`` is the (S/block_q, S/block_kv) tile mask of the global
    sequence, or per head (h_global, ., .); ``causal=True`` intersects it
    with the causal triangle at global positions. Under USP,
    ``head_shard=(ulysses_index, n_ulysses)`` restricts a 3-D mask to this
    rank's contiguous head block. Differentiable (sparse ring backward).
    ``interpret`` is accepted for API parity."""
    del interpret
    ring = RingComm(group)
    W = ring.size
    b, s_q, h, d = q.shape
    s_kv, h_kv = k.shape[1], k.shape[2]
    mask = _host_mask(block_mask)
    if mask.ndim not in (2, 3):
        raise ValueError(
            "block_mask must be (n_q, n_kv) or per-head (h, n_q, n_kv)")
    uly_idx, n_hs = 0, 1
    if mask.ndim == 3 and head_shard is not None:
        uly_idx, n_hs = (int(x) for x in head_shard)
    blk_q = min(block_q, s_q)
    blk_kv = min(block_kv, s_kv)
    want = ((s_q * W) // blk_q, (s_kv * W) // blk_kv)
    if mask.ndim == 3:
        want = (h * n_hs,) + want  # global heads (local heads x uly shards)
    if mask.shape != want:
        raise ValueError(
            f"global block_mask shape {mask.shape} != {want} for global "
            f"seq {s_q * W} at block ({blk_q}, {blk_kv})")
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / float(np.sqrt(d)))
    plans = _ring_step_plans(mask.tobytes(), mask.shape, bool(causal), W,
                             ring.rank, layout, s_q, s_kv, blk_q, blk_kv,
                             h // h_kv, uly_idx, n_hs)
    out, lse = _RingSparseAttention.apply(q, k, v, plans, float(scale), ring)
    return (out, lse) if return_lse else out
