"""Ulysses dimension: heads <-> sequence resharding by all-to-all.

Counterpart of ``long_context_attention_tpu/parallel/ulysses.py``. Each
function takes this rank's local (b, s_local, h, d) tensor and the
ulysses process group (None: degree 1, the identity). The element order is
the JAX package's tiled ``lax.all_to_all``: ``scatter_heads`` splits the
heads into U contiguous blocks (rank j gets block j) and concatenates the
sequence chunks in source-rank order; ``gather_heads`` is its inverse. Each
is a ``torch.autograd.Function`` whose backward is the other, as in the
reference's ``SeqAllToAll4D`` (``comm/all_to_all.py:125-134``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["scatter_heads", "PendingScatter", "gather_heads", "gather_seq",
           "ulysses_attention_local", "group_size", "group_rank"]


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    """The degree of an axis: 1 for None."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Optional[dist.ProcessGroup]) -> int:
    """This rank's index along an axis: 0 for None."""
    return 0 if group is None else dist.get_rank(group)


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    """all_to_all over dim 0 (U blocks, block j to rank j)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _scatter_blocks(x: torch.Tensor, u: int) -> torch.Tensor:
    """(b, s, h, d) -> (u, b, s, h/u, d): the head blocks rank j gets."""
    b, s, h, d = x.shape
    if h % u:
        raise ValueError(f"{h} heads do not divide by the ulysses degree {u}")
    return x.reshape(b, s, u, h // u, d).permute(2, 0, 1, 3, 4)


def _scatter_join(got: torch.Tensor, shape, u: int) -> torch.Tensor:
    """The (u source ranks, b, s, h/u, d) received -> (b, u*s, h/u, d)."""
    b, s, h, d = shape
    return got.permute(1, 0, 2, 3, 4).reshape(b, u * s, h // u, d)


def _scatter(x: torch.Tensor, group) -> torch.Tensor:
    u = group_size(group)
    return _scatter_join(_a2a(_scatter_blocks(x, u), group), x.shape, u)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    u = group_size(group)
    b, s, h, d = x.shape
    if s % u:
        raise ValueError(f"sequence {s} does not divide by the ulysses "
                         f"degree {u}")
    blocks = x.reshape(b, u, s // u, h, d).permute(1, 0, 2, 3, 4)
    got = _a2a(blocks, group)  # (u source ranks, b, s/u, h, d)
    return got.permute(1, 2, 0, 3, 4).reshape(b, s // u, u * h, d)


class _ScatterHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.group), None


class _GatherHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _scatter(grad, ctx.group), None


def scatter_heads(x: torch.Tensor,
                  group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """(b, s/U, h, d) -> (b, s, h/U, d): split the heads over the ulysses
    group, gather the sequence (U = 1: the identity)."""
    if group_size(group) == 1:
        return x
    return _ScatterHeads.apply(x, group)


def gather_heads(x: torch.Tensor,
                 group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """(b, s, h/U, d) -> (b, s/U, h, d): the inverse resharding."""
    if group_size(group) == 1:
        return x
    return _GatherHeads.apply(x, group)


class _AllToAllStart(torch.autograd.Function):
    """all_to_all over dim 0 issued with ``async_op=True``: the forward
    returns the receive buffer at once and appends the work to ``works``;
    the backward is the synchronous all-to-all (its own transpose)."""

    @staticmethod
    def forward(ctx, x, group, works):
        ctx.group = group
        out = torch.empty_like(x)
        works.append(dist.all_to_all_single(out, x, group=group,
                                            async_op=True))
        return out

    @staticmethod
    def backward(ctx, grad):
        return _a2a(grad, ctx.group), None, None


class PendingScatter:
    """:func:`scatter_heads` issued asynchronously (``async_op=True``):
    work queued before :meth:`wait` overlaps the all-to-all, and
    :meth:`wait` returns the result; differentiable like
    :func:`scatter_heads` (U = 1: no collective). Holds the send buffer
    until then."""

    def __init__(self, x: torch.Tensor, group: Optional[dist.ProcessGroup]):
        self.group, self.shape, self.u = group, x.shape, group_size(group)
        self.works = []
        if self.u == 1:
            self.got = x
            return
        self.blocks = _scatter_blocks(x, self.u).contiguous()
        self.got = _AllToAllStart.apply(self.blocks, group, self.works)

    def wait(self) -> torch.Tensor:
        if self.u == 1:
            return self.got
        for work in self.works:
            work.wait()
        self.blocks = None
        return _scatter_join(self.got, self.shape, self.u)


def gather_seq(x: torch.Tensor, group: Optional[dist.ProcessGroup],
               dim: int = 1) -> torch.Tensor:
    """The group's chunks of a sequence joined along ``dim`` in rank order,
    the order :func:`scatter_heads` concatenates them in: (b, s/U) segment
    ids -> (b, s) (JAX's tiled ``lax.all_gather`` of the ids, which have no
    head dim to scatter), or any tensor's sequence dim. No gradient."""
    u = group_size(group)
    if u == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(u)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def ulysses_attention_local(q, k, v, attn_fn, *,
                            group: Optional[dist.ProcessGroup]):
    """SP-Ulysses attention on local shards: scatter the heads of q, k and
    v, ``attn_fn(q, k, v) -> out`` over the full sequence with h/U heads,
    gather the heads of the output."""
    q, k, v = (scatter_heads(t, group) for t in (q, k, v))
    return gather_heads(attn_fn(q, k, v), group)
