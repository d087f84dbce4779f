"""Differentiable collectives along one dimension, over a process group.

The tiled ``lax.all_gather`` / ``lax.psum_scatter`` / ``lax.all_to_all``
of the JAX package's expert-parallel and ZeRO code, each a
``torch.autograd.Function`` whose backward is its transpose: a gather's
is the reduce-scatter (sum) of the gradient, an all-to-all's the inverse
all-to-all. A group of None is one rank: every function is then the
identity.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from long_context_attention_tpu_torch.parallel.ulysses import (
    _a2a,
    group_size,
)

__all__ = ["all_gather_dim", "reduce_scatter_dim", "gather_dim",
           "all_to_all_dim0"]

def all_gather_dim(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                   dim: int) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order
    (JAX's tiled ``all_gather``); no autograd."""
    n = group_size(group)
    if n == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((n * front.shape[0], *front.shape[1:]))
    dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                       dim: int) -> torch.Tensor:
    """The group's sum of ``x``, cut along ``dim`` into group-size pieces:
    this rank's piece (JAX's tiled ``psum_scatter``); no autograd. The
    dimension is moved to the front for the flat collective."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"divide by the group's {n} ranks")
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // n, *front.shape[1:]))
    dist.reduce_scatter_tensor(out, front, group=group)
    return out.movedim(0, dim)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.group, ctx.dim), None, None


def gather_dim(x: torch.Tensor, group: Optional[dist.ProcessGroup],
               dim: int) -> torch.Tensor:
    """:func:`all_gather_dim` whose backward is the reduce-scatter (sum) of
    the gradient along ``dim``: JAX's ``all_gather`` under autodiff."""
    if group_size(group) == 1:
        return x
    return _GatherDim.apply(x, group, dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _a2a(grad, ctx.group), None


def all_to_all_dim0(x: torch.Tensor,
                    group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """All-to-all over dim 0 (group-size blocks, block j to group rank j;
    the received blocks in source-rank order), differentiable: with equal
    blocks the exchange is its own transpose."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group)
