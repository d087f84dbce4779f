"""Tensor-parallel helpers: the Megatron f/g conjugate boundary operators.

Counterpart of ``long_context_attention_tpu/parallel/tp.py``. A
column-parallel matmul pair wraps its input in :func:`tp_region_input`
(identity forward, all-reduce backward: Megatron's "f") and reduces its
row-parallel output with :func:`tp_region_output` (all-reduce forward,
identity backward: Megatron's "g"). With both boundaries in place the
activation gradients stay replicated across the tp group, so parameter
gradients need no tp reduction: sharded weights get exactly their shard's
gradient and replicated weights the full gradient on every rank.

Each takes the tp process group where JAX takes the axis name; None is a
group of one (the identity both ways). ``torch.distributed.nn``'s
differentiable all-reduce is not used: its backward is another all-reduce,
which scales a replicated gradient by the group's size (the bug that the
JAX package's ``tp_region_output`` guards against).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["tp_region_input", "tp_region_output", "psum_for_value"]


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _RegionInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _RegionOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def tp_region_input(x: torch.Tensor,
                    group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Identity forward / all-reduce-over-``group`` backward (Megatron's
    "f")."""
    if group is None:
        return x
    return _RegionInput.apply(x, group)


def tp_region_output(x: torch.Tensor,
                     group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """All-reduce-over-``group`` forward / identity backward (Megatron's
    "g"): a value summed over the group whose gradient is not."""
    if group is None:
        return x
    return _RegionOutput.apply(x, group)


psum_for_value = tp_region_output  # reduce a value without scaling its
                                   # gradient by the group's size
