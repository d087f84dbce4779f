"""Pipeline parallelism: GPipe-style microbatched stage execution.

Counterpart of ``long_context_attention_tpu/parallel/pipeline.py``. A
pipeline stage is another mesh axis: the model's stacked layer weights
(n_layers, ...) are cut along their leading axis over the pp group, so each
rank owns a contiguous stage of layers; activations hop stages by one
non-circular send a tick (stage i to i + 1), and microbatches stream
through the (n_micro + n_stages - 1)-tick schedule. Gradients come from
autograd through the ticks (GPipe: exact gradients, every activation kept).

Every rank runs every tick, the USP collectives inside the stage body
included, so they stay matched across ranks; stage 0's injection and the
last stage's collection are masked with ``torch.where``, as in JAX. The
hop is an autograd function over ``batch_isend_irecv`` (each send matched
by its neighbour's receive in the same tick) whose backward is the reverse
hop; the final sum that hands the last stage's outputs to every stage is
:func:`~long_context_attention_tpu_torch.parallel.tp.psum_for_value`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from long_context_attention_tpu_torch.parallel.tp import psum_for_value
from long_context_attention_tpu_torch.parallel.ulysses import (
    group_rank,
    group_size,
)

__all__ = ["pipeline_apply", "stage_shift"]


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to stage + step and receive the tensor that stage - step
    sends; zeros where no stage sends (the ends of the pipeline)."""
    stage, n = group_rank(group), group_size(group)
    out = torch.zeros_like(x)
    ops = []
    if 0 <= stage + step < n:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, stage + step),
                              group))
    if 0 <= stage - step < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, stage - step),
                              group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _StageShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def stage_shift(x: torch.Tensor,
                group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """JAX's ``ppermute`` with ``[(i, i + 1)]``: stage i's ``x`` lands on
    stage i + 1, stage 0 gets zeros; the backward sends each gradient back
    a stage. A group of None is one stage: zeros."""
    if group_size(group) == 1:
        return torch.zeros_like(x)
    return _StageShift.apply(x, group)


def pipeline_apply(stage_fn: Callable, inject_fn: Callable,
                   collect_fn: Callable, stage_layers, n_micro: int,
                   out_zero, *, pp_axis: Optional[dist.ProcessGroup]):
    """Run the GPipe schedule; returns the last stage's per-microbatch
    outputs, a tuple of tensors each stacked (n_micro, ...), on every pp
    rank.

    ``stage_fn(x_mb, stage_layers) -> y_mb`` runs this rank's stage;
    ``inject_fn(t) -> x_mb`` is stage 0's input for microbatch t;
    ``collect_fn(t, y_mb)`` the last stage's per-microbatch outputs (a
    tuple of tensors shaped like ``out_zero``'s). ``pp_axis``: the pp
    process group (JAX's axis name); None runs one stage."""
    p, n_stages = group_rank(pp_axis), group_size(pp_axis)
    n_ticks = n_micro + n_stages - 1
    first = torch.tensor(p == 0)
    buf = None
    outs = []
    for t in range(n_ticks):
        # stage 0 takes microbatch t (clamped; masked out past n_micro)
        x0 = inject_fn(min(t, n_micro - 1))
        if buf is None:
            buf = torch.zeros_like(x0)
        x_in = torch.where(first.to(x0.device), x0, buf)
        y = stage_fn(x_in, stage_layers)
        # the last stage finished microbatch t - (n_stages - 1)
        out = collect_fn(min(max(t - (n_stages - 1), 0), n_micro - 1), y)
        live = torch.tensor(p == n_stages - 1 and t >= n_stages - 1)
        outs.append(tuple(torch.where(live.to(o.device), o, z)
                          for o, z in zip(out, out_zero)))
        if t + 1 < n_ticks:
            buf = stage_shift(y, pp_axis)
    # the last n_micro ticks are the ones the last stage emitted; every
    # other rank contributed zeros to the sum
    return tuple(psum_for_value(torch.stack(col[n_stages - 1:]), pp_axis)
                 for col in zip(*outs))
