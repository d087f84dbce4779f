"""Expert parallelism: Switch-style MoE MLP with experts sharded over ep.

Counterpart of ``long_context_attention_tpu/parallel/moe.py``:

* a top-1 router over ``n_experts`` global experts; each expert's bucket
  holds up to ``capacity`` tokens, ``max(int(capacity_factor * T / E),
  1)`` of a rank's T tokens, and the tokens past it drop (in token order);
* dispatch and combine move each kept token to its (expert, slot) and
  back. JAX multiplies one-hot matrices; each of those products has one
  nonzero term, so the port copies rows by index and gets the same
  values: ``index_copy`` into the buckets and ``index_select`` out of
  them, whose backwards are the other (a gather's backward through
  advanced indexing sorts its indices, and took a quarter of a training
  step on the H100);
* over an ep group (JAX's ``ep_axis``) the buckets travel to the rank that
  owns their expert by one all-to-all and return by another; the router is
  replicated, the expert weights (n_experts, ...) shard their leading axis
  over ep;
* the expert FFN is two batched products (``torch.bmm``) in
  ``cfg.dtype`` around a tanh GELU (``jax.nn.gelu``'s default form), as
  XLA's einsums are in JAX: no hand-written kernel.

:func:`record_drops` collects each call's routed and dropped tokens and
its router margin.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from long_context_attention_tpu_torch.parallel.collectives import (
    all_to_all_dim0,
    gather_dim,
)
from long_context_attention_tpu_torch.parallel.ulysses import (
    group_rank,
    group_size,
)
from long_context_attention_tpu_torch.utils.config import resolve_device

__all__ = ["MoEConfig", "init_moe_params", "moe_param_specs",
           "moe_mlp_local", "record_drops"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    dim: int
    ffn_hidden: int
    n_experts: int
    capacity_factor: float = 1.25
    dtype: Any = torch.bfloat16


def init_moe_params(generator: torch.Generator, cfg: MoEConfig,
                    device=None) -> Dict[str, torch.Tensor]:
    """He-style init of the router (dim, E) and the stacked expert weights
    (E, dim, ffn) and (E, ffn, dim) in ``cfg.dtype``, drawn from
    ``generator`` and placed on ``device`` (default: the card)."""
    dev = resolve_device(device)

    def dense(fan_in, shape):
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) / (fan_in ** 0.5)
        return w.to(device=dev, dtype=cfg.dtype)

    E = cfg.n_experts
    return {"router": dense(cfg.dim, (cfg.dim, E)),
            "w_up": dense(cfg.dim, (E, cfg.dim, cfg.ffn_hidden)),
            "w_down": dense(cfg.ffn_hidden, (E, cfg.ffn_hidden, cfg.dim))}


def moe_param_specs(ep_axis: Optional[str]):
    """The per-leaf split of :func:`init_moe_params`'s leaves, as the JAX
    package's PartitionSpecs: a tuple of axis names (None: not split) per
    dimension, ``()`` for all replicated."""
    if ep_axis is None:
        return ()
    return {"router": (), "w_up": (ep_axis, None, None),
            "w_down": (ep_axis, None, None)}


_DROPS: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def record_drops():
    """Within the block, every :func:`moe_mlp_local` call appends a dict
    to the list this yields: ``tokens`` (int, the tokens it routed),
    ``dropped`` (the tokens past their expert's capacity), ``margin``
    (the least gap between a token's two largest router logits: how far
    its routing is from a tie) and ``expert`` (each routed token's
    expert, in the order routed), tensors on the tokens' device (no host
    sync)."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


def moe_mlp_local(params: Dict[str, torch.Tensor], x: torch.Tensor,
                  cfg: MoEConfig, *,
                  ep_axis: Optional[dist.ProcessGroup] = None,
                  tokens_replicated: bool = False) -> torch.Tensor:
    """(b, s, dim) -> (b, s, dim) through top-1 routed experts.

    ``ep_axis``: the ep process group (None: this rank holds every
    expert); ``params["w_up"]`` / ``["w_down"]`` are then this rank's
    (n_experts / ep, ...) shard. Two token conventions:

    * ``tokens_replicated=False`` (default): the tokens are whatever this
      rank holds, routed here;
    * ``tokens_replicated=True``: the activations are the same on every ep
      rank; each rank routes its 1/ep of the tokens and the outputs are
      all-gathered back, so every token is routed once (the gather's
      backward sums the gradient's pieces over the ranks)."""
    b, s, dim = x.shape
    E = cfg.n_experts
    ep = group_size(ep_axis)
    if E % ep:
        raise ValueError(f"{E} experts do not divide over {ep} ep ranks")
    e_loc = E // ep
    if tokens_replicated and ep > 1:
        if (b * s) % ep:
            raise ValueError(f"{b * s} tokens do not divide over {ep} ep "
                             f"ranks")
        xf = x.reshape(ep, (b * s) // ep, dim)[group_rank(ep_axis)]
    else:
        xf = x.reshape(b * s, dim)
    T = xf.shape[0]
    cap = max(int(cfg.capacity_factor * T / E), 1)  # JAX's truncation
    logits = (xf @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, -1, expert[:, None])[:, 0]

    # each token's 0-based place in its expert's bucket (a running count
    # over the tokens, per expert); >= cap drops
    counts = torch.cumsum(
        F.one_hot(expert, E).to(torch.int32).t().contiguous(), dim=1)
    slot = counts.gather(0, expert[None]).squeeze(0).long() - 1
    keep = slot < cap
    if _DROPS is not None:
        top = torch.topk(logits.detach(), min(2, E), dim=-1).values
        _DROPS.append({"tokens": T, "dropped": (~keep).sum(),
                       "margin": (top[:, 0] - top[:, -1]).min(),
                       "expert": expert.detach()})
    # dispatch: bucket cell (e, c) takes the token routed there; a dropped
    # token goes to the spare cell E * cap, which is cut off
    cell = torch.where(keep, expert * cap + slot,
                       torch.full_like(expert, E * cap))
    buckets = xf.new_zeros(E * cap + 1, dim).index_copy(0, cell, xf)
    buckets = buckets[:E * cap].reshape(E, cap, dim)

    if ep > 1:
        # (E, cap, d) -> (e_loc, ep * cap, d): this rank's experts' buckets
        # from every source rank, source-major on axis 1
        got = all_to_all_dim0(buckets.reshape(ep, e_loc, cap, dim), ep_axis)
        buckets = got.permute(1, 0, 2, 3).reshape(e_loc, ep * cap, dim)

    h = F.gelu(torch.bmm(buckets.to(cfg.dtype), params["w_up"]).float(),
               approximate="tanh").to(cfg.dtype)
    out_b = torch.bmm(h, params["w_down"])  # (e_loc, ep * cap, d)

    if ep > 1:
        # back to the source ranks: piece j of axis 1 to rank j, the owners'
        # pieces in global expert order
        back = out_b.reshape(e_loc, ep, cap, dim).permute(1, 0, 2, 3)
        out_b = all_to_all_dim0(back, ep_axis).reshape(E, cap, dim)

    flat = torch.cat([out_b.float().reshape(E * cap, dim),
                      out_b.new_zeros(1, dim, dtype=torch.float32)])
    combined = flat.index_select(0, cell) * (gate * keep.float())[:, None]

    if tokens_replicated and ep > 1:
        combined = gather_dim(combined, ep_axis, 0)
    return combined.reshape(b, s, dim).to(x.dtype)
