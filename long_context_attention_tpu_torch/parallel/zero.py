"""ZeRO-style optimizer-state, gradient and parameter sharding over dp.

Counterpart of ``long_context_attention_tpu/parallel/zero.py``, with the
same six functions:

* **ZeRO-1/2** (:func:`make_zero_train_step`): each gradient is summed
  over the sequence axes (ring x ulysses), then reduce-scattered over dp
  along the leaf's shard dimension (moved to the front for the flat
  collective), so each dp rank gets its fully summed 1/dp slice. The torch
  optimizer owns only those slices (:func:`init_zero_opt_state`: its Adam
  moments are 1/dp of each leaf), and the updated slices are all-gathered
  back into the replicated (or tp-sharded) params. Leaves that dp does not
  divide stay whole and are summed over dp.
* **ZeRO-3** (:func:`make_zero3_train_step`): params and optimizer state
  stay dp-sharded at rest (:func:`shard_params_zero3`); the forward
  gathers the top-level leaves once and each layer's weights inside its
  layer body (an autograd function: all-gather forward, reduce-scatter of
  the gradient backward), so under ``remat="full"`` the backward gathers
  the layer again.

The shard dimension of a leaf is JAX's: the largest dimension not already
split by tp / ep / pp whose size dp divides, the first on a tie; ZeRO-3
never picks the stacked layer axis. MoE and pipeline meshes raise, as they
do in JAX (their gradients carry axis-specific sums); ZeRO-3 also raises
on a tp mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from long_context_attention_tpu_torch.models import llama
from long_context_attention_tpu_torch.parallel.collectives import (
    all_gather_dim,
    gather_dim,
    reduce_scatter_dim,
)
from long_context_attention_tpu_torch.parallel.mesh import MeshAxes

__all__ = [
    "zero_param_specs",
    "init_zero_opt_state",
    "make_zero_train_step",
    "zero3_param_specs",
    "shard_params_zero3",
    "make_zero3_train_step",
    "ZeroOptState",
]


def _shape(leaf):
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else \
        tuple(leaf)


def _zero_dim(shape, base_spec, dp: int) -> Optional[int]:
    """The largest dim with no axis in ``base_spec`` and size % dp == 0."""
    entries = tuple(base_spec) + (None,) * (len(shape) - len(base_spec))
    best = None
    for i, (n, e) in enumerate(zip(shape, entries)):
        if e is None and n % dp == 0 and n >= dp:
            if best is None or n > shape[best]:
                best = i
    return best


def _spec_dim(spec, name: str) -> Optional[int]:
    """The dimension a spec gives to axis ``name`` (None: none)."""
    for i, e in enumerate(spec):
        if e == name:
            return i
    return None


def zero_param_specs(params, base_specs, mesh, axes: MeshAxes = None):
    """Per-leaf specs with the dp axis added on the ZeRO shard dimension.

    ``params``: the params (or :func:`~..models.llama.param_shapes`, the
    global shapes); ``base_specs``: a ``param_specs`` tree or ``()``.
    Leaves keep their tp / ep / pp entries and gain ``axes.dp`` on the
    chosen dimension, or stay as they are where no dimension divides."""
    axes = mesh.axes if axes is None else axes
    dp = mesh.dp
    if isinstance(base_specs, tuple):
        base_specs = llama._map(lambda _: base_specs, params)

    def one(leaf, spec):
        shape = _shape(leaf)
        dim = _zero_dim(shape, spec, dp)
        if dim is None:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        entries[dim] = axes.dp
        return tuple(entries)

    return llama._map(one, params, base_specs)


@dataclasses.dataclass
class ZeroOptState:
    """ZeRO-1/2 optimizer state: ``optimizer`` owns ``shards``, one per
    leaf in ``param_leaves`` order, each this dp rank's slice along
    ``dims[i]`` (None: the whole leaf, the param itself)."""

    optimizer: torch.optim.Optimizer
    shards: List[torch.Tensor]
    dims: List[Optional[int]]


def init_zero_opt_state(optimizer: Callable, params, mesh,
                        zspecs) -> ZeroOptState:
    """The optimizer (``optimizer`` is a factory over a list of tensors)
    over this rank's 1/dp slices of ``params`` (full or tp-sharded) per
    ``zspecs`` (:func:`zero_param_specs`): its state never holds a whole
    leaf that dp divides."""
    spec_of = dict(llama.named_leaves(zspecs))
    shards, dims = [], []
    for path, p in llama.named_leaves(params):
        dim = _spec_dim(spec_of[path], mesh.axes.dp)
        dims.append(dim)
        shards.append(p if dim is None else
                      p.detach().chunk(mesh.dp, dim=dim)[mesh.dp_idx].clone())
    return ZeroOptState(optimizer(shards), shards, dims)


def _check_zero(cfg, mesh, what: str, tp_ok: bool) -> None:
    if cfg.moe:
        raise ValueError(f"{what}: an MoE model trains with make_train_step "
                         f"(its experts' gradients are ep-sharded)")
    if mesh.pp > 1:
        raise ValueError(f"{what}: a pp mesh trains with make_pp_train_step")
    if mesh.ep > 1 or (mesh.tp > 1 and not tp_ok):
        raise ValueError(f"{what} composes with dp x ring x ulysses"
                         f"{' x tp' if tp_ok else ''} meshes")


def make_zero_train_step(cfg, mesh, optimizer: Callable,
                         axes: MeshAxes = None, *, device=None):
    """The ZeRO-1/2 train step: ``step(params, opt_state, tokens, labels,
    mask) -> (params, opt_state, loss)``, ``opt_state`` from
    :func:`init_zero_opt_state` (None on the first step builds it), the
    same trajectory as ``make_train_step``'s (the sums are bracketed
    otherwise, so fp32-close, not bit-equal). dp x ring x ulysses x tp
    meshes; ``params`` is the replicated params, or this rank's tp shard
    (``shard_params``), updated IN PLACE."""
    _check_zero(cfg, mesh, "the ZeRO step", tp_ok=True)
    dev = llama.step_device(mesh, device)
    llama._check_mesh_model(cfg, mesh)
    base = llama.param_specs(mesh.axes, tp=mesh.tp > 1)
    zspecs = zero_param_specs(llama.param_shapes(cfg), base, mesh, axes)

    def step(params, opt_state, tokens, labels, mask):
        llama.check_devices(dev, "step",
                            **{"params['embed']": params["embed"]},
                            tokens=tokens, labels=labels, mask=mask)
        leaves = llama.param_leaves(params)
        if opt_state is None:
            opt_state = init_zero_opt_state(optimizer, params, mesh, zspecs)
        for p in leaves:
            p.requires_grad_(True)
        loss = llama.loss_local(params, tokens, labels, mask, cfg, mesh=mesh)
        loss.backward()
        loss = loss.detach()
        if mesh.loss_group is not None:
            dist.all_reduce(loss, group=mesh.loss_group)
        for p, shard, dim in zip(leaves, opt_state.shards, opt_state.dims):
            g = p.grad
            # the sequence-parallel sum, then dp's reduce-scatter
            if mesh.seq_group is not None:
                dist.all_reduce(g, group=mesh.seq_group)
            if dim is None:
                if mesh.dp_group is not None:
                    dist.all_reduce(g, group=mesh.dp_group)
            else:
                shard.grad = reduce_scatter_dim(g, mesh.dp_group, dim)
                p.grad = None
        opt_state.optimizer.step()
        opt_state.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():  # the updated slices back into the params
            for p, shard, dim in zip(leaves, opt_state.shards,
                                     opt_state.dims):
                if dim is not None:
                    p.copy_(all_gather_dim(shard, mesh.dp_group, dim))
        return params, opt_state, loss

    return step


def _zero3_dim(shape, dp: int, skip_dim0: bool) -> Optional[int]:
    """The largest dim that dp divides; ``skip_dim0`` keeps the stacked
    layer axis whole."""
    best = None
    for i, n in enumerate(shape):
        if skip_dim0 and i == 0:
            continue
        if n % dp == 0 and n >= dp:
            if best is None or n > shape[best]:
                best = i
    return best


def zero3_param_specs(params_or_shapes, mesh, axes: MeshAxes = None):
    """Per-leaf dp specs of ZeRO-3's rest layout: every leaf splits its
    largest dimension that dp divides over dp (never the stacked layer
    axis); the leaves dp does not divide stay whole (``()``)."""
    axes = mesh.axes if axes is None else axes
    dp = mesh.dp

    def one_tree(tree, skip_dim0):
        def one(leaf):
            shape = _shape(leaf)
            dim = _zero3_dim(shape, dp, skip_dim0)
            if dim is None:
                return ()
            return tuple(axes.dp if i == dim else None
                         for i in range(len(shape)))
        return llama._map(one, tree)

    p = dict(params_or_shapes)
    layers = p.pop("layers")
    out = one_tree(p, skip_dim0=False)
    out["layers"] = one_tree(layers, skip_dim0=True)
    return {k: out[k] for k in params_or_shapes}


def shard_params_zero3(params, mesh, zspecs):
    """ZeRO-3's rest layout: this dp rank's 1/dp of every leaf that dp
    divides (new tensors), the others whole."""
    return llama.shard_params(params, mesh, zspecs)


def make_zero3_train_step(cfg, mesh, optimizer: Callable,
                          axes: MeshAxes = None, *, device=None):
    """The ZeRO-3 (FSDP) train step: ``params`` is the rest layout
    (:func:`shard_params_zero3`), ``opt_state`` the optimizer over
    ``param_leaves(params)`` (None on the first step builds it), so the
    params and the state live dp-sharded between steps and are updated IN
    PLACE. The forward gathers one layer's weights at a time and the
    backward reduce-scatters each gradient; combine with ``cfg.remat`` for
    the full FSDP memory profile. dp x ring x ulysses meshes; the same
    contract and trajectory as ``make_train_step``."""
    _check_zero(cfg, mesh, "the ZeRO-3 step", tp_ok=False)
    dev = llama.step_device(mesh, device)
    name = mesh.axes.dp if axes is None else axes.dp
    zspecs = zero3_param_specs(llama.param_shapes(cfg), mesh, axes)
    top_dims = {k: _spec_dim(s, name) for k, s in zspecs.items()
                if k != "layers"}
    # inside a layer the stacked axis is gone: its dims shift down by one
    layer_dims = {k: (None if _spec_dim(s, name) is None
                      else _spec_dim(s, name) - 1)
                  for k, s in zspecs["layers"].items()}
    sharded = {k for k, d in top_dims.items() if d is not None} | {
        f"layers/{k}" for k, d in layer_dims.items() if d is not None}
    group = mesh.dp_group

    def layer_gather(lp):
        return {k: (t if layer_dims[k] is None
                    else gather_dim(t, group, layer_dims[k]))
                for k, t in lp.items()}

    def loss_fn(p, tokens, labels, mask):
        full = {k: (v if top_dims[k] is None
                    else gather_dim(v, group, top_dims[k]))
                for k, v in p.items() if k != "layers"}
        full["layers"] = p["layers"]
        return llama.loss_local(full, tokens, labels, mask, cfg, mesh=mesh,
                                layer_gather=layer_gather)

    def step(params, opt_state, tokens, labels, mask):
        llama.check_devices(dev, "step",
                            **{"params['embed']": params["embed"]},
                            tokens=tokens, labels=labels, mask=mask)
        leaves = list(llama.named_leaves(params))
        if opt_state is None:
            opt_state = optimizer([p for _, p in leaves])
        for _, p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, tokens, labels, mask)
        loss.backward()
        loss = loss.detach()
        if mesh.loss_group is not None:
            dist.all_reduce(loss, group=mesh.loss_group)
        for key, p in leaves:
            # the sequence-parallel sum for every leaf; the dp sum of the
            # sharded ones happened in the gather's backward
            if mesh.seq_group is not None:
                dist.all_reduce(p.grad, group=mesh.seq_group)
            if key not in sharded and group is not None:
                dist.all_reduce(p.grad, group=group)
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss

    return step
