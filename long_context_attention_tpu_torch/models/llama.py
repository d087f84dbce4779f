"""Llama-style GQA decoder in PyTorch: serving, and training on one device
or over a USP mesh.

Counterpart of ``long_context_attention_tpu/models/llama.py``: the same
config, parameter dict (layers stacked on a leading axis, bf16 weights, fp32
norms), RMSNorm, RoPE over global positions and dense SwiGLU FFN, with

* :func:`forward_local`: the full-sequence forward, differentiable. On one
  device (no ``mesh``) attention goes through ``ModelConfig.attn_impl``:
  "pallas" the autograd ``flash_attention`` (kernels B1 forward, B5
  backward; B4 for a sliding window, sinks or softcap), "sage"
  ``sage_attention_full`` (kernel B8a forward, B8b with a window; the
  straight-through B5 backward), "xla" the fp32 oracle under torch
  autograd. Over a USP ``mesh`` (``parallel/mesh.py``) every layer runs
  ``usp_attention_local`` on this rank's tokens at their global positions
  (``local_positions``), as the JAX model does: the Ulysses all-to-all and
  the ring (kernel B3 per step, B2a + B2b in its backward). Each layer is
  rematerialized per ``ModelConfig.remat``;
* :func:`loss_local` and :func:`make_train_step`: next-token cross entropy
  and one optimizer step, on one device or over a mesh (the loss's
  denominator summed over dp x ring x ulysses, and ep; each gradient over
  the axes its leaf is replicated on);
* tensor parallelism over a mesh's tp axis (Megatron's column-parallel
  wq / wk / wv / w_gate / w_up and row-parallel wo / w_down between the f
  and g operators of ``parallel/tp.py``), the MoE FFN (``n_experts > 0``,
  ``parallel/moe.py``, the experts sharded over the ep axis) and
  :func:`make_pp_train_step` (GPipe over the pp axis,
  ``parallel/pipeline.py``). torch has no globally sharded array:
  :func:`param_specs` gives the JAX package's per-leaf split and
  :func:`shard_params` cuts a full params dict into this rank's shard
  (:func:`gather_params` is its inverse);
* :func:`prefill_chunk_step`: one prompt chunk against the cache so far
  (chunk self-attention, attention over the cache prefix, LSE merge);
* :func:`decode_step`: one token per row against the cache (append, then
  attend), dense or paged;
* :func:`decode_multi_step`: a teacher-forced run of n tokens per row
  against the cache in one multi-token append and attention per layer (the
  prefix cache's suffix prefill and interleaved admission).

The two cache steps run the flash and decode kernels whatever
``attn_impl`` is, as the JAX package's do.

Both cache steps update the cache IN PLACE, and so does a train step its
params. The prefill chunk routes the MoE FFN at the config's capacity, the
decode and multi-token steps at full capacity (no token drops), as in
JAX.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from long_context_attention_tpu_torch.ops.decode import (
    cache_append_rows,
    decode_attention,
)
from long_context_attention_tpu_torch.ops.flash import (
    FLASH_ATTENTION_OP,
    flash_attention,
    flash_attention_fwd,
    flash_attention_fwd_cache,
)
from long_context_attention_tpu_torch.ops.merge import merge_attn_blocks
from long_context_attention_tpu_torch.ops.registry import get_attn_impl
from long_context_attention_tpu_torch.ops.sage import SAGE_ATTENTION_OP
from long_context_attention_tpu_torch.ops.wquant import qdot
from long_context_attention_tpu_torch.parallel.layouts import (
    position_descriptor,
    positions_from_descriptor,
)
from long_context_attention_tpu_torch.parallel.collectives import (
    all_gather_dim,
)
from long_context_attention_tpu_torch.parallel.mesh import (
    MeshAxes,
    mesh_axis,
)
from long_context_attention_tpu_torch.parallel.moe import (
    MoEConfig,
    moe_mlp_local,
)
from long_context_attention_tpu_torch.parallel.pipeline import pipeline_apply
from long_context_attention_tpu_torch.parallel.tp import (
    tp_region_input,
    tp_region_output,
)
from long_context_attention_tpu_torch.parallel.ring import RING_ATTENTION_OP
from long_context_attention_tpu_torch.parallel.usp import usp_attention_local
from long_context_attention_tpu_torch.utils.config import (
    BlockSizes,
    not_ported,
    resolve_device,
)

__all__ = ["ModelConfig", "init_params", "rmsnorm", "rope", "forward_local",
           "local_positions", "loss_local", "make_forward",
           "make_train_step", "make_pp_train_step", "optimizer_step",
           "param_leaves", "named_leaves", "check_devices", "step_device",
           "world_size", "prefill_chunk_step", "decode_step",
           "decode_multi_step", "layer_params", "moe_cfg", "param_specs",
           "param_shapes", "shard_params", "gather_params", "reduce_grads"]

Params = Dict[str, Any]
LAYOUTS = ("basic", "zigzag", "stripe")
REMATS = ("none", "full", "attn", "dots")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Llama-family hyperparameters (defaults: a tiny test model)."""

    vocab: int = 256
    dim: int = 128
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 32
    ffn_hidden: int = 256
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    window_left: int = -1
    softcap: float = 0.0
    sink_tokens: int = 0
    layout: str = "zigzag"
    attn_impl: str = "pallas"
    block_sizes: Optional[BlockSizes] = None
    n_experts: int = 0
    moe_capacity_factor: float = 2.0
    safe_softmax: bool = False
    # activation checkpointing per layer in training: none|full|attn|dots
    # (_maybe_remat); serving ignores it
    remat: str = "none"

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r}; expected one "
                             f"of {LAYOUTS}")
        get_attn_impl(self.attn_impl)  # ValueError naming the impls
        if self.attn_impl == "sage" and self.safe_softmax:
            raise ValueError(
                "safe_softmax is a pallas-kernel knob (the sage kernels are "
                "max-free by construction; the xla oracle computes the "
                "exact softmax either way)")
        if self.attn_impl == "sage" and self.softcap > 0:
            raise NotImplementedError(
                "sage_attention does not implement softcap; use "
                "attn_impl='pallas'")
        if self.n_experts < 0 or self.moe_capacity_factor <= 0:
            raise ValueError(f"n_experts {self.n_experts} and "
                             f"moe_capacity_factor "
                             f"{self.moe_capacity_factor} must be >= 0 "
                             f"and > 0")
        # A field kept for parity with the JAX config whose other values
        # need a slice not ported yet. ``layout`` orders the sequence across
        # a mesh's ring; on one device every layout is the same model.
        if self.block_sizes != _PARITY_DEFAULTS["block_sizes"]:
            raise not_ported(f"per-model kernel tile sizes (block_sizes="
                             f"{self.block_sizes!r})")

    def attention_kwargs(self) -> Dict[str, Any]:
        """The attention-shape kwargs every attention call of the model
        passes, as the JAX model does."""
        return dict(window_size=(self.window_left, -1), softcap=self.softcap,
                    sink_tokens=self.sink_tokens,
                    safe_softmax=self.safe_softmax)

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


_PARITY_DEFAULTS = {f.name: f.default
                    for f in dataclasses.fields(ModelConfig)}


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device=None) -> Params:
    """He-style init, bf16 storage, layers stacked on a leading axis (an
    MoE config's layers hold ``router`` (L, dim, E), ``moe_up`` (L, E,
    dim, ffn) and ``moe_down`` (L, E, ffn, dim) in place of the dense FFN's
    weights, as JAX's).

    Random numbers come from ``generator`` (drawn on the generator's own
    device) and the parameters land on ``device`` (default: the card)."""
    dev = resolve_device(device)

    def leaf(name, shape):
        if name.endswith("norm"):
            return torch.ones(shape, dtype=torch.float32, device=dev)
        fan_in = 1.0 if name == "embed" else shape[-2]
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) / (fan_in ** 0.5)
        return w.to(device=dev, dtype=cfg.dtype)

    # drawn in param_shapes' key order: embed, the layers' matrices, lm_head
    return {k: ({kk: leaf(kk, sh) for kk, sh in v.items()}
                if isinstance(v, dict) else leaf(k, v))
            for k, v in param_shapes(cfg).items()}


def layer_params(params: Params) -> List[Params]:
    """The stacked layer weights (tensors or int8 QTensors) as one dict of
    views per layer, with one ``unbind`` per stacked weight: in training its
    backward stacks the L layer grads once, where L index views would each
    scatter into a full (L, ...) zero tensor."""
    cols = {k: v.unbind() for k, v in params["layers"].items()}
    return [dict(zip(cols, vals)) for vals in zip(*cols.values())]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale * w).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding over global positions. x (b, s, h, d); positions
    (s,) shared or (b, s) per row."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d // 2, dtype=torch.float32,
                                    device=x.device) / (d // 2))
    ang = positions.float()[..., None] * freqs
    if ang.dim() == 2:
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def moe_cfg(cfg: ModelConfig) -> MoEConfig:
    """The ``parallel/moe.py`` config of this model's MoE FFN."""
    return MoEConfig(dim=cfg.dim, ffn_hidden=cfg.ffn_hidden,
                     n_experts=cfg.n_experts,
                     capacity_factor=cfg.moe_capacity_factor,
                     dtype=cfg.dtype)


def _ffn(cfg: ModelConfig, lp: Params, h: torch.Tensor, *,
         ep_axis=None, tokens_replicated: bool = True,
         full_capacity: bool = False) -> torch.Tensor:
    """The post-norm FFN: dense SwiGLU (``qdot`` is ``@`` for bf16 weights
    and w8a8 for int8) or, for an MoE config, the routed experts.

    ``ep_axis``: the ep process group sharding the experts (the tokens are
    the same on its ranks); None: this rank holds every expert.
    ``full_capacity`` raises each expert's capacity to the token count so
    that routing drops nothing (the decode steps, where T is the batch)."""
    if cfg.moe:
        mc = moe_cfg(cfg)
        if full_capacity:
            mc = dataclasses.replace(mc, capacity_factor=float(cfg.n_experts))
        mp = {"router": lp["router"], "w_up": lp["moe_up"],
              "w_down": lp["moe_down"]}
        return moe_mlp_local(mp, h, mc, ep_axis=ep_axis,
                             tokens_replicated=tokens_replicated)
    gate = F.silu(qdot(h, lp["w_gate"]).float()).to(h.dtype)
    return qdot(gate * qdot(h, lp["w_up"]), lp["w_down"])


def _qkv(cfg: ModelConfig, lp: Params, h: torch.Tensor, positions):
    """The rotated q, k and v of this rank's heads (all of them, or its
    1/tp under tensor parallelism)."""
    b, s, _ = h.shape
    q = qdot(h, lp["wq"]).reshape(b, s, -1, cfg.head_dim)
    k = qdot(h, lp["wk"]).reshape(b, s, -1, cfg.head_dim)
    v = qdot(h, lp["wv"]).reshape(b, s, -1, cfg.head_dim)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def local_positions(cfg: ModelConfig, s_local: int, mesh) -> torch.Tensor:
    """Global positions (s_local,) of this rank's tokens: its ring rank's
    layout descriptor expanded, then cut to its ulysses sub-chunk (the
    sequence is sharded (ring, ulysses), ring-major: ``parallel/mesh.py``)."""
    s_ring = s_local * mesh.ulysses
    off, stride = position_descriptor(cfg.layout, mesh.ring_idx, mesh.ring,
                                      s_ring)
    pos = positions_from_descriptor(off, stride, s_ring)
    u = mesh.ulysses_idx
    return pos[u * s_local:(u + 1) * s_local].to(mesh.device)


def _layer(cfg: ModelConfig, positions: torch.Tensor, x: torch.Tensor,
           lp: Params, mesh=None, layer_gather=None):
    """One decoder layer of the full-sequence forward: (x, k, v).

    Over a mesh with a tp axis, this rank's weight shards carry n_heads /
    tp and n_kv_heads / tp heads and ffn / tp columns, with Megatron's f
    and g around the attention and the dense FFN; an ep axis shards the
    MoE FFN's experts. ``layer_gather`` maps the layer's weights before use
    (ZeRO-3's gather of one layer, ``parallel/zero.py``)."""
    if layer_gather is not None:
        lp = layer_gather(lp)
    b, s, _ = x.shape
    tpg = None if mesh is None else mesh.tp_group
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    h = tp_region_input(h, tpg)  # Megatron "f": backward sums over tp
    q, k, v = _qkv(cfg, lp, h, positions)
    if mesh is not None:
        attn = usp_attention_local(
            q, k, v, ulysses_group=mesh.ulysses_group,
            ring_group=mesh.ring_group, layout=cfg.layout, causal=True,
            window_size=(cfg.window_left, -1), softcap=cfg.softcap,
            sink_tokens=cfg.sink_tokens, safe_softmax=cfg.safe_softmax,
            impl=cfg.attn_impl)
    elif cfg.attn_impl == "pallas":
        attn = flash_attention(q, k, v, causal=True, **cfg.attention_kwargs())
    else:  # the fwd-bwd stage of another registry impl
        attn = get_attn_impl(cfg.attn_impl).full(
            q, k, v, causal=True, window_size=(cfg.window_left, -1),
            softcap=cfg.softcap, sink_tokens=cfg.sink_tokens)
    o = attn.reshape(b, s, -1) @ lp["wo"]
    x = x + tp_region_output(o, tpg).to(x.dtype)  # Megatron "g"
    hh = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.moe:
        m = _ffn(cfg, lp, hh, ep_axis=None if mesh is None else mesh.ep_group)
    else:
        m = tp_region_output(_ffn(cfg, lp, tp_region_input(hh, tpg)), tpg)
    x = x + m.to(x.dtype)
    return x, k, v


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


_ATTENTION_OPS = (FLASH_ATTENTION_OP, SAGE_ATTENTION_OP, RING_ATTENTION_OP)


def _save_attention(ctx, op, *args, **kwargs):
    """remat="attn": keep the attention op's (out, lse) -- flash, sage or,
    over a mesh, the whole ring's -- and recompute the rest (the JAX policy
    saves the ring attention's out and lse by name)."""
    return (CheckpointPolicy.MUST_SAVE if op in _ATTENTION_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_dots(ctx, op, *args, **kwargs):
    """remat="dots": keep matmul outputs, recompute elementwise work (JAX's
    checkpoint_dots)."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(body: Callable, cfg: ModelConfig) -> Callable:
    """Wrap a layer body in activation checkpointing per ``cfg.remat``:
    "none" saves every activation for the backward; "full" keeps only the
    layer's input and recomputes the layer in the backward; "attn" is
    "full" plus the attention op's (out, lse), so the backward recomputes
    the projections but not the attention kernel; "dots" keeps the matmul
    outputs. Outside autograd (serving) the body runs as it is."""
    if cfg.remat not in REMATS:
        raise ValueError(f"remat must be none|full|attn|dots, got "
                         f"{cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return body
    kw = {}
    if cfg.remat != "full":
        policy = _save_attention if cfg.remat == "attn" else _save_dots
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return functools.partial(checkpoint, body, use_reentrant=False, **kw)


def forward_local(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  mesh=None, return_kv: bool = False,
                  last_index: Optional[int] = None, layer_gather=None):
    """Forward: tokens (b, s) int -> logits fp32 (b, s, vocab).

    Without ``mesh`` the tokens are one device's whole sequence. With a USP
    ``mesh`` they are this rank's shard (b/dp, s/(R*U)) of the sequence in
    ``cfg.layout`` order, at their global positions (:func:`local_positions`),
    and attention runs over the mesh. Differentiable; serving callers run
    it under ``torch.no_grad()``. ``return_kv=True`` also returns the
    per-layer post-RoPE (k, v), each (n_layers, b, s, h_kv, d).
    ``last_index`` projects only that position through lm_head (logits
    (b, 1, vocab)). A mesh with a tp or ep axis takes this rank's shard of
    the params (:func:`shard_params`); ``layer_gather`` maps each layer's
    weights inside its (rematerialized) body: ZeRO-3's gather, whose
    backward reduce-scatters the layer's gradient, and which a "full" remat
    runs again in the backward."""
    b, s = tokens.shape
    if mesh is None:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    else:
        _check_mesh_model(cfg, mesh)
        positions = local_positions(cfg, s, mesh)
    x = params["embed"][tokens]
    body = _maybe_remat(functools.partial(_layer, cfg, positions, mesh=mesh,
                                          layer_gather=layer_gather), cfg)
    ks, vs = [], []
    for lp in layer_params(params):
        x, k, v = body(x, lp)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if last_index is not None:
        x = x[:, last_index:last_index + 1]
    logits = (x @ params["lm_head"]).float()
    if return_kv:
        return logits, (torch.stack(ks), torch.stack(vs))
    return logits


def loss_local(params: Params, tokens: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor, cfg: ModelConfig, *, mesh=None,
               layer_gather=None) -> torch.Tensor:
    """Masked-mean next-token cross entropy: tokens, labels, mask (b, s);
    labels[i] is the token after tokens[i] in the original order. -sum(log
    p(label) * mask) / max(sum(mask), 1), over fp32 logits.

    With a USP ``mesh`` the arguments are this rank's shards and the result
    is its contribution: the denominator sums over the mesh's dp x ring x
    ulysses ranks, and its ep ranks (which hold the same tokens, so each
    contributes 1/ep), not over tp (whose ranks hold the same logits); the
    numerator stays local, so the contributions (and their gradients)
    sum to the global loss (and its gradient), as JAX's ``loss_local``.
    ``layer_gather``: :func:`forward_local`'s."""
    logits = forward_local(params, tokens, cfg, mesh=mesh,
                           layer_gather=layer_gather)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    maskf = mask.float()
    den = maskf.sum()
    if mesh is not None and mesh.loss_group is not None:
        den = den.detach().clone()
        dist.all_reduce(den, group=mesh.loss_group)
    return -(ll * maskf).sum() / torch.clamp(den, min=1.0)


def world_size(mesh) -> int:
    """The number of ranks of a USP mesh (dp x pp x ep x ring x ulysses x
    tp)."""
    return mesh.n_ranks


def make_forward(cfg: ModelConfig, mesh):
    """The forward over a USP mesh: ``fwd(params, tokens) -> logits`` of
    this rank's token shard (the JAX package's ``make_forward``; torch has
    no globally sharded array). Over a tp or ep mesh ``params`` is this
    rank's :func:`shard_params`; the logits are whole on every tp and ep
    rank."""
    _check_mesh_model(cfg, mesh)
    return functools.partial(_mesh_forward, cfg=cfg, mesh=mesh)


def _mesh_forward(params, tokens, *, cfg, mesh):
    return forward_local(params, tokens, cfg, mesh=mesh)


def _check_mesh_model(cfg: ModelConfig, mesh) -> None:
    """Raise unless the model splits over the mesh's tp axis: the heads,
    the kv heads and the dense FFN's columns divide by the tp degree, and
    an MoE model has no tp axis; the ep degree divides the experts."""
    tp = mesh.tp
    if tp > 1:
        if cfg.moe:
            raise ValueError("the MoE FFN does not compose with tensor "
                             "parallelism (tp > 1)")
        for name in ("n_heads", "n_kv_heads", "ffn_hidden"):
            if getattr(cfg, name) % tp:
                raise ValueError(f"{name}={getattr(cfg, name)} does not "
                                 f"divide by the tp degree {tp}")
    if mesh.ep > 1 and cfg.moe and cfg.n_experts % mesh.ep:
        raise ValueError(f"n_experts={cfg.n_experts} does not divide by the "
                         f"ep degree {mesh.ep}")


def param_specs(axes: MeshAxes = MeshAxes(), tp: bool = False,
                pp: bool = False, ep: bool = False, moe: bool = False):
    """The per-leaf split of the params, the JAX package's PartitionSpecs
    as tuples of axis names (None: that dimension is whole); ``()`` when
    nothing is split.

    Layer weights are stacked (n_layers, ...): pp splits the leading (layer)
    axis into stages; tp splits the last axis of the column-parallel wq /
    wk / wv / w_gate / w_up and the middle one of the row-parallel wo /
    w_down; ep splits the expert axis of moe_up / moe_down; the router, the
    norms, embed and lm_head are whole."""
    if not (tp or pp or moe):
        return ()
    lead = axes.pp if pp else None
    tpa = axes.tp if tp else None
    col, row, norm = (lead, None, tpa), (lead, tpa, None), (lead, None)
    if moe:
        epa = axes.ep if ep else None
        ffn = {"router": (lead, None, None),
               "moe_up": (lead, epa, None, None),
               "moe_down": (lead, epa, None, None)}
    else:
        ffn = {"w_gate": col, "w_up": col, "w_down": row}
    return {"embed": (),
            "layers": {"attn_norm": norm, "wq": col, "wk": col, "wv": col,
                       "wo": row, "mlp_norm": norm, **ffn},
            "final_norm": (), "lm_head": ()}


def param_shapes(cfg: ModelConfig) -> Params:
    """The shape of every leaf :func:`init_params` makes, allocating
    nothing."""
    L, d, F_ = cfg.n_layers, cfg.dim, cfg.ffn_hidden
    layers = {"attn_norm": (L, d), "wq": (L, d, cfg.q_dim),
              "wk": (L, d, cfg.kv_dim), "wv": (L, d, cfg.kv_dim),
              "wo": (L, cfg.q_dim, d), "mlp_norm": (L, d)}
    if cfg.moe:
        E = cfg.n_experts
        layers.update(router=(L, d, E), moe_up=(L, E, d, F_),
                      moe_down=(L, E, F_, d))
    else:
        layers.update(w_gate=(L, d, F_), w_up=(L, d, F_), w_down=(L, F_, d))
    return {"embed": (cfg.vocab, d), "layers": layers,
            "final_norm": (d,), "lm_head": (d, cfg.vocab)}


def _mesh_specs(params: Params, mesh, specs):
    """``specs`` as a per-leaf tree (the mesh's :func:`param_specs` when
    None)."""
    if specs is None:
        specs = param_specs(mesh.axes, mesh.tp > 1, mesh.pp > 1, mesh.ep > 1,
                            moe="router" in params["layers"])
    if isinstance(specs, tuple):
        return _map(lambda _: specs, params)
    return specs


def _map(fn, *trees):
    """``fn`` over the leaves of params-shaped dicts, keeping the keys."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def shard_params(params: Params, mesh, specs=None) -> Params:
    """This rank's shard of a full params dict: each leaf cut along every
    dimension its spec names, to this rank's index on that axis (the
    counterpart of JAX's ``shard_map`` in_specs). ``specs``: a
    :func:`param_specs` tree or ``()`` (default: the mesh's). The shards
    are new contiguous tensors."""
    def cut(x, spec):
        for dim, name in enumerate(spec):
            if name is not None:
                n, i, _ = mesh_axis(mesh, name)
                if x.shape[dim] % n:
                    raise ValueError(f"a leaf of shape {tuple(x.shape)} "
                                     f"does not split {n} ways on dim {dim}")
                x = x.chunk(n, dim=dim)[i]
        return x.detach().clone()

    return _map(cut, params, _mesh_specs(params, mesh, specs))


def gather_params(params: Params, mesh, specs=None) -> Params:
    """Inverse of :func:`shard_params`: every rank's shards gathered into
    the full params dict, on every rank."""
    def join(x, spec):
        for dim, name in enumerate(spec):
            if name is not None:
                x = all_gather_dim(x.detach(), mesh_axis(mesh, name)[2], dim)
        return x.contiguous()

    return _map(join, params, _mesh_specs(params, mesh, specs))


def named_leaves(params: Params, prefix: str = ""):
    """(key path, tensor) of every leaf of a params dict, in its key order
    (:func:`param_leaves`' order), paths joined by "/"."""
    if isinstance(params, dict):
        for k, v in params.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], params


# leaves each ep rank holds only its experts of, whose gradients the MoE
# all-to-all's backward already brought together
_EP_SHARDED = ("layers/moe_up", "layers/moe_down")
# leaves outside the pipeline's stages, used on its first or last stage
_PP_REPLICATED = ("embed", "final_norm", "lm_head")


def reduce_grads(params: Params, mesh) -> None:
    """Sum each leaf's gradient IN PLACE over the mesh axes that leaf is
    replicated on, as JAX's train steps do: every leaf over dp x ring x
    ulysses; over ep all but the experts; over pp embed, final_norm and
    lm_head (the stage-split layers stay per stage); never over tp (the f
    and g operators leave each rank its shard's gradient). On a dp x ring
    x ulysses mesh ``data_group`` is the whole world and there are no ep
    or pp groups, so every leaf is summed over the whole world."""
    leaves = list(named_leaves(params))
    for _, p in leaves:
        if p.grad is None:  # a leaf this rank's graph did not reach
            p.grad = torch.zeros_like(p)
    for name, p in leaves:
        if mesh.data_group is not None:
            dist.all_reduce(p.grad, group=mesh.data_group)
        if mesh.ep_group is not None and name not in _EP_SHARDED:
            dist.all_reduce(p.grad, group=mesh.ep_group)
        if mesh.pp_group is not None and name in _PP_REPLICATED:
            dist.all_reduce(p.grad, group=mesh.pp_group)


def param_leaves(params: Params) -> List[torch.Tensor]:
    """The parameter tensors of a params dict, in its key order (the list
    an optimizer is built over)."""
    return [t for _, t in named_leaves(params)]


def check_devices(dev: torch.device, what: str, **tensors) -> None:
    """Raise unless every tensor lives on ``dev``, where ``what`` runs."""
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, but the {what} runs "
                             f"on {dev}")


def step_device(mesh, device) -> torch.device:
    """Where a step over ``mesh`` runs: the mesh's device (``device``, when
    given, must be it); without a mesh ``device`` (None: the card, raising
    without one)."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


def optimizer_step(params: Params, opt_state, optimizer: Callable,
                   loss_fn: Callable, mesh=None):
    """One step of a train step: ``loss_fn(params)`` and its backward, the
    gradients summed over the mesh (:func:`reduce_grads`) and the loss over
    its ``loss_group`` when it has more than one rank, then ``opt_state``
    (built by ``optimizer`` over :func:`param_leaves` when None) updates
    ``params`` IN PLACE. Returns (params, opt_state, the detached loss)."""
    leaves = param_leaves(params)
    if opt_state is None:
        opt_state = optimizer(leaves)
    owned = {id(p) for grp in opt_state.param_groups for p in grp["params"]}
    if owned != {id(p) for p in leaves}:
        raise ValueError("opt_state does not hold these params: build it "
                         "with optimizer(param_leaves(params))")
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params)
    loss.backward()
    loss = loss.detach()
    if mesh is not None:
        reduce_grads(params, mesh)
        if mesh.loss_group is not None:
            dist.all_reduce(loss, group=mesh.loss_group)
    opt_state.step()
    opt_state.zero_grad(set_to_none=True)
    return params, opt_state, loss


def make_train_step(cfg: ModelConfig, optimizer: Callable, mesh=None, *,
                    device=None):
    """The train step, ``step(params, opt_state, tokens, labels, mask) ->
    (params, opt_state, loss)``, the JAX package's call shape.

    ``optimizer`` is a factory that builds a PyTorch optimizer over a list
    of tensors, e.g. ``functools.partial(torch.optim.AdamW, lr=1e-4,
    weight_decay=1e-4)`` (optax.adamw's decay is 1e-4, torch's default
    1e-2). ``opt_state`` is the optimizer that factory built over
    :func:`param_leaves` of these params, or None on the first step to
    build it. The step updates ``params`` IN PLACE and returns them with
    the optimizer and the detached loss. ``device``: where the step runs
    (None means the card; raises without one); params and batch elsewhere
    raise. A config with a window, sinks or softcap trains through the
    same kernels' masks.

    With a USP ``mesh`` (``make_usp_mesh``: dp x ring x ulysses, and tp
    or ep; every rank calls the step) the batch is this rank's shard,
    ``seq_shard`` of the sequence in ``cfg.layout`` order, labels and mask
    built in the original order before the permutation; the step runs on
    the mesh's device, each rank computes its loss contribution's
    gradients, which are summed over the axes each leaf is replicated on
    (:func:`reduce_grads`: the data-parallel and sequence-parallel
    reduction, and ep's), and every rank applies the same update to its
    replica. Over a tp or ep mesh ``params`` is this rank's
    :func:`shard_params` (the tokens are the same on its tp and ep ranks).
    The loss returned is the global loss."""
    dev = step_device(mesh, device)
    if mesh is not None:
        _check_mesh_model(cfg, mesh)

    def step(params, opt_state, tokens, labels, mask):
        check_devices(dev, "step", **{"params['embed']": params["embed"]},
                      tokens=tokens, labels=labels, mask=mask)
        return optimizer_step(
            params, opt_state, optimizer,
            lambda p: loss_local(p, tokens, labels, mask, cfg, mesh=mesh),
            mesh)

    return step


def make_pp_train_step(cfg: ModelConfig, mesh, optimizer: Callable,
                       n_micro: int, *, device=None):
    """The GPipe train step over a mesh with a pp axis (dp x pp x ring x
    ulysses x tp): ``step(params, opt_state, tokens, labels, mask) ->
    (params, opt_state, loss)``, as :func:`make_train_step`'s.

    ``params`` is this rank's :func:`shard_params` (its stage's n_layers /
    pp layers, its tp shards); the batch is its dp and sequence shard, the
    same on every stage. The local batch splits into ``n_micro``
    microbatches that stream through the stages
    (``parallel/pipeline.py``); stage 0 embeds, the last stage takes the
    final norm, lm_head and the loss's per-microbatch sums. The layer
    gradients stay per stage; embed, final_norm and lm_head are also summed
    over pp. Gradients are exact, so the trajectory is the plain step's.
    Raises unless ``n_layers % pp == 0`` and the local batch divides by
    ``n_micro``; an MoE config raises."""
    dev = step_device(mesh, device)
    if mesh.pp_group is None:
        raise ValueError("the mesh has no pp axis (pp degree > 1)")
    if cfg.moe:
        raise ValueError("MoE with pipeline parallelism is not supported "
                         "(as in the JAX package)")
    if cfg.n_layers % mesh.pp:
        raise ValueError(f"n_layers={cfg.n_layers} does not divide into "
                         f"{mesh.pp} pipeline stages")
    _check_mesh_model(cfg, mesh)

    def loss_fn(p, tokens, labels, mask):
        b, s = tokens.shape
        if b % n_micro:
            raise ValueError(f"the local batch {b} does not divide into "
                             f"{n_micro} microbatches")
        mb = b // n_micro
        tok_mb, lab_mb, msk_mb = (x.reshape(n_micro, mb, s)
                                  for x in (tokens, labels, mask))
        positions = local_positions(cfg, s, mesh)
        body = _maybe_remat(functools.partial(_layer, cfg, positions,
                                              mesh=mesh), cfg)

        def stage_fn(x, layers):
            for lp in layer_params({"layers": layers}):
                x, _, _ = body(x, lp)
            return x

        def inject(t):
            return p["embed"][tok_mb[t]]

        def collect(t, y):
            x = rmsnorm(y, p["final_norm"], cfg.norm_eps)
            logp = torch.log_softmax((x @ p["lm_head"]).float(), dim=-1)
            ll = torch.gather(logp, -1, lab_mb[t][..., None].long())[..., 0]
            mf = msk_mb[t].float()
            return (ll * mf).sum(), mf.sum()

        zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
        nums, dens = pipeline_apply(stage_fn, inject, collect, p["layers"],
                                    n_micro, (zero, zero),
                                    pp_axis=mesh.pp_group)
        den = dens.sum().detach()
        if mesh.data_group is not None:
            dist.all_reduce(den, group=mesh.data_group)
        return -nums.sum() / torch.clamp(den, min=1.0)

    def step(params, opt_state, tokens, labels, mask):
        check_devices(dev, "step", **{"params['embed']": params["embed"]},
                      tokens=tokens, labels=labels, mask=mask)
        return optimizer_step(
            params, opt_state, optimizer,
            lambda p: loss_fn(p, tokens, labels, mask), mesh)

    return step


@torch.no_grad()
def prefill_chunk_step(params: Params, cache, tokens: torch.Tensor,
                       start: int, cfg: ModelConfig, *,
                       last_logit_only: bool = False):
    """Process one prompt chunk against the cache so far (chunked prefill).

    tokens (b, s_c) at global positions [start, start + s_c). The chunk's
    causal self-attention (kernel B1, or B4 under a window or softcap) and
    its attention over the cache prefix (kernel B3 over the cache's bf16,
    int8, fp8 or packed int4 values, the sink tiles and the window band
    only) merge by LSE. The chunk's
    self-attention takes the sinks that lie inside it (global positions
    below ``sink_tokens``), the prefix call the rest. The chunk's K/V are
    written into the cache at [start, ...) and ``cache.length`` is set to
    start + s_c, IN PLACE. Returns (logits (b, s_c or 1, vocab) fp32,
    cache)."""
    b, s_c = tokens.shape
    positions = torch.arange(s_c, dtype=torch.int32,
                             device=tokens.device) + start
    x = params["embed"][tokens]
    scale = cfg.head_dim ** -0.5
    shape = cfg.attention_kwargs()
    # the chunk's own sinks: its local columns below sink_tokens - start
    local = dict(shape, sink_tokens=max(cfg.sink_tokens - start, 0))
    for i, lp in enumerate(layer_params(params)):
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, h, positions)
        out, lse = flash_attention_fwd(q, k, v, causal=True,
                                       softmax_scale=scale, **local)
        if start > 0:
            kcl = cache.k[i, :, :, :start]
            vcl = cache.v[i, :, :, :start]
            kscl = vscl = None
            if cache.k_scale is not None:
                kscl = cache.k_scale[i, :, :, 0, :start]
                vscl = cache.v_scale[i, :, :, 0, :start]
            # causal: the prefix is strictly past the chunk's rows, and the
            # finite right bound gives the kernel its banded walk
            c_out, c_lse = flash_attention_fwd_cache(
                q, kcl, vcl, k_scale=kscl, v_scale=vscl, q_start=start,
                softmax_scale=scale, causal=True, **shape)
            acc, _ = merge_attn_blocks(out.float(), lse, c_out, c_lse)
            out = acc.to(x.dtype)
        cache.write_prompt(i, k, v, start)
        x = x + (out.reshape(b, s_c, cfg.q_dim) @ lp["wo"]).to(x.dtype)
        hh = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(cfg, lp, hh).to(x.dtype)
    cache.length.fill_(start + s_c)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if last_logit_only:
        x = x[:, -1:]
    return (x @ params["lm_head"]).float(), cache


@torch.no_grad()
def decode_step(params: Params, cache, tokens: torch.Tensor,
                cfg: ModelConfig, *, active: Optional[torch.Tensor] = None,
                mesh=None):
    """One single-token decode step against a KVCache or a PagedKVCache (the
    serving hot path): tokens (b,) -> (logits (b, vocab) fp32, cache). Each
    layer appends the new token's K/V (kernel B6) and then attends over the
    cache including it (kernel B7); a paged cache's page table rides both
    kernels. ``cache.length`` advances once at the end. The cache is
    updated IN PLACE. ``active`` (b,) bool marks live rows; inactive rows
    write nothing and do not advance. ``mesh``: the cache is this rank's
    block of a sequence-sharded cache (:func:`decode_multi_step`)."""
    logits, cache = decode_multi_step(params, cache, tokens[:, None], cfg,
                                      active=active, mesh=mesh)
    return logits[:, 0], cache


@torch.no_grad()
def decode_multi_step(params: Params, cache, tokens: torch.Tensor,
                      cfg: ModelConfig, *,
                      active: Optional[torch.Tensor] = None,
                      last_index: Optional[int] = None, mesh=None):
    """Teacher-forced multi-token decode: tokens (b, n) at per-row
    positions cache.length + [0, n) -> (logits (b, n, vocab) fp32, position
    i's logits following token i, and the cache with the n K/V appended and
    ``length`` advanced by n), IN PLACE. Per layer one multi-token append
    (kernel B6) and one multi-token ``decode_attention`` (kernel B7, token
    i seeing slots up to its own position), so position i's math is that of
    :func:`decode_step` for that token. A PagedKVCache works through its
    page table; a one-row view of the engine's pool (the same tensors with
    another table and length) appends into the pool in place.

    ``active``: (b,) bool; inactive rows write nothing and do not advance.
    ``last_index``: project only that run position through lm_head
    (logits (b, 1, vocab)).

    ``mesh`` (a ``make_usp_mesh`` mesh, JAX's ``shard_axes``; every
    sequence rank runs the step alike): the cache is this rank's block of a
    sequence-sharded cache (``serving/sharded.py``): its ``length`` is the
    rows' global length, a dense cache holds s_max / n slots and a paged
    one this rank's pool partition under the global table. Each layer's
    append goes to the owner ranks and its attention merges every rank's
    partial (one all-gather); softcap, window and sinks apply, ALiBi does
    not (as in JAX)."""
    b, n = tokens.shape
    x = params["embed"][tokens]
    pos0 = cache.length
    live = (torch.ones_like(pos0) if active is None
            else active.to(device=pos0.device, dtype=pos0.dtype))
    append_pos = torch.where(live > 0, pos0, torch.full_like(pos0, -n))
    att_len = pos0 + n * live
    positions = pos0[:, None] + torch.arange(n, dtype=pos0.dtype,
                                             device=pos0.device)[None]
    scale = cfg.head_dim ** -0.5
    pt = getattr(cache, "page_table", None)
    shard = None
    if mesh is not None:
        from long_context_attention_tpu_torch.serving.sharded import (
            ShardStep)

        shard = ShardStep(mesh, cache, pos0, n, live, cfg.window_left,
                          cfg.sink_tokens)
    for i, lp in enumerate(layer_params(params)):
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, h, positions)
        if shard is not None:
            shard.append(cache, i, k, v)
            attn = shard.attention(q, cache, i, scale=scale,
                                   softcap=cfg.softcap,
                                   safe_softmax=cfg.safe_softmax)
        else:
            cache_append_rows(cache, i, k, v, append_pos)
            attn = decode_attention(q, cache.k, cache.v, att_len,
                                    cache.k_scale, cache.v_scale,
                                    softmax_scale=scale, layer=i,
                                    page_table=pt, **cfg.attention_kwargs())
        # the kernel's bf16 out meets the model's dtype, as JAX promotes it
        x = x + qdot(attn.reshape(b, n, cfg.q_dim).to(x.dtype),
                     lp["wo"]).to(x.dtype)
        hh = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(cfg, lp, hh, full_capacity=True).to(x.dtype)
    cache.length += n * live
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if last_index is not None:
        x = x[:, last_index:last_index + 1]
    return qdot(x, params["lm_head"]).float(), cache
