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
  denominator and the gradients summed over dp x ring x ulysses);
* :func:`prefill_chunk_step`: one prompt chunk against the cache so far
  (chunk self-attention, attention over the cache prefix, LSE merge);
* :func:`decode_step`: one token per row against the cache (append, then
  attend).

The two cache steps run the flash and decode kernels whatever
``attn_impl`` is, as the JAX package's do.

Both cache steps update the cache IN PLACE, and so does a train step its
params. MoE, tensor and pipeline parallelism, and serving over a mesh,
come in later slices.
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
    cache_append,
    decode_attention,
)
from long_context_attention_tpu_torch.ops.flash import (
    FLASH_ATTENTION_OP,
    flash_attention,
    flash_attention_fwd,
    flash_attention_fwd_cache,
)
from long_context_attention_tpu_torch.ops.kv_cache import quantize_kv
from long_context_attention_tpu_torch.ops.merge import merge_attn_blocks
from long_context_attention_tpu_torch.ops.registry import get_attn_impl
from long_context_attention_tpu_torch.ops.sage import SAGE_ATTENTION_OP
from long_context_attention_tpu_torch.ops.wquant import qdot
from long_context_attention_tpu_torch.parallel.layouts import (
    position_descriptor,
    positions_from_descriptor,
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
           "make_train_step", "param_leaves",
           "prefill_chunk_step", "decode_step", "layer_params"]

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
        # Fields kept for parity with the JAX config whose other values
        # need a slice not ported yet. ``layout`` orders the sequence across
        # a mesh's ring; on one device every layout is the same model.
        for name, what in (("block_sizes", "per-model kernel tile sizes"),
                           ("n_experts", "MoE layers"),
                           ("moe_capacity_factor", "MoE layers")):
            if getattr(self, name) != _PARITY_DEFAULTS[name]:
                raise not_ported(f"{what} ({name}={getattr(self, name)!r})")

    def attention_kwargs(self) -> Dict[str, Any]:
        """The attention-shape kwargs every attention call of the model
        passes, as the JAX model does."""
        return dict(window_size=(self.window_left, -1), softcap=self.softcap,
                    sink_tokens=self.sink_tokens,
                    safe_softmax=self.safe_softmax)

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
    """He-style init, bf16 storage, layers stacked on a leading axis.

    Random numbers come from ``generator`` (drawn on the generator's own
    device) and the parameters land on ``device`` (default: the card)."""
    dev = resolve_device(device)
    gdev = generator.device

    def dense(fan_in, shape):
        w = torch.randn(shape, generator=generator, device=gdev,
                        dtype=torch.float32) / (fan_in ** 0.5)
        return w.to(device=dev, dtype=cfg.dtype)

    L = cfg.n_layers

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    embed = dense(1.0, (cfg.vocab, cfg.dim))
    layers = {
        "attn_norm": ones(L, cfg.dim),
        "wq": dense(cfg.dim, (L, cfg.dim, cfg.q_dim)),
        "wk": dense(cfg.dim, (L, cfg.dim, cfg.kv_dim)),
        "wv": dense(cfg.dim, (L, cfg.dim, cfg.kv_dim)),
        "wo": dense(cfg.q_dim, (L, cfg.q_dim, cfg.dim)),
        "mlp_norm": ones(L, cfg.dim),
        "w_gate": dense(cfg.dim, (L, cfg.dim, cfg.ffn_hidden)),
        "w_up": dense(cfg.dim, (L, cfg.dim, cfg.ffn_hidden)),
        "w_down": dense(cfg.ffn_hidden, (L, cfg.ffn_hidden, cfg.dim)),
    }
    return {"embed": embed, "layers": layers,
            "final_norm": ones(cfg.dim),
            "lm_head": dense(cfg.dim, (cfg.dim, cfg.vocab))}


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


def _ffn(cfg: ModelConfig, lp: Params, h: torch.Tensor) -> torch.Tensor:
    """Dense SwiGLU; ``qdot`` is ``@`` for bf16 weights and w8a8 for int8."""
    gate = F.silu(qdot(h, lp["w_gate"]).float()).to(h.dtype)
    return qdot(gate * qdot(h, lp["w_up"]), lp["w_down"])


def _qkv(cfg: ModelConfig, lp: Params, h: torch.Tensor, positions):
    b, s, _ = h.shape
    q = qdot(h, lp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = qdot(h, lp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = qdot(h, lp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
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
           lp: Params, mesh=None):
    """One decoder layer of the full-sequence forward: (x, k, v)."""
    b, s, _ = x.shape
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
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
    x = x + (attn.reshape(b, s, cfg.q_dim) @ lp["wo"]).to(x.dtype)
    hh = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    x = x + _ffn(cfg, lp, hh).to(x.dtype)
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
                  last_index: Optional[int] = None):
    """Forward: tokens (b, s) int -> logits fp32 (b, s, vocab).

    Without ``mesh`` the tokens are one device's whole sequence. With a USP
    ``mesh`` they are this rank's shard (b/dp, s/(R*U)) of the sequence in
    ``cfg.layout`` order, at their global positions (:func:`local_positions`),
    and attention runs over the mesh. Differentiable; serving callers run
    it under ``torch.no_grad()``. ``return_kv=True`` also returns the
    per-layer post-RoPE (k, v), each (n_layers, b, s, h_kv, d).
    ``last_index`` projects only that position through lm_head (logits
    (b, 1, vocab))."""
    b, s = tokens.shape
    if mesh is None:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    else:
        positions = local_positions(cfg, s, mesh)
    x = params["embed"][tokens]
    body = _maybe_remat(functools.partial(_layer, cfg, positions, mesh=mesh),
                        cfg)
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
               mask: torch.Tensor, cfg: ModelConfig, *, mesh=None
               ) -> torch.Tensor:
    """Masked-mean next-token cross entropy: tokens, labels, mask (b, s);
    labels[i] is the token after tokens[i] in the original order. -sum(log
    p(label) * mask) / max(sum(mask), 1), over fp32 logits.

    With a USP ``mesh`` the arguments are this rank's shards and the result
    is its contribution: the denominator sums over every rank of the mesh
    (dp x ring x ulysses), the numerator stays local, so the contributions
    (and their gradients) sum to the global loss (and its gradient), as
    JAX's ``loss_local``."""
    logits = forward_local(params, tokens, cfg, mesh=mesh)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    maskf = mask.float()
    den = maskf.sum()
    if mesh is not None and _world(mesh) > 1:
        den = den.detach().clone()
        dist.all_reduce(den)
    return -(ll * maskf).sum() / torch.clamp(den, min=1.0)


def _world(mesh) -> int:
    return mesh.dp * mesh.ring * mesh.ulysses


def make_forward(cfg: ModelConfig, mesh):
    """The forward over a USP mesh: ``fwd(params, tokens) -> logits`` of
    this rank's token shard (the JAX package's ``make_forward``; torch has
    no globally sharded array)."""
    return functools.partial(_mesh_forward, cfg=cfg, mesh=mesh)


def _mesh_forward(params, tokens, *, cfg, mesh):
    return forward_local(params, tokens, cfg, mesh=mesh)


def param_leaves(params: Params) -> List[torch.Tensor]:
    """The parameter tensors of a params dict, in its key order (the list
    an optimizer is built over)."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    return [params]


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

    With a USP ``mesh`` (``make_usp_mesh``: dp x ring x ulysses; every rank
    calls the step) the batch is this rank's shard, ``seq_shard`` of the
    sequence in ``cfg.layout`` order, labels and mask built in the original
    order before the permutation; the step runs on the mesh's device, each
    rank computes its loss contribution's gradients, which are summed over
    the whole mesh (the data-parallel and sequence-parallel reduction), and
    every rank applies the same update to its replica. The loss returned is
    the global loss."""
    if mesh is not None:
        dev = mesh.device
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"device {device} is not the mesh's {dev}")
    else:
        dev = resolve_device(device)

    def step(params, opt_state, tokens, labels, mask):
        leaves = param_leaves(params)
        for name, t in (("params['embed']", params["embed"]),
                        ("tokens", tokens), ("labels", labels),
                        ("mask", mask)):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, but the step "
                                 f"runs on {dev}")
        if opt_state is None:
            opt_state = optimizer(leaves)
        owned = {id(p) for grp in opt_state.param_groups
                 for p in grp["params"]}
        if owned != {id(p) for p in leaves}:
            raise ValueError("opt_state does not hold these params: build it "
                             "with optimizer(param_leaves(params))")
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_local(params, tokens, labels, mask, cfg, mesh=mesh)
        loss.backward()
        loss = loss.detach()
        if mesh is not None and _world(mesh) > 1:
            for p in leaves:
                dist.all_reduce(p.grad)
            dist.all_reduce(loss)
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss

    return step


@torch.no_grad()
def prefill_chunk_step(params: Params, cache, tokens: torch.Tensor,
                       start: int, cfg: ModelConfig, *,
                       last_logit_only: bool = False):
    """Process one prompt chunk against the cache so far (chunked prefill).

    tokens (b, s_c) at global positions [start, start + s_c). The chunk's
    causal self-attention (kernel B1, or B4 under a window or softcap) and
    its attention over the cache prefix (kernel B3, int8 or bf16, over the
    sink tiles and the window band only) merge by LSE. The chunk's
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
                cfg: ModelConfig, *, active: Optional[torch.Tensor] = None):
    """One single-token decode step against a KVCache (the serving hot
    path): tokens (b,) -> (logits (b, vocab) fp32, cache). Each layer
    appends the new token's K/V (kernel B6) and then attends over the cache
    including it (kernel B7); ``cache.length`` advances once at the end.
    The cache is updated IN PLACE. ``active`` (b,) bool marks live rows;
    inactive rows write nothing and do not advance."""
    b = tokens.shape[0]
    x = params["embed"][tokens][:, None]
    pos = cache.length
    live = (torch.ones_like(pos) if active is None
            else active.to(device=pos.device, dtype=pos.dtype))
    append_pos = torch.where(live > 0, pos, torch.full_like(pos, -1))
    att_len = pos + live
    scale = cfg.head_dim ** -0.5
    dt = cache.dtype
    for i, lp in enumerate(layer_params(params)):
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, h, pos[:, None])
        kq, ks1 = quantize_kv(k.transpose(1, 2), dt)  # (b, h_kv, 1, d)
        vq, vs1 = quantize_kv(v.transpose(1, 2), dt)
        cache_append(cache.k, cache.v, kq, vq, append_pos, cache.k_scale,
                     cache.v_scale, ks1, vs1, layer=i)
        attn = decode_attention(q[:, 0], cache.k, cache.v, att_len,
                                cache.k_scale, cache.v_scale,
                                softmax_scale=scale, layer=i,
                                **cfg.attention_kwargs())
        x = x + qdot(attn.reshape(b, 1, cfg.q_dim), lp["wo"]).to(x.dtype)
        hh = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(cfg, lp, hh).to(x.dtype)
    cache.length += live
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return qdot(x[:, 0], params["lm_head"]).float(), cache
