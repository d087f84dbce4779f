"""Llama-style GQA decoder, serving side, in PyTorch.

Counterpart of the serving half of ``long_context_attention_tpu/models/
llama.py``: the same config, parameter dict (layers stacked on a leading
axis, bf16 weights, fp32 norms), RMSNorm, RoPE over global positions and
dense SwiGLU FFN, with

* :func:`forward_local`: the single-device full-prompt forward (what
  ``Engine.prefill`` runs), attention through ``flash_attention_fwd``;
* :func:`prefill_chunk_step`: one prompt chunk against the cache so far
  (chunk self-attention, attention over the cache prefix, LSE merge);
* :func:`decode_step`: one token per row against the cache (append, then
  attend).

Both cache steps update the cache IN PLACE. USP/ring sharding, MoE, tensor
and pipeline parallelism and training come in later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from long_context_attention_tpu_torch.ops.decode import (
    cache_append,
    decode_attention,
)
from long_context_attention_tpu_torch.ops.flash import (
    flash_attention_fwd,
    flash_attention_fwd_cache,
)
from long_context_attention_tpu_torch.ops.kv_cache import quantize_kv
from long_context_attention_tpu_torch.ops.merge import merge_attn_blocks
from long_context_attention_tpu_torch.ops.wquant import qdot
from long_context_attention_tpu_torch.utils.config import (
    BlockSizes,
    not_ported,
    resolve_device,
)

__all__ = ["ModelConfig", "init_params", "rmsnorm", "rope", "forward_local",
           "prefill_chunk_step", "decode_step", "layer_params"]

Params = Dict[str, Any]
LAYOUTS = ("basic", "zigzag", "stripe")


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
    remat: str = "none"

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r}; expected one "
                             f"of {LAYOUTS}")
        # Fields kept for parity with the JAX config whose other values
        # need a slice not ported yet. ``layout`` orders the sequence across
        # a mesh's ring; on one device (the only mode here) every layout is
        # the same model.
        for name, what in (("window_left", "sliding-window models"),
                           ("softcap", "softcapped models"),
                           ("sink_tokens", "attention sinks"),
                           ("attn_impl", "attention implementations other "
                                         "than the Hopper kernels"),
                           ("block_sizes", "per-model kernel tile sizes"),
                           ("n_experts", "MoE layers"),
                           ("moe_capacity_factor", "MoE layers"),
                           ("remat", "rematerialization (training)")):
            if getattr(self, name) != _PARITY_DEFAULTS[name]:
                raise not_ported(f"{what} ({name}={getattr(self, name)!r})")

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


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked layer weights (views)."""
    return {k: v[i] for k, v in params["layers"].items()}


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


@torch.no_grad()
def forward_local(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  return_kv: bool = False, last_index: Optional[int] = None):
    """Single-device forward: tokens (b, s) int -> logits fp32 (b, s, vocab).

    ``return_kv=True`` also returns the per-layer post-RoPE (k, v), each
    (n_layers, b, s, h_kv, d). ``last_index`` projects only that position
    through lm_head (logits (b, 1, vocab))."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    x = params["embed"][tokens]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, h, positions)
        attn, _ = flash_attention_fwd(q, k, v, causal=True,
                                      safe_softmax=cfg.safe_softmax)
        x = x + (attn.reshape(b, s, cfg.q_dim) @ lp["wo"]).to(x.dtype)
        hh = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(cfg, lp, hh).to(x.dtype)
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


@torch.no_grad()
def prefill_chunk_step(params: Params, cache, tokens: torch.Tensor,
                       start: int, cfg: ModelConfig, *,
                       last_logit_only: bool = False):
    """Process one prompt chunk against the cache so far (chunked prefill).

    tokens (b, s_c) at global positions [start, start + s_c). The chunk's
    causal self-attention (kernel B1) and its attention over the cache
    prefix (kernel B3, int8 or bf16) merge by LSE. The chunk's K/V are
    written into the cache at [start, ...) and ``cache.length`` is set to
    start + s_c, IN PLACE. Returns (logits (b, s_c or 1, vocab) fp32,
    cache)."""
    b, s_c = tokens.shape
    positions = torch.arange(s_c, dtype=torch.int32,
                             device=tokens.device) + start
    x = params["embed"][tokens]
    scale = cfg.head_dim ** -0.5
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, h, positions)
        out, lse = flash_attention_fwd(q, k, v, causal=True,
                                       safe_softmax=cfg.safe_softmax,
                                       softmax_scale=scale)
        if start > 0:
            kcl = cache.k[i, :, :, :start]
            vcl = cache.v[i, :, :, :start]
            kscl = vscl = None
            if cache.k_scale is not None:
                kscl = cache.k_scale[i, :, :, 0, :start]
                vscl = cache.v_scale[i, :, :, 0, :start]
            c_out, c_lse = flash_attention_fwd_cache(
                q, kcl, vcl, k_scale=kscl, v_scale=vscl,
                safe_softmax=cfg.safe_softmax, q_start=start,
                softmax_scale=scale, causal=True)
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
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, h, pos[:, None])
        kq, ks1 = quantize_kv(k.transpose(1, 2), dt)  # (b, h_kv, 1, d)
        vq, vs1 = quantize_kv(v.transpose(1, 2), dt)
        cache_append(cache.k, cache.v, kq, vq, append_pos, cache.k_scale,
                     cache.v_scale, ks1, vs1, layer=i)
        attn = decode_attention(q[:, 0], cache.k, cache.v, att_len,
                                cache.k_scale, cache.v_scale,
                                softmax_scale=scale, layer=i,
                                safe_softmax=cfg.safe_softmax)
        x = x + qdot(attn.reshape(b, 1, cfg.q_dim), lp["wo"]).to(x.dtype)
        hh = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(cfg, lp, hh).to(x.dtype)
    cache.length += live
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return qdot(x[:, 0], params["lm_head"]).float(), cache
