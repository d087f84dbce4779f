"""DiT family: non-causal USP attention for diffusion transformers.

Counterpart of ``long_context_attention_tpu/models/dit.py``: a patchified
latent transformer with adaLN-zero timestep conditioning, whose attention is
bidirectional :func:`usp_attention_local` in the basic layout (non-causal
work is balanced without zigzag). The same config, the same parameter dict
(layers stacked on a leading axis, ``cfg.dtype`` weights, ``mod`` and
``out`` zero at init) and the JAX numerics: an fp32 time MLP whose
modulation is cast to ``cfg.dtype`` after its fp32 product, unit-weight
RMSNorm, the tanh GELU (``jax.nn.gelu``'s default) and an fp32 output.

On one device (``mesh=None``) attention is a ring of one: under
``attn_impl="pallas"`` kernel B3 at the one-chunk descriptor forward and
B2a + B2b backward, under ``"sage"`` B8b (with the straight-through B2a +
B2b backward). Over a USP mesh the latent tokens are this rank's shard of
the sequence ((ring, ulysses), ring-major, ``seq_shard``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from long_context_attention_tpu_torch.models.llama import (
    check_devices,
    optimizer_step,
    rmsnorm,
    step_device,
    world_size,
)
from long_context_attention_tpu_torch.parallel.mesh import check_seq_mesh
from long_context_attention_tpu_torch.parallel.usp import usp_attention_local
from long_context_attention_tpu_torch.utils.config import (
    BlockSizes,
    resolve_device,
)

__all__ = ["DiTConfig", "timestep_embedding", "init_dit_params",
           "dit_forward_local", "make_dit_forward", "make_dit_train_step"]

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """DiT hyperparameters (the JAX defaults: a tiny test model)."""

    in_dim: int = 16           # patchified latent channels
    dim: int = 128
    n_layers: int = 2
    n_heads: int = 4
    head_dim: int = 32
    ffn_hidden: int = 256
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    attn_impl: str = "pallas"
    block_sizes: Optional[BlockSizes] = None

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal (b,) -> (b, dim) fp32 (the standard DiT embedding)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def init_dit_params(generator: torch.Generator, cfg: DiTConfig,
                    device=None) -> Params:
    """Normal / sqrt(fan_in) weights in ``cfg.dtype``, layers stacked on a
    leading axis; ``mod`` (adaLN-zero) and the ``out`` head zero, so every
    block starts as the identity. Random numbers come from ``generator``
    (drawn on its own device); the params land on ``device`` (default: the
    card; raises without one)."""
    dev = resolve_device(device)
    gdev = generator.device
    L = cfg.n_layers

    def dense(fan_in, shape):
        w = torch.randn(shape, generator=generator, device=gdev,
                        dtype=torch.float32) / math.sqrt(fan_in)
        return w.to(device=dev, dtype=cfg.dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    return {
        "patch_in": dense(cfg.in_dim, (cfg.in_dim, cfg.dim)),
        "t_mlp1": dense(cfg.dim, (cfg.dim, cfg.dim)),
        "t_mlp2": dense(cfg.dim, (cfg.dim, cfg.dim)),
        "layers": {
            "wqkv": dense(cfg.dim, (L, cfg.dim, 3 * cfg.q_dim)),
            "wo": dense(cfg.q_dim, (L, cfg.q_dim, cfg.dim)),
            "w_up": dense(cfg.dim, (L, cfg.dim, cfg.ffn_hidden)),
            "w_down": dense(cfg.ffn_hidden, (L, cfg.ffn_hidden, cfg.dim)),
            "mod": zeros(L, cfg.dim, 6 * cfg.dim),
        },
        "out": zeros(cfg.dim, cfg.in_dim),
    }


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None]) + shift[:, None]


def _norm(cfg: DiTConfig, h: torch.Tensor) -> torch.Tensor:
    return rmsnorm(h, torch.ones(cfg.dim, dtype=torch.float32,
                                 device=h.device), cfg.norm_eps)


def _block(cfg: DiTConfig, c: torch.Tensor, mesh, h: torch.Tensor,
           lp: Params) -> torch.Tensor:
    b, n, _ = h.shape
    mod = (c @ lp["mod"].float()).to(h.dtype)
    sh_a, sc_a, gate_a, sh_m, sc_m, gate_m = mod.chunk(6, dim=-1)
    a = _modulate(_norm(cfg, h), sh_a, sc_a)
    qkv = (a @ lp["wqkv"]).reshape(b, n, 3, cfg.n_heads, cfg.head_dim)
    attn = usp_attention_local(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
        ulysses_group=None if mesh is None else mesh.ulysses_group,
        ring_group=None if mesh is None else mesh.ring_group,
        layout="basic", causal=False, impl=cfg.attn_impl,
        block_sizes=cfg.block_sizes)
    h = h + gate_a[:, None] * (attn.reshape(b, n, cfg.q_dim) @ lp["wo"])
    m = _modulate(_norm(cfg, h), sh_m, sc_m)
    m = F.gelu((m @ lp["w_up"]).float(), approximate="tanh").to(h.dtype)
    return h + gate_m[:, None] * (m @ lp["w_down"])


def dit_forward_local(params: Params, x: torch.Tensor, t: torch.Tensor,
                      cfg: DiTConfig, *, mesh=None) -> torch.Tensor:
    """x (b, n, in_dim) latents, t (b,) their rows' timesteps -> (b, n,
    in_dim) fp32.

    Without ``mesh`` x is one device's whole token grid; with a USP
    ``mesh`` it is this rank's shard (b/dp, n/(R*U), in_dim) in the basic
    layout and attention runs over the mesh (dp x ring x ulysses: a mesh
    with a tp, pp or ep axis raises, as the JAX DiT has none).
    Differentiable."""
    check_seq_mesh(mesh, "the DiT")
    c = timestep_embedding(t, cfg.dim)
    c = F.silu(c @ params["t_mlp1"].float())
    c = F.silu(c @ params["t_mlp2"].float())  # (b, dim) fp32
    h = x.to(cfg.dtype) @ params["patch_in"]
    cols = {k: w.unbind() for k, w in params["layers"].items()}
    for vals in zip(*cols.values()):
        h = _block(cfg, c, mesh, h, dict(zip(cols, vals)))
    return (_norm(cfg, h) @ params["out"]).float()


def make_dit_forward(cfg: DiTConfig, mesh=None, *, device=None) -> Callable:
    """``fwd(params, x, t) -> (b, n, in_dim) fp32`` of this rank's latent
    shard (the JAX package's ``make_dit_forward``; torch has no globally
    sharded array), on the mesh's device or, without one, ``device``
    (default: the card; raises without one). Runs without autograd."""
    check_seq_mesh(mesh, "the DiT")
    dev = step_device(mesh, device)

    @torch.no_grad()
    def fwd(params, x, t):
        check_devices(dev, "forward", **{"params['patch_in']":
                                          params["patch_in"]}, x=x, t=t)
        return dit_forward_local(params, x, t, cfg, mesh=mesh)

    return fwd


def make_dit_train_step(cfg: DiTConfig, optimizer: Callable, mesh=None, *,
                        device=None) -> Callable:
    """The denoising train step, ``step(params, opt_state, noisy, noise, t)
    -> (params, opt_state, loss)``: predict the noise added to the latents.

    ``optimizer`` is a factory over a list of tensors, as for the llama
    ``make_train_step`` (e.g. ``functools.partial(torch.optim.AdamW,
    lr=1e-4, weight_decay=1e-4)``); ``opt_state`` is what it built, or
    None on the first step. The loss is the squared error summed over this
    rank's elements over the element count of the whole mesh, so the
    ranks' losses and gradients sum (over dp x ring x ulysses) to the
    global mean's; every rank applies the same update IN PLACE and gets
    the global loss. Runs on the mesh's device or ``device`` (default: the
    card)."""
    check_seq_mesh(mesh, "the DiT")
    dev = step_device(mesh, device)

    def step(params, opt_state, noisy, noise, t):
        check_devices(dev, "step", **{"params['patch_in']":
                                       params["patch_in"]},
                       noisy=noisy, noise=noise, t=t)
        count = torch.tensor(float(noise.numel()), device=dev)
        if mesh is not None and world_size(mesh) > 1:
            torch.distributed.all_reduce(count)

        def loss_fn(p):
            pred = dit_forward_local(p, noisy, t, cfg, mesh=mesh)
            return ((pred - noise.float()) ** 2).sum() / count

        return optimizer_step(params, opt_state, optimizer, loss_fn, mesh)

    return step
