"""fp32 reference attention, the tests' oracle.

Counterpart of the forward of ``long_context_attention_tpu/ops/reference.py``
``xla_attention``: position-aware flash-attn masking semantics (causal,
sliding window with sinks, softcap, segments, additive bias) in fp32,
returning out (b, s_q, h, d) in q's dtype and lse (b, h, s_q) fp32. Fully
masked rows give out == 0 and lse == -inf.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["xla_attention"]


def _build_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
                window_size: Tuple[int, int], sink_tokens: int = 0
                ) -> Optional[torch.Tensor]:
    """Boolean (s_q, s_kv) mask, True where the score is dropped."""
    left, right = window_size
    if causal:
        right = 0  # flash-attn semantics: causal overrides the right window
    if left < 0 and right < 0 and not causal:
        return None
    rows = q_pos[:, None]
    cols = kv_pos[None, :]
    mask = torch.zeros((rows.shape[0], cols.shape[1]), dtype=torch.bool,
                       device=q_pos.device)
    if right >= 0:
        mask = mask | (cols > rows + right)
    if left >= 0:
        left_drop = cols < rows - left
        if sink_tokens > 0:
            left_drop = left_drop & (cols >= sink_tokens)
        mask = mask | left_drop
    return mask


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False,
                  softmax_scale: Optional[float] = None,
                  window_size: Tuple[int, int] = (-1, -1),
                  sink_tokens: int = 0,
                  softcap: float = 0.0,
                  q_positions: Optional[torch.Tensor] = None,
                  kv_positions: Optional[torch.Tensor] = None,
                  q_segment_ids: Optional[torch.Tensor] = None,
                  kv_segment_ids: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (b, s_q, h, d); k, v (b, s_kv, h_kv, d), h % h_kv == 0. Default
    positions are arange with the bottom-right causal alignment
    (q_pos += s_kv - s_q) when the lengths differ."""
    b, s_q, h, d = q.shape
    _, s_kv, h_kv, _ = k.shape
    if h % h_kv:
        raise ValueError(f"GQA requires h ({h}) % h_kv ({h_kv}) == 0")
    group = h // h_kv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=2)
        vf = vf.repeat_interleave(group, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", qf * scale, kf)
    if softcap and softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    if bias is not None:
        scores = scores + bias.float()
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(s_q, dtype=torch.int32, device=dev) + (
            s_kv - s_q)
    if kv_positions is None:
        kv_positions = torch.arange(s_kv, dtype=torch.int32, device=dev)
    mask = _build_mask(q_positions, kv_positions, causal, window_size,
                       sink_tokens)
    if mask is not None:
        scores = scores.masked_fill(mask[None, None], -math.inf)
    if q_segment_ids is not None:
        seg = q_segment_ids[:, :, None] != kv_segment_ids[:, None, :]
        scores = scores.masked_fill(seg[:, None], -math.inf)
    row_max = scores.amax(dim=-1)
    dead = torch.isneginf(row_max)
    safe_max = torch.where(dead, torch.zeros_like(row_max), row_max)
    p = torch.exp(scores - safe_max[..., None])
    if mask is not None:
        p = p.masked_fill(mask[None, None], 0.0)
    denom = p.sum(dim=-1)
    lse = torch.where(dead, torch.full_like(denom, -math.inf),
                      safe_max + torch.log(torch.clamp(denom, min=1e-37)))
    out = torch.einsum("bhts,bshd->bthd", p, vf)
    out = out / torch.clamp(denom, min=1e-37).transpose(1, 2)[..., None]
    out = torch.where(dead.transpose(1, 2)[..., None], torch.zeros_like(out),
                      out)
    return out.to(q.dtype), lse
