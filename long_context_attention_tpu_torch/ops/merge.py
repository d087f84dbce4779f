"""Online log-sum-exp merge of attention blocks, -inf-safe.

Counterpart of ``long_context_attention_tpu/ops/merge.py``: combine partial
attention results whose softmax ran over disjoint KV sets, in fp32. A fully
masked block carries lse == -inf and merges as a no-op.

Layout contract: out (b, s, h, d) fp32 accumulator, lse (b, h, s) fp32.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = ["merge_attn_blocks", "init_merge_state", "merge_partials"]


def merge_partials(outs: torch.Tensor, lses: torch.Tensor):
    """N-way -inf-safe merge over the leading axis.

    outs (n, ..., d) any float dtype; lses (n, ...) fp32. Returns fp32
    (out (..., d), lse (...)); positions where every partial is -inf give
    out == 0, lse == -inf."""
    lses = lses.float()
    m = lses.amax(dim=0)
    dead = torch.isneginf(m)
    safe_m = torch.where(dead, torch.zeros_like(m), m)
    w = torch.where(torch.isneginf(lses), torch.zeros_like(lses),
                    torch.exp(lses - safe_m[None]))
    denom = w.sum(dim=0)
    out = (outs.float() * w[..., None]).sum(dim=0)
    out = out / torch.clamp(denom, min=1e-37)[..., None]
    out = torch.where(dead[..., None], torch.zeros_like(out), out)
    lse = torch.where(dead, torch.full_like(m, -math.inf),
                      safe_m + torch.log(torch.clamp(denom, min=1e-37)))
    return out, lse


def init_merge_state(b: int, s: int, h: int, d: int, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Empty accumulator: zero output, -inf LSE."""
    out = torch.zeros((b, s, h, d), dtype=torch.float32, device=device)
    lse = torch.full((b, h, s), -math.inf, dtype=torch.float32, device=device)
    return out, lse


def _weight(lse: torch.Tensor, new_lse: torch.Tensor) -> torch.Tensor:
    """exp(lse - new_lse) with 0 at lse == -inf (avoids -inf - -inf = NaN)."""
    safe_new = torch.where(torch.isneginf(new_lse), torch.zeros_like(new_lse),
                           new_lse)
    return torch.where(torch.isneginf(lse), torch.zeros_like(lse),
                       torch.exp(lse - safe_new))


def merge_attn_blocks(acc_out: torch.Tensor, acc_lse: torch.Tensor,
                      block_out: torch.Tensor, block_lse: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """new_lse = logaddexp(acc_lse, block_lse);
    new_out = exp(acc_lse - new_lse) * acc_out
              + exp(block_lse - new_lse) * block_out."""
    acc_lse = acc_lse.float()
    block_lse = block_lse.float()
    new_lse = torch.logaddexp(acc_lse, block_lse)
    w_acc = _weight(acc_lse, new_lse).transpose(1, 2)[..., None]
    w_blk = _weight(block_lse, new_lse).transpose(1, 2)[..., None]
    new_out = w_acc * acc_out.float() + w_blk * block_out.float()
    return new_out, new_lse
