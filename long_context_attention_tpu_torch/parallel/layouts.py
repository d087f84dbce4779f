"""Global token positions from the kernels' compact position descriptor.

Counterpart of ``positions_from_descriptor`` in
``long_context_attention_tpu/parallel/layouts.py``, the one function of that
module the attention registry needs (its ``xla`` impl takes per-token
positions). The layout permutations and the ring descriptors come with USP.
"""

from __future__ import annotations

import torch

__all__ = ["positions_from_descriptor"]


def positions_from_descriptor(offsets, stride: int,
                              local_len: int) -> torch.Tensor:
    """Expand a compact (offsets, stride) descriptor into per-token global
    positions (local_len,) int32: chunk c's token i sits at offsets[c] +
    i * stride, the chunks splitting ``local_len`` evenly."""
    offsets = torch.as_tensor(offsets).reshape(-1).to(torch.int32)
    chunk = local_len // offsets.shape[0]
    within = (torch.arange(local_len, dtype=torch.int32,
                           device=offsets.device) % chunk) * stride
    return torch.repeat_interleave(offsets, chunk) + within
