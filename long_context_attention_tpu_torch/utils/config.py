"""Shared constants and the device rule of the PyTorch port.

Counterpart of ``long_context_attention_tpu/utils/config.py``. The JAX
package picks compiled or interpreted Pallas from the active backend
(``default_interpret``); the port has no interpret mode. Its entry points run
on the card unless the caller asks for the CPU, where every kernel wrapper
takes its plain PyTorch version.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["NEG_INF", "BlockSizes", "resolve_device", "not_ported"]

# Large-negative stand-in for -inf inside kernels (keeps exp/max chains free
# of NaN while exp(NEG_INF - m) == 0 for any realistic running max m).
NEG_INF = float(-1e30)


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Tile sizes of the JAX package's flash kernels, kept for API parity.

    The port's kernels choose their own tiles."""

    block_q: int = 1024
    block_kv: int = 1024
    block_q_bwd: Optional[int] = None
    block_kv_bwd: Optional[int] = None


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.

    Raises ``RuntimeError`` when CUDA is asked for (or defaulted to) and no
    card is available; the CPU is used only when the caller passes it. A
    bare "cuda" resolves to the current card's index, so the result
    compares equal to the ``.device`` of tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on an NVIDIA GPU by "
                "default; pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:  # "cuda" names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def not_ported(what: str) -> NotImplementedError:
    """The error a feature of the JAX package raises until its slice of the
    port lands."""
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet")
