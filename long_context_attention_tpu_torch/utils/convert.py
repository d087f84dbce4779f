"""Parameters of the JAX package, as numpy arrays, into the port's dicts.

JAX keeps bf16 leaves as ``ml_dtypes.bfloat16`` numpy arrays, which
``torch.from_numpy`` rejects; they go through float32, a round trip that is
exact. Every other dtype keeps its type.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from long_context_attention_tpu_torch.utils.config import resolve_device

__all__ = ["params_from_jax"]


def _leaf(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(tree: Any, device=None) -> Any:
    """Map a JAX ``init_params`` pytree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) to the port's parameter dict:
    the same keys, stacked ``(L, ...)`` layer leaves included, as tensors
    on ``device`` (default: the card; raises without one)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _leaf(node, dev)

    return walk(tree)
