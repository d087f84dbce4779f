"""Parameters of the JAX package, as numpy arrays, into the port's dicts.

JAX keeps bf16 leaves as ``ml_dtypes.bfloat16`` numpy arrays, which
``torch.from_numpy`` rejects; they go through float32, a round trip that is
exact. Every other dtype keeps its type. :func:`cache_values_from_jax`
carries a quantized cache's values into the port's storage (fp8 by bytes,
int4 packed two per byte).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from long_context_attention_tpu_torch.ops.kv_cache import pack_int4
from long_context_attention_tpu_torch.utils.config import resolve_device

__all__ = ["params_from_jax", "cache_values_from_jax"]


def _leaf(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(tree: Any, device=None) -> Any:
    """Map a JAX params pytree -- the llama ``init_params``'s or the DiT
    ``init_dit_params``'s, nested dicts of numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``) -- to the port's parameter dict:
    the same keys, stacked ``(L, ...)`` layer leaves included, as tensors
    on ``device`` (default: the card; raises without one)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _leaf(node, dev)

    return walk(tree)


def cache_values_from_jax(x, device=None) -> torch.Tensor:
    """A JAX cache array (values or scales, as numpy) in the port's storage
    form on ``device`` (default: the card): ``float8_e4m3fn`` by its bytes,
    ``int4`` widened to int8 and packed along the last dim (the port's
    ``pack_int4``), every other dtype as :func:`params_from_jax` leaves."""
    dev = resolve_device(device)
    arr = np.asarray(x)
    if arr.dtype.name == "float8_e4m3fn":
        raw = torch.from_numpy(np.array(arr.view(np.uint8), copy=True))
        return raw.view(torch.float8_e4m3fn).to(dev)
    if arr.dtype.name == "int4":
        return pack_int4(torch.from_numpy(arr.astype(np.int8))).to(dev)
    return _leaf(arr, dev)
