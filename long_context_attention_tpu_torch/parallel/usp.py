"""USP: the 2-D hybrid of Ulysses and Ring sequence parallelism, block-sparse.

Counterpart of the sparse entries of
``long_context_attention_tpu/parallel/usp.py``: the composition
``a2a(ulysses) . ring-sparse(ring) . a2a^-1(ulysses)`` with a static global
tile mask, as functions on local shards and as the layers
:class:`LongContextAttention` and :class:`UlyssesAttention` over a
:class:`~long_context_attention_tpu_torch.parallel.mesh.UspMesh`.

torch has no globally sharded array: the layers take this rank's shards,
q (b/dp, s/(R*U), h, d) and k, v (b/dp, s/(R*U), h_kv, d), the sequence in
layout order (``permute_for_layout``) and cut by ``seq_shard`` (chunk
``ring_idx * U + ulysses_idx``), the convention of the reference's layers.
The dense path (``block_mask=None``, ``ring_attention_local``) comes with
the dense-ring slice and raises ``NotImplementedError`` until then.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from long_context_attention_tpu_torch.ops.sparse import (
    _host_mask,
    block_sparse_attention,
)
from long_context_attention_tpu_torch.parallel.mesh import MeshAxes, UspMesh
from long_context_attention_tpu_torch.parallel.ring_sparse import (
    ring_sparse_attention_local,
)
from long_context_attention_tpu_torch.parallel.ulysses import (
    gather_heads,
    group_rank,
    group_size,
    scatter_heads,
)
from long_context_attention_tpu_torch.utils.config import not_ported

__all__ = ["ulysses_sparse_attention_local",
           "usp_ring_sparse_attention_local", "LongContextAttention",
           "UlyssesAttention"]

_DENSE = ("the dense USP path (block_mask=None: ring_attention_local, the "
          "dense-ring slice)")


def _head_shard(block_mask, group):
    """(ulysses index, degree) for a per-head mask under ulysses > 1: the
    all-to-all hands rank u the u-th contiguous block of global heads."""
    u = group_size(group)
    if np.ndim(block_mask) == 3 and u > 1:
        return group_rank(group), u
    return None


def ulysses_sparse_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_mask,
    *,
    ulysses_group: Optional[dist.ProcessGroup],
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    block_q: int = 512,
    block_kv: int = 512,
    interpret: Optional[bool] = None,
) -> torch.Tensor:
    """Block-sparse attention under SP-Ulysses: after the head-scatter /
    sequence-gather all-to-all every rank holds the full sequence for h/U
    heads, so the global tile mask applies unchanged; a per-head mask is
    cut to the rank's head block (``head_shard``)."""
    mask = _host_mask(block_mask)
    q, k, v = (scatter_heads(t, ulysses_group) for t in (q, k, v))
    out = block_sparse_attention(
        q, k, v, mask, causal=causal, softmax_scale=softmax_scale,
        block_q=block_q, block_kv=block_kv, interpret=interpret,
        head_shard=_head_shard(mask, ulysses_group))
    return gather_heads(out, ulysses_group)


def usp_ring_sparse_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_mask,
    *,
    ulysses_group: Optional[dist.ProcessGroup],
    ring_group: Optional[dist.ProcessGroup],
    layout: str = "zigzag",
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    block_q: int = 512,
    block_kv: int = 512,
    interpret: Optional[bool] = None,
) -> torch.Tensor:
    """Block-sparse USP on local shards: head-scatter all-to-all over the
    ulysses group, the sparse ring over the ring group, the inverse
    all-to-all. 2-D shared or 3-D per-head global masks; layouts basic and
    zigzag; differentiable. A group of None is a degree of 1."""
    mask = _host_mask(block_mask)
    q, k, v = (scatter_heads(t, ulysses_group) for t in (q, k, v))
    out = ring_sparse_attention_local(
        q, k, v, mask, group=ring_group, layout=layout, causal=causal,
        softmax_scale=softmax_scale, block_q=block_q, block_kv=block_kv,
        interpret=interpret, head_shard=_head_shard(mask, ulysses_group))
    return gather_heads(out, ulysses_group)


class _LayerBase(torch.nn.Module):
    """Mesh-bound settings shared by the layers (the JAX dataclass fields;
    ``impl``, ``kv_quant``, ``bidirectional`` and ``block_sizes`` belong to
    the dense path)."""

    def __init__(self, mesh: UspMesh, axes: MeshAxes = MeshAxes(),
                 layout: str = "zigzag", impl: str = "pallas",
                 kv_quant: Optional[str] = None, bidirectional: bool = False,
                 block_sizes=None, interpret: Optional[bool] = None):
        super().__init__()
        self.mesh = mesh
        self.axes = axes
        self.layout = layout
        self.impl = impl
        self.kv_quant = kv_quant
        self.bidirectional = bidirectional
        self.block_sizes = block_sizes
        self.interpret = interpret


class LongContextAttention(_LayerBase):
    """The USP layer (``hybrid/attn_layer.py:14`` of the reference) on this
    rank's shards; with ``block_mask`` the block-sparse composition."""

    def forward(self, q, k, v, *, causal: bool = False,
                softmax_scale: Optional[float] = None,
                window_size: Tuple[int, int] = (-1, -1),
                softcap: float = 0.0,
                segment_ids=None,
                dropout_p: float = 0.0,
                dropout_key=None,
                alibi_slopes=None,
                sink_tokens: int = 0,
                block_mask=None,
                sparse_block_q: int = 512,
                sparse_block_kv: int = 512) -> torch.Tensor:
        """``block_mask``: a static (S/sparse_block_q, S/sparse_block_kv)
        global tile mask (or per head) routes the call through the sparse
        USP composition (basic/zigzag layouts, differentiable); it composes
        with ``causal`` and ``softmax_scale`` only, as in JAX."""
        del dropout_key
        if block_mask is None:
            raise not_ported(_DENSE)
        if (tuple(window_size) != (-1, -1) or softcap != 0.0
                or segment_ids is not None or dropout_p > 0.0
                or alibi_slopes is not None or sink_tokens > 0):
            raise NotImplementedError(
                "block_mask composes with causal/softmax_scale only — "
                "encode windows/sinks in the mask itself")
        return usp_ring_sparse_attention_local(
            q, k, v, block_mask, ulysses_group=self.mesh.ulysses_group,
            ring_group=self.mesh.ring_group, layout=self.layout,
            causal=causal, softmax_scale=softmax_scale,
            block_q=sparse_block_q, block_kv=sparse_block_kv,
            interpret=self.interpret)


class UlyssesAttention(_LayerBase):
    """The SP-Ulysses layer (``ulysses/attn_layer.py:15-126`` of the
    reference) on this rank's shards (ring degree 1); with ``block_mask``
    block-sparse attention after the all-to-all."""

    def forward(self, q, k, v, *, causal: bool = False,
                softmax_scale: Optional[float] = None,
                window_size: Tuple[int, int] = (-1, -1),
                softcap: float = 0.0, block_mask=None,
                sparse_block_q: int = 512,
                sparse_block_kv: int = 512) -> torch.Tensor:
        if block_mask is None:
            raise not_ported(_DENSE)
        if tuple(window_size) != (-1, -1) or softcap != 0.0:
            raise NotImplementedError(
                "block_mask does not combine with window/softcap — encode "
                "the window in the mask itself")
        return ulysses_sparse_attention_local(
            q, k, v, block_mask, ulysses_group=self.mesh.ulysses_group,
            causal=causal, softmax_scale=softmax_scale,
            block_q=sparse_block_q, block_kv=sparse_block_kv,
            interpret=self.interpret)
