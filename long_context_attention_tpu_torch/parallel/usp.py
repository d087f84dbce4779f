"""USP: the 2-D hybrid of Ulysses and Ring sequence parallelism.

Counterpart of ``long_context_attention_tpu/parallel/usp.py``: the
composition ``a2a(ulysses) . ring(ring) . a2a^-1(ulysses)``, dense
(:func:`usp_attention_local`, over ``parallel/ring.py``) or with a static
global tile mask (the sparse ring), as functions on local shards and as the
layers :class:`LongContextAttention` (with ``.packed``) and
:class:`UlyssesAttention` over a
:class:`~long_context_attention_tpu_torch.parallel.mesh.UspMesh`.

torch has no globally sharded array: the layers take this rank's shards,
q (b/dp, s/(R*U), h, d) and k, v (b/dp, s/(R*U), h_kv, d), the sequence in
layout order (``permute_for_layout``) and cut by ``seq_shard`` (chunk
``ring_idx * U + ulysses_idx``), the convention of the reference's layers.
The dense layer takes segment ids (packed varlen batches), ALiBi slopes and
dropout, the reference layer's training knobs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from long_context_attention_tpu_torch.ops.flash import dropout_word
from long_context_attention_tpu_torch.ops.sparse import (
    _host_mask,
    block_sparse_attention,
)
from long_context_attention_tpu_torch.parallel.mesh import MeshAxes, UspMesh
from long_context_attention_tpu_torch.parallel.ring import (
    ring_attention_local,
)
from long_context_attention_tpu_torch.parallel.ring_sparse import (
    ring_sparse_attention_local,
)
from long_context_attention_tpu_torch.parallel.ulysses import (
    PendingScatter,
    gather_heads,
    gather_seq,
    group_rank,
    group_size,
    scatter_heads,
)

__all__ = ["usp_attention_local", "async_usp_attention_local",
           "ulysses_sparse_attention_local",
           "usp_ring_sparse_attention_local", "LongContextAttention",
           "UlyssesAttention", "AsyncLongContextAttention"]


def usp_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    ulysses_group: Optional[dist.ProcessGroup],
    ring_group: Optional[dist.ProcessGroup],
    layout: str = "zigzag",
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    impl: str = "pallas",
    segment_ids=None,
    kv_quant: Optional[str] = None,
    bidirectional: bool = False,
    dropout_p: float = 0.0,
    dropout_key=None,
    alibi_slopes=None,
    sink_tokens: int = 0,
    block_sizes=None,
    interpret: Optional[bool] = None,
    safe_softmax: bool = False,
) -> torch.Tensor:
    """USP attention on this rank's shards (b, s/(U*R), h, d) -> the same
    shape: the head-scatter / sequence-gather all-to-all over the ulysses
    group, ring attention over the ring group, the inverse all-to-all
    (the reference's ``LongContextAttention.forward``,
    ``hybrid/attn_layer.py:57-161``). h and h_kv must divide by the
    ulysses degree. A group of None is a degree of 1. Differentiable.

    ``segment_ids`` ((b, s/(U*R)) ints, this rank's tokens) are gathered
    over the ulysses group to the ring-local sequence; ``alibi_slopes`` are
    the GLOBAL (h,) slopes, of which each ulysses rank takes its contiguous
    head block; ``dropout_key`` (a ``torch.Generator`` seeded alike on
    every rank, or its 32-bit word) gives one word, and the seed's head
    base is the rank's first global head, so every global head draws the
    bits it would on one device."""
    q, k, v = (scatter_heads(t, ulysses_group) for t in (q, k, v))
    if segment_ids is not None:
        segment_ids = gather_seq(torch.as_tensor(segment_ids,
                                                 device=q.device),
                                 ulysses_group)
    h_local = q.shape[2]
    u_rank = group_rank(ulysses_group)
    if alibi_slopes is not None:
        alibi_slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                       device=q.device).reshape(-1)
        alibi_slopes = alibi_slopes[u_rank * h_local:(u_rank + 1) * h_local]
    seed = None
    if dropout_p > 0.0:
        if dropout_key is None:
            raise ValueError("dropout_p > 0 requires dropout_key")
        seed = (dropout_word(dropout_key), u_rank * h_local)
    out = ring_attention_local(
        q, k, v, group=ring_group, layout=layout, causal=causal,
        softmax_scale=softmax_scale, window_size=window_size,
        softcap=softcap, impl=impl, segment_ids=segment_ids,
        kv_quant=kv_quant, bidirectional=bidirectional, dropout_p=dropout_p,
        dropout_seed=seed, alibi_slopes=alibi_slopes,
        sink_tokens=sink_tokens, block_sizes=block_sizes,
        interpret=interpret, safe_softmax=safe_softmax)
    return gather_heads(out, ulysses_group)


def async_usp_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    ulysses_group: Optional[dist.ProcessGroup],
    ring_group: Optional[dist.ProcessGroup],
    n_groups: Optional[int] = None,
    layout: str = "zigzag",
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    impl: str = "pallas",
    block_sizes=None,
    interpret: Optional[bool] = None,
) -> torch.Tensor:
    """Head-group pipelined USP on this rank's shards (the reference's
    ``AsyncLongContextAttention.forward``,
    ``hybrid/async_attn_layer.py:44-197``).

    The heads split into ``n_groups`` groups (default ``max(h_kv / U, 1)``,
    one kv head per ulysses rank a group): group i holds q heads ``[i*gh,
    (i+1)*gh)`` and kv heads ``[i*gkv, (i+1)*gkv)``, so GQA's map from q
    head to kv head is kept. Each group runs the a2a . ring . a2a^-1 chain
    of :func:`usp_attention_local`, and the outputs join on heads. The next
    group's head-scatter all-to-alls are issued (``async_op=True``) before
    this group's ring runs, so they overlap it; with U = 1 no collective
    runs. Differentiable (the reference's backward raises)."""
    u = group_size(ulysses_group)
    h, h_kv = q.shape[2], k.shape[2]
    if n_groups is None:
        n_groups = max(h_kv // u, 1)
    if h % n_groups or h_kv % n_groups:
        raise ValueError(f"heads ({h}, kv {h_kv}) must divide into "
                         f"{n_groups} groups")
    gh, gkv = h // n_groups, h_kv // n_groups

    def start(i):
        return [PendingScatter(t[:, :, i * w:(i + 1) * w], ulysses_group)
                for t, w in ((q, gh), (k, gkv), (v, gkv))]

    outs = []
    pending = start(0)
    for i in range(n_groups):
        qi, ki, vi = (p.wait() for p in pending)
        if i + 1 < n_groups:
            pending = start(i + 1)
        out = ring_attention_local(
            qi, ki, vi, group=ring_group, layout=layout, causal=causal,
            softmax_scale=softmax_scale, window_size=window_size,
            softcap=softcap, impl=impl, block_sizes=block_sizes,
            interpret=interpret)
        outs.append(gather_heads(out, ulysses_group))
    return torch.cat(outs, dim=2)


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

    def _dense(self, q, k, v, layout: str, **kw) -> torch.Tensor:
        return usp_attention_local(
            q, k, v, ulysses_group=self.mesh.ulysses_group,
            ring_group=self.mesh.ring_group, layout=layout, impl=self.impl,
            kv_quant=self.kv_quant, bidirectional=self.bidirectional,
            block_sizes=self.block_sizes, interpret=self.interpret, **kw)

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
    rank's shards: dense (:func:`usp_attention_local`), or with
    ``block_mask`` the block-sparse composition."""

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
        """Dense USP attention of this rank's shards with the sliding
        window, sinks, softcap, and the reference layer's training knobs:
        ``segment_ids`` (packed documents), ``alibi_slopes`` ((h,) global)
        and ``dropout_p`` with ``dropout_key`` (:func:`usp_attention_local`).
        ``block_mask``: a static
        (S/sparse_block_q, S/sparse_block_kv) global tile mask (or per
        head) routes the call through the sparse USP composition
        (basic/zigzag layouts, differentiable); it composes with ``causal``
        and ``softmax_scale`` only, as in JAX."""
        if block_mask is None:
            return self._dense(
                q, k, v, self.layout, causal=causal,
                softmax_scale=softmax_scale, window_size=window_size,
                softcap=softcap, segment_ids=segment_ids,
                dropout_p=dropout_p, dropout_key=dropout_key,
                alibi_slopes=alibi_slopes, sink_tokens=sink_tokens)
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

    def packed(self, qkv, *, causal: bool = False,
               softmax_scale: Optional[float] = None,
               window_size: Tuple[int, int] = (-1, -1),
               softcap: float = 0.0, segment_ids=None,
               dropout_p: float = 0.0, dropout_key=None,
               alibi_slopes=None, sink_tokens: int = 0) -> torch.Tensor:
        """The QKV-packed entry (``hybrid/attn_layer.py:164-259``): qkv (b,
        s/(R*U), 3, h, d), dense, with the kwargs of :meth:`forward`."""
        return self(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=causal,
                    softmax_scale=softmax_scale, window_size=window_size,
                    softcap=softcap, segment_ids=segment_ids,
                    dropout_p=dropout_p, dropout_key=dropout_key,
                    alibi_slopes=alibi_slopes, sink_tokens=sink_tokens)


class UlyssesAttention(_LayerBase):
    """The SP-Ulysses layer (``ulysses/attn_layer.py:15-126`` of the
    reference) on this rank's shards (ring degree 1): dense attention in
    the basic layout after the all-to-all, or with ``block_mask``
    block-sparse attention."""

    def forward(self, q, k, v, *, causal: bool = False,
                softmax_scale: Optional[float] = None,
                window_size: Tuple[int, int] = (-1, -1),
                softcap: float = 0.0, block_mask=None,
                sparse_block_q: int = 512,
                sparse_block_kv: int = 512) -> torch.Tensor:
        if block_mask is None:
            return self._dense(q, k, v, "basic", causal=causal,
                               softmax_scale=softmax_scale,
                               window_size=window_size, softcap=softcap)
        if tuple(window_size) != (-1, -1) or softcap != 0.0:
            raise NotImplementedError(
                "block_mask does not combine with window/softcap — encode "
                "the window in the mask itself")
        return ulysses_sparse_attention_local(
            q, k, v, block_mask, ulysses_group=self.mesh.ulysses_group,
            causal=causal, softmax_scale=softmax_scale,
            block_q=sparse_block_q, block_kv=sparse_block_kv,
            interpret=self.interpret)


class AsyncLongContextAttention(_LayerBase):
    """The head-group pipelined USP layer (``hybrid/async_attn_layer.py:13``
    of the reference) on this rank's shards: :func:`async_usp_attention_local`
    with the layer's layout, impl and ``n_groups`` (None: one kv head per
    ulysses rank a group, the reference's ``un = hc / ud``)."""

    def __init__(self, mesh: UspMesh, axes: MeshAxes = MeshAxes(),
                 layout: str = "zigzag", impl: str = "pallas",
                 kv_quant: Optional[str] = None, bidirectional: bool = False,
                 block_sizes=None, interpret: Optional[bool] = None,
                 n_groups: Optional[int] = None):
        super().__init__(mesh, axes, layout, impl, kv_quant, bidirectional,
                         block_sizes, interpret)
        self.n_groups = n_groups

    def forward(self, q, k, v, *, causal: bool = False,
                softmax_scale: Optional[float] = None,
                window_size: Tuple[int, int] = (-1, -1),
                softcap: float = 0.0) -> torch.Tensor:
        return async_usp_attention_local(
            q, k, v, ulysses_group=self.mesh.ulysses_group,
            ring_group=self.mesh.ring_group, n_groups=self.n_groups,
            layout=self.layout, causal=causal, softmax_scale=softmax_scale,
            window_size=window_size, softcap=softcap, impl=self.impl,
            block_sizes=self.block_sizes, interpret=self.interpret)
