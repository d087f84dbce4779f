"""Sequence layouts for the ring schedules (basic / zigzag / stripe).

Counterpart of ``long_context_attention_tpu/parallel/layouts.py``: a layout
is a permutation of the global sequence such that plain contiguous
sharding over the ring hands every rank its schedule-local shard, plus the
global position descriptor of each rank's tokens. Pure index math, equal to
the JAX package's (W = ring size, S = global seq, c = S / W per rank):

* ``basic``  -- rank r owns ``[r*c, (r+1)*c)``; one chunk at ``r*c``.
* ``zigzag`` -- 2W half-chunks; rank r owns halves ``r`` and ``2W-1-r``,
  balancing causal work.
* ``stripe`` -- rank r owns tokens ``r, r+W, r+2W, ...``; offset ``r``,
  stride ``W``.

``bidir_position_descriptor`` describes the bidirectional ring's two K/V
halves, ``segment_ids_from_cu_seqlens`` turns a varlen ``cu_seqlens`` into
segment ids.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "LAYOUTS",
    "layout_permutation",
    "permute_for_layout",
    "unpermute_from_layout",
    "extract_local",
    "position_descriptor",
    "bidir_position_descriptor",
    "positions_from_descriptor",
    "segment_ids_from_cu_seqlens",
]

LAYOUTS = ("basic", "zigzag", "stripe")


def _check(layout: str, ring_size: int, seq: int) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected one of {LAYOUTS}")
    if seq % ring_size:
        raise ValueError(f"seq {seq} not divisible by ring size {ring_size}")
    if layout == "zigzag" and seq % (2 * ring_size):
        raise ValueError(f"zigzag needs seq {seq} divisible by 2*ring ({2 * ring_size})")


def layout_permutation(layout: str, ring_size: int, seq: int) -> np.ndarray:
    """int32 permutation p with ``permuted[i] = global[p[i]]``; contiguous
    chunk r (of size seq // ring_size) of the permuted sequence is ring rank
    r's schedule-local shard."""
    _check(layout, ring_size, seq)
    if layout == "basic":
        return np.arange(seq, dtype=np.int32)
    if layout == "zigzag":
        half = seq // (2 * ring_size)
        parts = []
        for r in range(ring_size):
            parts.append(np.arange(r * half, (r + 1) * half, dtype=np.int32))
            parts.append(np.arange((2 * ring_size - 1 - r) * half,
                                   (2 * ring_size - r) * half, dtype=np.int32))
        return np.concatenate(parts)
    return np.concatenate(
        [np.arange(r, seq, ring_size, dtype=np.int32) for r in range(ring_size)]
    )


def _take(x: torch.Tensor, index: np.ndarray, axis: int) -> torch.Tensor:
    return torch.index_select(x, axis, torch.from_numpy(
        index.astype(np.int64)).to(x.device))


def permute_for_layout(x: torch.Tensor, layout: str, ring_size: int,
                       axis: int = 1) -> torch.Tensor:
    """Reorder the global sequence so contiguous ring sharding yields the
    layout."""
    if layout == "basic":
        return x
    return _take(x, layout_permutation(layout, ring_size, x.shape[axis]),
                 axis)


def unpermute_from_layout(x: torch.Tensor, layout: str, ring_size: int,
                          axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`permute_for_layout`."""
    if layout == "basic":
        return x
    perm = layout_permutation(layout, ring_size, x.shape[axis])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return _take(x, inv, axis)


def extract_local(x: torch.Tensor, rank: int, ring_size: int,
                  layout: str = "basic", axis: int = 1) -> torch.Tensor:
    """Rank ``rank``'s schedule-local shard of a global tensor."""
    seq = x.shape[axis]
    _check(layout, ring_size, seq)
    local = seq // ring_size
    perm = layout_permutation(layout, ring_size, seq)
    return _take(x, perm[rank * local:(rank + 1) * local], axis)


def position_descriptor(layout: str, rank: int, ring_size: int,
                        local_len: int) -> Tuple[torch.Tensor, int]:
    """Global positions of ring rank ``rank``'s tokens as ``(offsets int32,
    stride)``: the token at local index l sits at ``offsets[l // chunk] +
    (l % chunk) * stride`` with ``chunk = local_len // len(offsets)``."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected one of {LAYOUTS}")
    rank = int(rank)
    if layout == "basic":
        return torch.tensor([rank * local_len], dtype=torch.int32), 1
    if layout == "zigzag":
        half = local_len // 2
        return torch.tensor([rank * half, (2 * ring_size - 1 - rank) * half],
                            dtype=torch.int32), 1
    return torch.tensor([rank], dtype=torch.int32), ring_size


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


def bidir_position_descriptor(layout: str, src_a: int, src_b: int,
                              ring_size: int, local_len: int
                              ) -> Tuple[torch.Tensor, int]:
    """Positions of a rank's K/V when it is split in two halves that travel
    opposite ring directions: half A (local [0, local_len / 2)) is ring rank
    ``src_a``'s, half B rank ``src_b``'s. Returns a two-chunk ``(offsets
    int32, stride)`` in the kernels' contract."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    src_a, src_b = int(src_a), int(src_b)
    half = local_len // 2
    if layout == "basic":
        offs = [src_a * local_len, src_b * local_len + half]
        stride = 1
    elif layout == "zigzag":
        offs = [src_a * half, (2 * ring_size - 1 - src_b) * half]
        stride = 1
    else:
        offs = [src_a, src_b + half * ring_size]
        stride = ring_size
    return torch.tensor(offs, dtype=torch.int32), stride


def segment_ids_from_cu_seqlens(cu_seqlens, seq_len: int) -> torch.Tensor:
    """The varlen ``cu_seqlens`` (cumulative boundaries of a packed
    batch-of-one stream) as per-token segment ids (1, seq_len) int32:
    sequence i (``cu_seqlens[i] <= t < cu_seqlens[i+1]``) gets id i + 1;
    tokens at or past ``cu_seqlens[-1]`` are padding with id 0."""
    cu = torch.as_tensor(cu_seqlens, dtype=torch.int32).reshape(-1)
    t = torch.arange(seq_len, dtype=torch.int32)
    ids = torch.searchsorted(cu, t, right=True).to(torch.int32)
    ids = torch.where((t >= cu[-1]) | (ids == 0), torch.zeros_like(ids), ids)
    return ids[None]
