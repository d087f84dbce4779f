"""The USP process-group mesh: dp x ring x ulysses ranks on torch.distributed.

Counterpart of ``long_context_attention_tpu/parallel/mesh.py``. The JAX
package describes the topology with one ``jax.sharding.Mesh`` whose named
axes XLA turns into collectives; here, as in the reference's
``set_seq_parallel_pg`` (``yunchang/globals.py:22-81``), every rank builds
the ring and ulysses process groups of the whole grid in the same order
and keeps its own. The grid is the JAX package's device grid for an
explicit device list, with rank i in the place of device i:

* ``ulysses_low=True`` (the default): ranks ``reshape(dp, ring, ulysses)``,
  so a ulysses group holds consecutive ranks (the best-connected GPUs carry
  the all-to-all);
* ``ulysses_low=False``: ``reshape(dp, ulysses, ring)`` with the two axes
  swapped, so a ring group holds consecutive ranks.

A rank's sequence chunk is ``ring_idx * ulysses + ulysses_idx``, the
ring-major order of ``MeshAxes.seq``; its batch chunk is ``dp_idx``. The
sequence group holds the ring x ulysses ranks of a dp replica in that
order (a rank's place in it is its sequence chunk): the sharded serving
path (``serving/sharded.py``) gathers its decode partials over it. NCCL
serves the card (``device=None``), gloo the CPU (``device="cpu"``). Tensor,
pipeline and expert parallel degrees above 1 are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from long_context_attention_tpu_torch.utils.config import (
    not_ported,
    resolve_device,
)

__all__ = ["MeshAxes", "UspMesh", "SEQ_AXES", "make_usp_mesh",
           "usp_rank_grid", "seq_shard", "seq_unshard"]


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Axis names of a USP mesh (the JAX package's), kept for API parity."""

    dp: str = "dp"
    ring: str = "ring"
    ulysses: str = "ulysses"
    tp: str = "tp"
    pp: str = "pp"
    ep: str = "ep"

    @property
    def seq(self):
        """The sequence is sharded over (ring, ulysses), ring-major."""
        return (self.ring, self.ulysses)


SEQ_AXES = MeshAxes().seq


def usp_rank_grid(dp: int, ulysses: int, ring: int, *,
                  ulysses_low: bool = True) -> np.ndarray:
    """(dp, ring, ulysses) int array of global ranks: the JAX package's
    ``make_usp_mesh(devices=...)`` grid with rank i for device i."""
    ranks = np.arange(dp * ulysses * ring)
    if ulysses_low:
        return ranks.reshape(dp, ring, ulysses)
    return ranks.reshape(dp, ulysses, ring).swapaxes(1, 2)


@dataclasses.dataclass(frozen=True, eq=False)
class UspMesh:
    """This rank's place in the USP grid and its process groups.

    ``ring_group``, ``ulysses_group`` and ``seq_group`` (the ring x
    ulysses ranks of this dp replica, ring-major: this rank's place is
    :attr:`seq_idx`) are None when their degree is 1 (the collectives are
    then the identity and never run)."""

    dp: int
    ulysses: int
    ring: int
    ulysses_low: bool
    device: torch.device
    grid: np.ndarray
    rank: int
    dp_idx: int
    ring_idx: int
    ulysses_idx: int
    ring_group: Optional[dist.ProcessGroup]
    ulysses_group: Optional[dist.ProcessGroup]
    ring_ranks: Tuple[int, ...]
    ulysses_ranks: Tuple[int, ...]
    seq_group: Optional[dist.ProcessGroup] = None
    seq_ranks: Tuple[int, ...] = ()
    axes: MeshAxes = MeshAxes()

    @property
    def n_seq(self) -> int:
        """The sequence shards: ``ring * ulysses``."""
        return self.ring * self.ulysses

    @property
    def seq_idx(self) -> int:
        """This rank's sequence chunk: ``ring_idx * ulysses + ulysses_idx``."""
        return self.ring_idx * self.ulysses + self.ulysses_idx

    @property
    def ring_next(self) -> int:
        """Global rank of the next ring neighbour (K/V go there)."""
        return self.ring_ranks[(self.ring_idx + 1) % self.ring]

    @property
    def ring_prev(self) -> int:
        """Global rank of the previous ring neighbour (K/V come from it)."""
        return self.ring_ranks[(self.ring_idx - 1) % self.ring]


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_usp_mesh(dp: int = 1, ulysses: int = 1, ring: int = 1, tp: int = 1,
                  pp: int = 1, ep: int = 1, *, ulysses_low: bool = True,
                  device=None, axes: MeshAxes = MeshAxes()) -> UspMesh:
    """Build this rank's USP mesh over ``dp * ulysses * ring`` ranks.

    ``device=None`` is the card (NCCL; ``RuntimeError`` without CUDA),
    ``device="cpu"`` gloo. A world of one is initialised here (an in-memory
    store, no network); a larger one must be initialised by the caller
    (``torch.distributed.init_process_group`` with its address, world size
    and rank), with a world size equal to the mesh's. Every rank must call
    this with the same arguments: the process groups of the whole grid are
    built in one order on all of them."""
    if tp > 1 or pp > 1 or ep > 1:
        raise not_ported("tensor, pipeline and expert parallel mesh axes "
                         f"(tp={tp}, pp={pp}, ep={ep})")
    dev = resolve_device(device)
    n = dp * ulysses * ring
    backend = _backend(dev)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"torch.distributed is not initialised: a mesh of {n} ranks "
                f"needs init_process_group(world_size={n}) on every rank "
                f"first")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != n:
        raise ValueError(f"the mesh needs {n} ranks (dp={dp} x ring={ring} x "
                         f"ulysses={ulysses}), the world has "
                         f"{dist.get_world_size()}")
    if backend not in str(dist.get_backend()):
        raise ValueError(f"a mesh on {dev} needs the {backend} backend, the "
                         f"world runs {dist.get_backend()}")
    grid = usp_rank_grid(dp, ulysses, ring, ulysses_low=ulysses_low)
    rank = dist.get_rank()
    i_dp, i_ring, i_uly = (int(x) for x in np.argwhere(grid == rank)[0])
    ring_group = uly_group = None
    # every rank creates every group, in the same order
    if ring > 1:
        for a in range(dp):
            for u in range(ulysses):
                g = dist.new_group([int(r) for r in grid[a, :, u]])
                if (a, u) == (i_dp, i_uly):
                    ring_group = g
    if ulysses > 1:
        for a in range(dp):
            for r in range(ring):
                g = dist.new_group([int(x) for x in grid[a, r, :]])
                if (a, r) == (i_dp, i_ring):
                    uly_group = g
    seq_group = None
    if ring * ulysses > 1:
        for a in range(dp):
            g = dist.new_group([int(x) for x in grid[a].reshape(-1)])
            if a == i_dp:
                seq_group = g
    return UspMesh(dp=dp, ulysses=ulysses, ring=ring, ulysses_low=ulysses_low,
                   device=dev, grid=grid, rank=rank, dp_idx=i_dp,
                   ring_idx=i_ring, ulysses_idx=i_uly, ring_group=ring_group,
                   ulysses_group=uly_group,
                   ring_ranks=tuple(int(r) for r in grid[i_dp, :, i_uly]),
                   ulysses_ranks=tuple(int(r) for r in grid[i_dp, i_ring, :]),
                   seq_group=seq_group,
                   seq_ranks=tuple(int(r) for r in grid[i_dp].reshape(-1)),
                   axes=axes)


def seq_shard(mesh: UspMesh, x: torch.Tensor, *, batch_axis: int = 0,
              seq_axis: int = 1) -> torch.Tensor:
    """This rank's shard of a global (b, s, ...) tensor: batch chunk
    ``dp_idx`` of ``dp``, sequence chunk ``seq_idx`` of ``ring *
    ulysses`` (the JAX package's ``seq_sharding``)."""
    x = x.chunk(mesh.dp, dim=batch_axis)[mesh.dp_idx]
    return x.chunk(mesh.ring * mesh.ulysses, dim=seq_axis)[mesh.seq_idx]


def seq_unshard(mesh: UspMesh, x: torch.Tensor, *, batch_axis: int = 0,
                seq_axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`seq_shard`: every rank's shard gathered (over the
    whole world) into the global tensor, on every rank."""
    n = mesh.dp * mesh.ring * mesh.ulysses
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous())
    rows = []
    for a in range(mesh.dp):
        chunks = [None] * (mesh.ring * mesh.ulysses)
        for r in range(mesh.ring):
            for u in range(mesh.ulysses):
                chunks[r * mesh.ulysses + u] = parts[int(mesh.grid[a, r, u])]
        rows.append(torch.cat(chunks, dim=seq_axis))
    return torch.cat(rows, dim=batch_axis)
