"""The USP process-group mesh: dp x pp x ep x ring x ulysses x tp ranks on
torch.distributed.

Counterpart of ``long_context_attention_tpu/parallel/mesh.py``. The JAX
package describes the topology with one ``jax.sharding.Mesh`` whose named
axes XLA turns into collectives; here, as in the reference's
``set_seq_parallel_pg`` (``yunchang/globals.py:22-81``), every rank builds
the process groups of the whole grid in the same order and keeps its own.
The grid is the JAX package's device grid for an explicit device list,
``(dp[, pp][, ep], ring, ulysses[, tp])`` with an axis present only when its
degree is above 1, with rank i in the place of device i:

* ``ulysses_low=True`` (the default): ranks ``reshape(dp, pp, ep, ring,
  ulysses, tp)``, so a tp group holds consecutive ranks, then a ulysses
  group (the best-connected GPUs carry the all-reduces and the
  all-to-all);
* ``ulysses_low=False``: ``reshape(dp, pp, ep, ulysses, ring, tp)`` with
  the ring and ulysses axes swapped, so a ring group holds consecutive
  ranks (of one tp index).

A rank's sequence chunk is ``ring_idx * ulysses + ulysses_idx``, the
ring-major order of ``MeshAxes.seq``; its batch chunk is ``dp_idx``. The
ring, ulysses and sequence groups are taken within one (dp, pp, ep, tp)
index: the sequence group holds the ring x ulysses ranks of a replica in
ring-major order (a rank's place in it is its sequence chunk), and the
sharded serving path (``serving/sharded.py``) gathers its decode partials
over it. The tp, pp and ep groups hold the ranks that differ only in that
index; ``dp_group`` those that differ only in dp (ZeRO's reduce-scatter),
``data_group`` the dp x ring x ulysses ranks of one (pp, ep, tp) index
(the gradient sum every leaf takes) and ``loss_group`` the dp x ep x ring
x ulysses ranks of one (pp, tp) index (the loss's denominator). NCCL
serves the card (``device=None``), gloo the CPU (``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from long_context_attention_tpu_torch.utils.config import resolve_device

__all__ = ["MeshAxes", "UspMesh", "SEQ_AXES", "make_usp_mesh",
           "usp_rank_grid", "mesh_axis", "check_seq_mesh", "seq_shard",
           "seq_unshard"]


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


def _full_grid(dp: int, ulysses: int, ring: int, tp: int, pp: int,
               ep: int, ulysses_low: bool) -> np.ndarray:
    """(dp, pp, ep, ring, ulysses, tp) int array of global ranks, every
    axis kept whatever its degree."""
    ranks = np.arange(dp * pp * ep * ulysses * ring * tp)
    if ulysses_low:
        return ranks.reshape(dp, pp, ep, ring, ulysses, tp)
    return ranks.reshape(dp, pp, ep, ulysses, ring, tp).swapaxes(3, 4)


def usp_rank_grid(dp: int, ulysses: int, ring: int, tp: int = 1,
                  pp: int = 1, ep: int = 1, *,
                  ulysses_low: bool = True) -> np.ndarray:
    """``(dp[, pp][, ep], ring, ulysses[, tp])`` int array of global ranks:
    the JAX package's ``make_usp_mesh(devices=...)`` grid with rank i for
    device i (tp, pp and ep present only above degree 1)."""
    grid = _full_grid(dp, ulysses, ring, tp, pp, ep, ulysses_low)
    keep = (slice(None), slice(None) if pp > 1 else 0,
            slice(None) if ep > 1 else 0, slice(None), slice(None),
            slice(None) if tp > 1 else 0)
    return grid[keep]


@dataclasses.dataclass(frozen=True, eq=False)
class UspMesh:
    """This rank's place in the USP grid and its process groups.

    ``ring_group``, ``ulysses_group`` and ``seq_group`` (the ring x
    ulysses ranks of this (dp, pp, ep, tp) replica, ring-major: this rank's
    place is :attr:`seq_idx`) are None when their degree is 1 (the
    collectives are then the identity and never run); so are ``tp_group``,
    ``pp_group``, ``ep_group`` and ``dp_group``. ``data_group`` (dp x ring x
    ulysses) and ``loss_group`` (dp x ep x ring x ulysses) are the default
    group on a dp x ring x ulysses mesh of more than one rank.
    ``full_grid`` is :attr:`grid` with every axis kept, (dp, pp, ep, ring,
    ulysses, tp)."""

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
    tp: int = 1
    pp: int = 1
    ep: int = 1
    tp_idx: int = 0
    pp_idx: int = 0
    ep_idx: int = 0
    tp_group: Optional[dist.ProcessGroup] = None
    pp_group: Optional[dist.ProcessGroup] = None
    ep_group: Optional[dist.ProcessGroup] = None
    dp_group: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None
    loss_group: Optional[dist.ProcessGroup] = None
    pp_ranks: Tuple[int, ...] = ()
    full_grid: Optional[np.ndarray] = None

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

    @property
    def n_ranks(self) -> int:
        """Every rank of the mesh: dp x pp x ep x ring x ulysses x tp."""
        return self.dp * self.pp * self.ep * self.ring * self.ulysses * self.tp


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


# the (dp, pp, ep, ring, ulysses, tp) positions of each group's member axes
_GROUPS = (("ring", (3,)), ("ulysses", (4,)), ("seq", (3, 4)), ("tp", (5,)),
           ("pp", (1,)), ("ep", (2,)), ("dp", (0,)), ("data", (0, 3, 4)),
           ("loss", (0, 2, 3, 4)))


def _groups(full: np.ndarray, where: Tuple[int, ...], extra: bool):
    """Every group of the grid, built in one order on every rank: this
    rank's group of each kind (None when it has one rank). The tp, pp, ep,
    data and loss groups are built only on a mesh with a tp, pp or ep axis
    (``extra``); on a dp x ring x ulysses mesh the data and loss groups are
    the whole world."""
    out = {}
    for kind, axes in _GROUPS:
        if not extra and kind in ("tp", "pp", "ep", "data", "loss"):
            continue
        if int(np.prod([full.shape[a] for a in axes])) == 1:
            out[kind] = None
            continue
        rest = [a for a in range(6) if a not in axes]
        members = np.moveaxis(full, list(axes), list(range(6 - len(axes), 6)))
        members = members.reshape(-1, *[full.shape[a] for a in axes])
        mine = tuple(where[a] for a in rest)
        for i, idx in enumerate(np.ndindex(*[full.shape[a] for a in rest])):
            g = dist.new_group([int(r) for r in members[i].reshape(-1)])
            if idx == mine:
                out[kind] = g
    return out


def make_usp_mesh(dp: int = 1, ulysses: int = 1, ring: int = 1, tp: int = 1,
                  pp: int = 1, ep: int = 1, *, ulysses_low: bool = True,
                  device=None, axes: MeshAxes = MeshAxes()) -> UspMesh:
    """Build this rank's USP mesh over ``dp * pp * ep * ulysses * ring * tp``
    ranks.

    ``device=None`` is the card (NCCL; ``RuntimeError`` without CUDA),
    ``device="cpu"`` gloo. A world of one is initialised here (an in-memory
    store, no network); a larger one must be initialised by the caller
    (``torch.distributed.init_process_group`` with its address, world size
    and rank), with a world size equal to the mesh's. Every rank must call
    this with the same arguments: the process groups of the whole grid are
    built in one order on all of them."""
    dev = resolve_device(device)
    n = dp * pp * ep * ulysses * ring * tp
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
        raise ValueError(f"the mesh needs {n} ranks (dp={dp} x pp={pp} x "
                         f"ep={ep} x ring={ring} x ulysses={ulysses} x "
                         f"tp={tp}), the world has {dist.get_world_size()}")
    if backend not in str(dist.get_backend()):
        raise ValueError(f"a mesh on {dev} needs the {backend} backend, the "
                         f"world runs {dist.get_backend()}")
    full = _full_grid(dp, ulysses, ring, tp, pp, ep, ulysses_low)
    rank = dist.get_rank()
    where = tuple(int(x) for x in np.argwhere(full == rank)[0])
    i_dp, i_pp, i_ep, i_ring, i_uly, i_tp = where
    extra = tp > 1 or pp > 1 or ep > 1
    g = _groups(full, where, extra)
    if not extra:
        world = dist.group.WORLD if n > 1 else None
        g.update(data=world, loss=world)
    rep = full[i_dp, i_pp, i_ep, :, :, i_tp]  # this replica's (ring, ulysses)
    return UspMesh(dp=dp, ulysses=ulysses, ring=ring, ulysses_low=ulysses_low,
                   device=dev,
                   grid=usp_rank_grid(dp, ulysses, ring, tp, pp, ep,
                                      ulysses_low=ulysses_low),
                   rank=rank, dp_idx=i_dp, ring_idx=i_ring, ulysses_idx=i_uly,
                   ring_group=g["ring"], ulysses_group=g["ulysses"],
                   ring_ranks=tuple(int(r) for r in rep[:, i_uly]),
                   ulysses_ranks=tuple(int(r) for r in rep[i_ring, :]),
                   seq_group=g["seq"],
                   seq_ranks=tuple(int(r) for r in rep.reshape(-1)),
                   axes=axes, tp=tp, pp=pp, ep=ep, tp_idx=i_tp, pp_idx=i_pp,
                   ep_idx=i_ep, tp_group=g.get("tp"), pp_group=g.get("pp"),
                   ep_group=g.get("ep"), dp_group=g.get("dp"),
                   data_group=g["data"], loss_group=g["loss"],
                   pp_ranks=tuple(int(r) for r in
                                  full[i_dp, :, i_ep, i_ring, i_uly, i_tp]),
                   full_grid=full)


def mesh_axis(mesh: UspMesh, name: str
              ) -> Tuple[int, int, Optional[dist.ProcessGroup]]:
    """(degree, this rank's index, process group) of the mesh axis named
    ``name`` in ``mesh.axes``: how a JAX axis name resolves on this rank."""
    for key in ("dp", "pp", "ep", "ring", "ulysses", "tp"):
        if getattr(mesh.axes, key) == name:
            return (getattr(mesh, key), getattr(mesh, f"{key}_idx"),
                    getattr(mesh, f"{key}_group"))
    raise ValueError(f"the mesh has no axis named {name!r}")


def check_seq_mesh(mesh: Optional[UspMesh], what: str) -> None:
    """Raise ValueError unless ``mesh`` (None passes) is a dp x ring x
    ulysses mesh. ``what`` takes whole params and splits only the batch
    and the sequence: on a tp axis it would sum whole outputs over the tp
    ranks, on an ep axis hand each rank every expert."""
    if mesh is not None and (mesh.tp > 1 or mesh.pp > 1 or mesh.ep > 1):
        raise ValueError(f"{what} runs over dp x ring x ulysses meshes; "
                         f"this one has tp={mesh.tp}, pp={mesh.pp}, "
                         f"ep={mesh.ep}")


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
    whole world) into the global tensor, on every rank (from the ranks of
    this rank's pp, ep and tp index)."""
    n = mesh.n_ranks
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous())
    # the shards of this rank's (pp, ep, tp) index
    grid = mesh.full_grid[:, mesh.pp_idx, mesh.ep_idx, :, :, mesh.tp_idx]
    rows = []
    for a in range(mesh.dp):
        chunks = [None] * (mesh.ring * mesh.ulysses)
        for r in range(mesh.ring):
            for u in range(mesh.ulysses):
                chunks[r * mesh.ulysses + u] = parts[int(grid[a, r, u])]
        rows.append(torch.cat(chunks, dim=seq_axis))
    return torch.cat(rows, dim=batch_axis)
