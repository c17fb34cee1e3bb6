"""Device mesh for spatial domain decomposition.

Counterpart of ``richdem_tpu.parallel.mesh``.  The DEM grid is split over a
2-D ``(ny, nx)`` mesh of positions, each owning one contiguous block, the
reference's rectangular tile grid [P1].  A position names a
``torch.device``, and a device may repeat: four positions on ``cuda:0``,
or eight on the CPU, as the JAX tests get eight virtual CPU devices.

Across processes (a ``torch.distributed`` default group), each rank gives
its own devices, every rank the same number, and owns a row-major block of
positions: two ranks of four devices make a 2×4 mesh whose first row is
rank 0's.  Halos then travel through the group
(:mod:`richdem_tpu_torch.parallel.halo`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["make_mesh", "grid_sharding", "best_factorization", "Mesh",
           "GridSharding", "Shard", "ShardedArray"]


def best_factorization(n: int) -> tuple:
    """Split n devices into the most-square (ny, nx) grid."""
    best = (1, n)
    for ny in range(1, int(math.isqrt(n)) + 1):
        if n % ny == 0:
            best = (ny, n // ny)
    return best


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(ny, nx)`` grid of positions.

    ``devices``: the device of each position (an object array; a remote
    rank's positions hold that rank's device names); ``owners``: the rank
    that owns each position; ``group``: the ``torch.distributed`` group
    the halos travel through, None when this process owns every position
    and no group is set up; ``rank``: this process's rank in it."""

    devices: np.ndarray
    owners: np.ndarray
    group: object = None
    rank: int = 0

    @property
    def shape(self) -> tuple:
        return self.devices.shape

    @property
    def local_positions(self) -> list:
        """This rank's positions ``(ri, ci)``, row-major."""
        return [tuple(int(i) for i in p)
                for p in np.argwhere(self.owners == self.rank)]

    @property
    def single_process(self) -> bool:
        """Whether this process owns every position."""
        return bool((self.owners == self.rank).all())

    def device(self, pos) -> torch.device:
        return self.devices[pos]


def make_mesh(devices=None, shape=None) -> Mesh:
    """A 2-D ``(ny, nx)`` mesh over the given devices (default: every CUDA
    device).  A device may repeat.  Under a ``torch.distributed`` default
    group every rank passes its own devices, the same number each, and the
    mesh spans them all."""
    import torch.distributed as dist

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "(for example [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    local = [torch.device(d) for d in devices]
    group, rank, names = None, 0, [[str(d) for d in local]]
    if dist.is_available() and dist.is_initialized():
        group, rank = dist.group.WORLD, dist.get_rank()
        names = [None] * dist.get_world_size()
        dist.all_gather_object(names, [str(d) for d in local])
        if len({len(n) for n in names}) != 1:
            raise ValueError("make_mesh: every rank must give the same "
                             "number of devices, got "
                             f"{[len(n) for n in names]}")
    flat = [torch.device(d) for n in names for d in n]
    if shape is None:
        shape = best_factorization(len(flat))
    ny, nx = shape
    if ny * nx != len(flat):
        raise ValueError(f"mesh shape {shape} != {len(flat)} devices")
    arr = np.empty(len(flat), dtype=object)
    arr[:] = flat
    owners = np.arange(len(flat)).reshape(ny, nx) // len(local)
    return Mesh(arr.reshape(ny, nx), owners, group, rank)


@dataclasses.dataclass(frozen=True)
class Shard:
    """One block of a :class:`ShardedArray`: its data and its global
    slices (the counterpart of a ``jax.Array`` shard)."""

    data: torch.Tensor
    index: tuple


@dataclasses.dataclass(frozen=True)
class ShardedArray:
    """A raster spread over the processes of a mesh: its global ``shape``
    and the blocks this process holds (``addressable_shards``)."""

    shape: tuple
    addressable_shards: list


@dataclasses.dataclass(frozen=True)
class GridSharding:
    """How an ``(H, W)`` raster (or a stack ``(..., H, W)``) divisible by
    the mesh splits into the mesh's blocks, the counterpart of the
    reference's ``NamedSharding(mesh, P("y", "x"))``."""

    mesh: Mesh

    def tiling(self, shape) -> tuple:
        """``(rows, cols)``: the ``(start, stop)`` ranges of the blocks."""
        h, w = shape[-2:]
        ny, nx = self.mesh.shape
        if h % ny or w % nx:
            raise ValueError(f"raster {tuple(shape)} does not divide over "
                             f"the {ny}x{nx} mesh")
        th, tw = h // ny, w // nx
        return ([(i * th, (i + 1) * th) for i in range(ny)],
                [(j * tw, (j + 1) * tw) for j in range(nx)])

    def index(self, shape, pos) -> tuple:
        """The global ``(rows, cols)`` slices of position ``pos``."""
        rows, cols = self.tiling(shape)
        return slice(*rows[pos[0]]), slice(*cols[pos[1]])

    def split(self, x) -> dict:
        """``{pos: block}`` for this rank's positions, each block a
        contiguous copy on its position's device."""
        return {p: x[(...,) + self.index(x.shape, p)].to(
                    self.mesh.device(p)).contiguous()
                for p in self.mesh.local_positions}


def grid_sharding(mesh: Mesh) -> GridSharding:
    """Sharding that tiles an (H, W) raster over the mesh."""
    return GridSharding(mesh)
