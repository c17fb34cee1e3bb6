"""8-neighbour shifted-view stencil primitives (plain PyTorch).

Counterpart of :mod:`richdem_tpu.ops.stencil`: ``neighbor(x, d, fill)``
gives each cell the value of its direction-``d`` neighbour (package
encoding, 1 = W counter-clockwise), with ``fill`` off-grid;
``all_neighbors`` stacks the eight views and ``neighbor_distances`` gives
the eight step lengths.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from richdem_tpu_torch import topology

__all__ = ["as_tensor", "neighbor", "all_neighbors", "neighbor_distances",
           "nodata_like"]


def as_tensor(x, device="cuda") -> torch.Tensor:
    """``x`` itself if it is a tensor (work runs where a tensor lives),
    else ``x`` as a tensor on ``device``.  Entry points default to the
    card; asking for ``"cuda"`` without one raises, as torch does."""
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(np.asarray(x), device=device)


def neighbor(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """Value of each cell's neighbour in direction ``d`` (1..8) over the
    last two axes; off-grid positions read ``fill``."""
    dy, dx = int(topology.DY[d]), int(topology.DX[d])
    h, w = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (1, 1, 1, 1), value=float(fill))
    return xp[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def all_neighbors(x: torch.Tensor, fill) -> torch.Tensor:
    """Stack of the 8 neighbour views, shape (8, ..., H, W), index k =
    d - 1."""
    return torch.stack([neighbor(x, d, fill) for d in range(1, 9)])


def neighbor_distances(cellsize=1.0, dtype=torch.float32,
                       device="cuda") -> torch.Tensor:
    """(8,) distances to each neighbour (1 or sqrt(2), times
    ``cellsize``), on ``device``."""
    return torch.as_tensor(np.asarray(topology.DR[1:9]) * float(cellsize),
                           dtype=dtype, device=device)


def nodata_like(z: torch.Tensor, no_data) -> torch.Tensor:
    """Boolean nodata mask from a scalar ``no_data`` (None -> all False;
    NaN -> ``isnan``; otherwise equality after casting to ``z``'s dtype)."""
    if no_data is None:
        return torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    if isinstance(no_data, float) and math.isnan(no_data):
        return torch.isnan(z)
    return z == torch.tensor(no_data, dtype=z.dtype, device=z.device)
