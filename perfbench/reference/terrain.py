"""Slope and the topographic wetness index, worked out by the reference.

Slope is Horn (1981): with the 3×3 window ``a b c / d e f / g h i``, where
an off-grid or nodata neighbour reads the centre,

    fx = ((c + 2f + i) - (a + 2d + g)) / (8 L)
    fy = ((g + 2h + i) - (a + 2b + c)) / (8 L)
    slope = atan(hypot(fx, fy))          (radians; NaN at nodata)

and TWI is ``ln(max(A·L, 1e-30) / max(tan(slope), 1e-6))``, ``A`` the
accumulation and ``L`` the cell size.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.grid import shift

#: The least ``tan(slope)`` TWI divides by.
MIN_SLOPE = 1e-6


def slope_radians(filled: torch.Tensor, nodata: torch.Tensor, cellsize=1.0,
                  dtype=torch.float32) -> torch.Tensor:
    """Horn slope of ``filled`` in radians, computed in ``dtype``."""
    dev = filled.device
    z = filled.to(dtype)
    nan = torch.tensor(math.nan, dtype=dtype, device=dev)
    zed = torch.where(nodata, nan, z)

    def nb(d):
        v = shift(zed, d, math.nan)
        return torch.where(torch.isnan(v), z, v)

    a, b, c, d, f, g, h, i = (nb(2), nb(3), nb(4), nb(1), nb(5), nb(8),
                              nb(7), nb(6))
    eight_l = 8 * torch.tensor(cellsize, dtype=dtype, device=dev)
    fx = ((c + 2 * f + i) - (a + 2 * d + g)) / eight_l
    fy = ((g + 2 * h + i) - (a + 2 * b + c)) / eight_l
    return torch.where(nodata, nan, torch.atan(torch.hypot(fx, fy)))


def twi(accum: torch.Tensor, slope: torch.Tensor, cellsize=1.0,
        dtype=torch.float32) -> torch.Tensor:
    """Topographic wetness index, computed in ``dtype``."""
    a = accum.to(dtype) * cellsize
    tanb = torch.clamp(torch.tan(slope.to(dtype)), min=MIN_SLOPE)
    return torch.log(torch.clamp(a, min=1e-30) / tanb)
