"""Derived hydrological indices (plain PyTorch).

Counterpart of ``richdem_tpu.methods.twi`` and ``spi``.
"""

from __future__ import annotations

import torch

__all__ = ["twi", "spi"]


def twi(accum, slope_radians, cellsize=1.0, min_slope=1e-6):
    """Topographic wetness index ``ln(a / tan beta)``; ``a`` = specific
    catchment area = accumulation × cellsize."""
    a = accum * cellsize
    tanb = torch.clamp(torch.tan(slope_radians), min=min_slope)
    return torch.log(torch.clamp(a, min=1e-30) / tanb)


def spi(accum, slope_radians, cellsize=1.0):
    """Stream power index ``a · tan beta``; ``a`` = accumulation ×
    cellsize."""
    return accum * cellsize * torch.tan(slope_radians)
