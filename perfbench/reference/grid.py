"""The D8 neighbourhood the reference works on, written out from RichDEM's
convention: direction 0 is the cell itself (no flow), 1..8 run
counter-clockwise from West::

    2 3 4        NW N NE
    1 . 5   ==    W .  E
    8 7 6        SW S SE

Row indices grow southward, column indices eastward.  Ties between
directions go to the first in the order 1..8.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: Column and row offsets of directions 0..8.
DX = (0, -1, -1, 0, 1, 1, 1, 0, -1)
DY = (0, 0, -1, -1, -1, 0, 1, 1, 1)
#: Step length of directions 0..8 in cell sizes.
DR = (0.0, 1.0, math.sqrt(2.0), 1.0, math.sqrt(2.0), 1.0, math.sqrt(2.0),
      1.0, math.sqrt(2.0))
DIRECTIONS = range(1, 9)
#: The flow code of a nodata cell.
NODATA_CODE = -1


def shift(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """Each cell's direction-``d`` neighbour over the last two axes;
    off-grid positions read ``fill``."""
    dy, dx = DY[d], DX[d]
    h, w = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (1, 1, 1, 1), value=float(fill))
    return xp[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def toward(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """At each cell, the value of the cell whose direction-``d`` neighbour
    it is (``shift`` by the inverse direction): what a field sent along
    ``d`` delivers."""
    inverse = 1 + (d + 3) % 8
    return shift(x, inverse, fill)
