"""D8 grid topology: THE direction-encoding convention of the port.

The port's own copy of ``richdem_tpu/topology.py`` (numpy only), so that
the port imports nothing of the JAX package; ``tests/test_torch_copies.py``
holds the two copies' tables equal.  This module pins the neighbor ordering
once; every plain version, every CUDA kernel wrapper and every test of the
port must import these tables rather than re-deriving offsets.

Convention (matches the RichDEM constant tables described in SURVEY.md §2.1,
``include/richdem/common/constants.hpp`` in the reference layout):

* Direction ``0`` is the cell itself / ``NO_FLOW``.
* Directions ``1..8`` enumerate the 8 neighbors counter-clockwise starting
  from West::

      2 3 4        NW N NE
      1 . 5   ==    W .  E
      8 7 6        SW S SE

* ``x`` is the column index (increases rightwards/East), ``y`` is the row
  index (increases downwards/South).  So the neighbor of cell ``(row, col)``
  in direction ``d`` is ``(row + DY[d], col + DX[d])``.

Tie-breaking everywhere in the package is "first maximum in ascending
direction order 1..8"; this is part of the convention.
"""

from __future__ import annotations

import math
from enum import Enum

import numpy as np

# Neighbor offsets, direction 0 = self.
#       d:   0   1   2   3   4   5   6   7   8
#            .   W   NW  N   NE  E   SE  S   SW
DX = np.array([0, -1, -1, 0, 1, 1, 1, 0, -1], dtype=np.int8)
DY = np.array([0, 0, -1, -1, -1, 0, 1, 1, 1], dtype=np.int8)

#: Inverse direction: the direction pointing back from the neighbor to us.
D8_INVERSE = np.array([0, 5, 6, 7, 8, 1, 2, 3, 4], dtype=np.int8)

#: Distance to each neighbor in units of cell size (sqrt(2) on diagonals).
SQRT2 = math.sqrt(2.0)
DR = np.array([0.0, 1.0, SQRT2, 1.0, SQRT2, 1.0, SQRT2, 1.0, SQRT2])

#: Flow-direction value meaning "no flow leaves this cell".
NO_FLOW = np.int8(0)

#: Flow-direction value marking a nodata cell in a flow-direction raster.
FLOWDIR_NO_DATA = np.int8(-1)

#: Directions whose neighbor offsets are diagonal.
IS_DIAGONAL = np.array(
    [False, False, True, False, True, False, True, False, True]
)

#: D4 (von Neumann) directions within the D8 enumeration: W, N, E, S.
D4_DIRECTIONS = (1, 3, 5, 7)
D8_DIRECTIONS = (1, 2, 3, 4, 5, 6, 7, 8)

#: Angle of each direction measured counter-clockwise from East (radians),
#: in standard math orientation on the *grid* (y axis pointing down means
#: "North" = -y).  Used by D-infinity conversions.
DIRECTION_ANGLE = np.array(
    [
        np.nan,
        math.pi,  # 1 W
        3 * math.pi / 4,  # 2 NW
        math.pi / 2,  # 3 N
        math.pi / 4,  # 4 NE
        0.0,  # 5 E
        7 * math.pi / 4,  # 6 SE
        3 * math.pi / 2,  # 7 S
        5 * math.pi / 4,  # 8 SW
    ]
)


class Topology(Enum):
    """Neighbor connectivity, mirroring the reference's ``Topology`` enum."""

    D8 = "D8"
    D4 = "D4"

    @property
    def directions(self) -> tuple:
        return D8_DIRECTIONS if self is Topology.D8 else D4_DIRECTIONS


def neighbors(row: int, col: int, height: int, width: int,
              topology: Topology = Topology.D8):
    """Yield ``(direction, nrow, ncol)`` for in-bounds neighbors of a cell."""
    for d in topology.directions:
        nrow = row + int(DY[d])
        ncol = col + int(DX[d])
        if 0 <= nrow < height and 0 <= ncol < width:
            yield d, nrow, ncol


# -- Encoding converters --------------------------------------------------
#
# TauDEM numbers the 8 directions 1..8 counter-clockwise from EAST; this
# package (following the reference's constant tables, SURVEY.md §2.1)
# numbers them counter-clockwise from WEST.  Counterpart of the
# reference's ``rd_taudem_d8_to_richdem_d8`` app.

#: TauDEM code (1=E, 2=NE, …, 8=SE) → package code; 0 stays NO_FLOW.
TAUDEM_TO_RICHDEM = np.array([0, 5, 4, 3, 2, 1, 8, 7, 6], dtype=np.int8)
#: package code → TauDEM code (the map is an involution on 1..8).
RICHDEM_TO_TAUDEM = TAUDEM_TO_RICHDEM


def from_taudem_d8(flowdirs):
    """Convert a TauDEM D8 raster to package encoding (negatives kept as
    nodata markers)."""
    fd = np.asarray(flowdirs)
    out = np.where(fd >= 0, TAUDEM_TO_RICHDEM[np.clip(fd, 0, 8)],
                   fd).astype(np.int8)
    return out


def to_taudem_d8(flowdirs):
    """Convert a package D8 raster to TauDEM encoding."""
    return from_taudem_d8(flowdirs)  # involution
