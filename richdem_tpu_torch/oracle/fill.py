"""Serial Priority-Flood depression filling (oracle).

Implements the algorithm family of Barnes, Lehman & Mulla 2014
(arxiv 1511.04463; SURVEY.md appendix A.1): a min-heap flood inward from the
DEM edges.  Reference-layout counterpart:
``include/richdem/depressions/Barnes2014.hpp`` (``PriorityFlood_Barnes2014``,
``PriorityFloodEpsilon_Barnes2014``, ``PriorityFloodFlowdirs_Barnes2014``,
``PriorityFlood_Watersheds_Barnes2014``) per SURVEY.md §2.2.

Semantics used throughout this package:

* Seeds: every data cell on the raster border, plus every data cell
  8-adjacent to a nodata cell (nodata regions act as drains, exactly like
  the grid edge).
* Plain fill: popped cell ``c`` raises an unvisited neighbor ``n`` to
  ``max(z_n, z_c)``.  The result is the unique least fixpoint of
  ``W = max(Z, min_nbr(W))`` with ``W = Z`` on seeds (appendix A.2), which
  is what the device sweep kernels compute — so oracle and kernels agree to
  float tolerance by construction.
* Epsilon fill: neighbor raised to ``max(z_n, z_c + eps)`` with a *fixed*
  user epsilon.  (The reference chains ``nextafter`` calls; a fixed epsilon
  gives the same drainage structure with order-independent values — see
  SURVEY.md §7 "Hard parts" item 1.)
"""

from __future__ import annotations

import heapq

import numpy as np

from richdem_tpu_torch.topology import DX, DY, D8_INVERSE, NO_FLOW, FLOWDIR_NO_DATA

__all__ = [
    "priority_flood_fill",
    "priority_flood_epsilon",
    "priority_flood_flowdirs",
    "priority_flood_watersheds",
    "pit_mask",
]


def _nodata_mask(z: np.ndarray, no_data):
    if no_data is None:
        return np.zeros(z.shape, dtype=bool)
    if isinstance(no_data, float) and np.isnan(no_data):
        return np.isnan(z)
    return z == no_data


def _seed_cells(nodata: np.ndarray) -> np.ndarray:
    """Data cells on the border or 8-adjacent to nodata."""
    h, w = nodata.shape
    seeds = np.zeros((h, w), dtype=bool)
    seeds[0, :] = seeds[-1, :] = seeds[:, 0] = seeds[:, -1] = True
    # neighbors of nodata cells
    pad = np.pad(nodata, 1, constant_values=False)
    near_nd = np.zeros((h, w), dtype=bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            near_nd |= pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    seeds |= near_nd
    seeds &= ~nodata
    return seeds


def _flood(z, no_data, eps, want_flowdirs=False, want_labels=False):
    """Core Priority-Flood loop shared by all variants.

    Returns (filled, flowdirs or None, labels or None).
    """
    z = np.array(z, dtype=np.float64, copy=True)
    h, w = z.shape
    nodata = _nodata_mask(z, no_data)
    visited = nodata.copy()
    seeds = _seed_cells(nodata)

    flowdirs = None
    if want_flowdirs:
        flowdirs = np.full((h, w), FLOWDIR_NO_DATA, dtype=np.int8)
    labels = None
    if want_labels:
        labels = np.full((h, w), -1, dtype=np.int64)

    heap = []
    k = 0  # insertion order: stable tie-break, matching GridCellZk
    for r, c in zip(*np.nonzero(seeds)):
        heapq.heappush(heap, (z[r, c], k, int(r), int(c)))
        visited[r, c] = True
        if want_flowdirs:
            flowdirs[r, c] = NO_FLOW  # border cells drain off-grid
        if want_labels:
            labels[r, c] = k
        k += 1

    while heap:
        zc, _, r, c = heapq.heappop(heap)
        for d in range(1, 9):
            nr, nc = r + int(DY[d]), c + int(DX[d])
            if not (0 <= nr < h and 0 <= nc < w) or visited[nr, nc]:
                continue
            visited[nr, nc] = True
            zn = max(z[nr, nc], zc + eps)
            z[nr, nc] = zn
            if want_flowdirs:
                flowdirs[nr, nc] = D8_INVERSE[d]
            if want_labels:
                labels[nr, nc] = labels[r, c]
            heapq.heappush(heap, (zn, k, nr, nc))
            k += 1

    if no_data is not None:
        z[nodata] = no_data
    return z, flowdirs, labels


def priority_flood_fill(dem, no_data=None, dtype=None) -> np.ndarray:
    """Plain depression fill (``PriorityFlood_Barnes2014`` semantics)."""
    filled, _, _ = _flood(dem, no_data, eps=0.0)
    return filled.astype(dtype or np.asarray(dem).dtype)


def priority_flood_epsilon(dem, no_data=None, eps=1e-3,
                           dtype=None) -> np.ndarray:
    """Epsilon fill: filled regions get a strict drainage gradient."""
    filled, _, _ = _flood(dem, no_data, eps=eps)
    return filled.astype(dtype or np.asarray(dem).dtype)


def priority_flood_flowdirs(dem, no_data=None):
    """Fill + D8 flow directions assigned during the flood
    (``PriorityFloodFlowdirs_Barnes2014``).  Returns (filled, flowdirs).

    Every data cell gets a direction (no NO_FLOW pits remain; flats drain
    along the flood order, as in the reference variant)."""
    filled, flowdirs, _ = _flood(dem, no_data, eps=0.0, want_flowdirs=True)
    return filled.astype(np.asarray(dem).dtype), flowdirs


def priority_flood_watersheds(dem, no_data=None):
    """Fill + watershed labels (``PriorityFlood_Watersheds_Barnes2014``).

    Each cell is labeled with the seed cell that first reached it.  Labels
    are seed insertion indices; use ``np.unique`` for compaction.  Returns
    (filled, labels) with label ``-1`` on nodata cells."""
    filled, _, labels = _flood(dem, no_data, eps=0.0, want_labels=True)
    return filled.astype(np.asarray(dem).dtype), labels


def pit_mask(dem, no_data=None) -> np.ndarray:
    """Boolean mask of cells raised by depression filling (inside pits)."""
    z = np.asarray(dem, dtype=np.float64)
    filled, _, _ = _flood(dem, no_data, eps=0.0)
    mask = filled > z
    mask &= ~_nodata_mask(z, no_data)
    return mask
