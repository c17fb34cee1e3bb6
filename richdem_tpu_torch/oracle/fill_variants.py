"""Alternative depression-fill engines (Zhou 2016 / Wei 2018 rows).

The reference ships three serial fills that produce IDENTICAL output —
``Barnes2014.hpp``, ``Zhou2016.hpp``, ``Wei2018.hpp`` (SURVEY.md §2.2) —
and uses their agreement as its cross-validation backbone (SURVEY.md §4
item 1).  This module fills those inventory rows with two engines whose
*algorithmic strategies* follow the cited papers — region growing
instead of per-cell heap churn (Zhou, Sun & Fu 2016), and a two-stage
scan-then-finish structure (Wei, Zhou & Fu 2018) — written clean-room
from the strategies alone (the reference mount is empty; SURVEY.md
provenance).  Their value here is exactly the reference's: three
structurally different routes to the same unique fixpoint
``W = max(Z, min_nbr(W))`` (appendix A.2), compared cell-for-cell in
tests/test_oracle_fill.py.
"""

from __future__ import annotations

import heapq
from collections import deque

import numpy as np

from richdem_tpu_torch.topology import DX, DY
from richdem_tpu_torch.oracle.fill import _nodata_mask, _seed_cells

__all__ = ["zhou_fill", "wei_fill"]


def zhou_fill(dem, no_data=None, dtype=np.float64):
    """Region-growing fill (Zhou 2016 strategy).

    One heap entry per *region spill*, not per cell: when a cell pops at
    spill level ``s``, the whole connected region of unvisited cells at
    or below ``s`` is flooded to ``s`` by plain BFS — depression
    interiors never touch the heap.  Output equals
    :func:`richdem_tpu_torch.oracle.fill.priority_flood_fill` exactly.
    """
    z = np.asarray(dem, dtype=dtype).copy()
    nodata = _nodata_mask(z, no_data)
    h, w = z.shape
    visited = nodata.copy()
    seeds = _seed_cells(nodata) & ~nodata

    heap = []
    k = 0
    for r, c in zip(*np.nonzero(seeds)):
        heapq.heappush(heap, (z[r, c], k, int(r), int(c)))
        k += 1
        visited[r, c] = True

    bfs = deque()
    while heap:
        s, _, r, c = heapq.heappop(heap)
        # grow the ≤ s region from here without the heap
        bfs.append((r, c))
        while bfs:
            cr, cc = bfs.popleft()
            for d in range(1, 9):
                nr, nc = cr + int(DY[d]), cc + int(DX[d])
                if not (0 <= nr < h and 0 <= nc < w):
                    continue
                if visited[nr, nc]:
                    continue
                visited[nr, nc] = True
                if z[nr, nc] <= s:
                    z[nr, nc] = s          # in-region: fill, keep growing
                    bfs.append((nr, nc))
                else:
                    heapq.heappush(heap, (z[nr, nc], k, nr, nc))
                    k += 1
    if no_data is not None:
        z[nodata] = no_data
    return z


def wei_fill(dem, no_data=None, dtype=np.float64, max_scan_passes=64):
    """Two-stage fill (Wei 2018 strategy).

    Stage 1: cheap directional scans — alternating raster passes relax
    ``W ← max(Z, min_nbr(W))`` against already-scanned neighbors
    (Planchon–Darboux flavor), which settles the vast slope majority of
    cells in a few passes without any queue.  Stage 2: the few cells the
    scans left unsettled (interiors of nested depressions) are finished
    exactly with a Priority-Flood restricted to the unsettled region,
    seeded by its settled boundary.  Output equals
    :func:`richdem_tpu_torch.oracle.fill.priority_flood_fill` exactly.
    """
    z = np.asarray(dem, dtype=dtype)
    nodata = _nodata_mask(z, no_data)
    h, w = z.shape
    big = np.float64(np.finfo(np.float64).max / 4)
    seeds = _seed_cells(nodata) & ~nodata
    wsurf = np.where(seeds | nodata, np.where(nodata, -big, z), big)

    # ---- stage 1: alternating directional scans (no queue)
    scan_orders = [
        (range(h), range(w)),                       # NW→SE
        (range(h - 1, -1, -1), range(w - 1, -1, -1)),  # SE→NW
        (range(h), range(w - 1, -1, -1)),           # NE→SW
        (range(h - 1, -1, -1), range(w)),           # SW→NE
    ]
    for p in range(max_scan_passes):
        changed = False
        rows, cols = scan_orders[p % 4]
        for r in rows:
            for c in cols:
                if nodata[r, c] or seeds[r, c]:
                    continue
                m = big
                for d in range(1, 9):
                    nr, nc = r + int(DY[d]), c + int(DX[d])
                    if 0 <= nr < h and 0 <= nc < w:
                        if wsurf[nr, nc] < m:
                            m = wsurf[nr, nc]
                    else:
                        m = -big  # off-grid drains (border safety)
                new = max(z[r, c], m)
                if new < wsurf[r, c]:
                    wsurf[r, c] = new
                    changed = True
        if not changed and p >= 1:
            break
        if p == 3:
            break  # hand the long tail to stage 2

    # ---- stage 2: exact Priority-Flood finish on the raised residue.
    # Cells the scans left at W == z are PROVABLY final (W ≥ true ≥ z
    # everywhere, so W == z pins true == z); the fixpoint equation alone
    # would not be a safe test — a locally-consistent elevated plateau
    # satisfies it while being wrong.  Everything the scans raised above
    # z (depression interiors, typically a few %) is re-derived exactly
    # by a Priority-Flood seeded from its settled boundary.
    suspect = (~nodata) & (~seeds) & (wsurf > z)
    if suspect.any():
        visited = ~suspect  # settled cells + seeds + nodata = boundary
        heap = []
        k = 0
        pushed = np.zeros((h, w), bool)
        for r, c in zip(*np.nonzero(suspect)):
            for d in range(1, 9):
                nr, nc = int(r) + int(DY[d]), int(c) + int(DX[d])
                if (0 <= nr < h and 0 <= nc < w and visited[nr, nc]
                        and not nodata[nr, nc] and not pushed[nr, nc]):
                    heapq.heappush(heap, (wsurf[nr, nc], k, nr, nc))
                    pushed[nr, nc] = True
                    k += 1
        while heap:
            s, _, r, c = heapq.heappop(heap)
            for d in range(1, 9):
                nr, nc = r + int(DY[d]), c + int(DX[d])
                if not (0 <= nr < h and 0 <= nc < w):
                    continue
                if visited[nr, nc]:
                    continue
                visited[nr, nc] = True
                wsurf[nr, nc] = max(z[nr, nc], s)
                heapq.heappush(heap, (wsurf[nr, nc], k, nr, nc))
                k += 1
    out = np.where(nodata, z, wsurf)
    if no_data is not None:
        out[nodata] = no_data
    return out
