"""Serial depression breaching (oracle): Lindsay 2016.

Counterpart of the reference's ``include/richdem/depressions/Lindsay2016.hpp``
(``BreachDepressions`` with modes COMPLETE/SELECTIVE/CONSTRAINED —
SURVEY.md §2.2).  Instead of raising pit interiors (filling), breaching
*carves* a descending channel from each pit bottom out to the drainage edge,
following the least-cost route discovered by a Priority-Flood traversal with
backlinks.

Pinned package semantics (the reference was unreadable — SURVEY.md
provenance; details follow Lindsay 2016's published description):

* A *pit* is a non-seed data cell with no strictly lower data neighbor.
* The flood pops cells cheapest-spill-first from the edge/nodata seeds,
  recording for every cell the direction it was first reached from
  (*backlink*).  When a pit cell is popped, the backlink chain from the pit
  to the already-drained region is walked, lowering every chain cell above
  the carve level to ``z_pit - k*eps`` (k = steps walked).
* ``mode='Complete'``: every pit is breached.  ``'Selective'``: pits whose
  breach path would exceed ``max_path_len`` or ``max_path_depth`` are left
  unbreached (fill them afterwards with ``fill_remainder``).
  ``'Constrained'``: the path is carved but no cell is lowered by more than
  ``max_path_depth``.
"""

from __future__ import annotations

import heapq

import numpy as np

from richdem_tpu_torch.topology import DX, DY, D8_INVERSE
from richdem_tpu_torch.oracle.fill import _nodata_mask, _seed_cells

__all__ = ["breach_depressions"]

_MODES = ("Complete", "Selective", "Constrained")


def breach_depressions(dem, no_data=None, mode="Complete", eps=0.0,
                       max_path_len=None, max_path_depth=None,
                       fill_remainder=False):
    """Breach depressions; returns a new array of the input dtype."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}")
    in_dtype = np.asarray(dem).dtype
    z = np.array(dem, dtype=np.float64, copy=True)
    orig = z.copy()
    h, w = z.shape
    nodata = _nodata_mask(z, no_data)
    seeds = _seed_cells(nodata)

    # Pits: local minima among data cells, excluding seeds.
    is_pit = np.zeros((h, w), dtype=bool)
    for r in range(h):
        for c in range(w):
            if nodata[r, c] or seeds[r, c]:
                continue
            pit = True
            for d in range(1, 9):
                nr, nc = r + int(DY[d]), c + int(DX[d])
                if (0 <= nr < h and 0 <= nc < w and not nodata[nr, nc]
                        and z[nr, nc] < z[r, c]):
                    pit = False
                    break
            is_pit[r, c] = pit

    visited = nodata.copy()
    backlink = np.zeros((h, w), dtype=np.int8)  # direction back toward edge
    heap = []
    k = 0
    for r, c in zip(*np.nonzero(seeds)):
        heapq.heappush(heap, (z[r, c], k, int(r), int(c)))
        visited[r, c] = True
        k += 1

    def _carve(pr, pc):
        """Walk backlinks from pit (pr,pc); lower the chain; True if done."""
        level = z[pr, pc]
        # Measure the path first (for Selective constraints).
        path = []
        r, c = pr, pc
        steps = 0
        while True:
            d = int(backlink[r, c])
            if d == 0:
                break  # reached a seed
            r, c = r + int(DY[d]), c + int(DX[d])
            steps += 1
            target = level - steps * eps
            if z[r, c] <= target:
                break
            path.append((r, c, target))
        if mode == "Selective":
            if max_path_len is not None and len(path) > max_path_len:
                return False
            if max_path_depth is not None and any(
                    orig[r, c] - t > max_path_depth for r, c, t in path):
                return False
        for r, c, target in path:
            if mode == "Constrained" and max_path_depth is not None:
                target = max(target, orig[r, c] - max_path_depth)
            z[r, c] = min(z[r, c], target)
        return True

    while heap:
        zc, _, r, c = heapq.heappop(heap)
        if is_pit[r, c]:
            _carve(r, c)
        for d in range(1, 9):
            nr, nc = r + int(DY[d]), c + int(DX[d])
            if not (0 <= nr < h and 0 <= nc < w) or visited[nr, nc]:
                continue
            visited[nr, nc] = True
            backlink[nr, nc] = D8_INVERSE[d]
            heapq.heappush(heap, (z[nr, nc], k, nr, nc))
            k += 1

    if fill_remainder:
        from richdem_tpu_torch.oracle.fill import priority_flood_epsilon
        z = priority_flood_epsilon(z, no_data=no_data, eps=max(eps, 0.0),
                                   dtype=np.float64)

    if no_data is not None:
        z[nodata] = no_data
    return z.astype(in_dtype)
