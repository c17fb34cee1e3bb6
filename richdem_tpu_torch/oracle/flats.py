"""Serial flat resolution (oracle): Barnes, Lehman & Mulla 2014.

Counterpart of the reference's ``include/richdem/flats/flat_resolution.hpp``
(``ResolveFlats`` — SURVEY.md §2.2, appendix A.3).

A *flat* is a maximal 8-connected region of equal-elevation cells containing
at least one cell with no flow direction.  Drainage is imposed by building an
integer ``flat_mask`` of tiny virtual increments from two synchronized BFS
distance fields:

* ``T(c)`` — hop distance *towards lower* terrain: BFS seeded at the flat's
  outlet cells: cells in the flat that already have a flow direction, plus
  *virtual drains* — NO_FLOW flat cells on the raster border or 8-adjacent
  to nodata.  (Fill treats border/nodata as drains — SURVEY.md appendix
  A.2 — so a lake spilling over the border must resolve toward it; the
  drain cells themselves keep NO_FLOW and absorb flow.)
* ``D(c)`` — hop distance *away from higher* terrain: BFS seeded (D=1) at
  flat cells adjacent to strictly higher ground.

``flat_mask(c) = 2*T(c) + (FlatHeight[label] + 1 - D(c))`` (the away field
inverted so high edges sit highest; the factor 2 guarantees strict descent
toward outlets since the away component changes by at most 1 per step).
Both fields are unit-weight min-plus distances, so the device fixpoint
sweeps in :mod:`richdem_tpu_torch.ops.flats` reproduce them exactly.

Resolved flow directions on flat cells are steepest descent on
``flat_mask`` restricted to same-flat neighbors, with the package tie-break
(first max in scan order 1..8).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from richdem_tpu_torch.topology import DX, DY, DR, NO_FLOW

__all__ = ["resolve_flats", "flat_mask_and_labels"]


def _neighbors(r, c, h, w):
    for d in range(1, 9):
        nr, nc = r + int(DY[d]), c + int(DX[d])
        if 0 <= nr < h and 0 <= nc < w:
            yield d, nr, nc


def flat_mask_and_labels(dem, flowdirs, no_data=None):
    """Compute (flat_mask int32, labels int32) per BLM 2014.

    ``labels`` is 0 outside flats; positive ids inside (outlet cells
    included).  ``flat_mask`` is 0 outside flats and on outlet cells.
    Undrainable flats (no outlet) keep mask 0 and their cells stay NO_FLOW.
    """
    z = np.asarray(dem, dtype=np.float64)
    fd = np.asarray(flowdirs)
    h, w = z.shape
    if no_data is None:
        nodata = np.zeros((h, w), dtype=bool)
    elif isinstance(no_data, float) and np.isnan(no_data):
        nodata = np.isnan(z)
    else:
        nodata = z == no_data

    noflow = (fd == NO_FLOW) & ~nodata

    # Virtual drains: NO_FLOW cells that sit on the grid border or touch
    # nodata — they drain off-grid (fill semantics) and absorb flow.
    drain = np.zeros((h, w), dtype=bool)
    drain[0, :] = drain[-1, :] = drain[:, 0] = drain[:, -1] = True
    pad = np.pad(nodata, 1, constant_values=False)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            drain |= pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    drain &= noflow

    # --- label flats: flood equal elevation regions from NO_FLOW cells ---
    labels = np.zeros((h, w), dtype=np.int32)
    next_label = 1
    for r0 in range(h):
        for c0 in range(w):
            if not noflow[r0, c0] or labels[r0, c0]:
                continue
            elev = z[r0, c0]
            labels[r0, c0] = next_label
            queue = deque([(r0, c0)])
            while queue:
                r, c = queue.popleft()
                for _, nr, nc in _neighbors(r, c, h, w):
                    if (labels[nr, nc] == 0 and not nodata[nr, nc]
                            and z[nr, nc] == elev):
                        labels[nr, nc] = next_label
                        queue.append((nr, nc))
            next_label += 1

    in_flat = labels > 0

    # --- seed sets ------------------------------------------------------
    # Outlets ("low edges"): flat cells that already drain.
    # High edges: NO_FLOW flat cells adjacent to strictly higher data cells.
    towards = np.zeros((h, w), dtype=np.int32)
    away = np.zeros((h, w), dtype=np.int32)
    t_queue = deque()
    a_queue = deque()
    drainable = set()
    for r in range(h):
        for c in range(w):
            if not in_flat[r, c]:
                continue
            if not noflow[r, c] or drain[r, c]:
                t_queue.append((r, c))  # outlet (real or virtual): T = 0
                drainable.add(int(labels[r, c]))
                if not noflow[r, c]:
                    continue
            for _, nr, nc in _neighbors(r, c, h, w):
                if not nodata[nr, nc] and z[nr, nc] > z[r, c]:
                    away[r, c] = 1
                    a_queue.append((r, c))
                    break

    # --- BFS towards lower (on NO_FLOW flat cells, same label) ----------
    visited_t = np.zeros((h, w), dtype=bool)
    for r, c in t_queue:
        visited_t[r, c] = True
    while t_queue:
        r, c = t_queue.popleft()
        for _, nr, nc in _neighbors(r, c, h, w):
            if (noflow[nr, nc] and labels[nr, nc] == labels[r, c]
                    and not visited_t[nr, nc]):
                visited_t[nr, nc] = True
                towards[nr, nc] = towards[r, c] + 1
                t_queue.append((nr, nc))

    # --- BFS away from higher ------------------------------------------
    visited_a = away > 0
    while a_queue:
        r, c = a_queue.popleft()
        for _, nr, nc in _neighbors(r, c, h, w):
            if (noflow[nr, nc] and labels[nr, nc] == labels[r, c]
                    and not visited_a[nr, nc]):
                visited_a[nr, nc] = True
                away[nr, nc] = away[r, c] + 1
                a_queue.append((nr, nc))

    flat_height = {}
    for lbl in np.unique(labels[labels > 0]):
        flat_height[int(lbl)] = int(away[labels == lbl].max())

    # --- combine --------------------------------------------------------
    mask = np.zeros((h, w), dtype=np.int32)
    for r in range(h):
        for c in range(w):
            if not noflow[r, c] or drain[r, c] or labels[r, c] == 0:
                continue
            lbl = int(labels[r, c])
            if lbl not in drainable or not visited_t[r, c]:
                continue  # undrainable flat: leave mask 0
            m = 2 * towards[r, c]
            if away[r, c] > 0:
                m += flat_height[lbl] + 1 - away[r, c]
            mask[r, c] = m
    return mask, labels


def resolve_flats(dem, flowdirs, no_data=None):
    """Return flow directions with flats drained.

    Flat cells get the steepest-descent direction on ``flat_mask`` among
    same-flat neighbors (outlet cells have mask 0, so flow exits through
    them).  Undrainable flats keep NO_FLOW."""
    mask, labels = flat_mask_and_labels(dem, flowdirs, no_data)
    fd = np.array(flowdirs, copy=True)
    h, w = fd.shape
    for r in range(h):
        for c in range(w):
            if mask[r, c] == 0 or fd[r, c] != NO_FLOW:
                continue
            best_d, best_s = NO_FLOW, 0.0
            for d, nr, nc in _neighbors(r, c, h, w):
                if labels[nr, nc] != labels[r, c]:
                    continue
                s = (mask[r, c] - mask[nr, nc]) / DR[d]
                if s > best_s:
                    best_d, best_s = d, s
            fd[r, c] = best_d
    return fd
