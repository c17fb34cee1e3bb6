"""Orlandini et al. 2003 D8-LTD / D8-LAD path-based flow directions
(oracle).

Counterpart of the reference's ``flowmet/Orlandini2003.hpp`` (SURVEY.md
§2.2).  The method removes D8's grid bias by choosing, per cell, between
the two D8 directions bracketing the Tarboton facet angle — picking the
one that minimizes the *cumulative* transverse (LTD) or angular (LAD)
deviation carried along the flow path, attenuated by ``lam`` ∈ [0, 1].

The deviation state propagates *along paths*, which makes the method
inherently sequential (SURVEY.md §2.2 flags it as the hardest metric to
data-parallelize).  The reference runs it serially in C++; this package
keeps it a host-side op as well (oracle + API dispatch), with these
**pinned semantics** (the reference mount was empty — SURVEY.md
provenance — so tie-breaks follow the paper plus the package convention):

* Cells are processed in **descending filled-elevation order** (ties:
  row-major scan order), so every cell is settled before any cell it can
  flow to.
* Per cell: compute the steepest Tarboton facet (same 8-facet table and
  tie-breaks as :func:`richdem_tpu_torch.oracle.flowdirs.dinf_flowdirs`).  The
  facet's two D8 neighbors are the candidates; their transverse
  deviations are ``t1 = -d·sin(r)`` (cardinal side) and
  ``t2 = d·√2·sin(π/4 − r)`` (diagonal side), ``r`` the in-facet angle.
* Choose the candidate minimizing ``|δ_cum + t_i|`` (LTD; LAD uses the
  angular deviations ``−r`` and ``π/4 − r``); on a tie the steeper facet
  side (the D8 choice) wins.
* The downstream neighbor inherits ``δ = lam · (δ_cum + t_chosen)``;
  at confluences the value pushed by the **last-processed** (i.e. lowest
  spilling) upstream cell wins, matching elevation-ordered processing.
* Cells with no positive facet slope keep NO_FLOW; nodata propagates as
  in every other metric.
"""

from __future__ import annotations

import numpy as np

from richdem_tpu_torch.topology import DX, DY, NO_FLOW, FLOWDIR_NO_DATA
from richdem_tpu_torch.oracle.flowdirs import _nodata_mask

__all__ = ["orlandini_flowdirs"]

#: (e1, e2, ac, af) — same facet table as Tarboton/Dinf.
_FACETS = ((5, 4, 0, 1), (3, 4, 1, -1), (3, 2, 1, 1), (1, 2, 2, -1),
           (1, 8, 2, 1), (7, 8, 3, -1), (7, 6, 3, 1), (5, 6, 4, -1))


def orlandini_flowdirs(dem, no_data=None, lam=1.0, mode="LTD",
                       cellsize=1.0):
    """D8-LTD/LAD single flow directions; returns an int8 raster.

    ``lam``: deviation memory (0 = plain D8 facet choice, 1 = full path
    memory).  ``mode``: 'LTD' (transverse distances) or 'LAD' (angles).
    """
    if mode not in ("LTD", "LAD"):
        raise ValueError("mode must be 'LTD' or 'LAD'")
    z = np.asarray(dem, dtype=np.float64)
    h, w = z.shape
    nodata = _nodata_mask(z, no_data)
    d1 = float(cellsize)
    diag = d1 * np.sqrt(2.0)
    rmax = np.arctan2(d1, d1)

    fd = np.full((h, w), FLOWDIR_NO_DATA, dtype=np.int8)
    fd[~nodata] = NO_FLOW
    delta = np.zeros((h, w), dtype=np.float64)

    # descending elevation, ties broken by row-major index
    order = np.lexsort((np.arange(z.size), -z.ravel()))
    for idx in order:
        r, c = divmod(int(idx), w)
        if nodata[r, c]:
            continue
        zc = z[r, c]

        best_s = 0.0
        best = None  # (e1, e2, rr, af)
        for e1, e2, ac, af in _FACETS:
            n1r, n1c = r + int(DY[e1]), c + int(DX[e1])
            n2r, n2c = r + int(DY[e2]), c + int(DX[e2])
            ok1 = (0 <= n1r < h and 0 <= n1c < w and not nodata[n1r, n1c])
            ok2 = (0 <= n2r < h and 0 <= n2c < w and not nodata[n2r, n2c])
            if not (ok1 or ok2):
                continue
            z1 = z[n1r, n1c] if ok1 else zc
            z2 = z[n2r, n2c] if ok2 else z1
            s1 = (zc - z1) / d1
            s2 = (z1 - z2) / d1
            rr = np.arctan2(s2, s1)
            if rr < 0.0:
                rr, ss = 0.0, s1
            elif rr > rmax:
                rr, ss = rmax, (zc - z2) / diag
            else:
                ss = np.hypot(s1, s2)
            if ss > best_s:
                best_s = ss
                best = (e1, e2, rr, ok1, ok2)
        if best is None:
            continue  # NO_FLOW (pit or flat)
        e1, e2, rr, ok1, ok2 = best

        if mode == "LTD":
            t1 = -d1 * np.sin(rr)                 # choose the cardinal e1
            t2 = diag * np.sin(rmax - rr)          # choose the diagonal e2
        else:
            t1 = -rr
            t2 = rmax - rr
        dcum = delta[r, c]
        # candidate must be a usable neighbor AND strictly downhill (when
        # the facet angle clamps onto one D8 axis the other bracket cell
        # can sit above the center — deviation must not route uphill);
        # prefer smaller |dcum + t|, tie → the facet's steeper side.
        def lower(d):
            nr, nc = r + int(DY[d]), c + int(DX[d])
            return z[nr, nc] < zc
        cand = []
        if ok1 and lower(e1):
            cand.append((abs(dcum + t1), 0 if rr <= rmax / 2 else 1, e1, t1))
        if ok2 and lower(e2):
            cand.append((abs(dcum + t2), 0 if rr > rmax / 2 else 1, e2, t2))
        if not cand:
            continue  # flat bracket on an epsilon-scale ledge: NO_FLOW
        _, _, d_sel, t_sel = min(cand)
        fd[r, c] = d_sel
        nr, nc = r + int(DY[d_sel]), c + int(DX[d_sel])
        delta[nr, nc] = lam * (dcum + t_sel)
    return fd
