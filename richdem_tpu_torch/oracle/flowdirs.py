"""Serial flow-direction metrics (oracle).

Covers the reference's ``flowmet/`` family (SURVEY.md §2.2): D8/D4
(O'Callaghan & Marks 1984), Rho8 (Fairfield & Leymarie 1991), D-infinity
(Tarboton 1997), FD8 (Freeman 1991), Holmgren 1994, Quinn 1991, and
Seibert & McGlynn 2007 — reference-layout counterparts
``include/richdem/flowmet/{d8_flowdirs,Fairfield1991,Tarboton1997,
Freeman1991,Holmgren1994,Quinn1991,Seibert2007}.hpp``.

Package-wide conventions (pinned here and in :mod:`richdem_tpu_torch.topology`):

* Off-grid and nodata neighbors are *skipped* — flow never leaves the data
  region through them; cells with no strictly-downslope data neighbor get
  ``NO_FLOW`` and absorb flow during accumulation.
* Ties in steepest-descent are broken by the first maximum in direction
  scan order 1..8 (W, NW, N, NE, E, SE, S, SW).
* Multi-flow methods return an ``(H, W, 8)`` proportion tensor whose channel
  ``k`` is the fraction of outflow toward direction ``k+1``; rows sum to 1
  for flowing cells and 0 for NO_FLOW/nodata cells.
"""

from __future__ import annotations

import math

import numpy as np

from richdem_tpu_torch.topology import (
    DX, DY, DR, NO_FLOW, FLOWDIR_NO_DATA,
)

__all__ = ["d8_flowdirs", "rho8_flowdirs", "dinf_flowdirs",
           "flow_proportions", "proportions_from_d8",
           "proportions_from_dinf"]


def _nodata_mask(z, no_data):
    if no_data is None:
        return np.zeros(z.shape, dtype=bool)
    if isinstance(no_data, float) and np.isnan(no_data):
        return np.isnan(z)
    return z == no_data


def _slopes_at(z, nodata, r, c, directions, cellsize):
    """Slope (drop/distance) toward each given direction; -inf if invalid."""
    h, w = z.shape
    out = []
    for d in directions:
        nr, nc = r + int(DY[d]), c + int(DX[d])
        if 0 <= nr < h and 0 <= nc < w and not nodata[nr, nc]:
            out.append((z[r, c] - z[nr, nc]) / (DR[d] * cellsize))
        else:
            out.append(-math.inf)
    return out


def d8_flowdirs(dem, no_data=None, topology="D8", cellsize=1.0):
    """Steepest-descent single flow directions (O'Callaghan & Marks 1984)."""
    z = np.asarray(dem, dtype=np.float64)
    h, w = z.shape
    nodata = _nodata_mask(z, no_data)
    dirs = (1, 3, 5, 7) if topology == "D4" else (1, 2, 3, 4, 5, 6, 7, 8)
    out = np.full((h, w), FLOWDIR_NO_DATA, dtype=np.int8)
    for r in range(h):
        for c in range(w):
            if nodata[r, c]:
                continue
            best_d, best_s = NO_FLOW, 0.0
            for d, s in zip(dirs, _slopes_at(z, nodata, r, c, dirs, cellsize)):
                if s > best_s:
                    best_d, best_s = d, s
            out[r, c] = best_d
    return out


def rho8_flowdirs(dem, no_data=None, seed=0, cellsize=1.0, topology="D8"):
    """Stochastic single flow directions (Fairfield & Leymarie 1991 Rho8).

    The diagonal neighbor distance is randomized per cell as
    ``1 + tan(u * pi/4)`` with ``u ~ U(0, 1)``, which makes the chosen
    direction *unbiased* w.r.t. the true aspect: on a plane whose aspect sits
    at angle ``theta`` between a cardinal and the adjacent diagonal, the
    diagonal wins the steepest-descent comparison iff
    ``d_diag < 1 + tan(theta)`` (since ``sqrt(2)*cos(45°-theta) =
    cos(theta) + sin(theta)``), so ``P(diagonal) = theta/45°`` exactly.
    Correctness gates are statistical, not bitwise (SURVEY.md §4d).
    """
    z = np.asarray(dem, dtype=np.float64)
    h, w = z.shape
    nodata = _nodata_mask(z, no_data)
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 1.0, size=(h, w))
    dirs = (1, 3, 5, 7) if topology == "D4" else (1, 2, 3, 4, 5, 6, 7, 8)
    out = np.full((h, w), FLOWDIR_NO_DATA, dtype=np.int8)
    for r in range(h):
        for c in range(w):
            if nodata[r, c]:
                continue
            rho_diag = 1.0 + math.tan(u[r, c] * math.pi / 4.0)
            best_d, best_s = NO_FLOW, 0.0
            for d in dirs:
                nr, nc = r + int(DY[d]), c + int(DX[d])
                if not (0 <= nr < h and 0 <= nc < w) or nodata[nr, nc]:
                    continue
                dist = (rho_diag if DR[d] > 1.0 else 1.0) * cellsize
                s = (z[r, c] - z[nr, nc]) / dist
                if s > best_s:
                    best_d, best_s = d, s
            out[r, c] = best_d
    return out


# -- D-infinity (Tarboton 1997) -----------------------------------------

# Facet table: (e1, e2, ac, af) with e1/e2 as package direction codes and
# the global angle of the facet's steepest direction = af*r + ac*pi/2,
# measured counter-clockwise from East with "North" = up (-y).
_DINF_FACETS = (
    (5, 4, 0, 1),   # E , NE
    (3, 4, 1, -1),  # N , NE
    (3, 2, 1, 1),   # N , NW
    (1, 2, 2, -1),  # W , NW
    (1, 8, 2, 1),   # W , SW
    (7, 8, 3, -1),  # S , SW
    (7, 6, 3, 1),   # S , SE
    (5, 6, 4, -1),  # E , SE
)

#: D8 direction code at angle k * pi/4 (k = 0..7), i.e. E,NE,N,NW,W,SW,S,SE.
DINF_OCTANT_DIRS = (5, 4, 3, 2, 1, 8, 7, 6)


def dinf_flowdirs(dem, no_data=None, cellsize=1.0):
    """Continuous flow angles in radians CCW-from-East (Tarboton 1997).

    Returns an ``(H, W)`` float64 raster; ``-1`` marks NO_FLOW cells (no
    facet with positive slope) and ``-2`` marks nodata, mirroring the
    reference's ``dinf_flowdirs`` NO_FLOW=-1 convention (SURVEY.md §2.2).
    """
    z = np.asarray(dem, dtype=np.float64)
    h, w = z.shape
    nodata = _nodata_mask(z, no_data)
    d1 = d2 = float(cellsize)
    rmax = math.atan2(d2, d1)
    diag = math.hypot(d1, d2)
    out = np.full((h, w), -1.0, dtype=np.float64)
    out[nodata] = -2.0

    def _z(nr, nc):
        if 0 <= nr < h and 0 <= nc < w and not nodata[nr, nc]:
            return z[nr, nc]
        return None

    for r in range(h):
        for c in range(w):
            if nodata[r, c]:
                continue
            z0 = z[r, c]
            best_s = 0.0
            best_angle = None
            for e1, e2, ac, af in _DINF_FACETS:
                z1 = _z(r + int(DY[e1]), c + int(DX[e1]))
                z2 = _z(r + int(DY[e2]), c + int(DX[e2]))
                if z1 is None and z2 is None:
                    continue
                if z1 is None:
                    z1 = z0  # degrade facet to the diagonal edge only
                if z2 is None:
                    z2 = z1
                s1 = (z0 - z1) / d1
                s2 = (z1 - z2) / d2
                rr = math.atan2(s2, s1) if s1 != 0.0 or s2 != 0.0 else 0.0
                if rr < 0.0:
                    rr = 0.0
                    ss = s1
                elif rr > rmax:
                    rr = rmax
                    ss = (z0 - z2) / diag
                else:
                    ss = math.hypot(s1, s2)
                if ss > best_s:
                    best_s = ss
                    best_angle = af * rr + ac * (math.pi / 2.0)
            if best_angle is not None:
                out[r, c] = best_angle % (2.0 * math.pi)
    return out


def proportions_from_dinf(angles, no_data_mask=None):
    """Convert a D-infinity angle raster to ``(H, W, 8)`` proportions."""
    ang = np.asarray(angles, dtype=np.float64)
    h, w = ang.shape
    props = np.zeros((h, w, 8), dtype=np.float64)
    quarter = math.pi / 4.0
    for r in range(h):
        for c in range(w):
            a = ang[r, c]
            if a < 0.0:  # NO_FLOW or nodata
                continue
            k = int(a // quarter) % 8
            frac = (a - k * quarter) / quarter
            d_lo = DINF_OCTANT_DIRS[k]
            d_hi = DINF_OCTANT_DIRS[(k + 1) % 8]
            props[r, c, d_lo - 1] += 1.0 - frac
            props[r, c, d_hi - 1] += frac
    return props


def proportions_from_d8(flowdirs):
    """One-hot ``(H, W, 8)`` proportions from a D8 flow-direction raster."""
    fd = np.asarray(flowdirs)
    h, w = fd.shape
    props = np.zeros((h, w, 8), dtype=np.float64)
    for d in range(1, 9):
        props[..., d - 1] = (fd == d).astype(np.float64)
    return props


def _mfd_proportions(dem, no_data, exponent, cellsize):
    """Generic multi-flow: fraction toward d ∝ max(slope_d, 0)**exponent."""
    z = np.asarray(dem, dtype=np.float64)
    h, w = z.shape
    nodata = _nodata_mask(z, no_data)
    props = np.zeros((h, w, 8), dtype=np.float64)
    for r in range(h):
        for c in range(w):
            if nodata[r, c]:
                continue
            weights = np.zeros(8)
            for d in range(1, 9):
                nr, nc = r + int(DY[d]), c + int(DX[d])
                if not (0 <= nr < h and 0 <= nc < w) or nodata[nr, nc]:
                    continue
                s = (z[r, c] - z[nr, nc]) / (DR[d] * cellsize)
                if s > 0:
                    weights[d - 1] = s ** exponent
            total = weights.sum()
            if total > 0:
                props[r, c] = weights / total
    return props


def _seibert_mcglynn_proportions(dem, no_data, exponent, cellsize):
    """Triangular multi-flow MD-infinity (Seibert & McGlynn 2007).

    Each of the 8 Tarboton facets with positive slope receives a share
    ∝ slope**exponent; within a facet the share splits between the two
    bracketing D8 neighbors by angular proximity (as in D-infinity).
    """
    z = np.asarray(dem, dtype=np.float64)
    h, w = z.shape
    nodata = _nodata_mask(z, no_data)
    d1 = d2 = float(cellsize)
    rmax = math.atan2(d2, d1)
    diag = math.hypot(d1, d2)
    props = np.zeros((h, w, 8), dtype=np.float64)
    for r in range(h):
        for c in range(w):
            if nodata[r, c]:
                continue
            z0 = z[r, c]
            shares = np.zeros(8)
            for e1, e2, ac, af in _DINF_FACETS:
                nr1, nc1 = r + int(DY[e1]), c + int(DX[e1])
                nr2, nc2 = r + int(DY[e2]), c + int(DX[e2])
                ok1 = 0 <= nr1 < h and 0 <= nc1 < w and not nodata[nr1, nc1]
                ok2 = 0 <= nr2 < h and 0 <= nc2 < w and not nodata[nr2, nc2]
                if not (ok1 or ok2):
                    continue
                z1 = z[nr1, nc1] if ok1 else z0
                z2 = z[nr2, nc2] if ok2 else z1
                s1 = (z0 - z1) / d1
                s2 = (z1 - z2) / d2
                rr = math.atan2(s2, s1) if (s1 or s2) else 0.0
                if rr < 0.0:
                    rr, ss = 0.0, s1
                elif rr > rmax:
                    rr, ss = rmax, (z0 - z2) / diag
                else:
                    ss = math.hypot(s1, s2)
                if ss <= 0.0:
                    continue
                frac2 = rr / rmax  # share of the facet toward e2 (diagonal)
                weight = ss ** exponent
                shares[e1 - 1] += weight * (1.0 - frac2)
                shares[e2 - 1] += weight * frac2
            total = shares.sum()
            if total > 0:
                props[r, c] = shares / total
    return props


def flow_proportions(dem, method="D8", no_data=None, exponent=None,
                     cellsize=1.0, seed=0):
    """Dispatch to any supported metric; returns ``(H, W, 8)`` proportions.

    Method names follow pyrichdem's ``FlowProportions`` strings
    (SURVEY.md §2.5): D8, D4, Rho8, Rho4, Dinf, Quinn, Freeman, Holmgren,
    SeibertMcGlynn, OCallaghan (alias of D8).
    """
    method_l = method.lower()
    if method_l in ("d8", "ocallaghan"):
        return proportions_from_d8(d8_flowdirs(dem, no_data, "D8", cellsize))
    if method_l == "d4":
        return proportions_from_d8(d8_flowdirs(dem, no_data, "D4", cellsize))
    if method_l == "rho8":
        return proportions_from_d8(
            rho8_flowdirs(dem, no_data, seed, cellsize, "D8"))
    if method_l == "rho4":
        return proportions_from_d8(
            rho8_flowdirs(dem, no_data, seed, cellsize, "D4"))
    if method_l in ("dinf", "tarboton"):
        return proportions_from_dinf(dinf_flowdirs(dem, no_data, cellsize))
    if method_l == "quinn":
        return _mfd_proportions(dem, no_data, 1.0, cellsize)
    if method_l == "freeman":
        return _mfd_proportions(
            dem, no_data, 1.1 if exponent is None else exponent, cellsize)
    if method_l == "holmgren":
        if exponent is None:
            raise ValueError("Holmgren requires an exponent")
        return _mfd_proportions(dem, no_data, exponent, cellsize)
    if method_l in ("seibertmcglynn", "md_infinity", "mdinf"):
        return _seibert_mcglynn_proportions(
            dem, no_data, 1.0 if exponent is None else exponent, cellsize)
    raise ValueError(f"unknown flow metric: {method!r}")
