"""Serial terrain attributes (oracle): Horn 1981 slope/aspect and
Zevenbergen & Thorne 1987 curvatures.

Counterpart of the reference's ``TerrainAttribute`` / ``TA_*`` helpers
(``include/richdem/methods/terrain_attributes.hpp`` per SURVEY.md §2.2,
appendix A.8).

Window letters, row-major over the 3×3 neighborhood (y increases downward)::

    a b c
    d e f
    g h i

Out-of-bounds or nodata neighbors are replaced by the center value ``e``
(the standard reflection-free edge policy; pinned package-wide).

Conventions:

* ``fx`` is the Horn derivative toward **East**, ``fy`` toward **South**.
* ``aspect`` is compass degrees of the downslope direction — 0 = North,
  90 = East — and ``-1`` on flat cells.
* Curvatures carry the Z–T ``× 100`` factor (units: 1/100 z-units per
  cell-unit²), matching the reference's output scaling.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["terrain_attribute", "TERRAIN_ATTRIBUTES", "twi", "spi"]

TERRAIN_ATTRIBUTES = (
    "slope_riserun",
    "slope_percentage",
    "slope_degrees",
    "slope_radians",
    "aspect",
    "curvature",
    "planform_curvature",
    "profile_curvature",
)


def _nodata_mask(z, no_data):
    if no_data is None:
        return np.zeros(z.shape, dtype=bool)
    if isinstance(no_data, float) and np.isnan(no_data):
        return np.isnan(z)
    return z == no_data


def _window(z, nodata, r, c):
    h, w = z.shape
    e = z[r, c]
    vals = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nr, nc = r + dy, c + dx
            if 0 <= nr < h and 0 <= nc < w and not nodata[nr, nc]:
                vals.append(z[nr, nc])
            else:
                vals.append(e)
    return vals  # [a, b, c, d, e, f, g, h, i]


def terrain_attribute(dem, attrib, zscale=1.0, cellsize=1.0, no_data=None):
    """Compute one attribute from :data:`TERRAIN_ATTRIBUTES`.

    Returns float64 ``(H, W)``; nodata cells get ``nan`` (the caller maps
    them back to the raster's no_data value)."""
    if attrib not in TERRAIN_ATTRIBUTES:
        raise ValueError(f"unknown terrain attribute {attrib!r}; "
                         f"expected one of {TERRAIN_ATTRIBUTES}")
    z = np.asarray(dem, dtype=np.float64) * zscale
    hgt, wid = z.shape
    nodata = _nodata_mask(np.asarray(dem, dtype=np.float64), no_data)
    L = float(cellsize)
    out = np.full((hgt, wid), np.nan)

    for r in range(hgt):
        for c in range(wid):
            if nodata[r, c]:
                continue
            a, b, cc, d, e, f, g, h, i = _window(z, nodata, r, c)
            fx = ((cc + 2 * f + i) - (a + 2 * d + g)) / (8 * L)
            fy = ((g + 2 * h + i) - (a + 2 * b + cc)) / (8 * L)

            if attrib.startswith("slope"):
                riserun = math.hypot(fx, fy)
                if attrib == "slope_riserun":
                    out[r, c] = riserun
                elif attrib == "slope_percentage":
                    out[r, c] = 100.0 * riserun
                elif attrib == "slope_radians":
                    out[r, c] = math.atan(riserun)
                else:  # slope_degrees
                    out[r, c] = math.degrees(math.atan(riserun))
            elif attrib == "aspect":
                if fx == 0.0 and fy == 0.0:
                    out[r, c] = -1.0
                else:
                    out[r, c] = math.degrees(
                        math.atan2(-fx, fy)) % 360.0
            else:
                # Zevenbergen–Thorne quadric coefficients.
                D = ((d + f) / 2.0 - e) / (L * L)
                E = ((b + h) / 2.0 - e) / (L * L)
                F = (-a + cc + g - i) / (4.0 * L * L)
                G = (-d + f) / (2.0 * L)
                H = (b - h) / (2.0 * L)
                g2h2 = G * G + H * H
                if attrib == "curvature":
                    out[r, c] = -2.0 * (D + E) * 100.0
                elif attrib == "planform_curvature":
                    out[r, c] = (0.0 if g2h2 == 0.0 else
                                 2.0 * (D * H * H + E * G * G - F * G * H)
                                 / g2h2 * 100.0)
                else:  # profile_curvature
                    out[r, c] = (0.0 if g2h2 == 0.0 else
                                 -2.0 * (D * G * G + E * H * H + F * G * H)
                                 / g2h2 * 100.0)
    return out


def twi(accum, slope_radians, cellsize=1.0, min_slope=1e-6):
    """Topographic wetness index ``ln(a / tan beta)`` (appendix A.7).

    ``a`` is specific catchment area = cell-count accumulation × cellsize
    (per unit contour width); slopes are clamped to ``min_slope``."""
    a = np.asarray(accum, dtype=np.float64) * cellsize
    tanb = np.maximum(np.tan(np.asarray(slope_radians, dtype=np.float64)),
                      min_slope)
    return np.log(np.maximum(a, 1e-30) / tanb)


def spi(accum, slope_radians, cellsize=1.0):
    """Stream power index ``a · tan beta`` (appendix A.7)."""
    a = np.asarray(accum, dtype=np.float64) * cellsize
    return a * np.tan(np.asarray(slope_radians, dtype=np.float64))
