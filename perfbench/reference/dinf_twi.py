"""What the reference works out for the D∞ path (ε-fill → Tarboton D∞
angles → D∞ accumulation → slope → TWI), and the numbers that judge the
program's outputs by it.

* The fill at ε > 0 is judged by its own equation, as in ``quinn_mfd``
  (:func:`perfbench.reference.fill.fixpoint_residual`), and the stages
  after it start from that judged surface.
* :func:`tarboton_angles`: Tarboton (1997), in float64.  Around each cell
  lie eight triangular facets, each with a cardinal neighbour ``e1`` and
  a diagonal neighbour ``e2`` (:data:`FACETS`, his Table 1).  A facet has
  ``s1 = (e0 - e1)/d``, ``s2 = (e1 - e2)/d``, the angle ``r = tan⁻¹(s2 /
  s1)`` and the slope ``√(s1² + s2²)``; ``r < 0`` is clamped to 0 with the
  slope ``s1``, ``r > π/4`` to π/4 with the slope ``(e0 - e2)/(d√2)``.
  The cell flows at ``ac·π/2 + af·r`` of its steepest facet, the first
  facet winning ties, when that slope is above 0; else it is NO_FLOW
  (-1); nodata is -2.
* :func:`two_tap_planes`: the angle splits the flow between the two D8
  directions that bracket it, ``1 - f`` toward the direction at
  ``⌊q⌋·π/4`` and ``f`` toward the next, ``q = angle · (4/π)``, ``f = q -
  ⌊q⌋``.  ``f`` is the share the configuration states: worked out in
  float32 from the float32 angle and held on multiples of 2⁻¹⁷
  (:data:`P_GRID`).  The accumulation is :func:`perfbench.reference.flow.
  mfd_accumulation` of these shares in float64, over the angles of the
  outputs judged, so that a facet chosen otherwise than here counts once,
  in ``angle_gap``, and not again in ``accum_gap``.
* Slope and TWI: :mod:`perfbench.reference.terrain`, slope from the
  judged fill in float32, TWI from the judged accumulation, so that an
  accumulation's error counts once, in ``accum_gap``.

How each number is conditioned:

* ``angle_gap`` (:func:`facet_gap`): two facets whose slopes differ by
  less than float32 resolves are ordered by rounding, and on the ε-fill's
  flats such near-ties are common; the program's angle is measured to the
  nearest facet tied with the steepest to :data:`SLOPE_TIE`, so a tie
  broken the other way does not read as a gap of up to π.
* ``accum_gap``: the gap relative to the cell's own accumulation, over
  the stated shares, is the program's float32 summation alone: at most
  6.2e-5 on three 10240² surfaces on an H100.  A share worked out anew in
  float64, or left off the 2⁻¹⁷ grid, moves up to 2⁻¹⁷ of a large flow
  onto cells whose own accumulation is small, and reads 0.08 to 0.33 of
  it on the same surfaces: the grid is part of the result, and is judged
  as such.

Departures from the paper and from the program, each on purpose:

* ``tan⁻¹(s2 / s1)`` is read with its quadrant (``atan2``), as RichDEM
  reads it: a facet whose ``e1`` lies above the cell then gets ``r > π/4``
  and drains along its diagonal edge if ``e2`` lies below, and one with
  ``s1 < 0`` and ``s2 < 0`` gets ``r < 0`` and the negative slope ``s1``,
  never a positive slope toward two higher cells.
* The paper leaves the grid's edge and nodata open; the reference takes
  RichDEM's rule: a missing ``e1`` reads the cell's own elevation, a
  missing ``e2`` reads ``e1``'s, and a facet with both missing is skipped.
* The program computes in float32; the reference in float64 from the same
  float32 fill.
* The share is not Tarboton's exact ``r / (π/4)`` but the stated one
  (float32, on the 2⁻¹⁷ grid), so that the accumulation is judged on the
  shares the program guarantees.
* An angle at a facet's edge points along one direction; a float32 angle
  there splits off a share below 2⁻¹⁸, which the grid takes to 0.  A
  share toward a cell off the grid, at nodata or not below the cell goes
  to the other tap, and where both taps are such the cell sends nothing,
  so the reference's shares hold no cycle whatever angles it is given.

The control (``control=True``) rounds the fill to bfloat16 and works every
stage in bfloat16, its accumulation over its own angles.
"""


from __future__ import annotations

import math

import torch

from perfbench.reference import fill, flow, terrain
from perfbench.reference.grid import DIRECTIONS, shift

#: Tarboton's facets as D8 directions (``grid.py``): ``(e1, e2, ac, af)``,
#: E–NE, N–NE, N–NW, W–NW, W–SW, S–SW, S–SE, E–SE.
FACETS = ((5, 4, 0, 1), (3, 4, 1, -1), (3, 2, 1, 1), (1, 2, 2, -1),
          (1, 8, 2, 1), (7, 8, 3, -1), (7, 6, 3, 1), (5, 6, 4, -1))
#: The D8 direction at angle ``k·π/4``, k = 0..7: E, NE, N, NW, W, SW, S,
#: SE.
OCTANT = (5, 4, 3, 2, 1, 8, 7, 6)
NO_FLOW = -1.0
NODATA = -2.0
#: Facets whose float64 slopes lie within this share of each other are
#: tied for :func:`facet_gap`: about eight times the rounding of a float32
#: slope (``√(s1² + s2²)`` in float32 from exact differences: 2⁻²³), far
#: below bfloat16's (2⁻⁸).
SLOPE_TIE = 1e-6
#: The stated share ``f`` lies on multiples of ``1 / P_GRID``.
P_GRID = 2.0 ** 17


def _facets(filled, nodata, cellsize, dtype):
    """Per facet, its slope, its flow angle in ``[0, 2π]`` and whether it
    has a data neighbour, computed in ``dtype``."""
    dev = filled.device
    z = filled.to(dtype)
    zed = torch.where(nodata, torch.tensor(math.nan, dtype=dtype,
                                           device=dev), z)
    d = torch.tensor(cellsize, dtype=dtype, device=dev)
    rmax = torch.atan2(d, d)
    diag = torch.sqrt(d * d + d * d)
    for e1, e2, ac, af in FACETS:
        z1, z2 = shift(zed, e1, math.nan), shift(zed, e2, math.nan)
        gone1, gone2 = torch.isnan(z1), torch.isnan(z2)
        z1 = torch.where(gone1, z, z1)
        z2 = torch.where(gone2, z1, z2)
        s1 = (z - z1) / d
        s2 = (z1 - z2) / d
        r = torch.atan2(s2, s1)
        s = torch.where(r < 0, s1, torch.where(
            r > rmax, (z - z2) / diag, torch.sqrt(s1 * s1 + s2 * s2)))
        r = torch.minimum(r.clamp(min=0), rmax)
        yield s, af * r + ac * (math.pi / 2), ~(gone1 & gone2)


def tarboton_angles(filled: torch.Tensor, nodata: torch.Tensor,
                    cellsize=1.0, dtype=torch.float64) -> torch.Tensor:
    """D∞ angles of ``filled`` in radians counter-clockwise from East,
    in ``[0, 2π)``, computed in ``dtype``; -1 NO_FLOW, -2 nodata."""
    best_s = best_a = None
    for s, angle, ok in _facets(filled, nodata, cellsize, dtype):
        if best_s is None:
            best_s = torch.zeros_like(s)
            best_a = torch.full_like(s, NO_FLOW)
        take = ok & (s > best_s)
        best_s = torch.where(take, s, best_s)
        best_a = torch.where(take, angle, best_a)
    out = torch.where(best_s > 0, torch.remainder(best_a, 2 * math.pi),
                      best_a.new_tensor(NO_FLOW))
    return torch.where(nodata, out.new_tensor(NODATA), out)


def _around(a, b):
    """Distance of two angles around the circle."""
    d = torch.remainder(a - b, 2 * math.pi)
    return torch.minimum(d, 2 * math.pi - d)


def facet_gap(angles: torch.Tensor, filled: torch.Tensor,
              nodata: torch.Tensor, cellsize=1.0) -> torch.Tensor:
    """At each cell, the distance around the circle from ``angles`` to
    the nearest angle of a facet whose float64 slope lies within
    :data:`SLOPE_TIE` of the steepest: a float32 slope cannot order
    facets closer than that, so either may be the one a float32 program
    takes."""
    best = None
    for s, _, ok in _facets(filled, nodata, cellsize, torch.float64):
        s = torch.where(ok, s, -math.inf)
        best = s if best is None else torch.maximum(best, s)
    a = angles.double()
    gap = torch.full_like(a, math.inf)
    for s, angle, ok in _facets(filled, nodata, cellsize, torch.float64):
        near = ok & (s >= best - SLOPE_TIE * best.abs())
        gap = torch.where(near, torch.minimum(gap, _around(a, angle)), gap)
    return gap


def stated_share(angles: torch.Tensor, dtype=torch.float32):
    """``(k, f)`` of a D∞ angle raster: the octant ``k = ⌊q⌋ mod 8`` and
    the share ``f = q - ⌊q⌋`` toward the next octant, ``q = angle · (4/π)``
    with ``4/π`` the reciprocal of ``dtype``'s π/4, worked out in
    ``dtype`` and rounded to the nearest multiple of ``1 /``
    :data:`P_GRID`.  Angles below 0 give ``(0, 0)``."""
    a = angles.to(dtype)
    flowing = a >= 0
    inv = 1 / torch.tensor(math.pi / 4, dtype=dtype, device=a.device)
    q = torch.where(flowing, a, 0.0) * inv
    k = torch.remainder(torch.floor(q).long(), 8)
    f = torch.clamp(torch.round((q - torch.floor(q)) * P_GRID) / P_GRID,
                    0.0, 1.0)
    return k, torch.where(flowing, f, 0.0)


def two_tap_planes(angles: torch.Tensor, filled: torch.Tensor,
                   nodata: torch.Tensor, dtype=torch.float64,
                   share_dtype=torch.float32) -> torch.Tensor:
    """(8, H, W) shares of a D∞ angle raster in ``dtype``: ``1 - f``
    toward ``OCTANT[k]`` and ``f`` toward ``OCTANT[k + 1]``, ``(k, f)`` of
    :func:`stated_share` in ``share_dtype``; a tap toward a cell that is
    off the grid, at nodata or not below the cell in ``filled`` hands its
    share to the other tap, and angles below 0 send nothing."""
    dev = angles.device
    flowing = angles >= 0
    k, f = stated_share(angles, share_dtype)
    f = f.to(dtype)
    octant = torch.tensor(OCTANT, device=dev)
    taps = (octant[k], octant[(k + 1) % 8])
    z = filled.to(dtype)
    zed = torch.where(nodata, torch.tensor(math.inf, dtype=dtype,
                                           device=dev), z)
    lower = torch.stack([shift(zed, d, math.inf) < z for d in DIRECTIONS])
    ok = [torch.gather(lower, 0, (t - 1)[None]).squeeze(0) & flowing
          for t in taps]
    zero = torch.zeros((), dtype=dtype, device=dev)
    lo = torch.where(ok[0], torch.where(ok[1], 1 - f, 1.0), zero)
    hi = torch.where(ok[1], torch.where(ok[0], f, 1.0), zero)
    planes = torch.zeros((8,) + tuple(angles.shape), dtype=dtype,
                         device=dev)
    for share, t in zip((lo, hi), taps):
        planes.scatter_add_(0, (t - 1)[None], share[None])
    return planes


def reference(z, nodata, out, cfg, control=False) -> dict:
    """The entry's outputs on ``z``, from the program's judged fill: the
    reference's own angles; the accumulation over ``out``'s angles; TWI
    from ``out``'s accumulation.  The control works over its own angles
    and accumulation."""
    low = torch.bfloat16 if control else None
    cs = float(cfg["cellsize"])
    filled = out["filled"].to(low or torch.float32)
    angles = tarboton_angles(filled, nodata, cs, low or torch.float64)
    planes = two_tap_planes(angles if control else out["angles"], filled,
                            nodata, low or torch.float64,
                            low or torch.float32)
    weights = (~nodata).to(low or torch.float64)
    acc = flow.mfd_accumulation(planes, weights, low or torch.float64)
    del planes
    slope = terrain.slope_radians(filled, nodata, cs, low or torch.float32)
    twi = terrain.twi(acc if control else out["accum"], slope, cs,
                      low or torch.float32)
    return {"filled": filled, "angles": angles, "accum": acc,
            "slope": slope, "twi": twi}


def _gap(a, b, keep):
    """Largest |a - b| over the cells of ``keep`` (NaN if either is NaN
    there), 0 over no cells."""
    d = (a.double() - b.double()).abs()[keep]
    return float(d.max()) if d.numel() else 0.0


def judge(out, ref, z, nodata, cfg) -> dict:
    """The numbers compared, by name: cells where the fill breaks its
    equation or where ε does not raise it (limit 0); the widest
    :func:`facet_gap` where both sides flow; cells where the two sides
    differ on NO_FLOW or nodata (limit 0); the widest gap of the
    accumulation relative to the cell's own; and the widest gap of
    TWI."""
    check = fill.fixpoint_residual(out["filled"], z, nodata,
                                   float(cfg["eps"]))
    data = ~nodata
    a, r = out["angles"].double(), ref["angles"].double()
    zero = a.new_zeros(())
    off = torch.where(a < 0, a, zero) != torch.where(r < 0, r, zero)
    both = data & ~(a < 0) & (r >= 0)
    gap = facet_gap(a, ref["filled"], nodata, float(cfg["cellsize"]))
    acc, racc = out["accum"].double(), ref["accum"].double()
    rel = (acc - racc).abs() / racc.clamp(min=1.0)
    return {
        "fill_residual": check["residual"] + check["unresolved"],
        "angle_gap": float(gap[both].max()) if bool(both.any()) else 0.0,
        "noflow_off": int(off.sum()),
        "accum_gap": float(rel[data].max()) if bool(data.any()) else 0.0,
        "twi_gap": _gap(out["twi"], ref["twi"], data),
    }
