"""Depression filling, worked out by the reference.

The filled surface is the greatest ``W`` with

    W(c) = max(Z(c), min_n fl(W(n) + eps))     (n over the 8 neighbours)

where off-grid and nodata neighbours read ``-BIG`` (they drain), so an
edge cell keeps its elevation.  It is the least, over the paths from ``c``
to a drain, of the path's spill level.

* :func:`fill_flat` computes it at ``eps = 0`` from ``W = BIG``: rounds of
  whole-row clamp scans (west→east, east→west, and down and up the
  columns, each a Hillis–Steele composition of the maps
  ``x ↦ clamp(x, Z, W)``) and one step over the four diagonals, until a
  round changes nothing.  Only ``min`` and ``max`` touch the values, so it
  is exact in any precision and equals any other exact fill bit for bit.
* :func:`fixpoint_residual` judges a given surface at ``eps > 0`` by the
  equation itself.  When ``fl(W + eps) > W`` at every data cell, each
  non-drain cell of a solution has a strictly lower neighbour, so its
  descending path reaches a drain and the solution is the only one: a
  surface with no residual cell is the fill, bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.grid import shift

BIG = 1.0e30
#: Rounds of :func:`fill_flat` before it gives up.
MAX_ROUNDS = 256


def _row_scan(w, lo):
    """One west→east pass over whole rows: ``new[j] = clamp(new[j-1],
    lo[j], w[j])`` from a draining west edge, by composing the clamp maps
    in doubling steps."""
    lo_c, hi_c = lo, w
    width = w.shape[-1]
    d = 1
    while d < width:
        # compose each map with the composite ending d columns west; the
        # first d columns compose with the identity clamp
        plo = F.pad(lo_c[..., :-d], (d, 0), value=-math.inf)
        phi = F.pad(hi_c[..., :-d], (d, 0), value=math.inf)
        new_lo = torch.minimum(torch.maximum(plo, lo_c), hi_c)
        new_hi = torch.minimum(torch.maximum(phi, lo_c), hi_c)
        lo_c, hi_c = new_lo, new_hi
        d *= 2
    return lo_c  # the composite applied to -BIG, the drain off the row


def _diagonal_step(w, lo):
    m = torch.minimum(torch.minimum(shift(w, 2, -BIG), shift(w, 4, -BIG)),
                      torch.minimum(shift(w, 6, -BIG), shift(w, 8, -BIG)))
    return torch.minimum(w, torch.maximum(lo, m))


def fill_flat(z: torch.Tensor, nodata: torch.Tensor,
              dtype=torch.float32) -> torch.Tensor:
    """The ε = 0 fill of ``z`` in ``dtype``; nodata cells keep ``z``."""
    zd = z.to(dtype)
    lo = torch.where(nodata, torch.tensor(-BIG, dtype=dtype,
                                          device=z.device), zd)
    w = torch.full_like(lo, BIG)
    w[0], w[-1], w[:, 0], w[:, -1] = lo[0], lo[-1], lo[:, 0], lo[:, -1]
    w = torch.where(nodata, lo, w)
    lo_t = lo.t().contiguous()
    for _ in range(MAX_ROUNDS):
        old = w
        w = _row_scan(w, lo)
        w = _row_scan(w.flip(1), lo.flip(1)).flip(1)
        wt = w.t().contiguous()
        wt = _row_scan(wt, lo_t)
        wt = _row_scan(wt.flip(1), lo_t.flip(1)).flip(1)
        w = _diagonal_step(wt.t().contiguous(), lo)
        if torch.equal(w, old):
            return torch.where(nodata, zd, w)
    raise RuntimeError(f"reference fill: no fixpoint in {MAX_ROUNDS} rounds")


def fixpoint_residual(filled: torch.Tensor, z: torch.Tensor,
                      nodata: torch.Tensor, eps: float) -> dict:
    """Cells at which float32 ``filled`` breaks the fill's equation, and
    data cells at which ``eps`` does not raise ``filled`` (where the
    equation may have other solutions)."""
    w = filled.to(torch.float32)
    z32 = z.to(torch.float32)
    neg = torch.tensor(-BIG, dtype=torch.float32, device=z.device)
    eps_t = torch.tensor(eps, dtype=torch.float32, device=z.device)
    wd = torch.where(nodata, neg, w)
    lowest = shift(wd, 1, -BIG)
    for d in range(2, 9):
        lowest = torch.minimum(lowest, shift(wd, d, -BIG))
    want = torch.maximum(z32, lowest + eps_t)
    broken = torch.where(nodata, w != z32, w != want)
    unresolved = ~nodata & ((w + eps_t) <= w)
    return {"residual": int(broken.sum()),
            "unresolved": int(unresolved.sum())}
