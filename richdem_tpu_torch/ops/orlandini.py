"""Orlandini 2003 D8-LTD/LAD as an iterate-to-fixpoint on the device
(plain PyTorch).

Counterpart of ``richdem_tpu.ops.orlandini`` (an XLA fixpoint there, with
no Pallas kernel).  The method is path-sequential: each cell's choice
between the two facet-bracketing D8 directions depends on the cumulative
deviation δ carried from upstream.  Candidate targets are strictly lower
neighbours, so the (fd, δ) dependency graph is stratified by elevation:
an acyclic system whose unique fixpoint is the serial oracle's
descending-elevation computation
(:func:`richdem_tpu_torch.oracle.orlandini.orlandini_flowdirs`).  Iterate
jointly

    fd ← choose(δ)        (pointwise, from per-cell facet data that is
                           static given z, computed once)
    δ  ← λ·(δ(u*) + t(u*)) where u* is the lowest inflowing neighbour
                           (ties: largest flat index, the oracle's
                           "last processed wins")

one flow-path step per iteration, until neither changes.  Every tie-break
is the reference's (first-max facet; |δ+t|, then the steeper side, then
the smaller D8 code).
"""

from __future__ import annotations

import math

import torch

from richdem_tpu_torch.ops.stencil import as_tensor, neighbor, nodata_like
from richdem_tpu_torch.topology import D8_INVERSE, FLOWDIR_NO_DATA, NO_FLOW

__all__ = ["orlandini_flowdirs_device"]

#: (e1, e2, ac, af) — the facet table of Tarboton/D∞ and the oracle.
_FACETS = ((5, 4, 0, 1), (3, 4, 1, -1), (3, 2, 1, 1), (1, 2, 2, -1),
           (1, 8, 2, 1), (7, 8, 3, -1), (7, 6, 3, 1), (5, 6, 4, -1))


def _facet_data(z, nodata, d1, mode):
    """Per-cell facet choice and candidate data, static given ``z``:
    ``(e1, e2, t1, t2, c1_ok, c2_ok, pref1, pref2, any_facet)``."""
    dev, compute = z.device, z.dtype
    diag = d1 * torch.sqrt(torch.tensor(2.0, dtype=compute, device=dev))
    rmax = torch.atan2(d1, d1)
    zero = torch.zeros((), dtype=compute, device=dev)
    zed = torch.where(nodata, math.nan, z)

    best_s = torch.zeros(z.shape, dtype=compute, device=dev)
    best_i = torch.full(z.shape, -1, dtype=torch.int64, device=dev)
    best_r = torch.zeros(z.shape, dtype=compute, device=dev)
    best_ok1 = torch.zeros(z.shape, dtype=torch.bool, device=dev)
    best_ok2 = torch.zeros(z.shape, dtype=torch.bool, device=dev)
    for i, (e1, e2, _, _) in enumerate(_FACETS):
        z1 = neighbor(zed, e1, math.nan)
        z2 = neighbor(zed, e2, math.nan)
        ok1 = ~torch.isnan(z1)
        ok2 = ~torch.isnan(z2)
        z1v = torch.where(ok1, z1, zed)
        z2v = torch.where(ok2, z2, z1v)
        s1 = (zed - z1v) / d1
        s2 = (z1v - z2v) / d1
        r = torch.atan2(s2, s1)
        rr = torch.minimum(torch.maximum(r, zero), rmax)
        ss = torch.where(r < 0.0, s1,
                         torch.where(r > rmax, (zed - z2v) / diag,
                                     torch.hypot(s1, s2)))
        ss = torch.where(ok1 | ok2, ss, -math.inf)
        take = ss > best_s  # strict: the first facet wins ties
        best_s = torch.where(take, ss, best_s)
        best_i = torch.where(take, i, best_i)
        best_r = torch.where(take, rr, best_r)
        best_ok1 = torch.where(take, ok1, best_ok1)
        best_ok2 = torch.where(take, ok2, best_ok2)

    e1_tab = torch.tensor([f[0] for f in _FACETS], device=dev)
    e2_tab = torch.tensor([f[1] for f in _FACETS], device=dev)
    bi = best_i.clamp(min=0)
    e1, e2, rr = e1_tab[bi], e2_tab[bi], best_r
    if mode == "LTD":
        t1 = -d1 * torch.sin(rr)
        t2 = diag * torch.sin(rmax - rr)
    else:  # LAD
        t1 = -rr
        t2 = rmax - rr

    def lower(code):
        """The candidate exists and lies strictly below the centre."""
        zn = torch.zeros(z.shape, dtype=compute, device=dev)
        for d in range(1, 9):
            zn = torch.where(code == d, neighbor(zed, d, math.nan), zn)
        return zn < zed

    c1_ok = best_ok1 & lower(e1)
    c2_ok = best_ok2 & lower(e2)
    half = rmax / 2.0
    pref1 = torch.where(rr <= half, 0, 1)
    pref2 = torch.where(rr > half, 0, 1)
    return e1, e2, t1, t2, c1_ok, c2_ok, pref1, pref2, best_i >= 0


def orlandini_info(z, nodata, lam, cellsize, mode, max_iters):
    """The deviation fixpoint from δ = 0; returns ``(fd, iters,
    converged)`` without raising.  Computes in float64 for a float64
    ``z``, else in float32."""
    compute = torch.float64 if z.dtype == torch.float64 else torch.float32
    dev = z.device
    zc = z.to(compute)
    d1 = torch.tensor(float(cellsize), dtype=compute, device=dev)
    lam = torch.tensor(float(lam), dtype=compute, device=dev)
    (e1, e2, t1, t2, c1_ok, c2_ok,
     pref1, pref2, any_facet) = _facet_data(zc, nodata, d1, mode)
    h, w = z.shape
    idx = torch.arange(h * w, dtype=torch.int64, device=dev).view(h, w)
    zed = torch.where(nodata, math.inf, zc)  # nodata never wins u*
    flows = any_facet & (c1_ok | c2_ok)

    def choose(delta):
        """Codes from δ: the oracle's candidate rule, vectorised."""
        a1 = torch.abs(delta + t1)
        a2 = torch.abs(delta + t2)
        pick1 = torch.where(
            c1_ok & ~c2_ok, True,
            torch.where(~c1_ok & c2_ok, False,
                        (a1 < a2) | ((a1 == a2) & (
                            (pref1 < pref2)
                            | ((pref1 == pref2) & (e1 < e2))))))
        fd = torch.where(pick1, e1, e2)
        fd = torch.where(flows, fd, int(NO_FLOW))
        return torch.where(nodata, int(FLOWDIR_NO_DATA), fd).to(torch.int8)

    def propagate(fd, delta):
        """δ(c) ← λ·(δ(u*) + t_sel(u*)), u* the lowest inflowing
        neighbour (ties: the largest flat index)."""
        t_sel = torch.where(fd == e1, t1, t2)
        contrib = lam * (delta + t_sel)
        best_z = torch.full((h, w), math.inf, dtype=compute, device=dev)
        best_idx = torch.full((h, w), -1, dtype=torch.int64, device=dev)
        best_v = torch.zeros((h, w), dtype=compute, device=dev)
        for d in range(1, 9):
            flows_in = neighbor(fd, d, 0) == int(D8_INVERSE[d])
            nb_z = neighbor(zed, d, math.inf)
            nb_idx = neighbor(idx, d, -1)
            better = flows_in & ((nb_z < best_z)
                                 | ((nb_z == best_z) & (nb_idx > best_idx)))
            best_z = torch.where(better, nb_z, best_z)
            best_idx = torch.where(better, nb_idx, best_idx)
            best_v = torch.where(better, neighbor(contrib, d, 0.0), best_v)
        return torch.where(best_idx >= 0, best_v, 0.0)

    delta = torch.zeros((h, w), dtype=compute, device=dev)
    fd = choose(delta)
    iters, done = 0, False
    while not done and iters < max_iters:
        new_delta = propagate(fd, delta)
        new_fd = choose(new_delta)
        done = torch.equal(new_fd, fd) and torch.equal(new_delta, delta)
        fd, delta = new_fd, new_delta
        iters += 1
    return fd, iters, done


def orlandini_flowdirs_device(dem, no_data=None, lam=1.0, mode="LTD",
                              cellsize=1.0, max_iters=65536,
                              device="cuda"):
    """D8-LTD/LAD codes (int8) by the deviation fixpoint; the same codes as
    the serial oracle.  One iteration advances the deviation field one
    flow-path step, so the count is O(longest flow path).  Raises if
    ``max_iters`` iterations do not reach the fixpoint.  ``dem``: a tensor
    (the work runs where it lives) or an array (moved to ``device``)."""
    if mode not in ("LTD", "LAD"):
        raise ValueError("mode must be 'LTD' or 'LAD'")
    z = as_tensor(dem, device)
    fd, _, done = orlandini_info(z, nodata_like(z, no_data), lam, cellsize,
                                 mode, max_iters)
    if not done:
        raise RuntimeError("Orlandini deviation fixpoint did not converge "
                           f"within {max_iters} iterations")
    return fd
