"""Device tile consumers for the two-pass distributed protocols.

Counterpart of ``richdem_tpu.parallel.consumer``.  Each tile consumer runs
where its tile lives (the card, or the CPU through the kernels' plain
versions) and only O(perimeter) vectors cross to the host.

**Fill consumer** ([P1] pass 1, arxiv 1606.06204 §3).  Per tile:

1. local fill: ordinary depression fill of the tile alone (tile edges and
   nodata drain), the fill kernel's rotations;
2. watershed labels: D8 codes of the locally filled surface, flats drained
   toward their outlets, then the successor jump (the jump's kernels on a
   card): ``label(c)`` is 1 + the flat index of the drain cell
   that ``c`` reaches.  Drains on a global DEM edge, nodata cells and
   nodata-adjacent drains are pre-marked ocean (label 0);
3. label-graph edges: for every 8-adjacent pair with different labels,
   ``weight = max(w_loc, w_loc_nbr)`` (nodata cells carry ``-inf``, so a
   data↔nodata adjacency is the [P1] ocean edge at the data cell's
   elevation), min-reduced per pair on the host.

One label per drain cell is finer than [P1]'s basins, and keeps minimax
exactness: two cells of one label drain (weakly descending on ``w_loc``) to
one terminal, so they connect inside the tile at ``max(w_loc(x),
w_loc(y))``, and [P1]'s ``W* = max(w_loc, raise[label])`` applies.

**Ring-Dirichlet apply** (pass 2).  Once the global fill ``W*`` is known
on a tile's border ring, the tile interior of the global fill is the
unique fixpoint of the local fill problem with the ring pinned at those
values, so one more fill per tile reproduces it bit for bit and pass 1
persists nothing.

**Accumulation consumer** ([P2] pass 1, arxiv 1608.04431 §3–4): local D8
accumulation with zero external inflow and, per ring cell, its link, the
in-tile terminal of its flow path (the successor resolve).

:func:`_local_fill_solve` is the exact local fill fixpoint on a
halo-extended block with its ring clamped: the step of the Schwarz fill
(``outofcore``) and of the sharded fill (``sharded``).
"""

from __future__ import annotations

import numpy as np
import torch

from richdem_tpu_torch.methods import watersheds_from_flowdirs
from richdem_tpu_torch.ops.accum import d8_accumulation_info
from richdem_tpu_torch.ops.fill import (_require_converged,
                                        fill_depressions, fill_sweep)
from richdem_tpu_torch.ops.flats import resolve_flats
from richdem_tpu_torch.ops.flowdirs import d8_flowdirs
from richdem_tpu_torch.ops.stencil import as_tensor, neighbor, nodata_like
from richdem_tpu_torch.ops.successor import successor_jump
from richdem_tpu_torch.ops.sweeps import BIG, fill_fixpoint_core
from richdem_tpu_torch.topology import DX, DY, NO_FLOW

__all__ = ["fill_tile_consumer", "fill_tile_apply", "accum_tile_consumer",
           "ring_index", "GE_TOP", "GE_BOTTOM", "GE_LEFT", "GE_RIGHT"]

#: global-edge bitmask values (same convention as ``native.fill_tile``)
GE_TOP, GE_BOTTOM, GE_LEFT, GE_RIGHT = 1, 2, 4, 8

#: rotations of the ring-pinned apply fill and of the local solves
APPLY_CAP = 256
LOCAL_D8_CAP = 64


def ring_index(th, tw):
    """Flat indices of a tile's border ring, row-major unique: top row,
    bottom row, then left/right columns (interior rows)."""
    idx = [np.arange(tw)]
    if th > 1:
        idx.append((th - 1) * tw + np.arange(tw))
    if th > 2:
        inner = np.arange(1, th - 1)
        idx.append(inner * tw)
        if tw > 1:
            idx.append(inner * tw + (tw - 1))
    return np.concatenate(idx)


def _labels_impl(nd, fd_res, ge_mask):
    """Per-cell labels on the locally filled surface: 0 = ocean, else
    1 + flat index of the drain cell reached.  ``ge_mask`` bool (H, W):
    cells on a global DEM edge.  Each cell reads the premark of the
    terminal its path reaches (``successor_jump``), -1 on or above a
    cycle."""
    h, w = fd_res.shape
    noflow = (fd_res == NO_FLOW) & ~nd
    near_nodata = torch.zeros_like(nd)
    for d in range(1, 9):
        near_nodata |= neighbor(nd, d, False)
    ocean_drain = nd | (noflow & (ge_mask | near_nodata))
    self_idx = torch.arange(h * w, dtype=torch.int32,
                            device=nd.device).view(h, w)
    premark = torch.where(ocean_drain, 0, self_idx + 1).to(torch.int32)
    root = successor_jump(fd_res).view(-1).long()
    lab = premark.view(-1)[root.clamp(min=0)]
    return torch.where(root >= 0, lab, -1).view(h, w)


#: unordered-pair directions (E, SE, S, SW cover every 8-adjacency once)
_EDGE_DIRS = (5, 6, 7, 8)


def _boundary_mask(lab):
    """Cells with a differing-label neighbour in any unordered-pair
    direction: label boundaries are curves, so one nonzero over this mask
    and small gathers extract the edges."""
    m = torch.zeros(lab.shape, dtype=torch.bool, device=lab.device)
    for d in _EDGE_DIRS:
        lb = neighbor(lab, d, -1)
        m |= (lb >= 0) & (lab != lb)
    return m


def _host(x, dtype):
    return x.cpu().numpy().astype(dtype, copy=False)


def _extract_edges(w_loc, nd, lab):
    """Host numpy (la, lb, w) label-graph edge arrays from device rasters:
    one nonzero and O(boundary) gathers on the device, O(boundary) work on
    the host."""
    h, w = lab.shape
    idx = torch.nonzero(_boundary_mask(lab).reshape(-1)).reshape(-1)
    if idx.numel() == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float64))
    w_eff = torch.where(nd, -torch.inf, w_loc).reshape(-1)
    lab_f = lab.reshape(-1)
    n = h * w
    offs = torch.tensor([int(DY[d]) * w + int(DX[d]) for d in _EDGE_DIRS],
                        device=idx.device)
    nb = torch.clamp(idx[None, :] + offs[:, None], 0, n - 1)
    la = _host(lab_f[idx], np.int64)
    wa = _host(w_eff[idx], np.float64)
    lbs = _host(lab_f[nb], np.int64)
    wbs = _host(w_eff[nb], np.float64)
    rr, cc = np.divmod(_host(idx, np.int64), w)
    ea, eb, ew = [], [], []
    for k, d in enumerate(_EDGE_DIRS):
        dy, dx = int(DY[d]), int(DX[d])
        lb, wb = lbs[k], wbs[k]
        ok = ((rr + dy >= 0) & (rr + dy < h)
              & (cc + dx >= 0) & (cc + dx < w) & (la != lb))
        ea.append(la[ok])
        eb.append(lb[ok])
        ew.append(np.maximum(wa, wb)[ok])
    return (np.concatenate(ea), np.concatenate(eb), np.concatenate(ew))


def _ring(dev, h, w):
    return torch.from_numpy(ring_index(h, w)).to(dev)


def fill_tile_consumer(z_tile, no_data=None, global_edges=0, device="cuda"):
    """[P1] pass-1 consumer.

    ``z_tile``: a tensor (the work runs where it lives) or an array (moved
    to ``device``); ``global_edges``: bitmask of tile sides on the global
    DEM edge.  Returns a dict with host numpy ``ring_w``/``ring_lab``/
    ``ring_nd`` (border ring, :func:`ring_index` order), the ``edges``
    (la, lb, w) arrays, and the device ``w_loc``/``lab`` rasters (callers
    may drop them: nothing is persisted)."""
    z = as_tensor(z_tile, device).to(torch.float32)
    h, w = z.shape
    nd = nodata_like(z, no_data)

    w_loc = fill_depressions(z, no_data=no_data)
    fd = d8_flowdirs(w_loc, no_data=no_data)
    fd_res = resolve_flats(w_loc, fd, no_data=no_data)

    rows = torch.arange(h, device=z.device)[:, None]
    cols = torch.arange(w, device=z.device)[None, :]
    ge = torch.zeros((h, w), dtype=torch.bool, device=z.device)
    if global_edges & GE_TOP:
        ge |= rows == 0
    if global_edges & GE_BOTTOM:
        ge |= rows == h - 1
    if global_edges & GE_LEFT:
        ge |= cols == 0
    if global_edges & GE_RIGHT:
        ge |= cols == w - 1
    lab = _labels_impl(nd, fd_res, ge)

    ea, eb, ew = _extract_edges(w_loc, nd, lab)
    ridx = _ring(z.device, h, w)
    ring_w = _host(w_loc.reshape(-1)[ridx], np.float32)
    ring_lab = _host(lab.reshape(-1)[ridx], np.int64)
    ring_nd = _host(nd.reshape(-1)[ridx], bool)
    # ocean contact along global edges: every data cell on a global DEM
    # edge can spill off-grid at its own elevation ([P1] ocean edges)
    if global_edges:
        ge_ring = _host(ge.reshape(-1)[ridx], bool)
        sel = ge_ring & ~ring_nd
        ea = np.concatenate([ea, ring_lab[sel]])
        eb = np.concatenate([eb, np.zeros(int(sel.sum()), np.int64)])
        ew = np.concatenate([ew, ring_w[sel].astype(np.float64)])
    return {"w_loc": w_loc, "lab": lab, "ring_w": ring_w,
            "ring_lab": ring_lab, "ring_nd": ring_nd,
            "edges": (ea, eb, ew)}


def fill_tile_apply(z_tile, wstar_ring, no_data=None, device="cuda"):
    """[P1] pass 2, label-free: re-solve the tile's fill with its border
    ring pinned at the exact global-fill values ``wstar_ring``
    (:func:`ring_index` order, ``-inf`` for never-raised or ocean cells).

    The global fill restricted to the tile is the unique fixpoint of the
    local problem with these Dirichlet values.  Nodata cells are pinned
    drains (``w0 = -BIG``): a NaN reaching ``w0`` would poison the min/max
    fixpoint.  Raises if :data:`APPLY_CAP` rotations do not converge.
    Returns the filled tile, nodata cells restored."""
    z = as_tensor(z_tile, device).to(torch.float32)
    h, w = z.shape
    nd = nodata_like(z, no_data)
    ridx = _ring(z.device, h, w)
    neg = torch.tensor(-BIG, dtype=torch.float32, device=z.device)
    wstar = np.nan_to_num(np.asarray(wstar_ring, np.float32), neginf=-BIG)
    ring_vals = torch.maximum(torch.from_numpy(wstar).to(z.device),
                              z.reshape(-1)[ridx])
    ring_vals = torch.where(nd.reshape(-1)[ridx], neg, ring_vals)
    floor = z.reshape(-1).clone()
    floor[ridx] = ring_vals
    floor = torch.where(nd, neg, floor.view(h, w)).contiguous()
    w0 = torch.where(nd, neg, torch.full_like(z, BIG)).reshape(-1)
    w0[ridx] = ring_vals
    filled, _, done = fill_fixpoint_core(w0.view(h, w), floor, 0.0,
                                         APPLY_CAP, fill_sweep)
    _require_converged(done, "two-pass apply fill", APPLY_CAP)
    return torch.where(nd, z, filled)


def _local_d8_solve(fd_t, wt, what):
    """Exact D8 accumulation of one tile with weights ``wt`` (zero external
    inflow beyond them); raises if :data:`LOCAL_D8_CAP` rotations do not
    converge."""
    acc, _, done = d8_accumulation_info(fd_t, wt, LOCAL_D8_CAP)
    _require_converged(done, what, LOCAL_D8_CAP)
    return acc


def accum_tile_consumer(fd_tile, weights=None, device="cuda"):
    """[P2] pass-1 consumer: local D8 accumulation with zero external
    inflow and per-ring-cell links; only O(perimeter) vectors leave the
    device.

    Returns ``(acc_device, ring)`` where ``ring`` holds numpy
    ``a0``/``fd``/``link_local`` vectors over :func:`ring_index`:
    ``link_local`` is the tile-local flat index of each ring cell's
    in-tile terminal (off-tile-pointing cells pin to themselves)."""
    fd = as_tensor(fd_tile, device).to(torch.int8)
    h, w = fd.shape
    if weights is None:
        weights = torch.ones((h, w), dtype=torch.float32, device=fd.device)
    wt = torch.where(fd < 0, 0.0,
                     as_tensor(weights, fd.device).to(torch.float32))
    acc = _local_d8_solve(fd, wt, "two-pass local D8 solve")
    term = watersheds_from_flowdirs(fd)

    ridx = _ring(fd.device, h, w)
    ring = {
        "a0": _host(acc.reshape(-1)[ridx], np.float64),
        "fd": _host(fd.reshape(-1)[ridx], np.int8),
        "link_local": _host(term.reshape(-1)[ridx], np.int64),
    }
    return acc, ring


def _local_fill_solve(ext, floor_ext, eps, inner_iters, stats=None):
    """Exact local fill fixpoint on a halo-extended block, its ring
    clamped (``w0 == floor`` there): the fill kernel's rotations from
    ``w0 = ext``, where ``ext`` lives.  Raises if ``inner_iters`` rotations
    do not converge (the reference returns the block as it stands).
    ``stats``: a dict whose ``"fill_rotations"`` gains the rotations run
    (each one host sync)."""
    new_ext, iters, done = fill_fixpoint_core(
        ext.contiguous(), floor_ext.contiguous(),
        float(np.float32(eps)), inner_iters, fill_sweep)
    _require_converged(done, "local fill solve", inner_iters)
    if stats is not None:
        stats["fill_rotations"] = stats.get("fill_rotations", 0) + iters
    return new_ext
