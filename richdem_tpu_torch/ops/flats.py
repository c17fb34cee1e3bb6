"""Flat resolution as masked unit-cost distance fixpoints.

Counterpart of ``richdem_tpu.ops.flats`` on the path the TPU runs
(``_resolve_impl_pallas``, ``resolve_flats``,
``flat_mask_and_labels_device``), after Barnes, Lehman & Mulla 2014.  The
oracle's two synchronised BFS passes are unit-cost shortest paths, run here
as Gauss–Seidel distance fixpoints (:func:`ops.sweeps.dist_fixpoint_core`):

1. ``T`` towards lower — hop distance from the flat's outlets;
2. ``D`` away from higher — hop distance, seeded 1, from NO_FLOW cells next
   to higher ground;
3. per-flat ``max(D)`` — min-plus on ``-D`` over zero-cost flat edges;
4. ``mask = 2T + (maxD + 1 − D)`` and steepest descent on it.

A CUDA tensor sweeps with the hand-written kernel ``csrc/dist_sweep.cu``
(one kernel covers both TPU engines: ``pallas_sweeps._dist_down_kernel`` and
``pallas_scan._dist_scan_kernel`` relax the same fixpoint; on the walk of
``csrc/seam_walk.cuh``, narrow tiles that trade edge values); a CPU tensor
with its plain version :func:`ops.sweeps.dist_sweep_plain`, the sweep over
whole rows, so one sweep is bitwise the kernel's.  The fields are exact
small integers, so the resolved directions and the mask equal the oracle's
bit for bit, whatever the number of rotations.

Membership shortcut (from ``_resolve_impl_pallas``, which saves the exact
membership flood): every edge predicate already requires equal elevations
between the two cells, and NO_FLOW cells are flat members by definition, so
exact connected-component membership can be replaced by the local closure
``in_flat = noflow | (data ∧ ∃ equal-z data neighbour)`` without changing
any resolved direction or mask value: a cell that is only in this superset
can seed or relax a NO_FLOW chain only through an equal-z adjacency, which
would have made it an exact member too.  The superset differs only on
equal-z components that hold no NO_FLOW cell; those produce no drained cell
and no mask.  The returned ``in_flat`` is this superset.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from richdem_tpu_torch import topology
from richdem_tpu_torch._build import Kernel, stream_handle
from richdem_tpu_torch.debug import span
from richdem_tpu_torch.ops.fill import _require_converged
from richdem_tpu_torch.ops.stencil import as_tensor, neighbor, nodata_like
from richdem_tpu_torch.ops.successor import block_flags, walk_shape
from richdem_tpu_torch.ops.sweeps import (BIG, DIST_MODES, F_DATA, F_INFLAT,
                                          F_NOFLOW, ZBIG, dist_context,
                                          dist_fixpoint_core,
                                          dist_sweep_plain)

__all__ = ["DIST_SWEEP", "dist_sweep", "dist_shape", "flat_fields",
           "resolve_flats_info", "resolve_flats",
           "flat_mask_and_labels_device"]

_UNREACHED = BIG / 2
_NO_FLOW = int(topology.NO_FLOW)

_P = ctypes.c_void_p
DIST_SWEEP = Kernel("dist_sweep", "rd_dist_sweep",
                    [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_float, ctypes.c_int, _P,
                     ctypes.c_int, _P])


def dist_sweep(w_in, z, flags, mode, step, reverse, flag):
    """One directional masked-distance sweep (down, or up if ``reverse``)
    out of place; ORs 1 into the int32 ``flag`` when any cell changed.

    A CUDA tensor launches ``csrc/dist_sweep.cu`` (raising if it cannot be
    built or launched, its cooperative launch included); a CPU tensor runs
    the plain version."""
    if mode not in DIST_MODES:
        raise ValueError(f"unknown distance mode {mode!r}; expected one of "
                         f"{DIST_MODES}")
    if not w_in.is_cuda:
        return dist_sweep_plain(w_in, z, flags, mode, step, reverse, flag)
    for x, dt, name in ((w_in, torch.float32, "w_in"),
                        (z, torch.float32, "z"), (flags, torch.int8, "flags")):
        if (x.dim() != 2 or x.dtype != dt or not x.is_contiguous()
                or x.shape != w_in.shape or x.device != w_in.device):
            raise ValueError(f"{name}: expected a contiguous {dt} tensor "
                             "shaped and placed like w_in")
    if flag.dtype != torch.int32 or flag.device != w_in.device:
        raise ValueError("flag must be an int32 tensor on w_in's device")
    h, wd = w_in.shape
    out = torch.empty_like(w_in)
    if h == 0 or wd == 0:
        return out
    blk = block_flags(wd, w_in.device)
    DIST_SWEEP.launch(w_in.data_ptr(), z.data_ptr(), flags.data_ptr(),
                      out.data_ptr(), flag.data_ptr(), h, wd,
                      DIST_MODES.index(mode), float(step), int(bool(reverse)),
                      blk.data_ptr(), blk.numel(), stream_handle(w_in.device))
    return out


def dist_shape():
    """The distance kernel's walk
    (:func:`~richdem_tpu_torch.ops.successor.walk_shape`)."""
    return walk_shape(DIST_SWEEP, "rd_dist_shape")


def _scalar(x, like):
    """A float32 scalar tensor on ``like``'s device: arithmetic with it
    stays float32 on every device."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def flat_fields(z, fd, nodata_mask):
    """The per-cell inputs of the distance fixpoints, as
    ``_resolve_impl_pallas`` builds them: a dict of ``zed`` (float32, nodata
    at :data:`ZBIG`), ``flags`` (int8 bits data/NO_FLOW/in-flat),
    ``noflow``, ``in_flat``, ``drain``, ``outlet`` and ``high_seed``."""
    zf = z.to(torch.float32)
    data = ~nodata_mask
    noflow = (fd == _NO_FLOW) & data
    zbig = _scalar(ZBIG, zf)
    zed = torch.where(nodata_mask, zbig, zf)
    # one shift at a time: no stacked (8, H, W) temporaries
    any_eq = torch.zeros_like(data)
    any_higher = torch.zeros_like(data)
    near_nodata = torch.zeros_like(data)
    for d in range(1, 9):
        zb = neighbor(zed, d, float("nan"))
        any_eq |= (zed == zb) & (zb < zbig)
        any_higher |= (zb > zed) & (zb < zbig)
        near_nodata |= neighbor(nodata_mask, d, False)
    in_flat = data & (noflow | any_eq)
    flags = (data.to(torch.int8) * F_DATA + noflow.to(torch.int8) * F_NOFLOW
             + in_flat.to(torch.int8) * F_INFLAT)

    h, w = zf.shape
    rows = torch.arange(h, device=zf.device)[:, None]
    cols = torch.arange(w, device=zf.device)[None, :]
    on_border = (rows == 0) | (rows == h - 1) | (cols == 0) | (cols == w - 1)
    # drains: NO_FLOW cells on the border or next to nodata drain off-grid
    # (fill semantics), seed T at 0 and keep NO_FLOW
    drain = noflow & (on_border | near_nodata)
    return {"zed": zed, "flags": flags, "noflow": noflow,
            "in_flat": in_flat, "drain": drain,
            "outlet": in_flat & (~noflow | drain),
            "high_seed": noflow & in_flat & any_higher}


def resolve_flats_info(z, fd, nodata_mask, max_iters=256, sweep=dist_sweep):
    """``(resolved, mask, in_flat, rotations, converged)`` without raising.

    ``rotations``: the three fixpoints' rotation counts (towards, away,
    maxd); ``converged``: whether all three reached their fixpoint.
    ``mask`` is int32, ``in_flat`` the local membership superset (module
    docstring)."""
    with span("rd.flats"):
        ff = flat_fields(z, fd, nodata_mask)
        ctx = dist_context(ff["zed"], ff["flags"])
        big = _scalar(BIG, ff["zed"])

        def seeded(where, value):
            return torch.where(where, _scalar(value, big), big)

        T, i1, d1 = dist_fixpoint_core(seeded(ff["outlet"], 0.0), ctx,
                                       "towards", 1.0, max_iters, sweep)
        D, i2, d2 = dist_fixpoint_core(seeded(ff["high_seed"], 1.0), ctx,
                                       "away", 1.0, max_iters, sweep)
        zero = _scalar(0.0, big)
        reached_d = D < _UNREACHED
        d_finite = torch.where(reached_d, D, zero)
        neg_max, i3, d3 = dist_fixpoint_core(
            torch.where(ff["in_flat"], -d_finite, big), ctx, "maxd", 0.0,
            max_iters, sweep)
        max_d = -neg_max

        away_term = torch.where(reached_d, max_d + 1.0 - D, zero)
        drained = (ff["noflow"] & ~ff["drain"] & ff["in_flat"]
                   & (T < _UNREACHED))
        mask = torch.where(drained, 2.0 * T + away_term, zero)

        # steepest descent on the mask over equal-z neighbours in a flat;
        # strict > keeps the first maximum in direction order 1..8
        zed, in_flat = ff["zed"], ff["in_flat"]
        zbig = _scalar(ZBIG, zed)
        best = torch.full_like(mask, -BIG)
        kbest = torch.zeros(mask.shape, dtype=torch.int8,
                            device=mask.device)
        for d in range(1, 9):
            zb = neighbor(zed, d, float("nan"))
            eq = (zed == zb) & (zb < zbig)
            # 1/DR in float64, rounded once to float32 (as the reference)
            inv = _scalar(float(np.float32(1.0 / topology.DR[d])), mask)
            slope = torch.where(eq & neighbor(in_flat, d, False),
                                (mask - neighbor(mask, d, BIG)) * inv,
                                _scalar(-BIG, mask))
            upd = slope > best
            best = torch.where(upd, slope, best)
            kbest = torch.where(upd, torch.tensor(d, dtype=torch.int8,
                                                  device=mask.device), kbest)
        new_dir = torch.where(best > 0, kbest.to(fd.dtype),
                              torch.zeros_like(fd))
        resolved = torch.where(drained & (fd == _NO_FLOW), new_dir, fd)
        return (resolved, mask.to(torch.int32), in_flat, (i1, i2, i3),
                d1 and d2 and d3)


def _inputs(dem, flowdirs, no_data, device):
    z = as_tensor(dem, device)
    fd = as_tensor(flowdirs, z.device)
    if fd.shape != z.shape:
        raise ValueError(f"flowdirs {tuple(fd.shape)} do not match the DEM "
                         f"{tuple(z.shape)}")
    return z, fd, nodata_like(z, no_data)


def resolve_flats(dem, flowdirs, no_data=None, max_iters=256,
                  return_info=False, device="cuda"):
    """Flow directions with flats drained; raises if a distance fixpoint
    does not converge within ``max_iters`` rotations.

    ``dem``/``flowdirs``: tensors (the work runs where ``dem`` lives) or
    arrays (moved to ``device``).  ``return_info`` also returns ``(total
    rotations of the three fixpoints, converged)``."""
    z, fd, nd = _inputs(dem, flowdirs, no_data, device)
    resolved, _, _, rotations, done = resolve_flats_info(z, fd, nd,
                                                         max_iters)
    _require_converged(done, "flat-resolution distance sweeps", max_iters)
    if return_info:
        return resolved, sum(rotations), done
    return resolved


def flat_mask_and_labels_device(dem, flowdirs, no_data=None, max_iters=256,
                                device="cuda"):
    """``(flat_mask, in_flat)``: the int32 mask and the membership superset
    (labels are implicit: the mask is consistent within each flat).
    Raises on a non-converged fixpoint, as :func:`resolve_flats` does."""
    z, fd, nd = _inputs(dem, flowdirs, no_data, device)
    _, mask, in_flat, _, done = resolve_flats_info(z, fd, nd, max_iters)
    _require_converged(done, "flat-resolution distance sweeps", max_iters)
    return mask, in_flat
