"""Depression filling: the two fill engines' kernel wrappers, the multigrid
warm start and the fill entry points.

Counterpart of ``richdem_tpu.ops.fill`` (``auto_epsilon``,
``fill_depressions_info``, ``fill_depressions``, ``fill_epsilon``) and of
``richdem_tpu.ops.pallas_folded`` (``fill_fixpoint_folded``,
``fill_fixpoint_pallas``, ``_fill_engine``, ``_coarse_warm_start``,
``_require_converged``) and ``richdem_tpu.ops.pallas_scan``
(``fill_fixpoint_scan``), which the reference runs on the TPU in their
place.  Two engines reach the same fixpoint:

* ``"folded"`` (the default): rotations of four directional sweeps, down,
  up and both transposed (``csrc/fill_sweep.cu``);
* ``"scan"``: rotations of two sweeps, down and up, each resolving both
  in-row directions with clamp scans (``csrc/fill_scan.cu``).

``engine=None`` reads ``RICHDEM_TPU_FILL_ENGINE`` per call, the reference's
switch with the reference's default.  A CUDA tensor goes through the
hand-written kernels; a CPU tensor through their plain versions
(:mod:`richdem_tpu_torch.ops.sweeps`).  At ε = 0 every engine gives the
same bits; at ε > 0 the scan's tilted chains round differently from the
per-edge steps, within rtol 1e-6, atol 1e-4.
"""

from __future__ import annotations

import ctypes
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from richdem_tpu_torch._build import Kernel, stream_handle
from richdem_tpu_torch.debug import span
from richdem_tpu_torch.ops.stencil import as_tensor, nodata_like
from richdem_tpu_torch.ops.sweeps import (BIG, fill_fixpoint_core,
                                          fill_scan_fixpoint_core,
                                          fill_scan_sweep_plain,
                                          fill_sweep_plain)

__all__ = ["FILL_SWEEP", "FILL_SCAN", "FILL_ENGINES", "fill_engine",
           "fill_sweep", "fill_scan_sweep", "fill_scan_shape",
           "auto_epsilon",
           "fill_depressions_info", "fill_depressions", "fill_epsilon",
           "MULTISCALE_MIN"]

#: Edge length from which the multigrid warm start is used (as the
#: reference's ``pallas_folded._MULTISCALE_MIN``).
MULTISCALE_MIN = 4096

_P = ctypes.c_void_p
_SWEEP_ARGS = [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_float, ctypes.c_int, _P]
FILL_SWEEP = Kernel("fill_sweep", "rd_fill_sweep", _SWEEP_ARGS)
FILL_SCAN = Kernel("fill_scan", "rd_fill_scan", _SWEEP_ARGS)

#: The fill engines, by the names of ``RICHDEM_TPU_FILL_ENGINE``.
FILL_ENGINES = ("folded", "scan")
#: The engine when neither the call nor the environment names one.
FILL_DEFAULT = "folded"


def fill_engine(engine=None) -> str:
    """The fill engine a call runs: ``engine`` if given, else
    ``RICHDEM_TPU_FILL_ENGINE`` read now, else :data:`FILL_DEFAULT`.
    Raises ``ValueError`` on a name outside :data:`FILL_ENGINES`."""
    if engine is None:
        engine = os.environ.get("RICHDEM_TPU_FILL_ENGINE", FILL_DEFAULT)
    if engine not in FILL_ENGINES:
        raise ValueError(f"unknown fill engine {engine!r}; expected one of "
                         f"{FILL_ENGINES}")
    return engine


def _check_raster(x, dtype, name):
    if x.dim() != 2 or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 2-D {dtype} tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")


def _launch_sweep(kernel, w_in, floor, eps, eps_diag, reverse, flag):
    """Check a fill sweep's operands and launch ``kernel`` out of place."""
    _check_raster(w_in, torch.float32, "w_in")
    _check_raster(floor, torch.float32, "floor")
    if floor.shape != w_in.shape or floor.device != w_in.device:
        raise ValueError("floor must match w_in in shape and device")
    if flag.dtype != torch.int32 or flag.device != w_in.device:
        raise ValueError("flag must be an int32 tensor on w_in's device")
    h, wd = w_in.shape
    out = torch.empty_like(w_in)
    if h == 0 or wd == 0:
        return out
    kernel.launch(w_in.data_ptr(), floor.data_ptr(), out.data_ptr(),
                  flag.data_ptr(), h, wd, float(eps), float(eps_diag),
                  int(bool(reverse)), stream_handle(w_in.device))
    return out


def fill_sweep(w_in, floor, eps, eps_diag, reverse, flag):
    """One directional fill sweep (down, or up if ``reverse``) out of place;
    ORs 1 into the int32 ``flag`` when any cell changed.

    A CUDA tensor launches ``csrc/fill_sweep.cu`` (raising if it cannot be
    built or launched); a CPU tensor runs the plain version."""
    if not w_in.is_cuda:
        return fill_sweep_plain(w_in, floor, eps, eps_diag, reverse, flag)
    return _launch_sweep(FILL_SWEEP, w_in, floor, eps, eps_diag, reverse,
                         flag)


def fill_scan_sweep(w_in, floor, eps, eps_diag, reverse, flag):
    """One scan fill sweep (down, or up if ``reverse``) out of place, both
    in-row directions resolved; ORs 1 into the int32 ``flag`` when any cell
    changed.

    A CUDA tensor launches ``csrc/fill_scan.cu`` (raising if it cannot be
    built or launched); a CPU tensor runs
    :func:`~richdem_tpu_torch.ops.sweeps.fill_scan_sweep_plain`."""
    if not w_in.is_cuda:
        return fill_scan_sweep_plain(w_in, floor, eps, eps_diag, reverse,
                                     flag)
    return _launch_sweep(FILL_SCAN, w_in, floor, eps, eps_diag, reverse,
                         flag)


def fill_scan_shape(width):
    """The scan kernel's launch for rows of ``width`` columns, from its
    library (built if needed): ``cluster`` CTAs, ``segment`` columns a
    CTA, consumer ``threads`` a CTA, ``columns`` a thread, ring ``stages``
    and ``shared_bytes`` a CTA.  Raises if rows that wide do not fit."""
    out = (ctypes.c_int * 6)()
    rc = FILL_SCAN.entry("rd_fill_scan_shape", [ctypes.c_int,
                                                ctypes.c_void_p])(width, out)
    if rc != 0:
        raise ValueError(f"the scan fill kernel takes no rows of {width} "
                         "columns (its segment rows do not fit shared "
                         "memory)")
    return dict(zip(("cluster", "segment", "threads", "columns", "stages",
                     "shared_bytes"), out))


def _f32(x) -> float:
    return float(np.float32(x))


#: float32 rounding to nearest: ``|fl(x) - x| <= U32·|x| + TINY32``
#: (TINY32, half the least subnormal, covers results below the normals).
U32 = 2.0 ** -24
TINY32 = 2.0 ** -150


def _round_up_f32(x64):
    """The least float32 at or above each float64 of ``x64``."""
    x = x64.to(torch.float32)
    up = torch.nextafter(x, torch.full_like(x, math.inf))
    return torch.where(x.double() < x64, up, x)


def _coarse_warm_start(zed, eps, factor=8, max_iters=256):
    """Multigrid upper bound of the float32 fine fixpoint ``W*``: fill the
    block-max-pooled DEM with a coarse ``ε_c``, raise it by ``δ`` and
    upsample, ``U = max(Z, Wc + δ)``.  Nodata cells carry -BIG in ``zed``.
    A valid ``w0`` for the monotone-decreasing sweeps, which then reach
    ``W*`` exactly.

    Why ``U ≥ W*``, with ``f = factor``.  Every block ``C0`` with data has
    a coarse path ``C0 … Cm`` to the coarse edge along which the coarse
    fixpoint is its own chain, ``Wc(Cj) = max(Zc(Cj), fl(Wc(Cj+1) + ε_c))``.
    From a cell ``c`` of ``C0`` a fine path walks straight into each next
    block (at most ``f`` steps a block, through cells of the two blocks
    only, each at most its block's maximum ``Zc``), then to the grid edge
    in ``Cm``; it ends early at a nodata cell, which drains.  ``W*`` is at
    most the fine chain ``B(p) = max(Z(p), fl(B(next) + ε))`` along that
    path.  Each rounding errs by at most ``U32·M + TINY32`` with ``M``
    bounding the values involved (the data's and the coarse fill's largest
    magnitude, plus ``δ + ε``), so a fine step rises at most ``ε' = ε +
    U32·M + TINY32`` and a coarse step at least ``ε_c - U32·(M + ε_c) -
    TINY32``.  A cell of the path in block ``Cj`` lies at most ``(j+1)·f -
    1`` steps from ``c``, so

        W*(c) ≤ max_j Zc(Cj) + ((j+1)·f - 1)·ε'
              ≤ max_j Zc(Cj) + j·(ε_c - U32·(M + ε_c) - TINY32) + (f-1)·ε'
              ≤ Wc(C0) + δ,      δ = (f-1)·ε',

    given ``ε_c - U32·(M + ε_c) - TINY32 ≥ f·ε'``, which the start checks
    after the coarse solve (raising ``ε_c`` and solving again when it
    fails).  ``Wc + δ`` is rounded up to float32.  ``δ`` is the rise inside
    the start block, as when the block's own maximum is the spill of a pit
    in the block: without it the start lies below ``W*`` there.  ``ε_c``
    stays ``2·f²·ε`` (the reference's scaling) wherever that passes the
    check.  At ε = 0 no step rounds: ``ε_c = δ = 0`` and ``U`` is the
    plain upsampled coarse fill."""
    h, w = zed.shape
    ph, pw = (-h) % factor, (-w) % factor
    zp = F.pad(zed, (0, pw, 0, ph), value=-BIG)
    zc = F.max_pool2d(zp[None, None], factor, factor)[0, 0].contiguous()
    coarse_eps = _f32(np.float32(eps) * np.float32(2.0 * factor * factor))

    def solve(ce):
        wc, _, _ = fill_fixpoint_core(torch.full_like(zc, BIG), zc, ce,
                                      max_iters, fill_sweep)
        return wc

    wc = solve(coarse_eps)
    if eps > 0:
        zmax = float(torch.where(zed > -BIG / 2, zed.abs(), 0.0).max())
        data = zc > -BIG / 2
        for _ in range(4):
            live = data & (wc < BIG / 2)
            m0 = max(zmax, float(torch.where(live, wc.abs(), 0.0).max()))
            # one fine step's rise ε' (M = m0 + δ + ε, δ = (f-1)·ε')
            eps_f = ((eps + U32 * (m0 + eps) + TINY32)
                     / (1.0 - U32 * (factor - 1)))
            need = factor * eps_f + U32 * (m0 + coarse_eps) + TINY32
            if coarse_eps >= need:
                break
            coarse_eps = float(_round_up_f32(
                torch.tensor(2.0 * need, dtype=torch.float64)))
            wc = solve(coarse_eps)
        else:
            raise RuntimeError("multigrid start: no coarse epsilon bounds "
                               "the fine steps' rounding")
        wc = _round_up_f32(wc.double() + (factor - 1) * eps_f)
    up = wc.repeat_interleave(factor, 0).repeat_interleave(factor, 1)
    return torch.maximum(up[:h, :w], zed)


def auto_epsilon(dem, dtype=None) -> float:
    """Smallest safe fixed epsilon for a DEM: 2 ulp at the max |elevation|
    plus headroom for accumulation across the grid diameter; the same
    float as ``richdem_tpu.ops.fill.auto_epsilon``.

    ``dem``: a tensor, from which only one scalar leaves the device, or an
    array.  Non-finite elevations are ignored (nodata sentinels are not)."""
    if torch.is_tensor(dem):
        dtype = np.dtype(dtype or str(dem.dtype).removeprefix("torch."))
        zab = torch.abs(dem)
        zab = torch.where(torch.isfinite(zab), zab, torch.zeros_like(zab))
        scale = max(float(torch.max(zab)), 1.0)
        shape = tuple(dem.shape)
    else:
        z = np.asarray(dem)
        dtype = np.dtype(dtype or z.dtype)
        scale = float(np.max(np.abs(z[np.isfinite(z)]), initial=1.0))
        shape = z.shape
    diam = sum(shape[-2:])
    # increments must stay resolvable after `diam` additions
    return float(np.finfo(dtype).eps * scale * 4 *
                 max(1, int(np.log2(max(diam, 2)))))


def fill_depressions_info(dem, nodata_mask=None, eps=0.0, max_iters=1024,
                          w0=None, scale_diagonal=False, eps_diag=None,
                          engine=None):
    """Depression fill; returns ``(filled, iters, converged)`` with
    ``iters`` the number of rotations run (of four sweeps for the folded
    engine, two for the scan engine).

    ``w0``: optional warm start (an upper bound of the answer).  At edge ≥
    :data:`MULTISCALE_MIN` with no ``w0`` and no diagonal cost of its own,
    the multigrid warm start is used (on the folded engine, as in the
    reference).  ``eps_diag``: the cost of a diagonal edge (``eps`` when
    None); ``BIG / 2`` prices diagonals out (a D4 fill).
    ``scale_diagonal``: ``eps_diag = f32(eps·√2)`` (Planchon–Darboux
    flavour).  ``engine``: ``"folded"``, ``"scan"`` or None
    (:func:`fill_engine`).  Nodata cells drain and are returned
    unchanged."""
    with span("rd.fill"):
        eng = fill_engine(engine)
        z32 = dem.to(torch.float32)
        h, wd = z32.shape
        if nodata_mask is None:
            nodata_mask = torch.zeros(z32.shape, dtype=torch.bool,
                                      device=z32.device)
        neg = torch.tensor(-BIG, dtype=torch.float32, device=z32.device)
        if scale_diagonal:
            if eps_diag is not None:
                raise ValueError("give scale_diagonal or eps_diag, not both")
            eps_diag = eps * math.sqrt(2.0)
        eps_diag = None if eps_diag is None else _f32(eps_diag)
        eps = _f32(eps)
        if (w0 is None and eps_diag is None
                and max(h, wd) >= MULTISCALE_MIN):
            w0 = _coarse_warm_start(torch.where(nodata_mask, neg, z32), eps)
        if w0 is None:
            w0 = torch.full_like(z32, BIG)
        floor = torch.where(nodata_mask, neg, z32).contiguous()
        w0 = torch.where(nodata_mask, neg, w0.to(torch.float32)).contiguous()
        if eng == "scan":
            w, iters, done = fill_scan_fixpoint_core(w0, floor, eps, max_iters,
                                                     fill_scan_sweep, eps_diag)
        else:
            w, iters, done = fill_fixpoint_core(w0, floor, eps, max_iters,
                                                fill_sweep, eps_diag)
        return torch.where(nodata_mask, z32, w), iters, done


def _require_converged(done, what, cap):
    """Raise on an unconverged fixpoint: a truncated result is a
    correctness bug, not a degraded answer."""
    if not done:
        raise RuntimeError(f"{what} did not converge within {cap} "
                           "iterations; pass a larger cap")


def _rotation_cap(max_rotations, max_iters, default):
    """The cap of rotations, from the port's ``max_rotations`` or the
    reference's ``max_iters`` (``default`` when neither is given);
    ``TypeError`` when both are."""
    if max_rotations is not None and max_iters is not None:
        raise TypeError("give max_rotations or max_iters, not both")
    if max_iters is not None:
        return max_iters
    return default if max_rotations is None else max_rotations


def fill_depressions(dem, no_data=None, eps=0.0, max_iters=1024,
                     scale_diagonal=False, device="cuda", engine=None,
                     eps_diag=None):
    """Plain (or ε) depression fill; returns the filled raster and raises
    if the fixpoint was not reached within ``max_iters`` rotations.

    ``dem``: a tensor (the fill runs where it lives) or an array (moved to
    ``device``).  ``engine``, ``eps_diag``: see
    :func:`fill_depressions_info`."""
    dem = as_tensor(dem, device)
    mask = nodata_like(dem, no_data)
    filled, _, done = fill_depressions_info(dem, mask, eps=eps,
                                            max_iters=max_iters,
                                            scale_diagonal=scale_diagonal,
                                            eps_diag=eps_diag, engine=engine)
    _require_converged(done, "depression fill", max_iters)
    return filled.to(dem.dtype)


def fill_epsilon(dem, no_data=None, eps=None, max_iters=1024,
                 device="cuda", engine=None):
    """ε fill, with :func:`auto_epsilon` of the DEM by default."""
    dem = as_tensor(dem, device)
    if eps is None:
        eps = auto_epsilon(dem)
    return fill_depressions(dem, no_data=no_data, eps=eps,
                            max_iters=max_iters, engine=engine)
