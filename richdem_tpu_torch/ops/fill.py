"""Depression filling: the fill-sweep kernel's wrapper, the multigrid warm
start and the fill entry points.

Counterpart of ``richdem_tpu.ops.fill`` (``auto_epsilon``,
``fill_depressions_info``, ``fill_depressions``, ``fill_epsilon``) and of
``richdem_tpu.ops.pallas_folded``
(``fill_fixpoint_folded``, ``_coarse_warm_start``, ``_require_converged``),
which the reference runs on the TPU in their place.  A CUDA tensor goes
through the hand-written kernel ``csrc/fill_sweep.cu``; a CPU tensor through
its plain version
(:func:`richdem_tpu_torch.ops.sweeps.fill_sweep_plain`).  Both reach the
same fixpoint as the reference, bit for bit at ε = 0.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from richdem_tpu_torch._build import Kernel, stream_handle
from richdem_tpu_torch.ops.stencil import as_tensor, nodata_like
from richdem_tpu_torch.ops.sweeps import (BIG, fill_fixpoint_core,
                                          fill_sweep_plain)

__all__ = ["FILL_SWEEP", "fill_sweep", "auto_epsilon",
           "fill_depressions_info", "fill_depressions", "fill_epsilon",
           "MULTISCALE_MIN"]

#: Edge length from which the multigrid warm start is used (as the
#: reference's ``pallas_folded._MULTISCALE_MIN``).
MULTISCALE_MIN = 4096

_P = ctypes.c_void_p
FILL_SWEEP = Kernel("fill_sweep", "rd_fill_sweep",
                    [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                     ctypes.c_float, ctypes.c_float, ctypes.c_int, _P])


def _check_raster(x, dtype, name):
    if x.dim() != 2 or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 2-D {dtype} tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")


def fill_sweep(w_in, floor, eps, eps_diag, reverse, flag):
    """One directional fill sweep (down, or up if ``reverse``) out of place;
    ORs 1 into the int32 ``flag`` when any cell changed.

    A CUDA tensor launches ``csrc/fill_sweep.cu`` (raising if it cannot be
    built or launched); a CPU tensor runs the plain version."""
    if not w_in.is_cuda:
        return fill_sweep_plain(w_in, floor, eps, eps_diag, reverse, flag)
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
    FILL_SWEEP.launch(w_in.data_ptr(), floor.data_ptr(), out.data_ptr(),
                      flag.data_ptr(), h, wd, float(eps), float(eps_diag),
                      int(bool(reverse)), stream_handle(w_in.device))
    return out


def _f32(x) -> float:
    return float(np.float32(x))


def _coarse_warm_start(zed, eps, factor=8, max_iters=256):
    """Multigrid upper bound: fill the block-max-pooled DEM and upsample.
    Any coarse drainage path expands to a fine path with smaller maxima, so
    the upsampled coarse fill is ≥ the fine fixpoint — a valid ``w0`` for
    the monotone-decreasing sweeps.  A coarse ε step covers ≤ 2·factor² fine
    steps, hence the ε scaling.  Nodata cells already carry -BIG in
    ``zed``."""
    h, w = zed.shape
    ph, pw = (-h) % factor, (-w) % factor
    zp = F.pad(zed, (0, pw, 0, ph), value=-BIG)
    zc = F.max_pool2d(zp[None, None], factor, factor)[0, 0].contiguous()
    coarse_eps = _f32(np.float32(eps) * np.float32(2.0 * factor * factor))
    wc, _, _ = fill_fixpoint_core(torch.full_like(zc, BIG), zc, coarse_eps,
                                  max_iters, fill_sweep)
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
                          w0=None, scale_diagonal=False):
    """Depression fill; returns ``(filled, iters, converged)`` with
    ``iters`` the number of rotations (of four sweeps) run.

    ``w0``: optional warm start (an upper bound of the answer).  At edge ≥
    :data:`MULTISCALE_MIN` with no ``w0`` the multigrid warm start is used,
    unless ``scale_diagonal``.  ``scale_diagonal``: diagonal edges cost
    ``f32(eps·√2)`` (Planchon–Darboux flavour), the ``eps_diag`` the
    reference's TPU path hands its fill kernel.  Nodata cells drain and are
    returned unchanged."""
    z32 = dem.to(torch.float32)
    h, wd = z32.shape
    if nodata_mask is None:
        nodata_mask = torch.zeros(z32.shape, dtype=torch.bool,
                                  device=z32.device)
    neg = torch.tensor(-BIG, dtype=torch.float32, device=z32.device)
    eps_diag = _f32(eps * math.sqrt(2.0)) if scale_diagonal else None
    eps = _f32(eps)
    if (w0 is None and eps_diag is None
            and max(h, wd) >= MULTISCALE_MIN):
        w0 = _coarse_warm_start(torch.where(nodata_mask, neg, z32), eps)
    if w0 is None:
        w0 = torch.full_like(z32, BIG)
    floor = torch.where(nodata_mask, neg, z32).contiguous()
    w0 = torch.where(nodata_mask, neg, w0.to(torch.float32)).contiguous()
    w, iters, done = fill_fixpoint_core(w0, floor, eps, max_iters,
                                        fill_sweep, eps_diag)
    return torch.where(nodata_mask, z32, w), iters, done


def _require_converged(done, what, cap):
    """Raise on an unconverged fixpoint: a truncated result is a
    correctness bug, not a degraded answer."""
    if not done:
        raise RuntimeError(f"{what} did not converge within {cap} "
                           "iterations; pass a larger cap")


def fill_depressions(dem, no_data=None, eps=0.0, max_iters=1024,
                     scale_diagonal=False, device="cuda"):
    """Plain (or ε) depression fill; returns the filled raster and raises
    if the fixpoint was not reached within ``max_iters`` rotations.

    ``dem``: a tensor (the fill runs where it lives) or an array (moved to
    ``device``)."""
    dem = as_tensor(dem, device)
    mask = nodata_like(dem, no_data)
    filled, _, done = fill_depressions_info(dem, mask, eps=eps,
                                            max_iters=max_iters,
                                            scale_diagonal=scale_diagonal)
    _require_converged(done, "depression fill", max_iters)
    return filled.to(dem.dtype)


def fill_epsilon(dem, no_data=None, eps=None, max_iters=1024,
                 device="cuda"):
    """ε fill, with :func:`auto_epsilon` of the DEM by default."""
    dem = as_tensor(dem, device)
    if eps is None:
        eps = auto_epsilon(dem)
    return fill_depressions(dem, no_data=no_data, eps=eps,
                            max_iters=max_iters)
