"""Terrain attributes from the 3×3 window: Horn 1981 slope/aspect and
Zevenbergen & Thorne 1987 curvatures.

Off-grid and nodata neighbours read the centre value; nodata cells give NaN.

* :func:`terrain_core` is the counterpart of
  ``richdem_tpu.ops.terrain.terrain_core`` (rise/run by ``hypot``).  The
  pipeline's slope/TWI runs it as plain tensor code on every device, as the
  reference runs the XLA version on the TPU there.
* :func:`terrain_attribute` / :func:`slope_riserun` are the counterparts of
  ``richdem_tpu.ops.terrain.terrain_attribute``, which the TPU runs through
  ``pallas_stencils._terrain_kernel`` (``terrain_attribute_pallas``).  A CUDA
  tensor goes through the hand-written kernel ``csrc/terrain.cu``, which
  finishes atan/atan2 in the kernel; a CPU tensor through its plain version
  :func:`terrain_plain`, which follows the kernel's formula (rise/run as
  ``sqrt(fx² + fy²)``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from richdem_tpu_torch._build import Kernel, stream_handle
from richdem_tpu_torch.debug import span
from richdem_tpu_torch.ops.stencil import as_tensor, neighbor, nodata_like

__all__ = ["TERRAIN_ATTRIBUTES", "TERRAIN", "terrain_core", "terrain_plain",
           "terrain_fused", "terrain_attribute", "slope_riserun"]

TERRAIN_ATTRIBUTES = (
    "slope_riserun", "slope_percentage", "slope_degrees", "slope_radians",
    "aspect", "curvature", "planform_curvature", "profile_curvature",
)


def _window(z, nodata_mask):
    """(a, b, c, d, e, f, g, h, i), row-major, invalid neighbours → centre."""
    zed = torch.where(nodata_mask, torch.full_like(z, math.nan), z)

    def nb(d):
        v = neighbor(zed, d, math.nan)
        return torch.where(torch.isnan(v), z, v)

    # direction codes: 2=NW 3=N 4=NE 1=W 5=E 8=SW 7=S 6=SE
    return (nb(2), nb(3), nb(4), nb(1), z, nb(5), nb(8), nb(7), nb(6))


def _sqrt_riserun(fx, fy):
    return torch.sqrt(fx * fx + fy * fy)


def terrain_core(z, nodata_mask, zscale, cellsize, attrib,
                 riserun=torch.hypot):
    """One attribute of :data:`TERRAIN_ATTRIBUTES` as a float32 raster.

    ``riserun(fx, fy)``: the gradient norm (``hypot``, as the reference's
    ``terrain_core``)."""
    with span("rd.terrain"):
        if attrib not in TERRAIN_ATTRIBUTES:
            raise ValueError(f"unknown terrain attribute {attrib!r}; "
                             f"expected one of {TERRAIN_ATTRIBUTES}")
        dev = z.device

        def t(x):  # a device scalar, so divisions stay true divisions
            return torch.tensor(x, dtype=torch.float32, device=dev)

        compute = z.to(torch.float32) * t(zscale)
        L = t(cellsize)
        a, b, c, d, e, f, g, h, i = _window(compute, nodata_mask)
        fx = ((c + 2 * f + i) - (a + 2 * d + g)) / (8 * L)
        fy = ((g + 2 * h + i) - (a + 2 * b + c)) / (8 * L)

        if attrib == "slope_riserun":
            out = riserun(fx, fy)
        elif attrib == "slope_percentage":
            out = 100.0 * riserun(fx, fy)
        elif attrib == "slope_radians":
            out = torch.atan(riserun(fx, fy))
        elif attrib == "slope_degrees":
            out = torch.rad2deg(torch.atan(riserun(fx, fy)))
        elif attrib == "aspect":
            flat = (fx == 0) & (fy == 0)
            out = torch.where(flat, t(-1.0),
                              torch.rad2deg(torch.atan2(-fx, fy)) % 360.0)
        else:
            D = ((d + f) / t(2.0) - e) / (L * L)
            E = ((b + h) / t(2.0) - e) / (L * L)
            F = (-a + c + g - i) / (t(4.0) * L * L)
            G = (-d + f) / (t(2.0) * L)
            H = (b - h) / (t(2.0) * L)
            g2h2 = G * G + H * H
            den = torch.clamp(g2h2, min=1e-30)
            if attrib == "curvature":
                out = -2.0 * (D + E) * 100.0
            elif attrib == "planform_curvature":
                out = torch.where(
                    g2h2 == 0.0, t(0.0),
                    2.0 * (D * H * H + E * G * G - F * G * H) / den * 100.0)
            else:  # profile_curvature
                out = torch.where(
                    g2h2 == 0.0, t(0.0),
                    -2.0 * (D * G * G + E * H * H + F * G * H) / den * 100.0)
        return torch.where(nodata_mask, t(math.nan), out)


_P = ctypes.c_void_p
TERRAIN = Kernel("terrain", "rd_terrain",
                 [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                  ctypes.c_float, ctypes.c_int, _P])


def terrain_plain(z, nodata_mask, zscale, cellsize, attrib):
    """Plain version of the terrain kernel: :func:`terrain_core` with the
    kernel's ``sqrt(fx² + fy²)`` (as ``pallas_stencils._terrain_kernel``
    has it) in place of ``hypot``."""
    return terrain_core(z, nodata_mask, zscale, cellsize, attrib,
                        riserun=_sqrt_riserun)


def terrain_fused(z, nodata_mask, zscale, cellsize, attrib):
    """One attribute of a float32 raster.  A CUDA tensor launches
    ``csrc/terrain.cu`` (raising if it cannot be built or launched); a CPU
    tensor runs :func:`terrain_plain`."""
    if attrib not in TERRAIN_ATTRIBUTES:
        raise ValueError(f"unknown terrain attribute {attrib!r}; "
                         f"expected one of {TERRAIN_ATTRIBUTES}")
    if not z.is_cuda:
        return terrain_plain(z, nodata_mask, zscale, cellsize, attrib)
    if z.dim() != 2 or z.dtype != torch.float32:
        raise ValueError(f"z: expected a 2-D float32 tensor, got {z.dtype} "
                         f"{tuple(z.shape)}")
    if (nodata_mask.dtype != torch.bool or nodata_mask.shape != z.shape
            or nodata_mask.device != z.device):
        raise ValueError("nodata_mask must be a bool tensor shaped and "
                         "placed like z")
    z = z.contiguous()
    nodata_mask = nodata_mask.contiguous()
    h, w = z.shape
    out = torch.empty_like(z)
    if h == 0 or w == 0:
        return out
    TERRAIN.launch(z.data_ptr(), nodata_mask.data_ptr(), out.data_ptr(), h,
                   w, float(zscale), float(cellsize),
                   TERRAIN_ATTRIBUTES.index(attrib), stream_handle(z.device))
    return out


def terrain_attribute(dem, attrib, zscale=1.0, cellsize=1.0, no_data=None,
                      device="cuda"):
    """One attribute of :data:`TERRAIN_ATTRIBUTES`; nodata cells → NaN.

    ``dem``: a tensor (the work runs where it lives) or an array (moved to
    ``device``)."""
    with span("rd.terrain"):
        z = as_tensor(dem, device)
        return terrain_fused(z.to(torch.float32), nodata_like(z, no_data),
                             zscale, cellsize, attrib)


def slope_riserun(dem, zscale=1.0, cellsize=1.0, no_data=None,
                  device="cuda"):
    return terrain_attribute(dem, "slope_riserun", zscale, cellsize, no_data,
                             device)
