"""D8 / D4 steepest-descent flow directions.

Counterpart of ``richdem_tpu.ops.flowdirs`` (``d8_core``, ``d8_flowdirs``)
and of the TPU kernel ``richdem_tpu.ops.pallas_stencils._d8_kernel``.  A
CUDA tensor goes through ``csrc/d8.cu``; a CPU tensor through the plain
shifted-view version :func:`d8_plain`.  Both follow ``d8_core``: slope by
division, off-grid and nodata neighbours invalid, first maximum in
direction order 1..8 with strict ``>``, ``NO_FLOW`` unless the best slope
is > 0, ``FLOWDIR_NO_DATA`` at nodata.  Codes are int8.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from richdem_tpu_torch import topology
from richdem_tpu_torch._build import Kernel, stream_handle
from richdem_tpu_torch.ops.stencil import as_tensor, neighbor, nodata_like

__all__ = ["D8", "d8_plain", "d8_core", "d8_flowdirs"]

_P = ctypes.c_void_p
D8 = Kernel("d8", "rd_d8_flowdirs",
            [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_float, ctypes.c_int, _P])

_FLT_MAX = float(np.finfo(np.float32).max)
_INVALID = -3.0e38  # slope of an invalid neighbour


def _directions(topology_name):
    return (1, 3, 5, 7) if topology_name == "D4" else tuple(range(1, 9))


def _distance(d, cellsize) -> float:
    """float32 ``DR[d] * cellsize``, rounded as the reference rounds it."""
    return float(np.float32(topology.DR[d]) * np.float32(cellsize))


def d8_plain(z, nodata_mask, cellsize=1.0, topology_name="D8"):
    """Plain version of the D8 kernel: one shifted view per direction."""
    z = z.to(torch.float32)
    big = torch.tensor(_FLT_MAX, dtype=torch.float32, device=z.device)
    zed = torch.where(nodata_mask, big, z)
    best = torch.full_like(z, _INVALID)
    code = torch.zeros(z.shape, dtype=torch.int8, device=z.device)
    for d in _directions(topology_name):
        zn = neighbor(zed, d, _FLT_MAX)
        # a device tensor, not a Python scalar: PyTorch's CUDA division by
        # a host scalar multiplies by its reciprocal, which rounds apart
        dist = torch.tensor(_distance(d, cellsize), dtype=torch.float32,
                            device=z.device)
        s = torch.where(zn < big, (z - zn) / dist,
                        torch.tensor(_INVALID, device=z.device))
        take = s > best
        best = torch.where(take, s, best)
        code = torch.where(take, torch.tensor(d, dtype=torch.int8,
                                              device=z.device), code)
    fd = torch.where(best > 0, code, torch.zeros_like(code))
    return torch.where(nodata_mask, torch.full_like(code, -1), fd)


def d8_core(z, nodata_mask, cellsize=1.0, topology_name="D8"):
    """D8/D4 codes (int8) of ``z`` with its nodata mask.  A CUDA tensor
    launches ``csrc/d8.cu`` (raising if it cannot be built or launched); a
    CPU tensor runs :func:`d8_plain`."""
    if topology_name not in ("D8", "D4"):
        raise ValueError(f"topology must be 'D8' or 'D4', "
                         f"not {topology_name!r}")
    if not z.is_cuda:
        return d8_plain(z, nodata_mask, cellsize, topology_name)
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
    out = torch.empty(z.shape, dtype=torch.int8, device=z.device)
    if h == 0 or w == 0:
        return out
    D8.launch(z.data_ptr(), nodata_mask.data_ptr(), out.data_ptr(), h, w,
              _distance(1, cellsize), _distance(2, cellsize),
              int(topology_name == "D4"), stream_handle(z.device))
    return out


def d8_flowdirs(dem, no_data=None, topology_name="D8", cellsize=1.0,
                device="cuda"):
    """Steepest-descent single flow directions of a DEM: a tensor (the
    work runs where it lives) or an array (moved to ``device``)."""
    dem = as_tensor(dem, device)
    return d8_core(dem.to(torch.float32), nodata_like(dem, no_data),
                   cellsize, topology_name)
