"""Carry rasters between numpy and the port.

The system has no parameters: what crosses the boundary is data.  Both
sides of every comparison go through these functions, so the reference and
the port see the same float32 DEM and are compared in the same dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

from richdem_tpu_torch.ops.stencil import nodata_like

__all__ = ["from_numpy", "to_numpy"]

#: dtypes of the reference pipeline's output dict
_DTYPES = {"filled": np.float32, "flowdirs": np.int8, "accum": np.float32,
           "slope": np.float32, "twi": np.float32,
           "fill_iters": np.int32, "accum_rotations": np.int32,
           "fill_converged": np.bool_, "accum_converged": np.bool_}


def from_numpy(dem, no_data=None, device="cuda"):
    """``(z, nodata_mask)``: the DEM as float32 on ``device`` (the card
    unless another is asked for) and its mask, as
    ``richdem_tpu.ops.stencil.nodata_like`` builds it (NaN sentinels
    included)."""
    z = torch.from_numpy(np.ascontiguousarray(dem, dtype=np.float32))
    z = z.to(device)
    return z, nodata_like(z, no_data)


def to_numpy(out):
    """A pipeline output dict as numpy, in the reference's dtypes."""
    res = {}
    for key, val in out.items():
        if torch.is_tensor(val):
            val = val.detach().cpu().numpy()
        res[key] = np.asarray(val).astype(_DTYPES[key], copy=False)
    return res
