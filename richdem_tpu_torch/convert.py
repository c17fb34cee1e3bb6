"""Carry rasters between numpy and the port.

The system has no parameters: what crosses the boundary is data — DEMs,
D∞ angle rasters, ``(H, W, 8)`` proportions.  Both sides of every
comparison go through these functions, so the reference and the port see
the same float32 inputs and are compared in the same dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

from richdem_tpu_torch.ops.stencil import nodata_like
from richdem_tpu_torch.parallel.mesh import ShardedArray

__all__ = ["from_numpy", "raster_from_numpy", "props_from_numpy",
           "to_numpy"]

#: dtypes of the reference's outputs: the pipeline dict, and the angles,
#: proportions, indices and fixpoint counts of the other flow paths
_DTYPES = {"filled": np.float32, "flowdirs": np.int8, "accum": np.float32,
           "slope": np.float32, "twi": np.float32, "spi": np.float32,
           "angles": np.float32, "props": np.float32,
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


def raster_from_numpy(x, device="cuda"):
    """A float32 raster (D∞ angles, weights, an index) on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
        device)


def props_from_numpy(props, device="cuda"):
    """``(H, W, 8)`` proportions as float32 on ``device``, laid out
    plane-major underneath (the layout the accumulation sweeps read), as
    ``flow_proportions`` returns them."""
    planes = np.ascontiguousarray(np.moveaxis(props, -1, 0),
                                  dtype=np.float32)
    return torch.from_numpy(planes).to(device).permute(1, 2, 0)


def to_numpy(out):
    """A pipeline output dict as numpy, in the reference's dtypes.  A value
    spread over processes (a ``parallel.mesh.ShardedArray``) becomes the
    list of this process's ``(global slices, block)`` pairs, the
    counterpart of a ``jax.Array``'s ``addressable_shards``."""
    res = {}
    for key, val in out.items():
        if isinstance(val, ShardedArray):
            res[key] = [(sh.index, sh.data.detach().cpu().numpy().astype(
                _DTYPES[key], copy=False)) for sh in val.addressable_shards]
            continue
        if torch.is_tensor(val):
            val = val.detach().cpu().numpy()
        res[key] = np.asarray(val).astype(_DTYPES[key], copy=False)
    return res
