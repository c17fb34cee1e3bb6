"""Share of the flat-resolution layer's roofline (``ops/flats.py``,
``csrc/dist_sweep.cu`` on ``csrc/seam_walk.cuh``): ``resolve_flats``
reads the filled DEM (float32), the D8 codes (int8) and the nodata mask
(bool) and writes the resolved codes (int8), 4 + 1 + 1 + 1 = 7 bytes a
cell a step, over the device time of every distance sweep of its three
fixpoints."""

from perfbench.layers import roofline_pct

KERNELS = ("DistSweep",)
BYTES_PER_CELL = 4 + 1 + 1 + 1


def read(run):
    return roofline_pct(run, KERNELS, BYTES_PER_CELL)
