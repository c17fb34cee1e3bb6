"""Share of the successor walks' roofline (``ops/successor.py``,
``csrc/resolve_sweep.cu`` on ``csrc/seam_walk.cuh``): the watersheds read
the resolved codes (int8) and write the labels (int32), 1 + 4 bytes a
cell; the upslope cells read the codes (int8) and the gauges (bool) and
write the mask (bool), 1 + 1 + 1; 8 bytes a cell a step, over the device
time of every resolve sweep of both walks."""

from perfbench.layers import roofline_pct

KERNELS = ("ResolveSweep",)
BYTES_PER_CELL = (1 + 4) + (1 + 1 + 1)


def read(run):
    return roofline_pct(run, KERNELS, BYTES_PER_CELL)
