"""Share of the Strahler layer's roofline (``ops/successor.py``,
``csrc/strahler_sweep.cu`` on ``csrc/seam_walk.cuh``): Strahler order
reads the resolved codes (int8) and writes the order (int32), 1 + 4 = 5
bytes a cell a step, over the device time of every Strahler sweep."""

from perfbench.layers import roofline_pct

KERNELS = ("Strahler",)
BYTES_PER_CELL = 1 + 4


def read(run):
    return roofline_pct(run, KERNELS, BYTES_PER_CELL)
