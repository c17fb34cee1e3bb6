"""Share of the multi-flow accumulation layer's roofline (``ops/mfd.py``,
``csrc/mfd_sweep.cu`` over ``csrc/flow_sweep.cuh``): the accumulation
reads the (H, W, 8) float32 proportions and writes the accumulation
(float32), 36 bytes a cell a step, over the device time of every
multi-flow sweep."""

from perfbench.layers import roofline_pct

KERNELS = ("MfdField",)
BYTES_PER_CELL = 8 * 4 + 4


def read(run):
    return roofline_pct(run, KERNELS, BYTES_PER_CELL)
