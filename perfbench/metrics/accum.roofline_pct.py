"""Share of the D8 accumulation layer's roofline (``ops/accum.py``,
``csrc/accum_sweep.cu``): the accumulation reads the codes (int8) and
the weights (float32) and writes the accumulation (float32), 9 bytes a
cell a step, over the device time of every accumulation sweep."""

from perfbench.layers import roofline_pct

KERNELS = ("accum_sweep_kernel",)
BYTES_PER_CELL = 1 + 4 + 4


def read(run):
    return roofline_pct(run, KERNELS, BYTES_PER_CELL)
