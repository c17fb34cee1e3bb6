"""Share of the D∞ accumulation layer's roofline (``ops/dinf.py``,
``csrc/dinf_sweep.cu`` over ``csrc/flow_sweep.cuh``): the accumulation
reads the angles (float32) and the unit weights (float32) and writes the
accumulation (float32), 12 bytes a cell a step, over the device time of
every kernel instantiated over the D∞ field (``DinfField``): the sweeps,
and any later pass over the same field."""

from perfbench.layers import roofline_pct

KERNELS = ("DinfField",)
BYTES_PER_CELL = 4 + 4 + 4


def read(run):
    return roofline_pct(run, KERNELS, BYTES_PER_CELL)
