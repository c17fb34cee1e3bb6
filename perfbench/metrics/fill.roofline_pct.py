"""Share of the fill layer's roofline (``ops/fill.py``,
``csrc/fill_sweep.cu``, ``csrc/fill_scan.cu``): the fill function reads
the DEM (float32) and its nodata mask (bool) and writes the filled
surface (float32), 9 bytes a cell a step, over the device time of every
fill sweep the step runs (the multigrid start's coarse sweeps too)."""

from perfbench.layers import roofline_pct

KERNELS = ("fill_sweep_kernel", "fill_scan_kernel")
BYTES_PER_CELL = 4 + 1 + 4


def read(run):
    return roofline_pct(run, KERNELS, BYTES_PER_CELL)
