"""What a per-layer metric's reader works from.

A reader (``perfbench/metrics/<metric>.py``) defines ``read(run)`` and
returns a number, or ``None`` when the run has nothing for it to read (the
metric is then left out of the result line).  ``run`` holds:

* ``trace``: the window's trace (:func:`perfbench.tracing.read_trace`), or
  ``None`` in a run without ``--trace 1``;
* ``steps``: the steps the window ran; ``cells``: cells of one DEM;
* ``counters``: the program's counters, by name, one value a step;
* ``claimed``: every kernel-name pattern some reader claims.

A roofline share is the least time the layer's work could take at the
card's HBM bandwidth, its bytes over :data:`perfbench.peaks.
HBM_BYTES_PER_S`, over the layer's device time: each input array of the
layer's function read once and each output written once, per step,
whatever the kernels read again and however many sweeps they run.
"""

from __future__ import annotations

from perfbench import peaks, tracing


def roofline_pct(run, kernels, bytes_per_cell):
    """The layer's share of its roofline in %, or ``None`` when no kernel
    of ``kernels`` ran in the traced window."""
    if run["trace"] is None or not run["steps"]:
        return None
    seconds = tracing.device_seconds(run["trace"], kernels)
    if seconds <= 0:
        return None
    bound = bytes_per_cell * run["cells"] * run["steps"] \
        / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / seconds


def counter_mean(run, name):
    """The mean a step of a counter the program returns, or ``None``."""
    values = run["counters"].get(name)
    if not values:
        return None
    return sum(values) / len(values)
