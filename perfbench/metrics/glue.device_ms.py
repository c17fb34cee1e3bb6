"""Device time a step, in ms, of every operation that no other layer's
reader claims (``KERNELS`` of ``perfbench/metrics/*.py``): PyTorch's
elementwise kernels, copies and memsets inside ``ops/*`` and
``pipeline.py``, and the program's hand-written kernels that no layer
claims yet (D8's stencil among them).  Any other name, a renamed kernel
too, counts here, so no device time drops out of sight."""

from perfbench import tracing


def read(run):
    if not run["trace"] or not run["trace"]["device"] or not run["steps"]:
        return None
    seconds = tracing.device_seconds(run["trace"], exclude=run["claimed"])
    return 1e3 * seconds / run["steps"]
