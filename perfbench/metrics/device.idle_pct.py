"""Share of the traced window, in %, in which no kernel, memcpy or memset
ran on the card: 1 - (union of their intervals) / the window's wall
time."""

from perfbench import tracing


def read(run):
    trace = run["trace"]
    if trace is None or not trace["device"]:
        return None
    window = (trace["t1"] - trace["t0"]) / 1e6
    return 100.0 * (1.0 - tracing.busy_seconds(trace) / window)
