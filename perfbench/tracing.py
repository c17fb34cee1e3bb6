"""Reading a ``torch.profiler`` trace of the measured window.

The interval arithmetic (:func:`busy_us`) and the grouping of kernel names
(:func:`group`) are frozen copies of ``tools/torch_profile.py``'s
``_busy_us`` and ``_group``.  The window is the span
``perfbench.window`` that the harness records around its loop; device
operations are the trace's kernel, memcpy and memset events inside it.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from collections import defaultdict

WINDOW_SPAN = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: Readable names of the program's hand-written kernels, by a part of the
#: mangled name that the trace shows.
PORT_KERNELS = {"fill_sweep_kernel": "fill_sweep",
                # rd::tile::kernel, instantiated per stencil op
                "D8Op": "d8", "TerrainOp": "terrain", "Rho8Op": "rho8",
                "accum_sweep_kernel": "accum_sweep",
                # seam_walk_kernel, instantiated per rule
                "DistSweep": "dist_sweep",
                # flow_sweep_kernel, instantiated per field
                "DinfField": "dinf_sweep", "MfdField": "mfd_sweep",
                "ResolveSweep": "resolve_sweep",
                "Strahler": "strahler_sweep",
                "fill_scan_kernel": "fill_scan"}
#: Entries kept in each list of the breakdown.
TOP = 10


def group(name):
    for fn, kernel in PORT_KERNELS.items():
        if fn in name:
            return kernel
    return name[:90]


def busy_us(events):
    """Length of the union of the [ts, ts + dur) intervals."""
    total, end = 0.0, None
    for ts, dur in sorted((e["ts"], e["dur"]) for e in events):
        if end is None or ts > end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total


def _merged(events):
    """The union of the events' intervals as sorted, disjoint
    ``(start, end)`` pairs."""
    out = []
    for ts, dur in sorted((e["ts"], e["dur"]) for e in events):
        if out and ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], ts + dur)
        else:
            out.append([ts, ts + dur])
    return out


def read_trace(prof) -> dict:
    """The window's span, its device operations and its host events, from
    the profiler's Chrome trace (written to ``TMPDIR`` and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    finally:
        os.remove(path)
    events = [e for e in doc.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events if e.get("name") == WINDOW_SPAN]
    if not spans:
        raise RuntimeError("the trace holds no window span")
    t0 = spans[0]["ts"]
    t1 = t0 + spans[0]["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and t0 <= e["ts"] < t1]
    host = [e for e in events if e.get("cat") in HOST_CATS
            and e["ts"] < t1 and e["ts"] + e["dur"] > t0
            and e.get("name") != WINDOW_SPAN]
    return {"t0": t0, "t1": t1, "device": device, "host": host}


def busy_seconds(trace) -> float:
    """Seconds of the window in which some operation ran on the device."""
    t0, t1 = trace["t0"], trace["t1"]
    clipped = [{"ts": max(e["ts"], t0),
                "dur": min(e["ts"] + e["dur"], t1) - max(e["ts"], t0)}
               for e in trace["device"]]
    return busy_us(clipped) / 1e6


def device_seconds(trace, patterns=None, exclude=()) -> float:
    """Summed device time of the operations whose name holds one of
    ``patterns`` (all when None) and none of ``exclude``."""
    total = 0.0
    for e in trace["device"]:
        name = e.get("name", "")
        if patterns is not None and not any(p in name for p in patterns):
            continue
        if any(p in name for p in exclude):
            continue
        total += e["dur"]
    return total / 1e6


def breakdown(trace) -> dict:
    """The device operations that took most time, and the idle gaps by
    what the host was doing, in seconds, at most :data:`TOP` each."""
    ops = defaultdict(float)
    for e in trace["device"]:
        ops[group(e.get("name", ""))] += e["dur"] / 1e6
    busy = _merged(trace["device"])
    edges = [trace["t0"]] + [x for pair in busy for x in pair] \
        + [trace["t1"]]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    # a sweep over the gaps' midpoints, which rise: the innermost host
    # event running at each is the shortest one started and not yet ended
    host = sorted(trace["host"], key=lambda e: e["ts"])
    idle = defaultdict(float)
    active, nxt = [], 0
    for a, b in gaps:
        mid = (a + b) / 2
        while nxt < len(host) and host[nxt]["ts"] <= mid:
            e = host[nxt]
            heapq.heappush(active, (e["dur"], e["ts"] + e["dur"], nxt))
            nxt += 1
        while active and active[0][1] <= mid:
            heapq.heappop(active)
        name = host[active[0][2]]["name"][:90] if active else "host idle"
        idle[name] += (b - a) / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    gap = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gap]}
