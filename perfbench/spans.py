"""The traced window put down to the program's layer spans.

While a profiler records, the program opens one ``rd.*`` span
(``record_function``) at the entry of each layer: ``rd.fill``, ``rd.d8``,
``rd.accum``, ``rd.terrain``, ``rd.props``, ``rd.mfd``.  A device
operation belongs to the innermost ``rd.*`` span, on the launching thread,
that holds its launch: the runtime or driver call with the same
``args["correlation"]``.  One launched outside every span, or whose launch
the window lacks, is unspanned.  Spans are the host-side
``user_annotation`` events of :func:`perfbench.tracing.read_trace`'s
``host``, not the ``gpu_user_annotation`` copies the profiler also writes.
"""

from __future__ import annotations

import heapq
from collections import defaultdict

from perfbench import tracing

PREFIX = "rd."
#: Every layer span of the program (its ``debug.SPANS``, named here so
#: that a reader runs on a program without them and reads nothing).
ALL = ("rd.fill", "rd.d8", "rd.accum", "rd.terrain", "rd.props", "rd.mfd")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: The runtime calls in which the host waits for the device.
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def _thread(e):
    return e.get("pid"), e.get("tid")


def program_spans(trace) -> list:
    """The window's ``rd.*`` spans."""
    return [e for e in trace["host"] if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(PREFIX)]


def opened(run, names) -> bool:
    """Whether the run was traced and a span of ``names`` opened in its
    window."""
    return run["trace"] is not None and any(
        e["name"] in names for e in program_spans(run["trace"]))


def owners(spans, points) -> list:
    """The name of the innermost span of ``spans`` holding each point
    ``(thread, ts)`` on its thread, or None: per thread, a sweep over the
    points in time order that keeps the spans begun in a heap by length
    and drops ended ones from its top."""
    names = [None] * len(points)
    by_thread = defaultdict(list)
    for s in spans:
        by_thread[_thread(s)].append(s)
    queries = defaultdict(list)
    for i, (thread, ts) in enumerate(points):
        queries[thread].append((ts, i))
    for thread, pts in queries.items():
        begun = sorted(by_thread.get(thread, ()), key=lambda s: s["ts"])
        active, nxt = [], 0
        for ts, i in sorted(pts):
            while nxt < len(begun) and begun[nxt]["ts"] <= ts:
                s = begun[nxt]
                heapq.heappush(active, (s["dur"], s["ts"] + s["dur"], nxt))
                nxt += 1
            while active and active[0][1] <= ts:
                heapq.heappop(active)
            if active:
                names[i] = begun[active[0][2]]["name"]
    return names


def glue_by_span(trace, claimed) -> dict:
    """Device seconds of the operations that no pattern of ``claimed``
    names (the ones ``glue.device_ms`` reads), by the span that launched
    each; None holds the unspanned."""
    launches = {}
    for e in trace["host"]:
        if e.get("cat") in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    glue = [e for e in trace["device"]
            if not any(p in e.get("name", "") for p in claimed)]
    found = [launches.get(e.get("args", {}).get("correlation"))
             for e in glue]
    points = [(_thread(c), c["ts"]) for c in found if c is not None]
    held = iter(owners(program_spans(trace), points))
    out = defaultdict(float)
    for e, c in zip(glue, found):
        out[None if c is None else next(held)] += e["dur"] / 1e6
    return dict(out)


def glue_ms(run, names, unspanned=False):
    """Device ms a step of the glue launched inside a span of ``names``,
    or with ``unspanned`` outside every span; None when no span of
    ``names`` opened or the window ran nothing on the device."""
    if not opened(run, names) or not run["trace"]["device"] \
            or not run["steps"]:
        return None
    seconds = glue_by_span(run["trace"], run["claimed"])
    keys = (None,) if unspanned else names
    return 1e3 * sum(seconds.get(k, 0.0) for k in keys) / run["steps"]


def syncs(run, names):
    """Host waits for the device a step (:data:`SYNCS` calls) that begin
    inside a span of ``names``; None when none of them opened."""
    if not opened(run, names) or not run["steps"]:
        return None
    trace = run["trace"]
    calls = [e for e in trace["host"]
             if e.get("cat") in LAUNCH_CATS and e.get("name") in SYNCS]
    held = owners(program_spans(trace),
                  [(_thread(e), e["ts"]) for e in calls])
    return sum(1 for n in held if n in names) / run["steps"]


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint
    ``(start, end)`` intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_program_pct(run, names):
    """Share of the window, in %, in which the device ran nothing while
    the host was inside a span of ``names``; None when none of them
    opened or the window ran nothing on the device."""
    if not opened(run, names) or not run["trace"]["device"]:
        return None
    trace = run["trace"]
    t0, t1 = trace["t0"], trace["t1"]
    busy = tracing._merged(trace["device"])
    edges = [t0] + [x for pair in busy for x in pair] + [t1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    inside = [(max(a, t0), min(b, t1)) for a, b in tracing._merged(
        [s for s in program_spans(trace) if s["name"] in names])]
    return 100.0 * _overlap(idle, inside) / (t1 - t0)
