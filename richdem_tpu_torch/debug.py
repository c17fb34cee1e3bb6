"""Debugging and profiling utilities.

Counterpart of ``richdem_tpu.debug``:

* :func:`trace` — a ``torch.profiler`` context for a phase, which writes
  one Chrome-format trace (host ops, and the card's kernels and copies
  when there is a card) that Perfetto and ``chrome://tracing`` open;
* :func:`span` — the layer spans (:data:`SPANS`) that the ``ops`` entries
  open while a profiler records, so a trace puts each kernel, copy and
  host sync down to the layer that launched it;
* :class:`PhaseTimer` — wall-clock phase timers with an RDLOG_TIME_USE
  style summary, logged through :mod:`richdem_tpu_torch.provenance`;
* :func:`check_raster` — finiteness and bounds validation of a raster,
  a tensor (checked where it lives; only the first offender leaves the
  device) or an array, with the reference's messages.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from richdem_tpu_torch.provenance import logger

__all__ = ["trace", "span", "SPANS", "PhaseTimer", "check_raster"]

#: File name of the trace :func:`trace` writes into its directory.
TRACE_FILE = "trace.json"
#: The layer spans, one a layer, each opened by the entry that owns the
#: layer's work: the fill (``ops.fill.fill_depressions_info``), D8 codes
#: (``ops.flowdirs.d8_core``), D8 accumulation
#: (``ops.accum.d8_accumulation_info``), slope and TWI
#: (``ops.terrain.terrain_core``, ``ops.terrain.terrain_attribute``,
#: ``methods.twi``), flow proportions
#: (``ops.flowdirs.flow_proportions``), multi-flow accumulation
#: (``ops.mfd.mfd_accumulation``), flat resolution
#: (``ops.flats.resolve_flats_info``), watershed labels, Strahler order and
#: upslope cells (``methods.watersheds_from_flowdirs``,
#: ``methods.strahler_order``, ``methods.upslope_cells``), D∞ angles
#: (``ops.flowdirs.dinf_flowdirs``) and D∞ accumulation
#: (``ops.accum.dinf_accumulation_from_angles``,
#: ``ops.dinf.dinf_accumulation``).
SPANS = ("rd.fill", "rd.d8", "rd.accum", "rd.terrain", "rd.props",
         "rd.mfd", "rd.flats", "rd.watersheds", "rd.strahler",
         "rd.upslope", "rd.dinf_dirs", "rd.dinf")
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """The context of layer span ``name`` (one of :data:`SPANS`): a
    ``record_function`` while a profiler records, on the profiler's clock
    and thread, else one shared null context, so that without a profiler
    a span costs a flag check and touches neither the card nor memory.
    A span nested in another owns what it launches."""
    if name not in SPANS:
        raise ValueError(f"unknown span {name!r}; expected one of {SPANS}")
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a phase: ``with trace('/tmp/prof'): step(z)`` writes
    ``/tmp/prof/trace.json``; open it in Perfetto (ui.perfetto.dev).
    The card's activity is recorded when CUDA is available, and the
    layer spans (:func:`span`) with the host ops."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            try:
                yield prof
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
    finally:
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class PhaseTimer:
    """Wall-clock per-phase timers with an RDLOG-style summary.

    >>> t = PhaseTimer()
    >>> with t.phase("fill"): ...
    >>> t.summary()
    """

    def __init__(self):
        self.times = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0)

    def summary(self) -> str:
        total = sum(self.times.values()) or 1.0
        lines = [f"[time-use] {k}: {v:.3f}s ({100 * v / total:.0f}%)"
                 for k, v in self.times.items()]
        out = "\n".join(lines)
        logger.info(out)
        return out


def _first(bad, values):
    """(row, col, value as a numpy scalar, count) of the first True cell
    of ``bad`` in row-major order."""
    if torch.is_tensor(bad):
        idx = torch.nonzero(bad)[0]
        r, c = int(idx[0]), int(idx[1])
        return r, c, values[r, c].cpu().numpy()[()], int(bad.sum())
    r, c = np.argwhere(bad)[0]
    return r, c, values[r, c], int(bad.sum())


def check_raster(arr, name="raster", finite=True, lo=None, hi=None):
    """Validate a raster: finiteness and optional bounds.

    Raises ``ValueError`` with the cell coordinates of the first offender,
    in the reference's words.  A tensor is checked where it lives; anything
    else as a numpy array.  Returns ``arr``."""
    if torch.is_tensor(arr):
        a, isfinite, less, greater = arr, torch.isfinite, torch.lt, torch.gt
    else:
        a, isfinite, less, greater = (np.asarray(arr), np.isfinite,
                                      np.less, np.greater)
    if finite:
        bad = ~isfinite(a)
        if bad.any():
            r, c, v, n = _first(bad, a)
            raise ValueError(
                f"{name}: non-finite value {v!r} at ({r}, {c}) "
                f"(+{n - 1} more)")
    for bound, op, word in ((lo, less, "below"), (hi, greater, "above")):
        if bound is None:
            continue
        bad = op(a, bound)
        if bad.any():
            r, c, v, n = _first(bad, a)
            raise ValueError(
                f"{name}: value {v!r} at ({r}, {c}) {word} bound "
                f"{bound} (+{n - 1} more)")
    return arr
