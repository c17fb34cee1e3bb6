#!/usr/bin/env python3
"""Where the device time goes: one step of each full-size path of the
PyTorch port, traced with ``torch.profiler`` on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/torch_profile.py OUT_DIR [PATH ...]

PATH is any of ``main``, ``config2``, ``flats``, ``dinf_twi``,
``quinn_mfd``, ``d8_methods``, ``rho8``, ``api``, ``depths``,
``scan_widths``, ``sweep_rows``, ``flow_tiles``, ``walk_tiles``,
``resolve_tiles``, ``stencils`` and ``d8_levels`` (all when none is
named).  Paths, at
10240² on a Perlin DEM (seed 0), each after one warm-up step:

* ``main``    — ``make_pipeline(eps=0, with_twi=True)`` (BASELINE.json
  config 3, ``bench.py``'s default);
* ``config2`` — ``auto_epsilon`` → ε-fill → D8 → ``resolve_flats``
  (BASELINE.json config 2, ``bench.py``'s ``fill_flats``);
* ``flats``   — ``resolve_flats`` of the main path's ε = 0 output (flat
  lakes);
* ``dinf_twi``, ``quinn_mfd`` — BASELINE.json config 4, ``bench.py``'s
  configs of those names (``chip_smoke.dinf_twi_step``,
  ``quinn_mfd_step``);
* ``d8_methods`` — config 2's step, then watershed labels, Strahler order,
  D8 accumulation and the upslope cells of 64 gauges
  (``chip_smoke.d8_methods_step``);
* ``rho8`` — ε-fill → Rho8 → D8 accumulation (``chip_smoke.rho8_step``);
* ``api`` — the CLI ``twi`` verb's sequence through the pyrichdem names on
  an ``rdarray`` of numpy (Perlin seed 0 with nodata holes) under
  ``RICHDEM_TPU_FILL_ENGINE=scan`` (``chip_smoke.api_step``).

``depths`` runs no trace: at 4096² (Perlin seed 0, ε = 1e-2 fill) it times
the D∞ and Quinn accumulations at in-row scan depths 1, 8, 32 and 0 with
CUDA events (one warm-up call, then the mean of three) and prints one JSON
line per metric and depth with the rotations and the milliseconds per call,
from which the port's default depths are chosen.  ``scan_widths`` runs no
trace either: it builds the scan fill sweep (``csrc/fill_scan.cu``) at
several cluster sizes and most threads a CTA (``SCAN_BUILDS``, through
``RD_SCAN_CLUSTER`` and ``RD_SCAN_THREADS``), beside the port's own build and
a profiling build (``RD_SCAN_PROFILE``: the cycles of each part of a row
step, ``SCAN_PARTS``, on CTA 0's first thread), holds each against its
plain version on 64 rows, and times one sweep of each (ε = 1e-3, from
the fill's start) on 2048-row Perlin rasters of several widths with CUDA
events (one warm-up call, then the mean of three); one JSON line per
width and build with the microseconds per row step, the launch shape
(CTAs, columns and threads a CTA, columns a thread), the registers and
the spills.  ``sweep_rows`` runs no trace either: it
prints ``ptxas``'s registers and spill bytes of the entries of the fill,
accumulation, D8, multi-flow, D∞, resolve, distance, Strahler and scan
kernels, then times one call of each on 10240-row Perlin rasters of widths
1024, 4096 and 10240 with CUDA events (one warm-up call, then the mean of
three): a fill sweep (ε = 0, from the fill's start), an accumulation sweep
(unit weights, D8 codes of the DEM), D8 codes, a resolve sweep (watershed
start on those codes), a Strahler sweep (from order 1 on those codes), a
distance sweep (mode ``towards`` from the outlets, on the flat fields of
the DEM's ε = 0 fill), a scan fill sweep (ε = 1e-3), and a multi-flow
(Quinn planes of the DEM) and a D∞ sweep (its packed field) at in-row
depths 1 and 8, from unit accumulation.  It prints one JSON line per
kernel, depth and width with the milliseconds per call and the
microseconds per row step.
``flow_tiles`` runs no trace either: it builds the multi-flow and D∞
sweeps at tile widths 128, 256 and 512, each with a 32- and a 64-column
halo (``RD_FLOW_TILE``, ``RD_FLOW_HALO``; the port's own are
``_build.FLOW_TILE`` and ``FLOW_HALO``), holds each against the plain
sweep over whole rows on a 256×2100 raster at depths 1 and 8, then times
one sweep of each at 10240² (Perlin seed 0, unit accumulation) with CUDA
events and prints one JSON line per kernel, tile, halo and depth with the
microseconds per row step, the registers and the spills.
``walk_tiles`` runs no trace either: it builds the three sweeps of the
seam-exact walk (``csrc/seam_walk.cuh``: resolve, distance, Strahler) at
the tile widths and halos of ``WALK_TILES`` (``RD_RESOLVE_TILE`` and
``RD_RESOLVE_HALO``, ``RD_DIST_*``, ``RD_STRAHLER_*``; the port's own are
``_build.RESOLVE_TILE`` and the like), holds each against the plain sweep
over whole rows on a 256×2100 raster, and times one sweep of each at
10240² on the main path's ε = 0 fill of the Perlin DEM: the resolve
(watershed start) and Strahler (order 1) sweeps on its flat-resolved
codes, the distance sweep (``towards`` from the outlets) on its flat
fields; one JSON line per kernel, tile and halo with the microseconds per
row step, the registers and the spills, then one for a profiling build of
each at the port's tiles (``RD_WALK_PROFILE``: the cycles of each part of
a row step, ``WALK_PARTS``, by block, on the consumer thread of the
tile's first column).
``resolve_tiles`` does the same for the resolve sweep alone.
``stencils`` runs no trace either: for the three kernels on the
shared-memory tile (``csrc/stencil_tile.cuh``: D8, Rho8, terrain) it
prints, as a diagnostic, the instructions of each entry function's SASS
(``cuobjdump -sass`` of the built library) by class, then times one
call of D8 and Rho8 (D8 and D4) and of every terrain attribute on
10240-row Perlin rasters of widths 1024, 4096 and 10240 with CUDA events
(one warm-up call, then the mean of three), each checked against its
plain version first (terrain's atan attributes within rtol 1e-6, the rest
bitwise); one JSON line per kernel, variant and width with the
milliseconds per call, the bound (``chip_smoke.bound_ms``) and its share,
and the registers and spills of the entry that ran.
``d8_levels`` runs no trace either: on the 8 surfaces of the benchmark's
Perlin pool (seeds 0–7 at 10240²) it takes the ε = 0 fill's D8 codes
(the ``d8_pipeline_10k`` cell's) and the same codes after flat resolution
(the ``d8_basins_10k`` cell's), counts the levels of the topological pass
over each with its plain version (the cells on the longest chain of
donors), holds the pass bitwise to it, and times one call of the pass
with CUDA events (one warm-up call, then the mean of three); one JSON
line per surface and codes with the levels, the NO_FLOW share, the
milliseconds per call and the microseconds per level.

For each path it writes the Chrome trace to ``OUT_DIR`` (a directory that
git ignores) and prints one JSON line: the host wall time of the traced
step, the device busy time (the union of the kernel, memcpy and memset
intervals of the trace), the idle share (1 − busy / wall), the copy calls
whose device record the trace lacks (count and host ms: a path traced
after another in one process has lost the record of its one large
pageable host→card copy, so ``api`` is traced first), and device time and
launch count by group: each of the port's eleven kernels by its CUDA
function name (``perfbench.tracing.PORT_KERNELS``, whose ``group`` and
``busy_us`` the summary uses), the rest by the name of the PyTorch kernel
(up to 14 groups).  The card's
``name, power.limit`` comes first.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from collections import Counter, defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

MAIN = 10240
PATHS = ("main", "config2", "flats", "dinf_twi", "quinn_mfd", "d8_methods",
         "rho8", "api", "depths", "scan_widths", "sweep_rows", "flow_tiles",
         "walk_tiles", "resolve_tiles", "stencils", "d8_levels")
DEPTH_SIZE = 4096
DEPTHS = (1, 8, 32, 0)
SCAN_ROWS = 2048
SCAN_WIDTHS = (1024, 4096, 8192, 8193, 10240, 16384)
#: (cluster size, most threads a CTA) of each scan-sweep build that
#: ``scan_widths`` times (``RD_SCAN_CLUSTER``, ``RD_SCAN_THREADS``; the
#: port's own are ``_build.SCAN_CLUSTER`` and ``SCAN_THREADS``)
SCAN_BUILDS = ((16, 128), (16, 512), (8, 256), (4, 256))
#: the parts of a scan row step that the profiling build counts
SCAN_PARTS = ("set-up", "maps", "warp scans and CTA barrier",
              "scan over the warps and sends", "aggregates' wait",
              "carries and columns", "ring wait and CTA barrier")
#: (tile width, halo) of each build of the walk's sweeps that
#: ``walk_tiles`` times
WALK_TILES = ((64, 32), (128, 32), (128, 64), (256, 64), (512, 64))
#: the parts of a row step of the walk that its profiling build counts
#: (``RD_WALK_PROFILE``)
WALK_PARTS = ("neighbours' flags", "exchange reads", "stage wait",
              "rule and stores", "barrier", "rest of the loop")
#: blocks whose parts the profiling build keeps
WALK_PROFILE_BLOCKS = 1024
#: the walk's sweeps: (module, kernel attribute, macro prefix)
WALK_KERNELS = {"resolve_sweep": ("successor", "RESOLVE_SWEEP", "RESOLVE"),
                "dist_sweep": ("flats", "DIST_SWEEP", "DIST"),
                "strahler_sweep": ("successor", "STRAHLER_SWEEP",
                                   "STRAHLER")}
SWEEP_ROWS = 10240
SWEEP_WIDTHS = (1024, 4096, 10240)
#: (tile width, halo) of each flow-sweep build that ``flow_tiles`` times
FLOW_TILES = ((128, 32), (256, 32), (512, 32), (128, 64), (256, 64),
              (512, 64))


def trace(name, fn, out_dir):
    """Warm up, trace one call of ``fn``, and summarise the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench.tracing import busy_us, group

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    path = os.path.join(out_dir, f"trace_{name}.json")
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    events = [e for e in doc.get("traceEvents", [])
              if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    copied = {e.get("args", {}).get("correlation") for e in events
              if e["cat"] == "gpu_memcpy"}
    lost = [e["dur"] for e in doc.get("traceEvents", [])
            if e.get("cat") == "cuda_runtime"
            and e.get("name", "").startswith("cudaMemcpy")
            and e.get("args", {}).get("correlation") not in copied]
    groups = defaultdict(lambda: [0.0, 0])
    for e in events:
        g = groups[group(e.get("name", ""))]
        g[0] += e["dur"]
        g[1] += 1
    busy = busy_us(events)
    top = sorted(groups.items(), key=lambda kv: -kv[1][0])
    return {"path": name, "wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us, "events": len(events),
            "copies_without_device_record": [len(lost), sum(lost) / 1e3],
            "by_group_ms": {k: [round(v[0] / 1e3, 4), v[1]]
                            for k, v in top[:14]}}


def depth_sweep(dev, card):
    """Rotations and milliseconds per accumulation call at each depth."""
    import torch
    from richdem_tpu_torch import synth as tsynth
    from richdem_tpu_torch.ops import accum, dinf, fill, flowdirs

    z = tsynth.perlin_dem(DEPTH_SIZE, DEPTH_SIZE, seed=0, device=dev)
    filled, _, done = fill.fill_depressions_info(z, eps=1e-2, max_iters=256)
    if not done:
        raise RuntimeError("fill did not converge")
    code, p = dinf.dinf_two_tap(flowdirs.dinf_flowdirs(filled))
    props = flowdirs.flow_proportions(filled, "Quinn")
    runs = {"dinf": lambda d: dinf.dinf_accumulation(
                code, p, depth=d, return_info=True),
            "quinn": lambda d: accum.flow_accumulation_from_props(
                props, depth=d, return_info=True)}
    for metric, run in runs.items():
        for depth in DEPTHS:
            _, rotations, _ = run(depth)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                run(depth)
            end.record()
            torch.cuda.synchronize()
            print(json.dumps({"depths": metric, "size": DEPTH_SIZE,
                              "depth": depth, "rotations": rotations,
                              "ms": start.elapsed_time(end) / 3,
                              "card": card}), flush=True)


def _events_ms(fn, reps=3):
    """Milliseconds per call of ``fn`` (CUDA events; one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _variant(default, defines):
    """``default`` built with ``defines`` into a library of its own."""
    from richdem_tpu_torch import _build

    kern = _build.Kernel(default.name, default.symbol, default.argtypes,
                         defines=defines)
    kern.function()
    return kern


def scan_widths(dev, card):
    """Microseconds per row step of one scan fill sweep at each width, for
    each cluster size and most threads a CTA; the profiling build's cycles
    by part of a row step."""
    import ctypes

    import torch
    from richdem_tpu_torch import synth as tsynth
    from richdem_tpu_torch.ops import fill, sweeps

    default = fill.FILL_SCAN
    default.function()
    builds = [(f"cluster {c}, up to {t} threads",
               _variant(default, {"RD_SCAN_CLUSTER": c,
                                  "RD_SCAN_THREADS": t}))
              for c, t in SCAN_BUILDS]
    profile = _variant(default, {"RD_SCAN_PROFILE": 1})
    builds += [("the port's own", default), ("profiling", profile)]
    for width in SCAN_WIDTHS:
        z = tsynth.perlin_dem(SCAN_ROWS, width, seed=0, device=dev)
        w0 = torch.full_like(z, sweeps.BIG)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        ref = sweeps.fill_scan_sweep_plain(w0[:64].contiguous(),
                                           z[:64].contiguous(), 1e-3, 1e-3,
                                           False, flag)
        for name, kern in builds:
            fill.FILL_SCAN = kern
            try:
                got = fill.fill_scan_sweep(w0[:64].contiguous(),
                                           z[:64].contiguous(), 1e-3, 1e-3,
                                           False, flag)
                if not torch.equal(got, ref):
                    raise AssertionError(f"scan sweep ({name}) differs "
                                         "from its plain version")
                ms = _events_ms(lambda: fill.fill_scan_sweep(
                    w0, z, 1e-3, 1e-3, False, flag))
                rec = {"scan_widths": width, "build": name,
                       "rows": SCAN_ROWS, "ms": ms,
                       "us_per_row": 1e3 * ms / SCAN_ROWS,
                       "shape": fill.fill_scan_shape(width),
                       "resources": kern.resources(), "card": card}
                if kern is profile:
                    cycles = (ctypes.c_ulonglong * 8)()
                    kern.entry("rd_fill_scan_profile",
                               [ctypes.c_void_p])(cycles)
                    rec["cycles_per_row"] = dict(zip(
                        SCAN_PARTS, (v / SCAN_ROWS for v in cycles)))
                print(json.dumps(rec), flush=True)
            finally:
                fill.FILL_SCAN = default


def _walk_calls(z):
    """Per sweep of the walk, ``(kernel call, plain call)`` of one sweep
    down, each taking a 2-D slice of the rows and columns it sweeps: the
    resolve (watershed start) and Strahler (order 1) sweeps on the flat-
    resolved D8 codes of ``z``'s ε = 0 fill, the distance sweep
    (``towards`` from the outlets) on that fill's flat fields."""
    import torch
    from richdem_tpu_torch import resolve_flats
    from richdem_tpu_torch.ops import fill, flats, flowdirs, successor, sweeps

    nd = torch.zeros_like(z, dtype=torch.bool)
    filled, _, _ = fill.fill_depressions_info(z, eps=0.0, max_iters=256)
    fd0 = flowdirs.d8_core(filled, nd)
    fd = resolve_flats(filled, fd0)
    fd_eff = successor.effective_codes(fd)
    pinned = fd_eff == 0
    idx = torch.arange(fd.numel(), dtype=torch.int32,
                       device=z.device).view(fd.shape)
    init = torch.where(pinned, idx, -1)
    code = successor.pack_codes(fd_eff, pinned)
    o0 = (fd >= 0).to(torch.int32)
    sc = fd.clamp(min=0).to(torch.int8)
    ff = flats.flat_fields(filled, fd0, nd)
    w0 = torch.where(ff["outlet"], 0.0, torch.tensor(sweeps.BIG,
                                                     device=z.device))
    zed, fl = ff["zed"], ff["flags"]
    flag = torch.zeros(1, dtype=torch.int32, device=z.device)

    def cut(x, sl):
        return x[sl].contiguous()

    return {
        "resolve_sweep": (
            lambda sl: successor.resolve_sweep(cut(init, sl), cut(code, sl),
                                               False),
            lambda sl: successor.resolve_sweep_plain(cut(init, sl),
                                                     cut(code, sl), False)),
        "strahler_sweep": (
            lambda sl: successor.strahler_sweep(cut(o0, sl), cut(sc, sl),
                                                False),
            lambda sl: successor.strahler_sweep_plain(cut(o0, sl),
                                                      cut(sc, sl), False)),
        "dist_sweep": (
            lambda sl: flats.dist_sweep(cut(w0, sl), cut(zed, sl),
                                        cut(fl, sl), "towards", 1.0, False,
                                        flag),
            lambda sl: sweeps.dist_sweep_plain(cut(w0, sl), cut(zed, sl),
                                               cut(fl, sl), "towards", 1.0,
                                               False, flag))}


def walk_tiles(dev, card, names=tuple(WALK_KERNELS)):
    """The sweeps of the seam-exact walk built at each tile width and
    halo: registers, spills, a check against the plain sweep over whole
    rows, and the microseconds per row step at 10240² on the main path's
    ε = 0 fill of a Perlin DEM."""
    import ctypes
    import importlib

    import torch
    from richdem_tpu_torch import _build
    from richdem_tpu_torch import synth as tsynth

    z = tsynth.perlin_dem(SWEEP_ROWS, MAIN, seed=0, device=dev)
    calls = _walk_calls(z)
    small = (slice(0, 256), slice(0, 2100))
    whole = (slice(None), slice(None))
    for name in names:
        modname, attr, macro = WALK_KERNELS[name]
        mod = importlib.import_module(f"richdem_tpu_torch.ops.{modname}")
        kern_call, plain_call = calls[name]
        ref = plain_call(small)
        default = getattr(mod, attr)
        for tile, halo in WALK_TILES:
            kern = _variant(default, {f"RD_{macro}_TILE": tile,
                                      f"RD_{macro}_HALO": halo})
            setattr(mod, attr, kern)
            try:
                if not torch.equal(kern_call(small), ref):
                    raise AssertionError(f"{name} at tile {tile}, halo "
                                         f"{halo}: differs from the "
                                         "whole-row sweep")
                ms = _events_ms(lambda: kern_call(whole))
                print(json.dumps({"walk_tiles": name, "tile": tile,
                                  "halo": halo, "rows": SWEEP_ROWS,
                                  "width": MAIN, "ms": ms,
                                  "us_per_row": 1e3 * ms / SWEEP_ROWS,
                                  "resources": kern.resources(),
                                  "card": card}), flush=True)
            finally:
                setattr(mod, attr, default)
        kern = _variant(default, {"RD_WALK_PROFILE": 1})
        setattr(mod, attr, kern)
        try:
            if not torch.equal(kern_call(small), ref):
                raise AssertionError(f"{name}'s profiling build differs "
                                     "from the whole-row sweep")
            ms = _events_ms(lambda: kern_call(whole))
            nparts = len(WALK_PARTS)
            cycles = (ctypes.c_ulonglong * (WALK_PROFILE_BLOCKS * nparts))()
            rc = kern.entry("rd_walk_profile", [ctypes.c_void_p])(cycles)
            if rc != 0:
                raise RuntimeError(f"rd_walk_profile: cudaError {rc}")
            blocks = -(-MAIN // getattr(_build, f"{macro}_TILE"))
            per_block = [[cycles[b * nparts + p] / SWEEP_ROWS
                          for p in range(nparts)] for b in range(blocks)]
            print(json.dumps({"walk_tiles": name, "build": "profiling",
                              "rows": SWEEP_ROWS, "width": MAIN, "ms": ms,
                              "us_per_row": 1e3 * ms / SWEEP_ROWS,
                              "parts": WALK_PARTS,
                              "cycles_per_row_by_block": per_block,
                              "card": card}), flush=True)
        finally:
            setattr(mod, attr, default)


def sweep_rows(dev, card):
    """Registers, spills and microseconds per row step of the fill,
    accumulation, multi-flow, D∞, resolve, Strahler, distance and scan
    sweeps, and D8's time per call."""
    import torch
    from richdem_tpu_torch import synth as tsynth
    from richdem_tpu_torch.ops import (accum, dinf, fill, flats, flowdirs,
                                       mfd, successor, sweeps)

    for name, kern in (("fill_sweep", fill.FILL_SWEEP),
                       ("accum_sweep", accum.ACCUM_SWEEP),
                       ("d8", flowdirs.D8), ("mfd_sweep", mfd.MFD_SWEEP),
                       ("dinf_sweep", dinf.DINF_SWEEP),
                       ("resolve_sweep", successor.RESOLVE_SWEEP),
                       ("dist_sweep", flats.DIST_SWEEP),
                       ("strahler_sweep", successor.STRAHLER_SWEEP),
                       ("fill_scan", fill.FILL_SCAN)):
        kern.function()
        print(json.dumps({"ptxas": name, "entries": kern.resources(),
                          "card": card}), flush=True)
    for width in SWEEP_WIDTHS:
        z = tsynth.perlin_dem(SWEEP_ROWS, width, seed=0, device=dev)
        w0 = torch.full_like(z, sweeps.BIG)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        nd = torch.zeros_like(z, dtype=torch.bool)
        fd = flowdirs.d8_core(z, nd)
        ones = torch.ones_like(z)
        planes = flowdirs.flow_proportions(z, "Quinn").permute(
            2, 0, 1).contiguous()
        code, p = dinf.dinf_two_tap(flowdirs.dinf_flowdirs(z))
        v = dinf.pack_two_tap(*dinf.unpack_two_tap(
            dinf.pack_two_tap(code, p))).contiguous()
        fd_eff = successor.effective_codes(fd)
        pinned = fd_eff == 0
        idx = torch.arange(fd.numel(), dtype=torch.int32,
                           device=dev).view(fd.shape)
        init = torch.where(pinned, idx, -1)
        code_r = successor.pack_codes(fd_eff, pinned)
        o0 = (fd >= 0).to(torch.int32)
        sc = fd.clamp(min=0).to(torch.int8)
        filled0, _, _ = fill.fill_depressions_info(z, eps=0.0, max_iters=256)
        ff = flats.flat_fields(filled0, flowdirs.d8_core(filled0, nd), nd)
        wt0 = torch.where(ff["outlet"], 0.0, torch.tensor(sweeps.BIG,
                                                          device=dev))
        zed, fl = ff["zed"], ff["flags"]
        del filled0
        calls = [("fill_sweep", None,
                  lambda: fill.fill_sweep(w0, z, 0.0, 0.0, False, flag)),
                 ("accum_sweep", None,
                  lambda: accum.accum_sweep(ones, ones, fd, False)),
                 ("d8", None, lambda: flowdirs.d8_core(z, nd)),
                 ("resolve_sweep", None,
                  lambda: successor.resolve_sweep(init, code_r, False)),
                 ("strahler_sweep", None,
                  lambda: successor.strahler_sweep(o0, sc, False)),
                 ("dist_sweep", None,
                  lambda: flats.dist_sweep(wt0, zed, fl, "towards", 1.0,
                                           False, flag)),
                 ("fill_scan", None,
                  lambda: fill.fill_scan_sweep(w0, z, 1e-3, 1e-3, False,
                                               flag))]
        for depth in (1, 8):
            calls += [("mfd_sweep", depth,
                       lambda d=depth: mfd.mfd_sweep(ones, ones, planes,
                                                     False, d)),
                      ("dinf_sweep", depth,
                       lambda d=depth: dinf.dinf_sweep(ones, ones, v, False,
                                                       d))]
        for name, depth, call in calls:
            ms = _events_ms(call)
            print(json.dumps({"sweep_rows": name, "depth": depth,
                              "rows": SWEEP_ROWS, "width": width, "ms": ms,
                              "us_per_row": 1e3 * ms / SWEEP_ROWS,
                              "card": card}), flush=True)
        del planes


def flow_tiles(dev, card):
    """The multi-flow and D∞ sweeps built at each tile width and halo:
    registers, spills, a check against the plain sweep over whole rows,
    and the microseconds per row step at 10240²."""
    import torch
    from richdem_tpu_torch import _build
    from richdem_tpu_torch import synth as tsynth
    from richdem_tpu_torch.ops import dinf, flowdirs, mfd

    z = tsynth.perlin_dem(SWEEP_ROWS, MAIN, seed=0, device=dev)
    ones = torch.ones_like(z)
    planes = flowdirs.flow_proportions(z, "Quinn").permute(
        2, 0, 1).contiguous()
    code, p = dinf.dinf_two_tap(flowdirs.dinf_flowdirs(z))
    v = dinf.pack_two_tap(*dinf.unpack_two_tap(
        dinf.pack_two_tap(code, p))).contiguous()
    small = (slice(0, 256), slice(0, 2100))
    sweeps = {"mfd_sweep": (mfd, "MFD_SWEEP", mfd.mfd_sweep,
                            mfd.mfd_sweep_plain, planes,
                            planes[:, small[0], small[1]].contiguous()),
              "dinf_sweep": (dinf, "DINF_SWEEP", dinf.dinf_sweep,
                             dinf.dinf_sweep_plain, v, v[small].contiguous())}
    for name, (mod, attr, sweep, plain, field, field_s) in sweeps.items():
        default = getattr(mod, attr)
        for tile, halo in FLOW_TILES:
            kern = _build.Kernel(default.name, default.symbol,
                                 default.argtypes,
                                 defines={"RD_FLOW_TILE": tile,
                                          "RD_FLOW_HALO": halo})
            kern.function()
            setattr(mod, attr, kern)
            try:
                a_s = ones[small].contiguous()
                for depth in (1, 8):
                    got = sweep(a_s, a_s, field_s, False, depth)
                    if not torch.equal(got, plain(a_s, a_s, field_s, False,
                                                  depth, tile=1 << 30)):
                        raise AssertionError(f"{name} at tile {tile}, "
                                             f"depth {depth}: differs from "
                                             "the whole-row plain sweep")
                    ms = _events_ms(lambda d=depth: sweep(ones, ones, field,
                                                          False, d))
                    print(json.dumps({"flow_tiles": name, "tile": tile,
                                      "halo": halo, "depth": depth,
                                      "rows": SWEEP_ROWS,
                                      "width": MAIN, "ms": ms,
                                      "us_per_row": 1e3 * ms / SWEEP_ROWS,
                                      "resources": kern.resources(),
                                      "card": card}), flush=True)
            finally:
                setattr(mod, attr, default)


#: SASS opcodes by class: float32, the special-function unit, and
#: memory, control and uniform-datapath instructions ("other"); every
#: other opcode counts as int32.  A diagnostic: the bounds count the
#: function's operations (``chip_smoke.COST``), not the kernel's
SASS_FP32 = ("FFMA", "FADD", "FMUL", "FSETP", "FSEL", "FMNMX", "FCHK",
             "FSET")
SASS_XU = ("MUFU", "F2I", "F2F")
SASS_OTHER = ("LD", "ST", "BRA", "BSSY", "BSYNC", "EXIT", "BAR", "U", "S2R",
              "S2UR", "NOP", "CALL", "RET", "P2R", "R2P", "MEMBAR", "DMUL",
              "WARPSYNC")
#: the stencil kernels' entries: mangled Op name, its template argument,
#: and VEC
STENCIL_ENTRY = re.compile(r"(D8Op|Rho8Op|TerrainOp)IL[bi](\d+)EEELb(\d)E")


def _sass_class(ins):
    op = ins.split()[1] if ins.startswith("@") else ins.split()[0]
    if op.startswith(SASS_FP32):
        return "fp32"
    if op.startswith(SASS_XU) or (op.startswith("I2F")
                                  and not op.startswith("I2FP")):
        return "xu"
    if op.startswith(SASS_OTHER):
        return "other"
    return "int32"


def _sass_functions(kernel):
    """Per entry function of ``kernel``'s built library, its SASS
    instructions (``cuobjdump -sass``)."""
    from richdem_tpu_torch import _build

    kernel.function()
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    return _parse_sass(subprocess.run(
        [tool, "-sass", kernel.library], capture_output=True, text=True,
        check=True).stdout)


def _parse_sass(text):
    """``cuobjdump -sass`` output → {function: [instruction]}."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append(m.group(1))
    return funcs


def _stencil_entry(kernel, arg, vec):
    """The mangled name of ``kernel``'s entry for template argument
    ``arg`` (D4 for D8 and Rho8, the attribute's index for terrain) and
    VEC."""
    for name in kernel.resources():
        m = STENCIL_ENTRY.search(name)
        if m and int(m.group(2)) == arg and int(m.group(3)) == vec:
            return name
    raise RuntimeError(f"no {kernel.name} entry for {arg}, VEC {vec}")


def stencils(dev, card):
    """The D8, Rho8 and terrain kernels on the shared-memory tile: their
    SASS by instruction class, and one call of each variant timed at each
    width beside its bound."""
    import torch
    from chip_smoke import bound_ms
    from richdem_tpu_torch import synth as tsynth
    from richdem_tpu_torch.ops import flowdirs, terrain

    kernels = (flowdirs.D8, flowdirs.RHO8, terrain.TERRAIN)
    for kern in kernels:
        for name, ins in _sass_functions(kern).items():
            m = STENCIL_ENTRY.search(name)
            print(json.dumps({
                "stencil_sass": kern.name,
                "op": m and f"{m.group(1)}<{m.group(2)}>, VEC {m.group(3)}",
                "entry": name,
                "static": dict(Counter(map(_sass_class, ins))),
                "card": card}),
                flush=True)
    for width in SWEEP_WIDTHS:
        z = tsynth.perlin_dem(SWEEP_ROWS, width, seed=0, device=dev)
        nd = torch.zeros_like(z, dtype=torch.bool)
        n = z.numel()
        runs = []  # (kernel, variant, call, plain, cost, template arg)
        for topo in ("D8", "D4"):
            d4 = int(topo == "D4")
            runs.append((flowdirs.D8, topo,
                         lambda t=topo: flowdirs.d8_core(z, nd, 1.0, t),
                         lambda t=topo: flowdirs.d8_plain(z, nd, 1.0, t),
                         "d8", d4))
            runs.append((flowdirs.RHO8, topo,
                         lambda t=topo: flowdirs.rho8_core(z, nd, 1.0, 0, t),
                         lambda t=topo: flowdirs.rho8_plain(
                             z, nd, 1.0, flowdirs.rho8_diagonal(
                                 z.shape, 0, dev), t),
                         "rho8_d4" if d4 else "rho8", d4))
        for k, attrib in enumerate(terrain.TERRAIN_ATTRIBUTES):
            runs.append((terrain.TERRAIN, attrib,
                         lambda a=attrib: terrain.terrain_fused(
                             z, nd, 1.0, 1.0, a),
                         lambda a=attrib: terrain.terrain_plain(
                             z, nd, 1.0, 1.0, a), "terrain", k))
        for kern, variant, call, plain, cost, arg in runs:
            got, ref = call(), plain()
            if variant in ("slope_radians", "slope_degrees", "aspect"):
                torch.testing.assert_close(got, ref, rtol=1e-6, atol=0,
                                           equal_nan=True)
            elif not torch.equal(got.view(torch.uint8),
                                 ref.view(torch.uint8)):
                raise AssertionError(f"{kern.name} {variant} at width "
                                     f"{width} differs from its plain "
                                     "version")
            del got, ref
            ms = _events_ms(call)
            bound, bound_by = bound_ms(cost, n)
            print(json.dumps({
                "stencils": kern.name, "variant": variant,
                "rows": SWEEP_ROWS, "width": width, "ms": ms,
                "bound_ms": bound, "bound_by": bound_by,
                "share": bound / ms,
                "resources": kern.resources()[_stencil_entry(kern, arg, 1)],
                "card": card}), flush=True)


def d8_levels(dev, card):
    """The topological pass's levels and time on the D8 codes of the
    benchmark's two D8 cells, surface by surface of its pool."""
    import torch
    from richdem_tpu_torch import resolve_flats
    from richdem_tpu_torch import synth as tsynth
    from richdem_tpu_torch.ops import accum, fill, flowdirs

    for seed in range(8):
        z = tsynth.perlin_dem(MAIN, MAIN, seed=seed, device=dev)
        nd = torch.zeros_like(z, dtype=torch.bool)
        filled, _, done = fill.fill_depressions_info(z, nd, eps=0.0)
        if not done:
            raise RuntimeError(f"seed {seed}: the fill did not converge")
        fd = flowdirs.d8_core(filled, nd)
        ones = torch.ones_like(z)
        for cell, codes in (("d8_pipeline_10k", fd),
                            ("d8_basins_10k", resolve_flats(filled, fd))):
            stats = {}
            ref, left = accum.d8_topo_plain(codes, ones, stats)
            got, left_k = accum.d8_topo(codes, ones)
            if left or left_k or not torch.equal(got, ref):
                raise AssertionError(f"seed {seed}, {cell}: the pass "
                                     "differs from its plain version")
            ms = _events_ms(lambda: accum.d8_topo(codes, ones))
            print(json.dumps({
                "path": "d8_levels", "seed": seed, "codes": cell,
                "levels": stats["levels"],
                "no_flow_share": float((codes == 0).float().mean()),
                "topo_ms": ms, "us_per_level": 1e3 * ms / stats["levels"],
                "card": card}), flush=True)


def main():
    import torch

    if len(sys.argv) < 2 or not set(sys.argv[2:]) <= set(PATHS):
        raise SystemExit(f"usage: {sys.argv[0]} OUT_DIR [PATH ...], PATH "
                         f"in {PATHS}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the profile needs one")
    out_dir = sys.argv[1]
    # api first: see copies_without_device_record
    paths = sorted(sys.argv[2:] or PATHS, key=lambda p: p != "api")
    os.makedirs(out_dir, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)

    from chip_smoke import (api_step, d8_methods_step, dinf_twi_step,
                            holed_dem, quinn_mfd_step, rho8_step)
    from richdem_tpu_torch import (auto_epsilon, make_pipeline, rdarray,
                                   resolve_flats)
    from richdem_tpu_torch import synth as tsynth
    from richdem_tpu_torch.ops import fill, flowdirs

    dev = torch.device("cuda", 0)
    z = tsynth.perlin_dem(MAIN, MAIN, seed=0, device=dev)
    nd = torch.zeros_like(z, dtype=torch.bool)
    step = make_pipeline((MAIN, MAIN), eps=0.0, fill_iters=256,
                         with_twi=True)
    eps = auto_epsilon(z)

    def config2():
        filled, _, done = fill.fill_depressions_info(z, eps=eps,
                                                     max_iters=256)
        if not done:
            raise RuntimeError("config 2 fill did not converge")
        fd = flowdirs.d8_core(filled, nd)
        return resolve_flats(filled, fd)

    def api():
        old = os.environ.get("RICHDEM_TPU_FILL_ENGINE")
        os.environ["RICHDEM_TPU_FILL_ENGINE"] = "scan"
        try:
            return api_step(api_dem)
        finally:
            if old is None:
                del os.environ["RICHDEM_TPU_FILL_ENGINE"]
            else:
                os.environ["RICHDEM_TPU_FILL_ENGINE"] = old

    out = step(z) if "flats" in paths else None
    api_dem = (rdarray(holed_dem(MAIN, 0, dev)[0], no_data=-9999.0)
               if "api" in paths else None)
    fns = {"main": lambda: step(z), "config2": config2, "api": api,
           "flats": lambda: resolve_flats(out["filled"], out["flowdirs"]),
           "dinf_twi": lambda: dinf_twi_step(z),
           "quinn_mfd": lambda: quinn_mfd_step(z),
           "d8_methods": lambda: d8_methods_step(z, eps),
           "rho8": lambda: rho8_step(z, eps)}
    for name in paths:
        if name == "depths":
            depth_sweep(dev, card)
            continue
        if name == "scan_widths":
            scan_widths(dev, card)
            continue
        if name == "sweep_rows":
            sweep_rows(dev, card)
            continue
        if name == "flow_tiles":
            flow_tiles(dev, card)
            continue
        if name == "stencils":
            stencils(dev, card)
            continue
        if name == "d8_levels":
            d8_levels(dev, card)
            continue
        if name in ("walk_tiles", "resolve_tiles"):
            walk_tiles(dev, card, ("resolve_sweep",) if name ==
                       "resolve_tiles" else tuple(WALK_KERNELS))
            continue
        res = trace(name, fns[name], out_dir)
        res["card"] = card
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
