"""The basin cell (``d8_basins_10k.perlin``) on the CPU at a tiny size: it
reports its own metrics and those of the layers it shares with the D8
cell; a run is ``correct`` and reports its counters; its reference loads nothing
of either package in a fresh process; its readers read nothing without a
trace, and the rooflines and glue read a hand-built trace of its layers."""

import subprocess
import sys

import pytest

from perfbench import registry, run

ROOT = registry.ROOT
CELL = "d8_basins_10k.perlin"
ROOFLINES = {"flats.roofline_pct": ("void rd::walk::seam_walk_kernel<"
                                    "rd::DistSweep>(...)", 7),
             "resolve.roofline_pct": ("void rd::walk::seam_walk_kernel<"
                                      "rd::ResolveSweep>(...)", 8),
             "strahler.roofline_pct": ("void rd::walk::seam_walk_kernel<"
                                       "rd::Strahler>(...)", 5)}
GLUE = {"glue.flats_ms": "rd.flats", "glue.watersheds_ms": "rd.watersheds",
        "glue.strahler_ms": "rd.strahler", "glue.upslope_ms": "rd.upslope"}
COUNTERS = ("flats.rotations", "watersheds.rotations",
            "strahler.rotations", "upslope.rotations")
#: Metrics of the fill, D8 and accumulation layers, the glue and the
#: device, which the cell shares with ``d8_pipeline_10k.perlin``.
SHARED = ("fill.roofline_pct", "accum.roofline_pct", "fill.rotations",
          "accum.rotations", "glue.device_ms", "device.idle_pct",
          "glue.fill_ms", "glue.d8_ms", "glue.accum_ms",
          "glue.unspanned_ms")


def _names():
    return [m["name"] for m in registry.cell_metrics(
        registry.load_benchmark(), CELL, "per_layer")]


def test_the_cell_reports_its_metrics():
    assert sorted(_names()) == sorted(list(ROOFLINES) + list(GLUE)
                                      + list(COUNTERS) + list(SHARED))


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct(trace):
    result = run.run_cell(CELL, 3 * 2**31 + 7, 0.01, trace, device="cpu",
                          overrides={"shape": [24, 24]},
                          log=lambda *a, **k: None)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(
        registry.config("d8_basins_10k")["limits"])
    if trace:
        # the CPU runs no kernel: only the counters have something to read
        assert sorted(result["metrics"]) == sorted(
            COUNTERS + ("fill.rotations", "accum.rotations"))
        assert all(m["value"] >= 1 for m in result["metrics"].values())


def test_the_reference_loads_neither_package():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.d8_basins\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    tops = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "richdem_tpu",
                       "richdem_tpu_torch"}


@pytest.mark.parametrize("name", sorted(list(ROOFLINES) + list(GLUE)
                                        + list(COUNTERS)))
def test_a_new_reader_reads_none_without_a_trace(name):
    untraced = {"trace": None, "steps": 3, "cells": 100, "counters": {},
                "claimed": registry.claimed_kernels()}
    assert registry.metric_reader(name).read(untraced) is None


def _host(name, ts, dur, cat="user_annotation", corr=None):
    e = {"name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1,
         "tid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _device(name, ts, dur, corr):
    return {"name": name, "cat": "kernel", "ts": ts, "dur": dur, "pid": 0,
            "tid": 7, "args": {"correlation": corr}}


#: The sweep each layer's span launches.
SWEEPS = {"rd.flats": ROOFLINES["flats.roofline_pct"][0],
          "rd.watersheds": ROOFLINES["resolve.roofline_pct"][0],
          "rd.strahler": ROOFLINES["strahler.roofline_pct"][0],
          "rd.upslope": ROOFLINES["resolve.roofline_pct"][0]}


def _run():
    """Two steps of 10⁶ cells: in each, every layer's span launches its
    sweep (1000 µs) and one glue kernel of (1 + its place) · 10 µs."""
    host, device = [], []
    for step in range(2):
        for i, span in enumerate(GLUE.values()):
            t = step * 10_000 + 2000 * i
            host.append(_host(span, t, 1500))
            for name, dur in ((SWEEPS[span], 1000),
                              ("elementwise_kernel", 10 * (1 + i))):
                corr = len(device)
                host.append(_host("cudaLaunchKernel", t + 10, 2,
                                  "cuda_runtime", corr))
                device.append(_device(name, t + 20, dur, corr))
    return {"trace": {"t0": 0, "t1": 20_000, "device": device,
                      "host": host},
            "steps": 2, "cells": 10**6,
            "counters": {n: [3, 5] for n in COUNTERS},
            "claimed": registry.claimed_kernels()}


def test_the_new_readers_read_a_hand_built_trace():
    from perfbench import peaks

    traced = _run()
    read = {n: registry.metric_reader(n).read(traced) for n in _names()}
    for name in COUNTERS:
        assert read[name] == 4
    for i, name in enumerate(GLUE):
        assert read[name] == pytest.approx(10 * (1 + i) / 1e3)
    for name, (_, per_cell) in ROOFLINES.items():
        # the resolve sweep runs in both walks
        seconds = 2 * 1000e-6 * (2 if name == "resolve.roofline_pct" else 1)
        bound = per_cell * 10**6 * 2 / peaks.HBM_BYTES_PER_S
        assert read[name] == pytest.approx(100 * bound / seconds)
    # the new sweeps are no glue
    assert registry.metric_reader("glue.device_ms").read(traced) == \
        pytest.approx(sum(10 * (1 + i) for i in range(4)) / 1e3)
