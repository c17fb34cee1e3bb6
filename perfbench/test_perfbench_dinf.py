"""The D∞ cell (``dinf_twi_10k.perlin``) on the CPU at a tiny size: it
reports its own metrics and those of the layers it shares with the other
cells; a run is ``correct`` and reports its counters; its reference loads
nothing of either package in a fresh process; its readers read nothing
without a trace, and the roofline and glue read a hand-built trace of its
layers."""

import subprocess
import sys

import pytest

from perfbench import registry, run

ROOT = registry.ROOT
CELL = "dinf_twi_10k.perlin"
SWEEP = "void rd::flow::flow_sweep_kernel<(anonymous namespace)::DinfField>"
GLUE = {"glue.dinf_ms": "rd.dinf", "glue.dinf_dirs_ms": "rd.dinf_dirs"}
COUNTERS = ("dinf.rotations",)
NEW = ("dinf.roofline_pct",) + tuple(GLUE) + COUNTERS
#: Metrics of the fill and terrain layers, the glue and the device, which
#: the cell shares with the other cells.
SHARED = ("fill.roofline_pct", "fill.rotations", "glue.fill_ms",
          "glue.terrain_ms", "glue.device_ms", "glue.unspanned_ms",
          "device.idle_pct")


def _names():
    return [m["name"] for m in registry.cell_metrics(
        registry.load_benchmark(), CELL, "per_layer")]


def test_the_cell_reports_its_metrics():
    assert sorted(_names()) == sorted(NEW + SHARED)


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct(trace):
    result = run.run_cell(CELL, 3 * 2**31 + 7, 0.01, trace, device="cpu",
                          overrides={"shape": [24, 24]},
                          log=lambda *a, **k: None)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(
        registry.config("dinf_twi_10k")["limits"])
    if trace:
        # the CPU runs no kernel: only the counters have something to read
        assert sorted(result["metrics"]) == ["dinf.rotations",
                                             "fill.rotations"]
        assert all(m["value"] >= 1 for m in result["metrics"].values())


def test_the_reference_loads_neither_package():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.dinf_twi\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    tops = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "richdem_tpu",
                       "richdem_tpu_torch"}


@pytest.mark.parametrize("name", NEW)
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


def _run():
    """Two steps of 10⁶ cells: ``rd.fill`` launches a fill sweep of 500
    µs, ``rd.dinf_dirs`` one glue kernel of 10 µs, ``rd.dinf`` a sweep of
    1000 µs and one glue kernel of 20 µs, and one more glue kernel of 40
    µs runs outside every span."""
    host, device = [], []
    launches = (("rd.fill", "fill_sweep_kernel", 500),
                ("rd.dinf_dirs", "elementwise_kernel", 10),
                ("rd.dinf", SWEEP, 1000), ("rd.dinf", "transpose", 20),
                (None, "copy", 40))
    for step in range(2):
        for i, (span, name, dur) in enumerate(launches):
            t = step * 10_000 + 2000 * i
            if span is not None:
                host.append(_host(span, t, 1500))
            corr = len(device)
            host.append(_host("cudaLaunchKernel", t + 10, 2, "cuda_runtime",
                              corr))
            device.append(_device(name, t + 20, dur, corr))
    return {"trace": {"t0": 0, "t1": 20_000, "device": device,
                      "host": host},
            "steps": 2, "cells": 10**6,
            "counters": {"dinf.rotations": [9, 11]},
            "claimed": registry.claimed_kernels()}


def test_the_new_readers_read_a_hand_built_trace():
    from perfbench import peaks

    traced = _run()
    read = {n: registry.metric_reader(n).read(traced) for n in _names()}
    assert read["dinf.rotations"] == 10
    assert read["glue.fill_ms"] == 0
    assert read["glue.dinf_dirs_ms"] == pytest.approx(0.010)
    assert read["glue.dinf_ms"] == pytest.approx(0.020)
    assert read["glue.unspanned_ms"] == pytest.approx(0.040)
    bound = 12 * 10**6 * 2 / peaks.HBM_BYTES_PER_S
    assert read["dinf.roofline_pct"] == pytest.approx(
        100 * bound / (2 * 1000e-6))
    # the sweeps are no glue
    assert read["glue.device_ms"] == pytest.approx(0.070)
