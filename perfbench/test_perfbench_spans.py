"""The span readers on a hand-built trace with known answers: kernels
under nested spans, a claimed sweep, an unspanned copy, a kernel whose
launch the window lacks, a launch on another thread, syncs inside and
outside the spans, and an idle gap half inside a span."""

import pytest

from perfbench import registry, spans

GLUE = ("glue.fill_ms", "glue.d8_ms", "glue.accum_ms", "glue.terrain_ms",
        "glue.props_ms", "glue.mfd_ms", "glue.unspanned_ms")
NEW = GLUE + ("host.syncs", "device.idle_in_program_pct")


def _span(name, ts, dur, cat="user_annotation", tid=1):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1,
            "tid": tid}


def _call(name, ts, corr, tid=1):
    return {"name": name, "cat": "cuda_runtime", "ts": ts, "dur": 3,
            "pid": 1, "tid": tid, "args": {"correlation": corr}}


def _op(name, ts, dur, corr, cat="kernel"):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0,
            "tid": 7, "args": {"correlation": corr}}


def _trace():
    host = [
        _span("perfbench.terrain_pipeline", 0, 900),
        _span("rd.fill", 100, 300),
        _span("rd.props", 500, 300),
        _span("rd.d8", 550, 100),
        # the profiler's device-side copy of a span is no span
        _span("rd.mfd", 0, 1000, cat="gpu_user_annotation", tid=7),
        _call("cudaLaunchKernel", 150, 1),
        _call("cudaLaunchKernel", 200, 2),
        _call("cudaLaunchKernel", 560, 3),
        _call("cudaLaunchKernel", 700, 4),
        _call("cudaMemcpyAsync", 450, 5),
        _call("cudaLaunchKernel", 150, 6, tid=2),
        _call("cudaStreamSynchronize", 300, 7),
        _call("cudaStreamSynchronize", 600, 8),
        _call("cudaDeviceSynchronize", 950, 9),
    ]
    device = [
        _op("void at::native::elementwise_kernel<128, 2>", 160, 20, 1),
        _op("void fill_sweep_kernel<false>", 210, 100, 2),
        _op("void rd::tile::kernel<rd::D8Op>", 570, 30, 3),
        _op("void at::native::vectorized_elementwise_kernel<4>", 710, 40,
            4),
        _op("Memcpy DtoD (Device -> Device)", 455, 10, 5,
            cat="gpu_memcpy"),
        _op("void at::native::elementwise_kernel<128, 4>", 300, 7, 6),
        _op("void at::native::reduce_kernel<512, 1>", 900, 5, 99),
    ]
    return {"t0": 0, "t1": 1000, "device": device, "host": host}


def _run(trace, steps=2):
    return {"trace": trace, "steps": steps, "cells": 1, "counters": {},
            "claimed": registry.claimed_kernels()}


def _read(name, run):
    return registry.metric_reader(name).read(run)


def test_the_readers_put_the_glue_down_to_its_spans():
    run = _run(_trace())
    want = {"glue.fill_ms": 0.010, "glue.d8_ms": 0.015,
            "glue.props_ms": 0.020, "glue.unspanned_ms": 0.011,
            "glue.accum_ms": None, "glue.terrain_ms": None,
            "glue.mfd_ms": None, "host.syncs": 1.0,
            "device.idle_in_program_pct": 41.0}
    for name, value in want.items():
        got = _read(name, run)
        if value is None:
            assert got is None, name
        else:
            assert got == pytest.approx(value), name


def test_the_glue_split_sums_to_the_glue():
    run = _run(_trace())
    split = [_read(name, run) for name in GLUE]
    glue = _read("glue.device_ms", run)
    assert glue == pytest.approx(0.056)
    assert sum(v for v in split if v is not None) == pytest.approx(glue)


def test_idle_in_program_is_at_most_the_idle():
    run = _run(_trace())
    assert _read("device.idle_in_program_pct", run) \
        <= _read("device.idle_pct", run)


def test_no_new_reader_claims_kernels():
    assert registry.claimed_kernels() == (
        "accum_sweep_kernel", "fill_sweep_kernel", "fill_scan_kernel",
        "MfdField")
    for name in NEW:
        reader = registry.metric_reader(name)
        assert not hasattr(reader, "KERNELS"), name
        assert set(reader.SPANS) <= set(spans.ALL), name


@pytest.mark.parametrize("name", NEW)
def test_a_reader_without_its_spans_reads_nothing(name):
    trace = _trace()
    trace["host"] = [e for e in trace["host"]
                     if not e["name"].startswith("rd.")]
    assert _read(name, _run(trace)) is None
    reader = registry.metric_reader(name)
    kept = _trace()
    kept["host"] = [e for e in kept["host"] if e["name"] not in reader.SPANS
                    or e["cat"] != "user_annotation"]
    assert _read(name, _run(kept)) is None
    assert _read(name, _run(None)) is None


def test_the_innermost_span_owns_a_point():
    outer = _span("rd.props", 0, 100)
    inner = _span("rd.d8", 10, 20)
    other = _span("rd.fill", 0, 100, tid=2)
    points = [((1, 1), 5), ((1, 1), 15), ((1, 1), 40), ((1, 1), 100),
              ((1, 2), 15), ((1, 3), 15)]
    assert spans.owners([outer, inner, other], points) == [
        "rd.props", "rd.d8", "rd.props", None, "rd.fill", None]
