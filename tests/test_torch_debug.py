"""The port's debug module and stencil helpers ↔ the JAX package's.

``PhaseTimer`` gives the reference's summary lines for the same phase
times; ``check_raster`` the reference's messages for the same raster, as a
numpy array or as a tensor; ``trace`` writes a Chrome-format trace that
Perfetto opens.  ``all_neighbors`` and ``neighbor_distances`` are bitwise
the reference's.  The layer spans open at their entries, once each and
nested only where one entry calls another, while a profiler records; the
basin layers' spans hold every operator their entries run; they cost a
shared null context without one, and change no output.
"""

import json

import numpy as np
import pytest
import torch

from richdem_tpu import debug as jdebug
from richdem_tpu_torch import debug as tdebug
from richdem_tpu_torch._build import JUMP_TILE
from richdem_tpu_torch import synth as tsynth

torch.set_num_threads(1)


def test_phase_timer_summary_lines_match():
    t = tdebug.PhaseTimer()
    with t.phase("a"):
        sum(range(1000))
    with t.phase("b"):
        pass
    with t.phase("a"):
        pass
    s = t.summary()
    assert "a:" in s and "b:" in s and list(t.times) == ["a", "b"]
    j = jdebug.PhaseTimer()
    j.times = dict(t.times)
    assert s == j.summary()


def _messages(check, arr, **kw):
    with pytest.raises(ValueError) as info:
        check(arr, **kw)
    return str(info.value)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["nan", "inf", "below", "above"])
def test_check_raster_messages_match(dtype, case):
    a = np.ones((4, 5), dtype)
    kw = {}
    if case == "nan":
        a[1, 2] = a[3, 0] = np.nan
    elif case == "inf":
        a[2, 4] = -np.inf
    elif case == "below":
        a[0, 3] = a[2, 1] = -5.0
        kw = {"lo": 0.0}
    else:
        a[3, 3] = 7.0
        kw = {"hi": 2.0, "name": "filled"}
    want = _messages(jdebug.check_raster, a, **kw)
    assert _messages(tdebug.check_raster, a, **kw) == want
    assert _messages(tdebug.check_raster, torch.from_numpy(a), **kw) == want


def test_check_raster_passes_through():
    a = np.ones((4, 4))
    assert tdebug.check_raster(a, lo=0.0, hi=2.0) is a
    t = torch.ones(3, 3)
    assert tdebug.check_raster(t, lo=0.0, hi=2.0) is t
    assert tdebug.check_raster(torch.full((2, 2), np.nan), finite=False) \
        is not None


def test_trace_writes_a_perfetto_trace(tmp_path):
    with tdebug.trace(str(tmp_path / "prof")):
        x = torch.rand(64, 64)
        (x @ x).sum()
    with open(tmp_path / "prof" / tdebug.TRACE_FILE) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_stencil_helpers_match_jax():
    from richdem_tpu.ops import stencil as jstencil
    from richdem_tpu_torch.ops import stencil as tstencil

    x = np.random.default_rng(0).random((2, 7, 9)).astype(np.float32)
    got = tstencil.all_neighbors(torch.from_numpy(x), -3.0)
    want = np.asarray(jstencil.all_neighbors(x, -3.0))
    assert tuple(got.shape) == want.shape == (8, 2, 7, 9)
    np.testing.assert_array_equal(got.numpy(), want)
    for cellsize, dtype in ((1.0, np.float32), (2.5, np.float64)):
        got = tstencil.neighbor_distances(
            cellsize, dtype=getattr(torch, np.dtype(dtype).name),
            device="cpu")
        want = np.asarray(jstencil.neighbor_distances(cellsize, dtype))
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def _d8_pipeline(z):
    import richdem_tpu_torch as rt

    out = rt.terrain_pipeline(z, eps=0.0, with_twi=True)
    return [out[k] for k in ("filled", "flowdirs", "accum", "slope", "twi")]


def _quinn(z):
    import richdem_tpu_torch as rt
    from richdem_tpu_torch.ops.fill import fill_depressions_info

    filled, _, done = fill_depressions_info(z, eps=1e-2, max_iters=256)
    assert done
    props = rt.flow_proportions(filled, "Quinn")
    acc, _, done = rt.flow_accumulation_from_props(props, return_info=True)
    assert done
    return [filled, props, acc]


def _d8_props(z):
    import richdem_tpu_torch as rt

    return [rt.flow_proportions(z, "D8")]


def _dinf_twi(z):
    """The D∞ cell's step: ε-fill, angles, accumulation, slope and TWI
    through the public entries."""
    import richdem_tpu_torch as rt
    from richdem_tpu_torch.ops.fill import fill_depressions_info

    filled, _, done = fill_depressions_info(z, eps=1e-2, max_iters=256)
    assert done
    angles = rt.dinf_flowdirs(filled)
    acc, _, done = rt.dinf_accumulation_from_angles(angles,
                                                    return_info=True)
    assert done
    slope = rt.terrain_attribute(filled, "slope_radians")
    return [filled, angles, acc, slope, rt.twi(acc, slope)]


def _basin_inputs(z):
    """The ε = 0 fill of a 16 × 24 corner of ``z`` (the plain walks take a
    Python loop a row), its D8 codes and nodata mask, the resolved codes,
    and every terminal as a gauge."""
    import richdem_tpu_torch as rt
    from richdem_tpu_torch.ops.fill import fill_depressions_info
    from richdem_tpu_torch.ops.flowdirs import d8_core

    z = z[:16, :24].contiguous()
    mask = torch.zeros(z.shape, dtype=torch.bool)
    filled, _, done = fill_depressions_info(z, mask, eps=0.0, max_iters=256)
    assert done
    codes = d8_core(filled, mask)
    fd = rt.resolve_flats(filled, codes)
    return filled, codes, mask, fd, fd == 0


def _basins(z):
    import richdem_tpu_torch as rt

    _, _, _, fd, seeds = _basin_inputs(z)
    return [fd, rt.watersheds_from_flowdirs(fd), rt.strahler_order(fd),
            rt.upslope_cells(seeds, fd)]


#: Each path, the spans it opens (name: count) and the (outer, inner)
#: pairs of spans nested one in the other.
PATHS = {"d8_pipeline": (_d8_pipeline, {"rd.fill": 1, "rd.d8": 1,
                                        "rd.accum": 1, "rd.terrain": 2},
                         set()),
         "basins": (_basins, {"rd.fill": 1, "rd.d8": 1, "rd.flats": 1,
                              "rd.watersheds": 1, "rd.strahler": 1,
                              "rd.upslope": 1}, set()),
         "quinn": (_quinn, {"rd.fill": 1, "rd.props": 1, "rd.mfd": 1},
                   set()),
         "d8_props": (_d8_props, {"rd.props": 1, "rd.d8": 1},
                      {("rd.props", "rd.d8")}),
         # the accumulation's entry calls the two-tap one, and on the CPU
         # the terrain attribute its plain version: each opens its span
         "dinf_twi": (_dinf_twi, {"rd.fill": 1, "rd.dinf_dirs": 1,
                                  "rd.dinf": 2, "rd.terrain": 3},
                      {("rd.dinf", "rd.dinf"),
                       ("rd.terrain", "rd.terrain")})}


def _dem():
    return tsynth.perlin_dem(24, 40, seed=3, device="cpu")


def _profiled_events(call, tmp_path):
    """The events of a profiled ``call()``'s Chrome trace, and its
    outputs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = call()
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    with open(trace) as fh:
        return json.load(fh)["traceEvents"], out


def _rd_spans(events):
    return [e for e in events if e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith("rd.")]


def _profiled_spans(path, tmp_path):
    """The ``rd.*`` spans a profiled call of ``path`` leaves in its Chrome
    trace, and the call's outputs."""
    z = _dem()
    events, out = _profiled_events(lambda: path(z), tmp_path)
    return _rd_spans(events), out


@pytest.mark.parametrize("name", sorted(PATHS))
def test_entries_open_their_layer_spans(name, tmp_path):
    path, counts, nested = PATHS[name]
    spans, _ = _profiled_spans(path, tmp_path)
    got = {}
    for s in spans:
        got[s["name"]] = got.get(s["name"], 0) + 1
    assert got == counts
    pairs = {(a["name"], b["name"]) for a in spans for b in spans
             if a is not b and a["ts"] <= b["ts"]
             and b["ts"] + b["dur"] <= a["ts"] + a["dur"]}
    assert pairs == nested


@pytest.mark.parametrize("name", sorted(PATHS))
def test_outputs_are_bitwise_with_the_profiler_on_and_off(name, tmp_path):
    path = PATHS[name][0]
    _, traced = _profiled_spans(path, tmp_path)
    plain = path(_dem())
    assert len(traced) == len(plain)
    for a, b in zip(traced, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_without_a_profiler_a_span_is_one_null_context(monkeypatch,
                                                       tmp_path):
    """No profiler: every span is the one shared null context and no
    ``record_function`` is entered; with one, each span is entered."""
    from torch.profiler import record_function

    entered = []

    def counting(name):
        entered.append(name)
        return record_function(name)

    monkeypatch.setattr(tdebug, "record_function", counting)
    null = tdebug.span(tdebug.SPANS[0])
    assert all(tdebug.span(n) is null for n in tdebug.SPANS)
    _d8_pipeline(_dem())
    assert entered == []
    _profiled_spans(_d8_pipeline, tmp_path)
    assert sorted(entered) == sorted(["rd.fill", "rd.d8", "rd.accum",
                                      "rd.terrain", "rd.terrain"])


#: The entries of the basin layers and the span each opens;
#: ``_serpentine``: the walk once more on a path that turns back across
#: every row and crosses the jump's tiles, so that its rounds over the
#: tiles' border slots run too.
BASIN_ENTRIES = {"flats": "rd.flats", "watersheds": "rd.watersheds",
                 "watersheds_serpentine": "rd.watersheds",
                 "strahler": "rd.strahler", "upslope": "rd.upslope",
                 "upslope_serpentine": "rd.upslope"}


def _serpentine(n):
    """Each even row flows E and each odd row W, then S at the row's end;
    the path's last cell is the one terminal."""
    fd = torch.empty((n, n), dtype=torch.int8)
    fd[0::2], fd[1::2] = 5, 1
    fd[0::2, -1], fd[1::2, 0] = 7, 7
    fd[-1, -1 if n % 2 else 0] = 0
    return fd


def _basin_entry(entry, filled, codes, mask, fd, seeds):
    import richdem_tpu_torch as rt
    from richdem_tpu_torch.ops.flats import resolve_flats_info

    if entry == "flats":
        return resolve_flats_info(filled, codes, mask)
    if entry == "strahler":
        return rt.strahler_order(fd)
    if entry.startswith("watersheds"):
        return rt.watersheds_from_flowdirs(fd, return_info=True)
    return rt.upslope_cells(seeds, fd, return_info=True)


@pytest.mark.parametrize("entry", sorted(BASIN_ENTRIES))
def test_a_basin_span_owns_every_operation_of_its_entry(entry, tmp_path):
    """Every operator a basin entry runs, the jump's doubling rounds
    included, lies in the one span it opens, so a trace puts all its work
    on its layer."""
    from perfbench import spans

    name = BASIN_ENTRIES[entry]
    inputs = _basin_inputs(_dem())
    if entry.endswith("_serpentine"):
        fd = _serpentine(2 * JUMP_TILE + 3)
        inputs = inputs[:3] + (fd, fd == 0)
    events, out = _profiled_events(lambda: _basin_entry(entry, *inputs),
                                   tmp_path)
    if entry.endswith("_serpentine"):
        assert out[1:] == (0, "jump") and out[0].unique().numel() == 1
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    held = spans.owners(_rd_spans(events),
                        [((e.get("pid"), e.get("tid")), e["ts"])
                         for e in ops])
    assert ops and set(held) == {name}
    assert [s["name"] for s in _rd_spans(events)] == [name]


#: The D∞ entries and the span each opens (the accumulation's entry opens
#: it twice, once more in the two-tap entry it calls).
DINF_ENTRIES = {"dinf_flowdirs": "rd.dinf_dirs",
                "dinf_accumulation": "rd.dinf",
                "dinf_accumulation_from_angles": "rd.dinf"}


def _dinf_entry(entry, filled):
    import richdem_tpu_torch as rt
    from richdem_tpu_torch.ops.dinf import dinf_accumulation, dinf_two_tap

    angles = rt.dinf_flowdirs(filled)
    if entry == "dinf_flowdirs":
        return lambda: rt.dinf_flowdirs(filled)
    if entry == "dinf_accumulation":
        code, p = dinf_two_tap(angles)
        return lambda: dinf_accumulation(code, p, return_info=True)
    return lambda: rt.dinf_accumulation_from_angles(angles,
                                                    return_info=True)


@pytest.mark.parametrize("entry", sorted(DINF_ENTRIES))
def test_a_dinf_span_owns_every_operation_of_its_entry(entry, tmp_path):
    """Every operator a D∞ entry runs, its rotations' transposes and
    ``torch.equal`` included, lies in the span it opens."""
    from perfbench import spans

    name = DINF_ENTRIES[entry]
    filled = _dinf_twi(_dem())[0]
    events, out = _profiled_events(_dinf_entry(entry, filled), tmp_path)
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    held = spans.owners(_rd_spans(events),
                        [((e.get("pid"), e.get("tid")), e["ts"])
                         for e in ops])
    assert ops and set(held) == {name}
    assert {s["name"] for s in _rd_spans(events)} == {name}


def test_the_dinf_steps_glue_is_all_spanned(tmp_path):
    """No operator of the D∞ cell's step lies outside the program's spans,
    and the accumulation's lie in ``rd.dinf``: a trace of the step on a
    card leaves none of its glue unspanned."""
    from perfbench import spans

    z = _dem()
    events, _ = _profiled_events(lambda: _dinf_twi(z), tmp_path)
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    held = spans.owners(_rd_spans(events),
                        [((e.get("pid"), e.get("tid")), e["ts"])
                         for e in ops])
    assert [e["name"] for e, h in zip(ops, held) if h is None] == []
    assert set(held) == {"rd.fill", "rd.dinf_dirs", "rd.dinf",
                         "rd.terrain"}
    equals = [h for e, h in zip(ops, held) if e["name"] == "aten::equal"]
    assert equals and set(equals) == {"rd.dinf"}


@pytest.mark.parametrize("name", ["rd.nope", "perfbench.window", "",
                                  "rd.gauges", "rd.flat"])
def test_an_unknown_span_raises(name):
    with pytest.raises(ValueError, match="unknown span"):
        tdebug.span(name)


def test_every_reader_reads_spans_the_program_opens():
    """A renamed span fails here, not only on the card: each benchmark
    reader's ``SPANS`` lies within the program's."""
    from perfbench import registry

    readers = [registry.metric_reader(n) for n in registry.listed("metrics")]
    read = [r.SPANS for r in readers if hasattr(r, "SPANS")]
    assert read
    for names in read:
        assert names and set(names) <= set(tdebug.SPANS), names
