"""The port's debug module and stencil helpers ↔ the JAX package's.

``PhaseTimer`` gives the reference's summary lines for the same phase
times; ``check_raster`` the reference's messages for the same raster, as a
numpy array or as a tensor; ``trace`` writes a Chrome-format trace that
Perfetto opens.  ``all_neighbors`` and ``neighbor_distances`` are bitwise
the reference's.
"""

import json

import numpy as np
import pytest
import torch

from richdem_tpu import debug as jdebug
from richdem_tpu_torch import debug as tdebug

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
