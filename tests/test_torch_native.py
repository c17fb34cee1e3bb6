"""The port's native bindings ↔ the JAX package's, on the same inputs.

Both packages build the same ``core.cpp`` (tests/test_torch_isolation.py
holds the copies equal), so every function answers alike bit for bit:
``available``, ``fill_flowdirs``, ``fill_watersheds``, ``fill_tile`` (the
[P1] consumer, on interior and global-edge tiles), ``slope_radians`` and
``twi``, on tests/test_native.py's fixtures.  ``BreachDepressions`` falls
back to the copied breach oracle when the engine cannot be built, with the
same bits.
"""

import shutil

import numpy as np
import pytest

from richdem_tpu import native as jnative
from richdem_tpu import synth
from richdem_tpu_torch import native as tnative

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++: the engine cannot build")

ND = -9999.0


def _fixtures():
    return {
        "depressions": synth.depression_dem(48, seed=3, dtype=np.float64),
        "perlin": synth.perlin_dem(40, seed=7, dtype=np.float64),
        "holes": synth.with_nodata_holes(
            synth.depression_dem(48, seed=5, dtype=np.float64),
            no_data=ND),
    }


def _equal(got, want):
    assert type(got) is type(want)
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_available():
    assert tnative.available() is True
    assert jnative.available() is True


@pytest.mark.parametrize("name", ["depressions", "holes"])
def test_fill_flowdirs_and_watersheds_match(name):
    dem = _fixtures()[name]
    nd = ND if name == "holes" else None
    _equal(tnative.fill_flowdirs(dem, no_data=nd),
           jnative.fill_flowdirs(dem, no_data=nd))
    _equal(tnative.fill_watersheds(dem, no_data=nd),
           jnative.fill_watersheds(dem, no_data=nd))


@pytest.mark.parametrize("edges", [0, 1 | 4, 15])
@pytest.mark.parametrize("name", ["perlin", "holes"])
def test_fill_tile_matches(name, edges):
    dem = _fixtures()[name]
    nd = ND if name == "holes" else None
    got = tnative.fill_tile(dem, no_data=nd, global_edges=edges)
    _equal(got, jnative.fill_tile(dem, no_data=nd, global_edges=edges))
    assert got[2].shape[1] == 3


def test_slope_and_twi_match():
    dem = _fixtures()["holes"]
    for kw in ({}, {"zscale": 2.0, "cellsize": 3.0}):
        _equal(tnative.slope_radians(dem, no_data=ND, **kw),
               jnative.slope_radians(dem, no_data=ND, **kw))
    slope = tnative.slope_radians(dem, no_data=ND)
    acc = tnative.accum_d8(tnative.d8_flowdirs(tnative.fill(dem, eps=1e-3)))
    for kw in ({}, {"cellsize": 2.0, "min_slope": 1e-3}):
        _equal(tnative.twi(acc, np.nan_to_num(slope), **kw),
               jnative.twi(acc, np.nan_to_num(slope), **kw))


def test_breach_falls_back_to_the_oracle(monkeypatch):
    """Without the engine the API breaches with the copied oracle: the same
    bits as the engine, and as the JAX package's fallback."""
    import richdem_tpu as jrd
    import richdem_tpu_torch as rt

    dem = synth.depression_dem(24, seed=2, dtype=np.float64)
    kw = dict(mode="Selective", max_path_len=10, fill_remainder=True)
    built = rt.BreachDepressions(rt.rdarray(dem, no_data=ND), **kw).np()
    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "breach_depressions", None)
    fallback = rt.BreachDepressions(rt.rdarray(dem, no_data=ND), **kw).np()
    np.testing.assert_array_equal(fallback, built)
    monkeypatch.setattr(jnative, "available", lambda: False)
    want = jrd.BreachDepressions(jrd.rdarray(dem, no_data=ND), **kw).np()
    np.testing.assert_array_equal(fallback, np.asarray(want))
