"""The port's own copies of the reference's JAX-free modules ↔ the
originals.

The port imports nothing of ``richdem_tpu``, so it carries copies of
``topology.py`` (the D8 encoding), ``synth.py`` (as ``synth_np``, the numpy
DEM generators of the tests and the on-card gates) and ``native/`` (the C++
engine; its answers are held against the original's in
tests/test_torch_isolation.py and, on the card, in ``chip_smoke.py``).  The
tables must be equal and the generators bitwise equal.
"""

import numpy as np
import pytest

from richdem_tpu import synth, topology
from richdem_tpu_torch import synth_np
from richdem_tpu_torch import topology as ttopology

TABLES = ("DX", "DY", "D8_INVERSE", "DR", "IS_DIAGONAL", "DIRECTION_ANGLE",
          "TAUDEM_TO_RICHDEM", "RICHDEM_TO_TAUDEM")


@pytest.mark.parametrize("name", TABLES)
def test_topology_tables_equal(name):
    got, want = getattr(ttopology, name), getattr(topology, name)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_topology_scalars_and_helpers_equal():
    for name in ("NO_FLOW", "FLOWDIR_NO_DATA", "SQRT2", "D4_DIRECTIONS",
                 "D8_DIRECTIONS"):
        got, want = getattr(ttopology, name), getattr(topology, name)
        assert type(got) is type(want) and got == want, name
    assert (list(ttopology.neighbors(0, 1, 3, 4, ttopology.Topology.D4))
            == list(topology.neighbors(0, 1, 3, 4, topology.Topology.D4)))
    fd = np.arange(-1, 9, dtype=np.int8)
    np.testing.assert_array_equal(ttopology.from_taudem_d8(fd),
                                  topology.from_taudem_d8(fd))


SEEDED = {
    "perlin_dem": dict(height=37, width=52, octaves=4),
    "depression_dem": dict(height=40, width=33, n_pits=5),
}
UNSEEDED = {
    "cone_dem": dict(height=21, width=30),
    "inverted_cone_dem": dict(height=22, width=17),
    "saddle_dem": dict(height=19, width=26),
    "plateau_dem": dict(height=32, width=40, margin=6),
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_generators_bitwise(name, seed):
    for dtype in (np.float32, np.float64):
        kw = dict(SEEDED[name], seed=seed, dtype=dtype)
        got = getattr(synth_np, name)(**kw)
        want = getattr(synth, name)(**kw)
        assert got.dtype == want.dtype == dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(UNSEEDED))
def test_analytic_generators_bitwise(name):
    got = getattr(synth_np, name)(**UNSEEDED[name])
    want = getattr(synth, name)(**UNSEEDED[name])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [1, 4])
def test_nodata_holes_bitwise(seed):
    dem = synth.perlin_dem(45, 38, seed=seed)
    got = synth_np.with_nodata_holes(dem, no_data=-9999.0, seed=seed,
                                     n_holes=5)
    want = synth.with_nodata_holes(dem, no_data=-9999.0, seed=seed,
                                   n_holes=5)
    assert (got == -9999.0).any()
    np.testing.assert_array_equal(got, want)
