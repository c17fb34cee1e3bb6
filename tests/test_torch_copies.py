"""The port's own copies of the reference's JAX-free modules ↔ the
originals.

The port imports nothing of ``richdem_tpu``, so it carries copies of
``topology.py`` (the D8 encoding), ``synth.py`` (as ``synth_np``, the numpy
DEM generators of the tests and the on-card gates), ``native/`` (the C++
engine; its answers are held against the original's in
tests/test_torch_isolation.py and, on the card, in ``chip_smoke.py``), and,
for the API and the two-pass programs, ``provenance.py``,
``checkpoint.py``, ``io/``, the ``oracle/`` modules (``flowdirs``,
``orlandini``, ``fill``, ``fill_variants``, ``flats``, ``accum``,
``terrain``, ``breach``), ``parallel/layout.py`` and
``parallel/labelgraph.py``, which are the originals with the package's
module paths renamed (checked line for line), and ``version.py`` (the same
version).  The tables must be equal, the generators bitwise equal, and a
raster written by one package must read back bitwise in the other.
"""

import os

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


# -- copies of the API slice's JAX-free modules --------------------------

#: Files of the port that are the reference's file with the package's
#: module paths renamed, and nothing else.
VERBATIM = ("provenance.py", "checkpoint.py", "io/__init__.py",
            "io/npyio.py", "io/asciigrid.py", "io/geotiff.py",
            "oracle/flowdirs.py", "oracle/orlandini.py",
            "parallel/layout.py", "oracle/fill.py",
            "oracle/fill_variants.py", "oracle/flats.py", "oracle/accum.py",
            "oracle/terrain.py", "oracle/breach.py",
            "parallel/labelgraph.py")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _as_reference(text):
    """The port's text with its module paths renamed back."""
    return (text.replace("richdem_tpu_torch.", "richdem_tpu.")
            .replace("from richdem_tpu_torch import",
                     "from richdem_tpu import"))


@pytest.mark.parametrize("path", VERBATIM)
def test_verbatim_copies(path):
    with open(os.path.join(_REPO, "richdem_tpu_torch", path),
              encoding="utf-8") as fh:
        copy = fh.read()
    with open(os.path.join(_REPO, "richdem_tpu", path),
              encoding="utf-8") as fh:
        original = fh.read()
    assert _as_reference(copy) == original


def test_version_and_provenance():
    """One version number, one set of citations, and history lines of one
    form (``stamp | richdem_tpu <version> | call``) in both packages."""
    from richdem_tpu import provenance, version
    from richdem_tpu_torch import provenance as tprov
    from richdem_tpu_torch import version as tversion

    assert tversion.__version__ == version.__version__
    assert tversion.PROGRAM_IDENTIFIER.startswith("richdem_tpu_torch ")
    assert tprov.CITATIONS == provenance.CITATIONS
    for key in ("Dinf", "d8lad", "priority_flood", "nothing"):
        assert tprov.cite(key) == provenance.cite(key)

    class Raster:
        metadata = {"PROCESSING_HISTORY": "earlier"}

    a, b = Raster(), Raster()
    a.metadata, b.metadata = dict(a.metadata), dict(b.metadata)
    tprov.add_history(a, "X(dem)")
    provenance.add_history(b, "X(dem)")
    got = a.metadata["PROCESSING_HISTORY"].splitlines()
    want = b.metadata["PROCESSING_HISTORY"].splitlines()
    assert got[0] == want[0] == "earlier"
    assert got[1].split(" | ")[1:] == want[1].split(" | ")[1:]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("ext,kw", [
    (".npz", {}), (".asc", {}), (".tif", {}),
    (".tif", {"compress": "lzw", "predictor": 3})])
def test_io_round_trip_across_packages(tmp_path, writer, ext, kw):
    """A raster written by one package reads back in the other bitwise as
    in the writer itself (and equal to the data, except in the ten-digit
    text of ``.asc``), nodata, georeferencing and history included."""
    from richdem_tpu import io as jio
    from richdem_tpu.grid import rdarray as jrdarray
    from richdem_tpu_torch import io as tio
    from richdem_tpu_torch.grid import rdarray as trdarray

    dem = synth.with_nodata_holes(synth.perlin_dem(21, 34, seed=2),
                                  no_data=-9999.0, seed=2)
    meta = {"PROCESSING_HISTORY": "t | richdem_tpu 0.1.0 | X(dem)"}
    gt = (10.0, 2.0, 0.0, 50.0, 0.0, -2.0)
    make, mine, other = ((trdarray, tio, jio) if writer == "port"
                         else (jrdarray, jio, tio))
    path = tmp_path / f"r{ext}"
    mine.save(path, make(dem, no_data=-9999.0, geotransform=gt,
                         metadata=meta), **kw)
    back, own = other.load(path), mine.load(path)
    np.testing.assert_array_equal(back.np(), own.np())
    assert back.np().dtype == own.np().dtype
    if ext == ".asc":
        np.testing.assert_allclose(back.np(), dem, rtol=1e-9)
    else:
        np.testing.assert_array_equal(back.np(), dem)
        assert back.metadata == own.metadata
        assert back.metadata["PROCESSING_HISTORY"] == \
            meta["PROCESSING_HISTORY"]
    assert back.no_data == own.no_data == -9999.0
    assert back.geotransform == own.geotransform
    np.testing.assert_allclose(back.geotransform, gt)


def test_oracle_flowdirs_copy_answers_alike():
    from richdem_tpu.oracle import flowdirs as jflow
    from richdem_tpu_torch.oracle import flowdirs as tflow

    dem = synth.with_nodata_holes(synth.perlin_dem(24, 29, seed=5),
                                  no_data=-9999.0, seed=5)
    for fn, kw in (("d8_flowdirs", {}), ("dinf_flowdirs", {}),
                   ("flow_proportions", {"method": "Quinn"})):
        np.testing.assert_array_equal(
            getattr(tflow, fn)(dem, no_data=-9999.0, **kw),
            getattr(jflow, fn)(dem, no_data=-9999.0, **kw))


def test_layout_across_packages(tmp_path):
    """Tiles split by one package merge back in the other."""
    from richdem_tpu.grid import rdarray as jrdarray
    from richdem_tpu.parallel import layout as jlayout
    from richdem_tpu_torch.grid import rdarray as trdarray
    from richdem_tpu_torch.parallel import layout as tlayout

    dem = synth.perlin_dem(30, 41, seed=6)
    lay = tlayout.split_to_layout(trdarray(dem), str(tmp_path / "a"),
                                  (16, 16))
    np.testing.assert_array_equal(jlayout.merge_by_layout(lay).np(), dem)
    lay = jlayout.split_to_layout(jrdarray(dem), str(tmp_path / "b"),
                                  (8, 32))
    assert tlayout.read_layout(lay) == jlayout.read_layout(lay)
    np.testing.assert_array_equal(tlayout.merge_by_layout(lay).np(), dem)


def test_oracle_copies_answer_alike():
    """The copied oracles give the originals' answers (fill, ε-fill, flat
    resolution, accumulation, a terrain attribute, breaching)."""
    from richdem_tpu import oracle as jo
    from richdem_tpu_torch.oracle import accum, breach, fill, flats, terrain

    dem = synth.with_nodata_holes(synth.depression_dem(20, 23, seed=4),
                                  no_data=-9999.0, seed=4)
    f = fill.priority_flood_epsilon(dem, no_data=-9999.0, eps=1e-3)
    np.testing.assert_array_equal(
        f, jo.priority_flood_epsilon(dem, no_data=-9999.0, eps=1e-3))
    np.testing.assert_array_equal(
        fill.priority_flood_fill(dem, no_data=-9999.0),
        jo.priority_flood_fill(dem, no_data=-9999.0))
    fd = jo.d8_flowdirs(fill.priority_flood_fill(dem, no_data=-9999.0),
                        no_data=-9999.0)
    np.testing.assert_array_equal(flats.resolve_flats(dem, fd, -9999.0),
                                  jo.resolve_flats(dem, fd, -9999.0))
    np.testing.assert_array_equal(accum.d8_accumulation(fd),
                                  jo.d8_accumulation(fd))
    np.testing.assert_array_equal(
        terrain.terrain_attribute(dem, "curvature", no_data=-9999.0),
        jo.terrain_attribute(dem, "curvature", no_data=-9999.0))
    np.testing.assert_array_equal(
        breach.breach_depressions(dem, no_data=-9999.0, mode="Complete"),
        jo.breach_depressions(dem, no_data=-9999.0, mode="Complete"))
