"""The port's out-of-core programs ↔ the JAX package's, on the CPU.

``out_of_core_fill`` (two-pass with the device consumer, Schwarz at ε = 0
and ε > 0, the native consumer) and ``out_of_core_accum_d8`` (two-pass and
Schwarz) run with ``device="cpu"`` (the kernels' plain versions) on
``.npy`` rasters, held against the JAX package on the same input: its
out-of-core accumulation, and its in-core fill, which its out-of-core fill
equals.  At ε = 0 the fill is a selection of input values, so every engine and
tiling gives the same bits; the accumulations sum integer weights far
below 2²⁴, so they are bitwise too; at ε > 0 the reference's tolerance
against its oracle (atol 1e-4) is the gate.  The JAX accumulations keep to
one tile shape (48²), so JAX compiles once.
"""

import numpy as np
import pytest
import torch

from richdem_tpu import oracle, synth

torch.set_num_threads(1)

ND = -9999.0


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """96² pits with nodata holes, their ε-fill's D8 codes, and a 100×90
    Perlin DEM with a nodata island across a tile corner at tile 40, all
    saved as ``.npy``."""
    d = tmp_path_factory.mktemp("ooc")
    dem = synth.with_nodata_holes(
        synth.depression_dem(96, seed=5, dtype=np.float32), no_data=ND,
        seed=3)
    filled = oracle.priority_flood_epsilon(dem.astype(np.float64),
                                           no_data=ND, eps=1e-3)
    fd = oracle.d8_flowdirs(filled, no_data=ND)
    ragged = synth.perlin_dem(100, 90, seed=9, dtype=np.float32)
    ragged[30:50, 30:50] = ND
    paths = {"dem": d / "dem.npy", "fd": d / "fd.npy",
             "ragged": d / "ragged.npy"}
    for key, arr in (("dem", dem), ("fd", fd), ("ragged", ragged)):
        np.save(paths[key], arr)
    return d, {k: str(v) for k, v in paths.items()}, dem, fd, ragged


def _port():
    from richdem_tpu_torch.parallel import outofcore
    return outofcore


def _jax():
    from richdem_tpu.parallel import outofcore
    return outofcore


def test_twopass_fill_matches_jax(disk):
    """Two passes of the device consumer on the CPU: bitwise the JAX
    package's fill (its in-core fill, which its own out-of-core fill
    equals; the drivers themselves are held against the JAX package's in
    tests/test_torch_twopass.py), no label raster on disk."""
    from richdem_tpu import ops

    d, p, dem, _, _ = disk
    stats = {}
    got = np.load(_port().out_of_core_fill(
        p["dem"], str(d / "t.npy"), tile=48, method="twopass",
        consumer="device", no_data=ND, stats=stats, device="cpu"))
    want = np.asarray(ops.fill_depressions(dem, no_data=ND))
    np.testing.assert_array_equal(got, want)
    assert stats["method"] == "twopass" and stats["consumer"] == "device"
    assert stats["data_passes"] == 2 and stats["tile_loads"] == 8
    assert (got[dem == ND] == ND).all()
    assert not any("labels" in f.name for f in d.iterdir())


@pytest.mark.parametrize("tile,other", [(32, "native"), (37, "schwarz")])
def test_twopass_fill_ragged_tiles_and_islands(disk, tile, other):
    """Tiles that do not divide the grid, and a nodata island spanning a
    tile corner: bitwise the JAX package's in-core fill; the native
    consumer, and the Schwarz fill at ε = 0, give the same bits."""
    from richdem_tpu import ops

    d, p, _, _, ragged = disk
    port = _port()
    stats = {}
    got = np.load(port.out_of_core_fill(
        p["ragged"], str(d / f"r{tile}.npy"), tile=tile, method="twopass",
        consumer="device", no_data=ND, stats=stats, device="cpu"))
    want = np.asarray(ops.fill_depressions(ragged, no_data=ND))
    np.testing.assert_array_equal(got, want)
    assert stats["data_passes"] == 2
    kw = ({"method": "twopass", "consumer": "native"} if other == "native"
          else {"method": "schwarz"})
    again = {}
    np.testing.assert_array_equal(np.load(port.out_of_core_fill(
        p["ragged"], str(d / f"{other}{tile}.npy"), tile=tile, no_data=ND,
        stats=again, device="cpu", **kw)), got)
    assert again["method"] == kw["method"] and again["data_passes"] >= 2


def test_schwarz_epsilon_fill_matches_jax(disk):
    """ε = 1e-3 by Schwarz sweeps: within the reference's tolerance (atol
    1e-4) of the JAX package's ε-fill and of the oracle's."""
    from richdem_tpu import ops

    d, p, dem, _, _ = disk
    stats = {}
    got = np.load(_port().out_of_core_fill(
        p["dem"], str(d / "se.npy"), tile=48, eps=1e-3, no_data=ND,
        stats=stats, device="cpu"))
    assert stats["method"] == "schwarz" and stats["data_passes"] >= 2
    m = dem != ND
    want = np.asarray(ops.fill_depressions(dem, no_data=ND, eps=1e-3))
    np.testing.assert_allclose(got[m], want[m], rtol=0, atol=1e-4)
    oracle_eps = oracle.priority_flood_epsilon(dem, no_data=ND, eps=1e-3,
                                               dtype=np.float64)
    np.testing.assert_allclose(got[m], oracle_eps[m], rtol=0, atol=1e-4)
    assert (got[~m] == ND).all()


@pytest.mark.parametrize("method", ["twopass", "schwarz"])
def test_accum_matches_jax(disk, method):
    """Weighted accumulation with nodata codes, both methods: bitwise the
    JAX package's, and the topological oracle's within its rtol."""
    d, p, _, fd, _ = disk
    wts = np.full(fd.shape, 2.0)  # float64: the reference's Schwarz
    pw = str(d / "w.npy")         # engine writes into float32 memmaps
    np.save(pw, wts)
    stats, jstats = {}, {}
    got = np.load(_port().out_of_core_accum_d8(
        p["fd"], weights_path=pw, out_path=str(d / f"a{method}.npy"),
        tile=48, method=method, stats=stats, device="cpu"))
    want = np.load(_jax().out_of_core_accum_d8(
        p["fd"], weights_path=pw, out_path=str(d / f"j{method}.npy"),
        tile=48, method=method, stats=jstats))
    np.testing.assert_array_equal(got, want)
    assert stats == jstats
    if method == "twopass":
        assert stats["data_passes"] == 2
    ref = oracle.d8_accumulation(fd, weights=np.where(fd < 0, 0.0, wts))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_accum_float32_weights(disk):
    """A float32 weights raster (which the reference's Schwarz engine
    cannot take: it writes into the read-only memmap) gives both methods
    the same bits."""
    d, _, _, fd, _ = disk
    pf, pw = str(d / "fd48.npy"), str(d / "w32.npy")
    np.save(pf, fd[:48])
    np.save(pw, np.full((48, fd.shape[1]), 2.0, np.float32))
    port = _port()
    got = [np.load(port.out_of_core_accum_d8(
        pf, weights_path=pw, out_path=str(d / f"w32{m}.npy"), tile=48,
        method=m, device="cpu")) for m in ("twopass", "schwarz")]
    np.testing.assert_array_equal(got[0], got[1])


def test_accum_serpentine_ragged_two_passes(tmp_path):
    """[P2] contract: one serpentine path threading every cell of a 21×26
    grid, tile 8 (not dividing it): exactly two passes, and the Schwarz
    engine agrees."""
    h, w = 21, 26
    fd = np.zeros((h, w), np.int8)
    fd[0::2, :] = 5
    fd[0::2, -1] = 7
    fd[1::2, :] = 1
    fd[1::2, 0] = 7
    fd[h - 1, 0 if (h - 1) % 2 else w - 1] = 0
    p = str(tmp_path / "serp.npy")
    np.save(p, fd)
    port = _port()
    stats = {}
    out = np.load(port.out_of_core_accum_d8(p, tile=8, method="twopass",
                                            stats=stats, device="cpu"))
    assert stats["data_passes"] == 2
    np.testing.assert_array_equal(out, oracle.d8_accumulation(fd))
    assert out.max() == h * w
    out2 = np.load(port.out_of_core_accum_d8(
        p, out_path=str(tmp_path / "s.npy"), tile=8, method="schwarz",
        device="cpu"))
    np.testing.assert_array_equal(out, out2)


def test_geotiff_in_and_out(tmp_path):
    """A GeoTIFF streams in through the windowed reader and the device
    consumer's result streams out as a GeoTIFF; nodata and georeferencing
    carry over."""
    from richdem_tpu_torch import io
    from richdem_tpu_torch.grid import rdarray

    dem = synth.with_nodata_holes(synth.depression_dem(70, seed=8,
                                                       dtype=np.float32),
                                  no_data=ND, seed=8)
    gt = (500.0, 10.0, 0.0, 900.0, 0.0, -10.0)
    src = tmp_path / "dem.tif"
    io.save(src, rdarray(dem, no_data=ND, geotransform=gt))
    port = _port()
    out = port.out_of_core_fill(str(src), str(tmp_path / "filled.tif"),
                                tile=24, method="twopass",
                                consumer="device", device="cpu")
    back = io.load(out)
    want = oracle.priority_flood_fill(dem.astype(np.float64), no_data=ND)
    m = dem != ND
    np.testing.assert_allclose(back.np()[m], want[m], rtol=0, atol=1e-5)
    assert back.no_data == ND and (back.np()[~m] == ND).all()
    np.testing.assert_allclose(back.geotransform, gt)
    fd = oracle.d8_flowdirs(oracle.priority_flood_epsilon(
        dem.astype(np.float64), no_data=ND, eps=1e-3), no_data=ND)
    pf = tmp_path / "fd.npy"
    np.save(pf, fd)
    acc = io.load(port.out_of_core_accum_d8(
        str(pf), out_path=str(tmp_path / "acc.tif"), tile=24,
        device="cpu")).np()
    np.testing.assert_array_equal(acc, np.load(port.out_of_core_accum_d8(
        str(pf), out_path=str(tmp_path / "acc.npy"), tile=24,
        device="cpu")))


def test_auto_consumer_on_the_cpu(disk, monkeypatch):
    """``consumer="auto"`` on the CPU takes the native consumer when it
    builds, else the device consumer on the CPU; both give the same
    bits."""
    from richdem_tpu_torch import native

    d, p, _, _, _ = disk
    port = _port()
    out = {}
    for built in (True, False):
        monkeypatch.setattr(native, "available", lambda b=built: b)
        stats = {}
        out[built] = np.load(port.out_of_core_fill(
            p["dem"], str(d / f"auto{built}.npy"), tile=48, no_data=ND,
            stats=stats, device="cpu"))
        assert stats["consumer"] == ("native" if built else "device")
    np.testing.assert_array_equal(out[True], out[False])
    with pytest.raises(ValueError, match="plain fill only"):
        port.out_of_core_fill(p["dem"], tile=48, eps=1e-3,
                              method="twopass", device="cpu")
