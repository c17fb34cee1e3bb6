"""The port's sharded mesh ↔ the JAX package's, on the CPU: one case per
test of tests/test_sharded.py, plus the halo exchange.

The port's mesh is 2×4 positions of ``torch.device("cpu")`` (a device may
repeat); the reference's is the conftest's 8 virtual CPU devices.  The
same seeded float32 DEM goes through both (the conftest enables float64 in
JAX, so both sides get float32).  Each case holds the port's sharded op
against the port's single-device op with the reference test's own
comparison (bitwise where it is ``assert_array_equal``), and against the
reference's sharded op:

* plain fills, D8 codes, D8 accumulations (integer sums far below 2²⁴),
  the two-pass results and ε-fills at these sizes are bitwise (every
  engine takes per-edge ``fl(w + ε)`` steps here);
* terrain attributes: the port's kernel formula (rise/run as
  ``sqrt(fx² + fy²)``) against the reference's ``hypot``, as in
  tests/test_torch_terrain.py — rise/run rtol 2.4e-7 (2 ulp), aspect
  rtol 1e-6 (atan2), curvature atol 1e-6 of the largest |value|;
* the multi-flow cases are in tests/test_torch_sharded_mfd.py.
"""

import math

import numpy as np
import pytest
import torch

from richdem_tpu import oracle, synth
from richdem_tpu.ops.flowdirs import d8_flowdirs as jax_d8
from richdem_tpu.parallel import make_mesh as jax_make_mesh
from richdem_tpu.parallel import sharded as js
from richdem_tpu.parallel.mesh import best_factorization as jax_best
from richdem_tpu_torch.ops.accum import d8_accumulation
from richdem_tpu_torch.ops.fill import fill_depressions
from richdem_tpu_torch.ops.flowdirs import d8_flowdirs
from richdem_tpu_torch.ops.sweeps import BIG
from richdem_tpu_torch.ops.terrain import terrain_attribute
from richdem_tpu_torch.parallel import halo, mesh as tmesh, sharded as ts

torch.set_num_threads(1)

ND = -9999.0
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh8():
    return tmesh.make_mesh([CPU] * 8)  # 2 x 4


@pytest.fixture(scope="module")
def jmesh8():
    import jax

    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return jax_make_mesh()


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def test_best_factorization(mesh8):
    for n in (8, 4, 7, 16, 1, 12):
        assert tmesh.best_factorization(n) == jax_best(n)
    assert tmesh.best_factorization(8) == (2, 4)
    assert mesh8.shape == (2, 4) and mesh8.group is None
    assert mesh8.local_positions == [(r, c) for r in range(2)
                                     for c in range(4)]
    with pytest.raises(ValueError, match=r"mesh shape \(3, 3\) != 8 "
                       "devices"):
        tmesh.make_mesh([CPU] * 8, (3, 3))
    import jax

    with pytest.raises(ValueError, match=r"mesh shape \(3, 3\) != 8 "
                       "devices"):
        jax_make_mesh(jax.devices(), (3, 3))


@pytest.mark.parametrize("halo_k", [1, 2])
@pytest.mark.parametrize("fill", [0.0, -BIG, math.nan])
def test_exchange_halo_equals_padded_slices(mesh8, halo_k, fill):
    """Every extended block is the slice of the raster padded by ``halo``
    cells of ``fill``; a bool mask travels alike."""
    rng = np.random.default_rng(1)
    z = torch.from_numpy(rng.random((12, 20), dtype=np.float32))
    sh = tmesh.grid_sharding(mesh8)
    ext = halo.exchange_halo(sh.split(z), mesh8, halo=halo_k, fill=fill)
    k = halo_k
    padded = torch.nn.functional.pad(z, (k, k, k, k), value=fill)
    for p, e in ext.items():
        rs, cs = sh.index(z.shape, p)
        want = padded[rs.start:rs.stop + 2 * k, cs.start:cs.stop + 2 * k]
        assert e.shape == want.shape
        np.testing.assert_array_equal(e.numpy(), want.numpy())
    m = z > 0.5
    ext_m = halo.exchange_halo(sh.split(m), mesh8, halo=halo_k, fill=True)
    padded_m = torch.nn.functional.pad(m, (k, k, k, k), value=True)
    for p, e in ext_m.items():
        rs, cs = sh.index(z.shape, p)
        assert e.dtype == torch.bool
        assert torch.equal(e, padded_m[rs.start:rs.stop + 2 * k,
                                       cs.start:cs.stop + 2 * k])


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_sharded_fill_equals_single_device(mesh8, jmesh8, eps):
    dem = synth.depression_dem(64, seed=3, dtype=np.float32)
    stats = {}
    got = ts.sharded_fill(dem, mesh=mesh8, eps=eps, stats=stats)
    single = fill_depressions(dem, eps=eps, device="cpu")
    np.testing.assert_array_equal(got.numpy(), single.numpy())
    want = js.sharded_fill(dem, mesh=jmesh8, eps=eps)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert stats["fill_outer_iters"] >= 2 and stats["fill_rotations"] > 0


def test_sharded_fill_with_nodata(mesh8, jmesh8):
    dem = synth.depression_dem(64, seed=9, dtype=np.float32)
    dem = synth.with_nodata_holes(dem, no_data=ND, seed=1, n_holes=3)
    mask = dem == ND
    got = ts.sharded_fill(dem, mesh=mesh8, nodata_mask=mask)
    single = fill_depressions(dem, no_data=ND, device="cpu")
    np.testing.assert_array_equal(got.numpy(), single.numpy())
    want = js.sharded_fill(dem, mesh=jmesh8, nodata_mask=mask)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def _held_to_jax_terrain(attrib, got, want):
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), ~ok)
    if attrib == "aspect":
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6, atol=0)
    elif attrib == "curvature":
        np.testing.assert_allclose(got[ok], want[ok], rtol=0,
                                   atol=1e-6 * np.abs(want[ok]).max())
    else:
        np.testing.assert_allclose(got[ok], want[ok], rtol=2.4e-7, atol=0)


def test_sharded_terrain_equals_single_device(mesh8, jmesh8):
    dem = synth.perlin_dem(64, seed=7, dtype=np.float32)
    for attrib in ("slope_riserun", "aspect", "curvature"):
        got = ts.sharded_terrain_attribute(dem, attrib, mesh=mesh8).numpy()
        single = terrain_attribute(dem, attrib, device="cpu").numpy()
        np.testing.assert_array_equal(got, single)
        want = np.asarray(js.sharded_terrain_attribute(dem, attrib,
                                                       mesh=jmesh8))
        _held_to_jax_terrain(attrib, got, want)


def test_sharded_flowdirs_equal_single_device(mesh8, jmesh8):
    dem = oracle.priority_flood_epsilon(
        synth.perlin_dem(64, seed=5, dtype=np.float64),
        eps=1e-6).astype(np.float32)
    got = ts.sharded_d8_flowdirs(dem, mesh=mesh8).numpy()
    np.testing.assert_array_equal(got, d8_flowdirs(dem, device="cpu"))
    np.testing.assert_array_equal(
        got, np.asarray(js.sharded_d8_flowdirs(dem, mesh=jmesh8)))


def test_sharded_accum_equals_single_device(mesh8, jmesh8):
    dem = oracle.priority_flood_epsilon(
        synth.perlin_dem(64, seed=11, dtype=np.float64), eps=1e-6)
    fd = np.asarray(jax_d8(dem.astype(np.float32)))
    stats = {}
    got = ts.sharded_accumulation_d8(fd, mesh=mesh8, stats=stats).numpy()
    np.testing.assert_array_equal(got, d8_accumulation(fd, device="cpu"))
    np.testing.assert_array_equal(
        got, np.asarray(js.sharded_accumulation_d8(fd, mesh=jmesh8)))
    assert stats["accum_outer_iters"] >= 2 and stats["accum_rotations"] > 0


def test_sharded_pipeline_end_to_end(mesh8, jmesh8):
    """Config-5 shape: the port's sharded pipeline equals its single-device
    ops and the reference's sharded pipeline, key by key."""
    dem = synth.depression_dem(64, seed=21, dtype=np.float32)
    out = ts.sharded_pipeline(dem, mesh=mesh8, eps=1e-6)
    want = js.sharded_pipeline(dem, mesh=jmesh8, eps=1e-6)
    filled = fill_depressions(dem, eps=1e-6, device="cpu")
    np.testing.assert_array_equal(out["filled"].numpy(), filled.numpy())
    fd = d8_flowdirs(filled)
    np.testing.assert_array_equal(out["flowdirs"].numpy(), fd.numpy())
    np.testing.assert_array_equal(out["accum"].numpy(),
                                  d8_accumulation(fd).numpy())
    np.testing.assert_array_equal(
        out["slope"].numpy(),
        terrain_attribute(filled, "slope_radians").numpy())
    for key in ("filled", "flowdirs", "accum"):
        np.testing.assert_array_equal(out[key].numpy(), _np(want[key]))
    np.testing.assert_allclose(out["slope"].numpy(), _np(want["slope"]),
                               rtol=1e-6, atol=0)


def test_uneven_mesh_shapes(mesh8, jmesh8):
    """67×74 over the 2×4 mesh: padded with nodata, cropped back; every
    sharded op equals its single-device counterpart and the reference's
    sharded op."""
    dem = synth.depression_dem(67, 74, seed=2, dtype=np.float32)
    filled_s = ts.sharded_fill(dem, mesh=mesh8, eps=1e-3).numpy()
    filled_1 = fill_depressions(dem, eps=1e-3, device="cpu").numpy()
    assert filled_s.shape == (67, 74)
    np.testing.assert_array_equal(filled_s, filled_1)
    np.testing.assert_array_equal(
        filled_s, np.asarray(js.sharded_fill(dem, mesh=jmesh8, eps=1e-3)))

    fd_s = ts.sharded_d8_flowdirs(filled_1, mesh=mesh8).numpy()
    fd_1 = d8_flowdirs(filled_1, device="cpu").numpy()
    np.testing.assert_array_equal(fd_s, fd_1)

    acc_s = ts.sharded_accumulation_d8(fd_1, mesh=mesh8).numpy()
    np.testing.assert_array_equal(acc_s, d8_accumulation(fd_1,
                                                         device="cpu"))
    np.testing.assert_array_equal(
        acc_s, np.asarray(js.sharded_accumulation_d8(fd_1, mesh=jmesh8)))

    sl_s = ts.sharded_terrain_attribute(dem, "slope_radians",
                                        mesh=mesh8).numpy()
    np.testing.assert_array_equal(
        sl_s, terrain_attribute(dem, "slope_radians", device="cpu"))


def test_uneven_mesh_pipeline_and_twopass(mesh8, jmesh8):
    """65×70: the sharded pipeline and the two-pass fill equal the
    single-device ops and the reference's."""
    dem = synth.depression_dem(65, 70, seed=9, dtype=np.float32)
    out = ts.sharded_pipeline(dem, mesh=mesh8, eps=0.0)
    filled_1 = fill_depressions(dem, eps=0.0, device="cpu")
    np.testing.assert_array_equal(out["filled"].numpy(), filled_1.numpy())
    fd_1 = d8_flowdirs(filled_1)
    np.testing.assert_array_equal(out["flowdirs"].numpy(), fd_1.numpy())
    np.testing.assert_array_equal(out["accum"].numpy(),
                                  d8_accumulation(fd_1).numpy())
    want = js.sharded_pipeline(dem, mesh=jmesh8, eps=0.0)
    for key in ("filled", "flowdirs", "accum"):
        np.testing.assert_array_equal(out[key].numpy(), _np(want[key]))
    two = ts.sharded_fill_twopass(dem, mesh=mesh8).numpy()
    np.testing.assert_array_equal(two, filled_1.numpy())
    np.testing.assert_array_equal(
        two, np.asarray(js.sharded_fill_twopass(dem, mesh=jmesh8)))


def test_sharded_fill_twopass_equals_schwarz_and_jax(mesh8, jmesh8):
    """[P1] over the mesh tiling: exactly 2 passes, bitwise the Schwarz
    sharded fill and the reference's two-pass fill."""
    dem = synth.depression_dem(64, seed=3, dtype=np.float32)
    stats = {}
    two = ts.sharded_fill_twopass(dem, mesh=mesh8, stats=stats).numpy()
    assert stats["data_passes"] == 2
    np.testing.assert_array_equal(
        two, ts.sharded_fill(dem, mesh=mesh8, eps=0.0).numpy())
    jstats = {}
    np.testing.assert_array_equal(
        two, np.asarray(js.sharded_fill_twopass(dem, mesh=jmesh8,
                                                stats=jstats)))
    assert stats["n_labels"] == jstats["n_labels"]


def test_sharded_fill_twopass_nodata(mesh8, jmesh8):
    dem = synth.with_nodata_holes(
        synth.depression_dem(64, seed=7, dtype=np.float32), no_data=ND)
    nd = dem == ND
    two = ts.sharded_fill_twopass(dem, mesh=mesh8, no_data=ND).numpy()
    np.testing.assert_array_equal(two, fill_depressions(dem, no_data=ND,
                                                        device="cpu"))
    np.testing.assert_array_equal(
        two, np.asarray(js.sharded_fill_twopass(dem, mesh=jmesh8,
                                                no_data=ND)))
    np.testing.assert_array_equal(two[nd], ND)


def test_sharded_accum_twopass_equals_schwarz_and_jax(mesh8, jmesh8):
    """[P2] over the mesh tiling: exactly 2 local solves per block, bitwise
    the Schwarz mesh path and the reference — incl. a serpentine path
    threading every cell of an uneven grid."""
    dem = synth.perlin_dem(64, seed=4, dtype=np.float64)
    fd = oracle.d8_flowdirs(oracle.priority_flood_epsilon(dem, eps=1e-3))
    stats = {}
    two = ts.sharded_accumulation_d8_twopass(fd, mesh=mesh8,
                                             stats=stats).numpy()
    assert stats["data_passes"] == 2
    np.testing.assert_array_equal(
        two, ts.sharded_accumulation_d8(fd, mesh=mesh8).numpy())
    np.testing.assert_array_equal(
        two, np.asarray(js.sharded_accumulation_d8_twopass(fd,
                                                           mesh=jmesh8)))
    h, w = 48, 52
    serp = np.zeros((h, w), np.int8)
    for r in range(h):
        serp[r, :] = 5 if r % 2 == 0 else 1
        serp[r, -1 if r % 2 == 0 else 0] = 7
    serp[h - 1, 0 if (h - 1) % 2 else w - 1] = 0
    got = ts.sharded_accumulation_d8_twopass(serp, mesh=mesh8).numpy()
    np.testing.assert_array_equal(got, oracle.d8_accumulation(serp))
    assert got.max() == h * w


def test_mesh_devices_and_cpu_default():
    """A 1×1 mesh over ``device`` when no mesh is given; the card by
    default, which raises without one."""
    dem = synth.depression_dem(16, seed=1, dtype=np.float32)
    got = ts.sharded_fill(dem, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  fill_depressions(dem, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ts.sharded_fill(dem)


def test_outer_loop_raises_past_its_cap(mesh8):
    """An outer Schwarz loop that does not converge raises."""
    dem = synth.depression_dem(32, seed=3, dtype=np.float32)
    with pytest.raises(RuntimeError, match="sharded fill did not converge "
                       "within 1 outer"):
        ts.sharded_fill(dem, mesh=mesh8, outer_iters=1)
