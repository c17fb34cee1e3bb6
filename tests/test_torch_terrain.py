"""Port terrain attributes (plain version of the terrain kernel) ↔ the JAX
reference.

Same float32 DEM with nodata holes, ``zscale=2`` and ``cellsize=3``, through
both sides.  The port repeats the TPU kernel's arithmetic operation for
operation, without fused multiply-adds.  In interpret mode the Pallas kernel
runs through XLA on the CPU, which contracts a product and a sum into one
FMA: its rise/run is ``sqrt(fma(fy, fy, fx·fx))`` in every cell of these
DEMs.  So only ``curvature`` (no product feeds a sum) is bitwise.  The
tolerances, settled on from that:

* rise/run and percentage: rtol 2.4e-7 (2 ulp; one rounding apart);
* slope radians and degrees, aspect: rtol 1e-6 (atan/atan2 implementations
  differ between the frameworks as well);
* planform and profile curvature: atol 1e-6 of the largest |value| (the
  fused sum of three products differs by an ulp of its terms, and the
  terms cancel).

Against the XLA ``terrain_attribute`` (``hypot`` in place of the kernel's
sqrt) all eight are allclose at rtol 1e-5 and the same atol.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from richdem_tpu import synth
from richdem_tpu.ops.pallas_stencils import terrain_attribute_pallas
from richdem_tpu.ops.terrain import terrain_attribute as jax_terrain
from richdem_tpu_torch.ops import terrain as tterrain

torch.set_num_threads(1)

ND = -9999.0
ATAN = ("slope_radians", "slope_degrees", "aspect")
CANCEL = ("planform_curvature", "profile_curvature")


def _dem(h, w, seed):
    return synth.with_nodata_holes(
        synth.perlin_dem(h, w, seed=seed, dtype=np.float32), no_data=ND,
        seed=seed, n_holes=3, max_radius=5)


def _same_nan(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    return ~np.isnan(want)


@pytest.mark.parametrize("attrib", tterrain.TERRAIN_ATTRIBUTES)
def test_terrain_matches_pallas_kernel(attrib):
    dem = _dem(40, 52, 4)
    got = tterrain.terrain_attribute(dem, attrib, zscale=2.0, cellsize=3.0,
                                     no_data=ND, device="cpu").numpy()
    if jax.default_backend() != "tpu":
        with pltpu.force_tpu_interpret_mode():
            want = terrain_attribute_pallas(dem, attrib, zscale=2.0,
                                            cellsize=3.0, no_data=ND)
    else:
        want = terrain_attribute_pallas(dem, attrib, zscale=2.0,
                                        cellsize=3.0, no_data=ND)
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    ok = _same_nan(got, want)
    assert np.isnan(got[dem == ND]).all() and ok.sum() > 1000
    if attrib == "curvature":
        np.testing.assert_array_equal(got[ok], want[ok])
    elif attrib in ATAN:
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6, atol=0)
    elif attrib in CANCEL:
        np.testing.assert_allclose(got[ok], want[ok], rtol=0,
                                   atol=1e-6 * np.abs(want[ok]).max())
    else:
        np.testing.assert_allclose(got[ok], want[ok], rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("attrib", tterrain.TERRAIN_ATTRIBUTES)
def test_terrain_matches_xla(attrib):
    dem = _dem(57, 46, 6)
    got = tterrain.terrain_attribute(dem, attrib, zscale=2.0, cellsize=3.0,
                                     no_data=ND, device="cpu").numpy()
    want = np.asarray(jax_terrain(jnp.asarray(dem), attrib, zscale=2.0,
                                  cellsize=3.0, no_data=ND))
    ok = _same_nan(got, want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5,
                               atol=1e-6 * np.abs(want[ok]).max())


def test_slope_riserun_entry_point_and_errors():
    dem = _dem(30, 33, 8)
    z = torch.from_numpy(dem)
    got = tterrain.slope_riserun(z, zscale=2.0, cellsize=3.0, no_data=ND)
    assert got.device == z.device  # a tensor runs where it lives
    want = tterrain.terrain_plain(
        z, z == ND, 2.0, 3.0, "slope_riserun")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="unknown terrain attribute"):
        tterrain.terrain_attribute(z, "slope", device="cpu")
