"""Port D8/D4 flow directions (plain version of the D8 kernel) ↔ the JAX
reference, bitwise.

Against ``ops.flowdirs.d8_core`` on float DEMs with nodata: both divide by
the float32 distance.  Against the Pallas kernel ``_d8_impl`` (interpret
mode) on an integer-valued DEM only: that kernel multiplies by a reciprocal
distance, which rounds float near-ties apart from a division, and integer
elevations leave no such ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from richdem_tpu import synth
from richdem_tpu.ops.flowdirs import d8_core as jax_d8_core
from richdem_tpu.ops.pallas_stencils import _d8_impl
from richdem_tpu_torch import convert
from richdem_tpu_torch.ops import flowdirs as tflow

torch.set_num_threads(1)

ND = -9999.0


@pytest.mark.parametrize("topology", ["D8", "D4"])
@pytest.mark.parametrize("hw,cellsize", [((61, 90), 1.0), ((100, 37), 2.5)])
def test_d8_bitwise_vs_d8_core(hw, cellsize, topology):
    dem = synth.with_nodata_holes(
        synth.perlin_dem(*hw, seed=2, dtype=np.float32), no_data=ND, seed=4)
    z, m = convert.from_numpy(dem, ND, device="cpu")
    got = tflow.d8_flowdirs(torch.from_numpy(dem), no_data=ND,
                            topology_name=topology,
                            cellsize=cellsize).numpy()
    want = np.asarray(jax_d8_core(jnp.asarray(dem), jnp.asarray(m.numpy()),
                                  jnp.asarray(cellsize, jnp.float32),
                                  topology))
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert (got[m.numpy()] == -1).all()


def test_d8_flat_and_tied_neighbours():
    """Flats give NO_FLOW; exact ties take the first direction in 1..8."""
    dem = np.zeros((5, 6), np.float32)
    dem[2, 2] = 1.0  # four straight and four diagonal ties
    dem[4, :] = -1.0
    z, m = convert.from_numpy(dem, None, device="cpu")
    got = tflow.d8_core(z, m).numpy()
    want = np.asarray(jax_d8_core(jnp.asarray(dem), jnp.asarray(m.numpy()),
                                  jnp.asarray(1.0, jnp.float32)))
    np.testing.assert_array_equal(got, want)
    assert got[2, 2] == 1 and got[0, 0] == 0


@pytest.mark.parametrize("d4", [False, True])
def test_d8_bitwise_vs_pallas_kernel_integer_dem(d4):
    rng = np.random.default_rng(17)
    dem = rng.integers(0, 40, size=(48, 70)).astype(np.float32)
    dem[10:14, 20:26] = ND
    z, m = convert.from_numpy(dem, ND, device="cpu")
    got = tflow.d8_core(z, m, 1.0, "D4" if d4 else "D8").numpy()
    if jax.default_backend() != "tpu":
        with pltpu.force_tpu_interpret_mode():
            want = _d8_impl(jnp.asarray(dem), jnp.asarray(m.numpy()),
                            jnp.asarray(1.0, jnp.float32), d4)
    else:
        want = _d8_impl(jnp.asarray(dem), jnp.asarray(m.numpy()),
                        jnp.asarray(1.0, jnp.float32), d4)
    _d8_impl.clear_cache()
    np.testing.assert_array_equal(got, np.asarray(want))


def test_d8_rejects_unknown_topology():
    z, m = convert.from_numpy(np.zeros((4, 4), np.float32), device="cpu")
    with pytest.raises(ValueError):
        tflow.d8_core(z, m, 1.0, "D6")
