"""Port flow directions and proportions ↔ the JAX reference.

D8/D4 (plain version of the D8 kernel), bitwise: against
``ops.flowdirs.d8_core`` on float DEMs with nodata, as both divide by the
float32 distance; against the Pallas kernel ``_d8_impl`` (interpret mode)
on an integer-valued DEM only: that kernel multiplies by a reciprocal
distance, which rounds float near-ties apart from a division, and integer
elevations leave no such ties.

D∞ angles and the multi-flow proportions are XLA stencils in the reference
and plain PyTorch in the port, held allclose with the tolerances stated at
each test: XLA on the CPU contracts ``s1·s1 + s2·s2`` into an FMA, and
atan2, pow and the 8-term sums may round an ulp apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from richdem_tpu import synth
from richdem_tpu.ops import flowdirs as jflow
from richdem_tpu.ops.flowdirs import d8_core as jax_d8_core
from richdem_tpu.ops.pallas_dinf import dinf_two_tap as jax_dinf_two_tap
from richdem_tpu.ops.pallas_stencils import _d8_impl
from richdem_tpu_torch import convert
from richdem_tpu_torch.ops import dinf as tdinf
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
                            topology=topology,
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


def _holed_dem(hw, seed):
    return synth.with_nodata_holes(
        synth.perlin_dem(*hw, seed=seed, dtype=np.float32), no_data=ND,
        seed=4)


CASES = [((61, 90), 1.0, 2), ((100, 37), 2.5, 3)]


@pytest.mark.parametrize("hw,cellsize,seed", CASES)
def test_dinf_flowdirs_vs_jax(hw, cellsize, seed):
    """Angles within 1e-6 rad of ``ops.flowdirs.dinf_flowdirs``: about 1 %
    of the cells differ, by at most 4.8e-7 (the FMA and atan2 ulps), and
    no cell takes another facet (0 cells differ by more than 1e-5).  The
    NO_FLOW (-1) and nodata (-2) cells are the same."""
    dem = _holed_dem(hw, seed)
    got = tflow.dinf_flowdirs(torch.from_numpy(dem), ND, cellsize).numpy()
    want = np.asarray(jflow.dinf_flowdirs(jnp.asarray(dem), ND, cellsize))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got < 0, want < 0)
    np.testing.assert_array_equal(got[got < 0], want[want < 0])
    assert (got[dem == ND] == -2.0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert int((np.abs(got - want) > 1e-5).sum()) == 0


@pytest.mark.parametrize("hw,cellsize,seed", CASES)
def test_dinf_two_tap_and_proportions_bitwise_given_angles(hw, cellsize,
                                                          seed):
    """From the same angles, the two-tap encoding and the decoded
    proportions are bitwise the reference's: both turn angles into
    octants by the float32 reciprocal of π/4."""
    dem = _holed_dem(hw, seed)
    ang = np.array(jflow.dinf_flowdirs(jnp.asarray(dem), ND, cellsize))
    code, p = tdinf.dinf_two_tap(torch.from_numpy(ang))
    jcode, jp = jax_dinf_two_tap(jnp.asarray(ang))
    assert code.dtype == torch.int32 and p.dtype == torch.float32
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    got = tflow.proportions_from_dinf(torch.from_numpy(ang)).numpy()
    want = np.asarray(jflow.proportions_from_dinf(jnp.asarray(ang)))
    np.testing.assert_array_equal(got, want)


#: (method, keywords, atol against the reference's proportions)
METRICS = [
    ("D8", {}, 0.0), ("D4", {}, 0.0),
    # the angles' ulps (test_dinf_flowdirs_vs_jax) pass into the split
    ("Dinf", {}, 1e-6),
    # 8-term sums in another order: 1 ulp of the largest share
    ("Quinn", {}, 6e-8), ("Freeman", {}, 6e-8),
    ("Holmgren", {"exponent": 2.0}, 6e-8),
    # atan2, sqrt and FMA ulps through the facet weights: 2 ulps
    ("SeibertMcGlynn", {}, 1.2e-7), ("mdinf", {"exponent": 1.5}, 1.2e-7),
]


@pytest.mark.parametrize("method,kw,atol", METRICS,
                         ids=[m[0] for m in METRICS])
@pytest.mark.parametrize("hw,cellsize,seed", CASES)
def test_flow_proportions_vs_jax(method, kw, atol, hw, cellsize, seed):
    dem = _holed_dem(hw, seed)
    props = tflow.flow_proportions(torch.from_numpy(dem), method, ND,
                                   cellsize=cellsize, **kw)
    want = np.asarray(jflow.flow_proportions(jnp.asarray(dem), method=method,
                                             no_data=ND, cellsize=cellsize,
                                             **kw))
    got = props.numpy()
    assert got.shape == want.shape == hw + (8,)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert (got[dem == ND] == 0).all()
    # plane-major underneath: the accumulation sweeps read it without a copy
    assert props.permute(2, 0, 1).is_contiguous()


@pytest.mark.parametrize("method", ["Rho8", "rho4"])
def test_rho8_is_not_ported_yet(method):
    """Rho8 is ported now (``tests/test_torch_rho8.py``): its proportions
    are the one-hot proportions of its codes, no longer an error."""
    z = torch.rand(6, 7)
    topology = "D4" if method == "rho4" else "D8"
    got = tflow.flow_proportions(z, method, seed=2)
    assert torch.equal(got, tflow.proportions_from_d8(
        tflow.rho8_flowdirs(z, seed=2, topology=topology)))


def test_flow_proportions_rejects_unknown_and_needs_holmgren_exponent():
    z = torch.rand(6, 7)
    with pytest.raises(ValueError, match="unknown"):
        tflow.flow_proportions(z, "D7")
    with pytest.raises(ValueError, match="exponent"):
        tflow.flow_proportions(z, "Holmgren")
