"""The config-4 slice as a whole: ``bench.py``'s ``dinf_twi`` and
``quinn_mfd`` steps, composed from the port's functions, ↔ the same
composition of the JAX functions on the CPU, at 96×128.

The JAX side fills with ``fill_fixpoint_folded`` (interpret mode, the
engine of the reference's TPU path), which the port matches bitwise at any
ε; the rest of its composition is what the reference runs on the CPU: XLA
angles, proportions, slope and TWI, and Jacobi accumulation.  Tolerances:

* D∞ angles: within 1e-6 rad but in at most 2 cells, where the FMA and
  atan2 ulps tip a facet tie (the two cells measured on this DEM differ
  by 1.9e-4 rad);
* D∞ accumulation: rtol 5e-3 and total within 1e-6.  The gap is the
  reference's own: on the CPU it accumulates unsnapped proportions, while
  its TPU path and the port snap ``p`` to 2⁻¹⁷ — a shift of ≤ 3.8e-6 of a
  large upstream flow lands on a small neighbour (measured here: 9.9e-4
  relative at most);
* TWI: atol 5e-3, the accumulation gap through the log; slope within
  1.2e-7 (XLA's FMA in the rise/run, tests/test_torch_terrain.py);
* Quinn accumulation: rtol 2e-5 and total within 1e-6 (Jacobi and the
  sweeps group float sums differently; measured 8.2e-7).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from richdem_tpu import methods as jmethods
from richdem_tpu import synth
from richdem_tpu.ops import accum as jaccum
from richdem_tpu.ops import flowdirs as jflow
from richdem_tpu.ops import pallas_folded
from richdem_tpu.ops.terrain import terrain_attribute as jax_terrain
import richdem_tpu_torch as rt
from richdem_tpu_torch import convert
from richdem_tpu_torch.ops import accum as tacc
from richdem_tpu_torch.ops import fill as tfill

torch.set_num_threads(1)

FOLD = dict(fold_min=8, fold_pad=64)
EPS = 1e-2  # bench.py's config-4 fill


@functools.lru_cache(maxsize=None)
def _dem():
    return synth.perlin_dem(96, 128, seed=0, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _jax_steps():
    old_cap = pallas_folded._STRIP_CAP
    pallas_folded._STRIP_CAP = 16
    try:
        with pltpu.force_tpu_interpret_mode():
            filled, _, fdone = pallas_folded.fill_fixpoint_folded(
                jnp.asarray(_dem()), eps=EPS, max_iters=256, **FOLD)
    finally:
        pallas_folded._STRIP_CAP = old_cap
        pallas_folded._fill_folded_impl.clear_cache()
    ang = jflow.dinf_flowdirs(filled)
    acc, _, adone = jaccum.dinf_accumulation_from_angles(ang,
                                                         return_info=True)
    slope = jax_terrain(filled, "slope_radians")
    props = jflow.flow_proportions(filled, method="Quinn")
    qacc, _, qdone = jaccum.flow_accumulation_from_props(props,
                                                         return_info=True)
    assert bool(fdone) and bool(adone) and bool(qdone)
    out = {"filled": filled, "angles": ang, "accum": acc, "slope": slope,
           "twi": jmethods.twi(acc, slope), "spi": jmethods.spi(acc, slope),
           "quinn": qacc}
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _port_steps():
    z = torch.from_numpy(_dem())
    filled, _, fdone = tfill.fill_depressions_info(z, eps=EPS,
                                                   max_iters=256)
    ang = rt.dinf_flowdirs(filled)
    acc, arot, adone = rt.dinf_accumulation_from_angles(ang,
                                                        return_info=True)
    slope = rt.terrain_attribute(filled, "slope_radians")
    props = rt.flow_proportions(filled, "Quinn")
    qacc, qrot, qdone = rt.flow_accumulation_from_props(props,
                                                        return_info=True)
    assert fdone and adone and qdone and arot >= 1 and qrot >= 1
    for x in (filled, ang, acc, slope, qacc):
        assert x.dtype == torch.float32 and x.shape == z.shape
    out = {"filled": filled, "angles": ang, "accum": acc, "slope": slope,
           "twi": rt.twi(acc, slope), "spi": rt.spi(acc, slope),
           "quinn": qacc}
    return {k: v.numpy().astype(np.float64) for k, v in out.items()}


def test_filled_surface_bitwise():
    np.testing.assert_array_equal(_port_steps()["filled"],
                                  _jax_steps()["filled"])


def test_dinf_angles():
    got, want = _port_steps()["angles"], _jax_steps()["angles"]
    np.testing.assert_array_equal(got < 0, want < 0)
    off = np.abs(got - want) > 1e-6
    assert int(off.sum()) <= 2
    np.testing.assert_allclose(got[~off], want[~off], rtol=0, atol=1e-6)


def test_dinf_twi_step():
    got, want = _port_steps(), _jax_steps()
    np.testing.assert_allclose(got["accum"], want["accum"], rtol=5e-3)
    assert abs(got["accum"].sum() / want["accum"].sum() - 1) < 1e-6
    np.testing.assert_allclose(got["slope"], want["slope"], rtol=0,
                               atol=1.2e-7)
    np.testing.assert_allclose(got["twi"], want["twi"], rtol=0, atol=5e-3)
    assert np.isfinite(got["twi"]).all()


def test_spi():
    got, want = _port_steps(), _jax_steps()
    np.testing.assert_allclose(got["spi"], want["spi"], rtol=5e-3,
                               atol=1e-6)
    # on the same inputs the index is the reference's, but for XLA's tan,
    # which rounds an ulp apart in 3 % of the cells
    acc = np.asarray(want["accum"], np.float32)
    slope = np.asarray(want["slope"], np.float32)
    np.testing.assert_allclose(
        rt.spi(torch.from_numpy(acc), torch.from_numpy(slope), 2.0).numpy(),
        np.asarray(jmethods.spi(jnp.asarray(acc), jnp.asarray(slope), 2.0)),
        rtol=2.4e-7, atol=0)


def test_quinn_mfd_step():
    got, want = _port_steps()["quinn"], _jax_steps()["quinn"]
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert abs(got.sum() / want.sum() - 1) < 1e-6


@pytest.mark.parametrize("rounds", [None, 3])
def test_d8_doubling_cross_check(rounds):
    """Pointer doubling ↔ the reference's: unit weights sum integers, so
    bitwise with enough rounds, and equal after a cut number too."""
    fd = np.array(jflow.d8_flowdirs(jnp.asarray(
        np.asarray(_jax_steps()["filled"], np.float32))))
    got = tacc.d8_accumulation_doubling(torch.from_numpy(fd),
                                                rounds=rounds)
    want = jaccum.d8_accumulation_doubling(jnp.asarray(fd), rounds=rounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_jacobi_cross_check():
    """The port's Jacobi fixpoint ↔ the reference's on the Quinn
    proportions: the same iteration, summed in the same order."""
    filled = jnp.asarray(np.asarray(_jax_steps()["filled"], np.float32))
    props = np.array(jflow.flow_proportions(filled, method="Quinn"))
    got, it, done = tacc.accumulation_jacobi_info(
        torch.from_numpy(props))
    want, wit, wdone = jaccum.accumulation_jacobi_info(jnp.asarray(props))
    assert done and bool(wdone) and it == int(wit)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_convert_carries_angles_and_proportions():
    """Angle rasters and (H, W, 8) proportions cross between numpy and the
    port as DEMs do: float32 both ways, proportions plane-major on the
    port's side."""
    want = _jax_steps()
    filled = jnp.asarray(np.asarray(want["filled"], np.float32))
    props = np.asarray(jflow.flow_proportions(filled, method="Quinn"))
    ang = np.asarray(want["angles"], np.float32)
    t_props = convert.props_from_numpy(props, device="cpu")
    t_ang = convert.raster_from_numpy(ang, device="cpu")
    assert t_props.shape == props.shape
    assert t_props.permute(2, 0, 1).is_contiguous()
    back = convert.to_numpy({"props": t_props, "angles": t_ang,
                             "spi": rt.spi(t_ang, t_ang)})
    np.testing.assert_array_equal(back["props"], props)
    np.testing.assert_array_equal(back["angles"], ang)
    assert {v.dtype for v in back.values()} == {np.dtype(np.float32)}
