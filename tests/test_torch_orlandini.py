"""Orlandini D8-LTD/LAD: the port's device fixpoint (plain PyTorch,
``ops/orlandini.py``) and its copy of the serial oracle ↔ the JAX package.

Same float64 DEM (numpy, seeded) through every side; codes are compared
bitwise, as the reference gates its own device fixpoint against its oracle
(tests/test_ops_flowdirs.py).
"""

import numpy as np
import pytest
import torch

import richdem_tpu as jrd
from richdem_tpu import oracle, synth
from richdem_tpu.ops.orlandini import \
    orlandini_flowdirs_device as jax_device
from richdem_tpu.oracle.orlandini import orlandini_flowdirs as jax_oracle
import richdem_tpu_torch as rt
from richdem_tpu_torch.ops import orlandini as torl
from richdem_tpu_torch.oracle.orlandini import orlandini_flowdirs

torch.set_num_threads(1)

ND = -9999.0


def _filled(n, seed):
    return oracle.priority_flood_epsilon(
        synth.perlin_dem(n, seed=seed, dtype=np.float64), eps=1e-3)


@pytest.mark.parametrize("mode", ["LTD", "LAD"])
def test_device_matches_oracles_and_jax(mode):
    """Every λ: the port's device codes equal the port's oracle, the JAX
    oracle and the JAX device fixpoint, bitwise."""
    filled = _filled(48, 6)
    for lam in (1.0, 0.5, 0.0):
        got = torl.orlandini_flowdirs_device(filled, lam=lam, mode=mode,
                                             device="cpu").numpy()
        want = jax_oracle(filled, lam=lam, mode=mode)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            orlandini_flowdirs(filled, lam=lam, mode=mode), want)
        np.testing.assert_array_equal(
            got, np.asarray(jax_device(filled, lam=lam, mode=mode)))


def test_device_with_nodata_and_cellsize():
    dem = synth.with_nodata_holes(_filled(40, 7), no_data=ND)
    got = torl.orlandini_flowdirs_device(dem, no_data=ND, cellsize=2.5,
                                         device="cpu").numpy()
    want = jax_oracle(dem, no_data=ND, cellsize=2.5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[dem == ND], -1)
    np.testing.assert_array_equal(
        orlandini_flowdirs(dem, no_data=ND, cellsize=2.5), want)


def test_api_engines_match_jax_api():
    """``FlowDirections(method="Orlandini"/"D8LAD")`` on the host oracle
    (default) and on the device (``engine="device"``) gives the JAX API's
    codes, with its nodata value."""
    filled = _filled(32, 8)
    for method, exponent in (("Orlandini", None), ("D8LAD", 0.5)):
        want = jrd.FlowDirections(jrd.rdarray(filled), method=method,
                                  exponent=exponent)
        rd = rt.rdarray(torch.from_numpy(filled))
        host = rt.FlowDirections(rd, method=method, exponent=exponent)
        dev = rt.FlowDirections(rd, method=method, exponent=exponent,
                                engine="device")
        np.testing.assert_array_equal(host.np(), want.np())
        np.testing.assert_array_equal(dev.np(), want.np())
        assert host.no_data == dev.no_data == want.no_data == -1.0
        assert torch.is_tensor(dev.data) and dev.data.device.type == "cpu"


def test_fixpoint_info_and_cap():
    """The fixpoint takes as many iterations as the longest flow path has
    steps; a cap below that raises, and a bad mode is refused."""
    filled = _filled(24, 9)
    z = torch.from_numpy(filled)
    nd = torch.zeros(z.shape, dtype=torch.bool)
    fd, iters, done = torl.orlandini_info(z, nd, 1.0, 1.0, "LTD", 4096)
    assert done and iters > 2 and fd.dtype == torch.int8
    _, iters1, done1 = torl.orlandini_info(z, nd, 1.0, 1.0, "LTD", 1)
    assert iters1 == 1 and not done1
    with pytest.raises(RuntimeError, match="did not converge"):
        torl.orlandini_flowdirs_device(z, max_iters=1)
    with pytest.raises(ValueError, match="LTD"):
        torl.orlandini_flowdirs_device(z, mode="XYZ")
