"""Port Rho8 ↔ the JAX reference.

The reference draws Rho8's random diagonal distances from ``jax.random``
(XLA) or from the TPU's own generator (Pallas); the port from Philox4x32-10
keyed by the seed and counting the flat index, in the kernel and in the
plain version alike.  The streams differ, so the comparison is split:

* the plain core ``rho8_plain`` is bitwise the reference's
  ``_neighbor_slopes(diag_dist=)`` + ``_steepest`` given one diagonal
  raster (both divide by the float32 distance);
* the port's stream is Philox4x32-10 (Random123's known answers) and is
  unbiased: on a plane whose aspect lies θ past a cardinal, the diagonal
  wins in a share within 0.015 of θ/45°, the reference's hardware check
  (``tests/test_pallas.py``; the binomial spread at 252² cells is 0.002);
* nodata agrees with ``rho8_flowdirs_pallas`` in interpret mode, and Rho4,
  which draws nothing, is bitwise the reference's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from richdem_tpu import methods as jm
from richdem_tpu import synth
from richdem_tpu.ops import accum as jaccum
from richdem_tpu.ops import flowdirs as jflow
from richdem_tpu.ops.pallas_stencils import rho8_flowdirs_pallas
import richdem_tpu_torch as rt
from richdem_tpu_torch import convert
from richdem_tpu_torch.ops import accum as tacc
from richdem_tpu_torch.ops import flowdirs as tflow
from richdem_tpu_torch.ops.successor import successor_table

torch.set_num_threads(1)

ND = -9999.0


def _holed_dem(hw, seed):
    return synth.with_nodata_holes(
        synth.perlin_dem(*hw, seed=seed, dtype=np.float32), no_data=ND,
        seed=4)


#: (counter, key) → output of Philox4x32-10 (Random123's kat_vectors)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    ctr = [torch.tensor([c], dtype=torch.int64) for c in counter]
    got = tflow.philox4x32(ctr, key[0] | (key[1] << 32))
    assert tuple(int(x) for x in got) == want


@pytest.mark.parametrize("seed", [0, 5, 2 ** 33 + 7, 2 ** 64 - 1, -3])
def test_philox_round_keys(seed):
    """The round keys the Rho8 kernel takes from the host are the schedule
    of ``philox4x32``: round r keys ``(k0 + r·0x9E3779B9, k1 +
    r·0xBB67AE85)`` mod 2³² from the seed's low and high words, and
    running the rounds with them gives ``philox4x32``'s words."""
    k0, k1 = seed % 2 ** 32, (seed >> 32) % 2 ** 32
    keys = tflow.philox_round_keys(seed)
    assert keys == tuple(((k0 + r * 0x9E3779B9) % 2 ** 32,
                          (k1 + r * 0xBB67AE85) % 2 ** 32)
                         for r in range(10))
    ctr = np.random.default_rng(seed % 1000).integers(0, 2 ** 32, (4, 16))
    got = tflow.philox4x32([torch.from_numpy(c) for c in ctr], seed)
    for j in range(ctr.shape[1]):  # the rounds in Python integers
        c0, c1, c2, c3 = (int(x) for x in ctr[:, j])
        for rk0, rk1 in keys:
            p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
            c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ rk0, p1 % 2 ** 32,
                              (p0 >> 32) ^ c3 ^ rk1, p0 % 2 ** 32)
        assert tuple(int(w[j]) for w in got) == (c0, c1, c2, c3)


@pytest.mark.parametrize("topology", ["D8", "D4"])
@pytest.mark.parametrize("hw,cellsize,seed", [((61, 90), 1.0, 2),
                                              ((100, 37), 2.5, 3)])
def test_rho8_plain_bitwise_vs_jax_core(hw, cellsize, seed, topology):
    """Same DEM, mask and diagonal raster: codes bitwise equal."""
    dem = _holed_dem(hw, seed)
    z, m = convert.from_numpy(dem, ND, device="cpu")
    u = np.random.default_rng(seed).random(hw, dtype=np.float32)
    diag = (1.0 + np.tan(u * np.float32(math.pi / 4))).astype(np.float32)
    got = tflow.rho8_plain(z, m, cellsize, torch.from_numpy(diag),
                           topology).numpy()
    dirs = (1, 3, 5, 7) if topology == "D4" else tuple(range(1, 9))
    mask = jnp.asarray(m.numpy())
    slopes = jflow._neighbor_slopes(jnp.asarray(dem), mask,
                                    jnp.asarray(cellsize, jnp.float32), dirs,
                                    diag_dist=jnp.asarray(diag))
    want = np.asarray(jnp.where(mask, jnp.int8(-1),
                                jflow._steepest(slopes, dirs)))
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_rho8_stream_is_seeded_and_sound():
    """One seed, one stream; another seed, other codes.  Codes lie in
    0..8, -1 exactly at nodata, and never point into nodata."""
    dem = _holed_dem((80, 96), 5)
    a = rt.rho8_flowdirs(dem, ND, seed=11, device="cpu")
    b = rt.rho8_flowdirs(torch.from_numpy(dem), ND, seed=11)
    c = rt.rho8_flowdirs(dem, ND, seed=12, device="cpu")
    assert a.dtype == torch.int8 and torch.equal(a, b)
    assert int((a != c).sum()) > 0
    nd = torch.from_numpy(dem == ND)
    assert torch.equal(a == -1, nd)
    assert bool(((a >= 0) & (a <= 8))[~nd].all())
    succ = successor_table(a)
    flows = (a > 0).reshape(-1)
    assert not bool(nd.reshape(-1)[succ][flows].any())
    assert torch.equal(tflow.rho8_diagonal((80, 96), 11, "cpu"),
                       tflow.rho8_diagonal((80, 96), 11, "cpu"))


@pytest.mark.parametrize("theta_deg", [10.0, 30.0])
def test_rho8_plain_stream_unbiased(theta_deg):
    h = w = 256
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    th = math.radians(theta_deg)
    z = (-(np.cos(th) * x + np.sin(th) * y)).astype(np.float32)
    fd = rt.rho8_flowdirs(z, seed=3, device="cpu").numpy()
    inner = fd[2:-2, 2:-2]
    assert set(np.unique(inner)) <= {5, 6}
    share = float((inner == 6).mean())
    assert abs(share - theta_deg / 45.0) < 0.015, share


def test_rho8_nodata_agrees_with_pallas_interpret():
    z = synth.depression_dem(96, seed=5, dtype=np.float32)
    z[40:50, 40:50] = ND
    if jax.default_backend() != "tpu":
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(rho8_flowdirs_pallas(jnp.asarray(z),
                                                   no_data=ND))
    else:
        want = np.asarray(rho8_flowdirs_pallas(jnp.asarray(z), no_data=ND))
    got = rt.rho8_flowdirs(z, ND, device="cpu").numpy()
    np.testing.assert_array_equal(got == -1, want == -1)
    assert (got[40:50, 40:50] == -1).all()
    # both are steepest descents over the same neighbours: where a cell has
    # no lower data neighbour, both say NO_FLOW
    np.testing.assert_array_equal(got == 0, want == 0)


def test_topology_keyword_matches_jax():
    """``topology=`` by keyword in both packages (D4, and Rho4, which reads
    no diagonal and so draws nothing: bitwise the reference's)."""
    dem = _holed_dem((61, 90), 2)
    want = np.asarray(jflow.d8_flowdirs(jnp.asarray(dem), no_data=ND,
                                        topology="D4"))
    got = tflow.d8_flowdirs(dem, no_data=ND, topology="D4", device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    want4 = np.asarray(jflow.rho8_flowdirs(jnp.asarray(dem), no_data=ND,
                                           seed=1, topology="D4"))
    got4 = rt.rho8_flowdirs(dem, no_data=ND, seed=1, topology="D4",
                            device="cpu")
    np.testing.assert_array_equal(got4.numpy(), want4)
    np.testing.assert_array_equal(want4, want)
    with pytest.raises(ValueError, match="topology"):
        rt.rho8_flowdirs(dem, topology="D6", device="cpu")
    # the reference's key and max_iters, by name and in their places
    t = torch.from_numpy(dem)
    codes = rt.rho8_flowdirs(t, ND, None, 1)
    assert torch.equal(codes, rt.rho8_flowdirs(t, no_data=ND, seed=1))
    assert torch.equal(rt.rho8_flowdirs(t, ND, key=None, seed=1), codes)
    assert torch.equal(rt.rho8_flowdirs(t, None, None, 0),
                       rt.rho8_flowdirs(t, seed=0))
    with pytest.raises(ValueError, match="cannot reproduce jax.random"):
        rt.rho8_flowdirs(t, ND, key=object())
    props = rt.flow_proportions(t, "Rho8", ND, None, 1.0, None, 1)
    assert torch.equal(props, tflow.proportions_from_d8(codes))
    with pytest.raises(ValueError, match="cannot reproduce jax.random"):
        rt.flow_proportions(t, "Rho8", ND, key=object())
    fd = tflow.d8_flowdirs(t, no_data=ND)
    order = rt.strahler_order(fd, max_iters=64)
    np.testing.assert_array_equal(
        order.numpy(), np.asarray(jm.strahler_order(jnp.asarray(fd.numpy()),
                                                    max_iters=4096)))
    with pytest.raises(RuntimeError, match="did not converge within 1 "):
        rt.strahler_order(fd, max_iters=1)
    with pytest.raises(TypeError, match="not both"):
        rt.strahler_order(fd, max_rotations=8, max_iters=8)
    quinn = rt.flow_proportions(t, "Quinn", ND)
    acc, rot, done = tacc.flow_accumulation_from_props(
        quinn, max_iters=512, return_info=True)
    assert done and torch.equal(
        acc, tacc.flow_accumulation_from_props(quinn, max_rotations=512))
    with pytest.raises(RuntimeError, match="did not converge within 1 "):
        tacc.flow_accumulation_from_props(quinn, max_iters=1)
    with pytest.raises(TypeError, match="not both"):
        tacc.flow_accumulation_from_props(quinn, max_rotations=8,
                                          max_iters=8)


@pytest.mark.parametrize("method,topology", [("Rho8", "D8"), ("rho4", "D4")])
def test_flow_proportions_rho8(method, topology):
    dem = torch.from_numpy(_holed_dem((40, 52), 7))
    got = tflow.flow_proportions(dem, method, ND, seed=9)
    codes = tflow.rho8_flowdirs(dem, ND, seed=9, topology=topology)
    assert torch.equal(got, tflow.proportions_from_d8(codes))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jflow.proportions_from_d8(
            jnp.asarray(codes.numpy()))))


def test_rho8_accumulation_slice_vs_jax():
    """The Rho8 path, ε-fill → Rho8 → D8 accumulation: the port's codes
    accumulate bitwise as the reference's ``d8_accumulation`` does them
    (unit weights), and mass is conserved exactly."""
    z = torch.from_numpy(synth.perlin_dem(96, 128, seed=0,
                                          dtype=np.float32))
    filled = rt.fill_epsilon(z, eps=rt.auto_epsilon(z))
    codes = rt.rho8_flowdirs(filled, seed=0)
    acc = tacc.d8_accumulation(codes)
    want = np.asarray(jaccum.d8_accumulation(jnp.asarray(codes.numpy())))
    np.testing.assert_array_equal(acc.numpy(), want)
    assert float(acc[codes == 0].double().sum()) == z.numel()
