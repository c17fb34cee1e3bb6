"""The port's device Perlin generator ↔ the shared numpy generator.

Same seed, so the same per-octave lattices (drawn from
``numpy.random.default_rng`` in the same order); the port evaluates the
field in float32, the numpy generator in float64, hence atol 1e-3 at
amplitude 100.  ``richdem_tpu.synth_jax`` draws its lattices from
``jax.random``, whose bits cannot be reproduced in PyTorch, so the port is
not compared with it.
"""

import numpy as np
import pytest
import torch

from richdem_tpu import synth
from richdem_tpu_torch import synth as tsynth

torch.set_num_threads(1)


@pytest.mark.parametrize("hw,seed,octaves", [((64, 64), 0, 5),
                                             ((97, 150), 7, 4),
                                             ((200, 33), 3, 6)])
def test_perlin_matches_numpy_generator(hw, seed, octaves):
    got = tsynth.perlin_dem(*hw, seed=seed, octaves=octaves,
                            device="cpu")
    want = synth.perlin_dem(*hw, seed=seed, octaves=octaves,
                            dtype=np.float64)
    assert got.dtype == torch.float32 and tuple(got.shape) == hw
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_perlin_is_deterministic_and_seeded():
    a = tsynth.perlin_dem(40, 50, seed=1, device="cpu")
    assert torch.equal(a, tsynth.perlin_dem(40, 50, seed=1, device="cpu"))
    assert not torch.equal(a, tsynth.perlin_dem(40, 50, seed=2,
                                                device="cpu"))


# -- the device generators of synth_jax and synth -------------------------

ANALYTIC = {"cone_dem": dict(height=37, width=52),
            "saddle_dem": dict(height=41, width=29),
            "plateau_dem": dict(height=32, width=40, margin=6),
            "inverted_cone_dem": dict(height=22, width=17)}


@pytest.mark.parametrize("name", sorted(ANALYTIC))
def test_analytic_generators_match_numpy_and_jax(name):
    """Bitwise the numpy generators in float32 (both round float64 once);
    within 4
    ulp of the surface's largest |value| of ``synth_jax``'s, which rounds
    each of its float32 steps (that is how far ``synth_jax`` lies from
    the numpy generators itself)."""
    from richdem_tpu import synth_jax

    kw = ANALYTIC[name]
    got = getattr(tsynth, name)(**kw, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), getattr(synth, name)(**kw))
    # float64 output: within 2 ulp of the largest |value| (torch's and
    # numpy's hypot may part in the last bit before 1 - r/rmax cancels)
    want64 = getattr(synth, name)(**kw, dtype=np.float64)
    np.testing.assert_allclose(
        getattr(tsynth, name)(**kw, dtype=torch.float64,
                              device="cpu").numpy(), want64, rtol=0,
        atol=2 * np.spacing(np.abs(want64).max()))
    if hasattr(synth_jax, name):
        want = np.asarray(getattr(synth_jax, name)(**kw))
        ulp = np.spacing(np.float32(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4 * ulp)


@pytest.mark.parametrize("seed", [0, 7])
def test_depression_dem_matches_numpy_generator(seed):
    """The pits are drawn from ``default_rng(seed)`` in the numpy
    generator's order (``jax.random`` cannot be reproduced): allclose in
    float32."""
    got = tsynth.depression_dem(40, 33, seed=seed, n_pits=5, device="cpu")
    want = synth.depression_dem(40, 33, seed=seed, n_pits=5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [1, 4])
def test_nodata_holes_match_numpy_generator(seed):
    dem = synth.perlin_dem(45, 38, seed=seed)
    got = tsynth.with_nodata_holes(torch.from_numpy(dem), no_data=-9999.0,
                                   seed=seed, n_holes=5)
    want = synth.with_nodata_holes(dem, no_data=-9999.0, seed=seed,
                                   n_holes=5)
    assert (want == -9999.0).any()
    np.testing.assert_array_equal(got.numpy(), want)
    # a copy: the input is untouched
    assert not (dem == -9999.0).any()


@pytest.mark.parametrize("row0,nrows", [(0, 128), (128, 256), (384, 128)])
def test_perlin_rows_bitwise_slices_of_the_field(row0, nrows):
    """As tests/test_synth_jax.py holds ``synth_jax``'s strips."""
    full = tsynth.perlin_dem(512, 384, seed=3, device="cpu")
    win = tsynth.perlin_dem_rows(512, 384, row0, nrows, seed=3,
                                 device="cpu")
    assert tuple(win.shape) == (nrows, 384)
    assert torch.equal(full[row0:row0 + nrows], win)


def test_perlin_rows_cover_an_odd_tail():
    full = tsynth.perlin_dem(200, 96, seed=11, device="cpu")
    parts = [tsynth.perlin_dem_rows(200, 96, r0, min(64, 200 - r0),
                                    seed=11, device="cpu")
             for r0 in range(0, 200, 64)]
    assert torch.equal(full, torch.cat(parts))
