"""The port's main path ↔ the JAX pipeline (its XLA path on the CPU).

Same float32 DEM with nodata holes through ``richdem_tpu.pipeline`` and
``richdem_tpu_torch.pipeline``.  At ε = 0 fill, D8 codes and unit-weight
accumulation are exact, so ``filled``, ``flowdirs`` and ``accum`` are
bitwise; slope and TWI go through atan/tan/log, whose implementations
differ, so they are allclose.  Iteration counts are each side's own and are
not compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richdem_tpu import synth
from richdem_tpu.ops.terrain import terrain_core as jax_terrain_core
from richdem_tpu.pipeline import make_pipeline as jax_make_pipeline
from richdem_tpu_torch import check_converged, convert, make_pipeline
from richdem_tpu_torch import terrain_pipeline
from richdem_tpu_torch.ops.terrain import TERRAIN_ATTRIBUTES, terrain_core

torch.set_num_threads(1)

ND = -9999.0


def _dem(h, w, seed):
    return synth.with_nodata_holes(
        synth.perlin_dem(h, w, seed=seed, dtype=np.float32), no_data=ND,
        seed=seed)


@pytest.mark.parametrize("hw,seed", [((96, 130), 1), ((200, 72), 2)])
def test_pipeline_matches_jax(hw, seed):
    dem = _dem(*hw, seed)
    z, _ = convert.from_numpy(dem, ND, device="cpu")
    out = check_converged(make_pipeline(hw, eps=0.0, with_twi=True,
                                        no_data=ND)(z))
    got = convert.to_numpy(out)
    ref = jax_make_pipeline(hw, eps=0.0, with_twi=True,
                            no_data=ND)(jnp.asarray(dem))
    want = convert.to_numpy({k: np.asarray(v) for k, v in ref.items()})
    assert set(out) == set(ref)
    # each side's own dtypes, before to_numpy casts anything
    for key in ("filled", "flowdirs", "accum", "slope", "twi"):
        assert out[key].numpy().dtype == np.asarray(ref[key]).dtype, key
    assert out["flowdirs"].dtype == torch.int8
    assert out["accum"].dtype == torch.float32
    for key in ("fill_iters", "accum_rotations"):
        assert type(out[key]) is int
        assert np.asarray(ref[key]).dtype.kind == "i", key
    for key in ("fill_converged", "accum_converged"):
        assert type(out[key]) is bool
        assert np.asarray(ref[key]).dtype == np.bool_, key
    assert bool(want["fill_converged"]) and bool(want["accum_converged"])
    for key in ("filled", "flowdirs", "accum"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("slope", "twi"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    nd = dem == ND
    assert (got["accum"][nd] == 0).all()
    np.testing.assert_array_equal(got["filled"][nd], dem[nd])
    # mass: every data cell's unit weight ends at exactly one terminal
    term = (got["flowdirs"] == 0) & ~nd
    assert got["accum"][term].astype(np.float64).sum() == (~nd).sum()


def test_pipeline_default_eps_keys_and_one_shot():
    dem = _dem(64, 70, 3)
    out = terrain_pipeline(dem, no_data=ND, device="cpu")
    assert set(out) == {"filled", "flowdirs", "accum", "fill_iters",
                        "accum_rotations", "fill_converged",
                        "accum_converged"}
    with pytest.raises(ValueError):
        make_pipeline((10, 10))(torch.zeros(11, 10))


def test_check_converged_raises_on_truncated_run():
    dem = synth.depression_dem(60, 60, seed=5, dtype=np.float32)
    z = torch.from_numpy(dem)
    out = make_pipeline(z.shape, fill_iters=1)(z)
    assert not out["fill_converged"]
    with pytest.raises(RuntimeError, match="fill"):
        check_converged(out)
    out = make_pipeline(z.shape, max_rotations=1)(z)
    assert out["fill_converged"] and not out["accum_converged"]
    with pytest.raises(RuntimeError, match="accumulation"):
        check_converged(out)


@pytest.mark.parametrize("attrib", TERRAIN_ATTRIBUTES)
def test_terrain_core_matches_jax(attrib):
    dem = _dem(50, 66, 6)
    z, m = convert.from_numpy(dem, ND, device="cpu")
    got = terrain_core(z, m, 1.5, 2.0, attrib).numpy()
    want = np.asarray(jax_terrain_core(
        jnp.asarray(dem), jnp.asarray(m.numpy()),
        jnp.asarray(1.5, jnp.float32), jnp.asarray(2.0, jnp.float32),
        attrib))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    # curvatures and rise/run are plain arithmetic; the others go through
    # atan/atan2, implemented differently by the two frameworks
    rtol = 1e-5 if attrib in ("slope_degrees", "slope_radians",
                              "aspect") else 1e-6
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=1e-6)
