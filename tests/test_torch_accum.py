"""Port D8 accumulation (plain version of the accumulation-sweep kernel) ↔
the JAX reference.

Unit weights make every partial sum a small integer, exact in float32, so
the port is bitwise equal to ``ops.accum._d8_gs_impl`` (XLA) and to the
folded Pallas kernel (interpret mode, small fold thresholds as in
tests/test_pallas_folded.py).  Float weights are summed in another order
once tile seams or orientation differ, so they are held to rtol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from richdem_tpu import oracle, synth
from richdem_tpu.ops import pallas_folded
from richdem_tpu.ops.accum import _d8_gs_impl
from richdem_tpu_torch import convert
from richdem_tpu_torch.ops import accum as tacc

torch.set_num_threads(1)

FOLD = dict(fold_min=8, fold_pad=64)


def _flowdirs(h, w, seed):
    dem = synth.perlin_dem(h, w, seed=seed, dtype=np.float64)
    filled = oracle.priority_flood_epsilon(dem, eps=1e-3)
    return np.asarray(oracle.d8_flowdirs(filled), np.int8)


def test_perm_transpose_matches_reference():
    from richdem_tpu.ops.accum import _PERM_TRANSPOSE
    want = [_PERM_TRANSPOSE[d] for d in range(9)]
    assert tacc.PERM_TRANSPOSE.tolist() == want


@pytest.mark.parametrize("hw", [(64, 72), (90, 41)])
def test_accum_unit_weights_bitwise_vs_xla(hw):
    fd = _flowdirs(*hw, seed=4)
    w = np.ones(hw, np.float32)
    got, rot, done = tacc.d8_accumulation_info(torch.from_numpy(fd),
                                               torch.from_numpy(w))
    want, _, wdone = _d8_gs_impl(jnp.asarray(fd), jnp.asarray(w),
                                 max_rotations=64)
    assert done and bool(wdone) and rot >= 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), oracle.d8_accumulation(fd))


def test_accum_unit_weights_bitwise_vs_pallas_folded():
    fd = _flowdirs(64, 88, seed=6)
    got = tacc.d8_accumulation(torch.from_numpy(fd))
    if jax.default_backend() != "tpu":
        with pltpu.force_tpu_interpret_mode():
            want = pallas_folded.d8_accumulation_folded(jnp.asarray(fd),
                                                        **FOLD)
    else:
        want = pallas_folded.d8_accumulation_folded(jnp.asarray(fd), **FOLD)
    pallas_folded._accum_folded_impl.clear_cache()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_accum_float_weights_and_nodata():
    nd = -9999.0
    dem = synth.with_nodata_holes(
        synth.depression_dem(70, 66, seed=6, dtype=np.float32), no_data=nd)
    filled = oracle.priority_flood_epsilon(dem, no_data=nd, eps=1e-3,
                                           dtype=np.float64)
    fd = np.asarray(oracle.d8_flowdirs(filled, no_data=nd), np.int8)
    w = np.random.default_rng(3).uniform(0.1, 2.0, fd.shape).astype(
        np.float32)
    _, m = convert.from_numpy(dem, nd, device="cpu")
    got = tacc.d8_accumulation(torch.from_numpy(fd), torch.from_numpy(w),
                               no_data_mask=m)
    wj = np.where(m.numpy(), 0.0, w).astype(np.float32)
    want, _, wdone = _d8_gs_impl(jnp.asarray(fd), jnp.asarray(wj),
                                 max_rotations=64)
    assert bool(wdone)
    want = np.where(m.numpy(), 0.0, np.asarray(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert (got[m] == 0).all()


def test_accum_tile_seams_reach_the_same_fixpoint():
    """Narrow column tiles (stale seam reads, as in the kernel): same
    unit-weight accumulation, bitwise."""
    fd = _flowdirs(60, 75, seed=8)
    w = torch.ones(fd.shape)
    sweep = functools.partial(tacc.accum_sweep_plain, tile=16)
    got, _, done = tacc.d8_accumulation_info(torch.from_numpy(fd), w,
                                             sweep=sweep)
    assert done
    np.testing.assert_array_equal(got.numpy(), oracle.d8_accumulation(fd))


def test_accum_raises_on_small_rotation_cap():
    # a serpentine path: each row runs the other way, so every rotation
    # resolves only a few of its bends
    h, w = 12, 10
    fd = np.zeros((h, w), np.int8)
    for r in range(h):
        east = r % 2 == 0
        fd[r, :] = 5 if east else 1
        fd[r, w - 1 if east else 0] = 7
    fd[h - 1, :] = 0
    fdt = torch.from_numpy(fd)
    _, rot, done = tacc.d8_accumulation_info(fdt, torch.ones(h, w),
                                             max_rotations=1)
    assert rot == 1 and not done
    with pytest.raises(RuntimeError):
        tacc.d8_accumulation(fdt, max_rotations=1)
    np.testing.assert_array_equal(tacc.d8_accumulation(fdt).numpy(),
                                  oracle.d8_accumulation(fd))
