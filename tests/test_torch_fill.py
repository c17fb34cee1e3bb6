"""Port fill (plain version of the fill-sweep kernel) ↔ the JAX reference.

Same DEM (numpy, seeded, float32) through both sides.  The fill is the
greatest fixpoint below the start, reached by monotone sweeps with the same
per-edge ``fl(w + ε)`` step, so the port is bitwise equal to the Pallas
sweeps at any ε (run in interpret mode, with the small fold thresholds of
tests/test_pallas_folded.py) and to the XLA engine at ε = 0; the XLA
engine's associative scan regroups ε sums, so ε > 0 is allclose there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from richdem_tpu import synth
from richdem_tpu.ops import pallas_folded, pallas_sweeps
from richdem_tpu.ops.fill import auto_epsilon as jax_auto_epsilon
from richdem_tpu.ops.fill import fill_depressions_info as jax_fill_info
from richdem_tpu_torch import convert
from richdem_tpu_torch.ops import fill as tfill
from richdem_tpu_torch.ops import sweeps as tsweeps

torch.set_num_threads(1)

ND = -9999.0
#: fold the reference's kernels at test sizes (as tests/test_pallas_folded.py)
FOLD = dict(fold_min=8, fold_pad=64)


@pytest.fixture(autouse=True)
def _interpret_mode():
    """Pallas interpret mode off-TPU + small strips (the fixture of
    tests/test_pallas_folded.py, cache clearing included)."""
    old_cap = pallas_folded._STRIP_CAP
    pallas_folded._STRIP_CAP = 16
    try:
        if jax.default_backend() != "tpu":
            with pltpu.force_tpu_interpret_mode():
                yield
        else:
            yield
    finally:
        pallas_folded._STRIP_CAP = old_cap
        pallas_folded._fill_folded_impl.clear_cache()
        pallas_sweeps.fill_fixpoint_pallas.clear_cache()


def _dem(h, w, seed, holes=True):
    dem = synth.depression_dem(h, w, seed=seed, dtype=np.float32)
    if holes:
        dem = synth.with_nodata_holes(dem, no_data=ND, seed=seed)
    return dem


def _port(dem, eps, **kw):
    z, m = convert.from_numpy(dem, ND, device="cpu")
    filled, iters, done = tfill.fill_depressions_info(z, m, eps=eps, **kw)
    return filled.numpy(), iters, done


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_fill_bitwise_vs_pallas_sweeps(eps):
    dem = _dem(40, 57, seed=3)
    got, _, done = _port(dem, eps)
    want, _, wdone = pallas_sweeps.fill_fixpoint_pallas(
        jnp.asarray(dem), jnp.asarray(dem == ND), eps=eps)
    assert done and bool(wdone)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_fill_bitwise_vs_pallas_folded(eps):
    dem = _dem(72, 50, seed=5)
    got, _, done = _port(dem, eps)
    want, _, wdone = pallas_folded.fill_fixpoint_folded(
        jnp.asarray(dem), jnp.asarray(dem == ND), eps=eps, **FOLD)
    assert done and bool(wdone)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_fill_multigrid_bitwise_vs_pallas_folded():
    """The multigrid warm start (block-max pool, coarse ε·2·8² fill,
    upsample) reaches the same fixpoint, bitwise at ε = 0.  Production
    uses it from edge 4096; here it is passed in as ``w0``."""
    dem = synth.depression_dem(96, 136, seed=11, dtype=np.float32, n_pits=9)
    warm = tfill._coarse_warm_start(torch.from_numpy(dem), 0.0)
    got, _, done = _port(dem, 0.0, w0=warm)
    want, _, wdone = pallas_folded.fill_fixpoint_folded(
        jnp.asarray(dem), eps=0.0, multiscale=True, multiscale_min=64,
        **FOLD)
    assert done and bool(wdone)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert bool((warm >= torch.from_numpy(got)).all())  # an upper bound


@pytest.mark.parametrize("hw", [(64, 80), (45, 120)])
def test_fill_vs_xla_engine(hw):
    dem = _dem(*hw, seed=7)
    z, m = convert.from_numpy(dem, ND, device="cpu")
    for eps in (0.0, 1e-3):
        got, _, done = tfill.fill_depressions_info(z, m, eps=eps)
        want, _, wdone = jax_fill_info(jnp.asarray(dem),
                                       jnp.asarray(m.numpy()), eps=eps)
        assert done and bool(wdone)
        if eps == 0.0:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:  # the associative scan regroups ε sums
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-4)


def test_fill_tile_seams_reach_the_same_fixpoint():
    """Narrow column tiles (stale seam reads, as in the kernel) change the
    path to the fixpoint, not the fixpoint."""
    dem = _dem(50, 70, seed=9)
    z, m = convert.from_numpy(dem, ND, device="cpu")
    neg = torch.tensor(-tsweeps.BIG)
    floor = torch.where(m, neg, z)
    w0 = torch.where(m, neg, torch.full_like(z, tsweeps.BIG))
    sweep = functools.partial(tsweeps.fill_sweep_plain, tile=16)
    got, _, done = tsweeps.fill_fixpoint_core(w0, floor, 0.0, 256, sweep)
    want, _, wdone = jax_fill_info(jnp.asarray(dem), jnp.asarray(m.numpy()))
    assert done and bool(wdone)
    np.testing.assert_array_equal(torch.where(m, z, got).numpy(),
                                  np.asarray(want))


def test_fill_nodata_w0_and_iteration_cap():
    dem = _dem(48, 48, seed=13)
    z, m = convert.from_numpy(dem, ND, device="cpu")
    filled, iters, done = tfill.fill_depressions_info(z, m)
    assert done and iters >= 1
    np.testing.assert_array_equal(filled[m].numpy(), dem[m.numpy()])
    # warm start at the fixpoint: nothing moves, one rotation confirms it
    again, iters2, done2 = tfill.fill_depressions_info(z, m, w0=filled)
    assert done2 and iters2 == 1
    np.testing.assert_array_equal(again.numpy(), filled.numpy())
    # a cap that is too small is reported, never hidden
    _, iters1, done1 = tfill.fill_depressions_info(z, m, max_iters=1)
    assert iters1 == 1 and not done1
    with pytest.raises(RuntimeError):
        tfill.fill_depressions(z, no_data=ND, max_iters=1)


@pytest.mark.parametrize("hw,no_data", [((40, 57), ND), ((33, 20), None)])
def test_auto_epsilon_is_the_reference_float(hw, no_data):
    """Device and host paths of both sides give one float (the nodata
    sentinel counts towards the scale, as in the reference)."""
    dem = _dem(*hw, seed=2, holes=no_data is not None)
    want = jax_auto_epsilon(jnp.asarray(dem))
    assert want == jax_auto_epsilon(dem)
    got = tfill.auto_epsilon(torch.from_numpy(dem))
    assert type(got) is float and got == want
    assert tfill.auto_epsilon(dem) == want


def test_fill_epsilon_bitwise_vs_pallas():
    dem = _dem(40, 57, seed=3)
    eps = jax_auto_epsilon(dem)
    got = tfill.fill_epsilon(dem, no_data=ND, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    want, _, wdone = pallas_folded.fill_fixpoint_pallas(
        jnp.asarray(dem), jnp.asarray(dem == ND), eps=eps)
    assert bool(wdone)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() >= dem).all()


@pytest.mark.parametrize("hw", [(40, 57), (72, 50)])
def test_scale_diagonal_bitwise_vs_pallas(hw):
    """Diagonal edges cost f32(ε·√2): bitwise against the folded kernel
    given that ``eps_diag``, allclose against the XLA engine (whose scan
    regroups ε sums)."""
    dem = _dem(*hw, seed=5)
    eps = 1e-3
    got, _, done = _port(dem, eps, scale_diagonal=True)
    want, _, wdone = pallas_folded.fill_fixpoint_folded(
        jnp.asarray(dem), jnp.asarray(dem == ND), eps=eps,
        eps_diag=eps * float(np.sqrt(2.0)), **FOLD)
    assert done and bool(wdone)
    np.testing.assert_array_equal(got, np.asarray(want))
    xla, _, xdone = jax_fill_info(jnp.asarray(dem), jnp.asarray(dem == ND),
                                  eps=eps, scale_diagonal=True)
    assert bool(xdone)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=0, atol=1e-4)
    plain, _, _ = _port(dem, eps)
    assert not np.array_equal(got, plain)  # the diagonal cost mattered
    filled = tfill.fill_depressions(dem, no_data=ND, eps=eps,
                                    scale_diagonal=True, device="cpu")
    np.testing.assert_array_equal(filled.numpy(), got)


def _corner_spill_dem(seed):
    """A seeded 64×72 DEM lifted to about 4000 m: a walled bowl over the
    2×2 blocks of rows and columns 8..23 whose only spill is the cell
    (23, 23), the maximum of its 8×8 block, which drains diagonally to a
    lower slope.  The coarse fill sees that block at its maximum, while
    the bowl's cells inside it sit up to 7 ε above the spill."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:64, 0:72].astype(np.float64)
    dem = 40.0 - 0.125 * (x + y) + rng.uniform(0, 0.5, y.shape)
    dem[8:24, 8:24] = rng.uniform(0, 1.0, (16, 16))
    wall = np.zeros(y.shape, bool)
    wall[7, 7:25] = wall[7:25, 7] = wall[24, 7:24] = wall[7:24, 24] = True
    wall[23, 23] = True
    dem[wall] = 100.0 + rng.uniform(0, 1.0, int(wall.sum()))
    dem[23, 23] = 50.0
    return (dem + 4000.0).astype(np.float32)


@pytest.mark.parametrize("kind", ["corner_spill", "holes"])
def test_multigrid_start_bounds_the_epsilon_fill(kind, monkeypatch):
    """At ε > 0 the multigrid start is an upper bound of the float32
    fixpoint, so ``fill_epsilon`` from it is bitwise the fill from BIG.
    The corner-spill DEM puts a pit's spill at its block's maximum: the
    start without its in-block rise lies up to 7 ε below the fixpoint
    there, and so did the fill from it."""
    monkeypatch.setattr(tfill, "MULTISCALE_MIN", 64)
    eps = 1e-3
    if kind == "corner_spill":
        dem = _corner_spill_dem(seed=0)
    else:
        dem = _dem(96, 112, seed=7) + np.float32(4000.0)
        dem[dem < 0] = ND
    z, m = convert.from_numpy(dem, ND, device="cpu")
    want, _, done = tfill.fill_depressions_info(
        z, m, eps=eps, w0=torch.full_like(z, tsweeps.BIG))
    assert done
    zed = torch.where(m, -tsweeps.BIG, z)
    warm = tfill._coarse_warm_start(zed, tfill._f32(eps))
    assert bool((warm[~m] >= want[~m]).all())
    got = tfill.fill_epsilon(z, no_data=ND, eps=eps)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_multigrid_start_at_eps_zero_is_unchanged():
    """At ε = 0 the start is the plain upsampled coarse fill, as before the
    in-block rise was added: the main path's start is untouched."""
    dem = _dem(96, 112, seed=3)
    z, m = convert.from_numpy(dem, ND, device="cpu")
    zed = torch.where(m, -tsweeps.BIG, z)
    zc = torch.nn.functional.max_pool2d(zed[None, None], 8, 8)[0, 0]
    wc, _, _ = tsweeps.fill_fixpoint_core(
        torch.full_like(zc, tsweeps.BIG), zc.contiguous(), 0.0, 256,
        tfill.fill_sweep)
    up = wc.repeat_interleave(8, 0).repeat_interleave(8, 1)
    want = torch.maximum(up, zed)
    assert torch.equal(tfill._coarse_warm_start(zed, 0.0), want)
