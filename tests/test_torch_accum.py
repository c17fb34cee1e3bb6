"""Port D8 accumulation (plain version of the accumulation-sweep kernel) ↔
the JAX reference.

Unit weights make every partial sum a small integer, exact in float32, so
the port is bitwise equal to ``ops.accum._d8_gs_impl`` (XLA) and to the
folded Pallas kernel (interpret mode, small fold thresholds as in
tests/test_pallas_folded.py).  Float weights are summed in another order
once tile seams or orientation differ, so they are held to rtol 1e-6.

The plain version of the topological pass over the codes
(``d8_topo_plain``, the card's path) equals the native engine's
topological queue at unit weights, with nodata holes and codes pointing
off the grid, and the sweeps' fixpoint bitwise for integer weights and
within rtol 1e-6 for float weights; it leaves a cycle and what lies
downstream of it unsolved, and the entry point then runs the sweeps.
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
from richdem_tpu_torch import convert, native, topology
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
    got, _, done = tacc.d8_accumulation_sweeps(torch.from_numpy(fd), w,
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


# -- the topological pass over the codes ------------------------------------


def _holed_codes(h, w, seed):
    """D8 codes of an ε-filled depression DEM with nodata holes (-1), the
    first row pointing north and the last column east, off the grid."""
    nd = -9999.0
    dem = synth.with_nodata_holes(
        synth.depression_dem(h, w, seed=seed, dtype=np.float32), no_data=nd,
        n_holes=3)
    filled = oracle.priority_flood_epsilon(dem, no_data=nd, eps=1e-3,
                                           dtype=np.float64)
    fd = np.asarray(oracle.d8_flowdirs(filled, no_data=nd), np.int8)
    fd[0][fd[0] >= 0] = 3
    fd[:, -1][fd[:, -1] >= 0] = 5
    return fd


@pytest.mark.parametrize("hw", [(64, 72), (90, 41), (1, 9), (7, 1)])
def test_topo_plain_vs_native_queue(hw):
    """Unit weights on data: bitwise the native engine's topological queue,
    every cell solved, in as many levels as the longest chain of donors
    has cells."""
    fd = _holed_codes(*hw, seed=hw[1])
    assert (fd < 0).any() or min(hw) == 1
    w = torch.from_numpy(np.where(fd < 0, 0.0, 1.0).astype(np.float32))
    stats = {}
    acc, left = tacc.d8_topo_plain(torch.from_numpy(fd), w, stats)
    assert left == 0
    np.testing.assert_array_equal(acc.numpy(), native.accum_d8(fd))
    depth = np.zeros(fd.shape, np.int64)  # cells on the longest chain in
    order = np.argsort(acc.numpy(), axis=None, kind="stable")
    for r, c in zip(*np.unravel_index(order, fd.shape)):
        d = int(fd[r, c])
        rr, cc = r + int(topology.DY[d]), c + int(topology.DX[d])
        if d > 0 and 0 <= rr < hw[0] and 0 <= cc < hw[1]:
            depth[rr, cc] = max(depth[rr, cc], depth[r, c] + 1)
    assert stats["levels"] == depth.max() + 1


@pytest.mark.parametrize("kind", ["integer", "float"])
def test_topo_plain_is_the_sweeps_fixpoint(kind):
    """Integer weights: bitwise the sweeps' fixpoint (every sum exact);
    float weights: within rtol 1e-6 of it (sums grouped otherwise)."""
    fd = torch.from_numpy(_holed_codes(70, 66, seed=6))
    rng = np.random.default_rng(7)
    w = (rng.integers(0, 9, fd.shape) if kind == "integer"
         else rng.uniform(0.1, 2.0, fd.shape))
    w = torch.where(fd < 0, 0.0, torch.from_numpy(w.astype(np.float32)))
    acc, left = tacc.d8_topo_plain(fd, w)
    ref, rot, done = tacc.d8_accumulation_sweeps(fd, w)
    assert left == 0 and done and rot >= 1
    if kind == "integer":
        assert torch.equal(acc, ref)
    else:
        np.testing.assert_allclose(acc.numpy(), ref.numpy(), rtol=1e-6)


def _cycle_codes():
    """Perlin D8 codes with a four-cell cycle (2, 2) E → (2, 3) S →
    (3, 3) W → (3, 2) N → (2, 2)."""
    fd = _flowdirs(24, 30, seed=2)
    for d, (r, c) in ((5, (2, 2)), (7, (2, 3)), (1, (3, 3)), (3, (3, 2))):
        fd[r, c] = d
    return torch.from_numpy(fd)


def test_topo_plain_leaves_a_cycle_and_nan_unsolved():
    """The pass leaves the four cells of a cycle (each sends only to the
    next, so nothing lies downstream of it) and solves their donors; a
    cell it solves to NaN counts as left too."""
    fd = _cycle_codes()
    w = torch.ones(fd.shape)
    acc, left = tacc.d8_topo_plain(fd, w)
    assert left == 4
    ref = torch.from_numpy(native.accum_d8(_flowdirs(24, 30, seed=2)))
    donors = ref < ref[2:4, 2:4].min()  # upstream of the cycle or beside
    assert torch.equal(acc[donors], ref.float()[donors])
    fd = torch.from_numpy(_flowdirs(24, 30, seed=2))
    w[5, 6] = float("nan")
    acc, left = tacc.d8_topo_plain(fd, w)
    assert left == int(torch.isnan(acc).sum()) >= 1


@pytest.mark.parametrize("cyclic", [False, True])
def test_entry_point_falls_back_to_the_sweeps_on_a_cycle(monkeypatch,
                                                         cyclic):
    """With the topological pass first (as on a card), codes without a
    cycle take no rotation and are the pass's result bitwise; codes with
    one are left to the sweeps from A = w, whose result and rotations the
    entry returns, and which raise at their cap."""
    fd = (_cycle_codes() if cyclic
          else torch.from_numpy(_holed_codes(40, 52, seed=3)))
    w = torch.where(fd < 0, 0.0, 1.0)
    sweeps = tacc.d8_accumulation_sweeps(fd, w, 16)
    monkeypatch.setattr(tacc, "_topo_first", lambda fd: True)
    before = tacc.ACCUM_TOPO.launches
    acc, rot, done = tacc.d8_accumulation_info(fd, w, 16)
    assert tacc.ACCUM_TOPO.launches == before  # a CPU tensor: plain
    if cyclic:
        assert rot == sweeps[1] == 16 and not done and not sweeps[2]
        assert torch.equal(acc, sweeps[0])
        with pytest.raises(RuntimeError, match="did not converge"):
            tacc.d8_accumulation(fd, w, max_rotations=16)
    else:
        assert rot == 0 and done and sweeps[2]
        assert torch.equal(acc, tacc.d8_topo_plain(fd, w)[0])
        assert torch.equal(acc, sweeps[0])
