"""Port D∞ accumulation (plain version of the D∞ sweep kernel) ↔ the JAX
reference.

Both sides get the same two-tap field ``(code, p)``, made from a seeded DEM
with numpy and the reference's angles.  The helpers that only move bits
(pack, unpack, proportions, transpose) are bitwise.  Accumulation is held
against the reference's two TPU kernels, run in interpret mode with the
small fold thresholds of tests/test_pallas_scan.py: the Gauss–Seidel
kernel ``_dinf_kernel`` (the ``folded`` engine, port depth 1) and the
scan-GS kernel ``_accum_scan_kernel`` (port depth 1 and 16), and against
the float64 topological queue over the snapped proportions.  All reach one
fixpoint with float sums grouped differently, so they agree within rtol
2e-5 with total mass within 1e-6 (the tolerances of
tests/test_pallas_scan.py).  D8 codes through the two-tap scan with
``p = 1`` sum integers and are bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from richdem_tpu import oracle, synth
from richdem_tpu.ops import pallas_dinf, pallas_folded, pallas_scan
from richdem_tpu.ops.flowdirs import dinf_flowdirs as jax_dinf_flowdirs
from richdem_tpu_torch.ops import dinf as tdinf

torch.set_num_threads(1)

FOLD = dict(fold_min=8, fold_pad=64)
ND = -9999.0
RTOL, MASS = 2e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _interpret_mode():
    """Interpret mode and strip cap 16 for the whole module, so each
    Pallas engine compiles once for all its tests."""
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
        pallas_dinf._dinf_gs_impl.clear_cache()
        pallas_scan._dinf_scan_impl.clear_cache()


@functools.lru_cache(maxsize=None)
def _case(nodata):
    """(code, p, weights, mask) of an ε-filled depression DEM, as numpy;
    with nodata holes and float weights, or all data and unit weights."""
    dem = synth.depression_dem(56, 60, seed=4, dtype=np.float32)
    if nodata:
        dem = synth.with_nodata_holes(dem, no_data=ND, seed=2)
    mask = dem == ND
    filled = oracle.priority_flood_epsilon(
        dem, no_data=ND if nodata else None, eps=1e-3, dtype=np.float64)
    ang = jax_dinf_flowdirs(jnp.asarray(np.asarray(filled, np.float32)),
                            no_data=ND if nodata else None)
    code, p = pallas_dinf.dinf_two_tap(ang)
    weights = (np.random.default_rng(7).uniform(0.5, 2.0, dem.shape)
               .astype(np.float32) if nodata
               else np.ones(dem.shape, np.float32))
    return np.array(code), np.array(p), weights, mask


def _port(case, depth, **kw):
    code, p, weights, mask = case
    acc, rot, done = tdinf.dinf_accumulation(
        torch.from_numpy(code), torch.from_numpy(p),
        torch.from_numpy(weights), torch.from_numpy(mask), depth=depth,
        return_info=True, **kw)
    assert done and rot >= 1
    return acc.numpy()


def _oracle(case):
    code, p, weights, mask = case
    cq, pq = pallas_dinf.unpack_two_tap(pallas_dinf.pack_two_tap(code, p))
    props = np.asarray(pallas_dinf.two_tap_props(cq, pq), np.float64)
    want = oracle.flow_accumulation_from_props(
        props, weights=np.where(mask, 0.0, weights))
    want[mask] = 0.0
    return want


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert abs(got.sum() - want.sum()) / want.sum() < MASS


def test_two_tap_helpers_bitwise():
    code, p, _, _ = _case(True)
    v = tdinf.pack_two_tap(torch.from_numpy(code), torch.from_numpy(p))
    jv = pallas_dinf.pack_two_tap(jnp.asarray(code), jnp.asarray(p))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    c, q = tdinf.unpack_two_tap(v)
    jc, jq = pallas_dinf.unpack_two_tap(jv)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        tdinf.two_tap_props(c, q).numpy(),
        np.asarray(pallas_dinf.two_tap_props(jc, jq)))
    ct, qt = tdinf.transpose_two_tap(c, q)
    jct, jqt = pallas_dinf._transpose_two_tap(jc, jq)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(jct))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(jqt))
    # the transposed field packs exactly: p' = 1 - p is on the grid too
    np.testing.assert_array_equal(
        tdinf.unpack_two_tap(tdinf.pack_two_tap(ct, qt))[1].numpy(),
        qt.numpy())


def test_decoded_taps_are_the_proportions():
    """The plain sweep's taps, decoded as the kernel decodes a row, are the
    two-tap proportions plane by plane."""
    code, p, _, _ = _case(True)
    c, q = tdinf.unpack_two_tap(tdinf.pack_two_tap(torch.from_numpy(code),
                                                   torch.from_numpy(p)))
    v = tdinf.pack_two_tap(c, q)
    np.testing.assert_array_equal(
        tdinf.dinf_planes(v).numpy(),
        tdinf.two_tap_props(c, q).permute(2, 0, 1).numpy())


@pytest.mark.parametrize("nodata", [True, False])
def test_depth1_vs_gs_kernel(nodata, monkeypatch):
    """Port depth 1 ↔ ``pallas_dinf._dinf_kernel`` (the folded engine)."""
    monkeypatch.setenv("RICHDEM_TPU_ACCUM_ENGINE", "folded")
    case = _case(nodata)
    code, p, weights, mask = case
    want, _, done = pallas_dinf.dinf_accumulation_gs(
        code, p, weights=weights, no_data_mask=mask, return_info=True,
        **FOLD)
    assert bool(done)
    _close(_port(case, 1), want)


@functools.lru_cache(maxsize=None)
def _scan_reference():
    code, p, weights, mask = _case(True)
    want, _, done = pallas_scan.dinf_accumulation_scan(
        code, p, weights=weights, no_data_mask=mask, return_info=True,
        **FOLD)
    assert bool(done)
    return np.asarray(want)


@pytest.mark.parametrize("depth", [1, 16])
def test_vs_scan_kernel(depth):
    """Port depth 1 and 16 ↔ ``pallas_scan._accum_scan_kernel`` with D∞
    taps (the reference's default D∞ engine)."""
    _close(_port(_case(True), depth), _scan_reference())


@pytest.mark.parametrize("depth", [1, 2, 16, 0])
@pytest.mark.parametrize("nodata", [True, False])
def test_vs_oracle(depth, nodata):
    case = _case(nodata)
    got = _port(case, depth)
    _close(got, _oracle(case))
    if nodata:
        assert (got[case[3]] == 0).all()


def _d8_codes(hw, seed):
    dem = synth.depression_dem(*hw, seed=seed, dtype=np.float32)
    filled = oracle.priority_flood_epsilon(dem.astype(np.float64), eps=1e-3)
    return np.asarray(oracle.d8_flowdirs(filled), np.int8)


@pytest.mark.parametrize("depth", [0, 1])
def test_d8_through_the_two_tap_scan_is_exact(depth):
    """D8 codes are the two-tap field with ``p = 1``: unit weights sum
    integers, so the result is the topological queue's, bitwise."""
    fd = _d8_codes((50, 70), 5)
    code = torch.from_numpy(fd.astype(np.int32))
    acc, rot, done = tdinf.dinf_accumulation(code, torch.ones(fd.shape),
                                             depth=depth, return_info=True)
    assert done
    np.testing.assert_array_equal(acc.numpy(), oracle.d8_accumulation(fd))


def _serpentine(h, w):
    fd = np.zeros((h, w), np.int8)
    for r in range(h):
        fd[r, :] = 5 if r % 2 == 0 else 1
        fd[r, -1 if r % 2 == 0 else 0] = 7
    fd[h - 1, 0 if (h - 1) % 2 else w - 1] = 0
    return fd


def test_serpentine_converges_in_three_rotations_at_depth0():
    """One path through every cell: the in-row scans resolve each run and
    the row carry each bend, so a rotation resolves the whole path (the
    claim of tests/test_pallas_scan.py:53-74)."""
    fd = _serpentine(64, 72)
    code = torch.from_numpy(fd.astype(np.int32))
    acc, rot, done = tdinf.dinf_accumulation(code, torch.ones(fd.shape),
                                             depth=0, return_info=True)
    assert done and rot <= 3
    np.testing.assert_array_equal(acc.numpy(), oracle.d8_accumulation(fd))
    assert float(acc.max()) == fd.size


@pytest.mark.parametrize("depth", [1, 16, 0])
def test_narrow_tiles_reach_the_same_fixpoint(depth):
    """16-column tiles: across seams the row before is read at its new
    values, windows up to FLOW_HALO columns run on across them and wider
    ones (depth 0) close at the tile edge, as in the kernel; the fixpoint
    is the same."""
    code, p, weights, mask = _case(True)
    sweep = functools.partial(_tiled_sweep, tile=16)
    acc, _, done = tdinf.dinf_accumulation_info(
        torch.from_numpy(code), torch.from_numpy(p),
        torch.from_numpy(np.where(mask, 0.0, weights).astype(np.float32)),
        depth=depth, sweep=sweep)
    assert done
    got = np.where(mask, 0.0, acc.numpy())
    _close(got, _port(_case(True), depth))


def _tiled_sweep(acc, w, v, reverse, depth, tile):
    return tdinf.dinf_sweep_plain(acc, w, v, reverse, depth, tile=tile)


def _packed(nodata):
    code, p, weights, mask = _case(nodata)
    cq, pq = tdinf.unpack_two_tap(tdinf.pack_two_tap(
        torch.from_numpy(code), torch.from_numpy(p)))
    v = tdinf.pack_two_tap(cq, pq).contiguous()
    v_t = tdinf.pack_two_tap(*tdinf.transpose_two_tap(cq, pq)).contiguous()
    w = torch.from_numpy(np.where(mask, 0.0, weights).astype(np.float32))
    return v, v_t, w


@pytest.mark.parametrize("depth", [1, 8, 16])
def test_seam_exact_sweeps_match_whole_rows(depth):
    """With 8- and 16-column tiles one D∞ sweep equals the sweep over whole
    rows, bitwise, down and up, and transposed (nodata holes, float
    weights)."""
    v, v_t, w = _packed(True)
    acc = torch.from_numpy(np.random.default_rng(depth).uniform(
        1.0, 50.0, tuple(w.shape)).astype(np.float32))
    for a, wt, f in ((acc, w, v),
                     (acc.t().contiguous(), w.t().contiguous(), v_t)):
        for reverse in (False, True):
            whole = _tiled_sweep(a, wt, f, reverse, depth, a.shape[1])
            for tile in (8, 16):
                assert torch.equal(
                    _tiled_sweep(a, wt, f, reverse, depth, tile), whole)


@pytest.mark.parametrize("depth", [1, 8])
def test_narrow_tiles_take_the_one_tile_rotations(depth):
    """The D∞ fixpoint with 8-column tiles takes the rotations of one tile
    a row and has its values."""
    code, p, weights, mask = _case(True)
    w = torch.from_numpy(np.where(mask, 0.0, weights).astype(np.float32))
    runs = [tdinf.dinf_accumulation_info(
        torch.from_numpy(code), torch.from_numpy(p), w, depth=depth,
        sweep=functools.partial(_tiled_sweep, tile=tile))
        for tile in (8, code.shape[1])]
    (acc8, rot8, done8), (acc1, rot1, done1) = runs
    assert done8 and done1 and rot8 == rot1
    assert torch.equal(acc8, acc1)


def test_rotation_cap_raises():
    fd = _serpentine(12, 10)
    code = torch.from_numpy(fd.astype(np.int32))
    _, rot, done = tdinf.dinf_accumulation_info(
        code, torch.ones(fd.shape), torch.ones(fd.shape), max_rotations=1)
    assert rot == 1 and not done
    with pytest.raises(RuntimeError, match="did not converge"):
        tdinf.dinf_accumulation(code, torch.ones(fd.shape), max_rotations=1)


def test_arrays_go_to_the_device_asked_for():
    code, p, weights, mask = _case(True)
    got = tdinf.dinf_accumulation(code, p, weights, mask, device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), _port(_case(True), 1))
