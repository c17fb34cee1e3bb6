"""Port multi-flow accumulation (plain version of the multi-flow sweep
kernel) ↔ the JAX reference, for Quinn, Freeman and Holmgren(2).

Both sides get the same ``(H, W, 8)`` proportions, the reference's
``flow_proportions`` of a seeded ε-filled DEM.  The port is held against
the reference's three TPU kernels, run in interpret mode: the folded
Gauss–Seidel kernel ``_mfd_kernel`` and the small-grid ``_mfd_kernel_small``
(port depth 1), and the scan-GS kernel ``_mfd_scan_kernel`` (port depth 8
and 0), and against the float64 topological queue.  All reach one fixpoint
with float sums grouped differently: rtol 2e-5, the tolerance of
tests/test_pallas_scan.py.

Interpret mode runs a multi-flow engine at about a second per rotation
whatever the grid, so the DEM is 24×32 and every pad is 32: the folded and
scan engines take tests/test_pallas_scan.py's fold threshold with
``fold_pad`` 32 (64 there), and the small-grid kernel, which pads to
``pallas_sweeps._PAD`` (256, a TPU tile) through ``_pad_to``'s defaults,
gets both lowered to 32 (a minute and a half per call at 256).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from richdem_tpu import oracle, synth
from richdem_tpu.ops import pallas_folded, pallas_mfd, pallas_scan
from richdem_tpu.ops import pallas_sweeps
from richdem_tpu.ops.flowdirs import flow_proportions as jax_proportions
from richdem_tpu_torch import convert, topology
from richdem_tpu_torch._build import FLOW_HALO, FLOW_TILE
from richdem_tpu_torch.ops import accum as tacc
from richdem_tpu_torch.ops import mfd as tmfd

torch.set_num_threads(1)

FOLD = dict(fold_min=8, fold_pad=32)
ND = -9999.0
RTOL = 2e-5
METRICS = {"Quinn": {}, "Freeman": {}, "Holmgren": {"exponent": 2.0}}


@pytest.fixture(scope="module", autouse=True)
def _interpret_mode():
    """Interpret mode, strip cap 16 and a 32-cell small-grid pad for the
    whole module, so each Pallas engine compiles once for all metrics."""
    old = (pallas_folded._STRIP_CAP, pallas_sweeps._PAD,
           pallas_sweeps._pad_to.__defaults__)
    pallas_folded._STRIP_CAP = 16
    pallas_sweeps._PAD = 32
    pallas_sweeps._pad_to.__defaults__ = (32, 32)
    try:
        if jax.default_backend() != "tpu":
            with pltpu.force_tpu_interpret_mode():
                yield
        else:
            yield
    finally:
        (pallas_folded._STRIP_CAP, pallas_sweeps._PAD,
         pallas_sweeps._pad_to.__defaults__) = old
        pallas_mfd._mfd_gs_impl.clear_cache()
        pallas_mfd._mfd_gs_impl_small.clear_cache()
        pallas_scan._mfd_scan_impl.clear_cache()


@functools.lru_cache(maxsize=None)
def _case(method, nodata=False):
    """(props, weights, mask) as numpy: the reference's proportions of an
    ε-filled depression DEM; with nodata holes and float weights, or all
    data and unit weights."""
    dem = synth.depression_dem(24, 32, seed=7, dtype=np.float32)
    if nodata:
        dem = synth.with_nodata_holes(dem, no_data=ND, seed=3, n_holes=3)
    mask = dem == ND
    filled = oracle.priority_flood_epsilon(
        dem, no_data=ND if nodata else None, eps=1e-3, dtype=np.float64)
    props = jax_proportions(np.asarray(filled, np.float32), method=method,
                            no_data=ND if nodata else None,
                            **METRICS[method])
    weights = (np.random.default_rng(5).uniform(0.5, 2.0, dem.shape)
               .astype(np.float32) if nodata
               else np.ones(dem.shape, np.float32))
    return np.array(props, np.float32), weights, mask


def _port(case, depth, **kw):
    props, weights, mask = case
    acc, rot, done = tmfd.mfd_accumulation(
        convert.props_from_numpy(props, "cpu"), torch.from_numpy(weights),
        torch.from_numpy(mask), depth=depth, return_info=True, **kw)
    assert done and rot >= 1
    return acc.numpy()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL)


@pytest.mark.parametrize("method", sorted(METRICS))
def test_depth1_vs_folded_gs_kernel(method):
    """Port depth 1 ↔ ``pallas_mfd._mfd_kernel``."""
    props = _case(method)[0]
    want, _, done = pallas_mfd.mfd_accumulation_gs(
        props, engine="folded", return_info=True, **FOLD)
    assert bool(done)
    _close(_port(_case(method), 1), want)


@pytest.mark.parametrize("method", sorted(METRICS))
def test_depth1_vs_small_grid_kernel(method):
    """Port depth 1 ↔ ``pallas_mfd._mfd_kernel_small`` (no fold)."""
    props = _case(method)[0]
    want, _, done = pallas_mfd.mfd_accumulation_gs(props, return_info=True)
    assert bool(done)
    _close(_port(_case(method), 1), want)


@functools.lru_cache(maxsize=None)
def _scan_reference(method):
    want, _, done = pallas_scan.mfd_accumulation_scan(
        _case(method)[0], return_info=True, **FOLD)
    assert bool(done)
    return np.asarray(want)


@pytest.mark.parametrize("depth", [8, 0])
@pytest.mark.parametrize("method", sorted(METRICS))
def test_vs_scan_kernel(method, depth):
    """Port depth 8 and 0 ↔ ``pallas_scan._mfd_scan_kernel`` (the
    reference's default multi-flow engine, at its depth 8)."""
    _close(_port(_case(method), depth), _scan_reference(method))


@pytest.mark.parametrize("depth", [1, 8, 0])
@pytest.mark.parametrize("method", sorted(METRICS))
def test_vs_oracle(method, depth):
    props = _case(method)[0]
    want = oracle.flow_accumulation_from_props(props.astype(np.float64))
    _close(_port(_case(method), depth), want)


@pytest.mark.parametrize("depth", [1, 8])
def test_weights_and_nodata_vs_oracle(depth):
    case = _case("Quinn", nodata=True)
    props, weights, mask = case
    assert mask.any()
    want = oracle.flow_accumulation_from_props(
        props.astype(np.float64), weights=np.where(mask, 0.0, weights))
    want[mask] = 0.0
    got = _port(case, depth)
    _close(got, want)
    assert (got[mask] == 0).all()


def test_transposed_planes_match_the_reference():
    props = _case("Quinn")[0]
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(props, -1,
                                                               0)))
    want = pallas_mfd._transpose_props_small(np.moveaxis(props, -1, 0))
    np.testing.assert_array_equal(tmfd.transpose_planes(planes).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("depth", [1, 8, 0])
def test_narrow_tiles_reach_the_same_fixpoint(depth):
    props = _case("Freeman")[0]
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(props, -1,
                                                               0)))
    sweep = functools.partial(_tiled_sweep, tile=8)
    acc, _, done = tmfd.mfd_accumulation_info(
        planes, torch.ones(props.shape[:2]), depth=depth, sweep=sweep)
    assert done
    _close(acc.numpy(), _port(_case("Freeman"), depth))


def _tiled_sweep(acc, w, planes, reverse, depth, tile):
    return tmfd.mfd_sweep_plain(acc, w, planes, reverse, depth, tile=tile)


def _planes_weights(method, nodata):
    props, weights, mask = _case(method, nodata)
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(props, -1,
                                                               0)))
    return planes, torch.from_numpy(np.where(mask, 0.0, weights)
                                    .astype(np.float32))


@pytest.mark.parametrize("depth", [1, 8, 16])
def test_seam_exact_sweeps_match_whole_rows(depth):
    """With 8- and 16-column tiles one sweep equals the sweep over whole
    rows, bitwise, down and up, and transposed (nodata holes, float
    weights): the row before is read at its new values across tile edges
    and windows up to FLOW_HALO columns run on across them."""
    planes, w = _planes_weights("Quinn", True)
    acc = torch.from_numpy(np.random.default_rng(depth).uniform(
        1.0, 50.0, tuple(w.shape)).astype(np.float32))
    cases = ((acc, w, planes),
             (acc.t().contiguous(), w.t().contiguous(),
              tmfd.transpose_planes(planes)))
    for a, wt, p in cases:
        for reverse in (False, True):
            whole = _tiled_sweep(a, wt, p, reverse, depth, a.shape[1])
            for tile in (8, 16):
                assert torch.equal(
                    _tiled_sweep(a, wt, p, reverse, depth, tile), whole)


@pytest.mark.parametrize("depth", [1, 8])
def test_narrow_tiles_take_the_one_tile_rotations(depth):
    """The fixpoint with 8-column tiles takes the rotations of one tile a
    row and has its values (a stale seam rule took more)."""
    planes, w = _planes_weights("Quinn", False)
    runs = [tmfd.mfd_accumulation_info(
        planes, w, depth=depth,
        sweep=functools.partial(_tiled_sweep, tile=tile))
        for tile in (8, planes.shape[2])]
    (acc8, rot8, done8), (acc1, rot1, done1) = runs
    assert done8 and done1 and rot8 == rot1
    assert torch.equal(acc8, acc1)


def test_scan_window():
    """Depth 0 and windows past FLOW_HALO are capped at the flow sweep's
    tile; windows up to FLOW_HALO cross tile edges and are not."""
    assert [tmfd.scan_window(d) for d in (1, 2, 3, 8, 9, 32, 0)] == [
        1, 2, 4, 8, 16, 32, FLOW_TILE]
    assert tmfd.scan_window(5000) == FLOW_TILE
    assert tmfd.scan_window(0, tile=16) == 16
    assert tmfd.scan_window(16, tile=8) == 16
    assert tmfd.scan_window(FLOW_HALO + 1, tile=8) == 8
    with pytest.raises(ValueError):
        tmfd.scan_window(-1)


def test_entry_point_takes_arrays_and_caps_rotations():
    props, _, _ = _case("Quinn")
    acc, rot, done = tacc.flow_accumulation_from_props(
        props, return_info=True, device="cpu")
    assert done and acc.device.type == "cpu"
    _close(acc.numpy(), _port(_case("Quinn"), tmfd.MFD_DEPTH))
    with pytest.raises(RuntimeError, match="did not converge"):
        tacc.flow_accumulation_from_props(props, max_rotations=1,
                                          device="cpu")


# -- the topological pass (plain version of csrc/flow_topo.cuh) -----------


def _cycle_field():
    """Quinn planes of the seed case with a cycle of four cells, (2, 2) E →
    (2, 3) S → (3, 3) W → (3, 2) N → (2, 2), each sending half of its
    accumulation on round it: the sweeps still converge."""
    planes, w = _planes_weights("Quinn", False)
    planes = planes.clone()
    planes[:, 2:4, 2:4] *= 0.5
    for d, (r, c) in ((5, (2, 2)), (7, (2, 3)), (1, (3, 3)), (3, (3, 2))):
        planes[d - 1, r, c] += 0.5
    return planes, w


@pytest.mark.parametrize("nodata", [False, True])
@pytest.mark.parametrize("method", sorted(METRICS))
def test_topo_plain_vs_float64_queue(method, nodata):
    """The topological pass in float32 ↔ the float64 topological queue,
    unit weights on full data, float weights with nodata holes."""
    props, weights, mask = _case(method, nodata)
    planes, w = _planes_weights(method, nodata)
    acc, left = tmfd.mfd_topo_plain(planes, w)
    assert left == 0
    want = oracle.flow_accumulation_from_props(
        props.astype(np.float64), weights=np.where(mask, 0.0, weights))
    _close(acc.numpy(), want)


@pytest.mark.parametrize("method", sorted(METRICS))
def test_topo_plain_vs_sweep_fixpoint(method):
    """The topological pass reaches the sweeps' fixpoint, its float sums
    grouped otherwise."""
    planes, w = _planes_weights(method, False)
    acc, left = tmfd.mfd_topo_plain(planes, w)
    assert left == 0
    _close(acc.numpy(), _port(_case(method), tmfd.MFD_DEPTH))


def _downstream(planes, seeds):
    """The cells reachable from ``seeds`` over nonzero shares, seeds
    included."""
    _, h, w = planes.shape
    seen, todo = set(seeds), list(seeds)
    while todo:
        r, c = todo.pop()
        for d in range(1, 9):
            rr, cc = r + int(topology.DY[d]), c + int(topology.DX[d])
            if (0 <= rr < h and 0 <= cc < w and planes[d - 1, r, c] != 0
                    and (rr, cc) not in seen):
                seen.add((rr, cc))
                todo.append((rr, cc))
    return seen


def test_topo_plain_leaves_a_cycle_and_nan_unsolved():
    """The pass leaves the cells of a cycle and every cell downstream of
    them; it counts a cell it solves to NaN as left too (the sweeps never
    converge there)."""
    planes, w = _cycle_field()
    _, left = tmfd.mfd_topo_plain(planes, w)
    assert left == len(_downstream(planes, [(2, 2)])) > 4
    planes, w = _planes_weights("Quinn", False)
    w = w.clone()
    w[5, 6] = float("nan")
    acc, left = tmfd.mfd_topo_plain(planes, w)
    assert left == int(torch.isnan(acc).sum()) == len(
        _downstream(planes, [(5, 6)]))


@pytest.mark.parametrize("cyclic", [False, True])
def test_entry_point_falls_back_to_the_sweeps_on_a_cycle(monkeypatch,
                                                         cyclic):
    """With the topological pass first (as on a card), an acyclic field
    takes no rotation and is the pass's result bitwise; a field with a
    cycle is left to the sweeps from A = w, whose result and rotations it
    returns."""
    planes, w = _cycle_field() if cyclic else _planes_weights("Quinn", True)
    props = planes.permute(1, 2, 0)
    sweeps = tmfd.mfd_accumulation(props, w, return_info=True)
    monkeypatch.setattr(tmfd, "_topo_first", lambda planes: True)
    acc, rot, done = tmfd.mfd_accumulation(props, w, return_info=True)
    assert done
    if cyclic:
        assert rot == sweeps[1] >= 1
        assert torch.equal(acc, sweeps[0])
    else:
        assert rot == 0
        assert torch.equal(acc, tmfd.mfd_topo_plain(planes, w)[0])
        _close(acc.numpy(), sweeps[0].numpy())
