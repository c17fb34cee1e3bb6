"""Port flat resolution (plain version of the distance-sweep kernel) ↔ the
JAX reference, bitwise.

The three distance fields are exact small integers, so every engine reaches
the same fixpoint: the port's resolved directions and flat mask equal the
oracle's BFS, the exact-membership XLA engine ``F._resolve_impl``, and both
TPU engines of ``F._resolve_impl_pallas`` (``folded`` and ``scan``, in
interpret mode as tests/test_ops_flats.py runs them).  The port's
``in_flat`` is the local membership superset of the TPU path: equal to the
Pallas engines', a superset of the exact one.  Inputs are float32 DEMs made
with numpy from a seed; ε = 0 fills are the oracle's, exact in float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from richdem_tpu import oracle, synth
from richdem_tpu.ops import flats as F
from richdem_tpu.ops import pallas_folded, pallas_sweeps
from richdem_tpu_torch import convert, topology
from richdem_tpu_torch.ops import flats as tflats
from richdem_tpu_torch.ops import sweeps as tsweeps

torch.set_num_threads(1)

ND = -9999.0


def _filled(dem):
    """ε = 0 fill of a float32 DEM: spill elevations are DEM values, so the
    float64 oracle's result is exact in float32."""
    return oracle.priority_flood_fill(dem.astype(np.float64)).astype(
        np.float32)


DEMS = {
    "plateau32": lambda: (synth.plateau_dem(32, dtype=np.float32), None),
    "plateau40": lambda: (synth.plateau_dem(40, margin=8,
                                            dtype=np.float32), None),
    "plateau72": lambda: (synth.plateau_dem(72, dtype=np.float32), None),
    "filled_depressions": lambda: (_filled(synth.depression_dem(
        64, seed=5, dtype=np.float32)), None),
    "filled_perlin": lambda: (_filled(synth.perlin_dem(
        48, 56, seed=9, dtype=np.float32)), None),
    "plateau_nodata": lambda: (synth.with_nodata_holes(
        synth.plateau_dem(36, dtype=np.float32), no_data=ND, seed=2,
        n_holes=2, max_radius=3), ND),
}


def _case(name):
    dem, nd = DEMS[name]()
    fd = oracle.d8_flowdirs(dem.astype(np.float64), no_data=nd)
    return dem, fd, nd


def _port(dem, fd, nd):
    z, m = convert.from_numpy(dem, nd, device="cpu")
    resolved, mask, in_flat, rotations, done = tflats.resolve_flats_info(
        z, torch.from_numpy(fd), m)
    assert done and all(r >= 1 for r in rotations)
    return resolved.numpy(), mask.numpy(), in_flat.numpy()


@pytest.fixture
def interpret():
    """Pallas interpret mode off-TPU with small strips (the set-up of
    tests/test_ops_flats.py::test_pallas_quasi_membership_matches_exact)."""
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


@pytest.mark.parametrize("name", sorted(DEMS))
def test_resolve_flats_matches_oracle_and_exact_engine(name):
    dem, fd, nd = _case(name)
    got_fd, got_mask, got_flat = _port(dem, fd, nd)
    assert got_fd.dtype == np.int8 and got_mask.dtype == np.int32
    np.testing.assert_array_equal(
        got_fd, oracle.resolve_flats(dem.astype(np.float64), fd,
                                     no_data=nd))
    nodata = jnp.asarray(dem == ND) if nd is not None else jnp.zeros(
        dem.shape, bool)
    exact_fd, exact_mask, exact_flat, info = F._resolve_impl(
        jnp.asarray(dem), jnp.asarray(fd), nodata, 256)
    assert bool(info[1])
    np.testing.assert_array_equal(got_fd, np.asarray(exact_fd))
    np.testing.assert_array_equal(got_mask, np.asarray(exact_mask))
    assert (np.asarray(exact_flat) <= got_flat).all()
    assert (got_mask > 0).any() or name == "filled_perlin"


@pytest.mark.parametrize("engine", ["folded", "scan"])
@pytest.mark.parametrize("name", ["plateau72", "filled_depressions"])
def test_resolve_flats_matches_pallas_engines(name, engine, interpret):
    dem, fd, nd = _case(name)
    got_fd, got_mask, got_flat = _port(dem, fd, nd)
    want_fd, want_mask, want_flat, info = F._resolve_impl_pallas(
        jnp.asarray(dem), jnp.asarray(fd), jnp.zeros(dem.shape, bool), 256,
        engine=engine, fold_pad=64)
    assert bool(info[1])
    np.testing.assert_array_equal(got_fd, np.asarray(want_fd))
    np.testing.assert_array_equal(got_mask, np.asarray(want_mask))
    np.testing.assert_array_equal(got_flat, np.asarray(want_flat))


@pytest.mark.parametrize("mode", tsweeps.DIST_MODES)
def test_dist_fixpoint_matches_pallas(mode, interpret):
    """One fixpoint per mode, from the seeds flat resolution gives it (the
    ``maxd`` start from the ``away`` field), against
    ``pallas_sweeps.dist_fixpoint_pallas``."""
    dem = synth.with_nodata_holes(
        _filled(synth.depression_dem(40, 48, seed=3, dtype=np.float32)),
        no_data=ND, seed=1, n_holes=2, max_radius=4)
    fd = oracle.d8_flowdirs(dem.astype(np.float64), no_data=ND)
    z, m = convert.from_numpy(dem, ND, device="cpu")
    ff = tflats.flat_fields(z, torch.from_numpy(fd), m)
    ctx = tsweeps.dist_context(ff["zed"], ff["flags"])
    big = torch.tensor(tsweeps.BIG)
    seeds = {"member": torch.where(ff["noflow"], 0.0, big),
             "towards": torch.where(ff["outlet"], 0.0, big),
             "away": torch.where(ff["high_seed"], 1.0, big)}
    if mode == "maxd":
        away, _, _ = tsweeps.dist_fixpoint_core(
            seeds["away"], ctx, "away", 1.0, 256, tsweeps.dist_sweep_plain)
        d = torch.where(away < tsweeps.BIG / 2, away, 0.0)
        w0, step = torch.where(ff["in_flat"], -d, big), 0.0
    else:
        w0, step = seeds[mode], 1.0
    got, iters, done = tsweeps.dist_fixpoint_core(
        w0, ctx, mode, step, 256, tsweeps.dist_sweep_plain)
    pctx = pallas_sweeps._dist_context(jnp.asarray(ff["zed"].numpy()),
                                       jnp.asarray(ff["flags"].numpy(),
                                                   jnp.int32))
    want, _, wdone = pallas_sweeps.dist_fixpoint_pallas(
        jnp.asarray(w0.numpy()), pctx, mode, step, 256, return_info=True)
    assert done and bool(wdone) and iters >= 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got < w0).any()  # the fixpoint moved


#: the flag bits of ``flat_fields``: data, NO_FLOW, in a flat
_DATA, _NOFLOW, _INFLAT = 1, 2, 4


def _admissible(mode, z, zn, s, sn):
    """The edge n → c of each mode, from the cell's (``z``, ``s``) and the
    neighbour's (``zn``, ``sn``) elevation and flag byte: both data at one
    elevation, and the flags the mode asks for."""
    if not (z == zn and z < 2.9e37):
        return False
    both = {"member": (_DATA, _DATA),
            "towards": (_NOFLOW | _INFLAT, _INFLAT),
            "away": (_NOFLOW | _INFLAT, _NOFLOW | _INFLAT),
            "maxd": (_INFLAT, _INFLAT)}[mode]
    return (s & both[0]) == both[0] and (sn & both[1]) == both[1]


def _dist_cell_by_cell(w, z, s, mode, step, reverse):
    """One distance sweep over whole rows, one cell at a time in sweep
    order: a cell takes the least of its own sweep-start value and, over
    the admissible NW, N and NE of the row before, their new value plus
    ``step`` (float32).  Returns the raster and whether a cell changed."""
    h, wd = w.shape
    out = w.copy()
    before = 1 if reverse else -1
    step = np.float32(step)
    for r in (range(h - 1, -1, -1) if reverse else range(h)):
        rp = r + before
        for c in range(wd):
            best = out[r, c]
            for cc in (c - 1, c, c + 1):
                if (0 <= rp < h and 0 <= cc < wd and _admissible(
                        mode, z[r, c], z[rp, cc], s[r, c], s[rp, cc])):
                    best = min(best, out[rp, cc] + step)
            out[r, c] = best
    return out, bool((out != w).any())


def _cell_by_cell_sweep(w_in, z, flags, mode, step, reverse, flag):
    """:func:`_dist_cell_by_cell` with the sweep wrappers' signature."""
    out, changed = _dist_cell_by_cell(w_in.numpy(), z.numpy(),
                                      flags.numpy(), mode, step, reverse)
    flag.bitwise_or_(torch.tensor(int(changed), dtype=torch.int32))
    return torch.from_numpy(out)


@functools.lru_cache(maxsize=None)
def _holed_flats():
    """A 40×70 ε = 0 fill with nodata holes (flat lakes beside nodata and
    the grid's edges), its flat fields and each mode's start: the seeds
    flat resolution gives it, ``maxd`` a ramp of -D-like values, and
    ``member`` the outlets (nearly every flat cell here is NO_FLOW)."""
    dem = synth.with_nodata_holes(
        _filled(synth.depression_dem(40, 70, seed=6, dtype=np.float32)),
        no_data=ND, seed=4, n_holes=3, max_radius=4)
    fd = oracle.d8_flowdirs(dem.astype(np.float64), no_data=ND)
    z, m = convert.from_numpy(dem, ND, device="cpu")
    ff = tflats.flat_fields(z, torch.from_numpy(fd), m)
    big = torch.tensor(tsweeps.BIG)
    ramp = -(torch.arange(z.numel()) % 5).view(z.shape).to(torch.float32)
    starts = {"member": (torch.where(ff["outlet"], 0.0, big), 1.0),
              "towards": (torch.where(ff["outlet"], 0.0, big), 1.0),
              "away": (torch.where(ff["high_seed"], 1.0, big), 1.0),
              "maxd": (torch.where(ff["in_flat"], ramp, big), 0.0)}
    return ff, starts


@functools.lru_cache(maxsize=None)
def _whole_row_fixpoints():
    """Flat resolution of the ``plateau40`` case with the plain sweep and
    with the cell-by-cell whole-row sweep."""
    dem, fd, _ = _case("plateau40")
    z, m = convert.from_numpy(dem, None, device="cpu")
    fdt = torch.from_numpy(fd)
    return (tflats.resolve_flats_info(z, fdt, m),
            tflats.resolve_flats_info(z, fdt, m, sweep=_cell_by_cell_sweep))


@pytest.mark.parametrize("reverse", [False, True], ids=["down", "up"])
@pytest.mark.parametrize("mode", tsweeps.DIST_MODES)
def test_dist_sweep_is_the_whole_row_sweep(mode, reverse):
    """One plain distance sweep, with its change flag, is the sweep over
    whole rows read cell by cell (the kernel's tiles trade edge values, so
    no tile width shows), on a 40×70 raster with nodata holes, flats and
    off-grid neighbours; and flat resolution through the cell-by-cell sweep
    reaches the plain sweep's fixpoint."""
    ff, starts = _holed_flats()
    w0, step = starts[mode]
    flag = torch.zeros(1, dtype=torch.int32)
    got = tsweeps.dist_sweep_plain(w0, ff["zed"], ff["flags"], mode, step,
                                   reverse, flag)
    want, changed = _dist_cell_by_cell(w0.numpy(), ff["zed"].numpy(),
                                       ff["flags"].numpy(), mode, step,
                                       reverse)
    np.testing.assert_array_equal(got.numpy(), want)
    assert changed and int(flag) == 1
    flag.zero_()
    tsweeps.dist_sweep_plain(got, ff["zed"], ff["flags"], mode, step,
                             reverse, flag)
    assert int(flag) == 0  # a sweep is idempotent
    plain, cells = _whole_row_fixpoints()
    for g, w in zip(plain[:3], cells[:3]):
        assert torch.equal(g, w)
    assert plain[3] == cells[3] and plain[4] and cells[4]


def test_resolved_fills_drain_and_entry_points():
    """After an ε = 0 fill and resolution only border outlets keep
    NO_FLOW (tests/test_ops_flats.py::test_resolved_fills_drain); the
    array entry points run on the asked device and raise at a cap that is
    too small."""
    dem, fd, _ = _case("filled_depressions")
    got, rotations, done = tflats.resolve_flats(dem, fd, return_info=True,
                                                device="cpu")
    assert done and rotations >= 3 and got.device.type == "cpu"
    assert (got.numpy()[1:-1, 1:-1] == topology.NO_FLOW).sum() == 0
    mask, in_flat = tflats.flat_mask_and_labels_device(dem, fd,
                                                       device="cpu")
    np.testing.assert_array_equal(mask.numpy(), _port(dem, fd, None)[1])
    assert mask.dtype == torch.int32 and in_flat.dtype == torch.bool
    with pytest.raises(RuntimeError, match="did not converge"):
        tflats.resolve_flats(dem, fd, max_iters=1, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        tflats.dist_sweep(torch.zeros(2, 2), torch.zeros(2, 2),
                          torch.zeros(2, 2, dtype=torch.int8), "up", 1.0,
                          False, torch.zeros(1, dtype=torch.int32))
