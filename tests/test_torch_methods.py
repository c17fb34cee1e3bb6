"""Port D8 methods (watersheds, upslope cells, Strahler order) ↔ the JAX
reference, bitwise.

Three references hold the port: ``richdem_tpu.methods`` on the CPU (its
pointer doubling and Jacobi Strahler fixpoint), the from-scratch NumPy
walks of ``tests/reference_impls.py``, and, for the sweeps themselves, the
TPU engines ``successor_resolve_folded`` and ``strahler_folded`` in
interpret mode with small folds and strips.  All results are integers and
every fixpoint is unique on an acyclic code raster, so every comparison is
exact.  One plain resolve sweep and one plain Strahler sweep are also
held against cell-by-cell sweeps over whole rows: the kernels' tiles trade
edge values, so no tile width shows in one sweep.  The plain successor
jump (``successor_jump_plain``, the entries' engine for labels and
upslope masks off the card) is held against the sweeps' fixpoint and the
reference at several tiles, on cycles too, where it leaves what the
sweeps leave.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from richdem_tpu import methods as jm
from richdem_tpu import synth
from richdem_tpu.ops import accum as jaccum
from richdem_tpu.ops import fill as jfill
from richdem_tpu.ops import flats as jflats
from richdem_tpu.ops import flowdirs as jflow
from richdem_tpu.ops import pallas_folded
import richdem_tpu_torch as rt
from richdem_tpu_torch import methods as tm
from richdem_tpu_torch import topology
from richdem_tpu_torch._build import JUMP_TILE
from richdem_tpu_torch.ops import accum as tacc
from richdem_tpu_torch.ops import fill as tfill
from richdem_tpu_torch.ops import flowdirs as tflow
from richdem_tpu_torch.ops import successor as S

from tests.reference_impls import (strahler_numpy, successor_table,
                                   terminal_labels, upslope_numpy)

torch.set_num_threads(1)

ND = -9999.0


@functools.lru_cache(maxsize=None)
def _codes(hw, seed, outward):
    """D8 codes of an ε-filled Perlin DEM with nodata holes; with
    ``outward``, the border cells of the top row and of the left column
    point off the grid."""
    dem = synth.with_nodata_holes(
        synth.perlin_dem(*hw, seed=seed, dtype=np.float32), no_data=ND,
        seed=seed)
    z = torch.from_numpy(dem)
    mask = z == ND
    filled, _, done = tfill.fill_depressions_info(z, mask, eps=1e-3)
    assert done
    fd = tflow.d8_core(filled, mask).numpy()
    if outward:
        fd[0, 1:][fd[0, 1:] >= 0] = 3   # N, off the grid
        fd[1:, 0][fd[1:, 0] >= 0] = 1   # W, off the grid
    return fd


CASES = [((64, 80), 8, False), ((96, 200), 3, True)]
IDS = ["64x80", "96x200-outward"]


def _seeds(fd, seed=0):
    return np.random.default_rng(seed).random(fd.shape) < 0.01


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_watersheds_vs_jax_and_reference(case):
    fd = _codes(*case)
    got, rotations, engine = rt.watersheds_from_flowdirs(
        fd, return_info=True, device="cpu")
    assert got.dtype == torch.int32 and (rotations, engine) == (0, "jump")
    want = np.asarray(jm.watersheds_from_flowdirs(jnp.asarray(fd)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), terminal_labels(fd))
    np.testing.assert_array_equal(tm.watersheds_doubling(fd, "cpu").numpy(),
                                  want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_upslope_cells_vs_jax_and_reference(case):
    fd = _codes(*case)
    seeds = _seeds(fd)
    got = rt.upslope_cells(seeds, fd, device="cpu")
    assert got.dtype == torch.bool and int(got.sum()) > int(seeds.sum())
    want = np.asarray(jm.upslope_cells(jnp.asarray(seeds), jnp.asarray(fd)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), upslope_numpy(seeds, fd))
    np.testing.assert_array_equal(
        tm.upslope_doubling(seeds, fd, "cpu").numpy(), want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_strahler_order_vs_jax_and_reference(case):
    fd = _codes(*case)
    got = rt.strahler_order(torch.from_numpy(fd))
    assert got.dtype == torch.int32 and int(got.max()) >= 3
    want = np.asarray(jm.strahler_order(jnp.asarray(fd)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), strahler_numpy(fd))
    np.testing.assert_array_equal(tm.strahler_jacobi(fd, device="cpu")
                                  .numpy(), want)
    assert (got.numpy()[fd < 0] == 0).all()


def test_successor_table_and_effective_codes_vs_jax():
    fd = _codes((96, 200), 3, True)
    got = S.successor_table(torch.from_numpy(fd)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm._successors(
        jnp.asarray(fd))))
    np.testing.assert_array_equal(got, successor_table(fd))
    np.testing.assert_array_equal(
        S.effective_codes(torch.from_numpy(fd)).numpy(),
        np.asarray(jm._fd_effective(jnp.asarray(fd))))


@pytest.fixture
def folded_interpret():
    """The reference's folded engines in interpret mode with 16-row
    strips, as ``tests/test_pallas_folded.py`` runs them; the cap is
    restored and the traces dropped afterwards."""
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
        pallas_folded.successor_resolve_folded.clear_cache()
        pallas_folded.strahler_folded.clear_cache()


def test_successor_resolve_vs_folded_interpret(folded_interpret):
    fd = _codes((64, 80), 8, False)
    fd_eff = S.effective_codes(torch.from_numpy(fd))
    pinned = fd_eff == 0
    idx = torch.arange(fd.size, dtype=torch.int32).view(fd.shape)
    init = torch.where(pinned, idx, -1)
    got = S.successor_resolve(fd_eff, init, pinned)
    want = pallas_folded.successor_resolve_folded(
        jnp.asarray(fd_eff.numpy()), jnp.asarray(init.numpy()),
        jnp.asarray(pinned.numpy()), fold_pad=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_strahler_vs_folded_interpret(folded_interpret):
    fd = _codes((64, 80), 8, False)
    got = S.strahler_fixpoint(torch.from_numpy(fd))
    want = pallas_folded.strahler_folded(jnp.asarray(fd), fold_pad=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _resolve_cell_by_cell(v, code, reverse):
    """One resolve sweep over whole rows, one cell at a time in sweep order:
    a successor in the row before is read at its new value, one in the
    cell's own row or the row after at its sweep-start value, one off the
    grid as -1; pinned (negative code byte) and NO_FLOW cells keep theirs."""
    h, w = v.shape
    out = v.copy()
    before = 1 if reverse else -1
    for r in (range(h - 1, -1, -1) if reverse else range(h)):
        for c in range(w):
            d = int(code[r, c])
            if d <= 0:
                continue
            rr, cc = r + int(topology.DY[d]), c + int(topology.DX[d])
            if not (0 <= rr < h and 0 <= cc < w):
                out[r, c] = -1
            else:
                out[r, c] = (out if rr - r == before else v)[rr, cc]
    return out


def _strahler_cell_by_cell(o, code, reverse):
    """One Strahler sweep over whole rows, one cell at a time in sweep
    order: the inflows of a cell are the neighbours whose code points at
    it, read at their new orders in the row before and at their
    sweep-start orders in the cell's own row and the row after; with m
    the largest inflow order and k the inflows at m, the update is 1 (no
    inflow), m (k = 1) or m + 1 (k ≥ 2), and the new order max(old,
    update), 0 where old is 0."""
    h, w = o.shape
    out = o.copy()
    before = 1 if reverse else -1
    for r in (range(h - 1, -1, -1) if reverse else range(h)):
        for c in range(w):
            ins = []
            for rr in (r - 1, r, r + 1):
                for cc in (c - 1, c, c + 1):
                    if (rr, cc) == (r, c) or not (0 <= rr < h
                                                  and 0 <= cc < w):
                        continue
                    d = int(code[rr, cc])
                    if (d > 0 and rr + int(topology.DY[d]) == r
                            and cc + int(topology.DX[d]) == c):
                        ins.append((out if rr - r == before else o)[rr, cc])
            m = max(ins, default=0)
            k = sum(1 for x in ins if x == m and m > 0)
            upd = 1 if m == 0 else (m + 1 if k >= 2 else m)
            out[r, c] = max(o[r, c], upd) if o[r, c] > 0 else 0
    return out


def test_plain_sweeps_cross_seams():
    """A 96×200 raster with nodata holes and cells that point off the grid.
    One resolve sweep and one Strahler sweep, down and up, are the sweeps
    over whole rows read cell by cell (the kernels' tiles trade edge
    values, so no tile width shows); the fixpoints are the references'."""
    fd = _codes((96, 200), 3, True)
    t = torch.from_numpy(fd)
    fd_eff = S.effective_codes(t)
    pinned = fd_eff == 0
    init = torch.where(pinned, torch.arange(fd.size, dtype=torch.int32)
                       .view(fd.shape), -1)
    code = S.pack_codes(fd_eff, pinned)
    for reverse in (False, True):
        np.testing.assert_array_equal(
            S.resolve_sweep_plain(init, code, reverse).numpy(),
            _resolve_cell_by_cell(init.numpy(), code.numpy(), reverse))
    lab, _, done = S.successor_resolve_info(fd_eff, init, pinned)
    assert done
    np.testing.assert_array_equal(lab.numpy(), terminal_labels(fd))
    seeds = torch.from_numpy(_seeds(fd, 1))
    up, _, done = S.successor_resolve_info(
        fd_eff, seeds.to(torch.int32), seeds | pinned)
    assert done
    np.testing.assert_array_equal((up > 0).numpy(),
                                  upslope_numpy(seeds.numpy(), fd))
    o0 = (t >= 0).to(torch.int32)
    sc = t.clamp(min=0).to(torch.int8)
    for reverse in (False, True):
        got = S.strahler_sweep_plain(o0, sc, reverse)
        np.testing.assert_array_equal(
            got.numpy(),
            _strahler_cell_by_cell(o0.numpy(), sc.numpy(), reverse))
        assert (got > 1).any()
    order, _, done = S.strahler_fixpoint_info(t)
    assert done
    np.testing.assert_array_equal(order.numpy(), strahler_numpy(fd))


def test_cycle_and_unconverged_raise():
    """A cycle raises, through the port's function and
    ``api.WatershedLabels``; the jump reports no rotation and equals
    pointer doubling; Strahler order still raises at its cap."""
    fd = np.zeros((6, 7), np.int8)
    fd[2, 2], fd[2, 3] = 5, 1   # E then W: a 2-cycle
    fd[3, 3] = 3                # drains into it
    with pytest.raises(ValueError, match="cycle: 3 cells"):
        rt.watersheds_from_flowdirs(fd, device="cpu")
    with pytest.raises(ValueError, match="cycle: 3 cells"):
        rt.WatershedLabels(rt.rdarray(torch.from_numpy(fd)),
                           from_flowdirs=True)
    deep = _codes((64, 80), 8, False)
    labels, rotations, engine = rt.watersheds_from_flowdirs(
        deep, return_info=True, device="cpu")
    assert (rotations, engine) == (0, "jump")
    np.testing.assert_array_equal(
        labels.numpy(), tm.watersheds_doubling(deep, "cpu").numpy())
    up, rotations, engine = rt.upslope_cells(
        _seeds(deep), deep, return_info=True, device="cpu")
    assert (rotations, engine) == (0, "jump")
    np.testing.assert_array_equal(
        up.numpy(), tm.upslope_doubling(_seeds(deep), deep, "cpu").numpy())
    with pytest.raises(RuntimeError, match="did not converge"):
        rt.strahler_order(deep, max_rotations=1, device="cpu")


def _serpentine(n):
    """Each even row flows E and each odd row W, then S at the row's end;
    the last cell of the path is the one terminal.  The path turns back
    across every row, so the resolve sweeps gain about two rows a
    rotation."""
    fd = np.empty((n, n), np.int8)
    fd[0::2], fd[1::2] = 5, 1
    fd[0::2, -1], fd[1::2, 0] = 7, 7
    fd[-1, -1 if n % 2 else 0] = 0
    return fd


@pytest.mark.parametrize("n", [128, 192])
def test_serpentine_watersheds_by_the_jump(n):
    """A path that turns back across every row, past what 64 rotations of
    sweeps reach: the jump's labels are bitwise the reference's (its
    doubling on the CPU), through the port's function and
    ``api.WatershedLabels``, with no rotation reported."""
    fd = _serpentine(n)
    want = np.asarray(jm.watersheds_from_flowdirs(jnp.asarray(fd)))
    assert np.unique(want).size == 1
    got, rotations, engine = rt.watersheds_from_flowdirs(
        fd, return_info=True, device="cpu")
    assert (rotations, engine) == (0, "jump")
    np.testing.assert_array_equal(got.numpy(), want)
    api = rt.WatershedLabels(rt.rdarray(torch.from_numpy(fd)),
                             from_flowdirs=True)
    np.testing.assert_array_equal(api.np(), want)


@pytest.mark.parametrize("n", [128, 192])
def test_serpentine_upslope_by_the_jump(n):
    """The cells upslope of a seed in the last row, by the jump: bitwise
    the reference's through the port's function and ``api.UpslopeCells``,
    with no rotation reported."""
    fd = _serpentine(n)
    seeds = np.zeros(fd.shape, bool)
    seeds[-1, n // 2] = True
    want = np.asarray(jm.upslope_cells(jnp.asarray(seeds), jnp.asarray(fd)))
    assert 0 < want.sum() < want.size
    got, rotations, engine = rt.upslope_cells(seeds, fd, return_info=True,
                                              device="cpu")
    assert (rotations, engine) == (0, "jump")
    np.testing.assert_array_equal(got.numpy(), want)
    api = rt.UpslopeCells(seeds, rt.rdarray(torch.from_numpy(fd)))
    np.testing.assert_array_equal(api.np(), want)


def test_d8_methods_slice_vs_jax():
    """The d8_methods path as a whole, ε = 0 fill → D8 → resolve_flats →
    watersheds, Strahler order, accumulation → upslope cells of the 8
    interior cells of largest accumulation, composed from the port and
    from the JAX functions on the CPU: every output bitwise."""
    z = synth.perlin_dem(64, 96, seed=1, dtype=np.float32)
    nd = np.zeros(z.shape, bool)
    jf, _, jdone = jfill.fill_depressions_info(jnp.asarray(z), eps=0.0)
    jfd = jflats.resolve_flats(jf, jflow.d8_flowdirs(jf))
    tf_, _, tdone = tfill.fill_depressions_info(torch.from_numpy(z), eps=0.0)
    tfd = rt.resolve_flats(tf_, tflow.d8_core(tf_, torch.from_numpy(nd)))
    assert bool(jdone) and tdone
    np.testing.assert_array_equal(tfd.numpy(), np.asarray(jfd))
    acc = tacc.d8_accumulation(tfd)
    np.testing.assert_array_equal(acc.numpy(),
                                  np.asarray(jaccum.d8_accumulation(jfd)))
    inner = torch.full_like(acc, -1.0)
    inner[1:-1, 1:-1] = acc[1:-1, 1:-1]
    top = torch.sort(inner.reshape(-1), descending=True,
                     stable=True).indices[:8]
    gauges = torch.zeros(z.size, dtype=torch.bool)
    gauges[top] = True
    gauges = gauges.view(z.shape)
    for got, want in (
            (rt.watersheds_from_flowdirs(tfd),
             jm.watersheds_from_flowdirs(jfd)),
            (rt.strahler_order(tfd), jm.strahler_order(jfd)),
            (rt.upslope_cells(gauges, tfd),
             jm.upslope_cells(jnp.asarray(gauges.numpy()), jfd))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the successor jump (plain version of csrc/successor_jump.cuh) ----------

#: Tiles of the plain jump: the kernels' (wider than a case's rows or
#: columns), one that divides no side of any case, and one that divides
#: the tile-edge case's
JUMP_TILES = [JUMP_TILE, 7, 16]


def _with_stops(fd, seed):
    """A copy of ``fd`` with about 5 % of its cells NO_FLOW and 5 % nodata
    (code -1): pins inside the paths."""
    rng = np.random.default_rng(seed)
    out = fd.copy()
    u = rng.random(fd.shape)
    out[u < 0.05] = 0
    out[(u >= 0.05) & (u < 0.1)] = -1
    return out


def _tile_edges():
    """A path along a tile edge of tile 16: every cell flows S, but rows 15
    and 16 (the two sides of a tile edge) flow E and W to the edge columns,
    and column 31 (the last of a tile) flows S to the bottom row, which is
    NO_FLOW."""
    fd = np.full((48, 40), 7, np.int8)
    fd[15, :], fd[16, :] = 5, 1
    fd[15, -1], fd[16, 0] = 7, 7
    fd[:, 31] = 7
    fd[-1, :] = 0
    return fd


JUMP_CASES = {
    "perlin-64x80": lambda: _codes((64, 80), 8, False),
    "perlin-96x200-outward": lambda: _codes((96, 200), 3, True),
    "noflow-nodata": lambda: _with_stops(_codes((64, 80), 8, False), 4),
    "tile-edge": _tile_edges,
    "serpentine-128": lambda: _serpentine(128),
}


@functools.lru_cache(maxsize=None)
def _jump_case(name):
    """The case's codes, seeds, and the references' labels and mask (the
    JAX package's, each bitwise the CPU entry points' and, but on the
    serpentine, whose sweeps take a rotation for every two rows, the
    resolve sweeps' fixpoint)."""
    fd = JUMP_CASES[name]()
    seeds = _seeds(fd, 2)
    seeds[-1, fd.shape[1] // 2] = True
    labels = np.asarray(jm.watersheds_from_flowdirs(jnp.asarray(fd)))
    up = np.asarray(jm.upslope_cells(jnp.asarray(seeds), jnp.asarray(fd)))
    if not name.startswith("serpentine"):
        np.testing.assert_array_equal(_swept(fd).numpy(), labels)
        np.testing.assert_array_equal(_swept(fd, seeds).numpy(), up)
    np.testing.assert_array_equal(
        rt.watersheds_from_flowdirs(fd, device="cpu").numpy(), labels)
    np.testing.assert_array_equal(
        rt.upslope_cells(seeds, fd, device="cpu").numpy(), up)
    return fd, seeds, labels, up


@pytest.mark.parametrize("tile", JUMP_TILES)
@pytest.mark.parametrize("name", list(JUMP_CASES))
def test_successor_jump_plain_vs_sweeps_and_jax(name, tile):
    """Labels and upslope masks of the plain jump, at each tile, bitwise
    the resolve sweeps' fixpoint and the JAX reference: Perlin codes with
    nodata holes, codes off the grid, NO_FLOW and nodata inside the paths,
    paths along tile edges, and the serpentine, on which the sweeps stop at
    their cap of 64 rotations."""
    fd, seeds, labels, up = _jump_case(name)
    t = torch.from_numpy(fd)
    got = S.successor_jump_plain(t, tile=tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), labels)
    mask = S.successor_jump_plain(t, torch.from_numpy(seeds), tile=tile)
    assert mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), up)


def _swept(fd, seeds=None):
    """The resolve sweeps' fixpoint, started as the entry points start it:
    the labels, or the upslope mask of ``seeds``."""
    fd_eff = S.effective_codes(torch.from_numpy(fd))
    pinned = fd_eff == 0
    if seeds is None:
        own = torch.arange(fd.size, dtype=torch.int32).view(fd.shape)
        v, _, done = S.successor_resolve_info(fd_eff,
                                              torch.where(pinned, own, -1),
                                              pinned, 256)
    else:
        sd = torch.from_numpy(seeds)
        v, _, done = S.successor_resolve_info(fd_eff, sd.to(torch.int32),
                                              sd | pinned, 256)
        v = v > 0
    assert done
    return v


def _four_cycle():
    """A four-cell cycle (E, S, W, N) in a NO_FLOW field, three cells
    draining into it, and one cell of its own draining out."""
    fd = np.zeros((8, 9), np.int8)
    fd[2, 2], fd[2, 3], fd[3, 3], fd[3, 2] = 5, 7, 1, 3
    fd[1, 2], fd[1, 1], fd[4, 3] = 7, 5, 3
    fd[6, 6] = 5
    return fd


@pytest.mark.parametrize("tile", [2, 3, JUMP_TILE])
def test_successor_jump_plain_on_a_cycle(tile):
    """A four-cell cycle, inside one tile (2, 64) or across four (3): the
    cycle and what drains into it read -1 and not upslope, as the sweeps
    leave them; a seed on the cycle pins it, and everything upstream of the
    seed is upslope."""
    fd = _four_cycle()
    t = torch.from_numpy(fd)
    labels = S.successor_jump_plain(t, tile=tile)
    stuck = np.zeros(fd.shape, bool)
    stuck[1:5, 1:4] = fd[1:5, 1:4] != 0
    assert int(stuck.sum()) == 7
    np.testing.assert_array_equal(labels.numpy() < 0, stuck)
    np.testing.assert_array_equal(labels.numpy(), _swept(fd).numpy())
    for cell in ((1, 1), (2, 3), (6, 6)):
        seeds = np.zeros(fd.shape, bool)
        seeds[cell] = True
        up = S.successor_jump_plain(t, torch.from_numpy(seeds), tile=tile)
        np.testing.assert_array_equal(up.numpy(), _swept(fd, seeds).numpy())
    assert int(up.sum()) == 1 and bool(up[6, 6])
    seeds[:] = False
    seeds[2, 3] = True
    up = S.successor_jump_plain(t, torch.from_numpy(seeds), tile=tile)
    assert int(up.sum()) == 7


@pytest.mark.parametrize("shape", [(1, 1), (1, 70), (70, 1), (33, 47)])
def test_successor_jump_plain_random_codes(shape):
    """Codes drawn from -1..8, cycles among them, at tiles 2, 7 and 16:
    bitwise the resolve sweeps' fixpoint."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    fd = rng.integers(-1, 9, shape).astype(np.int8)
    seeds = rng.random(shape) < 0.1
    labels, up = _swept(fd), _swept(fd, seeds)
    for tile in (2, 7, 16):
        t = torch.from_numpy(fd)
        assert torch.equal(S.successor_jump_plain(t, tile=tile), labels)
        assert torch.equal(
            S.successor_jump_plain(t, torch.from_numpy(seeds), tile=tile),
            up)


def test_jump_slots_and_fits():
    """The kernels' border slots and rounds, and the grids they take."""
    assert S.jump_slots(64, 64) == (252, 9)
    assert S.jump_slots(65, 129, tile=64) == (6 * 252, 12)
    assert S.jump_slots(1, 1) == (252, 9)
    assert S.jump_fits((10240, 10240)) and S.jump_fits((1 << 15, 1 << 15))
    assert not S.jump_fits((1 << 15, (1 << 15) + 1))
    assert not S.jump_fits((1, 1 << 30))
