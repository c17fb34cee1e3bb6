"""The CUDA kernels ↔ their plain versions, on a CUDA card.

Marked ``gpu``: the kernels have no CPU mode, so without a card and
``nvcc`` these tests skip.  On a card, run
``python -m pytest tests/test_torch_cuda.py -q``.  Widths above the
1024-column tile put the fill and accumulation sweeps' seams inside the
grid; a single sweep must still be bitwise the plain version's (which
reads seams the same way).  The terrain
kernel's atan attributes are held to rtol 1e-6 (the kernel and torch may
call different atan implementations), the others bitwise.  The D∞ and
multi-flow sweeps are bitwise at 1000×1100 in every depth mode (1, a
window, the whole tile), down and transposed up.  Rho8 codes are bitwise
the plain version's for the same seed (the kernel's ``tanf`` and
``torch.tan`` on the card agree), and the resolve and Strahler sweeps are
bitwise, down and transposed up, and so are their fixpoints.  The
resolve, distance and Strahler kernels (the seam-exact walk of
``csrc/seam_walk.cuh``), built at several tile widths and halos, at widths
from 1 to 8193 and on grids wider than the card's resident blocks, equal
the plain sweeps over whole rows, the distance sweep's change flag
included.  The scan
fill sweep (a thread-block cluster a row) is bitwise its plain version
down and up at ε = 0, ε = 1e-3 and D4, at widths that give one CTA, a
ragged last CTA, 16 CTAs and many columns a thread, and its ε = 0
fixpoint equals the native engine's fill.  The row-ring fill and
accumulation sweeps are bitwise their plain versions at widths that cut
the last tile short, on rows that
are and are not 16-byte aligned (the float4 and the scalar consumers),
at heights 1, 2 and one past the ring.  The D8 tile kernel is bitwise
``d8_plain`` at widths 1 to 4099 and heights 1 to 3, on aligned and
unaligned rows, and on values that leave its fast division's range; so
are the Rho8 codes and the terrain attributes on the same tile
(``csrc/stencil_tile.cuh``), the non-atan attributes bit for bit.  The
D∞ and multi-flow sweeps, whose tiles trade edge values, equal their plain
versions and the plain sweep over whole rows at widths from 1 to 8300,
on grids wider than the card's resident blocks, and through a whole Quinn
fixpoint at 512².  The topological multi-flow pass (its count and solve
kernels) is bitwise its plain version and itself on a second run, on
those shapes with holes and at 512², and hands a field with a cycle to
the sweeps; so is the pass over D8 codes (nodata holes, off-grid targets,
unit and float weights; at 10240² on the codes of both D8 cells), which
the entry point takes with no sweep, native-exact at 2048² and 4096², and
which hands a cycle to the sweeps.  The successor jump's kernels equal their plain version
bitwise (and themselves on a second launch) on random codes with cycles
and on Perlin codes at the ragged shapes, a row, a column and around tile
edges, and the resolve sweeps' fixpoint at 1000×1100; the entry points
and the two-pass tile labels take them on a card, and a grid they cannot
index raises there.  The two-pass programs at 1024²
(tile 256) run the fill, D8, distance, jump and D8 pass kernels and
equal the
in-core results and the native consumer bitwise, as does the ε Schwarz
fill the in-core ε-fill from BIG; the min-plus names run the fill kernel
for a fill-shaped call and equal the CPU's plain code otherwise.  The
sharded mesh over four positions of one card (1024×1100, extended blocks
514×552): the pipeline's fill, codes, accumulation and slope bitwise the
in-core ops, the two-pass pair bitwise the Schwarz results, Quinn
accumulation within rtol 2e-5, and a one-rank NCCL group bitwise the
in-process mesh.
"""

import numpy as np
import pytest
import torch

from richdem_tpu_torch import _build, synth_np
from richdem_tpu_torch import synth as tsynth
from richdem_tpu_torch import methods
from richdem_tpu_torch.ops import (accum, dinf, fill, flats, flowdirs, mfd,
                                   successor, sweeps, terrain)

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

SHAPES = [(37, 2100), (300, 1025), (1030, 45)]
RAGGED_TOPO = (1000, 1100)  # the D8 pass with holes, as chip_smoke's


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    try:
        _build.find_nvcc()
    except RuntimeError as exc:
        pytest.skip(str(exc))
    return torch.device("cuda", 0)


def _dem(shape, dev, seed=1):
    z = tsynth.perlin_dem(*shape, seed=seed, device=dev)
    rng = np.random.default_rng(seed)
    mask = torch.from_numpy(rng.random(shape) < 0.02).to(dev)
    return z, mask


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_fill_sweep_kernel_matches_plain(dev, shape, eps):
    z, mask = _dem(shape, dev)
    neg = torch.tensor(-sweeps.BIG, device=dev)
    floor = torch.where(mask, neg, z)
    w = torch.where(mask, neg, torch.full_like(z, sweeps.BIG))
    for reverse in (False, True):
        fk = torch.zeros(1, dtype=torch.int32, device=dev)
        fp = torch.zeros(1, dtype=torch.int32, device=dev)
        before = fill.FILL_SWEEP.launches
        wk = fill.fill_sweep(w, floor, eps, eps, reverse, fk)
        wp = sweeps.fill_sweep_plain(w, floor, eps, eps, reverse, fp)
        torch.cuda.synchronize()
        assert fill.FILL_SWEEP.launches == before + 1
        assert torch.equal(wk, wp) and torch.equal(fk, fp)
        w = wk
    got, _, done = fill.fill_depressions_info(z, mask, eps=eps)
    ref, _, done_p = sweeps.fill_fixpoint_core(
        torch.where(mask, neg, torch.full_like(z, sweeps.BIG)), floor,
        float(np.float32(eps)), 256, sweeps.fill_sweep_plain)
    assert done and done_p
    assert torch.equal(got, torch.where(mask, z, ref))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("topology", ["D8", "D4"])
def test_d8_kernel_matches_plain(dev, shape, topology):
    z, mask = _dem(shape, dev, seed=2)
    z = torch.round(z * 4) / 4  # many exact ties
    got = flowdirs.d8_core(z, mask, 1.5, topology)
    assert torch.equal(got, flowdirs.d8_plain(z, mask, 1.5, topology))


@pytest.mark.parametrize("shape", SHAPES)
def test_accum_sweep_kernel_matches_plain(dev, shape):
    z, mask = _dem(shape, dev, seed=3)
    filled, _, _ = fill.fill_depressions_info(z, mask, eps=1e-3)
    fd = flowdirs.d8_core(filled, mask)
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.uniform(0.5, 2.0, shape).astype(np.float32))
    w = torch.where(mask, 0.0, w.to(dev))
    acc = w
    for reverse in (False, True):
        ak = accum.accum_sweep(acc, w, fd, reverse)
        ap = accum.accum_sweep_plain(acc, w, fd, reverse)
        assert torch.equal(ak, ap)  # same grouping, same seams
        acc = ak
    ones = torch.where(mask, 0.0, torch.ones_like(z))
    got, rk, dk = accum.d8_accumulation_sweeps(fd, ones, 64)
    ref, rp, dp = accum.d8_accumulation_sweeps(fd, ones, 64,
                                               sweep=accum.accum_sweep_plain)
    assert dk and dp and rk == rp and torch.equal(got, ref)
    # the entry takes the topological pass: the same integer sums
    assert torch.equal(accum.d8_accumulation(fd, ones), ref)


def _flat_case(shape, dev):
    """An ε = 0 filled depression DEM (flat lakes), its D8 codes and the
    flat fields flat resolution builds from them."""
    dem = synth_np.depression_dem(*shape, seed=4, n_pits=6)
    z = torch.from_numpy(dem).to(dev)
    mask = torch.zeros_like(z, dtype=torch.bool)
    filled, _, done = fill.fill_depressions_info(z, mask, eps=0.0)
    assert done
    fd = flowdirs.d8_core(filled, mask)
    return filled, fd, mask, flats.flat_fields(filled, fd, mask)


def _seeds(ff):
    """A start for each mode; ``maxd`` gets -D-like values that vary."""
    zed = ff["zed"]
    big = torch.tensor(sweeps.BIG, device=zed.device)
    ramp = -(torch.arange(zed.numel(), device=zed.device) % 5).view(
        zed.shape).to(torch.float32)
    return {"member": (torch.where(ff["noflow"], 0.0, big), 1.0),
            "towards": (torch.where(ff["outlet"], 0.0, big), 1.0),
            "away": (torch.where(ff["high_seed"], 1.0, big), 1.0),
            "maxd": (torch.where(ff["in_flat"], ramp, big), 0.0)}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", sweeps.DIST_MODES)
def test_dist_sweep_kernel_matches_plain(dev, shape, mode):
    _, _, _, ff = _flat_case(shape, dev)
    z, s, z_t, s_t = sweeps.dist_context(ff["zed"], ff["flags"])
    w, step = _seeds(ff)[mode]
    for transposed in (False, True):
        zz, ss = (z_t, s_t) if transposed else (z, s)
        w = w.t().contiguous() if transposed else w.contiguous()
        for reverse in (False, True):
            fk = torch.zeros(1, dtype=torch.int32, device=dev)
            fp = torch.zeros(1, dtype=torch.int32, device=dev)
            before = flats.DIST_SWEEP.launches
            wk = flats.dist_sweep(w, zz, ss, mode, step, reverse, fk)
            wp = sweeps.dist_sweep_plain(w, zz, ss, mode, step, reverse,
                                         fp)
            torch.cuda.synchronize()
            assert flats.DIST_SWEEP.launches == before + 1
            assert torch.equal(wk, wp) and torch.equal(fk, fp)
            w = wk
        if transposed:
            w = w.t().contiguous()


@pytest.mark.parametrize("shape", SHAPES)
def test_resolve_flats_kernel_matches_plain(dev, shape):
    filled, fd, mask, _ = _flat_case(shape, dev)
    got = flats.resolve_flats_info(filled, fd, mask)
    ref = flats.resolve_flats_info(filled, fd, mask,
                                   sweep=sweeps.dist_sweep_plain)
    assert got[4] and ref[4]
    for g, r in zip(got[:3], ref[:3]):
        assert torch.equal(g, r)
    assert int((got[1] > 0).sum()) > 0  # real flats were resolved


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("attrib", terrain.TERRAIN_ATTRIBUTES)
def test_terrain_kernel_matches_plain(dev, shape, attrib):
    z, mask = _dem(shape, dev, seed=5)
    before = terrain.TERRAIN.launches
    got = terrain.terrain_fused(z, mask, 2.0, 3.0, attrib)
    torch.cuda.synchronize()
    assert terrain.TERRAIN.launches == before + 1
    ref = terrain.terrain_plain(z, mask, 2.0, 3.0, attrib)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert bool(torch.isnan(got[mask]).all())
    ok = ~torch.isnan(ref)
    if attrib in ("slope_radians", "slope_degrees", "aspect"):
        torch.testing.assert_close(got[ok], ref[ok], rtol=1e-6, atol=0)
    else:
        assert torch.equal(got[ok], ref[ok])


@pytest.fixture(scope="module")
def flow_fields(dev):
    """The D∞ field and the Quinn planes of an ε-filled 1000×1100 Perlin
    DEM with nodata holes, each with its transposed form."""
    z, mask = _dem((1000, 1100), dev, seed=6)
    filled, _, done = fill.fill_depressions_info(z, mask, eps=1e-2)
    assert done
    ang = torch.where(mask, -2.0, flowdirs.dinf_flowdirs(filled))
    code, p = dinf.dinf_two_tap(ang)
    cq, pq = dinf.unpack_two_tap(dinf.pack_two_tap(code, p))
    v = dinf.pack_two_tap(cq, pq).contiguous()
    v_t = dinf.pack_two_tap(*dinf.transpose_two_tap(cq, pq)).contiguous()
    props = flowdirs.flow_proportions(filled, "Quinn")
    planes = torch.where(mask, 0.0, props.permute(2, 0, 1)).contiguous()
    weights = torch.where(mask, 0.0, torch.ones_like(z))
    return {"dinf": (dinf.DINF_SWEEP, dinf.dinf_sweep,
                     dinf.dinf_sweep_plain, v, v_t),
            "mfd": (mfd.MFD_SWEEP, mfd.mfd_sweep, mfd.mfd_sweep_plain,
                    planes, mfd.transpose_planes(planes)),
            "weights": weights}


@pytest.mark.parametrize("depth", [1, 8, 0])
@pytest.mark.parametrize("kind", ["dinf", "mfd"])
def test_flow_sweep_kernels_match_plain(dev, flow_fields, kind, depth):
    kernel, sweep, plain, field, field_t = flow_fields[kind]
    w = flow_fields["weights"]
    rng = np.random.default_rng(depth)
    acc = torch.from_numpy(rng.uniform(1.0, 50.0, tuple(w.shape))
                           .astype(np.float32)).to(dev)
    before = kernel.launches
    ak = sweep(acc, w, field, False, depth)
    ap = plain(acc, w, field, False, depth)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(ak, ap)
    at, w_t = ak.t().contiguous(), w.t().contiguous()
    assert torch.equal(sweep(at, w_t, field_t, True, depth),
                       plain(at, w_t, field_t, True, depth))


@pytest.mark.parametrize("kind", ["dinf", "mfd"])
def test_flow_accumulation_kernels_match_plain(dev, flow_fields, kind):
    """Whole fixpoints, kernel and plain rotations, bitwise (the default
    depth)."""
    _, sweep, plain, field, _ = flow_fields[kind]
    w = flow_fields["weights"]
    if kind == "dinf":
        info = dinf.dinf_accumulation_info
        args = dinf.unpack_two_tap(field)
    else:
        info, args = mfd.mfd_accumulation_info, (field,)
    got, rk, dk = info(*args, w)
    ref, rp, dp = info(*args, w, sweep=plain)
    assert dk and dp and rk == rp
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("topology", ["D8", "D4"])
@pytest.mark.parametrize("seed", [0, 5])
def test_rho8_kernel_matches_plain(dev, shape, topology, seed):
    z, mask = _dem(shape, dev, seed=7)
    before = flowdirs.RHO8.launches
    got = flowdirs.rho8_core(z, mask, 1.5, seed, topology)
    torch.cuda.synchronize()
    assert flowdirs.RHO8.launches == before + 1
    diag = flowdirs.rho8_diagonal(shape, seed, dev)
    assert torch.equal(got, flowdirs.rho8_plain(z, mask, 1.5, diag,
                                                topology))
    assert torch.equal(got == -1, mask)


@pytest.fixture(scope="module")
def succ_codes(dev):
    """D8 codes of an ε-filled 1000×1100 Perlin DEM with nodata holes."""
    z, mask = _dem((1000, 1100), dev, seed=8)
    filled, _, done = fill.fill_depressions_info(z, mask, eps=1e-3)
    assert done
    return flowdirs.d8_core(filled, mask)


def _resolve_start(fd, kind):
    fd_eff = successor.effective_codes(fd)
    pinned = fd_eff == 0
    if kind == "watersheds":
        idx = torch.arange(fd.numel(), dtype=torch.int32,
                           device=fd.device).view(fd.shape)
        return fd_eff, torch.where(pinned, idx, -1), pinned
    seeds = torch.from_numpy(np.random.default_rng(8).random(
        tuple(fd.shape)) < 0.01).to(fd.device)
    return fd_eff, seeds.to(torch.int32), seeds | pinned


@pytest.mark.parametrize("kind", ["watersheds", "upslope"])
def test_resolve_sweep_kernel_matches_plain(dev, succ_codes, kind):
    fd_eff, init, pinned = _resolve_start(succ_codes, kind)
    code = successor.pack_codes(fd_eff, pinned)
    before = successor.RESOLVE_SWEEP.launches
    vk = successor.resolve_sweep(init, code, False)
    torch.cuda.synchronize()
    assert successor.RESOLVE_SWEEP.launches == before + 1
    assert torch.equal(vk, successor.resolve_sweep_plain(init, code, False))
    vt, code_t = vk.t().contiguous(), successor.transpose_codes(code)
    assert torch.equal(successor.resolve_sweep(vt, code_t, True),
                       successor.resolve_sweep_plain(vt, code_t, True))
    got, rk, dk = successor.successor_resolve_info(fd_eff, init, pinned)
    ref, rp, dp = successor.successor_resolve_info(
        fd_eff, init, pinned, sweep=successor.resolve_sweep_plain)
    assert dk and dp and rk == rp and torch.equal(got, ref)


#: (tile, halo) builds of the resolve kernel: its default, wider tiles,
#: a narrower halo and narrower tiles
RESOLVE_TILES = [(128, 64), (256, 64), (512, 64), (128, 32), (64, 32)]


@pytest.mark.parametrize("tile,halo", RESOLVE_TILES)
def test_resolve_sweep_any_tile_width(dev, succ_codes, tile, halo):
    """Built at each tile width and halo, the resolve kernel's sweep, down
    and transposed up, equals the plain sweep over whole rows at 1000×1100
    with nodata holes and codes that point off the grid (top row N, left
    column W), for watershed and upslope starts: one sweep does not
    depend on the tile."""
    default = successor.RESOLVE_SWEEP
    kern = _build.Kernel(default.name, default.symbol, default.argtypes,
                         defines={"RD_RESOLVE_TILE": tile,
                                  "RD_RESOLVE_HALO": halo})
    fd = succ_codes.clone()
    fd[0, 1:][fd[0, 1:] >= 0] = 3
    fd[1:, 0][fd[1:, 0] >= 0] = 1
    successor.RESOLVE_SWEEP = kern
    try:
        assert successor.resolve_shape()["tile"] == tile
        for kind in ("watersheds", "upslope"):
            fd_eff, init, pinned = _resolve_start(fd, kind)
            code = successor.pack_codes(fd_eff, pinned)
            vk = successor.resolve_sweep(init, code, False)
            assert torch.equal(vk, successor.resolve_sweep_plain(init, code,
                                                                 False))
            vt, code_t = vk.t().contiguous(), successor.transpose_codes(code)
            assert torch.equal(successor.resolve_sweep(vt, code_t, True),
                               successor.resolve_sweep_plain(vt, code_t,
                                                             True))
    finally:
        successor.RESOLVE_SWEEP = default


def test_resolve_sweep_wider_than_resident_blocks(dev):
    """A raster with more tiles than the card holds blocks at once (each
    block then walks a run of tiles and trades edges every row): down and
    up sweeps equal the plain sweep over whole rows."""
    tiles = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    shape = (5, tiles * _build.RESOLVE_TILE + 77)
    rng = np.random.default_rng(11)
    fd = torch.from_numpy(rng.integers(-1, 9, shape).astype(np.int8)).to(dev)
    for kind in ("watersheds", "upslope"):
        fd_eff, init, pinned = _resolve_start(fd, kind)
        code = successor.pack_codes(fd_eff, pinned)
        for reverse in (False, True):
            assert torch.equal(
                successor.resolve_sweep(init, code, reverse),
                successor.resolve_sweep_plain(init, code, reverse))


#: (tile, halo) builds of the distance and Strahler kernels: their default,
#: wider tiles, narrower tiles and halo, and the widest
WALK_TILES = [(128, 64), (256, 64), (64, 32), (512, 64)]
#: one column, a tile short of 128 and one past it, and many tiles with a
#: ragged last one
WALK_WIDTHS = [1, 127, 129, 8193]


def _dist_inputs(shape, dev, seed):
    """Terraces of equal elevation with nodata, random flag bytes and a
    start of unreached cells and small distances: every admissibility case
    of every mode, at any width."""
    rng = np.random.default_rng(seed)
    z = rng.integers(0, 3, shape).astype(np.float32)
    z[rng.random(shape) < 0.05] = sweeps.ZBIG
    s = rng.integers(0, 8, shape).astype(np.int8)
    w = np.where(rng.random(shape) < 0.1, rng.integers(0, 4, shape),
                 sweeps.BIG).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev) for x in (w, z, s))


def _dist_pair(w, z, s, mode, reverse):
    """A distance sweep of the kernel and of its plain version, results
    and change flags held bitwise; the kernel's result."""
    step = 0.0 if mode == "maxd" else 1.0
    fk = torch.zeros(1, dtype=torch.int32, device=w.device)
    fp = torch.zeros(1, dtype=torch.int32, device=w.device)
    before = flats.DIST_SWEEP.launches
    wk = flats.dist_sweep(w, z, s, mode, step, reverse, fk)
    wp = sweeps.dist_sweep_plain(w, z, s, mode, step, reverse, fp)
    torch.cuda.synchronize()
    assert flats.DIST_SWEEP.launches == before + 1
    assert torch.equal(wk, wp) and torch.equal(fk, fp)
    return wk


def _strahler_pair(o, code, reverse):
    before = successor.STRAHLER_SWEEP.launches
    ok = successor.strahler_sweep(o, code, reverse)
    torch.cuda.synchronize()
    assert successor.STRAHLER_SWEEP.launches == before + 1
    assert torch.equal(ok, successor.strahler_sweep_plain(o, code, reverse))
    return ok


def _walk_sweeps(kind, shape, dev, seed, transposed=True):
    """A down sweep of the kernel on a raster of ``shape``, then an up
    sweep of its result, transposed or not, each against the whole-row
    plain sweep (in every mode for the distance)."""
    def t(x):
        return x.t().contiguous() if transposed else x

    if kind == "dist":
        w, z, s = _dist_inputs(shape, dev, seed)
        for mode in sweeps.DIST_MODES:
            wk = _dist_pair(w, z, s, mode, False)
            _dist_pair(t(wk), t(z), t(s), mode, True)
        return
    rng = np.random.default_rng(seed)
    fd = torch.from_numpy(rng.integers(-1, 9, shape).astype(np.int8)).to(dev)
    o0 = (fd >= 0).to(torch.int32)
    code = fd.clamp(min=0).to(torch.int8)
    ok = _strahler_pair(o0, code, False)
    _strahler_pair(t(ok), successor.transpose_codes(code) if transposed
                   else code, True)


@pytest.mark.parametrize("tile,halo", WALK_TILES)
@pytest.mark.parametrize("kind", ["dist", "strahler"])
def test_walk_sweeps_any_tile_width(dev, kind, tile, halo):
    """Built at each tile width and halo, the distance and Strahler
    kernels' sweeps, down and transposed up, equal the plain sweeps over
    whole rows at widths 1, 127, 129 and 8193: one sweep does not depend on
    the tile."""
    mod, attr, macro, shape = {
        "dist": (flats, "DIST_SWEEP", "DIST", flats.dist_shape),
        "strahler": (successor, "STRAHLER_SWEEP", "STRAHLER",
                     successor.strahler_shape)}[kind]
    default = getattr(mod, attr)
    kern = _build.Kernel(default.name, default.symbol, default.argtypes,
                         defines={f"RD_{macro}_TILE": tile,
                                  f"RD_{macro}_HALO": halo})
    setattr(mod, attr, kern)
    try:
        assert shape()["tile"] == tile and shape()["halo"] == halo
        for k, width in enumerate(WALK_WIDTHS):
            _walk_sweeps(kind, (37, width), dev, k)
    finally:
        setattr(mod, attr, default)


@pytest.mark.parametrize("kind", ["dist", "strahler"])
def test_walk_sweeps_wider_than_resident_blocks(dev, kind):
    """Rasters with more tiles than the card holds blocks at once (each
    block then walks a run of tiles and trades edges every row): down and
    up sweeps equal the plain sweeps over whole rows."""
    tile = {"dist": _build.DIST_TILE, "strahler": _build.STRAHLER_TILE}[kind]
    tiles = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    _walk_sweeps(kind, (5, tiles * tile + 77), dev, 12, transposed=False)


def test_strahler_sweep_kernel_matches_plain(dev, succ_codes):
    fd = succ_codes
    o0 = (fd >= 0).to(torch.int32)
    code = fd.clamp(min=0).to(torch.int8)
    before = successor.STRAHLER_SWEEP.launches
    ok = successor.strahler_sweep(o0, code, False)
    torch.cuda.synchronize()
    assert successor.STRAHLER_SWEEP.launches == before + 1
    assert torch.equal(ok, successor.strahler_sweep_plain(o0, code, False))
    ot, code_t = ok.t().contiguous(), successor.transpose_codes(code)
    assert torch.equal(successor.strahler_sweep(ot, code_t, True),
                       successor.strahler_sweep_plain(ot, code_t, True))
    got, rk, dk = successor.strahler_fixpoint_info(fd)
    ref, rp, dp = successor.strahler_fixpoint_info(
        fd, sweep=successor.strahler_sweep_plain)
    assert dk and dp and rk == rp and torch.equal(got, ref)


def test_methods_match_doubling_and_jacobi(dev, succ_codes):
    """The entry points on the card against the plain cross-checks."""
    fd = succ_codes
    assert torch.equal(methods.watersheds_from_flowdirs(fd),
                       methods.watersheds_doubling(fd))
    _, seeds, _ = _resolve_start(fd, "upslope")
    seeds = seeds > 0
    assert torch.equal(methods.upslope_cells(seeds, fd),
                       methods.upslope_doubling(seeds, fd))
    assert torch.equal(methods.strahler_order(fd),
                       methods.strahler_jacobi(fd, max_iters=1 << 16))


# -- the successor jump (csrc/successor_jump.cuh) ---------------------------

#: The kernels' ragged shapes, a row and a column, one tile, a cell past
#: a tile each way, a cell short of two
JUMP_SHAPES = SHAPES + [(1, 1), (1, 4099), (4099, 1), (64, 64), (65, 129),
                        (127, 63)]


def _jump_held(fd, seeds=None):
    """The jump's kernels ↔ ``successor_jump_plain``: bitwise, and the
    same bits on a second launch; returns the kernels' result."""
    before = successor.RESOLVE_JUMP.launches
    got = successor.successor_jump(fd, seeds)
    again = successor.successor_jump(fd, seeds)
    torch.cuda.synchronize()
    assert successor.RESOLVE_JUMP.launches == before + 2
    assert torch.equal(got, successor.successor_jump_plain(fd, seeds))
    assert torch.equal(again, got)
    return got


@pytest.mark.parametrize("shape", JUMP_SHAPES)
def test_resolve_jump_kernels_match_plain(dev, shape):
    """Labels and upslope masks of random codes in -1..8 (cycles among
    them) and of the D8 codes of an ε-filled Perlin DEM with holes:
    bitwise the plain version, and the same bits twice."""
    rng = np.random.default_rng(shape[0] + 7 * shape[1])
    seeds = torch.from_numpy(rng.random(shape) < 0.05).to(dev)
    fd = torch.from_numpy(rng.integers(-1, 9, shape).astype(np.int8)).to(dev)
    _jump_held(fd)
    _jump_held(fd, seeds)
    z, mask = _dem(shape, dev, seed=shape[1])
    filled, _, done = fill.fill_depressions_info(z, mask, eps=1e-3)
    assert done
    fd = flowdirs.d8_core(filled, mask)
    assert (_jump_held(fd) >= 0).all()
    _jump_held(fd, seeds)


def test_resolve_jump_is_the_sweeps_fixpoint(dev, succ_codes):
    """At 1000×1100, with and without codes off the grid (top row N, left
    column W): the kernels' labels and masks are the resolve sweeps'
    fixpoint on the card, bit for bit."""
    fd = succ_codes.clone()
    for outward in (False, True):
        if outward:
            fd[0, 1:][fd[0, 1:] >= 0] = 3
            fd[1:, 0][fd[1:, 0] >= 0] = 1
        for kind in ("watersheds", "upslope"):
            fd_eff, init, pinned = _resolve_start(fd, kind)
            want, _, done = successor.successor_resolve_info(fd_eff, init,
                                                             pinned)
            assert done
            if kind == "watersheds":
                assert torch.equal(_jump_held(fd), want)
            else:
                assert torch.equal(_jump_held(fd, init > 0), want > 0)


def _serpentine(n):
    """Each even row flows E and each odd row W, then S at the row's end;
    the path's last cell is the one terminal."""
    fd = np.empty((n, n), np.int8)
    fd[0::2], fd[1::2] = 5, 1
    fd[0::2, -1], fd[1::2, 0] = 7, 7
    fd[-1, -1 if n % 2 else 0] = 0
    return fd


def test_methods_take_the_jump_on_the_card(dev, succ_codes):
    """On a CUDA tensor the entry points run the jump and no sweep, report
    ``(0, "jump")`` and return the plain sweeps' fixpoint; a serpentine,
    past the sweeps' cap, needs no doubling; a cycle still raises."""
    fd = succ_codes
    _, seeds, _ = _resolve_start(fd, "upslope")
    seeds = seeds > 0
    before = successor.RESOLVE_SWEEP.launches
    labels, rot, engine = methods.watersheds_from_flowdirs(fd,
                                                           return_info=True)
    up, urot, uengine = methods.upslope_cells(seeds, fd, return_info=True)
    torch.cuda.synchronize()
    assert successor.RESOLVE_SWEEP.launches == before
    assert (rot, engine) == (urot, uengine) == (0, "jump")
    assert torch.equal(labels.cpu(), methods.watersheds_from_flowdirs(
        fd.cpu(), device="cpu"))
    assert torch.equal(up.cpu(), methods.upslope_cells(seeds.cpu(), fd.cpu(),
                                                       device="cpu"))
    serp = torch.from_numpy(_serpentine(2049)).to(dev)
    labels, rot, engine = methods.watersheds_from_flowdirs(serp,
                                                           return_info=True)
    assert (rot, engine) == (0, "jump")
    assert torch.equal(labels, methods.watersheds_doubling(serp))
    cyc = torch.zeros((8, 9), dtype=torch.int8, device=dev)
    cyc[2, 2], cyc[2, 3], cyc[3, 3], cyc[3, 2], cyc[1, 2] = 5, 7, 1, 3, 7
    with pytest.raises(ValueError, match="cycle: 5 cells"):
        methods.watersheds_from_flowdirs(cyc)


def test_tile_labels_take_the_jump_on_the_card(dev):
    """The two-pass fill's tile labels of a 256² tile with nodata holes,
    its top and left sides on the global edge: on the card the jump's
    kernels and no resolve sweep, bitwise the CPU's labels."""
    from richdem_tpu_torch.parallel.consumer import _labels_impl

    z, mask = _dem((256, 256), dev, seed=5)
    filled = fill.fill_depressions(torch.where(mask, -9999.0, z),
                                   no_data=-9999.0)
    fd = flats.resolve_flats(filled, flowdirs.d8_flowdirs(
        filled, no_data=-9999.0), no_data=-9999.0)
    ge = torch.zeros(fd.shape, dtype=torch.bool, device=dev)
    ge[0, :], ge[:, 0] = True, True
    sweeps_before = successor.RESOLVE_SWEEP.launches
    jumps_before = successor.RESOLVE_JUMP.launches
    lab = _labels_impl(mask, fd, ge)
    torch.cuda.synchronize()
    assert successor.RESOLVE_SWEEP.launches == sweeps_before
    assert successor.RESOLVE_JUMP.launches == jumps_before + 1
    want = _labels_impl(mask.cpu(), fd.cpu(), ge.cpu())
    assert torch.equal(lab.cpu(), want)
    assert (want == 0).any() and (want > 0).any()


def test_jump_refuses_a_grid_past_its_kernels(dev, succ_codes, monkeypatch):
    """A card grid that ``jump_fits`` refuses raises, through the jump
    and through both entries, and launches nothing."""
    fd = succ_codes
    seeds = _resolve_start(fd, "upslope")[1] > 0
    monkeypatch.setattr(successor, "jump_fits", lambda shape: False)
    before = successor.RESOLVE_JUMP.launches
    for call in (lambda: successor.successor_jump(fd),
                 lambda: successor.successor_jump(fd, seeds),
                 lambda: methods.watersheds_from_flowdirs(fd),
                 lambda: methods.upslope_cells(seeds, fd)):
        with pytest.raises(ValueError, match="2\\*\\*30"):
            call()
    assert successor.RESOLVE_JUMP.launches == before


#: One CTA (45 columns, a tall thin raster); a ragged last CTA (1100: 3
#: CTAs of 367, 367 and 366 columns); 16 CTAs, the last ragged (8300);
#: every thread of every CTA walking several columns (20000 and wider; at
#: 100000, 25 a thread and two ring stages).
SCAN_SHAPES = [(300, 1100), (48, 8300), (1030, 45), (20, 20000),
               (8, 40000), (6, 100000)]
SCAN_COSTS = [(0.0, 0.0), (1e-3, 1e-3), (0.0, sweeps.BIG / 2)]


def test_fill_scan_cluster_shapes(dev):
    """The widths of SCAN_SHAPES give every cluster shape: one CTA, a
    ragged last CTA, 16 CTAs, several columns a thread; a row too wide for
    shared memory raises, at the shape and at the launch."""
    shapes = {w: fill.fill_scan_shape(w) for w in (45, 1100, 8300, 10240,
                                                   40000, 100000)}
    assert shapes[45]["cluster"] == 1
    assert shapes[1100]["cluster"] == 3 and 1100 % shapes[1100][
        "segment"] != 0
    assert shapes[8300]["cluster"] == shapes[10240]["cluster"] == 16
    assert shapes[10240]["columns"] == 3
    assert shapes[40000]["columns"] > 3 and shapes[100000]["columns"] > 20
    for shape in shapes.values():
        assert shape["segment"] <= shape["threads"] * shape["columns"]
    with pytest.raises(ValueError):
        fill.fill_scan_shape(400000)
    z = torch.zeros((2, 400000), device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError):
        fill.fill_scan_sweep(z, z, 0.0, 0.0, False, flag)


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("costs", SCAN_COSTS, ids=["eps0", "eps1e-3", "D4"])
def test_fill_scan_kernel_matches_plain(dev, shape, costs):
    eps, eps_diag = costs
    z, mask = _dem(shape, dev, seed=7)
    neg = torch.tensor(-sweeps.BIG, device=dev)
    floor = torch.where(mask, neg, z)
    w = torch.where(mask, neg, torch.full_like(z, sweeps.BIG))
    for reverse in (False, True):
        fk = torch.zeros(1, dtype=torch.int32, device=dev)
        fp = torch.zeros(1, dtype=torch.int32, device=dev)
        before = fill.FILL_SCAN.launches
        wk = fill.fill_scan_sweep(w, floor, eps, eps_diag, reverse, fk)
        wp = sweeps.fill_scan_sweep_plain(w, floor, eps, eps_diag, reverse,
                                          fp)
        torch.cuda.synchronize()
        assert fill.FILL_SCAN.launches == before + 1
        assert torch.equal(wk, wp) and torch.equal(fk, fp)
        w = wk


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_fill_scan_fixpoint_matches_plain_and_folded(dev, eps):
    z, mask = _dem((260, 1300), dev, seed=8)
    got, it_k, done = fill.fill_depressions_info(z, mask, eps=eps,
                                                 engine="scan")
    neg = torch.tensor(-sweeps.BIG, device=dev)
    ref, it_p, done_p = sweeps.fill_scan_fixpoint_core(
        torch.where(mask, neg, torch.full_like(z, sweeps.BIG)),
        torch.where(mask, neg, z), float(np.float32(eps)), 256,
        sweeps.fill_scan_sweep_plain)
    assert done and done_p and it_k == it_p
    assert torch.equal(got, torch.where(mask, z, ref))
    folded, _, _ = fill.fill_depressions_info(z, mask, eps=eps,
                                              engine="folded")
    if eps == 0.0:
        assert torch.equal(got, folded)
    else:
        assert torch.allclose(got, folded, rtol=1e-6, atol=1e-4)


def test_fill_scan_matches_native(dev):
    from richdem_tpu_torch import native

    dem = synth_np.depression_dem(1024, 1100, seed=9, n_pits=12)
    got = fill.fill_depressions(torch.from_numpy(dem).to(dev),
                                engine="scan")
    want = native.fill(dem.astype(np.float64))
    assert np.array_equal(got.cpu().numpy().astype(np.float64), want)


# -- the row-ring sweeps (csrc/row_ring.cuh) --------------------------------

#: Widths that cut the last tile short, and give rows that are not 16-byte
#: aligned.
RING_WIDTHS = [1, 45, 127, 129, 1023, 1024, 1025, 2048, 2049, 3000]


def _unaligned(x, offset):
    """``x`` copied into a contiguous tensor that starts ``offset`` elements
    into its storage (``x`` itself when 0)."""
    if offset == 0:
        return x
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    out = buf[offset:].view(x.shape)
    out.copy_(x)
    return out


def _fill_case(shape, dev, seed):
    z, mask = _dem(shape, dev, seed=seed)
    neg = torch.tensor(-sweeps.BIG, device=dev)
    floor = torch.where(mask, neg, z)
    rng = np.random.default_rng(seed)
    lifted = torch.from_numpy(rng.random(shape) < 0.5).to(dev)
    w = torch.where(mask, neg, torch.where(
        lifted, z + 3.0, torch.full_like(z, sweeps.BIG)))
    return w, floor


def _accum_case(shape, dev, seed):
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(-1, 9, shape).astype(np.int8))
    w = torch.from_numpy(rng.uniform(0.5, 2.0, shape).astype(np.float32))
    acc = torch.from_numpy(rng.uniform(0.0, 50.0, shape).astype(np.float32))
    return acc.to(dev), w.to(dev), codes.to(dev)


def _fill_pair(w, floor, eps, reverse):
    fk = torch.zeros(1, dtype=torch.int32, device=w.device)
    fp = torch.zeros(1, dtype=torch.int32, device=w.device)
    got = fill.fill_sweep(w, floor, eps, eps, reverse, fk)
    want = sweeps.fill_sweep_plain(w, floor, eps, eps, reverse, fp)
    return got, want, fk, fp


@pytest.mark.parametrize("width", RING_WIDTHS)
@pytest.mark.parametrize("height", [1, 2, _build.SWEEP_STAGES + 1])
@pytest.mark.parametrize("offset", [0, 1])
def test_row_ring_sweeps_match_plain(dev, width, height, offset):
    """The fill and accumulation sweeps against their plain versions, down
    and up, with the fill's change flag; heights 1, 2 and one row past the
    ring.  Offset 0: inputs as allocated (16-byte aligned rows where the
    width allows, the float4 path of full tiles); offset 1: inputs that
    start 1, 2 and 3 elements into their storage (no row aligned)."""
    shape = (height, width)
    for kernel in (fill, accum):
        for reverse in (False, True):
            if kernel is fill:
                w, floor = _fill_case(shape, dev, seed=width + height)
                for eps in (0.0, 1e-3):
                    got, want, fk, fp = _fill_pair(
                        _unaligned(w, offset), _unaligned(floor, 2 * offset),
                        eps, reverse)
                    assert torch.equal(got, want) and torch.equal(fk, fp)
                # unchanged input: the flag stays 0
                fixed = torch.full_like(w, -sweeps.BIG)
                _, _, fk, fp = _fill_pair(fixed, fixed, 0.0, reverse)
                assert int(fk) == int(fp) == 0
            else:
                acc, w, codes = _accum_case(shape, dev, seed=width + height)
                got = accum.accum_sweep(_unaligned(acc, offset),
                                        _unaligned(w, 3 * offset),
                                        _unaligned(codes, 5 * offset),
                                        reverse)
                assert torch.equal(
                    got, accum.accum_sweep_plain(acc, w, codes, reverse))


def test_row_ring_sweeps_seam_rule_perlin(dev):
    """On a 2048×2100 Perlin DEM with nodata holes, a fill rotation (down,
    up, transposed down and up) and an accumulation sweep down and a
    transposed one up on its D8 codes equal the plain versions, which read
    every 1024-column seam at sweep-start values."""
    shape = (2048, 2100)
    z = tsynth.perlin_dem(*shape, seed=11, device=dev)
    holes = synth_np.with_nodata_holes(np.zeros(shape, np.float32),
                                       no_data=-1.0, seed=11)
    mask = torch.from_numpy(holes == -1.0).to(dev)
    assert 0 < int(mask.sum()) < mask.numel()
    neg = torch.tensor(-sweeps.BIG, device=dev)
    floor = torch.where(mask, neg, z)
    wk = wp = torch.where(mask, neg, torch.full_like(z, sweeps.BIG))
    floor_t = floor.t().contiguous()
    for transposed, reverse in ((False, False), (False, True),
                                (True, False), (True, True)):
        fl = floor_t if transposed else floor
        if transposed and wk.shape != fl.shape:
            wk, wp = wk.t().contiguous(), wp.t().contiguous()
        fk = torch.zeros(1, dtype=torch.int32, device=dev)
        fp = torch.zeros(1, dtype=torch.int32, device=dev)
        wk = fill.fill_sweep(wk, fl, 0.0, 0.0, reverse, fk)
        wp = sweeps.fill_sweep_plain(wp, fl, 0.0, 0.0, reverse, fp)
        assert torch.equal(wk, wp) and torch.equal(fk, fp)
    filled, _, done = fill.fill_depressions_info(z, mask, eps=1e-3)
    assert done
    fd = flowdirs.d8_core(filled, mask)
    ones = torch.where(mask, 0.0, torch.ones_like(z))
    ak = accum.accum_sweep(ones, ones, fd, False)
    assert torch.equal(ak, accum.accum_sweep_plain(ones, ones, fd, False))
    perm = torch.as_tensor(accum.PERM_TRANSPOSE, device=dev)
    fd_t = perm[fd.clamp(min=0).long()].t().contiguous()
    at, ones_t = ak.t().contiguous(), ones.t().contiguous()
    assert torch.equal(accum.accum_sweep(at, ones_t, fd_t, True),
                       accum.accum_sweep_plain(at, ones_t, fd_t, True))


D8_WIDTHS = [1, 2, 3, 5, 31, 33, 1023, 1025, 4099]


@pytest.mark.parametrize("width", D8_WIDTHS)
@pytest.mark.parametrize("offset", [0, 1])
def test_d8_tile_kernel_widths(dev, width, offset):
    """D8 and D4 codes of the shared-memory tile kernel equal ``d8_plain``
    at heights 1, 2 and 3, with nodata holes, many exact ties and cellsize
    3; offset 0 runs the 16-byte path where the width is a multiple of 4,
    offset 1 (inputs 1 element into their storage) the scalar path."""
    for height in (1, 2, 3):
        shape = (height, width)
        z, _ = _dem(shape, dev, seed=width + height)
        z = torch.round(z * 4) / 4
        rng = np.random.default_rng(width)
        mask = torch.from_numpy(rng.random(shape) < 0.1).to(dev)
        for topology in ("D8", "D4"):
            got = flowdirs.d8_core(_unaligned(z, offset),
                                   _unaligned(mask, 3 * offset), 3.0,
                                   topology)
            assert torch.equal(got, flowdirs.d8_plain(z, mask, 3.0,
                                                      topology))


@pytest.mark.parametrize("cellsize", [3.0, 1e-7])
def test_d8_tile_kernel_extreme_values(dev, cellsize):
    """Blocks whose values leave the fast division's range (zeros, values
    near the denormals or past 2^79, FLT_MAX as data, infinities, NaN) and
    a cellsize below its range take the division itself; codes equal
    ``d8_plain`` in D8 and D4 either way."""
    shape = (70, 300)
    rng = np.random.default_rng(4)
    z = rng.uniform(-5.0, 5.0, shape).astype(np.float32)
    z[::7, ::3] = 0.0
    z[3, :40] = rng.uniform(0, 1e-38, 40)
    z[40, 130:160] = rng.choice([1e30, -1e30, 3.4028235e38, np.inf, -np.inf,
                                 np.nan, 1e-30], 30)
    z[60:, 260:] = 2.0 ** -52
    mask = torch.from_numpy(rng.random(shape) < 0.05).to(dev)
    zt = torch.from_numpy(z).to(dev)
    for topology in ("D8", "D4"):
        got = flowdirs.d8_core(zt, mask, cellsize, topology)
        assert torch.equal(got, flowdirs.d8_plain(zt, mask, cellsize,
                                                  topology))


TERRAIN_ATAN = ("slope_radians", "slope_degrees", "aspect")


def _assert_terrain(got, ref, attrib):
    """NaN where the plain version has NaN; the other values bit for bit
    (the sign of zero included), the atan attributes within rtol 1e-6."""
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    if attrib in TERRAIN_ATAN:
        torch.testing.assert_close(got[~nan], ref[~nan], rtol=1e-6, atol=0)
    else:
        assert torch.equal(got[~nan].view(torch.int32),
                           ref[~nan].view(torch.int32))


@pytest.mark.parametrize("width", D8_WIDTHS)
@pytest.mark.parametrize("offset", [0, 1])
def test_terrain_tile_kernel_widths(dev, width, offset):
    """All 8 attributes of the terrain kernel on the shared-memory tile
    equal ``terrain_plain`` at heights 1, 2 and 3, with nodata holes, at
    (zscale, cellsize) (2, 3) and (1, 1); offset 0 runs the 16-byte path
    where the width is a multiple of 4, offset 1 the scalar path."""
    for height in (1, 2, 3):
        shape = (height, width)
        z, _ = _dem(shape, dev, seed=width + height)
        rng = np.random.default_rng(width)
        mask = torch.from_numpy(rng.random(shape) < 0.1).to(dev)
        zu, mu = _unaligned(z, offset), _unaligned(mask, 3 * offset)
        for zscale, cellsize in ((2.0, 3.0), (1.0, 1.0)):
            for attrib in terrain.TERRAIN_ATTRIBUTES:
                _assert_terrain(
                    terrain.terrain_fused(zu, mu, zscale, cellsize, attrib),
                    terrain.terrain_plain(z, mask, zscale, cellsize, attrib),
                    attrib)


RHO8_TILE_SEEDS = (0, 5, 2 ** 33 + 7)


@pytest.mark.parametrize("width", D8_WIDTHS)
@pytest.mark.parametrize("offset", [0, 1])
def test_rho8_tile_kernel_widths(dev, width, offset):
    """Rho8 and Rho4 codes of the shared-memory tile kernel equal
    ``rho8_plain`` on ``rho8_diagonal`` at heights 1, 2 and 3, with nodata
    holes and cellsize 3, for seeds whose key has a high word of 0 and of
    2; offsets as in the D8 tile test."""
    for height in (1, 2, 3):
        shape = (height, width)
        z, _ = _dem(shape, dev, seed=width + height)
        rng = np.random.default_rng(width)
        mask = torch.from_numpy(rng.random(shape) < 0.1).to(dev)
        zu, mu = _unaligned(z, offset), _unaligned(mask, 3 * offset)
        for seed in RHO8_TILE_SEEDS:
            diag = flowdirs.rho8_diagonal(shape, seed, dev)
            for topology in ("D8", "D4"):
                got = flowdirs.rho8_core(zu, mu, 3.0, seed, topology)
                assert torch.equal(got, flowdirs.rho8_plain(
                    z, mask, 3.0, diag, topology))


def _extreme_case(dev, edge):
    """A 70×300 raster whose 128×32 tiles hold values that leave the fast
    division's range (zeros are in it): denormals in tile (0, 0), values
    past 2^79, FLT_MAX as data, ±inf, NaN as data and 1e-30 in tile
    (1, 1), 2^-52 in tiles (1, 2) and (2, 2); and values on its edges,
    ±2^-50 and ±``edge``, in tile (2, 0); with nodata holes."""
    shape = (70, 300)
    rng = np.random.default_rng(4)
    z = rng.uniform(-5.0, 5.0, shape).astype(np.float32)
    z[::7, ::3] = 0.0
    z[3, :40] = rng.uniform(0, 1e-38, 40)
    z[40, 130:160] = rng.choice([1e30, -1e30, 3.4028235e38, np.inf, -np.inf,
                                 np.nan, 1e-30], 30)
    z[60:, 260:] = 2.0 ** -52
    z[65:69, 2:120] = rng.choice([2.0 ** -50, -2.0 ** -50, edge, -edge,
                                  0.0, 1.5], (4, 118))
    mask = torch.from_numpy(rng.random(shape) < 0.05).to(dev)
    return torch.from_numpy(z).to(dev), mask


@pytest.mark.parametrize("kind", ["terrain", "rho8"])
def test_stencil_tile_extreme_values(dev, kind):
    """Blocks whose values leave the fast division's range, and a cellsize
    below it (1e-7), take the division itself; a block at the range's
    edges takes the fast division.  Terrain (every attribute, zscale 1
    and 2) and Rho8 / Rho4 codes (two seeds) equal their plain versions
    either way."""
    if kind == "terrain":
        z, mask = _extreme_case(dev, 2.0 ** 77)
        for zscale, cellsize in ((1.0, 3.0), (2.0, 3.0), (1.0, 1e-7)):
            for attrib in terrain.TERRAIN_ATTRIBUTES:
                _assert_terrain(
                    terrain.terrain_fused(z, mask, zscale, cellsize, attrib),
                    terrain.terrain_plain(z, mask, zscale, cellsize, attrib),
                    attrib)
        return
    z, mask = _extreme_case(dev, 2.0 ** 79)
    for cellsize in (3.0, 1e-7):
        for seed in (0, 2 ** 33 + 7):
            diag = flowdirs.rho8_diagonal(z.shape, seed, dev)
            for topology in ("D8", "D4"):
                got = flowdirs.rho8_core(z, mask, cellsize, seed, topology)
                assert torch.equal(got, flowdirs.rho8_plain(
                    z, mask, cellsize, diag, topology))


def test_stencil_tile_shape(dev):
    """D8, Rho8 and terrain run on one tile: 32 rows by 128 columns, 256
    threads, 4×4 cells a thread."""
    assert flowdirs.stencil_tile_shape() == {
        "rows": 32, "cols": 128, "threads": 256, "cell_rows": 4,
        "cell_cols": 4}


def _flow_case(shape, dev, seed):
    """The packed D∞ field and the Quinn planes of an ε-filled Perlin DEM
    with nodata holes, float weights and a random start."""
    z, mask = _dem(shape, dev, seed=seed)
    filled, _, done = fill.fill_depressions_info(z, mask, eps=1e-2)
    assert done
    ang = torch.where(mask, -2.0, flowdirs.dinf_flowdirs(filled))
    v = dinf.pack_two_tap(*dinf.unpack_two_tap(dinf.pack_two_tap(
        *dinf.dinf_two_tap(ang)))).contiguous()
    props = flowdirs.flow_proportions(filled, "Quinn")
    planes = torch.where(mask, 0.0, props.permute(2, 0, 1)).contiguous()
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.uniform(0.5, 2.0, shape).astype(np.float32))
    acc = torch.from_numpy(rng.uniform(1.0, 50.0, shape).astype(np.float32))
    w = torch.where(mask, 0.0, w.to(dev))
    return acc.to(dev), w, {"dinf": v, "mfd": planes}


FLOW_KINDS = {"dinf": (dinf.dinf_sweep, dinf.dinf_sweep_plain),
              "mfd": (mfd.mfd_sweep, mfd.mfd_sweep_plain)}
WHOLE_ROW = 1 << 30  # a tile wider than any row: no seam


@pytest.mark.parametrize("shape", [(37, 1), (37, 45), (37, 257),
                                   (37, 1025), (37, 3000), (48, 8300)])
@pytest.mark.parametrize("kind", ["dinf", "mfd"])
def test_flow_sweeps_exact_seams(dev, shape, kind):
    """One tile, a ragged last tile and many tiles: each sweep, down and up,
    equals its plain version at the kernel's tile rule (depths 1, 2, 4, 8,
    16, 32 and 0: the one-barrier and the doubling scans) and, at every
    depth but 0, the plain sweep over whole rows, bitwise; so does the
    transposed sweep up at depths 8 and 0."""
    sweep, plain = FLOW_KINDS[kind]
    acc, w, fields = _flow_case(shape, dev, seed=shape[1])
    field = fields[kind]
    if kind == "dinf":
        field_t = field.t().contiguous()  # a valid field, not the transpose
    else:
        field_t = mfd.transpose_planes(field)
    for depth in (1, 2, 4, 8, 16, 32, 0):
        for reverse in (False, True):
            got = sweep(acc, w, field, reverse, depth)
            assert torch.equal(got, plain(acc, w, field, reverse, depth))
            if depth:
                assert torch.equal(got, plain(acc, w, field, reverse, depth,
                                              tile=WHOLE_ROW))
    at, wt = acc.t().contiguous(), w.t().contiguous()
    for depth in (8, 0):  # transposed: the height is the width
        assert torch.equal(sweep(at, wt, field_t, True, depth),
                           plain(at, wt, field_t, True, depth))


def test_flow_sweep_wider_than_resident_blocks(dev):
    """A raster with more tiles than the card holds blocks at once (each
    block then walks a run of tiles): a multi-flow and a D∞ sweep equal
    the plain sweep over whole rows at depth 8, down and up."""
    tiles = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    shape = (6, tiles * _build.FLOW_TILE + 77)
    acc, w, fields = _flow_case(shape, dev, seed=9)
    for kind, (sweep, plain) in FLOW_KINDS.items():
        for reverse in (False, True):
            got = sweep(acc, w, fields[kind], reverse, 8)
            assert torch.equal(got, plain(acc, w, fields[kind], reverse, 8,
                                          tile=WHOLE_ROW))


def test_quinn_fixpoint_matches_whole_rows(dev):
    """At 512² the kernel's Quinn fixpoint takes the rotations of the plain
    sweep over whole rows, and has its values."""
    z = tsynth.perlin_dem(512, 512, seed=0, device=dev)
    filled, _, done = fill.fill_depressions_info(z, eps=1e-2)
    assert done
    planes = flowdirs.flow_proportions(filled, "Quinn").permute(2, 0, 1)
    ones = torch.ones_like(z)
    got, rk, dk = mfd.mfd_accumulation_info(planes, ones)

    def whole(a, w, p, reverse, depth):
        return mfd.mfd_sweep_plain(a, w, p, reverse, depth, tile=WHOLE_ROW)

    ref, rp, dp = mfd.mfd_accumulation_info(planes, ones, sweep=whole)
    assert dk and dp and rk == rp
    assert torch.equal(got, ref)


def _topo_held(planes, w):
    """The topological pass's two kernels ↔ ``mfd_topo_plain``: the same
    count of cells left and, where none is, the same bits; a second launch
    gives the same bits again."""
    before = mfd.MFD_TOPO.launches
    got, left = mfd.mfd_topo(planes, w)
    again, left2 = mfd.mfd_topo(planes, w)
    torch.cuda.synchronize()
    assert mfd.MFD_TOPO.launches == before + 2
    ref, left_p = mfd.mfd_topo_plain(planes, w)
    assert left == left2 == left_p
    if not left:
        assert torch.equal(got, ref) and torch.equal(again, got)
    return got, left


@pytest.mark.parametrize("shape", SHAPES + [(1, 1), (1, 7), (5, 1)])
def test_mfd_topo_kernels_match_plain(dev, shape):
    """Quinn shares of an ε-filled Perlin DEM with nodata holes, float
    weights: bitwise the plain version, and the same bits twice."""
    _, w, fields = _flow_case(shape, dev, seed=shape[1])
    assert _topo_held(fields["mfd"], w)[1] == 0


def _quinn_512(dev):
    z = tsynth.perlin_dem(512, 512, seed=0, device=dev)
    filled, _, done = fill.fill_depressions_info(z, eps=1e-2)
    assert done
    planes = flowdirs.flow_proportions(filled, "Quinn").permute(2, 0, 1)
    return planes.contiguous(), torch.ones_like(z)


def test_mfd_topo_quinn_512(dev):
    """At 512² the topological pass is bitwise its plain version and runs
    no sweep through the entry point, whose result it is."""
    planes, ones = _quinn_512(dev)
    got, _ = _topo_held(planes, ones)
    before = mfd.MFD_SWEEP.launches
    acc, rot, done = mfd.mfd_accumulation(planes.permute(1, 2, 0),
                                          return_info=True)
    assert mfd.MFD_SWEEP.launches == before
    assert done and rot == 0 and torch.equal(acc, got)


def test_mfd_topo_falls_back_on_a_cycle(dev):
    """Four cells sending half their flow round a cycle: the pass leaves
    them and what lies downstream, the entry point runs the sweeps from
    A = w, and its result is theirs bit for bit; the rotation cap still
    governs there."""
    planes, ones = _quinn_512(dev)
    planes[:, 2:4, 2:4] *= 0.5
    for d, (r, c) in ((5, (2, 2)), (7, (2, 3)), (1, (3, 3)), (3, (3, 2))):
        planes[d - 1, r, c] += 0.5
    assert _topo_held(planes, ones)[1] > 4
    before = mfd.MFD_SWEEP.launches
    acc, rot, done = mfd.mfd_accumulation(planes.permute(1, 2, 0),
                                          return_info=True)
    assert mfd.MFD_SWEEP.launches > before
    ref, rr, dr = mfd.mfd_accumulation_info(planes, ones)
    assert done and dr and rot == rr >= 1
    assert torch.equal(acc, ref)
    with pytest.raises(RuntimeError, match="did not converge"):
        mfd.mfd_accumulation(planes.permute(1, 2, 0), max_rotations=1)


# -- the topological pass over the D8 codes ---------------------------------


def _d8_topo_held(fd, w):
    """The D8 pass's two kernels ↔ ``d8_topo_plain``: the same count of
    cells left and, where none is, the same bits; a second launch gives
    the same bits again."""
    before = accum.ACCUM_TOPO.launches
    got, left = accum.d8_topo(fd, w)
    again, left2 = accum.d8_topo(fd, w)
    torch.cuda.synchronize()
    assert accum.ACCUM_TOPO.launches == before + 2
    ref, left_p = accum.d8_topo_plain(fd, w)
    assert left == left2 == left_p
    if not left:
        assert torch.equal(got, ref) and torch.equal(again, got)
    return got, left


def _holed_codes(shape, dev, seed):
    """ε = 0 D8 codes of a Perlin DEM with nodata holes (-1), the first
    row's data cells pointing north, off the grid; and the nodata mask."""
    z, mask = _dem(shape, dev, seed=seed)
    filled, _, done = fill.fill_depressions_info(z, mask, eps=0.0)
    assert done
    fd = flowdirs.d8_core(filled, mask)
    fd[0] = torch.where(fd[0] >= 0, 3, fd[0]).to(fd.dtype)
    return fd, mask


@pytest.mark.parametrize("weights", ["unit", "float"])
@pytest.mark.parametrize("shape", SHAPES + [RAGGED_TOPO, (1, 1), (1, 7),
                                            (5, 1)])
def test_d8_topo_kernels_match_plain(dev, shape, weights):
    """Codes with nodata holes and off-grid targets, unit or float weights
    (zero at nodata): bitwise the plain version, and the same bits
    twice."""
    fd, mask = _holed_codes(shape, dev, seed=shape[1])
    rng = np.random.default_rng(shape[0])
    w = (torch.ones(shape) if weights == "unit" else torch.from_numpy(
        rng.uniform(0.1, 2.0, shape).astype(np.float32)))
    w = torch.where(mask, 0.0, w.to(dev))
    assert _d8_topo_held(fd, w)[1] == 0


@pytest.mark.parametrize("codes", ["d8", "resolved"])
@pytest.mark.parametrize("edge", [2048, 4096])
def test_d8_topo_entry_is_native_exact(dev, edge, codes):
    """The entry point on ε = 0 Perlin codes, before and after flat
    resolution: one pass, no sweep, ``(acc, 0, True)``, equal to the
    native engine's float64 queue in every cell (each sum an integer of
    at most 2²⁴)."""
    from richdem_tpu_torch import native

    z = tsynth.perlin_dem(edge, edge, seed=edge % 7, device=dev)
    mask = torch.zeros_like(z, dtype=torch.bool)
    filled, _, done = fill.fill_depressions_info(z, mask, eps=0.0)
    assert done
    fd = flowdirs.d8_core(filled, mask)
    if codes == "resolved":
        fd = flats.resolve_flats(filled, fd)
    ones = torch.ones_like(z)
    sweeps_before = accum.ACCUM_SWEEP.launches
    topo_before = accum.ACCUM_TOPO.launches
    acc, rot, done = accum.d8_accumulation_info(fd, ones)
    torch.cuda.synchronize()
    assert (rot, done) == (0, True)
    assert accum.ACCUM_SWEEP.launches == sweeps_before
    assert accum.ACCUM_TOPO.launches == topo_before + 1
    np.testing.assert_array_equal(acc.cpu().numpy(),
                                  native.accum_d8(fd.cpu().numpy()))


@pytest.fixture(scope="module")
def codes_10240(dev):
    """The 10240² seed-0 Perlin DEM's ε = 0 D8 codes, and the same codes
    after flat resolution."""
    z = tsynth.perlin_dem(10240, 10240, seed=0, device=dev)
    mask = torch.zeros_like(z, dtype=torch.bool)
    filled, _, done = fill.fill_depressions_info(z, mask, eps=0.0)
    assert done
    fd = flowdirs.d8_core(filled, mask)
    return {"d8": fd, "resolved": flats.resolve_flats(filled, fd)}


@pytest.mark.parametrize("codes", ["d8", "resolved"])
def test_d8_topo_10240_matches_plain(dev, codes_10240, codes):
    """At 10240², on the codes of both D8 cells of the benchmark: every
    cell solved, bitwise the plain version."""
    fd = codes_10240[codes]
    assert _d8_topo_held(fd, torch.ones(fd.shape, device=dev))[1] == 0


def test_d8_topo_falls_back_on_a_cycle(dev):
    """A four-cell cycle: the pass leaves its cells, the entry point runs
    the sweeps from A = w, and its result is theirs bit for bit; the
    rotation cap still governs there (a cycle of unit weights never
    converges)."""
    fd, mask = _holed_codes((300, 1025), dev, seed=6)
    for d, (r, c) in ((5, (2, 2)), (7, (2, 3)), (1, (3, 3)), (3, (3, 2))):
        fd[r, c] = d
    ones = torch.ones_like(fd, dtype=torch.float32)
    assert _d8_topo_held(fd, ones)[1] == 4
    before = accum.ACCUM_SWEEP.launches
    acc, rot, done = accum.d8_accumulation_info(fd, ones, 16)
    assert accum.ACCUM_SWEEP.launches > before
    ref, rr, dr = accum.d8_accumulation_sweeps(fd, ones, 16)
    assert (rot, done) == (rr, dr) == (16, False)
    assert torch.equal(acc, ref)
    with pytest.raises(RuntimeError, match="did not converge"):
        accum.d8_accumulation(fd, ones, max_rotations=16)


# -- the two-pass programs and the min-plus names -------------------------

TWOPASS_EDGE, TWOPASS_TILE = 1024, 256
TWOPASS_KERNELS = (fill.FILL_SWEEP, flowdirs.D8, flats.DIST_SWEEP,
                   successor.RESOLVE_JUMP, accum.ACCUM_TOPO)


@pytest.fixture(scope="module")
def twopass_disk(dev, tmp_path_factory):
    """A 1024² Perlin DEM with nodata holes on disk, and its in-core fill
    on the card."""
    d = tmp_path_factory.mktemp("twopass")
    z = tsynth.with_nodata_holes(
        tsynth.perlin_dem(TWOPASS_EDGE, TWOPASS_EDGE, seed=3, device=dev),
        seed=3, n_holes=6)
    np.save(d / "dem.npy", z.cpu().numpy())
    return d, z, fill.fill_depressions(z, no_data=-9999.0)


def test_twopass_fill_on_the_card(dev, twopass_disk):
    """Two data passes of the device consumer at 1024², tile 256: bitwise
    the in-core fill and the native consumer's, through the path's
    kernels."""
    from richdem_tpu_torch.parallel.outofcore import out_of_core_fill

    d, _, want = twopass_disk
    before = [k.launches for k in TWOPASS_KERNELS]
    stats = {}
    got = np.load(out_of_core_fill(str(d / "dem.npy"), str(d / "f.npy"),
                                   tile=TWOPASS_TILE, no_data=-9999.0,
                                   stats=stats))
    assert stats["consumer"] == "device" and stats["data_passes"] == 2
    assert all(k.launches > b for k, b in zip(TWOPASS_KERNELS[:4],
                                              before[:4]))
    np.testing.assert_array_equal(got, want.cpu().numpy())
    native = np.load(out_of_core_fill(
        str(d / "dem.npy"), str(d / "n.npy"), tile=TWOPASS_TILE,
        no_data=-9999.0, consumer="native"))
    np.testing.assert_array_equal(native, got)


@pytest.mark.parametrize("method", ["twopass", "schwarz"])
def test_twopass_accum_on_the_card(dev, twopass_disk, method):
    """D8 accumulation of the fill's codes at 1024², tile 256, through the
    topological pass on each tile: bitwise the in-core accumulation (every
    sum an integer below 2²⁴)."""
    from richdem_tpu_torch.parallel.outofcore import out_of_core_accum_d8

    d, _, filled = twopass_disk
    fd = flowdirs.d8_flowdirs(filled, no_data=-9999.0)
    np.save(d / "fd.npy", fd.cpu().numpy())
    want = accum.d8_accumulation(fd, weights=torch.where(fd < 0, 0.0, 1.0))
    before = accum.ACCUM_TOPO.launches
    stats = {}
    got = np.load(out_of_core_accum_d8(
        str(d / "fd.npy"), out_path=str(d / f"a_{method}.npy"),
        tile=TWOPASS_TILE, method=method, stats=stats))
    assert accum.ACCUM_TOPO.launches > before
    if method == "twopass":
        assert stats["data_passes"] == 2
    np.testing.assert_array_equal(got, want.cpu().numpy())


def test_schwarz_epsilon_fill_on_the_card(dev, twopass_disk):
    """ε = 1e-3 by Schwarz sweeps at 1024², tile 256: bitwise the in-core
    folded ε-fill from BIG (both are the greatest fixpoint below BIG)."""
    from richdem_tpu_torch.parallel.outofcore import out_of_core_fill

    d, z, _ = twopass_disk
    got = np.load(out_of_core_fill(str(d / "dem.npy"), str(d / "e.npy"),
                                   tile=TWOPASS_TILE, eps=1e-3,
                                   no_data=-9999.0))
    want, _, done = fill.fill_depressions_info(
        z, z == -9999.0, eps=1e-3, w0=torch.full_like(z, sweeps.BIG))
    assert done
    np.testing.assert_array_equal(got, want.cpu().numpy())


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_minplus_fill_shape_runs_the_fill_kernel(dev, eps):
    """A scalar cost with a draining boundary on the card runs the fill
    kernel and reaches the plain min-plus fixpoint: bitwise at ε = 0,
    within 1e-4 at ε = 1e-3."""
    z, mask = _dem((300, 1025), dev, seed=4)
    neg = torch.tensor(-sweeps.BIG, device=dev)
    floor = torch.where(mask, neg, z)
    w0 = torch.where(mask, neg, torch.full_like(z, sweeps.BIG))
    before = fill.FILL_SWEEP.launches
    got, _, done = sweeps.minplus_fixpoint(w0, floor, eps, -sweeps.BIG)
    assert done and fill.FILL_SWEEP.launches > before
    ref, _, done = sweeps.minplus_fixpoint(w0.cpu(), floor.cpu(), eps,
                                           -sweeps.BIG)
    assert done
    if eps == 0.0:
        assert torch.equal(got.cpu(), ref)
    else:
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-4)


def test_minplus_general_costs_on_the_card(dev):
    """Per-direction costs and a non-draining boundary run the plain
    min-plus code on the card: bitwise the CPU's, and so are one sweep
    and one Jacobi step."""
    rng = np.random.default_rng(6)
    big = sweeps.BIG
    costs = torch.from_numpy(np.where(rng.random((8, 60, 75)) < 0.2, big,
                                      1.0).astype(np.float32))
    seeds = torch.from_numpy(np.where(rng.random((60, 75)) < 0.05, 0.0,
                                      big).astype(np.float32))
    floor = torch.full_like(seeds, -big)
    got = sweeps.minplus_fixpoint_core(seeds.to(dev), -big, costs.to(dev),
                                       big)
    ref = sweeps.minplus_fixpoint_core(seeds, -big, costs, big)
    assert got[1:] == ref[1:] and ref[2]
    assert torch.equal(got[0].cpu(), ref[0])
    for name in ("minplus_sweep_once", "jacobi_step"):
        fn = getattr(sweeps, name)
        assert torch.equal(
            fn(seeds.to(dev), floor.to(dev), costs.to(dev), big).cpu(),
            fn(seeds, floor, costs, big))


# -- the sharded mesh ---------------------------------------------------------

SHARDED_SHAPE = (1024, 1100)  # extended blocks 514×552 on a 2×2 mesh


def _same(a, b):
    """Bitwise equal, NaN where the other has NaN (slope at nodata)."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan], b[~nan]))


@pytest.fixture(scope="module")
def sharded_dem(dev):
    """A 1024×1100 Perlin DEM with nodata holes on the card, its mask, and
    a 2×2 mesh whose four positions are all ``cuda:0``."""
    from richdem_tpu_torch.parallel import make_mesh

    z, mask = _dem(SHARDED_SHAPE, dev, seed=8)
    return z, mask, make_mesh([dev] * 4, (2, 2))


def test_sharded_pipeline_on_the_card(dev, sharded_dem):
    """ε = 1e-3 over the 2×2 mesh through the fill, D8, topological
    accumulation and terrain kernels on 514×552 extended blocks: the fill
    bitwise the in-core fill from BIG (and ``fill_epsilon`` from its
    multigrid start), codes, accumulation (integer sums below 2²⁴) and
    slope bitwise the in-core ops."""
    from richdem_tpu_torch.parallel import sharded_pipeline

    z, mask, mesh = sharded_dem
    names = ("fill_sweep", "d8", "accum_topo", "terrain")
    ks = [fill.FILL_SWEEP, flowdirs.D8, accum.ACCUM_TOPO, terrain.TERRAIN]
    before = [k.launches for k in ks]
    stats = {}
    out = sharded_pipeline(z, mesh=mesh, eps=1e-3, nodata_mask=mask,
                           stats=stats)
    launched = {n: k.launches - b for n, k, b in zip(names, ks, before)}
    assert all(v > 0 for v in launched.values()), launched
    assert stats["fill_outer_iters"] >= 2
    want, _, done = fill.fill_depressions_info(
        z, mask, eps=1e-3, w0=torch.full_like(z, sweeps.BIG))
    assert done
    assert torch.equal(out["filled"], want)
    fd = flowdirs.d8_core(want, mask)
    assert torch.equal(out["flowdirs"], fd)
    acc = accum.d8_accumulation(fd, no_data_mask=mask)
    assert float(acc.max()) < 2.0 ** 24
    assert torch.equal(out["accum"], acc)
    assert _same(out["slope"], terrain.terrain_fused(
        want, mask, 1.0, 1.0, "slope_radians"))


def test_sharded_twopass_on_the_card(dev, sharded_dem):
    """The two-pass fill and accumulation over the 2×2 mesh: two data
    passes each, bitwise the Schwarz fill at ε = 0 and the Schwarz
    accumulation."""
    from richdem_tpu_torch.parallel import (sharded_accumulation_d8,
                                            sharded_accumulation_d8_twopass,
                                            sharded_fill,
                                            sharded_fill_twopass)

    z, mask, mesh = sharded_dem
    dem = torch.where(mask, -9999.0, z)
    stats = {}
    two = sharded_fill_twopass(dem, mesh=mesh, no_data=-9999.0, stats=stats)
    assert stats["data_passes"] == 2
    schwarz = sharded_fill(dem, mesh=mesh, nodata_mask=mask)
    assert torch.equal(two, schwarz)
    fd = flowdirs.d8_core(schwarz, mask)
    stats = {}
    acc2 = sharded_accumulation_d8_twopass(fd, mesh=mesh, no_data_mask=mask,
                                           stats=stats)
    assert stats["data_passes"] == 2
    assert torch.equal(acc2, sharded_accumulation_d8(fd, mesh=mesh,
                                                     no_data_mask=mask))


def test_sharded_mfd_on_the_card(dev, sharded_dem):
    """Quinn accumulation over the 2×2 mesh through the multi-flow kernel:
    within rtol 2e-5, atol 1e-4 of the in-core accumulation."""
    from richdem_tpu_torch.parallel import sharded_accumulation_mfd

    z, mask, mesh = sharded_dem
    filled = fill.fill_depressions(z[:512, :512], eps=1e-3)
    props = flowdirs.flow_proportions(filled, "Quinn")
    before = mfd.MFD_SWEEP.launches
    got = sharded_accumulation_mfd(props, mesh=mesh)
    assert mfd.MFD_SWEEP.launches > before
    torch.testing.assert_close(got, accum.flow_accumulation_from_props(props),
                               rtol=2e-5, atol=1e-4)


def test_sharded_pipeline_one_rank_nccl(dev, sharded_dem):
    """Through a one-rank NCCL group every halo and flag travels by
    collectives on the card: bitwise the in-process result."""
    import socket

    import torch.distributed as dist

    from richdem_tpu_torch.parallel import make_mesh, sharded_pipeline

    z, mask, local = sharded_dem
    z, mask = z[:256, :300].contiguous(), mask[:256, :300].contiguous()
    want = sharded_pipeline(z, mesh=local, eps=1e-3, nodata_mask=mask)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh([dev] * 4, (2, 2))
        assert mesh.group is not None
        got = sharded_pipeline(z, mesh=mesh, eps=1e-3, nodata_mask=mask)
    finally:
        dist.destroy_process_group()
    for key in want:
        assert _same(got[key], want[key]), key
