"""The port's scan fill engine (plain version of ``csrc/fill_scan.cu``) ↔
the JAX reference.

Same DEM (numpy, seeded, float32) through both sides.  At ε = 0 every step
is a min/max selection and the acceptance guard is 0, so the scan engine is
bitwise the JAX scan engine (``pallas_scan.fill_fixpoint_scan`` in
interpret mode, with the small fold thresholds of
tests/test_pallas_scan.py), the port's folded engine and the JAX XLA fill.
At ε > 0 the tilted chains round differently from per-edge steps and the
guard's ``t_max`` is the port's unpadded ``(W − 1)·ε``: rtol 1e-6,
atol 1e-4 (the tolerance of tests/test_pallas_scan.py), and atol 1e-2
against the float64 oracle on the serpentine pit.
"""

import heapq

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from richdem_tpu import api as jax_api
from richdem_tpu import oracle, synth
from richdem_tpu.grid import rdarray as jax_rdarray
from richdem_tpu.ops import pallas_folded, pallas_scan
from richdem_tpu.ops.fill import fill_depressions_info as jax_fill_info
import richdem_tpu_torch as rt
from richdem_tpu_torch import convert
from richdem_tpu_torch.ops import fill as tfill
from richdem_tpu_torch.ops import sweeps as tsweeps

torch.set_num_threads(1)

ND = -9999.0
FOLD = dict(fold_min=8, fold_pad=64)
#: ε > 0 tolerance between engines (tests/test_pallas_scan.py)
RTOL, ATOL = 1e-6, 1e-4


@pytest.fixture()
def interpret_mode():
    """Pallas interpret mode off-TPU + small strips (the fixture of
    tests/test_pallas_scan.py, cache clearing included)."""
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
        pallas_scan._fill_scan_impl.clear_cache()


def _dem(h, w, seed, holes=True):
    dem = synth.depression_dem(h, w, seed=seed, dtype=np.float32)
    if holes:
        dem = synth.with_nodata_holes(dem, no_data=ND, seed=seed)
    return dem


def _port(dem, eps, engine="scan", **kw):
    z, m = convert.from_numpy(dem, ND, device="cpu")
    filled, iters, done = tfill.fill_depressions_info(z, m, eps=eps,
                                                      engine=engine, **kw)
    assert done
    return filled.numpy(), iters


def serpentine_pit(n):
    """tests/test_pallas_scan.py's walled serpentine pit: the only outlet is
    a notch above the path start, and the channel descends along the whole
    path, so the ε-fill level chains cell by cell from the notch."""
    z = np.full((n, n), 1e6, np.float32)
    z[0, 1] = 0.5
    val = 0.0
    for k, r in enumerate(range(1, n - 1, 2)):
        cols = (range(1, n - 1) if k % 2 == 0 else range(n - 2, 0, -1))
        for c in cols:
            z[r, c] = val
            val -= 1.0
        if r + 2 < n - 1:
            z[r + 1, (n - 2) if k % 2 == 0 else 1] = val
            val -= 1.0
    return z


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_scan_vs_jax_scan_engine(eps, interpret_mode):
    """64×72: bitwise at ε = 0, within RTOL/ATOL at ε = 1e-3."""
    dem = synth.depression_dem(64, 72, seed=5, dtype=np.float32)
    got, it = _port(dem, eps)
    want, wit, wdone = pallas_scan.fill_fixpoint_scan(
        dem, eps=eps, multiscale=False, **FOLD)
    assert bool(wdone)
    if eps == 0.0:
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    assert it <= int(wit) + 1


def test_scan_never_fills_below_the_dem(interpret_mode):
    """Untilting a chain value clamped at the floor, (fr − t) + t, can round
    an ulp below the floor; the reference's scan engine returns such cells
    below the DEM (tens of cells here, at the auto ε of a Perlin DEM with
    nodata holes), the port keeps them at the floor.  Elsewhere the two
    agree within RTOL/ATOL."""
    dem = synth.with_nodata_holes(
        synth.perlin_dem(64, 72, seed=0, dtype=np.float32), no_data=ND,
        seed=0)
    eps = rt.auto_epsilon(dem)
    got, _ = _port(dem, eps)
    want, _, wdone = pallas_scan.fill_fixpoint_scan(
        dem, nodata_mask=dem == ND, eps=eps, multiscale=False, **FOLD)
    want = np.asarray(want)
    assert bool(wdone)
    assert (want < dem).sum() > 0
    assert (got >= dem).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hw", [(40, 57), (72, 50), (33, 130)])
def test_scan_vs_folded_and_xla(hw):
    """Non-square DEMs with nodata holes: the scan engine equals the folded
    engine and the JAX XLA fill bitwise at ε = 0, within RTOL/ATOL at
    ε = 1e-3; nodata cells come back unchanged."""
    dem = _dem(*hw, seed=sum(hw))
    nd = dem == ND
    for eps in (0.0, 1e-3):
        got, _ = _port(dem, eps)
        folded, _ = _port(dem, eps, engine="folded")
        xla, _, xdone = jax_fill_info(jnp.asarray(dem), jnp.asarray(nd),
                                      eps=eps)
        assert bool(xdone)
        np.testing.assert_array_equal(got[nd], dem[nd])
        if eps == 0.0:
            np.testing.assert_array_equal(got, folded)
            np.testing.assert_array_equal(got, np.asarray(xla))
        else:
            np.testing.assert_allclose(got, folded, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got, np.asarray(xla), rtol=RTOL,
                                       atol=ATOL)


def _chain(lo, hi, reverse):
    """The clamp chain one cell at a time (float32 throughout)."""
    out = np.empty_like(lo)
    x = np.float32(-tsweeps.BIG)
    order = range(len(lo) - 1, -1, -1) if reverse else range(len(lo))
    for j in order:
        x = min(max(x, lo[j]), hi[j])
        out[j] = x
    return out


@pytest.mark.parametrize("reverse", [False, True])
def test_clamp_scan_chunks_bitwise(reverse):
    """The Hillis–Steele clamp scan over the whole row, over chunks of 7
    and of 64 columns with the chain value carried, and the cell-by-cell
    chain give the same bits (crossed maps, lo > hi, included)."""
    rng = np.random.default_rng(3)
    n = 300
    lo = rng.normal(0, 10, n).astype(np.float32)
    hi = (lo + rng.uniform(-2, 30, n)).astype(np.float32)
    want = _chain(lo, hi, reverse)
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    for chunk in (None, 7, 64):
        got = tsweeps.clamp_scan_plain(lo_t, hi_t, reverse, chunk)
        np.testing.assert_array_equal(got.numpy(), want)


def test_scan_sweep_chunks_bitwise():
    """One sweep each way at ε = 1e-3 does not depend on the chunk width,
    and its flag says whether anything changed."""
    dem = _dem(30, 90, seed=4)
    z, m = convert.from_numpy(dem, ND, device="cpu")
    neg = torch.tensor(-tsweeps.BIG)
    floor = torch.where(m, neg, z)
    w = torch.where(m, neg, torch.full_like(z, tsweeps.BIG))
    for reverse in (False, True):
        outs = []
        for chunk in (None, 16, 41):
            flag = torch.zeros(1, dtype=torch.int32)
            outs.append(tsweeps.fill_scan_sweep_plain(
                w, floor, 1e-3, 1e-3, reverse, flag, chunk=chunk))
            assert int(flag) == 1
        assert all(torch.equal(outs[0], o) for o in outs[1:])
        w = outs[0]
    fixed, _, _ = tfill.fill_depressions_info(z, m, eps=1e-3, engine="scan")
    flag = torch.zeros(1, dtype=torch.int32)
    again = tsweeps.fill_scan_sweep_plain(
        torch.where(m, neg, fixed), floor, 1e-3, 1e-3, False, flag)
    assert int(flag) == 0 and torch.equal(again, torch.where(m, neg, fixed))


def test_serpentine_pit_converges_fast():
    """On the walled serpentine pit (64²) the scan engine converges in at
    most 4 rotations of 2 sweeps, at least 10× fewer dispatches than the
    folded engine's rotations of 4 sweeps and 2 transposes, and both match
    the float64 oracle to atol 1e-2."""
    dem = serpentine_pit(64)
    want = oracle.priority_flood_epsilon(dem.astype(np.float64), eps=1e-3)
    got_s, it_s = _port(dem, 1e-3, max_iters=256)
    got_f, it_f = _port(dem, 1e-3, engine="folded", max_iters=256)
    np.testing.assert_allclose(got_s, want, atol=1e-2)
    np.testing.assert_allclose(got_f, want, atol=1e-2)
    assert it_s <= 4
    assert it_s * 2 * 10 <= it_f * 6


def test_multigrid_warm_start_composes_with_scan(monkeypatch):
    """From edge MULTISCALE_MIN (lowered to 64 here) the scan sweeps start
    from the multigrid upper bound and reach the folded engine's fixpoint:
    bitwise at ε = 0, within RTOL/ATOL at ε = 1e-3."""
    dem = synth.depression_dem(96, 128, seed=11, dtype=np.float32)
    calls = []
    warm = tfill._coarse_warm_start

    def counted(*args, **kw):
        calls.append(1)
        return warm(*args, **kw)

    monkeypatch.setattr(tfill, "MULTISCALE_MIN", 64)
    monkeypatch.setattr(tfill, "_coarse_warm_start", counted)
    for eps in (0.0, 1e-3):
        got, _ = _port(dem, eps)
        want, _ = _port(dem, eps, engine="folded", w0=torch.full(
            dem.shape, tsweeps.BIG))
        if eps == 0.0:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert len(calls) == 2


def test_engine_env_dispatch(monkeypatch):
    """``RICHDEM_TPU_FILL_ENGINE`` picks the engine per call (default
    folded) for every call site: the fill entry points, the pipeline and
    the API; ``engine=`` overrides it; an unknown name raises."""
    swept = []
    scan_sweep = tfill.fill_scan_sweep

    def counted(*args):
        swept.append(1)
        return scan_sweep(*args)

    monkeypatch.setattr(tfill, "fill_scan_sweep", counted)
    dem = _dem(24, 30, seed=2)
    z, m = convert.from_numpy(dem, ND, device="cpu")
    monkeypatch.delenv("RICHDEM_TPU_FILL_ENGINE", raising=False)
    assert tfill.fill_engine() == "folded"
    folded = tfill.fill_depressions(z, no_data=ND)
    pipe_folded = rt.make_pipeline(z.shape, eps=0.0, no_data=ND)(z)
    assert not swept
    monkeypatch.setenv("RICHDEM_TPU_FILL_ENGINE", "scan")
    assert tfill.fill_engine() == "scan"
    assert torch.equal(tfill.fill_depressions(z, no_data=ND), folded)
    n = len(swept)
    assert n >= 2
    pipe = rt.make_pipeline(z.shape, eps=0.0, no_data=ND)(z)
    assert len(swept) > n
    for key in ("filled", "flowdirs", "accum"):
        assert torch.equal(pipe[key], pipe_folded[key])
    api = rt.FillDepressions(rt.rdarray(z, no_data=ND))
    assert torch.equal(api.tensor(), folded)
    n = len(swept)
    tfill.fill_depressions(z, no_data=ND, engine="folded")
    assert len(swept) == n
    monkeypatch.setenv("RICHDEM_TPU_FILL_ENGINE", "tiled")
    with pytest.raises(ValueError, match="fill engine"):
        tfill.fill_depressions(z)


def _d4_priority_flood(z):
    """Plain D4 Priority-Flood (float64): the border seeds the queue, each
    cell floods its four neighbours, which take max(own, level)."""
    h, w = z.shape
    out = z.astype(np.float64).copy()
    done = np.zeros((h, w), bool)
    heap = []
    for r in range(h):
        for c in range(w):
            if r in (0, h - 1) or c in (0, w - 1):
                heapq.heappush(heap, (out[r, c], r, c))
                done[r, c] = True
    while heap:
        level, r, c = heapq.heappop(heap)
        for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            nr, nc = r + dr, c + dc
            if 0 <= nr < h and 0 <= nc < w and not done[nr, nc]:
                done[nr, nc] = True
                out[nr, nc] = max(out[nr, nc], level)
                heapq.heappush(heap, (out[nr, nc], nr, nc))
    return out


@pytest.mark.parametrize("engine", ["folded", "scan"])
def test_d4_fill(engine):
    """Diagonals priced out at BIG / 2 (the reference's TPU D4 fill): both
    engines equal a D4 Priority-Flood and, on a positive DEM, the JAX
    API's D4 fill (its CPU min-plus path), bitwise at ε = 0."""
    dem = synth.depression_dem(40, 46, seed=7, dtype=np.float32) + 1.0
    assert (dem > 0).all()
    got = tfill.fill_depressions(torch.from_numpy(dem), eps=0.0,
                                 eps_diag=tsweeps.BIG / 2, engine=engine)
    np.testing.assert_array_equal(got.numpy(),
                                  _d4_priority_flood(dem).astype(np.float32))
    want = jax_api.FillDepressions(jax_rdarray(dem), topology="D4").np()
    np.testing.assert_array_equal(got.numpy(), want)
    d8 = tfill.fill_depressions(torch.from_numpy(dem), engine=engine)
    assert bool((got >= d8).all()) and not torch.equal(got, d8)


def test_scan_cap_and_nodata():
    """A cap too small is reported, never hidden; at the fixpoint one
    rotation confirms it."""
    dem = _dem(48, 40, seed=13)
    z, m = convert.from_numpy(dem, ND, device="cpu")
    filled, iters, done = tfill.fill_depressions_info(z, m, engine="scan")
    assert done and iters >= 1
    again, iters2, done2 = tfill.fill_depressions_info(z, m, w0=filled,
                                                       engine="scan")
    assert done2 and iters2 == 1 and torch.equal(again, filled)
    _, iters1, done1 = tfill.fill_depressions_info(z, m, max_iters=1,
                                                   engine="scan")
    assert iters1 == 1 and not done1
    with pytest.raises(RuntimeError, match="did not converge"):
        tfill.fill_depressions(z, no_data=ND, max_iters=1, engine="scan")
