"""The plain reference against brute-force loops written from the
definitions, on small grids with and without nodata."""

import heapq
import math

import numpy as np
import pytest
import torch

from perfbench import synth
from perfbench.reference import fill, flow, terrain
from perfbench.reference.grid import DIRECTIONS, DR, DX, DY

ND = -9999.0


def _dem(h, w, seed, holes):
    z = synth.perlin_dem(h, w, seed=seed, octaves=4, device="cpu")
    z = z + torch.rand(h, w, generator=torch.Generator().manual_seed(seed))
    if holes:
        z = synth.with_nodata_holes(z, no_data=ND, seed=seed, n_holes=3)
    return z, z == ND


def _neighbours(r, c, h, w):
    for d in DIRECTIONS:
        rr, cc = r + DY[d], c + DX[d]
        if 0 <= rr < h and 0 <= cc < w:
            yield d, rr, cc


def _priority_flood(z, nodata, eps):
    """Barnes et al. (2014) Priority-Flood in float32: the edges and the
    cells beside nodata seed the queue; a neighbour is raised to at least
    ``fl(W + eps)`` of the cell that reaches it."""
    h, w = z.shape
    zz = z.numpy().astype(np.float32)
    nd = nodata.numpy()
    out = zz.copy()
    done = np.zeros((h, w), bool)
    queue = []
    for r in range(h):
        for c in range(w):
            if nd[r, c]:
                done[r, c] = True
                continue
            edge = r in (0, h - 1) or c in (0, w - 1) or any(
                nd[rr, cc] for _, rr, cc in _neighbours(r, c, h, w))
            if edge:
                done[r, c] = True
                heapq.heappush(queue, (float(zz[r, c]), r, c))
    e = np.float32(eps)
    while queue:
        v, r, c = heapq.heappop(queue)
        for _, rr, cc in _neighbours(r, c, h, w):
            if not done[rr, cc]:
                done[rr, cc] = True
                out[rr, cc] = max(zz[rr, cc], np.float32(v) + e)
                heapq.heappush(queue, (float(out[rr, cc]), rr, cc))
    return torch.from_numpy(out)


@pytest.mark.parametrize("holes", [False, True])
def test_flat_fill_is_priority_flood(holes):
    z, nodata = _dem(37, 45, 3, holes)
    want = _priority_flood(z, nodata, 0.0)
    assert torch.equal(fill.fill_flat(z, nodata), want)


@pytest.mark.parametrize("holes", [False, True])
def test_residual_accepts_the_epsilon_fill_and_nothing_else(holes):
    z, nodata = _dem(37, 45, 4, holes)
    filled = _priority_flood(z, nodata, 1e-2)
    assert fill.fixpoint_residual(filled, z, nodata, 1e-2) == {
        "residual": 0, "unresolved": 0}
    low = filled.clone()
    low[18, 20] = z[18, 20]  # a pit left unfilled, or a cell lowered
    low[10, 30] = torch.nextafter(filled[10, 30], torch.tensor(-1e9))
    assert fill.fixpoint_residual(low, z, nodata, 1e-2)["residual"] > 0
    assert fill.fixpoint_residual(z, z, nodata, 1e-2)["residual"] > 0
    # an epsilon below half an ulp raises nothing: uniqueness is not shown
    assert fill.fixpoint_residual(filled + 1e6, z + 1e6, nodata,
                                  1e-3)["unresolved"] > 0


def _codes_loop(z, nodata):
    h, w = z.shape
    zz = z.numpy().astype(np.float32)
    out = np.zeros((h, w), np.int8)
    for r in range(h):
        for c in range(w):
            if nodata[r, c]:
                out[r, c] = -1
                continue
            best, code = None, 0
            for d, rr, cc in _neighbours(r, c, h, w):
                if nodata[rr, cc]:
                    continue
                s = (zz[r, c] - zz[rr, cc]) / np.float32(DR[d])
                if best is None or s > best:
                    best, code = s, d
            out[r, c] = code if best is not None and best > 0 else 0
    return torch.from_numpy(out)


def _accum_loop(codes, weights):
    h, w = codes.shape
    acc = np.zeros((h, w))
    for r in range(h):
        for c in range(w):
            rr, cc = r, c
            while True:
                acc[rr, cc] += float(weights[r, c])
                d = int(codes[rr, cc])
                if d <= 0:
                    break
                rr, cc = rr + DY[d], cc + DX[d]
    return torch.from_numpy(acc)


@pytest.mark.parametrize("holes", [False, True])
def test_d8_codes_and_accumulation_are_the_loops(holes):
    z, nodata = _dem(29, 33, 5, holes)
    filled = fill.fill_flat(z, nodata)
    codes = flow.d8_codes(filled, nodata)
    assert torch.equal(codes, _codes_loop(filled, nodata))
    weights = (~nodata).double()
    acc = flow.d8_accumulation(codes, weights)
    assert torch.equal(acc, _accum_loop(codes, weights))


def _quinn_loop(z, nodata):
    h, w = z.shape
    zz = z.numpy().astype(np.float64)
    out = np.zeros((8, h, w))
    for r in range(h):
        for c in range(w):
            if nodata[r, c]:
                continue
            for d, rr, cc in _neighbours(r, c, h, w):
                if not nodata[rr, cc]:
                    out[d - 1, r, c] = max((zz[r, c] - zz[rr, cc]) / DR[d],
                                           0.0)
            total = out[:, r, c].sum()
            if total > 0:
                out[:, r, c] /= total
    return torch.from_numpy(out)


def _mfd_loop(planes, z, nodata):
    """Accumulation in order of falling elevation: every share flows to
    a strictly lower neighbour, so its senders are done first."""
    _, h, w = planes.shape
    acc = (~nodata).double().numpy().copy()
    for i in np.argsort(-z.numpy().astype(np.float64), axis=None,
                        kind="stable"):
        r, c = divmod(int(i), w)
        for d, rr, cc in _neighbours(r, c, h, w):
            acc[rr, cc] += acc[r, c] * float(planes[d - 1, r, c])
    return torch.from_numpy(acc)


@pytest.mark.parametrize("holes", [False, True])
def test_quinn_shares_and_accumulation_are_the_loops(holes):
    z, nodata = _dem(29, 33, 6, holes)
    filled = _priority_flood(z, nodata, 1e-2)
    planes = flow.quinn_planes(filled, nodata)
    want = _quinn_loop(filled, nodata)
    torch.testing.assert_close(planes, want, rtol=1e-12, atol=1e-15)
    acc = flow.mfd_accumulation(planes, (~nodata).double())
    torch.testing.assert_close(acc, _mfd_loop(planes, filled, nodata),
                               rtol=1e-12, atol=1e-12)


def test_mfd_accumulation_raises_on_a_cycle():
    planes = torch.zeros(8, 1, 2, dtype=torch.float64)
    planes[4, 0, 0] = 1.0  # west cell sends east
    planes[0, 0, 1] = 1.0  # east cell sends west
    with pytest.raises(RuntimeError, match="cycle"):
        flow.mfd_accumulation(planes, torch.ones(1, 2, dtype=torch.float64))


def test_slope_and_twi_are_horn_and_the_index():
    z, nodata = _dem(23, 27, 7, True)
    slope = terrain.slope_radians(z, nodata, 2.0)
    zz = z.double().numpy()
    h, w = zz.shape
    for r, c in [(0, 0), (5, 7), (22, 26), (11, 0), (12, 13)]:
        if nodata[r, c]:
            assert math.isnan(float(slope[r, c]))
            continue

        def at(dr, dc):
            rr, cc = r + dr, c + dc
            if 0 <= rr < h and 0 <= cc < w and not nodata[rr, cc]:
                return zz[rr, cc]
            return zz[r, c]

        fx = ((at(-1, 1) + 2 * at(0, 1) + at(1, 1))
              - (at(-1, -1) + 2 * at(0, -1) + at(1, -1))) / 16.0
        fy = ((at(1, -1) + 2 * at(1, 0) + at(1, 1))
              - (at(-1, -1) + 2 * at(-1, 0) + at(-1, 1))) / 16.0
        want = math.atan(math.hypot(fx, fy))
        assert float(slope[r, c]) == pytest.approx(want, rel=1e-5, abs=1e-6)
        acc = torch.tensor([[3.0]])
        got = float(terrain.twi(acc, slope[r:r + 1, c:c + 1], 2.0))
        want_twi = math.log(6.0 / max(math.tan(want), 1e-6))
        assert got == pytest.approx(want_twi, rel=1e-4, abs=1e-4)
