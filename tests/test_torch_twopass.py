"""The port's two-pass protocol pieces ↔ the JAX package's, on the CPU.

The tile consumers, the ring-pinned apply, the protocol drivers over
in-memory tilings, the Schwarz local solve and the min-plus fixpoint names
run on the same float32 numpy input through ``richdem_tpu`` and
``richdem_tpu_torch`` (the kernels' plain versions).  Everything here is
bitwise: the fill, labels, edges and ring vectors are selections of input
values or integers, the accumulations sum unit and integer weights far
below 2²⁴, and the ε > 0 fixpoints take per-edge steps in both packages
at these sizes (the reference's tolerance, atol 1e-4, is the stated gate
there).  JAX compiles once per tile shape, so every tiling here uses one
tile shape (48², halo-extended 50²).
"""

import os
import socket

import numpy as np
import pytest
import torch

from richdem_tpu import oracle, synth

torch.set_num_threads(1)

ND = -9999.0
T = 48


@pytest.fixture(scope="module")
def dem():
    """96² pits with nodata holes: a 2×2 tiling of 48² tiles."""
    return synth.with_nodata_holes(
        synth.depression_dem(2 * T, seed=4, dtype=np.float32), no_data=ND,
        seed=2)


@pytest.fixture(scope="module")
def codes(dem):
    filled = oracle.priority_flood_epsilon(dem.astype(np.float64),
                                           no_data=ND, eps=1e-3)
    return oracle.d8_flowdirs(filled, no_data=ND)


def _edges_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# -- the consumers ----------------------------------------------------------

@pytest.mark.parametrize("ri,ci", [(0, 0), (1, 1)])
def test_fill_tile_consumer_matches_jax(dem, ri, ci):
    """Ring vectors, the local fill, labels and the edge list (in the
    reference's order) bitwise; ``global_edges`` as the 2×2 tiling gives
    them."""
    from richdem_tpu.parallel import consumer as jc
    from richdem_tpu_torch.parallel import consumer as tc
    from richdem_tpu_torch.parallel.twopass import _ge_mask

    z = dem[ri * T:(ri + 1) * T, ci * T:(ci + 1) * T]
    ge = _ge_mask(ri, ci, 2, 2)
    want = jc.fill_tile_consumer(z, no_data=ND, global_edges=ge)
    got = tc.fill_tile_consumer(z, no_data=ND, global_edges=ge,
                                device="cpu")
    for key in ("ring_w", "ring_lab", "ring_nd"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["w_loc"].numpy(),
                                  np.asarray(want["w_loc"]))
    np.testing.assert_array_equal(got["lab"].numpy(),
                                  np.asarray(want["lab"]))
    _edges_equal(got["edges"], want["edges"])
    assert got["edges"][0].size > 0


def test_fill_tile_apply_matches_jax(dem):
    """The ring-pinned re-solve, with raised, never-raised (-inf) and
    nodata ring values."""
    from richdem_tpu.parallel import consumer as jc
    from richdem_tpu_torch.parallel import consumer as tc

    z = dem[T:, :T]
    ring = tc.ring_index(T, T)
    rng = np.random.default_rng(0)
    wstar = z.reshape(-1)[ring].astype(np.float64) + rng.uniform(0, 5,
                                                                 ring.size)
    wstar[rng.random(ring.size) < 0.3] = -np.inf
    wstar[z.reshape(-1)[ring] == ND] = -np.inf
    want = np.asarray(jc.fill_tile_apply(z, wstar, no_data=ND))
    got = tc.fill_tile_apply(z, wstar, no_data=ND, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[z == ND] == ND).all()


def test_accum_tile_consumer_matches_jax(codes):
    from richdem_tpu.parallel import consumer as jc
    from richdem_tpu_torch.parallel import consumer as tc

    fd = codes[:T, T:]
    wts = np.full(fd.shape, 2.0, np.float32)
    acc_j, ring_j = jc.accum_tile_consumer(fd, weights=wts)
    acc_t, ring_t = tc.accum_tile_consumer(fd, weights=wts, device="cpu")
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    for key in ("a0", "fd", "link_local"):
        assert ring_t[key].dtype == ring_j[key].dtype
        np.testing.assert_array_equal(ring_t[key], ring_j[key])


def test_fill_consumer_labels_are_ring_or_ocean(dem):
    """Every non-ocean label is the premark (flat index + 1) of a ring
    cell (tests/test_twopass_device.py's check, on the port)."""
    from richdem_tpu_torch.parallel.consumer import (fill_tile_consumer,
                                                     ring_index)

    z = dem[:T, :T]
    lab = fill_tile_consumer(z, no_data=ND, device="cpu")["lab"].numpy()
    ring = np.zeros(T * T, bool)
    ring[ring_index(T, T)] = True
    labs = np.unique(lab)
    labs = labs[labs > 0]
    assert labs.size > 0 and ring[labs - 1].all()


def test_labels_of_a_serpentine_tile():
    """A serpentine tile, whose resolve sweeps stop at their cap: the
    labels are the doubling labels."""
    from richdem_tpu_torch.methods import watersheds_doubling
    from richdem_tpu_torch.parallel.consumer import _labels_impl

    h, w = 80, 16
    fd = np.zeros((h, w), np.int8)
    fd[0::2, :] = 5
    fd[0::2, -1] = 7
    fd[1::2, :] = 1
    fd[1::2, 0] = 7
    fd[h - 1, 0 if (h - 1) % 2 else w - 1] = 0
    fd_t = torch.from_numpy(fd)
    nd = torch.zeros((h, w), dtype=torch.bool)
    lab = _labels_impl(nd, fd_t, nd)
    term = watersheds_doubling(fd_t).reshape(-1).long()
    np.testing.assert_array_equal(lab.reshape(-1).numpy(),
                                  term.numpy() + 1)


def _four_cycle_codes(shape):
    """A four-cell cycle (E, S, W, N) near the middle of a NO_FLOW field
    with a nodata cell, a cell draining into the cycle, and a cell
    draining off each side; on a row or a column, codes along it to a
    NO_FLOW cell every five and a nodata cell at the end."""
    h, w = shape
    fd = np.zeros(shape, np.int8)
    if h < 2 or w < 2:
        fd.reshape(-1)[:] = 5 if h == 1 else 7
        fd.reshape(-1)[::5] = 0
        fd.reshape(-1)[-1] = -1
        return fd
    r, c = h // 2, w // 2
    fd[r, c], fd[r, c + 1], fd[r + 1, c + 1], fd[r + 1, c] = 5, 7, 1, 3
    fd[r - 1, c] = 7
    fd[0, :], fd[:, 0], fd[-1, -1] = 3, 1, -1
    return fd


def _random_codes(shape):
    return np.random.default_rng(shape[0] * 100 + shape[1]).integers(
        -1, 9, shape).astype(np.int8)


@pytest.mark.parametrize("shape", [(1, 70), (70, 1), (33, 47)])
@pytest.mark.parametrize("make", [_random_codes, _four_cycle_codes],
                         ids=["random", "four-cycle"])
def test_labels_are_the_resolve_sweeps_fixpoint(make, shape):
    """Codes in -1..8 (cycles among them) and a four-cell cycle, with
    nodata cells and cells on a global edge: the labels are bitwise the
    resolve sweeps' fixpoint from the premarks, -1 on and above a
    cycle."""
    from richdem_tpu_torch.ops.stencil import neighbor
    from richdem_tpu_torch.ops.successor import (effective_codes,
                                                 successor_resolve_info)
    from richdem_tpu_torch.parallel.consumer import _labels_impl

    fd = torch.from_numpy(make(shape))
    nd = fd < 0
    ge = torch.zeros(shape, dtype=torch.bool)
    ge[0, :shape[1] if shape[0] > 1 else 1] = True
    lab = _labels_impl(nd, fd, ge)
    near_nodata = torch.zeros_like(nd)
    for d in range(1, 9):
        near_nodata |= neighbor(nd, d, False)
    ocean = nd | ((fd == 0) & ~nd & (ge | near_nodata))
    own = torch.arange(fd.numel(), dtype=torch.int32).view(shape)
    premark = torch.where(ocean, 0, own + 1).to(torch.int32)
    fd_eff = effective_codes(fd)
    pinned = fd_eff == 0
    want, _, done = successor_resolve_info(
        fd_eff, torch.where(pinned, premark, -1), pinned, 256)
    assert done and lab.dtype == torch.int32
    assert torch.equal(lab, want)
    if make is _four_cycle_codes and min(shape) > 1:
        assert int((lab < 0).sum()) == 5
    assert (lab == 0).any() and (lab > 0).any()


# -- the drivers over in-memory tilings -----------------------------------

def _tiling(n):
    return [(0, T), (T, n)]


def test_fill_twopass_run_matches_jax(dem):
    from richdem_tpu.parallel import twopass as jt
    from richdem_tpu_torch.parallel import twopass as tt

    rows = cols = _tiling(dem.shape[0])
    outs = {"jax": np.zeros_like(dem), "port": np.zeros_like(dem)}
    stats = {"jax": {}, "port": {}}

    def get(ri, ci):
        return dem[rows[ri][0]:rows[ri][1], cols[ci][0]:cols[ci][1]]

    def put(key):
        def _put(ri, ci, filled):
            outs[key][rows[ri][0]:rows[ri][1],
                      cols[ci][0]:cols[ci][1]] = np.asarray(filled)
        return _put

    jt.fill_twopass_run(get, put("jax"), rows, cols, no_data=ND,
                        stats=stats["jax"])
    tt.fill_twopass_run(get, put("port"), rows, cols, no_data=ND,
                        stats=stats["port"], device="cpu")
    np.testing.assert_array_equal(outs["port"], outs["jax"])
    assert stats["port"] == stats["jax"]
    assert stats["port"]["data_passes"] == 2
    want = oracle.priority_flood_fill(dem.astype(np.float64), no_data=ND)
    m = dem != ND
    np.testing.assert_allclose(outs["port"][m], want[m], rtol=0, atol=1e-5)


def test_accum_twopass_run_matches_jax(codes):
    """Weighted, with nodata codes: the host's float64 ring sums injected
    into float32 weights, bitwise the reference's."""
    from richdem_tpu.parallel import twopass as jt
    from richdem_tpu_torch.parallel import twopass as tt

    n = codes.shape[0]
    rows = cols = _tiling(n)
    wts = np.full(codes.shape, 3.0, np.float32)
    outs = {"jax": np.zeros(codes.shape, np.float32),
            "port": np.zeros(codes.shape, np.float32)}
    stats = {"jax": {}, "port": {}}

    def tile(x, ri, ci):
        return x[rows[ri][0]:rows[ri][1], cols[ci][0]:cols[ci][1]]

    def put(key):
        def _put(ri, ci, acc):
            outs[key][rows[ri][0]:rows[ri][1],
                      cols[ci][0]:cols[ci][1]] = np.asarray(acc)
        return _put

    for key, run, kw in (("jax", jt.accum_twopass_run, {}),
                         ("port", tt.accum_twopass_run, {"device": "cpu"})):
        run(lambda ri, ci: tile(codes, ri, ci),
            lambda ri, ci: tile(wts, ri, ci), put(key), rows, cols,
            codes.shape, stats=stats[key], **kw)
    np.testing.assert_array_equal(outs["port"], outs["jax"])
    assert stats["port"] == stats["jax"]
    want = oracle.d8_accumulation(codes, weights=np.where(codes < 0, 0.0,
                                                          wts))
    np.testing.assert_allclose(outs["port"], want, rtol=1e-6)


def test_side_positions_match_jax():
    from richdem_tpu.parallel import twopass as jt
    from richdem_tpu_torch.parallel import twopass as tt

    for th, tw in ((1, 1), (1, 5), (2, 3), (5, 1), (4, 7), (9, 6)):
        for side in ("top", "bottom", "left", "right"):
            np.testing.assert_array_equal(tt.side_positions(th, tw, side),
                                          jt.side_positions(th, tw, side))


# -- the Schwarz local solve and the min-plus names -------------------------

@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_local_fill_solve_matches_jax(dem, eps):
    """One Schwarz step on a halo-extended 50² block, its ring clamped at
    a state above the fill: bitwise at ε = 0, atol 1e-4 at ε > 0."""
    from richdem_tpu.parallel.sharded import _local_fill_solve as jsolve
    from richdem_tpu_torch.parallel.consumer import _local_fill_solve

    big = np.float32(1e30)
    z = dem[:T, :T]
    nd = z == ND
    ext = np.full((T + 2, T + 2), big, np.float32)
    ext[0, :] = ext[-1, :] = ext[:, 0] = ext[:, -1] = 60.0
    ext[0, 5] = -big
    ext[1:-1, 1:-1] = np.where(nd, -big, big)
    floor_ext = ext.copy()
    floor_ext[1:-1, 1:-1] = np.where(nd, -big, z)
    want = np.asarray(jsolve(ext, floor_ext, eps, 256))
    got = _local_fill_solve(torch.from_numpy(ext),
                            torch.from_numpy(floor_ext), eps, 256).numpy()
    if eps == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _minplus_inputs():
    rng = np.random.default_rng(5)
    z = synth.depression_dem(20, 24, seed=3, dtype=np.float32)
    big = np.float32(1e30)
    costs = np.where(rng.random((8, 20, 24)) < 0.2, big,
                     np.float32(1.0)).astype(np.float32)
    seeds = np.where(rng.random((20, 24)) < 0.05, 0.0, big).astype(
        np.float32)
    return z, big, costs, seeds


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_minplus_fixpoint_fill_matches_jax(eps):
    """The fill-shaped fixpoint (scalar cost, draining boundary): the same
    surface, iterations and converged flag."""
    from richdem_tpu.ops import sweeps as js
    from richdem_tpu_torch.ops import sweeps as ts

    z, big, _, _ = _minplus_inputs()
    w0 = np.full(z.shape, big, np.float32)
    want = js.minplus_fixpoint(w0, z, np.float32(eps), np.float32(-big))
    got = ts.minplus_fixpoint(torch.from_numpy(w0), torch.from_numpy(z),
                              np.float32(eps), np.float32(-big))
    assert got[2] and bool(want[2]) and got[1] == int(want[1])
    if eps == 0.0:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    else:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=1e-4)


def test_minplus_core_sweep_and_jacobi_match_jax():
    """General per-direction costs, a scalar floor and a non-draining
    boundary (a masked distance transform), ``check_every`` 2, then one
    sweep and one Jacobi step: bitwise."""
    import jax

    from richdem_tpu.ops import sweeps as js
    from richdem_tpu_torch.ops import sweeps as ts

    _, big, costs, seeds = _minplus_inputs()
    floor = np.full(seeds.shape, -big, np.float32)
    want = js.minplus_fixpoint(seeds, -big, costs, big, check_every=2)
    got = ts.minplus_fixpoint_core(torch.from_numpy(seeds), -big,
                                   torch.from_numpy(costs), big,
                                   check_every=2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert (got[1], got[2]) == (int(want[1]), bool(want[2]))
    t = [torch.from_numpy(x) for x in (seeds, floor, costs)]
    for name in ("minplus_sweep_once", "jacobi_step"):
        want = jax.jit(getattr(js, name))(seeds, floor, costs,
                                          np.float32(big))
        np.testing.assert_array_equal(getattr(ts, name)(*t, big).numpy(),
                                      np.asarray(want))


def test_minplus_reports_non_convergence():
    from richdem_tpu_torch.ops import sweeps as ts

    z, big, _, _ = _minplus_inputs()
    w, iters, done = ts.minplus_fixpoint(
        torch.full(z.shape, float(big)), torch.from_numpy(z), 0.0, -big,
        max_iters=1)
    assert iters == 1 and not done


# -- the exchange -----------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_multihost_exchange_needs_a_process_group():
    from richdem_tpu_torch.parallel.twopass import multihost_exchange

    with pytest.raises(RuntimeError, match="init_process_group"):
        multihost_exchange(b"payload")


def test_multihost_exchange_one_rank_gloo(dem):
    """In a one-rank gloo group the exchange gives back this process's
    payload, and the fill driver runs through it unchanged."""
    import torch.distributed as dist

    from richdem_tpu_torch.parallel.twopass import (fill_twopass_run,
                                                    multihost_exchange)

    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        assert multihost_exchange(b"") == [b""]
        assert multihost_exchange(bytes(range(7))) == [bytes(range(7))]
        z = dem[:T, :T]
        rows = cols = [(0, T)]
        out = {}
        fill_twopass_run(lambda ri, ci: z,
                         lambda ri, ci, f: out.setdefault("f", f.numpy()),
                         rows, cols, no_data=ND, exchange=multihost_exchange,
                         device="cpu")
    finally:
        dist.destroy_process_group()
    want = oracle.priority_flood_fill(z.astype(np.float64), no_data=ND)
    m = z != ND
    np.testing.assert_allclose(out["f"][m], want[m], rtol=0, atol=1e-5)


def test_cuda_without_a_card_raises(tmp_path):
    """The drivers and the out-of-core entry points run on the card unless
    asked for the CPU; without one they raise, never run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from richdem_tpu_torch.parallel.outofcore import (out_of_core_accum_d8,
                                                      out_of_core_fill)

    p = str(tmp_path / "z.npy")
    np.save(p, np.zeros((8, 8), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        out_of_core_fill(p)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        out_of_core_accum_d8(p, method="schwarz")
    assert not os.path.exists(p + ".filled.npy")
