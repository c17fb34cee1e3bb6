"""Successor fixpoints over D8 codes: the successor resolve (watershed
labels, upslope masks, the two-pass tile labels) by pointer jumping, with
the Gauss–Seidel resolve sweeps kept as its reference, and Strahler order,
by sweeps.

Counterpart of ``richdem_tpu.ops.pallas_folded`` lines 595-852
(``successor_resolve_folded``, ``strahler_folded``).  One resolve sweep
sets ``V(c) ← V(successor(c))`` for every unpinned cell whose successor
the sweep has already reached; one Strahler sweep sets a cell's order from
the orders of the cells that flow into it.  A rotation is down, up,
transposed down, transposed up; the transposed sweeps read codes through
:data:`~richdem_tpu_torch.ops.sweeps.PERM_TRANSPOSE`.  Values are int32,
so a rotation that changes nothing is exact convergence, and a loop that
reaches ``max_rotations`` first raises (the reference returns silently).

A CUDA tensor goes through ``csrc/resolve_sweep.cu`` and
``csrc/strahler_sweep.cu``, both on the walk of ``csrc/seam_walk.cuh``
(narrow tiles that trade edge values, so one sweep is the sweep over whole
rows); a CPU tensor through :func:`resolve_sweep_plain` and
:func:`strahler_sweep_plain`, the sweeps over whole rows, so one sweep is
bitwise the kernel's.  The resolve's pin rides in the sign bit of the code
byte (:func:`pack_codes`).

The resolve's fixpoint is unique: each cell takes the value of the first
pinned cell on its path, whatever the schedule.  :func:`successor_jump`
reaches it without sweeps: each cell's path is followed within its tile to
a stop or to the first cell outside the tile, then pointers double over
the tiles' border cells (``csrc/successor_jump.cuh``, entry points of the
resolve sweep's library; plain version :func:`successor_jump_plain`).  A
sweep carries a value only where the path runs with it, so a path's every
turn costs a rotation; the jump costs log₂ of the path's length.  It is
the one engine of the watershed labels and upslope masks
(:mod:`~richdem_tpu_torch.methods`) and of the two-pass tile labels
(``parallel/consumer.py``), on every device; a card grid past 2**30
cells or border slots raises, as the multi-flow pass does.  The resolve
sweeps (:func:`successor_resolve_info`) are what the tests hold the jump
against; their card kernel runs on no path.

:func:`successor_table` (flat successor indices) serves the plain pointer
doubling of :mod:`richdem_tpu_torch.methods` and of
``accum.d8_accumulation_doubling``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from richdem_tpu_torch import topology
from richdem_tpu_torch._build import JUMP_TILE, Kernel, stream_handle
from richdem_tpu_torch.ops.fill import _require_converged
from richdem_tpu_torch.ops.sweeps import (PERM_TRANSPOSE,
                                          accumulation_rotations,
                                          accumulation_trios)

__all__ = ["RESOLVE_SWEEP", "STRAHLER_SWEEP", "successor_table",
           "effective_codes", "pack_codes", "transpose_codes",
           "resolve_sweep_plain", "block_flags", "resolve_sweep",
           "walk_shape", "resolve_shape",
           "successor_resolve_info", "RESOLVE_JUMP", "jump_slots",
           "jump_fits", "jump_shape", "successor_jump_plain",
           "successor_jump",
           "successor_resolve", "strahler_sweep_plain", "strahler_sweep",
           "strahler_shape", "strahler_fixpoint_info", "strahler_fixpoint"]

_P = ctypes.c_void_p
_INT = ctypes.c_int
_SWEEP_ARGS = [_P, _P, _P, _INT, _INT, _INT, _P, _INT, _P]
RESOLVE_SWEEP = Kernel("resolve_sweep", "rd_resolve_sweep", _SWEEP_ARGS)
STRAHLER_SWEEP = Kernel("strahler_sweep", "rd_strahler_sweep", _SWEEP_ARGS)
#: Pointer jumping to the resolve's fixpoint, an entry point of the
#: resolve sweep's library (``csrc/resolve_sweep.cu`` over
#: ``csrc/successor_jump.cuh``).
RESOLVE_JUMP = Kernel("resolve_sweep", "rd_resolve_jump",
                      [_P, _P, _P, _P, _P, ctypes.c_longlong, _INT, _INT,
                       _P])

#: What an off-grid cell reads as in each sweep (the kernels' ``OFF``).
RESOLVE_OFF = -1
STRAHLER_OFF = 0
_PIN = -128  # the sign bit of a packed code byte


def _targets(flowdirs):
    """Flat own and successor indices (int64) and whether the successor is
    a real cell: a code in 1..8 pointing inside the grid."""
    fd = flowdirs.to(torch.int64)
    h, w = fd.shape
    dev = fd.device
    rows = torch.arange(h, device=dev)[:, None].expand(h, w)
    cols = torch.arange(w, device=dev)[None, :].expand(h, w)
    code = fd.clamp(0, 8)
    nr = rows + torch.as_tensor(topology.DY, device=dev).long()[code]
    nc = cols + torch.as_tensor(topology.DX, device=dev).long()[code]
    valid = (fd > 0) & (nr >= 0) & (nr < h) & (nc >= 0) & (nc < w)
    return rows * w + cols, nr * w + nc, valid


def successor_table(flowdirs, terminal=None):
    """Flat index (int64, raveled) of each cell's D8 successor.  A terminal
    (NO_FLOW, nodata, or a code pointing off the grid) gets ``terminal``,
    or its own index when that is None (``methods._successors`` of the
    reference)."""
    own, succ, valid = _targets(flowdirs)
    other = own if terminal is None else torch.full_like(own, terminal)
    return torch.where(valid, succ, other).reshape(-1)


def effective_codes(flowdirs):
    """int8 codes with every cell that points off the grid, and every
    nodata cell, made a terminal (code 0): ``methods._fd_effective`` of the
    reference."""
    _, _, valid = _targets(flowdirs)
    return torch.where(valid, flowdirs.to(torch.int8),
                       torch.zeros((), dtype=torch.int8,
                                   device=flowdirs.device))


def pack_codes(flowdirs, pinned):
    """The resolve sweep's code byte: the code (negative codes as 0) with
    the pin in the sign bit."""
    code = flowdirs.clamp(min=0).to(torch.int8)
    return torch.where(pinned, code + _PIN, code).to(torch.int8)


def transpose_codes(code):
    """The (W, H) code raster of the transposed grid, contiguous: each code
    permuted by ``PERM_TRANSPOSE``, a pin bit kept."""
    perm = torch.as_tensor(PERM_TRANSPOSE, device=code.device)
    moved = perm[(code & 15).long()]
    out = torch.where(code < 0, moved + _PIN, moved).to(torch.int8)
    return out.t().contiguous()


def _pad(x, off):
    return F.pad(x[None], (1, 1), value=off)[0]


def _split(row):
    """West, centre and east views of a (W + 2)-padded row."""
    return row[:-2], row[1:-1], row[2:]


def _walk(v_in, code, reverse, off, rule):
    """One sweep of the plain versions over whole rows: a loop over rows in
    sweep order, vectorised across columns.  For each row, ``rule(prev,
    prev_code, own, own_code, after, after_code)`` gives its new values
    from (W + 2)-padded rows: ``prev`` the (west, centre, east) views of
    the new values of the row before; ``own`` and ``after`` sweep-start
    values.  Off-grid cells read ``off`` and code 0."""
    h, wd = v_in.shape
    dev = v_in.device
    out = torch.empty_like(v_in)
    rows = list(range(h - 1, -1, -1) if reverse else range(h))
    step = -1 if reverse else 1
    p = torch.full((wd + 2,), off, dtype=v_in.dtype, device=dev)
    pc = torch.zeros(wd + 2, dtype=code.dtype, device=dev)
    off_row = p.clone()
    for r in rows:
        lv, lc = _pad(v_in[r], off), _pad(code[r], 0)
        rn = r + step
        if 0 <= rn < h:
            nv, nc = _pad(v_in[rn], off), _pad(code[rn], 0)
        else:
            nv, nc = off_row, torch.zeros_like(lc)
        new = rule(_split(p), pc, lv, lc, nv, nc)
        out[r] = new
        p, pc = _pad(new, off), lc
    return out


def resolve_sweep_plain(v_in, code, reverse):
    """Plain version of the resolve-sweep kernel (``csrc/resolve_sweep.cu``):
    the sweep over whole rows, which is the kernel's at every tile width
    (its tiles trade edge values), so one sweep is bitwise the kernel's.
    ``code``: :func:`pack_codes` bytes."""
    before = 1 if reverse else -1  # the dy of the row before

    def rule(prev, _pc, lv, lc, nv, _nc):
        own, here = lv[1:-1], lc[1:-1]
        d = here & 15
        new = own
        for dd in range(1, 9):
            dy, dx = int(topology.DY[dd]), int(topology.DX[dd])
            src = (_split(lv) if dy == 0 else prev if dy == before
                   else _split(nv))
            new = torch.where(d == dd, src[dx + 1], new)
        return torch.where(here < 0, own, new)

    return _walk(v_in, code, reverse, RESOLVE_OFF, rule)


def strahler_sweep_plain(o_in, code, reverse):
    """Plain version of the Strahler-sweep kernel
    (``csrc/strahler_sweep.cu``): the sweep over whole rows, which is the
    kernel's at every tile width (its tiles trade edge values), so one
    sweep is bitwise the kernel's.  ``code``: int8 codes 0..8."""
    (ns, nw, ne), (os_, ow, oe) = accumulation_trios(reverse)
    zero = torch.zeros((), dtype=o_in.dtype, device=o_in.device)

    def rule(prev, pc, lv, lc, nv, nc):
        pw, pcen, pe = prev
        taps = torch.stack([
            torch.where(pc[1:-1] == ns, pcen, zero),
            torch.where(pc[:-2] == nw, pw, zero),
            torch.where(pc[2:] == ne, pe, zero),
            torch.where(nc[1:-1] == os_, nv[1:-1], zero),
            torch.where(nc[:-2] == ow, nv[:-2], zero),
            torch.where(nc[2:] == oe, nv[2:], zero),
            torch.where(lc[:-2] == 5, lv[:-2], zero),
            torch.where(lc[2:] == 1, lv[2:], zero)])
        m = taps.amax(0)
        cnt = ((taps == m) & (m > 0)).sum(0)
        upd = torch.where(m == 0, 1, torch.where(cnt >= 2, m + 1, m))
        o = lv[1:-1]
        return torch.where(o > 0, torch.maximum(o, upd), zero).to(o.dtype)

    return _walk(o_in, code, reverse, STRAHLER_OFF, rule)


def _checked(v_in, code, what):
    for x, dt, name in ((v_in, torch.int32, "values"),
                        (code, torch.int8, "code")):
        if (x.dim() != 2 or x.dtype != dt or not x.is_contiguous()
                or x.shape != v_in.shape or x.device != v_in.device):
            raise ValueError(f"{what} {name}: expected a contiguous {dt} "
                             f"tensor shaped and placed like the values")


def block_flags(width, device):
    """Scratch for the blocks' flags of a sweep on the seam-exact walk
    (``csrc/seam_walk.cuh``): one int32 a block (a block owns at least one
    tile, of 32 columns or more in any build), from PyTorch's allocator
    for each call, so that no two streams share them; the kernel's entry
    point clears them on the launch's stream."""
    return torch.empty(-(-width // 32), dtype=torch.int32, device=device)


def _launch(kernel, v_in, code, reverse, what):
    """Check and launch out of place, with the blocks' flags."""
    _checked(v_in, code, what)
    h, wd = v_in.shape
    out = torch.empty_like(v_in)
    if h == 0 or wd == 0:
        return out
    flags = block_flags(wd, v_in.device)
    kernel.launch(v_in.data_ptr(), code.data_ptr(), out.data_ptr(), h, wd,
                  int(bool(reverse)), flags.data_ptr(), flags.numel(),
                  stream_handle(v_in.device))
    return out


def resolve_sweep(v_in, code, reverse):
    """One directional resolve sweep (down, or up if ``reverse``), out of
    place.  A CUDA tensor launches ``csrc/resolve_sweep.cu`` (raising if it
    cannot be built or launched, its cooperative launch included); a CPU
    tensor runs the plain version."""
    if not v_in.is_cuda:
        return resolve_sweep_plain(v_in, code, reverse)
    return _launch(RESOLVE_SWEEP, v_in, code, reverse, "resolve sweep")


def walk_shape(kernel, symbol):
    """The walk (``csrc/seam_walk.cuh``) of a sweep kernel, from its C
    entry ``symbol`` (the library built if needed): ``tile`` and ``halo``
    columns, consumer ``threads`` a block, ring ``stages``."""
    out = (ctypes.c_int * 4)()
    kernel.entry(symbol, [_P])(out)
    return dict(zip(("tile", "halo", "threads", "stages"), out))


def resolve_shape():
    """The resolve kernel's walk (:func:`walk_shape`)."""
    return walk_shape(RESOLVE_SWEEP, "rd_resolve_shape")


def strahler_sweep(o_in, code, reverse):
    """One directional Strahler sweep (down, or up if ``reverse``), out of
    place.  A CUDA tensor launches ``csrc/strahler_sweep.cu`` (raising if
    it cannot be built or launched, its cooperative launch included); a
    CPU tensor runs the plain version."""
    if not o_in.is_cuda:
        return strahler_sweep_plain(o_in, code, reverse)
    return _launch(STRAHLER_SWEEP, o_in, code, reverse, "Strahler sweep")


def strahler_shape():
    """The Strahler kernel's walk (:func:`walk_shape`)."""
    return walk_shape(STRAHLER_SWEEP, "rd_strahler_shape")


def _rotations(v0, code, max_rotations, sweep):
    code = code.contiguous()
    code_t = transpose_codes(code)
    return accumulation_rotations(
        v0.to(torch.int32).contiguous(),
        lambda v, rev: sweep(v, code, rev),
        lambda v, rev: sweep(v, code_t, rev), max_rotations)


def successor_resolve_info(flowdirs, init, pinned, max_rotations=64,
                           sweep=resolve_sweep):
    """Rotations of resolve sweeps from ``V = init`` until one changes
    nothing; returns ``(values, rotations, converged)`` without raising."""
    return _rotations(init, pack_codes(flowdirs, pinned), max_rotations,
                      sweep)


def successor_resolve(flowdirs, init, pinned, max_rotations=64,
                      return_info=False):
    """Iterate ``V(c) ← V(successor(c))``, pinned cells fixed, to the
    fixpoint; int32 values.  Raises if ``max_rotations`` rotations do not
    reach it.  ``return_info`` adds ``(rotations, converged)``.  A code
    that points off the grid reads -1, as in the reference."""
    v, rotations, done = successor_resolve_info(flowdirs, init, pinned,
                                                max_rotations)
    _require_converged(done, "successor resolve", max_rotations)
    if return_info:
        return v, rotations, done
    return v


def jump_slots(h, w, tile=JUMP_TILE):
    """``(slots, rounds)`` of the successor jump on an h × w grid: the
    border slots, ``4·tile − 4`` a tile in the frame of a whole tile, and
    the rounds of doubling over them, one more than it takes to pass the
    longest chain of slots."""
    slots = -(-h // tile) * -(-w // tile) * (4 * tile - 4)
    rounds = 1
    while (1 << rounds) < slots:
        rounds += 1
    return slots, rounds + 1


def jump_fits(shape):
    """Whether the jump's kernels take a grid of ``shape``: they index
    cells and border slots in int32, each below 2**30."""
    h, w = shape
    return h * w <= 2**30 and jump_slots(h, w)[0] < 2**30


def jump_shape():
    """The jump's local pass (the library built if needed): ``tile`` edge
    and ``threads`` a block."""
    out = (ctypes.c_int * 2)()
    RESOLVE_JUMP.entry("rd_resolve_jump_shape", [_P])(out)
    return dict(zip(("tile", "threads"), out))


def successor_jump_plain(flowdirs, seeds=None, tile=JUMP_TILE):
    """Plain version of the successor jump (``csrc/successor_jump.cuh``):
    watershed labels (int32) when ``seeds`` is None, else the upslope mask
    of ``seeds`` (bool).  A cell whose code is outside 1..8 or points off
    the grid, or a seed, is pinned; every other cell takes the value of the
    first pinned cell on its path (its flat index, or whether it is a
    seed).  Each path is followed within its ``tile`` × ``tile`` tile to a
    stop or to the first cell outside it, by doubling; then pointers double
    over those exits.  A cell on a cycle, or upstream of one, reads -1 or
    False, as the resolve sweeps leave it."""
    code = flowdirs.to(torch.int64)
    h, w = code.shape
    n = h * w
    own, succ, valid = _targets(code)
    own, succ = own.reshape(-1), succ.reshape(-1)
    pinned = ~(valid & (code <= 8)).reshape(-1)
    if seeds is None:
        value, cycle = own, -1
    else:
        seed = seeds.to(device=code.device, dtype=torch.bool).reshape(-1)
        pinned |= seed
        value, cycle = seed.to(torch.int64), 0
    succ = torch.where(pinned, own, succ)
    tiles_x = -(-w // tile)
    tile_of = own // max(w, 1) // tile * tiles_x + own % max(w, 1) // tile
    # a stop of value v as ~(v + 1) < 0; else the cell the path goes on at
    res = torch.where(pinned, ~(value + 1), succ)
    nxt = torch.where(~pinned & (tile_of[succ] == tile_of), succ, -1)
    for _ in range((tile * tile).bit_length()):
        go = torch.nonzero(nxt >= 0).squeeze(1)
        j = nxt[go]
        res[go] = res[j]
        nxt[go] = nxt[j]
    res = torch.where(nxt >= 0, ~(cycle + 1), res)
    for _ in range(max(n, 2).bit_length()):
        go = torch.nonzero(res >= 0).squeeze(1)
        res[go] = res[res[go]]
    out = torch.where(res >= 0, cycle, ~res - 1).view(h, w)
    return out.to(torch.int32) if seeds is None else out.to(torch.bool)


def successor_jump(flowdirs, seeds=None):
    """Watershed labels (int32) when ``seeds`` is None, else the upslope
    mask of ``seeds`` (bool), of D8 codes, as :func:`successor_jump_plain`
    defines them.  A CUDA tensor launches ``csrc/successor_jump.cuh``'s
    three kernels (the tiles' local pass, the rounds over the border
    slots, the final pass) with no host sync, and raises for a grid that
    :func:`jump_fits` refuses; a CPU tensor runs the plain version."""
    if not flowdirs.is_cuda:
        return successor_jump_plain(flowdirs, seeds)
    code = (flowdirs if flowdirs.dtype == torch.int8
            else flowdirs.clamp(-1, 9).to(torch.int8)).contiguous()
    h, w = code.shape
    if not jump_fits((h, w)):
        raise ValueError(f"{h}x{w}: the successor jump takes at most 2**30 "
                         "cells and border slots")
    dev = code.device
    if seeds is None:
        out = torch.empty((h, w), dtype=torch.int32, device=dev)
        ptr, seed_ptr = out, None
    else:
        seeds = seeds.to(device=dev, dtype=torch.bool).contiguous()
        if seeds.shape != code.shape:
            raise ValueError(f"seeds {tuple(seeds.shape)}: expected "
                             f"{(h, w)}")
        out = torch.empty((h, w), dtype=torch.bool, device=dev)
        ptr = torch.empty((h, w), dtype=torch.int32, device=dev)
        seed_ptr = seeds.data_ptr()
    if h == 0 or w == 0:
        return out
    slots, rounds = jump_slots(h, w)
    border = torch.empty(slots + rounds, dtype=torch.int32, device=dev)
    RESOLVE_JUMP.launch(code.data_ptr(), seed_ptr, ptr.data_ptr(),
                        out.data_ptr(), border.data_ptr(), border.numel(), h,
                        w, stream_handle(dev))
    return out


def strahler_fixpoint_info(flowdirs, max_rotations=64, sweep=strahler_sweep):
    """Rotations of Strahler sweeps from order 1 on data (0 on nodata,
    code < 0) until one changes nothing; returns ``(order, rotations,
    converged)`` without raising."""
    order0 = (flowdirs >= 0).to(torch.int32)
    code = flowdirs.clamp(min=0).to(torch.int8)
    return _rotations(order0, code, max_rotations, sweep)


def strahler_fixpoint(flowdirs, max_rotations=64, return_info=False):
    """Strahler order (int32, 0 on nodata) of a D8 code raster; raises if
    ``max_rotations`` rotations do not reach the fixpoint.
    ``return_info`` adds ``(rotations, converged)``."""
    order, rotations, done = strahler_fixpoint_info(flowdirs, max_rotations)
    _require_converged(done, "Strahler order", max_rotations)
    if return_info:
        return order, rotations, done
    return order
