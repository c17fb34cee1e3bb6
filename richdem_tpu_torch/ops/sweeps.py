"""Directional Gauss–Seidel sweeps (fill and masked distances): the plain
versions and the rotation/fixpoint loops.

Counterpart of :mod:`richdem_tpu.ops.sweeps` (``BIG``, the
``(w, iters, converged)`` while-loop contract) and of
``richdem_tpu.ops.pallas_sweeps.minplus_rotation`` /
``fill_fixpoint_pallas``.  The filled surface is the greatest fixpoint
below ``w0`` of

    W(c) = min( W(c), max( floor(c), min_n W(n) + eps_n ) )

with off-grid neighbours draining at ``-BIG``.  One directional sweep
relaxes the three neighbours of the row before; a rotation is down, up,
transposed-down and transposed-up, so it covers all 8 directions.  The
iteration is monotone, so any sweep order (and any staleness at tile seams)
reaches the same fixpoint, bit for bit.

The masked unit-cost distances of flat resolution are the same kind of
fixpoint with no floor (counterpart of ``pallas_sweeps._allowed``,
``_dist_rotation``, ``dist_fixpoint_pallas`` and of
``pallas_scan.dist_fixpoint_scan``):

    D(c) = min( D(c), min_{n admissible} D(n) + step )

where an edge n → c is admissible when both cells are data at one
elevation and their flag bytes pass the mode's test (:func:`allowed`).
Distances are small integers, so every engine and every sweep order reaches
the same answer exactly.

Accumulation ``A = w + PᵀA`` (D8, D∞, multi-flow) rotates through the same
four orientations (:func:`accumulation_rotations`); its transposed sweeps
read directions through :data:`PERM_TRANSPOSE`.  Float sums regroup from
one orientation to the next, so it converges on equality over a whole
rotation, never on a per-sweep flag.

The general min-plus fixpoint of ``richdem_tpu.ops.sweeps``,

    W(c) = min( W0(c),  max( floor(c),  min_d  W(n_d) + cost_d(c) ) )

with per-direction ``costs`` and an off-grid ``boundary`` value, keeps the
reference's names and ``(w, iters, converged)`` contract
(:func:`minplus_fixpoint`, :func:`minplus_fixpoint_core`,
:func:`minplus_sweep_once`, :func:`jacobi_step`) as plain tensor code: four
directional relaxations along rows and columns, each a loop of exact
per-edge steps, then one 8-neighbour Jacobi step.  Its fixpoint is unique,
so it equals the reference's at ε = 0 bit for bit.  A fill-shaped call on
the card (a scalar cost, ``boundary = -BIG``) runs the fill kernel's
rotations (:func:`fill_fixpoint_core`), which reach the same fixpoint.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from richdem_tpu_torch import topology
from richdem_tpu_torch._build import SWEEP_TILE
from richdem_tpu_torch.ops.stencil import neighbor

__all__ = ["BIG", "ZBIG", "DIST_MODES", "F_DATA", "F_NOFLOW", "F_INFLAT",
           "PERM_TRANSPOSE", "fill_sweep_plain", "fill_fixpoint_core",
           "clamp_scan_plain", "fill_scan_sweep_plain",
           "fill_scan_fixpoint_core",
           "seam_columns", "allowed", "dist_sweep_plain", "dist_context",
           "dist_fixpoint_core", "accumulation_trios", "pad_row",
           "accumulation_rotations", "minplus_fixpoint",
           "minplus_fixpoint_core", "minplus_sweep_once", "jacobi_step"]

#: Finite stand-in for infinity (fits comfortably in float32).
BIG = 1.0e30

#: Elevation of nodata and off-grid cells in the distance sweeps; an
#: elevation below 2.9e37 is a data cell's.
ZBIG = 3.0e37
_ZVALID = 2.9e37

#: Flag bits of a cell (int8): data, NO_FLOW, member of a flat.
F_DATA, F_NOFLOW, F_INFLAT = 1, 2, 4

#: Distance modes, in the order of the kernel's ``mode`` argument.
DIST_MODES = ("member", "towards", "away", "maxd")


def _transpose_permutation() -> np.ndarray:
    """Code of each direction in the transposed grid: (dy, dx) → (dx, dy).
    The reference's ``ops/accum._PERM_TRANSPOSE``, derived from the pinned
    topology tables instead of copied."""
    perm = np.zeros(9, np.int8)
    for d in range(1, 9):
        for e in range(1, 9):
            if (topology.DX[e] == topology.DY[d]
                    and topology.DY[e] == topology.DX[d]):
                perm[d] = e
    return perm


#: code permutation under transposition (0 stays NO_FLOW)
PERM_TRANSPOSE = _transpose_permutation()


def seam_columns(width: int, tile: int, device):
    """Columns whose west (``left``) or east (``right``) neighbour lies in
    another tile of ``tile`` columns; those neighbours are read at their
    sweep-start values, as the kernels read them."""
    left = torch.arange(tile, max(width, tile), tile, device=device)
    return left, left - 1


def fill_sweep_plain(w_in, floor, eps, eps_diag, reverse, flag,
                     tile=SWEEP_TILE):
    """Plain version of the fill-sweep kernel (``csrc/fill_sweep.cu``): a
    loop over rows in sweep order, vectorised across columns.  Returns the
    swept raster; ORs 1 into the int32 ``flag`` if any cell changed.

    ``tile``: width of the kernel's column tiles.  Across a tile edge the
    row before is read at its sweep-start values, exactly as the kernel
    does, so one sweep is bitwise the kernel's."""
    h, wd = w_in.shape
    out = torch.empty_like(w_in)
    eps_t = torch.tensor(eps, dtype=torch.float32, device=w_in.device)
    epsd_t = torch.tensor(eps_diag, dtype=torch.float32, device=w_in.device)
    lseam, rseam = seam_columns(wd, tile, w_in.device)
    rows = range(h - 1, -1, -1) if reverse else range(h)
    prev = torch.full((wd + 2,), -BIG, dtype=torch.float32,
                      device=w_in.device)
    prev_old = None
    for r in rows:
        left = prev[:-2]
        right = prev[2:]
        if prev_old is not None and lseam.numel():
            left = left.clone()
            right = right.clone()
            left[lseam] = prev_old[lseam - 1]
            right[rseam] = prev_old[rseam + 1]
        cand = prev[1:-1] + eps_t
        cand = torch.minimum(cand, left + epsd_t)
        cand = torch.minimum(cand, right + epsd_t)
        new = torch.minimum(w_in[r], torch.maximum(floor[r], cand))
        out[r] = new
        prev = F.pad(new, (1, 1), value=-BIG)
        prev_old = w_in[r]
    flag.bitwise_or_((out != w_in).any().to(torch.int32))
    return out


def _flag_rotations(w, rotation, flag, max_iters):
    """Apply ``rotation`` from ``w`` until one leaves the change flag at 0;
    returns ``(w, iters, converged)``.  The flag is zeroed before and read
    after each rotation (one host sync); ``max_iters`` bounds the loop,
    never the result."""
    iters = 0
    while iters < max_iters:
        flag.zero_()
        w = rotation(w)
        iters += 1
        if int(flag.item()) == 0:
            return w, iters, True
    return w, iters, False


def fill_fixpoint_core(w0, floor, eps, max_iters, sweep, eps_diag=None):
    """Iterate rotations of ``sweep`` (down, up, transposed-down,
    transposed-up) until one changes nothing; returns
    ``(w, iters, converged)``.

    ``sweep(w_in, floor, eps, eps_diag, reverse, flag)`` is the kernel
    wrapper or its plain version.  Straight edges cost ``eps``, diagonal
    edges ``eps_diag`` (``eps`` when None).  The loop reads the change flag
    once per rotation (one host sync); ``max_iters`` bounds the loop, never
    the result — ``converged`` says whether the fixpoint was reached."""
    eps_diag = eps if eps_diag is None else eps_diag
    floor_t = floor.t().contiguous()
    flag = torch.zeros(1, dtype=torch.int32, device=w0.device)

    def rotation(w):
        w = sweep(w, floor, eps, eps_diag, False, flag)
        w = sweep(w, floor, eps, eps_diag, True, flag)
        wt = w.t().contiguous()
        wt = sweep(wt, floor_t, eps, eps_diag, False, flag)
        wt = sweep(wt, floor_t, eps, eps_diag, True, flag)
        return wt.t().contiguous()

    return _flag_rotations(w0.contiguous(), rotation, flag, max_iters)


# -- the scan engine ---------------------------------------------------------
#
# Counterpart of ``richdem_tpu.ops.pallas_scan`` (``_clamp_scan``,
# ``_fill_scan_kernel``, ``_fill_scan_impl``).  Within a row, with the row
# before fixed, the Gauss–Seidel limit of the fill is
#
#     new[j] = min(wr[j], max(fr[j], min(vc[j], new[j−1]+ε, new[j+1]+ε)))
#
# and splits into two directional chains F[j] = clip(F[j∓1] + ε, fr[j],
# b[j]), b = min(wr, max(fr, vc)).  In tilted coordinates (x − j·ε forward,
# x + j·ε reverse) each chain is a pure clamp chain F'[j] = clip(F'[j∓1],
# lo'[j], hi'[j]) from −BIG off the row: compositions of clip maps are
# clip maps, (lo, hi) of "a then b" being (clip(a.lo, b), clip(a.hi, b)),
# computed with min and max only.  The composition is exact, so any
# grouping (a Hillis–Steele scan here, per-thread runs and a block scan in
# the kernel) gives the same chain bit for bit.


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _shift(x, d, fill, reverse):
    """``x`` moved ``d`` places along the chain: out[j] = x[j∓d], ``fill``
    where that falls off the row."""
    if reverse:
        return F.pad(x[d:], (0, d), value=fill)
    return F.pad(x[:-d], (d, 0), value=fill)


def _clamp_prefix(lo, hi, reverse):
    """Inclusive chain-order composition of the clip maps ``(lo, hi)`` of
    one row segment, by Hillis–Steele doubling (the identity map is
    (−∞, +∞))."""
    n = lo.numel()
    d = 1
    while d < n:
        elo = _shift(lo, d, -math.inf, reverse)
        ehi = _shift(hi, d, math.inf, reverse)
        lo, hi = _clip(elo, lo, hi), _clip(ehi, lo, hi)
        d *= 2
    return lo, hi


def clamp_scan_plain(lo, hi, reverse, chunk=None):
    """The clamp chain F'[j] = clip(F'[j∓1], lo[j], hi[j]) of one row, from
    −BIG off the row (forward: from the west; ``reverse``: from the east).

    ``chunk``: scan segments of this many columns in chain order, carrying
    the chain value from one to the next, as the kernel does; ``None``
    scans the whole row at once.  Every choice gives the same bits."""
    n = lo.numel()
    chunk = n if chunk is None else int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    starts = list(range(0, n, chunk))
    if reverse:
        starts.reverse()
    out = torch.empty_like(lo)
    carry = torch.tensor(-BIG, dtype=lo.dtype, device=lo.device)
    for s in starts:
        seg = slice(s, min(s + chunk, n))
        plo, phi = _clamp_prefix(lo[seg], hi[seg], reverse)
        out[seg] = _clip(carry, plo, phi)
        carry = out[seg][0 if reverse else -1]
    return out


def fill_scan_sweep_plain(w_in, floor, eps, eps_diag, reverse, flag,
                          chunk=None):
    """Plain version of the scan fill-sweep kernel (``csrc/fill_scan.cu``):
    a loop over rows in sweep order, vectorised across columns.  Each row
    relaxes the three cells of the row before (new values) and resolves
    both in-row chains exactly with :func:`clamp_scan_plain`; a lateral
    value is taken only where it beats ``b`` by more than the guard
    ``(|b| + t_max)·2⁻²¹`` (0 at ε = 0), as the reference does.  No row
    after the current one is read.  The result is kept at or above the
    floor: untilting a chain value clamped at the floor, ``(fr − t) + t``,
    can round an ulp below ``fr``, and the reference returns such cells
    below the DEM (at ε > 0 only).  Returns the swept raster; ORs 1 into
    the int32 ``flag`` if any cell changed.  ``chunk``: see
    :func:`clamp_scan_plain` (the result does not depend on it)."""
    h, wd = w_in.shape
    dev = w_in.device
    out = torch.empty_like(w_in)
    eps_t = torch.tensor(eps, dtype=torch.float32, device=dev)
    epsd_t = torch.tensor(eps_diag, dtype=torch.float32, device=dev)
    jeh = torch.arange(wd, dtype=torch.float32, device=dev) * eps_t
    # the guard's t_max, the row's largest tilt f32(W − 1)·ε: the reference
    # takes the width of its padded folded row, the port pads nothing
    tmax = torch.tensor(float(wd - 1), dtype=torch.float32,
                        device=dev) * eps_t
    gscale = torch.tensor(2.0 ** -21, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    positive = bool(np.float32(eps) > 0)
    rows = range(h - 1, -1, -1) if reverse else range(h)
    prev = torch.full((wd + 2,), -BIG, dtype=torch.float32, device=dev)
    for r in rows:
        wr, fr = w_in[r], floor[r]
        vc = torch.minimum(prev[1:-1] + eps_t,
                           torch.minimum(prev[:-2], prev[2:]) + epsd_t)
        b = torch.minimum(wr, torch.maximum(fr, vc))
        fwd = clamp_scan_plain(fr - jeh, b - jeh, False, chunk) + jeh
        rev = clamp_scan_plain(fr + jeh, b + jeh, True, chunk) - jeh
        lat = torch.minimum(fwd, rev)
        guard = (torch.abs(b) + tmax) * gscale if positive else zero
        new = torch.maximum(fr, torch.where(lat < b - guard, lat, b))
        out[r] = new
        prev = F.pad(new, (1, 1), value=-BIG)
    flag.bitwise_or_((out != w_in).any().to(torch.int32))
    return out


def fill_scan_fixpoint_core(w0, floor, eps, max_iters, sweep,
                            eps_diag=None):
    """Iterate rotations of two scan sweeps, down then up, with no
    transposes (each sweep resolves both in-row directions), until one
    changes nothing; returns ``(w, iters, converged)`` with the contract of
    :func:`fill_fixpoint_core`.  ``sweep`` is the scan kernel's wrapper or
    its plain version."""
    eps_diag = eps if eps_diag is None else eps_diag
    flag = torch.zeros(1, dtype=torch.int32, device=w0.device)

    def rotation(w):
        w = sweep(w, floor, eps, eps_diag, False, flag)
        return sweep(w, floor, eps, eps_diag, True, flag)

    return _flag_rotations(w0.contiguous(), rotation, flag, max_iters)


def allowed(mode, z, zn, s, sn):
    """Admissibility of the edge n → c per mode (``z``/``s``: the cell's
    elevation and flags; ``zn``/``sn``: the neighbour's).  The predicates
    of ``richdem_tpu.ops.pallas_sweeps._allowed``:

    * member  — both data;
    * towards — c is NO_FLOW and in a flat, n in a flat;
    * away    — both NO_FLOW and in a flat;
    * maxd    — both in a flat;

    always at one data elevation."""
    z_eq = (z == zn) & (z < _ZVALID) & (zn < _ZVALID)
    if mode == "member":
        return z_eq & ((s & F_DATA) > 0) & ((sn & F_DATA) > 0)
    nf_in = F_NOFLOW | F_INFLAT
    if mode == "towards":
        return z_eq & ((s & nf_in) == nf_in) & ((sn & F_INFLAT) > 0)
    if mode == "away":
        return z_eq & ((s & nf_in) == nf_in) & ((sn & nf_in) == nf_in)
    if mode == "maxd":
        return z_eq & ((s & F_INFLAT) > 0) & ((sn & F_INFLAT) > 0)
    raise ValueError(f"unknown distance mode {mode!r}; expected one of "
                     f"{DIST_MODES}")


def dist_sweep_plain(w_in, z, flags, mode, step, reverse, flag):
    """Plain version of the distance-sweep kernel (``csrc/dist_sweep.cu``):
    the sweep over whole rows, which is the kernel's at every tile width
    (its tiles trade edge values), so one sweep is bitwise the kernel's.
    A loop over rows in sweep order, vectorised across columns: each cell
    relaxes the three cells of the row before (N, NW, NE in sweep order)
    over admissible edges.  Returns the swept raster; ORs 1 into the int32
    ``flag`` if any cell changed.

    ``z``: float32 elevations with nodata at :data:`ZBIG`; ``flags``: int8
    flag bytes.  Off-grid cells are ``w = BIG``, ``z = ZBIG``, flags 0."""
    h, wd = w_in.shape
    dev = w_in.device
    out = torch.empty_like(w_in)
    step_t = torch.tensor(step, dtype=torch.float32, device=dev)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    rows = range(h - 1, -1, -1) if reverse else range(h)
    pw = torch.full((wd + 2,), BIG, dtype=torch.float32, device=dev)
    pz = torch.full((wd + 2,), ZBIG, dtype=torch.float32, device=dev)
    ps = torch.zeros(wd + 2, dtype=flags.dtype, device=dev)
    for r in rows:
        zr, sr = z[r], flags[r]
        cand = torch.where(allowed(mode, zr, pz[1:-1], sr, ps[1:-1]),
                           pw[1:-1] + step_t, big)
        cand = torch.minimum(cand, torch.where(
            allowed(mode, zr, pz[:-2], sr, ps[:-2]), pw[:-2] + step_t, big))
        cand = torch.minimum(cand, torch.where(
            allowed(mode, zr, pz[2:], sr, ps[2:]), pw[2:] + step_t, big))
        new = torch.minimum(w_in[r], cand)
        out[r] = new
        pw = F.pad(new, (1, 1), value=BIG)
        pz = F.pad(zr, (1, 1), value=ZBIG)
        ps = F.pad(sr, (1, 1), value=0)
    flag.bitwise_or_((out != w_in).any().to(torch.int32))
    return out


def dist_context(zed, flags):
    """``(z, flags, z.T, flags.T)``, contiguous: the rasters every distance
    fixpoint of one flat resolution reads, transposed once (as
    ``pallas_sweeps._dist_context`` prepares them once)."""
    z = zed.to(torch.float32).contiguous()
    s = flags.to(torch.int8).contiguous()
    return z, s, z.t().contiguous(), s.t().contiguous()


def dist_fixpoint_core(w0, ctx, mode, step, max_iters, sweep):
    """Iterate rotations of ``sweep`` (down, up, transposed-down,
    transposed-up) from ``w0`` until one changes nothing; returns
    ``(w, iters, converged)``.

    ``ctx``: :func:`dist_context`.  ``sweep(w_in, z, flags, mode, step,
    reverse, flag)`` is the kernel wrapper or its plain version.  The
    in-row E/W chains are left to the transposed sweeps, as
    ``pallas_sweeps._dist_rotation`` leaves them.  The change flag is read
    once per rotation; ``max_iters`` bounds the loop, never the result."""
    z, s, z_t, s_t = ctx
    flag = torch.zeros(1, dtype=torch.int32, device=w0.device)
    w = w0.to(torch.float32).contiguous()
    iters, converged = 0, False
    while iters < max_iters:
        flag.zero_()
        w = sweep(w, z, s, mode, step, False, flag)
        w = sweep(w, z, s, mode, step, True, flag)
        wt = w.t().contiguous()
        wt = sweep(wt, z_t, s_t, mode, step, False, flag)
        wt = sweep(wt, z_t, s_t, mode, step, True, flag)
        w = wt.t().contiguous()
        iters += 1
        if int(flag.item()) == 0:
            converged = True
            break
    return w, iters, converged


def accumulation_trios(reverse):
    """Directions an accumulation sweep reads on its new side (the row
    before in sweep order) and on its old side (the row after): straight,
    from the west source, from the east source."""
    down, up = (7, 6, 8), (3, 4, 2)
    return (up, down) if reverse else (down, up)


def pad_row(x):
    """``x`` with one zero column on either side of its last axis."""
    return F.pad(x[None], (1, 1))[0]


def accumulation_rotations(w, row_sweep, col_sweep, max_rotations):
    """Rotations of accumulation sweeps from ``A = w`` until one changes
    nothing; returns ``(acc, rotations, converged)`` without raising.

    ``row_sweep(acc, reverse)`` sweeps the (H, W) raster down or up;
    ``col_sweep(acc_t, reverse)`` sweeps its (W, H) transpose, whose
    fields the caller has transposed (and permuted) once.  A rotation is
    down, up, transposed down, transposed up.  ``max_rotations`` bounds the
    loop, never the result."""
    acc = w
    rotations, converged = 0, False
    while rotations < max_rotations:
        new = row_sweep(acc, False)
        new = row_sweep(new, True)
        t = col_sweep(new.t().contiguous(), False)
        t = col_sweep(t, True)
        new = t.t().contiguous()
        rotations += 1
        converged = torch.equal(new, acc)
        acc = new
        if converged:
            break
    return acc, rotations, converged


# -- the general min-plus fixpoint -------------------------------------------


def _axis_sweep(w, floor, cost_in, axis, reverse, boundary):
    """One directional relaxation along ``axis`` (-2: rows top to bottom,
    -1: columns left to right; ``reverse`` the other way):
    ``w_i = min(w_i, max(floor_i, w_{i-1} + cost_in_i))`` from ``boundary``
    off the grid.  ``cost_in[c]`` is the cost of the edge into ``c`` from
    its predecessor along the sweep."""
    if axis in (-1, w.dim() - 1):
        w, floor, cost_in = (a.transpose(-1, -2) for a in (w, floor,
                                                            cost_in))
    n = w.shape[-2]
    out = torch.empty_like(w)
    prev = boundary.expand(w.shape[-1])
    for i in (range(n - 1, -1, -1) if reverse else range(n)):
        prev = torch.minimum(w[..., i, :],
                             torch.maximum(floor[..., i, :],
                                           prev + cost_in[..., i, :]))
        out[..., i, :] = prev
    if axis in (-1, w.dim() - 1):
        out = out.transpose(-1, -2)
    return out.contiguous()


def jacobi_step(w, floor, costs, boundary):
    """One full 8-neighbour Jacobi relaxation (carries diagonal edges).

    ``costs``: (8, H, W) edge costs into each cell from direction d = k+1;
    ``boundary``: the value read off the grid."""
    best = torch.full_like(w, BIG)
    for d in range(1, 9):
        cand = neighbor(w, d, float(boundary)) + costs[d - 1]
        best = torch.minimum(best, cand)
    return torch.minimum(w, torch.maximum(floor, best))


def minplus_sweep_once(w, floor, costs, boundary):
    """One iteration: W→E, E→W, N→S, S→N relaxations + one Jacobi step.

    ``costs``: (8, H, W); index k is the cost into a cell from its
    direction-(k+1) neighbour (1 = W, 3 = N, 5 = E, 7 = S)."""
    bnd = torch.as_tensor(boundary, dtype=w.dtype, device=w.device)
    w = _axis_sweep(w, floor, costs[0], -1, False, bnd)  # from W, eastward
    w = _axis_sweep(w, floor, costs[4], -1, True, bnd)   # from E, westward
    w = _axis_sweep(w, floor, costs[2], -2, False, bnd)  # from N, southward
    w = _axis_sweep(w, floor, costs[6], -2, True, bnd)   # from S, northward
    return jacobi_step(w, floor, costs, bnd)


def _is_scalar(x):
    return x.dim() == 0 if torch.is_tensor(x) else np.ndim(x) == 0


def minplus_fixpoint_core(w0, floor, costs, boundary, max_iters=256,
                          check_every=1):
    """Iterate :func:`minplus_sweep_once` from ``w0`` until an iteration
    changes nothing; returns ``(w, iters, converged)`` without raising.

    ``floor`` and ``costs`` may be scalars (a uniform edge cost, e.g. the
    fill's ε) or rasters, ``costs`` (8, H, W); ``boundary``: the off-grid
    value.  Monotone: ``w`` only decreases, so exact-equality convergence
    detection is sound.  On the card a scalar cost with ``boundary =
    -BIG`` runs :func:`fill_fixpoint_core` over the fill kernel (``iters``
    then counts its rotations of four sweeps)."""
    w0 = torch.as_tensor(w0)
    dt, dev = w0.dtype, w0.device
    if (w0.is_cuda and _is_scalar(costs) and w0.dim() == 2
            and np.float32(float(boundary)) == np.float32(-BIG)
            and dt == torch.float32):
        from richdem_tpu_torch.ops.fill import fill_sweep

        fl = torch.as_tensor(floor, dtype=dt, device=dev)
        fl = fl.expand(w0.shape).contiguous()
        return fill_fixpoint_core(w0, fl, float(costs), max_iters,
                                  fill_sweep)
    floor = torch.as_tensor(floor, dtype=dt, device=dev).expand(w0.shape)
    costs = torch.as_tensor(costs, dtype=dt, device=dev).expand(
        (8,) + tuple(w0.shape))
    w, iters, done = w0, 0, False
    while not done and iters < max_iters:
        new = w
        for _ in range(check_every):
            new = minplus_sweep_once(new, floor, costs, boundary)
        done = torch.equal(new, w)
        w = new
        iters += check_every
    return w, iters, done


def minplus_fixpoint(w0, floor, costs, boundary, max_iters=256,
                     check_every=1):
    """Iterate sweeps to convergence; returns ``(w, iters, converged)``
    (:func:`minplus_fixpoint_core`; the reference's jitted entry)."""
    return minplus_fixpoint_core(w0, floor, costs, boundary,
                                 max_iters=max_iters,
                                 check_every=check_every)
