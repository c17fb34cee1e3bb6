"""Multi-flow accumulation by Gauss–Seidel and scan-GS directional sweeps,
and on a card by one pass in topological order.

Counterpart of ``richdem_tpu.ops.pallas_mfd`` (``mfd_accumulation_gs``,
``_mfd_gs_impl``, ``_mfd_gs_impl_small``) and ``richdem_tpu.ops.pallas_scan``
(``_mfd_scan_impl``, ``mfd_accumulation_scan``), and of their TPU kernels
``_mfd_kernel``, ``_mfd_kernel_small`` and ``_mfd_scan_kernel``.  One sweep
of ``A = w + PᵀA`` over plane-major proportions ``(8, H, W)`` takes the
row before at new values, the row after at sweep-start values, and its own
row by the in-row window of ``depth`` columns (:func:`scan_window`):

* ``depth`` 1 — the E/W neighbours' sweep-start values (the GS sweeps,
  ``_mfd_kernel`` and ``_mfd_kernel_small``);
* ``depth`` d ≥ 2 — the in-row E and W chains solved by affine prefix scans
  over the next power of two ≥ d columns, closed with sweep-start values
  (``_mfd_scan_kernel``);
* ``depth`` 0 — the scans over the whole column tile, closed at its
  edges with sweep-start values.

The kernel's column tiles (:data:`~richdem_tpu_torch._build.FLOW_TILE`)
trade their edge values: across a tile edge the row before is read at its
new values, and a window of up to
:data:`~richdem_tpu_torch._build.FLOW_HALO` columns runs on across it, so
at those depths a sweep is the sweep over whole rows, and the rotations
are those of one tile a row.  Every depth reaches the same fixpoint; depth
trades scan steps per sweep against rotations.  A rotation is down, up,
transposed down, transposed up (the reference's ``rrcc`` order), the
transposed sweeps reading the plane stack transposed and permuted
(:func:`transpose_planes`).  A CUDA tensor goes through
``csrc/mfd_sweep.cu``; a CPU tensor through :func:`mfd_sweep_plain`.
Convergence is equality over a whole rotation, and a non-converged result
raises.

On a CUDA tensor :func:`mfd_accumulation` first solves the field once in
topological order (:func:`mfd_topo`, ``csrc/flow_topo.cuh`` over the same
field; plain version :func:`mfd_topo_plain`): a cell takes its value from
its donors once they all have theirs, level after level.  Shares that only
go downhill hold no cycle, so every cell is solved and no rotation runs;
a field with a cycle leaves cells unsolved, and the sweeps run from
``A = w`` as above.  A CPU tensor takes the sweeps.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from richdem_tpu_torch import topology
from richdem_tpu_torch._build import (FLOW_HALO, FLOW_TILE, Kernel,
                                      stream_handle)
from richdem_tpu_torch.debug import span
from richdem_tpu_torch.ops.fill import _require_converged
from richdem_tpu_torch.ops.stencil import as_tensor
from richdem_tpu_torch.ops.sweeps import (PERM_TRANSPOSE,
                                          accumulation_rotations,
                                          accumulation_trios, pad_row)

__all__ = ["MFD_SWEEP", "MFD_TOPO", "MFD_DEPTH", "scan_window", "mfd_sweep",
           "sweep_flags", "mfd_sweep_plain", "transpose_planes",
           "mfd_topo", "mfd_topo_plain", "mfd_accumulation_info",
           "mfd_accumulation"]

_P = ctypes.c_void_p
MFD_SWEEP = Kernel("mfd_sweep", "rd_mfd_sweep",
                   [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, _P, ctypes.c_int, _P])
#: The topological pass, an entry point of the same library
#: (``csrc/mfd_sweep.cu`` over ``csrc/flow_topo.cuh``).
MFD_TOPO = Kernel("mfd_sweep", "rd_mfd_topo",
                  [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                   _P])

#: The in-row scan depth of multi-flow accumulation, chosen on an H100
#: (PERF.md: rotations and time per step at depth 1, 8, 32 and 0).
MFD_DEPTH = 8


def scan_window(depth: int, tile: int = FLOW_TILE) -> int:
    """Columns of the in-row window at ``depth``: 1 at depth 1 (the GS
    sweep), the next power of two ≥ ``depth`` above, ``tile`` at depth 0
    (the whole tile).  A window wider than :data:`FLOW_HALO` stops at the
    tile edge, so it is capped at ``tile``; one up to :data:`FLOW_HALO`
    wide runs across tile edges and is not.  The reference's
    ``_win_lim``."""
    if depth < 0:
        raise ValueError(f"depth must be >= 0, not {depth}")
    if depth == 0:
        return tile
    lim = 1 << (depth - 1).bit_length()
    return lim if lim <= FLOW_HALO else min(lim, tile)


def mfd_sweep_plain(acc_in, w, planes, reverse, depth, tile=FLOW_TILE):
    """Plain version of the sweep kernels (``csrc/flow_sweep.cuh``): a loop
    over rows in sweep order, vectorised across columns, with the kernel's
    grouping of every sum and its Hillis–Steele doubling order.

    ``planes``: (8, H, W) float32 taps, plane d - 1 toward direction d.
    ``tile``: width of the kernel's column tiles.  The row before is read
    at its new values across tile edges, and an in-row window of up to
    :data:`FLOW_HALO` columns runs on across them, as the kernel's tiles
    trade edge values; so at those depths one sweep is the sweep over
    whole rows, whatever ``tile``.  A wider window (depth 0, the whole
    tile) stops at the tile edge and is closed there with the neighbour
    column's sweep-start value, as in the kernel."""
    h, wd = acc_in.shape
    dev = acc_in.device
    lim = scan_window(depth, tile)
    # the window's bounds: the tile's at depth 0 or past FLOW_HALO, else
    # the row's
    span = tile if depth == 0 or lim > FLOW_HALO else max(wd, 1)
    (ns, nw, ne), (os_, ow, oe) = accumulation_trios(reverse)
    out = torch.empty_like(acc_in)
    zero = torch.zeros((), dtype=acc_in.dtype, device=dev)
    one = torch.ones((), dtype=acc_in.dtype, device=dev)
    col = torch.arange(wd, device=dev)
    first = col - col % span                          # window bounds
    last = torch.clamp(first + span, max=wd) - 1
    left, right = col - first, last - col             # room within them
    # padded-row positions of the values that close the windows
    close_e = torch.maximum(first - 1, col - lim) + 1
    close_w = torch.minimum(last + 1, col + lim) + 1

    def shift(x, d, fill, east):
        """x[j - d] (E chain) or x[j + d] (W chain) inside j's bounds."""
        if east:
            return torch.where(left >= d, F.pad(x[:-d], (d, 0)), fill)
        return torch.where(right >= d, F.pad(x[d:], (0, d)), fill)

    rows = list(range(h - 1, -1, -1) if reverse else range(h))
    step = -1 if reverse else 1
    off_grid = torch.zeros(8, wd + 2, dtype=acc_in.dtype, device=dev)
    pa, pt = torch.zeros(wd + 2, dtype=acc_in.dtype, device=dev), off_grid
    for r in rows:
        la, lt = pad_row(acc_in[r]), pad_row(planes[:, r])
        rn = r + step
        if 0 <= rn < h:
            na, nt = pad_row(acc_in[rn]), pad_row(planes[:, rn])
        else:
            na, nt = torch.zeros_like(la), off_grid
        newc = (pa[1:-1] * pt[ns - 1, 1:-1] + pa[:-2] * pt[nw - 1, :-2])
        newc = newc + pa[2:] * pt[ne - 1, 2:]
        oldb = (na[1:-1] * nt[os_ - 1, 1:-1] + na[:-2] * nt[ow - 1, :-2])
        oldb = oldb + na[2:] * nt[oe - 1, 2:]
        base = (w[r] + newc) + oldb
        gate_e, gate_w = lt[4, :-2], lt[0, 2:]  # j-1 toward E, j+1 toward W
        if lim == 1:
            new = (base + gate_e * la[:-2]) + gate_w * la[2:]
        else:
            ea, eb, wa, wb = gate_e, base, gate_w, base
            d = 1
            while d < min(lim, wd):  # past the row, steps change nothing
                eb, ea = (ea * shift(eb, d, zero, True) + eb,
                          ea * shift(ea, d, one, True))
                wb, wa = (wa * shift(wb, d, zero, False) + wb,
                          wa * shift(wa, d, one, False))
                d *= 2
            new_e, new_w = eb + ea * la[close_e], wb + wa * la[close_w]
            new = ((new_e - base) + (new_w - base)) + base
        out[r] = new
        pa, pt = pad_row(new), lt
    return out


def mfd_sweep(acc_in, w, planes, reverse, depth):
    """One directional multi-flow sweep (down, or up if ``reverse``), out of
    place.  A CUDA tensor launches ``csrc/mfd_sweep.cu`` (raising if it
    cannot be built or launched); a CPU tensor runs the plain version."""
    if not acc_in.is_cuda:
        return mfd_sweep_plain(acc_in, w, planes, reverse, depth)
    h, wd = acc_in.shape
    for x, shape, name in ((acc_in, (h, wd), "acc_in"), (w, (h, wd), "w"),
                           (planes, (8, h, wd), "planes")):
        if (x.dtype != torch.float32 or not x.is_contiguous()
                or tuple(x.shape) != shape or x.device != acc_in.device):
            raise ValueError(f"{name}: expected a contiguous float32 "
                             f"tensor {shape} on acc_in's device")
    out = torch.empty_like(acc_in)
    if h == 0 or wd == 0:
        return out
    flags = sweep_flags(wd, acc_in.device)
    MFD_SWEEP.launch(acc_in.data_ptr(), w.data_ptr(), planes.data_ptr(),
                     out.data_ptr(), h, wd, int(bool(reverse)),
                     scan_window(depth), flags.data_ptr(), flags.numel(),
                     stream_handle(acc_in.device))
    return out


def sweep_flags(width, device):
    """Scratch of a flow-sweep launch: one int32 flag a block (a block
    owns at least one tile, wider than :data:`FLOW_HALO`), from PyTorch's
    allocator for each call, so that no two streams share it; the kernel's
    entry point clears it on the launch's stream."""
    return torch.empty(-(-width // FLOW_HALO), dtype=torch.int32,
                       device=device)


def transpose_planes(planes):
    """The plane stack of the transposed grid: plane d - 1 is plane
    ``PERM_TRANSPOSE[d] - 1`` transposed (the reference's
    ``_transpose_props_small``), built one plane at a time."""
    _, h, wd = planes.shape
    out = torch.empty((8, wd, h), dtype=planes.dtype, device=planes.device)
    for d in range(1, 9):
        out[d - 1] = planes[int(PERM_TRANSPOSE[d]) - 1].t()
    return out


def mfd_topo_plain(planes, w, stats=None):
    """Plain version of the topological pass (``csrc/flow_topo.cuh``):
    Kahn's algorithm by levels over the graph of nonzero shares, in float32.
    A cell's value is pulled from its donors once they all have theirs,
    ``((w + a₁·s₁) + a₂·s₂) + …`` over the neighbours d = 1…8 that send it
    a nonzero share ``s_d`` (each product rounded, then each sum), which is
    the kernel's order, so the two agree bitwise whatever the schedule.

    ``planes``: (8, H, W) float32 shares, plane d - 1 toward direction d;
    ``w``: (H, W) float32.  Returns ``(acc, left)``: ``left`` counts the
    cells the pass leaves without a number (on a cycle of the shares or
    downstream of one, where ``acc`` reads 0), and those it solves to NaN,
    on which the sweeps never converge either.  ``stats``, a dict, gains
    ``levels``: the levels the pass solved, the cells on the longest
    chain of donors."""
    _, h, wd = planes.shape
    n = h * wd
    dev = planes.device
    shares = planes.reshape(8, n)
    flat = torch.arange(n, device=dev)
    row, col = flat // max(wd, 1), flat % max(wd, 1)
    nbr, inside = [], []  # by direction: neighbour's flat index, on grid
    for d in range(1, 9):
        dy, dx = int(topology.DY[d]), int(topology.DX[d])
        ok = ((row + dy >= 0) & (row + dy < h) & (col + dx >= 0)
              & (col + dx < wd))
        nbr.append(torch.where(ok, flat + dy * wd + dx, flat))
        inside.append(ok)

    def receivers(cells):  # one entry an edge out of ``cells``
        return torch.cat([nbr[d - 1][cells][inside[d - 1][cells]
                                            & (shares[d - 1, cells] != 0)]
                          for d in range(1, 9)])

    deps = torch.zeros(n, dtype=torch.int32, device=dev)
    recv = receivers(flat)
    deps.index_add_(0, recv, torch.ones_like(recv, dtype=torch.int32))
    acc = torch.zeros(n, dtype=torch.float32, device=dev)
    wf = w.reshape(n)
    ready = torch.nonzero(deps == 0).flatten()
    solved = levels = 0
    while ready.numel():
        levels += 1
        a = wf[ready]
        for d in range(1, 9):
            inv = int(topology.D8_INVERSE[d])
            nb = nbr[d - 1][ready]
            s = torch.where(inside[d - 1][ready], shares[inv - 1, nb], 0.0)
            a = torch.where(s != 0, a + acc[nb] * s, a)
        acc[ready] = a
        solved += int((a == a).sum())
        recv = receivers(ready)
        deps.index_add_(0, recv, torch.full_like(recv, -1,
                                                 dtype=torch.int32))
        recv = torch.unique(recv)
        ready = recv[deps[recv] == 0]
    if stats is not None:
        stats["levels"] = levels
    return acc.view(h, wd), n - solved


def mfd_topo(planes, w):
    """The topological pass over ``(8, H, W)`` float32 shares and ``(H, W)``
    float32 weights, both contiguous; returns ``(acc, left)`` as
    :func:`mfd_topo_plain` does (``acc`` is unwritten where a cell is left
    unsolved).  A CUDA tensor launches ``csrc/flow_topo.cuh``'s two kernels
    and reads the count of solved cells, the pass's one host sync; a CPU
    tensor runs the plain version."""
    if not planes.is_cuda:
        return mfd_topo_plain(planes, w)
    _, h, wd = planes.shape
    for x, shape, name in ((planes, (8, h, wd), "planes"),
                           (w, (h, wd), "w")):
        if (x.dtype != torch.float32 or not x.is_contiguous()
                or tuple(x.shape) != shape or x.device != planes.device):
            raise ValueError(f"{name}: expected a contiguous float32 "
                             f"tensor {shape} on planes' device")
    n = h * wd
    if n > 2**30:
        raise ValueError(f"{h}x{wd}: the topological pass takes at most "
                         "2**30 cells")
    dev = planes.device
    acc = torch.empty((h, wd), dtype=torch.float32, device=dev)
    if n == 0:
        return acc, 0
    deps = torch.empty(n, dtype=torch.int32, device=dev)
    inshare = torch.empty((n, 8), dtype=torch.float32, device=dev)
    order = torch.empty(n, dtype=torch.int64, device=dev)
    ctl = torch.empty(128, dtype=torch.int32, device=dev)
    MFD_TOPO.launch(planes.data_ptr(), w.data_ptr(), acc.data_ptr(),
                    deps.data_ptr(), inshare.data_ptr(), order.data_ptr(),
                    ctl.data_ptr(), h, wd, stream_handle(dev))
    return acc, n - int(ctl[64])  # the control block's count of solved


def _topo_first(planes):
    """Whether :func:`mfd_accumulation` tries the topological pass before
    the sweeps: on a card, where it replaces dozens of rotations, for a
    grid of at most 2**30 cells, which it indexes in int32."""
    return planes.is_cuda and planes[0].numel() <= 2**30


def mfd_accumulation_info(planes, weights, max_rotations=512,
                          depth=MFD_DEPTH, sweep=mfd_sweep):
    """Rotations from ``A = w`` over plane-major proportions ``(8, H, W)``
    until a rotation changes nothing; returns ``(accum, rotations,
    converged)`` without raising."""
    planes = planes.to(torch.float32).contiguous()
    w = weights.to(torch.float32).contiguous()
    planes_t = transpose_planes(planes)
    w_t = w.t().contiguous()
    return accumulation_rotations(
        w, lambda a, rev: sweep(a, w, planes, rev, depth),
        lambda a, rev: sweep(a, w_t, planes_t, rev, depth), max_rotations)


def mfd_accumulation(props, weights=None, no_data_mask=None,
                     max_rotations=512, return_info=False, depth=MFD_DEPTH,
                     device="cuda"):
    """Weighted upstream accumulation from ``(H, W, 8)`` proportions, exact
    at the fixpoint (the topological queue's result).  On a CUDA tensor the
    topological pass (:func:`mfd_topo`) solves an acyclic field with no
    rotation; a field it leaves unsolved, and a CPU tensor, take the sweeps
    (:func:`mfd_accumulation_info` at ``depth``), which raise if
    ``max_rotations`` rotations do not reach the fixpoint.  Zero weight and
    zero output at nodata.  ``return_info`` adds ``(rotations,
    converged)``: ``(0, True)`` after the topological pass.

    ``props``: a tensor (the work runs where it lives) or an array (moved
    to ``device``, as are array weights and masks).  A plane-major stack
    seen as ``(H, W, 8)``, as :func:`~richdem_tpu_torch.ops.flowdirs.
    flow_proportions` returns it, is read without a copy."""
    with span("rd.mfd"):
        props = as_tensor(props, device)
        planes = props.permute(2, 0, 1).to(torch.float32).contiguous()
        h, wd = planes.shape[1:]
        if weights is None:
            weights = torch.ones((h, wd), dtype=torch.float32,
                                 device=planes.device)
        weights = as_tensor(weights, planes.device).to(torch.float32)
        if no_data_mask is not None:
            no_data_mask = as_tensor(no_data_mask, planes.device)
            weights = torch.where(no_data_mask, 0.0, weights)
        topo = _topo_first(planes)
        if topo:
            acc, left = mfd_topo(planes, weights.contiguous())
            rotations, done = 0, True
        if not topo or left:
            acc, rotations, done = mfd_accumulation_info(
                planes, weights, max_rotations, depth)
        _require_converged(done, "multi-flow accumulation", max_rotations)
        if no_data_mask is not None:
            acc = torch.where(no_data_mask, 0.0, acc)
        if return_info:
            return acc, rotations, done
        return acc
