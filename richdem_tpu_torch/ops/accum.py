"""Flow accumulation: D8 by one pass in topological order on a card and by
Gauss–Seidel directional sweeps elsewhere, and the entry points of D∞ and
multi-flow accumulation.

Counterpart of ``richdem_tpu.ops.accum``.  D8 (``_d8_gs_impl``,
``d8_accumulation``) replaces the TPU kernels
``richdem_tpu.ops.pallas_folded._accum_kernel`` /
``pallas_sweeps._accum_down_kernel``.  One sweep solves ``A = w + PᵀA``
along every flow-path segment that is monotone in its direction; a rotation
is down, up, transposed-down, transposed-up (:func:`d8_accumulation_sweeps`).
A CUDA tensor goes through ``csrc/accum_sweep.cu``; a CPU tensor through
:func:`accum_sweep_plain`.  Convergence is equality over a whole rotation
(per-sweep flags chatter in the last bit of float sums), and a
non-converged result raises.

On a CUDA tensor :func:`d8_accumulation_info` first solves the codes once
in topological order (:func:`d8_topo`: ``csrc/flow_topo.cuh`` over the
codes, an entry point of the sweep's library; plain version
:func:`d8_topo_plain`): a cell's value is its weight plus its donors',
pulled once they all have theirs, level after level.  Codes without a
cycle are solved whole and no rotation runs; codes with one leave cells
unsolved, and the sweeps run from ``A = w`` as above.  A CPU tensor takes
the sweeps.

:func:`flow_accumulation_from_props` and
:func:`dinf_accumulation_from_angles` run multi-flow accumulation
(:mod:`~richdem_tpu_torch.ops.mfd`: one topological pass on a card, the
sweeps on the CPU) and the D∞ sweeps (:mod:`~richdem_tpu_torch.ops.dinf`)
on every device, where the reference takes its sweeps only on the TPU and
runs a Jacobi fixpoint elsewhere.  The Jacobi fixpoint
(:func:`accumulation_jacobi_info`) and D8 pointer doubling
(:func:`d8_accumulation_doubling`) stay as plain-PyTorch cross-checks.
"""

from __future__ import annotations

import ctypes
import math

import torch

from richdem_tpu_torch import topology
from richdem_tpu_torch._build import SWEEP_TILE, Kernel, stream_handle
from richdem_tpu_torch.debug import span
from richdem_tpu_torch.ops.dinf import (DINF_DEPTH, dinf_accumulation,
                                        dinf_two_tap)
from richdem_tpu_torch.ops.fill import _require_converged, _rotation_cap
from richdem_tpu_torch.ops.mfd import (MFD_DEPTH, mfd_accumulation,
                                       mfd_topo_plain)
from richdem_tpu_torch.ops.stencil import as_tensor, neighbor
from richdem_tpu_torch.ops.successor import successor_table
from richdem_tpu_torch.ops.sweeps import (PERM_TRANSPOSE,
                                          accumulation_rotations,
                                          accumulation_trios, pad_row,
                                          seam_columns)

__all__ = ["ACCUM_SWEEP", "ACCUM_TOPO", "PERM_TRANSPOSE", "accum_sweep",
           "accum_sweep_plain", "d8_topo", "d8_topo_plain",
           "d8_accumulation_sweeps", "d8_accumulation_info",
           "d8_accumulation",
           "flow_accumulation_from_props", "dinf_accumulation_from_angles",
           "accumulation_jacobi_info", "d8_accumulation_doubling"]

_P = ctypes.c_void_p
ACCUM_SWEEP = Kernel("accum_sweep", "rd_accum_sweep",
                     [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, _P])
#: The topological pass, an entry point of the same library
#: (``csrc/accum_sweep.cu`` over ``csrc/flow_topo.cuh``).
ACCUM_TOPO = Kernel("accum_sweep", "rd_accum_topo",
                    [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                     _P])


def accum_sweep_plain(acc_in, w, fd, reverse, tile=SWEEP_TILE):
    """Plain version of the accumulation-sweep kernel
    (``csrc/accum_sweep.cu``): a loop over rows in sweep order, vectorised
    across columns, with the kernel's grouping of the sum.

    ``tile``: width of the kernel's column tiles.  Across a tile edge the
    row before is read at its sweep-start values, as the kernel does, so one
    sweep is bitwise the kernel's."""
    h, wd = acc_in.shape
    dev = acc_in.device
    (ns, nw, ne), (os_, ow, oe) = accumulation_trios(reverse)
    out = torch.empty_like(acc_in)
    zero = torch.zeros((), dtype=acc_in.dtype, device=dev)
    lseam, rseam = seam_columns(wd, tile, dev)
    rows = list(range(h - 1, -1, -1) if reverse else range(h))
    step = -1 if reverse else 1
    pa = torch.zeros(wd + 2, dtype=acc_in.dtype, device=dev)
    pf = torch.zeros(wd + 2, dtype=fd.dtype, device=dev)
    for k, r in enumerate(rows):
        la, lf = pad_row(acc_in[r]), pad_row(fd[r])
        rn = r + step
        if 0 <= rn < h:
            na, nf = pad_row(acc_in[rn]), pad_row(fd[rn])
        else:
            na, nf = torch.zeros_like(la), torch.zeros_like(lf)
        west, east = pa[:-2], pa[2:]
        if k > 0 and lseam.numel():
            old = pad_row(acc_in[rows[k - 1]])
            west, east = west.clone(), east.clone()
            west[lseam] = old[lseam]       # old[c - 1] in padded coords
            east[rseam] = old[rseam + 2]   # old[c + 1]
        newc = (torch.where(pf[1:-1] == ns, pa[1:-1], zero)
                + torch.where(pf[:-2] == nw, west, zero))
        newc = newc + torch.where(pf[2:] == ne, east, zero)
        oldb = (torch.where(nf[1:-1] == os_, na[1:-1], zero)
                + torch.where(nf[:-2] == ow, na[:-2], zero))
        oldb = oldb + torch.where(nf[2:] == oe, na[2:], zero)
        oldl = (torch.where(lf[:-2] == 5, la[:-2], zero)
                + torch.where(lf[2:] == 1, la[2:], zero))
        new = ((w[r] + newc) + oldb) + oldl
        out[r] = new
        pa, pf = pad_row(new), lf
    return out


def accum_sweep(acc_in, w, fd, reverse):
    """One directional accumulation sweep (down, or up if ``reverse``), out
    of place.  A CUDA tensor launches ``csrc/accum_sweep.cu`` (raising if it
    cannot be built or launched); a CPU tensor runs the plain version."""
    if not acc_in.is_cuda:
        return accum_sweep_plain(acc_in, w, fd, reverse)
    for x, dt, name in ((acc_in, torch.float32, "acc_in"),
                        (w, torch.float32, "w"), (fd, torch.int8, "fd")):
        if (x.dim() != 2 or x.dtype != dt or not x.is_contiguous()
                or x.shape != acc_in.shape or x.device != acc_in.device):
            raise ValueError(f"{name}: expected a contiguous {dt} tensor "
                             f"shaped and placed like acc_in")
    h, wd = acc_in.shape
    out = torch.empty_like(acc_in)
    if h == 0 or wd == 0:
        return out
    ACCUM_SWEEP.launch(acc_in.data_ptr(), w.data_ptr(), fd.data_ptr(),
                       out.data_ptr(), h, wd, int(bool(reverse)),
                       stream_handle(acc_in.device))
    return out


def d8_topo_plain(flowdirs, w, stats=None):
    """Plain version of the topological pass over D8 codes: the multi-flow
    pass's plain version (:func:`~richdem_tpu_torch.ops.mfd.mfd_topo_plain`)
    over one-hot planes of the codes, a share of 1 toward the direction a
    code in 1..8 names.  A product by 1 is exact, so this is the kernel's
    sum ``((w + a₁) + a₂) + …`` over the donors in direction order, bitwise.

    ``flowdirs``: (H, W) codes (≤ 0 and off-grid targets send nothing);
    ``w``: (H, W) float32.  Returns ``(acc, left)`` as ``mfd_topo_plain``
    does: ``left`` counts the cells on a cycle (each sends only to the
    next, so nothing lies downstream of one) and those solved to NaN;
    ``stats`` gains the count of levels."""
    fd = flowdirs.to(torch.int64)
    planes = torch.stack([(fd == d) for d in range(1, 9)]).to(torch.float32)
    return mfd_topo_plain(planes, w.to(torch.float32), stats)


def d8_topo(flowdirs, w):
    """The topological pass over ``(H, W)`` int8 codes and float32 weights,
    both contiguous; returns ``(acc, left)`` as :func:`d8_topo_plain` does
    (``acc`` is unwritten where a cell is left unsolved).  A CUDA tensor
    launches ``csrc/flow_topo.cuh``'s two kernels over the codes and reads
    the count of solved cells, the pass's one host sync; a CPU tensor runs
    the plain version."""
    if not flowdirs.is_cuda:
        return d8_topo_plain(flowdirs, w)
    for x, dt, name in ((flowdirs, torch.int8, "flowdirs"),
                        (w, torch.float32, "w")):
        if (x.dim() != 2 or x.dtype != dt or not x.is_contiguous()
                or x.shape != flowdirs.shape or x.device != flowdirs.device):
            raise ValueError(f"{name}: expected a contiguous {dt} tensor "
                             f"shaped and placed like flowdirs")
    h, wd = flowdirs.shape
    n = h * wd
    if n > 2**30:
        raise ValueError(f"{h}x{wd}: the topological pass takes at most "
                         "2**30 cells")
    dev = flowdirs.device
    acc = torch.empty((h, wd), dtype=torch.float32, device=dev)
    if n == 0:
        return acc, 0
    deps = torch.empty(n, dtype=torch.int32, device=dev)
    order = torch.empty(n, dtype=torch.int64, device=dev)
    ctl = torch.empty(128, dtype=torch.int32, device=dev)
    ACCUM_TOPO.launch(flowdirs.data_ptr(), w.data_ptr(), acc.data_ptr(),
                      deps.data_ptr(), order.data_ptr(), ctl.data_ptr(), h,
                      wd, stream_handle(dev))
    return acc, n - int(ctl[64])  # the control block's count of solved


def _topo_first(fd):
    """Whether :func:`d8_accumulation_info` tries the topological pass
    before the sweeps: on a card, for a grid of at most 2**30 cells, which
    it indexes in int32."""
    return fd.is_cuda and fd.numel() <= 2**30


def d8_accumulation_sweeps(flowdirs, weights, max_rotations=64,
                           sweep=accum_sweep):
    """GS rotations from ``A = w`` until a rotation changes nothing; returns
    ``(accum, rotations, converged)`` without raising.  Nodata codes (< 0)
    act as NO_FLOW; give them zero weight."""
    fd = flowdirs.to(torch.int8).contiguous()
    w = weights.to(torch.float32).contiguous()
    perm = torch.as_tensor(PERM_TRANSPOSE, device=fd.device)
    fd_t = perm[fd.clamp(min=0).long()].t().contiguous()
    w_t = w.t().contiguous()
    return accumulation_rotations(
        w, lambda a, rev: sweep(a, w, fd, rev),
        lambda a, rev: sweep(a, w_t, fd_t, rev), max_rotations)


def d8_accumulation_info(flowdirs, weights, max_rotations=64):
    """Exact D8 accumulation; returns ``(accum, rotations, converged)``
    without raising.  On a card the topological pass (:func:`d8_topo`)
    solves codes without a cycle with no rotation: ``(accum, 0, True)``.
    Codes it leaves unsolved, a CPU tensor and a card grid past 2**30
    cells take the sweeps (:func:`d8_accumulation_sweeps`), at most
    ``max_rotations`` rotations.  Nodata codes (< 0) act as NO_FLOW; give
    them zero weight."""
    with span("rd.accum"):
        fd = flowdirs.to(torch.int8).contiguous()
        w = weights.to(torch.float32).contiguous()
        if _topo_first(fd):
            acc, left = d8_topo(fd, w)
            if not left:
                return acc, 0, True
        return d8_accumulation_sweeps(fd, w, max_rotations)


def d8_accumulation(flowdirs, weights=None, no_data_mask=None,
                    max_rotations=64, device="cuda"):
    """Exact D8 accumulation; raises if ``max_rotations`` rotations do not
    reach the fixpoint.  Zero weight and zero output at nodata.

    ``flowdirs``: a tensor (the work runs where it lives) or an array
    (moved to ``device``, as are array weights and masks)."""
    fd = as_tensor(flowdirs, device)
    if weights is not None:
        weights = as_tensor(weights, fd.device)
    if no_data_mask is not None:
        no_data_mask = as_tensor(no_data_mask, fd.device)
    if weights is None:
        weights = torch.ones(fd.shape, dtype=torch.float32, device=fd.device)
    weights = weights.to(torch.float32)
    if no_data_mask is not None:
        weights = torch.where(no_data_mask, 0.0, weights)
    acc, _, done = d8_accumulation_info(fd, weights, max_rotations)
    _require_converged(done, "D8 GS accumulation", max_rotations)
    if no_data_mask is not None:
        acc = torch.where(no_data_mask, 0.0, acc)
    return acc


def flow_accumulation_from_props(props, weights=None, no_data_mask=None,
                                 max_rotations=None, return_info=False,
                                 depth=MFD_DEPTH, device="cuda",
                                 max_iters=None):
    """Weighted upstream accumulation from ``(H, W, 8)`` proportions, by
    :func:`~richdem_tpu_torch.ops.mfd.mfd_accumulation` (one topological
    pass on a card, the sweeps on the CPU or where the shares hold a
    cycle).  Nodata cells must already have zero proportions
    (:func:`~richdem_tpu_torch.ops.flowdirs.flow_proportions` gives them
    that); the mask zeroes their weight and output.  ``return_info`` adds
    ``(rotations, converged)``.  ``max_rotations`` (512 by default) bounds
    the sweeps, as on the TPU; the reference's ``max_iters``, which bounds
    its CPU Jacobi fallback, is taken as the same cap (give one of the
    two)."""
    cap = _rotation_cap(max_rotations, max_iters, 512)
    return mfd_accumulation(props, weights, no_data_mask, cap, return_info,
                            depth, device)


def dinf_accumulation_from_angles(angles, weights=None, no_data_mask=None,
                                  return_info=False, max_rotations=512,
                                  depth=DINF_DEPTH, device="cuda"):
    """D∞ accumulation straight from the Tarboton angle raster, by the
    two-tap sweeps (:func:`~richdem_tpu_torch.ops.dinf.dinf_accumulation`)
    on every device (the reference's TPU path; its CPU path runs Jacobi
    over unsnapped proportions).  ``return_info`` adds ``(rotations,
    converged)``."""
    with span("rd.dinf"):
        a = as_tensor(angles, device)
        code, p = dinf_two_tap(a)
        return dinf_accumulation(code, p, weights, no_data_mask,
                                 max_rotations, return_info, depth)


def _inflow_step(acc, props):
    """One application of Pᵀ: the neighbour in direction d sends
    ``acc * props[..., inverse(d) - 1]``."""
    total = torch.zeros_like(acc)
    for d in range(1, 9):
        inv = int(topology.D8_INVERSE[d])
        total = total + neighbor(acc * props[..., inv - 1], d, 0.0)
    return total


def accumulation_jacobi_info(props, weights=None, max_iters=4096,
                             check_every=8):
    """Jacobi accumulation ``A ← w + PᵀA`` from ``(H, W, 8)`` proportions;
    returns ``(accum, iters, converged)``.  Converges in longest-flow-path
    iterations: a cross-check, not a fast path."""
    h, w, _ = props.shape
    dtype = torch.float64 if props.dtype == torch.float64 else torch.float32
    props = props.to(dtype)
    if weights is None:
        weights = torch.ones((h, w), dtype=dtype, device=props.device)
    weights = weights.to(dtype)
    acc, iters, done = weights, 0, False
    while not done and iters < max_iters:
        new = acc
        for _ in range(check_every):
            new = weights + _inflow_step(new, props)
        done = torch.equal(new, acc)
        acc = new
        iters += check_every
    return acc, iters, done


def d8_accumulation_doubling(flowdirs, weights=None, no_data_mask=None,
                             rounds=None, device="cuda"):
    """Exact D8 accumulation in ⌈log₂(n)⌉ pointer-doubling rounds: each
    cell adds its mass to its 2ᵏ-th successor, then squares the pointer
    (NO_FLOW, nodata and off-grid targets drain to a sink).  A cross-check
    of :func:`d8_accumulation`; scatter adds in float32 regroup sums."""
    fd = as_tensor(flowdirs, device).to(torch.int64)
    dev = fd.device
    h, w = fd.shape
    n = h * w
    if weights is None:
        weights = torch.ones((h, w), dtype=torch.float32, device=dev)
    weights = as_tensor(weights, dev).to(torch.float32)
    if no_data_mask is not None:
        no_data_mask = as_tensor(no_data_mask, dev)
        weights = torch.where(no_data_mask, 0.0, weights)
    if rounds is None:
        rounds = max(1, math.ceil(math.log2(max(n, 2))))
    sink = torch.tensor([n], device=dev)
    succ = torch.cat([successor_table(fd, terminal=n), sink])
    acc = torch.cat([weights.reshape(-1), weights.new_zeros(1)])
    live = torch.arange(n + 1, device=dev) < n
    for _ in range(rounds):
        acc = acc.index_add(0, succ, torch.where(live, acc, 0.0))
        succ = succ[succ]
    acc = acc[:n].reshape(h, w)
    if no_data_mask is not None:
        acc = torch.where(no_data_mask, 0.0, acc)
    return acc
