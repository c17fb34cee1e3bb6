"""D8 flow accumulation by Gauss–Seidel directional sweeps.

Counterpart of ``richdem_tpu.ops.accum`` (``_d8_gs_impl``,
``d8_accumulation``) and of the TPU kernels
``richdem_tpu.ops.pallas_folded._accum_kernel`` /
``pallas_sweeps._accum_down_kernel``.  One sweep solves ``A = w + PᵀA``
along every flow-path segment that is monotone in its direction; a rotation
is down, up, transposed-down, transposed-up.  A CUDA tensor goes through
``csrc/accum_sweep.cu``; a CPU tensor through :func:`accum_sweep_plain`.
Convergence is equality over a whole rotation (per-sweep flags chatter in
the last bit of float sums), and a non-converged result raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from richdem_tpu_torch import topology
from richdem_tpu_torch._build import SWEEP_TILE, Kernel, stream_handle
from richdem_tpu_torch.ops.fill import _require_converged
from richdem_tpu_torch.ops.stencil import as_tensor
from richdem_tpu_torch.ops.sweeps import seam_columns

__all__ = ["ACCUM_SWEEP", "PERM_TRANSPOSE", "accum_sweep",
           "accum_sweep_plain", "d8_accumulation_info", "d8_accumulation"]

_P = ctypes.c_void_p
ACCUM_SWEEP = Kernel("accum_sweep", "rd_accum_sweep",
                     [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, _P])


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


def _trios(reverse):
    """(new-side, old-side) code trios (straight, west source, east
    source): the row before in sweep order feeds the new side."""
    down, up = (7, 6, 8), (3, 4, 2)
    return (up, down) if reverse else (down, up)


def _pad1(x):
    return F.pad(x[None], (1, 1))[0]


def accum_sweep_plain(acc_in, w, fd, reverse, tile=SWEEP_TILE):
    """Plain version of the accumulation-sweep kernel
    (``csrc/accum_sweep.cu``): a loop over rows in sweep order, vectorised
    across columns, with the kernel's grouping of the sum.

    ``tile``: width of the kernel's column tiles.  Across a tile edge the
    row before is read at its sweep-start values, as the kernel does, so one
    sweep is bitwise the kernel's."""
    h, wd = acc_in.shape
    dev = acc_in.device
    (ns, nw, ne), (os_, ow, oe) = _trios(reverse)
    out = torch.empty_like(acc_in)
    zero = torch.zeros((), dtype=acc_in.dtype, device=dev)
    lseam, rseam = seam_columns(wd, tile, dev)
    rows = list(range(h - 1, -1, -1) if reverse else range(h))
    step = -1 if reverse else 1
    pa = torch.zeros(wd + 2, dtype=acc_in.dtype, device=dev)
    pf = torch.zeros(wd + 2, dtype=fd.dtype, device=dev)
    for k, r in enumerate(rows):
        la, lf = _pad1(acc_in[r]), _pad1(fd[r])
        rn = r + step
        if 0 <= rn < h:
            na, nf = _pad1(acc_in[rn]), _pad1(fd[rn])
        else:
            na, nf = torch.zeros_like(la), torch.zeros_like(lf)
        west, east = pa[:-2], pa[2:]
        if k > 0 and lseam.numel():
            old = _pad1(acc_in[rows[k - 1]])
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
        pa, pf = _pad1(new), lf
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


def d8_accumulation_info(flowdirs, weights, max_rotations=64,
                         sweep=accum_sweep):
    """GS rotations from ``A = w`` until a rotation changes nothing; returns
    ``(accum, rotations, converged)`` without raising.  Nodata codes (< 0)
    act as NO_FLOW; give them zero weight."""
    fd = flowdirs.to(torch.int8).contiguous()
    w = weights.to(torch.float32).contiguous()
    perm = torch.as_tensor(PERM_TRANSPOSE, device=fd.device)
    fd_t = perm[fd.clamp(min=0).long()].t().contiguous()
    w_t = w.t().contiguous()
    acc = w
    rotations, converged = 0, False
    while rotations < max_rotations:
        new = sweep(acc, w, fd, False)
        new = sweep(new, w, fd, True)
        t = sweep(new.t().contiguous(), w_t, fd_t, False)
        t = sweep(t, w_t, fd_t, True)
        new = t.t().contiguous()
        rotations += 1
        converged = torch.equal(new, acc)
        acc = new
        if converged:
            break
    return acc, rotations, converged


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
