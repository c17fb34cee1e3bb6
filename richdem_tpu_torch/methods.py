"""Derived hydrological methods: TWI/SPI, watersheds, upslope cells,
Strahler order.

Counterpart of ``richdem_tpu.methods``.  Watershed labels and upslope
masks are the successor resolve's fixpoint: each cell takes the value of
the first terminal or seed on its path.  Cells that point off the grid
are terminals, as in the reference (``richdem_tpu/methods.py:80-87``,
``:105-112``).
On every device one engine reaches that fixpoint, pointer jumping over
tile exits (``ops.successor.successor_jump``): the kernels of
``csrc/successor_jump.cuh`` on a card, which index at most 2**30 cells
(a larger card grid raises), and their plain version on the CPU.
The fixpoint is unique, so the labels are the resolve sweeps' bit for
bit; the sweeps' rotations grow with every turn of a path, the jump's
rounds with log₂ of its length.  Strahler order, a maximum over donors
and not a copy from the successor, keeps the hand-written sweeps
(:mod:`richdem_tpu_torch.ops.successor`).

The reference's other engines, log-depth pointer doubling over the
successor table and the Jacobi Strahler fixpoint, are kept as plain
PyTorch cross-checks (:func:`watersheds_doubling`,
:func:`upslope_doubling`, :func:`strahler_jacobi`).
"""

from __future__ import annotations

import math

import torch

from richdem_tpu_torch import topology
from richdem_tpu_torch.debug import span
from richdem_tpu_torch.ops.fill import _require_converged, _rotation_cap
from richdem_tpu_torch.ops.stencil import as_tensor, neighbor
from richdem_tpu_torch.ops.successor import (strahler_fixpoint,
                                             successor_jump,
                                             successor_table)

__all__ = ["twi", "spi", "watersheds_from_flowdirs", "upslope_cells",
           "strahler_order", "watersheds_doubling", "upslope_doubling",
           "strahler_jacobi"]


def twi(accum, slope_radians, cellsize=1.0, min_slope=1e-6):
    """Topographic wetness index ``ln(a / tan beta)``; ``a`` = specific
    catchment area = accumulation × cellsize."""
    with span("rd.terrain"):
        a = accum * cellsize
        tanb = torch.clamp(torch.tan(slope_radians), min=min_slope)
        return torch.log(torch.clamp(a, min=1e-30) / tanb)


def spi(accum, slope_radians, cellsize=1.0):
    """Stream power index ``a · tan beta``; ``a`` = accumulation ×
    cellsize."""
    return accum * cellsize * torch.tan(slope_radians)


def watersheds_from_flowdirs(flowdirs, return_info=False, device="cuda"):
    """Label every cell with the flat index of its terminal cell (int32):
    the drainage-basin partition (reference ``find_watersheds``).  Nodata
    and NO_FLOW cells, and cells pointing off the grid, label themselves.
    Raises ``ValueError`` if the codes hold a cycle (a cell that never
    reaches a terminal), or for a card grid the jump cannot index.  ``return_info`` adds ``(0, "jump")``: the jump
    (``successor_jump``) runs no rotation.  ``flowdirs``: a tensor (the
    work runs where it lives) or an array (moved to ``device``)."""
    with span("rd.watersheds"):
        labels = successor_jump(as_tensor(flowdirs, device))
        cyclic = int((labels < 0).sum())
        if cyclic:
            raise ValueError(f"flow directions hold a cycle: {cyclic} cells "
                             "never reach a terminal")
        return (labels, 0, "jump") if return_info else labels


def upslope_cells(seed_mask, flowdirs, return_info=False, device="cuda"):
    """Cells whose flow path passes through any seed cell, the seeds
    included (reference ``d8_upslope_cells``); bool, by the jump
    (``successor_jump``).  ``return_info`` adds ``(0, "jump")`` as
    :func:`watersheds_from_flowdirs` does.  Tensors run where ``flowdirs``
    lives; arrays move to ``device``."""
    with span("rd.upslope"):
        fd = as_tensor(flowdirs, device)
        up = successor_jump(fd, as_tensor(seed_mask, fd.device))
        return (up, 0, "jump") if return_info else up


def strahler_order(flowdirs, max_rotations=None, return_info=False,
                   device="cuda", max_iters=None):
    """Strahler stream order (int32): 1 on cells with no inflow, ``m``
    where one inflow attains the largest inflow order ``m``, ``m + 1``
    where two or more do; 0 on nodata.  Raises if ``max_rotations``
    rotations (64 by default) do not reach the fixpoint; ``max_iters`` is
    the reference's name for that cap (give one of the two).
    ``return_info`` adds ``(rotations, converged)``.  ``flowdirs``: a
    tensor (the work runs where it lives) or an array (moved to
    ``device``)."""
    with span("rd.strahler"):
        cap = _rotation_cap(max_rotations, max_iters, 64)
        return strahler_fixpoint(as_tensor(flowdirs, device), cap,
                                 return_info)


def _rounds(fd):
    return max(1, math.ceil(math.log2(max(fd.numel(), 2))))


def watersheds_doubling(flowdirs, device="cuda"):
    """Watershed labels by ⌈log₂ n⌉ rounds of pointer doubling over the
    successor table (the reference's engine off the TPU); int32."""
    fd = as_tensor(flowdirs, device)
    succ = successor_table(fd)
    for _ in range(_rounds(fd)):
        succ = succ[succ]
    return succ.view(fd.shape).to(torch.int32)


def upslope_doubling(seed_mask, flowdirs, device="cuda"):
    """Upslope cells by pointer doubling on (successor, hit): after round
    k a cell knows whether a seed lies within 2ᵏ steps downstream."""
    fd = as_tensor(flowdirs, device)
    succ = successor_table(fd)
    hit = as_tensor(seed_mask, fd.device).to(torch.bool).reshape(-1)
    for _ in range(_rounds(fd)):
        hit = hit | hit[succ]
        succ = succ[succ]
    return hit.view(fd.shape)


def _strahler_step(order, fd, data):
    """One Jacobi application of the Strahler rule to every cell."""
    inflow = torch.stack([
        torch.where(neighbor(fd, d, -1) == int(topology.D8_INVERSE[d]),
                    neighbor(order, d, 0), 0) for d in range(1, 9)])
    m = inflow.amax(0)
    at_max = ((inflow == m) & (m > 0)).sum(0)
    new = torch.where(m == 0, 1, torch.where(at_max >= 2, m + 1, m))
    return torch.where(data, torch.maximum(order, new), 0).to(torch.int32)


def strahler_jacobi(flowdirs, max_iters=4096, check_every=16,
                    return_info=False, device="cuda"):
    """Strahler order by the reference's Jacobi fixpoint (one application
    of the rule to every cell per iteration; it converges in as many
    iterations as the longest flow path has steps).  Raises if
    ``max_iters`` iterations do not reach it; ``return_info`` adds
    ``(iterations, converged)``.  Equality is checked every
    ``check_every`` iterations."""
    fd = as_tensor(flowdirs, device).to(torch.int32)
    data = fd >= 0
    order = data.to(torch.int32)
    iters, done = 0, False
    while not done and iters < max_iters:
        new = order
        for _ in range(check_every):
            new = _strahler_step(new, fd, data)
        iters += check_every
        done = torch.equal(new, order)
        order = new
    _require_converged(done, "Jacobi Strahler order", max_iters)
    return (order, iters, done) if return_info else order
