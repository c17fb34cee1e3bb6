"""D8 codes, Quinn proportions and both accumulations, worked out by the
reference.

* :func:`d8_codes`: steepest descent, the slope toward each data
  neighbour ``(z - z_n) / (DR_d · cellsize)`` in the precision asked for,
  the first strict maximum in direction order 1..8, no flow (0) unless
  the best slope is above 0, -1 at nodata.  The distance is a tensor, so a
  division on the card is a true division.
* :func:`d8_accumulation`: ``A(c) = Σ w(u)`` over the cells ``u`` whose
  flow path passes through ``c``, by pointer doubling: level ``k`` adds
  the sums of the cells ``2^k`` steps upstream.  In float64 with whole
  weights every sum is exact, whatever the order of the atomic adds.
* :func:`quinn_planes`: Quinn (1991) multi-flow shares, ``max(slope_d,
  0)`` over their total, toward data neighbours only, 0 at nodata, as
  plane-major ``(8, H, W)``.
* :func:`mfd_accumulation`: ``A = w + PᵀA`` in topological order: each
  level takes the cells all of whose upstream neighbours are done, as a
  queue would, but a level at a time.
"""

from __future__ import annotations

import torch

from perfbench.reference.grid import (DIRECTIONS, DR, DX, DY, NODATA_CODE,
                                      shift, toward)

#: Slope that marks an off-grid or nodata neighbour.
_INVALID = -3.0e38


def d8_codes(filled: torch.Tensor, nodata: torch.Tensor, cellsize=1.0,
             dtype=torch.float32) -> torch.Tensor:
    """int8 D8 codes of ``filled``, computed in ``dtype``."""
    dev = filled.device
    z = filled.to(dtype)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    zed = torch.where(nodata, inf, z)
    best = torch.full(z.shape, _INVALID, dtype=dtype, device=dev)
    code = torch.zeros(z.shape, dtype=torch.int8, device=dev)
    cs = torch.tensor(cellsize, dtype=dtype, device=dev)
    for d in DIRECTIONS:
        zn = shift(zed, d, float("inf"))
        dist = torch.tensor(DR[d], dtype=dtype, device=dev) * cs
        slope = torch.where(torch.isinf(zn), best.new_tensor(_INVALID),
                            (z - zn) / dist)
        take = slope > best
        best = torch.where(take, slope, best)
        code = torch.where(take, torch.tensor(d, dtype=torch.int8,
                                              device=dev), code)
    code = torch.where(best > 0, code, torch.zeros_like(code))
    return torch.where(nodata, torch.full_like(code, NODATA_CODE), code)


def _receiver(codes: torch.Tensor) -> torch.Tensor:
    """Flat index of each cell's receiver, ``n`` (one past the last cell,
    a sink that points to itself) for cells that pass nothing on."""
    h, w = codes.shape
    n = h * w
    dev = codes.device
    flat = torch.arange(n, dtype=torch.int64, device=dev).view(h, w)
    c = codes.long().clamp(min=0)
    dx = torch.tensor(DX, dtype=torch.int64, device=dev)[c]
    dy = torch.tensor(DY, dtype=torch.int64, device=dev)[c]
    row = torch.arange(h, device=dev)[:, None] + dy
    col = torch.arange(w, device=dev)[None, :] + dx
    inside = (row >= 0) & (row < h) & (col >= 0) & (col < w) & (c > 0)
    rec = torch.where(inside, flat + dy * w + dx, n)
    return torch.cat([rec.reshape(-1), rec.new_tensor([n])])


def d8_accumulation(codes: torch.Tensor, weights: torch.Tensor,
                    dtype=torch.float64) -> torch.Tensor:
    """D8 accumulation of ``weights`` along ``codes``, in ``dtype``."""
    h, w = codes.shape
    nxt = _receiver(codes)
    total = torch.cat([weights.reshape(-1).to(dtype),
                       weights.new_zeros(1, dtype=dtype)])
    sink = h * w
    while bool((nxt[:-1] != sink).any()):
        total = total.index_add(0, nxt, total)
        total[sink] = 0
        nxt = nxt[nxt]
    return total[:-1].view(h, w)


def quinn_planes(filled: torch.Tensor, nodata: torch.Tensor, cellsize=1.0,
                 dtype=torch.float64) -> torch.Tensor:
    """(8, H, W) Quinn proportions of ``filled``, computed in ``dtype``."""
    dev = filled.device
    z = filled.to(dtype)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    zed = torch.where(nodata, inf, z)
    cs = torch.tensor(cellsize, dtype=dtype, device=dev)
    planes = torch.empty((8,) + tuple(z.shape), dtype=dtype, device=dev)
    for d in DIRECTIONS:
        zn = shift(zed, d, float("inf"))
        dist = torch.tensor(DR[d], dtype=dtype, device=dev) * cs
        slope = torch.where(torch.isinf(zn), z.new_tensor(0.0),
                            (z - zn) / dist)
        planes[d - 1] = slope.clamp(min=0)
    total = planes.sum(0)
    planes /= torch.maximum(total, total.new_tensor(1e-30))
    planes.masked_fill_(nodata, 0.0)
    return planes


def mfd_accumulation(planes: torch.Tensor, weights: torch.Tensor,
                     dtype=torch.float64) -> torch.Tensor:
    """Multi-flow accumulation of ``weights`` over (8, H, W) shares, in
    ``dtype``; raises if the shares hold a cycle."""
    _, h, w = planes.shape
    dev = planes.device
    n = h * w
    sends = planes > 0
    indeg = torch.zeros((h, w), dtype=torch.int32, device=dev)
    for d in DIRECTIONS:
        indeg += toward(sends[d - 1].to(torch.int32), d, 0)
    indeg = indeg.reshape(-1)
    share = planes.reshape(8, n)
    acc = weights.reshape(-1).to(dtype).clone()
    step = torch.tensor([DY[d] * w + DX[d] for d in DIRECTIONS],
                        dtype=torch.int64, device=dev)[:, None]
    ready = torch.nonzero(indeg == 0).flatten()
    done = 0
    while ready.numel():
        done += ready.numel()
        p = share[:, ready]
        go = p > 0
        dst = (ready[None, :] + step)[go]
        acc.index_add_(0, dst, (acc[ready][None, :] * p)[go].to(dtype))
        indeg.index_add_(0, dst, torch.full_like(dst, -1,
                                                 dtype=torch.int32))
        dst = torch.unique(dst)
        ready = dst[indeg[dst] == 0]
    if done != n:
        raise RuntimeError(f"reference accumulation: {n - done} cells lie "
                           "on a cycle of the shares")
    return acc.view(h, w)
