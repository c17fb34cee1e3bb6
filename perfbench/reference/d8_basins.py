"""What the reference works out for basin delineation (fill at ε = 0 → D8
→ flat resolution → watershed labels, Strahler order, D8 accumulation and
the upslope cells of the step's gauges), and the numbers that judge the
program's outputs by it.

The reference starts from the DEM alone: its own fill and D8 codes
(:mod:`~perfbench.reference.fill`, :mod:`~perfbench.reference.flow`),
then flat resolution after Barnes, Lehman & Mulla (2014), *An efficient
assignment of drainage direction over flat surfaces in raster digital
elevation models*, Computers & Geosciences 62:117-127:

* a flat is an 8-connected region of data cells of one elevation that
  holds a cell with no flow (code 0);
* its low edges are the flat's cells that have a code; its high edges are
  its no-flow cells beside a strictly higher data cell;
* ``T``: hop distance towards lower terrain, from the low edges (0)
  through the flat's no-flow cells; ``D``: hop distance away from higher
  terrain, 1 at the high edges, through no-flow cells;
* each no-flow cell that ``T`` reaches gets the mask ``2·T + (maxD + 1 −
  D)``, ``maxD`` the largest ``D`` of its flat, the second term 0 where
  ``D`` does not reach; it flows to the neighbour of its flat of steepest
  descent on the mask, the drop times ``1/DR`` rounded once to float32,
  the first strict maximum in direction order 1..8, and keeps code 0
  unless the descent is above 0.

Departures from the paper, as the program documents its rules: a no-flow
cell on the raster's edge or beside nodata is a drain (the fill drains
off-grid there, so the paper's "cell with a flow direction" off the grid
has code 0 here): it seeds ``T`` at 0 like a low edge and keeps code 0;
the mask is held as integers and its drop taken in the configuration's
precision, where the paper divides in double.  The distance fields are
breadth-first searches in which each level expands only the cells the
last one reached, so their time grows with the flats' cells; ``maxD`` is
taken over connected components found by hooking each edge's larger root
under the smaller and compressing paths.

Watershed labels (the flat index of the cell a path ends at) and the
upslope cells of a set of gauges come from pointer doubling over the
reference's own receivers; the accumulation is float64 of whole weights,
so exact (:func:`perfbench.reference.flow.d8_accumulation`).  Strahler
order is judged by its defining equation over the reference's codes,
which has one solution on a graph with no cycle.  The upslope cells are
those of the step's own gauges, the one output of the program the
reference reads; the gauges are judged by the reference's accumulation.
The control (``control=True``) works every stage in bfloat16, picks its
own 64 gauges from its own accumulation, and solves Strahler order in
topological order over its own codes.
"""

from __future__ import annotations

import torch

from perfbench.reference import fill, flow
from perfbench.reference.grid import DIRECTIONS, DR, DX, DY, shift

#: Whole numbers above this are not all float32 numbers, so a float32
#: accumulation is exact below it and rounds above it.
EXACT_FLOAT32 = 2.0 ** 24
#: Rounds of pointer doubling before a path is taken to hold a cycle.
MAX_DOUBLINGS = 64
#: Directions that meet each undirected edge of the grid once.
HALF = (5, 6, 7, 8)


class _Padded:
    """The grid with a one-cell frame, flattened: a cell's neighbour in
    direction ``d`` is ``i + step[d]`` and never off the array."""

    def __init__(self, shape, device):
        self.h, self.w = shape
        self.wp = self.w + 2
        self.size = (self.h + 2) * self.wp
        self.step = torch.tensor([0] + [DY[d] * self.wp + DX[d]
                                        for d in DIRECTIONS],
                                 dtype=torch.int64, device=device)

    def pad(self, x, value):
        out = torch.full((self.h + 2, self.wp), value, dtype=x.dtype,
                         device=x.device)
        out[1:-1, 1:-1] = x
        return out.reshape(-1)

    def crop(self, x):
        return x.view(self.h + 2, self.wp)[1:-1, 1:-1]


def _bfs(grid, seeds, start, open_, zp):
    """Hop distances (int32, -1 where not reached) from the padded cells
    ``seeds``, at ``start``, through cells of ``open_`` of the same
    elevation as the cell they are reached from; a level at a time, each
    expanding only the cells the last level reached."""
    dist = torch.full((grid.size,), -1, dtype=torch.int32,
                      device=zp.device)
    dist[seeds] = start
    front, level = seeds, start
    steps = grid.step[1:, None]
    while front.numel():
        level += 1
        nb = front[None, :] + steps
        ok = open_[nb] & (zp[nb] == zp[front][None, :]) & (dist[nb] < 0)
        front = torch.unique(nb[ok])
        dist[front] = level
    return dist


def _roots(n, u, v):
    """Root of each of ``n`` nodes under the undirected edges ``(u, v)``:
    every edge between two trees hooks the larger root under the smaller,
    then paths are compressed, until no edge joins two trees."""
    parent = torch.arange(n, dtype=torch.int64, device=u.device)
    while True:
        pu, pv = parent[u], parent[v]
        join = pu != pv
        if not bool(join.any()):
            return parent
        lo = torch.minimum(pu, pv)[join]
        hi = torch.maximum(pu, pv)[join]
        parent.scatter_reduce_(0, hi, lo, "amin")
        while True:
            up = parent[parent]
            if torch.equal(up, parent):
                break
            parent = up


def resolve_flats(filled, codes, nodata, dtype=torch.float32):
    """D8 ``codes`` with the flats of ``filled`` drained (module
    docstring); the descent is taken in ``dtype``."""
    dev = filled.device
    grid = _Padded(filled.shape, dev)
    data = ~nodata
    noflow = (codes == 0) & data
    z = filled.to(dtype)
    nan = float("nan")
    zn = torch.where(nodata, torch.tensor(nan, dtype=dtype, device=dev), z)
    equal = [None] + [zn == shift(zn, d, nan) for d in DIRECTIONS]
    any_equal = torch.zeros_like(data)
    beside_noflow = torch.zeros_like(data)
    higher = torch.zeros_like(data)
    near_nodata = torch.zeros_like(data)
    for d in DIRECTIONS:
        any_equal |= equal[d]
        beside_noflow |= equal[d] & shift(noflow, d, False)
        higher |= shift(zn, d, nan) > zn
        near_nodata |= shift(nodata, d, False)
    edge = torch.ones_like(data)
    edge[1:-1, 1:-1] = False
    drain = noflow & (edge | near_nodata)
    low_edge = data & (codes > 0) & beside_noflow

    zp = grid.pad(zn, nan)
    open_ = grid.pad(noflow, False)
    flat_ix = torch.arange(grid.size, device=dev)
    t = _bfs(grid, flat_ix[grid.pad(drain | low_edge, False)], 0, open_, zp)
    d_away = _bfs(grid, flat_ix[grid.pad(noflow & higher, False)], 1,
                  open_, zp)

    # the largest D of each flat, over the components of equal-z cells
    member = grid.pad(data & any_equal, False)
    ids = flat_ix[member]
    pos = torch.full((grid.size,), -1, dtype=torch.int64, device=dev)
    pos[ids] = torch.arange(ids.numel(), device=dev)
    us, vs = [], []
    for d in HALF:
        nb = ids + grid.step[d]
        ok = member[nb] & (zp[nb] == zp[ids])
        us.append(pos[ids[ok]])
        vs.append(pos[nb[ok]])
    root = _roots(ids.numel(), torch.cat(us), torch.cat(vs))
    d_ids = d_away[ids].clamp(min=0).to(torch.int64)
    top = torch.zeros(ids.numel(), dtype=torch.int64, device=dev)
    top.scatter_reduce_(0, root, d_ids, "amax")
    max_d = torch.zeros(grid.size, dtype=torch.int64, device=dev)
    max_d[ids] = top[root]

    t, d_away, max_d = (grid.crop(x).to(torch.int64)
                        for x in (t, d_away, max_d))
    drained = noflow & ~drain & (t >= 0)
    away = torch.where(d_away > 0, max_d + 1 - d_away, 0)
    mask = torch.where(drained, 2 * t + away, 0)

    best = torch.full(z.shape, -float("inf"), dtype=dtype, device=dev)
    code = torch.zeros_like(codes)
    for d in DIRECTIONS:
        inv = torch.tensor(1.0 / DR[d], dtype=torch.float64) \
            .to(torch.float32).to(dtype).to(dev)
        drop = (mask - shift(mask, d, 0)).to(dtype) * inv
        slope = torch.where(equal[d], drop, -float("inf"))
        take = slope > best
        best = torch.where(take, slope, best)
        code = torch.where(take, torch.tensor(d, dtype=codes.dtype,
                                              device=dev), code)
    code = torch.where(best > 0, code, torch.zeros_like(code))
    return torch.where(drained, code, codes)


def _successors(codes):
    """Flat index of each cell's receiver, its own for a cell that passes
    nothing on (a terminal)."""
    rec = flow._receiver(codes)[:-1]
    own = torch.arange(rec.numel(), device=rec.device)
    return torch.where(rec == rec.numel(), own, rec)


def watershed_labels(codes):
    """The flat index of the terminal each cell's path ends at, by
    pointer doubling; raises if a path holds a cycle."""
    nxt = _successors(codes)
    for _ in range(MAX_DOUBLINGS):
        up = nxt[nxt]
        if torch.equal(up, nxt):
            return nxt.view(codes.shape)
        nxt = up
    raise RuntimeError("reference labels: a flow path holds a cycle")


def upslope(seeds, codes):
    """Cells whose flow path passes through a cell of ``seeds``, the seeds
    included, by pointer doubling over (receiver, hit)."""
    nxt = _successors(codes)
    hit = seeds.reshape(-1).to(torch.bool)
    for _ in range(MAX_DOUBLINGS):
        hit = hit | hit[nxt]
        up = nxt[nxt]
        if torch.equal(up, nxt):
            return hit.view(codes.shape)
        nxt = up
    raise RuntimeError("reference upslope cells: a flow path holds a cycle")


def gauges(acc, k):
    """The ``k`` interior cells of largest accumulation, ties going to the
    lower flat index (a stable sort)."""
    inner = torch.full(acc.shape, -1.0, dtype=torch.float64,
                       device=acc.device)
    inner[1:-1, 1:-1] = acc[1:-1, 1:-1].double()
    order = torch.sort(inner.reshape(-1), descending=True, stable=True)[1]
    out = torch.zeros(acc.numel(), dtype=torch.bool, device=acc.device)
    out[order[:k]] = True
    return out.view(acc.shape)


def strahler(codes):
    """Strahler order (int64, 0 at nodata) over ``codes`` in topological
    order: a cell is done once every cell that flows into it is, with the
    largest order ``m`` of its inflows and how many reach it."""
    n = codes.numel()
    dev = codes.device
    rec = flow._receiver(codes)
    indeg = torch.bincount(rec[:-1], minlength=n + 1)
    order = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    top = torch.zeros_like(order)
    count = torch.zeros_like(order)
    ready = torch.nonzero(indeg[:n] == 0).flatten()
    while ready.numel():
        m, k = top[ready], count[ready]
        order[ready] = torch.where(m == 0, 1, torch.where(k >= 2, m + 1, m))
        to = rec[ready]
        keep = to != n
        to, sent = to[keep], order[ready][keep]
        dest = torch.unique(to)
        before = top[dest]
        top.scatter_reduce_(0, to, sent, "amax")
        count[dest] = torch.where(top[dest] > before, 0, count[dest])
        count.index_add_(0, to, (sent == top[to]).to(torch.int64))
        indeg.index_add_(0, to, torch.full_like(to, -1))
        ready = dest[indeg[dest] == 0]
    return torch.where(codes >= 0, order[:n].view(codes.shape), 0)


def strahler_defects(order, codes):
    """Cells whose order breaks Strahler's defining equation over
    ``codes``: 0 on nodata; else, with ``m`` the largest order of the
    cells whose code points here and ``k`` the number at ``m``: 1 if there
    is none, ``m + 1`` if ``k ≥ 2``, ``m`` otherwise."""
    o = order.to(torch.int64)
    inflow = []
    for d in DIRECTIONS:
        # the direction-d neighbour flows here if its code is d's inverse
        back = 1 + (d + 3) % 8
        inflow.append(torch.where(shift(codes, d, -1) == back,
                                  shift(o, d, 0), 0))
    m = torch.stack(inflow).amax(0)
    k = sum(((x == m) & (m > 0)).to(torch.int64) for x in inflow)
    want = torch.where(m == 0, 1, torch.where(k >= 2, m + 1, m))
    want = torch.where(codes >= 0, want, 0)
    return int((o != want).sum())


def reference(z, nodata, out, cfg, control=False) -> dict:
    """The entry's outputs on ``z`` as the reference works them out; of
    ``out`` (the program's outputs) only the gauges are read, and not by
    the control."""
    low = torch.bfloat16 if control else None
    cs = float(cfg["cellsize"])
    filled = fill.fill_flat(z, nodata, low or torch.float32)
    codes = flow.d8_codes(filled, nodata, cs, low or torch.float32)
    codes = resolve_flats(filled, codes, nodata, low or torch.float32)
    weights = (~nodata).to(low or torch.float64)
    acc = flow.d8_accumulation(codes, weights, low or torch.float64)
    ref = {"filled": filled, "flowdirs": codes,
           "labels": watershed_labels(codes), "accum": acc}
    if control:
        ref["gauges"] = gauges(acc, int(cfg["gauges"]))
        ref["order"] = strahler(codes)
    seeds = ref["gauges"] if control else out["gauges"]
    ref["upslope"] = upslope(seeds.to(z.device), codes)
    return ref


def judge(out, ref, z, nodata, cfg) -> dict:
    """The numbers compared, by name, each with limit 0 but
    ``accum_gap``: cells off the reference's fill, resolved codes, labels
    and upslope mask; cells that break Strahler's equation over the
    reference's codes; accumulation cells off the exact sum below 2²⁴, and
    its widest relative gap; and gauges that are not interior cells, the
    gauges short of or beyond the configuration's count, and interior
    cells passed over for a gauge of a smaller accumulation where no
    accumulation the guarantee allows ranks them below it: exact at or
    below 2²⁴, and within the limit of ``accum_gap`` of exact above."""
    data = ~nodata
    acc, racc = out["accum"].double(), ref["accum"].double()
    exact = racc <= EXACT_FLOAT32
    acc_gap = ((acc - racc).abs() / racc.clamp(min=1.0))[data]
    picked = out["gauges"].to(torch.bool)
    interior = torch.zeros_like(picked)
    interior[1:-1, 1:-1] = True
    gauges_off = int((picked & ~interior).sum()) + abs(
        int(picked.sum()) - int(cfg["gauges"]))
    if bool(picked.any()):
        rel = float(cfg["limits"]["accum_gap"])
        slack = (~exact).double() * rel
        low = racc * (1 - slack)
        high = (racc * (1 + slack))[picked].min()
        gauges_off += int((interior & ~picked & (low > high)).sum())
    return {
        "filled_off": int((out["filled"].float() != ref["filled"].float())
                          .sum()),
        "codes_off": int((out["flowdirs"].to(torch.int8)
                          != ref["flowdirs"].to(torch.int8)).sum()),
        "labels_off": int((out["labels"].to(torch.int64)
                           != ref["labels"]).sum()),
        "order_defects": strahler_defects(out["order"], ref["flowdirs"]),
        "accum_off": int((acc != racc)[exact].sum()),
        "accum_gap": float(acc_gap.max()) if acc_gap.numel() else 0.0,
        "gauges_off": gauges_off,
        "upslope_off": int((out["upslope"].to(torch.bool)
                            != ref["upslope"]).sum()),
    }
