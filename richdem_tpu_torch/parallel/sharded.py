"""Sharded terrain ops: halo exchange over a 2-D device mesh.

Counterpart of ``richdem_tpu.parallel.sharded`` (``shard_map`` + halo
exchange).  A raster is split into the mesh's blocks, one per position
(:mod:`~richdem_tpu_torch.parallel.mesh`), and each block is worked where
its position's device is, through the port's kernels on the card and
their plain versions on the CPU:

* **stencil ops** (terrain attributes, D8 codes): one halo exchange, the
  single-device op on the extended block (``d8_core``, ``terrain_fused``),
  crop — bitwise the single-device op;
* **fill**: block-Schwarz iteration from ``w = BIG`` — each outer step
  exchanges a 1-cell halo of the current surface, solves the local fill
  fixpoint exactly on the extended block with its ring clamped
  (:func:`~richdem_tpu_torch.parallel.consumer._local_fill_solve`, the
  fill kernel from ``w0``), and ORs a changed-flag over the mesh.  Monotone,
  so it reaches the greatest fixpoint, bitwise the single-device fill from
  BIG, in O(mesh diameter) outer steps;
* **D8 and multi-flow accumulation**: block-Schwarz like the fill — ring
  inflow from the neighbours' halo cells that flow in, an exact local
  solve with ``weights + inflow`` (the accumulation and multi-flow
  kernels), a changed-flag over the mesh;
* **two-pass** fill and accumulation: the [P1]/[P2] drivers of
  :mod:`~richdem_tpu_torch.parallel.twopass` over the mesh's blocks, each
  process running its own positions.

Every outer loop that does not converge within ``outer_iters`` raises (the
reference's ``while_loop`` returns the state it reached).  A ``stats`` dict
gains the outer iterations and the local solves' rotations, each one host
sync.  One process owning every position gets a tensor of the original
shape on the mesh's first device; across processes each gets a
:class:`~richdem_tpu_torch.parallel.mesh.ShardedArray` of its own blocks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from richdem_tpu_torch.ops.accum import d8_accumulation_info
from richdem_tpu_torch.ops.fill import _require_converged
from richdem_tpu_torch.ops.flowdirs import d8_core
from richdem_tpu_torch.ops.mfd import mfd_accumulation_info
from richdem_tpu_torch.ops.stencil import as_tensor, neighbor
from richdem_tpu_torch.ops.sweeps import BIG
from richdem_tpu_torch.ops.terrain import terrain_fused
from richdem_tpu_torch.parallel.consumer import _local_fill_solve
from richdem_tpu_torch.parallel.halo import _global_any, exchange_halo
from richdem_tpu_torch.parallel.mesh import (Shard, ShardedArray,
                                             grid_sharding, make_mesh)
from richdem_tpu_torch.topology import D8_INVERSE

__all__ = ["sharded_fill", "sharded_fill_twopass",
           "sharded_terrain_attribute", "sharded_d8_flowdirs",
           "sharded_accumulation_d8", "sharded_accumulation_d8_twopass",
           "sharded_accumulation_mfd", "sharded_pipeline"]


def _mesh(mesh, device):
    """``mesh``, or a mesh over every CUDA device (``device="cuda"``) or
    over the one ``device`` asked for."""
    if mesh is not None:
        return mesh
    if torch.device(device).type == "cuda" and torch.device(device).index \
            is None:
        return make_mesh()
    return make_mesh([torch.device(device)])


def _raster(x, mesh, dtype=None):
    """``x`` as a tensor: where it lives, or an array on the mesh's first
    device of this process."""
    t = as_tensor(x, mesh.device(mesh.local_positions[0]))
    return t if dtype is None else t.to(dtype)


def _mesh_pad(mesh, h, w):
    """Bottom/right padding that makes (h, w) divisible by the mesh.

    Padding cells are marked nodata, which every sharded op treats
    exactly like off-grid cells (drains for fill, skipped neighbours for
    stencils, zero weight for accumulation), so results on the original
    extent are unchanged — outputs are cropped back before returning."""
    ny, nx = mesh.shape
    return (-h) % ny, (-w) % nx


def _pad_zm(z, mask, ph, pw, z_fill=0.0):
    """Pad a raster + nodata mask; padding is nodata."""
    if ph == 0 and pw == 0:
        return z, mask
    z = F.pad(z, (0, pw, 0, ph), value=z_fill)
    mask = F.pad(mask, (0, pw, 0, ph), value=True)
    return z, mask


def _mask(nodata_mask, z):
    if nodata_mask is None:
        return torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    return as_tensor(nodata_mask, z.device).to(torch.bool)


def _shard_tiling(shape, mesh):
    """(rows, cols): the ``(start, stop)`` ranges of the mesh's blocks of a
    raster of ``shape`` (divisible by the mesh), the two-pass drivers'
    tiling."""
    return grid_sharding(mesh).tiling(shape)


def _assemble(outs, mesh, shape):
    """The result of per-position blocks ``outs`` cropped to ``shape``: one
    tensor on the mesh's first device when this process owns every
    position, else a :class:`ShardedArray` of this process's blocks."""
    h, w = shape
    sharding = grid_sharding(mesh)
    ny, nx = mesh.shape
    if mesh.single_process:
        dev = mesh.device((0, 0))
        full = torch.cat([torch.cat([outs[(ri, ci)].to(dev)
                                     for ci in range(nx)], dim=-1)
                          for ri in range(ny)], dim=-2)
        return full[..., :h, :w]
    padded = (-(-h // ny) * ny, -(-w // nx) * nx)
    shards = []
    for p in mesh.local_positions:
        rs, cs = sharding.index(padded, p)
        rs, cs = slice(rs.start, min(rs.stop, h)), slice(cs.start,
                                                         min(cs.stop, w))
        data = outs[p][..., :rs.stop - rs.start, :cs.stop - cs.start]
        shards.append(Shard(data, (rs, cs)))
    return ShardedArray((h, w), shards)


def _outer_loop(step, state, mesh, outer_iters, what, stats, key):
    """Block-Schwarz: ``state, flags = step(state)`` until no block of the
    mesh changed; raises past ``outer_iters`` outer steps."""
    for it in range(1, outer_iters + 1):
        state, flags = step(state)
        if not _global_any(flags, mesh):
            break
    else:
        raise RuntimeError(f"{what} did not converge within {outer_iters} "
                           "outer iterations; pass a larger outer_iters")
    if stats is not None:
        stats[key] = it
    return state


def _fill_blocks(zb, mb, mesh, eps, outer_iters, inner_iters, stats):
    """The block-Schwarz fill of this rank's blocks."""
    neg = -BIG
    floor_in = {p: torch.where(mb[p], neg, zb[p]) for p in zb}
    w0 = {p: torch.where(mb[p], neg, BIG).to(zb[p].dtype) for p in zb}
    info = {} if stats is None else stats

    def step(w):
        ext = exchange_halo(w, mesh, halo=1, fill=-BIG)
        new, flags = {}, []
        for p, e in ext.items():
            # halo ring: clamped to the incoming values (floor == w0 there)
            floor_ext = e.clone()
            floor_ext[1:-1, 1:-1] = floor_in[p]
            new[p] = _local_fill_solve(e, floor_ext, eps, inner_iters,
                                       info)[1:-1, 1:-1]
            flags.append((new[p] != w[p]).any())
        return new, flags

    w = _outer_loop(step, w0, mesh, outer_iters, "sharded fill", stats,
                    "fill_outer_iters")
    return {p: torch.where(mb[p], zb[p], w[p]) for p in zb}


def sharded_fill(dem, mesh=None, nodata_mask=None, eps=0.0,
                 outer_iters=128, inner_iters=128, device="cuda",
                 stats=None):
    """Depression fill, domain-decomposed: bitwise the single-device fill
    from ``w0 = BIG`` (:func:`richdem_tpu_torch.ops.fill.
    fill_depressions_info`), the greatest fixpoint.  ``device``: where an
    array goes and the mesh's devices when ``mesh`` is None."""
    mesh = _mesh(mesh, device)
    z = _raster(dem, mesh, torch.float32)
    h, w = z.shape
    ph, pw = _mesh_pad(mesh, h, w)
    z, mask = _pad_zm(z, _mask(nodata_mask, z), ph, pw)
    sh = grid_sharding(mesh)
    out = _fill_blocks(sh.split(z), sh.split(mask), mesh, eps, outer_iters,
                       inner_iters, stats)
    return _assemble(out, mesh, (h, w))


def sharded_fill_twopass(dem, mesh=None, no_data=None, stats=None,
                         exchange=None, device="cuda"):
    """Depression fill over the mesh's blocks via the [P1] O(perimeter)
    label-graph protocol — exactly two passes, no Schwarz iteration (plain
    fill, eps = 0).

    Each process runs the device consumers
    (:mod:`richdem_tpu_torch.parallel.consumer`) on its own blocks, only
    O(perimeter) ring and edge vectors reach the host, every process solves
    the one global minimax problem, and a ring-Dirichlet solve per block
    reproduces the global fill bit for bit.  ``exchange``: the cross-process
    all-gather of pickled bytes (``twopass.multihost_exchange``) when the
    mesh spans processes.  Output equals :func:`sharded_fill` at eps = 0."""
    from richdem_tpu_torch.parallel.twopass import fill_twopass_run

    mesh = _mesh(mesh, device)
    z = _raster(dem, mesh, torch.float32)
    h, w = z.shape
    ph, pw = _mesh_pad(mesh, h, w)
    if ph or pw:
        # pad with nodata — drains, exactly like off-grid cells
        if no_data is None:
            no_data = float("nan")
        z = F.pad(z, (0, pw, 0, ph), value=float(no_data))
    blocks = grid_sharding(mesh).split(z)
    rows, cols = _shard_tiling(z.shape, mesh)
    outs = {}
    fill_twopass_run(lambda ri, ci: blocks[(ri, ci)],
                     lambda ri, ci, filled: outs.__setitem__((ri, ci),
                                                             filled),
                     rows, cols, no_data=no_data, stats=stats,
                     local_tiles=sorted(blocks), exchange=exchange,
                     device=z.device)
    return _assemble(outs, mesh, (h, w))


def _stencil_blocks(zb, mb, mesh, core):
    """One halo exchange, ``core`` on each extended block, crop."""
    ext_z = exchange_halo(zb, mesh, halo=1, fill=float("nan"))
    ext_m = exchange_halo(mb, mesh, halo=1, fill=True)
    return {p: core(ez, ext_m[p] | torch.isnan(ez))[1:-1, 1:-1]
            for p, ez in ext_z.items()}


def _stencil_sharded(dem, mesh, nodata_mask, core):
    """Pad, split, the stencil ``core`` on the blocks, assemble."""
    z = _raster(dem, mesh, torch.float32)
    h, w = z.shape
    ph, pw = _mesh_pad(mesh, h, w)
    z, mask = _pad_zm(z, _mask(nodata_mask, z), ph, pw)
    sh = grid_sharding(mesh)
    return _assemble(_stencil_blocks(sh.split(z), sh.split(mask), mesh,
                                     core), mesh, (h, w))


def sharded_terrain_attribute(dem, attrib, mesh=None, zscale=1.0,
                              cellsize=1.0, nodata_mask=None,
                              device="cuda"):
    """Terrain attribute, domain-decomposed (bitwise the single-device
    :func:`richdem_tpu_torch.ops.terrain.terrain_attribute`)."""
    mesh = _mesh(mesh, device)
    return _stencil_sharded(
        dem, mesh, nodata_mask,
        lambda zb, mb: terrain_fused(zb, mb, zscale, cellsize, attrib))


def sharded_d8_flowdirs(dem, mesh=None, nodata_mask=None, cellsize=1.0,
                        topology="D8", device="cuda"):
    """D8 flow directions, domain-decomposed (bitwise the single-device
    :func:`richdem_tpu_torch.ops.flowdirs.d8_core`)."""
    mesh = _mesh(mesh, device)
    return _stencil_sharded(
        dem, mesh, nodata_mask,
        lambda zb, mb: d8_core(zb, mb, cellsize, topology))


def _local_accum_solve(fd, w_eff, max_rotations, stats):
    """Exact local D8 accumulation: the accumulation kernel's rotations
    (their plain version on the CPU); raises past ``max_rotations``."""
    acc, rotations, done = d8_accumulation_info(fd, w_eff, max_rotations)
    _require_converged(done, "sharded D8 local solve", max_rotations)
    stats["accum_rotations"] = stats.get("accum_rotations", 0) + rotations
    return acc


def _ring_inflow(acc, mesh, taps):
    """Inflow into each block's cells from OUTSIDE the block: its halo ring
    of ``acc`` times ``taps(p, d)``, the share that ring cells send in
    direction ``d``, summed over the 8 directions."""
    acc_ext = exchange_halo(acc, mesh, halo=1, fill=0.0)
    out = {}
    for p, a in acc_ext.items():
        ring = a.clone()
        ring[1:-1, 1:-1] = 0.0  # zero the local interior
        total = torch.zeros_like(acc[p])
        for d in range(1, 9):
            contrib = ring * taps(p, int(D8_INVERSE[d]))
            total = total + neighbor(contrib, d, 0.0)[1:-1, 1:-1]
        out[p] = total
    return out


def _accum_d8_blocks(fdb, wb, mesh, outer_iters, max_rotations, stats):
    """The block-Schwarz D8 accumulation of this rank's blocks."""
    info = {} if stats is None else stats
    # ring flow directions are static: exchange once
    fd_ext = exchange_halo(fdb, mesh, halo=1, fill=0)

    def step(acc):
        inflow = _ring_inflow(acc, mesh, lambda p, inv: fd_ext[p] == inv)
        new = {p: _local_accum_solve(fdb[p], wb[p] + inflow[p],
                                     max_rotations, info) for p in fdb}
        return new, [(new[p] != acc[p]).any() for p in fdb]

    acc0 = {p: _local_accum_solve(fdb[p], wb[p], max_rotations, info)
            for p in fdb}
    return _outer_loop(step, acc0, mesh, outer_iters,
                       "sharded D8 accumulation", stats, "accum_outer_iters")


def _accum_inputs(flowdirs, mesh, weights, no_data_mask):
    """Codes (int8), effective weights and mask, padded to the mesh
    (padding: nodata codes with zero weight)."""
    fd = _raster(flowdirs, mesh, torch.int8)
    h, w = fd.shape
    wt = (torch.ones((h, w), dtype=torch.float32, device=fd.device)
          if weights is None else as_tensor(weights, fd.device).to(
              torch.float32))
    mask = _mask(no_data_mask, fd)
    wt = torch.where(mask, 0.0, wt)
    ph, pw = _mesh_pad(mesh, h, w)
    if ph or pw:
        fd = F.pad(fd, (0, pw, 0, ph), value=-1)
        wt = F.pad(wt, (0, pw, 0, ph))
        mask = F.pad(mask, (0, pw, 0, ph), value=True)
    return fd, wt, mask, (h, w)


def sharded_accumulation_d8(flowdirs, mesh=None, weights=None,
                            no_data_mask=None, outer_iters=256,
                            max_rotations=32, device="cuda", stats=None):
    """D8 accumulation, domain-decomposed — block-Schwarz iteration, the
    on-device recast of [P2]'s two-pass tile design:

    each outer step (1) exchanges a 1-cell halo of the current
    accumulation, (2) computes the *boundary inflow* each block receives
    from its neighbours' halo-ring cells whose flow direction points into
    it, (3) re-solves the local accumulation exactly with ``weights +
    inflow`` (the accumulation kernel's rotations), and (4) ORs a
    changed-flag over the mesh.  Inflow only grows, so exact-equality
    convergence detection is sound; it converges once every flow path has
    crossed its last block boundary.  Zero at nodata."""
    mesh = _mesh(mesh, device)
    fd, wt, mask, shape = _accum_inputs(flowdirs, mesh, weights,
                                        no_data_mask)
    sh = grid_sharding(mesh)
    acc = _accum_d8_blocks(sh.split(fd), sh.split(wt), mesh, outer_iters,
                           max_rotations, stats)
    mb = sh.split(mask)
    return _assemble({p: torch.where(mb[p], 0.0, a) for p, a in acc.items()},
                     mesh, shape)


def sharded_accumulation_d8_twopass(flowdirs, mesh=None, weights=None,
                                    no_data_mask=None, stats=None,
                                    exchange=None, device="cuda"):
    """D8 accumulation over the mesh's blocks via the [P2] O(perimeter)
    two-pass perimeter-link protocol — exactly two local solves per block
    (no Schwarz iteration), everything where the blocks live: local
    accumulations, the successor-resolve links, and the pass-2 replay; the
    host sees only the O(perimeter) ring vectors and the exit-graph
    topological sweep.  Output equals :func:`sharded_accumulation_d8`."""
    from richdem_tpu_torch.parallel.twopass import accum_twopass_run

    mesh = _mesh(mesh, device)
    fd, wt, mask, shape = _accum_inputs(flowdirs, mesh, weights,
                                        no_data_mask)
    sh = grid_sharding(mesh)
    fd_of, wt_of, mb = sh.split(fd), sh.split(wt), sh.split(mask)
    rows, cols = _shard_tiling(fd.shape, mesh)
    outs = {}
    accum_twopass_run(lambda ri, ci: fd_of[(ri, ci)],
                      lambda ri, ci: wt_of[(ri, ci)],
                      lambda ri, ci, a: outs.__setitem__((ri, ci), a),
                      rows, cols, tuple(fd.shape), stats=stats,
                      local_tiles=sorted(fd_of), exchange=exchange,
                      device=fd.device)
    return _assemble({p: torch.where(mb[p], 0.0, a) for p, a in outs.items()},
                     mesh, shape)


def _local_mfd_solve(planes, w_eff, max_rotations, stats):
    """Exact local multi-flow accumulation: the multi-flow kernel's
    rotations over plane-major proportions (their plain version on the
    CPU); raises past ``max_rotations``."""
    acc, rotations, done = mfd_accumulation_info(planes, w_eff,
                                                 max_rotations)
    _require_converged(done, "sharded multi-flow local solve",
                       max_rotations)
    stats["mfd_rotations"] = stats.get("mfd_rotations", 0) + rotations
    return acc


def sharded_accumulation_mfd(props, mesh=None, weights=None,
                             no_data_mask=None, outer_iters=256,
                             max_rotations=512, device="cuda", stats=None):
    """Divergent-metric (D∞/Quinn/Freeman/Holmgren/MD∞) accumulation,
    domain-decomposed — boundary-inflow Schwarz over the (H, W, 8)
    proportions, exactly like :func:`sharded_accumulation_d8` but with
    weighted taps from the neighbours' proportion planes.  Output equals
    :func:`richdem_tpu_torch.ops.accum.flow_accumulation_from_props` within
    its float regrouping."""
    mesh = _mesh(mesh, device)
    pr = _raster(props, mesh, torch.float32)
    planes = pr.permute(2, 0, 1)
    h, w = planes.shape[1:]
    wt = (torch.ones((h, w), dtype=torch.float32, device=pr.device)
          if weights is None else as_tensor(weights, pr.device).to(
              torch.float32))
    mask = _mask(no_data_mask, wt)
    wt = torch.where(mask, 0.0, wt)
    ph, pw = _mesh_pad(mesh, h, w)
    if ph or pw:
        planes = F.pad(planes, (0, pw, 0, ph))
        wt = F.pad(wt, (0, pw, 0, ph))
        mask = F.pad(mask, (0, pw, 0, ph), value=True)
    sh = grid_sharding(mesh)
    pb, wb, mb = sh.split(planes), sh.split(wt), sh.split(mask)
    info = {} if stats is None else stats
    # ring proportions are static: exchange the 8 planes once
    props_ext = exchange_halo(pb, mesh, halo=1, fill=0.0)

    def step(acc):
        inflow = _ring_inflow(acc, mesh,
                              lambda p, inv: props_ext[p][inv - 1])
        new = {p: _local_mfd_solve(pb[p], wb[p] + inflow[p], max_rotations,
                                   info) for p in pb}
        return new, [(new[p] != acc[p]).any() for p in pb]

    acc0 = {p: _local_mfd_solve(pb[p], wb[p], max_rotations, info)
            for p in pb}
    acc = _outer_loop(step, acc0, mesh, outer_iters,
                      "sharded multi-flow accumulation", stats,
                      "mfd_outer_iters")
    return _assemble({p: torch.where(mb[p], 0.0, a) for p, a in acc.items()},
                     mesh, (h, w))


def sharded_pipeline(dem, mesh=None, eps=1e-3, nodata_mask=None,
                     cellsize=1.0, device="cuda", stats=None):
    """The benchmark pipeline (BASELINE.md config 5): epsilon fill →
    D8 flow directions → accumulation → slope, all domain-decomposed.
    The blocks stay on their devices between the stages; each output is
    assembled once.

    Returns a dict of rasters."""
    mesh = _mesh(mesh, device)
    z = _raster(dem, mesh, torch.float32)
    h, w = z.shape
    ph, pw = _mesh_pad(mesh, h, w)
    z, mask = _pad_zm(z, _mask(nodata_mask, z), ph, pw)
    sh = grid_sharding(mesh)
    zb, mb = sh.split(z), sh.split(mask)
    del z, mask
    filled = _fill_blocks(zb, mb, mesh, eps, outer_iters=128,
                          inner_iters=128, stats=stats)
    fd = _stencil_blocks(filled, mb, mesh,
                         lambda b, m: d8_core(b, m, cellsize))
    acc = _accum_d8_blocks(
        fd, {p: torch.where(m, 0.0, torch.ones_like(filled[p]))
             for p, m in mb.items()}, mesh, outer_iters=256,
        max_rotations=32, stats=stats)
    slope = _stencil_blocks(
        filled, mb, mesh,
        lambda b, m: terrain_fused(b, m, 1.0, cellsize, "slope_radians"))
    acc = {p: torch.where(mb[p], 0.0, a) for p, a in acc.items()}
    return {"filled": _assemble(filled, mesh, (h, w)),
            "flowdirs": _assemble(fd, mesh, (h, w)),
            "accum": _assemble(acc, mesh, (h, w)),
            "slope": _assemble(slope, mesh, (h, w))}
