"""Halo exchange over the device mesh.

Counterpart of ``richdem_tpu.parallel.halo``, which swaps halos with
``lax.ppermute`` inside ``shard_map``.  Here a sharded raster is a dict of
this process's blocks ``{(ri, ci): tensor}`` (:mod:`~richdem_tpu_torch.
parallel.mesh`), and each block swaps k-cell halos with its 4 mesh
neighbours in the reference's two stages: rows along ``y``, then columns of
the row-extended block along ``x``, which carries the diagonal corners.

With no process group every block is local and a halo is a slice of its
neighbour (moved with ``.to`` when the neighbour lives on another device).
Under a group every strip travels through it: one ``all_gather`` a stage
of each rank's edge strips (O(perimeter)) over NCCL for CUDA tensors and
gloo for CPU tensors, also between blocks of one rank, so a one-rank group
runs the collective path too.  Bool blocks travel as ``uint8``, since NCCL
has no bool.
"""

from __future__ import annotations

import torch

__all__ = ["exchange_halo"]


def _collective_device(mesh):
    """Where this rank's strips meet the group: the current CUDA device
    under NCCL, the CPU under gloo."""
    import torch.distributed as dist

    if dist.get_backend(mesh.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_strips(mesh, strips):
    """``{pos: strip}`` for every position of the mesh, from this rank's
    ``strips`` (one per local position, all of one shape and dtype)."""
    if mesh.group is None:
        return strips
    import torch.distributed as dist

    local = mesh.local_positions
    dev = _collective_device(mesh)
    sent = torch.stack([strips[p] for p in local]).to(dev)
    dtype = sent.dtype
    if dtype == torch.bool:
        sent = sent.to(torch.uint8)
    world = dist.get_world_size(mesh.group)
    got = [torch.empty_like(sent) for _ in range(world)]
    dist.all_gather(got, sent.contiguous(), group=mesh.group)
    ny, nx = mesh.shape
    per = len(local)  # positions a rank, row-major
    return {(i // nx, i % nx): got[i // per][i % per].to(dtype)
            for i in range(ny * nx)}


def exchange_halo(blocks, mesh, halo=1, fill=0.0):
    """Extend each local ``(..., h, w)`` block to ``(..., h+2k, w+2k)``
    with its neighbours' halos.

    Off-grid positions (the global boundary) take ``fill``, the op's
    boundary condition (-BIG = drain for filling, NaN for
    replicate-centre stencils, True for nodata masks)."""
    k = halo
    ny, nx = mesh.shape

    def edge(like, size):
        return torch.full(like.shape[:-2] + size, fill, dtype=like.dtype,
                          device=like.device)

    # stage 1: rows. The top halo is the north neighbour's bottom k rows.
    rows = _all_strips(mesh, {p: torch.stack([b[..., :k, :], b[..., -k:, :]])
                              for p, b in blocks.items()})
    ext = {}
    for (ri, ci), b in blocks.items():
        w = b.shape[-1]
        top = (rows[(ri - 1, ci)][1].to(b.device) if ri > 0
               else edge(b, (k, w)))
        bot = (rows[(ri + 1, ci)][0].to(b.device) if ri < ny - 1
               else edge(b, (k, w)))
        ext[(ri, ci)] = torch.cat([top, b, bot], dim=-2)

    # stage 2: columns of the extended block (carries corners).
    cols = _all_strips(mesh, {p: torch.stack([e[..., :k], e[..., -k:]])
                              for p, e in ext.items()})
    out = {}
    for (ri, ci), e in ext.items():
        h = e.shape[-2]
        left = (cols[(ri, ci - 1)][1].to(e.device) if ci > 0
                else edge(e, (h, k)))
        right = (cols[(ri, ci + 1)][0].to(e.device) if ci < nx - 1
                 else edge(e, (h, k)))
        out[(ri, ci)] = torch.cat([left, e, right], dim=-1)
    return out


def _global_any(flags, mesh) -> bool:
    """OR of this rank's per-block flags (0-dim bool tensors), then over
    the group's ranks (``all_reduce(MAX)``) when there is a group: one
    host sync."""
    dev = (_collective_device(mesh) if mesh.group is not None
           else next(iter(flags)).device)
    v = torch.stack([f.to(dev) for f in flags]).any().to(torch.int32)
    if mesh.group is not None:
        import torch.distributed as dist

        v = v.reshape(1)
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(v.item())
