"""Distribution layer: the [P1]/[P2] two-pass tiled programs and tile
manifests.

* :mod:`~richdem_tpu_torch.parallel.outofcore`: disk-resident DEMs with
  O(tile) memory, ``out_of_core_fill`` (the [P1] label-graph fill, or
  Schwarz halo sweeps for ε-fill) and ``out_of_core_accum_d8`` (the [P2]
  perimeter-link accumulation), exactly two passes over the data;
* :mod:`~richdem_tpu_torch.parallel.twopass`: the protocol drivers over
  abstract tile sources, and ``multihost_exchange`` over
  ``torch.distributed``;
* :mod:`~richdem_tpu_torch.parallel.consumer`: the tile consumers, on the
  card through the port's kernels;
* :mod:`~richdem_tpu_torch.parallel.labelgraph` and
  :mod:`~richdem_tpu_torch.parallel.layout`: copies of the JAX package's
  label-graph solve and tile manifests;
* :mod:`~richdem_tpu_torch.parallel.mesh`: a 2-D mesh of device positions
  (a device may repeat; across processes each rank owns a row-major block
  of them) and the grid sharding of a raster over it;
* :mod:`~richdem_tpu_torch.parallel.halo`: k-cell halo exchange between
  the mesh's blocks, slice copies in one process and ``all_gather`` of edge
  strips under a ``torch.distributed`` group;
* :mod:`~richdem_tpu_torch.parallel.sharded`: the sharded ops — stencils
  with one halo exchange, block-Schwarz fill and D8/multi-flow
  accumulation, the two-pass fill and accumulation over the mesh, and
  ``sharded_pipeline`` (BASELINE.md config 5).
"""

from richdem_tpu_torch.parallel.consumer import (accum_tile_consumer,
                                                 fill_tile_apply,
                                                 fill_tile_consumer,
                                                 ring_index)
from richdem_tpu_torch.parallel.labelgraph import minimax_raise, reduce_edges
from richdem_tpu_torch.parallel.mesh import grid_sharding, make_mesh
from richdem_tpu_torch.parallel.outofcore import (out_of_core_accum_d8,
                                                  out_of_core_fill)
from richdem_tpu_torch.parallel.sharded import (
    sharded_accumulation_d8, sharded_accumulation_d8_twopass,
    sharded_accumulation_mfd, sharded_d8_flowdirs, sharded_fill,
    sharded_fill_twopass, sharded_pipeline, sharded_terrain_attribute)
from richdem_tpu_torch.parallel.twopass import (accum_twopass_run,
                                                fill_twopass_run,
                                                multihost_exchange,
                                                side_positions)

__all__ = ["out_of_core_fill", "out_of_core_accum_d8", "fill_twopass_run",
           "accum_twopass_run", "multihost_exchange", "side_positions",
           "fill_tile_consumer", "fill_tile_apply", "accum_tile_consumer",
           "ring_index", "reduce_edges", "minimax_raise", "make_mesh",
           "grid_sharding", "sharded_fill", "sharded_fill_twopass",
           "sharded_terrain_attribute", "sharded_d8_flowdirs",
           "sharded_accumulation_d8", "sharded_accumulation_d8_twopass",
           "sharded_accumulation_mfd", "sharded_pipeline"]
