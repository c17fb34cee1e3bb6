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
  label-graph solve and tile manifests.

The sharded mesh (``halo.py``, ``mesh.py``, ``sharded.py``) is not ported
yet.
"""

from richdem_tpu_torch.parallel.consumer import (accum_tile_consumer,
                                                 fill_tile_apply,
                                                 fill_tile_consumer,
                                                 ring_index)
from richdem_tpu_torch.parallel.labelgraph import minimax_raise, reduce_edges
from richdem_tpu_torch.parallel.outofcore import (out_of_core_accum_d8,
                                                  out_of_core_fill)
from richdem_tpu_torch.parallel.twopass import (accum_twopass_run,
                                                fill_twopass_run,
                                                multihost_exchange,
                                                side_positions)

__all__ = ["out_of_core_fill", "out_of_core_accum_d8", "fill_twopass_run",
           "accum_twopass_run", "multihost_exchange", "side_positions",
           "fill_tile_consumer", "fill_tile_apply", "accum_tile_consumer",
           "ring_index", "reduce_edges", "minimax_raise"]
