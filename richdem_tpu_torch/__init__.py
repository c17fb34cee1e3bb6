"""richdem_tpu_torch — the PyTorch / CUDA port of richdem_tpu.

The main path (fill → D8 flow directions → D8 accumulation, plus slope and
TWI), both fill engines (folded and scan), ε-fill with flat resolution, the
terrain attributes, D∞ and multi-flow routing with their accumulation (TWI,
SPI), Rho8 routing, and the D8 methods (watersheds, upslope cells, Strahler
order) run on an NVIDIA Hopper card through eleven hand-written CUDA
kernels (``csrc/``), built with ``nvcc`` at first use, and on the CPU
through their plain PyTorch versions.  Entry points run where a given
tensor lives, and put arrays on the card unless asked for another device.

The [P1]/[P2] two-pass out-of-core programs
(:mod:`richdem_tpu_torch.parallel`: ``out_of_core_fill``,
``out_of_core_accum_d8``) run their tile consumers through the same
kernels, reading a disk-resident DEM exactly twice.

The top-level namespace also mirrors pyrichdem's public API
(:mod:`richdem_tpu_torch.api`: ``rdarray``, ``FillDepressions``,
``FlowAccumulation``, ...), so RichDEM scripts port by changing the
import; ``PipelineConfig`` (:mod:`~richdem_tpu_torch.config`) and
``python -m richdem_tpu_torch.cli`` complete the surface, with ``synth``
(device DEM generators), ``io`` and ``topology``.  The JAX package
``richdem_tpu`` stays the reference; this package imports nothing of it
and never imports JAX.  Importing it touches neither CUDA nor ``nvcc``.
"""

from richdem_tpu_torch.api import (BreachDepressions, FillDepressions,
                                   FlowAccumFromProps, FlowAccumulation,
                                   FlowDirections, FlowProportions, LoadGDAL,
                                   ResolveFlats, SaveGDAL, SPI,
                                   StrahlerOrder, TerrainAttribute, TWI,
                                   UpslopeCells, WatershedLabels, rdCompare,
                                   rdShow)
from richdem_tpu_torch.config import PipelineConfig
from richdem_tpu_torch.grid import rd3array, rdarray
from richdem_tpu_torch.methods import (spi, strahler_order, twi,
                                      upslope_cells,
                                      watersheds_from_flowdirs)
from richdem_tpu_torch.ops.accum import (dinf_accumulation_from_angles,
                                         flow_accumulation_from_props)
from richdem_tpu_torch.ops.fill import auto_epsilon, fill_epsilon
from richdem_tpu_torch.ops.flats import (flat_mask_and_labels_device,
                                         resolve_flats)
from richdem_tpu_torch.ops.flowdirs import (dinf_flowdirs, flow_proportions,
                                            rho8_flowdirs)
from richdem_tpu_torch.ops.terrain import terrain_attribute
from richdem_tpu_torch.pipeline import (check_converged, make_pipeline,
                                        terrain_pipeline)
from richdem_tpu_torch.version import __version__
from richdem_tpu_torch import io, synth, topology


__all__ = ["__version__", "make_pipeline", "terrain_pipeline",
           "check_converged", "auto_epsilon", "fill_epsilon",
           "resolve_flats", "flat_mask_and_labels_device",
           "terrain_attribute", "dinf_flowdirs", "flow_proportions",
           "dinf_accumulation_from_angles", "flow_accumulation_from_props",
           "twi", "spi", "rho8_flowdirs", "watersheds_from_flowdirs",
           "upslope_cells", "strahler_order", "rdarray", "rd3array",
           "LoadGDAL", "SaveGDAL", "FillDepressions", "BreachDepressions",
           "ResolveFlats", "FlowProportions", "FlowAccumulation",
           "FlowAccumFromProps", "TerrainAttribute", "FlowDirections",
           "WatershedLabels", "UpslopeCells", "StrahlerOrder", "TWI", "SPI",
           "rdCompare", "rdShow", "PipelineConfig", "synth", "io",
           "topology"]
