"""Citations + provenance: the reproducibility subsystem.

Mirrors two deliberate features of the reference (SURVEY.md §5.5):

* every algorithm announces its citation (the reference prints mandatory
  citation banners via ``RDLOG_CITATION``);
* every public op appends a ``PROCESSING_HISTORY`` entry (timestamp,
  version, full call) to the output raster's metadata, which IO writers
  persist.
"""

from __future__ import annotations

import datetime
import logging

from richdem_tpu_torch.version import __version__

__all__ = ["CITATIONS", "cite", "add_history", "logger"]

logger = logging.getLogger("richdem_tpu")

CITATIONS = {
    "priority_flood": (
        "Barnes, Lehman, Mulla (2014). Priority-Flood: An Optimal "
        "Depression-Filling and Watershed-Labeling Algorithm for Digital "
        "Elevation Models. Computers & Geosciences 62, 117-127. "
        "doi:10.1016/j.cageo.2013.04.024"),
    "parallel_priority_flood": (
        "Barnes (2016). Parallel Priority-Flood depression filling for "
        "trillion cell digital elevation models on desktops or clusters. "
        "Computers & Geosciences 96, 56-68. "
        "doi:10.1016/j.cageo.2016.07.001"),
    "parallel_d8_accum": (
        "Barnes (2017). Parallel non-divergent flow accumulation for "
        "trillion cell digital elevation models on desktops or clusters. "
        "Environmental Modelling & Software 92, 202-212. "
        "doi:10.1016/j.envsoft.2017.02.022"),
    "flat_resolution": (
        "Barnes, Lehman, Mulla (2014). An efficient assignment of drainage "
        "direction over flat surfaces in raster digital elevation models. "
        "Computers & Geosciences 62, 128-135. "
        "doi:10.1016/j.cageo.2013.01.009"),
    "breach": (
        "Lindsay (2016). Efficient hybrid breaching-filling sink removal "
        "methods for flow path enforcement in digital elevation models. "
        "Hydrological Processes 30(6), 846-857. doi:10.1002/hyp.10648"),
    "d8": ("O'Callaghan, Marks (1984). The extraction of drainage networks "
           "from digital elevation data. CVGIP 28, 323-344."),
    "rho8": ("Fairfield, Leymarie (1991). Drainage networks from grid "
             "digital elevation models. Water Resources Research 27(5), "
             "709-717."),
    "dinf": ("Tarboton (1997). A new method for the determination of flow "
             "directions and upslope areas in grid digital elevation "
             "models. Water Resources Research 33(2), 309-319."),
    "freeman": ("Freeman (1991). Calculating catchment area with divergent "
                "flow based on a regular grid. Computers & Geosciences "
                "17(3), 413-422."),
    "quinn": ("Quinn, Beven, Chevallier, Planchon (1991). The prediction "
              "of hillslope flow paths for distributed hydrological "
              "modelling using digital terrain models. Hydrological "
              "Processes 5(1), 59-79."),
    "holmgren": ("Holmgren (1994). Multiple flow direction algorithms for "
                 "runoff modelling in grid based elevation models: an "
                 "empirical evaluation. Hydrological Processes 8(4), "
                 "327-334."),
    "seibert_mcglynn": ("Seibert, McGlynn (2007). A new triangular multiple "
                        "flow direction algorithm for computing upslope "
                        "areas from gridded digital elevation models. "
                        "Water Resources Research 43(4), W04501."),
    "horn": ("Horn (1981). Hill shading and the reflectance map. "
             "Proceedings of the IEEE 69(1), 14-47."),
    "zevenbergen_thorne": ("Zevenbergen, Thorne (1987). Quantitative "
                           "analysis of land surface topography. Earth "
                           "Surface Processes and Landforms 12(1), 47-56."),
    "twi": ("Beven, Kirkby (1979). A physically based, variable "
            "contributing area model of basin hydrology. Hydrological "
            "Sciences Bulletin 24(1), 43-69."),
    "orlandini": ("Orlandini, Moretti, Franchini, Aldighieri, Testa "
                  "(2003). Path-based methods for the determination of "
                  "nondispersive drainage directions in grid-based "
                  "digital elevation models. Water Resources Research "
                  "39(6), 1144. doi:10.1029/2002WR001639"),
}

_METHOD_CITATIONS = {
    "d8": "d8", "d4": "d8", "ocallaghan": "d8",
    "rho8": "rho8", "rho4": "rho8",
    "dinf": "dinf", "tarboton": "dinf",
    "freeman": "freeman", "quinn": "quinn", "holmgren": "holmgren",
    "seibertmcglynn": "seibert_mcglynn", "mdinf": "seibert_mcglynn",
    "orlandini": "orlandini", "d8ltd": "orlandini", "d8lad": "orlandini",
}


def cite(key: str) -> str:
    """Log and return the citation for an algorithm key (method strings
    like 'Dinf' are resolved too)."""
    k = _METHOD_CITATIONS.get(key.lower(), key.lower())
    text = CITATIONS.get(k, "")
    if text:
        logger.info("CITATION: %s", text)
    return text


def add_history(rd, call: str):
    """Append a PROCESSING_HISTORY line to an rdarray's metadata in place
    (timestamp | version | call), mirroring pyrichdem's _AddAnalysis."""
    stamp = datetime.datetime.now(datetime.timezone.utc).isoformat()
    prev = rd.metadata.get("PROCESSING_HISTORY", "")
    entry = f"{stamp} | richdem_tpu {__version__} | {call}"
    rd.metadata["PROCESSING_HISTORY"] = (prev + "\n" + entry).strip()
    return rd
