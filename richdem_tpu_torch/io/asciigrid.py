"""ESRI ASCII grid (.asc) IO — the reference reads these via GDAL and ships
an ``rd_ascii_to_terrain`` converter app (SURVEY.md §2.3); here it is a
first-class text codec with no dependencies."""

from __future__ import annotations

import numpy as np

from richdem_tpu_torch.grid import rdarray

__all__ = ["load_ascii", "save_ascii"]


def load_ascii(path) -> rdarray:
    header = {}
    data_start = 0
    with open(path, "r") as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        parts = line.split()
        if len(parts) == 2 and parts[0].lower() in (
                "ncols", "nrows", "xllcorner", "yllcorner", "xllcenter",
                "yllcenter", "cellsize", "nodata_value"):
            header[parts[0].lower()] = float(parts[1])
        else:
            data_start = i
            break
    ncols = int(header["ncols"])
    nrows = int(header["nrows"])
    data = np.loadtxt(lines[data_start:]).reshape(nrows, ncols)
    cellsize = header.get("cellsize", 1.0)
    xll = header.get("xllcorner", header.get("xllcenter", 0.0))
    yll = header.get("yllcorner", header.get("yllcenter", 0.0))
    # GDAL-style geotransform: origin is the top-left corner.
    geotransform = (xll, cellsize, 0.0, yll + nrows * cellsize, 0.0,
                    -cellsize)
    return rdarray(data, no_data=header.get("nodata_value"),
                   geotransform=geotransform)


def save_ascii(path, rd):
    if not isinstance(rd, rdarray):
        rd = rdarray(rd)
    nrows, ncols = rd.shape
    gt = rd.geotransform
    cellsize = abs(gt[1])
    xll = gt[0]
    yll = gt[3] - nrows * cellsize
    no_data = -9999.0 if rd.no_data is None else float(rd.no_data)
    with open(path, "w") as f:
        f.write(f"ncols {ncols}\n")
        f.write(f"nrows {nrows}\n")
        f.write(f"xllcorner {xll}\n")
        f.write(f"yllcorner {yll}\n")
        f.write(f"cellsize {cellsize}\n")
        f.write(f"NODATA_value {no_data}\n")
        np.savetxt(f, rd.np(), fmt="%.10g")
    return path
