"""Tile manifests: the counterpart of the reference's ``Layoutfile``
(``include/richdem/common/Layoutfile.hpp`` — SURVEY.md §2.1).

A layout is a CSV whose cell (row, col) names the raster file of that tile
of a larger DEM; blank entries are missing tiles.  The reference's MPI
programs read these to scatter work; here they feed host-side loading of
per-device shards and the ``merge`` CLI verb
(``rd_merge_rasters_by_layout`` counterpart).
"""

from __future__ import annotations

import os

import numpy as np

from richdem_tpu_torch.grid import rdarray

__all__ = ["read_layout", "write_layout", "merge_by_layout",
           "split_to_layout"]


def read_layout(path):
    """Parse a layout CSV → 2-D list of file paths ('' = missing tile).
    Relative entries resolve against the layout file's directory."""
    base = os.path.dirname(os.path.abspath(path))
    rows = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip() and not rows:
                continue
            rows.append([
                os.path.join(base, cell.strip()) if cell.strip() else ""
                for cell in line.split(",")])
    width = max((len(r) for r in rows), default=0)
    for r in rows:
        r.extend([""] * (width - len(r)))
    return rows


def write_layout(path, grid_of_paths):
    base = os.path.dirname(os.path.abspath(path))
    with open(path, "w") as f:
        for row in grid_of_paths:
            f.write(",".join(
                os.path.relpath(p, base) if p else "" for p in row) + "\n")
    return path


def merge_by_layout(layout_path):
    """Stitch the tiles of a layout into one rdarray (missing tiles fill
    with the first tile's nodata, or nan)."""
    from richdem_tpu_torch import io as rio

    layout = read_layout(layout_path)
    tiles = [[rio.load(p) if p else None for p in row] for row in layout]
    first = next(t for row in tiles for t in row if t is not None)
    row_heights = [
        next((t.shape[0] for t in row if t is not None), 0)
        for row in tiles]
    col_widths = [
        next((tiles[r][c].shape[1] for r in range(len(tiles))
              if tiles[r][c] is not None), 0)
        for c in range(len(tiles[0]))]
    fill = first.no_data if first.no_data is not None else np.nan
    dtype = first.dtype if first.no_data is not None else np.float64
    out = np.full((sum(row_heights), sum(col_widths)), fill, dtype=dtype)
    y = 0
    for r, row in enumerate(tiles):
        x = 0
        for c, t in enumerate(row):
            if t is not None:
                out[y:y + t.shape[0], x:x + t.shape[1]] = t.np()
            x += col_widths[c]
        y += row_heights[r]
    return rdarray(out, no_data=first.no_data,
                   geotransform=first.geotransform,
                   projection=first.projection)


def split_to_layout(rd_arr, out_dir, tile_shape, fmt="npz",
                    name="tile_%03d_%03d"):
    """Split a raster into tiles + layout manifest (the inverse of merge;
    used to stage big DEMs for the tiled pipeline)."""
    from richdem_tpu_torch import io as rio

    os.makedirs(out_dir, exist_ok=True)
    if not isinstance(rd_arr, rdarray):
        rd_arr = rdarray(rd_arr)
    th, tw = tile_shape
    h, w = rd_arr.shape
    paths = []
    for r0 in range(0, h, th):
        row_paths = []
        for c0 in range(0, w, tw):
            tile = rd_arr.like(rd_arr.np()[r0:r0 + th, c0:c0 + tw])
            p = os.path.join(out_dir, (name % (r0 // th, c0 // tw))
                             + "." + fmt)
            rio.save(p, tile)
            row_paths.append(p)
        paths.append(row_paths)
    layout_path = os.path.join(out_dir, "layout.csv")
    write_layout(layout_path, paths)
    return layout_path
