"""Raster IO without GDAL (SURVEY.md §7 hard-part 7).

The reference's L0 couples IO to GDAL (``Array2D::loadGDAL/saveGDAL``) plus
a native ``.dat`` cache (``saveNative``).  TPU hosts ship no GDAL, so this
package provides:

* ``.npz`` rasters with embedded georeferencing/metadata — the native
  format and phase-checkpoint medium (:mod:`richdem_tpu_torch.io.npyio`);
* ESRI ASCII grids (``.asc``) for interchange
  (:mod:`richdem_tpu_torch.io.asciigrid`);
* a pure-python GeoTIFF codec (:mod:`richdem_tpu_torch.io.geotiff`): classic +
  BigTIFF, DEFLATE/LZW/PackBits, predictors, windowed reads, streamed
  strip writes.

``load``/``save`` dispatch on extension; ``save`` forwards keyword
arguments (e.g. ``compress=/predictor=`` for ``.tif``).
"""

from richdem_tpu_torch.io.npyio import load_npz, save_npz
from richdem_tpu_torch.io.asciigrid import load_ascii, save_ascii
from richdem_tpu_torch.io.geotiff import load_geotiff, save_geotiff

__all__ = ["load", "save", "load_npz", "save_npz", "load_ascii",
           "save_ascii", "load_geotiff", "save_geotiff"]


def load(path):
    """Load a raster as :class:`richdem_tpu_torch.grid.rdarray` by extension."""
    p = str(path).lower()
    if p.endswith((".npz", ".npy")):
        return load_npz(path)
    if p.endswith((".asc", ".txt")):
        return load_ascii(path)
    if p.endswith((".tif", ".tiff")):
        return load_geotiff(path)
    raise ValueError(f"unsupported raster extension: {path}")


def save(path, rd, **kwargs):
    """Save an :class:`richdem_tpu_torch.grid.rdarray` by extension.  Extra
    keyword arguments go to the format writer (``compress=``,
    ``predictor=``, ``bigtiff=`` for ``.tif``)."""
    p = str(path).lower()
    if p.endswith(".npz"):
        return save_npz(path, rd, **kwargs)
    if p.endswith((".asc", ".txt")):
        return save_ascii(path, rd, **kwargs)
    if p.endswith((".tif", ".tiff")):
        return save_geotiff(path, rd, **kwargs)
    raise ValueError(f"unsupported raster extension: {path}")
