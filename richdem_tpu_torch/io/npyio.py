"""Native ``.npz`` raster format (counterpart of the reference's
``Array2D::saveNative``/``loadNative`` binary cache — SURVEY.md §2.1).

One compressed archive carrying the data plane plus georeferencing and the
``PROCESSING_HISTORY`` provenance record.  Fast to (re)load; used as the
phase-checkpoint medium by the distributed pipeline (SURVEY.md §5.4).
"""

from __future__ import annotations

import json

import numpy as np

from richdem_tpu_torch.grid import rdarray

__all__ = ["save_npz", "load_npz"]

_FORMAT_VERSION = 1


def save_npz(path, rd):
    """Save an rdarray (or bare array) to ``.npz``."""
    if not isinstance(rd, rdarray):
        rd = rdarray(rd)
    meta = {
        "format_version": _FORMAT_VERSION,
        "no_data": None if rd.no_data is None else float(rd.no_data),
        "geotransform": list(rd.geotransform),
        "projection": rd.projection,
        "metadata": rd.metadata,
    }
    np.savez_compressed(path, data=rd.np(),
                        richdem_meta=np.frombuffer(
                            json.dumps(meta).encode(), dtype=np.uint8))
    return path


def load_npz(path) -> rdarray:
    with np.load(path, allow_pickle=False) as f:
        data = f["data"]
        if "richdem_meta" in f:
            meta = json.loads(bytes(f["richdem_meta"].tobytes()).decode())
        else:
            meta = {}
    return rdarray(
        data,
        no_data=meta.get("no_data"),
        geotransform=tuple(meta.get("geotransform")
                           ) if meta.get("geotransform") else None,
        projection=meta.get("projection", ""),
        metadata=meta.get("metadata"),
    )
