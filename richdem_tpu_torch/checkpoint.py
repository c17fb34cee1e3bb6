"""Phase-granular checkpoint/resume.

The reference's only resilience mechanism is *restartability*: the
parallel programs evict tiles to ``--cache-dir`` as native ``.dat`` rasters
between phases, so a killed job can rerun a phase from disk (SURVEY.md
§5.3/5.4, ``Array2D::saveNative``/``loadNative``).  The TPU-native
equivalent here: every pipeline phase can persist its output raster(s) to
an ``.npy`` keyed by ``(grid_id, phase, shard)``; a rerun loads finished
phases and recomputes only what is missing.  Batch posture, exactly like
the reference: no in-flight failover, deterministic resume.

Staleness/race hardening (ADVICE r1): each entry carries a sidecar
``.meta.json`` written atomically (tmp + ``os.replace``) — per-entry
manifests mean concurrent shard writers cannot drop each other's resume
state — and an optional **fingerprint** (hash of the pipeline config +
input) is validated on load, so rerunning with a different DEM/eps under
the same ``cache_dir``/``grid_id`` recomputes instead of silently
returning stale rasters.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np

__all__ = ["PhaseCache", "fingerprint_of"]


def fingerprint_of(*parts) -> str:
    """Stable short hash of config strings / arrays (for PhaseCache)."""
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, (bytes, bytearray)):
            h.update(p)
        elif isinstance(p, str):
            h.update(p.encode())
        else:
            a = np.asarray(p)
            h.update(str(a.shape).encode())
            h.update(str(a.dtype).encode())
            # hash a bounded sample: corners + strided interior (hashing
            # a full 8192² raster on this slow host would dominate)
            flat = a.reshape(-1)
            step = max(1, flat.size // 65536)
            h.update(np.ascontiguousarray(flat[::step]).tobytes())
    return h.hexdigest()[:16]


class PhaseCache:
    """Disk cache of per-phase rasters.

    Layout: ``{root}/{grid_id}/{phase}[.s{shard}].npy`` plus a per-entry
    sidecar ``….meta.json`` (atomic rename; a phase is only considered
    present once both files exist and the fingerprint matches).
    """

    def __init__(self, root: str, grid_id: str = "grid",
                 fingerprint: str | None = None):
        self.root = root
        self.grid_id = grid_id
        self.fingerprint = fingerprint
        self.dir = os.path.join(root, grid_id)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, phase: str, shard=None) -> str:
        name = phase if shard is None else f"{phase}.s{int(shard)}"
        return os.path.join(self.dir, f"{name}.npy")

    def _entry_meta_path(self, phase: str, shard=None) -> str:
        return self._path(phase, shard) + ".meta.json"

    def _entry_meta(self, phase: str, shard=None) -> dict:
        try:
            with open(self._entry_meta_path(phase, shard)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def has(self, phase: str, shard=None) -> bool:
        if not os.path.exists(self._path(phase, shard)):
            return False
        meta = self._entry_meta(phase, shard)
        if not meta:
            return False
        if self.fingerprint is not None:
            return meta.get("fingerprint") == self.fingerprint
        return True

    def save(self, phase: str, array, shard=None) -> None:
        """Atomic write: tmp + rename for the raster, then its sidecar."""
        path = self._path(phase, shard)
        tmp = path + ".tmp.npy"  # .npy suffix stops np.save re-appending
        np.save(tmp, np.asarray(array))
        os.replace(tmp, path)
        meta = {"t": time.time(), "shape": list(np.shape(array))}
        if self.fingerprint is not None:
            meta["fingerprint"] = self.fingerprint
        mpath = self._entry_meta_path(phase, shard)
        mtmp = mpath + ".tmp"
        with open(mtmp, "w") as f:
            json.dump(meta, f)
        os.replace(mtmp, mpath)

    def load(self, phase: str, shard=None) -> np.ndarray:
        return np.load(self._path(phase, shard))

    def run(self, phase: str, fn, shard=None):
        """Load ``phase`` if checkpointed, else compute ``fn()`` and
        persist it.  ``fn`` must return one array."""
        if self.has(phase, shard):
            return self.load(phase, shard)
        out = np.asarray(fn())
        self.save(phase, out, shard)
        return out

    def clear(self) -> None:
        for name in os.listdir(self.dir):
            os.remove(os.path.join(self.dir, name))
