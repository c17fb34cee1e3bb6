"""ctypes bindings for the single-core C++ engine (``core.cpp``).

The port's own copy of ``richdem_tpu.native``: the exact reference that the
on-card gates of ``chip_smoke.py`` hold the kernels against (Priority-Flood
fill, D8 codes, topological-queue accumulation, flat resolution, D∞ angles
and multi-flow proportions), the engine of the API's
``BreachDepressions`` (Lindsay 2016 breaching, a host op as in the
reference), and the serial [P1] tile consumer of the out-of-core fill
(``fill_tile``, ``consumer="native"``).  It binds every function of the
reference's bindings.

``core.cpp`` is built at first use with the reference's g++ flags into
``richdem_tpu_torch/build/librichdem_native.so`` (rebuilt when the source is
newer), never beside the source.  There is no fallback: a missing g++ or a
failed build raises ``RuntimeError``; :func:`available` says beforehand
whether the engine builds and loads.  Nothing runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["available", "fill", "fill_flowdirs", "fill_watersheds",
           "fill_tile", "d8_flowdirs", "accum_d8", "accum_props",
           "breach_depressions", "resolve_flats", "flat_mask_and_labels",
           "dinf_flowdirs", "dinf_props", "mfd_props", "slope_radians",
           "twi"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "core.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "build")
_LIB = os.path.join(_BUILD, "librichdem_native.so")
#: the reference's flags (richdem_tpu/native/__init__.py); no FMA
#: contraction, so float results stay bitwise with the oracle
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
             "-fPIC", "-shared"]
_lock = threading.Lock()
_lib = None


def _build():
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError("g++ not found: the native engine cannot be "
                           "built") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SRC} (rc {proc.returncode}):"
                           f"\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, _LIB)


def _load():
    """The loaded library, building it first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_LIB)

        i64, f64 = ctypes.c_int64, ctypes.c_double
        p64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        pi8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        lib.rn_fill.argtypes = [p64, i64, i64, f64, ctypes.c_int, f64,
                                ctypes.c_void_p, ctypes.c_void_p]
        lib.rn_fill.restype = ctypes.c_int
        lib.rn_d8_flowdirs.argtypes = [p64, pi8, i64, i64, f64,
                                       ctypes.c_int, f64, ctypes.c_int]
        lib.rn_d8_flowdirs.restype = ctypes.c_int
        lib.rn_accum_d8.argtypes = [pi8, ctypes.c_void_p, p64, i64, i64]
        lib.rn_accum_d8.restype = ctypes.c_int
        lib.rn_accum_props.argtypes = [p64, ctypes.c_void_p, p64, i64, i64]
        lib.rn_accum_props.restype = ctypes.c_int
        lib.rn_dinf_flowdirs.argtypes = [p64, p64, i64, i64, f64,
                                         ctypes.c_int, f64]
        lib.rn_dinf_flowdirs.restype = ctypes.c_int
        lib.rn_dinf_props.argtypes = [p64, p64, i64, i64]
        lib.rn_dinf_props.restype = ctypes.c_int
        lib.rn_mfd_props.argtypes = [p64, p64, i64, i64, f64,
                                     ctypes.c_int, f64]
        lib.rn_mfd_props.restype = ctypes.c_int
        lib.rn_resolve_flats.argtypes = [p64, pi8, i64, i64, f64,
                                         ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_void_p]
        lib.rn_resolve_flats.restype = ctypes.c_int
        lib.rn_breach.argtypes = [p64, i64, i64, f64, ctypes.c_int,
                                  ctypes.c_int, f64, i64, f64]
        lib.rn_breach.restype = ctypes.c_int
        pi32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.rn_fill_tile.argtypes = [p64, i64, i64, f64, ctypes.c_int,
                                     ctypes.c_int, pi32, pi32, pi32, p64,
                                     i64, ctypes.POINTER(i64),
                                     ctypes.POINTER(ctypes.c_int32)]
        lib.rn_fill_tile.restype = ctypes.c_int
        lib.rn_slope_radians.argtypes = [p64, p64, i64, i64, f64,
                                         ctypes.c_int, f64, f64]
        lib.rn_slope_radians.restype = ctypes.c_int
        lib.rn_twi.argtypes = [p64, p64, p64, i64, f64, f64]
        lib.rn_twi.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """True if the engine builds (or is built) and loads on this host."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _nodata_args(no_data):
    if no_data is None:
        return 0.0, 0
    return float(no_data), 1


def _fill_impl(dem, no_data, eps, want_fd=False, want_labels=False):
    lib = _load()
    z = np.array(dem, dtype=np.float64, copy=True, order="C")
    h, w = z.shape
    fd = np.full((h, w), -1, np.int8) if want_fd else None
    labels = np.full((h, w), -1, np.int64) if want_labels else None
    nd, has_nd = _nodata_args(no_data)
    rc = lib.rn_fill(
        z, h, w, nd, has_nd, float(eps),
        fd.ctypes.data_as(ctypes.c_void_p) if want_fd else None,
        labels.ctypes.data_as(ctypes.c_void_p) if want_labels else None)
    if rc != 0:
        raise RuntimeError(f"rn_fill failed ({rc})")
    return z, fd, labels


def fill(dem, no_data=None, eps=0.0):
    """Priority-Flood fill (plain or epsilon); float64 copy returned."""
    z, _, _ = _fill_impl(dem, no_data, eps)
    return z


def fill_flowdirs(dem, no_data=None):
    """(filled, flowdirs): directions assigned during the flood."""
    z, fd, _ = _fill_impl(dem, no_data, 0.0, want_fd=True)
    return z, fd


def fill_watersheds(dem, no_data=None):
    """(filled, labels): seed-index watershed labels."""
    z, _, labels = _fill_impl(dem, no_data, 0.0, want_labels=True)
    return z, labels


def fill_tile(dem, no_data=None, global_edges=0):
    """[P1] two-pass fill, consumer pass: Priority-Flood one tile with its
    perimeter as the seed set (Barnes 2016, arxiv 1606.06204 §3).

    Returns ``(filled, labels, edges)``: the tile filled relative to its
    own perimeter (float64), int32 per-cell watershed ids (0 = ocean:
    global edges and nodata-adjacent drains), and an ``(m, 3)`` float64
    array of label-graph rows ``(label_a, label_b, spill_elevation)``.
    ``global_edges``: bitmask of the tile sides on the DEM's border (1
    top, 2 bottom, 4 left, 8 right)."""
    lib = _load()
    z = np.array(dem, dtype=np.float64, copy=True, order="C")
    h, w = z.shape
    labels = np.empty((h, w), np.int32)
    nd, has_nd = _nodata_args(no_data)
    cap = 8 * (h + w) + 1024
    for _ in range(8):
        ea = np.empty(cap, np.int32)
        eb = np.empty(cap, np.int32)
        ew = np.empty(cap, np.float64)
        n_edges = ctypes.c_int64(0)
        n_labels = ctypes.c_int32(0)
        rc = lib.rn_fill_tile(z, h, w, nd, has_nd, int(global_edges),
                              labels, ea, eb, ew, cap,
                              ctypes.byref(n_edges),
                              ctypes.byref(n_labels))
        if rc == 0:
            m = n_edges.value
            edges = np.column_stack([ea[:m].astype(np.float64),
                                     eb[:m].astype(np.float64), ew[:m]])
            return z, labels, edges
        if rc == 2:
            # the edge buffer was too small: retry at the reported size
            cap = int(n_edges.value) + 1024
            z = np.array(dem, dtype=np.float64, copy=True, order="C")
            continue
        raise RuntimeError(f"rn_fill_tile failed ({rc})")
    raise RuntimeError("rn_fill_tile: edge buffer kept overflowing")


def d8_flowdirs(dem, no_data=None, cellsize=1.0, topology="D8"):
    """Steepest-descent D8/D4 directions (package tie-break order)."""
    lib = _load()
    z = np.ascontiguousarray(dem, dtype=np.float64)
    h, w = z.shape
    fd = np.empty((h, w), np.int8)
    nd, has_nd = _nodata_args(no_data)
    lib.rn_d8_flowdirs(z, fd, h, w, nd, has_nd, float(cellsize),
                       1 if topology == "D4" else 0)
    return fd


def accum_d8(flowdirs, weights=None):
    """Topological-queue D8 accumulation; raises on cycles."""
    lib = _load()
    fd = np.ascontiguousarray(flowdirs, dtype=np.int8)
    h, w = fd.shape
    acc = np.empty((h, w), np.float64)
    wptr = None
    if weights is not None:
        weights = np.ascontiguousarray(weights, dtype=np.float64)
        wptr = weights.ctypes.data_as(ctypes.c_void_p)
    rc = lib.rn_accum_d8(fd, wptr, acc, h, w)
    if rc != 0:
        raise ValueError("flow graph has a cycle — fill the DEM first")
    return acc


def accum_props(props, weights=None):
    """Topological-queue accumulation from (H, W, 8) proportions; raises
    on cycles."""
    lib = _load()
    props = np.ascontiguousarray(props, dtype=np.float64)
    h, w, k = props.shape
    if k != 8:
        raise ValueError(f"proportions must be (H, W, 8), not {props.shape}")
    acc = np.empty((h, w), np.float64)
    wptr = None
    if weights is not None:
        weights = np.ascontiguousarray(weights, dtype=np.float64)
        wptr = weights.ctypes.data_as(ctypes.c_void_p)
    rc = lib.rn_accum_props(props, wptr, acc, h, w)
    if rc != 0:
        raise ValueError("flow graph has a cycle — fill the DEM first")
    return acc


def dinf_flowdirs(dem, no_data=None, cellsize=1.0):
    """Tarboton D∞ angles (radians counter-clockwise from East; -1
    NO_FLOW, -2 nodata)."""
    lib = _load()
    z = np.ascontiguousarray(dem, dtype=np.float64)
    h, w = z.shape
    ang = np.empty((h, w), np.float64)
    nd, has_nd = _nodata_args(no_data)
    lib.rn_dinf_flowdirs(z, ang, h, w, nd, has_nd, float(cellsize))
    return ang


def dinf_props(angles):
    """(H, W, 8) proportions from D∞ angles."""
    lib = _load()
    ang = np.ascontiguousarray(angles, dtype=np.float64)
    h, w = ang.shape
    props = np.empty((h, w, 8), np.float64)
    lib.rn_dinf_props(ang, props, h, w)
    return props


def mfd_props(dem, no_data=None, exponent=1.0):
    """Multi-flow proportions ∝ slope ** exponent (Quinn at 1.0, Freeman
    1.1, Holmgren any)."""
    lib = _load()
    z = np.ascontiguousarray(dem, dtype=np.float64)
    h, w = z.shape
    props = np.empty((h, w, 8), np.float64)
    nd, has_nd = _nodata_args(no_data)
    lib.rn_mfd_props(z, props, h, w, nd, has_nd, float(exponent))
    return props


_MODES = {"Complete": 0, "Selective": 1, "Constrained": 2}


def breach_depressions(dem, no_data=None, mode="Complete", eps=0.0,
                       max_path_len=None, max_path_depth=None,
                       fill_remainder=False):
    """Lindsay 2016 breaching (native); mirrors oracle.breach_depressions."""
    lib = _load()
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {tuple(_MODES)}")
    in_dtype = np.asarray(dem).dtype
    z = np.array(dem, dtype=np.float64, copy=True, order="C")
    h, w = z.shape
    nd, has_nd = _nodata_args(no_data)
    rc = lib.rn_breach(z, h, w, nd, has_nd, _MODES[mode], float(eps),
                       -1 if max_path_len is None else int(max_path_len),
                       -1.0 if max_path_depth is None
                       else float(max_path_depth))
    if rc != 0:
        raise RuntimeError(f"rn_breach failed ({rc})")
    if fill_remainder:
        z = fill(z, no_data=no_data, eps=max(eps, 0.0))
    return z.astype(in_dtype)


def _flats_impl(dem, flowdirs, no_data, want_mask):
    lib = _load()
    z = np.ascontiguousarray(dem, dtype=np.float64)
    fd = np.array(flowdirs, dtype=np.int8, copy=True, order="C")
    h, w = z.shape
    mask = np.zeros((h, w), np.int32) if want_mask else None
    labels = np.zeros((h, w), np.int32) if want_mask else None
    nd, has_nd = _nodata_args(no_data)
    rc = lib.rn_resolve_flats(
        z, fd, h, w, nd, has_nd,
        mask.ctypes.data_as(ctypes.c_void_p) if want_mask else None,
        labels.ctypes.data_as(ctypes.c_void_p) if want_mask else None)
    if rc != 0:
        raise RuntimeError(f"rn_resolve_flats failed ({rc})")
    return fd, mask, labels


def resolve_flats(dem, flowdirs, no_data=None):
    """Flow directions with flats drained (Barnes, Lehman & Mulla 2014)."""
    fd, _, _ = _flats_impl(dem, flowdirs, no_data, want_mask=False)
    return fd


def flat_mask_and_labels(dem, flowdirs, no_data=None):
    """(flat_mask, labels) int32 rasters."""
    _, mask, labels = _flats_impl(dem, flowdirs, no_data, want_mask=True)
    return mask, labels


def slope_radians(dem, no_data=None, zscale=1.0, cellsize=1.0):
    """Horn 1981 slope in radians (float64)."""
    lib = _load()
    z = np.ascontiguousarray(dem, dtype=np.float64)
    h, w = z.shape
    out = np.empty((h, w), np.float64)
    nd, has_nd = _nodata_args(no_data)
    lib.rn_slope_radians(z, out, h, w, nd, has_nd, float(zscale),
                         float(cellsize))
    return out


def twi(accum, slope, cellsize=1.0, min_slope=1e-6):
    """ln(a / tan beta) with a = accumulation × cellsize (float64)."""
    lib = _load()
    acc = np.ascontiguousarray(accum, dtype=np.float64)
    sl = np.ascontiguousarray(slope, dtype=np.float64)
    out = np.empty(acc.shape, np.float64)
    lib.rn_twi(acc, sl, out, acc.size, float(cellsize), float(min_slope))
    return out
