"""Out-of-core (larger-than-device-memory) processing of disk-resident DEMs.

Counterpart of ``richdem_tpu.parallel.outofcore``: the reference's
trillion-cell programs (``parallel_priority_flood`` [P1],
``parallel_d8_accum`` [P2]) keep one tile per consumer in memory.  Two
strategies, both O(tile) memory:

**Two-pass label-graph fill (default for plain fill)**, the [P1] protocol
(arxiv 1606.06204 §3).  The device consumer
(:mod:`richdem_tpu_torch.parallel.consumer`) runs the local fill, the
flats-resolved successor labels and the edge extraction where the run's
device is; pass 1 writes nothing and pass 2 is a ring-Dirichlet solve, so
only O(perimeter) data reach the host.  The serial C++ consumer
(``native.fill_tile``) is the cross-validation engine
(``consumer="native"``: locally filled z, a labels memmap and a raise-table
apply).  Either way the global label graph is solved once by minimax
Dijkstra (:mod:`richdem_tpu_torch.parallel.labelgraph`), the output equals
serial Priority-Flood exactly, and the data are read exactly twice.

**Schwarz sweeps (ε-fill, and the accumulation's cross-check)**: each pass
visits every tile in serpentine order, loads the tile plus a 1-cell halo of
the current state, solves the local fixpoint exactly with the halo ring
clamped, and writes back; alternating forward and reverse passes converge
in a handful of passes, detected by exact equality.

D8 accumulation has its own two-pass protocol ([P2]); see
:func:`out_of_core_accum_d8`.

``device`` (``"cuda"`` by default, as everywhere in the port) is where the
consumers run; ``device="cuda"`` without a card raises.  Tiles go up from
pinned host buffers by non-blocking copies, so the cached uploads of the
device consumer overlap the consumers, and come back whole through pinned
buffers.  The reference downloads only the cells the fill raised, patched
onto a fresh host read of the tile (``RICHDEM_TPU_DIFF_FRAC``), because its
device link is slow; on an H100 the whole 2048² tile comes back through a
pinned buffer several times faster than that host read alone
(``tools/twopass_measure.py transfers``, PERF.md), so the port has no sparse
path and does not read that variable.  A ``timer`` (:class:`richdem_tpu_torch.debug.PhaseTimer`) splits
a two-pass run into its passes, the host's solve, ``disk read``/``disk
write`` and ``upload``/``download``.
"""

from __future__ import annotations

import itertools
import os
import threading
import time as _time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from richdem_tpu_torch.ops.sweeps import BIG
from richdem_tpu_torch.parallel.twopass import phase

__all__ = ["out_of_core_fill", "out_of_core_accum_d8"]


def _ooc_workers():
    """``RICHDEM_TPU_OOC_WORKERS``: thread count for the native tile
    consumers ([P1]'s consumers are independent; ctypes releases the GIL
    around the C++ Priority-Flood, so threads overlap tile IO with compute
    and scale on cores).  The output is bit-identical at any worker count:
    ordering-sensitive steps stay on the main thread.  Default 2."""
    return max(1, int(os.environ.get("RICHDEM_TPU_OOC_WORKERS", "2")))


def _run_device(device):
    """The run's device; ``"cuda"`` without a card raises (no silent CPU
    run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("out-of-core run on device 'cuda', but no CUDA "
                           "card is available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def _upload(arr, dev):
    """A host array as a tensor on ``dev``: a non-blocking copy from a
    pinned buffer on a card (the buffer is held until the copy is done),
    the array's own memory on the CPU."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # a memmap view: torch takes a copy
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _download(x):
    """A tensor as a host numpy array, through a pinned buffer from a
    card."""
    if not x.is_cuda:
        return x.numpy()
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x)
    return buf.numpy()


def _tile_ranges(n, t):
    return [(i, min(i + t, n)) for i in range(0, n, t)]


def _read_halo(mm, r0, r1, c0, c1, fill):
    """(r1-r0+2, c1-c0+2) block with 1-cell halo; off-grid = fill."""
    h, w = mm.shape
    out = np.full((r1 - r0 + 2, c1 - c0 + 2), fill, np.float32)
    rr0, rr1 = max(r0 - 1, 0), min(r1 + 1, h)
    cc0, cc1 = max(c0 - 1, 0), min(c1 + 1, w)
    out[rr0 - (r0 - 1):rr1 - (r0 - 1),
        cc0 - (c0 - 1):cc1 - (c0 - 1)] = mm[rr0:rr1, cc0:cc1]
    return out


def _open_raster(path):
    """Raster for windowed access: ``.npy`` memmap, or a GeoTIFF via the
    windowed reader (only overlapping strips/tiles are decoded, so a
    compressed GeoTIFF larger than RAM streams through)."""
    p = str(path)
    if p.lower().endswith((".tif", ".tiff")):
        from richdem_tpu_torch.io.geotiff import GeoTIFFWindow
        return GeoTIFFWindow(p)
    return np.load(p, mmap_mode="r")


def _nodata_mask_of(z, no_data):
    if no_data is None:
        return np.zeros(z.shape, bool)
    if isinstance(no_data, float) and np.isnan(no_data):
        return np.isnan(z)
    return z == no_data


def _is_tif(path):
    return str(path).lower().endswith((".tif", ".tiff"))


class _RowBandSink:
    """Streams row-major tile results into a GeoTIFF strip writer; holds
    one tile-row band (O(tile_h × width)), never the raster."""

    def __init__(self, path, rows, cols, shape, dtype=np.float32,
                 no_data=None, compress="deflate", src=None):
        from richdem_tpu_torch.io.geotiff import GeoTIFFStripWriter
        gt = getattr(src, "geotransform", None)
        proj = getattr(src, "projection", "") or ""
        self._w = GeoTIFFStripWriter(path, shape, dtype,
                                     compress=compress,
                                     geotransform=gt, no_data=no_data,
                                     projection=proj)
        self.rows, self.cols = rows, cols
        self.width = shape[1]
        self._band = None
        self._ri = -1
        self._seen = 0

    def put(self, ri, ci, blk):
        if ri != self._ri:
            if self._band is not None:
                raise RuntimeError("tile rows written out of order")
            r0, r1 = self.rows[ri]
            self._band = np.empty((r1 - r0, self.width), np.float32)
            self._ri = ri
            self._seen = 0
        c0, c1 = self.cols[ci]
        self._band[:, c0:c1] = blk
        self._seen += 1
        if self._seen == len(self.cols):
            self._w.write_rows(self._band)
            self._band = None

    def close(self):
        self._w.close()


def out_of_core_fill(dem_path, state_path=None, tile=2048, eps=0.0,
                     no_data=None, max_passes=64, verbose=False,
                     method="auto", stats=None, consumer="auto",
                     cache_tiles="auto", device="cuda", timer=None):
    """Depression-fill a disk-resident DEM with O(tile) memory.

    ``dem_path``: ``.npy`` raster (read via memmap) or a GeoTIFF
    (``.tif``/``.tiff``, compressed and BigTIFF included: windowed reads).
    ``state_path``: where the filled surface is built (defaults to
    ``dem_path`` + ``.filled.npy``; a ``.tif`` path streams a GeoTIFF out
    of the device consumer).  Returns the state path.

    ``method``: ``"twopass"`` = the [P1] label-graph protocol (exactly 2
    data passes; plain fill only), ``"schwarz"`` = iterative halo sweeps
    (any eps), ``"auto"`` = twopass when ``eps == 0``.

    ``consumer`` (twopass only): ``"device"`` = the tile consumers on
    ``device`` and the ring-Dirichlet apply (O(perimeter) host data; no
    label raster on disk), ``"native"`` = the serial C++ tile consumer
    (the cross-validation engine), ``"auto"`` = device on a card, else
    native when it builds, else device on the CPU.

    ``cache_tiles`` (device consumer): keep uploaded elevation tiles on the
    device between the passes when the whole grid fits the budget
    (``RICHDEM_TPU_DEVCACHE_BYTES``, default 6e9 bytes), so that each tile
    goes up once.  ``device``: where the consumers run (``"cuda"`` raises
    without a card).  ``stats``: optional dict, filled with
    ``data_passes``/``tile_loads``/graph sizes.  ``timer``: an optional
    ``PhaseTimer`` (module docstring).  The output equals
    :func:`richdem_tpu_torch.ops.fill.fill_depressions` (the same
    fixpoint)."""
    dev = _run_device(device)
    if method == "auto":
        method = "twopass" if eps == 0.0 else "schwarz"
    if method == "twopass":
        if eps != 0.0:
            raise ValueError("two-pass fill supports plain fill only "
                             "(eps=0); use method='schwarz' for epsilon")
        if consumer == "auto":
            from richdem_tpu_torch import native
            consumer = ("device" if dev.type == "cuda"
                        or not native.available() else "native")
        if consumer == "device":
            return _fill_twopass_device(dem_path, state_path, tile,
                                        no_data, verbose, stats,
                                        cache_tiles, dev, timer)
        return _fill_twopass(dem_path, state_path, tile, no_data,
                             verbose, stats)
    return _fill_schwarz(dem_path, state_path, tile, eps, no_data,
                         max_passes, verbose, stats, dev)


def _fill_twopass_device(dem_path, state_path, tile, no_data, verbose,
                         stats, cache_tiles, dev, timer=None):
    """[P1] two-pass fill with the device consumers: pass 1 writes
    nothing; pass 2 writes the global fill.  Disk traffic = 2 reads + 1
    write per tile; host memory O(tile) for the staging buffers +
    O(perimeter) for the protocol."""
    from richdem_tpu_torch.parallel.twopass import fill_twopass_run

    dem = _open_raster(dem_path)
    if no_data is None:
        no_data = getattr(dem, "no_data", None)
    h, w = dem.shape
    if state_path is None:
        state_path = str(dem_path) + ".filled.npy"
    rows = _tile_ranges(h, tile)
    cols = _tile_ranges(w, tile)
    if _is_tif(state_path):
        sink = _RowBandSink(state_path, rows, cols, (h, w),
                            no_data=no_data, src=dem)
        wmm = None
    else:
        sink = None
        wmm = np.lib.format.open_memmap(state_path, mode="w+",
                                        dtype=np.float32, shape=(h, w))
    if cache_tiles == "auto":
        budget = float(os.environ.get("RICHDEM_TPU_DEVCACHE_BYTES", 6e9))
        cache_tiles = h * w * 4 <= budget
    cache = {}

    def load(ri, ci):
        r0, r1 = rows[ri]
        c0, c1 = cols[ci]
        with phase(timer, "disk read"):
            blk = np.array(dem[r0:r1, c0:c1], np.float32)
        with phase(timer, "upload"):
            return _upload(blk, dev)

    t0 = _time.perf_counter()
    if cache_tiles:
        # every upload issued up front: the copies are non-blocking, so
        # they stream while the consumers compute
        for ri in range(len(rows)):
            for ci in range(len(cols)):
                cache[(ri, ci)] = load(ri, ci)
    if stats is not None:
        stats["stage_read_s"] = round(_time.perf_counter() - t0, 2)

    def get_tile(ri, ci):
        if (ri, ci) in cache:
            return cache[(ri, ci)]
        z = load(ri, ci)
        if cache_tiles:
            cache[(ri, ci)] = z
        return z

    def put_tile(ri, ci, filled):
        with phase(timer, "download"):
            blk = _download(filled)
        with phase(timer, "disk write"):
            if sink is not None:
                sink.put(ri, ci, blk)
            else:
                r0, r1 = rows[ri]
                c0, c1 = cols[ci]
                wmm[r0:r1, c0:c1] = blk
        cache.pop((ri, ci), None)  # done with this tile

    fill_twopass_run(get_tile, put_tile, rows, cols, no_data=no_data,
                     stats=stats, verbose=verbose, device=dev, timer=timer)
    with phase(timer, "disk write"):
        if sink is not None:
            sink.close()
        else:
            wmm.flush()
    if stats is not None and cache_tiles:
        # one physical upload per tile even though the protocol touches
        # each tile twice
        stats["tile_uploads"] = len(rows) * len(cols)
    return state_path


def _fill_twopass(dem_path, state_path, tile, no_data, verbose, stats):
    """[P1] two-pass fill: native tile consumers + O(perimeter) label-
    graph combine + apply pass."""
    dem = _open_raster(dem_path)
    if no_data is None:
        no_data = getattr(dem, "no_data", None)
    h, w = dem.shape
    if state_path is None:
        state_path = str(dem_path) + ".filled.npy"
    wmm = np.lib.format.open_memmap(state_path, mode="w+",
                                    dtype=np.float32, shape=(h, w))
    labels_path = str(state_path) + ".labels.npy"
    lmm = np.lib.format.open_memmap(labels_path, mode="w+",
                                    dtype=np.int64, shape=(h, w))
    rows = _tile_ranges(h, tile)
    cols = _tile_ranges(w, tile)
    twopass_fill_into(dem, wmm, lmm, rows, cols, no_data, verbose, stats,
                      apply_pass=True)
    wmm.flush()
    return state_path


def twopass_fill_into(dem, wmm, lmm, rows, cols, no_data, verbose=False,
                      stats=None, apply_pass=True):
    """The [P1] protocol over any array-likes (memmaps or RAM arrays),
    with the native consumer.

    Fills ``wmm`` (f32 filled surface) and ``lmm`` (int64 global labels)
    tile by tile, solves the O(perimeter) label graph, and (if
    ``apply_pass``) applies the raise levels in a second tile sweep.
    Returns the per-label raise array (index 0 = ocean = -inf)."""
    from richdem_tpu_torch import native
    from richdem_tpu_torch.parallel.labelgraph import (minimax_raise,
                                                       reduce_edges)

    h, w = dem.shape
    tile_loads = 0
    next_base = 1  # global label ids; 0 = ocean
    ea, eb, ew = [], [], []

    # ---- pass 1: tile consumers (one DEM read per tile) on a bounded
    # thread pool.  Raster reads stay under a lock (GeoTIFFWindow shares
    # one file handle); label bases, memmap writes and edge appends happen
    # on the main thread in tile order, so the output is bit-identical to
    # the serial sweep at any worker count.
    workers = _ooc_workers()
    tiles = [(r0, r1, c0, c1)
             for (r0, r1) in rows for (c0, c1) in cols]
    read_lock = threading.Lock()

    def consume(t):
        r0, r1, c0, c1 = t
        with read_lock:
            z = np.asarray(dem[r0:r1, c0:c1], np.float64)
        ge = ((1 if r0 == 0 else 0) | (2 if r1 == h else 0)
              | (4 if c0 == 0 else 0) | (8 if c1 == w else 0))
        return native.fill_tile(z, no_data=no_data, global_edges=ge)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        pending = deque()
        it = iter(tiles)
        for t in itertools.islice(it, workers + 2):
            pending.append((t, ex.submit(consume, t)))
        while pending:
            (r0, r1, c0, c1), fut = pending.popleft()
            filled, lab, edges = fut.result()
            nxt = next(it, None)
            if nxt is not None:
                pending.append((nxt, ex.submit(consume, nxt)))
            tile_loads += 1
            nlab = int(lab.max())
            b = next_base
            next_base += nlab
            glab = np.where(lab > 0, lab.astype(np.int64) + (b - 1), 0)
            wmm[r0:r1, c0:c1] = filled.astype(np.float32)
            lmm[r0:r1, c0:c1] = glab
            if edges.shape[0]:
                la = edges[:, 0].astype(np.int64)
                lb = edges[:, 1].astype(np.int64)
                ea.append(np.where(la > 0, la + (b - 1), 0))
                eb.append(np.where(lb > 0, lb + (b - 1), 0))
                ew.append(edges[:, 2])

    # ---- seam edges: O(perimeter) reads along every tile boundary
    def _seam(za, zb, la, lb_):
        """Edges between two adjacent lines (8-adjacency: dj ∈ -1,0,1)."""
        nda = _nodata_mask_of(za, no_data)
        ndb = _nodata_mask_of(zb, no_data)
        wa = np.where(nda, -np.inf, za.astype(np.float64))
        wb = np.where(ndb, -np.inf, zb.astype(np.float64))
        m = za.shape[0]
        for dj in (-1, 0, 1):
            a_sl = slice(max(0, -dj), m - max(0, dj))
            b_sl = slice(max(0, dj), m - max(0, -dj))
            ga, gb = la[a_sl], lb_[b_sl]
            wgt = np.maximum(wa[a_sl], wb[b_sl])
            keep = (ga != gb) & np.isfinite(wgt)
            ea.append(ga[keep])
            eb.append(gb[keep])
            ew.append(wgt[keep])

    for (r0, r1) in rows[:-1]:
        _seam(np.asarray(wmm[r1 - 1]), np.asarray(wmm[r1]),
              np.asarray(lmm[r1 - 1]), np.asarray(lmm[r1]))
    for (c0, c1) in cols[:-1]:
        _seam(np.asarray(wmm[:, c1 - 1]), np.asarray(wmm[:, c1]),
              np.asarray(lmm[:, c1 - 1]), np.asarray(lmm[:, c1]))

    # ---- global O(perimeter) label-graph solve
    if ea:
        a, bb, wgt = reduce_edges(np.concatenate(ea), np.concatenate(eb),
                                  np.concatenate(ew))
    else:
        a = bb = np.zeros(0, np.int64)
        wgt = np.zeros(0, np.float64)
    raise_ = minimax_raise(next_base, a, bb, wgt)
    if next_base > 1 and not np.all(raise_[1:] < np.inf):
        raise RuntimeError("label graph has watersheds unreachable from "
                           "the ocean — combine bug")
    if verbose:
        print(f"label graph: {next_base} labels, {a.shape[0]} edges",
              flush=True)

    # ---- pass 2: apply raise levels (one state read/write per tile);
    # tiles touch disjoint memmap regions, so the pool needs no ordering
    if apply_pass:
        def apply_tile(t):
            r0, r1, c0, c1 = t
            blk = np.asarray(wmm[r0:r1, c0:c1])
            glab = np.asarray(lmm[r0:r1, c0:c1])
            lift = raise_[glab]
            np.maximum(blk, lift.astype(np.float32), out=blk,
                       where=np.isfinite(lift))
            wmm[r0:r1, c0:c1] = blk

        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(apply_tile, tiles))
        tile_loads += len(tiles)
    if stats is not None:
        stats.update(method="twopass", consumer="native", data_passes=2,
                     tile_loads=tile_loads, n_labels=int(next_base),
                     n_edges=int(a.shape[0]))
    return raise_


def _fill_schwarz(dem_path, state_path, tile, eps, no_data, max_passes,
                  verbose, stats, dev):
    from richdem_tpu_torch.parallel.consumer import _local_fill_solve

    dem = _open_raster(dem_path)
    if no_data is None:
        no_data = getattr(dem, "no_data", None)
    h, w = dem.shape
    if state_path is None:
        state_path = str(dem_path) + ".filled.npy"
    wmm = np.lib.format.open_memmap(state_path, mode="w+",
                                    dtype=np.float32, shape=(h, w))
    wmm[:] = BIG

    rows = _tile_ranges(h, tile)
    cols = _tile_ranges(w, tile)
    # serpentine tile orders: forward and reversed
    order_f = [(ri, ci) for ri in range(len(rows))
               for ci in (range(len(cols)) if ri % 2 == 0
                          else range(len(cols) - 1, -1, -1))]
    order_r = list(reversed(order_f))

    for pas in range(max_passes):
        changed = False
        for ri, ci in (order_f if pas % 2 == 0 else order_r):
            r0, r1 = rows[ri]
            c0, c1 = cols[ci]
            z = np.asarray(dem[r0:r1, c0:c1], np.float32)
            nd = _nodata_mask_of(z, no_data)
            ext = _read_halo(wmm, r0, r1, c0, c1, fill=-BIG)
            floor_ext = ext.copy()
            floor_ext[1:-1, 1:-1] = np.where(nd, -BIG, z)
            ext[1:-1, 1:-1] = np.where(
                nd, -BIG, ext[1:-1, 1:-1])
            new_ext = _download(_local_fill_solve(
                _upload(ext, dev), _upload(floor_ext, dev), eps, 256))
            new = new_ext[1:-1, 1:-1]
            old = wmm[r0:r1, c0:c1]
            if not np.array_equal(new, old):
                wmm[r0:r1, c0:c1] = new
                changed = True
        if verbose:
            print(f"pass {pas}: changed={changed}", flush=True)
        if not changed:
            break
    # restore nodata values
    if no_data is not None:
        for r0, r1 in rows:
            z = np.asarray(dem[r0:r1, :])
            blk = wmm[r0:r1, :]
            blk[_nodata_mask_of(z, no_data)] = no_data
            wmm[r0:r1, :] = blk
    wmm.flush()
    if stats is not None:
        stats.update(method="schwarz", data_passes=pas + 1,
                     tile_loads=(pas + 1) * len(rows) * len(cols))
    return state_path


def out_of_core_accum_d8(fd_path, weights_path=None, out_path=None,
                         tile=2048, max_passes=64, verbose=False,
                         method="auto", stats=None, device="cuda",
                         timer=None):
    """D8 flow accumulation over a disk-resident flow-direction raster with
    O(tile) memory: the ``parallel_d8_accum`` [P2] program.

    ``method="twopass"`` (the default): [P2]'s two-pass perimeter-link
    protocol (arxiv 1608.04431 §3–4).  Pass 1 solves each tile with zero
    external inflow and records, per perimeter cell, its local
    accumulation and its link, the perimeter cell its flow path leaves the
    tile through.  The O(perimeter) inter-tile exit graph is propagated
    topologically on the host; pass 2 re-solves each tile once with the
    exact entry inflows injected into the weights.  Exactly two passes
    over the data at any scale.

    ``method="schwarz"``: iterative halo sweeps (the cross-validation
    engine).  Code tiles stay on the device between the passes when the
    grid fits ``RICHDEM_TPU_DEVCACHE_BYTES``.  ``device``, ``stats`` and
    ``timer`` as in :func:`out_of_core_fill`.  ``out_path`` may be a
    ``.tif``."""
    dev = _run_device(device)
    if method == "auto":
        method = "twopass"
    if method == "twopass":
        return _accum_twopass(fd_path, weights_path, out_path, tile,
                              verbose, stats, dev, timer)
    return _accum_schwarz(fd_path, weights_path, out_path, tile,
                          max_passes, verbose, stats, dev)


def _accum_twopass(fd_path, weights_path, out_path, tile, verbose, stats,
                   dev, timer=None, cache_tiles="auto"):
    """[P2] two-pass accumulation driver over disk memmaps
    (:func:`richdem_tpu_torch.parallel.twopass.accum_twopass_run`).  Code
    tiles are cached on the device between the passes when the grid fits
    the budget (int8: 4× cheaper than the elevations)."""
    from richdem_tpu_torch.parallel.twopass import accum_twopass_run

    fd_mm = _open_raster(fd_path)
    h, w = fd_mm.shape
    wt_mm = (_open_raster(weights_path)
             if weights_path is not None else None)
    if out_path is None:
        out_path = str(fd_path) + ".accum.npy"
    rows = _tile_ranges(h, tile)
    cols = _tile_ranges(w, tile)
    if _is_tif(out_path):
        sink = _RowBandSink(out_path, rows, cols, (h, w), src=fd_mm)
        acc = None
    else:
        sink = None
        acc = np.lib.format.open_memmap(out_path, mode="w+",
                                        dtype=np.float32, shape=(h, w))
    if cache_tiles == "auto":
        budget = float(os.environ.get("RICHDEM_TPU_DEVCACHE_BYTES", 6e9))
        cache_tiles = h * w * (1 + (4 if wt_mm is not None else 0)) \
            <= budget
    cache = {}

    def cached(key, src, dtype):
        _, ri, ci = key
        if cache_tiles and key in cache:
            return cache[key]
        r0, r1 = rows[ri]
        c0, c1 = cols[ci]
        with phase(timer, "disk read"):
            blk = np.array(src[r0:r1, c0:c1], dtype)
        with phase(timer, "upload"):
            v = _upload(blk, dev)
        if cache_tiles:
            cache[key] = v
        return v

    def get_fd(ri, ci):
        return cached(("fd", ri, ci), fd_mm, np.int8)

    def get_wt(ri, ci):
        if wt_mm is None:
            return None
        return cached(("wt", ri, ci), wt_mm, np.float32)

    def put_acc(ri, ci, a):
        with phase(timer, "download"):
            blk = _download(a)
        with phase(timer, "disk write"):
            if sink is not None:
                sink.put(ri, ci, blk)
            else:
                r0, r1 = rows[ri]
                c0, c1 = cols[ci]
                acc[r0:r1, c0:c1] = blk
        cache.pop(("fd", ri, ci), None)
        cache.pop(("wt", ri, ci), None)

    accum_twopass_run(get_fd, get_wt, put_acc, rows, cols, (h, w),
                      stats=stats, device=dev, timer=timer)
    with phase(timer, "disk write"):
        if sink is not None:
            sink.close()
        else:
            acc.flush()
    return out_path


def _accum_schwarz(fd_path, weights_path, out_path, tile, max_passes,
                   verbose, stats, dev):
    """Iterative halo-inflow sweeps (the cross-validation engine of the
    two-pass protocol)."""
    from richdem_tpu_torch.parallel.consumer import _local_d8_solve
    from richdem_tpu_torch.topology import DX, DY, D8_INVERSE

    fd_mm = _open_raster(fd_path)
    h, w = fd_mm.shape
    wt_mm = (_open_raster(weights_path)
             if weights_path is not None else None)
    if out_path is None:
        out_path = str(fd_path) + ".accum.npy"
    acc = np.lib.format.open_memmap(out_path, mode="w+",
                                    dtype=np.float32, shape=(h, w))
    acc[:] = 0.0

    rows = _tile_ranges(h, tile)
    cols = _tile_ranges(w, tile)
    order_f = [(ri, ci) for ri in range(len(rows))
               for ci in (range(len(cols)) if ri % 2 == 0
                          else range(len(cols) - 1, -1, -1))]
    order_r = list(reversed(order_f))

    for pas in range(max_passes):
        changed = False
        for ri, ci in (order_f if pas % 2 == 0 else order_r):
            r0, r1 = rows[ri]
            c0, c1 = cols[ci]
            fd_t = np.asarray(fd_mm[r0:r1, c0:c1], np.int8)
            wt = (np.array(wt_mm[r0:r1, c0:c1], np.float32)
                  if wt_mm is not None
                  else np.ones(fd_t.shape, np.float32))
            wt[fd_t < 0] = 0.0
            # boundary inflow from the ring of neighbour-tile cells whose
            # flow direction points into this tile
            fd_ext = np.zeros((r1 - r0 + 2, c1 - c0 + 2), np.int8)
            acc_ext = _read_halo(acc, r0, r1, c0, c1, fill=0.0)
            fe = fd_ext
            rr0, rr1 = max(r0 - 1, 0), min(r1 + 1, h)
            cc0, cc1 = max(c0 - 1, 0), min(c1 + 1, w)
            fe[rr0 - (r0 - 1):rr1 - (r0 - 1),
               cc0 - (c0 - 1):cc1 - (c0 - 1)] = fd_mm[rr0:rr1, cc0:cc1]
            ring = acc_ext.copy()
            ring[1:-1, 1:-1] = 0.0
            th, tw = fd_t.shape
            inflow = np.zeros((th, tw), np.float32)
            for d in range(1, 9):
                inv = int(D8_INVERSE[d])
                contrib = np.where(fe == inv, ring, 0.0)
                dy, dx = int(DY[d]), int(DX[d])
                inflow += contrib[1 + dy:1 + dy + th, 1 + dx:1 + dx + tw]
            new = _download(_local_d8_solve(
                _upload(fd_t, dev), _upload(wt + inflow, dev),
                "Schwarz local D8 solve")).astype(np.float32)
            old = acc[r0:r1, c0:c1]
            if not np.array_equal(new, old):
                acc[r0:r1, c0:c1] = new
                changed = True
        if verbose:
            print(f"pass {pas}: changed={changed}", flush=True)
        if not changed:
            break
    acc.flush()
    if stats is not None:
        stats.update(method="schwarz", data_passes=pas + 1,
                     tile_loads=(pas + 1) * len(rows) * len(cols))
    return out_path
