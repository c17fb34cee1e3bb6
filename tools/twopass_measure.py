#!/usr/bin/env python3
"""Host↔card transfers of the out-of-core programs, and the device
generator's peak memory, on one CUDA card.

Run from the repository root on a machine with a card:

    python3 tools/twopass_measure.py [transfers] [synth_peak] [fill]

(all three when none is named).  Each measurement prints one JSON line
with the card's ``name, power.limit`` from nvidia-smi.

* ``transfers`` — one 2048² float32 tile of a disk-resident 10240² Perlin
  DEM (seed 0; a ``.npy`` memmap in a temporary directory), filled on the
  card: the upload from a pinned buffer (non-blocking, then synchronised)
  and from pageable memory; the full download of the filled tile through a
  pinned buffer and through pageable memory; and the JAX package's sparse
  raised-cell download (``fetch_tile`` of its ``parallel/outofcore.py``:
  compare with the uploaded tile, gather the raised cells, download their
  values and indices, patch a fresh host read of the tile), at the tile's
  own raised share and with every cell raised.  Each the mean of five
  after one warm-up, host wall clock.
* ``synth_peak`` — the card's peak allocation of ``synth.perlin_dem`` at
  10240² and 16384², against the field's own bytes.
* ``fill`` — ``out_of_core_fill`` of a 10240² Perlin DEM (seed 0) with
  nodata holes on disk, two-pass, tile 2048, device consumer, tiles not
  cached, bitwise the in-core fill: host seconds of one warm-up and of
  REPS runs, the last run's phases (``debug.PhaseTimer``) and launches of
  the resolve sweep and of the successor jump; and the drain labels of
  the first tile (``consumer._labels_impl``), CUDA-event milliseconds a
  call, the mean of REPS after one warm-up.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

TILE = 2048
EDGE = 10240
REPS = 5


def card_line():
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0].strip()


def mean_ms(fn):
    """Host milliseconds per call of ``fn`` (synchronised), the mean of
    REPS after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / REPS


def transfers(card):
    import torch
    from richdem_tpu_torch import synth
    from richdem_tpu_torch.ops import fill
    from richdem_tpu_torch.parallel import outofcore

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "dem.npy")
        np.save(p, synth.perlin_dem(EDGE, EDGE, seed=0, device=dev).cpu()
                .numpy())
        dem = np.load(p, mmap_mode="r")
        blk = np.array(dem[:TILE, :TILE], np.float32)
        z = outofcore._upload(blk, dev)
        filled = fill.fill_depressions(z)
        torch.cuda.synchronize()
        share = float((filled != z).float().mean())

        def sparse(f):
            m = (f != z).reshape(-1)
            idx = torch.nonzero(m).reshape(-1)
            host = np.array(dem[:TILE, :TILE], dtype=np.float32)
            vals = outofcore._download(f.reshape(-1)[idx])
            host.reshape(-1)[idx.cpu().numpy()] = vals
            return host

        raised = filled + 1.0
        out = {
            "upload_pinned_ms": mean_ms(lambda: outofcore._upload(blk, dev)),
            "upload_pageable_ms": mean_ms(
                lambda: torch.from_numpy(blk).to(dev)),
            "download_pinned_ms": mean_ms(
                lambda: outofcore._download(filled)),
            "download_pageable_ms": mean_ms(lambda: filled.cpu().numpy()),
            "host_tile_read_ms": mean_ms(
                lambda: np.array(dem[:TILE, :TILE], np.float32)),
            "sparse_ms": mean_ms(lambda: sparse(filled)),
            "sparse_all_raised_ms": mean_ms(lambda: sparse(raised)),
            "raised_share": share,
        }
        if not np.array_equal(sparse(filled), filled.cpu().numpy()):
            raise AssertionError("the sparse download differs from the "
                                 "full one")
    print(json.dumps({"measure": "transfers", "tile": TILE,
                      "tile_bytes": TILE * TILE * 4, **out,
                      "card": card}), flush=True)


def synth_peak(card):
    import torch
    from richdem_tpu_torch import synth

    dev = torch.device("cuda", 0)
    for edge in (EDGE, 16384):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        z = synth.perlin_dem(edge, edge, seed=0, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        field = z.numel() * z.element_size()
        if not bool(torch.isfinite(z).all()):
            raise AssertionError("non-finite Perlin field")
        del z
        print(json.dumps({"measure": "synth_peak", "edge": edge,
                          "peak_bytes": peak, "field_bytes": field,
                          "peak_over_field": peak / field,
                          "seconds_first_call": secs, "card": card}),
              flush=True)


def twopass_fill(card):
    import torch
    from richdem_tpu_torch import debug, synth
    from richdem_tpu_torch.ops import fill, flats, flowdirs, successor
    from richdem_tpu_torch.parallel import consumer
    from richdem_tpu_torch.parallel.outofcore import out_of_core_fill

    dev = torch.device("cuda", 0)
    nd = -9999.0
    kernels = {"resolve_sweep": successor.RESOLVE_SWEEP,
               "resolve_jump": successor.RESOLVE_JUMP}
    with tempfile.TemporaryDirectory() as tmp:
        z = synth.with_nodata_holes(
            synth.perlin_dem(EDGE, EDGE, seed=0, device=dev), no_data=nd)
        p = os.path.join(tmp, "dem.npy")
        np.save(p, z.cpu().numpy())
        want = fill.fill_depressions(z, no_data=nd).cpu().numpy()
        del z
        secs = []
        for _ in range(REPS + 1):
            timer, stats = debug.PhaseTimer(), {}
            before = {k: kern.launches for k, kern in kernels.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = out_of_core_fill(p, os.path.join(tmp, "filled.npy"),
                                   tile=TILE, method="twopass",
                                   consumer="device", no_data=nd,
                                   stats=stats, cache_tiles=False,
                                   device=dev, timer=timer)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            launches = {k: kern.launches - before[k]
                        for k, kern in kernels.items()}
            if not np.array_equal(np.load(out), want):
                raise AssertionError("the two-pass fill differs from the "
                                     "in-core fill")
        tile = torch.from_numpy(np.array(np.load(p, mmap_mode="r")
                                         [:TILE, :TILE])).to(dev)
    mask = tile == nd
    w_loc = fill.fill_depressions(tile, no_data=nd)
    fd = flats.resolve_flats(w_loc, flowdirs.d8_flowdirs(w_loc, no_data=nd),
                             no_data=nd)
    ge = torch.zeros_like(mask)
    ge[0, :], ge[:, 0] = True, True
    consumer._labels_impl(mask, fd, ge)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        consumer._labels_impl(mask, fd, ge)
    end.record()
    torch.cuda.synchronize()
    print(json.dumps({"measure": "fill", "edge": EDGE, "tile": TILE,
                      "warmup_s": secs[0], "fill_s": secs[1:],
                      "phases_s": dict(timer.times), "launches": launches,
                      "data_passes": stats["data_passes"],
                      "labels_ms": start.elapsed_time(end) / REPS,
                      "card": card}), flush=True)


def main(argv):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = card_line()
    todo = argv or ["transfers", "synth_peak", "fill"]
    for name in todo:
        {"transfers": transfers, "synth_peak": synth_peak,
         "fill": twopass_fill}[name](card)


if __name__ == "__main__":
    main(sys.argv[1:])
