#!/usr/bin/env python3
"""Where the device time goes: one step of each full-size path of the
PyTorch port, traced with ``torch.profiler`` on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/torch_profile.py OUT_DIR

Paths, at 10240² on a Perlin DEM (seed 0), each after one warm-up step:

* ``main``    — ``make_pipeline(eps=0, with_twi=True)`` (BASELINE.json
  config 3, ``bench.py``'s default);
* ``config2`` — ``auto_epsilon`` → ε-fill → D8 → ``resolve_flats``
  (BASELINE.json config 2, ``bench.py``'s ``fill_flats``);
* ``flats``   — ``resolve_flats`` of the main path's ε = 0 output (flat
  lakes).

For each path it writes the Chrome trace to ``OUT_DIR`` (a directory that
git ignores) and prints one JSON line: the host wall time of the traced
step, the device busy time (the union of the kernel, memcpy and memset
intervals of the trace), the idle share (1 − busy / wall), and device time
and launch count by group: each of the port's five kernels by its CUDA
function name, the rest by the name of the PyTorch kernel.  The card's
``name, power.limit`` comes first.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

MAIN = 10240
#: CUDA function name (as the trace shows it) → kernel of the port
PORT_KERNELS = {"fill_sweep_kernel": "fill_sweep", "d8_kernel": "d8",
                "accum_sweep_kernel": "accum_sweep",
                "dist_sweep_kernel": "dist_sweep",
                "terrain_kernel": "terrain"}


def _group(name):
    for fn, kernel in PORT_KERNELS.items():
        if fn in name:
            return kernel
    return name[:90]


def _busy_us(events):
    """Length of the union of the [ts, ts + dur) intervals."""
    total, end = 0.0, None
    for ts, dur in sorted((e["ts"], e["dur"]) for e in events):
        if end is None or ts > end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total


def trace(name, fn, out_dir):
    """Warm up, trace one call of ``fn``, and summarise the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    path = os.path.join(out_dir, f"trace_{name}.json")
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    events = [e for e in doc.get("traceEvents", [])
              if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    groups = defaultdict(lambda: [0.0, 0])
    for e in events:
        g = groups[_group(e.get("name", ""))]
        g[0] += e["dur"]
        g[1] += 1
    busy = _busy_us(events)
    top = sorted(groups.items(), key=lambda kv: -kv[1][0])
    return {"path": name, "wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us, "events": len(events),
            "by_group_ms": {k: [round(v[0] / 1e3, 4), v[1]]
                            for k, v in top[:14]}}


def main():
    import torch

    if len(sys.argv) != 2:
        raise SystemExit(f"usage: {sys.argv[0]} OUT_DIR")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the profile needs one")
    out_dir = sys.argv[1]
    os.makedirs(out_dir, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)

    from richdem_tpu_torch import (auto_epsilon, make_pipeline,
                                   resolve_flats)
    from richdem_tpu_torch import synth as tsynth
    from richdem_tpu_torch.ops import fill, flowdirs

    dev = torch.device("cuda", 0)
    z = tsynth.perlin_dem(MAIN, MAIN, seed=0, device=dev)
    nd = torch.zeros_like(z, dtype=torch.bool)
    step = make_pipeline((MAIN, MAIN), eps=0.0, fill_iters=256,
                         with_twi=True)
    eps = auto_epsilon(z)

    def config2():
        filled, _, done = fill.fill_depressions_info(z, eps=eps,
                                                     max_iters=256)
        if not done:
            raise RuntimeError("config 2 fill did not converge")
        fd = flowdirs.d8_core(filled, nd)
        return resolve_flats(filled, fd)

    out = step(z)
    results = [trace("main", lambda: step(z), out_dir),
               trace("config2", config2, out_dir),
               trace("flats", lambda: resolve_flats(out["filled"],
                                                    out["flowdirs"]),
                     out_dir)]
    for res in results:
        res["card"] = card
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
