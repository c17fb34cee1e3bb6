"""The north star's ratio, measured once; not a metric of the benchmark.

    python3 perfbench/native_ratio.py --seed <n> [--repeat 2]

Times the program's native single-core engine (``richdem_tpu_torch.
native``: Priority-Flood fill, D8 codes, topological D8 accumulation, in
float64 on the host) on the ``d8_pipeline_10k.perlin`` mix's surface of
``--seed``, and prints its cells a second as one JSON line.  The ratio
to the card is ``cells_per_s`` of that cell over this number; the
target is above 10.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--repeat", type=int, default=2)
    args = parser.parse_args(argv)

    from perfbench import registry, traffic
    from richdem_tpu_torch import native

    bench = registry.load_benchmark()
    cell = registry.workload(bench, "d8_pipeline_10k.perlin")
    cfg = registry.config(cell["config"])
    mix = dict(registry.traffic(cell["traffic"]), pool=1,
               surface_seed=args.seed)
    dem = traffic.make_pool(mix, cfg, "cuda")[0]["z"]
    dem = dem.cpu().double().numpy()
    native.available()  # builds the engine outside the timing
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        filled = native.fill(dem, eps=0.0)
        t1 = time.perf_counter()
        codes = native.d8_flowdirs(filled)
        t2 = time.perf_counter()
        native.accum_d8(codes)
        t3 = time.perf_counter()
        print(json.dumps({"seed": args.seed, "cells": dem.size,
                          "fill_s": t1 - t0, "d8_s": t2 - t1,
                          "accum_s": t3 - t2,
                          "cells_per_s": dem.size / (t3 - t0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
