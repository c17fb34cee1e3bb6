"""Readings that a configuration's limits are set from; not part of a run.

    python3 perfbench/calibrate.py --workload <cell> --seeds 0 1 ... \
        --control-seeds 0 1 2

For each seed of ``--seeds`` it makes the mix's surface of that seed at
the configuration's size, runs the timed path's step on it twice (the first
call of a process builds), times both and judges the second by the
reference: the lower readings.  For each seed of
``--control-seeds`` it judges the reference worked in bfloat16, the
precision below the configuration's float32, in the program's place: the
upper readings.  One JSON line each, and the largest and smallest of
each number at the end.
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
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)

    import torch

    from perfbench import registry, traffic

    bench = registry.load_benchmark()
    cell = registry.workload(bench, args.workload)
    cfg = registry.config(cell["config"])
    mix = registry.traffic(cell["traffic"])
    step = registry.step_module(cfg["entry"]).build(cfg)
    ref = registry.reference_module(cfg["entry"])
    sync = torch.cuda.synchronize

    lower, upper = {}, {}
    for kind, seeds in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for seed in seeds:
            item = traffic.make_pool(dict(mix, pool=1, surface_seed=seed),
                                     cfg, "cuda")[0]
            step_s = []
            for _ in range(2):
                sync()
                t0 = time.perf_counter()
                out, counts = step(item)
                sync()
                step_s.append(time.perf_counter() - t0)
            nodata = traffic.nodata_mask(item)
            expect = ref.reference(item["z"], nodata, out, cfg)
            judged = out
            if kind == "control":
                judged = ref.reference(item["z"], nodata, out, cfg,
                                       control=True)
            numbers = ref.judge(judged, expect, item["z"], nodata, cfg)
            seen = lower if kind == "program" else upper
            for k, v in numbers.items():
                seen.setdefault(k, []).append(v)
            print(json.dumps({"kind": kind, "seed": seed, "step_s": step_s,
                              "counters": counts, "numbers": numbers}),
                  flush=True)
            del out, judged, expect, item
            torch.cuda.empty_cache()
    print(json.dumps({
        "lower": {k: max(v) for k, v in lower.items()},
        "upper": {k: min(v) for k, v in upper.items()},
        "limits": cfg["limits"],
        "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
