"""The benchmark of richdem_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A run builds the program's kernels (or finds them built in the checkout),
makes the cell's pool of DEMs on the card, warms the step up once, then
runs a closed loop of whole-DEM steps through the pool, in the pool's
order, pass after pass, until the first step that ends ``--seconds`` or
more after the window opened (and not before the judged step): one client that sends the next DEM when the
last step's results are on the card.  A step ends in
``torch.cuda.synchronize()``; one that raises (a fixpoint that does not
converge) counts in ``failed``.  Once the window has closed, one step of
the first pass over the pool, drawn from the seed, is judged by the plain
reference (``perfbench/reference/``), each number against the limit that
the configuration gives it.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; ``checks``, each number compared with its limit, comes
last.  The same numbers are the last lines of standard error.  A run
without a CUDA card, or with fewer cards than the cell asks for, exits 2
and prints no result; one that finds JAX or the JAX package loaded once
the window has closed exits 3.
"""

from __future__ import annotations

import time

_STARTED = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: Top-level module names that no run may hold once its window closes.
BANNED = ("jax", "jaxlib", "flax", "richdem_tpu")
#: Build and kernel caches, at fixed paths inside the checkout.
CACHE = os.path.join(ROOT, ".perfbench_cache")
CACHE_ENV = {"TRITON_CACHE_DIR": "triton",
             "TORCH_EXTENSIONS_DIR": "torch_extensions",
             "CUDA_CACHE_PATH": "cuda"}
GIB = float(1 << 30)


def banned_modules() -> list:
    """Loaded modules whose whole top-level name is banned."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(BANNED))


def _percentile(values, q):
    """The ``q``-th percentile, interpolated between order statistics."""
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def _card(torch):
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    info = {"name": torch.cuda.get_device_name(0)}
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        info["nvidia_smi"] = proc.stdout.strip().splitlines()[:1]
    except (OSError, subprocess.SubprocessError):
        info["nvidia_smi"] = []
    return info


def _number(v):
    """A JSON-safe number: non-finite values as strings."""
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    return v


def run_cell(workload, seed, seconds, trace, device="cuda", overrides=None,
             base=None, log=print):
    """One run of ``workload``; returns the result's fields, ``checks``
    last, or ``None`` when a banned module is loaded at the end.
    ``overrides`` replace keys of the configuration (tests run tiny
    shapes on the CPU); ``base`` is the benchmark's folder (a copy, in
    tests)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import registry, tracing, traffic

    base = base or registry.PERFBENCH
    bench = registry.load_benchmark(os.path.dirname(base))
    cell = registry.workload(bench, workload)
    cfg = dict(registry.config(cell["config"], base), **(overrides or {}))
    mix = registry.traffic(cell["traffic"], base)
    step = registry.step_module(cfg["entry"], base).build(cfg)
    ref = registry.reference_module(cfg["entry"], base)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    torch.set_num_threads(2)
    pool = traffic.make_pool(mix, cfg, device)
    cells = pool[0]["z"].numel()
    # the judged step: one of the first pass over the pool
    sample_at = int(np.random.default_rng([seed % (1 << 64), 1])
                    .integers(len(pool)))
    step(pool[0])
    sync()
    setup_s = time.monotonic() - _STARTED

    times, counters = [], defaultdict(list)
    attempted = failed = 0
    sample = None
    proc_peak = torch.cuda.max_memory_allocated() if cuda else 0
    step_peak = 0
    tracer = (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if trace else contextlib.nullcontext())
    with tracer as prof:
        with record_function(tracing.WINDOW_SPAN):
            start = time.perf_counter()
            while True:
                item = pool[attempted % len(pool)]
                if cuda:
                    proc_peak = max(proc_peak,
                                    torch.cuda.max_memory_allocated())
                    torch.cuda.reset_peak_memory_stats()
                    held = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                try:
                    out, counts = step(item)
                    sync()
                except RuntimeError as exc:
                    out = None
                    failed += 1
                    log(f"step {attempted} failed: {exc}", file=sys.stderr)
                t1 = time.perf_counter()
                if out is not None:
                    times.append(t1 - t0)
                    for name, value in counts.items():
                        counters[name].append(value)
                if cuda:
                    step_peak = max(step_peak,
                                    torch.cuda.max_memory_allocated() - held)
                if attempted == sample_at:
                    sample = out
                attempted += 1
                del out
                if t1 - start >= seconds and attempted > sample_at:
                    break
            window_s = time.perf_counter() - start

    metrics = {}
    measured = {"cells_per_s": cells * len(times) / window_s,
                "setup_s": setup_s}
    if cuda:
        proc_peak = max(proc_peak, torch.cuda.max_memory_allocated())
        measured["peak_mem_gib"] = step_peak / GIB
    if len(times) >= 2:
        measured["step_ms_p95"] = 1e3 * _percentile(times, 95)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(proc_peak)}
    breakdown = None
    if trace:
        began = time.perf_counter()
        window = tracing.read_trace(prof)
        run = {"trace": window, "steps": attempted, "cells": cells,
               "counters": counters,
               "claimed": registry.claimed_kernels(base)}
        for m in registry.cell_metrics(bench, workload, "per_layer"):
            value = registry.metric_reader(m["name"], base).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = tracing.busy_seconds(window)
        dev["window_s"] = (window["t1"] - window["t0"]) / 1e6
        breakdown = tracing.breakdown(window)
        log(f"trace read in {time.perf_counter() - began:.3f} s: "
            f"{len(window['device'])} device operations, "
            f"{len(window['host'])} host events", file=sys.stderr)
    else:
        for m in registry.cell_metrics(bench, workload, "end_to_end"):
            if m["name"] not in measured:
                if not cuda:  # the card's memory, on a CPU rehearsal
                    continue
                raise KeyError(f"end-to-end metric {m['name']!r} is not "
                               "measured by this harness")
            metrics[m["name"]] = {"value": measured[m["name"]],
                                  "unit": m["unit"]}
    if cuda:
        free, total = torch.cuda.mem_get_info()
        log(f"card memory in use after the window: {total - free} bytes "
            f"of {total}; window {window_s:.3f} s, {attempted} steps",
            file=sys.stderr)
        log(f"card: {json.dumps(_card(torch))}", file=sys.stderr)

    # the program's state goes before the reference runs
    judged = pool[sample_at]
    del pool, step, prof, tracer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, correct = {}, False
    if sample is not None:
        began = time.perf_counter()
        nodata = traffic.nodata_mask(judged)
        expect = ref.reference(judged["z"], nodata, sample, cfg)
        numbers = ref.judge(sample, expect, judged["z"], nodata, cfg)
        log(f"reference and judgement of step {sample_at}: "
            f"{time.perf_counter() - began:.3f} s", file=sys.stderr)
        limits = cfg["limits"]
        if set(numbers) != set(limits):
            raise KeyError(f"numbers {sorted(numbers)} but limits "
                           f"{sorted(limits)}")
        checks = {k: {"value": _number(v), "limit": limits[k]}
                  for k, v in numbers.items()}
        correct = failed == 0 and all(
            v <= limits[k] for k, v in numbers.items())
    banned = banned_modules()
    if banned:
        log(f"loaded once the window closed: {', '.join(banned)}",
            file=sys.stderr)
        return None
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    os.makedirs(CACHE, exist_ok=True)
    for var, sub in CACHE_ENV.items():
        os.environ[var] = os.path.join(CACHE, sub)

    import torch

    from perfbench import registry

    cell = registry.workload(registry.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    if result is None:
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
