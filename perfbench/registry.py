"""Finds everything a cell needs by name, from files alone.

* ``BENCHMARK.json`` at the root of the checkout: the cells and metrics.
* ``perfbench/configs/<config>.json``: a configuration, its sizes, the
  program's entry it runs and the limit of each number compared.
* ``perfbench/steps/<entry>.py`` and ``perfbench/reference/<entry>.py``:
  the calls into the program that one step makes, and the plain reference
  with the numbers that judge the step's outputs.
* ``perfbench/traffic/<mix>.json``: the parameters that
  :func:`perfbench.traffic.make_pool` reads.
* ``perfbench/metrics/<metric>.py``: a per-layer metric's reader.

Adding a cell, a configuration, a mix or a metric adds files and entries;
no file here lists them.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

PERFBENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PERFBENCH)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
#: Keys every configuration file gives.
CONFIG_KEYS = ("name", "source", "entry", "shape", "dtype", "reduced",
               "limits")
#: Keys every traffic file gives.
TRAFFIC_KEYS = ("generator", "pool", "surface_seed", "loop")


def _json(path):
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def load_benchmark(root=ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def config(name, base=PERFBENCH) -> dict:
    return _json(os.path.join(base, "configs", f"{name}.json"))


def traffic(name, base=PERFBENCH) -> dict:
    return _json(os.path.join(base, "traffic", f"{name}.json"))


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def step_module(entry, base=PERFBENCH):
    return _module(os.path.join(base, "steps", f"{entry}.py"),
                   f"perfbench_step_{entry}")


def reference_module(entry, base=PERFBENCH):
    """``perfbench/reference/<entry>.py``, imported as part of the
    ``perfbench.reference`` package when ``base`` is this package."""
    if os.path.abspath(base) == PERFBENCH:
        return importlib.import_module(f"perfbench.reference.{entry}")
    return _module(os.path.join(base, "reference", f"{entry}.py"),
                   f"perfbench_reference_{entry}")


def metric_reader(name, base=PERFBENCH):
    return _module(os.path.join(base, "metrics", f"{name}.py"),
                   f"perfbench_metric_{name.replace('.', '_')}")


def listed(kind, base=PERFBENCH) -> list:
    """Names of the files of one kind on disk: ``configs``, ``traffic``,
    ``metrics``, ``steps``."""
    ext = ".py" if kind in ("metrics", "steps") else ".json"
    folder = os.path.join(base, kind)
    return sorted(f[:-len(ext)] for f in os.listdir(folder)
                  if f.endswith(ext) and not f.startswith("_"))


def claimed_kernels(base=PERFBENCH) -> tuple:
    """Every kernel name pattern that some metric's reader claims for its
    layer (its ``KERNELS``)."""
    out = []
    for name in listed("metrics", base):
        out += list(getattr(metric_reader(name, base), "KERNELS", ()))
    return tuple(dict.fromkeys(out))


def workload(bench, name) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench, cell_name, section) -> list:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    the cell reports."""
    return [m for m in bench[section]
            if "workloads" not in m or cell_name in m["workloads"]]


def validate(bench, base=PERFBENCH) -> list:
    """Problems with the benchmark's names and files; empty when every
    cell finds its configuration, mix, step, reference and metric readers
    and every name and unit keeps to its characters."""
    problems = []
    cfg_names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        if not NAME.match(c["name"]):
            problems.append(f"config name {c['name']!r}")
        for key in c.get("reduced", []):
            if not NAME.match(key):
                problems.append(f"reduced key {key!r}")
        path = os.path.join(base, "configs", f"{c['name']}.json")
        if not os.path.exists(path):
            problems.append(f"no file for config {c['name']!r}")
            continue
        cfg = _json(path)
        for key in CONFIG_KEYS:
            if key not in cfg:
                problems.append(f"config {c['name']!r} lacks {key!r}")
        entry = cfg.get("entry", "")
        for kind in ("steps", "reference"):
            if not os.path.exists(os.path.join(base, kind, f"{entry}.py")):
                problems.append(f"no {kind} file for entry {entry!r}")
    for cell in bench["workloads"]:
        for key in ("name", "config", "traffic"):
            if not NAME.match(cell[key]):
                problems.append(f"workload {key} {cell[key]!r}")
        if cell["config"] not in cfg_names:
            problems.append(f"workload {cell['name']!r}: unknown config")
        path = os.path.join(base, "traffic", f"{cell['traffic']}.json")
        if not os.path.exists(path):
            problems.append(f"no file for traffic {cell['traffic']!r}")
        else:
            mix = _json(path)
            for key in TRAFFIC_KEYS:
                if key not in mix:
                    problems.append(f"traffic {cell['traffic']!r} lacks "
                                    f"{key!r}")
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            if not NAME.match(m["name"]):
                problems.append(f"metric name {m['name']!r}")
            if not UNIT.match(m["unit"]):
                problems.append(f"unit {m['unit']!r} of {m['name']!r}")
    for m in bench["per_layer"]:
        path = os.path.join(base, "metrics", f"{m['name']}.py")
        if not os.path.exists(path):
            problems.append(f"no reader for metric {m['name']!r}")
        elif not hasattr(metric_reader(m["name"], base), "read"):
            problems.append(f"reader of {m['name']!r} has no read()")
    return problems
