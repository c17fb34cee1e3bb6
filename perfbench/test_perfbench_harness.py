"""The harness is driven by files: a new configuration, mix and per-layer
metric are found by name in a copy of the benchmark with nothing else
edited; ``BENCHMARK.json`` keeps to its names and units; and what a run
loads holds no JAX and nothing of the JAX package."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import registry, run

ROOT = registry.ROOT

NEW_CONFIG = {
    "name": "d8_pipeline_small", "source": "https://github.com/r-barnes/"
    "richdem pyrichdem FillDepressions, FlowAccumulation(method='D8')",
    "entry": "d8_pipeline", "shape": [24, 40], "dtype": "float32",
    "eps": 0.0, "cellsize": 1.0, "with_twi": True, "fill_iters": 256,
    "reduced": ["shape"], "limits": {
        "filled_off": 0, "codes_off": 0, "accum_off": 0,
        "accum_gap": 1e-05, "slope_gap": 1e-05, "twi_gap": 1e-04}}
NEW_MIX = {"generator": "perlin", "octaves": 3, "amplitude": 50.0,
           "pool": 2, "surface_seed": 40, "loop": "closed",
           "holes": {"count": 2, "value": -9999.0}}
NEW_METRIC = '''
from perfbench.layers import counter_mean


def read(run):
    return counter_mean(run, "fill.rotations")
'''


@pytest.fixture
def copy(tmp_path):
    """A copy of the benchmark, with the files of one more cell added."""
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = registry.load_benchmark()
    bench["configs"].append({"name": "d8_pipeline_small",
                             "source": NEW_CONFIG["source"],
                             "file": "perfbench/configs/"
                                     "d8_pipeline_small.json",
                             "reduced": ["shape"], "why": "a test"})
    bench["workloads"].append({"name": "d8_pipeline_small.holes",
                               "config": "d8_pipeline_small",
                               "traffic": "holes", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "fill.rotations_again",
                               "unit": "rotations/step", "better": "lower",
                               "source": "program_counter",
                               "layer": "fill (ops/fill.py)",
                               "moves": "cells_per_s",
                               "workloads": ["d8_pipeline_small.holes"]})
    base = tmp_path / "perfbench"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (base / "configs" / "d8_pipeline_small.json").write_text(
        json.dumps(NEW_CONFIG))
    (base / "traffic" / "holes.json").write_text(json.dumps(NEW_MIX))
    (base / "metrics" / "fill.rotations_again.py").write_text(NEW_METRIC)
    return str(base)


def test_new_files_are_found_and_valid(copy):
    bench = registry.load_benchmark(os.path.dirname(copy))
    assert registry.validate(bench, copy) == []
    assert "d8_pipeline_small" in registry.listed("configs", copy)
    assert "holes" in registry.listed("traffic", copy)
    assert "fill.rotations_again" in registry.listed("metrics", copy)
    names = [m["name"] for m in registry.cell_metrics(
        bench, "d8_pipeline_small.holes", "per_layer")]
    assert names == ["fill.rotations_again"]


def test_a_new_cell_runs_from_its_files(copy):
    result = run.run_cell("d8_pipeline_small.holes", 9, 0.01, True,
                          device="cpu", base=copy,
                          log=lambda *a, **k: None)
    assert result["correct"], result["checks"]
    assert list(result["metrics"]) == ["fill.rotations_again"]
    assert result["metrics"]["fill.rotations_again"]["value"] >= 1


def test_a_missing_file_is_named(copy):
    os.remove(os.path.join(copy, "traffic", "holes.json"))
    bench = registry.load_benchmark(os.path.dirname(copy))
    assert registry.validate(bench, copy) == ["no file for traffic 'holes'"]


def test_the_benchmark_keeps_to_its_names_and_units():
    bench = registry.load_benchmark()
    assert registry.validate(bench) == []
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            assert registry.NAME.match(m["name"])
            assert registry.UNIT.match(m["unit"]) and len(m["unit"]) <= 16
    cells = {c["name"] for c in bench["workloads"]}
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def test_what_a_run_loads_holds_no_jax():
    """A run's whole import chain, in a fresh process, by whole top-level
    names: the program's name begins with the JAX package's."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench import run\n"
        "run.run_cell('d8_pipeline_10k.perlin', 1, 0.01, True, "
        "device='cpu', overrides={'shape': [24, 24]}, "
        "log=lambda *a, **k: None)\n"
        "run.run_cell('quinn_mfd_10k.perlin', 1, 0.01, False, "
        "device='cpu', overrides={'shape': [24, 24]}, "
        "log=lambda *a, **k: None)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    tops = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert "richdem_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "richdem_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import perfbench.reference.d8_pipeline, "
        "perfbench.reference.quinn_mfd\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    tops = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "richdem_tpu",
                       "richdem_tpu_torch"}


def test_without_a_card_a_run_fails_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
         "--workload", "d8_pipeline_10k.perlin", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 2
    assert proc.stdout == ""


def test_banned_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "richdem_tpu_torch_like", sys)
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.banned_modules() == ["jax"]


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.run_cell("d8_pipeline_10k.perlin", 1, 0.01, False,
                        device="cpu", overrides={"shape": [24, 24]},
                        log=lambda *a, **k: None) is None


def test_every_kernel_no_layer_claims_is_glue():
    """D8's stencil, a renamed fill sweep and PyTorch's own kernels count
    in the glue; the kernels a layer's reader claims do not."""
    names = {"fill_sweep_kernel<float>": 3.0, "accum_sweep_kernel": 5.0,
             "void rd::tile::kernel<rd::D8Op>(...)": 0.5,
             "fill_sweep_v2": 2.0, "elementwise_kernel<...>": 7.0}
    trace = {"t0": 0, "t1": 100,
             "device": [{"name": n, "ts": 0, "dur": 1e3 * ms}
                        for n, ms in names.items()], "host": []}
    claimed = registry.claimed_kernels()
    assert "D8Op" not in claimed
    glue = registry.metric_reader("glue.device_ms").read(
        {"trace": trace, "steps": 1, "cells": 1, "counters": {},
         "claimed": claimed})
    assert glue == pytest.approx(0.5 + 2.0 + 7.0)


def test_the_window_closes_on_the_first_step_past_its_seconds():
    """With no seconds to run, the window ends on the judged step: it
    does not run on to the end of the pass."""
    import numpy as np

    seed = 3 * 2**31 + 11
    sample_at = int(np.random.default_rng([seed % (1 << 64), 1])
                    .integers(registry.traffic("perlin")["pool"]))
    result = run.run_cell("d8_pipeline_10k.perlin", seed, 0.0, False,
                          device="cpu", overrides={"shape": [24, 24]},
                          log=lambda *a, **k: None)
    assert result["correct"], result["checks"]
    assert result["attempted"] == sample_at + 1
