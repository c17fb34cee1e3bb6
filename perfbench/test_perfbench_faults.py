"""The check that decides ``correct``: it passes the program as it is and
fails each fault the cells can have, planted where the program produces
its answer; and the control, the reference worked in bfloat16, fails it.

The runs skip the look for a card: ``run_cell`` drives the pool, the
warm-up, the window, the sample and the judgement on the CPU, where the
program runs its kernels' plain versions, at a size a test can hold.
"""

import pytest
import torch

import richdem_tpu_torch as rt
from perfbench import registry, run, traffic
from richdem_tpu_torch import pipeline
from richdem_tpu_torch.ops import fill as program_fill

SHAPE = {"shape": [40, 48]}
D8 = "d8_pipeline_10k.perlin"
QUINN = "quinn_mfd_10k.perlin"


def _run(cell, seed=2**31 + 5):
    return run.run_cell(cell, seed, 0.01, False, device="cpu",
                        overrides=SHAPE, log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", [D8, QUINN])
def test_the_program_as_it_is_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert list(result)[-1] == "checks"


def _unchanged_fill(dem, nodata_mask=None, eps=0.0, max_iters=1024, **_):
    return dem.to(torch.float32), 1, True


def _unchanged_accumulation(flowdirs, weights, max_rotations=64, **_):
    return weights.to(torch.float32), 1, True


def _top_half(entry, keys):
    """``entry`` run on the top half of the DEM alone; the other half of
    every output left at zero."""
    def broken(dem, *args, **kwargs):
        h = dem.shape[0] // 2
        part = entry(dem[:h], *args, **kwargs)
        out = dict(part)
        for k in keys:
            full = torch.zeros(dem.shape[:2] + part[k].shape[2:],
                               dtype=part[k].dtype)
            full[:h] = part[k]
            out[k] = full
        return out
    return broken


def _altered(entry, key):
    """``entry`` with one answer altered: the least value of ``key`` plus
    one."""
    def broken(*args, **kwargs):
        out = dict(entry(*args, **kwargs))
        flat = out[key].clone().reshape(-1)
        flat[int(torch.argmin(flat))] += 1
        out[key] = flat.view(out[key].shape)
        return out
    return broken


def _quinn_accumulation(fault):
    entry = rt.flow_accumulation_from_props

    def broken(props, **kwargs):
        acc, rotations, done = entry(props, **kwargs)
        if fault == "unchanged":
            acc = torch.ones_like(acc)
        elif fault == "half":
            acc = acc.clone()
            acc[acc.shape[0] // 2:] = 0
        else:
            acc = acc.clone().reshape(-1)
            acc[int(torch.argmin(acc))] += 1
            acc = acc.view(props.shape[:2])
        return acc, rotations, done
    return broken


D8_FAULTS = {
    "fill_returns_its_start": (pipeline, "fill_depressions_info",
                               _unchanged_fill),
    "accumulation_returns_its_start": (pipeline, "d8_accumulation_info",
                                       _unchanged_accumulation),
    "half_the_dem_left_out": (rt, "terrain_pipeline", _top_half(
        rt.terrain_pipeline, ("filled", "flowdirs", "accum", "slope",
                              "twi"))),
    "one_answer_altered": (rt, "terrain_pipeline", _altered(
        rt.terrain_pipeline, "accum")),
}
QUINN_FAULTS = {
    "fill_returns_its_start": (program_fill, "fill_depressions_info",
                               _unchanged_fill),
    "accumulation_returns_its_start": (
        rt, "flow_accumulation_from_props", _quinn_accumulation("unchanged")),
    "half_the_dem_left_out": (rt, "flow_accumulation_from_props",
                              _quinn_accumulation("half")),
    "one_answer_altered": (rt, "flow_accumulation_from_props",
                           _quinn_accumulation("altered")),
}


@pytest.mark.parametrize("cell,fault", [(D8, f) for f in D8_FAULTS]
                         + [(QUINN, f) for f in QUINN_FAULTS])
def test_a_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    owner, name, broken = (D8_FAULTS if cell == D8 else QUINN_FAULTS)[fault]
    monkeypatch.setattr(owner, name, broken)
    result = _run(cell)
    assert not result["correct"], result["checks"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", [D8, QUINN])
def test_the_control_fails_the_check(cell):
    """The reference worked in bfloat16, in the program's place, at a
    size a test can hold: some number passes its limit."""
    bench = registry.load_benchmark()
    cfg = dict(registry.config(registry.workload(bench, cell)["config"]),
               shape=[96, 96])
    step = registry.step_module(cfg["entry"]).build(cfg)
    ref = registry.reference_module(cfg["entry"])
    for seed in (1, 2, 3):
        mix = dict(registry.traffic("perlin"), pool=1, surface_seed=seed)
        item = traffic.make_pool(mix, cfg, "cpu")[0]
        nodata = traffic.nodata_mask(item)
        out, _ = step(item)
        expect = ref.reference(item["z"], nodata, out, cfg)
        assert all(v <= cfg["limits"][k] for k, v in
                   ref.judge(out, expect, item["z"], nodata, cfg).items())
        control = ref.reference(item["z"], nodata, out, cfg, control=True)
        numbers = ref.judge(control, expect, item["z"], nodata, cfg)
        assert any(v > cfg["limits"][k] for k, v in numbers.items()), \
            numbers
