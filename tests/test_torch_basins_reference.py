"""The port's basin delineation on the CPU against the benchmark's plain
reference (``perfbench/reference/d8_basins.py``), which shares no code
with either package.

After an ε = 0 fill every filled depression is a flat, so flat
resolution has real work.  The whole step (``perfbench/steps/
d8_basins.py``, the port's public entries in a user's order) is judged by
the reference's numbers, which must all be 0; each stage is held to the
reference's stage fed with the port's own input to it; a hand-made
plateau resolves as Barnes, Lehman & Mulla (2014) work it out; the judge
counts one corrupted cell of each output as one; the bfloat16 control
fails; and the reference imports nothing of either package.
"""

import pytest
import torch

from perfbench import registry, synth, traffic
from perfbench.reference import d8_basins as ref
from perfbench.reference import fill, flow

torch.set_num_threads(1)

ND = -9999.0
CFG = registry.config("d8_basins_10k")
#: name: (height, width, nodata holes, surface seed)
DEMS = {"64x72": (64, 72, False, 11), "64x72_holes": (64, 72, True, 12),
        "128x136_holes": (128, 136, True, 13)}


@pytest.fixture(scope="module")
def steps():
    """The step's outputs on each DEM, computed once a module."""
    step = registry.step_module("d8_basins").build(CFG)
    done = {}

    def get(name):
        if name not in done:
            h, w, holes, seed = DEMS[name]
            z = synth.perlin_dem(h, w, seed=seed, device="cpu")
            no_data = None
            if holes:
                z = synth.with_nodata_holes(z, no_data=ND, seed=seed,
                                            n_holes=3)
                no_data = ND
            item = {"z": z, "no_data": no_data}
            out, counters = step(item)
            done[name] = (z, traffic.nodata_mask(item), out, counters)
        return done[name]

    return get


@pytest.mark.parametrize("name", sorted(DEMS))
def test_the_whole_step_is_the_reference(steps, name):
    z, nodata, out, counters = steps(name)
    assert int((out["flowdirs"] == 0).sum()) < int(
        (flow.d8_codes(out["filled"], nodata) == 0).sum()), "no flat"
    numbers = ref.judge(out, ref.reference(z, nodata, out, CFG), z, nodata,
                        CFG)
    assert numbers == dict.fromkeys(CFG["limits"], 0), numbers
    assert counters["watersheds.doubling"] == counters["upslope.doubling"] \
        == 0


STAGES = ("fill", "d8", "flats", "labels", "order", "accum", "gauges",
          "upslope")


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("name", sorted(DEMS))
def test_each_stage_is_the_reference_on_the_ports_input(steps, name,
                                                        stage):
    """Each stage of the reference, fed with the port's own input to the
    stage, gives the port's output of it, exactly."""
    from richdem_tpu_torch.ops.flowdirs import d8_core

    z, nodata, out, _ = steps(name)
    codes = d8_core(out["filled"], nodata)
    fd = out["flowdirs"]
    if stage == "fill":
        got, want = out["filled"], fill.fill_flat(z, nodata)
    elif stage == "d8":
        got, want = codes, flow.d8_codes(out["filled"], nodata)
    elif stage == "flats":
        got, want = fd, ref.resolve_flats(out["filled"], codes, nodata)
    elif stage == "labels":
        got, want = out["labels"].long(), ref.watershed_labels(fd)
    elif stage == "order":
        assert ref.strahler_defects(out["order"], fd) == 0
        got, want = out["order"].long(), ref.strahler(fd)
    elif stage == "accum":
        got = out["accum"].double()
        want = flow.d8_accumulation(fd, (~nodata).double())
    elif stage == "gauges":
        got, want = out["gauges"], ref.gauges(out["accum"], CFG["gauges"])
    else:
        got, want = out["upslope"], ref.upslope(out["gauges"], fd)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_a_plateau_resolves_as_barnes_works_it_out():
    """A 3 × 5 plateau at 5 inside a rim at 9, drained through one rim
    cell at 4 on the east edge.  Towards lower ``T`` counts columns from
    the cells that flow east; away from higher ``D`` is 1 on the
    plateau's rim and 2 on the middle row's inner cells; so the mask is
    ``2T + 3 - D`` and steepest descent bends the outer rows towards the
    middle one."""
    import richdem_tpu_torch as rt

    z = torch.full((5, 7), 9.0)
    z[1:4, 1:6] = 5.0
    z[2, 6] = 4.0
    nodata = torch.zeros(z.shape, dtype=torch.bool)
    codes = flow.d8_codes(z, nodata)
    want = torch.tensor([[6, 6, 6, 5, 6],
                         [5, 5, 5, 5, 5],
                         [4, 4, 4, 5, 4]], dtype=torch.int8)
    for resolved in (ref.resolve_flats(z, codes, nodata),
                     rt.resolve_flats(z, codes, device="cpu")):
        assert torch.equal(resolved[1:4, 1:6], want)
        assert torch.equal(resolved[0], codes[0])
        assert int(resolved[2, 6]) == 0  # the drain keeps no flow
    assert torch.equal(rt.resolve_flats(z, codes, device="cpu"),
                       ref.resolve_flats(z, codes, nodata))


def _corrupt(out, z, what):
    """``out`` with one cell of one output made wrong."""
    out = dict(out)
    fd = out["flowdirs"]
    if what == "order":
        # a terminal: no other cell's equation reads its order
        r, c = torch.nonzero((fd == 0))[0].tolist()
        out["order"] = out["order"].clone()
        out["order"][r, c] += 1
    elif what == "labels":
        out["labels"] = out["labels"].clone()
        out["labels"][3, 5] += 1
    elif what == "flowdirs":
        out["flowdirs"] = fd.clone()
        out["flowdirs"][3, 5] = 1 + int(fd[3, 5]) % 8
    elif what == "gauges":
        # the gauge of least accumulation goes: one gauge short
        picked = out["gauges"].reshape(-1)
        acc = out["accum"].reshape(-1)
        least = torch.nonzero(picked)[acc[picked].argmin()]
        out["gauges"] = picked.clone()
        out["gauges"][least] = False
        out["gauges"] = out["gauges"].view(z.shape)
    else:
        out["upslope"] = out["upslope"].clone()
        out["upslope"][3, 5] = ~out["upslope"][3, 5]
    return out


@pytest.mark.parametrize("what, number", [
    ("order", "order_defects"), ("labels", "labels_off"),
    ("flowdirs", "codes_off"), ("gauges", "gauges_off"),
    ("upslope", "upslope_off")])
def test_the_judge_counts_one_corrupted_cell_as_one(steps, what, number):
    z, nodata, out, _ = steps("64x72")
    expect = ref.reference(z, nodata, out, CFG)
    numbers = ref.judge(_corrupt(out, z, what), expect, z, nodata, CFG)
    want = dict.fromkeys(CFG["limits"], 0)
    want[number] = 1
    assert numbers == want



@pytest.mark.parametrize("least, ahead, off", [
    (1000.0, 1e-6, 1), (2.0 ** 25, 5e-4, 0), (2.0 ** 25, 3e-3, 1)])
def test_a_passed_over_cell_counts_past_the_guarantee(steps, least, ahead,
                                                      off):
    """A cell passed over for the least gauge counts against the gauges
    where no accumulation the guarantee allows ranks it below that gauge:
    exact at or below 2²⁴, within ``accum_gap``'s limit (1e-3) above."""
    z, nodata, out, _ = steps("64x72")
    expect = ref.reference(z, nodata, out, CFG)
    picked = out["gauges"]
    acc = expect["accum"].double() * (
        least / float(expect["accum"][picked].min()))
    interior = torch.zeros_like(picked)
    interior[1:-1, 1:-1] = True
    r, c = torch.nonzero(interior & ~picked)[0].tolist()
    acc[r, c] = least * (1 + ahead)
    numbers = ref.judge(dict(out, accum=acc), dict(expect, accum=acc), z,
                        nodata, CFG)
    want = dict.fromkeys(CFG["limits"], 0)
    want["gauges_off"] = off
    assert numbers == want

def test_the_bfloat16_control_is_not_correct(steps):
    z, nodata, out, _ = steps("128x136_holes")
    expect = ref.reference(z, nodata, out, CFG)
    control = ref.reference(z, nodata, out, CFG, control=True)
    numbers = ref.judge(control, expect, z, nodata, CFG)
    assert ref.strahler_defects(control["order"], control["flowdirs"]) == 0
    assert any(numbers[k] > CFG["limits"][k] for k in numbers), numbers


def test_the_reference_imports_only_torch_and_itself():
    """Every module the reference reaches imports nothing but the standard
    library, torch and the reference's own modules (``perfbench/
    test_perfbench_basins.py`` checks what a fresh process loads)."""
    import ast
    import importlib
    import importlib.util

    allowed = {"__future__", "math", "torch"}
    seen, todo = set(), ["perfbench.reference.d8_basins"]
    while todo:
        name = todo.pop()
        seen.add(name)
        tree = ast.parse(open(importlib.import_module(name).__file__).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                found = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                found = [node.module] + [f"{node.module}.{a.name}"
                                         for a in node.names]
            else:
                continue
            for mod in found:
                if mod.startswith("perfbench.reference."):
                    if (mod not in seen and mod.count(".") == 2
                            and importlib.util.find_spec(mod)):
                        todo.append(mod)
                elif mod != "perfbench.reference":
                    assert mod.split(".")[0] in allowed, (name, mod)
    assert {"perfbench.reference.fill", "perfbench.reference.flow",
            "perfbench.reference.grid"} <= seen
