"""The port's D∞ path on the CPU against the benchmark's plain reference
(``perfbench/reference/dinf_twi.py``), which shares no code with either
package.

The whole step (``perfbench/steps/dinf_twi.py``: the ε-fill, Tarboton
angles, D∞ accumulation, slope and TWI through the port's public entries
in a user's order) is judged within every limit of the configuration;
each stage is held to the reference's stage fed with the port's own input
to it; the judge counts one corrupted cell of each output; a field with
its shares swapped, ``p`` for ``1 - p``, fails ``accum_gap``; the bfloat16
control fails; and the reference imports nothing of either package.
"""

import math

import pytest
import torch

from perfbench import registry, synth, traffic
from perfbench.reference import dinf_twi as ref
from perfbench.reference import fill, flow, terrain

torch.set_num_threads(1)

ND = -9999.0
CFG = registry.config("dinf_twi_10k")
LIMITS = CFG["limits"]
#: name: (height, width, nodata holes, surface seed)
DEMS = {"64x72": (64, 72, False, 11), "64x72_holes": (64, 72, True, 12),
        "128x136_holes": (128, 136, True, 13)}


@pytest.fixture(scope="module")
def steps():
    """The step's outputs on each DEM, computed once a module."""
    step = registry.step_module("dinf_twi").build(CFG)
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


def _within(numbers, but=()):
    """Every number but those of ``but`` within its limit."""
    return {k: v for k, v in numbers.items()
            if k not in but and not v <= LIMITS[k]}


@pytest.mark.parametrize("name", sorted(DEMS))
def test_the_whole_step_is_within_every_limit(steps, name):
    z, nodata, out, counters = steps(name)
    numbers = ref.judge(out, ref.reference(z, nodata, out, CFG), z, nodata,
                        CFG)
    assert set(numbers) == set(LIMITS)
    assert _within(numbers) == {}, numbers
    assert counters["dinf.rotations"] >= 1
    assert counters["fill.rotations"] >= 1
    # the holes and the grid's edge leave cells with no lower neighbour
    assert int((out["angles"] == ref.NO_FLOW).sum()) > 0


STAGES = ("fill", "angles", "accum", "slope", "twi")


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("name", sorted(DEMS))
def test_each_stage_is_the_reference_on_the_ports_input(steps, name,
                                                        stage):
    """Each stage of the reference, fed with the port's own input to the
    stage, gives the port's output of it: the fill solves its equation,
    the angles lie within float32 rounding of a steepest facet, the
    accumulation within float32 rounding and the port's snapped shares of
    the float64 sum over its angles, slope within float32 rounding of
    Horn's and TWI bit for bit."""
    import richdem_tpu_torch as rt

    z, nodata, out, _ = steps(name)
    filled = out["filled"]
    if stage == "fill":
        check = fill.fixpoint_residual(filled, z, nodata, CFG["eps"])
        assert check == {"residual": 0, "unresolved": 0}
    elif stage == "angles":
        got = rt.dinf_flowdirs(filled, no_data=ND if nodata.any() else None,
                               device="cpu")
        want = ref.tarboton_angles(filled, nodata)
        assert torch.equal(got < 0, want < 0)
        assert torch.equal(got[got < 0].double(), want[want < 0])
        gap = ref.facet_gap(got, filled, nodata)[got >= 0]
        assert float(gap.max()) < 1e-6
    elif stage == "accum":
        from richdem_tpu_torch.ops.dinf import (dinf_two_tap, pack_two_tap,
                                                two_tap_props,
                                                unpack_two_tap)

        planes = ref.two_tap_planes(out["angles"], filled, nodata)
        # the stated shares are the port's snapped shares, bit for bit
        code, p = unpack_two_tap(pack_two_tap(*dinf_two_tap(out["angles"])))
        assert torch.equal(planes.float(),
                           two_tap_props(code, p).permute(2, 0, 1))
        want = flow.mfd_accumulation(planes, (~nodata).double())
        gap = (out["accum"].double() - want).abs() / want.clamp(min=1.0)
        assert float(gap.max()) < 1e-5
    elif stage == "slope":
        want = terrain.slope_radians(filled, nodata)
        data = ~nodata
        assert torch.isnan(out["slope"][nodata]).all()
        assert float((out["slope"] - want)[data].abs().max()) < 1e-6
    else:
        want = terrain.twi(out["accum"], out["slope"])
        assert torch.equal(out["twi"].isnan(), want.isnan())
        assert torch.equal(out["twi"].nan_to_num(), want.nan_to_num())


def _corrupt(out, what):
    """``out`` with one cell of one output made wrong."""
    out = dict(out)
    angles = out["angles"]
    flowing = torch.nonzero(angles >= 0)
    r, c = flowing[len(flowing) // 2].tolist()
    if what == "filled":
        out["filled"] = out["filled"].clone()
        out["filled"][r, c] += 1.0
    elif what == "angles":
        out["angles"] = angles.clone()
        out["angles"][r, c] = math.fmod(float(angles[r, c]) + 0.5,
                                        2 * math.pi)
    elif what == "noflow":
        out["angles"] = angles.clone()
        out["angles"][r, c] = ref.NO_FLOW
    elif what == "accum":
        out["accum"] = out["accum"].clone()
        out["accum"].view(-1)[out["accum"].argmax()] *= 1.01
    else:
        out["twi"] = out["twi"].clone()
        out["twi"][r, c] += 0.01
    return out


@pytest.mark.parametrize("what, number", [
    ("filled", "fill_residual"), ("angles", "angle_gap"),
    ("noflow", "noflow_off"), ("accum", "accum_gap"), ("twi", "twi_gap")])
def test_the_judge_counts_one_corrupted_cell(steps, what, number):
    z, nodata, out, _ = steps("64x72_holes")
    expect = ref.reference(z, nodata, out, CFG)
    numbers = ref.judge(_corrupt(out, what), expect, z, nodata, CFG)
    assert numbers[number] > LIMITS[number], numbers
    if number == "noflow_off":
        assert numbers[number] == 1
    assert _within(numbers, but=(number,)) == {}, numbers


def test_swapped_shares_fail_the_accumulation(steps):
    """The port's accumulation over its own field with ``p`` and ``1 -
    p`` swapped wherever a cell splits its flow fails ``accum_gap``, and
    only that."""
    from richdem_tpu_torch.ops.dinf import (dinf_accumulation,
                                            dinf_two_tap, pack_two_tap,
                                            unpack_two_tap)

    z, nodata, out, _ = steps("128x136_holes")
    code, p = unpack_two_tap(pack_two_tap(*dinf_two_tap(out["angles"])))
    split = (p > 0) & (p < 1)
    assert int(split.sum()) > 100
    swapped = dinf_accumulation(
        code, torch.where(split, 1 - p, p), no_data_mask=nodata,
        device="cpu")
    expect = ref.reference(z, nodata, out, CFG)
    numbers = ref.judge(dict(out, accum=swapped), expect, z, nodata, CFG)
    assert numbers["accum_gap"] > LIMITS["accum_gap"], numbers
    assert _within(numbers, but=("accum_gap",)) == {}, numbers


def test_the_bfloat16_control_is_not_correct(steps):
    z, nodata, out, _ = steps("128x136_holes")
    expect = ref.reference(z, nodata, out, CFG)
    control = ref.reference(z, nodata, out, CFG, control=True)
    numbers = ref.judge(control, expect, z, nodata, CFG)
    assert _within(numbers) != {}, numbers


def test_the_reference_imports_only_torch_and_itself():
    """Every module the reference reaches imports nothing but the standard
    library, torch and the reference's own modules."""
    import ast
    import importlib
    import importlib.util

    allowed = {"__future__", "math", "torch"}
    seen, todo = set(), ["perfbench.reference.dinf_twi"]
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
            "perfbench.reference.grid",
            "perfbench.reference.terrain"} <= seen
