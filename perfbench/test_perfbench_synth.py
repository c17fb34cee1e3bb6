"""The benchmark's frozen generator is, today, bitwise the program's own
(``richdem_tpu_torch.synth``); only this test imports the program's."""

import pytest
import torch

from perfbench import synth


@pytest.mark.parametrize("shape,seed,octaves", [
    ((64, 64), 0, 5), ((64, 64), 3 * 2**31 + 7, 5), ((48, 80), 11, 3)])
def test_perlin_is_the_programs(shape, seed, octaves):
    from richdem_tpu_torch import synth as program

    h, w = shape
    ours = synth.perlin_dem(h, w, seed=seed, octaves=octaves, device="cpu")
    theirs = program.perlin_dem(h, w, seed=seed, octaves=octaves,
                                device="cpu")
    assert ours.dtype == torch.float32
    assert torch.equal(ours, theirs)


def test_nodata_holes_are_the_programs():
    from richdem_tpu_torch import synth as program

    z = synth.perlin_dem(64, 64, seed=5, device="cpu")
    ours = synth.with_nodata_holes(z, no_data=-9999.0, seed=5, n_holes=6)
    theirs = program.with_nodata_holes(z, no_data=-9999.0, seed=5,
                                       n_holes=6)
    assert torch.equal(ours, theirs)
    assert bool((ours == -9999.0).any())
