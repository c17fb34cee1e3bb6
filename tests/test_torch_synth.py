"""The port's device Perlin generator ↔ the shared numpy generator.

Same seed, so the same per-octave lattices (drawn from
``numpy.random.default_rng`` in the same order); the port evaluates the
field in float32, the numpy generator in float64, hence atol 1e-3 at
amplitude 100.  ``richdem_tpu.synth_jax`` draws its lattices from
``jax.random``, whose bits cannot be reproduced in PyTorch, so the port is
not compared with it.
"""

import numpy as np
import pytest
import torch

from richdem_tpu import synth
from richdem_tpu_torch import synth as tsynth

torch.set_num_threads(1)


@pytest.mark.parametrize("hw,seed,octaves", [((64, 64), 0, 5),
                                             ((97, 150), 7, 4),
                                             ((200, 33), 3, 6)])
def test_perlin_matches_numpy_generator(hw, seed, octaves):
    got = tsynth.perlin_dem(*hw, seed=seed, octaves=octaves,
                            device="cpu")
    want = synth.perlin_dem(*hw, seed=seed, octaves=octaves,
                            dtype=np.float64)
    assert got.dtype == torch.float32 and tuple(got.shape) == hw
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_perlin_is_deterministic_and_seeded():
    a = tsynth.perlin_dem(40, 50, seed=1, device="cpu")
    assert torch.equal(a, tsynth.perlin_dem(40, 50, seed=1, device="cpu"))
    assert not torch.equal(a, tsynth.perlin_dem(40, 50, seed=2,
                                                device="cpu"))
