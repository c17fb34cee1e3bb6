"""The port's sharded multi-flow accumulation ↔ the JAX package's, on the
CPU: the two multi-flow cases of tests/test_sharded.py (Quinn and D∞
proportions, and an uneven 67×74 grid).

The port's mesh is 2×4 positions of ``torch.device("cpu")``, the
reference's the conftest's 8 virtual CPU devices; the proportions are the
reference's, in float32, on both sides.  Tolerance: rtol 2e-5, atol 1e-4,
the reference test's own (float sums regroup across block seams and sweep
orders), against the port's single-device accumulation, the reference's
sharded accumulation and its single-device one; the sharded result
conserves the mass within rtol 1e-5, as the reference test checks.
"""

import numpy as np
import pytest
import torch

from richdem_tpu import oracle, synth
from richdem_tpu.ops.accum import flow_accumulation_from_props as jax_props
from richdem_tpu.ops.flowdirs import flow_proportions as jax_proportions
from richdem_tpu.parallel import make_mesh as jax_make_mesh
from richdem_tpu.parallel import sharded as js
from richdem_tpu_torch import convert
from richdem_tpu_torch.ops.accum import flow_accumulation_from_props
from richdem_tpu_torch.parallel import mesh as tmesh, sharded as ts

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh8():
    return tmesh.make_mesh([torch.device("cpu")] * 8)  # 2 x 4


@pytest.fixture(scope="module")
def jmesh8():
    return jax_make_mesh()


def _props(dem, method):
    filled = oracle.priority_flood_epsilon(dem, eps=1e-3)
    return np.asarray(jax_proportions(filled.astype(np.float32),
                                      method=method))


@pytest.mark.parametrize("method", ["Quinn", "Dinf"])
def test_sharded_mfd_accumulation_equals_single_device(mesh8, jmesh8,
                                                       method):
    props = _props(synth.perlin_dem(64, seed=4, dtype=np.float64), method)
    tp = convert.props_from_numpy(props, device="cpu")
    stats = {}
    got = ts.sharded_accumulation_mfd(tp, mesh=mesh8, stats=stats).numpy()
    np.testing.assert_allclose(got, flow_accumulation_from_props(tp),
                               rtol=2e-5, atol=1e-4)
    want = np.asarray(js.sharded_accumulation_mfd(props, mesh=jmesh8))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jax_props(props)),
                               rtol=2e-5, atol=1e-4)
    out = props.sum(-1)
    np.testing.assert_allclose(got[out < 1e-9].sum(), 64 * 64, rtol=1e-5)
    assert stats["mfd_outer_iters"] >= 2


def test_sharded_mfd_accumulation_uneven(mesh8, jmesh8):
    props = _props(synth.perlin_dem(67, 74, seed=5, dtype=np.float64),
                   "Quinn")
    tp = convert.props_from_numpy(props, device="cpu")
    got = ts.sharded_accumulation_mfd(tp, mesh=mesh8).numpy()
    assert got.shape == (67, 74)
    np.testing.assert_allclose(got, flow_accumulation_from_props(tp),
                               rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(js.sharded_accumulation_mfd(props, mesh=jmesh8)),
        rtol=2e-5, atol=1e-4)
