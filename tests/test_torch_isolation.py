"""The port stands alone: no JAX, nothing of ``richdem_tpu``, no fallback
from a missing kernel, and the card by default.

The machine with the card has no JAX, so the port imports nothing of the
JAX package, not even a module there that is JAX-free: it carries its own
copies.  The test copies the package to a directory with no
``richdem_tpu/`` beside it and drives it there with ``jax`` unimportable.
Without ``nvcc`` the kernels cannot be built: asking for one raises instead
of quietly running the plain version.  Entry points given an array or
creating data run on the card unless asked for another device.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import richdem_tpu_torch as rt
from richdem_tpu_torch import _build, convert
from richdem_tpu_torch import synth as tsynth
from richdem_tpu_torch.ops import (accum, dinf, fill, flats, flowdirs, mfd,
                                   orlandini, stencil, successor, terrain)
from richdem_tpu_torch.parallel import consumer, outofcore, sharded

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = [fill.FILL_SWEEP, flowdirs.D8, accum.ACCUM_SWEEP, flats.DIST_SWEEP,
           terrain.TERRAIN, dinf.DINF_SWEEP, mfd.MFD_SWEEP, flowdirs.RHO8,
           successor.RESOLVE_SWEEP, successor.STRAHLER_SWEEP, fill.FILL_SCAN]

_ALONE = """
import os, shutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np, torch
torch.set_num_threads(1)
import richdem_tpu_torch as rt
from richdem_tpu_torch import native, synth, synth_np
from richdem_tpu_torch.ops.flowdirs import d8_flowdirs
z = synth.perlin_dem(64, 64, seed=0, device="cpu")
out = rt.check_converged(rt.make_pipeline(z.shape, with_twi=True)(z))
assert float(out["accum"].sum()) > 0
dem = synth_np.depression_dem(48, seed=3)
filled = rt.fill_epsilon(dem, eps=0.0, device="cpu")
fd = rt.resolve_flats(filled, d8_flowdirs(filled))
assert fd.device.type == "cpu" and int((fd[1:-1, 1:-1] == 0).sum()) == 0
slope = rt.terrain_attribute(dem, "slope_radians", device="cpu")
assert bool(torch.isfinite(slope).all())
ang = rt.dinf_flowdirs(filled)
acc = rt.dinf_accumulation_from_angles(ang)
assert bool(torch.isfinite(rt.twi(acc, slope)).all())
props = rt.flow_proportions(filled, "Quinn")
assert float(rt.flow_accumulation_from_props(props).sum()) > 0
labels = rt.watersheds_from_flowdirs(fd)
assert int(rt.strahler_order(fd).max()) >= 2
assert bool(rt.upslope_cells(labels == labels[24, 24], fd).any())
codes = rt.rho8_flowdirs(filled, seed=1)
assert bool(((codes >= 0) & (codes <= 8)).all())
import tempfile
from richdem_tpu_torch import checkpoint, cli, provenance, version
from richdem_tpu_torch.ops.orlandini import orlandini_flowdirs_device
from richdem_tpu_torch.oracle.orlandini import orlandini_flowdirs
from richdem_tpu_torch.parallel import layout
os.environ["RICHDEM_TPU_FILL_ENGINE"] = "scan"
rd = rt.rdarray(torch.from_numpy(dem), no_data=-9999.0)
scan = rt.FillDepressions(rd)
assert torch.equal(scan.tensor(), filled)
acc = rt.FlowAccumulation(rt.FillDepressions(rd, epsilon=True), "Dinf")
assert "FlowAccumulation" in acc.metadata["PROCESSING_HISTORY"]
del os.environ["RICHDEM_TPU_FILL_ENGINE"]
f64 = scan.np().astype(np.float64) + np.arange(48)[:, None] * 1e-3
assert np.array_equal(orlandini_flowdirs_device(f64, device="cpu").numpy(),
                      orlandini_flowdirs(f64))
quinn = rt.PipelineConfig(eps=1e-3, metric="Quinn").run(dem, device="cpu")
assert quinn["accum"].sum() > 0
tmp = tempfile.mkdtemp()
rt.SaveGDAL(os.path.join(tmp, "dem.tif"), rt.rdarray(dem))
cli.main(["--device", "cpu", "pipeline", os.path.join(tmp, "dem.tif"),
          os.path.join(tmp, "out"), "--cache-dir", os.path.join(tmp, "c")])
assert rt.LoadGDAL(os.path.join(tmp, "out.accum.npz")).np().max() > 10
tiles = layout.split_to_layout(rt.rdarray(dem), os.path.join(tmp, "t"),
                               (16, 16))
assert np.array_equal(layout.merge_by_layout(tiles).np(), dem)
if shutil.which("g++"):
    want = native.fill(dem.astype(np.float64))
    assert np.array_equal(want, filled.numpy().astype(np.float64))
    breached = rt.BreachDepressions(rd, eps=1e-6).np()
    assert (breached <= dem).all()
    qa = native.accum_props(props.numpy().astype(np.float64))
    assert np.allclose(qa, rt.flow_accumulation_from_props(props).numpy(),
                       rtol=2e-5)
    assert os.path.exists(native._LIB)
    print("native ok")
assert {"synth", "io", "topology"} <= set(rt.__all__)
assert rt.synth.cone_dem(5, device="cpu").shape == (5, 5)
assert callable(rt.io.load) and int(rt.topology.NO_FLOW) == 0
from richdem_tpu_torch import debug
from richdem_tpu_torch.oracle import accum, breach, fill, fill_variants
from richdem_tpu_torch.oracle import flats, terrain
from richdem_tpu_torch.parallel import (out_of_core_accum_d8,
                                        out_of_core_fill)
np.save(os.path.join(tmp, "dem.npy"), dem)
timer = debug.PhaseTimer()
ooc = np.load(out_of_core_fill(os.path.join(tmp, "dem.npy"), tile=20,
                               consumer="device", device="cpu",
                               timer=timer))
assert np.array_equal(ooc, filled.numpy()) and "pass 1" in timer.times
np.save(os.path.join(tmp, "fd.npy"), fd.numpy())
acc = np.load(out_of_core_accum_d8(os.path.join(tmp, "fd.npy"), tile=20,
                                   device="cpu"))
assert acc.max() > 10
from richdem_tpu_torch.parallel import halo, mesh as pmesh, sharded
m4 = pmesh.make_mesh([torch.device("cpu")] * 4)
ext = halo.exchange_halo(pmesh.grid_sharding(m4).split(filled), m4, 1, 0.0)
assert ext[(0, 0)].shape == (26, 26)
sp = sharded.sharded_pipeline(dem, mesh=m4, eps=0.0)
assert torch.equal(sp["filled"], filled)
from richdem_tpu_torch.ops.accum import d8_accumulation
assert torch.equal(sp["accum"], d8_accumulation(d8_flowdirs(filled)))
cfg = rt.PipelineConfig(eps=0.0, mesh=(2, 2)).run(dem, device="cpu")
assert torch.equal(cfg["flowdirs"], sp["flowdirs"])
reference = os.path.join(sys.argv[1], "richdem_tpu") + os.sep
loaded = [m for m, mod in list(sys.modules.items()) if mod is not None]
assert not any(m == "jax" or m.startswith("jax.") for m in loaded)
assert not any(m == "richdem_tpu" or m.startswith("richdem_tpu.")
               for m in loaded)
files = [getattr(sys.modules[m], "__file__", None) or "" for m in loaded]
assert not any(os.path.abspath(f).startswith(reference) for f in files)
print("ok")
"""


def test_port_runs_alone_without_jax(tmp_path):
    """A copy of the package with no ``richdem_tpu/`` beside it: import, the
    pipeline, flat resolution, a terrain attribute, D∞ and Quinn
    accumulation, the D8 methods, Rho8, the scan fill engine through the
    API, Orlandini, ``PipelineConfig``, the CLI with its phase cache and
    the IO and layout copies, ``rt.synth``/``rt.io``/``rt.topology``, the
    debug module, the oracle copies, the two-pass fill and accumulation on
    the CPU, the sharded mesh (halo exchange, ``sharded_pipeline`` and
    ``PipelineConfig(mesh=...)`` over CPU positions), and (where g++
    exists) the port's own native engine with breaching, which builds into
    the copy."""
    shutil.copytree(os.path.join(REPO, "richdem_tpu_torch"),
                    tmp_path / "richdem_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", _ALONE, REPO],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.split()
    assert lines[-1] == "ok"
    if shutil.which("g++"):
        assert "native" in lines
        assert (tmp_path / "richdem_tpu_torch" / "build"
                / "librichdem_native.so").exists()


def test_no_port_file_names_the_reference_package():
    """No source of the port (or the smoke script) imports, execs or
    builds anything of ``richdem_tpu``."""
    pkg = os.path.join(REPO, "richdem_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(pkg):
        paths += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cpp"))]
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            for ln, line in enumerate(fh, 1):
                code = line.split("#")[0]
                assert "import richdem_tpu " not in code + " ", (path, ln)
                assert "from richdem_tpu " not in code, (path, ln)
                assert "from richdem_tpu." not in code, (path, ln)
                assert "import jax" not in code, (path, ln)


def test_package_exposes_the_reference_names():
    """Every name of the JAX package's ``__all__`` is the port's too, and
    ``synth``, ``io`` and ``topology`` are the port's own modules."""
    import richdem_tpu

    assert set(richdem_tpu.__all__) <= set(rt.__all__)
    for name in ("synth", "io", "topology"):
        mod = getattr(rt, name)
        assert mod.__name__ == f"richdem_tpu_torch.{name}"


def test_parallel_exposes_the_reference_names():
    """The port's ``parallel`` package exports every function that
    ``richdem_tpu.parallel`` does, and its mesh, halo and sharded modules
    every public name of their counterparts."""
    import inspect

    import richdem_tpu.parallel as jp
    from richdem_tpu.parallel import halo as jhalo
    from richdem_tpu.parallel import mesh as jmesh
    from richdem_tpu.parallel import sharded as jsharded
    from richdem_tpu_torch import parallel as tp
    from richdem_tpu_torch.parallel import halo, mesh, sharded

    names = {n for n, v in vars(jp).items()
             if inspect.isfunction(v) and not n.startswith("_")}
    assert names and names <= set(tp.__all__)
    for ref, port in ((jhalo, halo), (jmesh, mesh), (jsharded, sharded)):
        assert set(ref.__all__) <= set(port.__all__)
        for name in ref.__all__:
            assert callable(getattr(port, name))


def _npy(arr):
    import tempfile

    path = os.path.join(tempfile.mkdtemp(), "r.npy")
    np.save(path, arr)
    return path


def _entry_points():
    dem = np.random.default_rng(0).random((12, 14)).astype(np.float32)
    fd = np.zeros(dem.shape, np.int8)
    props = np.zeros(dem.shape + (8,), np.float32)
    return {
        "from_numpy": lambda: convert.from_numpy(dem)[0],
        "perlin_dem": lambda: tsynth.perlin_dem(12, 14),
        "terrain_pipeline": lambda: rt.terrain_pipeline(dem)["accum"],
        "fill_epsilon": lambda: rt.fill_epsilon(dem),
        "fill_depressions": lambda: fill.fill_depressions(dem),
        "d8_flowdirs": lambda: flowdirs.d8_flowdirs(dem),
        "d8_accumulation": lambda: accum.d8_accumulation(fd),
        "resolve_flats": lambda: rt.resolve_flats(dem, fd),
        "flat_mask_and_labels_device":
            lambda: rt.flat_mask_and_labels_device(dem, fd)[0],
        "terrain_attribute": lambda: rt.terrain_attribute(dem, "aspect"),
        "dinf_flowdirs": lambda: rt.dinf_flowdirs(dem),
        "flow_proportions": lambda: rt.flow_proportions(dem, "Quinn"),
        "flow_accumulation_from_props":
            lambda: rt.flow_accumulation_from_props(props),
        "dinf_accumulation_from_angles":
            lambda: rt.dinf_accumulation_from_angles(dem),
        "dinf_accumulation": lambda: dinf.dinf_accumulation(fd, dem),
        "d8_accumulation_doubling":
            lambda: accum.d8_accumulation_doubling(fd),
        "rho8_flowdirs": lambda: rt.rho8_flowdirs(dem),
        "watersheds_from_flowdirs":
            lambda: rt.watersheds_from_flowdirs(fd),
        "upslope_cells": lambda: rt.upslope_cells(fd == 0, fd),
        "strahler_order": lambda: rt.strahler_order(fd),
        "fill_scan": lambda: fill.fill_depressions(dem, engine="scan"),
        "rdarray.tensor": lambda: rt.rdarray(dem).tensor(),
        "FillDepressions": lambda: rt.FillDepressions(dem).data,
        "FlowAccumulation": lambda: rt.FlowAccumulation(dem).data,
        "orlandini_flowdirs_device":
            lambda: orlandini.orlandini_flowdirs_device(dem),
        "PipelineConfig.run": lambda: rt.PipelineConfig().run(dem)["accum"],
        "cone_dem": lambda: tsynth.cone_dem(12, 14),
        "depression_dem": lambda: tsynth.depression_dem(12, 14),
        "perlin_dem_rows": lambda: tsynth.perlin_dem_rows(12, 14, 2, 5),
        "with_nodata_holes": lambda: tsynth.with_nodata_holes(dem),
        "neighbor_distances": lambda: stencil.neighbor_distances(),
        "fill_tile_consumer":
            lambda: consumer.fill_tile_consumer(dem)["w_loc"],
        "accum_tile_consumer": lambda: consumer.accum_tile_consumer(fd)[0],
        "out_of_core_fill": lambda: torch.from_numpy(np.load(
            outofcore.out_of_core_fill(_npy(dem)))).cuda(),
        "out_of_core_accum_d8": lambda: torch.from_numpy(np.load(
            outofcore.out_of_core_accum_d8(_npy(fd)))).cuda(),
        "sharded_pipeline": lambda: sharded.sharded_pipeline(dem)["accum"],
        "sharded_fill_twopass": lambda: sharded.sharded_fill_twopass(dem),
        "PipelineConfig.run(mesh)":
            lambda: rt.PipelineConfig(mesh=(1, 1)).run(dem)["filled"],
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name):
    """Given an array, or making data, an entry point asks for the card:
    without one, torch refuses; with one, the result lies on it."""
    call = _entry_points()[name]
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            call()
    else:
        assert call().is_cuda


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k.name)
def test_kernel_without_nvcc_raises(kernel, monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernel, "library", str(tmp_path / "missing.so"))
    monkeypatch.setattr(kernel, "_fn", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.function()
    assert kernel.launches == 0


def test_cpu_tensors_take_the_plain_version():
    """The kernels' wrappers never reach a kernel for a CPU tensor."""
    before = [k.launches for k in KERNELS]
    z = torch.rand(20, 24)
    m = torch.zeros(20, 24, dtype=torch.bool)
    f, _, _ = fill.fill_depressions_info(z, m)
    fill.fill_depressions_info(z, m, engine="scan")
    fd = flowdirs.d8_core(f, m)
    accum.d8_accumulation(fd)
    flats.resolve_flats(torch.round(z * 4) / 4, fd)
    terrain.terrain_attribute(z, "curvature")
    accum.dinf_accumulation_from_angles(flowdirs.dinf_flowdirs(f))
    accum.flow_accumulation_from_props(flowdirs.flow_proportions(f, "Quinn"))
    codes = flowdirs.rho8_core(f, m, 1.0, 3)
    rt.watersheds_from_flowdirs(codes)
    rt.upslope_cells(codes == 0, codes)
    rt.strahler_order(codes)
    after = [k.launches for k in KERNELS]
    assert after == before
