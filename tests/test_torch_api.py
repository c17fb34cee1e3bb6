"""The port's pyrichdem-compatible surface ↔ the JAX package's: the API
(one case per test of tests/test_api.py), ``PipelineConfig``
(tests/test_config.py), the phase cache and ``resumable_pipeline``
(tests/test_checkpoint.py) and the CLI verbs (tests/test_cli.py).

Same seeded float32 DEMs through both packages; the port runs on the CPU
(tensors on the CPU, ``--device cpu``).  Tolerances: fills, D8 codes and
accumulation, flat resolution, labels, Strahler order, breaching and every
host verb are bitwise; ε-fills are held to atol 1e-4 (the JAX CPU fill's
associative scan regroups ε sums); multi-flow accumulation to rtol 2e-5
(sums grouped in sweep order); D∞ accumulation to rtol 5e-3 and TWI/SPI
through it to 5e-3 (the reference's own gap: its CPU path accumulates
unsnapped proportions, its TPU path and the port snap the two-tap split to
2⁻¹⁷; tests/test_torch_config4.py); slope to rtol 1e-5.
"""

import json
import os

import numpy as np
import pytest
import torch

import richdem_tpu as jrd
from richdem_tpu import oracle, synth
from richdem_tpu.checkpoint import PhaseCache as JaxPhaseCache
from richdem_tpu.checkpoint import fingerprint_of as jax_fingerprint_of
from richdem_tpu.cli import main as jax_main
from richdem_tpu.config import PipelineConfig as JaxConfig
from richdem_tpu.io import load_npz as jax_load_npz
from richdem_tpu.io import save_npz as jax_save_npz
from richdem_tpu.pipeline import resumable_pipeline as jax_resumable
import richdem_tpu_torch as rt
from richdem_tpu_torch.checkpoint import PhaseCache, fingerprint_of
from richdem_tpu_torch.cli import main
from richdem_tpu_torch.config import PipelineConfig
from richdem_tpu_torch.io import load_npz, save_npz
from richdem_tpu_torch.pipeline import resumable_pipeline

torch.set_num_threads(1)

ND = -9999.0
GT = (500000.0, 30.0, 0.0, 4100000.0, 0.0, -30.0)
FLOW_RTOL = 2e-5
DINF_RTOL = 5e-3


def _pair(dem, no_data=ND, geotransform=GT):
    """The same raster as a JAX-package ``rdarray`` and as the port's,
    holding a CPU tensor (so the port computes on the CPU)."""
    return (jrd.rdarray(dem.copy(), no_data=no_data,
                        geotransform=geotransform),
            rt.rdarray(torch.from_numpy(dem.copy()), no_data=no_data,
                       geotransform=geotransform))


@pytest.fixture(scope="module")
def dems():
    dem = synth.with_nodata_holes(
        synth.depression_dem(48, seed=3, dtype=np.float32), no_data=ND,
        seed=3)
    j, t = _pair(dem)
    return {"dem": dem, "jax": j, "port": t,
            "jfill": jrd.FillDepressions(j, epsilon=True),
            "tfill": rt.FillDepressions(t, epsilon=True)}


def _calls(rd):
    """The call column of each PROCESSING_HISTORY line."""
    return [line.split(" | ")[-1]
            for line in rd.metadata["PROCESSING_HISTORY"].splitlines()]


# -- API (tests/test_api.py) ---------------------------------------------

def test_fill_depressions_matches_jax(dems):
    want = jrd.FillDepressions(dems["jax"])
    got = rt.FillDepressions(dems["port"])
    np.testing.assert_array_equal(got.np(), want.np())
    np.testing.assert_allclose(
        got.np(), oracle.priority_flood_fill(dems["dem"], no_data=ND),
        atol=1e-4)
    assert _calls(got) == _calls(want) == [
        "FillDepressions(dem, epsilon=False, topology='D8')"]
    assert got.geotransform == GT and got.data.device.type == "cpu"


def test_fill_epsilon_true_strictly_drains(dems):
    z = dems["tfill"].np()
    np.testing.assert_allclose(z, dems["jfill"].np(), rtol=0, atol=1e-4)
    h, w = z.shape
    inner = z[1:-1, 1:-1]
    lower = np.zeros((h - 2, w - 2), bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                lower |= z[1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx] < inner
    assert lower[inner != ND].all()


def test_fill_in_place(dems):
    j, t = _pair(dems["dem"])
    ret, jret = rt.FillDepressions(t, in_place=True), jrd.FillDepressions(
        j, in_place=True)
    assert ret is t and jret is j
    np.testing.assert_array_equal(t.np(), j.np())
    assert (t.np() >= dems["dem"]).all()


def test_fill_d4_topology():
    dem = synth.depression_dem(32, seed=7, dtype=np.float32) + 1.0
    j, t = _pair(dem, no_data=None)
    d4 = rt.FillDepressions(t, topology="D4").np()
    np.testing.assert_array_equal(
        d4, jrd.FillDepressions(j, topology="D4").np())
    assert (d4 >= rt.FillDepressions(t).np()).all()
    with pytest.raises(ValueError):
        rt.FillDepressions(t, topology="D16")


def test_flow_accumulation_methods(dems):
    for method in ("D8", "Dinf", "Quinn", "Freeman"):
        acc = rt.FlowAccumulation(dems["tfill"], method=method)
        want = jrd.FlowAccumulation(dems["jfill"], method=method).np()
        if method == "D8":
            np.testing.assert_array_equal(acc.np(), want)
        else:
            np.testing.assert_allclose(
                acc.np(), want,
                rtol=DINF_RTOL if method == "Dinf" else FLOW_RTOL)
        assert acc.np()[acc.np() >= 0].max() > 100
        assert acc.no_data == -1.0
    with pytest.raises(ValueError):
        rt.FlowAccumulation(dems["tfill"], method="D9")


def test_flow_accumulation_matches_oracle(dems):
    filled = dems["tfill"]
    acc = rt.FlowAccumulation(filled, method="Dinf").np()
    props = oracle.flow_proportions(filled.np(), method="Dinf", no_data=ND)
    want = oracle.flow_accumulation_from_props(
        props, no_data_mask=filled.nodata_mask())
    sel = ~filled.nodata_mask()
    np.testing.assert_allclose(acc[sel], want[sel], rtol=DINF_RTOL)


def test_flow_proportions_shape(dems):
    props = rt.FlowProportions(dems["port"], method="Quinn")
    assert isinstance(props, rt.rd3array)
    assert props.shape == dems["dem"].shape + (8,)
    np.testing.assert_allclose(
        props.np(), jrd.FlowProportions(dems["jax"], method="Quinn").np(),
        rtol=0, atol=1e-7)
    sums = props.np().sum(axis=-1)
    assert ((np.isclose(sums, 1)) | (np.isclose(sums, 0))).all()


def test_flow_accum_from_props(dems):
    props = rt.FlowProportions(dems["tfill"], method="D8")
    acc = rt.FlowAccumFromProps(props)
    sel = ~dems["tfill"].nodata_mask()
    np.testing.assert_array_equal(
        acc.np()[sel],
        rt.FlowAccumulation(dems["tfill"], method="D8").np()[sel])
    want = jrd.FlowAccumFromProps(
        jrd.FlowProportions(dems["jfill"], method="D8")).np()
    np.testing.assert_allclose(acc.np()[sel], want[sel], rtol=1e-6)


def test_terrain_attribute(dems):
    out = rt.TerrainAttribute(dems["port"], attrib="slope_riserun",
                              zscale=2.0)
    want = jrd.TerrainAttribute(dems["jax"], attrib="slope_riserun",
                                zscale=2.0)
    np.testing.assert_allclose(out.np(), want.np(), rtol=1e-5, atol=1e-7)
    assert out.no_data == want.no_data == -9999.0
    assert (out.np()[dems["dem"] == ND] == -9999.0).all()


def test_resolve_flats_drains_plateau():
    dem = synth.plateau_dem(32, dtype=np.float32)
    j, t = _pair(dem, no_data=None)
    resolved = rt.ResolveFlats(t)
    np.testing.assert_array_equal(resolved.np(), jrd.ResolveFlats(j).np())
    fd = rt.FlowDirections(resolved, method="D8").np()
    assert (fd[1:-1, 1:-1] == 0).sum() == 0


def test_breach_depressions(dems):
    out = rt.BreachDepressions(dems["port"], eps=1e-6)
    np.testing.assert_array_equal(
        out.np(), jrd.BreachDepressions(dems["jax"], eps=1e-6).np())
    sel = dems["dem"] != ND
    assert (out.np()[sel] <= dems["dem"][sel]).all()
    assert isinstance(out.data, np.ndarray)  # a host op, as in the reference


def test_watersheds_and_strahler():
    filled = oracle.priority_flood_epsilon(
        synth.perlin_dem(40, seed=4, dtype=np.float32), eps=1e-3)
    j, t = _pair(filled.astype(np.float32), no_data=None)
    np.testing.assert_array_equal(rt.WatershedLabels(t).np(),
                                  jrd.WatershedLabels(j).np())
    order = rt.StrahlerOrder(rt.FlowDirections(t, method="D8")).np()
    np.testing.assert_array_equal(
        order, jrd.StrahlerOrder(jrd.FlowDirections(j, method="D8")).np())
    assert order.min() >= 1 and order.max() >= 2


def test_upslope_cells():
    z = np.arange(6, dtype=np.float32)[None, :].repeat(3, axis=0)
    j, t = _pair(z, no_data=None)
    seeds = np.zeros((3, 6), bool)
    seeds[1, 2] = True
    up = rt.UpslopeCells(seeds, rt.FlowDirections(t, method="D8")).np()
    np.testing.assert_array_equal(
        up, jrd.UpslopeCells(seeds, jrd.FlowDirections(j, method="D8")).np())
    assert up[1, 2] and up[1, 3] and not up[1, 1]


def test_twi_spi(dems):
    acc = rt.FlowAccumulation(dems["tfill"], method="Dinf")
    slope = rt.TerrainAttribute(dems["tfill"], attrib="slope_radians")
    jacc = jrd.FlowAccumulation(dems["jfill"], method="Dinf")
    jslope = jrd.TerrainAttribute(dems["jfill"], attrib="slope_radians")
    sel = dems["dem"] != ND
    wet = rt.TWI(acc, slope.np()).np()
    power = rt.SPI(acc, slope.np()).np()
    np.testing.assert_allclose(wet[sel], jrd.TWI(jacc, jslope.np()).np()[sel],
                               rtol=0, atol=DINF_RTOL)
    np.testing.assert_allclose(power[sel],
                               jrd.SPI(jacc, jslope.np()).np()[sel],
                               rtol=DINF_RTOL, atol=1e-6)
    assert np.isfinite(wet[sel]).all() and (power[sel] >= 0).all()


def test_rd_compare(dems):
    t = dems["port"]
    assert rt.rdCompare(t, t.copy())
    other = t.copy()
    other.np()[10, 10] += 1.0
    for compare in (rt.rdCompare, jrd.rdCompare):
        assert not compare(t, other, verbose=False)
        assert compare(t, other, atol=2.0, verbose=False)


def test_processing_history_accumulates(dems):
    a = rt.FillDepressions(dems["port"])
    b = rt.FlowAccumulation(a, method="D8")
    want = jrd.FlowAccumulation(jrd.FillDepressions(dems["jax"]),
                                method="D8")
    assert _calls(b) == _calls(want)
    assert b.metadata["PROCESSING_HISTORY"].splitlines()[0].split(
        " | ")[1] == want.metadata["PROCESSING_HISTORY"].splitlines()[
            0].split(" | ")[1]


def test_rho8_accumulation_conserves_mass(dems):
    """Rho8 keys the port's Philox stream, not JAX's: held to the port's
    own codes and to exact mass conservation instead."""
    acc = rt.FlowAccumulation(dems["tfill"], method="Rho8", seed=2).np()
    fd = rt.FlowDirections(dems["tfill"], method="Rho8", seed=2).np()
    sel = dems["dem"] != ND
    assert acc[(fd == 0) & sel].sum() == sel.sum()
    assert rt.FlowDirections(dems["tfill"], method="Rho8", seed=2).no_data \
        == -1.0


def test_rdarray_device_rules():
    """A tensor payload stays where it is; an array payload goes to the
    card unless another device is asked for; ``.np()`` copies to the
    host."""
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    rd = rt.rdarray(arr)
    assert rd.tensor("cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            rd.tensor()
        with pytest.raises((RuntimeError, AssertionError)):
            rt.FillDepressions(arr)
    t = torch.from_numpy(arr)
    assert rt.rdarray(t).tensor() is t
    assert rt.rdarray(t).shape == (3, 4)
    np.testing.assert_array_equal(np.asarray(rt.rdarray(t)), arr)


def test_rdshow_quicklook(dems):
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    import inspect
    assert list(inspect.signature(rt.rdShow).parameters)[-1] == "log"
    out = rt.rdShow(rt.FlowAccumulation(dems["tfill"]), show=False,
                    log=True)
    assert out["vmin"] >= 1 and out["vmax"] > 100


# -- PipelineConfig (tests/test_config.py) --------------------------------

def test_config_frozen_and_roundtrip():
    import dataclasses
    kw = dict(eps=1e-3, metric="Quinn", exponent=1.0, mesh=(2, 4))
    cfg = PipelineConfig(**kw)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.eps = 0.0
    assert cfg.to_json() == JaxConfig(**kw).to_json()
    back = PipelineConfig.from_json(JaxConfig(**kw).to_json())
    assert back == cfg and hash(back) == hash(cfg)


def test_config_run_d8(tmp_path):
    dem = synth.depression_dem(48, seed=7, dtype=np.float32)
    cfg = dict(eps=0.0, with_twi=True)
    out = PipelineConfig(cache_dir=str(tmp_path / "t"), **cfg).run(
        dem, device="cpu")
    want = JaxConfig(cache_dir=str(tmp_path / "j"), **cfg).run(dem)
    for key in ("filled", "flowdirs", "accum"):
        np.testing.assert_array_equal(out[key], np.asarray(want[key]))
    np.testing.assert_allclose(out["twi"], np.asarray(want["twi"]),
                               rtol=1e-5, atol=1e-5)
    assert out["accum"][out["flowdirs"] == 0].sum() == dem.size
    plain = PipelineConfig(**cfg).run(dem, device="cpu")
    np.testing.assert_array_equal(plain["accum"].numpy(), out["accum"])


def test_config_run_mfd():
    dem = synth.depression_dem(48, seed=7, dtype=np.float32)
    out = PipelineConfig(eps=1e-3, metric="Quinn").run(dem, device="cpu")
    want = JaxConfig(eps=1e-3, metric="Quinn").run(dem)
    np.testing.assert_allclose(out["filled"], want["filled"], atol=1e-4)
    np.testing.assert_allclose(out["accum"], want["accum"], rtol=FLOW_RTOL)
    assert out["accum"].sum() > 0


def test_config_mesh_runs_the_sharded_pipeline():
    """``mesh=(2, 4)`` runs the sharded pipeline: on the CPU over 8
    positions of the CPU, against the reference's over the conftest's 8
    devices; a JSON config of the reference runs unchanged.  The four keys
    bitwise, slope to rtol 1e-6 (the port's sqrt against the reference's
    hypot, through atan)."""
    dem = synth.with_nodata_holes(
        synth.depression_dem(40, 48, seed=7, dtype=np.float32), no_data=ND,
        seed=3, n_holes=2)
    want = JaxConfig(mesh=(2, 4)).run(dem, no_data=ND)
    cfg = PipelineConfig.from_json(JaxConfig(mesh=(2, 4)).to_json())
    assert cfg.mesh == (2, 4)
    out = cfg.run(dem, no_data=ND, device="cpu")
    assert set(out) == set(want) == {"filled", "flowdirs", "accum", "slope"}
    for key in ("filled", "flowdirs", "accum"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(want[key]))
    np.testing.assert_allclose(out["slope"].numpy(), np.asarray(want["slope"]),
                               rtol=1e-6, atol=0)


# -- checkpoint (tests/test_checkpoint.py) --------------------------------

def test_phase_cache_roundtrip_across_packages(tmp_path):
    a = np.arange(12.0).reshape(3, 4)
    c = PhaseCache(str(tmp_path), "g1")
    assert not c.has("fill")
    c.save("fill", a)
    c.save("fill", a * 2, shard=3)
    j = JaxPhaseCache(str(tmp_path), "g1")
    assert j.has("fill") and j.has("fill", shard=3)
    np.testing.assert_array_equal(j.load("fill"), a)
    np.testing.assert_array_equal(j.load("fill", shard=3), a * 2)
    j.save("flow", a + 1)
    np.testing.assert_array_equal(c.load("flow"), a + 1)


def test_run_skips_completed_phase(tmp_path):
    calls = []

    def compute():
        calls.append(1)
        return np.ones((2, 2))

    PhaseCache(str(tmp_path), "g2").run("p", compute)
    PhaseCache(str(tmp_path), "g2").run("p", compute)
    JaxPhaseCache(str(tmp_path), "g2").run("p", compute)
    assert len(calls) == 1


def test_fingerprint_invalidates_stale_entries(tmp_path):
    a, b = np.ones((4, 4)), np.zeros((4, 4))
    for parts in (("eps=1", a), ("eps=2", a), ("x", b.astype(np.float32))):
        assert fingerprint_of(*parts) == jax_fingerprint_of(*parts)
    c1 = PhaseCache(str(tmp_path), "g", fingerprint=fingerprint_of("eps=1", a))
    c1.save("fill", a)
    c2 = PhaseCache(str(tmp_path), "g", fingerprint=fingerprint_of("eps=2", a))
    assert c1.has("fill") and not c2.has("fill")
    np.testing.assert_array_equal(c2.run("fill", lambda: b), b)
    assert c2.has("fill") and not c1.has("fill")


def test_resumable_pipeline_invalidates_on_changed_dem(tmp_path):
    dem1 = synth.depression_dem(48, seed=7, dtype=np.float32)
    dem2 = synth.depression_dem(48, seed=8, dtype=np.float32)
    out1 = resumable_pipeline(dem1, str(tmp_path), grid_id="t", eps=0.0,
                              device="cpu")
    out2 = resumable_pipeline(dem2, str(tmp_path), grid_id="t", eps=0.0,
                              device="cpu")
    assert not np.array_equal(out1["filled"], out2["filled"])
    want = jax_resumable(dem2, str(tmp_path / "j"), grid_id="t", eps=0.0)
    for key in ("filled", "flowdirs", "accum"):
        np.testing.assert_array_equal(out2[key], np.asarray(want[key]))
    assert out2["accum"][out2["flowdirs"] == 0].sum() == dem2.size


def test_resumable_pipeline_resumes(tmp_path):
    dem = synth.depression_dem(48, seed=7, dtype=np.float32)
    out1 = resumable_pipeline(dem, str(tmp_path), grid_id="t", eps=0.0,
                              device="cpu")
    os.remove(os.path.join(str(tmp_path), "t", "accum.npy"))
    out2 = resumable_pipeline(dem, str(tmp_path), grid_id="t", eps=0.0,
                              device="cpu")
    for key in ("filled", "flowdirs", "accum", "twi"):
        np.testing.assert_array_equal(out1[key], out2[key])
    assert out2["accum"][out2["flowdirs"] == 0].sum() == dem.size


# -- CLI (tests/test_cli.py) ----------------------------------------------

@pytest.fixture()
def dem_path(tmp_path):
    dem = synth.depression_dem(32, seed=3, dtype=np.float32)
    p = tmp_path / "dem.npz"
    save_npz(p, rt.rdarray(dem, no_data=ND))
    return p


def _both(tmp_path, verb, *args, out="out.npz", inputs=()):
    """Run one verb through each package (the port on the CPU); returns
    the two output rasters."""
    mine, theirs = tmp_path / f"t_{out}", tmp_path / f"j_{out}"
    main(["--device", "cpu", verb, *map(str, inputs), str(mine), *args])
    jax_main([verb, *map(str, inputs), str(theirs), *args])
    return load_npz(mine), jax_load_npz(theirs)


def test_fill_verb(tmp_path, dem_path):
    got, want = _both(tmp_path, "fill-depressions", "--epsilon",
                      inputs=[dem_path])
    np.testing.assert_allclose(got.np(), want.np(), rtol=0, atol=1e-4)
    assert (got.np() >= load_npz(dem_path).np()).all()
    assert _calls(got) == _calls(want)


def test_pipeline_verbs(tmp_path, dem_path):
    filled, jfilled = _both(tmp_path, "fill-depressions", inputs=[dem_path],
                            out="filled.npz")
    np.testing.assert_array_equal(filled.np(), jfilled.np())
    src = tmp_path / "t_filled.npz"
    for verb, args, exact in (
            ("flowdirs", ["--resolve-flats"], True),
            ("flow-accumulation", ["--method", "D8"], True),
            ("terrain-attribute", ["--attrib", "slope_degrees"], False)):
        got, want = _both(tmp_path, verb, *args, inputs=[src])
        if exact:
            np.testing.assert_array_equal(got.np(), want.np())
        else:
            np.testing.assert_allclose(got.np(), want.np(), rtol=1e-5)
    assert got.np().max() >= 0


def test_twi_verb(tmp_path, dem_path):
    got, want = _both(tmp_path, "twi", inputs=[dem_path])
    np.testing.assert_allclose(got.np(), want.np(), rtol=0, atol=DINF_RTOL)
    assert np.isfinite(got.np()).any()


def test_info_verb(capsys, dem_path):
    main(["info", str(dem_path)])
    mine = json.loads(capsys.readouterr().out)
    jax_main(["info", str(dem_path)])
    assert mine == json.loads(capsys.readouterr().out)
    assert mine["shape"] == [32, 32] and mine["no_data"] == ND


def test_hist_verb(capsys, dem_path):
    main(["hist", str(dem_path), "--bins", "5"])
    mine = capsys.readouterr().out
    jax_main(["hist", str(dem_path), "--bins", "5"])
    assert mine == capsys.readouterr().out
    assert len(mine.strip().splitlines()) == 5


def test_compare_verb(tmp_path, dem_path, capsys):
    other = tmp_path / "copy.npz"
    main(["convert", str(dem_path), str(other)])
    for run in (main, jax_main):
        with pytest.raises(SystemExit) as exc:
            run(["compare", str(dem_path), str(other)])
        assert exc.value.code == 0
    assert "EQUAL" in capsys.readouterr().out
    r = load_npz(other)
    arr = r.np().copy()
    arr[5, 5] += 10
    save_npz(other, r.like(arr))
    for run in (main, jax_main):
        with pytest.raises(SystemExit) as exc:
            run(["compare", str(dem_path), str(other)])
        assert exc.value.code == 1


def test_synth_and_convert(tmp_path):
    for kind in ("cone", "perlin", "depressions"):
        got, want = _both(tmp_path, "synth", "--size", "40", "--seed", "2",
                          out=f"{kind}.npz", inputs=[kind])
        np.testing.assert_array_equal(got.np(), want.np())
    cone = tmp_path / "t_cone.npz"
    main(["convert", str(cone), str(tmp_path / "c.tif")])
    back = jrd.LoadGDAL(str(tmp_path / "c.tif"))
    np.testing.assert_array_equal(back.np(), load_npz(cone).np())
    assert back.shape == (40, 40)


def test_convert_compressed_tif(tmp_path):
    from richdem_tpu.io import load_geotiff as jax_load_geotiff
    cone = tmp_path / "cone.npz"
    tif = tmp_path / "cone_lzw.tif"
    main(["synth", "cone", str(cone), "--size", "64"])
    main(["convert", str(cone), str(tif), "--compress", "lzw",
          "--predictor", "3"])
    np.testing.assert_array_equal(jax_load_geotiff(tif).np(),
                                  load_npz(cone).np())


def test_expand_dimensions_verb(tmp_path, dem_path):
    got, want = _both(tmp_path, "expand-dimensions", "--height", "48",
                      "--width", "40", "--y0", "8", "--x0", "4",
                      inputs=[dem_path])
    np.testing.assert_array_equal(got.np(), want.np())
    assert got.shape == (48, 40) and got.no_data == ND
    np.testing.assert_array_equal(got.np()[8:40, 4:36],
                                  load_npz(dem_path).np())


def test_merge_verb(tmp_path):
    from richdem_tpu.parallel.layout import split_to_layout
    dem = jrd.rdarray(synth.perlin_dem(32, seed=4, dtype=np.float32))
    layout = split_to_layout(dem, str(tmp_path / "tiles"), (16, 16))
    got, want = _both(tmp_path, "merge", inputs=[layout])
    np.testing.assert_array_equal(got.np(), want.np())
    np.testing.assert_array_equal(got.np(), dem.np())


def test_no_data_and_geotransform_verbs(tmp_path, dem_path, capsys):
    outs = []
    for run in (main, jax_main):
        run(["no-data", str(dem_path)])
        outs.append(capsys.readouterr().out)
        run(["geotransform", str(dem_path)])
        outs.append(capsys.readouterr().out)
    assert outs[:2] == outs[2:]
    assert outs[0].strip().startswith("-9999")
    out = tmp_path / "nd.npz"
    main(["no-data", str(dem_path), "--set", "-1", "--output", str(out)])
    assert jax_load_npz(out).no_data == -1.0


def test_taudem_convert(tmp_path):
    fd = np.array([[1, 5, 0], [3, 7, -1]], np.int8)  # TauDEM codes
    src = tmp_path / "fd.npz"
    save_npz(src, rt.rdarray(fd))
    got, want = _both(tmp_path, "taudem-convert", inputs=[src])
    np.testing.assert_array_equal(got.np(), want.np())
    np.testing.assert_array_equal(
        got.np(), np.array([[5, 1, 0], [3, 7, -1]], np.int8))
    back = tmp_path / "back.npz"
    main(["taudem-convert", str(tmp_path / "t_out.npz"), str(back),
          "--reverse"])
    np.testing.assert_array_equal(load_npz(back).np(), fd)


def test_pipeline_verb(tmp_path):
    dem = synth.depression_dem(48, seed=7, dtype=np.float32)
    src = tmp_path / "dem.npz"
    jax_save_npz(src, jrd.rdarray(dem))
    main(["--device", "cpu", "pipeline", str(src), str(tmp_path / "t"),
          "--twi", "--cache-dir", str(tmp_path / "tc")])
    jax_main(["pipeline", str(src), str(tmp_path / "j"), "--twi",
              "--cache-dir", str(tmp_path / "jc")])
    for key in ("filled", "flowdirs", "accum"):
        got = load_npz(tmp_path / f"t.{key}.npz").np()
        np.testing.assert_allclose(
            got, jax_load_npz(tmp_path / f"j.{key}.npz").np(), rtol=0,
            atol=1e-4 if key == "filled" else 0)
    acc = load_npz(tmp_path / "t.accum.npz").np()
    fd = load_npz(tmp_path / "t.flowdirs.npz").np()
    assert acc[fd == 0].sum() == dem.size


def test_device_flag(tmp_path, dem_path):
    """``--device`` defaults to the card: without one, a verb that
    computes refuses; host verbs never ask for it."""
    from richdem_tpu_torch.cli import build_parser
    assert build_parser().parse_args(["info", "x"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            main(["fill-depressions", str(dem_path),
                  str(tmp_path / "f.npz")])
    main(["info", str(dem_path)])
