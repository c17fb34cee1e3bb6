"""Execute every ``python`` code block in docs/EXAMPLES_TORCH.md on the
CPU.

As tests/test_examples_doc.py does for the JAX package's recipes: small
synthetic fixtures under the doc's file names in a tmp cwd, the one
literal tile size scaled down, and every block executed verbatim in one
namespace (the doc reads top to bottom as a session).  The doc already
asks for ``DEVICE = "cpu"``.  matplotlib draws the quicklook; without it
the test skips.
"""

import os
import pathlib
import re

import numpy as np
import pytest
import torch

DOC = (pathlib.Path(__file__).resolve().parents[1] / "docs"
       / "EXAMPLES_TORCH.md")

#: recipe scale → test scale; file names stay as written
SUBS = [("tile=4096", "tile=64")]

torch.set_num_threads(1)


def _blocks():
    return re.findall(r"```python\n(.*?)```", DOC.read_text(), re.S)


def test_examples_torch_md_executes(tmp_path, monkeypatch):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")  # rdShow block: headless no-op show()
    monkeypatch.chdir(tmp_path)

    import richdem_tpu_torch as rt
    from richdem_tpu_torch import synth_np
    from richdem_tpu_torch.oracle import fill as ofill
    from richdem_tpu_torch.oracle import flowdirs as oflow

    dem_np = synth_np.depression_dem(96, seed=5, dtype=np.float64)
    rt.SaveGDAL("srtm_tile.tif", rt.rdarray(dem_np, no_data=-9999.0))
    big = synth_np.depression_dem(160, seed=7, dtype=np.float64)
    rt.SaveGDAL("huge_dem.tif", rt.rdarray(big, no_data=-9999.0))
    fd_big = oflow.d8_flowdirs(ofill.priority_flood_epsilon(big, eps=1e-3))
    np.save("huge_fd.npy", fd_big.astype(np.int8))

    blocks = _blocks()
    assert len(blocks) >= 8, "EXAMPLES_TORCH.md lost code blocks"
    assert 'DEVICE = "cpu"' in blocks[0]
    ns = {}
    for i, block in enumerate(blocks):
        src = block
        for old, new in SUBS:
            src = src.replace(old, new)
        if "rdCompare(a, b" in src:  # utility recipe: any two rasters
            ns.setdefault("a", ns["filled"])
            ns.setdefault("b", ns["filled"])
        exec(compile(src, f"EXAMPLES_TORCH.md#block{i + 1}", "exec"), ns)

    assert os.path.exists("accum.tif")
    assert os.path.exists(ns["filled_path"])
    assert os.path.exists(ns["acc_path"])
    assert os.path.exists(os.path.join("prof", "trace.json"))
    assert ns["acc"].shape[:2] == (96, 96)
    assert np.nanmax(ns["twi"].np()) > 0
    assert int(ns["order"].np().max()) >= 1
    assert "fill:" in ns["timer"].summary()
    filled = np.load(ns["filled_path"])
    want = ofill.priority_flood_fill(big, dtype=np.float64)
    np.testing.assert_allclose(filled, want, rtol=0, atol=1e-4)
    import matplotlib.pyplot as plt
    plt.close("all")
