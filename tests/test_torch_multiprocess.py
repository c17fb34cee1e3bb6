"""The port's sharded mesh across processes: two gloo ranks on one box,
each owning 4 CPU positions of a 2×4 mesh (tools/torch_multiprocess_check.py,
the counterpart of tools/multiprocess_check.py), every rank's blocks
bitwise the single-process result."""

import os
import subprocess
import sys

import pytest


@pytest.mark.timeout(600)
def test_two_process_sharded_pipeline():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "tools", "torch_multiprocess_check.py")
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, timeout=580, cwd=root)
    assert "PASS" in out.stdout, out.stdout[-2000:] + out.stderr[-2000:]
