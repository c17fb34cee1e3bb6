"""Two-process check of the port's sharded mesh across processes: the
multi-process path (a ``torch.distributed`` group and a mesh spanning its
ranks) exercised on one box with CPU positions, the way the reference's
``tools/multiprocess_check.py`` runs two JAX processes and the reference
tests its MPI programs with ``mpirun -n 2`` on one machine.

Run:  python tools/torch_multiprocess_check.py            (spawns 2 workers)
      python tools/torch_multiprocess_check.py worker <i> <port> (internal)

Two gloo ranks on localhost, each owning 4 CPU positions of a 2×4 mesh:
``sharded_pipeline(eps=1e-3)`` of a 64² ``depression_dem(seed=7)``, then
the two-pass fill and D8 accumulation with ``exchange=multihost_exchange``.
Each rank checks its own blocks against the single-process result (the
port's single-device ops), bitwise, and prints one line per check; the
parent prints ``PASS`` when every rank passed every check.
"""

import os
import socket
import subprocess
import sys

NPROC = 2
LOCAL_POSITIONS = 4
GRID = 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(idx: int, port: int) -> None:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=idx, world_size=NPROC)
    from richdem_tpu_torch import convert, synth_np
    from richdem_tpu_torch.ops.accum import d8_accumulation
    from richdem_tpu_torch.ops.fill import fill_depressions
    from richdem_tpu_torch.ops.flowdirs import d8_flowdirs
    from richdem_tpu_torch.ops.terrain import terrain_attribute
    from richdem_tpu_torch.parallel import (make_mesh, sharded_pipeline,
                                            sharded_accumulation_d8_twopass,
                                            sharded_fill_twopass)
    from richdem_tpu_torch.parallel.twopass import multihost_exchange

    mesh = make_mesh([torch.device("cpu")] * LOCAL_POSITIONS,
                     (NPROC, LOCAL_POSITIONS))
    dem = synth_np.depression_dem(GRID, seed=7)

    def mine(out, want):
        """Every block this rank holds equals the single-process raster."""
        return all(np.array_equal(block, want[index])
                   for index, block in out)

    out = convert.to_numpy(sharded_pipeline(dem, mesh=mesh, eps=1e-3))
    filled = fill_depressions(dem, eps=1e-3, device="cpu")
    fd = d8_flowdirs(filled)
    want = convert.to_numpy({
        "filled": filled, "flowdirs": fd, "accum": d8_accumulation(fd),
        "slope": terrain_attribute(filled, "slope_radians")})
    n_blocks = len(out["filled"])
    ok = n_blocks == LOCAL_POSITIONS and all(mine(out[k], want[k])
                                             for k in want)
    print(f"PIPELINE_RESULT ok={ok} p={idx} blocks={n_blocks}", flush=True)

    two = sharded_fill_twopass(dem, mesh=mesh, exchange=multihost_exchange)
    plain = fill_depressions(dem, device="cpu").numpy()
    two = convert.to_numpy({"filled": two})["filled"]
    ok_fill = len(two) == LOCAL_POSITIONS and mine(two, plain)
    print(f"TWOPASS_FILL_RESULT ok={ok_fill} p={idx}", flush=True)

    acc2 = sharded_accumulation_d8_twopass(fd.numpy(), mesh=mesh,
                                           exchange=multihost_exchange)
    acc2 = convert.to_numpy({"accum": acc2})["accum"]
    ok_acc = len(acc2) == LOCAL_POSITIONS and mine(acc2, want["accum"])
    print(f"TWOPASS_ACCUM_RESULT ok={ok_acc} p={idx}", flush=True)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]))
        return 0
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(i),
         str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT) for i in range(NPROC)]
    counts = {"PIPELINE_RESULT": 0, "TWOPASS_FILL_RESULT": 0,
              "TWOPASS_ACCUM_RESULT": 0}
    for p in procs:
        try:
            out, _ = p.communicate(timeout=560)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        for key in counts:
            counts[key] += out.count(f"{key} ok=True")
        if p.returncode != 0:
            print(out[-3000:])
    ok = all(n == NPROC for n in counts.values())
    print(", ".join(f"{k} {n}/{NPROC}" for k, n in counts.items()))
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
