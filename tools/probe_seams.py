#!/usr/bin/env python3
"""How the port's column tiles change the rotation count of D∞ and Quinn
accumulation: the plain sweeps (the kernels' arithmetic, any tile width)
on the CPU, so only counts come out, never times.

    python3 tools/probe_seams.py [SIZE]

On a SIZE² Perlin DEM (seed 0, default 256) filled at ε = 1e-2 it runs
each accumulation to its fixpoint with one tile spanning the row, then 4
and 16 tiles a row, at depth 8 and 0 (the whole tile), and prints one JSON
line per run: metric, depth, tile width, rotations.  As in the kernels,
the row before is read at its new values across a tile edge and an
in-row window of up to ``FLOW_HALO`` columns runs on across it, so at
depth 8 the tile width changes nothing; at depth 0 the window stops at
the tile edge, closed with the neighbour column's sweep-start value.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch

    from richdem_tpu_torch import synth as tsynth
    from richdem_tpu_torch.ops import dinf, fill, flowdirs, mfd

    torch.set_num_threads(2)
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    z = tsynth.perlin_dem(size, size, seed=0, device="cpu")
    filled, _, _ = fill.fill_depressions_info(z, eps=1e-2)
    code, p = dinf.dinf_two_tap(flowdirs.dinf_flowdirs(filled))
    planes = flowdirs.flow_proportions(filled, "Quinn").permute(2, 0, 1)
    ones = torch.ones(size, size)
    for depth in (8, 0):
        for tile in (size, size // 4, size // 16):
            runs = {
                "dinf": lambda: dinf.dinf_accumulation_info(
                    code, p, ones, depth=depth,
                    sweep=lambda a, w, v, r, d: dinf.dinf_sweep_plain(
                        a, w, v, r, d, tile=tile)),
                "quinn": lambda: mfd.mfd_accumulation_info(
                    planes, ones, depth=depth,
                    sweep=lambda a, w, q, r, d: mfd.mfd_sweep_plain(
                        a, w, q, r, d, tile=tile))}
            for metric, run in runs.items():
                _, rotations, done = run()
                print(json.dumps({"metric": metric, "size": size,
                                  "depth": depth, "tile": tile,
                                  "rotations": rotations,
                                  "converged": done}), flush=True)


if __name__ == "__main__":
    main()
