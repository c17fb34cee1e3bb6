#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card, ``nvcc`` and
``g++``:

    python3 chip_smoke.py

Phases, one line each (any failure raises: non-zero exit, no final line):

1. device — the card's ``name, power.limit`` from nvidia-smi;
2. build — compiles the eleven kernel sources from
   ``richdem_tpu_torch/csrc`` (fourteen kernels: the multi-flow and D8
   accumulation sweeps' libraries also hold their topological passes, the
   resolve sweep's the successor jump) and the port's native engine,
   all at once (or loads them when the libraries
   are newer than the sources), and reads each kernel's registers and
   spills from ``ptxas``'s report and the launch shapes of the scan
   sweep, the walk's sweeps and the stencil kernels' tile;
3. kernel vs plain — each kernel against its plain PyTorch version on the
   card, on a ragged 1000×1100 Perlin DEM with nodata holes (the distance
   sweep in every mode, the terrain kernel for all 8 attributes, the D∞ and
   multi-flow sweeps at depths 1, 8 and 0, down and transposed up (at 1
   and 8 against the plain sweep over whole rows: the kernels' tile seams
   are exact), the multi-flow topological pass with unit and float
   weights (bitwise, and the same bits on a second call), the D8
   accumulation sweeps' fixpoint and the topological pass over the same
   codes (bitwise its plain version twice, and the fixpoint at unit
   weights), Rho8
   and Rho4 codes for three seeds, the resolve and Strahler sweeps down and
   transposed up and their fixpoints, the successor jump's labels and
   upslope masks (bitwise its plain version, the same bits on a second
   call, and the resolve sweeps' fixpoint); the distance, resolve and Strahler
   sweeps against the plain sweeps over whole rows); Rho8's diagonal share
   on 256² planes at θ = 10° and 30° within 0.015 of θ/45; the scan fill
   sweep
   down and up at ε = 0, ε = 1e-3 and D4 (``eps_diag = BIG/2``), also on a
   48×8300 raster (a cluster of 16 CTAs), and its fixpoint
   against the folded engine's and the native float64 fill (bitwise at
   ε = 0; at ε = 1e-3 within ``ENGINES_ATOL`` and ``NATIVE_EPS_ATOL``);
4. native gates — fill bit-exact against the port's copy of the
   single-core C++ engine at 2048×2176 and 4096×4224 (multigrid warm
   start), with both fill engines, then D8 and flat resolution of those
   ε = 0 fills bitwise against the engine's, and the accumulation of
   their codes before and after flat resolution (the topological pass)
   exact below 2²⁴; accumulation exact at 2048×2176, D8 codes within 1e-5 of
   the cells (float32 slope ties); at 2048×2176 on ε = 1e-2 fills, D∞ and
   Quinn accumulation within rtol 2e-5 of the engine's topological queue
   over the same proportions, and D8 codes through the two-tap scan
   (``p = 1``, depth 0) bitwise; the walled serpentine pit at 2048² with
   ε = 2⁻¹⁰ through both fill engines (rotations of each; the scan engine
   within rtol 1e-6, atol 1e-4 of the folded one and atol 1e-2 of the
   native engine's float64 fill);
5. main path — ``make_pipeline((10240, 10240), eps=0, with_twi=True)`` on a
   device Perlin DEM: converged, mass-conserving, every kernel launched;
   three timed steps and the peak device memory;
6. flats at full size — ``resolve_flats`` of the main path's ε = 0 output
   (real flat lakes): converged, no interior NO_FLOW left, and the resolved
   codes' accumulation conserves mass exactly, the topological pass over
   them bitwise its plain version;
7. config 2 (``BASELINE.json``; ``bench.py``'s ``fill_flats``) at 10240²:
   ``auto_epsilon`` → ε-fill → D8 → ``resolve_flats``; converged, its
   kernels launched, the ε-fill (from the multigrid start) bitwise the
   fill from ``w0 = BIG``; three timed steps and the peak memory;
8. terrain path — ``terrain_attribute`` slope (radians) and aspect at
   10240², the terrain kernel launched;
9. config 4 (``BASELINE.json``; ``bench.py``'s ``dinf_twi`` and
   ``quinn_mfd``) at 10240²: ε = 1e-2 fill → D∞ angles → D∞ accumulation →
   slope → TWI, and ε = 1e-2 fill → Quinn proportions → multi-flow
   accumulation (one topological pass, ``csrc/flow_topo.cuh``, and no
   sweep); each converged, mass-conserving, its kernels launched;
   three timed steps, the peak memory, the accumulation's rotations and
   the depth;
10. d8_methods at 10240²: config 2's step, then watershed labels,
   Strahler order, D8 accumulation, and the upslope cells of the 64
   interior cells of largest accumulation; labels and upslope mask bitwise
   equal to pointer doubling, labels constant along every flow path,
   Strahler order satisfying its defining equation at every cell (and
   bitwise equal to the Jacobi fixpoint at 2048×2176); three timed steps,
   the peak memory, the rotations of each fixpoint, and which engine
   finished the watershed and upslope calls (on the card the successor
   jump, which runs no rotation);
11. rho8 at 10240²: ε-fill → ``rho8_flowdirs(seed=0)`` →
   ``d8_accumulation`` (pyrichdem's ``FlowAccumulation(method="Rho8")``);
   codes sound, mass conserved exactly (the native engine's float64
   accumulation of the codes); three timed steps and the peak memory;
12. api at 10240² — the pyrichdem names on an ``rdarray`` of numpy (Perlin
   seed 0 with nodata holes) under ``RICHDEM_TPU_FILL_ENGINE=scan``: the
   CLI ``twi`` verb's sequence (``FillDepressions(epsilon=True)``,
   ``FlowAccumulation("D8")``, ``TerrainAttribute("slope_radians")``,
   ``TWI``); mass conserved, history kept, the scan kernel launched; three
   timed steps, the peak memory and the rotations; then the ε = 0 fill at
   10240² and the D4 fill at 2048², each bitwise the folded engine's;
13. kernels at the paths' shapes — each kernel against its plain version at
   10240² (fill also at the 1280² multigrid coarse grid, fill,
   accumulation, distance, D∞, multi-flow, resolve and Strahler sweeps also
   transposed; the scan sweep down on the api DEM at its ε; the multi-flow
   topological pass on config 4's Quinn planes, also bitwise the path's
   own accumulation; the D8 topological pass on the main path's codes,
   also bitwise its own accumulation; the successor jump's labels and
   upslope mask on the
   d8_methods path's codes and gauges, also bitwise the path's own), then
   one call of each timed beside its bound (the jump's call: one of
   each walk), with each sweep's time per row step and
   each kernel's registers and spill bytes a thread from the build's
   ``-Xptxas -v`` report, the scan sweep's cluster and the tiles of the
   distance, resolve and Strahler sweeps; every terrain attribute, and
   Rho4 beside Rho8, timed beside its bound; pointer doubling's watershed
   labels timed on the d8_methods codes beside the resolve sweep (another
   engine, a reference point);
14. twopass — the [P1]/[P2] out-of-core programs on ``.npy`` rasters in a
   temporary directory: first the path's five kernels (fill, D8, distance
   sweep, the successor jump, the D8 topological pass) on one 2048² tile,
   each bitwise its plain version and timed beside its bound at that
   shape; then
   ``out_of_core_fill`` of the api path's DEM (10240² Perlin seed 0 with
   nodata holes; tile 2048, device consumer, tiles not cached) in exactly
   two data passes, bitwise the in-core fill, its wall time split by
   ``debug.PhaseTimer``; ``out_of_core_accum_d8`` of that fill's D8 codes
   in two passes, bitwise the in-core accumulation below 2²⁴ and within
   ``TWOPASS_ACC_RTOL`` above; the native C++ consumer bitwise the device
   consumer at 2048² (tile 512); the ε = 1e-3 Schwarz fill at 4096² (tile
   1024) bitwise the in-core folded ε-fill from ``w0 = BIG`` and the
   in-core ``fill_epsilon`` (which starts from the multigrid upper bound
   at this size); and the card's peak at 10240² within 10 % of the peak
   at 4096² (tile 2048, not cached);
15. sharded — the sharded mesh on the one card, a 2×2 mesh whose four
   positions are all ``cuda:0``: ``sharded_pipeline`` (ε = 1e-3) of the
   10240² Perlin DEM, its fill bitwise the in-core fill from ``w0 = BIG``
   and ``fill_epsilon``, codes and slope bitwise, the accumulation bitwise
   below 2²⁴ and within ``TWOPASS_ACC_RTOL`` above; its outer Schwarz
   iterations, launches, three timed steps beside the main path's and the
   peak; the two-pass fill and accumulation on the mesh (two data passes
   each, bitwise the Schwarz fill at ε = 0 and the Schwarz accumulation);
   Quinn accumulation at ``SHARDED_MFD_EDGE``² within rtol 2e-5, atol 1e-4
   of the in-core accumulation (the topological pass) and of the in-core
   sweeps (``mfd_accumulation_info``, the solve each shard runs), mass
   conserved; ``dryrun_multichip(4)`` (an uneven
   509×1019 DEM, pad and crop); the pipeline through a one-rank NCCL group
   at 2048², bitwise the in-process mesh; then the seven kernels of these
   paths against their plain versions and timed beside their bounds at the
   shape their path gives them (an extended block for the fill, D8 and
   terrain, a shard for the D8 topological pass, the distance and
   multi-flow sweeps and the successor jump).

Each path's launch counts are set to 0 just before it runs and read just
after (the topological passes, ``mfd.MFD_TOPO`` and ``accum.ACCUM_TOPO``,
entry points of the multi-flow and D8 accumulation sweeps' libraries,
have records of their own, ``mfd_topo`` and ``accum_topo``, and so
has the successor jump, ``successor.RESOLVE_JUMP``, in the resolve
sweep's: ``resolve_jump``); the two-pass programs are two paths
(``twopass_fill``, ``twopass_accum``), whose launches and tile-width times
each of their kernels' records carries under ``twopass``, and the sharded
phase three (``sharded``, ``sharded_twopass``, ``sharded_mfd``), whose
launches and block-shape times go under ``sharded``.  The line before the
last is the per-kernel JSON record; the last
line is ``{"ok": true, "device": {...}}``.  The script imports no JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ND = -9999.0
MAIN = 10240
STEPS = 3  # timed steps of each full-size path
RAGGED = (1000, 1100)  # kernel vs plain, seams and ragged edges
#: native gates: (shape, seed, pits) of the depression DEMs
NATIVE_GATES = (((2048, 2176), 9, 24), ((4096, 4224), 21, 60))

GAUGES = 64  # upslope seeds of the d8_methods path
JACOBI_SHAPE = (2048, 2176)  # Strahler order against the Jacobi fixpoint
THETAS = (10.0, 30.0)  # Rho8's unbiasedness planes, degrees
RHO8_SEEDS = (0, 7, -3)
SCAN_WIDE = (48, 8300)  # the scan sweep over 16 CTAs, the last ragged
SERPENTINE = 2048  # edge of the walled serpentine pit
#: ε of the serpentine gate: a power of two, so every step of its 2²¹-cell
#: ramp (up to about 2048) is exact in float32
SERPENTINE_EPS = 2.0 ** -10
D4_SIZE = 2048  # edge of the api path's D4 fill
TWOPASS_TILE = 2048  # tile of the two-pass path at MAIN²
#: the native consumer's cross-check: edge and tile
TWOPASS_CHECK = (2048, 512)
#: the ε Schwarz check: edge, tile and ε
SCHWARZ = (4096, 1024, 1e-3)
#: the two-pass memory check: the peak at MAIN² within this share of the
#: peak at SCHWARZ[0]² (same tile, tiles not cached on the card)
MEMORY_SHARE = 0.10
#: the sharded phase: its mesh (every position on the one card), the ε of
#: its pipeline (the reference's default), the edge of its multi-flow
#: accumulation and of its run through a one-rank NCCL group.  Quinn is
#: cut to 4096²: at 10240² its block-Schwarz took 139 outer iterations
#: (11 617 local rotations, 299 s; H100 80GB HBM3, 700.00 W)
SHARDED_MESH = (2, 2)
SHARDED_EPS = 1e-3
SHARDED_MFD_EDGE = 4096
SHARDED_NCCL_EDGE = 2048
#: the kernels of the two-pass path: the local fill and the ring-pinned
#: apply, D8 and flat resolution of the labels, the successor jump of the
#: drain labels and of the accumulation's links, and the [P2] local
#: solves
TWOPASS_KERNELS = ("fill_sweep", "d8", "dist_sweep", "resolve_jump",
                   "accum_topo")
#: two-pass accumulation against the in-core one, on cells whose in-core
#: value reaches 2²⁴: float32 sums of more unit weights than that round,
#: and the tiled replay adds an entry cell's inflow to its weight where
#: the in-core sweep adds it to the other inflows, so the two round apart
#: there (16 ulp); below 2²⁴ every sum is an exact integer: bitwise
TWOPASS_ACC_RTOL = 1e-6
#: ε > 0 fills of Perlin DEMs: the largest |scan − folded|, and the largest
#: distance of either to the native engine's float64 fill.  Every float32
#: ε step rounds (the folded engine once a step, the scan engine twice an
#: in-row chain and once a row step), and the roundings add up along long
#: flooded paths: measured 1.7e-4 between the engines and 0.0158 to native
#: at 1000×1100, ε = 1e-3 (H100 80GB HBM3, 700.00 W).
ENGINES_ATOL = 1e-3
NATIVE_EPS_ATOL = 5e-2

#: Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
#: bandwidth and float32 outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12
#: Instruction rates of one H100 SXM (the GH100 white paper; CUDA's
#: arithmetic throughput table for compute capability 9.0): 132 SMs at
#: 1.98 GHz, each a clock 128 float32 and 64 int32 instructions and 16
#: conversions (I2F).
SMS = 132
SM_HZ = 1.98e9
ISSUE_PER_CLOCK = {"fp32": 128, "int32": 64, "xu": 16}

#: Per cell of one call, as (bytes, operations): each input read once and
#: each output written once; the arithmetic the function does, as float
#: operations, or as operations by class where most of it is not float.
#:   fill_sweep  W, Z in, W out (4+4+4); 3 adds, 3 min, 1 max
#:   d8          z, mask in, code out (4+1+1); 8 × (sub, div, compare)
#:   accum_sweep acc, w, code in, acc out (4+4+1+4); up to 9 adds
#:   accum_topo  w, code in, acc out (4+1+4); one add a donor, one a cell
#:               (its counters and level list are its own scratch)
#:   dist_sweep  w, z, flags in, w out (4+4+1+4); 3 × (compare, add, min)
#:   terrain     z, mask in, out (4+1+4); about 40 with the atan
#:   dinf_sweep  acc, w, packed field in, acc out (4+4+4+4); decode 4,
#:               8 taps (compare, select), 8 multiplies, 8 adds
#:   mfd_sweep   acc, w, 8 planes in, acc out (4+4+32+4); 8 multiplies and
#:               8 adds, 3 doubling steps of 2 chains (3 each), closure 6
#:   mfd_topo    w, 8 planes in, acc out (4+32+4); 8 multiplies and 8 adds
#:               (its counters, in-share records and level list are its
#:               own scratch, not counted)
#:   rho8        z, mask in, code out (4+1+1); int32: the counter's two
#:               words from the flat index 2, Philox4x32-10 37 (18 wide
#:               multiplies and 19 three-input xors: round 1 multiplies
#:               one word, as the counter's others are 0, and the last
#:               round forms only the word drawn), the 24 bits 1; one
#:               conversion to float; fp32: u and u·π/4 2, tanf 13 (its
#:               reduction 4, its polynomial 9), the diagonal distance 2,
#:               8 × (sub, div, compare) 24.  The int32 count binds: 40
#:               at 64 a clock, 0.2508 ms at 10240² (158 operations at 67
#:               TFLOP/s, the count of the first port, gave 0.2473)
#:   rho8_d4     as d8 with 4 directions: 4 × (sub, div, compare)
#:   resolve_sweep      value, code in, value out (4+1+4); pin test, code
#:               decode, one select
#:   resolve_jump       one call of each walk: code in, labels out (1+4);
#:               code and seed in, mask out (1+1+1); a walk's decode and
#:               pin test 6, its tile target 6, its rounds of jumps in
#:               shared memory about 8 × (compare, select), the final
#:               decode 3: about 30 a walk (its pointers and border slots
#:               are its own scratch, not counted)
#:   strahler_sweep     order, code in, order out (4+1+4); 8 compares and
#:               selects, 7 max, 8 × (compare, and, add), 3 for the update
#:               and 2 for max(old, upd)
#:   fill_scan   W, Z in, W out (4+4+4); the vertical candidate 7, the two
#:               tilts 4 each way, composing and applying two clip maps
#:               (4 + 2 each way, the scans' share of their steps about 8
#:               each way), untilting 2, the guard and the choice 7: about
#:               100 operations
#: Bytes bound all but rho8 on an H100 (under either count of their
#: operations); its int32 operations bound rho8.
COST = {"fill_sweep": (12, 7), "d8": (6, 24), "accum_sweep": (13, 9),
        "accum_topo": (9, 1),
        "dist_sweep": (13, 9), "terrain": (9, 40), "dinf_sweep": (16, 36),
        "mfd_sweep": (44, 40), "mfd_topo": (40, 16),
        "rho8": (6, {"int32": 40, "xu": 1, "fp32": 41}),
        "rho8_d4": (6, 12), "resolve_sweep": (9, 4), "resolve_jump": (8, 60),
        "strahler_sweep": (9, 52), "fill_scan": (12, 100)}


def op_seconds(name, n):
    """The least time the card could take for the operations of ``n``
    cells of ``name`` (COST): float operations over the float32 peak, or
    operations by class over their instruction rates."""
    ops = COST[name][1]
    if isinstance(ops, dict):
        clocks = max(k / ISSUE_PER_CLOCK[c] for c, k in ops.items())
        return clocks * n / (SMS * SM_HZ)
    return ops * n / F32_FLOPS_S


def bound_ms(name, n):
    """(bound in ms, what bounds it) of one call of ``name`` on ``n``
    cells: the larger of its bytes over the memory rate and its
    operations (``op_seconds``)."""
    by_bytes = COST[name][0] * n / HBM_BYTES_S
    by_ops = op_seconds(name, n)
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


#: The TPU kernel each CUDA kernel replaces (file:line of the body), and
#: the other TPU kernels it covers where there are any (a list where there
#: are two).
REPLACES = {
    "fill_sweep": ("richdem_tpu/ops/pallas_folded.py:133",
                   "richdem_tpu/ops/pallas_sweeps.py:89"),
    "d8": ("richdem_tpu/ops/pallas_stencils.py:41", None),
    "accum_sweep": ("richdem_tpu/ops/pallas_folded.py:329",
                    "richdem_tpu/ops/pallas_sweeps.py:201"),
    "dist_sweep": ("richdem_tpu/ops/pallas_scan.py:1121",
                   "richdem_tpu/ops/pallas_sweeps.py:396"),
    "terrain": ("richdem_tpu/ops/pallas_stencils.py:218", None),
    "dinf_sweep": ("richdem_tpu/ops/pallas_dinf.py:131",
                   "richdem_tpu/ops/pallas_scan.py:177"),
    "mfd_sweep": ("richdem_tpu/ops/pallas_scan.py:515",
                  ["richdem_tpu/ops/pallas_mfd.py:49",
                   "richdem_tpu/ops/pallas_mfd.py:290"]),
    "mfd_topo": ("no TPU kernel", None),
    "accum_topo": ("no TPU kernel", None),
    "rho8": ("richdem_tpu/ops/pallas_stencils.py:119", None),
    "resolve_sweep": ("richdem_tpu/ops/pallas_folded.py:606", None),
    "resolve_jump": ("richdem_tpu/ops/pallas_folded.py:606", None),
    "strahler_sweep": ("richdem_tpu/ops/pallas_folded.py:729", None),
    "fill_scan": ("richdem_tpu/ops/pallas_scan.py:876", None),
}
#: The path whose launch counts each kernel's record reports: the
#: multi-flow sweep's is the sharded one, as the in-core path takes the
#: topological pass; the successor jump's the d8_methods path (the basin
#: step of the benchmark's d8_basins cell).  The resolve sweep runs on no
#: path, as watershed labels, upslope masks and the two-pass tile labels
#: take the jump, nor does the D8 accumulation sweep, as every card path
#: takes the topological pass over the codes: their records keep their
#: gates against their plain versions and their times, and no launches.
PATH_OF = {"fill_sweep": "main", "d8": "main", "accum_sweep": None,
           "accum_topo": "main",
           "dist_sweep": "config2", "terrain": "terrain",
           "dinf_sweep": "dinf_twi", "mfd_sweep": "sharded_mfd",
           "mfd_topo": "quinn_mfd", "resolve_jump": "d8_methods",
           "rho8": "rho8", "resolve_sweep": None,
           "strahler_sweep": "d8_methods", "fill_scan": "api"}
#: Kernels redesigned since their port, and in which PR: the row-ring fill
#: and accumulation sweeps (``csrc/row_ring.cuh``), the shared-memory D8
#: tile, the flow sweeps whose tiles trade edge values
#: (``csrc/flow_sweep.cuh``), the scan fill sweep over a thread-block
#: cluster, and the seam-exact narrow tiles of the resolve sweep, then of
#: the distance and Strahler sweeps on the same walk
#: (``csrc/seam_walk.cuh``), then terrain and Rho8 on the D8 tile, lifted
#: into ``csrc/stencil_tile.cuh``.
REDESIGNED = {"fill_sweep": 6, "accum_sweep": 6, "d8": 7, "mfd_sweep": 7,
              "dinf_sweep": 7, "fill_scan": 8, "resolve_sweep": 8,
              "dist_sweep": 9, "strahler_sweep": 9, "terrain": 10,
              "rho8": 10}
#: The record of a second entry point of a source, by its C symbol: the
#: topological passes are built in the multi-flow and D8 accumulation
#: sweeps' libraries, the successor jump in the resolve sweep's.
ENTRY_RECORDS = {"rd_mfd_topo": "mfd_topo", "rd_accum_topo": "accum_topo",
                 "rd_resolve_jump": "resolve_jump"}
#: Their entry functions, which share their library's ptxas report, by a
#: part of their mangled names: those in namespace rd::topo, and those
#: templated on the jump's tag.
ENTRY_MANGLED = {"mfd_topo": "2rd4topo", "accum_topo": "2rd4topo",
                 "resolve_jump": "ResolveSweepJump"}


def kname(kernel):
    """The name of a kernel's record: its source's, or that of its entry
    point where a source has two (ENTRY_RECORDS)."""
    return ENTRY_RECORDS.get(kernel.symbol, kernel.name)


#: D∞ and multi-flow sweeps held against their plain versions at 1000×1100
FLOW_DEPTHS = (1, 8, 0)
#: Depths at which those sweeps are held against the plain sweep over whole
#: rows, a tile as wide as WHOLE_ROW
WHOLE_ROW_DEPTHS = (1, 8)
WHOLE_ROW = 1 << 30



#: Terrain attributes finished with atan/atan2: the kernel and torch may
#: call different implementations, so these are held to ATAN_RTOL.
ATAN = ("slope_radians", "slope_degrees", "aspect")
ATAN_RTOL = 1e-6


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps=1):
    """Milliseconds per call of ``fn`` on the current stream (CUDA
    events).  The caller has made the warm-up call."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(a, b):
    """Largest |a - b| over the cells where neither is NaN."""
    import torch

    if a.dtype in (torch.int8, torch.int32):
        return float((a.long() - b.long()).abs().max())
    ok = ~(torch.isnan(a) | torch.isnan(b))
    if not bool(ok.any()):
        return 0.0
    return float((a[ok].double() - b[ok].double()).abs().max())


def bitwise(name, pairs, err, what, rtol=0.0):
    """Hold each (kernel, plain) result pair bitwise (NaN where the other
    has NaN), or to ``rtol`` where given; fold the largest difference into
    ``err[name]``."""
    import torch

    for got, ref in pairs:
        diff = max_abs(got, ref)
        err[name] = max(err[name], diff)
        if got.is_floating_point():
            nan = torch.isnan(ref)
            ok = torch.equal(torch.isnan(got), nan)
            if ok and rtol:
                ok = torch.allclose(got[~nan], ref[~nan], rtol=rtol, atol=0)
            elif ok:
                ok = torch.equal(got[~nan], ref[~nan])
        else:
            ok = torch.equal(got, ref)
        if not ok:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"({what}): max |diff| {diff}")


def fill_rotation(w, floor, eps, err, what):
    """One rotation (down, up, transposed-down, transposed-up) of the fill
    kernel and of its plain version from the same start, every sweep and
    change flag held bitwise."""
    import torch
    from richdem_tpu_torch.ops import fill, sweeps

    floor_t = floor.t().contiguous()
    wk = wp = w
    for transposed, reverse in ((False, False), (False, True),
                                (True, False), (True, True)):
        fl = floor_t if transposed else floor
        if transposed:
            wk, wp = wk.t().contiguous(), wp.t().contiguous()
        fk = torch.zeros(1, dtype=torch.int32, device=w.device)
        fp = torch.zeros(1, dtype=torch.int32, device=w.device)
        wk = fill.fill_sweep(wk, fl, eps, eps, reverse, fk)
        wp = sweeps.fill_sweep_plain(wp, fl, eps, eps, reverse, fp)
        bitwise("fill_sweep", ((wk, wp), (fk, fp)), err,
                f"{what}, eps {eps}, transposed {transposed}, "
                f"reverse {reverse}")
        if transposed:
            wk, wp = wk.t().contiguous(), wp.t().contiguous()


def scan_sweeps(w, floor, eps, eps_diag, err, what):
    """A down sweep, then an up sweep of its result, of the scan fill
    kernel and of its plain version, results and change flags held
    bitwise; returns the kernel's result."""
    import torch
    from richdem_tpu_torch.ops import fill, sweeps

    for reverse in (False, True):
        fk = torch.zeros(1, dtype=torch.int32, device=w.device)
        fp = torch.zeros(1, dtype=torch.int32, device=w.device)
        wk = fill.fill_scan_sweep(w, floor, eps, eps_diag, reverse, fk)
        wp = sweeps.fill_scan_sweep_plain(w, floor, eps, eps_diag, reverse,
                                          fp)
        bitwise("fill_scan", ((wk, wp), (fk, fp)), err,
                f"{what}, reverse {reverse}")
        w = wk
    return w


def nodata_holes(shape, seed, dev, n_holes=6):
    """Circular holes drawn as ``synth_np.with_nodata_holes`` draws them,
    the mask built on the card (a 10240² mask is not built on the host)."""
    import torch

    h, w = shape
    max_radius = max(h, w) // 10
    rng = np.random.default_rng(seed)
    y = torch.arange(h, dtype=torch.float64, device=dev)[:, None]
    x = torch.arange(w, dtype=torch.float64, device=dev)[None, :]
    mask = torch.zeros(shape, dtype=torch.bool, device=dev)
    for _ in range(n_holes):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(1, max(max_radius, 2))
        mask |= (y - cy) ** 2 + (x - cx) ** 2 <= r * r
    return mask


def serpentine_pit(n):
    """tests/test_pallas_scan.py's walled serpentine pit, built a row at a
    time: the only outlet is a notch at (0, 1), and the channel descends
    one unit a cell along a path through every other row, so the ε-fill
    level chains cell by cell from the notch along about n²/2 cells."""
    z = np.full((n, n), 1e6, np.float32)
    z[0, 1] = 0.5
    val = 0.0
    for k, r in enumerate(range(1, n - 1, 2)):
        seg = val - np.arange(n - 2, dtype=np.float64)
        z[r, 1:n - 1] = seg if k % 2 == 0 else seg[::-1]
        val -= n - 2
        if r + 2 < n - 1:
            z[r + 1, (n - 2) if k % 2 == 0 else 1] = val
            val -= 1.0
    return z


def dist_starts(ff, ctx, modes):
    """The start of each distance fixpoint, as flat resolution seeds it;
    ``maxd`` starts from the ``away`` field, relaxed by the kernel."""
    import torch
    from richdem_tpu_torch.ops import flats, sweeps

    big = torch.tensor(sweeps.BIG, device=ff["zed"].device)
    starts = {"member": (torch.where(ff["noflow"], 0.0, big), 1.0),
              "towards": (torch.where(ff["outlet"], 0.0, big), 1.0),
              "away": (torch.where(ff["high_seed"], 1.0, big), 1.0)}
    if "maxd" in modes:
        d, _, done = sweeps.dist_fixpoint_core(
            starts["away"][0], ctx, "away", 1.0, 256, flats.dist_sweep)
        if not done:
            raise AssertionError("away fixpoint did not converge")
        d = torch.where(d < sweeps.BIG / 2, d, 0.0)
        starts["maxd"] = (torch.where(ff["in_flat"], -d, big), 0.0)
    return {m: starts[m] for m in modes}


def dist_down_and_transposed_up(filled, fd, mask, modes, err, what):
    """For each mode, a down sweep and then a transposed up sweep of the
    distance kernel and of its plain version (the sweep over whole rows)
    from the same start, results and change flags held bitwise."""
    import torch
    from richdem_tpu_torch.ops import flats, sweeps

    ff = flats.flat_fields(filled, fd, mask)
    ctx = sweeps.dist_context(ff["zed"], ff["flags"])
    z, s, z_t, s_t = ctx
    moved = {}
    for mode, (w0, step) in dist_starts(ff, ctx, modes).items():
        flags = [torch.zeros(1, dtype=torch.int32, device=filled.device)
                 for _ in range(4)]
        wk = flats.dist_sweep(w0, z, s, mode, step, False, flags[0])
        wp = sweeps.dist_sweep_plain(w0, z, s, mode, step, False, flags[1])
        bitwise("dist_sweep", ((wk, wp), (flags[0], flags[1])), err,
                f"{what}, {mode}, down")
        wt = wk.t().contiguous()
        wk = flats.dist_sweep(wt, z_t, s_t, mode, step, True, flags[2])
        wp = sweeps.dist_sweep_plain(wt, z_t, s_t, mode, step, True,
                                     flags[3])
        bitwise("dist_sweep", ((wk, wp), (flags[2], flags[3])), err,
                f"{what}, {mode}, transposed up")
        moved[mode] = int((wk.t() < w0).sum())
    return moved


def terrain_attributes(z, mask, zscale, cellsize, err, what):
    """The terrain kernel against its plain version, all 8 attributes."""
    from richdem_tpu_torch.ops import terrain

    for attrib in terrain.TERRAIN_ATTRIBUTES:
        got = terrain.terrain_fused(z, mask, zscale, cellsize, attrib)
        ref = terrain.terrain_plain(z, mask, zscale, cellsize, attrib)
        bitwise("terrain", ((got, ref),), err, f"{what}, {attrib}",
                rtol=ATAN_RTOL if attrib in ATAN else 0.0)


def flow_fields(angles, props):
    """The D∞ packed field (p snapped) of an angle raster and the planes of
    (H, W, 8) proportions, each with its transposed form, as the
    accumulations build them."""
    from richdem_tpu_torch.ops import dinf, mfd

    cq, pq = dinf.unpack_two_tap(dinf.pack_two_tap(
        *dinf.dinf_two_tap(angles)))
    v = dinf.pack_two_tap(cq, pq).contiguous()
    v_t = dinf.pack_two_tap(*dinf.transpose_two_tap(cq, pq)).contiguous()
    planes = props.permute(2, 0, 1).contiguous()
    return {"dinf_sweep": (v, v_t),
            "mfd_sweep": (planes, mfd.transpose_planes(planes))}


def flow_sweeps(name):
    """(kernel wrapper, plain version) of the D∞ or multi-flow sweep."""
    from richdem_tpu_torch.ops import dinf, mfd

    return {"dinf_sweep": (dinf.dinf_sweep, dinf.dinf_sweep_plain),
            "mfd_sweep": (mfd.mfd_sweep, mfd.mfd_sweep_plain)}[name]


def flow_sweep_pair(name, acc, w, field, field_t, depth, err, what):
    """A down sweep, then a transposed up sweep of its result, of the D∞ or
    multi-flow kernel and of its plain version, held bitwise.  At depths 1
    and 8 the plain version sweeps whole rows (one tile a row): the
    kernel's tiles trade edge values, so their seams change nothing; at
    other depths it takes the kernel's tiles."""
    from richdem_tpu_torch._build import FLOW_TILE

    kern, plain = flow_sweeps(name)
    tile = WHOLE_ROW if depth in WHOLE_ROW_DEPTHS else FLOW_TILE
    rule = "whole rows" if tile == WHOLE_ROW else f"{tile}-column tiles"
    ak = kern(acc, w, field, False, depth)
    bitwise(name, ((ak, plain(acc, w, field, False, depth, tile=tile)),),
            err, f"{what}, depth {depth}, down, plain over {rule}")
    at, w_t = ak.t().contiguous(), w.t().contiguous()
    bitwise(name, ((kern(at, w_t, field_t, True, depth),
                    plain(at, w_t, field_t, True, depth, tile=tile)),), err,
            f"{what}, depth {depth}, transposed up, plain over {rule}")


def topo_pair(planes, w, err, what):
    """The multi-flow topological pass and its plain version over the same
    planes and weights: every cell solved, bitwise, and the kernel's
    second call the same bits; returns the kernel's result."""
    from richdem_tpu_torch.ops import mfd

    (got, left), (again, _) = mfd.mfd_topo(planes, w), mfd.mfd_topo(planes,
                                                                    w)
    ref, left_p = mfd.mfd_topo_plain(planes, w)
    if left or left_p:
        raise AssertionError(f"mfd_topo ({what}): {left} cells left by the "
                             f"kernel, {left_p} by the plain version")
    bitwise("mfd_topo", ((got, ref), (again, got)), err, what)
    return got


def d8_topo_pair(fd, w, err, what):
    """The topological pass over D8 codes and its plain version over the
    same codes and weights: every cell solved, bitwise, and the kernel's
    second call the same bits; returns the kernel's result."""
    from richdem_tpu_torch.ops import accum

    (got, left), (again, _) = accum.d8_topo(fd, w), accum.d8_topo(fd, w)
    ref, left_p = accum.d8_topo_plain(fd, w)
    if left or left_p:
        raise AssertionError(f"accum_topo ({what}): {left} cells left by "
                             f"the kernel, {left_p} by the plain version")
    bitwise("accum_topo", ((got, ref), (again, got)), err, what)
    return got


def absorbed_mass(acc, props):
    """Mass that leaves the raster or stops, in float64: each cell keeps
    ``acc`` times its share toward no neighbour on the grid.  At the
    fixpoint of ``A = w + PᵀA`` it equals the total weight."""
    import torch
    from richdem_tpu_torch.ops.stencil import neighbor

    stay = torch.zeros(acc.shape, dtype=torch.float64, device=acc.device)
    ones = torch.ones_like(acc)
    for d in range(1, 9):
        stay += props[..., d - 1].double() * neighbor(ones, d, 0.0).double()
    return float((acc.double() * (1.0 - stay)).sum())


def succ_sweep_pair(name, v0, code, code_t, err, what):
    """A down sweep, then a transposed up sweep of its result, of the
    resolve or Strahler kernel and of its plain version (the sweep over
    whole rows), held bitwise."""
    from richdem_tpu_torch.ops import successor

    kern, plain = {
        "resolve_sweep": (successor.resolve_sweep,
                          successor.resolve_sweep_plain),
        "strahler_sweep": (successor.strahler_sweep,
                           successor.strahler_sweep_plain)}[name]
    vk = kern(v0, code, False)
    bitwise(name, ((vk, plain(v0, code, False)),), err, f"{what}, down")
    vt = vk.t().contiguous()
    bitwise(name, ((kern(vt, code_t, True), plain(vt, code_t, True)),), err,
            f"{what}, transposed up")


def jump_pair(fd, seeds, err, what):
    """The successor jump's kernels and its plain version on the same codes
    (and seeds, for the upslope mask): bitwise, and the kernels' second
    call the same bits; returns the kernels' result."""
    from richdem_tpu_torch.ops import successor

    got, again = (successor.successor_jump(fd, seeds),
                  successor.successor_jump(fd, seeds))
    bitwise("resolve_jump", ((got, successor.successor_jump_plain(fd, seeds)),
                             (again, got)), err, what)
    return got


def resolve_starts(fd, seeds):
    """(what, effective codes, init, pinned) of the two successor resolves:
    watershed labels and the upslope cells of ``seeds``."""
    import torch
    from richdem_tpu_torch.ops import successor

    fd_eff = successor.effective_codes(fd)
    pinned = fd_eff == 0
    idx = torch.arange(fd.numel(), dtype=torch.int32,
                       device=fd.device).view(fd.shape)
    return (("watersheds", fd_eff, torch.where(pinned, idx, -1), pinned),
            ("upslope", fd_eff, seeds.to(torch.int32), seeds | pinned))


def check_codes(name, codes, mask):
    """Codes in 0..8 on data, -1 exactly at nodata, and none pointing into
    nodata or off the grid."""
    import torch
    from richdem_tpu_torch.ops import successor

    if not torch.equal(codes == -1, mask):
        raise AssertionError(f"{name}: -1 is not exactly the nodata mask")
    data = codes[~mask]
    if not bool(((data >= 0) & (data <= 8)).all()):
        raise AssertionError(f"{name}: a data cell's code is out of 0..8")
    succ = successor.successor_table(codes)
    flows = (codes > 0).reshape(-1)
    if bool(mask.reshape(-1)[succ][flows].any()):
        raise AssertionError(f"{name}: a code points into nodata")
    if not torch.equal(successor.effective_codes(codes),
                       codes.clamp(min=0)):
        raise AssertionError(f"{name}: a code points off the grid")


def rho8_planes(dev):
    """Rho8 through its kernel on 256² planes whose aspect lies θ past
    East toward South: the SE diagonal must win in a share within 0.015 of
    θ/45 (tests/test_pallas.py's hardware check)."""
    import torch
    import richdem_tpu_torch as rt

    y, x = torch.meshgrid(torch.arange(256.0, device=dev),
                          torch.arange(256.0, device=dev), indexing="ij")
    shares = {}
    for theta in THETAS:
        th = np.radians(theta)
        z = -(float(np.cos(th)) * x + float(np.sin(th)) * y)
        inner = rt.rho8_flowdirs(z, seed=3)[2:-2, 2:-2]
        if not bool(((inner == 5) | (inner == 6)).all()):
            raise AssertionError(f"Rho8 plane {theta}°: codes other than "
                                 "E and SE")
        shares[theta] = float((inner == 6).float().mean())
        if abs(shares[theta] - theta / 45.0) >= 0.015:
            raise AssertionError(f"Rho8 plane {theta}°: diagonal share "
                                 f"{shares[theta]} vs {theta / 45.0}")
    return shares


def run_path(name, kernels, needed, fn):
    """Run one path with every launch count set to 0 just before it; read
    the counts just after and fail unless each of ``needed`` launched."""
    import torch

    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    result = fn()
    torch.cuda.synchronize()
    launches = {kname(k): k.launches for k in kernels}
    missing = [n for n in needed if launches[n] <= 0]
    if missing:
        raise AssertionError(f"{name}: kernels of the path never launched: "
                             f"{missing} ({launches})")
    return result, launches


def timed_steps(step, *args):
    """STEPS calls of ``step``, each timed with CUDA events and on the
    host; returns (event seconds, host seconds, last output)."""
    import torch

    ev_secs, host_secs, out = [], [], None
    for _ in range(STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = step(*args)
        end.record()
        torch.cuda.synchronize()
        host_secs.append(time.perf_counter() - t0)
        ev_secs.append(start.elapsed_time(end) / 1e3)
    return ev_secs, host_secs, out


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's smoke test needs one")
    card = card_line()
    print(card, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} visible")
    return card


def phase_build(kernels):
    """Build every kernel and the native engine at once (one nvcc per
    source and one g++, all started together)."""
    from richdem_tpu_torch import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(kernels) + 1) as pool:
        jobs = [pool.submit(k.function) for k in kernels]
        jobs.append(pool.submit(native._load))
        for job in jobs:
            job.result()
    RESOURCES.update({kname(k): kernel_resources(k) for k in kernels})
    from richdem_tpu_torch.ops import fill, flats, flowdirs, successor
    SHAPES["fill_scan"] = fill.fill_scan_shape(MAIN)
    SHAPES["resolve_sweep"] = successor.resolve_shape()
    SHAPES["resolve_jump"] = successor.jump_shape()
    SHAPES["dist_sweep"] = flats.dist_shape()
    SHAPES["strahler_sweep"] = successor.strahler_shape()
    for name in ("d8", "rho8", "terrain"):
        SHAPES[name] = flowdirs.stencil_tile_shape()
    log("build", f"scan fill sweep at {MAIN} columns: {SHAPES['fill_scan']}"
        f", {RESOURCES['fill_scan']}; "
        + "; ".join(f"{name}: {SHAPES[name]}, {RESOURCES[name]}"
                    for name in ("resolve_sweep", "resolve_jump",
                                 "dist_sweep", "strahler_sweep", "d8",
                                 "rho8", "terrain")))
    log("build", f"{len(kernels)} kernels and the native engine loaded in "
        f"{time.perf_counter() - t0:.2f} s ("
        + ", ".join(f"{kname(k)} " + ("cached" if k.build_seconds is None
                                    else f"built {k.build_seconds:.2f} s")
                    for k in kernels)
        + ")")


def _ragged_dem(dev):
    import torch
    from richdem_tpu_torch import synth as tsynth
    from richdem_tpu_torch import synth_np

    z = tsynth.perlin_dem(*RAGGED, seed=5, device=dev)
    holes = synth_np.with_nodata_holes(np.zeros(RAGGED, np.float32),
                                       no_data=1.0, seed=5, n_holes=6)
    mask = torch.from_numpy(holes == 1.0).to(dev)
    return torch.where(mask, torch.tensor(ND, device=dev), z), mask


def phase_kernel_vs_plain(dev, err):
    import torch
    from richdem_tpu_torch.ops import (accum, fill, flowdirs, successor,
                                       sweeps)

    z, mask = _ragged_dem(dev)
    shape = f"{RAGGED[0]}x{RAGGED[1]}"
    neg = torch.tensor(-sweeps.BIG, device=dev)
    floor = torch.where(mask, neg, z).contiguous()
    w = torch.where(mask, neg, torch.full_like(z, sweeps.BIG)).contiguous()

    # fill: one sweep in each of the four directions, then the fixpoints
    for eps in (0.0, 1e-3):
        fill_rotation(w, floor, eps, err, shape)
        got, it_k, done_k = fill.fill_depressions_info(z, mask, eps=eps)
        ref, it_p, done_p = sweeps.fill_fixpoint_core(
            w, floor, float(np.float32(eps)), 256, sweeps.fill_sweep_plain)
        ref = torch.where(mask, z, ref)
        if not (done_k and done_p and it_k == it_p and torch.equal(got, ref)):
            raise AssertionError(f"fill fixpoint differs at eps {eps}: "
                                 f"{max_abs(got, ref)} ({it_k}/{it_p})")
        err["fill_sweep"] = max(err["fill_sweep"], max_abs(got, ref))
        log("kernel-vs-plain", f"fill eps={eps}: 4 sweeps and fixpoint "
            f"bitwise ({it_k} rotations)")

    filled, _, _ = fill.fill_depressions_info(z, mask, eps=1e-3)
    for topo in ("D8", "D4"):
        bitwise("d8", ((flowdirs.d8_core(filled, mask, 1.0, topo),
                        flowdirs.d8_plain(filled, mask, 1.0, topo)),),
                err, f"{topo}, {shape}")
    log("kernel-vs-plain", "D8 and D4 codes bitwise")

    for topo in ("D8", "D4"):
        for seed in RHO8_SEEDS:
            got = flowdirs.rho8_core(filled, mask, 1.5, seed, topo)
            ref = flowdirs.rho8_plain(filled, mask, 1.5,
                                      flowdirs.rho8_diagonal(z.shape, seed,
                                                             dev), topo)
            bitwise("rho8", ((got, ref),), err,
                    f"{topo}, seed {seed}, {shape}")
            check_codes("rho8", got, mask)
    shares = rho8_planes(dev)
    log("kernel-vs-plain", f"Rho8 and Rho4 codes, seeds {RHO8_SEEDS}, "
        f"cellsize 1.5: bitwise, -1 exactly at nodata, none into nodata; "
        f"diagonal share on 256² planes {shares} (θ/45 within 0.015)")

    fd = flowdirs.d8_core(filled, mask)
    seeds = torch.from_numpy(np.random.default_rng(6).random(RAGGED)
                             < 0.01).to(dev)
    for what, fd_eff, init, pinned in resolve_starts(fd, seeds):
        code = successor.pack_codes(fd_eff, pinned)
        succ_sweep_pair("resolve_sweep", init, code,
                        successor.transpose_codes(code), err,
                        f"{what}, {shape}")
        got, rk, dk = successor.successor_resolve_info(fd_eff, init, pinned)
        ref, rp, dp = successor.successor_resolve_info(
            fd_eff, init, pinned, sweep=successor.resolve_sweep_plain)
        if not (dk and dp and rk == rp and torch.equal(got, ref)):
            raise AssertionError(f"resolve fixpoint ({what}) differs "
                                 f"({rk}/{rp} rotations)")
        log("kernel-vs-plain", f"resolve sweep ({what}): down and "
            f"transposed up, and the fixpoint, bitwise ({rk} rotations)")
        jump = jump_pair(fd, seeds if what == "upslope" else None, err,
                         f"{what}, {shape}")
        bitwise("resolve_jump", ((jump, got > 0 if what == "upslope"
                                  else got),), err,
                f"{what}, {shape}, against the resolve sweeps' fixpoint")
    log("kernel-vs-plain", "successor jump (watersheds, upslope): bitwise "
        "its plain version, twice, and the resolve sweeps' fixpoint")
    sc = fd.clamp(min=0).to(torch.int8)
    succ_sweep_pair("strahler_sweep", (fd >= 0).to(torch.int32), sc,
                    successor.transpose_codes(sc), err, shape)
    got, rk, dk = successor.strahler_fixpoint_info(fd)
    ref, rp, dp = successor.strahler_fixpoint_info(
        fd, sweep=successor.strahler_sweep_plain)
    if not (dk and dp and rk == rp and torch.equal(got, ref)):
        raise AssertionError(f"Strahler fixpoint differs ({rk}/{rp})")
    log("kernel-vs-plain", f"Strahler sweep: down and transposed up, and "
        f"the fixpoint, bitwise ({rk} rotations, largest order "
        f"{int(got.max())})")
    rng = np.random.default_rng(5)
    wf = torch.from_numpy(rng.uniform(0.1, 2.0, tuple(z.shape))
                          .astype(np.float32)).to(dev)
    for name, wt in (("unit", torch.ones_like(z)), ("float", wf)):
        wt = torch.where(mask, 0.0, wt)
        got, rk, dk = accum.d8_accumulation_sweeps(fd, wt, 64)
        ref, rp, dp = accum.d8_accumulation_sweeps(
            fd, wt, 64, sweep=accum.accum_sweep_plain)
        if not (dk and dp):
            raise AssertionError(f"accumulation ({name}) not converged")
        if name == "unit":
            ok = torch.equal(got, ref)
        else:  # summation order may differ in principle: rtol 1e-6
            ok = torch.allclose(got, ref, rtol=1e-6, atol=0.0)
        if not ok:
            raise AssertionError(f"accumulation ({name} weights) differs: "
                                 f"{max_abs(got, ref)}")
        err["accum_sweep"] = max(err["accum_sweep"], max_abs(got, ref))
        topo = d8_topo_pair(fd, wt, err, f"{shape}, {name} weights")
        if name == "unit" and not torch.equal(topo, ref):
            raise AssertionError("the D8 pass differs from the sweeps' "
                                 "fixpoint at unit weights")
        log("kernel-vs-plain", f"accumulation, {name} weights: "
            f"{'bitwise' if name == 'unit' else 'allclose rtol 1e-6'} "
            f"(max |diff| {max_abs(got, ref)}, {rk}/{rp} rotations); the "
            f"topological pass over the codes bitwise its plain version"
            f"{' and the fixpoint' if name == 'unit' else ''}")

    # distance sweeps on the flats of this DEM's ε = 0 fill
    filled0, _, _ = fill.fill_depressions_info(z, mask, eps=0.0)
    fd0 = flowdirs.d8_core(filled0, mask)
    moved = dist_down_and_transposed_up(filled0, fd0, mask,
                                        sweeps.DIST_MODES, err, shape)
    log("kernel-vs-plain", f"distance sweep, every mode, down and "
        f"transposed up: bitwise to the plain sweep over whole rows, change "
        f"flags included (cells lowered: {moved})")

    # D∞ and multi-flow sweeps on this DEM's ε = 1e-2 fill, nodata holes
    # routing nothing, from a random start
    filled2, _, _ = fill.fill_depressions_info(z, mask, eps=1e-2)
    fields = flow_fields(flowdirs.dinf_flowdirs(filled2, ND),
                         flowdirs.flow_proportions(filled2, "Quinn", ND))
    ones = torch.where(mask, 0.0, torch.ones_like(z))
    acc0 = torch.from_numpy(rng.uniform(1.0, 50.0, tuple(z.shape))
                            .astype(np.float32)).to(dev)
    for name in ("dinf_sweep", "mfd_sweep"):
        for depth in FLOW_DEPTHS:
            flow_sweep_pair(name, acc0, ones, *fields[name], depth, err,
                            shape)
    log("kernel-vs-plain", f"D∞ and multi-flow (Quinn) sweeps at depths "
        f"{FLOW_DEPTHS}, down and transposed up: bitwise (at depths "
        f"{WHOLE_ROW_DEPTHS} to the plain sweep over whole rows)")
    planes = fields["mfd_sweep"][0]
    for what, wt in (("unit", ones), ("float", torch.where(mask, 0.0, wf))):
        topo_pair(planes, wt, err, f"{shape}, {what} weights")
    log("kernel-vs-plain", "multi-flow (Quinn) topological pass, unit and "
        "float weights, nodata holes: every cell solved, bitwise, the same "
        "bits twice")

    terrain_attributes(z, mask, 2.0, 3.0, err,
                       f"{shape}, zscale 2, cellsize 3")
    log("kernel-vs-plain", f"terrain, 8 attributes (zscale 2, cellsize 3, "
        f"nodata): bitwise, {'/'.join(ATAN)} within rtol {ATAN_RTOL} "
        f"(max |diff| {err['terrain']})")


def phase_scan_vs_plain(dev, err):
    """The scan fill sweep against its plain version at 1000×1100 with
    nodata holes (ε = 0, ε = 1e-3, D4) and on a 48×8300 raster (a cluster
    of 16 CTAs), then the scan engine's fixpoint against the folded engine's
    and the native engine's float64 fill: bitwise at ε = 0; at ε = 1e-3
    within ENGINES_ATOL of each other and NATIVE_EPS_ATOL of native."""
    import torch
    from richdem_tpu_torch import native
    from richdem_tpu_torch import synth as tsynth
    from richdem_tpu_torch.ops import fill, sweeps

    z, mask = _ragged_dem(dev)
    shape = f"{RAGGED[0]}x{RAGGED[1]}"
    neg = torch.tensor(-sweeps.BIG, device=dev)
    floor = torch.where(mask, neg, z).contiguous()
    w = torch.where(mask, neg, torch.full_like(z, sweeps.BIG)).contiguous()
    for eps, eps_diag, name in ((0.0, 0.0, "eps 0"), (1e-3, 1e-3, "eps 1e-3"),
                                (0.0, sweeps.BIG / 2, "D4")):
        scan_sweeps(w, floor, eps, eps_diag, err, f"{shape}, {name}")
    zw = tsynth.perlin_dem(*SCAN_WIDE, seed=6, device=dev)
    mw = torch.from_numpy(np.random.default_rng(6).random(SCAN_WIDE)
                          < 0.01).to(dev)
    scan_sweeps(torch.where(mw, neg, torch.full_like(zw, sweeps.BIG)),
                torch.where(mw, neg, zw), 1e-3, 1e-3, err,
                f"{SCAN_WIDE[0]}x{SCAN_WIDE[1]}, eps 1e-3")
    log("kernel-vs-plain", f"scan fill sweep down and up: bitwise at {shape} "
        f"(eps 0, eps 1e-3, D4) and at {SCAN_WIDE[0]}x{SCAN_WIDE[1]} "
        f"({fill.fill_scan_shape(SCAN_WIDE[1])})")
    dem64 = z.double().cpu().numpy()
    for eps in (0.0, 1e-3):
        got, it_s, done_s = fill.fill_depressions_info(z, mask, eps=eps,
                                                       engine="scan")
        ref, it_f, done_f = fill.fill_depressions_info(z, mask, eps=eps,
                                                       engine="folded")
        want = native.fill(dem64, no_data=ND, eps=eps)
        d_native = [float(np.max(np.abs(x.cpu().numpy() - want)))
                    for x in (got, ref)]
        same = torch.equal(got, ref)
        if not (done_s and done_f) or (eps == 0.0 and not (
                same and d_native[0] == 0.0)) or max_abs(
                    got, ref) > ENGINES_ATOL or max(d_native) > \
                NATIVE_EPS_ATOL:
            raise AssertionError(f"scan fixpoint at eps {eps}: scan vs "
                                 f"folded {max_abs(got, ref)}, vs native "
                                 f"{d_native}")
        log("kernel-vs-plain", f"scan fixpoint {shape} eps {eps}: "
            f"{'bitwise' if same else f'max |diff| {max_abs(got, ref)}'} "
            f"against the folded engine; max |diff| to the native float64 "
            f"fill: scan {d_native[0]}, folded {d_native[1]} ({it_s} scan "
            f"rotations of 2 sweeps, {it_f} folded rotations of 4)")


def phase_native(dev):
    import torch
    from richdem_tpu_torch import native, synth_np
    from richdem_tpu_torch import synth as tsynth
    from richdem_tpu_torch.ops import accum, fill, flats, flowdirs

    for (h, w), seed, pits in NATIVE_GATES:
        dem = synth_np.depression_dem(h, w, seed=seed, n_pits=pits,
                                      dtype=np.float32)
        z = torch.from_numpy(dem).to(dev)
        got, iters, done = fill.fill_depressions_info(z, eps=0.0)
        got64 = got.cpu().numpy().astype(np.float64)
        want = native.fill(dem.astype(np.float64))
        multigrid = max(h, w) >= fill.MULTISCALE_MIN
        if not (done and np.array_equal(got64, want)):
            raise AssertionError(f"fill {h}x{w} differs from native")
        scan, s_iters, s_done = fill.fill_depressions_info(z, eps=0.0,
                                                           engine="scan")
        if not (s_done and np.array_equal(
                scan.cpu().numpy().astype(np.float64), want)):
            raise AssertionError(f"scan fill {h}x{w} differs from native")
        del scan
        log("native", f"fill {h}x{w} eps=0 bit-exact vs native with both "
            f"engines (folded {iters} rotations of 4 sweeps, scan {s_iters} "
            f"of 2; multigrid {multigrid})")

        # flat resolution of the ε = 0 fill's flat lakes
        nd = torch.zeros_like(z, dtype=torch.bool)
        fd = flowdirs.d8_core(got, nd)
        fd_np = fd.cpu().numpy()
        resolved, mask, _, rots, sdone = flats.resolve_flats_info(got, fd,
                                                                  nd)
        if not sdone:
            raise AssertionError(f"resolve_flats {h}x{w} not converged")
        want_fd = native.resolve_flats(got64, fd_np)
        bad = int((resolved.cpu().numpy() != want_fd).sum())
        want_mask, _ = native.flat_mask_and_labels(got64, fd_np)
        mask_diff = int((mask.cpu().numpy() != want_mask).sum())
        log("native", f"resolve_flats {h}x{w}: {bad} of {h * w} codes "
            f"differ from native; {int((fd_np == 0).sum())} NO_FLOW cells "
            f"before, {int((want_fd == 0).sum())} after; rotations "
            f"(towards, away, maxd) {rots}; {mask_diff} flat-mask cells "
            f"differ from native.flat_mask_and_labels")
        if bad:
            raise AssertionError(f"resolve_flats {h}x{w}: {bad} codes "
                                 "differ from native")
        for codes, what in ((fd, "eps=0 codes"), (resolved, "resolved")):
            mass, rel, above, _ = held_to_native(
                codes, accum.d8_accumulation(codes), f"{h}x{w} {what}")
            log("native", f"accumulation of the {h}x{w} {what} (the "
                f"topological pass): mass {mass:.0f}, exact vs native "
                f"below 2**24, within {rel:.3e} above ({above} cells)")

    h, w = NATIVE_GATES[0][0]
    z = tsynth.perlin_dem(h, w, seed=22, device=dev)
    filled, _, done = fill.fill_depressions_info(z, eps=1e-2)
    if not done:
        raise AssertionError("fill at eps=1e-2 did not converge")
    fd = flowdirs.d8_core(filled, torch.zeros_like(z, dtype=torch.bool))
    fd_np = fd.cpu().numpy()
    acc = accum.d8_accumulation(fd).cpu().numpy().astype(np.float64)
    if not np.array_equal(acc, native.accum_d8(fd_np)):
        raise AssertionError("accumulation differs from native")
    log("native", f"accumulation {h}x{w} exact vs native")
    want_fd = native.d8_flowdirs(filled.cpu().numpy().astype(np.float64))
    bad = int((fd_np != want_fd).sum())
    log("native", f"D8 {h}x{w}: {bad} of {h * w} codes differ from native "
        "(float32 slope ties; limit 1e-5 of the cells)")
    if bad > 1e-5 * h * w:
        raise AssertionError(f"D8: {bad} codes differ from native")


def phase_native_flow(dev):
    """Config 4's accumulations against the native topological queue over
    the same proportions, on ε = 1e-2 fills at 2048×2176 (the gates of
    tests/test_tpu_only.py): D∞ (snapped two-tap proportions) and Quinn
    within rtol 2e-5, D∞ mass within 1e-5; D8 codes through the two-tap
    scan (p = 1, depth 0) bitwise."""
    import torch
    from richdem_tpu_torch import native
    from richdem_tpu_torch import synth as tsynth
    from richdem_tpu_torch.ops import dinf, fill, flowdirs, mfd

    h, w = NATIVE_GATES[0][0]
    nd = torch.zeros((h, w), dtype=torch.bool, device=dev)

    def filled_of(seed):
        z = tsynth.perlin_dem(h, w, seed=seed, device=dev)
        filled, _, done = fill.fill_depressions_info(z, eps=1e-2)
        if not done:
            raise AssertionError(f"fill at eps=1e-2 (seed {seed}) did not "
                                 "converge")
        return filled

    def held(name, got, want, mass_tol=None):
        got = got.cpu().numpy().astype(np.float64)
        rel = float(np.max(np.abs(got - want) / want))
        mass = abs(got.sum() / want.sum() - 1.0)
        if not np.allclose(got, want, rtol=2e-5, atol=0.0) or (
                mass_tol is not None and mass >= mass_tol):
            raise AssertionError(f"{name} {h}x{w} differs from native: rel "
                                 f"{rel:.3e}, mass {mass:.3e}")
        return rel, mass

    filled = filled_of(31)
    ang = flowdirs.dinf_flowdirs(filled)
    code, p = dinf.dinf_two_tap(ang)
    acc, rot, done = dinf.dinf_accumulation_info(code, p, torch.ones_like(
        filled))
    if not done:
        raise AssertionError("D∞ accumulation did not converge")
    cq, pq = dinf.unpack_two_tap(dinf.pack_two_tap(code, p))
    props = dinf.two_tap_props(cq, pq).cpu().numpy().astype(np.float64)
    rel, mass = held("D∞", acc, native.accum_props(props), 1e-5)
    want_ang = native.dinf_flowdirs(filled.cpu().numpy().astype(np.float64))
    flips = int((np.abs(ang.cpu().numpy() - want_ang) > 1e-5).sum())
    log("native", f"D∞ accumulation {h}x{w} (eps=1e-2 fill, depth "
        f"{dinf.DINF_DEPTH}): within rtol 2e-5 of native over the snapped "
        f"proportions (max rel {rel:.3e}, mass {mass:.3e}), {rot} "
        f"rotations; angles: {flips} cells differ from native's float64 "
        "angles by more than 1e-5 rad")

    filled = filled_of(24)
    props = flowdirs.flow_proportions(filled, "Quinn")
    acc, rot, done = mfd.mfd_accumulation(props, return_info=True)
    rel, mass = held("Quinn", acc, native.accum_props(
        props.cpu().numpy().astype(np.float64)))
    log("native", f"Quinn accumulation {h}x{w} (eps=1e-2 fill, the "
        f"topological pass): within rtol 2e-5 of native (max rel {rel:.3e}, "
        f"mass {mass:.3e}), {rot} rotations")

    filled = filled_of(22)
    fd = flowdirs.d8_core(filled, nd)
    acc, rot, _ = dinf.dinf_accumulation(fd.to(torch.int32),
                                         torch.ones_like(filled), depth=0,
                                         max_rotations=64, return_info=True)
    got = acc.cpu().numpy().astype(np.float64)
    if not np.array_equal(got, native.accum_d8(fd.cpu().numpy())):
        raise AssertionError("D8 through the two-tap scan differs from "
                             "native")
    log("native", f"D8 codes through the two-tap scan (p = 1, depth 0) "
        f"{h}x{w}: bitwise equal to native.accum_d8, {rot} rotations")


def phase_serpentine(dev, card):
    """The walled serpentine pit at SERPENTINE² through both fill engines
    at ε = SERPENTINE_EPS: each converges; the scan engine within rtol
    1e-6, atol 1e-4 of the folded one and atol 1e-2 of the native engine's
    float64 fill; the rotations and host times of each."""
    import torch
    from richdem_tpu_torch import native
    from richdem_tpu_torch.ops import fill

    n = SERPENTINE
    dem = serpentine_pit(n)
    z = torch.from_numpy(dem).to(dev)
    res = {}
    for engine in ("scan", "folded"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, iters, done = fill.fill_depressions_info(
            z, eps=SERPENTINE_EPS, max_iters=4096, engine=engine)
        torch.cuda.synchronize()
        if not done:
            raise AssertionError(f"serpentine: the {engine} engine did not "
                                 "converge")
        res[engine] = (got, iters, time.perf_counter() - t0)
    scan, folded = res["scan"][0], res["folded"][0]
    diff = max_abs(scan, folded)
    if not torch.allclose(scan, folded, rtol=1e-6, atol=1e-4):
        raise AssertionError(f"serpentine: the engines differ by {diff}")
    want = native.fill(dem.astype(np.float64), eps=SERPENTINE_EPS)
    got = scan.cpu().numpy().astype(np.float64)
    ndiff = float(np.max(np.abs(got - want)))
    if ndiff > 1e-2:
        raise AssertionError(f"serpentine: scan differs from native by "
                             f"{ndiff}")
    top = float(scan[z < 1e6].max())
    log("serpentine", f"{n}x{n} walled serpentine pit, eps 2^-10 (ramp top "
        f"{top}): scan "
        f"{res['scan'][1]} rotations of 2 sweeps in {res['scan'][2]:.3f} s, "
        f"folded {res['folded'][1]} rotations of 4 sweeps in "
        f"{res['folded'][2]:.3f} s (host clock) on [{card}]; scan vs folded "
        f"{'bitwise' if torch.equal(scan, folded) else f'max |diff| {diff}'}"
        f"; scan vs native float64 max |diff| {ndiff}")
    return {k: v[1] for k, v in res.items()}


def phase_main(dev, card, kernels):
    import torch
    from richdem_tpu_torch import check_converged, make_pipeline
    from richdem_tpu_torch import synth as tsynth

    z = tsynth.perlin_dem(MAIN, MAIN, seed=0, device=dev)
    step = make_pipeline((MAIN, MAIN), eps=0.0, fill_iters=256,
                         with_twi=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out, launches = run_path("main", kernels,
                             ("fill_sweep", "d8", "accum_topo"),
                             lambda: step(z))
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    check_converged(out)

    ev_secs, host_secs, out = timed_steps(step, z)
    check_converged(out)

    n = MAIN * MAIN
    for key in ("filled", "accum", "slope", "twi"):
        if (tuple(out[key].shape) != (MAIN, MAIN)
                or not bool(torch.isfinite(out[key]).all())):
            raise AssertionError(f"{key}: wrong shape or non-finite values")
    terminal = out["flowdirs"] == 0
    mass = float(out["accum"][terminal].double().sum())
    if not abs(mass - n) <= 1e-6 * n:
        raise AssertionError(f"mass not conserved: {mass} vs {n} cells")
    if not bool((out["filled"] >= z).all()):
        raise AssertionError("filled surface below the DEM")
    best = min(ev_secs)
    log("main", f"{MAIN}x{MAIN} pipeline (eps=0, with_twi): "
        f"fill_iters {out['fill_iters']}, accum_rotations "
        f"{out['accum_rotations']}; {STEPS} steps after one warm-up: "
        f"{ev_secs} s (CUDA events), {host_secs} s (host); best "
        f"{n / best:.4e} cells/s; peak allocated {peak_gib:.3f} GiB "
        f"(warm-up step, DEM included) on [{card}]; mass {mass:.1f} of "
        f"{n}; launches {launches}")
    return out, launches, z, best


def held_to_native(codes, acc, what):
    """The native engine's float64 accumulation of D8 ``codes`` conserves
    mass exactly (NO_FLOW cells absorb every cell), and the port's float32
    ``acc`` equals it in every cell below 2**24, where float32 holds a
    count and each partial sum of it exactly; above, it rounds.  Returns
    (mass, largest relative difference above, cells above, largest)."""
    from richdem_tpu_torch import native

    got = codes.cpu().numpy()
    want = native.accum_d8(got)
    mass = float(want[got == 0].sum())
    if mass != got.size:
        raise AssertionError(f"{what} lose mass: {mass} vs {got.size}")
    acc = acc.cpu().numpy().astype(np.float64)
    small = want < 2**24
    if not np.array_equal(acc[small], want[small]):
        raise AssertionError(f"accumulation of the {what} differs from "
                             "native below 2**24")
    rel = float(np.max(np.abs(acc[~small] - want[~small]) / want[~small],
                       initial=0.0))
    return mass, rel, int((~small).sum()), float(want.max())


def phase_flats_full(out, err):
    """Flat resolution of the main path's ε = 0 output, whose filled lakes
    are real flats: held bitwise against the native engine at full size,
    and the resolved codes' accumulation against native's (float64) and,
    through the topological pass, bitwise its plain version."""
    import torch
    from richdem_tpu_torch import native, resolve_flats
    from richdem_tpu_torch.ops import accum

    filled, fd = out["filled"], out["flowdirs"]
    t0 = time.perf_counter()
    resolved, rotations, done = resolve_flats(filled, fd, return_info=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    inner = (slice(1, -1), slice(1, -1))
    before = int((fd[inner] == 0).sum())
    left = int((resolved[inner] == 0).sum())
    if not done or left:
        raise AssertionError(f"flats at {MAIN}x{MAIN}: converged {done}, "
                             f"{left} interior NO_FLOW cells left")
    fd_np, got = fd.cpu().numpy(), resolved.cpu().numpy()
    bad = int((got != native.resolve_flats(
        filled.cpu().numpy().astype(np.float64), fd_np)).sum())
    if bad:
        raise AssertionError(f"flats at {MAIN}x{MAIN}: {bad} codes differ "
                             "from native")
    n = MAIN * MAIN
    mass, rel, above, largest = held_to_native(
        resolved, accum.d8_accumulation(resolved, max_rotations=256),
        "resolved codes")
    d8_topo_pair(resolved, torch.ones_like(filled), err,
                 f"{MAIN}x{MAIN} resolved codes")
    log("flats", f"resolve_flats on the {MAIN}x{MAIN} eps=0 main-path "
        f"output: {before} interior NO_FLOW cells before, 0 after; codes "
        f"bitwise equal to native; {rotations} rotations over the three "
        f"fixpoints; {secs:.3f} s (host, first call); native float64 "
        f"accumulation of the resolved codes conserves mass exactly "
        f"({mass:.0f} of {n}); the port's float32 accumulation equals it in "
        f"every cell "
        f"below 2**24 and is within {rel:.3e} relative above "
        f"({above} cells, largest {largest:.0f}); the topological pass "
        f"over the resolved codes bitwise its plain version")


def config2_step(z, eps):
    """Config 2's step through the entry points: ε-fill, D8,
    resolve_flats; returns (filled, codes, resolved codes, fill rotations,
    flats rotations)."""
    import torch
    from richdem_tpu_torch import resolve_flats
    from richdem_tpu_torch.ops import fill, flowdirs

    filled, fiters, fdone = fill.fill_depressions_info(z, eps=eps,
                                                       max_iters=256)
    if not fdone:
        raise AssertionError(f"config 2 fill not converged ({fiters})")
    fd = flowdirs.d8_core(filled, torch.zeros_like(z, dtype=torch.bool))
    resolved, rotations, _ = resolve_flats(filled, fd, return_info=True)
    return filled, fd, resolved, fiters, rotations


def phase_config2(dev, card, kernels):
    """BASELINE.json config 2 (bench.py BENCH_CONFIG=fill_flats) at full
    width: auto_epsilon of the device raster, ε-fill, D8, resolve_flats."""
    import torch
    from richdem_tpu_torch import auto_epsilon
    from richdem_tpu_torch import synth as tsynth

    z = tsynth.perlin_dem(MAIN, MAIN, seed=0, device=dev)
    eps = auto_epsilon(z)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    (filled, fd, resolved, fiters, rotations), launches = run_path(
        "config 2", kernels, ("fill_sweep", "d8", "dist_sweep"),
        lambda: config2_step(z, eps))
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    if not bool((filled >= z).all()):
        raise AssertionError("config 2: filled surface below the DEM")
    from richdem_tpu_torch.ops import fill, sweeps
    big, big_iters, done = fill.fill_depressions_info(
        z, eps=eps, w0=torch.full_like(z, sweeps.BIG))
    if not (done and torch.equal(filled, big)):
        raise AssertionError(
            f"config 2: the fill from the multigrid start is not the fill "
            f"from BIG (converged {done}, max |diff| {max_abs(filled, big)})")
    del big
    noflow = (int((fd == 0).sum()), int((resolved == 0).sum()),
              int((resolved[1:-1, 1:-1] == 0).sum()))
    ev_secs, host_secs, last = timed_steps(config2_step, z, eps)
    if not torch.equal(last[2], resolved):
        raise AssertionError("config 2 is not deterministic")
    n = MAIN * MAIN
    log("config2", f"{MAIN}x{MAIN} Perlin seed 0: auto_epsilon {eps!r}; "
        f"fill rotations {fiters} (bitwise the fill from BIG, "
        f"{big_iters} rotations), flats rotations {rotations}; NO_FLOW "
        f"{noflow[0]} before resolve_flats, {noflow[1]} after "
        f"({noflow[2]} of them off the border); {STEPS} "
        f"steps after one warm-up: {ev_secs} s (CUDA events), {host_secs} s "
        f"(host); best {n / min(ev_secs):.4e} cells/s; peak allocated "
        f"{peak_gib:.3f} GiB (warm-up step, DEM included) on [{card}]; "
        f"launches {launches}")
    return launches


def _config4_fill(z):
    from richdem_tpu_torch.ops import fill

    filled, fiters, fdone = fill.fill_depressions_info(z, eps=1e-2,
                                                       max_iters=256)
    if not fdone:
        raise AssertionError(f"config 4 fill not converged ({fiters})")
    return filled, fiters


def dinf_twi_step(z, depth=None):
    """bench.py's dinf_twi through the port's entry points: ε = 1e-2 fill
    → D∞ angles → D∞ accumulation (at ``depth``, the default if None) →
    slope → TWI."""
    import richdem_tpu_torch as rt
    from richdem_tpu_torch.ops import dinf

    filled, fiters = _config4_fill(z)
    ang = rt.dinf_flowdirs(filled)
    acc, rot, done = rt.dinf_accumulation_from_angles(
        ang, return_info=True, depth=dinf.DINF_DEPTH if depth is None
        else depth)
    slope = rt.terrain_attribute(filled, "slope_radians")
    return {"filled": filled, "angles": ang, "accum": acc,
            "twi": rt.twi(acc, slope), "fill_iters": fiters,
            "rotations": rot, "converged": done}


def quinn_mfd_step(z, depth=None):
    """bench.py's quinn_mfd through the port's entry points: ε = 1e-2
    fill → Quinn proportions → multi-flow accumulation (at ``depth``, the
    default if None)."""
    import richdem_tpu_torch as rt
    from richdem_tpu_torch.ops import mfd

    filled, fiters = _config4_fill(z)
    props = rt.flow_proportions(filled, "Quinn")
    acc, rot, done = rt.flow_accumulation_from_props(
        props, return_info=True, depth=mfd.MFD_DEPTH if depth is None
        else depth)
    return {"filled": filled, "props": props, "accum": acc,
            "fill_iters": fiters, "rotations": rot, "converged": done}


def phase_config4(dev, card, kernels, z):
    """BASELINE.json config 4 (bench.py's dinf_twi and quinn_mfd) at full
    width, through the entry points (:func:`dinf_twi_step`,
    :func:`quinn_mfd_step`)."""
    import torch
    from richdem_tpu_torch.ops import dinf, mfd

    def props_of(out):
        if "props" in out:
            return out["props"]
        code, p = dinf.dinf_two_tap(out["angles"])
        return dinf.two_tap_props(*dinf.unpack_two_tap(
            dinf.pack_two_tap(code, p)))

    n = MAIN * MAIN
    outs, launches = {}, {}
    for name, step, needed, depth in (
            ("dinf_twi", dinf_twi_step,
             ("fill_sweep", "dinf_sweep", "terrain"), dinf.DINF_DEPTH),
            ("quinn_mfd", quinn_mfd_step, ("fill_sweep", "mfd_topo"),
             mfd.MFD_DEPTH)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        out, launches[name] = run_path(name, kernels, needed,
                                       lambda: step(z))
        topo = launches[name]["mfd_topo"]
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        if not out["converged"]:
            raise AssertionError(f"{name}: accumulation not converged")
        # Quinn's shares go downhill: one topological pass solves them
        # (csrc/flow_topo.cuh), with no rotation of the sweep
        if name == "quinn_mfd" and (topo != 1 or out["rotations"] != 0
                                    or launches[name]["mfd_sweep"] != 0):
            raise AssertionError(f"quinn_mfd: {topo} topological passes, "
                                 f"{out['rotations']} rotations, "
                                 f"{launches[name]['mfd_sweep']} sweeps")
        for key in ("accum", "twi"):
            x = out.get(key)
            if x is not None and (tuple(x.shape) != (MAIN, MAIN) or not bool(
                    torch.isfinite(x).all())):
                raise AssertionError(f"{name} {key}: wrong shape or "
                                     "non-finite values")
        mass = absorbed_mass(out["accum"], props_of(out))
        if not abs(mass - n) <= 1e-5 * n:
            raise AssertionError(f"{name}: mass not conserved: {mass} vs "
                                 f"{n}")
        ev_secs, host_secs, last = timed_steps(step, z)
        if not torch.equal(last["accum"], out["accum"]):
            raise AssertionError(f"{name} is not deterministic")
        log(name, f"{MAIN}x{MAIN} Perlin seed 0, eps=1e-2: fill rotations "
            f"{out['fill_iters']}, accumulation rotations "
            f"{out['rotations']} at depth {depth}"
            + (f" ({topo} topological pass)" if topo else "")
            + f"; {STEPS} steps after one "
            f"warm-up: {ev_secs} s (CUDA events), {host_secs} s (host); "
            f"best {n / min(ev_secs):.4e} cells/s; peak allocated "
            f"{peak_gib:.3f} GiB (warm-up step, DEM included) on [{card}]; "
            f"mass {mass:.1f} of {n}; launches {launches[name]}")
        outs[name] = out
    return outs, launches


def phase_terrain(dev, card, z, kernels):
    """terrain_attribute, the entry point, on the 10240² DEM."""
    import torch
    from richdem_tpu_torch import terrain_attribute

    (slope, aspect), launches = run_path(
        "terrain", kernels, ("terrain",),
        lambda: (terrain_attribute(z, "slope_radians"),
                 terrain_attribute(z, "aspect")))
    if not (bool(torch.isfinite(slope).all())
            and bool(((slope >= 0) & (slope < np.pi / 2)).all())):
        raise AssertionError("slope_radians out of [0, pi/2)")
    if not bool((((aspect >= 0) & (aspect < 360)) | (aspect == -1)).all()):
        raise AssertionError("aspect out of [0, 360) and not -1")
    slope_ms = cuda_ms(lambda: terrain_attribute(z, "slope_radians"), 5)
    aspect_ms = cuda_ms(lambda: terrain_attribute(z, "aspect"), 5)
    log("terrain", f"terrain_attribute at {MAIN}x{MAIN}: slope_radians "
        f"{slope_ms:.3f} ms, aspect {aspect_ms:.3f} ms per call on "
        f"[{card}]; launches {launches}")
    return launches


def kernel_resources(kernel):
    """Registers and spill bytes a thread of ``kernel``, the largest over
    its entries, from the build's ``-Xptxas -v`` report (a second entry
    point's functions, ENTRY_MANGLED, apart from its library's first)."""
    part = ENTRY_MANGLED.get(kname(kernel))
    entries = {e: v for e, v in kernel.resources().items()
               if (part in e if part else
                   not any(p in e for p in ENTRY_MANGLED.values()))}
    if not entries:
        raise AssertionError(f"no ptxas report of {kname(kernel)}'s "
                             "entries")
    return {key: max(e[key] for e in entries.values())
            for key in ("registers", "spill_stores", "spill_loads")}


#: Per kernel, its registers and spills (``kernel_resources``), filled in
#: by the build phase.
RESOURCES = {}
#: The launch shapes of the scan sweep (its cluster at MAIN columns), of
#: the sweeps on the seam-exact walk (their tiles) and of the stencil
#: kernels (their shared-memory tile), filled in by the build phase.
SHAPES = {}


def time_kernel(name, kern, plain, card, times, what):
    """One call of ``kern`` timed (after a warm-up call) beside its plain
    version and the bound of its work at MAIN², from ``COST``; logs the
    kernel's registers and spills and, for a sweep, its time per row step
    (MAIN rows); returns the plain version's result."""
    kern()
    ms = cuda_ms(kern, reps=5)
    out = {}
    plain_ms = cuda_ms(lambda: out.setdefault("plain", plain()), reps=1)
    bound, bound_by = bound_ms(name, MAIN * MAIN)
    times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by=bound_by)
    res = RESOURCES[name]
    row = (f"{1e3 * ms / MAIN:.3f} us per row step, "
           if name.endswith(("_sweep", "_scan")) else "")
    log("timing", f"{name} at {what}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms per call; bound {bound:.4f} ms ({bound_by}), "
        f"{100 * bound / ms:.1f} % of it; {row}{res['registers']} "
        f"registers, {res['spill_stores']} B spill stores and "
        f"{res['spill_loads']} B spill loads a thread; on [{card}]")
    return out["plain"]


def time_variants(name, calls, card, what):
    """One call of each variant of kernel ``name`` (``{variant: (call,
    COST key)}``) timed after a warm-up call, beside the bound of its
    work at MAIN²; logged, not recorded."""
    parts = []
    for variant, (call, cost) in calls.items():
        call()
        ms = cuda_ms(call, reps=5)
        bound, bound_by = bound_ms(cost, MAIN * MAIN)
        parts.append(f"{variant} {ms:.3f} ms ({100 * bound / ms:.1f} % of "
                     f"{bound:.4f} ms, {bound_by})")
    log("timing", f"{name} at {what}, kernel per call: " + "; ".join(parts)
        + f"; on [{card}]")


def phase_timing(dev, card, out, z, err, times):
    """Each kernel against its plain version at the paths' shapes, then
    one call of each timed (the compared call warms up)."""
    import torch
    import torch.nn.functional as F
    from richdem_tpu_torch.ops import (accum, fill, flats, flowdirs, sweeps,
                                       terrain)

    big = sweeps.BIG
    # fill: a full rotation at 10240² from the main path's start (no
    # warm start given), and at the multigrid coarse grid (1280²)
    w0 = torch.full_like(z, big)
    fill_rotation(w0, z, 0.0, err, f"{MAIN}x{MAIN}")
    zc = F.max_pool2d(z[None, None], 8, 8)[0, 0].contiguous()
    fill_rotation(torch.full_like(zc, big), zc, 0.0, err,
                  f"{zc.shape[0]}x{zc.shape[1]} coarse grid")
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    fill_calls = (
        lambda: fill.fill_sweep(w0, z, 0.0, 0.0, False, flag),
        lambda: sweeps.fill_sweep_plain(w0, z, 0.0, 0.0, False, flag))

    # D8 on the main path's filled surface: kernel, plain and the main
    # path's own codes agree
    mask = torch.zeros_like(z, dtype=torch.bool)
    filled, fd = out["filled"], out["flowdirs"]
    d8_calls = (lambda: flowdirs.d8_core(filled, mask),
                lambda: flowdirs.d8_plain(filled, mask))
    dk, dp = d8_calls[0](), d8_calls[1]()
    bitwise("d8", ((dk, dp), (fd, dp)), err, f"{MAIN}x{MAIN}")

    # accumulation, unit weights: a down sweep on the main path's codes,
    # then a transposed up sweep on the permuted codes
    ones = torch.ones_like(z)
    accum_calls = (lambda: accum.accum_sweep(ones, ones, fd, False),
                   lambda: accum.accum_sweep_plain(ones, ones, fd, False))
    ak, ap = accum_calls[0](), accum_calls[1]()
    perm = torch.as_tensor(accum.PERM_TRANSPOSE, device=dev)
    fd_t = perm[fd.clamp(min=0).long()].t().contiguous()
    at = ak.t().contiguous()
    bitwise("accum_sweep",
            ((ak, ap), (accum.accum_sweep(at, ones, fd_t, True),
                        accum.accum_sweep_plain(at, ones, fd_t, True))),
            err, f"{MAIN}x{MAIN}, down and transposed up")
    # the topological pass over the same codes: the main path's own
    # accumulation, bitwise its plain version
    topo_calls = (lambda: accum.d8_topo(fd, ones)[0],
                  lambda: accum.d8_topo_plain(fd, ones)[0])
    bitwise("accum_topo", ((d8_topo_pair(fd, ones, err, f"{MAIN}x{MAIN}"),
                            out["accum"]),), err,
            f"{MAIN}x{MAIN}, the main path's accumulation")

    # distance sweeps on the main path's flat lakes, in the three modes
    # of flat resolution
    moved = dist_down_and_transposed_up(filled, fd, mask,
                                        ("towards", "away", "maxd"), err,
                                        f"{MAIN}x{MAIN}")
    ff = flats.flat_fields(filled, fd, mask)
    zed, fl = ff["zed"].contiguous(), ff["flags"].contiguous()
    wt0 = torch.where(ff["outlet"], 0.0, torch.tensor(big, device=dev))
    dist_calls = (
        lambda: flats.dist_sweep(wt0, zed, fl, "towards", 1.0, False, flag),
        lambda: sweeps.dist_sweep_plain(wt0, zed, fl, "towards", 1.0, False,
                                        flag))

    # terrain: all 8 attributes of the 10240² DEM
    terrain_attributes(z, mask, 1.0, 1.0, err, f"{MAIN}x{MAIN}")
    terrain_calls = (
        lambda: terrain.terrain_fused(z, mask, 1.0, 1.0, "slope_radians"),
        lambda: terrain.terrain_plain(z, mask, 1.0, 1.0, "slope_radians"))
    log("timing", f"every kernel against its plain version at {MAIN}x{MAIN}"
        f" (fill: a rotation, also at {zc.shape[0]}x{zc.shape[1]}; "
        f"accumulation: down and transposed up, and the topological pass; "
        f"distance: towards, away "
        f"and maxd, down and transposed up, against the plain sweep over "
        f"whole rows, cells lowered {moved}; "
        f"terrain: 8 attributes): bitwise, {'/'.join(ATAN)} within rtol "
        f"{ATAN_RTOL}")

    for name, (kern, plain) in (("fill_sweep", fill_calls),
                                ("d8", d8_calls),
                                ("accum_sweep", accum_calls),
                                ("accum_topo", topo_calls),
                                ("dist_sweep", dist_calls),
                                ("terrain", terrain_calls)):
        time_kernel(name, kern, plain, card, times, f"{MAIN}x{MAIN}")
    time_variants("terrain", {
        a: (lambda a=a: terrain.terrain_fused(z, mask, 1.0, 1.0, a),
            "terrain") for a in terrain.TERRAIN_ATTRIBUTES}, card,
        f"{MAIN}x{MAIN}, every attribute")


def phase_flow_timing(dev, card, c4, err, times):
    """The D∞ and multi-flow sweeps against their plain versions on the
    config-4 paths' own fields at 10240² (a down sweep and a transposed up
    sweep at the default depth), then one call of each timed; the
    multi-flow topological pass on the Quinn path's planes timed beside
    its plain version, then held bitwise to it and to the path's own
    accumulation."""
    import torch
    from richdem_tpu_torch.ops import dinf, mfd

    fields = flow_fields(c4["dinf_twi"]["angles"], c4["quinn_mfd"]["props"])
    depths = {"dinf_sweep": dinf.DINF_DEPTH, "mfd_sweep": mfd.MFD_DEPTH}
    ones = torch.ones((MAIN, MAIN), dtype=torch.float32, device=dev)
    for name, (field, field_t) in fields.items():
        depth, (kern, plain) = depths[name], flow_sweeps(name)
        flow_sweep_pair(name, ones, ones, field, field_t, depth, err,
                        f"{MAIN}x{MAIN}")
        time_kernel(name, lambda: kern(ones, ones, field, False, depth),
                    lambda: plain(ones, ones, field, False, depth), card,
                    times, f"{MAIN}x{MAIN}, depth {depth}, on the config-4 "
                    "path's field (bitwise to plain down and transposed up)")
    planes = fields["mfd_sweep"][0]
    ref, left_p = time_kernel(
        "mfd_topo", lambda: mfd.mfd_topo(planes, ones),
        lambda: mfd.mfd_topo_plain(planes, ones), card, times,
        f"{MAIN}x{MAIN}, on the config-4 path's Quinn planes")
    got, left = mfd.mfd_topo(planes, ones)
    if left or left_p:
        raise AssertionError(f"mfd_topo at {MAIN}x{MAIN}: {left} cells left "
                             f"by the kernel, {left_p} by the plain version")
    bitwise("mfd_topo", ((got, ref), (c4["quinn_mfd"]["accum"], got)), err,
            f"{MAIN}x{MAIN}, config 4's Quinn planes")
    log("timing", f"mfd_topo at {MAIN}x{MAIN} on config 4's Quinn planes: "
        "every cell solved, bitwise its plain version and the path's own "
        "accumulation")


def gauge_seeds(acc, k=GAUGES):
    """Mask of the ``k`` interior cells of largest accumulation, ties going
    to the lower flat index (the river gauges of a basin study)."""
    import torch

    inner = torch.full_like(acc, -1.0)
    inner[1:-1, 1:-1] = acc[1:-1, 1:-1]
    flat = inner.reshape(-1)
    kth = torch.topk(flat, k).values[-1]
    above = torch.nonzero(flat > kth).squeeze(1)
    tied = torch.nonzero(flat == kth).squeeze(1)[:k - above.numel()]
    seeds = torch.zeros_like(flat, dtype=torch.bool)
    seeds[torch.cat([above, tied])] = True
    return seeds.view(acc.shape)


def d8_methods_step(z, eps):
    """Basin delineation, contributing areas and stream network through the
    entry points: config 2's step, then watershed labels, Strahler order,
    D8 accumulation and the upslope cells of the GAUGES gauges."""
    import torch
    import richdem_tpu_torch as rt
    from richdem_tpu_torch.ops import accum

    _, _, resolved, fiters, frot = config2_step(z, eps)
    labels, lrot, lengine = rt.watersheds_from_flowdirs(resolved,
                                                        return_info=True)
    order, srot, _ = rt.strahler_order(resolved, return_info=True)
    acc, arot, adone = accum.d8_accumulation_info(resolved,
                                                  torch.ones_like(z))
    if not adone:
        raise AssertionError("d8_methods: accumulation not converged")
    gauges = gauge_seeds(acc)
    up, urot, uengine = rt.upslope_cells(gauges, resolved, return_info=True)
    return {"resolved": resolved, "labels": labels, "order": order,
            "accum": acc, "gauges": gauges, "upslope": up,
            "rotations": {"fill": fiters, "flats": frot, "watersheds": lrot,
                          "strahler": srot, "accum": arot, "upslope": urot},
            "engines": {"watersheds": lengine, "upslope": uengine}}


def rho8_step(z, eps):
    """pyrichdem's ``FlowAccumulation(method="Rho8")`` through the entry
    points: ε-fill, ``rho8_flowdirs(seed=0)``, D8 accumulation."""
    import torch
    import richdem_tpu_torch as rt
    from richdem_tpu_torch.ops import accum, fill

    filled, fiters, fdone = fill.fill_depressions_info(z, eps=eps,
                                                       max_iters=256)
    if not fdone:
        raise AssertionError(f"rho8 fill not converged ({fiters})")
    codes = rt.rho8_flowdirs(filled, seed=0)
    acc, arot, adone = accum.d8_accumulation_info(codes, torch.ones_like(z))
    if not adone:
        raise AssertionError("rho8: accumulation not converged")
    return {"filled": filled, "codes": codes, "accum": acc,
            "rotations": {"fill": fiters, "accum": arot}}


def strahler_defects(order, fd):
    """Cells whose order breaks Strahler's defining equation, written
    afresh from the codes: 0 on nodata; else, with m the largest order of
    the neighbours whose code points here and k the number at m, 1 if there
    is none, m + 1 if k >= 2, m otherwise."""
    import torch
    from richdem_tpu_torch import topology
    from richdem_tpu_torch.ops.stencil import neighbor

    fd = fd.to(torch.int32)
    m = torch.zeros_like(order)
    cnt = torch.zeros_like(order)
    inflows = []
    for d in range(1, 9):
        flows_in = neighbor(fd, d, -1) == int(topology.D8_INVERSE[d])
        inflows.append((d, flows_in))
        m = torch.maximum(m, torch.where(flows_in, neighbor(order, d, 0), 0))
    for d, flows_in in inflows:
        cnt += (flows_in & (neighbor(order, d, 0) == m) & (m > 0)).int()
    want = torch.where(m == 0, 1, torch.where(cnt >= 2, m + 1, m))
    want = torch.where(fd >= 0, want, 0)
    return int((order != want).sum())


def phase_d8_methods(dev, card, kernels, z):
    """The d8_methods path at MAIN² (:func:`d8_methods_step`), held to
    gates that do not run its kernels: pointer doubling for labels and
    upslope cells, the defining equation for Strahler order, and the Jacobi
    fixpoint at JACOBI_SHAPE."""
    import torch
    import richdem_tpu_torch as rt
    from richdem_tpu_torch import methods
    from richdem_tpu_torch import synth as tsynth
    from richdem_tpu_torch.ops import successor

    eps = rt.auto_epsilon(z)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out, launches = run_path(
        "d8_methods", kernels,
        ("fill_sweep", "d8", "dist_sweep", "accum_topo", "resolve_jump",
         "strahler_sweep"), lambda: d8_methods_step(z, eps))
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    fd, labels = out["resolved"], out["labels"]
    if not torch.equal(labels, methods.watersheds_doubling(fd)):
        raise AssertionError("watershed labels differ from pointer doubling")
    succ = successor.successor_table(fd)
    own = torch.arange(succ.numel(), device=dev)
    lab = labels.reshape(-1).long()
    terminal = succ == own
    if not (torch.equal(lab[terminal], own[terminal])
            and torch.equal(lab, lab[succ])):
        raise AssertionError("a label is not its terminal's index")
    del succ, own, lab
    if not torch.equal(out["upslope"],
                       methods.upslope_doubling(out["gauges"], fd)):
        raise AssertionError("upslope cells differ from pointer doubling")
    bad = strahler_defects(out["order"], fd)
    if bad:
        raise AssertionError(f"Strahler order breaks its equation at {bad} "
                             "cells")
    zj = tsynth.perlin_dem(*JACOBI_SHAPE, seed=0, device=dev)
    fdj = config2_step(zj, rt.auto_epsilon(zj))[2]
    oj, jiters, _ = methods.strahler_jacobi(fdj, max_iters=1 << 16,
                                            return_info=True)
    if not torch.equal(rt.strahler_order(fdj), oj):
        raise AssertionError("Strahler order differs from the Jacobi "
                             f"fixpoint at {JACOBI_SHAPE}")
    ev_secs, host_secs, last = timed_steps(d8_methods_step, z, eps)
    for key in ("labels", "order", "accum", "upslope"):
        if not torch.equal(last[key], out[key]):
            raise AssertionError(f"d8_methods {key} is not deterministic")
    n = MAIN * MAIN
    log("d8_methods", f"{MAIN}x{MAIN} Perlin seed 0, eps {eps!r}: "
        f"rotations {out['rotations']}; finished by {out['engines']}; "
        f"{int(terminal.sum())} basins, "
        f"largest Strahler order {int(out['order'].max())}, "
        f"{int(out['upslope'].sum())} cells upslope of {GAUGES} gauges; "
        f"labels and upslope bitwise equal to pointer doubling, Strahler "
        f"order meets its equation at every cell and equals the Jacobi "
        f"fixpoint at {JACOBI_SHAPE[0]}x{JACOBI_SHAPE[1]} ({jiters} "
        f"iterations); {STEPS} steps after one warm-up: {ev_secs} s (CUDA "
        f"events), {host_secs} s (host); best {n / min(ev_secs):.4e} "
        f"cells/s; peak allocated {peak_gib:.3f} GiB (warm-up step, DEM "
        f"included) on [{card}]; launches {launches}")
    return out, launches


def phase_rho8(dev, card, kernels, z):
    """The rho8 path at MAIN² (:func:`rho8_step`): sound codes, mass
    conserved exactly, deterministic."""
    import torch
    import richdem_tpu_torch as rt

    eps = rt.auto_epsilon(z)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out, launches = run_path("rho8", kernels,
                             ("fill_sweep", "rho8", "accum_topo"),
                             lambda: rho8_step(z, eps))
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    codes = out["codes"]
    check_codes("rho8", codes, torch.zeros_like(z, dtype=torch.bool))
    flowing = codes > 0
    diagonal = float(((codes % 2 == 0) & flowing).sum() / flowing.sum())
    mass, rel, above, largest = held_to_native(codes, out["accum"],
                                               "Rho8 codes")
    ev_secs, host_secs, last = timed_steps(rho8_step, z, eps)
    if not (torch.equal(last["codes"], codes)
            and torch.equal(last["accum"], out["accum"])):
        raise AssertionError("rho8 is not deterministic")
    n = MAIN * MAIN
    log("rho8", f"{MAIN}x{MAIN} Perlin seed 0, eps {eps!r}, Rho8 seed 0: "
        f"rotations {out['rotations']}; {diagonal:.4f} of the flowing cells "
        f"take a diagonal; native float64 accumulation of the codes "
        f"conserves mass exactly ({mass:.0f} of {n}), the port's float32 "
        f"accumulation equals it below 2**24 and is within {rel:.3e} "
        f"relative above ({above} cells, largest {largest:.0f}); {STEPS} "
        f"steps after one warm-up: {ev_secs} s (CUDA events), {host_secs} s "
        f"(host); best {n / min(ev_secs):.4e} cells/s; peak allocated "
        f"{peak_gib:.3f} GiB (warm-up step, DEM included) on [{card}]; "
        f"launches {launches}")
    return out, launches


def phase_methods_timing(dev, card, dm, r8, err, times):
    """The resolve, Strahler and Rho8 kernels against their plain versions
    on the new paths' own codes at MAIN² (a down and a transposed up sweep
    from each resolve's start and from order 1), the successor jump's
    labels and upslope mask against its plain version and the d8_methods
    path's own, then one call of each timed (the jump's: one of each
    walk)."""
    import torch
    from richdem_tpu_torch.ops import flowdirs, successor

    fd = dm["resolved"]
    calls = {}
    for what, fd_eff, init, pinned in resolve_starts(fd, dm["gauges"]):
        code = successor.pack_codes(fd_eff, pinned)
        succ_sweep_pair("resolve_sweep", init, code,
                        successor.transpose_codes(code), err,
                        f"{MAIN}x{MAIN}, {what}")
        calls.setdefault("resolve_sweep", (
            lambda v=init, c=code: successor.resolve_sweep(v, c, False),
            lambda v=init, c=code: successor.resolve_sweep_plain(v, c,
                                                                 False)))
    gauges = dm["gauges"]
    jl = jump_pair(fd, None, err, f"{MAIN}x{MAIN}, watersheds")
    ju = jump_pair(fd, gauges, err, f"{MAIN}x{MAIN}, upslope")
    bitwise("resolve_jump", ((jl, dm["labels"]), (ju, dm["upslope"])), err,
            f"{MAIN}x{MAIN}, the d8_methods path's own")
    del jl, ju
    calls["resolve_jump"] = (
        lambda: (successor.successor_jump(fd),
                 successor.successor_jump(fd, gauges)),
        lambda: (successor.successor_jump_plain(fd),
                 successor.successor_jump_plain(fd, gauges)))
    o0 = (fd >= 0).to(torch.int32)
    sc = fd.clamp(min=0).to(torch.int8)
    succ_sweep_pair("strahler_sweep", o0, sc, successor.transpose_codes(sc),
                    err, f"{MAIN}x{MAIN}")
    calls["strahler_sweep"] = (
        lambda: successor.strahler_sweep(o0, sc, False),
        lambda: successor.strahler_sweep_plain(o0, sc, False))
    filled = r8["filled"]
    nd = torch.zeros_like(filled, dtype=torch.bool)
    calls["rho8"] = (
        lambda: flowdirs.rho8_core(filled, nd, 1.0, 0),
        lambda: flowdirs.rho8_plain(filled, nd, 1.0, flowdirs.rho8_diagonal(
            filled.shape, 0, dev)))
    got, ref = calls["rho8"][0](), calls["rho8"][1]()
    bitwise("rho8", ((got, ref), (r8["codes"], ref)), err, f"{MAIN}x{MAIN}")
    log("timing", f"resolve (watersheds, upslope) and Strahler sweeps at "
        f"{MAIN}x{MAIN} on the d8_methods path's codes, down and transposed "
        f"up (against the plain sweeps over whole rows), the successor "
        f"jump's labels and upslope mask (against its plain version and the "
        f"path's own), and Rho8 codes on the rho8 path's surface: bitwise")
    for name, (kern, plain) in calls.items():
        time_kernel(name, kern, plain, card, times, f"{MAIN}x{MAIN}")
    time_variants("rho8", {
        "Rho8": (calls["rho8"][0], "rho8"),
        "Rho4": (lambda: flowdirs.rho8_core(filled, nd, 1.0, 0, "D4"),
                 "rho8_d4")}, card, f"{MAIN}x{MAIN}, the rho8 path's surface")
    # a reference point beside the resolve sweep, not a yardstick: pointer
    # doubling is another engine, and a fixpoint, not one sweep
    from richdem_tpu_torch import methods
    methods.watersheds_doubling(fd)
    ms = cuda_ms(lambda: methods.watersheds_doubling(fd), reps=3)
    log("timing", f"watersheds_doubling (pointer doubling, the whole "
        f"labelling) on the d8_methods codes at {MAIN}x{MAIN}: {ms:.3f} ms "
        f"per call on [{card}]; the tiles of the resolve sweep: "
        f"{SHAPES['resolve_sweep']}, of the Strahler sweep: "
        f"{SHAPES['strahler_sweep']}")


def api_step(rd):
    """The CLI ``twi`` verb's sequence through the pyrichdem names:
    ε-fill (auto ε), D8 accumulation, slope in radians, TWI."""
    import richdem_tpu_torch as rt

    filled = rt.FillDepressions(rd, epsilon=True)
    acc = rt.FlowAccumulation(filled, method="D8")
    slope = rt.TerrainAttribute(filled, attrib="slope_radians")
    return {"filled": filled, "accum": acc, "slope": slope,
            "twi": rt.TWI(acc, slope)}


def holed_dem(size, seed, dev):
    """A size² Perlin DEM with nodata holes, as a host array, and its
    mask on the card."""
    import torch
    from richdem_tpu_torch import synth as tsynth

    z = tsynth.perlin_dem(size, size, seed=seed, device=dev)
    mask = nodata_holes(z.shape, seed, dev)
    return torch.where(mask, ND, z).cpu().numpy(), mask


def phase_api(dev, card, kernels):
    """The api path at MAIN² under ``RICHDEM_TPU_FILL_ENGINE=scan`` (the
    variable restored after): :func:`api_step` on an ``rdarray`` of numpy,
    then the ε = 0 fill at MAIN² and the D4 fill at D4_SIZE², each bitwise
    the folded engine's; the fill rotations of both engines at the api
    path's ε and at ε = 0."""
    import torch
    import richdem_tpu_torch as rt
    from richdem_tpu_torch.ops import fill, flowdirs

    old = os.environ.get("RICHDEM_TPU_FILL_ENGINE")

    def engine(name):
        os.environ["RICHDEM_TPU_FILL_ENGINE"] = name

    def rotations(call):
        """``call()``'s result and its fill rotations, from the launch
        counts: (scan rotations of 2 sweeps, folded rotations of 4 on the
        coarse warm-start grid and the fine grid together)."""
        scan0, sweep0 = fill.FILL_SCAN.launches, fill.FILL_SWEEP.launches
        res = call()
        return res, ((fill.FILL_SCAN.launches - scan0) // 2,
                     (fill.FILL_SWEEP.launches - sweep0) // 4)

    try:
        engine("scan")
        dem, mask = holed_dem(MAIN, 0, dev)
        rd = rt.rdarray(dem, no_data=ND)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        out, launches = run_path(
            "api", kernels,
            ("fill_scan", "fill_sweep", "d8", "accum_topo", "terrain"),
            lambda: api_step(rd))
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        filled, acc = out["filled"].tensor(), out["accum"].tensor()
        data = ~mask
        n_data = int(data.sum())
        for key in ("filled", "accum", "slope", "twi"):
            x = out[key].tensor()
            if (tuple(x.shape) != (MAIN, MAIN) or x.device != dev
                    or not bool(torch.isfinite(x[data]).all())):
                raise AssertionError(f"api {key}: wrong shape, place or "
                                     "non-finite values")
        z = torch.from_numpy(dem).to(dev)
        if not (bool((filled >= z).all())
                and torch.equal(filled[mask], z[mask])):
            raise AssertionError("api: filled surface below the DEM or "
                                 "nodata changed")
        fd = flowdirs.d8_flowdirs(filled, no_data=ND)
        mass = float(acc[(fd == 0) & data].double().sum())
        if not abs(mass - n_data) <= 1e-6 * n_data:
            raise AssertionError(f"api: mass not conserved: {mass} vs "
                                 f"{n_data}")
        history = out["twi"].metadata["PROCESSING_HISTORY"]
        calls = [line.split(" | ")[-1] for line in history.splitlines()]
        if calls != ["FillDepressions(dem, epsilon=True, topology='D8')",
                     "FlowAccumulation(dem, method='D8', exponent=None)",
                     "TWI(accum, slope)"]:
            raise AssertionError(f"api: PROCESSING_HISTORY {calls}")
        del fd, z
        ev_secs, host_secs, last = timed_steps(api_step, rd)
        if not torch.equal(last["twi"].tensor(), out["twi"].tensor()):
            raise AssertionError("api is not deterministic")
        del last
        scan0, rot_s0 = rotations(lambda: rt.FillDepressions(rd).tensor())
        engine("folded")
        folded0, rot_f0 = rotations(lambda: rt.FillDepressions(rd).tensor())
        if not torch.equal(scan0, folded0):
            raise AssertionError(f"api: the scan engine's eps=0 fill at "
                                 f"{MAIN}x{MAIN} differs from the folded "
                                 "engine's")
        del scan0, folded0
        _, rot_f = rotations(lambda: rt.FillDepressions(rd, epsilon=True))
        coarse = launches["fill_sweep"] // 4
        scan_rot = launches["fill_scan"] // 2
        fills = (f"fill rotations at the api eps: scan {scan_rot} of 2 "
                 f"sweeps, folded {rot_f[1] - coarse} of 4; at eps 0: scan "
                 f"{rot_s0[0]}, folded {rot_f0[1] - rot_s0[1]}; each after "
                 f"the multigrid warm start's {coarse} and {rot_s0[1]} "
                 "folded rotations on the coarse grid")
        dem4, _ = holed_dem(D4_SIZE, 4, dev)
        rd4 = rt.rdarray(dem4, no_data=ND)
        folded4 = rt.FillDepressions(rd4, topology="D4").tensor()
        engine("scan")
        if not torch.equal(rt.FillDepressions(rd4, topology="D4").tensor(),
                           folded4):
            raise AssertionError(f"api: the scan engine's D4 fill at "
                                 f"{D4_SIZE}x{D4_SIZE} differs from the "
                                 "folded engine's")
    finally:
        if old is None:
            os.environ.pop("RICHDEM_TPU_FILL_ENGINE", None)
        else:
            os.environ["RICHDEM_TPU_FILL_ENGINE"] = old
    n = MAIN * MAIN
    eps = rt.auto_epsilon(torch.from_numpy(dem))
    log("api", f"{MAIN}x{MAIN} Perlin seed 0 with nodata holes ({n - n_data}"
        f" cells), an rdarray of numpy, RICHDEM_TPU_FILL_ENGINE=scan: "
        f"FillDepressions(epsilon=True) (auto eps {eps!r}), "
        f"FlowAccumulation D8, TerrainAttribute slope_radians, TWI; {fills}; "
        f"{STEPS} steps after one warm-up: "
        f"{ev_secs} s (CUDA events), {host_secs} s (host); best "
        f"{n / min(ev_secs):.4e} cells/s; peak allocated {peak_gib:.3f} GiB "
        f"(warm-up step) on [{card}]; mass {mass:.1f} of {n_data} data "
        f"cells; history {calls}; eps=0 fill at {MAIN}x{MAIN} and D4 fill at "
        f"{D4_SIZE}x{D4_SIZE} bitwise the folded engine's; launches "
        f"{launches}")
    return launches, dem, mask, eps


def phase_scan_timing(dev, card, dem, mask, eps, err, times):
    """The scan sweep down on the api DEM at the api path's ε, from the
    fill's start, against its plain version at MAIN² (the timed plain call
    is the one compared), then timed beside its bound."""
    import torch
    from richdem_tpu_torch.ops import fill, sweeps

    z = torch.from_numpy(dem).to(dev)
    neg = torch.tensor(-sweeps.BIG, device=dev)
    floor = torch.where(mask, neg, z).contiguous()
    w0 = torch.where(mask, neg, torch.full_like(z, sweeps.BIG)).contiguous()
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    eps = float(np.float32(eps))
    got = fill.fill_scan_sweep(w0, floor, eps, eps, False, flag)
    ref = time_kernel(
        "fill_scan", lambda: fill.fill_scan_sweep(w0, floor, eps, eps, False,
                                                  flag),
        lambda: sweeps.fill_scan_sweep_plain(w0, floor, eps, eps, False,
                                             flag),
        card, times, f"{MAIN}x{MAIN}, the api DEM at eps {eps!r}")
    bitwise("fill_scan", ((got, ref),), err,
            f"{MAIN}x{MAIN}, the api DEM, down")
    log("timing", f"scan fill sweep at {MAIN}x{MAIN} down on the api DEM: "
        f"bitwise to plain; its cluster: {SHAPES['fill_scan']}")


def block_kernels(names, z, m, eps, err, card, times, phase, what):
    """Kernels ``names`` on one block ``z`` (mask ``m``) as the two-pass
    consumers and the sharded ops call them: each against its plain
    version (bitwise; terrain's atan to ATAN_RTOL), then one call of each
    timed beside its bound at that shape (``times[name]``; the jump's
    call: one of each walk, the upslope mask of the NO_FLOW cells)."""
    import torch
    from richdem_tpu_torch.ops import (accum, fill, flats, flowdirs, mfd,
                                       successor, sweeps, terrain)

    h, w = z.shape
    dev = z.device
    neg = torch.tensor(-sweeps.BIG, device=dev)
    floor = torch.where(m, neg, z).contiguous()
    w0 = torch.where(m, neg, torch.full_like(z, sweeps.BIG)).contiguous()
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    filled = fill.fill_depressions_info(z, m)[0]
    fd = flowdirs.d8_core(filled, m)
    ff = flats.flat_fields(filled, fd, m)
    zed, fl = ff["zed"].contiguous(), ff["flags"].contiguous()
    big = torch.tensor(sweeps.BIG, device=dev)
    wt0 = torch.where(ff["outlet"], 0.0, big).contiguous()
    seeds = fd == 0
    ones = torch.where(fd < 0, 0.0, torch.ones_like(z)).contiguous()
    calls = {
        "fill_sweep": (
            lambda: fill.fill_sweep(w0, floor, eps, eps, False, flag),
            lambda: sweeps.fill_sweep_plain(w0, floor, eps, eps, False,
                                            flag)),
        "d8": (lambda: flowdirs.d8_core(filled, m),
               lambda: flowdirs.d8_plain(filled, m)),
        "dist_sweep": (
            lambda: flats.dist_sweep(wt0, zed, fl, "towards", 1.0, False,
                                     flag),
            lambda: sweeps.dist_sweep_plain(wt0, zed, fl, "towards", 1.0,
                                            False, flag)),
        "resolve_jump": (
            lambda: (successor.successor_jump(fd),
                     successor.successor_jump(fd, seeds)),
            lambda: (successor.successor_jump_plain(fd),
                     successor.successor_jump_plain(fd, seeds))),
        "accum_sweep": (
            lambda: accum.accum_sweep(ones, ones, fd, False),
            lambda: accum.accum_sweep_plain(ones, ones, fd, False)),
        "accum_topo": (lambda: accum.d8_topo(fd, ones)[0],
                       lambda: accum.d8_topo_plain(fd, ones)[0]),
        "terrain": (
            lambda: terrain.terrain_fused(filled, m, 1.0, 1.0,
                                          "slope_radians"),
            lambda: terrain.terrain_plain(filled, m, 1.0, 1.0,
                                          "slope_radians")),
    }
    if "mfd_sweep" in names:
        planes = flowdirs.flow_proportions(filled, "Quinn").permute(
            2, 0, 1).contiguous()
        calls["mfd_sweep"] = (
            lambda: mfd.mfd_sweep(ones, ones, planes, False, mfd.MFD_DEPTH),
            lambda: mfd.mfd_sweep_plain(ones, ones, planes, False,
                                        mfd.MFD_DEPTH))
    parts = []
    for name in names:
        kern, plain = calls[name]
        got = kern()
        ms = cuda_ms(kern, reps=5)
        out = {}
        plain_ms = cuda_ms(lambda: out.setdefault("plain", plain()))
        pairs = (tuple(zip(got, out["plain"])) if isinstance(got, tuple)
                 else ((got, out["plain"]),))
        bitwise(name, pairs, err, f"{h}x{w} {what}",
                rtol=ATAN_RTOL if name == "terrain" else 0.0)
        bound, bound_by = bound_ms(name, h * w)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by=bound_by)
        parts.append(f"{name} {ms:.4f} ms (plain {plain_ms:.2f} ms; bound "
                     f"{bound:.5f} ms, {bound_by}, {100 * bound / ms:.1f} "
                     "%)")
    log(phase, f"the path's kernels on a {h}x{w} {what}, each against its "
        f"plain version, one call each: " + "; ".join(parts)
        + f"; on [{card}]")


def phase_twopass(dev, card, kernels, err):
    """The [P1]/[P2] out-of-core programs on disk-resident rasters in a
    temporary directory: the MAIN² fill (TWOPASS_TILE tiles, device
    consumer, tiles not cached) bitwise the in-core fill, D8 accumulation
    of its codes against the in-core accumulation, each in exactly two
    data passes; the native consumer bitwise the device consumer at
    TWOPASS_CHECK; the ε Schwarz fill bitwise the in-core folded ε-fill
    from BIG at SCHWARZ, and bitwise the multigrid-started ε-fill; the
    card's peak at MAIN² within MEMORY_SHARE of the peak at
    SCHWARZ[0]².  Returns the launch counts of each program and the
    kernels' times at the tile width."""
    import tempfile

    import torch
    from richdem_tpu_torch import debug
    from richdem_tpu_torch.ops import accum, fill, flowdirs, sweeps
    from richdem_tpu_torch.parallel.outofcore import (out_of_core_accum_d8,
                                                      out_of_core_fill)

    def peak_run(name, needed, call):
        """``call()`` as a path (launch counts from 0), with the card's
        peak above what was allocated before it, in bytes."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        out, launches = run_path(name, kernels, needed, call)
        secs = time.perf_counter() - t0
        return out, launches, secs, torch.cuda.max_memory_allocated(dev) - base

    def held(name, got, want, what):
        if not np.array_equal(got, want):
            diff = np.abs(got.astype(np.float64) - want).max()
            raise AssertionError(f"twopass {name}: {what} differs from the "
                                 f"in-core result (max |diff| {diff})")

    tile = TWOPASS_TILE
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        dem, mask = holed_dem(MAIN, 0, dev)
        np.save(path("dem.npy"), dem)
        t = TWOPASS_TILE
        block_kernels(TWOPASS_KERNELS,
                      torch.from_numpy(np.ascontiguousarray(
                          dem[:t, :t])).to(dev), mask[:t, :t].contiguous(),
                      0.0, err, card, times, "twopass", "two-pass tile")
        z = torch.from_numpy(dem).to(dev)
        want = fill.fill_depressions(z, no_data=ND).cpu().numpy()
        del z
        timer, stats = debug.PhaseTimer(), {}
        _, fill_launches, fill_s, fill_peak = peak_run(
            "twopass_fill", ("fill_sweep", "d8", "dist_sweep",
                             "resolve_jump"),
            lambda: out_of_core_fill(
                path("dem.npy"), path("filled.npy"), tile=tile,
                method="twopass", consumer="device", no_data=ND,
                stats=stats, cache_tiles=False, device=dev, timer=timer))
        got = np.load(path("filled.npy"))
        if stats["data_passes"] != 2 or stats["consumer"] != "device":
            raise AssertionError(f"twopass fill: {stats}")
        held("fill", got, want, f"the {MAIN}x{MAIN} fill")
        fill_parts = dict(timer.times)

        # D8 codes of that fill, and their in-core accumulation
        fd = flowdirs.d8_flowdirs(torch.from_numpy(got).to(dev), no_data=ND)
        np.save(path("fd.npy"), fd.cpu().numpy())
        wts = torch.where(fd < 0, 0.0, 1.0)
        acc_want = accum.d8_accumulation(fd, weights=wts).cpu().numpy()
        del fd, wts, got, want
        timer2, stats2 = debug.PhaseTimer(), {}
        _, acc_launches, acc_s, _ = peak_run(
            "twopass_accum", ("accum_topo", "resolve_jump"),
            lambda: out_of_core_accum_d8(
                path("fd.npy"), out_path=path("acc.npy"), tile=tile,
                method="twopass", stats=stats2, device=dev, timer=timer2))
        acc = np.load(path("acc.npy"))
        if stats2["data_passes"] != 2:
            raise AssertionError(f"twopass accumulation: {stats2}")
        n_big, rel = held_accumulation(
            torch.from_numpy(acc), torch.from_numpy(acc_want),
            f"twopass {MAIN}x{MAIN}")
        acc_max = float(acc_want.max())
        del acc, acc_want

        # the native consumer against the device consumer
        edge, ctile = TWOPASS_CHECK
        small, _ = holed_dem(edge, 2, dev)
        np.save(path("small.npy"), small)
        outs = {}
        for consumer in ("device", "native"):
            st = {}
            outs[consumer] = np.load(out_of_core_fill(
                path("small.npy"), path(f"small_{consumer}.npy"),
                tile=ctile, method="twopass", consumer=consumer,
                no_data=ND, stats=st, device=dev))
            if st["data_passes"] != 2:
                raise AssertionError(f"twopass {consumer} consumer: {st}")
        if not np.array_equal(outs["native"], outs["device"]):
            raise AssertionError("twopass: the native consumer's fill "
                                 "differs from the device consumer's")

        # the ε Schwarz fill, and the peak at SCHWARZ[0]² for the memory
        # check
        edge, stile, eps = SCHWARZ
        mid, _ = holed_dem(edge, 1, dev)
        np.save(path("mid.npy"), mid)
        st = {}
        t0 = time.perf_counter()
        sch = np.load(out_of_core_fill(
            path("mid.npy"), path("mid_eps.npy"), tile=stile, eps=eps,
            method="schwarz", no_data=ND, stats=st, device=dev))
        sch_s = time.perf_counter() - t0
        zm = torch.from_numpy(mid).to(dev)
        sch_want, _, done = fill.fill_depressions_info(
            zm, zm == ND, eps=eps, w0=torch.full_like(zm, sweeps.BIG),
            engine="folded")
        if not done:
            raise AssertionError("twopass: the in-core eps-fill from BIG "
                                 "did not converge")
        held("schwarz", sch, sch_want.cpu().numpy(),
             f"the {edge}x{edge} eps={eps} Schwarz fill")
        warm = fill.fill_epsilon(zm, no_data=ND, eps=eps,
                                 engine="folded").cpu().numpy()
        below = int((warm < sch).sum())
        warm_diff = float(np.abs(warm.astype(np.float64) - sch).max())
        if below or warm_diff != 0.0:
            raise AssertionError(f"twopass: the in-core eps-fill from the "
                                 f"multigrid start is off the Schwarz fill "
                                 f"by {warm_diff} ({below} cells below)")
        del zm, sch_want, warm
        _, _, _, mid_peak = peak_run(
            "twopass_memory", (), lambda: out_of_core_fill(
                path("mid.npy"), path("mid_filled.npy"), tile=tile,
                method="twopass", consumer="device", no_data=ND,
                cache_tiles=False, device=dev))
    if not fill_peak <= (1 + MEMORY_SHARE) * mid_peak:
        raise AssertionError(f"twopass: peak {fill_peak} B at {MAIN}^2 "
                             f"against {mid_peak} B at {edge}^2")
    path_kernels = {k: fill_launches[k] + acc_launches[k]
                    for k in TWOPASS_KERNELS}
    log("twopass", f"{MAIN}x{MAIN} Perlin seed 0 with nodata holes, "
        f"tile {tile}, device consumer, tiles not cached: fill {fill_s:.3f} "
        f"s ({stats['n_labels']} labels, {stats['n_edges']} edges, "
        f"{stats['data_passes']} data passes, {stats['tile_loads']} tile "
        f"loads), by phase {fill_parts} (disk and copies inside the "
        f"passes), bitwise the in-core fill; launches {fill_launches}")
    log("twopass", f"D8 accumulation of its codes: {acc_s:.3f} s "
        f"({stats2['n_exits']} exits, {stats2['data_passes']} data "
        f"passes), by phase {dict(timer2.times)}; bitwise the in-core "
        f"accumulation below 2^24, {n_big} cells above it (max "
        f"{acc_max:.0f}) within rtol {rel:.3e} (gate "
        f"{TWOPASS_ACC_RTOL}); launches {acc_launches}")
    log("twopass", f"native consumer bitwise the device consumer at "
        f"{TWOPASS_CHECK[0]}^2, tile {TWOPASS_CHECK[1]}; eps={eps} Schwarz "
        f"fill at {edge}^2, tile {stile}: {st['data_passes']} passes in "
        f"{sch_s:.3f} s, bitwise the in-core folded eps-fill from BIG and "
        f"the in-core fill_epsilon from its multigrid start ({below} cells "
        f"below, max |diff| {warm_diff!r}); peak "
        f"allocated above the start {fill_peak / 2**20:.1f} MiB at "
        f"{MAIN}^2 against {mid_peak / 2**20:.1f} MiB at {edge}^2 (tile "
        f"{tile}, not cached; gate {100 * MEMORY_SHARE:.0f} %); the path's "
        f"launches by kernel {path_kernels}; on [{card}]")
    return {"twopass_fill": fill_launches,
            "twopass_accum": acc_launches}, times


def same(a, b):
    """Bitwise equal, NaN where the other has NaN."""
    import torch

    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan], b[~nan]))


def dryrun_multichip(n_devices):
    """Shard the full pipeline over an ``n_devices``-position mesh, every
    position on the card, and run one step on an uneven depression DEM,
    so that the pad-and-crop path runs (the counterpart of
    ``__graft_entry__.dryrun_multichip``): the right shape, a non-empty
    accumulation, and every output bitwise the in-core ops.  Returns the
    shape."""
    import torch
    from richdem_tpu_torch import synth_np
    from richdem_tpu_torch.ops import accum, fill, flowdirs, sweeps, terrain
    from richdem_tpu_torch.parallel import make_mesh, sharded_pipeline
    from richdem_tpu_torch.parallel.mesh import best_factorization

    dev = torch.device("cuda", 0)
    ny, nx = best_factorization(n_devices)
    mesh = make_mesh([dev] * n_devices, (ny, nx))
    h = max(512, 128 * ny) - 3
    w = max(1024, 128 * nx) - 5
    dem = torch.from_numpy(synth_np.depression_dem(h, w, seed=7)).to(dev)
    out = sharded_pipeline(dem, mesh=mesh, eps=1e-3)
    torch.cuda.synchronize()
    if tuple(out["accum"].shape) != (h, w) or not float(out["accum"].sum()):
        raise AssertionError("dryrun: wrong shape or empty accumulation")
    filled, _, done = fill.fill_depressions_info(
        dem, eps=1e-3, w0=torch.full_like(dem, sweeps.BIG))
    mask = torch.zeros_like(dem, dtype=torch.bool)
    fd = flowdirs.d8_core(filled, mask)
    want = {"filled": filled, "flowdirs": fd,
            "accum": accum.d8_accumulation(fd),
            "slope": terrain.terrain_fused(filled, mask, 1.0, 1.0,
                                           "slope_radians")}
    bad = [k for k in want if not same(out[k], want[k])]
    if not done or bad:
        raise AssertionError(f"dryrun: {bad} differ from the in-core ops")
    return h, w


def sharded_gates(out, z, eps, what):
    """The sharded pipeline's outputs against the in-core ops on ``z``: the
    fill bitwise the fill from BIG and ``fill_epsilon`` (its multigrid
    start), codes and slope bitwise, the accumulation bitwise below 2²⁴
    and within TWOPASS_ACC_RTOL above.  Returns (rotations from BIG,
    cells at or above 2²⁴, their largest relative difference)."""
    import torch
    from richdem_tpu_torch.ops import accum, fill, flowdirs, sweeps, terrain

    want, big_iters, done = fill.fill_depressions_info(
        z, eps=eps, w0=torch.full_like(z, sweeps.BIG))
    if not (done and torch.equal(out["filled"], want)):
        raise AssertionError(f"sharded {what}: the fill differs from the "
                             f"fill from BIG ({max_abs(out['filled'], want)})")
    if not torch.equal(fill.fill_epsilon(z, eps=eps), want):
        raise AssertionError(f"sharded {what}: fill_epsilon differs from "
                             "the fill from BIG")
    mask = torch.zeros_like(z, dtype=torch.bool)
    fd = flowdirs.d8_core(want, mask)
    if not torch.equal(out["flowdirs"], fd):
        raise AssertionError(f"sharded {what}: D8 codes differ")
    if not same(out["slope"], terrain.terrain_fused(
            want, mask, 1.0, 1.0, "slope_radians")):
        raise AssertionError(f"sharded {what}: slope differs")
    acc = accum.d8_accumulation(fd)
    del want, fd
    return (big_iters,) + held_accumulation(out["accum"], acc,
                                            f"sharded {what}")


def held_accumulation(got, want, what):
    """``got`` bitwise ``want`` below 2²⁴, within TWOPASS_ACC_RTOL above;
    returns (cells above, their largest relative difference)."""
    import torch

    exact = want < 2.0 ** 24
    if not torch.equal(got[exact], want[exact]):
        raise AssertionError(f"{what}: accumulation differs below 2^24 "
                             f"({max_abs(got[exact], want[exact])})")
    above = ~exact
    rel = 0.0
    if bool(above.any()):
        rel = float(((got[above].double() - want[above].double()).abs()
                     / want[above].double()).max())
        if not rel <= TWOPASS_ACC_RTOL:
            raise AssertionError(f"{what}: accumulation off by {rel} "
                                 "relative above 2^24")
    return int(above.sum()), rel


def phase_sharded(dev, card, kernels, err, main_best):
    """The sharded mesh on one card: a 2×2 mesh whose four positions are
    all ``cuda:0``.  ``sharded_pipeline`` (ε = SHARDED_EPS) of the MAIN²
    Perlin DEM (seed 0) held to the in-core ops (``sharded_gates``) and
    timed; the two-pass fill and accumulation on the same mesh, two data
    passes each, bitwise the Schwarz fill at ε = 0 and the Schwarz
    accumulation (below 2²⁴; TWOPASS_ACC_RTOL above); Quinn accumulation
    at SHARDED_MFD_EDGE² within rtol 2e-5, atol 1e-4 of the in-core
    accumulation (the topological pass) and of the in-core sweeps (the
    solve each shard runs), mass conserved within 1e-5; the uneven dryrun; the pipeline through a
    one-rank NCCL group at SHARDED_NCCL_EDGE² bitwise the in-process mesh;
    then the seven kernels at their path's shapes against their plain
    versions and timed.  Returns the launches of each sharded path, the
    kernels' times and the shapes they were timed at."""
    import socket

    import torch
    import torch.distributed as dist
    from richdem_tpu_torch import synth as tsynth
    from richdem_tpu_torch.ops import accum, fill, flowdirs, mfd
    from richdem_tpu_torch.parallel import (make_mesh,
                                            sharded_accumulation_d8_twopass,
                                            sharded_accumulation_mfd,
                                            sharded_fill,
                                            sharded_fill_twopass,
                                            sharded_pipeline)

    mesh = make_mesh([dev] * (SHARDED_MESH[0] * SHARDED_MESH[1]),
                     SHARDED_MESH)
    z = tsynth.perlin_dem(MAIN, MAIN, seed=0, device=dev)
    eps = SHARDED_EPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    stats = {}
    t0 = time.perf_counter()
    out, launches = run_path(
        "sharded", kernels, ("fill_sweep", "d8", "accum_topo", "terrain"),
        lambda: sharded_pipeline(z, mesh=mesh, eps=eps, stats=stats))
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    big_iters, n_big, rel = sharded_gates(out, z, eps, "pipeline")
    ev_secs, host_secs, last = timed_steps(
        lambda: sharded_pipeline(z, mesh=mesh, eps=eps))
    if not all(same(last[k], out[k]) for k in out):
        raise AssertionError("sharded pipeline is not deterministic")
    del last
    n = MAIN * MAIN
    log("sharded", f"{MAIN}x{MAIN} Perlin seed 0 over a {SHARDED_MESH} "
        f"mesh on one card, eps={eps}: fill {stats['fill_outer_iters']} "
        f"outer iterations ({stats['fill_rotations']} local rotations), "
        f"accumulation {stats['accum_outer_iters']} outer iterations "
        f"({stats['accum_rotations']} local rotations); the fill bitwise "
        f"the in-core fill from BIG ({big_iters} rotations) and "
        f"fill_epsilon, codes and slope bitwise, the accumulation bitwise "
        f"below 2^24 ({n_big} cells above, within rtol {rel:.3e}); first "
        f"step {first_s:.3f} s; {STEPS} steps after it: {ev_secs} s (CUDA "
        f"events), {host_secs} s (host); best {min(ev_secs):.4f} s "
        f"({n / min(ev_secs):.4e} cells/s) beside the in-core main path's "
        f"{main_best:.4f} s (eps=0, with_twi); peak allocated above the "
        f"DEM {peak / 2**30:.3f} GiB; launches {launches}; on [{card}]")

    # the two-pass pair on the same mesh
    st_f, st_a = {}, {}
    t0 = time.perf_counter()
    (two, acc2), tp_launches = run_path(
        "sharded_twopass", kernels,
        ("fill_sweep", "d8", "dist_sweep", "resolve_jump", "accum_topo"),
        lambda: (sharded_fill_twopass(z, mesh=mesh, stats=st_f),
                 sharded_accumulation_d8_twopass(out["flowdirs"], mesh=mesh,
                                                 stats=st_a)))
    tp_s = time.perf_counter() - t0
    if st_f["data_passes"] != 2 or st_a["data_passes"] != 2:
        raise AssertionError(f"sharded two-pass: {st_f}, {st_a}")
    st0 = {}
    schwarz0 = sharded_fill(z, mesh=mesh, eps=0.0, stats=st0)
    if not (torch.equal(two, schwarz0)
            and torch.equal(schwarz0, fill.fill_depressions(z))):
        raise AssertionError("sharded two-pass fill differs from the "
                             "Schwarz fill at eps=0 or the in-core fill")
    tp_big, tp_rel = held_accumulation(acc2, out["accum"],
                                       "sharded two-pass")
    del two, acc2, schwarz0, out
    log("sharded", f"two-pass pair on the mesh: {tp_s:.3f} s, "
        f"{st_f['data_passes']} + {st_a['data_passes']} data passes "
        f"({st_f['n_labels']} labels, {st_a['n_exits']} exits); the fill "
        f"bitwise the Schwarz fill at eps=0 ({st0['fill_outer_iters']} "
        f"outer iterations) and the in-core fill, the accumulation bitwise "
        f"the Schwarz accumulation below 2^24 ({tp_big} cells above, "
        f"within rtol {tp_rel:.3e}); launches {tp_launches}")

    # multi-flow accumulation
    edge = SHARDED_MFD_EDGE
    zq = z[:edge, :edge].contiguous()
    props = flowdirs.flow_proportions(fill.fill_depressions(zq, eps=1e-2),
                                      "Quinn")
    del zq
    mst = {}
    t0 = time.perf_counter()
    got, mfd_launches = run_path(
        "sharded_mfd", kernels, ("mfd_sweep",),
        lambda: sharded_accumulation_mfd(props, mesh=mesh, stats=mst))
    mfd_s = time.perf_counter() - t0
    want = accum.flow_accumulation_from_props(props)
    sweeps, srot, sdone = mfd.mfd_accumulation_info(
        props.permute(2, 0, 1), torch.ones((edge, edge), device=dev))
    for what, ref in (("accumulation", want), ("sweeps", sweeps)):
        if not torch.allclose(got, ref, rtol=2e-5, atol=1e-4):
            raise AssertionError(f"sharded Quinn accumulation off the "
                                 f"in-core {what} ({max_abs(got, ref)})")
    if not sdone:
        raise AssertionError(f"in-core Quinn sweeps not converged ({srot})")
    mass = absorbed_mass(got, props)
    if not abs(mass - edge * edge) <= 1e-5 * edge * edge:
        raise AssertionError(f"sharded Quinn mass {mass} of {edge ** 2}")

    def rel(a, b):  # every cell holds at least its own unit weight
        return float(((a.double() - b.double()).abs() / b.double()).max())

    log("sharded", f"Quinn accumulation at {edge}x{edge} on the mesh: "
        f"{mfd_s:.3f} s, {mst['mfd_outer_iters']} outer iterations "
        f"({mst['mfd_rotations']} local rotations); within rtol 2e-5, atol "
        f"1e-4 of the in-core accumulation, the topological pass (max "
        f"|diff| {max_abs(got, want)}, max rel {rel(got, want):.3e}), and "
        f"of the in-core sweeps ({srot} rotations; max rel "
        f"{rel(got, sweeps):.3e}; the pass is {rel(want, sweeps):.3e} "
        f"from them); mass {mass!r} of {edge * edge}; launches "
        f"{mfd_launches}")
    del got, want, sweeps, props

    shape = dryrun_multichip(4)
    log("sharded", f"dryrun_multichip(4): {shape} depression DEM over a "
        "2x2 mesh, padded and cropped, bitwise the in-core ops")

    # one rank of NCCL: every halo and flag through collectives
    zs = z[:SHARDED_NCCL_EDGE, :SHARDED_NCCL_EDGE].contiguous()
    local = sharded_pipeline(zs, mesh=mesh, eps=eps)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    store = dist.TCPStore("localhost", port, 1, True)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        gmesh = make_mesh([dev] * len(mesh.local_positions), SHARDED_MESH)
        if gmesh.group is None:
            raise AssertionError("the NCCL mesh has no group")
        t0 = time.perf_counter()
        coll = sharded_pipeline(zs, mesh=gmesh, eps=eps)
        torch.cuda.synchronize()
        nccl_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    del store
    bad = [k for k in local if not same(coll[k], local[k])]
    if bad:
        raise AssertionError(f"sharded NCCL run: {bad} differ from the "
                             "in-process mesh")
    log("sharded", f"one-rank NCCL group at {SHARDED_NCCL_EDGE}^2: "
        f"{nccl_s:.3f} s, bitwise the in-process mesh")
    del zs, local, coll

    # the kernels at the shape their path gives them: the Schwarz fill and
    # the stencils an extended block (a shard and its 1-cell ring), the
    # local accumulation solves and the two-pass consumers a shard, at the
    # edge their path ran at
    times, blocks = {}, {}
    ny, nx = SHARDED_MESH
    for names, e, ring, what in (
            (("fill_sweep", "d8", "terrain"), MAIN, 2, "extended block"),
            (("accum_topo", "dist_sweep", "resolve_jump"), MAIN, 0,
             "shard"),
            (("mfd_sweep",), edge, 0, "shard")):
        bh, bw = e // ny + ring, e // nx + ring
        block_kernels(names, z[:bh, :bw].contiguous(),
                      torch.zeros((bh, bw), dtype=torch.bool, device=dev),
                      eps, err, card, times, "sharded", what)
        blocks.update({n: [bh, bw] for n in names})
    return {"sharded": launches, "sharded_twopass": tp_launches,
            "sharded_mfd": mfd_launches}, times, blocks


def main():
    t0 = time.perf_counter()
    card = phase_device()
    import torch
    from richdem_tpu_torch.ops import (accum, dinf, fill, flats, flowdirs,
                                       mfd, successor, terrain)

    dev = torch.device("cuda", 0)
    kernels = [fill.FILL_SWEEP, flowdirs.D8, accum.ACCUM_SWEEP,
               accum.ACCUM_TOPO, flats.DIST_SWEEP, terrain.TERRAIN, dinf.DINF_SWEEP,
               mfd.MFD_SWEEP, mfd.MFD_TOPO, flowdirs.RHO8,
               successor.RESOLVE_SWEEP, successor.RESOLVE_JUMP,
               successor.STRAHLER_SWEEP,
               fill.FILL_SCAN]
    phase_build(kernels)
    err = {kname(k): 0.0 for k in kernels}
    phase_kernel_vs_plain(dev, err)
    phase_scan_vs_plain(dev, err)
    phase_native(dev)
    phase_native_flow(dev)
    phase_serpentine(dev, card)
    out, launches, z, main_best = phase_main(dev, card, kernels)
    phase_flats_full(out, err)
    path_launches = {"main": launches,
                     "config2": phase_config2(dev, card, kernels),
                     "terrain": phase_terrain(dev, card, z, kernels)}
    c4, c4_launches = phase_config4(dev, card, kernels, z)
    path_launches.update(c4_launches)
    times = {}
    phase_timing(dev, card, out, z, err, times)
    del out
    phase_flow_timing(dev, card, c4, err, times)
    del c4
    dm, path_launches["d8_methods"] = phase_d8_methods(dev, card, kernels, z)
    # what timing reads
    dm = {k: dm[k] for k in ("resolved", "gauges", "labels", "upslope")}
    r8, path_launches["rho8"] = phase_rho8(dev, card, kernels, z)
    phase_methods_timing(dev, card, dm, r8, err, times)
    del dm, r8, z
    path_launches["api"], dem, mask, eps = phase_api(dev, card, kernels)
    phase_scan_timing(dev, card, dem, mask, eps, err, times)
    del dem, mask
    twopass_launches, twopass_times = phase_twopass(dev, card, kernels, err)
    path_launches.update(twopass_launches)
    sharded_launches, sharded_times, blocks = phase_sharded(
        dev, card, kernels, err, main_best)
    path_launches.update(sharded_launches)
    if any(m == "jax" or m.startswith(("jax.", "richdem_tpu."))
           or m == "richdem_tpu"
           for m in sys.modules if sys.modules[m] is not None):
        raise AssertionError("JAX or the JAX package was imported")

    log("done", f"every phase passed in {time.perf_counter() - t0:.1f} s "
        "(builds included)")
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"richdem_tpu_torch/csrc/{k.name}.cu",
         "replaces": REPLACES[name][0],
         "also_replaces": REPLACES[name][1],
         "path": PATH_OF[name],
         "launches": (path_launches[PATH_OF[name]][name]
                      if PATH_OF[name] else None),
         "max_abs_err": err[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": None, **RESOURCES[name],
         **({"launch_shape": SHAPES[name]} if name in SHAPES else {}),
         **({"redesigned_in": REDESIGNED[name]}
            if name in REDESIGNED else {}),
         **({"twopass": {
             "launches": sum(run[name]
                             for run in twopass_launches.values()),
             "tile": TWOPASS_TILE, **twopass_times[name]}}
            if name in twopass_times else {}),
         **({"sharded": {
             "launches": sum(run[name]
                             for run in sharded_launches.values()),
             "block": blocks[name], **sharded_times[name]}}
            if name in sharded_times else {})}
        for k, name in ((k, kname(k)) for k in kernels)]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
