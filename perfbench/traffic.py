"""The one generator of the benchmark's traffic.

A mix (``perfbench/traffic/<mix>.json``) gives:

* ``generator``: the surface, ``"perlin"`` (fractal value noise,
  :func:`perfbench.synth.perlin_dem`, with ``octaves`` and
  ``amplitude``);
* ``pool``: how many DEMs a run cycles through, DEM ``i`` drawn from
  seed ``surface_seed + i`` and sent ``i``-th in every pass, whatever the
  run's seed: every run does the same work in the same order, so a window
  that ends inside a pass ends on the same DEMs; the run's seed draws
  which step is judged;
* ``holes`` (optional): ``{"count", "value", "max_radius"}``, circular
  nodata holes punched into each DEM with that sentinel, their circles
  drawn from the same seed (:func:`perfbench.synth.with_nodata_holes`);
* ``loop``: ``"closed"``, one client that sends the next DEM when the
  last result is back.

The DEMs are made on ``device`` at the configuration's ``shape``.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import synth

GENERATORS = ("perlin",)
LOOPS = ("closed",)


def make_pool(mix: dict, cfg: dict, device) -> list:
    """The run's DEMs in the order it sends them, each ``{"z": float32
    tensor, "no_data": sentinel or None}``."""
    if mix["generator"] not in GENERATORS:
        raise ValueError(f"unknown generator {mix['generator']!r}")
    if mix["loop"] not in LOOPS:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    h, w = (int(s) for s in cfg["shape"])
    holes = mix.get("holes")
    pool = []
    for i in range(int(mix["pool"])):
        s = int(mix["surface_seed"]) + i
        z = synth.perlin_dem(h, w, seed=s, octaves=int(mix["octaves"]),
                             amplitude=float(mix["amplitude"]),
                             device=device)
        no_data = None
        if holes:
            no_data = float(holes["value"])
            z = synth.with_nodata_holes(z, no_data=no_data, seed=s,
                                        n_holes=int(holes["count"]),
                                        max_radius=holes.get("max_radius"))
        pool.append({"z": z, "no_data": no_data})
    return pool


def nodata_mask(item):
    """The pool item's nodata cells (all False without a sentinel)."""
    z, no_data = item["z"], item["no_data"]
    if no_data is None:
        return torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    return z == np.float32(no_data).item()
