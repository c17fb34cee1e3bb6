"""The main path: fill → D8 flow directions → D8 accumulation (+ slope/TWI).

Counterpart of ``richdem_tpu.pipeline`` (``make_pipeline``,
``terrain_pipeline``, ``check_converged``, ``resumable_pipeline``): same
defaults, same nodata handling (nodata drains, has zero weight and zero
accumulation, and keeps its elevation in ``filled``) and the same output
keys.  A CUDA tensor runs the hand-written kernels (``csrc/``); a CPU
tensor runs their plain versions.  The fill engine is
``RICHDEM_TPU_FILL_ENGINE``'s (:func:`~richdem_tpu_torch.ops.fill.
fill_engine`).
"""

from __future__ import annotations

import numpy as np
import torch

from richdem_tpu_torch.methods import twi as _twi
from richdem_tpu_torch.ops.accum import d8_accumulation, d8_accumulation_info
from richdem_tpu_torch.ops.fill import fill_depressions, fill_depressions_info
from richdem_tpu_torch.ops.flowdirs import d8_core, d8_flowdirs
from richdem_tpu_torch.ops.stencil import as_tensor, nodata_like
from richdem_tpu_torch.ops.terrain import terrain_core

__all__ = ["make_pipeline", "terrain_pipeline", "check_converged",
           "resumable_pipeline"]


def _pipeline(z, nodata, eps, cellsize, fill_iters, rounds, with_twi):
    z = z.to(torch.float32)
    filled, fiters, fdone = fill_depressions_info(z, nodata, eps=eps,
                                                  max_iters=fill_iters)
    fd = d8_core(filled, nodata, cellsize)
    weights = torch.where(nodata, 0.0, 1.0).to(torch.float32)
    acc, aiters, adone = d8_accumulation_info(fd, weights, rounds)
    acc = torch.where(nodata, 0.0, acc)
    # convergence rides in the output so no caller can silently use a
    # truncated fixpoint; check_converged raises on it
    out = {"filled": filled, "flowdirs": fd, "accum": acc,
           "fill_iters": fiters, "accum_rotations": aiters,
           "fill_converged": fdone, "accum_converged": adone}
    if with_twi:
        slope = terrain_core(filled, nodata, 1.0, cellsize, "slope_radians")
        out["slope"] = slope
        out["twi"] = _twi(acc, slope, cellsize=cellsize)
    return out


def make_pipeline(shape, eps=1e-3, cellsize=1.0, fill_iters=256,
                  with_twi=False, no_data=None, max_rotations=None):
    """A ``step(dem) -> dict`` closure for a fixed grid shape.

    ``no_data``: sentinel value treated as nodata.  ``fill_iters`` and
    ``max_rotations`` bound the fill rotations and the accumulation
    rotations; they bound the loop, never the result — the output carries
    ``fill_converged``/``accum_converged`` and :func:`check_converged`
    raises on either being False."""
    shape = tuple(int(s) for s in shape)
    # loop bound, not a guarantee: adversarial DEMs need O(H) rotations
    if max_rotations is None:
        max_rotations = max(
            4, int(np.ceil(np.log2(max(shape[0] * shape[1], 2)))))
    rounds = max_rotations

    def step(z):
        if tuple(z.shape) != shape:
            raise ValueError(f"pipeline built for {shape}, got "
                             f"{tuple(z.shape)}")
        nodata = nodata_like(z, no_data)
        return _pipeline(z, nodata, eps, cellsize, fill_iters, rounds,
                         with_twi)

    return step


def check_converged(out):
    """Raise if a pipeline output dict carries unconverged fixpoints."""
    if not bool(out["fill_converged"]):
        raise RuntimeError(
            f"pipeline fill did not converge in {int(out['fill_iters'])} "
            "iterations; raise fill_iters")
    if not bool(out["accum_converged"]):
        raise RuntimeError(
            "pipeline accumulation did not converge in "
            f"{int(out['accum_rotations'])} GS rotations; raise "
            "max_rotations (adversarial flow paths need up to O(H))")
    return out


def terrain_pipeline(dem, eps=1e-3, cellsize=1.0, fill_iters=256,
                     with_twi=False, no_data=None, max_rotations=None,
                     device="cuda"):
    """One-shot :func:`make_pipeline` on ``dem``, a tensor (the pipeline
    runs where it lives) or an array (moved to ``device``); raises on
    non-convergence."""
    z = as_tensor(dem, device)
    out = make_pipeline(z.shape, eps, cellsize, fill_iters, with_twi,
                        no_data=no_data, max_rotations=max_rotations)(z)
    return check_converged(out)


def _host(x):
    """A phase's result as the host array the phase cache stores."""
    return x.detach().cpu().numpy()


def resumable_pipeline(dem, cache_dir, grid_id="grid", eps=1e-3,
                       cellsize=1.0, with_twi=True, no_data=None,
                       device="cuda"):
    """fill → flowdirs → accum (→ slope/TWI) with phase-granular
    checkpoint/resume (SURVEY.md §5.3/5.4: the reference's --cache-dir
    tile eviction recast as .npy phase dumps).  A rerun after a crash
    loads finished phases from ``cache_dir`` and computes only the rest;
    the entries are keyed by a fingerprint of the DEM and the knobs, so a
    changed input recomputes.  Returns host arrays, as the reference does.
    ``dem``: a tensor (phases run where it lives) or an array (moved to
    ``device``)."""
    from richdem_tpu_torch.checkpoint import PhaseCache, fingerprint_of

    z = as_tensor(dem, device)
    fp = fingerprint_of(
        f"eps={eps};cellsize={cellsize};no_data={no_data}", _host(z))
    cache = PhaseCache(cache_dir, grid_id, fingerprint=fp)
    nd_mask = nodata_like(z, no_data)

    def on_device(x):
        return torch.as_tensor(x, device=z.device)

    filled = cache.run(
        "filled", lambda: _host(fill_depressions(z, no_data=no_data,
                                                 eps=eps)))
    fd = cache.run(
        "flowdirs", lambda: _host(d8_flowdirs(on_device(filled),
                                              no_data=no_data,
                                              cellsize=cellsize)))
    acc = cache.run(
        "accum", lambda: _host(d8_accumulation(on_device(fd),
                                               no_data_mask=nd_mask)))
    out = {"filled": filled, "flowdirs": fd, "accum": acc}
    if with_twi:
        slope = cache.run(
            "slope", lambda: _host(terrain_core(
                on_device(filled).to(torch.float32), nd_mask, 1.0, cellsize,
                "slope_radians")))
        out["slope"] = slope
        out["twi"] = cache.run(
            "twi", lambda: _host(_twi(on_device(acc), on_device(slope),
                                      cellsize=cellsize)))
    return out
