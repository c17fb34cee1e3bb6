"""Synthetic DEMs generated on the device.

Counterpart of ``richdem_tpu.synth_jax`` (``cone_dem``, ``saddle_dem``,
``plateau_dem``, ``depression_dem``, ``perlin_dem``, ``perlin_dem_rows``)
and of the remaining names of ``richdem_tpu.synth`` (``inverted_cone_dem``,
``with_nodata_holes``), evaluated on ``device`` (the card unless another
is asked for) so that a 10240² raster is never built on the host.

The analytic surfaces are computed in float64, as the numpy generators
(:mod:`richdem_tpu_torch.synth_np`) compute them, and rounded once to
``dtype``.  The random ones draw their few parameters (pit centres,
lattices, hole circles) from ``numpy.random.default_rng(seed)`` in the
numpy generators' order, so each field equals its numpy counterpart up to
float rounding; ``jax.random``'s bits cannot be reproduced here, so no
field is ``synth_jax``'s.  Value noise is evaluated in float32, elementwise
over global coordinates, so :func:`perlin_dem_rows` strips are bitwise
slices of :func:`perlin_dem`.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["cone_dem", "inverted_cone_dem", "saddle_dem", "plateau_dem",
           "depression_dem", "perlin_dem", "perlin_dem_rows",
           "with_nodata_holes"]


def _coords(height, width, device, dtype=torch.float64):
    """(y, x) cell coordinates, broadcastable to (height, width)."""
    y = torch.arange(height, dtype=dtype, device=device)[:, None]
    x = torch.arange(width, dtype=dtype, device=device)[None, :]
    return y, x


def cone_dem(height: int, width: int = None, peak: float = 100.0,
             dtype=torch.float32, device="cuda") -> torch.Tensor:
    """A cone peaking at the grid centre: every cell drains outward."""
    width = height if width is None else width
    y, x = _coords(height, width, device)
    cy, cx = (height - 1) / 2.0, (width - 1) / 2.0
    r = torch.hypot(y - cy, x - cx)
    rmax = max(float(np.hypot(cy, cx)), 1.0)
    return (peak * (1.0 - r / rmax)).to(dtype)


def inverted_cone_dem(height: int, width: int = None, depth: float = 100.0,
                      dtype=torch.float32, device="cuda") -> torch.Tensor:
    """A single giant depression: a cone opening upward (pit at the
    centre)."""
    return (-cone_dem(height, width, peak=depth, dtype=torch.float64,
                      device=device)).to(dtype)


def saddle_dem(height: int, width: int = None, scale: float = 50.0,
               dtype=torch.float32, device="cuda") -> torch.Tensor:
    """A hyperbolic-paraboloid saddle."""
    width = height if width is None else width
    y, x = _coords(height, width, device)
    yn = (y / max(height - 1, 1)) * 2 - 1
    xn = (x / max(width - 1, 1)) * 2 - 1
    return (scale * (xn * xn - yn * yn)).to(dtype)


def plateau_dem(height: int, width: int = None, base: float = 10.0,
                top: float = 20.0, margin: int = None, dtype=torch.float32,
                device="cuda") -> torch.Tensor:
    """A flat-topped mesa on a slightly tilted base (exercises flat
    resolution)."""
    width = height if width is None else width
    margin = max(height, width) // 4 if margin is None else margin
    y, x = _coords(height, width, device)
    z = base + 1e-3 * (x + y)
    z[margin:height - margin, margin:width - margin] = top
    return z.to(dtype)


def depression_dem(height: int, width: int = None, seed: int = 0,
                   n_pits: int = 8, pit_depth: float = 30.0,
                   dtype=torch.float32, device="cuda") -> torch.Tensor:
    """A gently sloping plane pocked with Gaussian pits (guaranteed
    depressions)."""
    width = height if width is None else width
    rng = np.random.default_rng(seed)
    y, x = _coords(height, width, device)
    z = 50.0 + 0.05 * (x + 0.5 * y)
    for _ in range(n_pits):
        py = rng.uniform(0.15, 0.85) * height
        px = rng.uniform(0.15, 0.85) * width
        sigma = rng.uniform(0.03, 0.1) * max(height, width)
        depth = rng.uniform(0.3, 1.0) * pit_depth
        z = z - depth * torch.exp(-((y - py) ** 2 + (x - px) ** 2)
                                  / (2 * sigma ** 2))
    return z.to(dtype)


def perlin_dem(height: int, width: int = None, seed: int = 0,
               octaves: int = 5, base_period: int = None,
               amplitude: float = 100.0, device="cuda") -> torch.Tensor:
    """Fractal value-noise terrain, float32 ``(height, width)`` on
    ``device``; the whole field in one call (its peak on the card is
    recorded in PERF.md)."""
    width = height if width is None else width
    return perlin_dem_rows(height, width, 0, height, seed=seed,
                           octaves=octaves, base_period=base_period,
                           amplitude=amplitude, device=device)


def perlin_dem_rows(height: int, width: int, row0: int, nrows: int,
                    seed: int = 0, octaves: int = 5, base_period: int = None,
                    amplitude: float = 100.0,
                    device="cuda") -> torch.Tensor:
    """Rows ``[row0, row0 + nrows)`` of ``perlin_dem(height, width, ...)``:
    the lattices are drawn and shaped from the global dimensions and every
    cell's value is elementwise in its global coordinates, so the strip is
    bitwise the slice of the full field."""
    base_period = (max(height, width) // 4 if base_period is None
                   else base_period)
    base_period = max(base_period, 2)
    rng = np.random.default_rng(seed)
    y = torch.arange(row0, row0 + nrows, dtype=torch.float32,
                     device=device)[:, None]
    x = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    z = torch.zeros((nrows, width), dtype=torch.float32, device=device)
    amp, total_amp = 1.0, 0.0
    for octave in range(octaves):
        period = max(base_period >> octave, 1)
        gh, gw = height // period + 2, width // period + 2
        lattice = torch.from_numpy(
            rng.uniform(-1.0, 1.0, size=(gh, gw)).astype(np.float32)
        ).to(device)
        gy, gx = y / period, x / period
        y0, x0 = torch.floor(gy), torch.floor(gx)
        ty, tx = gy - y0, gx - x0
        sy = ty * ty * (3 - 2 * ty)
        sx = tx * tx * (3 - 2 * tx)
        iy, ix = y0.long(), x0.long()
        top = lattice[iy, ix] * (1 - sx) + lattice[iy, ix + 1] * sx
        bot = lattice[iy + 1, ix] * (1 - sx) + lattice[iy + 1, ix + 1] * sx
        z += amp * (top * (1 - sy) + bot * sy)
        total_amp += amp
        amp *= 0.5
    return z * (amplitude / total_amp)


def with_nodata_holes(dem, no_data: float = -9999.0, seed: int = 0,
                      n_holes: int = 4, max_radius: int = None,
                      device="cuda") -> torch.Tensor:
    """Punch circular nodata holes into a DEM; returns a copy.  ``dem``: a
    tensor (the copy lies where it lives) or an array (moved to
    ``device``)."""
    z = (dem.clone() if torch.is_tensor(dem)
         else torch.as_tensor(np.array(dem), device=device))
    h, w = z.shape
    max_radius = max(h, w) // 10 if max_radius is None else max_radius
    rng = np.random.default_rng(seed)
    y, x = _coords(h, w, z.device)
    for _ in range(n_holes):
        cy = rng.uniform(0, h)
        cx = rng.uniform(0, w)
        r = rng.uniform(1, max(max_radius, 2))
        z[(y - cy) ** 2 + (x - cx) ** 2 <= r * r] = no_data
    return z
