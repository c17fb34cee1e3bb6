"""Frozen copy of the DEM generators the benchmark's traffic uses.

Copied from ``richdem_tpu_torch.synth`` (``perlin_dem`` at its default
period, ``with_nodata_holes``) so that the benchmark's inputs
cannot move when the program's own generator changes.
``perfbench/test_perfbench_synth.py`` holds the copy bitwise equal to the
program's today.  Value noise is evaluated in float32 on ``device`` from
lattices drawn by ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["perlin_dem", "with_nodata_holes"]


def _coords(height, width, device, dtype=torch.float64):
    """(y, x) cell coordinates, broadcastable to (height, width)."""
    y = torch.arange(height, dtype=dtype, device=device)[:, None]
    x = torch.arange(width, dtype=dtype, device=device)[None, :]
    return y, x


def perlin_dem(height: int, width: int = None, seed: int = 0,
               octaves: int = 5, amplitude: float = 100.0,
               device="cuda") -> torch.Tensor:
    """Fractal value-noise terrain, float32 ``(height, width)`` on
    ``device``; the coarsest octave's period is a quarter of the longer
    side."""
    width = height if width is None else width
    base_period = max(max(height, width) // 4, 2)
    rng = np.random.default_rng(seed)
    y = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    x = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    z = torch.zeros((height, width), dtype=torch.float32, device=device)
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
