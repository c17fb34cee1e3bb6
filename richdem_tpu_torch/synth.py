"""Synthetic DEMs generated on the device.

Counterpart of ``richdem_tpu.synth_jax.perlin_dem`` /
``perlin_dem_rows``: multi-octave smoothstep value noise, evaluated in
float32 on ``device`` so that a 10240² raster is never built on the host.
The per-octave lattices are tiny; they come from
``numpy.random.default_rng(seed)`` in the order ``richdem_tpu.synth``
draws them, so the field equals the numpy generator's
(:mod:`richdem_tpu_torch.synth_np`, float64) up to float32 rounding.
``jax.random``'s bits cannot be reproduced here, so the field is not
``synth_jax``'s.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["perlin_dem"]


def perlin_dem(height: int, width: int = None, seed: int = 0,
               octaves: int = 5, base_period: int = None,
               amplitude: float = 100.0, device="cuda") -> torch.Tensor:
    """Fractal value-noise terrain, float32 ``(height, width)`` on
    ``device`` (the card unless another is asked for)."""
    width = height if width is None else width
    base_period = (max(height, width) // 4 if base_period is None
                   else base_period)
    base_period = max(base_period, 2)
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
