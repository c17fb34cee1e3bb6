"""Pipeline configuration (SURVEY.md §5.6), the port's counterpart of
``richdem_tpu.config``.

One frozen dataclass per pipeline carrying every knob that changes
numerical results or placement, hashable so it can key checkpoint
manifests; the same fields and JSON form as the reference's.
"""

from __future__ import annotations

import dataclasses
import json

__all__ = ["PipelineConfig"]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Knobs for the fill → flowdirs → accumulation (→ TWI) pipeline."""

    #: fixed fill epsilon; 0 = plain fill, None = auto (ulp-scaled)
    eps: float | None = 1e-3
    #: flow metric: D8/D4/Rho8/Rho4/Dinf/Quinn/Freeman/Holmgren/...
    metric: str = "D8"
    #: exponent for Freeman/Holmgren/Seibert-McGlynn
    exponent: float | None = None
    #: grid cell size (map units)
    cellsize: float = 1.0
    #: compute dtype policy for rasters on device
    dtype: str = "float32"
    #: fixpoint iteration caps
    fill_iters: int = 256
    accum_rotations: int = 64
    #: attach slope + TWI outputs
    with_twi: bool = False
    #: device mesh shape for the sharded pipeline; None = single device
    mesh: tuple | None = None
    #: checkpoint directory for phase-granular resume; None = off
    cache_dir: str | None = None
    grid_id: str = "grid"

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["mesh"] = list(self.mesh) if self.mesh else None
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "PipelineConfig":
        d = json.loads(s)
        if d.get("mesh"):
            d["mesh"] = tuple(d["mesh"])
        return cls(**d)

    def run(self, dem, no_data=None, device="cuda"):
        """Execute the configured pipeline; returns a dict of rasters.

        ``dem``: a tensor (the pipeline runs where it lives) or an array
        (moved to ``device``).  The D8 pipelines return tensors, the
        generic-metric path host arrays, as in the reference."""
        from richdem_tpu_torch.ops.stencil import as_tensor

        z = as_tensor(dem, device)
        # Resolve eps ONCE for every branch: None = auto (ulp-scaled to
        # the DEM); any explicit value — including 0.0 (plain fill) —
        # passes through unchanged.
        if self.eps is None:
            from richdem_tpu_torch.ops.fill import auto_epsilon
            eps = auto_epsilon(z)
        else:
            eps = float(self.eps)

        if self.metric.lower() not in ("d8",):
            # generic path through the public API
            import richdem_tpu_torch as rd

            arr = rd.rdarray(z, no_data=no_data,
                             geotransform=(0, self.cellsize, 0, 0, 0,
                                           -self.cellsize))
            filled = rd.FillDepressions(arr, epsilon=eps if eps else False)
            acc = rd.FlowAccumulation(filled, method=self.metric,
                                      exponent=self.exponent)
            out = {"filled": filled.np(), "accum": acc.np()}
            if self.with_twi:
                slope = rd.TerrainAttribute(filled, "slope_radians")
                out["slope"] = slope.np()
                out["twi"] = rd.TWI(acc, slope).np()
            return out
        if self.mesh is not None:
            import torch

            from richdem_tpu_torch.ops.stencil import nodata_like
            from richdem_tpu_torch.parallel import (make_mesh,
                                                    sharded_pipeline)

            ny, nx = self.mesh
            # the card's devices, or the one device the DEM lives on
            # repeated over the mesh (the CPU, as the reference's tests
            # take 8 virtual CPU devices)
            mesh = make_mesh(None if z.device.type == "cuda"
                             else [z.device] * (ny * nx), shape=self.mesh)
            nd_mask = None if no_data is None else nodata_like(z, no_data)
            return sharded_pipeline(z.to(torch.float32), mesh=mesh, eps=eps,
                                    nodata_mask=nd_mask,
                                    cellsize=self.cellsize)
        if self.cache_dir:
            from richdem_tpu_torch.pipeline import resumable_pipeline

            return resumable_pipeline(z, self.cache_dir,
                                      grid_id=self.grid_id,
                                      eps=eps,
                                      cellsize=self.cellsize,
                                      with_twi=self.with_twi,
                                      no_data=no_data)
        from richdem_tpu_torch.pipeline import terrain_pipeline

        return terrain_pipeline(z, eps=eps,
                                cellsize=self.cellsize,
                                fill_iters=self.fill_iters,
                                with_twi=self.with_twi,
                                no_data=no_data)
