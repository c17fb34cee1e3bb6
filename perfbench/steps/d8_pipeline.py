"""One step of the D8 pipeline: ``richdem_tpu_torch.terrain_pipeline`` on
one DEM, fill → D8 → D8 accumulation → slope → TWI, which raises when a
fixpoint does not converge.

``build(cfg)`` returns ``step(item) -> (outputs, counters)``: the
outputs the reference judges and the program's own counters, named as
the per-layer metrics that read them.
"""

from __future__ import annotations

from torch.profiler import record_function

OUTPUTS = ("filled", "flowdirs", "accum", "slope", "twi")


def build(cfg):
    import richdem_tpu_torch as rt

    eps = float(cfg["eps"])
    cellsize = float(cfg["cellsize"])
    with_twi = bool(cfg["with_twi"])
    fill_iters = int(cfg["fill_iters"])

    def step(item):
        with record_function("perfbench.terrain_pipeline"):
            out = rt.terrain_pipeline(item["z"], eps=eps, cellsize=cellsize,
                                      fill_iters=fill_iters,
                                      with_twi=with_twi,
                                      no_data=item["no_data"])
        counters = {"fill.rotations": int(out["fill_iters"]),
                    "accum.rotations": int(out["accum_rotations"])}
        return {k: out[k] for k in OUTPUTS}, counters

    return step
