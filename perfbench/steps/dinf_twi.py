"""One step of the D∞ path on one DEM: the ε-fill
(``ops.fill.fill_depressions_info``), Tarboton D∞ angles
(``dinf_flowdirs``), D∞ accumulation
(``dinf_accumulation_from_angles(angles, return_info=True)``), slope
(``terrain_attribute(filled, "slope_radians")``) and TWI (``twi``).  A
fixpoint that does not converge raises, as a user's step would.

``build(cfg)`` returns ``step(item) -> (outputs, counters)``.
"""

from __future__ import annotations

from torch.profiler import record_function


def build(cfg):
    import richdem_tpu_torch as rt
    from richdem_tpu_torch.ops.fill import fill_depressions_info
    from richdem_tpu_torch.ops.stencil import nodata_like

    eps = float(cfg["eps"])
    cellsize = float(cfg["cellsize"])
    fill_iters = int(cfg["fill_iters"])

    def step(item):
        z, no_data = item["z"], item["no_data"]
        with record_function("perfbench.fill"):
            mask = None if no_data is None else nodata_like(z, no_data)
            filled, fill_rotations, done = fill_depressions_info(
                z, mask, eps=eps, max_iters=fill_iters)
            if not done:
                raise RuntimeError(f"ε-fill did not converge in "
                                   f"{fill_rotations} rotations")
        with record_function("perfbench.dinf_flowdirs"):
            angles = rt.dinf_flowdirs(filled, no_data=no_data,
                                      cellsize=cellsize)
        with record_function("perfbench.dinf_accumulation"):
            # raises RuntimeError past its default cap of rotations
            acc, rotations, _ = rt.dinf_accumulation_from_angles(
                angles, no_data_mask=mask, return_info=True)
        with record_function("perfbench.slope_twi"):
            slope = rt.terrain_attribute(filled, "slope_radians",
                                         cellsize=cellsize, no_data=no_data)
            twi = rt.twi(acc, slope, cellsize=cellsize)
        counters = {"fill.rotations": int(fill_rotations),
                    "dinf.rotations": int(rotations)}
        return {"filled": filled, "angles": angles, "accum": acc,
                "slope": slope, "twi": twi}, counters

    return step
