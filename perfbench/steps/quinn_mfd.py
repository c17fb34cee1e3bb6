"""One step of the Quinn multi-flow path on one DEM: the ε-fill
(``ops.fill.fill_depressions_info``), Quinn proportions
(``flow_proportions(filled, "Quinn")``) and multi-flow accumulation
(``flow_accumulation_from_props(props, return_info=True)``).  A fixpoint
that does not converge raises, as a user's step would.

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
        with record_function("perfbench.flow_proportions"):
            props = rt.flow_proportions(filled, "Quinn", no_data=no_data,
                                        cellsize=cellsize)
        with record_function("perfbench.mfd_accumulation"):
            acc, rotations, done = rt.flow_accumulation_from_props(
                props, no_data_mask=mask, return_info=True)
            if not done:
                raise RuntimeError(f"multi-flow accumulation did not "
                                   f"converge in {rotations} rotations")
        counters = {"fill.rotations": int(fill_rotations),
                    "mfd.rotations": int(rotations)}
        return {"filled": filled, "props": props, "accum": acc}, counters

    return step
