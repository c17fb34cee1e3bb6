"""One step of basin delineation on one DEM, through the program's public
entries in the order a user calls them: the ε = 0 fill
(``ops.fill.fill_depressions_info``), D8 (``ops.flowdirs.d8_core``),
flat resolution (``resolve_flats``), watershed labels
(``watersheds_from_flowdirs``), Strahler order (``strahler_order``), D8
accumulation (``ops.accum.d8_accumulation_info``, weight 1 on data), the
gauges (:func:`gauge_mask`) and their upslope cells (``upslope_cells``).
Every entry runs at the program's default caps.  A fixpoint that does
not converge raises, as a user's step would; the watershed and upslope
walks finish by pointer doubling past their cap, as the program does.

``build(cfg)`` returns ``step(item) -> (outputs, counters)``: the
outputs the reference judges and the program's own counters, named as
the per-layer metrics that read them (``*.doubling``: 1 where pointer
doubling finished the walk).
"""

from __future__ import annotations

from torch.profiler import record_function


def gauge_mask(acc, k):
    """Mask of the ``k`` interior cells of largest accumulation, ties going
    to the lower flat index: the river gauges of a basin study."""
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


def build(cfg):
    import richdem_tpu_torch as rt
    from richdem_tpu_torch.ops.accum import d8_accumulation_info
    from richdem_tpu_torch.ops.fill import fill_depressions_info
    from richdem_tpu_torch.ops.flowdirs import d8_core
    from richdem_tpu_torch.ops.stencil import nodata_like

    eps = float(cfg["eps"])
    cellsize = float(cfg["cellsize"])
    fill_iters = int(cfg["fill_iters"])
    gauges = int(cfg["gauges"])

    def step(item):
        z, no_data = item["z"], item["no_data"]
        with record_function("perfbench.fill"):
            mask = nodata_like(z, no_data)
            filled, fill_rotations, done = fill_depressions_info(
                z, mask, eps=eps, max_iters=fill_iters)
            if not done:
                raise RuntimeError(f"fill did not converge in "
                                   f"{fill_rotations} rotations")
        with record_function("perfbench.d8"):
            codes = d8_core(filled, mask, cellsize)
        with record_function("perfbench.resolve_flats"):
            resolved, flats_rotations, _ = rt.resolve_flats(
                filled, codes, no_data=no_data, return_info=True)
        with record_function("perfbench.watersheds"):
            labels, shed_rotations, shed_engine = \
                rt.watersheds_from_flowdirs(resolved, return_info=True)
        with record_function("perfbench.strahler"):
            order, order_rotations, _ = rt.strahler_order(
                resolved, return_info=True)
        with record_function("perfbench.accumulation"):
            acc, acc_rotations, done = d8_accumulation_info(
                resolved, (~mask).to(z.dtype))
            if not done:
                raise RuntimeError(f"D8 accumulation did not converge in "
                                   f"{acc_rotations} rotations")
        with record_function("perfbench.gauges"):
            seeds = gauge_mask(acc, gauges)
        with record_function("perfbench.upslope"):
            up, up_rotations, up_engine = rt.upslope_cells(
                seeds, resolved, return_info=True)
        counters = {"fill.rotations": int(fill_rotations),
                    "flats.rotations": int(flats_rotations),
                    "watersheds.rotations": int(shed_rotations),
                    "watersheds.doubling": int(shed_engine == "doubling"),
                    "strahler.rotations": int(order_rotations),
                    "accum.rotations": int(acc_rotations),
                    "upslope.rotations": int(up_rotations),
                    "upslope.doubling": int(up_engine == "doubling")}
        out = {"filled": filled, "flowdirs": resolved, "labels": labels,
               "order": order, "accum": acc, "gauges": seeds,
               "upslope": up}
        return out, counters

    return step
