"""What the reference works out for the D8 pipeline (fill at ε = 0 → D8 →
D8 accumulation → slope → TWI), and the numbers that judge the program's
outputs by it.

The reference starts from the DEM alone: its own fill, its own codes from
that fill, its accumulation from its codes, its slope from its fill and
its TWI from its accumulation and slope.  The fill and the codes are
exact; the accumulation is float64 of whole weights, so exact; slope and
TWI are float32, the precision the configuration states.  The control
(``control=True``) works every stage in bfloat16.
"""

from __future__ import annotations

import torch

from perfbench.reference import fill, flow, terrain

#: Whole numbers above this are not all float32 numbers, so a float32
#: accumulation is exact below it and rounds above it.
EXACT_FLOAT32 = 2.0 ** 24


def reference(z, nodata, out, cfg, control=False) -> dict:
    """The entry's outputs on ``z`` as the reference works them out;
    ``out`` (the program's outputs) is not read."""
    low = torch.bfloat16 if control else None
    cs = float(cfg["cellsize"])
    filled = fill.fill_flat(z, nodata, low or torch.float32)
    codes = flow.d8_codes(filled, nodata, cs, low or torch.float32)
    weights = (~nodata).to(low or torch.float64)
    acc = flow.d8_accumulation(codes, weights, low or torch.float64)
    slope = terrain.slope_radians(filled, nodata, cs, low or torch.float32)
    twi = terrain.twi(acc, slope, cs, low or torch.float32)
    return {"filled": filled, "flowdirs": codes, "accum": acc,
            "slope": slope, "twi": twi}


def _gap(a, b, keep):
    """Largest |a - b| over the cells of ``keep`` (NaN if either is NaN
    there), 0 over no cells."""
    d = (a.double() - b.double()).abs()[keep]
    return float(d.max()) if d.numel() else 0.0


def judge(out, ref, z, nodata, cfg) -> dict:
    """The numbers compared, by name: cells off the reference's fill,
    codes and accumulation where float32 holds it exactly (limit 0), and
    the widest gaps, relative for the accumulation, in radians for slope
    and in TWI's own units."""
    data = ~nodata
    acc, racc = out["accum"].double(), ref["accum"].double()
    exact = racc <= EXACT_FLOAT32
    acc_gap = ((acc - racc).abs() / racc.clamp(min=1.0))[data]
    return {
        "filled_off": int((out["filled"].float() != ref["filled"].float())
                          .sum()),
        "codes_off": int((out["flowdirs"].to(torch.int8)
                          != ref["flowdirs"]).sum()),
        "accum_off": int((acc != racc)[exact].sum()),
        "accum_gap": float(acc_gap.max()) if acc_gap.numel() else 0.0,
        "slope_gap": _gap(out["slope"], ref["slope"], data),
        "twi_gap": _gap(out["twi"], ref["twi"], data),
    }
