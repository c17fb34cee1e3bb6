"""What the reference works out for the Quinn multi-flow path (ε-fill →
Quinn proportions → multi-flow accumulation), and the numbers that judge
the program's outputs by it.

The fill at ε > 0 is judged by its own equation
(:func:`perfbench.reference.fill.fixpoint_residual`): with no residual
cell, and ``ε`` raising every cell, the program's surface is the only
solution, bit for bit.  A float32 fill worked out anew would cost a
label-correcting search of some 10¹⁰ relaxations at 10240², so the
proportions start from that judged surface, as a served model's
reference reads the served tokens; everything after it is the
reference's own: float64 proportions and a float64 accumulation in
topological order.  The control (``control=True``) rounds the fill to
bfloat16 and works the rest in bfloat16.
"""

from __future__ import annotations

import torch

from perfbench.reference import fill, flow


def reference(z, nodata, out, cfg, control=False) -> dict:
    """The entry's outputs on ``z``, from the program's judged fill."""
    low = torch.bfloat16 if control else None
    cs = float(cfg["cellsize"])
    filled = out["filled"].to(low or torch.float32)
    planes = flow.quinn_planes(filled, nodata, cs, low or torch.float64)
    weights = (~nodata).to(low or torch.float64)
    acc = flow.mfd_accumulation(planes, weights, low or torch.float64)
    return {"filled": filled, "props": planes.permute(1, 2, 0),
            "accum": acc}


def judge(out, ref, z, nodata, cfg) -> dict:
    """The numbers compared, by name: cells where the fill breaks its
    equation or where ε does not raise it (limit 0), and the widest gaps
    of the proportions and, relative, of the accumulation."""
    check = fill.fixpoint_residual(out["filled"], z, nodata,
                                   float(cfg["eps"]))
    # a plane at a time: the float64 stack is 6.4 GB at 10240²; torch's
    # max keeps a NaN, which fails the limit
    props_gap = float(torch.stack([
        (out["props"][..., d].double()
         - ref["props"][..., d].double()).abs().max() for d in range(8)
    ]).max())
    acc, racc = out["accum"].double(), ref["accum"].double()
    data = ~nodata
    rel = ((acc - racc).abs() / racc.clamp(min=1.0))[data]
    return {
        "fill_residual": check["residual"] + check["unresolved"],
        "props_gap": props_gap,
        "accum_gap": float(rel.max()) if rel.numel() else 0.0,
    }
