"""Serial flow accumulation via topological propagation (oracle).

Counterpart of the reference's generic accumulation engine
(``include/richdem/methods/flow_accumulation_generic.hpp``,
``FlowAccumulation<fm>`` / ``FlowAccumFromProps`` — SURVEY.md §2.2, §3.2):
dependency-count Kahn's-algorithm propagation of weighted upstream area over
an ``(H, W, 8)`` proportion tensor.

Semantics (appendix A.6): ``A = w + Pᵀ A`` where ``P(c→n)`` are outflow
proportions; cells whose proportions are all zero (NO_FLOW, nodata) absorb
their inflow.  Default weights are 1 per data cell.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from richdem_tpu_torch.topology import DX, DY

__all__ = ["flow_accumulation_from_props", "d8_accumulation"]


def flow_accumulation_from_props(props, weights=None, no_data_mask=None):
    """Weighted upstream accumulation from an ``(H, W, 8)`` proportion
    tensor.  Returns float64 ``(H, W)``; nodata cells (mask) get 0."""
    props = np.asarray(props, dtype=np.float64)
    h, w, _ = props.shape
    if no_data_mask is None:
        no_data_mask = np.zeros((h, w), dtype=bool)
    if weights is None:
        weights = np.ones((h, w), dtype=np.float64)
    accum = np.array(weights, dtype=np.float64, copy=True)
    accum[no_data_mask] = 0.0

    # Dependency counts: number of neighbors that flow into each cell.
    deps = np.zeros((h, w), dtype=np.int32)
    for r in range(h):
        for c in range(w):
            if no_data_mask[r, c]:
                continue
            for d in range(1, 9):
                if props[r, c, d - 1] <= 0.0:
                    continue
                nr, nc = r + int(DY[d]), c + int(DX[d])
                if 0 <= nr < h and 0 <= nc < w:
                    deps[nr, nc] += 1

    queue = deque(
        (r, c)
        for r in range(h)
        for c in range(w)
        if deps[r, c] == 0 and not no_data_mask[r, c]
    )
    processed = 0
    while queue:
        r, c = queue.popleft()
        processed += 1
        for d in range(1, 9):
            p = props[r, c, d - 1]
            if p <= 0.0:
                continue
            nr, nc = r + int(DY[d]), c + int(DX[d])
            if not (0 <= nr < h and 0 <= nc < w):
                continue
            accum[nr, nc] += accum[r, c] * p
            deps[nr, nc] -= 1
            if deps[nr, nc] == 0:
                queue.append((nr, nc))

    n_data = int((~no_data_mask).sum())
    if processed != n_data:
        raise ValueError(
            f"flow graph has a cycle: processed {processed} of {n_data} "
            "cells — run depression filling / flat resolution first")
    accum[no_data_mask] = 0.0
    return accum


def d8_accumulation(flowdirs, weights=None, no_data_mask=None):
    """Accumulation from a D8 single-flow-direction raster."""
    from richdem_tpu_torch.oracle.flowdirs import proportions_from_d8

    fd = np.asarray(flowdirs)
    if no_data_mask is None:
        no_data_mask = fd < 0
    return flow_accumulation_from_props(
        proportions_from_d8(fd), weights=weights, no_data_mask=no_data_mask)
