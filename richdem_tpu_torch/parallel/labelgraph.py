"""Global label-graph combine for the two-pass distributed fill ([P1]).

Spec: Barnes 2016, *Parallel Priority-Flood* (arxiv 1606.06204 §3;
SURVEY.md §2.4 row 1, §3.4, §5.7).  Tile consumers (``native.fill_tile``)
emit per-tile watershed labels, locally filled surfaces, and label-
adjacency spill graphs; this module merges those graphs with the seam
edges and solves the single global problem on the O(perimeter) label
graph:

    raise[L] = min over label paths L → ocean of (max spill along path)

— the minimax ("bottleneck") distance from the ocean node, computed by a
Priority-Flood/Dijkstra sweep over labels.  Cells then rise to
``max(local_fill, raise[label])``, which [P1] proves equals the serial
Priority-Flood output.  Total cost is O(perimeter · log), independent of
tile count — the property that makes exactly TWO passes over the data
sufficient at any scale.
"""

from __future__ import annotations

import heapq

import numpy as np

__all__ = ["reduce_edges", "minimax_raise", "OCEAN"]

#: global label id of the ocean (DEM border / nodata drains).
OCEAN = 0


def reduce_edges(a, b, w):
    """Combine parallel edges: unordered (a, b) pairs keep the min weight.

    Returns ``(a, b, w)`` int64/int64/float64 arrays with a < b, unique.
    """
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    w = np.asarray(w, np.float64)
    keep = a != b
    a, b, w = a[keep], b[keep], w[keep]
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    order = np.lexsort((w, hi, lo))
    lo, hi, w = lo[order], hi[order], w[order]
    first = np.ones(lo.shape, bool)
    first[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    return lo[first], hi[first], w[first]


def minimax_raise(n_nodes, edge_a, edge_b, edge_w, ocean=OCEAN):
    """Bottleneck-shortest-path raise elevations from the ocean node.

    ``raise[ocean] = -inf``; any node unreachable from the ocean keeps
    ``+inf`` (cannot happen on a DEM whose border drains — asserted by
    callers).  Runs the label-graph Priority-Flood of [P1] §3: pop the
    lowest-spill label, finalize it, relax neighbors with
    ``max(raise[u], w(u, v))``.
    """
    edge_a = np.asarray(edge_a, np.int64)
    edge_b = np.asarray(edge_b, np.int64)
    edge_w = np.asarray(edge_w, np.float64)
    # CSR adjacency over both directions (vectorized sort-based build)
    src = np.concatenate([edge_a, edge_b])
    dst = np.concatenate([edge_b, edge_a])
    ww = np.concatenate([edge_w, edge_w])
    order = np.argsort(src, kind="stable")
    nbr = dst[order]
    wgt = ww[order]
    indptr = np.searchsorted(src[order], np.arange(n_nodes + 1))

    dist = np.full(n_nodes, np.inf)
    done = np.zeros(n_nodes, bool)
    dist[ocean] = -np.inf
    heap = [(-np.inf, ocean)]
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = True
        for p in range(indptr[u], indptr[u + 1]):
            v = int(nbr[p])
            if done[v]:
                continue
            cand = max(d, wgt[p])
            if cand < dist[v]:
                dist[v] = cand
                heapq.heappush(heap, (cand, v))
    return dist
