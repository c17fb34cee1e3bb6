// Native CPU reference engine for richdem_tpu.
//
// The reference implements its entire algorithm core as header-only C++
// (SURVEY.md §2.2: include/richdem/depressions/Barnes2014.hpp,
// flowmet/d8_flowdirs.hpp, methods/flow_accumulation_generic.hpp).  This
// translation unit is the TPU package's native counterpart, written
// clean-room from the published pseudocode (Barnes, Lehman & Mulla 2014,
// arxiv 1511.04463; appendix A of SURVEY.md):
//
//   * the single-core CPU baseline that bench.py MEASURES (vs_baseline is a
//     real measurement, not an assumed constant);
//   * a fast correctness oracle for grids where the pure-Python heap oracle
//     is too slow.
//
// Semantics are identical to richdem_tpu/oracle/*.py (same D8 encoding,
// same seed rule, same fixed-epsilon fill, same insertion-order heap
// tie-break).  C ABI only; bound from Python via ctypes (no pybind11 in
// this environment).
//
// This file is the PyTorch port's own copy of richdem_tpu/native/core.cpp,
// kept byte-for-byte in its code so that both packages gate against the
// same engine.  Build: richdem_tpu_torch/native/__init__.py compiles it into
// richdem_tpu_torch/build/ at first use (g++ -O3 -ffp-contract=off -shared).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

// D8 topology — MUST match richdem_tpu/topology.py.
//            d:  0   1   2   3   4   5   6   7   8
//                .   W   NW  N   NE  E   SE  S   SW
const int DX[9] = {0, -1, -1, 0, 1, 1, 1, 0, -1};
const int DY[9] = {0, 0, -1, -1, -1, 0, 1, 1, 1};
const int D8_INVERSE[9] = {0, 5, 6, 7, 8, 1, 2, 3, 4};
const double SQRT2 = 1.4142135623730951;
const double DR[9] = {0, 1, SQRT2, 1, SQRT2, 1, SQRT2, 1, SQRT2};
const int8_t NO_FLOW = 0;
const int8_t FLOWDIR_NO_DATA = -1;

struct Cell {
  double z;
  int64_t k;  // insertion order: stable tie-break (GridCellZk semantics)
  int32_t r, c;
};
struct CellGreater {
  bool operator()(const Cell& a, const Cell& b) const {
    if (a.z != b.z) return a.z > b.z;
    return a.k > b.k;
  }
};
using MinHeap = std::priority_queue<Cell, std::vector<Cell>, CellGreater>;

inline bool is_nodata(double v, double no_data, int has_nodata) {
  if (!has_nodata) return false;
  if (std::isnan(no_data)) return std::isnan(v);
  return v == no_data;
}

}  // namespace

extern "C" {

// Priority-Flood fill (Barnes 2014 "improved" + epsilon variants), with
// optional flow-direction and watershed-label outputs.
//
// z: (h*w) float64, modified in place.  eps: 0 = plain fill.
// flowdirs_out: nullable int8 (h*w); labels_out: nullable int64 (h*w).
// Returns 0 on success.
int rn_fill(double* z, int64_t h, int64_t w, double no_data, int has_nodata,
            double eps, int8_t* flowdirs_out, int64_t* labels_out) {
  const int64_t n = h * w;
  std::vector<uint8_t> visited(n, 0);
  std::vector<uint8_t> nodata(n, 0);
  for (int64_t i = 0; i < n; ++i) {
    nodata[i] = is_nodata(z[i], no_data, has_nodata);
    visited[i] = nodata[i];
  }
  if (flowdirs_out)
    for (int64_t i = 0; i < n; ++i) flowdirs_out[i] = FLOWDIR_NO_DATA;
  if (labels_out)
    for (int64_t i = 0; i < n; ++i) labels_out[i] = -1;

  // Seeds: data cells on the border or 8-adjacent to nodata — scanned in
  // row-major order so insertion indices match the Python oracle's
  // np.nonzero order.
  MinHeap heap;
  int64_t k = 0;
  for (int64_t r = 0; r < h; ++r) {
    for (int64_t c = 0; c < w; ++c) {
      const int64_t i = r * w + c;
      if (nodata[i]) continue;
      bool seed = (r == 0 || r == h - 1 || c == 0 || c == w - 1);
      if (!seed) {
        for (int d = 1; d <= 8 && !seed; ++d) {
          const int64_t nr = r + DY[d], nc = c + DX[d];
          if (nr >= 0 && nr < h && nc >= 0 && nc < w &&
              nodata[nr * w + nc])
            seed = true;
        }
      }
      if (seed) {
        heap.push({z[i], k, (int32_t)r, (int32_t)c});
        visited[i] = 1;
        if (flowdirs_out) flowdirs_out[i] = NO_FLOW;
        if (labels_out) labels_out[i] = k;
        ++k;
      }
    }
  }

  // "Improved" variant: plain FIFO pit queue for cells at/below the
  // current spill level — removes most heap operations [P3 §improved].
  std::queue<Cell> pit;
  while (!heap.empty() || !pit.empty()) {
    Cell cell;
    if (!pit.empty()) {
      cell = pit.front();
      pit.pop();
    } else {
      cell = heap.top();
      heap.pop();
    }
    const int64_t ci = (int64_t)cell.r * w + cell.c;
    const double zc = z[ci];
    for (int d = 1; d <= 8; ++d) {
      const int64_t nr = cell.r + DY[d], nc = cell.c + DX[d];
      if (nr < 0 || nr >= h || nc < 0 || nc >= w) continue;
      const int64_t ni = nr * w + nc;
      if (visited[ni]) continue;
      visited[ni] = 1;
      const double lifted = zc + eps;
      if (flowdirs_out) flowdirs_out[ni] = D8_INVERSE[d];
      if (labels_out) labels_out[ni] = labels_out[ci];
      if (z[ni] <= lifted) {
        z[ni] = lifted;
        pit.push({lifted, k++, (int32_t)nr, (int32_t)nc});
      } else {
        heap.push({z[ni], k++, (int32_t)nr, (int32_t)nc});
      }
    }
  }
  if (has_nodata)
    for (int64_t i = 0; i < n; ++i)
      if (nodata[i]) z[i] = no_data;
  return 0;
}

// ---------------------------------------------------------------------------
// Tile consumer for the two-pass distributed fill — the [P1] protocol
// (Barnes 2016, arxiv 1606.06204 §3; SURVEY.md §2.4 row 1, §3.4).
//
// Runs Priority-Flood on ONE tile with the tile perimeter as the flood
// seed set, producing everything the global O(perimeter) combine needs:
//
//   * z filled RELATIVE TO THE TILE PERIMETER (each cell raised to its
//     within-tile spill level; perimeter cells stay at their own z);
//   * a watershed label per cell: 0 = "ocean" (cells on a GLOBAL grid
//     edge per `global_edges` bits, nodata cells, and cells 8-adjacent
//     to nodata — all true drains), 1..k = the perimeter seed the cell
//     was flooded from;
//   * the label-adjacency graph: for every pair of labels whose flood
//     fronts touch, the MINIMUM over touchings of max(filled z on both
//     sides) — the spill elevation joining the two watersheds.
//
// Plain fill only (eps = 0): the label-graph combine computes flat raise
// levels; the epsilon variant stays on the Schwarz path.
//
// global_edges bits: 1 = top row is a global DEM edge, 2 = bottom,
// 4 = left, 8 = right.  Edges are emitted deduplicated with a < b; if
// more than edge_cap exist, rc = 2 and *n_edges holds the required
// capacity (caller reallocates and retries).
int rn_fill_tile(double* z, int64_t h, int64_t w, double no_data,
                 int has_nodata, int global_edges, int32_t* labels_out,
                 int32_t* edge_a, int32_t* edge_b, double* edge_w,
                 int64_t edge_cap, int64_t* n_edges, int32_t* n_labels) {
  const int64_t n = h * w;
  std::vector<uint8_t> visited(n, 0), nodata(n, 0);
  for (int64_t i = 0; i < n; ++i) {
    nodata[i] = is_nodata(z[i], no_data, has_nodata);
    visited[i] = nodata[i];
    labels_out[i] = nodata[i] ? 0 : -1;
  }
  const bool g_top = global_edges & 1, g_bot = global_edges & 2;
  const bool g_left = global_edges & 4, g_right = global_edges & 8;

  MinHeap heap;
  int64_t k = 0;
  int32_t next_label = 1;
  for (int64_t r = 0; r < h; ++r) {
    for (int64_t c = 0; c < w; ++c) {
      const int64_t i = r * w + c;
      if (nodata[i]) continue;
      const bool on_perim = (r == 0 || r == h - 1 || c == 0 || c == w - 1);
      bool near_nodata = false;
      for (int d = 1; d <= 8 && !near_nodata; ++d) {
        const int64_t nr = r + DY[d], nc = c + DX[d];
        if (nr >= 0 && nr < h && nc >= 0 && nc < w && nodata[nr * w + nc])
          near_nodata = true;
      }
      if (!on_perim && !near_nodata) continue;
      const bool ocean = near_nodata || (r == 0 && g_top) ||
                         (r == h - 1 && g_bot) || (c == 0 && g_left) ||
                         (c == w - 1 && g_right);
      labels_out[i] = ocean ? 0 : next_label++;
      visited[i] = 1;
      heap.push({z[i], k++, (int32_t)r, (int32_t)c});
    }
  }

  // flood; record label-front meetings with their joining level.
  std::unordered_map<uint64_t, double> spills;
  std::queue<Cell> pit;
  while (!heap.empty() || !pit.empty()) {
    Cell cell;
    if (!pit.empty()) {
      cell = pit.front();
      pit.pop();
    } else {
      cell = heap.top();
      heap.pop();
    }
    const int64_t ci = (int64_t)cell.r * w + cell.c;
    const double zc = z[ci];
    const int32_t lc = labels_out[ci];
    for (int d = 1; d <= 8; ++d) {
      const int64_t nr = cell.r + DY[d], nc = cell.c + DX[d];
      if (nr < 0 || nr >= h || nc < 0 || nc >= w) continue;
      const int64_t ni = nr * w + nc;
      if (visited[ni]) {
        const int32_t ln = labels_out[ni];
        if (ln >= 0 && ln != lc && !nodata[ni]) {
          // both z final (set at visit time): joining spill level
          const double s = std::max(zc, z[ni]);
          const uint64_t key =
              ((uint64_t)std::min(lc, ln) << 32) | (uint32_t)std::max(lc, ln);
          auto it = spills.find(key);
          if (it == spills.end() || s < it->second) spills[key] = s;
        }
        continue;
      }
      visited[ni] = 1;
      labels_out[ni] = lc;
      if (z[ni] <= zc) {
        z[ni] = zc;
        pit.push({zc, k++, (int32_t)nr, (int32_t)nc});
      } else {
        heap.push({z[ni], k++, (int32_t)nr, (int32_t)nc});
      }
    }
  }

  *n_labels = next_label;
  *n_edges = (int64_t)spills.size();
  if ((int64_t)spills.size() > edge_cap) return 2;
  int64_t e = 0;
  for (const auto& kv : spills) {
    edge_a[e] = (int32_t)(kv.first >> 32);
    edge_b[e] = (int32_t)(kv.first & 0xffffffffu);
    edge_w[e] = kv.second;
    ++e;
  }
  if (has_nodata)
    for (int64_t i = 0; i < n; ++i)
      if (nodata[i]) z[i] = no_data;
  return 0;
}

// D8 steepest-descent flow directions (O'Callaghan 1984 semantics,
// first-max tie-break in direction order 1..8).  d4 != 0 restricts to the
// von Neumann directions {1,3,5,7}.
int rn_d8_flowdirs(const double* z, int8_t* fd, int64_t h, int64_t w,
                   double no_data, int has_nodata, double cellsize, int d4) {
  for (int64_t r = 0; r < h; ++r) {
    for (int64_t c = 0; c < w; ++c) {
      const int64_t i = r * w + c;
      if (is_nodata(z[i], no_data, has_nodata)) {
        fd[i] = FLOWDIR_NO_DATA;
        continue;
      }
      double best = 0.0;
      int best_d = NO_FLOW;
      for (int d = 1; d <= 8; ++d) {
        if (d4 && (d % 2 == 0)) continue;  // diagonals are even codes
        const int64_t nr = r + DY[d], nc = c + DX[d];
        if (nr < 0 || nr >= h || nc < 0 || nc >= w) continue;
        const double zn = z[nr * w + nc];
        if (is_nodata(zn, no_data, has_nodata)) continue;
        const double s = (z[i] - zn) / (DR[d] * cellsize);
        if (s > best) {  // strict > keeps the FIRST max (oracle tie-break)
          best = s;
          best_d = d;
        }
      }
      fd[i] = (int8_t)best_d;
    }
  }
  return 0;
}

// Generic weighted flow accumulation from (h, w, 8) float64 proportions —
// dependency-count topological propagation (Kahn), appendix A.6.
// weights nullable (default 1 per cell).  Returns 0, or 1 if the flow
// graph has a cycle (unfilled DEM).
int rn_accum_props(const double* props, const double* weights, double* acc,
                   int64_t h, int64_t w) {
  const int64_t n = h * w;
  std::vector<int32_t> deps(n, 0);
  for (int64_t i = 0; i < n; ++i) acc[i] = weights ? weights[i] : 1.0;

  for (int64_t r = 0; r < h; ++r)
    for (int64_t c = 0; c < w; ++c) {
      const int64_t i = r * w + c;
      for (int d = 1; d <= 8; ++d) {
        if (props[i * 8 + d - 1] <= 0.0) continue;
        const int64_t nr = r + DY[d], nc = c + DX[d];
        if (nr >= 0 && nr < h && nc >= 0 && nc < w) ++deps[nr * w + nc];
      }
    }

  std::vector<int64_t> queue;
  queue.reserve(n);
  for (int64_t i = 0; i < n; ++i)
    if (deps[i] == 0) queue.push_back(i);
  size_t head = 0;
  int64_t processed = 0;
  while (head < queue.size()) {
    const int64_t i = queue[head++];
    ++processed;
    const int64_t r = i / w, c = i % w;
    for (int d = 1; d <= 8; ++d) {
      const double p = props[i * 8 + d - 1];
      if (p <= 0.0) continue;
      const int64_t nr = r + DY[d], nc = c + DX[d];
      if (nr < 0 || nr >= h || nc < 0 || nc >= w) continue;
      const int64_t ni = nr * w + nc;
      acc[ni] += acc[i] * p;
      if (--deps[ni] == 0) queue.push_back(ni);
    }
  }
  return processed == n ? 0 : 1;
}

// D8 single-flow accumulation (the fast common case — no proportion
// tensor).  fd values: 0 = NO_FLOW (absorbs), -1 = nodata (weight 0,
// absorbs), 1..8 = direction.  Returns 0, or 1 on a cycle.
int rn_accum_d8(const int8_t* fd, const double* weights, double* acc,
                int64_t h, int64_t w) {
  const int64_t n = h * w;
  std::vector<int32_t> deps(n, 0);
  for (int64_t i = 0; i < n; ++i)
    acc[i] = fd[i] < 0 ? 0.0 : (weights ? weights[i] : 1.0);

  for (int64_t r = 0; r < h; ++r)
    for (int64_t c = 0; c < w; ++c) {
      const int64_t i = r * w + c;
      const int d = fd[i];
      if (d <= 0) continue;
      const int64_t nr = r + DY[d], nc = c + DX[d];
      if (nr >= 0 && nr < h && nc >= 0 && nc < w) ++deps[nr * w + nc];
    }

  std::vector<int64_t> queue;
  queue.reserve(n);
  for (int64_t i = 0; i < n; ++i)
    if (deps[i] == 0) queue.push_back(i);
  size_t head = 0;
  int64_t processed = 0;
  while (head < queue.size()) {
    const int64_t i = queue[head++];
    ++processed;
    const int d = fd[i];
    if (d <= 0) continue;
    const int64_t r = i / w, c = i % w;
    const int64_t nr = r + DY[d], nc = c + DX[d];
    if (nr < 0 || nr >= h || nc < 0 || nc >= w) continue;
    const int64_t ni = nr * w + nc;
    acc[ni] += acc[i];
    if (--deps[ni] == 0) queue.push_back(ni);
  }
  return processed == n ? 0 : 1;
}

}  // extern "C"

extern "C" {

// Lindsay 2016 depression breaching — mirrors oracle/breach.py exactly
// (same pit definition, same cheapest-spill-first flood with backlinks,
// same carve semantics; SURVEY.md §2.2 Lindsay2016.hpp row).
// mode: 0=Complete 1=Selective 2=Constrained.  max_path_len < 0 or
// max_path_depth < 0 mean "unset".  fill_remainder handled by the caller.
int rn_breach(double* z, int64_t h, int64_t w, double no_data,
              int has_nodata, int mode, double eps, int64_t max_path_len,
              double max_path_depth) {
  const int64_t n = h * w;
  std::vector<uint8_t> nodata(n, 0), visited(n, 0), seed(n, 0), pit(n, 0);
  std::vector<int8_t> backlink(n, 0);
  std::vector<double> orig(z, z + n);
  for (int64_t i = 0; i < n; ++i) {
    nodata[i] = is_nodata(z[i], no_data, has_nodata);
    visited[i] = nodata[i];
  }
  for (int64_t r = 0; r < h; ++r)
    for (int64_t c = 0; c < w; ++c) {
      const int64_t i = r * w + c;
      if (nodata[i]) continue;
      bool s = (r == 0 || r == h - 1 || c == 0 || c == w - 1);
      for (int d = 1; d <= 8 && !s; ++d) {
        const int64_t nr = r + DY[d], nc = c + DX[d];
        if (nr >= 0 && nr < h && nc >= 0 && nc < w && nodata[nr * w + nc])
          s = true;
      }
      seed[i] = s;
      if (!s) {
        bool p = true;
        for (int d = 1; d <= 8 && p; ++d) {
          const int64_t nr = r + DY[d], nc = c + DX[d];
          if (nr >= 0 && nr < h && nc >= 0 && nc < w &&
              !nodata[nr * w + nc] && z[nr * w + nc] < z[i])
            p = false;
        }
        pit[i] = p;
      }
    }

  MinHeap heap;
  int64_t k = 0;
  for (int64_t r = 0; r < h; ++r)
    for (int64_t c = 0; c < w; ++c) {
      const int64_t i = r * w + c;
      if (seed[i] && !nodata[i]) {
        heap.push({z[i], k++, (int32_t)r, (int32_t)c});
        visited[i] = 1;
      }
    }

  std::vector<int64_t> path_cells;
  std::vector<double> path_targets;
  while (!heap.empty()) {
    Cell cell = heap.top();
    heap.pop();
    const int64_t ci = (int64_t)cell.r * w + cell.c;
    if (pit[ci]) {
      // Walk backlinks from the pit, collecting cells to lower.
      const double level = z[ci];
      path_cells.clear();
      path_targets.clear();
      int64_t r = cell.r, c = cell.c, steps = 0;
      while (true) {
        const int d = backlink[r * w + c];
        if (d == 0) break;  // reached a seed
        r += DY[d];
        c += DX[d];
        ++steps;
        const double target = level - (double)steps * eps;
        if (z[r * w + c] <= target) break;
        path_cells.push_back(r * w + c);
        path_targets.push_back(target);
      }
      bool carve = true;
      if (mode == 1) {  // Selective
        if (max_path_len >= 0 && (int64_t)path_cells.size() > max_path_len)
          carve = false;
        if (carve && max_path_depth >= 0)
          for (size_t j = 0; j < path_cells.size(); ++j)
            if (orig[path_cells[j]] - path_targets[j] > max_path_depth) {
              carve = false;
              break;
            }
      }
      if (carve)
        for (size_t j = 0; j < path_cells.size(); ++j) {
          double target = path_targets[j];
          if (mode == 2 && max_path_depth >= 0)
            target = std::max(target, orig[path_cells[j]] - max_path_depth);
          z[path_cells[j]] = std::min(z[path_cells[j]], target);
        }
    }
    for (int d = 1; d <= 8; ++d) {
      const int64_t nr = cell.r + DY[d], nc = cell.c + DX[d];
      if (nr < 0 || nr >= h || nc < 0 || nc >= w) continue;
      const int64_t ni = nr * w + nc;
      if (visited[ni]) continue;
      visited[ni] = 1;
      backlink[ni] = D8_INVERSE[d];
      heap.push({z[ni], k++, (int32_t)nr, (int32_t)nc});
    }
  }
  if (has_nodata)
    for (int64_t i = 0; i < n; ++i)
      if (nodata[i]) z[i] = no_data;
  return 0;
}

// Barnes-Lehman-Mulla 2014 flat resolution — mirrors oracle/flats.py
// (same virtual-drain rule, same two BFS fields, same 2*T + (H+1-D)
// combination, same steepest-descent-on-mask direction assignment).
// fd is modified in place; flat_mask_out/labels_out nullable int32.
int rn_resolve_flats(const double* z, int8_t* fd, int64_t h, int64_t w,
                     double no_data, int has_nodata, int32_t* flat_mask_out,
                     int32_t* labels_out) {
  const int64_t n = h * w;
  std::vector<uint8_t> nodata(n, 0);
  for (int64_t i = 0; i < n; ++i)
    nodata[i] = is_nodata(z[i], no_data, has_nodata);
  std::vector<uint8_t> noflow(n, 0), drain(n, 0);
  for (int64_t r = 0; r < h; ++r)
    for (int64_t c = 0; c < w; ++c) {
      const int64_t i = r * w + c;
      noflow[i] = (fd[i] == NO_FLOW) && !nodata[i];
      bool dr = (r == 0 || r == h - 1 || c == 0 || c == w - 1);
      for (int d = 1; d <= 8 && !dr; ++d) {
        const int64_t nr = r + DY[d], nc = c + DX[d];
        if (nr >= 0 && nr < h && nc >= 0 && nc < w && nodata[nr * w + nc])
          dr = true;
      }
      drain[i] = dr && noflow[i];
    }

  // Label flats: flood equal-elevation regions from NO_FLOW cells.
  std::vector<int32_t> labels(n, 0);
  int32_t next_label = 1;
  std::vector<int64_t> bfs;
  for (int64_t i0 = 0; i0 < n; ++i0) {
    if (!noflow[i0] || labels[i0]) continue;
    const double elev = z[i0];
    labels[i0] = next_label;
    bfs.clear();
    bfs.push_back(i0);
    size_t head = 0;
    while (head < bfs.size()) {
      const int64_t i = bfs[head++];
      const int64_t r = i / w, c = i % w;
      for (int d = 1; d <= 8; ++d) {
        const int64_t nr = r + DY[d], nc = c + DX[d];
        if (nr < 0 || nr >= h || nc < 0 || nc >= w) continue;
        const int64_t ni = nr * w + nc;
        if (labels[ni] == 0 && !nodata[ni] && z[ni] == elev) {
          labels[ni] = next_label;
          bfs.push_back(ni);
        }
      }
    }
    ++next_label;
  }

  // Seeds: outlets (T=0) and high edges (D=1).
  std::vector<int32_t> towards(n, 0), away(n, 0);
  std::vector<uint8_t> visited_t(n, 0), visited_a(n, 0);
  std::vector<uint8_t> drainable(next_label, 0);
  std::vector<int64_t> tq, aq;
  for (int64_t r = 0; r < h; ++r)
    for (int64_t c = 0; c < w; ++c) {
      const int64_t i = r * w + c;
      if (labels[i] == 0) continue;
      if (!noflow[i] || drain[i]) {
        tq.push_back(i);
        visited_t[i] = 1;
        drainable[labels[i]] = 1;
        if (!noflow[i]) continue;
      }
      for (int d = 1; d <= 8; ++d) {
        const int64_t nr = r + DY[d], nc = c + DX[d];
        if (nr < 0 || nr >= h || nc < 0 || nc >= w) continue;
        const int64_t ni = nr * w + nc;
        if (!nodata[ni] && z[ni] > z[i]) {
          away[i] = 1;
          visited_a[i] = 1;
          aq.push_back(i);
          break;
        }
      }
    }

  // BFS towards lower (among NO_FLOW same-label cells).
  size_t head = 0;
  while (head < tq.size()) {
    const int64_t i = tq[head++];
    const int64_t r = i / w, c = i % w;
    for (int d = 1; d <= 8; ++d) {
      const int64_t nr = r + DY[d], nc = c + DX[d];
      if (nr < 0 || nr >= h || nc < 0 || nc >= w) continue;
      const int64_t ni = nr * w + nc;
      if (noflow[ni] && labels[ni] == labels[i] && !visited_t[ni]) {
        visited_t[ni] = 1;
        towards[ni] = towards[i] + 1;
        tq.push_back(ni);
      }
    }
  }
  // BFS away from higher.
  head = 0;
  while (head < aq.size()) {
    const int64_t i = aq[head++];
    const int64_t r = i / w, c = i % w;
    for (int d = 1; d <= 8; ++d) {
      const int64_t nr = r + DY[d], nc = c + DX[d];
      if (nr < 0 || nr >= h || nc < 0 || nc >= w) continue;
      const int64_t ni = nr * w + nc;
      if (noflow[ni] && labels[ni] == labels[i] && !visited_a[ni]) {
        visited_a[ni] = 1;
        away[ni] = away[i] + 1;
        aq.push_back(ni);
      }
    }
  }

  std::vector<int32_t> flat_height(next_label, 0);
  for (int64_t i = 0; i < n; ++i)
    if (labels[i] > 0)
      flat_height[labels[i]] = std::max(flat_height[labels[i]], away[i]);

  std::vector<int32_t> mask(n, 0);
  for (int64_t i = 0; i < n; ++i) {
    if (!noflow[i] || drain[i] || labels[i] == 0) continue;
    if (!drainable[labels[i]] || !visited_t[i]) continue;
    int32_t m = 2 * towards[i];
    if (away[i] > 0) m += flat_height[labels[i]] + 1 - away[i];
    mask[i] = m;
  }

  // Steepest descent on the mask among same-flat neighbors.
  for (int64_t r = 0; r < h; ++r)
    for (int64_t c = 0; c < w; ++c) {
      const int64_t i = r * w + c;
      if (mask[i] == 0 || fd[i] != NO_FLOW) continue;
      int best_d = NO_FLOW;
      double best_s = 0.0;
      for (int d = 1; d <= 8; ++d) {
        const int64_t nr = r + DY[d], nc = c + DX[d];
        if (nr < 0 || nr >= h || nc < 0 || nc >= w) continue;
        const int64_t ni = nr * w + nc;
        if (labels[ni] != labels[i]) continue;
        const double s = (double)(mask[i] - mask[ni]) / DR[d];
        if (s > best_s) {
          best_s = s;
          best_d = d;
        }
      }
      fd[i] = (int8_t)best_d;
    }

  if (flat_mask_out) std::memcpy(flat_mask_out, mask.data(), n * 4);
  if (labels_out) std::memcpy(labels_out, labels.data(), n * 4);
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Divergent flow metrics + terrain tail — the single-core counterparts of
// the TPU pipeline configs (bench.py BENCH_CONFIG=dinf_twi / quinn_mfd), so
// each config's vs_baseline divides by a baseline doing the SAME work.
// Mirrors richdem_tpu/oracle/flowdirs.py (Tarboton 1997 facets, Quinn/
// Holmgren slope^exponent proportions; reference flowmet/ semantics per
// SURVEY.md §2.2, appendix A.4/A.5) and oracle/terrain.py (Horn 1981).
// ---------------------------------------------------------------------------

namespace {

// Tarboton facet table — (e1, e2, ac, af) with the facet's global angle
// af*r + ac*pi/2, CCW from East.  MUST match oracle/flowdirs._DINF_FACETS.
const int FACET_E1[8] = {5, 3, 3, 1, 1, 7, 7, 5};
const int FACET_E2[8] = {4, 4, 2, 2, 8, 8, 6, 6};
const int FACET_AC[8] = {0, 1, 1, 2, 2, 3, 3, 4};
const int FACET_AF[8] = {1, -1, 1, -1, 1, -1, 1, -1};

// D8 direction code at angle k*pi/4 (k = 0..7): E,NE,N,NW,W,SW,S,SE.
const int OCTANT_DIRS[8] = {5, 4, 3, 2, 1, 8, 7, 6};

}  // namespace

extern "C" {

// D-infinity flow angles, radians CCW-from-East; -1 = NO_FLOW, -2 = nodata.
int rn_dinf_flowdirs(const double* z, double* ang, int64_t h, int64_t w,
                     double no_data, int has_nodata, double cellsize) {
  const double d1 = cellsize, d2 = cellsize;
  const double rmax = std::atan2(d2, d1);
  const double diag = std::hypot(d1, d2);
  const double pi = 3.14159265358979323846;
  for (int64_t r = 0; r < h; ++r) {
    for (int64_t c = 0; c < w; ++c) {
      const int64_t i = r * w + c;
      if (is_nodata(z[i], no_data, has_nodata)) {
        ang[i] = -2.0;
        continue;
      }
      const double z0 = z[i];
      double best_s = 0.0, best_angle = -1.0;
      bool have = false;
      for (int f = 0; f < 8; ++f) {
        const int e1 = FACET_E1[f], e2 = FACET_E2[f];
        const int64_t r1 = r + DY[e1], c1 = c + DX[e1];
        const int64_t r2 = r + DY[e2], c2 = c + DX[e2];
        const bool ok1 = r1 >= 0 && r1 < h && c1 >= 0 && c1 < w &&
                         !is_nodata(z[r1 * w + c1], no_data, has_nodata);
        const bool ok2 = r2 >= 0 && r2 < h && c2 >= 0 && c2 < w &&
                         !is_nodata(z[r2 * w + c2], no_data, has_nodata);
        if (!ok1 && !ok2) continue;
        const double z1 = ok1 ? z[r1 * w + c1] : z0;
        const double z2 = ok2 ? z[r2 * w + c2] : z1;
        const double s1 = (z0 - z1) / d1;
        const double s2 = (z1 - z2) / d2;
        double rr = (s1 != 0.0 || s2 != 0.0) ? std::atan2(s2, s1) : 0.0;
        double ss;
        if (rr < 0.0) {
          rr = 0.0;
          ss = s1;
        } else if (rr > rmax) {
          rr = rmax;
          ss = (z0 - z2) / diag;
        } else {
          ss = std::hypot(s1, s2);
        }
        if (ss > best_s) {
          best_s = ss;
          best_angle = FACET_AF[f] * rr + FACET_AC[f] * (pi / 2.0);
          have = true;
        }
      }
      if (have) {
        double a = std::fmod(best_angle, 2.0 * pi);
        if (a < 0.0) a += 2.0 * pi;
        ang[i] = a;
      } else {
        ang[i] = -1.0;
      }
    }
  }
  return 0;
}

// (h, w, 8) proportions from a D-infinity angle raster (octant split).
int rn_dinf_props(const double* ang, double* props, int64_t h, int64_t w) {
  const double quarter = 3.14159265358979323846 / 4.0;
  std::memset(props, 0, sizeof(double) * (size_t)(h * w * 8));
  for (int64_t i = 0; i < h * w; ++i) {
    const double a = ang[i];
    if (a < 0.0) continue;  // NO_FLOW or nodata
    int k = ((int)(a / quarter)) % 8;
    const double frac = (a - k * quarter) / quarter;
    props[i * 8 + OCTANT_DIRS[k] - 1] += 1.0 - frac;
    props[i * 8 + OCTANT_DIRS[(k + 1) % 8] - 1] += frac;
  }
  return 0;
}

// Generic MFD proportions: fraction toward d proportional to
// max(slope_d, 0)^exponent (Quinn 1991 at exponent 1, Holmgren 1994,
// Freeman 1991 at 1.1).
int rn_mfd_props(const double* z, double* props, int64_t h, int64_t w,
                 double no_data, int has_nodata, double exponent) {
  std::memset(props, 0, sizeof(double) * (size_t)(h * w * 8));
  for (int64_t r = 0; r < h; ++r) {
    for (int64_t c = 0; c < w; ++c) {
      const int64_t i = r * w + c;
      if (is_nodata(z[i], no_data, has_nodata)) continue;
      double wts[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      double total = 0.0;
      for (int d = 1; d <= 8; ++d) {
        const int64_t nr = r + DY[d], nc = c + DX[d];
        if (nr < 0 || nr >= h || nc < 0 || nc >= w) continue;
        const double zn = z[nr * w + nc];
        if (is_nodata(zn, no_data, has_nodata)) continue;
        const double s = (z[i] - zn) / DR[d];
        if (s > 0.0) {
          wts[d - 1] = std::pow(s, exponent);
          total += wts[d - 1];
        }
      }
      if (total > 0.0)
        for (int d = 0; d < 8; ++d) props[i * 8 + d] = wts[d] / total;
    }
  }
  return 0;
}

// Horn 1981 slope in radians (out-of-bounds/nodata window cells replaced
// by the center value, as in oracle/terrain.py); nodata cells -> NaN.
int rn_slope_radians(const double* z, double* out, int64_t h, int64_t w,
                     double no_data, int has_nodata, double zscale,
                     double cellsize) {
  for (int64_t r = 0; r < h; ++r) {
    for (int64_t c = 0; c < w; ++c) {
      const int64_t i = r * w + c;
      if (is_nodata(z[i], no_data, has_nodata)) {
        out[i] = std::nan("");
        continue;
      }
      const double e = z[i] * zscale;
      double win[9];  // a b c / d e f / g h i, row-major window
      int k = 0;
      for (int dr = -1; dr <= 1; ++dr)
        for (int dc = -1; dc <= 1; ++dc, ++k) {
          const int64_t nr = r + dr, nc = c + dc;
          if (nr < 0 || nr >= h || nc < 0 || nc >= w ||
              is_nodata(z[nr * w + nc], no_data, has_nodata))
            win[k] = e;
          else
            win[k] = z[nr * w + nc] * zscale;
        }
      const double fx = ((win[2] + 2 * win[5] + win[8]) -
                         (win[0] + 2 * win[3] + win[6])) / (8 * cellsize);
      const double fy = ((win[6] + 2 * win[7] + win[8]) -
                         (win[0] + 2 * win[1] + win[2])) / (8 * cellsize);
      out[i] = std::atan(std::hypot(fx, fy));
    }
  }
  return 0;
}

// Topographic wetness index ln(a / tan(beta)) — appendix A.7 semantics.
int rn_twi(const double* acc, const double* slope, double* out, int64_t n,
           double cellsize, double min_slope) {
  for (int64_t i = 0; i < n; ++i) {
    const double a = std::max(acc[i] * cellsize, 1e-30);
    const double tanb = std::max(std::tan(slope[i]), min_slope);
    out[i] = std::log(a / tanb);
  }
  return 0;
}

}  // extern "C"
