// One directional sweep of multi-flow accumulation, A = w + P^T A, over
// plane-major proportions (8, H, W): plane d - 1 holds each cell's share
// toward D8 direction d (Quinn, Freeman, Holmgren, Seibert-McGlynn, D8).
//
// Replaces the TPU kernels richdem_tpu/ops/pallas_mfd.py:_mfd_kernel (line
// 49) and _mfd_kernel_small (line 290), the Gauss-Seidel sweeps (lim = 1),
// and richdem_tpu/ops/pallas_scan.py:_mfd_scan_kernel (line 515), the
// scan-GS sweep at any depth.  The sweep itself is flow_sweep.cuh; this
// file says which plane rows an item stages.  The folded/small split exists
// only because folding pads to 1024 on the TPU.
//
// What bounds it on an H100: the row-to-row dependency (flow_sweep.cuh).
// Per cell a sweep reads acc, w and the 8 planes and writes acc, 44 bytes:
// each of the 8 taps plays one role a sweep (new-side trio, old-side trio,
// the two in-row gates), so an item stages each plane's row once, for the
// role it plays there: the new-side trio of row r - 1, the old-side trio of
// row r + 1 and the gates of row r, 11 slots with acc and w.
//
// The same field feeds the topological pass of flow_topo.cuh (rd_mfd_topo
// below), which solves an acyclic field once instead of by rotations of
// this sweep; the sweep stays as its fallback.

#include "flow_sweep.cuh"
#include "flow_topo.cuh"

namespace {

using rd::flow::View;

struct MfdField {
  struct Ptrs {
    const float* planes;
    size_t plane;  // elements per plane, H * W
  };
  // acc, w, acc of the row after; then one plane row per role
  static constexpr int NSLOT = 3 + 8;

  template <int REV>
  static __device__ const float* source(const Ptrs& p, int q, int& dr) {
    const int role = q - 3;
    dr = rd::flow::row_of(role);
    return p.planes + (rd::flow::Dirs<REV>::of(role) - 1) * p.plane;
  }
  // weight toward the role's direction of staged column c (on the grid
  // if `in`)
  template <int REV, int ROLE>
  static __device__ float tap(const View<NSLOT>& v, int c, bool in) {
    return v.at(3 + ROLE, c, in && v.row_ok(rd::flow::row_of(ROLE)));
  }
  // share of cell i toward direction d (flow_topo.cuh), read-only; the
  // shares are fractions, laid out for the solve by the count kernel
  static constexpr bool UNIT = false;
  static __device__ float share(const Ptrs& p, int d, int i) {
    return __ldg(p.planes + (d - 1) * p.plane + i);
  }
};

}  // namespace

extern "C" int rd_mfd_sweep(const float* acc_in, const float* wgt,
                            const float* planes, float* acc_out, int h,
                            int w, int reverse, int lim, int* flags,
                            int flags_len, void* stream) {
  const MfdField::Ptrs ptrs{planes,
                            static_cast<size_t>(h) * static_cast<size_t>(w)};
  return rd::launch_flow_sweep<MfdField>(acc_in, wgt, ptrs, acc_out, h, w,
                                         reverse, lim, flags, flags_len,
                                         stream);
}

extern "C" int rd_mfd_topo(const float* planes, const float* wgt, float* acc,
                           int* deps, float* inshare,
                           unsigned long long* order, int* ctl, int h, int w,
                           void* stream) {
  const MfdField::Ptrs ptrs{planes,
                            static_cast<size_t>(h) * static_cast<size_t>(w)};
  return rd::launch_flow_topo<MfdField>(ptrs, wgt, acc, deps, inshare, order,
                                        ctl, h, w, stream);
}
