// One directional sweep of multi-flow accumulation, A = w + P^T A, over
// plane-major proportions (8, H, W): plane d - 1 holds each cell's share
// toward D8 direction d (Quinn, Freeman, Holmgren, Seibert-McGlynn, D8).
//
// Replaces the TPU kernels richdem_tpu/ops/pallas_mfd.py:_mfd_kernel (line
// 49) and _mfd_kernel_small (line 290), the Gauss-Seidel sweeps (lim = 1),
// and richdem_tpu/ops/pallas_scan.py:_mfd_scan_kernel (line 515), the
// scan-GS sweep at any depth.  The sweep itself is flow_sweep.cuh; this
// file loads the planes.  The folded/small split exists only because
// folding pads to 1024 on the TPU.
//
// What bounds it on an H100: the row-to-row dependency (flow_sweep.cuh).
// Per cell a sweep reads acc, w and the 8 planes and writes acc, 44 bytes:
// each plane is read once, as each of the 8 taps plays one role per sweep
// (new-side trio, old-side trio, the two in-row gates).  Loads run PF = 2
// rows ahead to keep the 10 prefetched values per thread in registers at
// 1024 threads a block; the halo threads load only the 3 planes a halo
// column feeds.

#include "flow_sweep.cuh"

namespace {

struct MfdField {
  struct Ptrs {
    const float* planes;
    size_t plane;  // elements per plane, H * W
  };
  struct Own {
    float p[8];  // index d - 1: tap toward direction d
  };
  struct Halo {
    float p[3];
  };
  struct Shared {
    float p[8][4][rd::W2];
  };

  const float* __restrict__ planes;
  size_t plane;
  Shared* sh;

  __device__ MfdField(Ptrs ptrs, Shared* s)
      : planes(ptrs.planes), plane(ptrs.plane), sh(s) {}

  // the three directions a halo column feeds: left (side 0) the west
  // sources of the two trios and the E gate, right the east ones and W
  template <int REV>
  static __device__ int halo_dir(int side, int n) {
    using D = rd::Dirs<REV>;
    if (side == 0) return n == 0 ? D::NW : (n == 1 ? D::OW : D::IE);
    return n == 0 ? D::NE : (n == 1 ? D::OE : D::IW);
  }

  static __device__ void clear(Own& x) {
#pragma unroll
    for (int d = 0; d < 8; ++d) x.p[d] = 0.0f;
  }
  static __device__ void clear(Halo& x) {
#pragma unroll
    for (int n = 0; n < 3; ++n) x.p[n] = 0.0f;
  }
  __device__ void load(size_t i, Own& x) const {
#pragma unroll
    for (int d = 0; d < 8; ++d) x.p[d] = planes[d * plane + i];
  }
  template <int REV>
  __device__ void load_halo(size_t i, int side, Halo& x) const {
#pragma unroll
    for (int n = 0; n < 3; ++n)
      x.p[n] = planes[(halo_dir<REV>(side, n) - 1) * plane + i];
  }
  __device__ void stage(int slot, int i, const Own& x) const {
#pragma unroll
    for (int d = 0; d < 8; ++d) sh->p[d][slot][i] = x.p[d];
  }
  template <int REV>
  __device__ void stage_halo(int slot, int i, int side, const Halo& x) const {
#pragma unroll
    for (int n = 0; n < 3; ++n)
      sh->p[halo_dir<REV>(side, n) - 1][slot][i] = x.p[n];
  }
  __device__ void zero(int slot, int i) const {
#pragma unroll
    for (int d = 0; d < 8; ++d) sh->p[d][slot][i] = 0.0f;
  }
  template <int DIR>
  __device__ float tap(int slot, int i) const {
    return sh->p[DIR - 1][slot][i];
  }
};

}  // namespace

extern "C" int rd_mfd_sweep(const float* acc_in, const float* wgt,
                            const float* planes, float* acc_out, int h,
                            int w, int reverse, int lim, void* stream) {
  const MfdField::Ptrs ptrs{planes,
                            static_cast<size_t>(h) * static_cast<size_t>(w)};
  return rd::launch_flow_sweep<MfdField, 2>(acc_in, wgt, ptrs, acc_out, h, w,
                                            reverse, lim, stream);
}
