// One directional Gauss-Seidel sweep of a masked unit-cost distance
// fixpoint (flat resolution):
//
//     D(c) = min( D(c), min_{n admissible} D(n) + step )
//
// over the three neighbours in the row before (N straight, NW/NE diagonal),
// walking a row-major float32 (H, W) raster down (reverse = 0) or up
// (reverse = 1).  An edge n -> c is admissible when both cells hold one data
// elevation (z < 2.9e37; nodata carries 3e37) and their flag bytes pass the
// mode's test (bits: 1 data, 2 NO_FLOW, 4 in a flat):
//
//   member  (0): both data
//   towards (1): c NO_FLOW and in a flat, n in a flat
//   away    (2): both NO_FLOW and in a flat
//   maxd    (3): both in a flat                 (min-plus on -D, step 0)
//
// Off-grid cells are w = BIG, z = 3e37, flags 0: they never relax a cell.
// Admissibility is recomputed here from z and the flags, so no (8, H, W)
// cost planes are built.  The in-row E/W chains are left to the transposed
// sweeps of the rotation.
//
// Replaces the TPU kernels richdem_tpu/ops/pallas_sweeps.py:_dist_down_kernel
// (line 396) and richdem_tpu/ops/pallas_scan.py:_dist_scan_kernel (line
// 1121).  Both relax the same fixpoint, which has one answer in exact small
// integers, so the sweep order (and the scan kernel's in-row tropical
// scans) changes only the number of rotations, never the result.
//
// The walk is seam_walk.cuh: narrow tiles (_build.DIST_TILE, DIST_HALO)
// that trade edge values, so one sweep is the sweep over whole rows,
// whatever the tile (bitwise).  A stage holds the sweep-start w of row r
// and the z and flags of rows r - 1 and r; z and flags never change, so
// ghost columns read the same as their owners.
//
// What bounds it on an H100: the row-to-row dependency.  Per cell a sweep
// reads w, z and a flag byte and writes w, 13 bytes; a cell's rule is 3
// tests, adds and minima, so a row step is the latency of its shared-
// memory reads, its rule and one barrier.
//
// Change flag: one atomicOr per block into `changed` when any cell the
// block owns changed (ghost columns do not count); every sweep is
// idempotent at the fixpoint.

#include "seam_walk.cuh"

#ifndef RD_DIST_TILE
#define RD_DIST_TILE 128
#endif
#ifndef RD_DIST_HALO
#define RD_DIST_HALO 64
#endif

namespace {

constexpr float BIG = 1.0e30f;     // unreached
constexpr float ZVALID = 2.9e37f;  // z < ZVALID: a data elevation
constexpr int F_DATA = 1, F_NOFLOW = 2, F_INFLAT = 4;
constexpr int NF_IN = F_NOFLOW | F_INFLAT;

// the cell's side of the mode's test
template <int MODE>
__device__ __forceinline__ bool cell_ok(int s) {
  if (MODE == 0) return (s & F_DATA) != 0;
  if (MODE == 3) return (s & F_INFLAT) != 0;
  return (s & NF_IN) == NF_IN;  // towards, away
}

// the neighbour's side of the mode's test
template <int MODE>
__device__ __forceinline__ bool nb_ok(int sn) {
  if (MODE == 0) return (sn & F_DATA) != 0;
  if (MODE == 2) return (sn & NF_IN) == NF_IN;
  return (sn & F_INFLAT) != 0;  // towards, maxd
}

template <int MODE>
struct DistSweep {
  using T = float;
  static constexpr T OFF = BIG;
  static constexpr int TILE = RD_DIST_TILE;
  static constexpr int HALO = RD_DIST_HALO;
  static constexpr bool FLAG = true;
  // slots: w of row r; z of rows r - 1 and r; flags of rows r - 1 and r
  static constexpr int NSLOT = 5, OWN = 0;
  struct Args {
    const float* w_in;
    const float* z;
    const int8_t* fl;
    int* changed;
    float step;
  };
  __host__ __device__ static constexpr int elem(int q) { return q < 3 ? 4 : 1; }
  __host__ __device__ static constexpr int row(int q) {
    return q == 1 || q == 3 ? -1 : 0;
  }
  __device__ static const void* raster(const Args& a, int q) {
    return q == 0 ? static_cast<const void*>(a.w_in)
                  : (q < 3 ? static_cast<const void*>(a.z)
                           : static_cast<const void*>(a.fl));
  }
  __device__ static int* changed(const Args& a) { return a.changed; }

  // min(w, min over the admissible NW, N, NE of the row before of their
  // new w + step); off the grid z = ZBIG and flags 0 admit nothing.  Every
  // operand is read and the tests are selects, so a warp does not diverge
  // (a column off the grid reads stage bytes that the test then ignores).
  template <int REV, class View, class Before>
  __device__ static T update(const Args& a, const View& v, int i, int w,
                             Before before) {
    const float wr = v.template at<float>(0, i);
    const float zc = v.template at<float>(2, i);
    const int sc = v.template at<int8_t>(4, i);
    const bool ok = v.prev && zc < ZVALID && cell_ok<MODE>(sc);
    float cand = BIG;
#pragma unroll
    for (int o = -1; o <= 1; ++o) {  // NW, N, NE of the row before
      const int c = i + o;
      const bool in = ok && c >= 0 && c < w;
      const float zn = v.template at<float>(1, c);
      const int sn = v.template at<int8_t>(3, c);
      const float nv = before(o) + a.step;
      cand = in && zn == zc && nb_ok<MODE>(sn) && nv < cand ? nv : cand;
    }
    return cand < wr ? cand : wr;
  }
};

template <int MODE>
int launch(const float* w_in, const float* z, const int8_t* flags,
           float* w_out, int* changed, int h, int w, float step, int reverse,
           int* blk, int blk_len, void* stream) {
  return rd::walk::launch<DistSweep<MODE>>({w_in, z, flags, changed, step},
                                           w_out, h, w, reverse, blk,
                                           blk_len, stream);
}

}  // namespace

// The walk's shape into out[0..3]: tile columns, halo columns, consumer
// threads a block, ring stages.
extern "C" int rd_dist_shape(int* out) {
  return rd::walk::shape<DistSweep<1>>(out);
}

// `blk`: blk_len ints of scratch on the stream's device, one a block
// (ceil(w / TILE) always suffice), cleared here on `stream`; too few
// return cudaErrorInvalidValue.  `changed`: one int, ORed with 1 when any
// cell changed.
extern "C" int rd_dist_sweep(const float* w_in, const float* z,
                             const int8_t* flags, float* w_out, int* changed,
                             int h, int w, int mode, float step, int reverse,
                             int* blk, int blk_len, void* stream) {
  switch (mode) {
    case 0:
      return launch<0>(w_in, z, flags, w_out, changed, h, w, step, reverse,
                       blk, blk_len, stream);
    case 1:
      return launch<1>(w_in, z, flags, w_out, changed, h, w, step, reverse,
                       blk, blk_len, stream);
    case 2:
      return launch<2>(w_in, z, flags, w_out, changed, h, w, step, reverse,
                       blk, blk_len, stream);
    case 3:
      return launch<3>(w_in, z, flags, w_out, changed, h, w, step, reverse,
                       blk, blk_len, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
