// One directional sweep of D-infinity accumulation, A = w + P^T A, on the
// packed two-tap field v = code + p/2 (0 = NO_FLOW): a cell sends p of its
// acc toward `code` and 1 - p toward next(code) = code % 8 + 1.
//
// Replaces the TPU kernels richdem_tpu/ops/pallas_dinf.py:_dinf_kernel
// (line 131, the Gauss-Seidel sweep: lim = 1) and
// richdem_tpu/ops/pallas_scan.py:_accum_scan_kernel (line 177, the scan-GS
// sweep with D-infinity taps, any depth; its D8 form is this kernel with
// p = 1).  The sweep itself is flow_sweep.cuh; this file decodes the field.
// Folding, strip heights and index-mapped boundary groups are TPU artefacts
// and are not carried over.
//
// What bounds it on an H100: the row-to-row dependency (flow_sweep.cuh).
// Per cell a sweep reads acc, w and v and writes acc, 16 bytes.  An item
// stages v of rows r - 1, r + 1 and r (the second and third reads of a row
// hit L2); a tap decodes its staged v (floor, cast, one subtract): p toward
// code, 1 - p toward next(code), 0 elsewhere (code 0 matches no direction).

#include "flow_sweep.cuh"

namespace {

using rd::flow::View;

struct DinfField {
  struct Ptrs {
    const float* v;
  };
  // acc, w, acc of the row after; then v of rows r - 1, r + 1 and r
  static constexpr int NSLOT = 3 + 3;

  template <int REV>
  static __device__ const float* source(const Ptrs& p, int q, int& dr) {
    dr = q == 3 ? -1 : (q == 4 ? 1 : 0);
    return p.v;
  }
  // weight toward the role's direction of staged column c (on the grid
  // if `in`)
  template <int REV, int ROLE>
  static __device__ float tap(const View<NSLOT>& v, int c, bool in) {
    constexpr int DR = rd::flow::row_of(ROLE);
    constexpr int DIR = rd::flow::Dirs<REV>::of(ROLE);
    constexpr int PREV = DIR == 1 ? 8 : DIR - 1;  // next(PREV) == DIR
    const float x = v.at(DR < 0 ? 3 : (DR > 0 ? 4 : 5), c,
                         in && v.row_ok(DR));
    const float fl = floorf(x);
    const int cd = static_cast<int>(fl);
    const float p = (x - fl) * 2.0f;
    return cd == DIR ? p : (cd == PREV ? 1.0f - p : 0.0f);
  }
};

}  // namespace

extern "C" int rd_dinf_sweep(const float* acc_in, const float* wgt,
                             const float* v, float* acc_out, int h, int w,
                             int reverse, int lim, int* flags,
                             int flags_len, void* stream) {
  return rd::launch_flow_sweep<DinfField>(acc_in, wgt, DinfField::Ptrs{v},
                                          acc_out, h, w, reverse, lim,
                                          flags, flags_len, stream);
}
