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
// Per cell a sweep reads acc, w and v and writes acc, 16 bytes.  The field
// is decoded once per row as it is staged (floor, cast, one subtract), into
// an int8 code and a float p in shared memory; a tap is then two compares
// and a select: p toward code, 1 - p toward next(code), 0 elsewhere (code
// 0 matches no direction).

#include "flow_sweep.cuh"

namespace {

struct DinfField {
  struct Ptrs {
    const float* v;
  };
  struct Val {
    float v;
  };
  using Own = Val;
  using Halo = Val;
  struct Shared {
    float p[4][rd::W2];
    int8_t code[4][rd::W2];
  };

  const float* __restrict__ v;
  Shared* sh;

  __device__ DinfField(Ptrs ptrs, Shared* s) : v(ptrs.v), sh(s) {}

  static __device__ void clear(Val& x) { x.v = 0.0f; }
  __device__ void load(size_t i, Val& x) const { x.v = v[i]; }
  template <int REV>
  __device__ void load_halo(size_t i, int, Val& x) const {
    x.v = v[i];
  }
  __device__ void put(int slot, int i, float x) const {
    const float fl = floorf(x);
    sh->code[slot][i] = static_cast<int8_t>(static_cast<int>(fl));
    sh->p[slot][i] = (x - fl) * 2.0f;
  }
  __device__ void stage(int slot, int i, const Val& x) const {
    put(slot, i, x.v);
  }
  template <int REV>
  __device__ void stage_halo(int slot, int i, int, const Val& x) const {
    put(slot, i, x.v);
  }
  __device__ void zero(int slot, int i) const {
    sh->code[slot][i] = 0;
    sh->p[slot][i] = 0.0f;
  }
  // weight of staged cell i toward direction DIR
  template <int DIR>
  __device__ float tap(int slot, int i) const {
    constexpr int PREV = DIR == 1 ? 8 : DIR - 1;  // next(PREV) == DIR
    const int cd = sh->code[slot][i];
    const float p = sh->p[slot][i];
    return cd == DIR ? p : (cd == PREV ? 1.0f - p : 0.0f);
  }
};

}  // namespace

extern "C" int rd_dinf_sweep(const float* acc_in, const float* wgt,
                             const float* v, float* acc_out, int h, int w,
                             int reverse, int lim, void* stream) {
  return rd::launch_flow_sweep<DinfField, 4>(
      acc_in, wgt, DinfField::Ptrs{v}, acc_out, h, w, reverse, lim, stream);
}
