// One directional sweep of the successor resolve V(c) <- V(successor(c)):
// each unpinned cell takes the value of the cell its D8 code points to, a
// pinned cell keeps its own.  Watershed labels (V = the terminal's flat
// index) and upslope masks (V = 1 below a seed) are its fixpoints.
//
// The code byte carries the pin in its sign bit: b = code | 0x80 for a
// pinned cell, code in 0..8 otherwise (ops/successor.py:pack_codes), so a
// sweep reads one byte per cell for both.  The successor's value is read
// where the sweep has it: new values in the row before (codes 2, 3, 4
// walking down, 8, 7, 6 walking up), sweep-start values in the row after
// and in the cell's own row (codes 1 and 5), exactly as
// richdem_tpu/ops/pallas_folded.py:_resolve_kernel (lines 615-646) reads
// them; off-grid successors read -1.  The walk is succ_sweep.cuh.
//
// Replaces the TPU kernel richdem_tpu/ops/pallas_folded.py:_resolve_kernel
// (line 606).  Folding, strip heights, the separate int32 pin raster and
// the int32 code widening are TPU artefacts and are not carried over.
//
// What bounds it on an H100: the row-to-row dependency (succ_sweep.cuh).
// Per cell a sweep reads a value and a code byte and writes a value, 9
// bytes; a cell's rule is one decode and one select.

#include "succ_sweep.cuh"

namespace {

struct Resolve {
  static constexpr int32_t OFF = -1;

  template <int REV>
  static __device__ __forceinline__ int32_t cell(const rd::Nbhd& nb) {
    const int b = nb.lc[0];
    if (b < 0) return nb.l[0];  // pinned
    // the row a code's successor lies in: dy = -1 is the row before when
    // walking down, the row after when walking up
    const int32_t* up = REV ? nb.n : nb.p;
    const int32_t* dn = REV ? nb.p : nb.n;
    switch (b & 15) {
      case 1: return nb.l[-1];  // W
      case 2: return up[-1];    // NW
      case 3: return up[0];     // N
      case 4: return up[1];     // NE
      case 5: return nb.l[1];   // E
      case 6: return dn[1];     // SE
      case 7: return dn[0];     // S
      case 8: return dn[-1];    // SW
      default: return nb.l[0];  // NO_FLOW
    }
  }
};

}  // namespace

extern "C" int rd_resolve_sweep(const int32_t* v_in, const int8_t* code,
                                int32_t* v_out, int h, int w, int reverse,
                                void* stream) {
  return rd::launch_succ_sweep<Resolve>(v_in, code, v_out, h, w, reverse,
                                        stream);
}
