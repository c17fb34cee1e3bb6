// One directional sweep of Strahler stream order.  A cell's inflows are the
// neighbours whose D8 code points at it; with m the largest inflow order
// and k the number of inflows at m, upd = 1 (no inflow), m (k = 1) or
// m + 1 (k >= 2), and the new order is max(old, upd), 0 where old is 0
// (nodata).  Orders only grow, so the sweeps reach the unique solution on
// an acyclic code raster from below.
//
// Walking down, the inflows are read as richdem_tpu/ops/pallas_folded.py:
// _strahler_kernel (lines 741-784) reads them: new orders of the row before
// (its codes 7, 6 from the west, 8 from the east), sweep-start orders of
// the row after (3, 4 from the west, 2 from the east) and of the cell's own
// row (5 from the west, 1 from the east); walking up swaps the two trios.
// Codes are 0..8 (nodata clamped to 0); off-grid cells read order 0, code
// 0.  The walk is succ_sweep.cuh.
//
// Replaces the TPU kernel richdem_tpu/ops/pallas_folded.py:_strahler_kernel
// (line 729).  Folding, strip heights, the carried code row and the int32
// code widening are TPU artefacts and are not carried over.
//
// What bounds it on an H100: the row-to-row dependency (succ_sweep.cuh).
// Per cell a sweep reads an order and a code byte and writes an order, 9
// bytes; a cell's rule is 8 compare-selects, a max and a count.

#include "succ_sweep.cuh"

namespace {

struct Strahler {
  static constexpr int32_t OFF = 0;

  template <int REV>
  static __device__ __forceinline__ int32_t cell(const rd::Nbhd& nb) {
    // code trios (straight, from the west source, from the east source)
    constexpr int NS = REV ? 3 : 7, NW = REV ? 4 : 6, NE = REV ? 2 : 8;
    constexpr int OS = REV ? 7 : 3, OW = REV ? 6 : 4, OE = REV ? 8 : 2;
    const int32_t t[8] = {
        nb.pc[0] == NS ? nb.p[0] : 0,   nb.pc[-1] == NW ? nb.p[-1] : 0,
        nb.pc[1] == NE ? nb.p[1] : 0,   nb.nc[0] == OS ? nb.n[0] : 0,
        nb.nc[-1] == OW ? nb.n[-1] : 0, nb.nc[1] == OE ? nb.n[1] : 0,
        nb.lc[-1] == 5 ? nb.l[-1] : 0,  nb.lc[1] == 1 ? nb.l[1] : 0};
    int32_t m = t[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) m = max(m, t[i]);
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) cnt += (t[i] == m) & (m > 0);
    const int32_t upd = m == 0 ? 1 : (cnt >= 2 ? m + 1 : m);
    const int32_t o = nb.l[0];
    return o > 0 ? max(o, upd) : 0;
  }
};

}  // namespace

extern "C" int rd_strahler_sweep(const int32_t* v_in, const int8_t* code,
                                 int32_t* v_out, int h, int w, int reverse,
                                 void* stream) {
  return rd::launch_succ_sweep<Strahler>(v_in, code, v_out, h, w, reverse,
                                         stream);
}
