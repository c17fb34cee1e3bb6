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
// 0.
//
// Replaces the TPU kernel richdem_tpu/ops/pallas_folded.py:_strahler_kernel
// (line 729).  Folding, strip heights, the carried code row and the int32
// code widening are TPU artefacts and are not carried over.
//
// The walk is seam_walk.cuh: narrow tiles (_build.STRAHLER_TILE,
// STRAHLER_HALO) that trade edge values, so one sweep is the sweep over
// whole rows, whatever the tile (bitwise).  A stage holds the orders of
// rows r and r + 1 and the codes of rows r, r + 1 and r - 1; the codes
// never change, so ghost columns read the same codes as their owners
// (codes of row r - 1 kept by the consumers in shared memory, in place of
// staged, were measured slower).
//
// What bounds it on an H100: the row-to-row dependency.  Per cell a sweep
// reads an order and a code byte and writes an order, 9 bytes; a cell's
// rule is 8 compare-selects, a max and a count.  No change flag: the
// caller compares whole rotations (int32 orders, so equality is exact).

#include "seam_walk.cuh"

#ifndef RD_STRAHLER_TILE
#define RD_STRAHLER_TILE 128
#endif
#ifndef RD_STRAHLER_HALO
#define RD_STRAHLER_HALO 32
#endif

namespace {

// Three rows around one cell, each pointer at the cell's column (index
// -1 west, 0, +1 east).
struct Nbhd {
  const int32_t* p;  // row before, new orders
  const int8_t* pc;
  const int32_t* l;  // own row, sweep-start orders
  const int8_t* lc;
  const int32_t* n;  // row after, sweep-start orders
  const int8_t* nc;
};

struct Strahler {
  using T = int32_t;
  static constexpr T OFF = 0;
  static constexpr int TILE = RD_STRAHLER_TILE;
  static constexpr int HALO = RD_STRAHLER_HALO;
  static constexpr bool FLAG = false;
  // slots: orders of rows r and r + 1; codes of rows r, r + 1 and r - 1
  static constexpr int NSLOT = 5;
  struct Args {
    const int32_t* o_in;
    const int8_t* code;
  };
  __host__ __device__ static constexpr int elem(int q) { return q < 2 ? 4 : 1; }
  __host__ __device__ static constexpr int row(int q) {
    return q == 1 || q == 3 ? 1 : (q == 4 ? -1 : 0);
  }
  __device__ static const void* raster(const Args& a, int q) {
    return q < 2 ? static_cast<const void*>(a.o_in)
                 : static_cast<const void*>(a.code);
  }

  template <int REV>
  static __device__ __forceinline__ int32_t cell(const Nbhd& nb) {
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

  // The cell's neighbourhood from the staged rows and the new orders of
  // the row before; off the grid, order 0 and code 0.  Every operand is
  // read and then masked, so a warp does not diverge (a column or row off
  // the grid reads stage bytes that the mask then replaces).
  template <int REV, class View, class Before>
  __device__ static T update(const Args&, const View& v, int i, int w,
                             Before before) {
    int32_t p[3], l[3], n[3];
    int8_t pc[3], lc[3], nc[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int c = i + d - 1;
      const bool in = c >= 0 && c < w;
      const bool up = in && v.prev, down = in && v.next;
      p[d] = before(d - 1);
      const int32_t lv = v.template at<int32_t>(0, c);
      const int32_t nv = v.template at<int32_t>(1, c);
      const int8_t pcv = v.template at<int8_t>(4, c);
      const int8_t lcv = v.template at<int8_t>(2, c);
      const int8_t ncv = v.template at<int8_t>(3, c);
      l[d] = in ? lv : OFF;
      n[d] = down ? nv : OFF;
      pc[d] = up ? pcv : 0;
      lc[d] = in ? lcv : 0;
      nc[d] = down ? ncv : 0;
    }
    return cell<REV>(Nbhd{p + 1, pc + 1, l + 1, lc + 1, n + 1, nc + 1});
  }
};

}  // namespace

// The walk's shape into out[0..3]: tile columns, halo columns, consumer
// threads a block, ring stages.
extern "C" int rd_strahler_shape(int* out) {
  return rd::walk::shape<Strahler>(out);
}

// `flags`: flags_len ints of scratch on the stream's device, one a block
// (ceil(w / TILE) always suffice), cleared here on `stream`; too few
// return cudaErrorInvalidValue.
extern "C" int rd_strahler_sweep(const int32_t* o_in, const int8_t* code,
                                 int32_t* o_out, int h, int w, int reverse,
                                 int* flags, int flags_len, void* stream) {
  return rd::walk::launch<Strahler>({o_in, code}, o_out, h, w, reverse,
                                    flags, flags_len, stream);
}
