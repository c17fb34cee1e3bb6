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
// them within a strip; off-grid successors read -1.
//
// Replaces the TPU kernel richdem_tpu/ops/pallas_folded.py:_resolve_kernel
// (line 606).  Folding, strip heights, the separate int32 pin raster and
// the int32 code widening are TPU artefacts and are not carried over.
//
// The walk is seam_walk.cuh: 128-column tiles with a 64-column halo
// (_build.RESOLVE_TILE, RESOLVE_HALO) that trade edge values, so one sweep
// is the sweep over whole rows, whatever the tile (bitwise).  A stage
// holds the values of rows r and r + 1 and the codes of row r.
//
// What bounds it on an H100: the row-to-row dependency.  Per cell a sweep
// reads a value and a code byte and writes a value, 9 bytes; a cell's
// rule is one decode and one select, so a row step is the latency of its
// shared-memory reads, its select and one barrier.  No change flag: the
// caller compares whole rotations (int32 values, so equality is exact).
//
// Watershed labels, upslope masks and the two-pass tile labels take the
// pointer jumping of successor_jump.cuh (rd_resolve_jump below), which
// reaches the same fixpoint without rotations.  The sweep kernel runs on
// no path; ROADMAP.md queue 5 lists its retirement.

#include "seam_walk.cuh"
#include "successor_jump.cuh"

#ifndef RD_RESOLVE_TILE
#define RD_RESOLVE_TILE 128
#endif
#ifndef RD_RESOLVE_HALO
#define RD_RESOLVE_HALO 64
#endif

namespace {

struct ResolveSweep {
  using T = int32_t;
  static constexpr T OFF = -1;  // what an off-grid successor reads
  static constexpr int TILE = RD_RESOLVE_TILE;
  static constexpr int HALO = RD_RESOLVE_HALO;
  static constexpr bool FLAG = false;
  // slots: values of rows r and r + 1, codes of row r
  static constexpr int NSLOT = 3;
  struct Args {
    const int32_t* v_in;
    const int8_t* code;
  };
  __host__ __device__ static constexpr int elem(int q) { return q < 2 ? 4 : 1; }
  __host__ __device__ static constexpr int row(int q) { return q == 1; }
  __device__ static const void* raster(const Args& a, int q) {
    return q < 2 ? static_cast<const void*>(a.v_in)
                 : static_cast<const void*>(a.code);
  }

  // The successor's offsets: dx + 1 and dy + 1 of code d in bits 2d and
  // 2d + 1 (topology.DX, DY: dx + 1 = 1 0 0 1 2 2 2 1 0, dy + 1 = 1 1 0 0
  // 0 1 2 2 2 for codes 0..8; code 0 reads the cell itself).
  static constexpr uint32_t DX1 = 0x6a41u;
  static constexpr uint32_t DY1 = 0x2a405u;

  // One select of the successor's row and one read, so a warp does not
  // diverge on its codes.
  template <int REV, class View, class Before>
  __device__ static T update(const Args&, const View& v, int i, int w,
                             Before before) {
    const int byte = v.template at<int8_t>(2, i);
    const int d = byte < 0 || (byte & 15) > 8 ? 0 : (byte & 15);  // 0: own
    const int dx = static_cast<int>((DX1 >> (2 * d)) & 3) - 1;
    const int dy = static_cast<int>((DY1 >> (2 * d)) & 3) - 1;
    // dy = -1 is the row before when walking down, the row after when
    // walking up
    const int side = REV ? -dy : dy;  // -1 before, 0 own, 1 after
    const int c = i + dx;
    const bool in = c >= 0 && c < w && (side <= 0 || v.next);
    const int32_t nv = side < 0   ? before(dx)
                       : side > 0 ? v.template at<int32_t>(1, c)
                                  : v.template at<int32_t>(0, c);
    return in || side < 0 ? nv : OFF;
  }
};

}  // namespace

// The walk's shape into out[0..3]: tile columns, halo columns, consumer
// threads a block, ring stages.
extern "C" int rd_resolve_shape(int* out) {
  return rd::walk::shape<ResolveSweep>(out);
}

// `flags`: flags_len ints of scratch on the stream's device, one a block
// (ceil(w / TILE) always suffice), cleared here on `stream`; too few
// return cudaErrorInvalidValue.
extern "C" int rd_resolve_sweep(const int32_t* v_in, const int8_t* code,
                                int32_t* v_out, int h, int w, int reverse,
                                int* flags, int flags_len, void* stream) {
  return rd::walk::launch<ResolveSweep>({v_in, code}, v_out, h, w, reverse,
                                        flags, flags_len, stream);
}

// The fixpoint by pointer jumping (successor_jump.cuh): watershed labels
// into int32 `out` when `seeds` is null (`ptr` may be `out`), else the
// upslope mask of the seed bytes into bool `out`.  `border`: border_len
// int32 of scratch, at least rd::jump::slots_of(h, w) +
// rd::jump::rounds_of(slots); too few, or a grid past 2^30 cells or slots,
// return cudaErrorInvalidValue.
extern "C" int rd_resolve_jump(const int8_t* code, const uint8_t* seeds,
                               int32_t* ptr, void* out, int* border,
                               long long border_len, int h, int w,
                               void* stream) {
  if (seeds == nullptr)
    return rd::launch_successor_jump<false>(
        code, seeds, ptr, static_cast<int32_t*>(out), border, border_len, h,
        w, stream);
  return rd::launch_successor_jump<true>(code, seeds, ptr,
                                         static_cast<uint8_t*>(out), border,
                                         border_len, h, w, stream);
}

// The jump's shape into out[0..1]: tile edge, threads a block.
extern "C" int rd_resolve_jump_shape(int* out) {
  out[0] = rd::jump::T;
  out[1] = rd::jump::NT;
  return 0;
}
