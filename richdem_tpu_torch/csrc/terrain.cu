// One terrain attribute from the 3x3 window, in one pass: Horn 1981
// slope/aspect and Zevenbergen & Thorne 1987 curvatures, as
// richdem_tpu/ops/terrain.py:terrain_core defines them.
//
// Window (row-major a..i, e the centre), after `zscale`:
//
//     a b c
//     d e f        an off-grid or nodata neighbour, or one whose scaled
//     g h i        value is NaN, reads the centre e
//
// fx = ((c + 2f + i) - (a + 2d + g)) / 8L,  fy = ((g + 2h + i) - (a + 2b + c)) / 8L
// with L the cell size.  Nodata cells give NaN.  `attrib` indexes
// TERRAIN_ATTRIBUTES of richdem_tpu_torch/ops/terrain.py:
//   0 slope_riserun   sqrt(fx^2 + fy^2)
//   1 slope_percentage, 2 slope_degrees, 3 slope_radians
//   4 aspect          degrees(atan2(-fx, fy)) floor-mod 360, -1 where flat
//   5 curvature, 6 planform_curvature, 7 profile_curvature
//
// Replaces the TPU kernel richdem_tpu/ops/pallas_stencils.py:_terrain_kernel
// (line 218).  Mosaic could not lower atan/atan2, so the TPU finished those
// attributes in XLA (_terrain_finish); here they finish in the kernel.  The
// arithmetic repeats the plain version's grouping operation for operation,
// built with --fmad=false and IEEE division, so every attribute but the
// atan ones is bitwise the plain version's on the card.
//
// What bounds it on an H100: device memory.  Each cell needs its z (4 B)
// and nodata byte once and writes 4 B, 9 B a cell; the arithmetic is a few
// dozen operations (a few more for the curvatures).  What the design does
// about it: the shared-memory tile of stencil_tile.cuh (32 rows by 128
// columns, 4x4 cells a thread, 16-byte loads of z, 4-byte loads of the
// mask and one 16-byte store of a row's 4 values where rows start
// aligned), so each value and mask byte is read from device memory once,
// not nine times; z * zscale is computed once a cell, at staging, where a
// nodata or off-grid cell stages as NaN, exactly the fold of the plain
// _window (a NaN neighbour reads the centre); the centre's own nodata is
// read from the mask (NaN out).  The uniform divisors 8L, L*L, (4L)*L and
// 2L, grouped as terrain_core groups them, take stencil_tile.cuh's fast
// division (their reciprocals hoisted) where the block's scaled values are
// 0 or 2^-50 <= |v| <= 2^77: then every dividend the attributes form (sums
// and differences of at most eight window values, weights 1, 2 and 1/2)
// is 0 or within [2^-74, 2^80], where the divisors lie in [2^-20, 2^20];
// other blocks divide with `/`.  The halving in D and E is a
// multiplication by 0.5, exact as the division by 2; the division by
// max(G^2 + H^2, 1e-30) of the planform and profile curvatures differs
// from cell to cell and stays `/`.

#include <math.h>

#include "stencil_tile.cuh"

namespace {

using rd::tile::quotient;
using rd::tile::refined_rcp;

constexpr float RAD2DEG = 57.295779513082320876798154814105f;

template <int ATTRIB>
struct TerrainOp {
  using Res = float;
  using Out = float;
  static constexpr float OK_MAX = 1.5111572745182865e+23f;  // 2^77
  float zscale;
  float d8L, dLL, d4LL, d2L;  // 8L, L*L, (4L)*L, 2L
  int fast;
  struct Thread {
    float y8L, yLL, y4LL, y2L;
  };

  __device__ static float off() { return __int_as_float(0x7fffffff); }
  __device__ float fold(float z) const { return z * zscale; }
  __device__ Thread prepare() const {
    return {refined_rcp(d8L), refined_rcp(dLL), refined_rcp(d4LL),
            refined_rcp(d2L)};
  }

  template <bool FAST>
  __device__ float cell(const float (&win)[3][6], int x,
                        const Thread& t) const {
    // a b c / d e f / g h i, a NaN (invalid) neighbour reading the centre
    const float e = win[1][x + 1];
    auto nb = [e](float v) { return isnan(v) ? e : v; };
    const float a = nb(win[0][x]), b = nb(win[0][x + 1]),
                c = nb(win[0][x + 2]);
    const float d = nb(win[1][x]), f = nb(win[1][x + 2]);
    const float g = nb(win[2][x]), hh = nb(win[2][x + 1]),
                i = nb(win[2][x + 2]);
    if (ATTRIB <= 4) {
      const float fx = quotient<FAST>((c + 2.0f * f + i) - (a + 2.0f * d + g),
                                      d8L, t.y8L);
      const float fy = quotient<FAST>((g + 2.0f * hh + i) - (a + 2.0f * b + c),
                                      d8L, t.y8L);
      if (ATTRIB == 4) {
        if (fx == 0.0f && fy == 0.0f) return -1.0f;
        // floor modulo, as `%` in torch and JAX (fmodf truncates)
        float m = fmodf(atan2f(-fx, fy) * RAD2DEG, 360.0f);
        if (m != 0.0f && m < 0.0f) m += 360.0f;
        return m;
      }
      const float rr = sqrtf(fx * fx + fy * fy);
      if (ATTRIB == 0) return rr;
      if (ATTRIB == 1) return 100.0f * rr;
      if (ATTRIB == 2) return atanf(rr) * RAD2DEG;
      return atanf(rr);
    }
    const float D = quotient<FAST>((d + f) * 0.5f - e, dLL, t.yLL);
    const float E = quotient<FAST>((b + hh) * 0.5f - e, dLL, t.yLL);
    const float F = quotient<FAST>(-a + c + g - i, d4LL, t.y4LL);
    const float G = quotient<FAST>(-d + f, d2L, t.y2L);
    const float H = quotient<FAST>(b - hh, d2L, t.y2L);
    const float g2h2 = G * G + H * H;
    const float den = fmaxf(g2h2, 1e-30f);
    if (ATTRIB == 5) return -2.0f * (D + E) * 100.0f;
    if (ATTRIB == 6)
      return g2h2 == 0.0f
                 ? 0.0f
                 : 2.0f * (D * H * H + E * G * G - F * G * H) / den * 100.0f;
    return g2h2 == 0.0f
               ? 0.0f
               : -2.0f * (D * G * G + E * H * H + F * G * H) / den * 100.0f;
  }

  template <bool FAST>
  __device__ void cells(const float (&win)[3][6], size_t, const Thread& t,
                        float (&res)[4]) const {
#pragma unroll
    for (int x = 0; x < 4; ++x) res[x] = cell<FAST>(win, x, t);
  }
  template <bool VEC>
  __device__ static void store(const float (&res)[4], const uint8_t* nodata,
                               float* out, size_t idx, int c, int w) {
    rd::tile::store_floats<VEC>(res, nodata, out, idx, c, w);
  }
};

template <int ATTRIB>
int launch(const float* z, const uint8_t* nd, float* out, int h, int w,
           float zscale, float L, void* stream) {
  using rd::tile::divisor_ok;
  TerrainOp<ATTRIB> op{zscale, 8.0f * L, L * L, 4.0f * L * L, 2.0f * L, 0};
  // the divisors this attribute divides by
  op.fast = ATTRIB <= 4 ? divisor_ok(op.d8L)
                        : divisor_ok(op.dLL) && divisor_ok(op.d4LL) &&
                              divisor_ok(op.d2L);
  return rd::tile::launch(z, nd, out, h, w, op, stream);
}

}  // namespace

extern "C" int rd_terrain(const float* z, const uint8_t* nodata, float* out,
                          int h, int w, float zscale, float cellsize,
                          int attrib, void* stream) {
  switch (attrib) {
    case 0: return launch<0>(z, nodata, out, h, w, zscale, cellsize, stream);
    case 1: return launch<1>(z, nodata, out, h, w, zscale, cellsize, stream);
    case 2: return launch<2>(z, nodata, out, h, w, zscale, cellsize, stream);
    case 3: return launch<3>(z, nodata, out, h, w, zscale, cellsize, stream);
    case 4: return launch<4>(z, nodata, out, h, w, zscale, cellsize, stream);
    case 5: return launch<5>(z, nodata, out, h, w, zscale, cellsize, stream);
    case 6: return launch<6>(z, nodata, out, h, w, zscale, cellsize, stream);
    case 7: return launch<7>(z, nodata, out, h, w, zscale, cellsize, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
