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
// dozen flops.  This first version reads the nine window values and nine
// mask bytes through L1 per thread (blocks of 32 x 8 cells, neighbouring
// threads on neighbouring columns), so it is bound by load issue before
// bandwidth; a shared-memory tile with halos is the next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BX = 32, BY = 8;
constexpr float RAD2DEG = 57.295779513082320876798154814105f;

template <int ATTRIB>
__global__ void __launch_bounds__(BX * BY)
terrain_kernel(const float* __restrict__ z, const uint8_t* __restrict__ nd,
               float* __restrict__ out, int h, int w, float zscale,
               float L) {
  const int col = blockIdx.x * BX + threadIdx.x;
  const int row = blockIdx.y * BY + threadIdx.y;
  if (row >= h || col >= w) return;
  const size_t at = static_cast<size_t>(row) * w + col;
  if (nd[at]) {
    out[at] = nanf("");
    return;
  }
  const float e = z[at] * zscale;
  auto nb = [&](int dr, int dc) -> float {
    const int r = row + dr, cc = col + dc;
    if (r < 0 || r >= h || cc < 0 || cc >= w) return e;
    const size_t j = static_cast<size_t>(r) * w + cc;
    if (nd[j]) return e;
    const float v = z[j] * zscale;
    return isnan(v) ? e : v;
  };
  const float a = nb(-1, -1), b = nb(-1, 0), c = nb(-1, 1);
  const float d = nb(0, -1), f = nb(0, 1);
  const float g = nb(1, -1), hh = nb(1, 0), i = nb(1, 1);

  const float fx = ((c + 2.0f * f + i) - (a + 2.0f * d + g)) / (8.0f * L);
  const float fy = ((g + 2.0f * hh + i) - (a + 2.0f * b + c)) / (8.0f * L);
  float res;
  if (ATTRIB <= 3) {
    const float rr = sqrtf(fx * fx + fy * fy);
    if (ATTRIB == 0) res = rr;
    if (ATTRIB == 1) res = 100.0f * rr;
    if (ATTRIB == 2) res = atanf(rr) * RAD2DEG;
    if (ATTRIB == 3) res = atanf(rr);
  } else if (ATTRIB == 4) {
    if (fx == 0.0f && fy == 0.0f) {
      res = -1.0f;
    } else {
      // floor modulo, as `%` in torch and JAX (fmodf truncates)
      float m = fmodf(atan2f(-fx, fy) * RAD2DEG, 360.0f);
      if (m != 0.0f && m < 0.0f) m += 360.0f;
      res = m;
    }
  } else {
    const float D = ((d + f) / 2.0f - e) / (L * L);
    const float E = ((b + hh) / 2.0f - e) / (L * L);
    const float F = (-a + c + g - i) / (4.0f * L * L);
    const float G = (-d + f) / (2.0f * L);
    const float H = (b - hh) / (2.0f * L);
    const float g2h2 = G * G + H * H;
    const float den = fmaxf(g2h2, 1e-30f);
    if (ATTRIB == 5) {
      res = -2.0f * (D + E) * 100.0f;
    } else if (ATTRIB == 6) {
      res = g2h2 == 0.0f
                ? 0.0f
                : 2.0f * (D * H * H + E * G * G - F * G * H) / den * 100.0f;
    } else {
      res = g2h2 == 0.0f
                ? 0.0f
                : -2.0f * (D * G * G + E * H * H + F * G * H) / den * 100.0f;
    }
  }
  out[at] = res;
}

template <int ATTRIB>
void launch(const float* z, const uint8_t* nd, float* out, int h, int w,
            float zscale, float cellsize, cudaStream_t s) {
  const dim3 block(BX, BY);
  const dim3 grid((w + BX - 1) / BX, (h + BY - 1) / BY);
  terrain_kernel<ATTRIB><<<grid, block, 0, s>>>(z, nd, out, h, w, zscale,
                                                cellsize);
}

}  // namespace

extern "C" int rd_terrain(const float* z, const uint8_t* nodata, float* out,
                          int h, int w, float zscale, float cellsize,
                          int attrib, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (attrib) {
    case 0: launch<0>(z, nodata, out, h, w, zscale, cellsize, s); break;
    case 1: launch<1>(z, nodata, out, h, w, zscale, cellsize, s); break;
    case 2: launch<2>(z, nodata, out, h, w, zscale, cellsize, s); break;
    case 3: launch<3>(z, nodata, out, h, w, zscale, cellsize, s); break;
    case 4: launch<4>(z, nodata, out, h, w, zscale, cellsize, s); break;
    case 5: launch<5>(z, nodata, out, h, w, zscale, cellsize, s); break;
    case 6: launch<6>(z, nodata, out, h, w, zscale, cellsize, s); break;
    case 7: launch<7>(z, nodata, out, h, w, zscale, cellsize, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
