// Single-pass Rho8 / Rho4 stochastic flow directions (Fairfield & Leymarie
// 1991), with the random bits drawn in the kernel.
//
// For each data cell: u = (bits & 0xFFFFFF) * 2^-24 from the first word of
// Philox4x32-10 (Salmon et al. 2011) of the counter (flat index, 0, 0, 0)
// under the key (seed low word, seed high word); the diagonal distance is
// (1 + tanf(u * pi/4)) * cellsize.  Then steepest descent exactly as
// richdem_tpu/ops/flowdirs.py:_rho8_impl does it: slope by division
// (z - z_d) / dist_d, off-grid and nodata neighbours invalid, first maximum
// in direction order 1..8 (strict >), NO_FLOW (0) unless that slope is > 0,
// FLOWDIR_NO_DATA (-1) at nodata.  Codes are written as int8.  Rho4 (d4)
// reads no diagonal and draws no bits.  The plain version
// (ops/flowdirs.py:philox_bits, rho8_diagonal, rho8_plain) draws the same
// bits in int64 tensor arithmetic.
//
// Replaces the TPU kernel richdem_tpu/ops/pallas_stencils.py:_rho8_kernel
// (line 119).  That kernel draws from the TPU's own generator (pltpu.prng,
// seeded per grid step) and multiplies by reciprocal distances; this one
// draws a counter-based stream that does not depend on how the grid is cut,
// and divides, as the XLA function does.  The +-1-row shifted copies and the
// int32 code widening are TPU artefacts and are not carried over.
//
// What bounds it on an H100: like d8.cu it reads 4 bytes of z and one byte
// of mask and writes one byte per cell, but it also does about 100 integer
// operations of Philox and one tanf per cell, which puts its operation
// bound above its byte bound.  What the design does about it: one thread
// per cell, a 32-wide block row so that neighbouring threads read
// neighbouring addresses, the round keys kept in registers, and no
// intermediate raster (the diagonal distance never leaves the thread).

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float INVALID = -3.0e38f;  // slope of an invalid neighbour
constexpr float QUARTER_PI = 0.785398163397448309616f;  // float32(pi / 4)

// The first output word of Philox4x32-10 of (lo, hi, 0, 0) under (k0, k1).
__device__ __forceinline__ uint32_t philox_word0(uint32_t lo, uint32_t hi,
                                                 uint32_t k0, uint32_t k1) {
  uint32_t c0 = lo, c1 = hi, c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

__global__ void rho8_kernel(const float* __restrict__ z,
                            const bool* __restrict__ nodata,
                            int8_t* __restrict__ out, int h, int w,
                            float cellsize, uint32_t k0, uint32_t k1,
                            int d4) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w) return;
  const size_t idx = static_cast<size_t>(r) * w + c;
  if (nodata[idx]) {
    out[idx] = -1;
    return;
  }
  float dist_diag = 0.0f;
  if (!d4) {
    const uint64_t i = static_cast<uint64_t>(idx);
    const uint32_t bits = philox_word0(static_cast<uint32_t>(i),
                                       static_cast<uint32_t>(i >> 32), k0,
                                       k1);
    const float u = static_cast<float>(bits & 0xFFFFFFu) * (1.0f / 16777216.0f);
    const float rho = 1.0f + tanf(u * QUARTER_PI);
    dist_diag = rho * cellsize;
  }
  // direction d = 1..8: W, NW, N, NE, E, SE, S, SW
  const int dx[9] = {0, -1, -1, 0, 1, 1, 1, 0, -1};
  const int dy[9] = {0, 0, -1, -1, -1, 0, 1, 1, 1};
  const float zc = z[idx];
  float best = INVALID;
  int code = 0;
#pragma unroll
  for (int d = 1; d <= 8; ++d) {
    const bool diag = (d % 2) == 0;
    if (d4 && diag) continue;
    const int rn = r + dy[d], cn = c + dx[d];
    float s = INVALID;
    if (rn >= 0 && rn < h && cn >= 0 && cn < w) {
      const size_t n = static_cast<size_t>(rn) * w + cn;
      const float zn = nodata[n] ? FLT_MAX : z[n];
      if (zn < FLT_MAX) s = (zc - zn) / (diag ? dist_diag : cellsize);
    }
    if (s > best) {
      best = s;
      code = d;
    }
  }
  out[idx] = static_cast<int8_t>(best > 0.0f ? code : 0);
}

}  // namespace

extern "C" int rd_rho8_flowdirs(const float* z, const bool* nodata,
                                int8_t* out, int h, int w, float cellsize,
                                uint32_t k0, uint32_t k1, int d4,
                                void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  rho8_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      z, nodata, out, h, w, cellsize, k0, k1, d4);
  return static_cast<int>(cudaGetLastError());
}
