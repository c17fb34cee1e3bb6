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
// What bounds it on an H100: its int32 operations.  It moves the 6 bytes
// a cell that D8 moves (4 of z and one of mask read, one of code written),
// but a cell also draws 32 random bits (Philox4x32-10, 10 rounds), one
// tanf and 8 divisions.  What the design does about it: D8's shared-memory
// tile (stencil_tile.cuh: 32 rows by 128 columns, 4x4 cells a thread,
// nodata and off-grid cells staged as FLT_MAX, a row's 4 codes out as one
// 32-bit store); the round keys, the same for every cell, computed once on
// the host (ops/flowdirs.py:philox_round_keys) and read from the kernel's
// parameters, so a round is two wide multiplies and two three-input xors;
// and stencil_tile.cuh's fast division where the block's values (0 or
// 2^-50 <= |z| <= 2^79) and the cell size (2^-20 <= cellsize <= 2^19, so
// every diagonal distance, in [cellsize, 2 cellsize], lies in
// [2^-20, 2^20]) allow it: the 4 orthogonal divisions share the block's
// reciprocal of the cell size, the 4 diagonal ones the cell's own refined
// reciprocal of its diagonal distance.  Any other block divides with `/`.
// The tanf stays, as the plain version's torch.tan, so the codes stay
// bitwise.

#include "stencil_tile.cuh"

namespace {

using rd::tile::refined_rcp;

constexpr int ROUNDS = 10;
constexpr float QUARTER_PI = 0.785398163397448309616f;  // float32(pi / 4)

template <bool D4>
struct Rho8Op {
  using Res = int;
  using Out = int8_t;
  static constexpr float OK_MAX = 6.0446290980731459e+23f;  // 2^79
  float ds;  // the cell size: the orthogonal distance
  int fast;
  uint32_t k0[ROUNDS], k1[ROUNDS];  // Philox round keys
  struct Thread {
    float ys;
  };

  __device__ static float off() { return FLT_MAX; }
  __device__ float fold(float z) const { return z; }
  __device__ Thread prepare() const { return {refined_rcp(ds)}; }

  // The first output word of Philox4x32-10 of (lo, hi, 0, 0).
  __device__ uint32_t philox_word0(uint32_t lo, uint32_t hi) const {
    uint32_t c0 = lo, c1 = hi, c2 = 0u, c3 = 0u;
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const uint64_t p0 = static_cast<uint64_t>(0xD2511F53u) * c0;
      const uint64_t p1 = static_cast<uint64_t>(0xCD9E8D57u) * c2;
      c0 = static_cast<uint32_t>(p1 >> 32) ^ c1 ^ k0[r];
      c1 = static_cast<uint32_t>(p1);
      c2 = static_cast<uint32_t>(p0 >> 32) ^ c3 ^ k1[r];
      c3 = static_cast<uint32_t>(p0);
    }
    return c0;
  }

  template <bool FAST>
  __device__ void cells(const float (&win)[3][6], size_t idx,
                        const Thread& t, int (&code)[4]) const {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float dd = ds, yd = t.ys;
      if (!D4) {
        const uint64_t i = static_cast<uint64_t>(idx) + x;
        const uint32_t bits = philox_word0(static_cast<uint32_t>(i),
                                           static_cast<uint32_t>(i >> 32));
        const float u =
            static_cast<float>(bits & 0xFFFFFFu) * (1.0f / 16777216.0f);
        dd = (1.0f + tanf(u * QUARTER_PI)) * ds;
        if (FAST) yd = refined_rcp(dd);
      }
      code[x] = rd::tile::steepest<D4, FAST>(win, x, ds, dd, t.ys, yd);
    }
  }
  template <bool VEC>
  __device__ static void store(const int (&code)[4], const uint8_t* nodata,
                               int8_t* out, size_t idx, int c, int w) {
    rd::tile::store_codes<VEC>(code, nodata, out, idx, c, w);
  }
};

template <bool D4>
int launch(const float* z, const bool* nodata, int8_t* out, int h, int w,
           float cellsize, const uint32_t* keys, void* stream) {
  Rho8Op<D4> op{};
  op.ds = cellsize;
  // every distance in [2^-20, 2^20]: the cell size, and the diagonal
  // distances up to twice it
  op.fast = rd::tile::divisor_ok(cellsize) &&
            (D4 || rd::tile::divisor_ok(2.0f * cellsize));
  for (int r = 0; r < ROUNDS; ++r) {
    op.k0[r] = keys[2 * r];
    op.k1[r] = keys[2 * r + 1];
  }
  return rd::tile::launch(z, nodata, out, h, w, op, stream);
}

}  // namespace

// `keys`: the 2 x 10 Philox round keys (k0, k1 of round 0, then of round
// 1, ...; ops/flowdirs.py:philox_round_keys), read on the host.
extern "C" int rd_rho8_flowdirs(const float* z, const bool* nodata,
                                int8_t* out, int h, int w, float cellsize,
                                const uint32_t* keys, int d4, void* stream) {
  return d4 ? launch<true>(z, nodata, out, h, w, cellsize, keys, stream)
            : launch<false>(z, nodata, out, h, w, cellsize, keys, stream);
}
