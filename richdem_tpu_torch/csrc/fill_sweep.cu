// One directional Gauss-Seidel sweep of the depression-fill fixpoint
//
//     W(c) = min( W(c), max( Z(c), min_n W(n) + eps_n ) )
//
// over the three neighbours in the row before (N straight, NW/NE diagonal),
// walking a row-major float32 (H, W) raster down (reverse = 0) or up
// (reverse = 1).  Off-grid neighbours are drains (-BIG); nodata cells
// already hold -BIG in `flr` and `w_in`.
//
// Replaces the TPU kernels richdem_tpu/ops/pallas_folded.py:_fill_kernel
// (line 133) and richdem_tpu/ops/pallas_sweeps.py:_fill_down_kernel
// (line 89).  The folded (8, 128) layout, the 1024 padding and the seam
// fix-ups of those kernels are TPU artefacts and are not carried over.
//
// What bounds it on an H100: the row-to-row dependency.  The columns are
// cut into 1024-column tiles, one block each, and each tile walks its H
// rows in order, so a sweep costs H times the latency of one row step, not
// bandwidth: a 10240-wide raster gives only 10 tiles for 132 SMs.  Across
// a tile edge the row before is read at its sweep-start values (from
// `w_in`), which only delays convergence (the fixpoint is a monotone
// selection with a unique answer) and keeps every run deterministic.
//
// What the design does about it: the rows of `w_in` and `flr` are staged
// in a shared-memory ring by a producer warp (row_ring.cuh), so a row step
// never waits on device memory and holds no prefetched rows in registers.
// The 256 consumer threads of a full tile whose rows start 16-byte aligned
// (MODE 2) each own 4 adjacent columns: a row step is one float4 load of
// each staged row, two shuffles for the neighbours' new values (shared
// memory at a warp's edge), 28 float operations, one float4 store and one
// barrier over the consumers.  Other full tiles (MODE 1) and a ragged last
// tile (MODE 0, the only one that tests its columns) own the columns tx,
// tx + 256, ... and read the row before from shared memory.
//
// Change flag: one atomicOr per consumer warp into `changed` when any cell
// it owns changed.  Sound for the fill only, because every sweep is
// idempotent at the fixpoint.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_ring.cuh"

#ifndef RD_TILE
#define RD_TILE 1024
#endif
#ifndef RD_STAGES
#define RD_STAGES 16
#endif

namespace {

constexpr int TILE = RD_TILE;
constexpr int STAGES = RD_STAGES;  // rows in the ring
constexpr int NT = 256;            // consumers; the producer warp besides
constexpr int CPT = TILE / NT;     // columns of a consumer
constexpr int SLOT = rd::slot_elems<float>(TILE);
constexpr rd::Layout LAYOUT = rd::layout(STAGES, TILE, 2 * SLOT * 4);
constexpr float NEG = -1.0e30f;  // -BIG: the drain value
static_assert(CPT == 4 && STAGES >= 2, "4 columns a consumer, 2+ stages");

template <int MODE>  // 0: a ragged tile; 1: full tiles; 2: aligned full
__global__ void __launch_bounds__(NT + 32)
fill_sweep_kernel(const float* __restrict__ w_in,
                  const float* __restrict__ flr,
                  float* __restrict__ w_out, int* __restrict__ changed,
                  int h, int w, float eps, float eps_diag, int reverse,
                  int tile0) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  float* prev = reinterpret_cast<float*>(smem + LAYOUT.prev);
  float* ring = reinterpret_cast<float*>(smem + LAYOUT.ring);

  const int tx = threadIdx.x;  // NT consumers, then the producer warp
  const int cs = (tile0 + blockIdx.x) * TILE;  // the tile's first column
  const int ncols = min(TILE, w - cs);
  const bool has_l = cs > 0;           // a column west of the tile
  const bool has_r = cs + ncols < w;   // a column east of it
  const int first = has_l ? cs - 1 : cs;  // staged columns [first, last)
  const int last = has_r ? cs + ncols + 1 : cs + ncols;
  const int sh = has_l ? 1 : 0;  // staged index of column cs, past the lead

  auto row_base = [&](int k) -> size_t {
    return static_cast<size_t>(reverse ? h - 1 - k : k) *
           static_cast<size_t>(w);
  };

  if (tx == 0) {
    for (int s = 0; s < STAGES; ++s) {
      rd::bar_init(&full[s], 1);
      rd::bar_init(&empty[s], 1);
    }
    rd::bar_init_fence();
  }
  // the row before the first one is off-grid: a drain
  for (int i = tx; i < 2 * (TILE + 8); i += NT + 32) prev[i] = NEG;
  __syncthreads();

  if (tx >= NT) {  // the producer warp: one thread stages every row
    if (tx == NT) {
      int s = 0, phase = 0;
      for (int k = 0; k < h; ++k) {
        if (k >= STAGES) rd::bar_wait(&empty[s], phase ^ 1);
        const size_t b = row_base(k);
        const rd::Covering cw = rd::covering(w_in, b + first, b + last);
        const rd::Covering cf = rd::covering(flr, b + first, b + last);
        rd::bar_expect(&full[s], cw.bytes + cf.bytes);
        rd::bulk_copy(ring + (2 * s) * SLOT, cw, &full[s]);
        rd::bulk_copy(ring + (2 * s + 1) * SLOT, cf, &full[s]);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  int any = 0;
  int s = 0, phase = 0;  // slot of row k, and the parity of its use
  if constexpr (MODE == 2) {
    const int lane = tx & 31;
    const int i0 = 4 * tx;  // this consumer's columns i0 .. i0 + 3
    float4 np = make_float4(NEG, NEG, NEG, NEG);  // new values, row k - 1
    // the row before's sweep-start values across the tile's seams, kept by
    // the consumers that read them
    float seam_w = NEG, seam_e = NEG;
    for (int k = 0; k < h; ++k) {
      const size_t b = row_base(k);
      rd::bar_wait(&full[s], phase);
      const float* sw = ring + (2 * s) * SLOT + rd::lead(w_in, b + first) +
                        sh;  // sw[i]: w_in at column cs + i
      const float* sf = ring + (2 * s + 1) * SLOT +
                        rd::lead(flr, b + first) + sh;
      const float4 wr = *reinterpret_cast<const float4*>(sw + i0);
      const float4 fr = *reinterpret_cast<const float4*>(sf + i0);
      const float next_w = tx == 0 && has_l ? sw[-1] : NEG;
      const float next_e = tx == NT - 1 && has_r ? sw[TILE] : NEG;
      const float* p = prev + 4 + ((k + 1) & 1) * (TILE + 8);  // p[i]
      float* q = prev + 4 + (k & 1) * (TILE + 8);
      float npw = __shfl_up_sync(0xffffffffu, np.w, 1);
      float npe = __shfl_down_sync(0xffffffffu, np.x, 1);
      if (lane == 0) npw = tx == 0 ? seam_w : p[i0 - 1];
      if (lane == 31) npe = tx == NT - 1 ? seam_e : p[i0 + 4];
      const float pv[6] = {npw, np.x, np.y, np.z, np.w, npe};
      const float wv[4] = {wr.x, wr.y, wr.z, wr.w};
      const float fv[4] = {fr.x, fr.y, fr.z, fr.w};
      float nv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float cand = pv[c + 1] + eps;              // N
        cand = fminf(cand, pv[c] + eps_diag);      // NW
        cand = fminf(cand, pv[c + 2] + eps_diag);  // NE
        nv[c] = fminf(wv[c], fmaxf(fv[c], cand));
        any |= (nv[c] != wv[c]);
      }
      np = make_float4(nv[0], nv[1], nv[2], nv[3]);
      *reinterpret_cast<float4*>(w_out + b + cs + i0) = np;
      if (lane == 0) q[i0] = nv[0];      // for the warp before
      if (lane == 31) q[i0 + 3] = nv[3];  // for the warp after
      seam_w = next_w;
      seam_e = next_e;
      rd::sync_consumers(NT);  // row k's edge values are in q; stage s read
      if (tx == 0) rd::bar_arrive(&empty[s]);
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
  } else {
    for (int k = 0; k < h; ++k) {
      const size_t b = row_base(k);
      rd::bar_wait(&full[s], phase);
      const float* sw = ring + (2 * s) * SLOT + rd::lead(w_in, b + first) +
                        sh;
      const float* sf = ring + (2 * s + 1) * SLOT +
                        rd::lead(flr, b + first) + sh;
      const float* p = prev + ((k + 1) & 1) * (TILE + 2);  // p[i + 1]
      float* q = prev + (k & 1) * (TILE + 2);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int i = tx + j * NT;
        if (MODE == 1 || i < ncols) {
          float cand = p[i + 1] + eps;              // N
          cand = fminf(cand, p[i] + eps_diag);      // NW
          cand = fminf(cand, p[i + 2] + eps_diag);  // NE
          const float wr = sw[i];
          const float nv = fminf(wr, fmaxf(sf[i], cand));
          w_out[b + cs + i] = nv;
          any |= (nv != wr);
          q[i + 1] = nv;
        }
      }
      if (tx == 0) {  // seams: sweep-start values of this row
        q[0] = has_l ? sw[-1] : NEG;
        q[ncols + 1] = has_r ? sw[ncols] : NEG;
      }
      rd::sync_consumers(NT);  // row k's new values are in q; stage s read
      if (tx == 0) rd::bar_arrive(&empty[s]);
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
  }
  if (__any_sync(0xffffffffu, any) && (tx & 31) == 0) atomicOr(changed, 1);
}

template <int MODE>
int launch(const float* w_in, const float* flr, float* w_out, int* changed,
           int h, int w, float eps, float eps_diag, int reverse, int tile0,
           int tiles, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fill_sweep_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      LAYOUT.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_sweep_kernel<MODE><<<tiles, NT + 32, LAYOUT.bytes, stream>>>(
      w_in, flr, w_out, changed, h, w, eps, eps_diag, reverse, tile0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch over the full tiles, one over a ragged last tile.
extern "C" int rd_fill_sweep(const float* w_in, const float* flr,
                             float* w_out, int* changed, int h, int w,
                             float eps, float eps_diag, int reverse,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int full_tiles = w / TILE;
  if (full_tiles > 0) {
    const int rc =
        rd::rows_aligned(w, 4, {w_in, flr, w_out})
            ? launch<2>(w_in, flr, w_out, changed, h, w, eps, eps_diag,
                        reverse, 0, full_tiles, st)
            : launch<1>(w_in, flr, w_out, changed, h, w, eps, eps_diag,
                        reverse, 0, full_tiles, st);
    if (rc != 0) return rc;
  }
  if (w % TILE == 0) return 0;
  return launch<0>(w_in, flr, w_out, changed, h, w, eps, eps_diag, reverse,
                   full_tiles, 1, st);
}
