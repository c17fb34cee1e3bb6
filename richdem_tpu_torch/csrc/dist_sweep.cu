// One directional Gauss-Seidel sweep of a masked unit-cost distance
// fixpoint (flat resolution):
//
//     D(c) = min( D(c), min_{n admissible} D(n) + step )
//
// over the three neighbours in the row before (N straight, NW/NE diagonal),
// walking a row-major float32 (H, W) raster down (reverse = 0) or up
// (reverse = 1).  An edge n -> c is admissible when both cells hold one data
// elevation (z < 2.9e37; nodata carries 3e37) and their flag bytes pass the
// mode's test (bits: 1 data, 2 NO_FLOW, 4 in a flat):
//
//   member  (0): both data
//   towards (1): c NO_FLOW and in a flat, n in a flat
//   away    (2): both NO_FLOW and in a flat
//   maxd    (3): both in a flat                 (min-plus on -D, step 0)
//
// Off-grid cells are w = BIG, z = 3e37, flags 0: they never relax a cell.
// Admissibility is recomputed here from z and the flags, so no (8, H, W)
// cost planes are built.  The in-row E/W chains are left to the transposed
// sweeps of the rotation.
//
// Replaces the TPU kernels richdem_tpu/ops/pallas_sweeps.py:_dist_down_kernel
// (line 396) and richdem_tpu/ops/pallas_scan.py:_dist_scan_kernel (line
// 1121).  Both relax the same fixpoint, which has one answer in exact small
// integers, so the sweep order (and the scan kernel's in-row tropical
// scans) changes only the number of rotations, never the result.
//
// What bounds it on an H100: the row-to-row dependency, as in
// fill_sweep.cu, whose structure it keeps: one thread per column, 1024-
// column tiles (a 10240-wide raster gives 10 blocks for 132 SMs), each block
// walking all H rows in order with one barrier per row.  The new row before
// and its z and flags sit in shared memory; the global loads of the next PF
// rows are issued PF steps ahead into registers.  A neighbour across a tile
// edge is read at its sweep-start value (from `w_in`), which only delays
// convergence of the monotone fixpoint and keeps every run deterministic.
//
// Change flag: one atomicOr per block into `changed` when any cell of the
// block changed; every sweep is idempotent at the fixpoint.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef RD_TILE
#define RD_TILE 1024
#endif

namespace {

constexpr int TILE = RD_TILE;
constexpr int PF = 4;              // rows of loads kept in flight per thread
constexpr float BIG = 1.0e30f;     // unreached
constexpr float ZBIG = 3.0e37f;    // elevation of nodata and off-grid cells
constexpr float ZVALID = 2.9e37f;  // z < ZVALID: a data elevation
constexpr int F_DATA = 1, F_NOFLOW = 2, F_INFLAT = 4;
constexpr int NF_IN = F_NOFLOW | F_INFLAT;

// the cell's side of the mode's test
template <int MODE>
__device__ __forceinline__ bool cell_ok(int s) {
  if (MODE == 0) return (s & F_DATA) != 0;
  if (MODE == 3) return (s & F_INFLAT) != 0;
  return (s & NF_IN) == NF_IN;  // towards, away
}

// the neighbour's side of the mode's test
template <int MODE>
__device__ __forceinline__ bool nb_ok(int sn) {
  if (MODE == 0) return (sn & F_DATA) != 0;
  if (MODE == 2) return (sn & NF_IN) == NF_IN;
  return (sn & F_INFLAT) != 0;  // towards, maxd
}

template <int MODE>
__global__ void __launch_bounds__(TILE)
dist_sweep_kernel(const float* __restrict__ w_in,
                  const float* __restrict__ zr,
                  const int8_t* __restrict__ fl,
                  float* __restrict__ w_out, int* __restrict__ changed,
                  int h, int w, float step, int reverse) {
  // the row before (new w; z and flags), one halo column on either side
  __shared__ float pw[2][TILE + 2];
  __shared__ float pz[2][TILE + 2];
  __shared__ int8_t ps[2][TILE + 2];
  const int tx = threadIdx.x;
  const int c0 = blockIdx.x * TILE;
  const int ncols = min(TILE, w - c0);
  const int c = c0 + tx;
  const bool own = tx < ncols;
  const bool has_l = c0 > 0;
  const bool has_r = c0 + ncols < w;

  // this column's w, z, flags; tile-edge halo (thread 0): w and z of
  // columns c0 - 1 and c0 + ncols, their flags packed as l | r << 8
  float wb[PF], zb[PF], lw[PF], rw[PF], lz[PF], rz[PF];
  int sb[PF], hs[PF];
  auto row_base = [&](int k) -> size_t {
    return static_cast<size_t>(reverse ? h - 1 - k : k) *
           static_cast<size_t>(w);
  };
  auto load = [&](int k, float& wv, float& zv, int& sv, float& lwv,
                  float& rwv, float& lzv, float& rzv, int& hv) {
    if (k < h) {
      const size_t base = row_base(k);
      if (own) {
        wv = w_in[base + c];
        zv = zr[base + c];
        sv = fl[base + c];
      }
      if (tx == 0) {
        int ls = 0, rs = 0;
        if (has_l) {
          lwv = w_in[base + c0 - 1];
          lzv = zr[base + c0 - 1];
          ls = fl[base + c0 - 1];
        }
        if (has_r) {
          rwv = w_in[base + c0 + ncols];
          rzv = zr[base + c0 + ncols];
          rs = fl[base + c0 + ncols];
        }
        hv = ls | (rs << 8);
      }
    }
  };

#pragma unroll
  for (int j = 0; j < PF; ++j) {
    wb[j] = lw[j] = rw[j] = BIG;
    zb[j] = lz[j] = rz[j] = ZBIG;
    sb[j] = hs[j] = 0;
    load(j, wb[j], zb[j], sb[j], lw[j], rw[j], lz[j], rz[j], hs[j]);
  }
  // the row before the first one is off-grid
  pw[1][tx + 1] = BIG;
  pz[1][tx + 1] = ZBIG;
  ps[1][tx + 1] = 0;
  if (tx == 0) {
    pw[1][0] = pw[1][TILE + 1] = BIG;
    pz[1][0] = pz[1][TILE + 1] = ZBIG;
    ps[1][0] = ps[1][TILE + 1] = 0;
  }
  __syncthreads();

  int any = 0;
  for (int k0 = 0; k0 < h; k0 += PF) {
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      const int k = k0 + j;
      if (k < h) {  // uniform across the block
        const int pb = (k + 1) & 1, qb = k & 1;
        const float wr = wb[j], zc = zb[j], lwh = lw[j], rwh = rw[j];
        const float lzh = lz[j], rzh = rz[j];
        const int sc = sb[j], hh = hs[j];
        load(k + PF, wb[j], zb[j], sb[j], lw[j], rw[j], lz[j], rz[j],
             hs[j]);
        if (own) {
          float cand = BIG;
          if (zc < ZVALID && cell_ok<MODE>(sc)) {
#pragma unroll
            for (int o = 0; o < 3; ++o) {  // NW, N, NE of the row before
              const float zn = pz[pb][tx + o];
              if (zn == zc && nb_ok<MODE>(ps[pb][tx + o])) {
                const float v = pw[pb][tx + o] + step;
                cand = v < cand ? v : cand;
              }
            }
          }
          const float nv = cand < wr ? cand : wr;
          w_out[row_base(k) + c] = nv;
          any |= (nv != wr);
          pw[qb][tx + 1] = nv;
          pz[qb][tx + 1] = zc;
          ps[qb][tx + 1] = static_cast<int8_t>(sc);
        }
        if (tx == 0) {  // seams: sweep-start values of this row
          pw[qb][0] = lwh;
          pz[qb][0] = lzh;
          ps[qb][0] = static_cast<int8_t>(hh & 0xff);
          pw[qb][ncols + 1] = rwh;
          pz[qb][ncols + 1] = rzh;
          ps[qb][ncols + 1] = static_cast<int8_t>(hh >> 8);
        }
        __syncthreads();
      }
    }
  }
  if (__syncthreads_or(any) && tx == 0) atomicOr(changed, 1);
}

}  // namespace

extern "C" int rd_dist_sweep(const float* w_in, const float* z,
                             const int8_t* flags, float* w_out, int* changed,
                             int h, int w, int mode, float step, int reverse,
                             void* stream) {
  const dim3 grid((w + TILE - 1) / TILE);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      dist_sweep_kernel<0><<<grid, TILE, 0, s>>>(w_in, z, flags, w_out,
                                                 changed, h, w, step, reverse);
      break;
    case 1:
      dist_sweep_kernel<1><<<grid, TILE, 0, s>>>(w_in, z, flags, w_out,
                                                 changed, h, w, step, reverse);
      break;
    case 2:
      dist_sweep_kernel<2><<<grid, TILE, 0, s>>>(w_in, z, flags, w_out,
                                                 changed, h, w, step, reverse);
      break;
    case 3:
      dist_sweep_kernel<3><<<grid, TILE, 0, s>>>(w_in, z, flags, w_out,
                                                 changed, h, w, step, reverse);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
