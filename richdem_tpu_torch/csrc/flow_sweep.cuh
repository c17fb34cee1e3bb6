// One directional sweep of multi-flow accumulation, A = w + P^T A, shared by
// dinf_sweep.cu (the packed two-tap D-infinity field) and mfd_sweep.cu (8
// proportion planes).  The field decides how a cell's tap weights are loaded
// and stored; everything else lives here.
//
// Walking a row-major (H, W) raster down (REV = 0), row r takes
//   new values of the row before, through the taps toward 7 (S), 6 (SE,
//     from the west source) and 8 (SW, from the east source);
//   sweep-start values of the row after, through the taps toward 3 (N),
//     4 (NE, west source) and 2 (NW, east source);
//   its own row's values through the taps toward 5 (E, from the west
//     neighbour) and 1 (W, from the east neighbour).
// Walking up (REV = 1) swaps the two trios.  base = (w + new) + old, each
// trio summed straight, west, east, each term value * tap.
//
// In-row terms, by the window `lim` the caller derives from the depth:
//   lim = 1: sweep-start values of the E/W neighbours,
//            new = (base + tapE[j-1] old[j-1]) + tapW[j+1] old[j+1];
//   lim > 1: the E chain new[j] = base[j] + tapE[j-1] new[j-1] and the W
//            chain (mirror) are solved over a window of lim columns by a
//            Hillis-Steele composition of affine maps (b = a*b' + b, then
//            a = a*a'), closed with the sweep-start value at j -/+ lim, or
//            at the tile's neighbour column where the window meets the tile
//            edge; new = (newE + newW) - base.  lim = TILE solves the whole
//            tile.  E and W chains are independent on an acyclic field.
// This is richdem_tpu/ops/pallas_scan.py:_accum_scan_kernel and
// _mfd_scan_kernel, with the row ending at the tile edge instead of the
// grid edge.
//
// What bounds it on an H100: the row-to-row dependency, as in
// accum_sweep.cu, whose structure it keeps: one thread per column in a
// TILE-column tile, each block walking all H rows with one barrier per row
// (and one per doubling step of the in-row scan).  A 10240-wide raster gives
// 10 blocks for 132 SMs.  Each row's acc, weight and field are loaded PF
// rows ahead into registers and staged through a 4-row shared-memory ring
// (dynamic shared memory; the field decodes once per row as it stages).  A
// new value from across a tile edge is read at its sweep-start value, which
// only delays convergence of the rotation-level fixpoint and keeps runs
// deterministic.  No change flag: the caller judges convergence on whole
// rotations.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#ifndef RD_TILE
#define RD_TILE 1024
#endif

namespace rd {

constexpr int TILE = RD_TILE;
constexpr int W2 = TILE + 2;  // a row of a tile with one halo column a side

// Directions of the taps each role reads, for a sweep down (REV = 0) or up.
template <int REV>
struct Dirs {
  static constexpr int NS = REV ? 3 : 7, NW = REV ? 4 : 6, NE = REV ? 2 : 8;
  static constexpr int OS = REV ? 7 : 3, OW = REV ? 6 : 4, OE = REV ? 8 : 2;
  static constexpr int IE = 5, IW = 1;
};

struct Base {
  float a[4][W2];     // sweep-start acc of staged rows (halo: seams)
  float w[4][TILE];   // weights of staged rows
  float newp[2][W2];  // new acc of the row before (halo: sweep-start)
  float ea[2][TILE], eb[2][TILE];  // E-chain scan, ping-pong
  float wa[2][TILE], wb[2][TILE];  // W-chain scan, ping-pong
};

template <class F, int REV, int PF>
__global__ void __launch_bounds__(TILE, 1)
flow_sweep_kernel(const float* __restrict__ acc_in,
                  const float* __restrict__ wgt, typename F::Ptrs fp,
                  float* __restrict__ acc_out, int h, int w, int lim) {
  using D = Dirs<REV>;
  extern __shared__ __align__(16) unsigned char smem[];
  Base& sh = *reinterpret_cast<Base*>(smem);
  F field(fp, reinterpret_cast<typename F::Shared*>(smem + sizeof(Base)));

  const int tx = threadIdx.x;
  const int c0 = blockIdx.x * TILE;
  const int ncols = min(TILE, w - c0);
  const int c = c0 + tx;
  const bool own = tx < ncols;
  // thread 0 loads the left halo column, thread 1 the right one
  const bool halo = (tx == 0 && c0 > 0) || (tx == 1 && c0 + ncols < w);
  const int hcol = tx == 0 ? c0 - 1 : c0 + ncols;
  const int hpos = tx == 0 ? 0 : ncols + 1;

  struct Row {
    float a, wt, ha;  // acc and weight of this column; halo acc
    typename F::Own f;
    typename F::Halo hf;
  };
  auto row_base = [&](int k) -> size_t {
    return static_cast<size_t>(REV ? h - 1 - k : k) * static_cast<size_t>(w);
  };
  // rows past the last one, and off-grid halos, read as zero acc, no flow
  auto load = [&](int k, Row& v) {
    v.a = v.wt = v.ha = 0.0f;
    F::clear(v.f);
    F::clear(v.hf);
    if (k < h) {
      const size_t base = row_base(k);
      if (own) {
        v.a = acc_in[base + c];
        v.wt = wgt[base + c];
        field.load(base + c, v.f);
      }
      if (halo) {
        v.ha = acc_in[base + hcol];
        field.template load_halo<REV>(base + hcol, tx, v.hf);
      }
    }
  };
  auto stage = [&](int slot, const Row& v) {
    if (own) {
      sh.a[slot][tx + 1] = v.a;
      sh.w[slot][tx] = v.wt;
      field.stage(slot, tx + 1, v.f);
    }
    if (tx < 2) {
      sh.a[slot][hpos] = v.ha;
      field.template stage_halo<REV>(slot, hpos, tx, v.hf);
    }
  };

  Row buf[PF];
#pragma unroll
  for (int j = 0; j < PF; ++j) load(j, buf[j]);
  // slot 3 is the row before the first one: off-grid, no flow
  for (int i = tx; i < W2; i += TILE) {
    sh.a[3][i] = 0.0f;
    sh.newp[1][i] = 0.0f;
    field.zero(3, i);
  }
  stage(0, buf[0]);
  load(PF, buf[0]);

  for (int k0 = 0; k0 < h; k0 += PF) {
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      const int k = k0 + j;
      if (k < h) {  // uniform across the block
        const int jn = (j + 1) % PF;
        stage((k + 1) & 3, buf[jn]);  // row k+1 (zeros past the end)
        load(k + 1 + PF, buf[jn]);
        __syncthreads();
        const int sp = (k + 3) & 3, s0 = k & 3, sn = (k + 1) & 3;
        const float* pa = sh.newp[(k + 1) & 1];
        float* qa = sh.newp[k & 1];
        const float* la = sh.a[s0];
        const float* na = sh.a[sn];
        float base = 0.0f, nv = 0.0f;
        if (own) {
          float newc = pa[tx + 1] * field.template tap<D::NS>(sp, tx + 1) +
                       pa[tx] * field.template tap<D::NW>(sp, tx);
          newc = newc + pa[tx + 2] * field.template tap<D::NE>(sp, tx + 2);
          float oldb = na[tx + 1] * field.template tap<D::OS>(sn, tx + 1) +
                       na[tx] * field.template tap<D::OW>(sn, tx);
          oldb = oldb + na[tx + 2] * field.template tap<D::OE>(sn, tx + 2);
          base = (sh.w[s0][tx] + newc) + oldb;
        }
        if (lim == 1) {  // uniform
          if (own)
            nv = (base + field.template tap<D::IE>(s0, tx) * la[tx]) +
                 field.template tap<D::IW>(s0, tx + 2) * la[tx + 2];
        } else {
          float ea = own ? field.template tap<D::IE>(s0, tx) : 1.0f;
          float wa = own ? field.template tap<D::IW>(s0, tx + 2) : 1.0f;
          float eb = base, wb = base;
          int pp = 0;
          for (int d = 1; d < lim; d <<= 1) {
            sh.ea[pp][tx] = ea;
            sh.eb[pp][tx] = eb;
            sh.wa[pp][tx] = wa;
            sh.wb[pp][tx] = wb;
            __syncthreads();
            if (tx >= d) {  // else the identity map (a = 1, b = 0)
              const float pa2 = sh.ea[pp][tx - d], pb2 = sh.eb[pp][tx - d];
              eb = ea * pb2 + eb;
              ea = ea * pa2;
            }
            if (tx + d < ncols) {
              const float qa2 = sh.wa[pp][tx + d], qb2 = sh.wb[pp][tx + d];
              wb = wa * qb2 + wb;
              wa = wa * qa2;
            }
            pp ^= 1;
          }
          if (own) {
            const float xe = la[max(0, tx + 1 - lim)];
            const float xw = la[min(ncols + 1, tx + 1 + lim)];
            const float ne = eb + ea * xe;
            const float nw = wb + wa * xw;
            nv = (ne + nw) - base;
          }
        }
        if (own) {
          acc_out[row_base(k) + c] = nv;
          qa[tx + 1] = nv;
        }
        if (tx == 0) {  // seams: sweep-start values of this row
          qa[0] = la[0];
          qa[ncols + 1] = la[ncols + 1];
        }
      }
    }
  }
}

// Launch one sweep: dynamic shared memory above 48 KB must be granted to
// each instantiation before its launch.
template <class F, int PF>
int launch_flow_sweep(const float* acc_in, const float* wgt,
                      typename F::Ptrs fp, float* acc_out, int h, int w,
                      int reverse, int lim, void* stream) {
  if (lim < 1 || lim > TILE || (lim & (lim - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(Base) + sizeof(typename F::Shared);
  const dim3 grid((w + TILE - 1) / TILE);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (reverse) {
    err = cudaFuncSetAttribute(flow_sweep_kernel<F, 1, PF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    flow_sweep_kernel<F, 1, PF><<<grid, TILE, bytes, s>>>(
        acc_in, wgt, fp, acc_out, h, w, lim);
  } else {
    err = cudaFuncSetAttribute(flow_sweep_kernel<F, 0, PF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    flow_sweep_kernel<F, 0, PF><<<grid, TILE, bytes, s>>>(
        acc_in, wgt, fp, acc_out, h, w, lim);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rd
