// One directional Gauss-Seidel sweep over int32 values and int8 D8 codes,
// the walk of strahler_sweep.cu (Strahler order from the orders of the
// cells that flow in).  The rule of one cell is the op's (a template
// parameter); everything else lives here.
//
// Walking a row-major (H, W) raster down (REV = 0) or up (REV = 1), row r
// sees, through a Nbhd of three staged rows (index -1 west, 0, +1 east):
//   p: new values of the row before in sweep order (r - 1 going down);
//   l: sweep-start values of its own row;
//   n: sweep-start values of the row after;
// and the codes of all three rows.  This is what
// richdem_tpu/ops/pallas_folded.py:_strahler_kernel reads within a strip.
// Rows and columns off the grid read the op's OFF value and code 0.
//
// What bounds it on an H100: the row-to-row dependency, as in
// accum_sweep.cu, whose structure it keeps: one thread per column in a
// TILE-column tile, each block walking all H rows with one barrier per row;
// a 10240-wide raster gives 10 blocks for 132 SMs.  Each row's values and
// codes are loaded PF rows ahead into registers and staged through a 4-row
// shared-memory ring.  A new value from across a tile edge is read at its
// sweep-start value, which only delays convergence of the rotation-level
// fixpoint (both fixpoints are unique on an acyclic code raster) and keeps
// runs deterministic.  No change flag: the caller compares whole rotations
// (int32 values, so equality is exact).

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
constexpr int PF = 4;         // rows of loads kept in flight per thread

// Three staged rows around one cell, each pointer at the cell's column.
struct Nbhd {
  const int32_t* p;  // row before, new values (sweep-start across a seam)
  const int8_t* pc;
  const int32_t* l;  // own row, sweep-start values
  const int8_t* lc;
  const int32_t* n;  // row after, sweep-start values
  const int8_t* nc;
};

template <class Op, int REV>
__global__ void __launch_bounds__(TILE)
succ_sweep_kernel(const int32_t* __restrict__ v_in,
                  const int8_t* __restrict__ code,
                  int32_t* __restrict__ v_out, int h, int w) {
  __shared__ int32_t v_sh[4][W2];   // sweep-start values, rows k-1..k+1
  __shared__ int8_t c_sh[4][W2];    // codes, same rows
  __shared__ int32_t newp[2][W2];   // new values of the row before
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
    int32_t v, hv;  // value of this column; halo value
    int f, hf;      // codes, same
  };
  auto row_base = [&](int k) -> size_t {
    return static_cast<size_t>(REV ? h - 1 - k : k) * static_cast<size_t>(w);
  };
  // rows past the last one, and off-grid halos, read as OFF, code 0
  auto load = [&](int k, Row& x) {
    x.v = x.hv = Op::OFF;
    x.f = x.hf = 0;
    if (k < h) {
      const size_t base = row_base(k);
      if (own) {
        x.v = v_in[base + c];
        x.f = code[base + c];
      }
      if (halo) {
        x.hv = v_in[base + hcol];
        x.hf = code[base + hcol];
      }
    }
  };
  auto stage = [&](int slot, const Row& x) {
    if (own) {
      v_sh[slot][tx + 1] = x.v;
      c_sh[slot][tx + 1] = static_cast<int8_t>(x.f);
    }
    if (tx < 2) {
      v_sh[slot][hpos] = x.hv;
      c_sh[slot][hpos] = static_cast<int8_t>(x.hf);
    }
  };

  Row buf[PF];
#pragma unroll
  for (int j = 0; j < PF; ++j) load(j, buf[j]);
  // slot 3 is the row before the first one: off the grid
  for (int i = tx; i < W2; i += TILE) {
    v_sh[3][i] = Op::OFF;
    c_sh[3][i] = 0;
    newp[1][i] = Op::OFF;
  }
  stage(0, buf[0]);
  load(PF, buf[0]);

  for (int k0 = 0; k0 < h; k0 += PF) {
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      const int k = k0 + j;
      if (k < h) {  // uniform across the block
        const int jn = (j + 1) % PF;
        stage((k + 1) & 3, buf[jn]);  // row k+1 (OFF past the end)
        load(k + 1 + PF, buf[jn]);
        __syncthreads();
        const int sp = (k + 3) & 3, s0 = k & 3, sn = (k + 1) & 3;
        const int32_t* pa = newp[(k + 1) & 1];
        int32_t* qa = newp[k & 1];
        if (own) {
          const Nbhd nb{pa + tx + 1,       c_sh[sp] + tx + 1,
                        v_sh[s0] + tx + 1, c_sh[s0] + tx + 1,
                        v_sh[sn] + tx + 1, c_sh[sn] + tx + 1};
          const int32_t nv = Op::template cell<REV>(nb);
          v_out[row_base(k) + c] = nv;
          qa[tx + 1] = nv;
        }
        if (tx == 0) {  // seams: sweep-start values of this row
          qa[0] = v_sh[s0][0];
          qa[ncols + 1] = v_sh[s0][ncols + 1];
        }
      }
    }
  }
}

template <class Op>
int launch_succ_sweep(const int32_t* v_in, const int8_t* code,
                      int32_t* v_out, int h, int w, int reverse,
                      void* stream) {
  const dim3 grid((w + TILE - 1) / TILE);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reverse)
    succ_sweep_kernel<Op, 1><<<grid, TILE, 0, s>>>(v_in, code, v_out, h, w);
  else
    succ_sweep_kernel<Op, 0><<<grid, TILE, 0, s>>>(v_in, code, v_out, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rd
