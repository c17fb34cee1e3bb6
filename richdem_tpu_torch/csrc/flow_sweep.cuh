// One directional sweep of multi-flow accumulation, A = w + P^T A, shared by
// dinf_sweep.cu (the packed two-tap D-infinity field) and mfd_sweep.cu (8
// proportion planes).  The field decides which rows of which rasters a row
// step stages and how it reads a tap; everything else lives here.
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
//            at the grid edge (zero); new = ((newE - base) + (newW -
//            base)) + base: the two in-row inflows summed apart from the
//            base, which they are usually far below (the reference's
//            (newE + newW) - base rounds once at twice the base's
//            magnitude, and its float32 fixpoint drifts from mass
//            conservation by 1e-5 on Quinn at 10240^2).  E and W chains are
//            independent on an acyclic field.
// This is richdem_tpu/ops/pallas_scan.py:_accum_scan_kernel and
// _mfd_scan_kernel.
//
// Seams.  A block owns a run of TILE-column tiles and walks all H rows.
// Row r of a tile needs the new values of row r - 1 up to lim columns past
// its edges, and nothing else of its neighbours': so the tiles trade edge
// values, and where lim <= HALO one sweep is the sweep over whole rows,
// whatever TILE and however many tiles a block owns (bitwise).  A block
// publishes that it finished row r by a release store of r + 1 to its
// flag, after its new values are in `acc_out`; at an exchange row its
// thread 0 waits (acquire, with __nanosleep backoff) until both
// neighbours' flags reach the row, and a barrier releases the other
// threads, which read the neighbours' new values from `acc_out` through L2
// (ld.global.cg).  A block that owns one tile exchanges only every R =
// HALO / lim rows: at an exchange row it takes R * lim columns of new
// values past each edge and computes its row (R - 1) * lim columns past
// them, then lim columns fewer a row, keeping them in shared memory, so
// that each row until the next exchange finds the values of the row
// before that it needs (ghost columns, computed by both neighbours from
// the same values in the same order: bitwise equal).  The scans also run
// lim - 1 columns past a row's computed columns, over inputs that never
// change within a sweep.  A wider window (depth 0 is lim = TILE) stops at
// the tile edge, closed with the neighbour column's sweep-start value, and
// every row exchanges; the row before is still read at its new values.
// Blocks wait on each other, so all of a sweep's blocks must be resident:
// the launch is cooperative (cudaLaunchCooperativeKernel refuses a grid
// that cannot be), and where a grid has more tiles than resident blocks a
// block owns a run of adjacent tiles, walks them in order within each row
// and exchanges every row.  A block stays within R rows of its neighbours,
// and a flag that is not set within 10 s traps (a launch error) rather
// than hang.
//
// What bounds it on an H100: the row-to-row dependency, now also between
// blocks: a row step waits for its neighbours' earlier row.  What the
// design does about it: the exchange only every R rows (its fence, flag
// and L2 round trip once in R row steps); narrow tiles, so a row spreads
// over many SMs and a block's row step is short (TILE = 128 columns with
// HALO = 64 on an H100: _build.FLOW_TILE, FLOW_HALO); one consumer thread
// a column of the tile and its halo, and a producer warp; windows of up to
// LOCAL columns composed by each thread from the row's maps after one
// barrier, wider ones by the doubling steps, a barrier each.  One row step
// of one tile is an item: the producer stages the rows an item reads (the
// field's taps of rows r - 1 and r + 1, acc and w of row r, acc of row
// r + 1, each over the tile and HALO columns either side) in a
// shared-memory ring by bulk asynchronous copies (row_ring.cuh), one lane
// a copy, up to STAGES items ahead, each stage on its full and empty
// mbarriers.  Every plane is read from device memory once a sweep (each
// tap plays one role a sweep).  No change flag: the caller judges
// convergence on whole rotations.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "row_ring.cuh"

#ifndef RD_FLOW_TILE
#define RD_FLOW_TILE 128
#endif
#ifndef RD_FLOW_HALO
#define RD_FLOW_HALO 64
#endif

namespace rd {
namespace flow {

constexpr int TILE = RD_FLOW_TILE;
constexpr int HALO = RD_FLOW_HALO;
// A tile's columns and HALO columns either side: staged, kept, and each
// the column of one consumer thread
constexpr int EXT = TILE + 2 * HALO;
constexpr int NT = EXT;                   // consumers; a producer warp besides
constexpr int SLOT = EXT + 8;             // floats: the covering span fits
constexpr int BUDGET = 227 * 1024;        // shared memory a block may use
static_assert(TILE % 32 == 0 && HALO % 32 == 0 && TILE > HALO &&
                  EXT + 32 <= 1024,
              "tiles wider than the exchange, both whole warps, and a "
              "thread a column within a block's 1024");

// The item's rows, by role.  Slots 0..2 are acc and w of row r and acc of
// row r + 1 (sweep order); the field's slots follow.
enum Role { P_S, P_W, P_E, N_S, N_W, N_E, G_E, G_W };

// Directions of the taps each role reads, for a sweep down (REV = 0) or up.
template <int REV>
struct Dirs {
  static constexpr int NS = REV ? 3 : 7, NW = REV ? 4 : 6, NE = REV ? 2 : 8;
  static constexpr int OS = REV ? 7 : 3, OW = REV ? 6 : 4, OE = REV ? 8 : 2;
  static constexpr int IE = 5, IW = 1;
  static constexpr __host__ __device__ int of(int role) {
    return role == P_S ? NS : role == P_W ? NW : role == P_E ? NE
         : role == N_S ? OS : role == N_W ? OW : role == N_E ? OE
         : role == G_E ? IE : IW;
  }
};

// Row offset in sweep order of a role's taps: -1 the row before, +1 the
// row after, 0 the row itself.
constexpr __host__ __device__ int row_of(int role) {
  return role <= P_E ? -1 : (role <= N_E ? 1 : 0);
}

// One staged item as the consumers read it: slot q of column c is
// sm[off[q] + c]; a column off the grid (`in` false) reads as zero, and
// so does a row off it.
template <int NSLOT>
struct View {
  const float* sm;
  int off[NSLOT];
  bool prev, next;  // rows r - 1 and r + 1 exist
  __device__ float at(int q, int c, bool in) const {
    return in ? sm[off[q] + c] : 0.0f;
  }
  __device__ bool row_ok(int dr) const {
    return dr < 0 ? prev : (dr > 0 ? next : true);
  }
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until *flag >= target; trap after 10 s (a neighbour that never
// finishes its row is a fault, not a wait).
__device__ __forceinline__ void wait_flag(const int* flag, int target) {
  if (ld_acquire(flag) >= target) return;
  const uint64_t t0 = global_ns();
  unsigned ns = 32;
  for (int spin = 0; ld_acquire(flag) < target; ++spin) {
    if (spin >= 32) {
      __nanosleep(ns);
      if (ns < 1024) ns <<= 1;
      if (global_ns() - t0 > 10000000000ull) __trap();
    }
  }
}

// The Hillis-Steele composition of one chain over a window of LIM <=
// LOCAL columns, by one thread from the row's maps (a, b) in shared
// memory: the same steps in the same order as the doubling loop (step d
// composes column j's map with column j - d's, skipped where j - d leaves
// the scanned columns), walked over the columns x - m (E chain, dir -1;
// bound: the first scanned column) or x + m (W chain, dir 1; bound: one
// past the last) that the thread's result depends on.
constexpr int LOCAL = 8;

template <int LIM>
__device__ __forceinline__ void local_scan(const float* sa, const float* sb,
                                           int x, int bound, int dir,
                                           float& a, float& b) {
  float A[LIM], B[LIM];
  A[0] = a;
  B[0] = b;
#pragma unroll
  for (int m = 1; m < LIM; ++m) {
    const int y = x + dir * m;
    const bool in = dir < 0 ? y >= bound : y < bound;
    A[m] = in ? sa[y] : 1.0f;
    B[m] = in ? sb[y] : 0.0f;
  }
#pragma unroll
  for (int d = 1; d < LIM; d <<= 1) {
#pragma unroll
    for (int m = 0; m < LIM; m += 2 * d) {
      const int y = x + dir * (m + d);
      if (dir < 0 ? y >= bound : y < bound) {
        B[m] = A[m] * B[m + d] + B[m];
        A[m] = A[m] * A[m + d];
      }
    }
  }
  a = A[0];
  b = B[0];
}

// Dynamic shared memory: full and empty barriers of each stage, the
// ping-pong scan arrays, the kept new values of two rows, then the ring.
template <class F>
struct Smem {
  static constexpr int STAGE = F::NSLOT * SLOT * 4;  // bytes
  static constexpr int SCAN = 16 * 8 * 2;            // the barriers, room
  // 4 scan arrays [2][EXT], then the new values of two rows [2][EXT]
  static constexpr int RING = SCAN + 10 * EXT * 4;
  static constexpr int FIT = (BUDGET - RING) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int BYTES = RING + STAGES * STAGE;
  static_assert(STAGES >= 2, "two stages of the ring fit at least");
};

template <class F, int REV>
__global__ void __launch_bounds__(NT + 32, 1)
flow_sweep_kernel(const float* __restrict__ acc_in,
                  const float* __restrict__ wgt, typename F::Ptrs fp,
                  float* acc_out, int h, int w, int lim, int tpb, int ntiles,
                  int* flags) {
  using S = Smem<F>;
  constexpr int NSLOT = F::NSLOT;
  constexpr int STAGES = S::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + 8;
  float* scan = reinterpret_cast<float*>(smem + S::SCAN);
  // scan arrays [2][EXT] each: E chain a, b; W chain a, b
  float* sea = scan;
  float* seb = scan + 2 * EXT;
  float* swa = scan + 4 * EXT;
  float* swb = scan + 6 * EXT;
  float* prv = scan + 8 * EXT;  // [2][EXT]: new values of two rows
  unsigned char* ring = smem + S::RING;

  const int tx = threadIdx.x;
  const int b = blockIdx.x, nblocks = gridDim.x;
  const int tile0 = b * tpb;
  const int ntb = min(tpb, ntiles - tile0);  // tiles of this block
  auto row_base = [&](int k) -> size_t {
    return static_cast<size_t>(REV ? h - 1 - k : k) * static_cast<size_t>(w);
  };
  // the raster and row offset (sweep order) of slot q
  auto source = [&](int q, int& dr) -> const float* {
    if (q == 0) { dr = 0; return acc_in; }
    if (q == 1) { dr = 0; return wgt; }
    if (q == 2) { dr = 1; return acc_in; }
    return F::template source<REV>(fp, q, dr);
  };

  if (tx == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 1);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (tx >= NT) {  // the producer warp: lane q stages slot q of each item
    const int lane = tx - NT;
    int s = 0, phase = 0, n = 0;
    for (int k = 0; k < h; ++k) {
      for (int t = 0; t < ntb; ++t, ++n) {
        if (n >= STAGES) bar_wait(&empty[s], phase ^ 1);
        const int t0 = (tile0 + t) * TILE, t1 = min(t0 + TILE, w);
        const int cs = max(0, t0 - HALO), ce = min(w, t1 + HALO);
        Covering cv{nullptr, 0};
        if (lane < NSLOT) {
          int dr;
          const float* src = source(lane, dr);
          const int kr = k + dr;
          if (kr >= 0 && kr < h) {
            const size_t rb = row_base(kr);
            cv = covering(src, rb + cs, rb + ce);
          }
        }
        uint32_t total = cv.bytes;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          total += __shfl_xor_sync(0xffffffffu, total, o);
        if (lane == 0) bar_expect(&full[s], total);
        __syncwarp();
        if (cv.bytes)
          bulk_copy(ring + s * S::STAGE + lane * SLOT * 4, cv, &full[s]);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Rows between exchanges: where each block owns one tile, a block keeps
  // the new values of the row before in shared memory over the columns its
  // later rows still need, R * lim past its edges at an exchange row,
  // shrinking by lim a row, so it takes its neighbours' edges only every R
  // rows.  R is the same in every block.
  const bool own_prev = tpb == 1;
  const int R = (own_prev && lim <= HALO) ? HALO / lim : 1;  // a power of 2
  for (int i = tx; i < 2 * EXT; i += NT) prv[i] = 0.0f;  // off the grid
  // each slot's raster's start, in floats mod 4: with a row's first
  // element's index it gives the slot's lead
  int align[NSLOT];
#pragma unroll
  for (int q = 0; q < NSLOT; ++q) {
    int dr;
    align[q] = static_cast<int>(
        (reinterpret_cast<uintptr_t>(source(q, dr)) >> 2) & 3);
  }
  int s = 0, phase = 0;
  for (int k = 0; k < h; ++k) {
    const size_t rb = row_base(k);
    const bool exchange = (k & (R - 1)) == 0;
    // rows r - 1, r, r + 1 (sweep order) mod 4, zero off the grid
    const int rm[3] = {k > 0 ? static_cast<int>(row_base(k - 1) & 3) : 0,
                       static_cast<int>(rb & 3),
                       k + 1 < h ? static_cast<int>(row_base(k + 1) & 3)
                                 : 0};
    // the row before, in sweep order, holds this row's new-side values
    const float* pn = k > 0 ? acc_out + row_base(k - 1) : acc_out;
    float* pprev = prv + ((k + 1) & 1) * EXT;  // column c at c - (t0 - HALO)
    float* pnew = prv + (k & 1) * EXT;
    if (exchange && nblocks > 1 && k > 0) {
      if (tx == 0) {
        if (b > 0) wait_flag(flags + b - 1, k);
        if (b + 1 < nblocks) wait_flag(flags + b + 1, k);
      }
      sync_consumers(NT);
    }
    for (int t = 0; t < ntb; ++t) {
      const int t0 = (tile0 + t) * TILE, t1 = min(t0 + TILE, w);
      const int cs = max(0, t0 - HALO);
      const int i = t0 - HALO + tx;  // this thread's column
      // the window's bounds; the columns this row computes new values of
      // [os, oe), and those whose scans it computes [es, ee)
      const bool cross = lim <= HALO;
      const int lb = cross ? 0 : t0, ub = cross ? w : t1;
      const int ext = (R - 1 - (k & (R - 1))) * lim;
      const int os = max(lb, t0 - ext), oe = min(ub, t1 + ext);
      const int es = max(lb, os - (lim - 1)), ee = min(ub, oe + (lim - 1));
      const bool active = i >= es && i < ee;
      const bool gm = i > 0, gp = i + 1 < w;  // i - 1, i + 1 on the grid
      View<NSLOT> v;
      v.sm = reinterpret_cast<const float*>(ring + s * S::STAGE);
      v.prev = k > 0;
      v.next = k + 1 < h;
#pragma unroll
      for (int q = 0; q < NSLOT; ++q) {  // lead(src, row start + cs)
        int dr;
        source(q, dr);
        v.off[q] = q * SLOT + ((align[q] + rm[dr + 1] + cs) & 3) - cs;
      }
      // at an exchange row, the new values of the row before that no row
      // of this block computed: the neighbours' (and, where a block owns
      // several tiles, its own) from acc_out, zero off the grid
      if (exchange && k > 0 && (nblocks > 1 || !own_prev)) {
        if (i >= es - 1 && i <= ee && (!own_prev || i < t0 || i >= t1))
          pprev[tx] = (i >= 0 && i < w) ? __ldcg(pn + i) : 0.0f;
        sync_consumers(NT);
      }
      bar_wait(&full[s], phase);

      float base = 0.0f, ea = 0.0f, eb = 0.0f, wa = 0.0f, wb = 0.0f;
      if (active) {
        float pm = 0.0f, p0 = 0.0f, pp = 0.0f;
        if (v.prev) {
          pm = pprev[tx - 1];
          p0 = pprev[tx];
          pp = pprev[tx + 1];
        }
        float newc = p0 * F::template tap<REV, P_S>(v, i, true) +
                     pm * F::template tap<REV, P_W>(v, i - 1, gm);
        newc = newc + pp * F::template tap<REV, P_E>(v, i + 1, gp);
        const float am = v.next ? v.at(2, i - 1, gm) : 0.0f;
        const float a0 = v.next ? v.at(2, i, true) : 0.0f;
        const float ap = v.next ? v.at(2, i + 1, gp) : 0.0f;
        float oldb = a0 * F::template tap<REV, N_S>(v, i, true) +
                     am * F::template tap<REV, N_W>(v, i - 1, gm);
        oldb = oldb + ap * F::template tap<REV, N_E>(v, i + 1, gp);
        base = (v.at(1, i, true) + newc) + oldb;
        ea = F::template tap<REV, G_E>(v, i - 1, gm);
        wa = F::template tap<REV, G_W>(v, i + 1, gp);
        eb = wb = base;
      }
      if (lim > 1) {
        const int xs = es - (t0 - HALO), xe = ee - (t0 - HALO);
        if (lim <= LOCAL) {  // one barrier; each thread walks its window
          if (active) {
            sea[tx] = ea;
            seb[tx] = eb;
            swa[tx] = wa;
            swb[tx] = wb;
          }
          sync_consumers(NT);
          if (active) {
            if (lim == 2) {
              local_scan<2>(sea, seb, tx, xs, -1, ea, eb);
              local_scan<2>(swa, swb, tx, xe, 1, wa, wb);
            } else if (lim == 4) {
              local_scan<4>(sea, seb, tx, xs, -1, ea, eb);
              local_scan<4>(swa, swb, tx, xe, 1, wa, wb);
            } else {
              local_scan<8>(sea, seb, tx, xs, -1, ea, eb);
              local_scan<8>(swa, swb, tx, xe, 1, wa, wb);
            }
          }
        } else {  // a barrier a doubling step
          int pp = 0;
          for (int d = 1; d < lim; d <<= 1) {
            if (active) {
              sea[pp * EXT + tx] = ea;
              seb[pp * EXT + tx] = eb;
              swa[pp * EXT + tx] = wa;
              swb[pp * EXT + tx] = wb;
            }
            sync_consumers(NT);
            if (active) {
              if (tx - d >= xs) {  // else the identity map (a = 1, b = 0)
                const float pa2 = sea[pp * EXT + tx - d];
                const float pb2 = seb[pp * EXT + tx - d];
                eb = ea * pb2 + eb;
                ea = ea * pa2;
              }
              if (tx + d < xe) {
                const float qa2 = swa[pp * EXT + tx + d];
                const float qb2 = swb[pp * EXT + tx + d];
                wb = wa * qb2 + wb;
                wa = wa * qa2;
              }
            }
            pp ^= 1;
          }
        }
      }
      if (i >= os && i < oe) {
        float nv;
        if (lim == 1) {
          nv = (base + ea * v.at(0, i - 1, gm)) + wa * v.at(0, i + 1, gp);
        } else {
          const int ce = max(lb - 1, i - lim), cw = min(ub, i + lim);
          const float ne = eb + ea * v.at(0, ce, ce >= 0);
          const float nw = wb + wa * v.at(0, cw, cw < w);
          nv = ((ne - base) + (nw - base)) + base;
        }
        if (own_prev) pnew[tx] = nv;
        if (i >= t0 && i < t1) acc_out[rb + i] = nv;
      }
      sync_consumers(NT);  // the stage is read; the row is out
      if (tx == 0) {
        bar_arrive(&empty[s]);
        // the neighbours take this row at their next exchange
        if (t == ntb - 1 && nblocks > 1 && ((k + 1) & (R - 1)) == 0)
          st_release(flags + b, k + 1);  // after every consumer's store
      }
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
  }
}

template <class F, int REV>
int launch_one(const float* acc_in, const float* wgt, typename F::Ptrs fp,
               float* acc_out, int h, int w, int lim, int* flags,
               int flags_len, cudaStream_t stream) {
  using S = Smem<F>;
  auto kern = flow_sweep_kernel<F, REV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, NT + 32, S::BYTES)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ntiles = (w + TILE - 1) / TILE;
  const int resident = per_sm * sms;
  const int tpb = (ntiles + resident - 1) / resident;
  const int nblocks = (ntiles + tpb - 1) / tpb;
  if (nblocks > flags_len) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaMemsetAsync(flags, 0, sizeof(int) * nblocks, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&acc_in, &wgt, &fp, &acc_out, &h, &w, &lim,
                  const_cast<int*>(&tpb), const_cast<int*>(&ntiles), &flags};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                    dim3(nblocks), dim3(NT + 32), args,
                                    S::BYTES, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flow

// Launch one sweep.  `flags`: flags_len ints of scratch on the stream's
// device, one a block (a block owns at least one tile of TILE > HALO
// columns, so ceil(w / HALO) always suffice), cleared here on `stream`.
template <class F>
int launch_flow_sweep(const float* acc_in, const float* wgt,
                      typename F::Ptrs fp, float* acc_out, int h, int w,
                      int reverse, int lim, int* flags, int flags_len,
                      void* stream) {
  if (lim < 1 || lim > flow::TILE || (lim & (lim - 1)) != 0 || h < 1 ||
      w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return reverse ? flow::launch_one<F, 1>(acc_in, wgt, fp, acc_out, h, w,
                                          lim, flags, flags_len, s)
                 : flow::launch_one<F, 0>(acc_in, wgt, fp, acc_out, h, w,
                                          lim, flags, flags_len, s);
}

}  // namespace rd
