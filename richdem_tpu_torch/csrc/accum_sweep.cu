// One directional Gauss-Seidel sweep of D8 flow accumulation, A = w + P^T A.
//
// Walking a row-major (H, W) raster down (reverse = 0), row r takes
//   new values of the row before, through codes 7 (S), 6 (SE, from the west
//     source) and 8 (SW, from the east source);
//   sweep-start values of the row after, through codes 3 (N), 4 (NE, west
//     source) and 2 (NW, east source);
//   sweep-start values of its own row, through codes 5 (E, from the west
//     neighbour) and 1 (W, from the east neighbour).
// Walking up (reverse = 1) swaps the two code trios.  The sum is grouped as
// in richdem_tpu/ops/accum.py:_gs_down_sweep, ((w + new) + old_row) + in_row,
// each trio summed straight, west, east.  Codes are int8; nodata (-1)
// matches no code, so it acts as NO_FLOW with zero weight.  Out of place:
// `acc_in` is never written.
//
// Replaces the TPU kernels richdem_tpu/ops/pallas_folded.py:_accum_kernel
// (line 329) and richdem_tpu/ops/pallas_sweeps.py:_accum_down_kernel
// (line 201).  Folding, padding, the precomputed +-1-row code rasters and
// the int32 code widening are TPU artefacts and are not carried over.
//
// What bounds it on an H100: like the fill sweep, the row-to-row dependency
// (H dependent row steps per sweep, one 1024-column tile per block).  A new
// value from across a tile edge is read from `acc_in` (sweep-start), which
// only delays convergence of the rotation-level fixpoint and keeps runs
// deterministic.  What the design does about it: the rows of `acc_in`,
// `wgt` and `fd` are staged in a shared-memory ring by a producer warp
// (row_ring.cuh).  The 256 consumer threads of a full tile whose rows start
// 16-byte aligned (MODE 2) each own 4 adjacent columns and keep the codes
// and sweep-start values of rows k and k + 1, and the new values of row
// k - 1, in registers: a row step loads row k + 1 (a float4 and a word of
// codes) and the weights, takes the neighbours' values from the adjacent
// lanes (shared memory at a warp's edge), sums, stores one float4 and
// meets the other consumers at one barrier.  Other full tiles (MODE 1) and
// a ragged last tile (MODE 0, the only one that tests its columns) own the
// columns tx, tx + 256, ... and read rows k - 1, k and k + 1 from the ring.
// Convergence is judged by the caller on whole rotations (per-sweep flags
// chatter in the last bit of float sums), so the kernel has no change flag.
//
// On a card the sweeps are the fallback: the same codes feed the
// topological pass of flow_topo.cuh (rd_accum_topo below), which solves
// codes without a cycle once, in order, instead of by rotations of this
// sweep (each turn of a donor chain costs a sweep another rotation).

#include <cstdint>
#include <cuda_runtime.h>

#include "flow_topo.cuh"
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
// one stage: a slot of `acc_in`, one of `wgt` and one of `fd`
constexpr int STAGE = 2 * SLOT * 4 + rd::slot_elems<int8_t>(TILE);
constexpr rd::Layout LAYOUT = rd::layout(STAGES, TILE, STAGE);
// rows k - 1, k and k + 1 are read at row k
static_assert(CPT == 4 && STAGES >= 3, "4 columns a consumer, 3+ stages");

__device__ __forceinline__ int code_of(uint32_t word, int c) {
  return static_cast<int>((word >> (8 * c)) & 0xffu);
}

template <int MODE>  // 0: a ragged tile; 1: full tiles; 2: aligned full
__global__ void __launch_bounds__(NT + 32)
accum_sweep_kernel(const float* __restrict__ acc_in,
                   const float* __restrict__ wgt,
                   const int8_t* __restrict__ fd,
                   float* __restrict__ acc_out, int h, int w, int reverse,
                   int tile0) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  float* prev = reinterpret_cast<float*>(smem + LAYOUT.prev);
  unsigned char* ring = smem + LAYOUT.ring;

  const int tx = threadIdx.x;  // NT consumers, then the producer warp
  const int cs = (tile0 + blockIdx.x) * TILE;  // the tile's first column
  const int ncols = min(TILE, w - cs);
  const bool has_l = cs > 0;
  const bool has_r = cs + ncols < w;
  const int first = has_l ? cs - 1 : cs;  // staged columns [first, last)
  const int last = has_r ? cs + ncols + 1 : cs + ncols;
  const int sh = has_l ? 1 : 0;
  // code trios (straight, from west source, from east source)
  const int ns = reverse ? 3 : 7, nw = reverse ? 4 : 6, ne = reverse ? 2 : 8;
  const int os = reverse ? 7 : 3, ow = reverse ? 6 : 4, oe = reverse ? 8 : 2;

  auto row_base = [&](int k) -> size_t {
    return static_cast<size_t>(reverse ? h - 1 - k : k) *
           static_cast<size_t>(w);
  };
  // staged rows, indexed by the column in the tile (-1 and ncols: the
  // halo columns)
  auto acc_row = [&](int s, size_t b) {
    return reinterpret_cast<const float*>(ring + s * STAGE) +
           rd::lead(acc_in, b + first) + sh;
  };
  auto wgt_row = [&](int s, size_t b) {
    return reinterpret_cast<const float*>(ring + s * STAGE) + SLOT +
           rd::lead(wgt, b + first) + sh;
  };
  auto fd_row = [&](int s, size_t b) {
    return reinterpret_cast<const int8_t*>(ring + s * STAGE + 2 * SLOT * 4) +
           rd::lead(fd, b + first) + sh;
  };

  if (tx == 0) {
    for (int s = 0; s < STAGES; ++s) {
      rd::bar_init(&full[s], 1);
      rd::bar_init(&empty[s], 1);
    }
    rd::bar_init_fence();
  }
  // the row before the first one is off-grid: no flow
  for (int i = tx; i < 2 * (TILE + 8); i += NT + 32) prev[i] = 0.0f;
  __syncthreads();

  if (tx >= NT) {  // the producer warp: one thread stages every row
    if (tx == NT) {
      int s = 0, phase = 0;
      for (int k = 0; k < h; ++k) {
        if (k >= STAGES) rd::bar_wait(&empty[s], phase ^ 1);
        const size_t b = row_base(k);
        const rd::Covering ca = rd::covering(acc_in, b + first, b + last);
        const rd::Covering cw = rd::covering(wgt, b + first, b + last);
        const rd::Covering cf = rd::covering(fd, b + first, b + last);
        unsigned char* stage = ring + s * STAGE;
        rd::bar_expect(&full[s], ca.bytes + cw.bytes + cf.bytes);
        rd::bulk_copy(stage, ca, &full[s]);
        rd::bulk_copy(stage + SLOT * 4, cw, &full[s]);
        rd::bulk_copy(stage + 2 * SLOT * 4, cf, &full[s]);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // slots of rows k - 1, k and k + 1, and the parity of row k + 1's use
  int sp = STAGES - 1, s0 = 0, sn = 1, pn = 0;
  rd::bar_wait(&full[0], 0);
  if constexpr (MODE == 2) {
    const int lane = tx & 31;
    const int i0 = 4 * tx;  // this consumer's columns i0 .. i0 + 3
    const bool has_w = i0 > 0 || has_l, has_e = i0 + 4 < TILE || has_r;
    // row "k + 1": sweep-start values and codes at i0 .. i0 + 3, and their
    // neighbours at i0 - 1 and i0 + 4
    float4 an;
    float anw, ane;
    uint32_t fn;
    int fnw, fne;
    auto load_next = [&](int s, size_t b) {
      const float* na = acc_row(s, b);
      const int8_t* nf = fd_row(s, b);
      an = *reinterpret_cast<const float4*>(na + i0);
      fn = *reinterpret_cast<const uint32_t*>(nf + i0);
      anw = __shfl_up_sync(0xffffffffu, an.w, 1);
      ane = __shfl_down_sync(0xffffffffu, an.x, 1);
      fnw = code_of(__shfl_up_sync(0xffffffffu, fn, 1), 3);
      fne = code_of(__shfl_down_sync(0xffffffffu, fn, 1), 0);
      if (lane == 0) {
        anw = has_w ? na[i0 - 1] : 0.0f;
        fnw = has_w ? static_cast<uint8_t>(nf[i0 - 1]) : 0;
      }
      if (lane == 31) {
        ane = has_e ? na[i0 + 4] : 0.0f;
        fne = has_e ? static_cast<uint8_t>(nf[i0 + 4]) : 0;
      }
    };
    load_next(0, row_base(0));
    float4 np = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // new, row k - 1
    uint32_t fp = 0;  // codes of row k - 1 (none before the first row)
    int fpw = 0, fpe = 0;
    // the row before's sweep-start values at i0 - 1 and i0 + 4: across the
    // tile's seams they stand for its new values there
    float seam_w = 0.0f, seam_e = 0.0f;
    for (int k = 0; k < h; ++k) {
      const size_t b = row_base(k);
      const bool has_next = k + 1 < h;
      const float4 ac = an;  // row k, sweep-start
      const float acw = anw, ace = ane;
      const uint32_t fc = fn;
      const int fcw = fnw, fce = fne;
      if (has_next) {
        rd::bar_wait(&full[sn], pn);
        load_next(sn, row_base(k + 1));
      } else {  // the row after the last one is off-grid: no flow
        an = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        anw = ane = 0.0f;
        fn = 0;
        fnw = fne = 0;
      }
      const float4 wt = *reinterpret_cast<const float4*>(wgt_row(s0, b) + i0);
      const float* pa = prev + 4 + ((k + 1) & 1) * (TILE + 8);  // pa[i]
      float* qa = prev + 4 + (k & 1) * (TILE + 8);
      float npw = __shfl_up_sync(0xffffffffu, np.w, 1);
      float npe = __shfl_down_sync(0xffffffffu, np.x, 1);
      if (lane == 0) npw = tx == 0 ? seam_w : pa[i0 - 1];
      if (lane == 31) npe = tx == NT - 1 ? seam_e : pa[i0 + 4];
      // columns i0 - 1 .. i0 + 4 of the rows before, at and after row k
      const float pav[6] = {npw, np.x, np.y, np.z, np.w, npe};
      const int pfv[6] = {fpw, code_of(fp, 0), code_of(fp, 1),
                          code_of(fp, 2), code_of(fp, 3), fpe};
      const float lav[6] = {acw, ac.x, ac.y, ac.z, ac.w, ace};
      const int lfv[6] = {fcw, code_of(fc, 0), code_of(fc, 1),
                          code_of(fc, 2), code_of(fc, 3), fce};
      const float nav[6] = {anw, an.x, an.y, an.z, an.w, ane};
      const int nfv[6] = {fnw, code_of(fn, 0), code_of(fn, 1),
                          code_of(fn, 2), code_of(fn, 3), fne};
      const float wv[4] = {wt.x, wt.y, wt.z, wt.w};
      float nv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int x = c + 1;
        float newc = (pfv[x] == ns ? pav[x] : 0.0f) +
                     (pfv[x - 1] == nw ? pav[x - 1] : 0.0f);
        newc = newc + (pfv[x + 1] == ne ? pav[x + 1] : 0.0f);
        float oldb = (nfv[x] == os ? nav[x] : 0.0f) +
                     (nfv[x - 1] == ow ? nav[x - 1] : 0.0f);
        oldb = oldb + (nfv[x + 1] == oe ? nav[x + 1] : 0.0f);
        const float oldl = (lfv[x - 1] == 5 ? lav[x - 1] : 0.0f) +
                           (lfv[x + 1] == 1 ? lav[x + 1] : 0.0f);
        nv[c] = ((wv[c] + newc) + oldb) + oldl;
      }
      np = make_float4(nv[0], nv[1], nv[2], nv[3]);
      *reinterpret_cast<float4*>(acc_out + b + cs + i0) = np;
      if (lane == 0) qa[i0] = nv[0];      // for the warp before
      if (lane == 31) qa[i0 + 3] = nv[3];  // for the warp after
      seam_w = acw;
      seam_e = ace;
      fp = fc;
      fpw = fcw;
      fpe = fce;
      rd::sync_consumers(NT);  // row k's edge values are in qa
      if (k > 0 && tx == 0) rd::bar_arrive(&empty[sp]);  // row k - 1 read
      sp = s0;
      s0 = sn;
      if (++sn == STAGES) {
        sn = 0;
        pn ^= 1;
      }
    }
  } else {
    // west and east neighbours of each of the thread's columns exist
    bool wv[CPT], ev[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int i = tx + j * NT;
      wv[j] = i > 0 || has_l;
      ev[j] = i < ncols - 1 || has_r;
    }
    for (int k = 0; k < h; ++k) {
      const size_t b = row_base(k);
      const bool has_prev = k > 0, has_next = k + 1 < h;
      if (has_next) rd::bar_wait(&full[sn], pn);
      const float* la = acc_row(s0, b);
      const float* lw = wgt_row(s0, b);
      const int8_t* lf = fd_row(s0, b);
      const int8_t* pf = fd_row(sp, has_prev ? row_base(k - 1) : b);
      const size_t bn = has_next ? row_base(k + 1) : b;
      const float* na = acc_row(sn, bn);
      const int8_t* nf = fd_row(sn, bn);
      const float* pa = prev + ((k + 1) & 1) * (TILE + 2);  // pa[i + 1]
      float* qa = prev + (k & 1) * (TILE + 2);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int i = tx + j * NT;
        if (MODE == 1 || i < ncols) {
          // codes of the rows before and after read as NO_FLOW off the
          // grid: no branch, so the loads of all columns interleave
          const int pc = has_prev ? pf[i] : 0;
          const int pw = has_prev && wv[j] ? pf[i - 1] : 0;
          const int pe = has_prev && ev[j] ? pf[i + 1] : 0;
          float newc = (pc == ns ? pa[i + 1] : 0.0f) +
                       (pw == nw ? pa[i] : 0.0f);
          newc = newc + (pe == ne ? pa[i + 2] : 0.0f);
          const int nc = has_next ? nf[i] : 0;
          const int nwc = has_next && wv[j] ? nf[i - 1] : 0;
          const int nec = has_next && ev[j] ? nf[i + 1] : 0;
          float oldb = (nc == os ? na[i] : 0.0f) +
                       (nwc == ow ? na[i - 1] : 0.0f);
          oldb = oldb + (nec == oe ? na[i + 1] : 0.0f);
          const int fw = wv[j] ? lf[i - 1] : 0, fe = ev[j] ? lf[i + 1] : 0;
          const float oldl = (fw == 5 ? la[i - 1] : 0.0f) +
                             (fe == 1 ? la[i + 1] : 0.0f);
          const float nv = ((lw[i] + newc) + oldb) + oldl;
          acc_out[b + cs + i] = nv;
          qa[i + 1] = nv;
        }
      }
      if (tx == 0) {  // seams: sweep-start values of this row
        qa[0] = has_l ? la[-1] : 0.0f;
        qa[ncols + 1] = has_r ? la[ncols] : 0.0f;
      }
      rd::sync_consumers(NT);  // row k's new values are in qa
      if (has_prev && tx == 0) rd::bar_arrive(&empty[sp]);  // row k - 1 read
      sp = s0;
      s0 = sn;
      if (++sn == STAGES) {
        sn = 0;
        pn ^= 1;
      }
    }
  }
}

template <int MODE>
int launch(const float* acc_in, const float* wgt, const int8_t* fd,
           float* acc_out, int h, int w, int reverse, int tile0, int tiles,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      accum_sweep_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      LAYOUT.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  accum_sweep_kernel<MODE><<<tiles, NT + 32, LAYOUT.bytes, stream>>>(
      acc_in, wgt, fd, acc_out, h, w, reverse, tile0);
  return static_cast<int>(cudaGetLastError());
}

// The D8 codes as a field of the topological pass (flow_topo.cuh): cell i
// sends everything to the neighbour its code names (1..8); a code <= 0
// (NO_FLOW, nodata) sends nothing, nor does one pointing off the grid (the
// pass tests that).  Every share is 1 (UNIT), so no in-share plane is laid
// out.  The name holds this file's kernel's, by which a trace claims the
// layer's time (the pass's count and solve kernels are templated on it).
struct accum_sweep_kernel_d8 {
  struct Ptrs {
    const int8_t* codes;
  };
  static constexpr bool UNIT = true;
  static __device__ float share(const Ptrs& p, int d, int i) {
    return __ldg(p.codes + i) == d ? 1.0f : 0.0f;
  }
};

}  // namespace

// One launch over the full tiles, one over a ragged last tile.
extern "C" int rd_accum_sweep(const float* acc_in, const float* wgt,
                              const int8_t* fd, float* acc_out, int h, int w,
                              int reverse, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int full_tiles = w / TILE;
  if (full_tiles > 0) {
    // rows of codes start 16-byte aligned only where w is a multiple of 16
    const int rc =
        rd::rows_aligned(w, 1, {acc_in, wgt, fd, acc_out})
            ? launch<2>(acc_in, wgt, fd, acc_out, h, w, reverse, 0,
                        full_tiles, st)
            : launch<1>(acc_in, wgt, fd, acc_out, h, w, reverse, 0,
                        full_tiles, st);
    if (rc != 0) return rc;
  }
  if (w % TILE == 0) return 0;
  return launch<0>(acc_in, wgt, fd, acc_out, h, w, reverse, full_tiles, 1,
                   st);
}

// The topological pass over the codes (flow_topo.cuh): `acc` written where
// a cell is solved, the count of cells solved to a number in ctl[64].
extern "C" int rd_accum_topo(const int8_t* fd, const float* wgt, float* acc,
                             int* deps, unsigned long long* order, int* ctl,
                             int h, int w, void* stream) {
  return rd::launch_flow_topo<accum_sweep_kernel_d8>(
      accum_sweep_kernel_d8::Ptrs{fd}, wgt, acc, deps, nullptr, order, ctl,
      h, w, stream);
}
