// The seam-exact narrow-tile walk of the successor-style sweeps
// (resolve_sweep.cu, strahler_sweep.cu, dist_sweep.cu): one directional
// Gauss-Seidel sweep of a row-major (H, W) raster, down (REV = 0) or up
// (REV = 1), in which row r reads the new values of the row before (in
// sweep order) at columns c - 1 .. c + 1 and anything else only at
// sweep-start values or from rasters that the sweep does not change.  The
// rule of one cell is the op's (a template parameter); everything else
// lives here.
//
// The op supplies (see the ops in the three sources):
//   T, OFF           the value type, and what a value off the grid reads;
//   TILE, HALO       the tile's columns and the exchange's halo;
//   NSLOT, elem(q), row(q), raster(a, q)
//                    the row segments a stage holds: slot q holds the
//                    elem(q)-byte elements of raster(a, q) on row
//                    k + row(q) (sweep order, row(q) in -1..1) over the
//                    tile and HALO columns either side; a row off the grid
//                    is not staged;
//   update<REV>(a, view, i, w, before)
//                    the new value of column i of the row, from the staged
//                    slots (view.at<E>(q, c); view.prev / view.next say
//                    whether rows r - 1 and r + 1 exist; a column or row
//                    off the grid reads stage bytes that the op must
//                    ignore) and the new values of the row before
//                    (before(dx) at column i + dx, OFF off the grid);
//   FLAG, changed(a), OWN
//                    whether the sweep ORs 1 into *changed(a) when any
//                    value of the raster changed (one atomicOr a block),
//                    comparing with slot OWN, the values' own row.
//
// Seams.  A block owns a run of TILE-column tiles and walks all H rows;
// row r of a tile reads the new values of row r - 1 one column past its
// edges, so the tiles trade edge values and one sweep is the sweep over
// whole rows, whatever TILE (bitwise).  This is flow_sweep.cuh's exchange
// at a window of one column, with its flags (wait_flag, st_release): a
// block publishes that it finished row r by a release store of r + 1 to
// its flag, after its new values are in `out`; at an exchange row its
// thread 0 waits (acquire, __nanosleep backoff, a trap after 10 s rather
// than a hang) until both neighbours' flags reach the row, and a barrier
// releases the other threads, which read the neighbours' new values from
// `out` through L2.  A block that owns one tile exchanges every HALO rows:
// at an exchange row it takes HALO columns of new values past each edge,
// computes its row HALO - 1 columns past the edges, then one column fewer
// a row, keeping them in shared memory (ghost columns, computed by both
// neighbours from the same values: bitwise equal, since everything else a
// cell reads is staged over the ghost band too).  All blocks must be
// resident: the launch is cooperative (cudaLaunchCooperativeKernel refuses
// a grid that cannot be, and the launch returns its error); where a grid
// has more tiles than resident blocks, a block owns a run of adjacent
// tiles and exchanges every row.
//
// What bounds it on an H100: the row-to-row dependency.  A row step is the
// latency of its shared-memory reads, the cell rule and one barrier.  What
// the walk does about it: narrow tiles, so a 10240-column row spreads over
// 80 SMs at TILE = 128, one consumer thread a column of the tile and its
// halo, and a producer warp (lane q stages slot q) that stages the rows a
// row step reads in a shared-memory ring by bulk asynchronous copies
// (row_ring.cuh), up to 16 items ahead; a cell's neighbours are read from
// shared memory, never from device memory, except at an exchange row.  On
// an H100 at 10240 columns (tools/torch_profile.py walk_tiles, profiling
// build) the rule and the loop's own instructions take about two thirds
// of a row step and the exchange about a third; the copies cost nothing
// that a row step waits for.

#pragma once

#include <utility>

#include "flow_sweep.cuh"

namespace rd {
namespace walk {

constexpr int MAX_STAGES = 16;

#ifdef RD_WALK_PROFILE
// A profiling build: the cycles of each block's consumer of the tile's
// first column by part of a row step, summed over the last sweep: the wait
// for the neighbours' flags, the exchange's reads, the wait for the stage,
// the rule and stores, the closing barrier, the rest of the loop.
constexpr int PROFILE_PARTS = 6;
constexpr int PROFILE_BLOCKS = 1024;  // the first blocks of the grid
__device__ unsigned long long profile_cycles[PROFILE_BLOCKS][PROFILE_PARTS];
#endif

// Bytes of a slot of `elem`-byte elements over `ext` columns: the aligned
// span that covers them (up to 15 bytes either side) fits.
__host__ __device__ constexpr int slot_bytes(int ext, int elem) {
  return ext * elem + 32;
}

// The first byte of slot q in a stage of an op's slots over `ext` columns.
template <class Op>
__host__ __device__ constexpr int slot_offset(int ext, int q) {
  int o = 0;
  for (int j = 0; j < q; ++j) o += slot_bytes(ext, Op::elem(j));
  return o;
}

// The walk's shape and shared-memory layout for an op.
template <class Op>
struct Shape {
  using T = typename Op::T;
  static constexpr int TILE = Op::TILE;
  static constexpr int HALO = Op::HALO;
  static constexpr int EXT = TILE + 2 * HALO;  // a tile, HALO either side
  static constexpr int NT = EXT;  // consumers; a producer warp besides
  static constexpr int STAGE =
      (slot_offset<Op>(EXT, Op::NSLOT) + 15) / 16 * 16;
  // the full and empty barriers, then the change flag
  static constexpr int ANY = 16 * MAX_STAGES;
  static constexpr int PRV = 16 * 2 * MAX_STAGES;  // new values of 2 rows
  static constexpr int RING =
      PRV + (2 * EXT * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  static constexpr int FIT = (rd::flow::BUDGET - RING) / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int BYTES = RING + STAGES * STAGE;
  static_assert(TILE % 32 == 0 && HALO % 32 == 0 && TILE > HALO &&
                    (HALO & (HALO - 1)) == 0 && EXT + 32 <= 1024,
                "tiles wider than the exchange, both whole warps, a power-"
                "of-two halo, and a thread a column within a block's 1024");
  static_assert(Op::NSLOT >= 1 && Op::NSLOT <= 32,
                "a producer lane a slot");
  static_assert(STAGES >= 2, "2 stages or more");
};

// f(std::integral_constant<int, q>) for each slot q, q a constant in f.
template <class F, int... Q>
__device__ __forceinline__ void for_slots(F&& f,
                                          std::integer_sequence<int, Q...>) {
  (f(std::integral_constant<int, Q>{}), ...);
}

// One staged item as a consumer reads it: element c of slot q.
template <int NSLOT>
struct View {
  const unsigned char* col[NSLOT];  // column 0 of each slot
  bool prev, next;                  // rows r - 1 and r + 1 exist
  template <typename E>
  __device__ __forceinline__ E at(int q, int c) const {
    return reinterpret_cast<const E*>(col[q])[c];
  }
};

template <class Op, int REV>
__global__ void __launch_bounds__(Shape<Op>::NT + 32)
seam_walk_kernel(const typename Op::Args a, typename Op::T* out, int h,
                 int w, int tpb, int ntiles, int* flags) {
  using S = Shape<Op>;
  using T = typename Op::T;
  constexpr int TILE = S::TILE, HALO = S::HALO, EXT = S::EXT, NT = S::NT;
  constexpr int STAGES = S::STAGES, STAGE = S::STAGE;
  constexpr T OFF = Op::OFF;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  int* any_sh = reinterpret_cast<int*>(smem + S::ANY);
  T* prv = reinterpret_cast<T*>(smem + S::PRV);  // [2][EXT]
  unsigned char* ring = smem + S::RING;

  const int tx = threadIdx.x;
  const int b = blockIdx.x, nblocks = gridDim.x;
  const int tile0 = b * tpb;
  const int ntb = min(tpb, ntiles - tile0);  // tiles of this block
  auto row_base = [&](int k) -> size_t {
    return static_cast<size_t>(REV ? h - 1 - k : k) * static_cast<size_t>(w);
  };

  if (tx == 0) {
    for (int s = 0; s < STAGES; ++s) {
      rd::bar_init(&full[s], 1);
      rd::bar_init(&empty[s], 1);
    }
    *any_sh = 0;
    rd::bar_init_fence();
  }
  __syncthreads();

  if (tx >= NT) {  // the producer warp: lane q stages slot q of each item
    const int q = tx - NT;
    const bool mine = q < Op::NSLOT;
    const unsigned char* base = static_cast<const unsigned char*>(
        mine ? Op::raster(a, q) : nullptr);
    const int e = mine ? Op::elem(q) : 0;
    const int dr = mine ? Op::row(q) : 0;
    const int soff = mine ? slot_offset<Op>(EXT, q) : 0;
    int s = 0, phase = 0, n = 0;
    for (int k = 0; k < h; ++k) {
      const int kk = k + dr;
      const bool staged = mine && kk >= 0 && kk < h;
      const size_t rb = staged ? row_base(kk) : 0;
      for (int t = 0; t < ntb; ++t, ++n) {
        if (n >= STAGES) rd::bar_wait(&empty[s], phase ^ 1);
        const int t0 = (tile0 + t) * TILE, t1 = min(t0 + TILE, w);
        const int cs = max(0, t0 - HALO), ce = min(w, t1 + HALO);
        rd::Covering cv{nullptr, 0};
        if (staged) cv = rd::covering(base, (rb + cs) * e, (rb + ce) * e);
        uint32_t total = cv.bytes;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          total += __shfl_xor_sync(0xffffffffu, total, o);
        if (q == 0) rd::bar_expect(&full[s], total);
        __syncwarp();
        if (cv.bytes) rd::bulk_copy(ring + s * STAGE + soff, cv, &full[s]);
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
  // later rows still need, so it takes its neighbours' edges only every R
  // rows.  R is the same in every block.
  const bool own_prev = tpb == 1;
  const int R = own_prev ? HALO : 1;  // a power of 2
  for (int i = tx; i < 2 * EXT; i += NT) prv[i] = OFF;  // off the grid
  bool any = false;
  int s = 0, phase = 0;
#ifdef RD_WALK_PROFILE
  const bool timed = tx == HALO && b < PROFILE_BLOCKS;
  unsigned long long cycles[PROFILE_PARTS] = {}, tick = clock64();
  auto lap = [&](int part) {
    const unsigned long long now = clock64();
    cycles[part] += now - tick;
    tick = now;
  };
#else
  const bool timed = false;
  auto lap = [](int) {};
#endif
  for (int k = 0; k < h; ++k) {
    const size_t rb = row_base(k);
    const bool exchange = (k & (R - 1)) == 0;
    const T* pn = k > 0 ? out + row_base(k - 1) : out;
    T* pprev = prv + ((k + 1) & 1) * EXT;  // column c at c - t0 + HALO
    T* pnew = prv + (k & 1) * EXT;
    if (exchange && nblocks > 1 && k > 0) {
      if (tx == 0) {
        if (b > 0) rd::flow::wait_flag(flags + b - 1, k);
        if (b + 1 < nblocks) rd::flow::wait_flag(flags + b + 1, k);
      }
      rd::sync_consumers(NT);
    }
    if (timed) lap(0);
    for (int t = 0; t < ntb; ++t) {
      const int t0 = (tile0 + t) * TILE, t1 = min(t0 + TILE, w);
      const int cs = max(0, t0 - HALO);
      const int i = t0 - HALO + tx;  // this thread's column
      // the columns this row computes new values of: [os, oe)
      const int ext = R - 1 - (k & (R - 1));
      const int os = max(0, t0 - ext), oe = min(w, t1 + ext);
      const bool active = i >= os && i < oe;
      // at an exchange row, the new values of the row before that no row
      // of this block computed: the neighbours' (and, where a block owns
      // several tiles, its own) from `out`, OFF off the grid
      if (exchange && k > 0 && (nblocks > 1 || !own_prev)) {
        if (i >= os - 1 && i <= oe && (!own_prev || i < t0 || i >= t1))
          pprev[tx] = (i >= 0 && i < w) ? __ldcg(pn + i) : OFF;
        rd::sync_consumers(NT);
      }
      if (timed) lap(1);
      rd::bar_wait(&full[s], phase);
      if (timed) lap(2);
      if (active) {
        const unsigned char* st = ring + s * STAGE;
        View<Op::NSLOT> v;
        v.prev = k > 0;
        v.next = k + 1 < h;
        // each slot's offset is a compile-time constant: computed at run
        // time, it cost the resolve's row step 11 % on an H100
        for_slots(
            [&](auto slot) {
              constexpr int q = decltype(slot)::value;
              constexpr int e = Op::elem(q);
              constexpr int off = slot_offset<Op>(S::EXT, q);
              const int kk = k + Op::row(q);
              const size_t first = (kk >= 0 && kk < h ? row_base(kk) : 0) +
                                   static_cast<size_t>(cs);
              const unsigned char* base =
                  static_cast<const unsigned char*>(Op::raster(a, q));
              v.col[q] = st + off + rd::lead(base, first * e) -
                         static_cast<ptrdiff_t>(cs) * e;
            },
            std::make_integer_sequence<int, Op::NSLOT>{});
        // the row before in sweep order: new values
        auto before = [&](int dx) -> T {
          const int c = i + dx;
          return c >= 0 && c < w ? pprev[tx + dx] : OFF;
        };
        const T nv = Op::template update<REV>(a, v, i, w, before);
        if (own_prev) pnew[tx] = nv;
        if (i >= t0 && i < t1) {
          out[rb + i] = nv;
          if constexpr (Op::FLAG)
            any |= nv != v.template at<T>(Op::OWN, i);
        }
      }
      if (timed) lap(3);
      rd::sync_consumers(NT);  // the stage is read; the row is out
      if (timed) lap(4);
      if (tx == 0) {
        rd::bar_arrive(&empty[s]);
        // the neighbours take this row at their next exchange
        if (t == ntb - 1 && nblocks > 1 && ((k + 1) & (R - 1)) == 0)
          rd::flow::st_release(flags + b, k + 1);
      }
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
      if (timed) lap(5);
    }
  }
  if constexpr (Op::FLAG) {
    if (any) *any_sh = 1;
    rd::sync_consumers(NT);
    if (tx == 0 && *any_sh) atomicOr(Op::changed(a), 1);
  }
#ifdef RD_WALK_PROFILE
  if (timed)
    for (int p = 0; p < PROFILE_PARTS; ++p) profile_cycles[b][p] = cycles[p];
#endif
}

template <class Op, int REV>
int launch_dir(const typename Op::Args& a, typename Op::T* out, int h,
               int w, int* flags, int flags_len, cudaStream_t stream) {
  using S = Shape<Op>;
  auto kern = seam_walk_kernel<Op, REV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, S::NT + 32, S::BYTES)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int ntiles = (w + S::TILE - 1) / S::TILE;
  const int resident = per_sm * sms;
  int tpb = (ntiles + resident - 1) / resident;
  const int nblocks = (ntiles + tpb - 1) / tpb;
  if (nblocks > flags_len) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaMemsetAsync(flags, 0, sizeof(int) * nblocks, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  typename Op::Args args_copy = a;
  void* args[] = {&args_copy, &out, &h, &w, &tpb, &ntiles, &flags};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                    dim3(nblocks), dim3(S::NT + 32), args,
                                    S::BYTES, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One sweep, down or up (`reverse`).  `flags`: flags_len ints of scratch
// on the stream's device, one a block (ceil(w / TILE) always suffice),
// cleared here on `stream`; too few return cudaErrorInvalidValue.
template <class Op>
int launch(const typename Op::Args& a, typename Op::T* out, int h, int w,
           int reverse, int* flags, int flags_len, void* stream) {
  if (h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return reverse ? launch_dir<Op, 1>(a, out, h, w, flags, flags_len, s)
                 : launch_dir<Op, 0>(a, out, h, w, flags, flags_len, s);
}

// The walk's shape into out[0..3]: tile columns, halo columns, consumer
// threads a block, ring stages.
template <class Op>
int shape(int* out) {
  out[0] = Shape<Op>::TILE;
  out[1] = Shape<Op>::HALO;
  out[2] = Shape<Op>::NT;
  out[3] = Shape<Op>::STAGES;
  return 0;
}

}  // namespace walk
}  // namespace rd

#ifdef RD_WALK_PROFILE
// The profiling build's cycles of the last sweep into
// out[PROFILE_BLOCKS][PROFILE_PARTS] (blocks past the grid's: stale).
extern "C" int rd_walk_profile(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, rd::walk::profile_cycles, sizeof(rd::walk::profile_cycles)));
}
#endif
