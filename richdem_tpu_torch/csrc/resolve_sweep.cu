// One directional sweep of the successor resolve V(c) <- V(successor(c)):
// each unpinned cell takes the value of the cell its D8 code points to, a
// pinned cell keeps its own.  Watershed labels (V = the terminal's flat
// index) and upslope masks (V = 1 below a seed) are its fixpoints.
//
// The code byte carries the pin in its sign bit: b = code | 0x80 for a
// pinned cell, code in 0..8 otherwise (ops/successor.py:pack_codes), so a
// sweep reads one byte per cell for both.  The successor's value is read
// where the sweep has it: new values in the row before (codes 2, 3, 4
// walking down, 8, 7, 6 walking up), sweep-start values in the row after
// and in the cell's own row (codes 1 and 5), exactly as
// richdem_tpu/ops/pallas_folded.py:_resolve_kernel (lines 615-646) reads
// them within a strip; off-grid successors read -1.
//
// Replaces the TPU kernel richdem_tpu/ops/pallas_folded.py:_resolve_kernel
// (line 606).  Folding, strip heights, the separate int32 pin raster and
// the int32 code widening are TPU artefacts and are not carried over.
//
// Seams.  A block owns a run of TILE-column tiles and walks all H rows;
// row r of a tile reads the new values of row r - 1 one column past its
// edges, so the tiles trade edge values and one sweep is the sweep over
// whole rows, whatever TILE (bitwise).  This is csrc/flow_sweep.cuh's
// exchange at a window of one column, with its flags (wait_flag,
// st_release): a block publishes that it finished row r by a release
// store of r + 1 to its flag, after its new values are in `v_out`; at an
// exchange row its thread 0 waits (acquire, __nanosleep backoff, a trap
// after 10 s rather than a hang) until both neighbours' flags reach the
// row, and a barrier releases the other threads, which read the
// neighbours' new values from `v_out` through L2.  A block that owns one
// tile exchanges every HALO rows: at an exchange row it takes HALO
// columns of new values past each edge, computes its row HALO - 1 columns
// past the edges, then one column fewer a row, keeping them in shared
// memory (ghost columns, computed by both neighbours from the same values:
// bitwise equal).  All blocks must be resident: the launch is cooperative
// (cudaLaunchCooperativeKernel refuses a grid that cannot be, and the
// wrapper raises); where a grid has more tiles than resident blocks, a
// block owns a run of adjacent tiles and exchanges every row.
//
// What bounds it on an H100: the row-to-row dependency.  Per cell a sweep
// reads a value and a code byte and writes a value, 9 bytes; a cell's
// rule is one decode and one select, so a row step is the latency of its
// shared-memory reads, its select and one barrier.  What the design does
// about it: narrow tiles (TILE = 128 columns, HALO = 64: _build.RESOLVE_
// TILE, RESOLVE_HALO), so a 10240-column row spreads over 80 SMs, one
// consumer thread a column of the tile and its halo, and a producer warp
// that stages the rows a row step reads (values of rows r and r + 1, codes
// of row r, each over the tile and HALO columns either side) in a
// shared-memory ring by bulk asynchronous copies (row_ring.cuh), up to 16
// items ahead.  No change flag: the caller compares whole rotations
// (int32 values, so equality is exact).

#include "flow_sweep.cuh"

#ifndef RD_RESOLVE_TILE
#define RD_RESOLVE_TILE 128
#endif
#ifndef RD_RESOLVE_HALO
#define RD_RESOLVE_HALO 64
#endif

namespace {

constexpr int TILE = RD_RESOLVE_TILE;
constexpr int HALO = RD_RESOLVE_HALO;
constexpr int EXT = TILE + 2 * HALO;  // a tile and HALO columns either side
constexpr int NT = EXT;               // consumers; a producer warp besides
constexpr int32_t OFF = -1;           // what an off-grid successor reads
constexpr int VSLOT = EXT + 8;   // int32: the covering span fits
constexpr int CSLOT = EXT + 32;  // bytes of a code row's covering span
constexpr int STAGE = 2 * VSLOT * 4 + CSLOT;  // values r, r + 1; codes r
constexpr int MAX_STAGES = 16;
constexpr int PRV = 16 * 2 * MAX_STAGES;  // after the full/empty barriers
constexpr int RING = PRV + 2 * EXT * 4;   // after the new values of 2 rows
constexpr int FIT = (rd::flow::BUDGET - RING) / STAGE;
constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
constexpr int BYTES = RING + STAGES * STAGE;
static_assert(TILE % 32 == 0 && HALO % 32 == 0 && TILE > HALO &&
                  (HALO & (HALO - 1)) == 0 && EXT + 32 <= 1024,
              "tiles wider than the exchange, both whole warps, a power-of-"
              "two halo, and a thread a column within a block's 1024");
static_assert(STAGE % 16 == 0 && STAGES >= 2, "aligned stages, 2 or more");

template <int REV>
__global__ void __launch_bounds__(NT + 32)
resolve_sweep_kernel(const int32_t* __restrict__ v_in,
                     const int8_t* __restrict__ code, int32_t* v_out, int h,
                     int w, int tpb, int ntiles, int* flags) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  int32_t* prv = reinterpret_cast<int32_t*>(smem + PRV);  // [2][EXT]
  unsigned char* ring = smem + RING;

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
    rd::bar_init_fence();
  }
  __syncthreads();

  if (tx >= NT) {  // the producer warp: lane q stages slot q of each item
    const int lane = tx - NT;
    int s = 0, phase = 0, n = 0;
    for (int k = 0; k < h; ++k) {
      for (int t = 0; t < ntb; ++t, ++n) {
        if (n >= STAGES) rd::bar_wait(&empty[s], phase ^ 1);
        const int t0 = (tile0 + t) * TILE, t1 = min(t0 + TILE, w);
        const int cs = max(0, t0 - HALO), ce = min(w, t1 + HALO);
        rd::Covering cv{nullptr, 0};
        if (lane == 0) {
          cv = rd::covering(v_in, row_base(k) + cs, row_base(k) + ce);
        } else if (lane == 1 && k + 1 < h) {
          cv = rd::covering(v_in, row_base(k + 1) + cs, row_base(k + 1) + ce);
        } else if (lane == 2) {
          cv = rd::covering(code, row_base(k) + cs, row_base(k) + ce);
        }
        uint32_t total = cv.bytes;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          total += __shfl_xor_sync(0xffffffffu, total, o);
        if (lane == 0) rd::bar_expect(&full[s], total);
        __syncwarp();
        if (cv.bytes)
          rd::bulk_copy(ring + s * STAGE + lane * VSLOT * 4, cv, &full[s]);
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
  int s = 0, phase = 0;
  for (int k = 0; k < h; ++k) {
    const size_t rb = row_base(k);
    const bool next = k + 1 < h;
    const size_t rn = next ? row_base(k + 1) : rb;
    const bool exchange = (k & (R - 1)) == 0;
    const int32_t* pn = k > 0 ? v_out + row_base(k - 1) : v_out;
    int32_t* pprev = prv + ((k + 1) & 1) * EXT;  // column c at c - t0 + HALO
    int32_t* pnew = prv + (k & 1) * EXT;
    if (exchange && nblocks > 1 && k > 0) {
      if (tx == 0) {
        if (b > 0) rd::flow::wait_flag(flags + b - 1, k);
        if (b + 1 < nblocks) rd::flow::wait_flag(flags + b + 1, k);
      }
      rd::sync_consumers(NT);
    }
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
      // several tiles, its own) from v_out, OFF off the grid
      if (exchange && k > 0 && (nblocks > 1 || !own_prev)) {
        if (i >= os - 1 && i <= oe && (!own_prev || i < t0 || i >= t1))
          pprev[tx] = (i >= 0 && i < w) ? __ldcg(pn + i) : OFF;
        rd::sync_consumers(NT);
      }
      rd::bar_wait(&full[s], phase);
      if (active) {
        const unsigned char* st = ring + s * STAGE;
        // the staged rows, indexed by column
        const int32_t* v0 = reinterpret_cast<const int32_t*>(st) +
                            rd::lead(v_in, rb + cs) - cs;
        const int32_t* v1 = reinterpret_cast<const int32_t*>(st) + VSLOT +
                            rd::lead(v_in, rn + cs) - cs;
        const int8_t* cd = reinterpret_cast<const int8_t*>(st) +
                           2 * VSLOT * 4 + rd::lead(code, rb + cs) - cs;
        const int byte = cd[i];
        auto own = [&](int dx) {
          const int c = i + dx;
          return c >= 0 && c < w ? v0[c] : OFF;
        };
        // the row before in sweep order: new values
        auto before = [&](int dx) {
          const int c = i + dx;
          return c >= 0 && c < w ? pprev[tx + dx] : OFF;
        };
        // the row after: sweep-start values
        auto after = [&](int dx) {
          const int c = i + dx;
          return next && c >= 0 && c < w ? v1[c] : OFF;
        };
        int32_t nv = v0[i];
        if (byte >= 0) {  // not pinned
          // dy = -1 is the row before when walking down, the row after
          // when walking up
          switch (byte & 15) {
            case 1: nv = own(-1); break;                       // W
            case 2: nv = REV ? after(-1) : before(-1); break;  // NW
            case 3: nv = REV ? after(0) : before(0); break;    // N
            case 4: nv = REV ? after(1) : before(1); break;    // NE
            case 5: nv = own(1); break;                        // E
            case 6: nv = REV ? before(1) : after(1); break;    // SE
            case 7: nv = REV ? before(0) : after(0); break;    // S
            case 8: nv = REV ? before(-1) : after(-1); break;  // SW
            default: break;                                    // NO_FLOW
          }
        }
        if (own_prev) pnew[tx] = nv;
        if (i >= t0 && i < t1) v_out[rb + i] = nv;
      }
      rd::sync_consumers(NT);  // the stage is read; the row is out
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
    }
  }
}

template <int REV>
int launch(const int32_t* v_in, const int8_t* code, int32_t* v_out, int h,
           int w, int* flags, int flags_len, cudaStream_t stream) {
  auto kern = resolve_sweep_kernel<REV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, NT + 32, BYTES)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ntiles = (w + TILE - 1) / TILE;
  const int resident = per_sm * sms;
  const int tpb = (ntiles + resident - 1) / resident;
  const int nblocks = (ntiles + tpb - 1) / tpb;
  if (nblocks > flags_len) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaMemsetAsync(flags, 0, sizeof(int) * nblocks, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&v_in, &code, &v_out, &h, &w, const_cast<int*>(&tpb),
                  const_cast<int*>(&ntiles), &flags};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                    dim3(nblocks), dim3(NT + 32), args,
                                    BYTES, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The walk's shape into out[0..3]: tile columns, halo columns, consumer
// threads a block, ring stages.
extern "C" int rd_resolve_shape(int* out) {
  out[0] = TILE;
  out[1] = HALO;
  out[2] = NT;
  out[3] = STAGES;
  return 0;
}

// `flags`: flags_len ints of scratch on the stream's device, one a block
// (ceil(w / TILE) always suffice), cleared here on `stream`; too few
// return cudaErrorInvalidValue.
extern "C" int rd_resolve_sweep(const int32_t* v_in, const int8_t* code,
                                int32_t* v_out, int h, int w, int reverse,
                                int* flags, int flags_len, void* stream) {
  if (h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return reverse ? launch<1>(v_in, code, v_out, h, w, flags, flags_len, s)
                 : launch<0>(v_in, code, v_out, h, w, flags, flags_len, s);
}
