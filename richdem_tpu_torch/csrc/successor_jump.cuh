// Watershed labels and upslope masks by pointer jumping: the fixpoint of
// the successor resolve V(c) <- V(successor(c)) (resolve_sweep.cu), reached
// without sweeps.  Each cell takes the value of the first pinned cell on
// its flow path: the labels the flat index of that cell, the upslope mask
// whether it is a seed.  A cell pointing at a code outside 1..8 (NO_FLOW,
// nodata), off the grid, or a seed (upslope only) is pinned.  A cell on a
// cycle, or upstream of one, reaches no pinned cell and reads what the
// sweeps leave there: label -1, not upslope.
//
// The counterpart of the TPU's _resolve_kernel (pallas_folded.py:606) on
// every path: the TPU engine reaches the same fixpoint by rotations of
// directional sweeps (the resolve sweep, whose plain version is the
// jump's reference in the tests).  A sweep carries a value only
// where the path runs with it, so every turn of a path costs another
// rotation (21 rotations of four sweeps a basin step at 10240^2); pointer
// jumping needs log2 of the path's length in rounds, whatever its turns.
//
// Three kernels, templated on a tag whose name holds ResolveSweep (a trace
// claims the layer's time by it).
//   local:  one block a T x T tile.  Every cell's target goes to shared
//           memory as one int32: a stop (a pinned cell's value v, as
//           ~(v + 1) < 0), the in-tile successor (LOCAL + its index in the
//           tile), or the border slot of the successor outside the tile
//           (>= 0).  Pointers jump in place, t <- t[t], until a round makes
//           no target final; a target still in the tile then runs into a
//           cycle and becomes the cycle's stop.  Each cell writes its
//           target to `ptr`, and the cells of the tile's ring (the only
//           ones another tile's path can enter) also to their border slot.
//   round:  one jump over the border slots, b <- b[b] where b is not yet a
//           stop, in place (a value read mid-round is only further along the
//           same path).  ceil(log2(slots)) + 1 rounds are launched, which
//           doubles past the longest chain of slots; a round whose
//           predecessor made nothing final returns at once (what is left
//           runs into a cycle).  No host sync.
//   final:  each cell's value: its stop, or that of its border slot; a slot
//           left without a stop is a cycle's.
// Integer values only: the result is the fixpoint bit for bit, on every
// run, whatever the schedule.
//
// What bounds it on an H100: the local pass's rounds of jumps in shared
// memory (a load, a dependent load and a barrier a round), about 0.76 ms
// of a walk's 1.3 ms at 10240^2 (PERF.md).  Bytes would take 0.4 ms: the
// local pass reads the code (and seed) bytes and writes 4 a cell (and a
// slot for 6 % of the cells), the rounds read the slots, the final pass
// reads 4 and writes 4 (the labels) or 1 (the mask).
//
// Cells are indexed in int32: h * w <= 2^30, and the slots below 2^30 (the
// launcher refuses more).

#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#ifndef RD_JUMP_TILE
#define RD_JUMP_TILE 64
#endif
#ifndef RD_JUMP_THREADS
#define RD_JUMP_THREADS 256
#endif

namespace rd {
namespace jump {

constexpr int T = RD_JUMP_TILE;   // tile edge
constexpr int NT = RD_JUMP_THREADS;  // threads a block
constexpr int RING = 4 * T - 4;   // border slots a tile
constexpr int LOCAL = 1 << 30;    // an in-tile target, in shared memory
static_assert(T >= 2 && NT % 32 == 0 && NT <= 1024, "tile and block");
static_assert(T * T * 4 <= 48 * 1024, "a tile's targets in static shared");

// The tag: which walk, and what a cell on or below a cycle reads.
template <bool UPSLOPE>
struct ResolveSweepJump {
  static constexpr bool UP = UPSLOPE;
  static constexpr int CYCLE = UPSLOPE ? 0 : -1;
};

// A stop of value v >= -1, and back.
__device__ __forceinline__ int stop(int v) { return ~(v + 1); }
__device__ __forceinline__ int value_of(int e) { return ~e - 1; }

// D8 offsets of code d in 1..8 (topology.py: 1 W, 2 NW, 3 N, 4 NE, 5 E,
// 6 SE, 7 S, 8 SW).
__device__ __forceinline__ int dx(int d) {
  return (d == 1 || d == 2 || d == 8) ? -1 : ((d == 3 || d == 7) ? 0 : 1);
}
__device__ __forceinline__ int dy(int d) {
  return (d == 1 || d == 5) ? 0 : (d <= 4 ? -1 : 1);
}

// The slot of tile cell (lr, lc) on the tile's ring, in the frame of a
// whole T x T tile: the top row, the bottom row, then the left and right
// columns without their corners.  A short tile at the grid's bottom or
// right edge is never entered across the edge that lies off the grid, so
// its missing ring cells are never targets.
__device__ __forceinline__ bool on_ring(int lr, int lc) {
  return lr == 0 || lr == T - 1 || lc == 0 || lc == T - 1;
}
__device__ __forceinline__ int ring_slot(int lr, int lc) {
  return lr == 0       ? lc
         : lr == T - 1 ? T + lc
         : lc == 0     ? 2 * T + lr - 1
                       : 3 * T - 2 + lr - 1;
}

template <class J>
__global__ void __launch_bounds__(NT)
    local_kernel(const int8_t* __restrict__ code,
                 const uint8_t* __restrict__ seeds, int* __restrict__ ptr,
                 int* __restrict__ border, int* __restrict__ progress,
                 int rounds, int h, int w, int tiles_x) {
  __shared__ int s[T * T];
  const int tile = blockIdx.x;
  const int r0 = tile / tiles_x * T, c0 = tile % tiles_x * T;
  if (tile == 0 && threadIdx.x < rounds) progress[threadIdx.x] = 0;
  for (int i = threadIdx.x; i < T * T; i += NT) {
    const int r = r0 + i / T, c = c0 + i % T;
    int e = stop(J::CYCLE);  // a cell off the grid: never a target
    if (r < h && c < w) {
      const int cell = r * w + c;
      const int k = code[cell];
      const bool seed = J::UP && seeds[cell] != 0;
      bool pin = seed || k < 1 || k > 8;
      const int nr = pin ? r : r + dy(k), nc = pin ? c : c + dx(k);
      pin = pin || nr < 0 || nr >= h || nc < 0 || nc >= w;
      if (pin)
        e = stop(J::UP ? static_cast<int>(seed) : cell);
      else if (nr - r0 >= 0 && nr - r0 < T && nc - c0 >= 0 && nc - c0 < T)
        e = LOCAL + (nr - r0) * T + (nc - c0);
      else
        e = (nr / T * tiles_x + nc / T) * RING + ring_slot(nr % T, nc % T);
    }
    s[i] = e;
  }
  // A round in which no target became final leaves only targets that run
  // into a cycle: each chain's last non-final cell reads a final target.
  for (bool more = true; more;) {
    __syncthreads();
    bool moved = false;
    for (int i = threadIdx.x; i < T * T; i += NT) {
      const int e = s[i];
      if (e >= LOCAL) {
        const int t = s[e - LOCAL];
        if (t != e) {
          s[i] = t;
          moved = moved || t < LOCAL;
        }
      }
    }
    more = __syncthreads_or(moved);
  }
  int* slots = border + static_cast<long long>(tile) * RING;
  for (int i = threadIdx.x; i < T * T; i += NT) {
    const int lr = i / T, lc = i % T, r = r0 + lr, c = c0 + lc;
    int e = s[i];
    if (e >= LOCAL) e = stop(J::CYCLE);
    if (r < h && c < w) ptr[r * w + c] = e;
    if (on_ring(lr, lc)) slots[ring_slot(lr, lc)] = e;
  }
}

template <class J>
__global__ void __launch_bounds__(NT)
    round_kernel(int* border, int* progress, int slots, int k) {
  if (k > 0 && __ldcg(progress + k - 1) == 0) return;
  bool moved = false;
  for (int b = blockIdx.x * NT + threadIdx.x; b < slots;
       b += gridDim.x * NT) {
    const int e = __ldcg(border + b);
    if (e >= 0) {
      const int t = __ldcg(border + e);
      if (t != e) {
        border[b] = t;
        moved = moved || t < 0;
      }
    }
  }
  if (__syncthreads_or(moved) && threadIdx.x == 0) progress[k] = 1;
}

template <class J, class O>
__global__ void __launch_bounds__(NT)
    final_kernel(const int* ptr, const int* __restrict__ border, O* out,
                 int n) {
  for (int c = blockIdx.x * NT + threadIdx.x; c < n; c += gridDim.x * NT) {
    int e = ptr[c];
    if (e >= 0) e = __ldg(border + e);
    out[c] = static_cast<O>(e >= 0 ? J::CYCLE : value_of(e));
  }
}

// Border slots of an h x w grid, and the rounds that jump over them.
inline long long slots_of(int h, int w) {
  return static_cast<long long>((h + T - 1) / T) * ((w + T - 1) / T) * RING;
}
inline int rounds_of(long long slots) {
  int r = 1;
  while ((1ll << r) < slots) ++r;
  return r + 1;
}

}  // namespace jump

// Local pass, rounds, final pass on `stream`.  `ptr`: h * w int32 of
// scratch (it may be `out` for the labels); `border`: the grid's slots
// (jump::slots_of) and then one int32 a round (jump::rounds_of), scratch;
// `out`: h * w values (int32 labels, or bool as uint8).  Seeds are read
// for the upslope walk only.
template <bool UPSLOPE, class O>
int launch_successor_jump(const int8_t* code, const uint8_t* seeds, int* ptr,
                          O* out, int* border, long long border_len, int h,
                          int w, void* stream) {
  using namespace jump;
  using J = ResolveSweepJump<UPSLOPE>;
  if (h < 1 || w < 1 || static_cast<long long>(h) * w > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long slots = slots_of(h, w);
  if (slots >= LOCAL) return static_cast<int>(cudaErrorInvalidValue);
  const int rounds = rounds_of(slots);
  if (border_len < slots + rounds || rounds > NT)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_x = (w + T - 1) / T;
  const int tiles = static_cast<int>(slots / RING);
  int* progress = border + slots;
  local_kernel<J><<<tiles, NT, 0, s>>>(code, seeds, ptr, border, progress,
                                       rounds, h, w, tiles_x);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  const long long most = 8ll * sms;  // blocks of a grid-stride pass
  const int n = h * w;
  const int round_blocks =
      static_cast<int>(std::min<long long>((slots + NT - 1) / NT, most));
  for (int k = 0; k < rounds; ++k)
    round_kernel<J><<<round_blocks, NT, 0, s>>>(border, progress,
                                                static_cast<int>(slots), k);
  const int final_blocks =
      static_cast<int>(std::min<long long>((n + NT - 1) / NT, most));
  final_kernel<J, O><<<final_blocks, NT, 0, s>>>(ptr, border, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rd
