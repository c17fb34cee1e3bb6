// Multi-flow accumulation A = w + P^T A solved once, in topological order,
// for a field whose shares hold no cycle (after a fill every share goes
// strictly downhill).  Templates over a field that says what cell i sends
// toward D8 direction d (F::share) and whether every share it sends is 1
// (F::UNIT); mfd_sweep.cu instantiates them over MfdField, accum_sweep.cu
// over the D8 codes (a cell sends everything to the one neighbour its code
// names: UNIT).
//
// Replaces no TPU kernel: the TPU engines reach the same fixpoint by
// rotations of directional sweeps (flow_sweep.cuh, the fallback here).  A
// sweep carries flow only along paths that run with it, so every turn of a
// donor chain costs another rotation (34 rotations of 4 sweeps at 10240^2
// on Quinn); on the graph of nonzero shares the exact answer takes one
// pass in topological order.
//
// Two kernels.
//   count: one stencil pass over the planes.  deps[c] holds how many
//          on-grid neighbours send c a nonzero share (bits 0-7), the
//          directions c sends to (8-15) and those it takes from (16-23);
//          inshare[c] the 8 shares its neighbours send it, 32 bytes a cell
//          (one sector where the planes would take 8), unless the field is
//          UNIT.  It also fills `order` with EMPTY and clears the control
//          block.
//   solve: one cooperative grid (every block resident), level by level.
//          Level 0 is the cells with no donor.  A level's entries (the
//          cell with its two masks) lie in order[lo, hi), handed to the
//          blocks in runs of 32.  A cell's value is pulled from its donors,
//          which lie in earlier levels,
//            acc[c] = (((w[c] + a[n_1] s_1) + a[n_2] s_2) + ...)
//          over the directions d = 1..8 whose neighbour n_d sends c a
//          nonzero share s_d, each product and each sum rounded
//          (__fmul_rn, __fadd_rn): the order of the plain version, so the
//          two agree bitwise whatever the schedule.  A UNIT field loads no
//          share and multiplies by none (a product by 1 is exact, so the
//          sum is that of the same field as planes).  The cell counts down
//          its receivers' counters as it loads; a receiver whose counter
//          reaches zero goes to its block's buffer in shared memory.  At
//          the level's end each block arrives and reserves the slots of its
//          buffer with one atomic, then writes them; the last arrival knows
//          the new tail and publishes it with the next generation.  A reader
//          waits for an entry still EMPTY.  The pass ends at an empty level.
// Integer atomics only (the counters, the arrivals and tail, the barrier):
// no float atomics, so the result is the same bitwise on every run.  A
// cell on a cycle, or downstream of one, never reaches a level: the
// control block's count of solved cells (NaN results not counted) tells
// the caller to fall back to the sweeps, which run as before.
//
// What bounds it on an H100: the chain of levels (16 512 on the seed-0
// 10240^2 Perlin DEM at eps = 0.01), not bytes: the two kernels move
// under 200 bytes a cell, under 6 ms of HBM time there, while a level
// costs about 4.7 us of dependent latency (the barrier's word, the entry,
// the loads, the fence, the arrival).  What the design does about it: a
// level's countdowns go out with its loads (a receiver is solved only
// after the barrier), every load of a cell in flight at once, a level
// spread over every SM in runs of 32 entries, one arrival atomic a block
// that also reserves its slots, the level's bounds carried by the
// barrier's one word, and the control words on lines of their own.
// Measured on an H100 (PERF.md): per-block frontiers (no redistribution)
// and a per-block dataflow queue were both slower, by imbalance.  Over D8
// codes the levels are fewer (about 2 000 after an eps = 0 fill, 10 000
// after flat resolution, at 10240^2) but the first ones wide (a third of
// the cells at eps = 0), so a level costs about 12 and 5 us there.
//
// Cells are indexed in int32: h * w <= 2^30 (the launcher refuses more).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rd {
namespace topo {

// Threads a block, blocks an SM, and the entries a block buffers in shared
// memory for the next level (more go to `order` one by one): chosen on an
// H100, where 1 x 1024 to 6 x 128 threads an SM were within 4 % (PERF.md).
constexpr int NT = 256;
constexpr int BLOCKS_PER_SM = 2;
constexpr int CAP = 1024;
constexpr int WARPS = NT / 32;
static_assert(NT % 32 == 0 && NT <= 1024, "whole warps, one block");
constexpr unsigned long long EMPTY = ~0ull;  // an entry not written yet

// D8 offsets of direction d (1 W, 2 NW, 3 N, 4 NE, 5 E, 6 SE, 7 S, 8 SW)
// and the direction back (topology.py).
constexpr __host__ __device__ int dx(int d) {
  return (d == 1 || d == 2 || d == 8) ? -1 : ((d == 3 || d == 7) ? 0 : 1);
}
constexpr __host__ __device__ int dy(int d) {
  return (d == 1 || d == 5) ? 0 : (d <= 4 ? -1 : 1);
}
constexpr __host__ __device__ int inverse(int d) { return (d + 3) % 8 + 1; }

// The control block, in 128 int32 of scratch, one 128-byte line a word
// (the barrier's waiters poll one line, its arrivals hit another): the
// barrier's word (the generation above, the tail of `order` below), the
// arrival word (the blocks that have arrived above, the tail below), the
// cells solved.
struct Ctl {
  unsigned long long bar;
  int pad0[30];
  unsigned long long at;
  int pad1[30];
  int solved;
  int pad2[63];
};
static_assert(sizeof(Ctl) == 128 * sizeof(int), "128 int32");

__device__ __forceinline__ unsigned long long ld_acquire_u64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed_u64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_u64(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// An entry of `order`: the cell, and above it the masks of its deps word
// (receivers, then donors).
__device__ __forceinline__ unsigned long long entry(int c, int word) {
  return static_cast<unsigned>(c) |
         (static_cast<unsigned long long>(static_cast<unsigned>(word) >> 8)
          << 32);
}

// A slot of `order` for one entry, outside the level's buffer.
__device__ __forceinline__ int append_one(Ctl* ctl) {
  return static_cast<int>(atomicAdd(&ctl->at, 1ull) & 0xffffffffu);
}

// The end of a level.  Thread 0 of each block, after a fence (the block's
// values and overflow appends before it, by the barrier's cumulativity),
// arrives and reserves the slots of its buffered entries with one atomic;
// the block then writes them, while the barrier may already be open:
// `order` starts out EMPTY and a reader waits for its entry.  The last
// arrival knows the new tail, resets the arrivals and publishes the tail
// with the next generation; the others wait with acquire loads.  A wait
// of more than 10 s traps (a launch error) rather than hang.  Returns the
// new tail, the next level's end.
__device__ __forceinline__ int end_level(Ctl* ctl, unsigned& gen,
                                         const unsigned long long* buf,
                                         int* n, unsigned long long* order) {
  __shared__ int s_hi, s_base, s_k;
  __syncthreads();
  bool last = false;
  if (threadIdx.x == 0) {
    const int k = min(*n, CAP);
    ++gen;
    __threadfence();
    const unsigned long long old =
        atomicAdd(&ctl->at, (1ull << 32) | static_cast<unsigned>(k));
    s_base = static_cast<int>(old & 0xffffffffu);
    s_k = k;
    if (static_cast<int>(old >> 32) == static_cast<int>(gridDim.x) - 1) {
      last = true;
      s_hi = s_base + k;
      ctl->at = static_cast<unsigned>(s_hi);  // no arrival: the tail alone
      st_release_u64(&ctl->bar, (static_cast<unsigned long long>(gen) << 32) |
                                    static_cast<unsigned>(s_hi));
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < s_k; j += NT) order[s_base + j] = buf[j];
  if (threadIdx.x == 0) {
    *n = 0;
    if (!last) {
      unsigned long long v;
      const uint64_t t0 = now_ns();
      while (static_cast<unsigned>((v = ld_acquire_u64(&ctl->bar)) >> 32) !=
             gen) {
        if (now_ns() - t0 > 10000000000ull) __trap();
      }
      s_hi = static_cast<int>(v & 0xffffffffu);
    }
  }
  __syncthreads();
  return s_hi;
}

template <class F>
__global__ void __launch_bounds__(NT)
    count_kernel(typename F::Ptrs fp, int h, int w, int* deps,
                 float* inshare, unsigned long long* order, Ctl* ctl) {
  const int c = blockIdx.x * NT + threadIdx.x;
  if (c == 0) {
    ctl->bar = 0ull;
    ctl->at = 0ull;
    ctl->solved = 0;
  }
  if (c >= h * w) return;
  const int r = c / w, col = c - r * w;
  unsigned in_m = 0, out_m = 0;
  float s[8];
#pragma unroll
  for (int d = 1; d <= 8; ++d) {
    const int rr = r + dy(d), cc = col + dx(d);
    const bool ok = rr >= 0 && rr < h && cc >= 0 && cc < w;
    s[d - 1] = ok ? F::share(fp, inverse(d), c + dy(d) * w + dx(d)) : 0.0f;
    if (s[d - 1] != 0.0f) in_m |= 1u << (d - 1);
    if (ok && F::share(fp, d, c) != 0.0f) out_m |= 1u << (d - 1);
  }
  if constexpr (!F::UNIT) {
    float4* out =
        reinterpret_cast<float4*>(inshare) + 2 * static_cast<size_t>(c);
    out[0] = make_float4(s[0], s[1], s[2], s[3]);
    out[1] = make_float4(s[4], s[5], s[6], s[7]);
  }
  deps[c] = __popc(in_m) | (out_m << 8) | (in_m << 16);
  order[c] = EMPTY;
}

// The next level being filled: a buffer in shared memory, appended at the
// level's end; what the buffer cannot take goes to `order` at once.
struct Next {
  unsigned long long* buf;
  int* n;
  unsigned long long* order;
  Ctl* ctl;
  __device__ void add(unsigned long long e) const {
    const int i = atomicAdd(n, 1);
    if (i < CAP)
      buf[i] = e;
    else
      order[append_one(ctl)] = e;
  }
};

// Solve one cell whose donors are all solved, then count down its
// receivers; those it readies go to `next`.  Returns 1 if the value is a
// number.
template <class F>
__device__ __forceinline__ int solve_cell(unsigned long long e,
                                          const float* __restrict__ wgt,
                                          float* acc, int* deps,
                                          const float* __restrict__ inshare,
                                          int w, const Next& next) {
  const int c = static_cast<int>(e & 0xffffffffu);
  const unsigned out_m = static_cast<unsigned>(e >> 32) & 0xffu;
  const unsigned in_m = static_cast<unsigned>(e >> 40) & 0xffu;
  // The countdowns go out with the loads: a receiver they ready is solved
  // at the next level, after the barrier has published acc[c].
  int old[8];
#pragma unroll
  for (int d = 1; d <= 8; ++d)
    old[d - 1] = (out_m >> (d - 1)) & 1u
                     ? atomicSub(deps + c + dy(d) * w + dx(d), 1)
                     : 0;
  // the in-shares: a UNIT field's are 1, neither loaded nor multiplied by
  const float4* sp =
      reinterpret_cast<const float4*>(inshare) + 2 * static_cast<size_t>(c);
  const float4 s0 = F::UNIT ? float4{} : __ldg(sp);
  const float4 s1 = F::UNIT ? float4{} : __ldg(sp + 1);
  const float s_in[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  float a_in[8];
#pragma unroll
  for (int d = 1; d <= 8; ++d)  // written at an earlier level, elsewhere
    a_in[d - 1] = (in_m >> (d - 1)) & 1u
                      ? __ldcg(acc + c + dy(d) * w + dx(d))
                      : 0.0f;
  float a = __ldg(wgt + c);
#pragma unroll
  for (int d = 0; d < 8; ++d)
    if ((in_m >> d) & 1u)
      a = __fadd_rn(a, F::UNIT ? a_in[d] : __fmul_rn(a_in[d], s_in[d]));
  acc[c] = a;
#pragma unroll
  for (int d = 1; d <= 8; ++d)
    if ((old[d - 1] & 0xff) == 1)
      next.add(entry(c + dy(d) * w + dx(d), old[d - 1]));
  return a == a ? 1 : 0;
}

// Templated on the field so that its name carries the field's (a trace
// claims the layer's time by it), and for UNIT: otherwise it reads the
// in-shares that count_kernel laid out.
template <class F>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
    solve_kernel(const float* __restrict__ wgt, float* acc, int* deps,
                 const float* __restrict__ inshare,
                 unsigned long long* order, Ctl* ctl, int h, int w) {
  __shared__ unsigned long long s_buf[CAP];
  __shared__ int s_n;
  const int n = h * w;
  const int blocks = static_cast<int>(gridDim.x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Next next{s_buf, &s_n, order, ctl};
  unsigned gen = 0;
  int solved = 0;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  // level 0: the cells no neighbour sends to
  for (int c = blockIdx.x * NT + threadIdx.x; c < n; c += blocks * NT) {
    const int word = deps[c];
    if ((word & 0xff) == 0) next.add(entry(c, word));
  }
  int lo = 0, hi = end_level(ctl, gen, s_buf, &s_n, order);
  while (lo < hi) {
    // a level's runs of 32 entries go to the blocks in turn: a narrow
    // level spreads over every SM, and a warp reads 256 bytes at once
    for (int q0 = blockIdx.x; lo + 32 * q0 < hi; q0 += WARPS * blocks) {
      const int k = lo + 32 * (q0 + warp * blocks) + lane;
      if (k < hi) {
        unsigned long long e = ld_relaxed_u64(order + k);
        if (e == EMPTY) {  // its block has arrived but not yet written it
          const uint64_t t0 = now_ns();
          while ((e = ld_relaxed_u64(order + k)) == EMPTY)
            if (now_ns() - t0 > 10000000000ull) __trap();
        }
        solved += solve_cell<F>(e, wgt, acc, deps, inshare, w, next);
      }
    }
    lo = hi;
    hi = end_level(ctl, gen, s_buf, &s_n, order);
  }
  // the block's count of solved cells, one atomic a block
  __shared__ int s_solved;
  if (threadIdx.x == 0) s_solved = 0;
  __syncthreads();
  atomicAdd(&s_solved, solved);
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(&ctl->solved, s_solved);
}

}  // namespace topo

// Count, then solve.  `deps`: h * w int32 of scratch; `inshare`: 8 * h * w
// floats of scratch, 16-byte aligned (none for a UNIT field: null);
// `order`: h * w uint64 of scratch;
// `ctl`: 128 int32 (all cleared or filled by the count kernel on
// `stream`); `acc`: h * w floats, written where a cell is solved.  After
// the stream reaches it, ctl[64] holds the cells solved to a number (not
// NaN).
template <class F>
int launch_flow_topo(typename F::Ptrs fp, const float* wgt, float* acc,
                     int* deps, float* inshare, unsigned long long* order,
                     int* ctl, int h, int w, void* stream) {
  using namespace topo;
  if (h < 1 || w < 1 || static_cast<long long>(h) * w > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Ctl* c = reinterpret_cast<Ctl*>(ctl);
  const int n = h * w;
  count_kernel<F><<<(n + NT - 1) / NT, NT, 0, s>>>(fp, h, w, deps, inshare,
                                                   order, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = solve_kernel<F>;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                           0)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  per_sm = per_sm < BLOCKS_PER_SM ? per_sm : BLOCKS_PER_SM;
  const float* ins = inshare;
  void* args[] = {&wgt, &acc, &deps, &ins, &order, &c,
                  const_cast<int*>(&h), const_cast<int*>(&w)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                    dim3(per_sm * sms), dim3(NT), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rd
