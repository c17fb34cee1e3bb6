// One scan Gauss-Seidel sweep of the depression-fill fixpoint
//
//     W(c) = min( W(c), max( Z(c), min_n W(n) + eps_n ) )
//
// over a row-major float32 (H, W) raster, walking the rows down (reverse =
// 0) or up (reverse = 1).  Each row takes the new values of the row before
// (N straight at eps, NW/NE diagonal at eps_diag) and resolves BOTH in-row
// directions exactly, so a rotation is two sweeps and needs no transpose.
// Off-grid neighbours are drains (-BIG); nodata cells already hold -BIG in
// `flr` and `w_in`.  For each row:
//
//   vc  = min(prev[j] + eps, min(prev[j-1], prev[j+1]) + eps_diag)
//   b   = min(wr, max(fr, vc))
//   F'  = clip(F'[j-+1], lo'[j], hi'[j]) from -BIG off the row, in tilted
//         coordinates lo' = fr - t, hi' = b - t, t = +j*eps (forward chain)
//         or t = -j*eps (reverse chain), j the column; F = F' + t
//   lat = min(F_fwd, F_rev)
//   new = max(fr, lat < b - guard ? lat : b),  guard = (|b| + tmax)*2^-21
//         if eps > 0 else 0, tmax = (W - 1)*eps (the reference uses its
//         padded width)
//
// The max with the floor is the port's: untilting a chain value clamped at
// the floor, (fr - t) + t, can round one ulp below fr, and the reference
// then returns such cells below the DEM.  At eps = 0 it changes nothing.
//
// Replaces the TPU kernel richdem_tpu/ops/pallas_scan.py:_fill_scan_kernel
// (line 876) with its in-row _clamp_scan (line 833) at the default depth 0
// (the whole row is one scan).  As there, no cell of the rows after the
// current one is read: every output is a function of settled rows only.
//
// Design.  One thread-block cluster of C CTAs walks all H rows of the sweep;
// CTA q owns the contiguous segment [q*S, q*S + S) of every row, S =
// ceil(W / C) (the last segment may be shorter), and each of its nt
// consumer threads owns K contiguous columns of it: the fewest columns that
// RD_SCAN_THREADS = 256 threads allow, on the fewest whole warps (K = 3 on
// 224 threads at 10240 columns).  The composition of two clip maps, "a then
// b" = (clip(a.lo, b), clip(a.hi, b)), is min/max only: exact and
// associative, so any grouping gives the chain bit for bit as the plain
// version's Hillis-Steele scan does.  A row step:
//   1. each thread composes the forward and reverse maps of its columns
//      (one pass, both chains), keeping b in shared memory;
//   2. __shfl warp scans of both chains at once (the reverse one in
//      mirrored lane order); one CTA barrier; every warp scans the warps'
//      totals, and warp 0 sends the CTA's pair of aggregates to every CTA
//      of the cluster;
//   3. each thread waits for the cluster's aggregates, scans them (the
//      CTAs before its own in each chain's order) into its CTA's carry-ins,
//      applies its warp's and lane's exclusive prefixes and walks its
//      columns: forward, then backward, where both chains meet and the new
//      values are made;
//   4. the CTA's first and last new values go to the neighbours' halo
//      columns, and a CTA barrier closes the row.
// The sends are asynchronous stores into the other CTAs' shared memory
// (st.async, distributed shared memory) that complete transactions on the
// receiver's mbarrier, so a CTA waits only for the bytes it reads: the
// aggregates once a row (every CTA's), the halo columns at the next row (the
// threads that read them).  Each of those buffers and barriers is double, by
// row parity; a sender can be at most one row ahead of a receiver, because
// its next row needs the receiver's aggregates.  No cluster-wide barrier
// runs in the row loop (two a row, the first design, were slower than the
// sends); one runs before it (the barriers initialised, every CTA running)
// and one after it (nothing in flight).  The row before's new values stay in
// shared memory (two rows, each with a halo column either side), so nothing
// is read back from `w_out`.  `w_in` and `flr` of the rows ahead do not
// depend on the sweep: a producer warp stages them by bulk asynchronous
// copies into a ring of up to 8 rows (row_ring.cuh).  C is
// min(RD_SCAN_CLUSTER = 16, ceil(W / 512)): 16 CTAs (a non-portable cluster
// size) at 10240 columns.  The column loops stay rolled: unrolled and
// register-staged versions ran slower.  The launch is cudaLaunchKernelEx
// with a cluster dimension; a launch the card refuses returns its error, and
// so does a width whose segment rows do not fit shared memory
// (rd_fill_scan_shape says which).
//
// What bounds it on an H100: the row-to-row dependency, across the
// cluster: a sweep moves 12 bytes a cell (W and Z read, W written: 0.38 ms
// at 10240^2 at 3.35 TB/s) but takes H row steps, each a chain of about
// 12 dependent scan steps (lanes, warps, CTAs), two CTA barriers and a
// round trip of distributed shared memory: about 3300 cycles.
//
// Change flag: one atomicOr into `changed` when any cell changed.  Sound
// for the fill only, because every sweep is idempotent at the fixpoint.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "row_ring.cuh"

#ifndef RD_SCAN_THREADS
#define RD_SCAN_THREADS 256
#endif
#ifndef RD_SCAN_CLUSTER
#define RD_SCAN_CLUSTER 16
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int NT = RD_SCAN_THREADS;  // most consumers a CTA
constexpr int WARPS = NT / 32;
constexpr int CMAX = RD_SCAN_CLUSTER;
constexpr int SEG_MIN = 512;        // columns a CTA before the cluster grows
constexpr int STAGES_MAX = 8;       // rows of w_in and flr staged ahead
constexpr int BUDGET = 227 * 1024;  // shared memory a block may use
constexpr float NEG = -1.0e30f;     // -BIG: the drain value
constexpr unsigned FULL = 0xffffffffu;
static_assert(NT % 32 == 0 && NT >= 32 && NT + 32 <= 1024,
              "whole consumer warps and a producer warp within 1024");
static_assert(CMAX >= 1 && CMAX <= 16, "a cluster holds at most 16 CTAs");

// Dynamic shared memory, in bytes from the start: the mbarriers (the
// ring's full and empty ones, then the aggregates' and the halos' two
// each); the aggregates of every CTA of the cluster for two rows (forward
// lo, hi, reverse lo, hi); the warps' totals of both chains; the new
// values of two rows, column j of the segment at j + 1 (halo columns at 0
// and S + 1); b and the forward chain of the segment; then the ring, two
// slots (w_in, flr) a stage.
constexpr int BAR_EMPTY = STAGES_MAX, BAR_AGG = 2 * STAGES_MAX,
              BAR_HALO = BAR_AGG + 2, NBARS = BAR_HALO + 2;
constexpr int OFF_AGG = 8 * NBARS;
constexpr int OFF_WARP = OFF_AGG + 2 * 16 * CMAX;
constexpr int OFF_PRV = OFF_WARP + 2 * 32 * 8;
static_assert(OFF_AGG % 16 == 0 && OFF_PRV % 16 == 0, "aligned parts");

struct Shape {
  int c;       // CTAs of the cluster
  int seg;     // columns a CTA (the last may own fewer)
  int k;       // columns a consumer thread: as few as NT threads allow
  int nt;      // consumer threads a CTA: the fewest whole warps for k
  int stages;  // rows of the ring
  int prow;    // floats of one row of new values, halos included
  int slot;    // floats of one ring slot
  int off_b, off_ring, bytes;
};

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ inline int round4(int a) { return (a + 3) / 4 * 4; }

// The launch shape for a row of w columns; stages = 0 where two stages of
// the segment rows do not fit shared memory.
__host__ __device__ inline Shape shape_of(int w) {
  Shape s;
  int c = ceil_div(w, SEG_MIN);
  c = c < 1 ? 1 : (c > CMAX ? CMAX : c);
  s.seg = ceil_div(w, c);
  s.c = ceil_div(w, s.seg);
  s.k = ceil_div(s.seg, NT);
  s.nt = 32 * ceil_div(ceil_div(s.seg, s.k), 32);
  s.prow = round4(s.seg + 2);
  // the covering span of a segment row starts up to 3 floats before it
  // and ends up to 3 after
  s.slot = round4(s.seg + 8);
  s.off_b = OFF_PRV + 4 * 2 * s.prow;
  s.off_ring = s.off_b + 4 * 2 * round4(s.seg);
  const int fit = (BUDGET - s.off_ring) / (8 * s.slot);
  s.stages = fit < 2 ? 0 : (fit > STAGES_MAX ? STAGES_MAX : fit);
  s.bytes = s.off_ring + s.stages * 8 * s.slot;
  return s;
}

struct Clip {
  float lo, hi;
};

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float apply(const Clip& m, float x) {
  return clip(x, m.lo, m.hi);
}

// the map "a, then b"
__device__ __forceinline__ Clip compose(Clip a, Clip b) {
  return {clip(a.lo, b.lo, b.hi), clip(a.hi, b.lo, b.hi)};
}

__device__ __forceinline__ Clip identity() { return {-INFINITY, INFINITY}; }

__device__ __forceinline__ Clip shfl_up(Clip v, int d) {
  return {__shfl_up_sync(FULL, v.lo, d), __shfl_up_sync(FULL, v.hi, d)};
}

__device__ __forceinline__ Clip shfl_down(Clip v, int d) {
  return {__shfl_down_sync(FULL, v.lo, d), __shfl_down_sync(FULL, v.hi, d)};
}

__device__ __forceinline__ Clip shfl_from(Clip v, int lane) {
  return {__shfl_sync(FULL, v.lo, lane), __shfl_sync(FULL, v.hi, lane)};
}

// Inclusive scans of the forward chain (lane order) and the reverse chain
// (mirrored order), both at once, over the first SPAN lanes (the others
// hold the identity).
template <int SPAN>
__device__ __forceinline__ void warp_scans(Clip& f, Clip& r, int lane) {
#pragma unroll
  for (int d = 1; d < SPAN; d <<= 1) {
    const Clip ef = shfl_up(f, d);
    const Clip er = shfl_down(r, d);
    if (lane >= d) f = compose(ef, f);
    if (lane + d < 32) r = compose(er, r);
  }
}

// A barrier over every thread of the cluster (arrival, then wait); every
// warp reaches it converged.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;" ::: "memory");
}

// The shared::cluster address of `p`'s counterpart in CTA `rank`.
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"(rd::smem_addr(p)), "r"(rank));
  return a;
}

// Asynchronous stores into another CTA's shared memory, each completing
// its bytes on that CTA's mbarrier `bar`.
__device__ __forceinline__ void send(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "f"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void send4(uint32_t addr, float a, float b,
                                      float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

#ifdef RD_SCAN_PROFILE
// Measurement builds only: cycles of thread 0 of CTA 0 in each part of
// the row steps of the last sweep (rd_fill_scan_profile reads them).
__device__ unsigned long long scan_prof[8];
#define PROF_MARK(i)                      \
  do {                                    \
    const long long now = clock64();      \
    prof[i] += now - mark;                \
    mark = now;                           \
  } while (0)
#else
#define PROF_MARK(i) \
  do {               \
  } while (0)
#endif

__global__ void __launch_bounds__(NT + 32, 1)
fill_scan_kernel(const float* __restrict__ w_in,
                 const float* __restrict__ flr, float* __restrict__ w_out,
                 int* __restrict__ changed, int h, int w, float eps,
                 float eps_diag, int reverse, Shape sh) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = bars;
  uint64_t* empty = bars + BAR_EMPTY;
  uint64_t* aggbar = bars + BAR_AGG;
  uint64_t* halobar = bars + BAR_HALO;
  float* agg = reinterpret_cast<float*>(smem + OFF_AGG);  // [2][CMAX][4]
  Clip* wtf = reinterpret_cast<Clip*>(smem + OFF_WARP);   // warp totals
  Clip* wtr = wtf + 32;
  float* prv = reinterpret_cast<float*>(smem + OFF_PRV);  // [2][prow]
  // b and the forward chain of the segment's columns
  float* bb = reinterpret_cast<float*>(smem + sh.off_b);
  float* ff = bb + round4(sh.seg);
  float* ring = reinterpret_cast<float*>(smem + sh.off_ring);

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int nc = sh.c;
  const int tx = threadIdx.x;
  const int s0 = rank * sh.seg;         // the segment's first column
  const int sw = min(sh.seg, w - s0);   // and its width
  const int stages = sh.stages;
  const int nbrs = (rank > 0) + (rank + 1 < nc);
  auto row_base = [&](int k) -> size_t {
    return static_cast<size_t>(reverse ? h - 1 - k : k) *
           static_cast<size_t>(w);
  };

  if (tx == 0) {
    for (int s = 0; s < stages; ++s) {
      rd::bar_init(&full[s], 1);
      rd::bar_init(&empty[s], 1);
    }
    for (int p = 0; p < 2; ++p) {
      rd::bar_init(&aggbar[p], 1);
      rd::bar_init(&halobar[p], 1);
    }
    rd::bar_init_fence();
  }
  const int nt = sh.nt, nwarps = nt / 32;
  for (int i = tx; i < 2 * sh.prow; i += nt + 32) prv[i] = NEG;
  // barriers initialised, halos set, every CTA of the cluster running
  cluster_sync();

  if (tx >= nt) {  // the producer warp; lane 0 issues the copies
    if (tx == nt) {
      int s = 0, phase = 0;
      for (int k = 0; k < h; ++k) {
        if (k >= stages) rd::bar_wait(&empty[s], phase ^ 1);
        const size_t e0 = row_base(k) + s0;
        const rd::Covering a = rd::covering(w_in, e0, e0 + sw);
        const rd::Covering b = rd::covering(flr, e0, e0 + sw);
        rd::bar_expect(&full[s], a.bytes + b.bytes);
        rd::bulk_copy(ring + (2 * s) * sh.slot, a, &full[s]);
        rd::bulk_copy(ring + (2 * s + 1) * sh.slot, b, &full[s]);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    __syncwarp();
    cluster_sync();
    return;
  }

  const int lane = tx & 31, warp = tx >> 5;
  const int c0 = tx * sh.k;              // this thread's first column
  const int c1 = min(c0 + sh.k, sw);     // one past its last
  const float tmax = __fmul_rn(static_cast<float>(w - 1), eps);
  const bool guarded = eps > 0.f;
  // this thread reads a halo column (its neighbour's edge value)
  const bool reads_halo = (c0 == 0 && rank > 0) ||
                          (c0 < sw && sw <= c1 && rank + 1 < nc);
  // warp 0, lane q: where this CTA's aggregates go in CTA q
  const bool sender = warp == 0 && lane < nc;
  const int to = sender ? lane : rank;
  const uint32_t agg_to = remote(agg + 4 * rank, to);
  const uint32_t aggbar_to = remote(aggbar, to);
  // the edges go to the neighbours' halo columns
  const int west = rank > 0 ? rank - 1 : rank;
  const int east = rank + 1 < nc ? rank + 1 : rank;
  const uint32_t west_to = remote(prv + sh.seg + 1, west);
  const uint32_t west_bar = remote(halobar, west);
  const uint32_t east_to = remote(prv, east);
  const uint32_t east_bar = remote(halobar, east);
  int any = 0;
  int st = 0, phase = 0;
#ifdef RD_SCAN_PROFILE
  long long prof[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  long long mark = clock64();
#endif

  for (int k = 0; k < h; ++k) {
    const int par = k & 1, use = (k >> 1) & 1;  // buffer; its phase
    const size_t e0 = row_base(k) + s0;
    const float* pv = prv + (par ^ 1) * sh.prow;  // the row before
    float* nv_row = prv + par * sh.prow;
    const float* sw_in = ring + (2 * st) * sh.slot + rd::lead(w_in, e0);
    const float* sfl = ring + (2 * st + 1) * sh.slot + rd::lead(flr, e0);
    if (tx == nt - 1) {  // this row's receipts: every CTA's aggregates,
                         // and the neighbours' edges (read by the next row)
      rd::bar_expect(&aggbar[par], 16 * nc);
      if (k + 1 < h) rd::bar_expect(&halobar[par], 4 * nbrs);
    }
    if (reads_halo && k > 0)  // the edges the row before sent
      rd::bar_wait(&halobar[par ^ 1], ((k - 1) >> 1) & 1);
    if (k == 0) rd::bar_wait(&full[0], 0);  // later rows: at the row before
    PROF_MARK(0);

    // 1. b and the maps of this thread's columns, both chains
    Clip mf = identity(), mr = identity();
#pragma unroll 1
    for (int c = c0; c < c1; ++c) {
      const float wr = sw_in[c], fr = sfl[c];
      const float vc = fminf(__fadd_rn(pv[c + 1], eps),
                             __fadd_rn(fminf(pv[c], pv[c + 2]), eps_diag));
      const float b = fminf(wr, fmaxf(fr, vc));
      any |= (b != wr);  // b <= wr, so b != wr means a change
      bb[c] = b;
      const float t = __fmul_rn(static_cast<float>(s0 + c), eps);
      mf = compose(mf, {__fsub_rn(fr, t), __fsub_rn(b, t)});
      mr = compose({__fadd_rn(fr, t), __fadd_rn(b, t)}, mr);
    }
    PROF_MARK(1);

    // 2. the warp's scans, then the CTA's over its warps: every warp takes
    // the warps before and after it, warp 0 sends the CTA's aggregates
    Clip fi = mf, ri = mr;
    warp_scans<32>(fi, ri, lane);
    Clip fe = shfl_up(fi, 1), re = shfl_down(ri, 1);  // exclusive
    if (lane == 0) fe = identity();
    if (lane == 31) re = identity();
    if (lane == 31) wtf[warp] = fi;
    if (lane == 0) wtr[warp] = ri;
    rd::sync_consumers(nt);
    PROF_MARK(2);
    Clip a = lane < nwarps ? wtf[lane] : identity();
    Clip b = lane < nwarps ? wtr[lane] : identity();
    warp_scans<WARPS>(a, b, lane);
    const Clip tf = shfl_from(a, nwarps - 1), tr = shfl_from(b, 0);
    if (sender)
      send4(agg_to + par * 16 * CMAX, tf.lo, tf.hi, tr.lo, tr.hi,
            aggbar_to + 8 * par);
    const Clip wf = shfl_from(a, warp > 0 ? warp - 1 : 0);
    const Clip wb = shfl_from(b, warp + 1 < nwarps ? warp + 1 : 0);
    PROF_MARK(3);

    // 3. the carry-ins from the other CTAs, in each chain's order, then
    // through the warps and the lanes before this thread
    rd::bar_wait(&aggbar[par], use);
    PROF_MARK(4);
    const float* ag = agg + par * 4 * CMAX;
    Clip cf = lane < nc ? Clip{ag[4 * lane], ag[4 * lane + 1]} : identity();
    Clip cr = lane < nc ? Clip{ag[4 * lane + 2], ag[4 * lane + 3]}
                        : identity();
    warp_scans<CMAX>(cf, cr, lane);
    cf = shfl_from(cf, rank > 0 ? rank - 1 : 0);
    cr = shfl_from(cr, rank + 1 < nc ? rank + 1 : 0);
    float xf = rank > 0 ? apply(cf, NEG) : NEG;
    float xr = rank + 1 < nc ? apply(cr, NEG) : NEG;
    if (warp > 0) xf = apply(wf, xf);
    if (warp + 1 < nwarps) xr = apply(wb, xr);
    xf = apply(fe, xf);
    xr = apply(re, xr);

    // 4. this thread's columns: forward, then backward, where both chains
    // meet and the new values are made
#pragma unroll 1
    for (int c = c0; c < c1; ++c) {
      const float t = __fmul_rn(static_cast<float>(s0 + c), eps);
      xf = clip(xf, __fsub_rn(sfl[c], t), __fsub_rn(bb[c], t));
      ff[c] = __fadd_rn(xf, t);
    }
#pragma unroll 1
    for (int c = c1 - 1; c >= c0; --c) {
      const float t = __fmul_rn(static_cast<float>(s0 + c), eps);
      const float fr = sfl[c], bc = bb[c];
      xr = clip(xr, __fadd_rn(fr, t), __fadd_rn(bc, t));
      const float lat = fminf(ff[c], __fsub_rn(xr, t));
      const float guard =
          guarded ? __fmul_rn(__fadd_rn(fabsf(bc), tmax), 0x1p-21f) : 0.f;
      const float nv = fmaxf(fr, lat < __fsub_rn(bc, guard) ? lat : bc);
      any |= (nv != bc);
      nv_row[c + 1] = nv;
      w_out[e0 + c] = nv;
      // the edges, into the neighbours' halo columns
      if (k + 1 < h) {
        if (c == 0 && rank > 0)
          send(west_to + 4 * par * sh.prow, nv, west_bar + 8 * par);
        if (c == sw - 1 && rank + 1 < nc)
          send(east_to + 4 * par * sh.prow, nv, east_bar + 8 * par);
      }
    }
    PROF_MARK(5);
    // the next row's inputs (staged rows ahead), then the row's end: it is
    // in nv_row, and its stage is read
    const int sn = st + 1 == stages ? 0 : st + 1;
    const int pn = sn == 0 ? phase ^ 1 : phase;
    if (k + 1 < h) rd::bar_wait(&full[sn], pn);
    rd::sync_consumers(nt);
    if (tx == 0) rd::bar_arrive(&empty[st]);
    st = sn;
    phase = pn;
    PROF_MARK(6);
  }
  if (__any_sync(FULL, any) && lane == 0) atomicOr(changed, 1);
#ifdef RD_SCAN_PROFILE
  if (rank == 0 && tx == 0)
    for (int i = 0; i < 8; ++i) scan_prof[i] = prof[i];
#endif
  cluster_sync();  // every CTA has read what was sent to it
}

}  // namespace

// The launch shape for a row of `w` columns, into out[0..5]: CTAs of the
// cluster, columns a CTA, consumer threads a CTA, columns a thread, ring
// stages, dynamic shared memory bytes.  Returns cudaErrorInvalidValue when
// the width does not fit (two stages of the ring do not fit shared
// memory: wider than about 115000 columns).
extern "C" int rd_fill_scan_shape(int w, int* out) {
  if (w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh = shape_of(w);
  out[0] = sh.c;
  out[1] = sh.seg;
  out[2] = sh.nt;
  out[3] = sh.k;
  out[4] = sh.stages;
  out[5] = sh.bytes;
  return static_cast<int>(sh.stages < 1 ? cudaErrorInvalidValue
                                        : cudaSuccess);
}

#ifdef RD_SCAN_PROFILE
// Cycles of the last sweep's row steps by part (thread 0 of CTA 0): the
// row's set-up (the receipts, the halo wait), the maps, the warp scans and
// the CTA barrier, the scan over the warps and the aggregates' sends, the
// wait for the cluster's aggregates, the carries and the columns, the
// next row's ring wait and the closing CTA barrier.
extern "C" int rd_fill_scan_profile(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, scan_prof, sizeof(scan_prof)));
}
#endif

extern "C" int rd_fill_scan(const float* w_in, const float* flr,
                            float* w_out, int* changed, int h, int w,
                            float eps, float eps_diag, int reverse,
                            void* stream) {
  if (h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh = shape_of(w);
  if (sh.stages < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = fill_scan_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sh.bytes);
  if (err == cudaSuccess && CMAX > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.c);
  cfg.blockDim = dim3(sh.nt + 32);
  cfg.dynamicSmemBytes = sh.bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, w_in, flr, w_out, changed, h, w, eps,
                           eps_diag, reverse, sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
