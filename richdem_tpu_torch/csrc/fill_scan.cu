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
// Design.  One block of 1024 threads walks all H rows of the sweep; the whole
// row is one scan.  Each thread owns K = min(ceil(W/1024), KMAX) contiguous
// columns; a row wider than 1024*K is walked in chunks of that width, the
// chain value carried from chunk to chunk.  The composition of two clip
// maps, "a then b" = (clip(a.lo, b), clip(a.hi, b)), is min/max only: exact
// and associative, so the per-thread serial runs, the __shfl warp scans and
// the shared-memory pass over the 32 warps give the chain bit for bit as
// the plain version's Hillis-Steele scan does.  The reverse chain scans in
// mirrored order (__shfl_down_sync, warps from the last).  The loads of the
// next row's first chunk are issued a row ahead into registers.  The row
// before is read back from `w_out` (written by this block and made visible
// by the barrier closing each row), so any width fits.  In a row of several
// chunks the forward chain is parked in the row of `w_out` it will
// overwrite, and the reverse pass reloads what it needs.
//
// What bounds it on an H100: the row-to-row dependency on ONE SM.  A sweep
// moves 12 bytes a cell (W and Z read, W written: 0.38 ms at 10240^2 at
// 3.35 TB/s) but runs H row steps of four block barriers each.  It is
// written to be right first; a later redesign spreads a row over a
// thread-block cluster and exchanges chunk aggregates through distributed
// shared memory.
//
// Change flag: one atomicOr into `changed` when any cell changed.  Sound
// for the fill only, because every sweep is idempotent at the fixpoint.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 8;          // columns a thread holds in one chunk
constexpr float NEG = -1.0e30f;  // -BIG: the drain value
constexpr unsigned FULL = 0xffffffffu;

struct Clip {
  float lo, hi;
};

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// the map "a, then b"
__device__ __forceinline__ Clip compose(Clip a, Clip b) {
  return {clip(a.lo, b.lo, b.hi), clip(a.hi, b.lo, b.hi)};
}

__device__ __forceinline__ Clip identity() { return {-INFINITY, INFINITY}; }

// the value of the lane `d` places earlier in chain order
__device__ __forceinline__ Clip shfl_earlier(Clip v, int d, bool rev) {
  if (rev)
    return {__shfl_down_sync(FULL, v.lo, d), __shfl_down_sync(FULL, v.hi, d)};
  return {__shfl_up_sync(FULL, v.lo, d), __shfl_up_sync(FULL, v.hi, d)};
}

// inclusive scan over the 32 lanes; `pos` is the lane's place in chain order
__device__ __forceinline__ Clip warp_scan(Clip v, int pos, bool rev) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Clip e = shfl_earlier(v, d, rev);
    if (pos >= d) v = compose(e, v);
  }
  return v;
}

// Exclusive chain-order prefix of the threads' maps `m` over the block, and
// the block's total.  `tot` holds WARPS + 1 maps; a call must not reuse the
// buffer of the call just before it (the caller alternates two).
__device__ Clip block_prefix(Clip m, bool rev, Clip* tot, Clip& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pos = rev ? 31 - lane : lane;
  const Clip inc = warp_scan(m, pos, rev);
  Clip ex = shfl_earlier(inc, 1, rev);
  if (pos == 0) ex = identity();
  if (pos == 31) tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {  // lane = warp index
    const Clip wi = warp_scan(tot[lane], pos, rev);
    Clip we = shfl_earlier(wi, 1, rev);
    if (pos == 0) we = identity();
    tot[lane] = we;
    if (pos == 31) tot[WARPS] = wi;
  }
  __syncthreads();
  total = tot[WARPS];
  return compose(tot[warp], ex);
}

__global__ void __launch_bounds__(THREADS, 1)
fill_scan_kernel(const float* __restrict__ w_in,
                 const float* __restrict__ flr, float* w_out,
                 int* __restrict__ changed, int h, int w, float eps,
                 float eps_diag, int reverse) {
  __shared__ Clip tot[2][WARPS + 1];
  const int tid = threadIdx.x;
  const int K = min((w + THREADS - 1) / THREADS, KMAX);
  const int chunk = THREADS * K;
  const int nch = (w + chunk - 1) / chunk;
  const float tmax = __fmul_rn(static_cast<float>(w - 1), eps);
  const bool guarded = eps > 0.f;
  int buf = 0;
  int any = 0;

  auto row_of = [&](int s) { return reverse ? h - 1 - s : s; };
  auto base = [&](int r) {
    return static_cast<size_t>(r) * static_cast<size_t>(w);
  };
  // the row's value and floor at the thread's columns of chunk c
  auto load = [&](int r, int c, float* wv, float* fv) {
    const int j0 = c * chunk + tid * K;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int j = j0 + k;
      if (k < K && j < w) {
        wv[k] = w_in[base(r) + j];
        fv[k] = flr[base(r) + j];
      }
    }
  };
  // b = min(wr, max(fr, vc)) from the new values of the row before (rp)
  auto bound = [&](int rp, bool has_prev, int c, const float* wv,
                   const float* fv, float* b) {
    const int j0 = c * chunk + tid * K;
    auto prev = [&](int j) {
      return (has_prev && j >= 0 && j < w) ? w_out[base(rp) + j] : NEG;
    };
    float left = prev(j0 - 1), mid = prev(j0);
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int j = j0 + k;
      if (k < K && j < w) {
        const float right = prev(j + 1);
        const float vc = fminf(__fadd_rn(mid, eps),
                               __fadd_rn(fminf(left, right), eps_diag));
        b[k] = fminf(wv[k], fmaxf(fv[k], vc));
        left = mid;
        mid = right;
      }
    }
  };

  float nw[KMAX], nf[KMAX];  // the next row's first chunk, loaded ahead
#pragma unroll
  for (int k = 0; k < KMAX; ++k) nw[k] = nf[k] = NEG;
  load(row_of(0), 0, nw, nf);

  for (int s = 0; s < h; ++s) {
    const int r = row_of(s);
    const int rp = reverse ? r + 1 : r - 1;
    const bool has_prev = s > 0;
    float fr[KMAX], b[KMAX], ff[KMAX];

    // forward chain, chunks from the west
    float carry = NEG;
    for (int c = 0; c < nch; ++c) {
      const int j0 = c * chunk + tid * K;
      float wv[KMAX];
      if (c == 0) {
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          wv[k] = nw[k];
          fr[k] = nf[k];
        }
        if (s + 1 < h) load(row_of(s + 1), 0, nw, nf);
      } else {
        load(r, c, wv, fr);
      }
      bound(rp, has_prev, c, wv, fr, b);
      Clip m = identity();
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const int j = j0 + k;
        if (k < K && j < w) {
          any |= (b[k] != wv[k]);  // b <= wr, so b != wr means a change
          const float t = __fmul_rn(static_cast<float>(j), eps);
          m = compose(m, {__fsub_rn(fr[k], t), __fsub_rn(b[k], t)});
        }
      }
      Clip total;
      const Clip ex = block_prefix(m, false, tot[buf], total);
      buf ^= 1;
      float x = clip(carry, ex.lo, ex.hi);
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const int j = j0 + k;
        if (k < K && j < w) {
          const float t = __fmul_rn(static_cast<float>(j), eps);
          x = clip(x, __fsub_rn(fr[k], t), __fsub_rn(b[k], t));
          ff[k] = __fadd_rn(x, t);
          if (nch > 1) w_out[base(r) + j] = ff[k];
        }
      }
      carry = clip(carry, total.lo, total.hi);
    }

    // reverse chain, chunks from the east; the last chunk's fields are
    // still in registers
    carry = NEG;
    for (int c = nch - 1; c >= 0; --c) {
      const int j0 = c * chunk + tid * K;
      if (c != nch - 1) {
        float wv[KMAX];
        load(r, c, wv, fr);
        bound(rp, has_prev, c, wv, fr, b);
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          const int j = j0 + k;
          if (k < K && j < w) ff[k] = w_out[base(r) + j];
        }
      }
      Clip m = identity();
#pragma unroll
      for (int k = KMAX - 1; k >= 0; --k) {
        const int j = j0 + k;
        if (k < K && j < w) {
          const float t = __fmul_rn(static_cast<float>(j), eps);
          m = compose(m, {__fadd_rn(fr[k], t), __fadd_rn(b[k], t)});
        }
      }
      Clip total;
      const Clip ex = block_prefix(m, true, tot[buf], total);
      buf ^= 1;
      float x = clip(carry, ex.lo, ex.hi);
#pragma unroll
      for (int k = KMAX - 1; k >= 0; --k) {
        const int j = j0 + k;
        if (k < K && j < w) {
          const float t = __fmul_rn(static_cast<float>(j), eps);
          x = clip(x, __fadd_rn(fr[k], t), __fadd_rn(b[k], t));
          const float lat = fminf(ff[k], __fsub_rn(x, t));
          const float guard =
              guarded ? __fmul_rn(__fadd_rn(fabsf(b[k]), tmax), 0x1p-21f)
                      : 0.f;
          const float nv =
              fmaxf(fr[k], lat < __fsub_rn(b[k], guard) ? lat : b[k]);
          any |= (nv != b[k]);
          w_out[base(r) + j] = nv;
        }
      }
      carry = clip(carry, total.lo, total.hi);
    }
    __syncthreads();  // this row's new values, for the next row's reads
  }
  if (__syncthreads_or(any) && tid == 0) atomicOr(changed, 1);
}

}  // namespace

extern "C" int rd_fill_scan(const float* w_in, const float* flr,
                            float* w_out, int* changed, int h, int w,
                            float eps, float eps_diag, int reverse,
                            void* stream) {
  fill_scan_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      w_in, flr, w_out, changed, h, w, eps, eps_diag, reverse);
  return static_cast<int>(cudaGetLastError());
}
