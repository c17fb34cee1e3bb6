// Row rings in shared memory for the directional sweep kernels
// (fill_sweep.cu, accum_sweep.cu).
//
// A sweep walks the rows of its column tile one after another.  Each input
// row a block needs is staged in shared memory by bulk asynchronous copies
// (cp.async.bulk, the Tensor Memory Accelerator's 1-D form), issued up to
// `stages` rows ahead by one thread of a producer warp that computes
// nothing: a copy's issue costs that thread hundreds of cycles, which no
// row step of the consumers waits for.  A stage's copies report their
// bytes to its full barrier, which every consumer waits on before it reads
// the stage (the bytes are visible to the threads that see the phase
// complete); consumer thread 0 arrives on the stage's empty barrier once
// the consumers' own barrier says that all of them are done with it, and
// the producer waits on that before it refills the stage.  The copies
// cost the consumers no registers, and no row step waits on device memory.
//
// Alignment: a bulk copy moves 16-byte-aligned spans whose length is a
// multiple of 16.  A row segment of a raster of any width, a transposed
// raster, an int8 code row, or a tensor that starts at an odd offset
// begins and ends anywhere, so each copy moves the aligned span that
// covers the segment (`covering`), and readers index the stage from the
// segment's first element's offset in that span (`lead`).  The extra bytes
// read lie in the same 16-byte granules as bytes of the raster, hence in
// mapped memory; they are never used.  A staged element has the same
// offset within its 16 bytes as in device memory, so where every row of
// the rasters starts 16-byte aligned (`rows_aligned`) the stages can be
// read as float4.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <initializer_list>

namespace rd {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Elements of one ring slot for a row segment of `cols` columns plus one
// halo column on either side: room for the aligned span that covers it
// (up to 15 bytes before and after), rounded to 16 bytes.
template <typename T>
__host__ __device__ constexpr int slot_elems(int cols) {
  return static_cast<int>(
      (((cols + 2) * sizeof(T) + 30 + 15) / 16 * 16) / sizeof(T));
}

// The aligned span that covers elements [e0, e1) of the raster at p.
struct Covering {
  const void* src;   // first byte of the span (16-byte aligned)
  uint32_t bytes;    // a multiple of 16
};

template <typename T>
__device__ __forceinline__ Covering covering(const T* p, size_t e0,
                                             size_t e1) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p + e0);
  const uintptr_t b = reinterpret_cast<uintptr_t>(p + e1);
  const uintptr_t a16 = a & ~static_cast<uintptr_t>(15);
  const uintptr_t b16 = (b + 15) & ~static_cast<uintptr_t>(15);
  return {reinterpret_cast<const void*>(a16),
          static_cast<uint32_t>(b16 - a16)};
}

// Elements of the covering span that come before element e0.
template <typename T>
__device__ __forceinline__ int lead(const T* p, size_t e0) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p + e0) & 15) /
                          sizeof(T));
}

// Whether every row of `w` elements of `size` bytes starts 16-byte
// aligned in each raster at the given addresses.
inline bool rows_aligned(int w, int size,
                         std::initializer_list<const void*> rasters) {
  uintptr_t bits = 0;
  for (const void* p : rasters) bits |= reinterpret_cast<uintptr_t>(p);
  return (bits & 15) == 0 && (static_cast<size_t>(w) * size) % 16 == 0;
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy.
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also announces `bytes` of copies to come.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const Covering& c,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(c.src), "r"(c.bytes), "r"(smem_addr(bar))
      : "memory");
}

// One arrival, no bytes.
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Barrier 1 over the first `threads` threads of the block: the consumers,
// without the producer warp.
__device__ __forceinline__ void sync_consumers(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Dynamic shared memory of a sweep block: the stages' full and empty
// barriers, the two rows of new values (a halo column on either side and
// room to start them 16 bytes in), then the ring: `stages` stages, each
// holding one slot per staged raster.
struct Layout {
  int prev, ring, bytes;
};

__host__ __device__ constexpr Layout layout(int stages, int cols,
                                            int stage_bytes) {
  return {16 * stages, 16 * stages + 2 * (cols + 8) * 4,
          16 * stages + 2 * (cols + 8) * 4 + stages * stage_bytes};
}

}  // namespace rd
