// Hopper helpers shared by the kernels that stage a span of a table in
// shared memory: a 1-D bulk async copy (cp.async.bulk, the TMA's linear
// form) completed on an mbarrier.
//
// A bulk copy needs a 16-byte-aligned global source, a 16-byte-aligned
// shared destination and a byte count that is a multiple of 16.  Callers
// round the span's start down and its end up to 16 bytes, clip the end to
// the last whole 16 bytes of the table, and load what is left plainly.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace muscato {

// Built with -DMUSCATO_NO_STAGE, the kernels never stage a span and read
// every tile from global memory: chip_smoke.py builds that variant beside
// the real one to time what staging gains.
#ifdef MUSCATO_NO_STAGE
constexpr bool kStage = false;
#else
constexpr bool kStage = true;
#endif

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One thread initialises the barrier for one arrival (the thread that
// issues the copy) before any other thread touches it.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(1u)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Copy `bytes` (a multiple of 16, > 0) from global `src` to shared `dst`,
// both 16-byte aligned; the barrier's phase completes when they land.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n\t"
      "}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ long long round_up4(long long w) {
  return (w + 3) & ~3LL;
}

// Stage table words [w0, w1) of a 4-byte-word table of `total` words in
// shared memory `s` (16-byte aligned, room for round_up4(w1) - (w0 & ~3)
// words): word w lands at s[w - base], where the returned base is w0
// rounded down to 16 bytes when the table is 16-byte aligned, and w0 when
// it is not (then every word is loaded plainly).  Thread 0 issues the bulk
// copy of the aligned middle; all threads load the rest.  The caller waits
// with stage_wait after a __syncthreads().  Returns the staged base and
// sets *bulk to whether a copy is in flight.
__device__ __forceinline__ long long stage_words(
    const uint32_t* __restrict__ table, long long total, long long w0,
    long long w1, uint32_t* s, uint64_t* bar, bool* bulk) {
  const bool aligned = ((uintptr_t)table & 15) == 0;
  const long long base = aligned ? (w0 & ~3LL) : w0;
  // The bulk part [base, a1): whole 16-byte groups inside the table.
  long long a1 = aligned ? min(round_up4(w1), total & ~3LL) : base;
  if (w1 <= w0) a1 = base;  // nothing to stage
  *bulk = a1 > base;
  if (*bulk && threadIdx.x == 0) {
    mbar_init(bar);
    bulk_load(s, table + base, (unsigned)((a1 - base) * 4), bar);
  }
  // Words the copy does not cover: the clipped tail, or all of them.
  for (long long w = max(a1, w0) + threadIdx.x; w < w1; w += blockDim.x)
    s[w - base] = __ldg(table + w);
  return base;
}

// After a __syncthreads() that follows stage_words: the bulk copy (if any)
// has landed once this returns.  One tile per CTA, so phase 0.
__device__ __forceinline__ void stage_wait(uint64_t* bar, bool bulk) {
  if (bulk) mbar_wait(bar, 0);
}

}  // namespace muscato
