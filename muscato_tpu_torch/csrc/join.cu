// B1 sorted_join: lo[i] = #{skeys < q[i]}, cnt[i] = #{skeys == q[i]}.
//
// Replaces muscato_tpu/ops/pallas_join.py:sorted_join (Pallas kernel
// _kernel).  The TPU kernel DMAs one index window per 1024-query block and
// resolves each query with byte-plane one-hot matmuls on the MXU; none of
// that carries over.  Here every query is one thread that runs a lower- and
// an upper-bound binary search over the sorted uint32 index.
//
// Bound on the card: memory latency.  Each search step is one dependent
// 4-byte load from a ~400 MB index (log2(V) ~ 27 steps at V = 98M).  The
// queries arrive sorted, so neighbouring threads walk the same search path:
// the top levels of the tree stay in L1/L2 and a warp's loads mostly hit
// the same lines.  The upper bound starts from the lower bound, so it only
// searches the equal run and the tail.
//
// Keys are stored as int32 bit patterns by the caller and read here as
// uint32_t, so the comparison is the unsigned one the index was sorted by.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long lower_bound_u32(
    const uint32_t* __restrict__ a, long long lo, long long hi, uint32_t q) {
  while (lo < hi) {
    long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long upper_bound_u32(
    const uint32_t* __restrict__ a, long long lo, long long hi, uint32_t q) {
  while (lo < hi) {
    long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) <= q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void sorted_join_kernel(const uint32_t* __restrict__ skeys,
                                   long long v,
                                   const uint32_t* __restrict__ q,
                                   long long m,
                                   int32_t* __restrict__ lo,
                                   int32_t* __restrict__ cnt) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint32_t k = q[i];
  long long l = lower_bound_u32(skeys, 0, v, k);
  long long h = upper_bound_u32(skeys, l, v, k);
  lo[i] = (int32_t)l;
  cnt[i] = (int32_t)(h - l);
}

}  // namespace

extern "C" int muscato_sorted_join(const void* skeys, long long v,
                                   const void* qkeys, long long m, void* lo,
                                   void* cnt, void* stream) {
  if (m > 0) {
    const int threads = 256;
    long long blocks = (m + threads - 1) / threads;
    sorted_join_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)skeys, v, (const uint32_t*)qkeys, m, (int32_t*)lo,
        (int32_t*)cnt);
  }
  return (int)cudaGetLastError();
}
