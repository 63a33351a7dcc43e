// B2 expand_owners: for each pair lane p < pair_cap, its owning slot
// owner(p) = last s with oexcl[s] <= p (clipped to [0, m)), and emits
//   qid_out[p]  = qid[owner]
//   sidx_out[p] = lo[owner] + (p - oexcl[owner]).
//
// Replaces muscato_tpu/ops/pallas_expand.py:expand_owners (Pallas kernel
// _kernel; the 128-lane variant _kernel_sub computes the same function).
// The TPU kernel ranks each lane against a VMEM window of slot offsets with
// compares and one-hot matmuls, because scatters and per-lane gathers are
// slow there.  Here each lane is one thread that runs an upper-bound binary
// search over the nondecreasing exclusive prefix sum `oexcl`.
//
// Bound on the card: memory latency of the search (log2(m) ~ 24 dependent
// loads at m = 16M slots).  Consecutive lanes belong to the same or
// neighbouring slots, so a warp's search paths coincide and mostly hit L1/L2;
// the outputs are written fully coalesced.  Lanes past the pair total land on
// the last slot (its oexcl is the total), exactly as the numpy oracle
// expand_owners_np does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void expand_owners_kernel(const int32_t* __restrict__ oexcl,
                                     const int32_t* __restrict__ lo,
                                     const int32_t* __restrict__ qid,
                                     long long m, long long pair_cap,
                                     int32_t* __restrict__ qid_out,
                                     int32_t* __restrict__ sidx_out) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pair_cap) return;
  long long a = 0, b = m;
  while (a < b) {
    long long mid = a + ((b - a) >> 1);
    if ((long long)__ldg(oexcl + mid) <= p) a = mid + 1; else b = mid;
  }
  long long o = a - 1;
  if (o < 0) o = 0;
  if (o > m - 1) o = m - 1;
  qid_out[p] = __ldg(qid + o);
  sidx_out[p] = (int32_t)((long long)__ldg(lo + o) + (p - (long long)__ldg(oexcl + o)));
}

}  // namespace

extern "C" int muscato_expand_owners(const void* oexcl, const void* lo,
                                     const void* qid, long long m,
                                     long long pair_cap, void* qid_out,
                                     void* sidx_out, void* stream) {
  if (pair_cap > 0 && m > 0) {
    const int threads = 256;
    long long blocks = (pair_cap + threads - 1) / threads;
    expand_owners_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)oexcl, (const int32_t*)lo, (const int32_t*)qid, m,
        pair_cap, (int32_t*)qid_out, (int32_t*)sidx_out);
  }
  return (int)cudaGetLastError();
}
