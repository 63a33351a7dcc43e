// B2 expand_owners: for each pair lane p < pair_cap, its owning slot
// owner(p) = last s with oexcl[s] <= p (clipped to [0, m)), and emits
//   qid_out[p]  = qid[owner]
//   sidx_out[p] = lo[owner] + (p - oexcl[owner]).
//
// Two kernels compute this function:
//   expand_owners_kernel (B2) replaces muscato_tpu/ops/pallas_expand.py:
//     expand_owners, Pallas kernel _kernel;
//   expand_owners_sub_kernel (B6) replaces the same function with
//     subchunk=True, Pallas kernel _kernel_sub (see below).
// The TPU kernels rank each lane against a VMEM window of slot offsets with
// compares and one-hot matmuls, because scatters and per-lane gathers are
// slow there.  In B2 each lane is one thread that runs an upper-bound binary
// search over the nondecreasing exclusive prefix sum `oexcl`.
//
// Bound on the card: memory latency of the search (log2(m) ~ 24 dependent
// loads at m = 16M slots).  Consecutive lanes belong to the same or
// neighbouring slots, so a warp's search paths coincide and mostly hit L1/L2;
// the outputs are written fully coalesced.  Lanes past the pair total land on
// the last slot (its oexcl is the total), exactly as the numpy oracle
// expand_owners_np does.

#include <climits>
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

// B6: the sub-chunked expand.  The TPU kernel _kernel_sub ranks 128-lane
// sub-chunks against a slot window staged in VMEM.  Here the slot window
// goes to shared memory: each CTA owns kSubLanes consecutive lanes, finds
// the owners of its first and last lane with one global search each,
// stages oexcl, lo and qid of that slot span with coalesced loads, and each
// thread then searches in shared memory.  A span longer than kSubTile
// (an interior run of empty slots, or the lanes past the pair total, which
// all belong to the last slot of the dead tail) is staged only up to the
// tile: lanes whose owner lies beyond it search global memory, so the
// kernel is exact on every lane and has no window to overflow (the TPU
// kernel's lookback limit is not carried over).
//
// Bound on the card: memory bandwidth of the slot reads (the staged span,
// read once) and the two output streams; the per-lane search runs in
// shared memory.  Correctness of the staged search: every slot before the
// span has oexcl <= the CTA's first lane, and every slot after the staged
// part has oexcl >= `lim` > the lane, so the global upper bound of a lane
// is the span start plus its upper bound within the staged part.

constexpr int kSubThreads = 256;
constexpr int kSubLanesPerThread = 4;
constexpr int kSubLanes = kSubThreads * kSubLanesPerThread;
constexpr int kSubTile = 2048;  // staged slots (24 KB of shared memory)

// First index in [a, b) whose oexcl exceeds p (b if none).
__device__ __forceinline__ long long upper_bound_global(
    const int32_t* __restrict__ oexcl, long long a, long long b, long long p) {
  while (a < b) {
    long long mid = a + ((b - a) >> 1);
    if ((long long)__ldg(oexcl + mid) <= p) a = mid + 1; else b = mid;
  }
  return a;
}

__device__ __forceinline__ long long clip_owner(long long o, long long m) {
  return o < 0 ? 0 : (o > m - 1 ? m - 1 : o);
}

__global__ void expand_owners_sub_kernel(const int32_t* __restrict__ oexcl,
                                         const int32_t* __restrict__ lo,
                                         const int32_t* __restrict__ qid,
                                         long long m, long long pair_cap,
                                         int32_t* __restrict__ qid_out,
                                         int32_t* __restrict__ sidx_out) {
  __shared__ int32_t s_oex[kSubTile];
  __shared__ int32_t s_lo[kSubTile];
  __shared__ int32_t s_qid[kSubTile];
  __shared__ long long s_first, s_last, s_lim;

  const long long p0 = (long long)blockIdx.x * kSubLanes;
  const long long p1 = min(p0 + kSubLanes, pair_cap) - 1;  // last lane
  if (threadIdx.x == 0)
    s_first = clip_owner(upper_bound_global(oexcl, 0, m, p0) - 1, m);
  if (threadIdx.x == 32)
    s_last = clip_owner(upper_bound_global(oexcl, 0, m, p1) - 1, m);
  __syncthreads();
  const long long first = s_first;
  const long long span = s_last - first + 1;
  const int n = (int)min(span, (long long)kSubTile);
  for (int i = threadIdx.x; i < n; i += kSubThreads) {
    s_oex[i] = __ldg(oexcl + first + i);
    s_lo[i] = __ldg(lo + first + i);
    s_qid[i] = __ldg(qid + first + i);
  }
  if (threadIdx.x == 0)
    s_lim = n < span ? (long long)__ldg(oexcl + first + n) : LLONG_MAX;
  __syncthreads();
  const long long lim = s_lim;

  for (int j = 0; j < kSubLanesPerThread; ++j) {
    const long long p = p0 + threadIdx.x + (long long)j * kSubThreads;
    if (p >= pair_cap) break;
    int32_t q, l, oe;
    if (p < lim) {
      int a = 0, b = n;
      while (a < b) {
        int mid = (a + b) >> 1;
        if ((long long)s_oex[mid] <= p) a = mid + 1; else b = mid;
      }
      // a >= 1 unless first == 0 and oexcl[0] > p, where the owner clips
      // to slot 0 == first.
      const int li = (int)(clip_owner(first + a - 1, m) - first);
      q = s_qid[li];
      l = s_lo[li];
      oe = s_oex[li];
    } else {
      const long long o =
          clip_owner(upper_bound_global(oexcl, first + n, m, p) - 1, m);
      q = __ldg(qid + o);
      l = __ldg(lo + o);
      oe = __ldg(oexcl + o);
    }
    qid_out[p] = q;
    sidx_out[p] = (int32_t)((long long)l + (p - (long long)oe));
  }
}

}  // namespace

extern "C" int muscato_expand_owners_sub(const void* oexcl, const void* lo,
                                         const void* qid, long long m,
                                         long long pair_cap, void* qid_out,
                                         void* sidx_out, void* stream) {
  if (pair_cap > 0 && m > 0) {
    long long blocks = (pair_cap + kSubLanes - 1) / kSubLanes;
    expand_owners_sub_kernel<<<(unsigned)blocks, kSubThreads, 0,
                               (cudaStream_t)stream>>>(
        (const int32_t*)oexcl, (const int32_t*)lo, (const int32_t*)qid, m,
        pair_cap, (int32_t*)qid_out, (int32_t*)sidx_out);
  }
  return (int)cudaGetLastError();
}

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
