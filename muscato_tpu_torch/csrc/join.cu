// B1 sorted_join: lo[i] = #{skeys < q[i]}, cnt[i] = #{skeys == q[i]}.
//
// Replaces muscato_tpu/ops/pallas_join.py:sorted_join (Pallas kernel
// _kernel).  The TPU kernel DMAs the index window that a 1024-query block
// covers into VMEM and resolves each query there with byte-plane one-hot
// matmuls, with an overflow flag when the window is too small.  The idea of
// the window carries over; the matmuls and the flag do not.
//
// Bytes bound it: the index is read once (4 V bytes), the queries once and
// both outputs written once (12 Q bytes); at the flagship (V = 98.1M,
// Q = 16.8M) that is 593.6 MB.  A CTA takes a tile of kJoinTile queries,
// reduces their min and max as uint32, and finds L = lower_bound(min) and
// H = upper_bound(max) with one warp-cooperative 32-ary search each
// (search.cuh; about six dependent loads over 98M keys, not 27).  Every
// lane's lo and lo + cnt
// lie in [L, H].  When H - L <= kJoinSpan, one bulk async copy (bulk.cuh)
// stages skeys[L, H) in shared memory, so the index is read about once in
// total (a flagship tile spans ~3,000 keys), and each query's lower bound
// is a binary search there and its upper bound a galloping search from the
// lower bound.  A tile whose span exceeds kJoinSpan (a long run of equal
// keys that its queries hit, or queries far apart) searches global memory
// inside [L, H] the same way, in the same kernel, so every lane is exact.
// Nothing depends on the queries being sorted: min and max bound any order.
//
// Keys are stored as int32 bit patterns by the caller and read here as
// uint32_t, so the comparison is the unsigned one the index was sorted by.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bulk.cuh"
#include "search.cuh"

namespace {

constexpr int kJoinThreads = 256;
constexpr int kJoinPerThread = 2;
constexpr int kJoinTile = kJoinThreads * kJoinPerThread;  // queries per CTA
// Staged keys: 6,144 (24 KB), plus the 16-byte rounding at both ends; a
// flagship tile spans ~3,000 keys.  Small tiles let eight CTAs share an
// SM, and more tiles in flight hide the searches' latency better than
// fewer, larger ones.  It also stays within the 48 KB a CTA gets without
// opting in.
constexpr int kJoinSpan = 6144;
constexpr int kJoinSmemBytes = (kJoinSpan + 8) * 4;
static_assert(kJoinSmemBytes + 1024 <= 48 * 1024, "stage within the default 48 KB");

// First index in [lo, hi) with a[i] >= q, or hi.
template <typename Idx>
__device__ __forceinline__ Idx lower_bound_u32(const uint32_t* a, Idx lo, Idx hi,
                                               uint32_t q) {
  while (lo < hi) {
    const Idx mid = lo + ((hi - lo) >> 1);
    if (a[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First index in [lo, hi) with a[i] > q, or hi.  Called with lo = q's
// lower bound: it gallops over the run of keys equal to q, then bisects.
template <typename Idx>
__device__ __forceinline__ Idx upper_bound_from(const uint32_t* a, Idx lo, Idx hi,
                                                uint32_t q) {
  for (Idx step = 1; lo < hi; step <<= 1) {
    const Idx probe = lo + step - 1;
    if (probe >= hi) break;
    if (a[probe] > q) {
      hi = probe;
      break;
    }
    lo = probe + 1;
  }
  while (lo < hi) {
    const Idx mid = lo + ((hi - lo) >> 1);
    if (a[mid] <= q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kJoinThreads)
    sorted_join_kernel(const uint32_t* __restrict__ skeys, long long v,
                       const uint32_t* __restrict__ q, long long m,
                       int32_t* __restrict__ lo, int32_t* __restrict__ cnt) {
  extern __shared__ __align__(16) uint32_t s_keys[];
  __shared__ uint32_t s_min[kJoinThreads / 32], s_max[kJoinThreads / 32];
  __shared__ long long s_lh[2];
  __shared__ __align__(8) uint64_t s_bar;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q0 = (long long)blockIdx.x * kJoinTile;

  // The tile's queries and their min and max; lanes past m stay out.
  uint32_t mine[kJoinPerThread];
  uint32_t kmin = UINT_MAX, kmax = 0;
#pragma unroll
  for (int k = 0; k < kJoinPerThread; ++k) {
    const long long i = q0 + tid + k * kJoinThreads;
    mine[k] = 0;
    if (i < m) {
      mine[k] = __ldg(q + i);
      kmin = min(kmin, mine[k]);
      kmax = max(kmax, mine[k]);
    }
  }
  kmin = __reduce_min_sync(0xffffffffu, kmin);
  kmax = __reduce_max_sync(0xffffffffu, kmax);
  if (lane == 0) {
    s_min[warp] = kmin;
    s_max[warp] = kmax;
  }
  __syncthreads();
  // Warp 0: L = lower_bound(min); warp 1: H = upper_bound(max).
  if (warp < 2) {
    uint32_t x = warp == 0 ? s_min[0] : s_max[0];
#pragma unroll
    for (int w = 1; w < kJoinThreads / 32; ++w)
      x = warp == 0 ? min(x, s_min[w]) : max(x, s_max[w]);
    const long long r = muscato::warp_search(skeys, 0, v, x, warp == 1);
    if (lane == 0) s_lh[warp] = r;
  }
  __syncthreads();
  const long long L = s_lh[0], H = s_lh[1];

  if (muscato::kStage && H - L <= kJoinSpan) {
    bool bulk = false;
    const long long base =
        muscato::stage_words(skeys, v, L, H, s_keys, &s_bar, &bulk);
    __syncthreads();
    muscato::stage_wait(&s_bar, bulk);
    const uint32_t* s = s_keys + (L - base);  // s[i] = skeys[L + i]
    const int n = (int)(H - L);
#pragma unroll
    for (int k = 0; k < kJoinPerThread; ++k) {
      const long long i = q0 + tid + k * kJoinThreads;
      if (i < m) {
        const int a = lower_bound_u32(s, 0, n, mine[k]);
        const int b = upper_bound_from(s, a, n, mine[k]);
        lo[i] = (int32_t)(L + a);
        cnt[i] = b - a;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kJoinPerThread; ++k) {
      const long long i = q0 + tid + k * kJoinThreads;
      if (i < m) {
        const long long a = lower_bound_u32(skeys, L, H, mine[k]);
        const long long b = upper_bound_from(skeys, a, H, mine[k]);
        lo[i] = (int32_t)a;
        cnt[i] = (int32_t)(b - a);
      }
    }
  }
}

}  // namespace

extern "C" int muscato_sorted_join(const void* skeys, long long v,
                                   const void* qkeys, long long m, void* lo,
                                   void* cnt, void* stream) {
  if (m > 0) {
    const long long blocks = (m + kJoinTile - 1) / kJoinTile;
    sorted_join_kernel<<<(unsigned)blocks, kJoinThreads,
                         muscato::kStage ? kJoinSmemBytes : 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)skeys, v, (const uint32_t*)qkeys, m, (int32_t*)lo,
        (int32_t*)cnt);
  }
  return (int)cudaGetLastError();
}
