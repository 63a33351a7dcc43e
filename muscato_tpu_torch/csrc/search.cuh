// Warp-cooperative search of a sorted array in global memory, shared by
// the kernels that locate a tile's span of a table before staging it
// (B1's index span, B2's first owning slot).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace muscato {

// First index in [lo, hi) of the sorted a with a[i] > q (strict) or
// a[i] >= q, else hi; elements are compared as Q.  The whole warp calls it
// with the same arguments; each step loads 31 pivots at once and keeps the
// 1/32 between two, so 2**24 elements take five dependent loads, not 24.
template <typename T, typename Q>
__device__ __forceinline__ long long warp_search(const T* __restrict__ a,
                                                 long long lo, long long hi,
                                                 Q q, bool strict) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long piv = lo + ((hi - lo) * (lane + 1)) / 32;  // lane 31: hi
    bool t = true;
    if (lane < 31) {
      const Q x = (Q)__ldg(a + piv);
      t = strict ? x > q : x >= q;
    }
    const int k = __ffs(__ballot_sync(full, t)) - 1;
    const long long pk = __shfl_sync(full, piv, k);
    const long long pprev = __shfl_sync(full, piv, k > 0 ? k - 1 : 0);
    if (k > 0) lo = pprev + 1;
    hi = pk;
  }
  bool t = true;
  if (lo + lane < hi) {
    const Q x = (Q)__ldg(a + lo + lane);
    t = strict ? x > q : x >= q;
  }
  const unsigned b = __ballot_sync(full, t);
  return b ? lo + __ffs(b) - 1 : hi;
}

}  // namespace muscato
