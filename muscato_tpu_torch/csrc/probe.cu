// B8 direct_probe_kernel and B9 binary_probe_kernel: the search probe's two
// bodies.  For each query of the key-sorted batch (key1, key2, valid) they
// write counts[i], the number of index windows with the query's key (0 for
// an invalid query or a miss), and loc[i], where that key's run starts in
// the sorted index.
//
// They replace two XLA bodies of the JAX package, which has no Pallas
// kernel for them:
//   B8  muscato_tpu/ops/fused.py:595 _probe_windows_direct_impl, its
//       per-chunk body _chunk (:626-651) under lax.map;
//   B9  muscato_tpu/ops/search.py:70 searchsorted2_bucketed and the hit
//       test of fused.py:674 _probe_windows_search_impl.
// On the CPU the port runs their plain twins, ops/search.py
// direct_probe_torch and binary_probe_torch, which these equal bit for bit.
//
// B8 reads the index's SearchAux in direct mode: sbucket (2^bits + 1 int32
// bounds) and urec, 16-byte records (k1, k2, start, count) of the unique
// keys in key order, 16 padding records after them.  The table is sized so
// that no bucket holds more than 16 records.  One thread takes one query:
// its bucket from the key's top bits (as ops/search.py bucket_of), the
// bucket's two bounds, then at most `width` records as uint4 loads; a
// record that matches k1 (and k2 when the width uses it) adds its count and
// its start.  Both are sums over every hit, as the twin computes them, so
// the kernel agrees with the twin whatever the number of hits; the count is
// 0 for an invalid query, the start sum is not masked (the twin's).  The
// twin's (C, 16, 4) record gather, its masks and its chunk loop are gone.
//
// B9 reads the binary mode's arrays: sbucket, ukk (the unique keys as
// interleaved (k1, k2) pairs, read as uint2), ustart and ucount.  One
// thread a query runs at most `steps` rounds of the twin's branchless left
// search from the bucket's bounds; once lo == hi a round changes nothing,
// so the loop ends there.  Then the twin's hit test at min(lo, n - 1).
//
// Bytes bound both (about 50-100 a query: the 12 bytes of the query, the
// 8 of its bucket bounds, its bucket's records or search steps, 8 out),
// or rather the card's rate for scattered 32-byte sectors: the queries are
// sorted, so neighbouring threads read neighbouring bucket bounds, but at
// the flagship 2^20 queries spread over 2^25 buckets, so each query's
// records are a sector of their own.  Integer work is a few compares a
// record.  Keys are uint32 (the caller's int32 bit patterns) and compare as
// such: no sign flip.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kProbeThreads = 256;
constexpr int kMaxDirectWidth = 16;  // engine/index.py DIRECT_BUCKET_WIDTH
constexpr int kMaxProbeSteps = 32;

__device__ __forceinline__ uint32_t bucket_of(uint32_t key, int upshift, int bits) {
  return (key << upshift) >> (32 - bits);
}

__global__ void __launch_bounds__(kProbeThreads)
direct_probe_kernel(const uint32_t* __restrict__ keyf, const uint32_t* __restrict__ key2f,
                    const uint8_t* __restrict__ validf, long long nq,
                    const uint4* __restrict__ urec, const int32_t* __restrict__ sbucket,
                    int upshift, int bits, int width, int use_k2,
                    int32_t* __restrict__ counts, int32_t* __restrict__ loc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const uint32_t k1 = __ldg(keyf + i);
  const uint32_t k2 = use_k2 ? __ldg(key2f + i) : 0u;
  const uint32_t b = bucket_of(k1, upshift, bits);
  const int lo = __ldg(sbucket + b);
  const int nb = min(__ldg(sbucket + b + 1) - lo, width);
  uint32_t c = 0, s = 0;
  for (int j = 0; j < nb; ++j) {
    const uint4 r = __ldg(urec + lo + j);
    if (r.x == k1 && (!use_k2 || r.y == k2)) {
      c += r.w;
      s += r.z;
    }
  }
  counts[i] = __ldg(validf + i) ? (int32_t)c : 0;
  loc[i] = (int32_t)s;
}

__global__ void __launch_bounds__(kProbeThreads)
binary_probe_kernel(const uint32_t* __restrict__ keyf, const uint32_t* __restrict__ key2f,
                    const uint8_t* __restrict__ validf, long long nq,
                    const uint2* __restrict__ ukk, const int32_t* __restrict__ ustart,
                    const int32_t* __restrict__ ucount, uint32_t n,
                    const int32_t* __restrict__ sbucket, int upshift, int bits, int steps,
                    int use_k2, int32_t* __restrict__ counts, int32_t* __restrict__ loc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const uint32_t k1 = __ldg(keyf + i);
  const uint32_t k2 = use_k2 ? __ldg(key2f + i) : 0u;
  const uint32_t b = bucket_of(k1, upshift, bits);
  // Bounds are at most n < 2^31, so lo + hi fits in 32 bits.
  uint32_t lo = __ldg(sbucket + b), hi = __ldg(sbucket + b + 1);
  const uint32_t last = n - 1;
  for (int step = 0; step < steps && lo < hi; ++step) {
    const uint32_t mid = (lo + hi) >> 1;  // < hi, so no clamp needed
    const uint2 m = __ldg(ukk + mid);
    if (m.x < k1 || (use_k2 && m.x == k1 && m.y < k2)) lo = mid + 1; else hi = mid;
  }
  const uint32_t at = min(lo, last);
  const uint2 e = __ldg(ukk + at);
  const bool hit = __ldg(validf + i) && lo < n && e.x == k1 && (!use_k2 || e.y == k2);
  counts[i] = hit ? __ldg(ucount + at) : 0;
  loc[i] = hit ? __ldg(ustart + at) : 0;
}

bool bad_bits(int upshift, int bits) {
  return upshift < 0 || upshift > 31 || bits < 1 || bits > 31;
}

unsigned blocks_for(long long nq) {
  return (unsigned)((nq + kProbeThreads - 1) / kProbeThreads);
}

}  // namespace

// counts, loc (nq int32 each) of the sorted queries against a direct-mode
// aux.  Refuses a width past kMaxDirectWidth, records not 16-byte aligned
// and bucket bits or shifts outside 32 bits.
extern "C" int muscato_direct_probe(const void* keyf, const void* key2f, const void* validf,
                                    long long nq, const void* urec, const void* sbucket,
                                    int upshift, int bits, int width, int use_k2,
                                    void* counts, void* loc, void* stream) {
  if (width < 0 || width > kMaxDirectWidth || bad_bits(upshift, bits) ||
      ((uintptr_t)urec & 15) != 0 || nq < 0 || (nq + kProbeThreads - 1) / kProbeThreads > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (nq > 0)
    direct_probe_kernel<<<blocks_for(nq), kProbeThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)keyf, (const uint32_t*)key2f, (const uint8_t*)validf, nq,
        (const uint4*)urec, (const int32_t*)sbucket, upshift, bits, width, use_k2,
        (int32_t*)counts, (int32_t*)loc);
  return (int)cudaGetLastError();
}

// counts, loc (nq int32 each) of the sorted queries against a binary-mode
// aux of nuniq unique keys.  Refuses an empty or 2^31-key table, steps
// outside [0, kMaxProbeSteps], ukk not 8-byte aligned and bucket bits or
// shifts outside 32 bits.
extern "C" int muscato_binary_probe(const void* keyf, const void* key2f, const void* validf,
                                    long long nq, const void* ukk, const void* ustart,
                                    const void* ucount, long long nuniq, const void* sbucket,
                                    int upshift, int bits, int steps, int use_k2,
                                    void* counts, void* loc, void* stream) {
  if (nuniq < 1 || nuniq > INT_MAX || steps < 0 || steps > kMaxProbeSteps ||
      bad_bits(upshift, bits) || ((uintptr_t)ukk & 7) != 0 || nq < 0 ||
      (nq + kProbeThreads - 1) / kProbeThreads > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (nq > 0)
    binary_probe_kernel<<<blocks_for(nq), kProbeThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)keyf, (const uint32_t*)key2f, (const uint8_t*)validf, nq,
        (const uint2*)ukk, (const int32_t*)ustart, (const int32_t*)ucount,
        (uint32_t)nuniq, (const int32_t*)sbucket, upshift, bits, steps, use_k2,
        (int32_t*)counts, (int32_t*)loc);
  return (int)cudaGetLastError();
}
