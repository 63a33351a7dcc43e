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
// that no bucket holds more than 16 records.  A record that matches k1
// (and k2 when the width uses it) adds its count and its start.  Both are
// sums over every hit, as the twin computes them, so the kernel agrees with
// the twin whatever the number of hits; the count is 0 for an invalid
// query, the start sum is not masked (the twin's).
//
// B9 reads the binary mode's arrays: sbucket, ukk (the unique keys as
// interleaved (k1, k2) pairs, read as uint2) and usc, each key's run
// (start, count) as an interleaved pair (SearchAux's ustart and ucount are
// its two columns).  Its result is the twin's: the left insertion point
// that `steps` rounds of the branchless binary search from the bucket's
// bounds reach, then the hit test at min(lo, n - 1).
//
// Bytes bound both (about 50-100 a query: the 12 bytes of the query, the
// 8 of its bucket bounds, its bucket's records or search steps, 8 out), or
// rather the card's rate for scattered 32-byte sectors: at the flagship
// 2^20 sorted queries spread over 2^25 buckets, so each query's records
// are sectors of their own.  Integer work is a few compares a record.
// Keys are uint32 (the caller's int32 bit patterns) and compare as such.
//
// The first design (the -DMUSCATO_NO_STAGE build keeps it, as
// direct_probe_thread_kernel and binary_probe_thread_kernel) runs one
// thread a query, so each query is one chain of dependent loads: its key,
// its bucket's bounds, then B8's records one after another in a loop whose
// trip count is data, or B9's `steps` rounds of one key pair each, then
// the key at the insertion point, then its count and its start.  On an
// H100 at the flagship's 2^20 queries neither kernel waits on that chain
// alone: there are queries enough in flight to hide much of it, and the
// time follows the scattered 32-byte sectors the loads touch and the
// rounds that wait on one another.  This design:
//  - B8 (kDirectGroup = 4 lanes a query): the group's first lane reads the
//    two bounds; then every lane loads its own records j = lane, lane + 4,
//    ... (j < the bucket's count) at once, so the whole bucket arrives in
//    one round; the lanes' sums meet by __shfl_xor_sync (a uint32 sum, so
//    the order of the adds does not matter) and the first lane writes.  It
//    reads the sectors the first design reads, none of them waiting on
//    another.  Lanes past the last query run empty buckets, so that every
//    lane of a warp reaches the shuffles.
//  - B9 (one thread a query) reads kBinaryWindow = 4 consecutive key pairs
//    a round, one 32-byte sector, aligned to the window, around a guess:
//    where the keys are hashes, the first kInterpolatedRounds rounds place
//    the query's key1 image (key << upshift) between the images known to
//    bound the range (the bucket's, then those of the pairs that ended the
//    last round); other rounds, and every round over keys that are not
//    hashes, take the middle.  The widths with a second key word (use_k2)
//    are exactly those whose key1 is a multiplicative hash of the window,
//    spread evenly over a bucket (ops/windows.py uses_second_key,
//    key_multiplier); narrower widths key the window's exact base-5 code,
//    whose spread follows the genome's composition, so a guess placed by
//    interpolation misses there (chip_smoke.py's AT-rich index: slower
//    than the first design on an H100).  The pairs' "below the query" bits
//    are a prefix of c (the keys are sorted): 0 < c < W puts the insertion
//    point p between two loaded pairs, and c = 0 or W leaves the range on
//    one side of the window.  The search ends at the exact insertion point
//    p.  The twin's `steps` rounds reach p whenever the bucket fits them,
//    as the aux's probe_steps (the bit length of its largest bucket) makes
//    every bucket do; for any `steps` the kernel replays the twin's rounds
//    on indices alone (mid < p is the twin's "key at mid below the
//    query"), no load, so it is exact for every `steps` the launcher
//    takes.  The pair that closed the range from above at p told whether
//    the key at p equals the query, so a hit loads only its (start,
//    count), one 8-byte load; a query whose range never closed from above
//    (p at the bucket's end) loads the key at p first.  An invalid query
//    searches nothing: the twin gives it 0 and 0 whatever its search
//    finds.
// Groups of lanes a query were slower for B9 on an H100 (a group divides
// the queries in flight, which hide the loads' latency), and so was a
// (W+1)-ary search of spread probes, which reads W sectors in its first
// round.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bulk.cuh"

namespace {

constexpr int kProbeThreads = 256;
constexpr int kMaxDirectWidth = 16;  // engine/index.py DIRECT_BUCKET_WIDTH
constexpr int kMaxProbeSteps = 32;
constexpr int kDirectGroup = 4;        // B8's lanes a query
constexpr int kBinaryWindow = 4;       // B9's key pairs a round, one 32-byte sector
constexpr int kInterpolatedRounds = 2;  // B9's rounds that guess by interpolation

__device__ __forceinline__ uint32_t bucket_of(uint32_t key, int upshift, int bits) {
  return (key << upshift) >> (32 - bits);
}

__device__ __forceinline__ bool key_below(uint2 e, uint32_t k1, uint32_t k2, int use_k2) {
  return e.x < k1 || (use_k2 && e.x == k1 && e.y < k2);
}

__device__ __forceinline__ bool key_equal(uint2 e, uint32_t k1, uint32_t k2, int use_k2) {
  return e.x == k1 && (!use_k2 || e.y == k2);
}

// The mask, for the *_sync intrinsics, of this thread's group of
// kDirectGroup lanes within its warp.
__device__ __forceinline__ unsigned group_mask() {
  constexpr unsigned G = kDirectGroup;
  return ((1u << G) - 1u) << ((threadIdx.x & 31u) & ~(G - 1));
}

__global__ void __launch_bounds__(kProbeThreads)
direct_probe_kernel(const uint32_t* __restrict__ keyf, const uint32_t* __restrict__ key2f,
                    const uint8_t* __restrict__ validf, long long nq,
                    const uint4* __restrict__ urec, const int32_t* __restrict__ sbucket,
                    int upshift, int bits, int width, int use_k2,
                    int32_t* __restrict__ counts, int32_t* __restrict__ loc) {
  constexpr int G = kDirectGroup;
  constexpr int kPer = kMaxDirectWidth / G;  // records a lane at most
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int lane = threadIdx.x % G;
  const unsigned gmask = group_mask();
  const bool live = i < nq;
  uint32_t k1 = 0, k2 = 0;
  int lo = 0, nb = 0;
  if (live) {
    k1 = __ldg(keyf + i);
    k2 = use_k2 ? __ldg(key2f + i) : 0u;
    if (lane == 0) {
      const uint32_t b = bucket_of(k1, upshift, bits);
      lo = __ldg(sbucket + b);
      nb = min(__ldg(sbucket + b + 1) - lo, width);
    }
  }
  lo = __shfl_sync(gmask, lo, 0, G);
  nb = __shfl_sync(gmask, nb, 0, G);
  // Every record load is issued before any is used.
  uint4 r[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    r[k] = lane + k * G < nb ? __ldg(urec + lo + lane + k * G) : make_uint4(0, 0, 0, 0);
  uint32_t c = 0, s = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (lane + k * G < nb && r[k].x == k1 && (!use_k2 || r[k].y == k2)) {
      c += r[k].w;
      s += r[k].z;
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    c += __shfl_xor_sync(gmask, c, off, G);
    s += __shfl_xor_sync(gmask, s, off, G);
  }
  if (live && lane == 0) {
    counts[i] = __ldg(validf + i) ? (int32_t)c : 0;
    loc[i] = (int32_t)s;
  }
}

__global__ void __launch_bounds__(kProbeThreads)
binary_probe_kernel(const uint32_t* __restrict__ keyf, const uint32_t* __restrict__ key2f,
                    const uint8_t* __restrict__ validf, long long nq,
                    const uint2* __restrict__ ukk, const int2* __restrict__ usc, uint32_t n,
                    const int32_t* __restrict__ sbucket, int upshift, int bits, int steps,
                    int use_k2, int32_t* __restrict__ counts, int32_t* __restrict__ loc) {
  constexpr int W = kBinaryWindow;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const uint32_t k1 = __ldg(keyf + i);
  const uint32_t k2 = use_k2 ? __ldg(key2f + i) : 0u;
  const bool valid = __ldg(validf + i);
  const uint32_t b = bucket_of(k1, upshift, bits);
  // An invalid query gets an empty range.
  const uint32_t lo0 = valid ? __ldg(sbucket + b) : 0u;
  const uint32_t hi0 = valid ? __ldg(sbucket + b + 1) : 0u;
  // The query's key1 and the bounds [vlo, vhi] of the range's key1 words,
  // all as `key << upshift` (the image whose top bits are the bucket).
  const uint32_t q = k1 << upshift;
  uint32_t vlo = b << (32 - bits);
  uint32_t vhi = vlo | (0xffffffffu >> bits);
  uint32_t lo = lo0, hi = hi0;
  bool hi_probed = false, hi_equal = false;  // the key at hi was loaded; it equals the query
  for (int round = 0; lo < hi; ++round) {
    const uint32_t m = hi - lo;
    uint32_t g = lo + (m - 1) / 2;
    if (use_k2 && round < kInterpolatedRounds && vlo <= q && q <= vhi)
      g = lo + min(m - 1, (uint32_t)((float)(q - vlo) / ((float)(vhi - vlo) + 1.0f) * m));
    const uint32_t start = g & ~(uint32_t)(W - 1);
    // Probe t of the window, kept inside [lo, hi): nondecreasing in t.
    auto probe_at = [&](int t) { return min(max(start + t, lo), hi - 1); };
    uint2 e[W];
#pragma unroll
    for (int t = 0; t < W; ++t) e[t] = __ldg(ukk + probe_at(t));
    int c = 0;  // probes 0 .. c-1 lie below the query
#pragma unroll
    for (int t = 0; t < W; ++t) c += key_below(e[t], k1, k2, use_k2);
    // Probe k = c (W - 1 when every probe is below): whether it equals the
    // query and its key1 image.
    const int k = min(c, W - 1);
    uint2 ek = e[0];
#pragma unroll
    for (int t = 1; t < W; ++t)
      if (t == k) ek = e[t];
    // Probes k and c - 1, taken before lo and hi move.
    const uint32_t xk = probe_at(k), xb = probe_at(max(c - 1, 0));
    if (c == W) {
      lo = xk + 1;
      vlo = ek.x << upshift;
    } else {
      if (c > 0) lo = xb + 1;
      hi = xk;
      vhi = ek.x << upshift;
      hi_probed = true;
      hi_equal = key_equal(ek, k1, k2, use_k2);
    }
  }
  int32_t count = 0, start = 0;
  if (valid) {
    // The twin's `steps` rounds, on indices: the key at mid is below the
    // query iff mid < lo (the insertion point), in the bucket's range.
    uint32_t tlo = lo0, thi = hi0;
    for (int step = 0; step < steps && tlo < thi; ++step) {
      const uint32_t mid = (tlo + thi) >> 1;
      if (mid < lo) tlo = mid + 1; else thi = mid;
    }
    uint32_t at;
    bool hit;
    if (tlo == lo && hi_probed) {
      at = lo;  // < hi0 <= n
      hit = hi_equal;
    } else {
      at = min(tlo, n - 1);
      hit = tlo < n && key_equal(__ldg(ukk + at), k1, k2, use_k2);
    }
    if (hit) {
      const int2 sc = __ldg(usc + at);
      start = sc.x;
      count = sc.y;
    }
  }
  counts[i] = count;
  loc[i] = start;
}

// The first design, one thread a query (see the head of the file).
__global__ void __launch_bounds__(kProbeThreads)
direct_probe_thread_kernel(const uint32_t* __restrict__ keyf,
                           const uint32_t* __restrict__ key2f,
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
binary_probe_thread_kernel(const uint32_t* __restrict__ keyf,
                           const uint32_t* __restrict__ key2f,
                           const uint8_t* __restrict__ validf, long long nq,
                           const uint2* __restrict__ ukk, const int2* __restrict__ usc,
                           uint32_t n, const int32_t* __restrict__ sbucket, int upshift,
                           int bits, int steps, int use_k2, int32_t* __restrict__ counts,
                           int32_t* __restrict__ loc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const uint32_t k1 = __ldg(keyf + i);
  const uint32_t k2 = use_k2 ? __ldg(key2f + i) : 0u;
  const uint32_t b = bucket_of(k1, upshift, bits);
  // Bounds are at most n < 2^31, so lo + hi fits in 32 bits.
  uint32_t lo = __ldg(sbucket + b), hi = __ldg(sbucket + b + 1);
  for (int step = 0; step < steps && lo < hi; ++step) {
    const uint32_t mid = (lo + hi) >> 1;  // < hi, so no clamp needed
    if (key_below(__ldg(ukk + mid), k1, k2, use_k2)) lo = mid + 1; else hi = mid;
  }
  const uint32_t at = min(lo, n - 1);
  const uint2 e = __ldg(ukk + at);
  const bool hit = __ldg(validf + i) && lo < n && key_equal(e, k1, k2, use_k2);
  // The count and the start as two 4-byte loads, as from PR 13's two arrays.
  const int32_t* sc = (const int32_t*)(usc + at);
  counts[i] = hit ? __ldg(sc + 1) : 0;
  loc[i] = hit ? __ldg(sc) : 0;
}

bool bad_bits(int upshift, int bits) {
  return upshift < 0 || upshift > 31 || bits < 1 || bits > 31;
}

// Blocks for nq queries at `group` threads a query (0 past INT_MAX).
long long blocks_for(long long nq, int group) {
  const long long b = (nq * group + kProbeThreads - 1) / kProbeThreads;
  return b > INT_MAX ? 0 : b;
}

}  // namespace

// counts, loc (nq int32 each) of the sorted queries against a direct-mode
// aux.  Refuses a width past kMaxDirectWidth, records not 16-byte aligned
// and bucket bits or shifts outside 32 bits.
extern "C" int muscato_direct_probe(const void* keyf, const void* key2f, const void* validf,
                                    long long nq, const void* urec, const void* sbucket,
                                    int upshift, int bits, int width, int use_k2,
                                    void* counts, void* loc, void* stream) {
  const int group = muscato::kStage ? kDirectGroup : 1;
  if (width < 0 || width > kMaxDirectWidth || bad_bits(upshift, bits) ||
      ((uintptr_t)urec & 15) != 0 || nq < 0 || nq > (1LL << 40) ||
      (nq > 0 && blocks_for(nq, group) == 0))
    return (int)cudaErrorInvalidValue;
  auto kernel = muscato::kStage ? direct_probe_kernel : direct_probe_thread_kernel;
  if (nq > 0)
    kernel<<<(unsigned)blocks_for(nq, group), kProbeThreads, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)keyf, (const uint32_t*)key2f, (const uint8_t*)validf, nq,
            (const uint4*)urec, (const int32_t*)sbucket, upshift, bits, width, use_k2,
            (int32_t*)counts, (int32_t*)loc);
  return (int)cudaGetLastError();
}

// counts, loc (nq int32 each) of the sorted queries against a binary-mode
// aux of nuniq unique keys: ukk its (k1, k2) pairs, usc its (start, count)
// pairs.  Refuses an empty or 2^31-key table, steps outside [0,
// kMaxProbeSteps], ukk or usc not 8-byte aligned and bucket bits or shifts
// outside 32 bits.
extern "C" int muscato_binary_probe(const void* keyf, const void* key2f, const void* validf,
                                    long long nq, const void* ukk, const void* usc,
                                    long long nuniq, const void* sbucket, int upshift, int bits,
                                    int steps, int use_k2, void* counts, void* loc,
                                    void* stream) {
  if (nuniq < 1 || nuniq > INT_MAX || steps < 0 || steps > kMaxProbeSteps ||
      bad_bits(upshift, bits) || ((uintptr_t)ukk & 7) != 0 || ((uintptr_t)usc & 7) != 0 ||
      nq < 0 || nq > (1LL << 40) || (nq > 0 && blocks_for(nq, 1) == 0))
    return (int)cudaErrorInvalidValue;
  auto kernel = muscato::kStage ? binary_probe_kernel : binary_probe_thread_kernel;
  if (nq > 0)
    kernel<<<(unsigned)blocks_for(nq, 1), kProbeThreads, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)keyf, (const uint32_t*)key2f, (const uint8_t*)validf, nq,
            (const uint2*)ukk, (const int2*)usc, (uint32_t)nuniq, (const int32_t*)sbucket,
            upshift, bits, steps, use_k2, (int32_t*)counts, (int32_t*)loc);
  return (int)cudaGetLastError();
}
