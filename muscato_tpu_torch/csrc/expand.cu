// B2 and B6 expand_owners: for each pair lane p < pair_cap, its owning slot
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
// slow there.  Neither carries over: this card scatters into shared memory
// at full speed, so B2 turns the ranking around.  Slots announce themselves
// to the lanes they start at, and a running maximum carries each owner to
// the lanes that follow: O(lanes + slots) work and no search per lane.
//
// Bytes bound B2 on the card: each slot that owns lanes is read once (three
// words) and each lane written once (two words); at a flagship batch
// (about 11.0M owning slots, 12.58M lanes) that is 233 MB, 0.069 ms at
// 3.35 TB/s.  The integer work (a compare per slot, a compare and two adds
// per lane, about 49M operations, 0.003 ms) is far below it.  What holds a
// kernel of this shape above its bound is latency: a tile's loads depend
// on one another (where its slots start, their offsets, then their lo and
// qid), and only what is in flight hides that.  So the unit of work is a
// warp, not a CTA: warps share nothing and never wait for one another
// (__syncwarp only), and the kernel is held to 64 registers so that 32 of
// them are resident on an SM.
//   - a warp walks kExpTiles consecutive tiles of kExpTile lanes [p0, p1],
//     each thread kExpPerThread consecutive lanes of a tile, so both output
//     streams leave as 16-byte stores;
//   - a tile at or past oexcl[m-1] (the dead tail of the pair buffer)
//     belongs to slot m-1 whole: one broadcast load of three words, then
//     stores, and no search;
//   - for its first live tile the warp finds first = owner(p0) with one
//     warp-cooperative 32-ary search (search.cuh: five dependent loads
//     over 16M slots, not 24); when the next slot's offset lies past p1
//     the tile belongs to `first` whole and is filled the same way.  Every
//     later tile starts at the owner of the lane before it, which the tile
//     before has just computed: one search a warp;
//   - otherwise the warp stages oexcl of the slots from `first` on in its
//     part of shared memory with 16-byte loads, a tile's worth and a
//     little more at first, until the first unstaged offset `lim` lies
//     past p1 or kExpStage slots are staged.  The last slot of each run of
//     slots that start at one lane of the tile (lane 0 for offsets at or
//     before p0) writes its index there in a shared array (one writer a
//     lane, so no atomics), and an inclusive max-scan over the tile
//     (thread-local, then warp shuffles), floored at `first`, gives every
//     lane its owner.  Each lane then reads its owner's lo and qid from
//     global memory: neighbouring lanes read the same or neighbouring
//     words, so the loads coalesce, and staging the two arrays as well was
//     slower on the card (one more dependent step a tile);
//   - lanes at or past `lim` (a run of empty slots longer than the stage,
//     met where the live slots end and the dead ones begin) search global
//     memory from the first unstaged slot on, inside the same kernel, as B6
//     does: the kernel is exact for any nondecreasing oexcl, any pair_cap
//     and any m >= 1, and has no overflow flag.
// Every staged word is read about once, so the stage is filled with plain
// 16-byte loads and not with a bulk async copy (bulk.cuh): B1's staged
// words are re-read a dozen times each and the copy paid 1.5x there, B4's
// are read once and it paid nothing.  Inputs that are not 16-byte aligned
// (sliced views) are staged with 4-byte loads, and outputs that are not, or
// the ragged end of the buffer, are written with 4-byte stores.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "search.cuh"

namespace {

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

// B2's two searches, kept out of line: a warp calls the first once and few
// lanes ever call the second, and inlined into the tile loop their 64-bit
// state would cost every lane registers, and the kernel warps in flight.
//
// The first slot whose offset exceeds p (m if none), by the whole warp.
__device__ __noinline__ long long first_past(const int32_t* __restrict__ oexcl,
                                             long long m, long long p) {
  return muscato::warp_search(oexcl, 0, m, p, true);
}

// The owner of lane p among slots [a, m), the first of which has an offset
// <= p.
__device__ __noinline__ long long owner_from(const int32_t* __restrict__ oexcl,
                                             long long a, long long m,
                                             long long p) {
  return clip_owner(upper_bound_global(oexcl, a, m, p) - 1, m);
}

constexpr int kExpThreads = 256;
constexpr int kExpWarps = kExpThreads / 32;
constexpr int kExpPerThread = 4;  // consecutive lanes a thread: one 16-byte store
constexpr int kExpTile = 32 * kExpPerThread;  // lanes per tile, a warp's
// Consecutive tiles a warp walks, and the CTAs the kernel's registers are
// cut to fit on an SM (4: 64 registers and no spills; the compiler takes
// over 100 when left alone, and spills from 5 on).  chip_smoke.py builds
// other values of both beside these to time them.
#ifndef MUSCATO_EXP_TILES
#define MUSCATO_EXP_TILES 4
#endif
#ifndef MUSCATO_EXP_MIN_BLOCKS
#define MUSCATO_EXP_MIN_BLOCKS 4
#endif
constexpr int kExpTiles = MUSCATO_EXP_TILES;
// Staged slots of a warp: a first round of a tile's worth and a little
// more (at a flagship batch nearly every live slot owns one lane, so a
// tile spans about kExpTile slots), then the rest of its 1.5 KB stage if
// that was not enough (empty slots inside the tile).
constexpr int kExpRound = kExpTile + 32;
constexpr int kExpStage = 3 * kExpTile;
static_assert(kExpRound % 4 == 0 && kExpRound <= kExpStage, "rounds of whole 16 bytes");

// A warp's s[i] = a[base + i] for i in [i0, i1).  With `vec`, a + base is
// 16-byte aligned and i0 a multiple of 4: whole groups of four load as one
// int4.
__device__ __forceinline__ void stage_slots(const int32_t* __restrict__ a,
                                            long long base, int i0, int i1,
                                            int32_t* s, bool vec, int lane) {
  if (vec) {
    const int4* a4 = reinterpret_cast<const int4*>(a + base);
    int4* s4 = reinterpret_cast<int4*>(s);
    const int v1 = i1 >> 2;
    for (int v = (i0 >> 2) + lane; v < v1; v += 32) s4[v] = __ldg(a4 + v);
    i0 = max(i0, v1 << 2);  // what is left of the last 16 bytes
  }
  for (int i = i0 + lane; i < i1; i += 32) s[i] = __ldg(a + base + i);
}

// Lanes pt .. pt + 3 of both outputs, up to the last lane p1: one 16-byte
// store a stream when `vec` and all four exist.
__device__ __forceinline__ void emit_lanes(int32_t* __restrict__ qid_out,
                                           int32_t* __restrict__ sidx_out,
                                           long long pt, long long p1, bool vec,
                                           const int32_t (&q)[kExpPerThread],
                                           const int32_t (&s)[kExpPerThread]) {
  if (vec && pt + kExpPerThread - 1 <= p1) {
    *reinterpret_cast<int4*>(qid_out + pt) = make_int4(q[0], q[1], q[2], q[3]);
    *reinterpret_cast<int4*>(sidx_out + pt) = make_int4(s[0], s[1], s[2], s[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kExpPerThread; ++j)
      if (pt + j <= p1) {
        qid_out[pt + j] = q[j];
        sidx_out[pt + j] = s[j];
      }
  }
}

__global__ void __launch_bounds__(kExpThreads, MUSCATO_EXP_MIN_BLOCKS)
    expand_owners_kernel(const int32_t* __restrict__ oexcl,
                         const int32_t* __restrict__ lo,
                         const int32_t* __restrict__ qid, long long m,
                         long long pair_cap, int32_t* __restrict__ qid_out,
                         int32_t* __restrict__ sidx_out, int vec_in,
                         int vec_out) {
  __shared__ __align__(16) int32_t s_oex_all[kExpWarps][kExpStage];
  __shared__ __align__(16) int s_own_all[kExpWarps][kExpTile];

  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* s_oex = s_oex_all[warp];
  int* s_own = s_own_all[warp];
  const long long c0 =
      ((long long)blockIdx.x * kExpWarps + warp) * (kExpTiles * kExpTile);
  const long long c1 = min(c0 + kExpTiles * kExpTile, pair_cap);
  if (c0 >= c1) return;
  const long long tail = (long long)__ldg(oexcl + m - 1);

  // `first`: a slot at or before owner(p0) whose offset is <= p0 (or slot
  // 0); -1 until the warp has searched for it.
  long long first = -1;
  for (long long p0 = c0; p0 < c1; p0 += kExpTile) {
    const long long p1 = min(p0 + kExpTile, c1) - 1;  // last lane
    const long long pt = p0 + kExpPerThread * lane;   // this thread's first

    // A tile owned by one slot: the dead tail (slot m - 1, no search), or
    // the slot found when the next one starts past the tile.
    bool whole = tail <= p0;
    if (whole) {
      first = m - 1;
    } else if (first < 0) {
      const long long ub = first_past(oexcl, m, p0);
      first = clip_owner(ub - 1, m);
      whole = ub >= m || (long long)__ldg(oexcl + ub) > p1;
    }
    int32_t q[kExpPerThread], s[kExpPerThread];
    if (whole) {
      const int32_t qf = __ldg(qid + first);
      const long long d =
          (long long)__ldg(lo + first) - (long long)__ldg(oexcl + first) + pt;
#pragma unroll
      for (int j = 0; j < kExpPerThread; ++j) {
        q[j] = qf;
        s[j] = (int32_t)(d + j);
      }
      emit_lanes(qid_out, sidx_out, pt, p1, vec_out, q, s);
      continue;
    }

    // Stage oexcl of slots [base, base + n): s_oex[i] = oexcl[base + i];
    // `first` is staged slot f.  lim = the first unstaged offset.
    const long long base = vec_in ? (first & ~3LL) : first;
    const int f = (int)(first - base);
    *reinterpret_cast<int4*>(s_own + kExpPerThread * lane) = make_int4(-1, -1, -1, -1);
    int n = 0;
    long long lim;
    for (int want = kExpRound;; want = kExpStage) {
      const int n1 = (int)min((long long)want, m - base);
      stage_slots(oexcl, base, n, n1, s_oex, vec_in, lane);
      n = n1;
      lim = base + n < m ? (long long)__ldg(oexcl + base + n) : LLONG_MAX;
      if (lim > p1 || want == kExpStage) break;
    }
    __syncwarp();

    // Head flags.  The owner of lane p is the last slot with oexcl <= p, so
    // a slot announces itself at lane max(oexcl - p0, 0), and of a run of
    // slots with one such lane only the last does: one writer a lane.  A
    // run cut by the end of the stage has offset lim, whose lanes search
    // below.  From here on lanes count from p0, in 32 bits; offsets are
    // int32, so a p0 past INT_MAX has every offset at or before it.
    const int span = (int)(p1 - p0);
    const int p0c = (int)min(p0, (long long)INT_MAX);
    const int rlim = (int)min(lim - p0, (long long)INT_MAX);  // lim > p0
    for (int i = f + lane; i < n; i += 32) {
      const int oe = s_oex[i], nx = i + 1 < n ? s_oex[i + 1] : INT_MAX;
      const int off = oe > p0c ? oe - p0c : 0;
      if (off <= span && (i + 1 == n || (nx > p0c ? nx - p0c : 0) != off))
        s_own[off] = i;
    }
    __syncwarp();

    // Inclusive max-scan of the flags over the tile, floored at f.
    const int4 mk = *reinterpret_cast<const int4*>(s_own + kExpPerThread * lane);
    int own[kExpPerThread];
    own[0] = max(mk.x, f);
    own[1] = max(own[0], mk.y);
    own[2] = max(own[1], mk.z);
    own[3] = max(own[2], mk.w);
    int incl = own[3];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(full, incl, d);
      if (lane >= d) incl = max(incl, y);
    }
    int pre = __shfl_up_sync(full, incl, 1);
    if (lane == 0) pre = f;
    const int omax = __shfl_sync(full, incl, 31);  // the last lane's staged owner

    // sidx = lo + (p - oexcl) in 64 bits, cut to 32: the same bits as the
    // wrapping 32-bit sum.
    const int32_t* lo_b = lo + base;
    const int32_t* qid_b = qid + base;
#pragma unroll
    for (int j = 0; j < kExpPerThread; ++j) {
      const int r = kExpPerThread * lane + j;  // the lane, from p0
      q[j] = s[j] = 0;
      if (r > span) continue;
      uint32_t l, oe;
      if (r < rlim) {
        const int os = max(own[j], pre);
        oe = (uint32_t)s_oex[os];
        l = (uint32_t)__ldg(lo_b + os);
        q[j] = __ldg(qid_b + os);
      } else {
        const long long o = owner_from(oexcl, base + n, m, p0 + r);
        oe = (uint32_t)__ldg(oexcl + o);
        l = (uint32_t)__ldg(lo + o);
        q[j] = __ldg(qid + o);
      }
      s[j] = (int32_t)(l + ((uint32_t)p0 + (uint32_t)r - oe));
    }
    emit_lanes(qid_out, sidx_out, pt, p1, vec_out, q, s);
    // The next tile starts where this one ended: at its last lane's owner,
    // or at the first unstaged slot when that lane searched.
    first = span < rlim ? base + omax : base + n;
    __syncwarp();  // the stage is rewritten by the next tile
  }
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
    const long long chunk = (long long)kExpWarps * kExpTiles * kExpTile;
    const long long blocks = (pair_cap + chunk - 1) / chunk;
    const bool vec_in =
        (((uintptr_t)oexcl | (uintptr_t)lo | (uintptr_t)qid) & 15) == 0;
    const bool vec_out = (((uintptr_t)qid_out | (uintptr_t)sidx_out) & 15) == 0;
    expand_owners_kernel<<<(unsigned)blocks, kExpThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)oexcl, (const int32_t*)lo, (const int32_t*)qid, m,
        pair_cap, (int32_t*)qid_out, (int32_t*)sidx_out, vec_in, vec_out);
  }
  return (int)cudaGetLastError();
}
