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
// at full speed, so both turn the ranking around.  Slots announce themselves
// to the lanes they start at, and a running maximum carries each owner to
// the lanes that follow: O(lanes + slots) work and no search per lane.  B2
// loads each tile's slots when it reaches the tile; B6 streams them into a
// ring ahead of the tiles (below).
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
//     memory from the first unstaged slot on, inside the same kernel: the
//     kernel is exact for any nondecreasing oexcl, any pair_cap
//     and any m >= 1, and has no overflow flag.
// Every staged word is read about once, so the stage is filled with plain
// 16-byte loads and not with a bulk async copy (bulk.cuh): B1's staged
// words are re-read a dozen times each and the copy paid 1.5x there, B4's
// are read once and it paid nothing.  Inputs that are not 16-byte aligned
// (sliced views) are staged with 4-byte loads, and outputs that are not, or
// the ragged end of the buffer, are written with 4-byte stores.

#include <atomic>
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

// The two searches of B2 and B6, kept out of line: a warp calls the first
// once and few lanes ever call the second, and inlined into the tile loop
// their 64-bit state would cost every lane registers, and the kernel warps
// in flight.
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

// B6, the same function (the TPU kernel _kernel_sub ranks 128-lane
// sub-chunks against a slot window staged in VMEM).  B2's tiles wait on a
// chain of dependent loads: where the slots start, their offsets, then
// their lo and qid.  The chain need not be dependent: the owners of
// consecutive lanes never decrease, so the slots a warp reads form one
// contiguous, increasing stream, and once one search has fixed where it
// starts, every later address is known before the scan needs it.
//   - warps are persistent: as many CTAs as are resident on the card (the
//     grid cut to the work), each warp one range of consecutive lanes, an
//     equal share of pair_cap but at least kSubMinTiles tiles, walked as
//     kExpTile-lane tiles; each thread writes four consecutive lanes, so
//     both outputs leave as 16-byte stores;
//   - a tile at or past oexcl[m-1] belongs to slot m-1 whole and is
//     filled from one broadcast load, as in B2.  For its first live tile
//     a warp finds the owner of the first lane with the warp search of
//     search.cuh (five dependent loads); it searches no more but in the
//     one case below;
//   - from that owner on, the warp streams the slot words (oexcl, and lo
//     and qid unless built with -DMUSCATO_SUB_LOQID=0) into a ring of
//     kSubRing stages of kSubSlots slots in its part of shared memory, by
//     cp.async (16-byte copies; 4-byte ones for views that are not
//     16-byte aligned and for the ragged end of the arrays), one commit
//     group a stage.  Before a tile it issues every stage the ring has
//     room for past the one the tile starts in, then waits only for the
//     stages the tile needs: the copies never wait on the scan, and only
//     the ring's read position follows it;
//   - owners come from B2's head flags and max-scan over the window of
//     landed slots, and each lane reads its owner's words from the ring;
//   - a run of empty slots longer than the ring (the window cannot reach
//     past the tile) leaves lanes whose owner lies beyond it.  Those at or
//     past oexcl[m-1] take slot m-1; the others search global memory from
//     the first slot outside the window, and the ring restarts at the
//     owner of the tile's last lane.
// Exact for any nondecreasing oexcl, any m >= 1 and any pair_cap, with no
// overflow flag.  Bound: B2's (bytes).  wait_group counts the groups of
// one thread, so every lane commits a group for every stage, copies or
// not, and a __syncwarp follows each wait before other lanes read.  Ring
// positions stay 32-bit: the ring's base slot moves on by whole laps.

#ifndef MUSCATO_SUB_RING
#define MUSCATO_SUB_RING 4
#endif
#ifndef MUSCATO_SUB_LOQID
#define MUSCATO_SUB_LOQID 1
#endif
#ifndef MUSCATO_SUB_MIN_TILES
#define MUSCATO_SUB_MIN_TILES 16
#endif
// Registers are not cut: the compiler's own choice (68, so 3 CTAs an SM)
// was no slower on the card than cuts for 3 or 4 CTAs.
#ifndef MUSCATO_SUB_MIN_BLOCKS
#define MUSCATO_SUB_MIN_BLOCKS 1
#endif
constexpr int kSubRing = MUSCATO_SUB_RING;
// A stage: a tile's slots at one lane a slot, so a tile's window spans two
// or three stages and the rest of the ring is in flight.
constexpr int kSubSlots = kExpTile;
constexpr int kSubRingSlots = kSubRing * kSubSlots;
constexpr int kSubArrays = MUSCATO_SUB_LOQID ? 3 : 1;  // oexcl[, lo, qid]
// A warp's shared memory: the ring of each array, then the tile's flags.
constexpr int kSubWarpWords = kSubArrays * kSubRingSlots + kExpTile;
constexpr int kSubSmem = kExpWarps * kSubWarpWords * 4;
constexpr long long kSubMinTiles = MUSCATO_SUB_MIN_TILES;
static_assert(kSubRing >= 3 && kSubMinTiles >= 1, "a window spans up to three stages");
static_assert(kSubSlots == 32 * 4, "a whole stage is one 16-byte copy a lane");

__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Until at most n of this thread's commit groups are pending (the count
// must be an immediate; above 3 it waits for more than it must).
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 3;" ::: "memory");
}

// Copies of slots [s0, s0 + n) of each ringed array into ring stage `buf`,
// committed as one group.  With `vec`, s0 is a multiple of 4 and the
// arrays are 16-byte aligned.
__device__ __forceinline__ void issue_stage(const int32_t* __restrict__ oexcl,
                                            const int32_t* __restrict__ lo,
                                            const int32_t* __restrict__ qid,
                                            int32_t* ring, long long s0, int n,
                                            int buf, bool vec, int lane) {
#pragma unroll
  for (int a = 0; a < kSubArrays; ++a) {
    const int32_t* g = (a == 0 ? oexcl : a == 1 ? lo : qid) + s0;
    int32_t* d = ring + a * kSubRingSlots + buf * kSubSlots;
    if (vec && n == kSubSlots) {  // a whole stage: 16 bytes a lane
      cp_async16(d + 4 * lane, g + 4 * lane);
      continue;
    }
    int i0 = 0;
    if (vec) {
      const int nv = n >> 2;
      for (int v = lane; v < nv; v += 32) cp_async16(d + 4 * v, g + 4 * v);
      i0 = nv << 2;
    }
    for (int i = i0 + lane; i < n; i += 32) cp_async4(d + i, g + i);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// x mod k for 0 <= x < 2k.
__device__ __forceinline__ int lap(int x, int k) { return x >= k ? x - k : x; }

__global__ void __launch_bounds__(kExpThreads, MUSCATO_SUB_MIN_BLOCKS)
    expand_owners_sub_kernel(const int32_t* __restrict__ oexcl,
                             const int32_t* __restrict__ lo,
                             const int32_t* __restrict__ qid, long long m,
                             long long pair_cap, long long range,
                             int32_t* __restrict__ qid_out,
                             int32_t* __restrict__ sidx_out, int vec_in,
                             int vec_out) {
  extern __shared__ __align__(16) int32_t s_sub[];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // Consecutive ranges go to different CTAs, so the dead tail's cheap
  // ranges spread over the SMs.
  const long long c0 = ((long long)warp * gridDim.x + blockIdx.x) * range;
  if (c0 >= pair_cap) return;
  const long long c1 = min(c0 + range, pair_cap);
  int32_t* ring = s_sub + warp * kSubWarpWords;  // array a at a * kSubRingSlots
  int* s_own = ring + kSubArrays * kSubRingSlots;
  const long long tail = (long long)__ldg(oexcl + m - 1);
  const int32_t q_last = __ldg(qid + m - 1), l_last = __ldg(lo + m - 1);

  // `head`: a slot at or before the owner of the tile's first lane whose
  // offset is <= that lane (or slot 0); -1 until the warp has searched.
  // Stage k < issued holds slots [base + k S, base + (k + 1) S) in ring
  // stage k % kSubRing; the stages below `landed` have arrived; head lies
  // in the ring's first lap, below base + kSubRingSlots.
  long long head = -1, base = 0;
  int issued = 0, landed = 0;
  for (long long p0 = c0; p0 < c1; p0 += kExpTile) {
    const long long p1 = min(p0 + kExpTile, c1) - 1;  // last lane
    const long long pt = p0 + kExpPerThread * lane;   // this thread's first
    int32_t q[kExpPerThread], s[kExpPerThread];
    if (tail <= p0) {
      const long long d = (long long)l_last - tail + pt;
#pragma unroll
      for (int j = 0; j < kExpPerThread; ++j) {
        q[j] = q_last;
        s[j] = (int32_t)(d + j);
      }
      emit_lanes(qid_out, sidx_out, pt, p1, vec_out, q, s);
      continue;
    }
    if (head < 0) {
      head = clip_owner(first_past(oexcl, m, p0) - 1, m);
      base = vec_in ? (head & ~3LL) : head;
      issued = landed = 0;
    }
    const int hrel = (int)(head - base);  // head's ring position
    const int h = hrel / kSubSlots;       // the tile's first stage
    for (; issued < h + kSubRing; ++issued) {
      const long long s0 = base + (long long)issued * kSubSlots;
      if (s0 >= m) break;
      issue_stage(oexcl, lo, qid, ring, s0, (int)min((long long)kSubSlots, m - s0),
                  lap(issued, kSubRing), vec_in, lane);
    }
    *reinterpret_cast<int4*>(s_own + kExpPerThread * lane) = make_int4(-1, -1, -1, -1);

    // Landed slots [head, base + erel).  Wait for one more stage until the
    // last of them starts past the tile, is slot m - 1, starts the dead run
    // of slots at oexcl[m-1], or nothing more is in flight.
    int erel, last;  // last = oexcl[base + erel - 1]
    for (int w = max(landed, h + 1);; ++w) {
      if (w > landed) {
        cp_async_wait(issued - w);
        __syncwarp();
        landed = w;
      }
      erel = (int)min((long long)landed * kSubSlots, m - base);
      last = ring[lap(erel - 1, kSubRingSlots)];
      if (base + erel == m || last > p1 || last == tail || landed == issued) break;
    }
    __syncwarp();  // the flags' reset, before any lane writes a flag

    // Head flags of slots [head, head + n), as in B2, relative to head;
    // short of slot m - 1 the window leaves out its last landed slot,
    // whose offset `lim` is the first lane (rlim from p0) it cannot place.
    const bool all = base + erel == m;
    const int n = erel - hrel - (all ? 0 : 1);
    const long long lim = all ? LLONG_MAX : (long long)last;
    const int span = (int)(p1 - p0);
    const int p0c = (int)min(p0, (long long)INT_MAX);
    const int rlim = lim <= p0 ? 0 : (int)min(lim - p0, (long long)INT_MAX);
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const int oe = i < n ? ring[lap(hrel + i, kSubRingSlots)] : INT_MAX;
      int nx = __shfl_down_sync(full, oe, 1);  // the next slot's offset
      if (lane == 31 && i + 1 < n) nx = ring[lap(hrel + i + 1, kSubRingSlots)];
      if (i < n) {
        const int off = oe > p0c ? oe - p0c : 0;
        if (off <= span && (i + 1 == n || (nx > p0c ? nx - p0c : 0) != off))
          s_own[off] = i;
      }
      if (__any_sync(full, i < n && oe > p1)) break;  // later slots start past the tile
    }
    __syncwarp();

    const int4 mk = *reinterpret_cast<const int4*>(s_own + kExpPerThread * lane);
    int own[kExpPerThread];
    own[0] = max(mk.x, 0);
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
    if (lane == 0) pre = 0;

    if (rlim > span) {
      // The window places every lane: the common case, with no branch a
      // lane (lanes past a ragged end compute values that are not stored).
#pragma unroll
      for (int j = 0; j < kExpPerThread; ++j) {
        const int os = max(own[j], pre);
        const int pos = lap(hrel + os, kSubRingSlots);
        const uint32_t oe = (uint32_t)ring[pos];
        uint32_t l;
        if (kSubArrays == 3) {
          l = (uint32_t)ring[kSubRingSlots + pos];
          q[j] = ring[2 * kSubRingSlots + pos];
        } else {
          l = (uint32_t)__ldg(lo + head + os);
          q[j] = __ldg(qid + head + os);
        }
        s[j] = (int32_t)(l + ((uint32_t)pt + (uint32_t)j - oe));
      }
      emit_lanes(qid_out, sidx_out, pt, p1, vec_out, q, s);
      // The next tile starts at the owner of this one's last lane: flags
      // lie at or before the last lane, so the scan of its thread holds it.
      head += __shfl_sync(full, incl, span / kExpPerThread);
      if (head - base >= kSubRingSlots) {  // past the first lap
        base += kSubRingSlots;
        issued -= kSubRing;
        landed -= kSubRing;
      }
      __syncwarp();  // ring stages and flags are rewritten by the next tile
      continue;
    }
    long long mine = 0;  // the owner of this thread's last lane
#pragma unroll
    for (int j = 0; j < kExpPerThread; ++j) {
      const int r = kExpPerThread * lane + j;  // the lane, from p0
      q[j] = s[j] = 0;
      if (r > span) continue;
      uint32_t l, oe;
      if (r < rlim) {
        const int os = max(own[j], pre);
        const int pos = lap(hrel + os, kSubRingSlots);
        oe = (uint32_t)ring[pos];
        if (kSubArrays == 3) {
          l = (uint32_t)ring[kSubRingSlots + pos];
          q[j] = ring[2 * kSubRingSlots + pos];
        } else {
          l = (uint32_t)__ldg(lo + head + os);
          q[j] = __ldg(qid + head + os);
        }
        mine = head + os;
      } else if (lim == tail) {
        oe = (uint32_t)tail;
        l = (uint32_t)l_last;
        q[j] = q_last;
        mine = m - 1;
      } else {
        mine = owner_from(oexcl, base + erel - 1, m, p0 + r);
        oe = (uint32_t)__ldg(oexcl + mine);
        l = (uint32_t)__ldg(lo + mine);
        q[j] = __ldg(qid + mine);
      }
      s[j] = (int32_t)(l + ((uint32_t)p0 + (uint32_t)r - oe));
    }
    emit_lanes(qid_out, sidx_out, pt, p1, vec_out, q, s);
    // The next tile starts at the owner of this one's last lane.  Past
    // every issued stage (after a search, or at slot m - 1) the ring
    // restarts there; past the first lap, the ring's base moves on one.
    head = __shfl_sync(full, mine, span / kExpPerThread);
    if (head >= base + (long long)issued * kSubSlots) {
      cp_async_wait(0);
      base = vec_in ? (head & ~3LL) : head;
      issued = landed = 0;
    } else if (head - base >= kSubRingSlots) {
      base += kSubRingSlots;
      issued -= kSubRing;
      landed -= kSubRing;
    }
    __syncwarp();  // ring stages and flags are rewritten by the next tile
  }
  cp_async_wait(0);  // nothing left in flight when the warp exits
}

// CTAs of B6 resident at once on the current device, cached per device;
// the first call also allows the kernel its dynamic shared memory and asks
// for the largest shared-memory carveout (the kernel reads nothing through
// L1), so that the CTAs counted are resident at once.
cudaError_t sub_resident_ctas(int* ctas) {
  static std::atomic<int> cached[64];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && (*ctas = cached[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  if ((e = cudaFuncSetAttribute(expand_owners_sub_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSubSmem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(expand_owners_sub_kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, expand_owners_sub_kernel, kExpThreads, kSubSmem)) != cudaSuccess)
    return e;
  *ctas = max(1, sms * per_sm);
  if (dev < 64) cached[dev].store(*ctas, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

extern "C" int muscato_expand_owners_sub(const void* oexcl, const void* lo,
                                         const void* qid, long long m,
                                         long long pair_cap, void* qid_out,
                                         void* sidx_out, void* stream) {
  if (pair_cap > 0 && m > 0) {
    int ctas;
    const cudaError_t e = sub_resident_ctas(&ctas);
    if (e != cudaSuccess) return (int)e;
    // A warp's range: an equal share of the lanes, at least kSubMinTiles
    // tiles.
    const long long warps = (long long)ctas * kExpWarps;
    const long long share =
        ((pair_cap + warps - 1) / warps + kExpTile - 1) / kExpTile * kExpTile;
    const long long range = max(kSubMinTiles * kExpTile, share);
    const long long blocks = ((pair_cap + range - 1) / range + kExpWarps - 1) / kExpWarps;
    const bool vec_in =
        (((uintptr_t)oexcl | (uintptr_t)lo | (uintptr_t)qid) & 15) == 0;
    const bool vec_out = (((uintptr_t)qid_out | (uintptr_t)sidx_out) & 15) == 0;
    expand_owners_sub_kernel<<<(unsigned)blocks, kExpThreads, kSubSmem,
                               (cudaStream_t)stream>>>(
        (const int32_t*)oexcl, (const int32_t*)lo, (const int32_t*)qid, m,
        pair_cap, range, (int32_t*)qid_out, (int32_t*)sidx_out, vec_in, vec_out);
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
