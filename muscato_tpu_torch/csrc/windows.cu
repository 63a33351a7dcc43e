// B5 window_queries: for every (window k, read r), from the nibble-packed
// read matrix rpacked (R, nw) — 8 bases per 32-bit word, nibble i of a word
// holds base i — emits, window-major at k*R + r,
//   key1  = Horner fold of the window's `width` codes with multiplier m1
//           (uint32 wrap),
//   key2  = the same fold with m2 when use_k2 (width > 13), else 0,
//   valid = lengths[r] >= q1 + width, AND (when min_dinuc > 0) at least
//           min_dinuc distinct dinucleotides (a 25-bit presence mask of
//           prev*5 + code, popcount).
//
// Replaces muscato_tpu/ops/pallas_windows.py:window_queries_pallas (Pallas
// kernel _kernel), which tiles the byte code matrix through VMEM and
// extracts every window in registers.  This kernel computes the same
// function from the nibble-packed words the probe already holds (half the
// bytes of the codes), and reproduces the plain twin
// (muscato_tpu_torch/ops/window_queries.py:window_queries_torch) on every
// lane, including windows that run past the packed width: the host computes
// each window's clipped word start w0 and funnel shift sh exactly as the
// twin does, and words past the packed width read as 0 (the twin's guard
// column).
//
// Bound on the card: bytes and integer operations are of one order.  A
// flagship call (4,194,304 reads of 13 words, 4 windows of width 20,
// min_dinuc 3) moves 386 MB (each row and length read once, 9 bytes
// written per (window, read)): 0.115 ms at 3.35 TB/s.  It also walks
// 335.5M bases, and a base needs six integer operations: a nibble
// extract, a multiply-add for each key, and for the mask a multiply-add, a
// shift and an or.  That is 1.0e9 multiply-adds and 1.0e9 shift/logic
// operations, and the card issues 64 of each a clock on each of its 132
// SMs: 0.060 ms at 1.98 GHz when both pipes run at once, as they do
// (chip_smoke.py's integer chains reach 98% of that rate on each pipe, and
// on the shift/logic pipe still with multiply-adds beside it).  So the
// kernel has to stay near six instructions a base, and
// every instruction spent on addressing, branching or loop counting
// shows.  The design:
//   - a CTA takes a tile of consecutive reads, one read a thread.  The
//     tile's rows are one contiguous span of rpacked, so for an odd row
//     width (13, 19, 25 words at 100-, 150-, 200-base reads) one bulk async
//     copy (cp.async.bulk on an mbarrier, bulk.cuh) stages them: no thread
//     computes an address, and the odd stride already spreads a warp's
//     per-read word reads over 32 distinct banks.  An even width is staged
//     by a copy loop over the tile's words in flat order, with the stride
//     padded by one word; its (row, word) advance by a fixed stride
//     (walk.cuh), so no loop divides;
//   - the window loop is outside and the read is the thread, so a window's
//     w0, sh and gate are uniform in the CTA (one constant-bank read each)
//     and consecutive threads write consecutive reads of one window;
//   - the step is specialised at compile time on use_k2 and min_dinuc > 0
//     (four instances), whole 8-base words are fully unrolled, and the tail
//     word enters a straight run of steps at the right place after one
//     shift, so no per-base branch or counter is left;
//   - the mask bit is PTX shl.b32, which gives 0 for a shift above 31 as
//     the twin does for dinucleotide indices of nibbles past the code
//     range (C++ << is undefined there).  The window's first base has no
//     predecessor and sets no bit: prev starts at 7, whose index 35 + code
//     shifts out.
// Built with -DMUSCATO_NO_STAGE every width is staged by the copy loop.

#include <cstdint>
#include <cuda_runtime.h>

#include "bulk.cuh"
#include "walk.cuh"

namespace {

constexpr int kMaxWindows = 64;
constexpr int kThreads = 256;  // and reads per tile, one a thread
constexpr int kSmemBytes = 48 * 1024;  // what a block gets without opting in

struct WindowParams {
  int nwin;
  int w0[kMaxWindows];    // first sliced word of each window (clipped)
  int sh[kMaxWindows];    // funnel shift in bits, in [0, 31]
  long long gate[kMaxWindows];  // q1 + width: the length gate
};

// Keys and dinucleotide mask of one window as its bases stream through.
template <bool kK2, bool kDinuc>
struct Fold {
  uint32_t h1 = 0, h2 = 0, bits = 0, prev = 7;
  __device__ __forceinline__ void step(uint32_t b, uint32_t m1, uint32_t m2) {
    h1 = h1 * m1 + b;
    if (kK2) h2 = h2 * m2 + b;
    if (kDinuc) {
      uint32_t bit;
      asm("shl.b32 %0, %1, %2;" : "=r"(bit) : "r"(1u), "r"(prev * 5u + b));
      bits |= bit;
      prev = b;
    }
  }
};

template <bool kK2, bool kDinuc>
__global__ void __launch_bounds__(kThreads)
    window_queries_kernel(const int32_t* __restrict__ rpacked,
                          const int32_t* __restrict__ lengths, long long nreads,
                          int nw, int ld, int tile, WindowParams wp, int width,
                          int min_dinuc, uint32_t m1, uint32_t m2,
                          int32_t* __restrict__ key1, int32_t* __restrict__ key2,
                          uint8_t* __restrict__ valid) {
  extern __shared__ __align__(16) uint32_t s_rows[];  // tile x ld words (+ 8)
  __shared__ __align__(8) uint64_t s_bar;
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * tile;
  const int nt = (int)min((long long)tile, nreads - r0);

  // Stage the tile's rows: word c of row r lands at rows[r * ld + c].
  const uint32_t* rows = s_rows;
  bool bulk = false;
  if (ld == nw) {
    const long long w0 = r0 * nw;
    rows += w0 - muscato::stage_words((const uint32_t*)rpacked, nreads * nw, w0,
                                      w0 + (long long)nt * nw, s_rows, &s_bar,
                                      &bulk);
  } else {
    // Flat order over the tile's words, so the loads coalesce and several
    // are in flight; (row, word) advance by a fixed stride, no division
    // in the loop.
    const int32_t* src = rpacked + r0 * nw;
    muscato::RowWalk a(tid, blockDim.x, nw);
    for (int i = tid; a.j < nt; i += blockDim.x, a.next())
      s_rows[a.j * ld + a.c] = (uint32_t)__ldg(src + i);
  }
  const long long len = tid < nt ? (long long)__ldg(lengths + r0 + tid) : 0;
  __syncthreads();
  muscato::stage_wait(&s_bar, bulk);
  if (tid >= nt) return;

  const uint32_t* row = rows + tid * ld;
  const int nfull = width >> 3;  // whole 8-base words of a window
  const int rem = width & 7;     // bases of its tail word
  for (int k = 0; k < wp.nwin; ++k) {
    const int w0 = wp.w0[k];
    const int sh = wp.sh[k];
    Fold<kK2, kDinuc> f;
    uint32_t hi = (w0 < nw) ? row[w0] : 0u;
    for (int j = 0; j < nfull; ++j) {
      const uint32_t lo = hi;
      hi = (w0 + j + 1 < nw) ? row[w0 + j + 1] : 0u;
      // (hi:lo) >> sh; sh == 0 gives lo alone, as the twin does.
      const uint32_t al = __funnelshift_r(lo, hi, sh);
#pragma unroll
      for (int q = 0; q < 8; ++q) f.step((al >> (4 * q)) & 0xFu, m1, m2);
    }
    if (rem) {
      const uint32_t lo = hi;
      hi = (w0 + nfull + 1 < nw) ? row[w0 + nfull + 1] : 0u;
      // The tail's `rem` bases, moved to the top nibbles: base i of the
      // tail is nibble 8 - rem + i, and the run below is entered there.
      const uint32_t al = __funnelshift_r(lo, hi, sh) << (4 * (8 - rem));
      switch (rem) {
        case 7: f.step((al >> 4) & 0xFu, m1, m2);
        case 6: f.step((al >> 8) & 0xFu, m1, m2);
        case 5: f.step((al >> 12) & 0xFu, m1, m2);
        case 4: f.step((al >> 16) & 0xFu, m1, m2);
        case 3: f.step((al >> 20) & 0xFu, m1, m2);
        case 2: f.step((al >> 24) & 0xFu, m1, m2);
        default: f.step(al >> 28, m1, m2);
      }
    }
    bool ok = len >= wp.gate[k];
    if (kDinuc) ok = ok && (__popc(f.bits) >= min_dinuc);
    const long long out = (long long)k * nreads + r0 + tid;
    key1[out] = (int32_t)f.h1;
    key2[out] = (int32_t)f.h2;
    valid[out] = ok ? 1 : 0;
  }
}

template <bool kK2, bool kDinuc>
cudaError_t launch_windows(const int32_t* rpacked, const int32_t* lengths,
                           long long nreads, int nw, const WindowParams& wp,
                           int width, int min_dinuc, uint32_t m1, uint32_t m2,
                           int32_t* key1, int32_t* key2, uint8_t* valid,
                           cudaStream_t stream) {
  // An odd stride is free of bank conflicts as it is; an even one is padded.
  const int ld = muscato::kStage ? (nw | 1) : nw + 1;
  // Rows of the tile, the 16-byte rounding of a staged span's two ends
  // (32 bytes) and the kernel's static shared memory; rows of 48 words or
  // more (reads of 380 bases) get a smaller tile.
  const long long row_bytes = 4LL * ld, slack = 64;
  const int tile = (int)min((long long)kThreads, (kSmemBytes - slack) / row_bytes);
  if (tile < 1) return cudaErrorInvalidValue;  // a row too long for any tile
  const long long blocks = (nreads + tile - 1) / tile;
  const int threads = min(kThreads, (tile + 31) & ~31);
  window_queries_kernel<kK2, kDinuc>
      <<<(unsigned)blocks, threads, (size_t)(tile * row_bytes + 32), stream>>>(
      rpacked, lengths, nreads, nw, ld, tile, wp, width, min_dinuc, m1, m2, key1,
      key2, valid);
  return cudaGetLastError();
}

}  // namespace

// params: host array of 3*nwin ints (w0, sh, gate per window), at most
// kMaxWindows windows a launch: ops/window_queries.py launches more in
// groups, each writing from its first window's row of key1, key2 and
// valid (offset pointers).
extern "C" int muscato_window_queries(const void* rpacked, const void* lengths,
                                      long long nreads, int nw,
                                      const void* params, int nwin, int width,
                                      int min_dinuc, unsigned int m1,
                                      unsigned int m2, int use_k2, void* key1,
                                      void* key2, void* valid, void* stream) {
  if (nwin < 1 || nwin > kMaxWindows || nw < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  if (nreads <= 0) return (int)cudaGetLastError();
  WindowParams wp;
  wp.nwin = nwin;
  const long long* p = (const long long*)params;
  for (int k = 0; k < nwin; ++k) {
    wp.w0[k] = (int)p[3 * k];
    wp.sh[k] = (int)p[3 * k + 1];
    wp.gate[k] = p[3 * k + 2];
  }
  auto launch = use_k2 ? (min_dinuc > 0 ? launch_windows<true, true>
                                        : launch_windows<true, false>)
                       : (min_dinuc > 0 ? launch_windows<false, true>
                                        : launch_windows<false, false>);
  return (int)launch((const int32_t*)rpacked, (const int32_t*)lengths, nreads, nw,
                     wp, width, min_dinuc, (uint32_t)m1, (uint32_t)m2,
                     (int32_t*)key1, (int32_t*)key2, (uint8_t*)valid,
                     (cudaStream_t)stream);
}
