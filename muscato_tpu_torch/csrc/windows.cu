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
// Bound on the card: memory bandwidth.  Each read row is read once, staged
// by a CTA into shared memory with coalesced loads (row stride padded to an
// odd word count, so the per-read word reads of a warp hit 32 distinct
// banks), and each output is written once, coalesced: consecutive threads
// take consecutive reads of one window.  The arithmetic is native uint32
// (the twin's int64 emulation is what the CPU needs): one funnel shift per
// aligned word, a multiply-add per base and key, and __popc of the mask.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWindows = 64;
constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;

struct WindowParams {
  int nwin;
  int w0[kMaxWindows];    // first sliced word of each window (clipped)
  int sh[kMaxWindows];    // funnel shift in bits, in [0, 31]
  long long gate[kMaxWindows];  // q1 + width: the length gate
};

__global__ void window_queries_kernel(const int32_t* __restrict__ rpacked,
                                      const int32_t* __restrict__ lengths,
                                      long long nreads, int nw, int ld,
                                      int tile, WindowParams wp, int width,
                                      int min_dinuc, uint32_t m1, uint32_t m2,
                                      int use_k2, int32_t* __restrict__ key1,
                                      int32_t* __restrict__ key2,
                                      uint8_t* __restrict__ valid) {
  extern __shared__ uint32_t rows[];  // tile x ld words
  const long long r0 = (long long)blockIdx.x * tile;
  const int nt = (int)min((long long)tile, nreads - r0);

  // Stage the tile's rows: they are contiguous in global memory.
  const int32_t* src = rpacked + r0 * nw;
  for (int i = threadIdx.x; i < nt * nw; i += blockDim.x) {
    int r = i / nw;
    rows[r * ld + (i - r * nw)] = (uint32_t)__ldg(src + i);
  }
  __syncthreads();

  const int nal = (width + 7) >> 3;  // aligned words covering the window
  for (int it = threadIdx.x; it < nt * wp.nwin; it += blockDim.x) {
    const int k = it / nt;
    const int r = it - k * nt;
    const uint32_t* row = rows + r * ld;
    const int w0 = wp.w0[k];
    const int sh = wp.sh[k];
    uint32_t h1 = 0, h2 = 0, bits = 0, prev = 0;
    uint32_t hi = (w0 < nw) ? row[w0] : 0u;
    for (int j = 0; j < nal; ++j) {
      const uint32_t lo = hi;
      hi = (w0 + j + 1 < nw) ? row[w0 + j + 1] : 0u;
      // (hi:lo) >> sh; sh == 0 gives lo alone, as the twin does.
      const uint32_t al = __funnelshift_r(lo, hi, sh);
      const int nb = min(8, width - 8 * j);
      for (int q = 0; q < nb; ++q) {
        const uint32_t b = (al >> (4 * q)) & 0xFu;
        h1 = h1 * m1 + b;
        if (use_k2) h2 = h2 * m2 + b;
        if (min_dinuc > 0 && (j | q)) {
          // prev*5 + b reaches 90 for garbage nibbles; a shift past bit
          // 31 is undefined in CUDA, and the twin gives 0 there.
          const uint32_t pr = prev * 5u + b;
          bits |= (pr < 32u) ? (1u << pr) : 0u;
        }
        prev = b;
      }
    }
    bool ok = (long long)__ldg(lengths + r0 + r) >= wp.gate[k];
    if (min_dinuc > 0) ok = ok && (__popc(bits) >= min_dinuc);
    const long long out = (long long)k * nreads + r0 + r;
    key1[out] = (int32_t)h1;
    key2[out] = (int32_t)h2;
    valid[out] = ok ? 1 : 0;
  }
}

}  // namespace

// params: host array of 3*nwin ints (w0, sh, gate per window).
extern "C" int muscato_window_queries(const void* rpacked, const void* lengths,
                                      long long nreads, int nw,
                                      const void* params, int nwin, int width,
                                      int min_dinuc, unsigned int m1,
                                      unsigned int m2, int use_k2, void* key1,
                                      void* key2, void* valid, void* stream) {
  if (nwin < 1 || nwin > kMaxWindows || nw < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  if (nreads > 0) {
    WindowParams wp;
    wp.nwin = nwin;
    const long long* p = (const long long*)params;
    for (int k = 0; k < nwin; ++k) {
      wp.w0[k] = (int)p[3 * k];
      wp.sh[k] = (int)p[3 * k + 1];
      wp.gate[k] = p[3 * k + 2];
    }
    const int ld = nw | 1;  // odd stride: conflict-free per-read word reads
    int tile = kSmemBytes / (ld * 4);
    if (tile > kThreads) tile = kThreads;
    if (tile < 1) return (int)cudaErrorInvalidValue;
    const long long blocks = (nreads + tile - 1) / tile;
    window_queries_kernel<<<(unsigned)blocks, kThreads,
                            (size_t)tile * ld * 4, (cudaStream_t)stream>>>(
        (const int32_t*)rpacked, (const int32_t*)lengths, nreads, nw, ld, tile,
        wp, width, min_dinuc, (uint32_t)m1, (uint32_t)m2, use_k2,
        (int32_t*)key1, (int32_t*)key2, (uint8_t*)valid);
  }
  return (int)cudaGetLastError();
}
