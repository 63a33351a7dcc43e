// B7 verify_diagonals: the SWAR body of the dedup verify.  For every lane j
// of a (d, r)-sorted chunk, with dc = clamp(d, 0, smax - 1) and the lane's
// nwords + 1 target words starting at word (dc >> 3) & 7 of its row of
// t_rows (B4's output), it emits
//   nx     = mismatching bases of the read rpacked[clamp(r)] against the
//            target under diagonal dc, over the read's length (X codes are
//            4, so X against X matches),
//   s      = dc - gstart (the read start in its gene),
//   okbits = bit k when the window at q1s[k] passes: dc + q1k < gend, the
//            fit check (rlen + s <= glen; at q1k == 0 and s == 0 the
//            reference's pos-0 cap rlen <= min(glen, 100 - width)) and no
//            mismatch in nibbles [q1k, q1k + width); 0 unless r >= 0,
//            d >= 0 and nx <= budget[clamp(rlen)].
//
// Replaces the XLA body of muscato_tpu/ops/packed.py:verify_diagonals_packed
// (its SWAR lines, which XLA fuses between the B3 gene lookup and the B4
// row gather inside _verify_diagonals_impl's while loop; there is no
// pl.pallas_call).  Its plain twin is
// muscato_tpu_torch/ops/packed.py:verify_diagonals_swar_torch, which runs
// the same steps as int64 tensor passes, every lane exact.
//
// Bound on the card: bytes.  A flagship chunk of 2**20 lanes at 13-word
// reads reads 8 bytes of (r, d), 56 of target words, 56 of read row and
// length and 8 of (gstart, gend) a lane and writes 12: ~136 MB with each
// read row counted once, 0.041 ms at 3.35 TB/s.  Its integer work is ~320 operations a lane (a funnel
// shift, xor, length mask, three shift-ors and a popcount a word, and an
// and and a popcount a (window, word)), 0.02 ms on one pipe.  The design
// is the simple one: a thread a lane, read-only loads through __ldg, the
// words streamed with the previous target word in a register (so no word
// count is compiled in), the aligned word one __funnelshift_r (which is
// the twin's lowpart | hipart, rshift 0 included).  The window masks are
// applied only to words that hold a mismatch while the running nx is
// still within the budget: a lane over its budget gets okbits 0 whatever
// its windows say, and a lane within it has at most budget + 1 words with
// mismatches, so the window loop costs a few words a lane and not
// nwin x nwords.  Windows arrive by value (a kernel parameter, read from
// the constant bank), at most kMaxWindows of them.  Neighbouring threads
// read target rows 88 bytes apart and read rows from anywhere in
// rpacked, so each load of a warp touches 32 sectors.  The read rows set
// the time: on an H100 a flagship chunk takes 0.53 ms with random reads
// and 0.12 ms with every lane on one read (micro_verify's tuned modes),
// against the 0.041 ms bound.  A warp-cooperative or TMA-staged load of
// the rows is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWindows = 32;
constexpr int kThreads = 256;

struct Windows {
  int n;
  int q1[kMaxWindows];
};

// The low k nibbles set, k clamped to [0, 8].
__device__ __forceinline__ uint32_t nib_mask(int k) {
  k = min(max(k, 0), 8);
  return k >= 8 ? 0xFFFFFFFFu : (1u << (4 * k)) - 1u;
}

__global__ void __launch_bounds__(kThreads)
    verify_diagonals_kernel(const int32_t* __restrict__ r, const int32_t* __restrict__ d,
                            long long n, const uint32_t* __restrict__ t_rows, int tcols,
                            const uint32_t* __restrict__ rpacked, int nreads, int nwords,
                            const int32_t* __restrict__ lengths,
                            const int32_t* __restrict__ gstart,
                            const int32_t* __restrict__ gend,
                            const int32_t* __restrict__ budget, int nbudget,
                            const Windows win, int width, int smax,
                            int32_t* __restrict__ nx_out, int32_t* __restrict__ s_out,
                            int32_t* __restrict__ ok_out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int rj = __ldg(r + j), dj = __ldg(d + j);
  const int rc = min(max(rj, 0), nreads - 1);
  const int dc = min(max(dj, 0), smax - 1);
  const int gs = __ldg(gstart + j), ge = __ldg(gend + j);
  const int s = dc - gs;
  const int rlen = __ldg(lengths + rc);
  const int bud = __ldg(budget + min(max(rlen, 0), nbudget - 1));

  const uint32_t* t = t_rows + j * tcols + ((dc >> 3) & 7);
  const uint32_t* rw = rpacked + (long long)rc * nwords;
  const int rshift = (dc & 7) * 4;
  uint32_t prev = __ldg(t);
  int nx = 0;
  uint32_t bad = 0;  // windows holding a mismatch
  for (int w = 0; w < nwords; ++w) {
    const uint32_t next = __ldg(t + w + 1);
    uint32_t x = __funnelshift_r(prev, next, rshift) ^ __ldg(rw + w);
    prev = next;
    x &= nib_mask(rlen - 8 * w);
    const uint32_t nz = (x | (x >> 1) | (x >> 2) | (x >> 3)) & 0x11111111u;
    nx += __popc(nz);
    if (nz != 0 && nx <= bud) {
      for (int k = 0; k < win.n; ++k) {
        const int q1 = win.q1[k] - 8 * w;
        if (nz & nib_mask(q1 + width) & ~nib_mask(q1)) bad |= 1u << k;
      }
    }
  }

  uint32_t ok = 0;
  if (rj >= 0 && dj >= 0 && nx <= bud) {
    const int glen = ge - gs;
    const bool fit_norm = rlen + s <= glen;
    const bool fit_pos0 = rlen <= min(glen, 100 - width);
    for (int k = 0; k < win.n; ++k) {
      const int q1 = win.q1[k];
      const bool fit = (q1 == 0 && s == 0) ? fit_pos0 : fit_norm;
      if (dc + q1 < ge && fit && !((bad >> k) & 1u)) ok |= 1u << k;
    }
  }
  nx_out[j] = nx;
  s_out[j] = s;
  ok_out[j] = (int32_t)ok;
}

}  // namespace

// q1s: host array of nwin window offsets.  t_rows holds tcols >= nwords + 8
// words a lane.
extern "C" int muscato_verify_diagonals(
    const void* r, const void* d, long long n, const void* t_rows, int tcols,
    const void* rpacked, int nreads, int nwords, const void* lengths,
    const void* gstart, const void* gend, const void* budget, int nbudget,
    const void* q1s, int nwin, int width, int smax, void* nx, void* s, void* okbits,
    void* stream) {
  if (nwin < 0 || nwin > kMaxWindows || nwords < 1 || tcols < nwords + 8 ||
      nreads < 1 || nbudget < 1 || smax < 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  Windows win;
  win.n = nwin;
  for (int k = 0; k < nwin; ++k) win.q1[k] = ((const int*)q1s)[k];
  const long long blocks = (n + kThreads - 1) / kThreads;
  verify_diagonals_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)r, (const int32_t*)d, n, (const uint32_t*)t_rows, tcols,
      (const uint32_t*)rpacked, nreads, nwords, (const int32_t*)lengths,
      (const int32_t*)gstart, (const int32_t*)gend, (const int32_t*)budget, nbudget, win,
      width, smax, (int32_t*)nx, (int32_t*)s, (int32_t*)okbits);
  return (int)cudaGetLastError();
}
