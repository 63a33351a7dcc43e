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
// read row counted once, 0.041 ms at 3.35 TB/s.  Counted in the 32-byte
// sectors the memory system moves, a read row (52 bytes anywhere) takes
// two or three sectors and its length a sector of its own, so the same
// data is ~1.6x those bytes.  Its integer work is ~320 operations a lane
// (a funnel shift, xor, length mask, three shift-ors and a popcount a
// word, and an and and a popcount a (window, word)), 0.02 ms on one pipe.
//
// The arithmetic (verify_lane) is one thread a lane: the words streamed
// with the previous target word in a register (so no word count is
// compiled in), the aligned word one __funnelshift_r (the twin's lowpart
// | hipart, rshift 0 included), the window masks applied only to words
// that hold a mismatch while the running nx is still within the budget (a
// lane over its budget gets okbits 0 whatever its windows say, and a lane
// within it has at most budget + 1 words with mismatches, so the window
// loop costs a few words a lane and not nwin x nwords).  Windows arrive
// by value (a kernel parameter, read from the constant bank), at most
// kMaxWindows of them.
//
// What bounded the first design (one thread a lane reading its rows from
// global memory, kept as verify_diagonals_direct_kernel and built under
// -DMUSCATO_NO_STAGE): neighbouring threads read target rows 88 bytes
// apart and read rows from anywhere in rpacked, so every warp load
// touched 32 sectors, and a loop whose trip count is a runtime nwords
// used each load at once.  On an H100 a flagship chunk took 0.53 ms with
// random reads and 0.12 ms with every lane on one read, against the
// 0.041 ms bound: the latency of the read-row loads set the time.
//
// The staged design moves every byte a tile needs into shared memory
// before any is used, with all its loads in flight at once:
//  - A tile is one CTA of 256 lanes, or of 128, 64 or 32 when the rows of
//    256 do not fit (pick_tile: reads past 864 bases at B4's row width;
//    reads of 4096 bases fit in tiles of 32 lanes, and reads past 903
//    words take the direct kernel).  Its target rows t_rows[j0, j0 + tile) are one
//    contiguous span of tile * tcols words, copied by one bulk async copy
//    on an mbarrier (bulk.cuh's stage_words: whole 16-byte groups in bulk,
//    a ragged end and an unaligned t_rows by plain loads).
//  - Each warp gathers its 32 lanes' read rows as one flat run of 32 *
//    nwords words: word f goes to thread f % 32 from row f / nwords of the
//    warp (its index from that lane's register by a shuffle), so a warp
//    instruction reads about three neighbouring rows' words, a few
//    sectors, where a thread a row touched 32.  The loads are 4-byte
//    cp.async (LDGSTS), all issued before one wait, so no register holds
//    them and their latencies overlap.  Rows land nwords | 1 words apart:
//    an odd stride, so the threads' word reads that follow hit 32 banks.
//  - The target rows keep t_rows' stride tcols (the bulk copy cannot pad
//    them); with an even tcols and each lane's own word offset, a warp's
//    reads of them share banks a few ways.  chip_smoke.py's verify_phase
//    counts those wavefronts from the chunk's addresses.
//  - Dead lanes (r < 0, the chunk's padded tail) run the same code: the
//    twin gives them an nx over read 0 against their own row, and being
//    exact on every lane keeps those loads (read 0 is one row, and a warp
//    of dead lanes gathers it in two sectors a load).
//  - Shared memory is 16 bytes (the barrier) + 4 * tile * (tcols +
//    (nwords | 1)) bytes, sized at launch: 36 KB at the flagship's 13-word
//    reads and 22-word rows (six CTAs an SM), 61 KB at 25-word reads, 132
//    KB for 32 lanes of 4096-base reads.  A shape whose 32-lane tile passes
//    the device's opt-in limit (reads past 903 words, ~7,200 bases, at
//    B4's rows: 232,448 bytes on an H100) takes the direct kernel, which
//    needs no shared memory and takes any shape (pick_tile; the wrapper
//    counts those launches apart).
// Independent CTAs, several to an SM, overlap one tile's copies with
// another's arithmetic.
//
// What bounds it now (chip_smoke.py's verify_phase on an H100 80GB HBM3
// at 700 W, the flagship chunk): 0.134-0.141 ms back to back, against
// 0.474-0.483 ms for the first design.  With every live lane on read 0
// the two designs take about the same time (0.056-0.058 ms in one run):
// staging pays only on the scattered read rows.  Those rows and their
// lengths, ~1M rows of 52 bytes and entries of 4 at random in 218 MB and
// 16 MB of tables, add the other ~0.08 ms, less than PyTorch's
// index_select of the same rows and lengths alone (0.090 ms): the card's
// rate for scattered sectors, not the kernel, sets that part.  The rest
// (the tiles' contiguous target rows, the lane arrays and the outputs)
// streams at about 2 TB/s.  A ring of two stages in persistent CTAs (tile
// i + 1's copies and gathers in flight while tile i computes) was measured
// slower, 0.153-0.159 ms (PERF.md keeps the numbers): its registers and
// two stages a CTA left half the warps an SM, and independent CTAs already
// overlap one another's loads.

#include <cstdint>
#include <cuda_runtime.h>

#include "bulk.cuh"

namespace {

constexpr int kMaxWindows = 32;
constexpr int kTile = 256;  // the most lanes a tile, one a thread (the direct kernel's block)
constexpr int kBarBytes = 16;  // the mbarrier, padded so the stage is 16-byte aligned

struct Windows {
  int n;
  int q1[kMaxWindows];
};

// The low k nibbles set, k clamped to [0, 8].
__device__ __forceinline__ uint32_t nib_mask(int k) {
  k = min(max(k, 0), 8);
  return k >= 8 ? 0xFFFFFFFFu : (1u << (4 * k)) - 1u;
}

template <bool kGlobal>
__device__ __forceinline__ uint32_t load_word(const uint32_t* p) {
  if constexpr (kGlobal) return __ldg(p);
  else return *p;
}

// One lane's outputs from its target words t[0, nwords] (already offset
// by (dc >> 3) & 7) and read words rw[0, nwords), in global memory
// (kGlobal) or shared memory.
template <bool kGlobal>
__device__ __forceinline__ void verify_lane(long long j, int rj, int dj, int dc, int gs,
                                            int ge, int rlen, int bud,
                                            const uint32_t* t, const uint32_t* rw,
                                            int nwords, const Windows& win, int width,
                                            int32_t* __restrict__ nx_out,
                                            int32_t* __restrict__ s_out,
                                            int32_t* __restrict__ ok_out) {
  const int s = dc - gs;
  const int rshift = (dc & 7) * 4;
  uint32_t prev = load_word<kGlobal>(t);
  int nx = 0;
  uint32_t bad = 0;  // windows holding a mismatch
  for (int w = 0; w < nwords; ++w) {
    const uint32_t next = load_word<kGlobal>(t + w + 1);
    uint32_t x = __funnelshift_r(prev, next, rshift) ^ load_word<kGlobal>(rw + w);
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

// The first design: a thread a lane, every word read from global memory.
// Built into every library: the route of a shape whose staged tile does
// not fit in shared memory, and the only kernel under -DMUSCATO_NO_STAGE.
__global__ void __launch_bounds__(kTile)
    verify_diagonals_direct_kernel(const int32_t* __restrict__ r,
                                   const int32_t* __restrict__ d, long long n,
                                   const uint32_t* __restrict__ t_rows, int tcols,
                                   const uint32_t* __restrict__ rpacked, int nreads,
                                   int nwords, const int32_t* __restrict__ lengths,
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
  const int rlen = __ldg(lengths + rc);
  const int bud = __ldg(budget + min(max(rlen, 0), nbudget - 1));
  verify_lane<true>(j, rj, dj, dc, __ldg(gstart + j), __ldg(gend + j), rlen, bud,
                    t_rows + j * tcols + ((dc >> 3) & 7),
                    rpacked + (long long)rc * nwords, nwords, win, width, nx_out, s_out,
                    ok_out);
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(muscato::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// One flat run of the warp's 32 rows of `words` words each into s (rows
// `stride` words apart), as cp.async copies: word f of the run is word
// f % words of row f / words, whose first source word, src + at(key), the
// shuffle takes from that row's lane.  Every thread takes `words` turns
// (the shuffle needs them all); rows at or past `live` load nothing.
template <class At>
__device__ __forceinline__ void stage_run(uint32_t* s, int stride, const uint32_t* src, int key,
                                          At at, int words, int live, int lane) {
  const int step_rows = 32 / words, step_words = 32 % words;
  int row = lane / words, word = lane % words;
  for (int f = lane; f < 32 * words; f += 32) {
    const int k = __shfl_sync(0xffffffffu, key, row);
    if (row < live) cp_async4(s + row * stride + word, src + at(k) + word);
    row += step_rows;
    word += step_words;
    if (word >= words) {
      word -= words;
      ++row;
    }
  }
}

// The lanes of a warp inside the chunk, of the 32 from lane j0w on.
__device__ __forceinline__ int live_lanes(long long j0w, long long n) {
  return (int)min(32LL, max(0LL, n - j0w));
}

// The staged design (see the note above): a CTA a tile of blockDim.x
// lanes, a multiple of 32.
__global__ void __launch_bounds__(kTile)
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
  extern __shared__ __align__(16) unsigned char s_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_raw);
  uint32_t* s_t = reinterpret_cast<uint32_t*>(s_raw + kBarBytes);  // tile x tcols
  const int tile = blockDim.x, rstride = nwords | 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* s_r = s_t + tile * tcols + warp * 32 * rstride;  // this warp's 32 read rows

  // The tile's target rows, in one bulk copy: issued first, as it needs
  // no lane's data.
  const long long j0 = (long long)blockIdx.x * tile;
  bool bulk;
  const long long base = muscato::stage_words(t_rows, n * tcols, j0 * tcols,
                                              min(j0 + tile, n) * tcols, s_t, bar, &bulk);
  const long long j = j0 + threadIdx.x;
  const bool in = j < n;
  const int rj = in ? __ldg(r + j) : -1;
  const int dj = in ? __ldg(d + j) : 0;
  const int gs = in ? __ldg(gstart + j) : 0;
  const int ge = in ? __ldg(gend + j) : 0;
  const int rc = min(max(rj, 0), nreads - 1);
  const int dc = min(max(dj, 0), smax - 1);
  // The warp's read rows, one flat run in one cp.async group.
  stage_run(s_r, rstride, rpacked, rc, [=](int k) { return (long long)k * nwords; }, nwords,
            live_lanes(j0 + warp * 32, n), lane);
  asm volatile("cp.async.commit_group;" ::: "memory");
  const int rlen = __ldg(lengths + rc);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  const int bud = __ldg(budget + min(max(rlen, 0), nbudget - 1));
  __syncthreads();  // the barrier's init, the plain-loaded words, the read rows
  muscato::stage_wait(bar, bulk);
  if (!in) return;
  verify_lane<false>(j, rj, dj, dc, gs, ge, rlen, bud,
                     s_t + (j * tcols - base) + ((dc >> 3) & 7), s_r + lane * rstride,
                     nwords, win, width, nx_out, s_out, ok_out);
}



// Shared memory a tile of `lanes` lanes takes: its barrier, its target rows
// at t_rows' stride and its read rows at an odd stride.
size_t tile_smem(int lanes, int nwords, int tcols) {
  return kBarBytes + 4 * (size_t)lanes * ((size_t)tcols + (nwords | 1));
}

// The tile the launcher takes for reads of nwords words and rows of tcols
// words on the current device: the widest of 256, 128, 64 and 32 lanes
// whose shared memory fits the device's opt-in limit a block.  A narrower
// tile only lets long reads (past ~860 bases with B4's rows) fit; it keeps
// the design and, on an H100, about the same time a lane.  When not even
// 32 lanes fit, and always under -DMUSCATO_NO_STAGE, it is the direct
// kernel's: kTile lanes and no shared memory (*smem 0).
cudaError_t pick_tile(int nwords, int tcols, int* lanes, size_t* smem) {
  *lanes = kTile;
  *smem = 0;
  if constexpr (!muscato::kStage) return cudaSuccess;
  int dev, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (int l = kTile; l >= 32; l /= 2) {
    if (tile_smem(l, nwords, tcols) <= (size_t)optin) {
      *lanes = l;
      *smem = tile_smem(l, nwords, tcols);
      break;
    }
  }
  return e;
}

// ---- B10 verify_pairs: the streaming expand's per-pair verify ----------
//
// For every lane j of a streaming chunk (one (read, window position) pair
// a lane, in the probe's lo order: neither its read rows nor its positions
// are monotone), with rc = clamp(r), pc = clamp(p, 0, smax - 1) and q1 the
// lane's window offset (q1v[j], or the scalar q1 when q1v is null), it
// emits
//   g    = the gene owning pc (gene_of_pos_block: bounds from
//          gblock[pc >> 8] and gblock[(pc >> 8) + 1], then gsteps
//          branchless refines on gene_start[mid] <= pc),
//   s    = pc - gene_start[g] - q1 (the read start in the gene),
//   nx   = mismatching bases of rpacked[rc] against the target under the
//          diagonal dc = max(pc - q1, 0), over the read's length,
//   keep = r >= 0, p >= 0, s >= 0, the right-tail fit with the
//          reference's pos-0 cap (rlen - q2 <= min(glen, cap) - (pl +
//          width), cap = 100 - q2 where pl == 0 and q1 == 0, else pl +
//          width + max_read_length - q2; pl = pc - gene_start[g], q2 = q1 +
//          width), no mismatch in nibbles [q1, q2) and nx <= budget[rlen].
//
// Replaces the XLA body of muscato_tpu/ops/packed.py:verify_pairs_packed
// (:432; there is no pl.pallas_call), which the JAX package's streaming
// expand runs once a chunk inside the lax.while_loop of
// muscato_tpu/ops/fused.py:_expand_verify_impl.  Its plain twin is
// muscato_tpu_torch/ops/packed.py:verify_pairs_packed_torch, the same steps
// as int64 tensor passes (about 100 launches a chunk), every lane exact.
//
// Bound on the card: bytes.  131,072 lanes of 13-word reads read about 190
// bytes a lane (r, p, q1, the read row and length, 56 bytes of target
// words, ~10 gene-table words) and write 13: ~25 MB, 0.008 ms at 3.35 TB/s
// (0.0056 ms with each read row counted once, chip_smoke.py's call_work;
// more in the 32-byte sectors the scattered rows and windows touch, its
// pairs_sector_bytes); its integer work is ~250 operations a lane, 0.002
// ms on one pipe.
//
// The first design (verify_pairs_thread_kernel, built under
// -DMUSCATO_NO_STAGE) is one thread a lane in blocks of kTile,
// every load a __ldg: the lane's nwords + 1 target words from its row of
// trows (dc >> 6, clamped) at word (dc >> 3) & 7, the row and column the
// twin's 3-level select picks, and its read row.  In the probe's lo order
// neither the read rows nor the target rows of neighbouring lanes are
// neighbours, so each of its word loop's 27 warp loads touched 32 rows,
// one after another in a loop of runtime length, behind a chain of 2 +
// gsteps + 2 dependent gene-table loads.
//
// The staged design (verify_pairs_kernel) follows B7's read-row gather:
//  - A CTA is one warp of 32 lanes.  It stages its lanes'
//    rows into shared memory: the read rows (nwords words) and the target
//    windows (nwords + 1 words from the lane's word offset in its trows
//    row) as two flat runs, word f of a run from row f / words, whose
//    source the shuffle takes from that lane (stage_run).  A warp load
//    then reads a few neighbouring rows' words, a few sectors, where a
//    thread a row touched 32.  The copies are 4-byte cp.async (rows of 13
//    words are not 16-byte aligned), all issued before one wait, so every
//    row of the warp is in flight at once and no register holds them.
//  - Between the copies' issue and their wait the lane runs its gene
//    lookup (gene_of): gblock and gene_start are 1.5 and 0.4 MB on the
//    flagship, so that chain runs from L2 while the rows land.
//  - After the wait and __syncwarp (a warp reads only the rows it staged),
//    the compare (pair_lane) runs from shared memory: rows land at an
//    odd stride (nwords | 1 and (nwords + 1) | 1 words), so a word of the
//    32 lanes' rows falls in 32 banks.
//  - Shared memory is 4 * 32 * ((nwords | 1) + ((nwords + 1) | 1)) bytes:
//    3.6 KB at the flagship's 13-word reads, 131 KB at 4096-base reads (512
//    words).  Reads past 907 words, whose tile passes the device's opt-in
//    limit, take the thread kernel, which needs no shared memory
//    (pick_pairs_tile; the wrapper counts those launches apart).
//  - Lanes past n load nothing and store nothing; dead lanes (r or p < 0)
//    run the same code, as the twin computes their nx, g and s.
//
// What bounds it now (chip_smoke.py on an H100 80GB HBM3 at 700 W; PERF.md
// keeps the numbers): the streaming flagship's 84 calls, replayed, take
// 1.65-1.67 ms of device time against 2.98-3.02 ms for the first design,
// 0.020 ms a call.  A chunk touches 28.8 MB of distinct 32-byte sectors
// (its sector bound, 0.0086 ms: the lane arrays, and read rows, windows and
// lengths scattered over 218, 137 and 16 MB of tables), which it reads at
// ~1.46 TB/s: the rate of scattered sectors, as for B7's read rows, sets
// it.  Tiles of 64, 128 and 256 lanes (the same code, more warps a CTA)
// took 2.14-2.25 ms, and the first design launched in CTAs of 32 lanes
// 3.56-3.67 ms (PERF.md keeps their times): the staging and the
// one-warp CTA each pay.

// The owning gene of position pc, as gene_of_pos_block finds it: returns
// it and sets *gstart and *glen.
__device__ __forceinline__ int gene_of(int pc, const int32_t* __restrict__ gene_start,
                                       int ngs, const int32_t* __restrict__ gblock,
                                       int nblock, int gsteps, int* gstart, int* glen) {
  const int glast = ngs - 1;
  const int b = pc >> 8;
  int lo = __ldg(gblock + min(max(b, 0), nblock - 1));
  int hi = __ldg(gblock + min(max(b + 1, 0), nblock - 1));
  for (int i = 0; i < gsteps; ++i) {
    const int mid = (lo + hi + 1) >> 1;
    const bool up = __ldg(gene_start + min(max(mid, 0), glast)) <= pc;
    lo = up ? mid : lo;
    hi = up ? hi : mid - 1;
  }
  *gstart = __ldg(gene_start + min(max(lo, 0), glast));
  *glen = __ldg(gene_start + min(max(lo + 1, 0), glast)) - *gstart;
  return lo;
}

// One lane's fit, compare and stores, given its gene; t and rw in global
// memory (kGlobal) or shared memory.  The SWAR compare streams the target
// words t[0, nwords] (already offset by (dc >> 3) & 7) with the previous
// word in a register, aligned by one __funnelshift_r, so no word count is
// compiled in; each word's nibbles fold to one bit, counted by __popc for
// nx and, masked to the lane's window [q1, q2), for its window.
template <bool kGlobal>
__device__ __forceinline__ void pair_lane(long long j, int rj, int pj, int pc, int q1,
                                          int rlen, int bud, int g, int gstart, int glen,
                                          const uint32_t* t, const uint32_t* rw, int nwords,
                                          int width, int max_read_length,
                                          uint8_t* __restrict__ keep_out,
                                          int32_t* __restrict__ nx_out,
                                          int32_t* __restrict__ g_out,
                                          int32_t* __restrict__ s_out) {
  const int pl = pc - gstart;
  const int s = pl - q1;
  const int q2 = q1 + width;
  const int cap = (pl == 0 && q1 == 0) ? 100 - q2 : pl + width + (max_read_length - q2);
  const bool fit = rlen - q2 <= min(glen, cap) - (pl + width);
  const int rshift = (max(pc - q1, 0) & 7) * 4;
  uint32_t prev = load_word<kGlobal>(t);
  int nx = 0, win = 0;
  for (int w = 0; w < nwords; ++w) {
    const uint32_t next = load_word<kGlobal>(t + w + 1);
    uint32_t x = __funnelshift_r(prev, next, rshift) ^ load_word<kGlobal>(rw + w);
    prev = next;
    x &= nib_mask(rlen - 8 * w);
    const uint32_t nz = (x | (x >> 1) | (x >> 2) | (x >> 3)) & 0x11111111u;
    nx += __popc(nz);
    win += __popc(nz & nib_mask(q2 - 8 * w) & ~nib_mask(q1 - 8 * w));
  }
  keep_out[j] = rj >= 0 && pj >= 0 && s >= 0 && fit && win == 0 && nx <= bud;
  nx_out[j] = nx;
  g_out[j] = g;
  s_out[j] = s;
}

#define MUSCATO_PAIRS_PARAMS                                                             \
  const int32_t *__restrict__ r, const int32_t *__restrict__ p, long long n,             \
      const int32_t *__restrict__ q1v, int q1s, const uint32_t *__restrict__ trows,      \
      int ntrows, int tcols, const uint32_t *__restrict__ rpacked, int nreads, int nwords, \
      const int32_t *__restrict__ lengths, const int32_t *__restrict__ gene_start, int ngs, \
      const int32_t *__restrict__ gblock, int nblock, int gsteps,                        \
      const int32_t *__restrict__ budget, int nbudget, int width, int max_read_length,   \
      int smax, uint8_t *__restrict__ keep_out, int32_t *__restrict__ nx_out,            \
      int32_t *__restrict__ g_out, int32_t *__restrict__ s_out

// The first design: a thread a lane, every word read from global memory.
// Built into every library: the route of reads whose staged tile does not
// fit in shared memory, and the only kernel under -DMUSCATO_NO_STAGE.
__global__ void __launch_bounds__(kTile) verify_pairs_thread_kernel(MUSCATO_PAIRS_PARAMS) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int rj = __ldg(r + j), pj = __ldg(p + j);
  const int q1 = q1v ? __ldg(q1v + j) : q1s;
  const int rc = min(max(rj, 0), nreads - 1);
  const int pc = min(max(pj, 0), smax - 1);
  const int rlen = __ldg(lengths + rc);
  int gstart, glen;
  const int g = gene_of(pc, gene_start, ngs, gblock, nblock, gsteps, &gstart, &glen);
  const int dc = max(pc - q1, 0);
  const int row = min(max(dc >> 6, 0), ntrows - 1);
  const int bud = __ldg(budget + min(max(rlen, 0), nbudget - 1));
  pair_lane<true>(j, rj, pj, pc, q1, rlen, bud, g, gstart, glen,
                  trows + (long long)row * tcols + ((dc >> 3) & 7),
                  rpacked + (long long)rc * nwords, nwords, width, max_read_length, keep_out,
                  nx_out, g_out, s_out);
}

// The staged design (see the note above): a CTA a warp of 32 lanes,
// staging its lanes' rows.
__global__ void __launch_bounds__(32) verify_pairs_kernel(MUSCATO_PAIRS_PARAMS) {
  extern __shared__ __align__(16) uint32_t s_pairs[];
  const int rstride = nwords | 1, tstride = (nwords + 1) | 1;
  const int lane = threadIdx.x;
  uint32_t* s_r = s_pairs;              // the read rows
  uint32_t* s_t = s_r + 32 * rstride;  // and the target windows
  const long long j0w = (long long)blockIdx.x * 32;
  const long long j = j0w + lane;
  const bool in = j < n;
  const int rj = in ? __ldg(r + j) : -1;
  const int pj = in ? __ldg(p + j) : -1;
  const int q1 = (q1v && in) ? __ldg(q1v + j) : q1s;
  const int rc = min(max(rj, 0), nreads - 1);
  const int pc = min(max(pj, 0), smax - 1);
  const int dc = max(pc - q1, 0);
  const int row = min(max(dc >> 6, 0), ntrows - 1);  // < 2^25, so row << 3 fits
  const int live = live_lanes(j0w, n);
  stage_run(s_r, rstride, rpacked, rc, [=](int k) { return (long long)k * nwords; }, nwords,
            live, lane);
  stage_run(s_t, tstride, trows, (row << 3) | ((dc >> 3) & 7),
            [=](int k) { return (long long)(k >> 3) * tcols + (k & 7); }, nwords + 1, live,
            lane);
  asm volatile("cp.async.commit_group;" ::: "memory");
  // The loads that need no row, while the rows land.
  const int rlen = __ldg(lengths + rc);
  int gstart, glen;
  const int g = gene_of(pc, gene_start, ngs, gblock, nblock, gsteps, &gstart, &glen);
  const int bud = __ldg(budget + min(max(rlen, 0), nbudget - 1));
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncwarp();
  if (!in) return;
  pair_lane<false>(j, rj, pj, pc, q1, rlen, bud, g, gstart, glen, s_t + lane * tstride,
                   s_r + lane * rstride, nwords, width, max_read_length, keep_out, nx_out,
                   g_out, s_out);
}

// Shared memory a B10 tile of `lanes` lanes takes: its read rows and
// target windows at odd strides.
size_t pairs_smem(int lanes, int nwords) {
  return 4 * (size_t)lanes * ((size_t)(nwords | 1) + (size_t)((nwords + 1) | 1));
}

// The tile B10 takes for reads of nwords words: a warp of 32 lanes when
// their rows fit the device's opt-in shared memory a block; else, and
// always under -DMUSCATO_NO_STAGE, the thread kernel's blocks of kTile
// lanes and no shared memory (*smem 0).
cudaError_t pick_pairs_tile(int nwords, int* lanes, size_t* smem) {
  *lanes = kTile;
  *smem = 0;
  if constexpr (!muscato::kStage) return cudaSuccess;
  int dev, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (pairs_smem(32, nwords) <= (size_t)optin) {
    *lanes = 32;
    *smem = pairs_smem(32, nwords);
  }
  return e;
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, opting in
// past 48 KB; returns the launch's error (a failed opt-in is cleared, so
// a later launch does not report it).
template <class Kernel, class... Args>
cudaError_t launch_tile(Kernel kernel, long long n, int lanes, size_t smem,
                        cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
  }
  kernel<<<(unsigned)((n + lanes - 1) / lanes), lanes, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// The tile that muscato_verify_diagonals takes for reads of nwords words
// and t_rows of tcols words on the current device: its lanes and its
// shared memory in bytes (0: the direct kernel).
extern "C" int muscato_verify_tile(int nwords, int tcols, int* lanes, long long* smem) {
  size_t bytes = 0;
  const cudaError_t e = pick_tile(nwords, tcols, lanes, &bytes);
  *smem = (long long)bytes;
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// The same for muscato_verify_pairs (0 bytes: the thread kernel).
extern "C" int muscato_verify_pairs_tile(int nwords, int* lanes, long long* smem) {
  size_t bytes = 0;
  const cudaError_t e = pick_pairs_tile(nwords, lanes, &bytes);
  *smem = (long long)bytes;
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// q1s: host array of nwin window offsets.  t_rows holds tcols >= nwords + 8
// words a lane.  Refused (cudaErrorInvalidValue, nothing launched): more
// than kMaxWindows windows, narrower rows and empty tables.  A shape whose
// 32-lane tile exceeds the device's opt-in shared memory a block takes the
// direct kernel (muscato_verify_tile reports the route).
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
  int lanes;
  size_t smem;
  cudaError_t e = pick_tile(nwords, tcols, &lanes, &smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so a later launch does not report it
    return (int)e;
  }
  return (int)launch_tile(
      smem ? verify_diagonals_kernel : verify_diagonals_direct_kernel, n, lanes, smem,
      (cudaStream_t)stream, (const int32_t*)r, (const int32_t*)d, n,
      (const uint32_t*)t_rows, tcols, (const uint32_t*)rpacked, nreads, nwords,
      (const int32_t*)lengths, (const int32_t*)gstart, (const int32_t*)gend,
      (const int32_t*)budget, nbudget, win, width, smax, (int32_t*)nx, (int32_t*)s,
      (int32_t*)okbits);
}

// B10.  q1v: a device array of n window offsets, or null for the scalar
// q1.  trows holds ntrows rows of tcols >= nwords + 8 words.  Refused
// (cudaErrorInvalidValue, nothing launched): narrower rows, empty tables
// (trows, reads, gene_start of fewer than 2 entries, gblock, budget), a
// negative gsteps and smax < 1.  Reads whose tile passes the device's
// opt-in shared memory a block (past 907 words) take the thread kernel
// (muscato_verify_pairs_tile reports the route).
extern "C" int muscato_verify_pairs(
    const void* r, const void* p, long long n, const void* q1v, int q1, const void* trows,
    int ntrows, int tcols, const void* rpacked, int nreads, int nwords, const void* lengths,
    const void* gene_start, int ngs, const void* gblock, int nblock, int gsteps,
    const void* budget, int nbudget, int width, int max_read_length, int smax, void* keep,
    void* nx, void* g, void* s, void* stream) {
  if (nwords < 1 || tcols < nwords + 8 || ntrows < 1 || nreads < 1 || ngs < 2 ||
      nblock < 1 || gsteps < 0 || nbudget < 1 || smax < 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  int tile;
  size_t smem;
  cudaError_t e = pick_pairs_tile(nwords, &tile, &smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so a later launch does not report it
    return (int)e;
  }
  return (int)launch_tile(
      smem ? verify_pairs_kernel : verify_pairs_thread_kernel, n, tile, smem,
      (cudaStream_t)stream, (const int32_t*)r, (const int32_t*)p, n, (const int32_t*)q1v,
      q1, (const uint32_t*)trows, ntrows, tcols, (const uint32_t*)rpacked, nreads, nwords,
      (const int32_t*)lengths, (const int32_t*)gene_start, ngs, (const int32_t*)gblock,
      nblock, gsteps, (const int32_t*)budget, nbudget, width, max_read_length, smax,
      (uint8_t*)keep, (int32_t*)nx, (int32_t*)g, (int32_t*)s);
}
