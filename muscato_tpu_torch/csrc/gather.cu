// B3 monotone_gather:      out[j]    = table[idx[j]]
// B4 monotone_gather_rows: out[j, :] = table[ridx[j], :]
//
// Replace muscato_tpu/ops/pallas_gather.py:monotone_gather (Pallas kernel
// _kernel) and monotone_gather_rows (Pallas kernel _rows_kernel).  Indices
// are clamped to the table: the engine only passes in-range indices, and
// the clamp keeps a bad one from reading outside the allocation.
//
// B3 is bound by bytes: each index is read and each output written once,
// and the (piecewise) nondecreasing streams the engine feeds it make
// neighbouring lanes read neighbouring table entries, so the table loads
// share sectors.  Its first design (gather_thread_kernel, built under
// -DMUSCATO_NO_STAGE) takes one thread an output: a 4-byte index load, one
// dependent table load and a 4-byte store, in blocks of 256, one table
// load in flight a thread.
//
// The design now (gather_kernel): a thread takes a run of kRun = 4
// consecutive outputs, loads their indices in one 16-byte load, issues
// its four clamped table loads before it uses any, and writes the four in
// one 16-byte store.  The run's store is aligned by a scalar head of up to
// three outputs (out's offset from 16 bytes) and a scalar tail covers the
// rest of m; where idx's offset from 16 bytes differs from out's, the
// run's four indices are four 4-byte loads.  The grid is a thread a run.
//
// On an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md keeps the
// numbers) a default flagship batch's 28 calls, replayed, take 0.527-0.532
// ms of device time against 0.693-0.717 for the first design, and the
// streaming batch's 86 0.357-0.371 against 0.373-0.386.  A 2^20-lane gene
// lookup takes 0.0033 ms against 0.0040-0.0043 (its bound 0.0026), while the
// 12.6M-lane postings fetch, 7.2M distinct sectors scattered over a
// 392 MB table, takes 0.142 ms in both designs (its sector bound 0.098):
// the card's rate for scattered sectors sets it.  Runs of 8, a grid of 8
// CTAs an SM striding over the runs, and a warp that loads its dense span
// once and picks its outputs by __shfl_sync were each slower over a batch
// (PERF.md keeps their times).
//
// B4 is bound by bytes too: at a flagship verify chunk it reads 1M row
// indices (4 MB) and the ~360K table rows they touch (88 bytes each) and
// writes 1M rows (92 MB), ~127 MB in all.  The TPU kernel's idea carries
// over: a CTA takes a tile of kRowTile output rows, loads their indices
// into shared memory once and reduces their min and max row (min and max,
// not first and last, so any order is exact).  A dense tile, whose rows
// [min, max] are no more than its own rows, stages that span of the table
// in shared memory with one bulk async copy (cp.async.bulk on an mbarrier,
// bulk.cuh): the table is read once, in whole 16-byte groups, however
// often the tile repeats a row, and the copy reads no more rows than
// reading each row would.  A sparse tile (a wider span: the tile
// straddling the live/dead boundary, whose dead lanes map to the last
// row, sorted rows spread over the whole table, or any scattered stream)
// reads its rows straight from global memory inside the same kernel, so
// every lane is exact and there is no overflow.  Staging a span wider
// than the tile read ~1.5x the rows it used and was slower than reading
// the rows directly on the card.  The
// output tile is contiguous.  Rows of an even word count (22 words at
// 100-base reads, 28 at 150) are moved in 8-byte pieces, two to each
// 16-byte store, and a piece never straddles a row; odd widths, and
// tables not 8-byte aligned, move 4-byte words.  Inside a tile the (row,
// piece) of each output unit advances by a fixed stride in 32-bit
// arithmetic without dividing; row offsets into the table are 64-bit.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bulk.cuh"
#include "walk.cuh"

namespace {

using muscato::RowWalk;

__device__ __forceinline__ long long clamp_index(int k, long long n) {
  return k < 0 ? 0 : (k >= n ? n - 1 : k);
}

// The first design: a thread an output.
__global__ void gather_thread_kernel(const int32_t* __restrict__ table, long long n,
                                     const int32_t* __restrict__ idx, long long m,
                                     int32_t* __restrict__ out) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  out[j] = __ldg(table + clamp_index(__ldg(idx + j), n));
}

constexpr int kRun = 4;  // outputs a thread takes at once: one 16-byte load and store of them
constexpr int kGatherThreads = 256;

// Run t of kRun outputs from out[head] on (out + head 16-byte aligned;
// kIdxVec: idx + head is too).  The head's outputs (before out[head]) and
// the tail's (past the last run), at most kRun - 1 each, go to the grid's
// last threads, past the runs: a thread that did both would wait on two
// chains of loads, and the launch with it.
template <bool kIdxVec>
__global__ void __launch_bounds__(kGatherThreads)
    gather_kernel(const int32_t* __restrict__ table, long long n,
                  const int32_t* __restrict__ idx, long long m, int32_t* __restrict__ out,
                  int head, long long nrun) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long e = (long long)gridDim.x * blockDim.x - 1 - t;  // head, then tail outputs
  const long long j1 = e < head ? e : head + nrun * kRun + (e - head);
  if (j1 < m) out[j1] = __ldg(table + clamp_index(__ldg(idx + j1), n));
  if (t >= nrun) return;
  const long long j = head + t * kRun;
  int4 k;
  if constexpr (kIdxVec) {
    k = __ldg(reinterpret_cast<const int4*>(idx + j));
  } else {
    k = make_int4(__ldg(idx + j), __ldg(idx + j + 1), __ldg(idx + j + 2), __ldg(idx + j + 3));
  }
  const int x0 = __ldg(table + clamp_index(k.x, n)), x1 = __ldg(table + clamp_index(k.y, n));
  const int x2 = __ldg(table + clamp_index(k.z, n)), x3 = __ldg(table + clamp_index(k.w, n));
  *reinterpret_cast<int4*>(out + j) = make_int4(x0, x1, x2, x3);
}

constexpr int kRowThreads = 256;
constexpr int kRowTile = kRowThreads;  // output rows per CTA, one index each
// Staged span: at most a tile's 256 rows (a tile of 256 sorted rows spans
// ~100 table rows at a flagship verify chunk); the stage holds 256 rows of
// 22 words plus the 16-byte rounding at both ends (22.5 KB), and wider
// rows stage proportionally fewer.  Eight CTAs, the thread limit, fit on
// an SM, as many as without a stage; a 45 KB stage fit five and was
// slower on the card wherever tiles were sparse.
// Independent CTAs overlap one another's copies and writes; a persistent
// CTA that double-buffers two tiles fits only two to an SM and was slower
// on the card.
constexpr int kStageWords = 256 * 22 + 8;
constexpr int kStageBytes = kStageWords * 4;  // 22,560 bytes
static_assert(kStageBytes + 2048 <= 48 * 1024, "stage within the default 48 KB");

// kPieces: rows of an even word count `nc`, the table 8-byte and the
// output 16-byte aligned; otherwise any width and alignment.
template <bool kPieces>
__global__ void __launch_bounds__(kRowThreads)
    gather_rows_kernel(const int32_t* __restrict__ table, long long nrows, int nc,
                       const int32_t* __restrict__ ridx, long long m,
                       int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t s_span[];
  __shared__ int s_row[kRowTile];
  __shared__ int s_min[kRowThreads / 32], s_max[kRowThreads / 32];
  __shared__ __align__(8) uint64_t s_bar;

  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * kRowTile;
  const int rows = (int)min((long long)kRowTile, m - t0);

  // The tile's row indices, clamped; lanes past m stay out of min and max.
  int lo = INT_MAX, hi = INT_MIN;
  if (tid < rows) {
    long long r = __ldg(ridx + t0 + tid);
    r = r < 0 ? 0 : (r >= nrows ? nrows - 1 : r);
    s_row[tid] = (int)r;
    lo = hi = (int)r;
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((tid & 31) == 0) {
    s_min[tid >> 5] = lo;
    s_max[tid >> 5] = hi;
  }
  __syncthreads();
  int rmin = s_min[0], rmax = s_max[0];
#pragma unroll
  for (int w = 1; w < kRowThreads / 32; ++w) {
    rmin = min(rmin, s_min[w]);
    rmax = max(rmax, s_max[w]);
  }

  // Dense tile: stage table words [w0, w1) of rows [rmin, rmax].
  const long long w0 = (long long)rmin * nc, w1 = ((long long)rmax + 1) * nc;
  const bool dense = muscato::kStage && rmax - rmin < rows &&
                     muscato::round_up4(w1) - (w0 & ~3LL) <= kStageWords;
  int off = 0;  // s_span[off + (r - rmin) * nc + c] = table[r][c]
  bool bulk = false;
  if (dense)
    off = (int)(w0 - muscato::stage_words((const uint32_t*)table, nrows * nc,
                                          w0, w1, s_span, &s_bar, &bulk));
  __syncthreads();
  muscato::stage_wait(&s_bar, bulk);

  const long long o0 = t0 * nc;  // the tile's first output word
  if constexpr (kPieces) {
    // 8-byte pieces, np to a row; thread tid writes 16-byte stores q = tid,
    // tid + kRowThreads, ... of pieces 2q and 2q + 1 (the last alone when
    // the tile's piece count is odd).  The stage's base is w0 rounded down
    // to 4 words, or w0 itself, and w0 is even, so staged pieces are
    // 8-byte aligned too.
    const int np = nc >> 1;
    auto piece = [&](int j, int c) -> uint2 {
      const int r = s_row[j];
      if (dense)
        return *reinterpret_cast<const uint2*>(s_span + off + (r - rmin) * nc + 2 * c);
      return __ldg(reinterpret_cast<const uint2*>(table + (long long)r * nc) + c);
    };
    int4* out4 = reinterpret_cast<int4*>(out + o0);
    RowWalk a(2 * tid, 2 * kRowThreads, np);
    for (int q = tid; a.j < rows; q += kRowThreads, a.next()) {
      const uint2 x = piece(a.j, a.c);
      const bool row_end = a.c + 1 == np;
      const int bj = a.j + row_end;
      if (bj < rows) {
        const uint2 y = piece(bj, row_end ? 0 : a.c + 1);
        out4[q] = make_int4((int)x.x, (int)x.y, (int)y.x, (int)y.y);
      } else {
        *reinterpret_cast<uint2*>(out4 + q) = x;
      }
    }
  } else {
    RowWalk a(tid, kRowThreads, nc);
    for (long long o = o0 + tid; a.j < rows; o += kRowThreads, a.next()) {
      const int r = s_row[a.j];
      out[o] = dense ? (int32_t)s_span[off + (r - rmin) * nc + a.c]
                     : __ldg(table + (long long)r * nc + a.c);
    }
  }
}

template <bool kPieces>
cudaError_t launch_rows(const int32_t* table, long long nrows, int ncols,
                        const int32_t* ridx, long long m, int32_t* out,
                        cudaStream_t stream) {
  const long long blocks = (m + kRowTile - 1) / kRowTile;
  gather_rows_kernel<kPieces>
      <<<(unsigned)blocks, kRowThreads, muscato::kStage ? kStageBytes : 0, stream>>>(
          table, nrows, ncols, ridx, m, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int muscato_monotone_gather(const void* table, long long n,
                                       const void* idx, long long m, void* out,
                                       void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  auto* t = (const int32_t*)table;
  auto* i = (const int32_t*)idx;
  auto* o = (int32_t*)out;
  auto s = (cudaStream_t)stream;
  if constexpr (!muscato::kStage) {
    gather_thread_kernel<<<(unsigned)((m + 255) / 256), 256, 0, s>>>(t, n, i, m, o);
    return (int)cudaGetLastError();
  }
  // out and idx are int32 tensors, so 4-byte aligned: the head is the
  // outputs before out's first 16-byte boundary.
  const int head = (int)std::min<long long>((16 - ((uintptr_t)out & 15)) / 4 % 4, m);
  const long long nrun = (m - head) / kRun;
  // A thread a run, a head output or a tail output.
  const long long blocks = (nrun + (m - nrun * kRun) + kGatherThreads - 1) / kGatherThreads;
  if (((uintptr_t)idx & 15) == ((uintptr_t)out & 15))
    gather_kernel<true><<<(unsigned)blocks, kGatherThreads, 0, s>>>(t, n, i, m, o, head, nrun);
  else
    gather_kernel<false><<<(unsigned)blocks, kGatherThreads, 0, s>>>(t, n, i, m, o, head, nrun);
  return (int)cudaGetLastError();
}

extern "C" int muscato_monotone_gather_rows(const void* table, long long nrows,
                                            int ncols, const void* ridx,
                                            long long m, void* out,
                                            void* stream) {
  if (m > 0 && nrows > 0 && ncols > 0) {
    const bool pieces = ncols % 2 == 0 && ((uintptr_t)table & 7) == 0 &&
                        ((uintptr_t)out & 15) == 0;
    auto* t = (const int32_t*)table;
    auto* r = (const int32_t*)ridx;
    auto* o = (int32_t*)out;
    auto s = (cudaStream_t)stream;
    return (int)(pieces ? launch_rows<true>(t, nrows, ncols, r, m, o, s)
                        : launch_rows<false>(t, nrows, ncols, r, m, o, s));
  }
  return (int)cudaGetLastError();
}
