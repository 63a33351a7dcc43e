// B3 monotone_gather:      out[j]    = table[idx[j]]
// B4 monotone_gather_rows: out[j, :] = table[ridx[j], :]
//
// Replace muscato_tpu/ops/pallas_gather.py:monotone_gather (Pallas kernel
// _kernel) and monotone_gather_rows (Pallas kernel _rows_kernel).  On the
// TPU a per-lane gather costs about one HBM latency, so the Pallas kernels
// DMA a window of the table that covers a block's (nondecreasing) index
// span into VMEM and pick lanes with byte-plane one-hot matmuls, with an
// overflow flag when a span outgrows the window.  A GPU gathers natively,
// so there is no window and no overflow: both kernels are plain gathers.
//
// Bound on the card: memory bandwidth.  The index streams the engine feeds
// them are (piecewise) nondecreasing, so neighbouring threads read
// neighbouring table entries and the loads coalesce into few sectors; the
// outputs are written fully coalesced.  The row gather runs one thread per
// 4-byte output word (rows are 22 words, not a multiple of 16 bytes), so a
// warp covers about 1.5 consecutive rows and every access stays coalesced.
//
// Indices are clamped to the table.  The engine only passes in-range
// indices; the clamp keeps a bad one from reading outside the allocation.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void gather_kernel(const int32_t* __restrict__ table, long long n,
                              const int32_t* __restrict__ idx, long long m,
                              int32_t* __restrict__ out) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  long long k = __ldg(idx + j);
  k = k < 0 ? 0 : (k >= n ? n - 1 : k);
  out[j] = __ldg(table + k);
}

__global__ void gather_rows_kernel(const int32_t* __restrict__ table,
                                   long long nrows, int ncols,
                                   const int32_t* __restrict__ ridx,
                                   long long m, int32_t* __restrict__ out) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m * ncols) return;
  long long j = e / ncols;
  int c = (int)(e - j * ncols);
  long long r = __ldg(ridx + j);
  r = r < 0 ? 0 : (r >= nrows ? nrows - 1 : r);
  out[e] = __ldg(table + r * ncols + c);
}

}  // namespace

extern "C" int muscato_monotone_gather(const void* table, long long n,
                                       const void* idx, long long m, void* out,
                                       void* stream) {
  if (m > 0 && n > 0) {
    const int threads = 256;
    long long blocks = (m + threads - 1) / threads;
    gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)table, n, (const int32_t*)idx, m, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int muscato_monotone_gather_rows(const void* table, long long nrows,
                                            int ncols, const void* ridx,
                                            long long m, void* out,
                                            void* stream) {
  if (m > 0 && nrows > 0 && ncols > 0) {
    const int threads = 256;
    long long blocks = (m * ncols + threads - 1) / threads;
    gather_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)table, nrows, ncols, (const int32_t*)ridx, m,
        (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
