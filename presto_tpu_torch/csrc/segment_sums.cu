// Direct GROUP BY segment sums for Hopper (sm_90a).
//
// Replaces the TPU kernel presto_tpu/ops/pallas_groupby.py:_kernel
// (direct_segment_sums_pallas): [G, A] per-group sums of an [N, A] float64
// matrix by a group id in [0, G), G <= 32.  The TPU kernel splits each
// value into hi/lo float32 halves and keeps compensated (Kahan) pairs,
// because the TPU's matrix unit has no float64; the H100 adds float64
// natively, so this kernel accumulates in float64 and has no split.
//
// Bound: bytes.  Each row is read once, 4 + 8*A bytes (the int32 group id
// and A doubles), and the output is G*A doubles; the arithmetic is at most
// 32 predicated float64 adds per value, far below the card's float64 rate.
// What the design does about it:
//   - threads of a block own one column each, R rows in parallel
//     (R*A <= 256 threads), so consecutive threads read consecutive
//     addresses of the row-major matrix and every load is coalesced;
//   - each thread keeps its 32 group totals in registers (the G <= 32 gate
//     is what makes that possible: the group id selects a register by an
//     unrolled compare, never an indexed local array), so the rows stream
//     through once with no shared-memory or global atomics;
//   - the result is deterministic, the same bits on every run: a block
//     folds its R row lanes into shared memory in lane order, writes its
//     partial [G, A] to scratch, and a second kernel sums the partials in
//     block order.  There are no float atomics anywhere (torch's
//     index_add_ on CUDA uses them, and its sums change order run to run).
// A later version can read 16-byte vectors and fold the two phases into
// one pass; this one is the simple, right one.
//
// Plain C entry point, loaded with ctypes (presto_tpu_torch/ops/
// segment_sums.py).  It launches on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSegments = 32;
constexpr int kThreads = 256;

__global__ void block_partial_sums(const int* __restrict__ gid,
                                   const double* __restrict__ vals,
                                   double* __restrict__ partials,
                                   long long n, int a, int n_seg,
                                   long long rows_per_block, int lanes) {
  extern __shared__ double block_sum[];  // [n_seg][a]
  const int t = threadIdx.x;
  const int lane = t / a;  // which of the R parallel rows
  const int col = t - lane * a;
  const bool active = lane < lanes;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  long long row1 = row0 + rows_per_block;
  if (row1 > n) row1 = n;

  double acc[kMaxSegments];
#pragma unroll
  for (int g = 0; g < kMaxSegments; ++g) acc[g] = 0.0;

  if (active) {
    for (long long r = row0 + lane; r < row1; r += lanes) {
      const int g0 = gid[r];
      const double v = vals[r * a + col];
#pragma unroll
      for (int g = 0; g < kMaxSegments; ++g) {
        if (g == g0) acc[g] += v;
      }
    }
  }

  for (int i = t; i < n_seg * a; i += blockDim.x) block_sum[i] = 0.0;
  __syncthreads();
  // fold the row lanes in lane order: same order, same bits, every run
  for (int k = 0; k < lanes; ++k) {
    if (active && lane == k) {
#pragma unroll
      for (int g = 0; g < kMaxSegments; ++g) {
        if (g < n_seg) block_sum[g * a + col] += acc[g];
      }
    }
    __syncthreads();
  }
  double* out = partials + (long long)blockIdx.x * n_seg * a;
  for (int i = t; i < n_seg * a; i += blockDim.x) out[i] = block_sum[i];
}

__global__ void combine_partials(const double* __restrict__ partials,
                                 double* __restrict__ out, int blocks,
                                 int cells) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cells) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partials[(long long)b * cells + c];
  out[c] = s;
}

}  // namespace

// gid: int32 [n]; vals: float64 [n, a] row-major; out: float64 [n_seg, a];
// partials: float64 scratch [blocks, n_seg, a].  Requires 1 <= n_seg <= 32,
// 1 <= a <= 1024, n_seg * a doubles within a block's shared memory,
// blocks >= 1 and blocks * rows_per_block >= n; the wrapper checks it all.
extern "C" int presto_segment_sums(const void* gid, const void* vals,
                                   void* out, void* partials, long long n,
                                   int a, int n_seg, int blocks,
                                   long long rows_per_block, void* stream) {
  const int lanes = a >= kThreads ? 1 : kThreads / a;
  const int threads = lanes * a;
  const size_t smem = (size_t)n_seg * a * sizeof(double);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        block_partial_sums, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  block_partial_sums<<<blocks, threads, smem, s>>>(
      static_cast<const int*>(gid), static_cast<const double*>(vals),
      static_cast<double*>(partials), n, a, n_seg, rows_per_block, lanes);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int cells = n_seg * a;
  combine_partials<<<(cells + 127) / 128, 128, 0, s>>>(
      static_cast<const double*>(partials), static_cast<double*>(out),
      blocks, cells);
  return (int)cudaGetLastError();
}
