// Direct GROUP BY segment sums for Hopper (sm_90a).
//
// Replaces the TPU kernel presto_tpu/ops/pallas_groupby.py:_kernel
// (direct_segment_sums_pallas): [G, A] per-group sums of A float64 columns
// by a group id in [0, G), G <= 32.  The TPU kernel splits each value into
// hi/lo float32 halves, contracts a one-hot against a stacked [N, A] block
// on the matrix unit and keeps compensated (Kahan) pairs, because that
// unit has no float64 and Pallas wants the [N, A] block; the H100 adds
// float64 natively, so this kernel adds in float64, reads each column
// where it lies, and has no split.
//
// Bound: bytes.  Each row is read once, 4 + 8*A bytes (the int32 group id
// and one double of each column), and the output is G*A doubles; the
// arithmetic is one float64 add a value, far below the card's float64
// rate (the register build issues kSeg predicated adds a value, still
// below it at kSeg = 8).  What the design does about it:
//   - totals sized to the group count: the walk is built for kSeg = 8, 16
//     and 32 segments and the entry launches the smallest build that
//     holds n_seg.  Up to 8 segments a lane keeps its totals in registers
//     (the group id picks one by an unrolled compare, never an indexed
//     local array): Q1's 7 groups take 16 registers and 8 predicated adds
//     a value.  Above 8 the compares and the registers cost more than one
//     read-modify-write of the lane's own slot in shared memory, so the
//     16- and 32-segment builds keep their totals there;
//   - columns read where they lie: the entry takes the column pointers by
//     value (a parameter struct of kMaxColumns slots, no device array of
//     pointers, so a launch can be captured in a CUDA graph).  Warp w of a
//     block owns column w; a lane reads two rows of it as one 16-byte
//     double2 and their group ids as one int2, kUnroll independent pairs
//     a step, so a warp keeps 32 * kUnroll * 16 bytes of its column in
//     flight.  Every warp of the block walks the same rows, so the group
//     ids come from HBM once and from L1 for the other columns; the
//     values are streaming loads.  A column (or gid) that is not 16-byte
//     (8-byte) aligned takes the same walk with 8-byte (4-byte) loads;
//   - a grid sized to the card: the wrapper launches SMs x resident
//     blocks (fewer for a short input), each walking row tiles of
//     kStepRows with a grid stride; the ragged tail (fewer than kStepRows
//     rows, or N = 0) is masked by one block;
//   - one deterministic pass over the rows: a warp folds its 32 lanes by a
//     fixed shuffle tree and writes its block's partial [n_seg] of its
//     column; a second, small kernel folds the partials of each cell in a
//     fixed order (lane l takes blocks l, l + 32, ... in order, then the
//     same tree).  No float atomics: same inputs, same grid, same bits,
//     every run;
//   - no device read in the wrapper: rows whose group id lies outside
//     [0, n_seg) add nothing, and warp 0 of the first launch counts them
//     into a device status word (an integer atomic) that the caller reads
//     at a host read it already makes.
//
// Plain C entry points, loaded with ctypes (presto_tpu_torch/ops/
// segment_sums.py).  A launch runs on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxColumns = 32;  // one warp a column: at most 1024 threads
constexpr int kUnroll = 4;       // double2 loads a lane has in flight
constexpr int kStepRows = 64 * kUnroll;  // 32 lanes x 2 rows x kUnroll

struct Columns {
  const double* col[kMaxColumns];
};

// A lane's kSeg group totals in registers: the group id picks one by an
// unrolled compare (kSeg predicated adds a value), never an indexed local
// array.
template <int kSeg>
struct RegisterTotals {
  double t[kSeg];
  __device__ __forceinline__ RegisterTotals(double*, int, int) {}
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int s = 0; s < kSeg; ++s) t[s] = 0.0;
  }
  __device__ __forceinline__ void add(int g, double v) {
#pragma unroll
    for (int s = 0; s < kSeg; ++s) {
      if (s == g) t[s] += v;
    }
  }
  // s a compile-time index (an unrolled loop)
  __device__ __forceinline__ double& at(int s) { return t[s]; }
};

// A lane's kSeg group totals in shared memory, its column of its warp's
// [kSeg][32] block (bank-conflict free): one read-modify-write a value,
// whatever kSeg, and few registers.
template <int kSeg>
struct SharedTotals {
  double* t;
  __device__ __forceinline__ SharedTotals(double* smem, int warp, int lane)
      : t(smem + warp * kSeg * 32 + lane) {}
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int s = 0; s < kSeg; ++s) t[32 * s] = 0.0;
  }
  __device__ __forceinline__ void add(int g, double v) {
    if (static_cast<unsigned>(g) < static_cast<unsigned>(kSeg)) {
      t[32 * g] += v;
    }
  }
  __device__ __forceinline__ double& at(int s) { return t[32 * s]; }
};

template <int kSeg, bool kShared>
using Totals = typename std::conditional<kShared, SharedTotals<kSeg>,
                                         RegisterTotals<kSeg>>::type;

__device__ __forceinline__ int outside(int g, int n_seg) {
  return static_cast<unsigned>(g) >= static_cast<unsigned>(n_seg);
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;  // lane 0's is the warp's total, in one fixed order
}

template <int kSeg, bool kShared>
__global__ void segment_sums_kernel(const int* __restrict__ gid,
                                    Columns cols, long long n, int n_seg,
                                    double* __restrict__ partials,
                                    int* __restrict__ status) {
  const int lane = threadIdx.x & 31;
  const int c = threadIdx.x >> 5;  // this warp's column
  const int ncols = blockDim.x >> 5;
  const double* __restrict__ v = cols.col[c];
  const bool counting = status != nullptr && c == 0;
  extern __shared__ double shared_totals[];
  Totals<kSeg, kShared> acc(shared_totals, c, lane);
  acc.zero();
  int bad = 0;

  const long long tiles = n / kStepRows;  // full tiles
  const bool vec = ((reinterpret_cast<uintptr_t>(v) & 15) == 0) &&
                   ((reinterpret_cast<uintptr_t>(gid) & 7) == 0);
  if (vec) {
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long r0 = t * kStepRows + 2 * lane;
      int2 g[kUnroll];
      double2 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        g[u] = __ldg(reinterpret_cast<const int2*>(gid + r0 + 64 * u));
        x[u] = __ldcs(reinterpret_cast<const double2*>(v + r0 + 64 * u));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        acc.add(g[u].x, x[u].x);
        acc.add(g[u].y, x[u].y);
        if (counting) {
          bad += outside(g[u].x, n_seg) + outside(g[u].y, n_seg);
        }
      }
    }
  } else {
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long r0 = t * kStepRows + lane;
      int g[2 * kUnroll];
      double x[2 * kUnroll];
#pragma unroll
      for (int u = 0; u < 2 * kUnroll; ++u) {
        g[u] = __ldg(gid + r0 + 32 * u);
        x[u] = __ldcs(v + r0 + 32 * u);
      }
#pragma unroll
      for (int u = 0; u < 2 * kUnroll; ++u) {
        acc.add(g[u], x[u]);
        if (counting) bad += outside(g[u], n_seg);
      }
    }
  }
  // the ragged tail: the block whose turn the next tile would be
  if (blockIdx.x == tiles % gridDim.x) {
    for (long long r = tiles * kStepRows + lane; r < n; r += 32) {
      const int g = __ldg(gid + r);
      acc.add(g, __ldcs(v + r));
      if (counting) bad += outside(g, n_seg);
    }
  }

  if (counting) {
    bad = __reduce_add_sync(0xffffffffu, bad);
    if (lane == 0 && bad != 0) atomicAdd(status, bad);
  }
  double* part = partials + (long long)blockIdx.x * n_seg * ncols + c;
#pragma unroll
  for (int s = 0; s < kSeg; ++s) {
    if (s < n_seg) {
      const double x = warp_sum(acc.at(s));
      if (lane == 0) part[s * ncols] = x;
    }
  }
}

// out[s][c] = the sum over blocks b of partials[b][s][c], one warp a cell:
// lane l sums blocks l, l + 32, ... in order, then the shuffle tree.
__global__ void fold_partials(const double* __restrict__ partials,
                              int blocks, int n_seg, int ncols,
                              double* __restrict__ out, int out_stride) {
  const int cell = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int cells = n_seg * ncols;
  if (cell >= cells) return;
  double x = 0.0;
#pragma unroll 4
  for (int b = lane; b < blocks; b += 32) {
    x += partials[(long long)b * cells + cell];
  }
  x = warp_sum(x);
  if (lane == 0) out[(cell / ncols) * out_stride + cell % ncols] = x;
}

// Which totals each build keeps: registers up to 8 segments, shared
// memory above, where kSeg predicated adds a value and the registers they
// take cost more than one read-modify-write in shared memory.
template <int kSeg>
constexpr bool kSharedBuild = kSeg > 8;

template <int kSeg>
size_t shared_bytes(int ncols) {
  return kSharedBuild<kSeg> ? (size_t)ncols * kSeg * 32 * sizeof(double)
                            : 0;
}

template <int kSeg>
cudaError_t launch(const int* gid, const Columns& cols, int ncols,
                   long long n, int n_seg, double* out, int out_stride,
                   double* partials, int* status, int blocks,
                   cudaStream_t stream) {
  segment_sums_kernel<kSeg, kSharedBuild<kSeg>>
      <<<blocks, 32 * ncols, shared_bytes<kSeg>(ncols), stream>>>(
          gid, cols, n, n_seg, partials, status);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int cells = n_seg * ncols;
  fold_partials<<<(cells + 3) / 4, 128, 0, stream>>>(
      partials, blocks, n_seg, ncols, out, out_stride);
  return cudaGetLastError();
}

template <int kSeg>
cudaError_t plan(int ncols, int* cols_per_launch, int* blocks) {
  auto kernel = segment_sums_kernel<kSeg, kSharedBuild<kSeg>>;
  int dev = 0, sms = 0, smem = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  int k = attr.maxThreadsPerBlock / 32;  // warps the registers allow
  if (kSharedBuild<kSeg>) {
    const int dynamic = smem - (int)attr.sharedSizeBytes;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
    if (e != cudaSuccess) return e;
    const int fit = dynamic / (int)shared_bytes<kSeg>(1);
    if (k > fit) k = fit;  // and the shared memory
  }
  if (k > kMaxColumns) k = kMaxColumns;
  if (k > ncols) k = ncols;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, 32 * k, shared_bytes<kSeg>(k));
  if (e != cudaSuccess) return e;
  *cols_per_launch = k;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

// Rows a block takes per step of its walk (the wrapper sizes the grid by
// it: a block with no full tile only adds the tail).
extern "C" int presto_segment_sums_step_rows() { return kStepRows; }

// For ncols columns of n_seg segments on the current card: the columns a
// launch may take (one warp each, as many as the build's registers and
// shared memory allow in one block, at most 32) and the blocks of that
// width resident at once, the grid of a full-size launch.
extern "C" int presto_segment_sums_plan(int ncols, int n_seg,
                                        int* cols_per_launch, int* blocks) {
  if (ncols < 1 || n_seg < 1 || n_seg > 32) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e =
      n_seg <= 8    ? plan<8>(ncols, cols_per_launch, blocks)
      : n_seg <= 16 ? plan<16>(ncols, cols_per_launch, blocks)
                    : plan<32>(ncols, cols_per_launch, blocks);
  if (e != cudaSuccess) cudaGetLastError();  // not left for a launch
  return (int)e;
}

// gid: int32 [n]; cols: a host array of ncols pointers, each to a float64
// [n] column; out: float64 [n_seg, out_stride], this launch's columns at
// out[:, 0:ncols]; partials: float64 scratch [blocks, n_seg, ncols];
// status: int32, out-of-range rows are added to it (null: not counted).
// Requires 1 <= ncols <= the plan's columns, 1 <= n_seg <= 32,
// blocks >= 1, n >= 0; the wrapper checks it all.
extern "C" int presto_segment_sums(const void* gid, const void* const* cols,
                                   int ncols, long long n, int n_seg,
                                   void* out, int out_stride, void* partials,
                                   void* status, int blocks, void* stream) {
  if (ncols < 1 || ncols > kMaxColumns || n_seg < 1 || n_seg > 32 ||
      blocks < 1 || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Columns cs = {};
  for (int i = 0; i < ncols; ++i) {
    cs.col[i] = static_cast<const double*>(cols[i]);
  }
  const int* g = static_cast<const int*>(gid);
  double* o = static_cast<double*>(out);
  double* p = static_cast<double*>(partials);
  int* st = static_cast<int*>(status);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      n_seg <= 8    ? launch<8>(g, cs, ncols, n, n_seg, o, out_stride, p, st,
                                blocks, s)
      : n_seg <= 16 ? launch<16>(g, cs, ncols, n, n_seg, o, out_stride, p,
                                 st, blocks, s)
                    : launch<32>(g, cs, ncols, n, n_seg, o, out_stride, p,
                                 st, blocks, s);
  return (int)e;
}
