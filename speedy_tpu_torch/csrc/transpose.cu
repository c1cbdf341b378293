// Column-to-row transpose: out [8, F] = x[:, :8]^T for x [F, C] (C >= 8),
// in the three forms of the probe, each exact in float32 with an identity:
//   swap     (form 0)  a shared-memory tile transpose
//   dot_rhsT (form 1)  out = E[:8, :8] . x[:, :8]^T, 8 FMAs an output
//   dot_lhsT (form 2)  out = x[:, :8]^T . E, F products an output, reading
//                      the whole [F, F] E
// E (the probe's identity, or any [F, F] matrix) is read only by the dot
// forms; their products sum in float32 FMA, so with an identity every
// output is one product by 1 plus products by 0, and equals its x element
// bit for bit.
//
// Replaces: experiments/mosaic_transpose_probe.py:23 make (its kernel,
// :24-42; call :46). Kernel 1 on the TPU reduced per-frame energy and lsd
// to columns [F, 1] of VMEM and wrote frame-lane rows; the probe asks
// which transpose form Mosaic lowers, whether it is exact, and which is
// cheapest. On the H100 the same three forms are written out as threads.
//
// Bound on the H100: bytes, at F = 512 the 16 KiB of columns read and
// 16 KiB written (10 ns at 3.35 TB/s); dot_lhsT also reads 1 MiB of E
// (0.32 us). swap and dot_rhsT run near the card's floor for a launch (1.1
// and 2.1 us of device time by torch.profiler on an NVIDIA H100 80GB HBM3
// at 700 W, chip_smoke.py), so the host's launch path sets their time by
// events (ops/kernels.py::_launch).
//
// Design of swap and dot_rhsT: one block of 256 threads per 32 rows of x.
// swap reads the block's 32 x 8 columns (8 consecutive words a row) into a
// padded shared tile and writes 8 rows of 32 consecutive words; dot_rhsT
// gives each thread one output (j, f), threads along f consecutive.
//
// Design of dot_lhsT, a split reduction: a thread per output (j, f) with a
// serial chain of F FMAs reads each E element 8 times, once per j, on F/32
// blocks, most SMs idle. Here each E element is read once, for all 8
// outputs that need it:
//   - a block takes 32 columns f (a lane each, 8 accumulators, one per j)
//     and one eighth of g; a cluster of 8 blocks takes all of g for its
//     columns, so F = 512 gives 16 clusters, 128 blocks;
//   - the block's 8 warps split its rows of g in turn (row r to warp
//     r mod 8), each a chain of F/64 FMAs a j; a warp reads 128
//     consecutive bytes of an E row, all its loads issued before x's rows
//     x[g, 0:8] are staged in shared memory, where every lane reads them
//     as a broadcast operand;
//   - the partial sums meet in a fixed order, so the result is the same
//     on every run (no atomics): the 8 warps' in shared memory, in warp
//     order, then the cluster's 8 blocks' through distributed shared
//     memory, block rank r adding row j = r in rank order and writing it.
// At F = 512 it runs in 3.7 us of device time, from 27.5 us for a thread
// per output (the same card and scripts, kernel_ab.py against the parent).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 32, kCols = 8, kThreads = kRows * kCols;

__global__ void __launch_bounds__(kThreads)
transpose_kernel(const float* __restrict__ x, const float* __restrict__ eye,
                 float* __restrict__ out, int F, int C, int form) {
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * kRows;
  // Output element of this thread: row j of out, column f.
  const int j = tid / kRows, f = f0 + tid % kRows;
  if (form == 0) {
    __shared__ float tile[kRows][kCols + 1];
    const int r = tid / kCols, col = tid % kCols;
    if (f0 + r < F) tile[r][col] = x[(long long)(f0 + r) * C + col];
    __syncthreads();
    if (f < F) out[(long long)j * F + f] = tile[tid % kRows][j];
    return;
  }
  if (f >= F) return;
  float acc = 0.f;
  for (int i = 0; i < kCols; ++i)
    acc = fmaf(eye[(long long)j * F + i], x[(long long)f * C + i], acc);
  out[(long long)j * F + f] = acc;
}

// dot_lhsT's split reduction.
constexpr int kTileCols = 32;                  // columns f a block, a lane each
constexpr int kSplit = kCols;                  // blocks a cluster; rank r writes row r
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 64;                     // rows of g staged at a time
constexpr int kPerWarp = kStage / kWarps;      // of which each warp takes 8
static_assert(kWarps * 32 == kCols * kTileCols, "a thread per (j, f) of the block's sums");

__global__ void __cluster_dims__(1, kSplit, 1) __launch_bounds__(kThreads)
dot_lhsT_kernel(const float* __restrict__ x, const float* __restrict__ eye,
                float* __restrict__ out, int F, int C) {
  __shared__ float xs[kStage][kCols];              // x[g, 0:8], the broadcast operand
  __shared__ float part[kWarps][kCols][kTileCols];  // each warp's partial sums
  __shared__ float sums[kCols][kTileCols];         // the block's, read by the cluster
  const cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int f0 = blockIdx.x * kTileCols, f = f0 + lane;
  const int rank = static_cast<int>(cluster.block_rank());
  const int share = (F + kSplit - 1) / kSplit;
  const int g_end = min(F, (rank + 1) * share);
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  for (int g0 = rank * share; g0 < g_end; g0 += kStage) {
    const int n = min(kStage, g_end - g0);
    float e[kPerWarp];  // E's rows first: their loads fly while x is staged
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int r = warp + i * kWarps;
      e[i] = r < n && f < F ? eye[(long long)(g0 + r) * F + f] : 0.f;
    }
    for (int i = threadIdx.x; i < n * kCols; i += kThreads)
      xs[i / kCols][i % kCols] = x[(long long)(g0 + i / kCols) * C + i % kCols];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int r = warp + i * kWarps;
      if (r < n) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[j] = fmaf(xs[r][j], e[i], acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) part[warp][j][lane] = acc[j];
  __syncthreads();
  {
    const int j = threadIdx.x / kTileCols, c = threadIdx.x % kTileCols;
    float s = part[0][j][c];
    for (int w = 1; w < kWarps; ++w) s += part[w][j][c];
    sums[j][c] = s;
  }
  cluster.sync();
  if (threadIdx.x < kTileCols && f0 + threadIdx.x < F) {
    const int c = threadIdx.x;
    float s = cluster.map_shared_rank(&sums[rank][0], 0)[c];
    for (int q = 1; q < kSplit; ++q) s += cluster.map_shared_rank(&sums[rank][0], q)[c];
    out[(long long)rank * F + f] = s;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

}  // namespace

// x [F, C] (C >= 8), eye [F, F] (read by forms 1 and 2; F >= 8 for form 1)
// -> out [8, F]; form 0 swap, 1 dot_rhsT, 2 dot_lhsT. Returns a
// cudaError_t.
extern "C" int speedy_transpose_cols(const float* x, const float* eye, float* out, int F,
                                     int C, int form, void* stream) {
  if (F <= 0) return cudaSuccess;
  if (C < kCols || form < 0 || form > 2 || (form == 1 && F < kCols))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 2) {
    const dim3 grid((F + kTileCols - 1) / kTileCols, kSplit);
    dot_lhsT_kernel<<<grid, kThreads, 0, s>>>(x, eye, out, F, C);
  } else {
    transpose_kernel<<<(F + kRows - 1) / kRows, kThreads, 0, s>>>(x, eye, out, F, C, form);
  }
  return cudaGetLastError();
}
