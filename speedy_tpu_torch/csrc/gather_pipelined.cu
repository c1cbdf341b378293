// Per-row gather in row chunks, rows copied through a ring of shared memory:
// rows[b, k, j] = x[b, s + j] for j < width and every k < K, with
// s = clamp(starts[b, k], 0, L - width). The same function as
// csrc/gather_rows.cu with every row live.
//
// Replaces: speedy_tpu/ops/pallas_kernels.py:288 gather_rows_pipelined (body
// _gather_pipelined_kernel, :227), an experiment that asked whether
// overlapping row j+1's DMA with row j's extraction beats one program per
// row block on the TPU (it measured equal there, :230-236). The TPU kernel
// indexes a flattened x, so a start past L - width reads into the next
// utterance; here starts clamp as dynamic_slice clamps them.
//
// Bound on the H100: bytes, as for gather_rows: every output word written
// once and every sample the rows cover read once. The TPU's schedule (one
// program walking an utterance's rows, one row's copy in flight) leaves
// most of the H100's 132 SMs idle at B = 32 and one row's copy latency
// exposed per row; this design keeps the experiment's identity (rows are
// copied into shared memory by cp.async while earlier rows are stored) on a
// schedule for the card:
//   - a grid of (ceil(K / 32), B): a block of 4 warps takes 32 consecutive
//     rows of one utterance, so B = 32 at K = 1,008 gives 1,024 blocks,
//     several on every SM;
//   - a ring of 4 stages, each a group of 4 rows (fewer for rows too wide
//     for 4 stages of 4 in shared memory), with 3 groups in flight while
//     one is stored;
//   - each row is copied as its 16-byte-aligned superset, the start
//     rounded down to a multiple of 4 floats, by 16-byte cp.async, and the
//     0-3-float shift is applied when shared memory is read. Where x's
//     utterances are not 16-byte aligned (L % 4 != 0, or x itself), rows
//     are copied exactly by 4-byte cp.async, in the same kernel;
//   - a group's rows are consecutive in out, group * width floats, and are
//     stored as one flat run: the unaligned head a float at a time, then
//     16-byte stores, then the tail.

#include <cuda_runtime.h>

#include <stdint.h>

#include "cp_async.cuh"
#include "shared_grant.cuh"

namespace {

using speedy::cp_async16;
using speedy::cp_async4;
using speedy::cp_async_commit;
using speedy::cp_async_wait;

constexpr int kThreads = 128;
constexpr int kRowsPerBlock = 32;
constexpr int kStages = 4;
constexpr int kMaxShared = 232448 - 1024;  // the H100's per-block maximum, less the static part

struct Geometry {
  int L, K, width;
  int group;    // rows a stage: 4, 2 or 1
  int row_cap;  // floats a stage row, a multiple of 4
  int aligned;  // rows copied as 16-byte-aligned supersets
};

// Copy group g of the block's rows into its stage of the ring (nothing past
// the block's last group), then commit, so that every thread commits one
// group per call.
__device__ __forceinline__ void issue(const float* __restrict__ xb, const int* s_start,
                                      float* ring, int g, int groups, int rows,
                                      const Geometry& geo) {
  if (g < groups) {
    float* stage = ring + (g % kStages) * geo.group * geo.row_cap;
    const int r0 = g * geo.group;
    // The stage's rows, 4 / group warps each.
    const int per_row = kThreads / geo.group;
    const int r = threadIdx.x / per_row;
    const int lane = threadIdx.x % per_row;
    if (r0 + r < rows) {
      const int s = s_start[r0 + r];
      float* dst = stage + r * geo.row_cap;
      if (geo.aligned) {
        const int base = s & ~3;
        const int n4 = (s - base + geo.width + 3) >> 2;
        for (int c = lane; c < n4; c += per_row) cp_async16(dst + 4 * c, xb + base + 4 * c);
      } else {
        for (int c = lane; c < geo.width; c += per_row) cp_async4(dst + c, xb + s + c);
      }
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
gather_pipelined_kernel(const float* __restrict__ x, const int* __restrict__ starts,
                        float* __restrict__ out, Geometry geo) {
  extern __shared__ __align__(16) float ring[];  // [kStages][group][row_cap]
  __shared__ int s_start[kRowsPerBlock];         // each row's clamped start
  __shared__ int s_shift[kRowsPerBlock];         // and its offset in its stage row
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, geo.K - j0);
  const int groups = (rows + geo.group - 1) / geo.group;
  const float* xb = x + (long long)b * geo.L;
  if (threadIdx.x < rows) {
    const int s = min(max(starts[(long long)b * geo.K + j0 + threadIdx.x], 0), geo.L - geo.width);
    s_start[threadIdx.x] = s;
    s_shift[threadIdx.x] = geo.aligned ? (s & 3) : 0;
  }
  __syncthreads();

  for (int g = 0; g < kStages - 1; ++g) issue(xb, s_start, ring, g, groups, rows, geo);
  for (int g = 0; g < groups; ++g) {
    // Into the stage group g - 1 used, which the barrier closing the last
    // iteration freed.
    issue(xb, s_start, ring, g + kStages - 1, groups, rows, geo);
    cp_async_wait<kStages - 1>();  // this thread's copies of group g have landed
    __syncthreads();               // and every thread's
    const float* stage = ring + (g % kStages) * geo.group * geo.row_cap;
    const int r0 = g * geo.group;
    const int nr = min(geo.group, rows - r0);
    const int n = nr * geo.width;
    const long long o = ((long long)b * geo.K + j0 + r0) * geo.width;
    float* dst = out + o;
    // Flat word f of the run is row f / width, sample f % width.
    auto word = [&](int r, int c) { return stage[r * geo.row_cap + s_shift[r0 + r] + c]; };
    const int head = min(n, (int)((4 - (o & 3)) & 3));
    if (threadIdx.x < head) {
      const int r = threadIdx.x / geo.width;
      dst[threadIdx.x] = word(r, threadIdx.x - r * geo.width);
    }
    const int body = (n - head) >> 2;
    for (int i = threadIdx.x; i < body; i += kThreads) {
      const int f = head + 4 * i;
      int r = f / geo.width, c = f - r * geo.width;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = word(r, c);
        if (++c == geo.width) {
          c = 0;
          ++r;
        }
      }
      *reinterpret_cast<float4*>(dst + f) = make_float4(v[0], v[1], v[2], v[3]);
    }
    const int tail = head + 4 * body;
    if (threadIdx.x < n - tail) {
      const int f = tail + threadIdx.x;
      const int r = f / geo.width;
      dst[f] = word(r, f - r * geo.width);
    }
    __syncthreads();  // this stage is refilled by group g + kStages
  }
}

}  // namespace

// x [B, L], starts [B, K] int32 -> out [B, K, width] (16-byte aligned).
// Needs 1 <= width <= L and 4 stages of one row (width + 3 floats rounded
// up to 4) within the H100's 227 KB of shared memory. Returns a
// cudaError_t.
extern "C" int speedy_gather_rows_pipelined(const float* x, const int* starts, float* out,
                                            int B, int L, int K, int width, void* stream) {
  if (B <= 0 || K <= 0) return cudaSuccess;
  if (width < 1 || width > L || B > 65535) return cudaErrorInvalidValue;
  Geometry geo{L, K, width, 4, 0, 0};
  geo.aligned = L % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  geo.row_cap = ((geo.aligned ? width + 3 : width) + 3) / 4 * 4;
  while (geo.group > 1 && (size_t)kStages * geo.group * geo.row_cap * 4 > kMaxShared) {
    geo.group /= 2;
  }
  const size_t smem = (size_t)kStages * geo.group * geo.row_cap * sizeof(float);
  if (smem > kMaxShared) return cudaErrorInvalidValue;
  cudaError_t err = speedy::grant_shared_bytes(gather_pipelined_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((K + kRowsPerBlock - 1) / kRowsPerBlock, B);
  gather_pipelined_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, starts, out, geo);
  return cudaGetLastError();
}
