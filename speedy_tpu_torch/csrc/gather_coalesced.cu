// Coalesced row gather in blocks of 8 rows: rows[b, k, j] = x[b, s + j] for
// j < width and every k < K, with s = clamp(starts[b, k], 0, L - width).
// The same function as csrc/gather_rows.cu with every row live.
//
// Replaces: speedy_tpu/ops/pallas_coalesced.py:102 gather_rows_coalesced
// (body _kernel, :30), an experiment that asked whether one span DMA per
// 8 sorted rows beats a DMA per row on the TPU (it measured no gain there,
// :5-8). As there, a block copies one span of span_rows*128 samples when all
// 8 rows lie in it and reads each row on its own otherwise, so no result
// depends on the starts being sorted. The TPU kernel aligns the span to 1024
// samples and indexes a flattened x; here the span starts at the block's
// first row, the test "every row lies in it" is exact, and starts clamp to
// [0, L - width] as dynamic_slice clamps them.
//
// Bound on the H100: bytes, as for gather_rows. The span route reads the
// whole span (8,192 samples at span_rows = 64) for 8 rows of width samples,
// 3.2x the row bytes at width 321, in exchange for one copy a block.
//
// Design: one block of 8 warps per 8 rows. Threads 0-7 load the block's
// starts; every thread evaluates the same route test. On the span route the
// block copies the span (clipped to L) into shared memory with cp.async and
// warp i writes row i from it; otherwise warp i copies row i from global
// memory. Optionally the route of each block is written out (1 = span).

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "shared_grant.cuh"

namespace {

using speedy::cp_async4;
using speedy::cp_async_commit;
using speedy::cp_async_wait;

constexpr int kRows = 8;  // rows per block, one warp each
constexpr int kThreads = kRows * 32;

__global__ void __launch_bounds__(kThreads)
gather_coalesced_kernel(const float* __restrict__ x, const int* __restrict__ starts,
                        float* __restrict__ out, int* __restrict__ route, int L, int K,
                        int width, int span) {
  extern __shared__ float buf[];  // [span]
  __shared__ int s_start[kRows];
  const int kb = blockIdx.x;
  const int b = blockIdx.y;
  const long long row0 = (long long)b * K + (long long)kb * kRows;
  const float* xb = x + (long long)b * L;
  if (threadIdx.x < kRows) s_start[threadIdx.x] = min(max(starts[row0 + threadIdx.x], 0), L - width);
  __syncthreads();
  const int s0 = s_start[0];
  bool fits = true;
  for (int i = 0; i < kRows; ++i) {
    fits = fits && s_start[i] >= s0 && s_start[i] + width <= s0 + span;
  }
  if (fits) {  // the same for every thread of the block
    const int len = min(span, L - s0);
    for (int i = threadIdx.x; i < len; i += kThreads) cp_async4(buf + i, xb + s0 + i);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  if (route != nullptr && threadIdx.x == 0) route[(long long)b * (K / kRows) + kb] = fits;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* src = fits ? buf + (s_start[w] - s0) : xb + s_start[w];
  float* dst = out + (row0 + w) * width;
  for (int j = lane; j < width; j += 32) dst[j] = src[j];
}

}  // namespace

// x [B, L], starts [B, K] int32 with K % 8 == 0, span_rows >= 1 (the span is
// span_rows*128 samples), route [B, K/8] int32 or null -> out [B, K, width].
// Needs 1 <= width <= L. Returns a cudaError_t.
extern "C" int speedy_gather_rows_coalesced(const float* x, const int* starts, float* out,
                                            int* route, int B, int L, int K, int width,
                                            int span_rows, void* stream) {
  if (B <= 0 || K <= 0) return cudaSuccess;
  if (width < 1 || width > L || K % kRows != 0 || span_rows < 1 || B > 65535) {
    return cudaErrorInvalidValue;
  }
  const int span = span_rows * 128;
  const size_t smem = (size_t)span * sizeof(float);
  cudaError_t err = speedy::grant_shared_bytes(gather_coalesced_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(K / kRows, B);
  gather_coalesced_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, starts, out, route, L, K, width, span);
  return cudaGetLastError();
}
