// Per-row gather, one block per utterance with double-buffered row copies:
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
// Bound on the H100: bytes, as for gather_rows. The schedule is the
// experiment's and not a fast one: an utterance's K rows go through one SM
// in sequence, so at B=128 only 128 of the 132 SMs work and each row's copy
// latency is hidden behind one row's store at most.
//
// Design: one block per utterance. Row j+1's samples are copied into one of
// two shared-memory rows with cp.async while row j is stored from the other,
// consecutive threads on consecutive samples.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

using speedy::cp_async4;
using speedy::cp_async_commit;
using speedy::cp_async_wait;

constexpr int kThreads = 128;

__device__ __forceinline__ void issue_row(const float* __restrict__ xb,
                                          const int* __restrict__ sb, int j, int max_start,
                                          int width, float* dst) {
  const int s = min(max(sb[j], 0), max_start);
  for (int i = threadIdx.x; i < width; i += kThreads) cp_async4(dst + i, xb + s + i);
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
gather_pipelined_kernel(const float* __restrict__ x, const int* __restrict__ starts,
                        float* __restrict__ out, int L, int K, int width) {
  extern __shared__ float buf[];  // [2][width]
  const int b = blockIdx.x;
  const float* xb = x + (long long)b * L;
  const int* sb = starts + (long long)b * K;
  float* ob = out + (long long)b * K * width;
  issue_row(xb, sb, 0, L - width, width, buf);
  for (int j = 0; j < K; ++j) {
    if (j + 1 < K) {
      issue_row(xb, sb, j + 1, L - width, width, buf + ((j + 1) & 1) * width);
      cp_async_wait<1>();  // row j has landed; row j+1 may still fly
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* src = buf + (j & 1) * width;
    float* dst = ob + (long long)j * width;
    for (int i = threadIdx.x; i < width; i += kThreads) dst[i] = src[i];
    __syncthreads();  // this buffer is refilled by row j+2
  }
}

}  // namespace

// x [B, L], starts [B, K] int32 -> out [B, K, width]. Needs 1 <= width <= L.
// Returns a cudaError_t.
extern "C" int speedy_gather_rows_pipelined(const float* x, const int* starts, float* out,
                                            int B, int L, int K, int width, void* stream) {
  if (B <= 0 || K <= 0) return cudaSuccess;
  if (width < 1 || width > L) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)width * sizeof(float);
  cudaError_t err = speedy::allow_shared_bytes(gather_pipelined_kernel, smem);
  if (err != cudaSuccess) return err;
  gather_pipelined_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, starts, out, L, K, width);
  return cudaGetLastError();
}
