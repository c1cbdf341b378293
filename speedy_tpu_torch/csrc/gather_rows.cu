// Per-row gather: rows[b, k, j] = x[b, s + j] for j < width, with
// s = clamp(starts[b, k], 0, L - width), and rows k >= n_valid[b] written
// as zeros.
//
// Replaces: speedy_tpu/ops/pallas_kernels.py:121 gather_rows_pallas (body
// _gather_rows_kernel, :59), reached through gather_rows (:182) from the
// grid engine's unbounded synthesis (speedy_tpu/ops/wsola_fast.py:603).
// The clamp is the one jax.lax.dynamic_slice applies in
// gather_rows_reference (:173); the TPU kernel assumes 0 <= s <= L - width
// and leaves skipped rows unspecified, where this one writes zeros.
//
// Bound on the H100: bytes. Each valid row is one read of width floats and
// one write of the same; there is no arithmetic. At B=128, 10 s at 16 kHz
// and width 321 the output is 166 MB, about 0.05 ms of writes at
// 3.35 TB/s, plus the reads of the valid rows.
//
// Design: one warp per row, eight rows per block, a 2-D grid over (row
// blocks, utterances). Consecutive lanes read and write consecutive
// samples, so each row is one coalesced read and one coalesced write. The
// TPU kernel's 1024-sample aligned superset DMA, its sublane and lane
// rolls, the 32-row programs and the SMEM batch chunking existed because
// Mosaic has no unaligned vector loads or large scalar memory; a CUDA
// thread loads any address, and each warp reads its own start.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_rows_kernel(const float* __restrict__ x, const int* __restrict__ starts,
                   const int* __restrict__ n_valid, float* __restrict__ out, int L,
                   int K, int width) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (k >= K) return;
  float* row = out + ((long long)b * K + k) * width;
  const int nv = n_valid == nullptr ? K : n_valid[b];
  if (k >= nv) {
    for (int j = lane; j < width; j += 32) row[j] = 0.f;
    return;
  }
  const int s = min(max(starts[(long long)b * K + k], 0), L - width);
  const float* src = x + (long long)b * L + s;
  for (int j = lane; j < width; j += 32) row[j] = src[j];
}

}  // namespace

// x [B, L], starts [B, K] int32, n_valid [B] int32 or null (all K rows
// valid) -> out [B, K, width]. Needs 1 <= width <= L. Returns a
// cudaError_t.
extern "C" int speedy_gather_rows(const float* x, const int* starts, const int* n_valid,
                                  float* out, int B, int L, int K, int width,
                                  void* stream) {
  if (B <= 0 || K <= 0) return cudaSuccess;
  if (width < 1 || width > L || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((K + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  gather_rows_kernel<<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, starts, n_valid, out, L, K, width);
  return cudaGetLastError();
}
