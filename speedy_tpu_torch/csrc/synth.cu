// Fused WSOLA synthesis: fractional-delay gather, COLA Hann window, half-slot
// overlap-add, gain and the valid-length mask, written straight into the
// [B, capacity] output.
//
// Replaces: speedy_tpu/ops/pallas_kernels.py:653 gather_synth_block_pallas
// (body _gather_synth_kernel, :321) together with the reshape and mask pass
// after it (speedy_tpu/ops/wsola_fast.py:614-626).
//
// With raw_k[j] = x[a_i[k]+j]*(1-a_f[k]) + x[a_i[k]+j+1]*a_f[k] (x read as
// 0 outside [0, L)), output sample s = k*hop + j is
//   k >= 1: win[j]*raw_k[j] + win[hop+j]*raw_{k-1}[hop+j]
//   k == 0: raw_0[j] (slot 0 has no blend partner and is not windowed),
// times gain[b], and 0 at or past valid[b].
//
// Bound on the H100: bytes. The output is written once (31 MB at the
// B=128, 10 s, 3.5x shape); each sample reads four x values and two slot
// controls, which neighbouring threads share through L1.
//
// Design: one thread per output sample, consecutive threads on consecutive
// samples, so the output store and the x reads of a slot are coalesced.
// Samples at or past valid[b] store 0 and read nothing. The TPU kernel's
// span DMAs, one-hot row selection and barrel shifts existed to turn a
// gather into dense vector work; here the indexed load is direct.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float tap(const float* __restrict__ xb, int L, long long p) {
  return p >= 0 && p < L ? xb[p] : 0.f;
}

__device__ __forceinline__ float raw(const float* __restrict__ xb, int L, int start,
                                     float frac, int j) {
  const long long p = (long long)start + j;
  return tap(xb, L, p) * (1.f - frac) + tap(xb, L, p + 1) * frac;
}

__global__ void __launch_bounds__(kThreads)
synth_kernel(const float* __restrict__ x, const int* __restrict__ a_i,
             const float* __restrict__ a_f, const float* __restrict__ win,
             const float* __restrict__ gain, const int* __restrict__ valid,
             float* __restrict__ out, int L, int K, int hop, int capacity) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (s >= capacity) return;
  float* ob = out + (size_t)b * capacity;
  if (s >= valid[b]) {
    ob[s] = 0.f;
    return;
  }
  const float* xb = x + (size_t)b * L;
  const int* ib = a_i + (size_t)b * K;
  const float* fb = a_f + (size_t)b * K;
  const int k = s / hop;
  const int j = s - k * hop;
  float v;
  if (k == 0) {
    v = raw(xb, L, ib[0], fb[0], j);
  } else {
    v = win[j] * raw(xb, L, ib[k], fb[k], j) +
        win[hop + j] * raw(xb, L, ib[k - 1], fb[k - 1], hop + j);
  }
  ob[s] = v * gain[b];
}

}  // namespace

// x [B, L], a_i [B, K] int32, a_f [B, K], win [2*hop], gain [B], valid [B]
// int32 -> out [B, capacity]. Needs K*hop >= capacity. Returns a cudaError_t.
extern "C" int speedy_gather_synth(const float* x, const int* a_i, const float* a_f,
                                   const float* win, const float* gain,
                                   const int* valid, float* out, int B, int L, int K,
                                   int hop, int capacity, void* stream) {
  if (B <= 0 || capacity <= 0) return cudaSuccess;
  if (hop < 1 || (long long)K * hop < capacity) return cudaErrorInvalidValue;
  const dim3 grid((capacity + kThreads - 1) / kThreads, B);
  synth_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, a_i, a_f, win, gain, valid, out, L, K, hop, capacity);
  return cudaGetLastError();
}
