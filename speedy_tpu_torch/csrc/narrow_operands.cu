// Narrow operands: o[b, i, 0] = (a[b, i, 0] * amp + b[b, i, 0]) + c[b, i, 0]
// for i < 8, from three [B, R, C] float32 inputs (R >= 8), each rounded
// as float32 multiply and adds in that order.
//
// Replaces: experiments/lane1_blockspec_probe.py:21 make (kernel :22-25,
// call :30): a do-nothing Pallas kernel over a grid of B whose three
// inputs come in BlockSpecs of (1, R, C), either (1, 4096, 1) or the
// lane-dense (1, 32, 128) of the same payload. On the TPU a 1-wide block
// is padded to 128 lanes in VMEM (2 MB a block), and the probe asks
// whether its copy costs that padding, as kernel 3's [4096, 1] control
// inputs seemed to. The probe's window folds a * amp in before each call;
// this kernel folds it in.
//
// Bound on the H100: bytes. The function needs 3 x 8 words of input and 8
// of output an utterance (12 KiB at B = 96, 4 ns at 3.35 TB/s); the block
// copies below move each whole input block (3 x 16 KiB an utterance,
// 4.7 MB at B = 96, 1.4 us), which is the cost the probe measures. Either
// is under a launch.
//
// Design: the BlockSpec's copy is kept. One block of threads per
// utterance copies its three [R, C] blocks into shared memory, 16 bytes a
// thread where the rows allow it, then eight threads compute the outputs
// from rows 0..7, column 0. A contiguous [4096, 1] block and a [32, 128]
// one are the same 16 KiB of consecutive words on the card, so the two
// layouts make the same copy; row i sits at word i * C of the block, so
// the eight words read are 0..7 in the narrow layout and 0, 128, ..., 896
// in the lane-dense one.

#include <cstdint>

#include <cuda_runtime.h>

#include "shared_grant.cuh"

namespace {

constexpr int kThreads = 256, kOut = 8;
constexpr int kMaxShared = 227 * 1024;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
narrow_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ c, float* __restrict__ o, int n, int C, float amp) {
  extern __shared__ float blocks[];  // [3][n], n = R * C
  const long long base = (long long)blockIdx.x * n;
  const float* src[3] = {a + base, b + base, c + base};
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (kVec) {
      const float4* s4 = reinterpret_cast<const float4*>(src[t]);
      float4* d4 = reinterpret_cast<float4*>(blocks + t * n);
      for (int e = threadIdx.x; e < n / 4; e += kThreads) d4[e] = s4[e];
    } else {
      for (int e = threadIdx.x; e < n; e += kThreads) blocks[t * n + e] = src[t][e];
    }
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (i < kOut) {
    const float va = blocks[i * C], vb = blocks[n + i * C], vc = blocks[2 * n + i * C];
    o[(long long)blockIdx.x * kOut + i] = __fadd_rn(__fadd_rn(__fmul_rn(va, amp), vb), vc);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

template <bool kVec>
cudaError_t launch(const float* a, const float* b, const float* c, float* o, int B, int n,
                   int C, float amp, int bytes, cudaStream_t s) {
  if (bytes > 48 * 1024) {  // above the default, a kernel must ask for it
    const cudaError_t err = speedy::grant_shared_bytes(narrow_kernel<kVec>, bytes);
    if (err != cudaSuccess) return err;
  }
  narrow_kernel<kVec><<<B, kThreads, bytes, s>>>(a, b, c, o, n, C, amp);
  return cudaGetLastError();
}

}  // namespace

// a, b, c [B, R, C] -> o [B, 8, 1]; needs R >= 8, C >= 1 and 3 * R * C
// words within a block's shared memory. Returns a cudaError_t.
extern "C" int speedy_narrow_operand_sum(const float* a, const float* b, const float* c,
                                         float* o, int B, int R, int C, float amp,
                                         void* stream) {
  if (B <= 0) return cudaSuccess;
  if (R < kOut || C < 1) return cudaErrorInvalidValue;
  const long long n = (long long)R * C;
  const long long bytes = 3 * n * (long long)sizeof(float);
  if (bytes > kMaxShared) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(c))
    return launch<true>(a, b, c, o, B, static_cast<int>(n), C, amp, static_cast<int>(bytes), s);
  return launch<false>(a, b, c, o, B, static_cast<int>(n), C, amp, static_cast<int>(bytes), s);
}
