// The speed law for a batch of utterances: tension [B, T] -> per-frame
// speeds [B, T] and the final durations (current [B], desired [B]), from
// optional initial durations. One thread per utterance walks its T frames
// in order: speedyComputeSpeedFromTension (speedy.c:768-788) plus the
// shim's nonlinear interpolation (soniclib.c:342-345).
//
// Counterpart of: speedy_tpu/ops/speed.py:49 speed_from_tension, a jitted
// lax.scan (vmapped over the batch by speedy_tpu/parallel/batch.py:578-583)
// that XLA runs as one loop on the device. There is no Pallas kernel; the
// port's plain version is a Python loop of about fifteen PyTorch ops a
// frame (kernels.speed_law_reference), which this kernel replaces on the
// card.
//
// Arithmetic: exactly the plain loop's float32 operations, in its order
// (ops/speed.py: _base_speed, _with_feedback, speed_law_step,
// _interpolate), each written as a round-to-nearest intrinsic so that nvcc
// contracts none of them into an FMA: the plain loop on the card is a chain
// of separate PyTorch kernels, none fused, and the two are held bitwise
// equal. clamp and maximum become fminf/fmaxf, which differ from them only
// for NaN; tension is finite on every path. The scalars rg, fb, nl,
// kMinimumSpeed and 1/kFrameRateHz arrive as the float32 values the plain
// loop makes of them, and the two branches (rg > 1, fb > 0) are taken on
// the caller's Python values, as the plain loop takes them.
//
// Bound on the H100: latency, not bytes or operations. Frame t's speed
// depends on frame t-1's durations through fb * (cur - des), a maximum, an
// add, an IEEE division and an add: six dependent steps, the division a
// sequence of a reciprocal and its refinements with a range check. An
// utterance therefore takes T times that chain's latency, and utterances
// run side by side, a thread each. The bytes (8 B a frame) and operations
// (about 12 a frame) are microseconds at any batch the port runs.
//
// Design: a block of two warps takes 32 utterances. Warp 0 walks them, a
// thread each (at B = 1 one thread walks); warp 1 moves data, so that no
// load or store sits in the walkers' instruction stream. Tension comes in
// chunks of 64 frames a row: warp 1 copies chunk c + 1 into shared memory
// by cp.async and stores chunk c - 1's speeds while warp 0 walks chunk c.
// A walker first reads its row's 64 frames into registers and computes
// their base speeds (no dependence on the durations), then runs the chain;
// the division's range check is a branch, and the compiler schedules no
// load across it, so nothing but the chain is left between two divisions.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

using speedy::cp_async4;
using speedy::cp_async_commit;
using speedy::cp_async_wait;

constexpr int kRows = 32;   // utterances a block, one walker each
constexpr int kChunk = 64;  // frames a row staged at a time
constexpr int kPad = kChunk + 1;

struct Law {
  float rg, fb, nl, min_speed, frame_duration;
};

// Warp 1: chunk c of the block's rows into dst (frames past T and rows past
// B are not copied, and never read).
__device__ __forceinline__ void load_chunk(const float* __restrict__ tension,
                                           float (*dst)[kPad], int lane, int b0, int B, int T,
                                           int c) {
  for (int e = lane; e < kRows * kChunk; e += 32) {
    const int r = e / kChunk, j = e % kChunk;
    const int b = b0 + r, t = c * kChunk + j;
    if (b < B && t < T) cp_async4(&dst[r][j], tension + (long long)b * T + t);
  }
  cp_async_commit();
}

// Warp 1: chunk c's speeds from src to speeds, consecutive lanes on
// consecutive frames.
__device__ __forceinline__ void store_chunk(float* __restrict__ speeds, const float (*src)[kPad],
                                            int lane, int b0, int B, int T, int c) {
  for (int e = lane; e < kRows * kChunk; e += 32) {
    const int r = e / kChunk, j = e % kChunk;
    const int b = b0 + r, t = c * kChunk + j;
    if (b < B && t < T) speeds[(long long)b * T + t] = src[r][j];
  }
}

// kFast: rg > 1, the speed-up branch of the law; kFeedback: fb > 0.
template <bool kFast, bool kFeedback>
__global__ void __launch_bounds__(2 * kRows)
speed_law_kernel(const float* __restrict__ tension, const float* __restrict__ cur0,
                 const float* __restrict__ des0, float* __restrict__ speeds,
                 float* __restrict__ cur_out, float* __restrict__ des_out, int B, int T,
                 Law law) {
  __shared__ float ten[2][kRows][kPad];
  __shared__ float spd[2][kRows][kPad];
  const bool walker = threadIdx.x < kRows;
  const int lane = threadIdx.x % kRows;
  const int b0 = blockIdx.x * kRows;
  const int b = b0 + lane;
  const bool live = walker && b < B;
  float cur = (live && cur0 != nullptr) ? cur0[b] : 0.f;
  float des = (live && des0 != nullptr) ? des0[b] : 0.f;
  // The per-frame constants of the plain loop: 1 - rg, fd / rg, rg * (1 - nl).
  const float one_minus_rg = __fsub_rn(1.f, law.rg);
  const float des_step = __fdiv_rn(law.frame_duration, law.rg);
  const float rg_rest = __fmul_rn(law.rg, __fsub_rn(1.f, law.nl));
  const int chunks = (T + kChunk - 1) / kChunk;
  if (!walker) {
    load_chunk(tension, ten[0], lane, b0, B, T, 0);
    cp_async_wait<0>();
  }
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (!walker) {
      if (c + 1 < chunks) load_chunk(tension, ten[(c + 1) & 1], lane, b0, B, T, c + 1);
      if (c > 0) store_chunk(speeds, spd[(c - 1) & 1], lane, b0, B, T, c - 1);
      cp_async_wait<0>();  // chunk c + 1 has landed
    } else if (live) {
      const int n = min(kChunk, T - c * kChunk);
      const float* row = ten[c & 1][lane];
      float* out = spd[c & 1][lane];
      // The chunk's base speeds, off the chain (frames past n are unused).
      float base[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float t = row[j];
        base[j] = kFast
                      ? fmaxf(__fadd_rn(law.rg, __fmul_rn(one_minus_rg, t)), 1.f)
                      : fmaxf(law.min_speed,
                              fminf(__fsub_rn(law.rg, __fmul_rn(one_minus_rg, t)), 1.f));
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < n) {
          const float req =
              kFeedback
                  ? __fadd_rn(base[j], fmaxf(law.min_speed, __fmul_rn(law.fb, __fsub_rn(cur, des))))
                  : base[j];
          cur = __fadd_rn(cur, __fdiv_rn(law.frame_duration, req));
          des = __fadd_rn(des, des_step);
          out[j] = __fadd_rn(__fmul_rn(req, law.nl), rg_rest);
        }
      }
    }
    // Chunk c's speeds are complete and chunk c + 1's tension is in; the
    // buffers written next iteration were last read before this barrier.
    __syncthreads();
  }
  if (!walker && chunks > 0) store_chunk(speeds, spd[(chunks - 1) & 1], lane, b0, B, T, chunks - 1);
  if (live) {
    cur_out[b] = cur;
    des_out[b] = des;
  }
}

}  // namespace

// tension [B, T] float32, cur0/des0 [B] or null (zeros) -> speeds [B, T],
// cur_out/des_out [B]. rg, fb, nl, min_speed and frame_duration are the
// law's float32 scalars; fast and feedback its branches (rg > 1, fb > 0).
// Returns a cudaError_t.
extern "C" int speedy_speed_law(const float* tension, const float* cur0, const float* des0,
                                float* speeds, float* cur_out, float* des_out, int B, int T,
                                float rg, float fb, float nl, float min_speed,
                                float frame_duration, int fast, int feedback, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (T < 0) return cudaErrorInvalidValue;
  const Law law{rg, fb, nl, min_speed, frame_duration};
  const int blocks = (B + kRows - 1) / kRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = fast ? (feedback ? speed_law_kernel<true, true> : speed_law_kernel<true, false>)
                           : (feedback ? speed_law_kernel<false, true> : speed_law_kernel<false, false>);
  kernel<<<blocks, 2 * kRows, 0, s>>>(tension, cur0, des0, speeds, cur_out, des_out, B, T, law);
  return cudaGetLastError();
}
