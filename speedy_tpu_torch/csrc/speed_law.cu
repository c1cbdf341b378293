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
// add, a division and an add. An utterance therefore takes T times that
// chain's latency, and utterances run side by side, a thread each. The
// bytes (8 B a frame) and operations (about 12 a frame) are microseconds
// at any batch the port runs.
//
// The division. The numerator is always fd = float32(1/100) and every
// denominator is a requested speed, at least kMinimumSpeed = 0.01. For
// that numerator, law_divide below (the reciprocal's approximation, the
// quotient from it, its remainder by one FMA, and one FMA correcting the
// quotient by remainder x reciprocal) returns the correctly rounded
// quotient, bit for bit __fdiv_rn's, for every float32 denominator in
// [0.01, 2^126): the proof is exhaustive. speedy_speed_law_division_check
// counts the denominators of a range where the two differ; chip_smoke.py
// runs it over all 1,113,336,054 of them on the card and requires none
// (none on an H100 80GB HBM3 at 700 W, law_variants.py at commit c4c951d).
// law_divide drops __fdiv_rn's range check (FCHK) and its branch to a
// slow path, and takes three dependent steps after the reciprocal where
// __fdiv_rn takes five: 29 cycles against 44 on that card. The entry
// point takes only the law's own fd and kMinimumSpeed, so that every
// denominator is at least 0.01, and the kernel bounds each row's
// denominators off the chain, from its largest base speed and the most
// its durations can part: a row whose bound reaches 2^126, which no caller
// of the port makes, is walked again with __fdiv_rn.
//
// Design: a warp a block, kWalkers walkers a warp (lanes 0 .. 7, an
// utterance each), and nothing else: no shared memory, no barrier, no copy
// warp. Each walker first asks L2 for its whole row (one prefetch a
// 128-byte line), then reads its tension a chunk of 16 frames ahead into
// registers, computes the chunk's base speeds (no dependence on the
// durations) before its walk, and stores each speed straight to global
// memory as it is made: loads and stores sit off the chain. A full chunk is
// one straight run of code without a branch; only the last, partial chunk
// tests each frame. Why these numbers (law_variants.py at c4c951d, H100
// 80GB HBM3, 700 W, clock64 cycles a frame at 3.5x fb 0.1): chunks of 8, 16, 32 and
// 64 frames walked in 76, 73, 74 and 73 cycles at B = 1 and in 77, 74, 75
// and 75 at [128, 999] with 8 walkers a warp. With 32 walkers a warp they
// took 76-92 there: each walker's loads and stores touch a cache line of
// their own, and a warp's 32 lines queue behind one another. One walker a
// warp was no faster than 8. The kernel takes 0.2285 ms device at the
// 60 s call (T = 5,991) and 0.0411 at [128, 999] (kernel_ab.py), where
// the chain alone, 52 cycles a frame, takes 0.157 and 0.026 ms.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWalkers = 8;  // utterances a block (one warp), a lane each
constexpr int kChunk = 16;   // frames a walker reads ahead
constexpr float kFrameDuration = 0.01f;   // float32(1 / kFrameRateHz)
constexpr float kMinimumSpeed = 0.01f;    // float32(speedy.c's kMinimumSpeed)
constexpr float kHalfMaxDenominator = 0x1p125f;  // law_divide's proof stops below 2^126

struct Law {
  float rg, fb, nl, min_speed, frame_duration;
};

// fd / b, correctly rounded for fd = kFrameDuration and b in [0.01,
// 2^126) (the head of the file says why).
__device__ __forceinline__ float law_divide(float fd, float b) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(b));
  const float q = __fmul_rn(fd, y);
  const float r = __fmaf_rn(-b, q, fd);
  return __fmaf_rn(r, y, q);
}

__device__ __forceinline__ float base_speed(bool fast, const Law& law, float one_minus_rg,
                                            float t) {
  return fast ? fmaxf(__fadd_rn(law.rg, __fmul_rn(one_minus_rg, t)), 1.f)
              : fmaxf(law.min_speed, fminf(__fsub_rn(law.rg, __fmul_rn(one_minus_rg, t)), 1.f));
}

// One frame: its requested speed from the base and the durations, the
// durations advanced, the speed stored. kShort: law_divide, else
// __fdiv_rn.
template <bool kFeedback, bool kShort>
__device__ __forceinline__ void step(float base, const Law& law, float des_step, float rg_rest,
                                     float& cur, float& des, float* out) {
  const float req =
      kFeedback ? __fadd_rn(base, fmaxf(law.min_speed, __fmul_rn(law.fb, __fsub_rn(cur, des))))
                : base;
  cur = __fadd_rn(cur, kShort ? law_divide(law.frame_duration, req)
                              : __fdiv_rn(law.frame_duration, req));
  des = __fadd_rn(des, des_step);
  *out = __fadd_rn(__fmul_rn(req, law.nl), rg_rest);
}

// A walker's whole row: chunk c + 1's tension is read into registers while
// chunk c is walked, a full chunk without a branch, the last frame by frame.
// top keeps the largest base speed (kShort).
template <bool kFast, bool kFeedback, bool kShort>
__device__ __forceinline__ void walk(const float* __restrict__ row, float* __restrict__ out,
                                     int T, const Law& law, float des_step, float& cur,
                                     float& des, float& top) {
  // The per-frame constants of the plain loop: 1 - rg, rg * (1 - nl).
  const float one_minus_rg = __fsub_rn(1.f, law.rg);
  const float rg_rest = __fmul_rn(law.rg, __fsub_rn(1.f, law.nl));
  float next[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) next[j] = j < T ? __ldg(row + j) : 0.f;
  for (int c0 = 0; c0 < T; c0 += kChunk) {
    float base[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) base[j] = base_speed(kFast, law, one_minus_rg, next[j]);
    if (kShort) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) top = fmaxf(top, base[j]);
    }
    const int c1 = c0 + kChunk;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) next[j] = c1 + j < T ? __ldg(row + c1 + j) : 0.f;
    if (c1 <= T) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        step<kFeedback, kShort>(base[j], law, des_step, rg_rest, cur, des, out + c0 + j);
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (c0 + j < T)
          step<kFeedback, kShort>(base[j], law, des_step, rg_rest, cur, des, out + c0 + j);
    }
  }
}

// walk with IEEE division from the row's first frame, out of line: the
// kernel's hot loop keeps its registers as if it were not there.
// Returns the final (cur, des).
template <bool kFast, bool kFeedback>
__device__ __noinline__ float2 rewalk(const float* __restrict__ row, float* __restrict__ out,
                                      int T, Law law, float des_step, float cur, float des) {
  float top = 0.f;
  walk<kFast, kFeedback, false>(row, out, T, law, des_step, cur, des, top);
  return make_float2(cur, des);
}

// kFast: rg > 1, the speed-up branch of the law; kFeedback: fb > 0.
template <bool kFast, bool kFeedback>
__global__ void __launch_bounds__(32)
speed_law_kernel(const float* __restrict__ tension, const float* __restrict__ cur0,
                 const float* __restrict__ des0, float* __restrict__ speeds,
                 float* __restrict__ cur_out, float* __restrict__ des_out, int B, int T,
                 Law law) {
  const int b = blockIdx.x * kWalkers + threadIdx.x;
  if (threadIdx.x >= kWalkers || b >= B) return;
  const float* row = tension + (long long)b * T;
  float* out = speeds + (long long)b * T;
  for (int t = 0; t < T; t += 32) asm volatile("prefetch.global.L2 [%0];" ::"l"(row + t));
  const float cur_in = cur0 != nullptr ? cur0[b] : 0.f;
  const float des_in = des0 != nullptr ? des0[b] : 0.f;
  const float des_step = __fdiv_rn(law.frame_duration, law.rg);
  float cur = cur_in, des = des_in, top = 0.f;
  walk<kFast, kFeedback, true>(row, out, T, law, des_step, cur, des, top);
  // Every denominator is a base speed plus at most max(0.01, fb * |cur -
  // des|), and each frame moves cur by at most fd / 0.01 = 1 and des by
  // |fd / rg|. Where that could reach 2^126, past law_divide's proof (on
  // no path of the port), the row is walked again with IEEE division.
  const float reach = __fadd_rn(fabsf(cur_in) + fabsf(des_in),
                                __fmul_rn((float)T, __fadd_rn(1.f, fabsf(des_step))));
  const float feedback = kFeedback ? __fmul_rn(fabsf(law.fb), reach) : 0.f;
  if (!(top < kHalfMaxDenominator && feedback < kHalfMaxDenominator)) {
    const float2 again = rewalk<kFast, kFeedback>(row, out, T, law, des_step, cur_in, des_in);
    cur = again.x;
    des = again.y;
  }
  cur_out[b] = cur;
  des_out[b] = des;
}

// Counts the float32 denominators b in [lo, hi) (as bit patterns) where
// law_divide(kFrameDuration, b) and __fdiv_rn(kFrameDuration, b) differ.
__global__ void division_check_kernel(uint32_t lo, uint32_t hi,
                                      unsigned long long* __restrict__ mismatches) {
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  unsigned long long bad = 0;
  for (uint64_t i = lo + (uint64_t)blockIdx.x * blockDim.x + threadIdx.x; i < hi; i += stride) {
    const float b = __uint_as_float((uint32_t)i);
    bad += __float_as_uint(law_divide(kFrameDuration, b)) !=
           __float_as_uint(__fdiv_rn(kFrameDuration, b));
  }
  if (bad) atomicAdd(mismatches, bad);
}

}  // namespace

// tension [B, T] float32, cur0/des0 [B] or null (zeros) -> speeds [B, T],
// cur_out/des_out [B]. rg, fb, nl, min_speed and frame_duration are the
// law's float32 scalars, min_speed and frame_duration the law's own
// (0.01f each); fast and feedback its branches (rg > 1, fb > 0). Returns a
// cudaError_t.
extern "C" int speedy_speed_law(const float* tension, const float* cur0, const float* des0,
                                float* speeds, float* cur_out, float* des_out, int B, int T,
                                float rg, float fb, float nl, float min_speed,
                                float frame_duration, int fast, int feedback, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (T < 0 || frame_duration != kFrameDuration || min_speed != kMinimumSpeed)
    return cudaErrorInvalidValue;
  const Law law{rg, fb, nl, min_speed, frame_duration};
  const int blocks = (B + kWalkers - 1) / kWalkers;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = fast ? (feedback ? speed_law_kernel<true, true> : speed_law_kernel<true, false>)
                           : (feedback ? speed_law_kernel<false, true> : speed_law_kernel<false, false>);
  kernel<<<blocks, 32, 0, s>>>(tension, cur0, des0, speeds, cur_out, des_out, B, T, law);
  return cudaGetLastError();
}

// The denominators b in [lo, hi) (float32 bit patterns, lo <= hi) where
// the walk's division and __fdiv_rn differ, added to *mismatches ([1]
// uint64 on the card, zeroed by the caller). Returns a cudaError_t.
extern "C" int speedy_speed_law_division_check(unsigned lo, unsigned hi,
                                               unsigned long long* mismatches, void* stream) {
  if (hi < lo) return cudaErrorInvalidValue;
  if (hi == lo) return cudaSuccess;
  division_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(lo, hi,
                                                                               mismatches);
  return cudaGetLastError();
}
