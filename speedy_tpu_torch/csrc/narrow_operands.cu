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
// of output an utterance (12 KiB at B = 96, 4 ns at 3.35 TB/s), far under
// one launch.
//
// Design: the function and nothing else. The BlockSpec's whole-block copy
// belongs to Pallas's pipeline, not to the probe's function, so it is not
// made: one thread per output, t -> (b = t / 8, i = t % 8), reads the three
// words at b*R*C + i*C and writes o[t]. No shared memory and no barrier.
// Row i sits at word i * C of a block, so an utterance's eight words of an
// operand share one 32-byte sector in the narrow layout and lie 512 bytes
// apart in the lane-dense one: what a 1-wide operand costs on the card is
// the difference between the two layouts' times. A contiguous [4096, 1]
// tensor holds the same consecutive words as a [32, 128] one, so nothing
// is padded on the card either way.

#include <climits>

#include <cuda_runtime.h>

namespace {

// Threads a block: 32 measured faster than 64, 128 or 256 in the
// lane-dense layout, whose sectors then spread over more SMs (PERF.md,
// PR 13).
constexpr int kThreads = 32, kOut = 8;

__global__ void __launch_bounds__(kThreads)
narrow_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ c, float* __restrict__ o, int n_out, long long n,
              int C, float amp) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_out) return;
  const long long w = t / kOut * n + (long long)(t % kOut) * C;
  o[t] = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(a + w), amp), __ldg(b + w)), __ldg(c + w));
}

}  // namespace

// a, b, c [B, R, C] -> o [B, 8, 1]; needs R >= 8, C >= 1 and 8 * B within
// an int. Returns a cudaError_t.
extern "C" int speedy_narrow_operand_sum(const float* a, const float* b, const float* c,
                                         float* o, int B, int R, int C, float amp,
                                         void* stream) {
  if (B <= 0) return cudaSuccess;
  if (R < kOut || C < 1 || B > INT_MAX / kOut) return cudaErrorInvalidValue;
  const int n_out = B * kOut;
  narrow_kernel<<<(n_out + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a, b, c, o, n_out, (long long)R * C, C,
                                                       amp);
  return cudaGetLastError();
}
