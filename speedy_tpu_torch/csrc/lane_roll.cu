// Row rotate: out[r, (c + shift) % G] = x[r, c] for x [R, G] float32 and
// 0 <= shift < G (np.roll(x, shift, axis=1)); a copy, exact.
//
// Replaces: experiments/multitile_roll_probe.py:26 run (kernel :21, call
// :27), pltpu.roll of a [64, 512] tile by 266 lanes. On the TPU a row of
// 512 lanes spans four 128-lane vector tiles, and the probe asks whether
// Mosaic lowers a rotate across them; kernel 2's forward-DFT split needed
// the segment tail at that lane offset.
//
// Bound on the H100: bytes, 128 KiB read and 128 KiB written at the
// probe's shape (0.08 us at 3.35 TB/s), under a launch.
//
// Design: a row has no tiles on the card. One block of threads per row
// and 256-word stretch of it; thread c writes out[r, c] from
// x[r, (c - shift) mod G], so the writes are consecutive and the reads are
// consecutive but for the one wrap. The body runs in 1.1 us of device
// time (torch.profiler on an NVIDIA H100 80GB HBM3 at 700 W,
// chip_smoke.py), the card's floor for a launch, and stays as it is:
// what this kernel loses to torch.roll on is the host's launch path,
// which ops/kernels.py::_launch keeps short (a table bound once, the
// stream's raw handle, no device context when the tensor's device is
// current).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lane_roll_kernel(const float* __restrict__ x, float* __restrict__ out, int G, int shift) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= G) return;
  const long long row = (long long)blockIdx.y * G;
  const int src = c >= shift ? c - shift : c - shift + G;
  out[row + c] = x[row + src];
}

}  // namespace

// x [R, G] -> out [R, G] rotated by shift along G; needs 0 <= shift < G
// and R <= 65535. Returns a cudaError_t.
extern "C" int speedy_lane_roll(const float* x, float* out, int R, int G, int shift,
                                void* stream) {
  if (R <= 0 || G <= 0) return cudaSuccess;
  if (shift < 0 || shift >= G || R > 65535) return cudaErrorInvalidValue;
  const dim3 grid((G + kThreads - 1) / kThreads, R);
  lane_roll_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, G, shift);
  return cudaGetLastError();
}
