// Column-to-row transpose: out [8, F] = x[:, :8]^T for x [F, C] (C >= 8),
// in the three forms of the probe, each exact in float32:
//   swap     (form 0)  a shared-memory tile transpose
//   dot_rhsT (form 1)  out = eye[:8, :8] . x[:, :8]^T, 8 FMAs an output
//   dot_lhsT (form 2)  out = x[:, :8]^T . eye, F FMAs an output, reading
//                      the whole [F, F] identity
// eye is read only by the dot forms; the products sum in float32 FMA from
// zero, so with an identity every output is one product by 1 plus
// products by 0, and equals its x element bit for bit.
//
// Replaces: experiments/mosaic_transpose_probe.py:23 make (its kernel,
// :24-42; call :46). Kernel 1 on the TPU reduced per-frame energy and lsd
// to columns [F, 1] of VMEM and wrote frame-lane rows; the probe asks
// which transpose form Mosaic lowers, whether it is exact, and which is
// cheapest. On the H100 the same three forms are written out as threads.
//
// Bound on the H100: bytes, at F = 512 the 16 KiB of columns read and
// 16 KiB written (10 ns at 3.35 TB/s; dot_lhsT also reads 1 MiB of
// identity, 0.32 us), far under a launch, so a launch sets every form's
// time.
//
// Design: one block of 256 threads per 32 rows of x. swap reads the
// block's 32 x 8 columns (8 consecutive words a row) into a padded
// shared tile and writes 8 rows of 32 consecutive words. The dot forms
// give each thread one output (j, f), threads along f consecutive, so a
// step of dot_lhsT reads 32 consecutive identity words a warp.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32, kCols = 8, kThreads = kRows * kCols;

__global__ void __launch_bounds__(kThreads)
transpose_kernel(const float* __restrict__ x, const float* __restrict__ eye,
                 float* __restrict__ out, int F, int C, int form) {
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * kRows;
  // Output element of this thread: row j of out, column f.
  const int j = tid / kRows, f = f0 + tid % kRows;
  if (form == 0) {
    __shared__ float tile[kRows][kCols + 1];
    const int r = tid / kCols, col = tid % kCols;
    if (f0 + r < F) tile[r][col] = x[(long long)(f0 + r) * C + col];
    __syncthreads();
    if (f < F) out[(long long)j * F + f] = tile[tid % kRows][j];
    return;
  }
  if (f >= F) return;
  float acc = 0.f;
  if (form == 1) {
    for (int i = 0; i < kCols; ++i)
      acc = fmaf(eye[(long long)j * F + i], x[(long long)f * C + i], acc);
  } else {
    for (int g = 0; g < F; ++g)
      acc = fmaf(x[(long long)g * C + j], eye[(long long)g * F + f], acc);
  }
  out[(long long)j * F + f] = acc;
}

}  // namespace

// x [F, C] (C >= 8), eye [F, F] (read by forms 1 and 2; F >= 8 for form 1)
// -> out [8, F]; form 0 swap, 1 dot_rhsT, 2 dot_lhsT. Returns a
// cudaError_t.
extern "C" int speedy_transpose_cols(const float* x, const float* eye, float* out, int F,
                                     int C, int form, void* stream) {
  if (F <= 0) return cudaSuccess;
  if (C < kCols || form < 0 || form > 2 || (form == 1 && F < kCols))
    return cudaErrorInvalidValue;
  const int blocks = (F + kRows - 1) / kRows;
  transpose_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, eye, out, F,
                                                                               C, form);
  return cudaGetLastError();
}
