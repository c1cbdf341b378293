// Kernel 5's body stopped after each stage, for bisecting where its time
// goes: the span copy, the one-hot row select, the barrel shift. Two
// kernels share the stages (barrel.cuh):
//
// Kernel 10 replaces experiments/gather_bisect.py:62 gather_variant (body
// _kernel :26, call :96). Per block (b, nb) of R rows with span base
// base_al (barrel.cuh span_base) and offs = start - base_al, q8 = offs / 128,
// r7 = offs % 128, the R-major slab row r*nt + t is: copy, span row
// r*nt + t; select, span row q8[r] + t (zero past the span's w_rows, where
// the one-hot row is empty); shift, the select barrel-shifted with bits
// r7[r] and next(i) = i + 1 mod R*nt, which is x[b, s : s + width] where
// the span holds it. Written as out [B, K, width]: row nb*R + r is the
// slab's rows r*nt .. r*nt + nt - 1 joined and cut to width. Span row q is
// flat[b*Lpq + base_al + q*128 :][:128] of the flat view (barrel.cuh).
//
// Kernel 14 replaces experiments/bisect_kernel.py:57 (body kern :13), a
// copy of the same body on given rows: block (b, nb)'s span is x2's rows
// from b*length_rows + bases[b, nb]; slab row i is copy, span row i +
// q8k[i]; select, span row q8k[i]; shift, the select barrel-shifted with
// bits q8k[i] and next(i) = i + 1, which is no single shift, since
// neighbouring rows have other bits; no copy, q8k[i] in every lane. Out
// [B, NB, R*nt, 128].
//
// The TPU kernels leave dead blocks (nb >= ceil(n_valid / R), nb >= nvb[b])
// unwritten; these write zeros.
//
// Bound on the H100: bytes, the output written once and the span samples a
// stage's output comes from read once (166 MB of output for kernel 10 at
// the experiment's shape, about 0.05 ms at 3.35 TB/s).
//
// Design: a warp per output row (kernel 10) or slab row (kernel 14), its
// lanes on consecutive samples, eight rows to a block of threads, a grid
// of (row chunks, NB, B). Kernel 10's blocks find their span's base and
// keep its rows' offsets in shared memory. On the card the TPU's
// span DMA, one-hot matmul and pltpu.roll become index arithmetic: each
// element's source is computed (for the shift by barrel_source) and read
// straight from global memory, so the stages differ only in that
// arithmetic, and their times say what each costs.

#include <cuda_runtime.h>

#include "barrel.cuh"

namespace {

using namespace bisect;

constexpr int kNoCopy = 3;  // kernel 14's stage for any other name

template <int Stage>
__global__ void __launch_bounds__(kThreads)
gather_bisect_kernel(const float* __restrict__ x, const int* __restrict__ starts,
                     const int* __restrict__ n_valid, float* __restrict__ out, int B, int L,
                     int K, int width, int R, int w_rows, int nt, int Lpq) {
  extern __shared__ int offs[];  // [R]: each row's start less the span base
  __shared__ int scratch[kWarps];
  const int nb = blockIdx.y, b = blockIdx.z;
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;  // this warp's row of the block
  const int k = nb * R + r;
  const bool has_row = r < R && k < K;
  float* o = out + ((long long)b * K + k) * width;
  if (nb >= live_blocks(n_valid[b], R, gridDim.y)) {
    if (has_row)
      for (int j = threadIdx.x % 32; j < width; j += 32) o[j] = 0.f;
    return;
  }
  const int base = span_base(starts + (long long)b * K, K, nb, R, offs, scratch);
  if (!has_row) return;
  for (int j = threadIdx.x % 32; j < width; j += 32) {
    int lane = j % kLanes;
    int2 row = make_int2(r, j / kLanes);  // slab row r*nt + t as (r, t)
    if (Stage == kCopy) {
      o[j] = flat_sample(x, B, L, Lpq, b, base + (r * nt + row.y) * kLanes + lane);
      continue;
    }
    if (Stage == kShift)
      barrel_source(row, lane, [&](int2 i) { return offs[i.x] & (kLanes - 1); },
                    [&](int2 i) {  // slab row r*nt + t + 1, mod R*nt
                      return i.y + 1 < nt ? make_int2(i.x, i.y + 1)
                                          : make_int2(i.x + 1 == R ? 0 : i.x + 1, 0);
                    });
    const int q = offs[row.x] / kLanes + row.y;
    o[j] = q < w_rows ? flat_sample(x, B, L, Lpq, b, base + q * kLanes + lane) : 0.f;
  }
}

template <int Stage>
__global__ void __launch_bounds__(kThreads)
bisect_span_rows_kernel(const int* __restrict__ nvb, const int* __restrict__ bases,
                        const int* __restrict__ q8k, const float* __restrict__ x2,
                        float* __restrict__ out, int tot, int w_rows, int length_rows,
                        int n_rows) {
  const int nb = blockIdx.y, b = blockIdx.z;
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;  // this warp's slab row
  if (i >= tot) return;
  const long long blk = (long long)b * gridDim.y + nb;
  const int* __restrict__ q = q8k + blk * tot;
  float* o = out + (blk * tot + i) * kLanes;
  if (Stage == kNoCopy) {
    const float v = (float)__ldg(q + i);
    for (int l = threadIdx.x % 32; l < kLanes; l += 32) o[l] = v;
    return;
  }
  if (nb >= nvb[b]) {
    for (int l = threadIdx.x % 32; l < kLanes; l += 32) o[l] = 0.f;
    return;
  }
  const int row0 = b * length_rows + bases[blk];
  auto span = [&](int row, int lane) {  // span row `row`; an empty one-hot row past w_rows
    const int g = row0 + row;
    return row >= 0 && row < w_rows && g >= 0 && g < n_rows
               ? __ldg(x2 + (long long)g * kLanes + lane) : 0.f;
  };
  for (int l = threadIdx.x % 32; l < kLanes; l += 32) {
    if (Stage == kCopy) {
      o[l] = span(i, l) * 1.f + (float)__ldg(q + i);
      continue;
    }
    int row = i, lane = l;
    if (Stage == kShift)
      barrel_source(row, lane, [&](int j) { return __ldg(q + j); },
                    [&](int j) { return j + 1 == tot ? 0 : j + 1; });
    o[l] = span(__ldg(q + row), lane);
  }
}

// The stages' instances, indexed by the C entry points' `stage`.
const decltype(&gather_bisect_kernel<kCopy>) kGatherStages[] = {
    gather_bisect_kernel<kCopy>, gather_bisect_kernel<kSelect>, gather_bisect_kernel<kShift>};
const decltype(&bisect_span_rows_kernel<kCopy>) kSpanRowsStages[] = {
    bisect_span_rows_kernel<kCopy>, bisect_span_rows_kernel<kSelect>,
    bisect_span_rows_kernel<kShift>, bisect_span_rows_kernel<kNoCopy>};

}  // namespace

// Kernel 10: x [B, L], starts [B, K] int32, n_valid [B] int32 -> out
// [B, K, width] after `stage` (0 copy, 1 select, 2 shift), blocks of R rows
// whose R*nt slab rows come from a span of w_rows rows. Needs 1 <= width <= L,
// 1 <= R <= 4096, B and ceil(K / R) <= 65535 and, for the copy,
// R*nt <= w_rows. Returns a cudaError_t.
extern "C" int speedy_gather_bisect(const float* x, const int* starts, const int* n_valid,
                                    float* out, int B, int L, int K, int width, int R,
                                    int w_rows, int nt, int stage, void* stream) {
  if (B <= 0 || K <= 0) return cudaSuccess;
  if (stage < kCopy || stage > kShift || width < 1 || width > L || R < 1 || R > 4096 ||
      B > 65535 || (K + R - 1) / R > 65535 || nt * kLanes < width ||
      (stage == kCopy && R * nt > w_rows))
    return cudaErrorInvalidValue;
  const dim3 grid((R + kWarps - 1) / kWarps, (K + R - 1) / R, B);
  const int Lpq = (L + kSpanAlign - 1) / kSpanAlign * kSpanAlign;
  kGatherStages[stage]<<<grid, kThreads, R * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      x, starts, n_valid, out, B, L, K, width, R, w_rows, nt, Lpq);
  return cudaGetLastError();
}

// Kernel 14: nvb [B], bases [B, NB], q8k [B, NB, tot] int32, x2 [n_rows,
// 128] -> out [B, NB, tot, 128] after `stage` (0 copy, 1 select, 2 shift,
// 3 no copy). Needs B, NB <= 65535 and, for the copy, tot <= w_rows.
// Returns a cudaError_t.
extern "C" int speedy_bisect_span_rows(const int* nvb, const int* bases, const int* q8k,
                                       const float* x2, float* out, int B, int NB, int tot,
                                       int w_rows, int length_rows, int n_rows, int stage,
                                       void* stream) {
  if (B <= 0 || NB <= 0 || tot <= 0) return cudaSuccess;
  if (stage < kCopy || stage > kNoCopy || B > 65535 || NB > 65535 ||
      (stage == kCopy && tot > w_rows))
    return cudaErrorInvalidValue;
  const dim3 grid((tot + kWarps - 1) / kWarps, NB, B);
  kSpanRowsStages[stage]<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nvb, bases, q8k, x2, out, tot, w_rows, length_rows, n_rows);
  return cudaGetLastError();
}
