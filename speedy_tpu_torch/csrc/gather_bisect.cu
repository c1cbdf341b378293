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
// Design: on the card the TPU's span DMA, one-hot matmul and pltpu.roll
// become index arithmetic: each element's source is computed and read
// straight from global memory, so the stages differ only in that
// arithmetic, and their times say what each costs.
//
// Kernel 10: a warp per output row, its lanes on consecutive samples, eight
// rows to a block of threads, a grid of (row chunks, NB, B). Its blocks
// find their span's base and keep its rows' offsets in shared memory; the
// shift's source comes from barrel_source.
//
// Kernel 14 (bound 0.0007 ms at the experiment's R = 128, w_rows = 1,024,
// under one launch): a warp per slab row, a thread on 4 consecutive lanes,
// so a row is one 16-byte store a thread, eight rows to a block of threads,
// over a grid of (row chunks, NB, B); two or four rows a warp measured
// slower at every stage (PERF.md, PR 13). dma and dot read whole x2 rows as
// 16-byte loads (the bounds test is per row). The shift needs only
// q8k[i] and q8k[next(i)]: a walk wraps at most once, and
// barrel_source_two_rows (barrel.cuh) finds its end in closed form, in
// registers with no load on its chain; a thread's four loads then issue
// together, predicated, with no branch between them. On the card the
// walk's integer operations set the shift's time more than its loads do
// (a step-by-step walk with no loads took longer than the select with
// its load), hence the closed form, a few operations a lane. Where x2 is
// not 16-byte aligned the same kernel makes 4-byte loads; out comes from
// torch.empty, so its stores are always 16-byte.

#include <cstdint>

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

// Four consecutive floats of x2: one 16-byte load where x2 allows it
// (kVec), else four 4-byte ones.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ p) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

template <int Stage, bool kVec>
__global__ void __launch_bounds__(kThreads)
bisect_span_rows_kernel(const int* __restrict__ nvb, const int* __restrict__ bases,
                        const int* __restrict__ q8k, const float* __restrict__ x2,
                        float* __restrict__ out, int tot, int w_rows, int length_rows,
                        int n_rows) {
  const int nb = blockIdx.y, b = blockIdx.z;
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;  // this warp's slab row
  if (i >= tot) return;
  const int l0 = threadIdx.x % 32 * 4;  // this thread's 4 lanes of the row
  const long long blk = (long long)b * gridDim.y + nb;
  const int* __restrict__ q = q8k + blk * tot;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (Stage == kNoCopy) {
    const float f = (float)__ldg(q + i);
    v = make_float4(f, f, f, f);
  } else if (nb < nvb[b]) {
    const unsigned row0 = b * length_rows + bases[blk];
    // Whether span row `row`, x2's row g, is read: inside the span's
    // w_rows (else its one-hot row is empty) and inside x2 (else zeros).
    auto inside = [&](int row, unsigned g) {
      return (unsigned)row < (unsigned)w_rows && g < (unsigned)n_rows;
    };
    const int qi = __ldg(q + i);
    if (Stage == kCopy || Stage == kSelect) {
      const int row = Stage == kCopy ? i : qi;
      const unsigned g = row0 + row;
      if (inside(row, g)) v = load4<kVec>(x2 + (size_t)g * kLanes + l0);
      if (Stage == kCopy) {
        const float f = (float)qi;
        v = make_float4(v.x * 1.f + f, v.y * 1.f + f, v.z * 1.f + f, v.w * 1.f + f);
      }
    } else {
      // The shift: each lane's walk from row i's and next(i)'s bits in
      // registers, then one load from the select row it ends on (span row
      // q8k[i], or q8k[next(i)] past the wrap), all four issued together.
      const int qn = __ldg(q + (i + 1 == tot ? 0 : i + 1));
      const unsigned gi = row0 + qi, gn = row0 + qn;
      const bool in_i = inside(qi, gi), in_n = inside(qn, gn);
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bool wrapped;
        const int lane = barrel_source_two_rows(qi, qn, l0 + j, wrapped);
        e[j] = (wrapped ? in_n : in_i) ? __ldg(x2 + (size_t)(wrapped ? gn : gi) * kLanes + lane)
                                       : 0.f;
      }
      v = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
  *reinterpret_cast<float4*>(out + (blk * tot + i) * kLanes + l0) = v;
}

// The stages' instances, indexed by the C entry points' `stage`.
const decltype(&gather_bisect_kernel<kCopy>) kGatherStages[] = {
    gather_bisect_kernel<kCopy>, gather_bisect_kernel<kSelect>, gather_bisect_kernel<kShift>};
// Kernel 14's by [16-byte loads][stage].
const decltype(&bisect_span_rows_kernel<kCopy, true>) kSpanRowsStages[2][4] = {
    {bisect_span_rows_kernel<kCopy, false>, bisect_span_rows_kernel<kSelect, false>,
     bisect_span_rows_kernel<kShift, false>, bisect_span_rows_kernel<kNoCopy, false>},
    {bisect_span_rows_kernel<kCopy, true>, bisect_span_rows_kernel<kSelect, true>,
     bisect_span_rows_kernel<kShift, true>, bisect_span_rows_kernel<kNoCopy, true>}};

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

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
// 3 no copy). Needs B, NB <= 65535, out 16-byte aligned (torch.empty's
// is) and, for the copy, tot <= w_rows.
// Returns a cudaError_t.
extern "C" int speedy_bisect_span_rows(const int* nvb, const int* bases, const int* q8k,
                                       const float* x2, float* out, int B, int NB, int tot,
                                       int w_rows, int length_rows, int n_rows, int stage,
                                       void* stream) {
  if (B <= 0 || NB <= 0 || tot <= 0) return cudaSuccess;
  if (stage < kCopy || stage > kNoCopy || B > 65535 || NB > 65535 ||
      (stage == kCopy && tot > w_rows) || !aligned16(out))
    return cudaErrorInvalidValue;
  if (w_rows < 0) w_rows = 0;  // the kernel compares rows with them unsigned
  if (n_rows < 0) n_rows = 0;
  const dim3 grid((tot + kWarps - 1) / kWarps, NB, B);
  kSpanRowsStages[aligned16(x2)][stage]<<<grid, kThreads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
      nvb, bases, q8k, x2, out, tot, w_rows, length_rows, n_rows);
  return cudaGetLastError();
}
