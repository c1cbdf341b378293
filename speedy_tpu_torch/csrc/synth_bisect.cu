// Kernel 3's body stopped after each stage, for bisecting where its time
// goes: the span copy, the one-hot row select, the barrel shift, the
// interpolation and window, the overlap-add.
//
// Replaces: experiments/synth_bisect.py:24 make_fused (body _kernel :28,
// call :174). Per block (b, nb) of R chunks with kernel 10's span geometry
// (barrel.cuh span_base; offs = start - base_al, q8 = offs / 128,
// r7 = offs % 128), the T-major slab row t*R + r (t < nt) is: copy, span
// row t*R + r; select, span row q8[r] + t (zero past w_rows); shift, the
// select barrel-shifted with bits r7[r] and next(t*R + r) = the same r at
// t + 1 mod nt; interp, raw = slab * (1 - af[r]) + (slab shifted one lane)
// * af[r], times window row t (the COLA window of 2*hop, zero past it);
// OLA, slot[r][j] = raw_w[r][j] + raw_w[r - 1][hop + j], where row 0 takes
// the previous block's last row (the TPU kernel's carry) and row 0 of
// block 0 is unwindowed raw[0]. Each stage writes the slab's first R*ts
// rows, ts = ceil(hop / 128), as out [B, NB, R*ts, 128]. There is no gain
// and no valid-length mask. The TPU kernel leaves dead blocks
// (nb >= ceil(n_valid / R)) unwritten; this one writes zeros.
//
// Bound on the H100: bytes, the output written once (134 MB at the
// experiment's shape, about 0.04 ms at 3.35 TB/s) and the samples a stage
// needs read once; the arithmetic is 3 FLOP an interpolated sample.
//
// Design: a warp per slab row, its lanes on consecutive samples, eight
// rows to a block of threads, a grid of (row chunks, NB, B). A block finds
// its span's base and the previous span's (for the carry) and keeps its
// chunks' offsets and fractions in shared memory. Every element is computed
// from its own sources: the shift by barrel_source, the interpolation from two shifted
// samples, the OLA from four, each read straight from global memory (the
// flat view is never built). The TPU kernel's span DMA, one-hot matmul,
// pltpu.roll and scratch carry become this index arithmetic, so the stages
// differ only in it. Products and sums round as the TPU kernel's
// (no fused multiply-add), in its order.

#include <cuda_runtime.h>

#include "barrel.cuh"

namespace {

using namespace bisect;

constexpr int kWindow = 3;  // interp
constexpr int kOla = 4;     // full

struct Chunk {
  int base;  // the span base of the chunk's block
  int off;   // its start less base
  float af;  // its fraction
};

struct Span {
  const float* __restrict__ x;
  const float* __restrict__ win;  // [nt * 128], zero past 2*hop
  int B, L, Lpq, b, w_rows, nt, hop;

  // Tile t, lane l of the chunk's selected rows: span row q8 + t.
  __device__ float select(const Chunk& c, int t, int l) const {
    const int q = c.off / kLanes + t;
    return q < w_rows ? flat_sample(x, B, L, Lpq, b, c.base + q * kLanes + l) : 0.f;
  }
  // The same after the barrel: every step of the walk stays on the chunk's
  // row r, so the bits are r7 throughout.
  __device__ float shifted(const Chunk& c, int t, int l) const {
    const int r7 = c.off & (kLanes - 1);
    const int n = nt;
    barrel_source(t, l, [&](int) { return r7; }, [&](int i) { return i + 1 == n ? 0 : i + 1; });
    return select(c, t, l);
  }
  __device__ float raw(const Chunk& c, int t, int l) const {
    const float a = shifted(c, t, l);
    const float s1 = l + 1 < kLanes ? shifted(c, t, l + 1)
                                    : shifted(c, t + 1 == nt ? 0 : t + 1, 0);
    return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, c.af)), __fmul_rn(s1, c.af));
  }
  __device__ float windowed(const Chunk& c, int t, int l) const {
    return __fmul_rn(raw(c, t, l), win[t * kLanes + l]);
  }
  // The chunk's windowed samples from hop on: tile t, lane l of the slab
  // rolled by hop / 128 tiles, then shifted by hop % 128 lanes.
  __device__ float second(const Chunk& c, int t, int l) const {
    l += hop % kLanes;
    if (l >= kLanes) {
      l -= kLanes;
      ++t;
    }
    return windowed(c, (t + hop / kLanes) % nt, l);
  }
};

template <int Stage>
__global__ void __launch_bounds__(kThreads)
synth_bisect_kernel(const float* __restrict__ x, const int* __restrict__ starts,
                    const float* __restrict__ af, const int* __restrict__ n_valid,
                    const float* __restrict__ win, float* __restrict__ out, int B, int L, int K,
                    int hop, int R, int w_rows, int nt, int ts, int Lpq) {
  extern __shared__ int smem[];  // offs [R], then af [R]
  __shared__ int scratch[kWarps];
  int* offs = smem;
  float* afs = reinterpret_cast<float*>(smem + R);
  const int nb = blockIdx.y, b = blockIdx.z;
  const int st = R * ts;
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;  // this warp's slab row t*R + r
  float* o = out + (((long long)b * gridDim.y + nb) * st + i) * kLanes;
  if (nb >= live_blocks(n_valid[b], R, gridDim.y)) {
    if (i < st)
      for (int l = threadIdx.x % 32; l < kLanes; l += 32) o[l] = 0.f;
    return;
  }
  const int* sb = starts + (long long)b * K;
  const float* ab = af + (long long)b * K;
  for (int r = threadIdx.x; r < R; r += kThreads)
    afs[r] = nb * R + r < K ? ab[nb * R + r] : 0.f;  // af is padded with zeros
  const int base = span_base(sb, K, nb, R, offs, scratch);
  // The carry: the previous block's last chunk, in that block's span.
  Chunk carry{0, 0, 0.f};
  if (Stage == kOla && nb > 0) {
    const int prev_base = span_base(sb, K, nb - 1, R, nullptr, scratch);
    carry = Chunk{prev_base, sb[nb * R - 1] - prev_base, ab[nb * R - 1]};
  }
  if (i >= st) return;
  const int t = i / R, r = i - t * R;
  const Chunk c{base, offs[r], afs[r]};
  const Chunk p = r > 0 ? Chunk{base, offs[r - 1], afs[r - 1]} : carry;
  const Span sp{x, win, B, L, Lpq, b, w_rows, nt, hop};
  for (int l = threadIdx.x % 32; l < kLanes; l += 32) {
    float v;
    if (Stage == kCopy) {
      v = flat_sample(x, B, L, Lpq, b, base + i * kLanes + l);
    } else if (Stage == kSelect) {
      v = sp.select(c, t, l);
    } else if (Stage == kShift) {
      v = sp.shifted(c, t, l);
    } else if (Stage == kWindow) {
      v = sp.windowed(c, t, l);
    } else if (r == 0 && nb == 0) {
      v = sp.raw(c, t, l);
    } else {
      v = __fadd_rn(sp.windowed(c, t, l), sp.second(p, t, l));
    }
    o[l] = v;
  }
}

// The stages' instances, indexed by the C entry point's `stage`.
const decltype(&synth_bisect_kernel<kCopy>) kStages[] = {
    synth_bisect_kernel<kCopy>, synth_bisect_kernel<kSelect>, synth_bisect_kernel<kShift>,
    synth_bisect_kernel<kWindow>, synth_bisect_kernel<kOla>};

}  // namespace

// x [B, L], starts [B, K] int32, af [B, K], n_valid [B] int32, win
// [nt * 128] (the COLA window of 2*hop, zero past it) -> out [B, NB,
// R*ts, 128] after `stage` (0 copy, 1 select, 2 shift, 3 interp, 4 OLA).
// Needs 2*hop + 1 <= L, 2*hop < nt * 128, 1 <= R <= 4096, B and
// ceil(K / R) <= 65535 and, for the copy, R*ts <= w_rows. Returns a
// cudaError_t.
extern "C" int speedy_synth_bisect(const float* x, const int* starts, const float* af,
                                   const int* n_valid, const float* win, float* out, int B,
                                   int L, int K, int hop, int R, int w_rows, int nt, int ts,
                                   int stage, void* stream) {
  if (B <= 0 || K <= 0) return cudaSuccess;
  if (stage < kCopy || stage > kOla || hop < 1 || 2 * hop + 1 > L || 2 * hop >= nt * kLanes ||
      R < 1 || R > 4096 || B > 65535 || (K + R - 1) / R > 65535 ||
      (stage == kCopy && R * ts > w_rows))
    return cudaErrorInvalidValue;
  const dim3 grid((R * ts + kWarps - 1) / kWarps, (K + R - 1) / R, B);
  const int Lpq = (L + kSpanAlign - 1) / kSpanAlign * kSpanAlign;
  const size_t smem = R * (sizeof(int) + sizeof(float));
  kStages[stage]<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, starts, af, n_valid, win, out, B, L, K, hop, R, w_rows, nt, ts, Lpq);
  return cudaGetLastError();
}
