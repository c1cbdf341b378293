// What the bisection kernels (gather_bisect.cu, synth_bisect.cu) share: the
// TPU kernels' barrel shift composed exactly, the flat view of x their spans
// are read from, and a block's span base.
//
// The barrel (experiments/gather_bisect.py:51-57, synth_bisect.py:84-89,
// bisect_kernel.py:29-35): a slab of 128-lane rows is shifted in 7 steps.
// At step k (sh = 1 << k) row i takes lane l + sh of itself, or lane
// l + sh - 128 of row next(i) past its end, where bits(i) & sh is set, and
// keeps lane l otherwise; each step reads the slab the step before wrote.
// barrel_source walks the steps backward from one output element, reading
// the bits of the row it is on at each step, and lands on the slab element
// that output holds: 7 integer steps in place of 7 passes of pltpu.roll and
// select over the whole slab. Where every row that a walk visits has the
// same bits (kernels 10 and 11) the walk is one shift by bits; where
// neighbouring rows differ (kernel 14) it is not, and
// barrel_source_two_rows walks it from the two rows' bits alone.

#pragma once

#include <climits>

namespace bisect {

constexpr int kLanes = 128;      // lanes of a slab row
constexpr int kSpanAlign = 1024; // a block's span starts at a multiple of this
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // slab rows a block of threads writes, a warp each

// Stages, in the order of the C entry points' `stage`.
constexpr int kCopy = 0;    // span rows as they are (dma)
constexpr int kSelect = 1;  // the one-hot row select (onehot, dot)
constexpr int kShift = 2;   // then the barrel (full for kernels 10, 14; barrel for 11)

template <class Row, class Bits, class Next>
__device__ __forceinline__ void barrel_source(Row& row, int& lane, Bits bits, Next next) {
#pragma unroll
  for (int k = 6; k >= 0; --k) {
    const int sh = 1 << k;
    if (bits(row) & sh) {
      lane += sh;
      if (lane >= kLanes) {
        lane -= kLanes;
        row = next(row);
      }
    }
  }
}

// Kernel 14's walk, from the bits of row i and of next(i) alone: returns
// the source lane of output lane `lane` of row i, and `wrapped` when it
// lies on next(i). A walk wraps at most once: it starts at a lane below 128
// and its steps add at most 64 + 32 + ... + 1 = 127, so the lane it reaches
// before any wrap is below 255, one wrap takes it below 127, and the steps
// left cannot reach 128 again. So it reads no row past next(i), and with
// both rows' bits in registers no load sits on it. In closed form, with s
// = bits & 127: let p be the highest bit at which lane and s agree. Above
// p each has a 1 the other lacks. If both have a 1 at p, the steps from 6
// down to p take lane to exactly 128 + (lane & below), below = 2^p - 1:
// the walk wraps there, and steps p - 1 .. 0 add next_bits & below. If both
// have a 0 at p, or there is no p, lane + s < 128 and it never wraps. So it
// wraps iff lane + s >= 128, and then lands on (lane & below) + (next_bits
// & below). Only the low 7 bits of either enter, so any int32 bits
// (negative ones too) walk as barrel_source does.
__device__ __forceinline__ int barrel_source_two_rows(int bits, int next_bits, int lane,
                                                      bool& wrapped) {
  const int s = bits & (kLanes - 1), sum = lane + s;
  // 2^p - 1, or 0 where lane and s agree nowhere (the shift clamps at 32)
  const int below = __funnelshift_rc(0x7fffffff, 0, __clz(~(s ^ lane) & (kLanes - 1)));
  wrapped = sum >= kLanes;
  return wrapped ? (lane & below) + (next_bits & below) : sum;
}

// floor(a / b) for b > 0, as Python's //.
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return q * b > a ? q - 1 : q;
}

// Sample `local` of utterance b in the TPU wrappers' flat view of x [B, L]
// (gather_bisect.py:80-83): each utterance zero-padded to Lpq samples and
// concatenated, zeros after. A local offset past Lpq reads on into the
// next utterance, as the TPU span does; anything outside the view reads 0.
// The view itself is never built.
__device__ __forceinline__ float flat_sample(const float* __restrict__ x, int B, int L, int Lpq,
                                             int b, int local) {
  if (local >= 0 && local < Lpq) return local < L ? __ldg(x + (long long)b * L + local) : 0.f;
  const int du = floor_div(local, Lpq);
  const int u = b + du;
  const int o = local - du * Lpq;
  return u >= 0 && u < B && o < L ? __ldg(x + (long long)u * L + o) : 0.f;
}

// The minimum of v over the block's kThreads threads (every thread calls it).
__device__ __forceinline__ int block_min(int v, int* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = scratch[0];
  for (int w = 1; w < kThreads / 32; ++w) v = min(v, scratch[w]);
  __syncthreads();
  return v;
}

// Block nb's span base, floor(min start / 1024) * 1024 over its R rows, the
// last start standing in for rows past K (gather_bisect.py:66-71). Every
// thread of a block of threads calls it; with offs non-null they also
// store each row's start less the base there, visible to all after the
// call. Each block of threads a span's rows are spread over finds the base
// anew: R loads, which L1 and L2 serve.
__device__ __forceinline__ int span_base(const int* __restrict__ starts_b, int K, int nb, int R,
                                         int* offs, int* scratch) {
  int m = INT_MAX;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int s = starts_b[min(nb * R + r, K - 1)];
    if (offs != nullptr) offs[r] = s;
    m = min(m, s);
  }
  const int base = floor_div(block_min(m, scratch), kSpanAlign) * kSpanAlign;
  if (offs != nullptr) {
    for (int r = threadIdx.x; r < R; r += kThreads) offs[r] -= base;
    __syncthreads();
  }
  return base;
}

// Live blocks of an utterance: ceil(n_valid / R), at most NB.
__device__ __forceinline__ int live_blocks(int n_valid, int R, int NB) {
  return n_valid <= 0 ? 0 : min((n_valid + R - 1) / R, NB);
}

}  // namespace bisect
