// Fused WSOLA synthesis: fractional-delay gather, COLA Hann window, half-slot
// overlap-add, gain and the valid-length mask, written straight into the
// [B, capacity] output.
//
// Replaces: speedy_tpu/ops/pallas_kernels.py:653 gather_synth_block_pallas
// (body _gather_synth_kernel, :321) together with the reshape and mask pass
// after it (speedy_tpu/ops/wsola_fast.py:614-626).
//
// With raw_k[j] = x[a_i[k]+j]*(1-a_f[k]) + x[a_i[k]+j+1]*a_f[k] (x read as
// 0 outside [0, L)), output sample s = k*hop + j is
//   k >= 1: win[j]*raw_k[j] + win[hop+j]*raw_{k-1}[hop+j]
//   k == 0: raw_0[j] (slot 0 has no blend partner and is not windowed),
// times gain[b], and 0 at or past valid[b].
//
// Arithmetic: each operation is a round-to-nearest intrinsic in the order
// of kernels.gather_synth_reference ((1-f) first, then x0*(1-f) + x1*f,
// w*raw for each half, their sum, the product with gain), so nvcc
// contracts none of them into an FMA. The plain version on the card is a
// chain of separate PyTorch kernels, none fused, and the two are equal bit
// for bit.
//
// Bound on the H100: bytes. The output is written once (31 MB at the
// B=128, 10 s, 3.5x shape) and each live chunk's 2*hop + 1 samples are read
// once (at 3.5x chunks lie about 560 samples apart, so they do not
// overlap); the controls are a few hundred KB.
//
// Design (the plan is ops/synth_model.py's, which models it in PyTorch):
//  - A block takes one row b and a run of S consecutive output slots
//    k0 .. k0+S-1; the caller picks S (synth_plan): the longest run, at
//    most 16, that still gives every SM two blocks and 12 warps.
//  - Before the first barrier a block reads all it needs but x at once:
//    the run's S+1 controls (a thread a chunk), valid, gain and each
//    thread's window taps, so one latency covers them.
//  - Staged chunk spans. The run reads chunks k0-1 .. k0+S-1: chunk k0-1's
//    second half, chunk k0+S-1's first half, both halves between, and no
//    half that only slots at or past valid read. Each span is copied into
//    shared memory once, with 16-byte cp.async from the aligned address at
//    or below its first sample; a granule that straddles either end of the
//    row is copied a float at a time and zero-filled outside [0, L), so the
//    math reads no branch and x is read in whole 16-byte transactions.
//  - The window in registers. Thread t owns offsets j = t, t + blockDim ..
//    of a slot (one for every hop up to 512) and holds win[j], win[hop+j]
//    in registers across the run's S slots. There is no division: the
//    slot and offset come from the loops, and the slot loop has no branch
//    (its live and zero slots are counted first), so it unrolls.
//  - Stores. Each thread stores its own samples, so a warp writes 128
//    consecutive bytes. Staging the run in shared memory for 16-byte
//    stores (a tile at the row's phase, a scalar head and tail) was slower
//    at every shape measured: it costs a barrier and the shared memory that
//    would hold more blocks.
//  - Past valid. A run that starts at or past valid[b] stages and reads
//    nothing and stores zeros, 16 bytes at a time between a scalar head
//    and tail; the one run that straddles valid[b] stores 0 for its
//    samples at or past it.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "cp_async.cuh"
#include "shared_grant.cuh"

namespace {

using speedy::cp_async16;
using speedy::cp_async4;
using speedy::cp_async_commit;
using speedy::cp_async_wait;

constexpr int kRunMax = 16;      // slots a block (synth_model.RUN_MAX)
constexpr int kThreadsMax = 512;  // synth_model.THREADS_MAX
constexpr int kOffsetsMax = 4;    // offsets a thread (synth_model.OFFSETS_MAX)

// Floats between two staged spans: 2*hop + 1 samples and up to 3 in front
// of them from aligning down, in whole granules (synth_model.span_stride).
__host__ __device__ inline int span_stride(int hop) { return (2 * hop + 4 + 3) / 4 * 4; }

// A chunk's controls as the math reads them, one 16-byte shared load.
struct __align__(16) Ctl {
  int off;    // a_i[c] - span base: where x[a_i[c]] sits in the span
  float f;    // a_f[c]
  float omf;  // 1 - a_f[c]
  int pad;
};

__device__ __forceinline__ float interp(const float* p, const Ctl& c) {
  return __fadd_rn(__fmul_rn(p[0], c.omf), __fmul_rn(p[1], c.f));
}

// Slots m of the run (from 0) whose sample at offset j lies below n:
// ceil((n - j) / hop), 0 when j >= n.
__device__ __forceinline__ int slots_below(int n, int j, int hop) {
  return n > j ? (n - j + hop - 1) / hop : 0;
}

__global__ void __launch_bounds__(kThreadsMax)
synth_kernel(const float* __restrict__ x, const int* __restrict__ a_i,
             const float* __restrict__ a_f, const float* __restrict__ win,
             const float* __restrict__ gain, const int* __restrict__ valid,
             float* __restrict__ out, int L, int K, int hop, int capacity, int run) {
  extern __shared__ __align__(16) float xs[];  // run + 1 spans of `stride` floats
  __shared__ Ctl ctl[kRunMax + 1];
  __shared__ int2 span[kRunMax + 1];  // (base, granules) of chunk k0-1+i

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * run;
  const int s0 = k0 * hop;
  const int n_out = min(run * hop, capacity - s0);  // the run's samples
  float* ob = out + (size_t)b * capacity + s0;

  // Everything the block reads from global memory but x, read at once:
  // chunk k0-1+tid's controls, valid, gain and this thread's window taps.
  const int c = k0 - 1 + tid;
  int a = 0;
  float f = 0.f;
  if (tid <= run && c >= 0 && c < K) {
    a = a_i[(size_t)b * K + c];
    f = a_f[(size_t)b * K + c];
  }
  const int n_live = min(valid[b] - s0, n_out);  // samples not zeroed
  if (n_live <= 0) {
    // The whole run lies at or past valid: zeros, 16 bytes at a time
    // between a scalar head and tail.
    const int ph = static_cast<int>((reinterpret_cast<uintptr_t>(ob) >> 2) & 3);
    const int head = min((4 - ph) & 3, n_out);
    const int quads = (n_out - head) >> 2;
    for (int i = tid; i < head; i += blockDim.x) ob[i] = 0.f;
    float4* oq = reinterpret_cast<float4*>(ob + head);
    for (int i = tid; i < quads; i += blockDim.x) oq[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = head + 4 * quads + tid; i < n_out; i += blockDim.x) ob[i] = 0.f;
    return;
  }
  const float gb = gain[b];
  float w0[kOffsetsMax], w1[kOffsetsMax];
#pragma unroll
  for (int n = 0; n < kOffsetsMax; ++n) {
    const int j = tid + n * blockDim.x;
    w0[n] = j < hop ? win[j] : 0.f;
    w1[n] = j < hop ? win[hop + j] : 0.f;
  }
  const float* xb = x + (size_t)b * L;
  if (tid <= run) {
    const int vend = s0 + n_live;
    const bool first = tid >= 1 && c * hop < vend;                 // slot c
    const bool second = c >= 0 && tid < run && (c + 1) * hop < vend;  // slot c+1
    int base = 0, granules = 0;
    if (first || second) {
      const int lo = first ? 0 : hop;
      const int hi = second ? 2 * hop : hop;  // the span's last sample: a + hi
      const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(xb) >> 2) & 3);
      base = ((a + lo + mis) & ~3) - mis;
      granules = (a + hi - base + 4) >> 2;
    }
    span[tid] = make_int2(base, granules);
    ctl[tid] = Ctl{a - base, f, __fsub_rn(1.f, f), 0};
  }
  __syncthreads();

  // Stage the spans, granule g of chunk i at xs + i*stride + 4g.
  const int stride = span_stride(hop);
  const int per_chunk = stride >> 2;
  int i = tid / per_chunk, g = tid - i * per_chunk;
  while (i <= run) {
    const int2 sp = span[i];
    if (g < sp.y) {
      const int q = sp.x + 4 * g;
      float* dst = xs + i * stride + 4 * g;
      if (q >= 0 && q + 4 <= L) {
        cp_async16(dst, xb + q);
      } else if (q + 4 <= 0 || q >= L) {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (q + e >= 0 && q + e < L) cp_async4(dst + e, xb + q + e);
          else dst[e] = 0.f;
        }
      }
    }
    g += blockDim.x;
    while (g >= per_chunk) {
      g -= per_chunk;
      ++i;
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Slot k0+m at offset j reads chunk k0+m (span m+1) and chunk k0+m-1
  // (span m). Slots m < live are computed, the rest up to `all` are zeros.
  // Each thread stores its own samples, 4 bytes at a time: a warp writes
  // 128 consecutive bytes.
#pragma unroll
  for (int n = 0; n < kOffsetsMax; ++n) {
    const int j = tid + n * blockDim.x;
    if (j >= hop) break;
    const int live = slots_below(n_live, j, hop);
    const int all = slots_below(n_out, j, hop);
    int m = 0;
    if (k0 == 0 && live > 0) {  // slot 0: no partner, no window
      ob[j] = __fmul_rn(interp(xs + stride + ctl[1].off + j, ctl[1]), gb);
      m = 1;
    }
#pragma unroll 4
    for (; m < live; ++m) {
      const Ctl cur = ctl[m + 1], prev = ctl[m];
      const float r1 = interp(xs + (m + 1) * stride + cur.off + j, cur);
      const float r2 = interp(xs + m * stride + prev.off + hop + j, prev);
      ob[m * hop + j] = __fmul_rn(__fadd_rn(__fmul_rn(r1, w0[n]), __fmul_rn(r2, w1[n])), gb);
    }
    for (; m < all; ++m) ob[m * hop + j] = 0.f;
  }
}

}  // namespace

// x [B, L], a_i [B, K] int32, a_f [B, K], win [2*hop], gain [B], valid [B]
// int32 -> out [B, capacity], in runs of `run` slots a block
// (ops/synth_model.py::synth_plan). Needs K*hop >= capacity, hop <= 2,048,
// 1 <= run <= 16 and B <= 65,535. Returns a cudaError_t.
extern "C" int speedy_gather_synth(const float* x, const int* a_i, const float* a_f,
                                   const float* win, const float* gain,
                                   const int* valid, float* out, int B, int L, int K,
                                   int hop, int capacity, int run, void* stream) {
  if (B <= 0 || capacity <= 0) return cudaSuccess;
  if (hop < 1 || hop > kThreadsMax * kOffsetsMax || run < 1 || run > kRunMax ||
      B > 65535 || (long long)K * hop < capacity)
    return cudaErrorInvalidValue;
  const int slots = (capacity + hop - 1) / hop;
  const dim3 grid((slots + run - 1) / run, B);
  const int threads = std::min((hop + 31) / 32 * 32, kThreadsMax);
  const size_t bytes = sizeof(float) * (size_t)(run + 1) * span_stride(hop);
  if (bytes > 48 * 1024) {
    const cudaError_t err = speedy::grant_shared_bytes(synth_kernel, bytes);
    if (err != cudaSuccess) return err;
  }
  synth_kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, a_i, a_f, win, gain, valid, out, L, K, hop, capacity, run);
  return cudaGetLastError();
}
