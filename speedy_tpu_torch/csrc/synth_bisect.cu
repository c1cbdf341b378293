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
// needs read once; the arithmetic is 3 FLOP an interpolated sample. The
// full stage there takes 0.079 ms device, 68% of its 0.0544 ms bound
// (kernel_ab.py, H100 80GB HBM3, 700 W).
//
// The walk as one run. Every step of the barrel walk stays on the chunk's
// row r, so the shift is one rotation by r7 of the chunk's selected rows
// read as N = nt*128 samples: sample u of the shifted slab (u = t*128 +
// l) is selected sample (u + r7) mod N, which is span row q8 + w / 128,
// lane w % 128, w = (u + r7) mod N, zero past w_rows. An output row t < ts
// of the shift reads u < ts*128; interp reads one sample more; the OLA
// also reads the previous chunk's walk from u + hop on, where the window
// index u + hop stays below N, but u + hop + r7 may pass N and wrap to the
// chunk's first selected row (those samples meet a zero window; their
// signs still reach the sum, so they are read as the TPU kernel reads
// them).
//
// Design: a block takes one (b, nb) and a group of kGroup chunks r, and
// finds its span base once (and, for the OLA's first group, the previous
// block's). For each pass of up to kPassTiles tiles t, each warp stages
// whole runs into shared memory: a chunk's walk samples [t0*128,
// t0*128 + 128*tiles + 1) and, for the OLA, the previous chunk's from
// hop + t0*128 on, each in walk order, so the wrap, the zeros past w_rows
// and the flat view's edges are resolved once per staged sample (a run
// that needs none of them is one contiguous copy). Runs start at any
// sample, so they move by 4-byte cp.async, 32 consecutive samples a warp
// instruction, which is one 128-byte request. The window's two runs are
// staged beside them. Then a warp makes one output row a time, a lane four
// consecutive samples: 16-byte shared loads of the aligned runs and window,
// the TPU kernel's float32 operations in its order (round-to-nearest
// intrinsics, no fused multiply-add), and one 16-byte store. The copy and
// select stages stage their span rows the same way. Dead blocks store
// zeros, 16 bytes at a time.

#include <cuda_runtime.h>

#include "barrel.cuh"
#include "cp_async.cuh"

namespace {

using namespace bisect;
using speedy::cp_async4;
using speedy::cp_async4_zfill;
using speedy::cp_async_commit;
using speedy::cp_async_wait;

constexpr int kWindow = 3;  // interp
constexpr int kOla = 4;     // full
constexpr int kGroup = 16;      // chunks a block
constexpr int kPassTiles = 2;   // output tiles a chunk a pass
constexpr int kPassLanes = kPassTiles * kLanes;
constexpr int kRun = kPassLanes + 4;  // staged samples a run: one more, in whole float4s

// A chunk as its walk reads it: the flat view's sample where its selected
// rows start (base + q8*128), q8, r7 and its fraction.
struct Chunk {
  int origin, q8, r7;
  float af;
};

struct Flat {
  const float* __restrict__ x;
  int B, L, Lpq, b;

  // The address of sample `local` of utterance b in the flat view
  // (barrel.cuh flat_sample), or null where the view holds a zero.
  __device__ const float* at(int local) const {
    if (local >= 0 && local < Lpq) return local < L ? x + (long long)b * L + local : nullptr;
    const int du = floor_div(local, Lpq);
    const int u = b + du;
    const int o = local - du * Lpq;
    return u >= 0 && u < B && o < L ? x + (long long)u * L + o : nullptr;
  }
  __device__ void stage(float* dst, const float* src) const {
    cp_async4_zfill(dst, src != nullptr ? src : x, src != nullptr ? 4 : 0);
  }
};

// Walk samples x0 .. x0 + n - 1 of chunk c into dst, a lane every 32nd.
// Below N every sample's w < 2N, so one subtraction wraps it.
__device__ __forceinline__ void stage_walk(float* dst, const Flat& f, const Chunk& c, int x0,
                                           int n, int N, int w_rows, int lane) {
  const int first = x0 + c.r7, last = x0 + n - 1 + c.r7;
  if (last < N && c.q8 + (last >> 7) < w_rows && c.origin + first >= 0 &&
      c.origin + last < f.L) {  // one contiguous run inside the utterance
    const float* src = f.x + (long long)f.b * f.L + c.origin + first;
    for (int v = lane; v < n; v += 32) cp_async4(dst + v, src + v);
    return;
  }
  for (int v = lane; v < n; v += 32) {
    int w = first + v;
    if (w >= N) w -= N;
    f.stage(dst + v, c.q8 + (w >> 7) < w_rows ? f.at(c.origin + w) : nullptr);
  }
}

template <int Stage>
__global__ void __launch_bounds__(kThreads)
synth_bisect_kernel(const float* __restrict__ x, const int* __restrict__ starts,
                    const float* __restrict__ af, const int* __restrict__ n_valid,
                    const float* __restrict__ win, float* __restrict__ out, int B, int L, int K,
                    int hop, int R, int w_rows, int nt, int ts, int Lpq) {
  __shared__ __align__(16) float cur_run[kGroup][kRun];
  __shared__ __align__(16) float prev_run[Stage == kOla ? kGroup : 1][kRun];
  __shared__ __align__(16) float win_cur[kPassLanes];
  __shared__ __align__(16) float win_prev[kPassLanes];
  __shared__ Chunk chunks[2][kGroup];  // [0] this group's, [1] each one's previous
  __shared__ int scratch[kWarps];
  const int nb = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * kGroup;
  const int rows = min(kGroup, R - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long st = (long long)R * ts;
  float* ob = out + ((long long)b * gridDim.y + nb) * st * kLanes;
  if (nb >= live_blocks(n_valid[b], R, gridDim.y)) {
    for (int t = 0; t < ts; ++t)
      for (int i = warp; i < rows; i += kWarps)
        reinterpret_cast<float4*>(ob + ((long long)t * R + r0 + i) * kLanes)[lane] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int* sb = starts + (long long)b * K;
  const float* ab = af + (long long)b * K;
  const int base = span_base(sb, K, nb, R, nullptr, scratch);
  // The carry: the previous block's last chunk, in that block's span.
  const bool carry = Stage == kOla && nb > 0 && r0 == 0;
  const int prev_base = carry ? span_base(sb, K, nb - 1, R, nullptr, scratch) : base;
  if (threadIdx.x < (Stage == kOla ? 2 : 1) * kGroup) {
    const int i = threadIdx.x % kGroup, prev = threadIdx.x / kGroup;
    const int k = nb * R + r0 + i - prev;  // row r or, for prev, r - 1
    const int bb = prev && r0 + i == 0 ? prev_base : base;
    if (i < rows && k >= 0) {
      const int off = sb[min(k, K - 1)] - bb;  // af is padded with zeros
      chunks[prev][i] = Chunk{bb + (off >> 7) * kLanes, off >> 7, off & (kLanes - 1),
                              k < K ? ab[k] : 0.f};
    }
  }
  __syncthreads();
  const Flat f{x, B, L, Lpq, b};
  const int N = nt * kLanes;
  // Row 0 of block 0 has no previous chunk: its slot is unwindowed raw.
  const bool first_raw = nb == 0 && r0 == 0;
  for (int t0 = 0; t0 < ts; t0 += kPassTiles) {
    const int tiles = min(kPassTiles, ts - t0);
    const int need = tiles * kLanes + (Stage >= kWindow ? 1 : 0);
    for (int job = warp; job < (Stage == kOla ? 2 : 1) * rows; job += kWarps) {
      const int i = job % rows, prev = job / rows;
      if (Stage == kCopy) {  // span rows (t0 + tt) * R + r
        for (int v = lane; v < tiles * kLanes; v += 32)
          f.stage(&cur_run[i][v],
                  f.at(base + ((t0 + v / kLanes) * R + r0 + i) * kLanes + v % kLanes));
      } else if (Stage == kSelect) {  // the walk without the shift
        Chunk c = chunks[0][i];
        c.r7 = 0;
        stage_walk(cur_run[i], f, c, t0 * kLanes, need, N, w_rows, lane);
      } else if (!prev) {
        stage_walk(cur_run[i], f, chunks[0][i], t0 * kLanes, need, N, w_rows, lane);
      } else if (Stage == kOla && !(first_raw && i == 0)) {
        stage_walk(prev_run[i], f, chunks[1][i], hop + t0 * kLanes, need, N, w_rows, lane);
      }
    }
    if (Stage >= kWindow) {
      for (int v = threadIdx.x; v < tiles * kLanes; v += kThreads) {
        cp_async4(&win_cur[v], win + t0 * kLanes + v);
        if (Stage == kOla) cp_async4(&win_prev[v], win + hop + t0 * kLanes + v);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int tt = 0; tt < tiles; ++tt) {
      const int v = tt * kLanes + 4 * lane;  // this lane's four samples
      for (int i = warp; i < rows; i += kWarps) {
        const float4 a = *reinterpret_cast<const float4*>(&cur_run[i][v]);
        float4 o = a;
        if (Stage >= kWindow) {
          const float a4 = cur_run[i][v + 4];
          const float w = chunks[0][i].af, w1 = __fsub_rn(1.f, w);
          // raw = slab * (1 - af) + slab shifted one lane * af
          float4 raw;
          raw.x = __fadd_rn(__fmul_rn(a.x, w1), __fmul_rn(a.y, w));
          raw.y = __fadd_rn(__fmul_rn(a.y, w1), __fmul_rn(a.z, w));
          raw.z = __fadd_rn(__fmul_rn(a.z, w1), __fmul_rn(a.w, w));
          raw.w = __fadd_rn(__fmul_rn(a.w, w1), __fmul_rn(a4, w));
          const float4 wc = *reinterpret_cast<const float4*>(&win_cur[v]);
          o = make_float4(__fmul_rn(raw.x, wc.x), __fmul_rn(raw.y, wc.y),
                          __fmul_rn(raw.z, wc.z), __fmul_rn(raw.w, wc.w));
          if (Stage == kOla) {
            if (first_raw && i == 0) {
              o = raw;
            } else {
              const float4 p = *reinterpret_cast<const float4*>(&prev_run[i][v]);
              const float p4 = prev_run[i][v + 4];
              const float pw = chunks[1][i].af, pw1 = __fsub_rn(1.f, pw);
              const float4 wp = *reinterpret_cast<const float4*>(&win_prev[v]);
              o.x = __fadd_rn(o.x, __fmul_rn(__fadd_rn(__fmul_rn(p.x, pw1), __fmul_rn(p.y, pw)),
                                             wp.x));
              o.y = __fadd_rn(o.y, __fmul_rn(__fadd_rn(__fmul_rn(p.y, pw1), __fmul_rn(p.z, pw)),
                                             wp.y));
              o.z = __fadd_rn(o.z, __fmul_rn(__fadd_rn(__fmul_rn(p.z, pw1), __fmul_rn(p.w, pw)),
                                             wp.z));
              o.w = __fadd_rn(o.w, __fmul_rn(__fadd_rn(__fmul_rn(p.w, pw1), __fmul_rn(p4, pw)),
                                             wp.w));
            }
          }
        }
        reinterpret_cast<float4*>(ob + ((long long)(t0 + tt) * R + r0 + i) * kLanes)[lane] = o;
      }
    }
    __syncthreads();  // every run read before the next pass stages over it
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
  const dim3 grid((R + kGroup - 1) / kGroup, (K + R - 1) / R, B);
  const int Lpq = (L + kSpanAlign - 1) / kSpanAlign * kSpanAlign;
  kStages[stage]<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, starts, af, n_valid, win, out, B, L, K, hop, R, w_rows, nt, ts, Lpq);
  return cudaGetLastError();
}
