// Pitch SSD search: one sub-sample pitch period per grid cell.
//
// Replaces: speedy_tpu/ops/pallas_kernels.py:1235 pitch_ssd_pallas (body
// _pitch_ssd_kernel, :1166) and the pitch half of the fused front-end
// analysis_energy_lsd_pallas(pitch_geom=...), :1700; both share the math of
// _pitch_cell_body, :1117-1163.
//
// Cell g of utterance b reads seg = gain * x[b, g*G : g*G + seg_w], zero
// past L, with seg_w = taps + max_period. For every lag l in
// [min_period, max_period]:
//   SSD(l) = e0 + e_lag(l) - 2*cc(l),  cc(l) = sum_{i<taps} seg[i]*seg[i+l],
// where e0 and e_lag come from one prefix sum of seg^2. The period is the
// first argmin (jnp.argmin's tie rule), refined by a 3-point parabola with
// the |den| > 1e-12 guard and the fraction clipped to +-0.5.
//
// Bound on the H100: multiply-adds. cc costs taps*n_lags of them a cell:
// about 51k at 16 kHz (taps 246, 207 lags), 2 G over the 40k cells of a
// B=128, 10 s batch (0.061 ms at the float32 peak), against 82 MB of x
// read once (0.0245 ms). The TPU formed cc with real-DFT matmuls (about
// 390k MACs a cell) because its matrix unit made them cheap; on CUDA
// cores the direct sum is 7.6x less work.
//
// Precision: full float32, no TF32. Where this search and a float64 one
// part, the cell's SSD curve has a plateau of tied lags (a segment whose
// lagged windows run into exact silence), and the two picks' float64 SSDs
// agree to 5e-14 of the curve's scale. Accumulating in float64 changes
// which tie wins, parts from the float64 search on about as many cells
// (0.95% against 1.09% at B=128, 10 s, 16 kHz) and takes 1.4x the time
// (H100 80GB HBM3 at 700 W; PERF.md, Findings).
//
// Design: one warp per cell, kWarps cells a block, and no block barrier:
// each warp stages its own segment in shared memory with 16-byte loads
// where x's rows allow them. Lane q owns the R consecutive lags
// minp + q*R + [0, R) (R = ceil(n_lags / 32), a template parameter; above
// kMaxR the lanes sweep the lags 32*R at a time). For each tap i it needs
// seg[i], one broadcast load, and seg[i + l0 .. i + l0 + R-1], a window
// kept in registers that moves R samples every R taps: R*R multiply-adds
// for 2R loads, where one lag a thread cost two loads a multiply-add.
// Each lag's cc is fmaf over i ascending from 0, bitwise the per-thread
// sum of the block-per-cell design this replaces. The prefix sum of seg^2
// is a warp scan over rows of 32 samples, each row's inclusive scan by
// shuffles plus the carry of the rows before it: e0 and e_lag sum in
// another order than that design's Hillis-Steele rounds, so their bits
// differ. The argmin is a butterfly of shuffles on (value, index), so equal
// values resolve to the lowest lag; lane 0 refines it from the warp's
// SSD row in shared memory.

#include <cuda_runtime.h>

#include "shared_grant.cuh"

namespace {

constexpr int kWarps = 4;   // cells a block
constexpr int kMaxR = 20;   // lags a lane at most in one sweep

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// The segment's floats in shared memory: zero-padded to the last window
// sample a lane reads, and to a multiple of 4.
__host__ __device__ __forceinline__ int seg_pad(int taps, int minp, int R, int sweeps) {
  return (taps + minp + 32 * R * sweeps + 3) & ~3;
}

// Floats of shared memory one warp uses, a multiple of 4: the padded
// segment, its prefix sums and the SSD row.
__host__ __device__ __forceinline__ int warp_floats(int pad, int seg_w, int n_lags) {
  return (pad + seg_w + n_lags + 3) & ~3;
}

template <int R>
__global__ void __launch_bounds__(kWarps * 32)
pitch_kernel(const float* __restrict__ x, const float* __restrict__ gain,
             float* __restrict__ period, int L, int n_cells, int n_grid, int G, int taps,
             int minp, int maxp, int sweeps, int vec4) {
  extern __shared__ float4 smem4[];
  const int seg_w = taps + maxp;
  const int n_lags = maxp - minp + 1;
  const int pad = seg_pad(taps, minp, R, sweeps);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* seg = reinterpret_cast<float*>(smem4) + warp * warp_floats(pad, seg_w, n_lags);
  float* cum = seg + pad;    // [seg_w] inclusive prefix sums of seg^2
  float* ssd = cum + seg_w;  // [n_lags]

  const int cell = blockIdx.x * kWarps + warp;
  if (cell >= n_cells) return;  // the whole warp; no block barrier follows
  const int b = cell / n_grid;
  const int g = cell - b * n_grid;
  const float gb = gain[b];
  const float* xb = x + (size_t)b * L;
  const long long base = (long long)g * G;

  // Stage the segment: 16-byte loads where the row and G keep them aligned.
  for (int i = 4 * lane; i < pad; i += 128) {
    const long long s = base + i;
    float v[4];
    if (vec4 && s + 3 < L && i + 3 < seg_w) {
      const float4 q = *reinterpret_cast<const float4*>(xb + s);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __fmul_rn(v[u], gb);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = i + u < seg_w && s + u < L ? __fmul_rn(xb[s + u], gb) : 0.0f;
    }
    *reinterpret_cast<float4*>(seg + i) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncwarp();

  // Prefix sums of seg^2: rows of 32, each an inclusive warp scan plus the
  // running total of the rows before.
  float carry = 0.0f;
  for (int r0 = 0; r0 < seg_w; r0 += 32) {
    const int i = r0 + lane;
    float v = i < seg_w ? __fmul_rn(seg[i], seg[i]) : 0.0f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += up;
    }
    v += carry;
    if (i < seg_w) cum[i] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
  __syncwarp();
  const float e0 = cum[taps - 1];

  float bv = __int_as_float(0x7f800000);  // +inf
  int bi = 0x7fffffff;
  bool first = true;
  for (int sw = 0; sw < sweeps; ++sw) {
    const int j0 = sw * 32 * R + lane * R;  // the lane's first lag index
    const float* win_src = seg + minp + j0;
    float cc[R], w[2 * R - 1];
#pragma unroll
    for (int r = 0; r < R; ++r) cc[r] = 0.0f;
#pragma unroll
    for (int u = 0; u < R - 1; ++u) w[u] = win_src[u];
    int i0 = 0;
    // Two blocks of taps an iteration: the window's shift becomes renaming.
#pragma unroll 2
    for (; i0 + R <= taps; i0 += R) {
#pragma unroll
      for (int u = 0; u < R; ++u) w[R - 1 + u] = win_src[i0 + R - 1 + u];
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const float a = seg[i0 + t];
#pragma unroll
        for (int r = 0; r < R; ++r) cc[r] = fmaf(a, w[t + r], cc[r]);
      }
#pragma unroll
      for (int u = 0; u < R - 1; ++u) w[u] = w[R + u];
    }
    for (int i = i0; i < taps; ++i) {
      const float a = seg[i];
#pragma unroll
      for (int r = 0; r < R; ++r) cc[r] = fmaf(a, win_src[i + r], cc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = j0 + r;
      if (j < n_lags) {
        const int l = minp + j;
        const float e_lag = cum[l + taps - 1] - cum[l - 1];
        const float v = (e0 + e_lag) - 2.0f * cc[r];
        ssd[j] = v;
        if (first || v < bv) {
          bv = v;
          bi = j;
          first = false;
        }
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  __syncwarp();
  if (lane == 0) {
    const int jc = min(max(bi, 1), n_lags - 2);
    const float l_ = ssd[jc - 1], m_ = ssd[jc], r_ = ssd[jc + 1];
    const float den = (l_ - 2.0f * m_) + r_;
    float frac = fabsf(den) > 1e-12f ? (0.5f * (l_ - r_)) / den : 0.0f;
    frac = fminf(fmaxf(frac, -0.5f), 0.5f);
    period[(size_t)b * n_grid + g] = (float)(minp + jc) + frac;
  }
}

template <int R>
cudaError_t launch(const float* x, const float* gain, float* period, int B, int L,
                   int n_grid, int G, int taps, int minp, int maxp, int sweeps,
                   cudaStream_t stream) {
  const int n_cells = B * n_grid;
  const int per_warp =
      warp_floats(seg_pad(taps, minp, R, sweeps), taps + maxp, maxp - minp + 1);
  const size_t smem = (size_t)kWarps * per_warp * sizeof(float);
  cudaError_t err = speedy::grant_shared_bytes(pitch_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  // 16-byte segment loads need 16-byte aligned rows and cell starts.
  const int vec4 = (reinterpret_cast<size_t>(x) % 16 == 0) && L % 4 == 0 && G % 4 == 0;
  pitch_kernel<R><<<(n_cells + kWarps - 1) / kWarps, kWarps * 32, smem, stream>>>(
      x, gain, period, L, n_cells, n_grid, G, taps, minp, maxp, sweeps, vec4);
  return cudaGetLastError();
}

}  // namespace

// x [B, L], gain [B] -> period [B, n_grid]. Returns a cudaError_t.
extern "C" int speedy_pitch_ssd(const float* x, const float* gain, float* period,
                                int B, int L, int n_grid, int G, int taps,
                                int minp, int maxp, void* stream) {
  if (B <= 0 || n_grid <= 0) return cudaSuccess;
  if (minp < 1 || maxp - minp + 1 < 3 || taps < 1 || G < 1)
    return cudaErrorInvalidValue;
  const int n_lags = maxp - minp + 1;
  int R = (n_lags + 31) / 32;
  R = R > kMaxR ? kMaxR : R;
  const int sweeps = (n_lags + 32 * R - 1) / (32 * R);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
#define SPEEDY_PITCH_R(r) \
  case r: return launch<r>(x, gain, period, B, L, n_grid, G, taps, minp, maxp, sweeps, s);
    SPEEDY_PITCH_R(1) SPEEDY_PITCH_R(2) SPEEDY_PITCH_R(3) SPEEDY_PITCH_R(4)
    SPEEDY_PITCH_R(5) SPEEDY_PITCH_R(6) SPEEDY_PITCH_R(7) SPEEDY_PITCH_R(8)
    SPEEDY_PITCH_R(9) SPEEDY_PITCH_R(10) SPEEDY_PITCH_R(11) SPEEDY_PITCH_R(12)
    SPEEDY_PITCH_R(13) SPEEDY_PITCH_R(14) SPEEDY_PITCH_R(15) SPEEDY_PITCH_R(16)
    SPEEDY_PITCH_R(17) SPEEDY_PITCH_R(18) SPEEDY_PITCH_R(19) SPEEDY_PITCH_R(20)
#undef SPEEDY_PITCH_R
  }
  return cudaErrorInvalidValue;
}
