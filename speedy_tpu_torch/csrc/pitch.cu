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
// B=128, 10 s batch. The TPU formed cc with real-DFT matmuls (about 390k
// MACs a cell) because its matrix unit made them cheap; on CUDA cores the
// direct sum is 7.6x less work.
//
// Precision: full float32, no TF32. Where this search and a float64 one
// part, the cell's SSD curve has a plateau of tied lags (a segment whose
// lagged windows run into exact silence), and the two picks' float64 SSDs
// agree to 5e-14 of the curve's scale. Accumulating in float64 changes
// which tie wins, parts from the float64 search on about as many cells
// (0.95% against 1.09% at B=128, 10 s, 16 kHz) and takes 1.4x the time
// (H100 80GB HBM3 at 700 W; PERF.md, Findings).
//
// Design: one block per cell. The segment and its prefix sums live in
// shared memory; each thread owns lags and accumulates cc over the template,
// reading seg[i] as a broadcast and seg[i+l] from consecutive addresses. The
// argmin is an explicit index-ordered reduction: each thread keeps the first
// minimum of its ascending lags, then warps and the block combine pairs by
// (value, index), so equal values resolve to the lowest lag.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
pitch_kernel(const float* __restrict__ x, const float* __restrict__ gain,
             float* __restrict__ period, int L, int n_grid, int G, int taps,
             int minp, int maxp) {
  extern __shared__ float smem_f[];
  const int seg_w = taps + maxp;
  const int n_lags = maxp - minp + 1;
  float* seg = smem_f;          // [seg_w]
  float* buf0 = seg + seg_w;    // [seg_w] prefix-sum ping
  float* buf1 = buf0 + seg_w;   // [seg_w] prefix-sum pong
  float* ssd = buf1 + seg_w;    // [n_lags]
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const float gb = gain[b];
  const float* xb = x + (size_t)b * L;
  const long long base = (long long)g * G;

  for (int i = threadIdx.x; i < seg_w; i += blockDim.x) {
    const long long s = base + i;
    const float v = s < L ? __fmul_rn(xb[s], gb) : 0.0f;
    seg[i] = v;
    buf0[i] = __fmul_rn(v, v);
  }
  __syncthreads();

  // Inclusive prefix sum of seg^2 (Hillis-Steele, log2(seg_w) rounds).
  float* src = buf0;
  float* dst = buf1;
  for (int off = 1; off < seg_w; off <<= 1) {
    for (int i = threadIdx.x; i < seg_w; i += blockDim.x)
      dst[i] = i >= off ? src[i] + src[i - off] : src[i];
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }
  const float* cum = src;
  const float e0 = cum[taps - 1];

  for (int j = threadIdx.x; j < n_lags; j += blockDim.x) {
    const int l = minp + j;
    float cc = 0.0f;
    for (int i = 0; i < taps; ++i) cc = fmaf(seg[i], seg[i + l], cc);
    const float e_lag = cum[l + taps - 1] - cum[l - 1];
    ssd[j] = (e0 + e_lag) - 2.0f * cc;
  }
  __syncthreads();

  float bv = 0.0f;
  int bi = -1;
  for (int j = threadIdx.x; j < n_lags; j += blockDim.x) {
    const float v = ssd[j];
    if (bi < 0 || v < bv) {
      bv = v;
      bi = j;
    }
  }
  if (bi < 0) {  // a thread without lags loses every comparison below
    bv = __int_as_float(0x7f800000);  // +inf
    bi = 0x7fffffff;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bv = red_v[0];
    bi = red_i[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      if (better(red_v[w], red_i[w], bv, bi)) {
        bv = red_v[w];
        bi = red_i[w];
      }
    const int jc = min(max(bi, 1), n_lags - 2);
    const float l_ = ssd[jc - 1], m_ = ssd[jc], r_ = ssd[jc + 1];
    const float den = (l_ - 2.0f * m_) + r_;
    float frac = fabsf(den) > 1e-12f ? (0.5f * (l_ - r_)) / den : 0.0f;
    frac = fminf(fmaxf(frac, -0.5f), 0.5f);
    period[(size_t)b * n_grid + g] = (float)(minp + jc) + frac;
  }
}

}  // namespace

// x [B, L], gain [B] -> period [B, n_grid]. Returns a cudaError_t.
extern "C" int speedy_pitch_ssd(const float* x, const float* gain, float* period,
                                int B, int L, int n_grid, int G, int taps,
                                int minp, int maxp, void* stream) {
  if (B <= 0 || n_grid <= 0) return cudaSuccess;
  if (minp < 1 || maxp - minp + 1 < 3 || taps < 1 || G < 1)
    return cudaErrorInvalidValue;
  const int seg_w = taps + maxp;
  const size_t smem = (3 * (size_t)seg_w + (maxp - minp + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pitch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_grid, B);
  pitch_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, gain, period, L, n_grid, G, taps, minp, maxp);
  return cudaGetLastError();
}
