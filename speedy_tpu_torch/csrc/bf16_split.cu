// Matrix product c [M, N] = a [M, K] @ b [K, N] in float32, in one of four
// precision modes, each computed as the TPU's matrix unit computes it:
//   conv3   (mode 0)  h = bf16_rn(x), l = bf16_rn(x - f32(h)) for every
//                     element of a and b; c = ah.bh + ah.bl + al.bh
//   bitcast (mode 1)  the same with h = x's top 16 bits (x & 0xFFFF0000,
//                     exact in bf16)
//   default (mode 2)  one pass of bf16_rn-rounded inputs, ah.bh
//   highest (mode 3)  full float32
// Every bf16 x bf16 product is exact in float32, and every pass sums in
// float32.
//
// Replaces: experiments/bf16_split_probe.py:70 run (body _kernel, :32), a
// [256, 256] @ [256, 256] Pallas matmul in these four modes; conv3 is the
// split of speedy_tpu/ops/dft.py's HIGH precision and of
// speedy_tpu/ops/pallas_kernels.py:31 _bf16_trunc_split's callers. The
// probe asks whether the split keeps float32's accuracy on the hardware
// and what it costs; the port asks the same of the H100's tensor cores.
//
// Bound on the H100: at the probe's [256, 256] shape, bytes (0.8 MB, a
// quarter of a microsecond) and so a launch; at kernel 1's DFT product
// ([127,872, 240] @ [240, 241], 246 MB moved) also bytes, 0.073 ms, with
// 3 x 14.8 GFLOP of bf16 passes (0.045 ms at 989 TFLOP/s). highest does
// its 14.8 GFLOP in float32 FMA, 0.22 ms at 67 TFLOP/s.
//
// Design, the bf16 modes: a block of 8 warps computes a 64 x 128 tile of c.
// Per 32-deep step it loads the float32 tiles of a and b (zero past M, K
// and N, so no shape has to be a multiple of 16; kernel 1's N is 241),
// splits each element into its bf16 head and tail in shared memory, and
// each warp runs nvcuda::wmma m16n16k16 bf16 products with float32
// accumulators on its 32 x 32 part: the head products in one set of
// accumulators, the two tail products in another, added at the end. The
// TPU's 3-pass product becomes 3 tensor-core instructions per fragment
// pair on the same staged tiles. No TF32 anywhere. highest is an FMA loop
// tiled through shared memory, 4 x 4 outputs a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kConv3 = 0, kBitcast = 1, kDefault = 2, kHighest = 3;

// Tensor-core tile: 64 x 128 outputs a block, 32-deep steps, 8 warps as
// 2 x 4 of 32 x 32. Row pads keep wmma's 32-byte fragment alignment and
// spread shared-memory banks.
constexpr int kBM = 64, kBN = 128, kBK = 32, kWarps = 8;
constexpr int kLdA = kBK + 8, kLdB = kBN + 8, kLdC = kBN + 4;
// Shared memory: a's head and tail [kBM][kLdA] and b's [kBK][kLdB], all
// bf16; after the last product the same bytes stage c [kBM][kLdC] float.
constexpr int kTileBytes = 2 * 2 * (kBM * kLdA + kBK * kLdB);
constexpr int kCBytes = 4 * kBM * kLdC;
constexpr int kSharedBytes = kTileBytes > kCBytes ? kTileBytes : kCBytes;

template <int MODE>
__device__ __forceinline__ void split(float x, __nv_bfloat16* hi, __nv_bfloat16* lo) {
  if (MODE == kBitcast) {
    const float h = __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
    *hi = __float2bfloat16_rn(h);  // exact: the low 16 bits are zero
    *lo = __float2bfloat16_rn(x - h);
  } else {
    *hi = __float2bfloat16_rn(x);
    if (MODE != kDefault) *lo = __float2bfloat16_rn(x - __bfloat162float(*hi));
  }
}

// Two blocks an SM: the split modes then fit 128 registers a thread without
// spilling (left to itself ptxas takes ~150 and one block an SM), and the
// second block's loads overlap the first one's products.
template <int MODE>
__global__ void __launch_bounds__(kWarps * 32, 2)
bf16_split_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int M, int K, int N) {
  __shared__ __align__(128) unsigned char smem[kSharedBytes];
  auto a_hi = reinterpret_cast<__nv_bfloat16 (*)[kLdA]>(smem);
  auto a_lo = a_hi + kBM;
  auto b_hi = reinterpret_cast<__nv_bfloat16 (*)[kLdB]>(a_lo + kBM);
  auto b_lo = b_hi + kBK;
  auto cs = reinterpret_cast<float (*)[kLdC]>(smem);
  constexpr bool kSplit = MODE != kDefault;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  FragC acc[2][2], tail[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0.f);
      wmma::fill_fragment(tail[i][j], 0.f);
    }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // a's 64 x 32 tile: 32 consecutive floats a row, 8 per thread.
    for (int e = tid; e < kBM * kBK; e += kWarps * 32) {
      const int r = e / kBK, kk = e % kBK;
      const long long gm = m0 + r;
      const int gk = k0 + kk;
      const float v = (gm < M && gk < K) ? a[gm * K + gk] : 0.f;
      split<MODE>(v, &a_hi[r][kk], &a_lo[r][kk]);
    }
    // b's 32 x 128 tile: 128 consecutive floats a row, 16 per thread.
    for (int e = tid; e < kBK * kBN; e += kWarps * 32) {
      const int kk = e / kBN, n = e % kBN;
      const int gk = k0 + kk, gn = n0 + n;
      const float v = (gk < K && gn < N) ? b[(long long)gk * N + gn] : 0.f;
      split<MODE>(v, &b_hi[kk][n], &b_lo[kk][n]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA ah[2], al[2];
      FragB bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(ah[i], &a_hi[wm * 32 + i * 16][kk], kLdA);
        wmma::load_matrix_sync(bh[i], &b_hi[kk][wn * 32 + i * 16], kLdB);
        if (kSplit) {
          wmma::load_matrix_sync(al[i], &a_lo[wm * 32 + i * 16][kk], kLdA);
          wmma::load_matrix_sync(bl[i], &b_lo[kk][wn * 32 + i * 16], kLdB);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(acc[i][j], ah[i], bh[j], acc[i][j]);
          if (kSplit) {
            wmma::mma_sync(tail[i][j], ah[i], bl[j], tail[i][j]);
            wmma::mma_sync(tail[i][j], al[i], bh[j], tail[i][j]);
          }
        }
    }
    __syncthreads();
  }

  // Head plus tails, staged through shared memory so that the ragged edge
  // of M and N is masked on the way out.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (kSplit)
        for (int t = 0; t < acc[i][j].num_elements; ++t) acc[i][j].x[t] += tail[i][j].x[t];
      wmma::store_matrix_sync(&cs[wm * 32 + i * 16][wn * 32 + j * 16], acc[i][j], kLdC,
                              wmma::mem_row_major);
    }
  __syncthreads();
  for (int e = tid; e < kBM * kBN; e += kWarps * 32) {
    const int r = e / kBN, n = e % kBN;
    if (m0 + r < M && n0 + n < N) c[(m0 + r) * N + n0 + n] = cs[r][n];
  }
}

// highest: 64 x 64 outputs a block of 16 x 16 threads, each the 4 x 4
// outputs (ty + 16 i, tx + 16 j), over 16-deep steps; a's tile is stored
// transposed so that a step reads one broadcast word of it and 16
// consecutive words of b's.
constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(256)
f32_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int M, int K, int N) {
  __shared__ float as[kFK][kFM + 1];
  __shared__ float bs[kFK][kFN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.x * kFM;
  const int n0 = blockIdx.y * kFN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFK) {
    for (int e = tid; e < kFM * kFK; e += 256) {
      const int r = e / kFK, kk = e % kFK;
      const long long gm = m0 + r;
      const int gk = k0 + kk;
      as[kk][r] = (gm < M && gk < K) ? a[gm * K + gk] : 0.f;
    }
    for (int e = tid; e < kFK * kFN; e += 256) {
      const int kk = e / kFN, n = e % kFN;
      const int gk = k0 + kk, gn = n0 + n;
      bs[kk][n] = (gk < K && gn < N) ? b[(long long)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long gm = m0 + ty + 16 * i;
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) c[gm * N + gn] = acc[i][j];
    }
}

}  // namespace

// a [M, K], b [K, N] row-major float32 -> c [M, N]; mode 0 conv3, 1
// bitcast, 2 default, 3 highest. Needs K >= 1. Returns a cudaError_t.
extern "C" int speedy_bf16_split_matmul(const float* a, const float* b, float* c, int M,
                                        int K, int N, int mode, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || mode < kConv3 || mode > kHighest) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kHighest) {
    const dim3 grid((M + kFM - 1) / kFM, (N + kFN - 1) / kFN);
    f32_matmul_kernel<<<grid, 256, 0, s>>>(a, b, c, M, K, N);
    return cudaGetLastError();
  }
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (mode == kConv3) bf16_split_kernel<kConv3><<<grid, kWarps * 32, 0, s>>>(a, b, c, M, K, N);
  if (mode == kBitcast)
    bf16_split_kernel<kBitcast><<<grid, kWarps * 32, 0, s>>>(a, b, c, M, K, N);
  if (mode == kDefault)
    bf16_split_kernel<kDefault><<<grid, kWarps * 32, 0, s>>>(a, b, c, M, K, N);
  return cudaGetLastError();
}
