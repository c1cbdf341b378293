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
// Design, the bf16 modes: Hopper's warpgroup products (wgmma m64n128k16,
// bf16 in, float32 accumulators), with a's split in registers and b's in
// shared memory.
//   - Persistent blocks, one an SM, each of two warpgroups. A block owns a
//     128-column tile of b: it splits that tile into bf16 head and tail in
//     shared memory once, in wgmma's K-major layout without swizzle (8 x 8
//     core matrices), then its warpgroups walk 64-row tiles of a, the
//     block's two in turn. Blocks 2j and 2j + 1 take the same rows for
//     two column tiles, so a's second read comes from L2.
//   - Each warpgroup streams its a tiles through a private ring of 4
//     stages of 64 rows x 32 floats, filled by 16-byte cp.async (4-byte
//     where a's rows are not 16-byte aligned; zeros past M and K), 3 stages
//     ahead of the products and across tile ends, so the next chunk's load
//     overlaps this chunk's products and the epilogue.
//   - Each element of a is split once, straight into wgmma's register A
//     fragment (rows g and g + 8 of the warp's 16, k pairs 2t and 2t + 8).
//   - The head product and the two tail products accumulate apart, 3
//     wgmmas a 16-deep step (1 for default), and are added at the end.
//   - The epilogue stages each warp's 16 rows through shared memory, 32
//     columns at a time, and stores full rows of 32 consecutive floats:
//     N = 241 leaves c's rows only 4-byte aligned.
//   - b's head and tail for K = 256 take 128 KB of shared memory; a launch
//     takes at most 256 of K, and the entry point sums longer K over
//     launches, each adding its segment's product into c.
// highest: a float32 FMA loop, no TF32 and no tensor cores. A block of 256
// threads computes a 128 x 128 tile, 8 x 8 outputs a thread, over 8-deep
// steps: a's tile is stored k-major (transposed from registers, loaded as
// float4 a step ahead), b's by cp.async (16 bytes where its rows are
// aligned) into the other of two buffers, and each step reads both as
// float4 from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <algorithm>

#include "cp_async.cuh"
#include "shared_grant.cuh"

namespace {

using speedy::cp_async16_zfill;
using speedy::cp_async4_zfill;
using speedy::cp_async_commit;
using speedy::cp_async_wait;

constexpr int kConv3 = 0, kBitcast = 1, kDefault = 2, kHighest = 3;

// ---------------------------------------------------------------------------
// bf16 modes
// ---------------------------------------------------------------------------

constexpr int kGroups = 2;  // warpgroups a block, each on its own row tiles
constexpr int kThreads = kGroups * 128;
constexpr int kTM = 64;     // rows of a warpgroup's tile: wgmma's M
constexpr int kTN = 128;    // columns of a block's b tile: wgmma's N
constexpr int kMaxK = 256;  // depth of one launch
constexpr int kKC = 32;     // depth of a ring stage: two 16-deep steps
constexpr int kLdA = kKC + 8;  // floats a stage row: conflict-free fragment reads
constexpr int kStages = 4;
constexpr int kStageFloats = kTM * kLdA;
constexpr int kLdC = 33;  // the epilogue's staging row: 32 columns + 1
constexpr size_t kRingBytes = (size_t)kGroups * kStages * kStageFloats * sizeof(float);
constexpr size_t kStoreBytes = (size_t)kGroups * 4 * 16 * kLdC * sizeof(float);
// b's tile: core matrix (kc, ng) of 8 columns x 8 k at element offset
// (kc * kTN / 8 + ng) * 64, row n % 8 of it 16 bytes. Strides in bytes
// between core matrices: along K (leading) and along N (stride).
constexpr uint32_t kLBO = kTN / 8 * 64 * 2;  // 2,048
constexpr uint32_t kSBO = 64 * 2;            // 128

__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((kLBO & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((kSBO & 0x3FFFF) >> 4) << 32);  // base offset 0, no swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += A . B for a 64 x 16 bf16 A in registers (this thread's fragment a)
// and a 16 x 128 bf16 B in shared memory (descriptor desc_b, K-major).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two consecutive elements (x0 the lower column or k) -> their bf16 heads
// and tails, packed as one 32-bit register each, x0 in the low half.
template <int MODE>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  if (MODE == kBitcast) {
    const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
    hi = (u0 >> 16) | (u1 & 0xFFFF0000u);  // exact: the low 16 bits dropped
    lo = bits(__floats2bfloat162_rn(x0 - __uint_as_float(u0 & 0xFFFF0000u),
                                    x1 - __uint_as_float(u1 & 0xFFFF0000u)));
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi = bits(h);
    if (MODE != kDefault) {
      const float2 hf = __bfloat1622float2(h);
      lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
  }
}

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(group + 1) : "memory");
}

struct Shape {
  int M, K, N;   // K: this launch's depth, at most kMaxK
  int lda;       // a's row stride in floats (the whole product's K)
  int accumulate;  // add into c (a later K segment) instead of writing it
  int a_vec;     // a's rows 16-byte aligned: 16-byte copies
  int m_tiles, n_tiles;
};

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
bf16_split_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, Shape sh) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kSplit = MODE != kDefault;
  const int K16 = (sh.K + 15) & ~15;
  __nv_bfloat16* b_hi = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_lo = b_hi + K16 * kTN;  // split modes only
  float* rings = reinterpret_cast<float*>(smem + (size_t)(kSplit ? 2 : 1) * K16 * kTN * 2);
  float* stores = rings + kGroups * kStages * kStageFloats;

  const int n_tile = blockIdx.x % sh.n_tiles;
  const int n0 = n_tile * kTN;

  // b's column tile, split once: a thread takes 8 consecutive k of one
  // column (coalesced across the warp's columns) and writes their heads
  // and tails as one 16-byte row of a core matrix each.
  for (int e = threadIdx.x; e < K16 / 8 * kTN; e += kThreads) {
    const int kc = e / kTN, n = e % kTN;
    const int gn = n0 + n;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = kc * 8 + 2 * q;
      const float x0 = (k < sh.K && gn < sh.N) ? b[(long long)k * sh.N + gn] : 0.f;
      const float x1 = (k + 1 < sh.K && gn < sh.N) ? b[(long long)(k + 1) * sh.N + gn] : 0.f;
      split2<MODE>(x0, x1, hi[q], lo[q]);
    }
    const int off = ((kc * (kTN / 8) + (n >> 3)) * 8 + (n & 7)) * 8;
    *reinterpret_cast<uint4*>(b_hi + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    if (kSplit) *reinterpret_cast<uint4*>(b_lo + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  // The tensor cores read shared memory through the async proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int group = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  float* ring = rings + group * kStages * kStageFloats;
  float* cstage = stores + (group * 4 + warp) * 16 * kLdC;
  // This warpgroup's row tiles: first, first + step, ...
  const int blocks_per_col = gridDim.x / sh.n_tiles;
  const int first = (blockIdx.x / sh.n_tiles) * kGroups + group;
  const int step = blocks_per_col * kGroups;
  const int my_tiles = first < sh.m_tiles ? (sh.m_tiles - 1 - first) / step + 1 : 0;
  const int chunks = (sh.K + kKC - 1) / kKC;
  const int total = my_tiles * chunks;

  // Chunk q of the warpgroup's stream (tile q / chunks, depth chunk q %
  // chunks) into ring stage q % kStages; one commit per call.
  auto issue = [&](int q) {
    if (q < total) {
      const int it = q / chunks, ch = q - it * chunks;
      const long long m0 = (long long)(first + it * step) * kTM;
      const int k0 = ch * kKC;
      float* st = ring + (q % kStages) * kStageFloats;
      if (sh.a_vec) {
        for (int e = tid; e < kTM * (kKC / 4); e += 128) {
          const int r = e >> 3, q4 = e & 7;
          const long long gm = m0 + r;
          const int gk = k0 + 4 * q4;
          const int bytes = gm < sh.M ? max(0, min(16, (sh.K - gk) * 4)) : 0;
          cp_async16_zfill(st + r * kLdA + 4 * q4, bytes > 0 ? a + gm * sh.lda + gk : a, bytes);
        }
      } else {
        for (int e = tid; e < kTM * kKC; e += 128) {
          const int r = e >> 5, kk = e & 31;
          const long long gm = m0 + r;
          const int gk = k0 + kk;
          const bool in = gm < sh.M && gk < sh.K;
          cp_async4_zfill(st + r * kLdA + kk, in ? a + gm * sh.lda + gk : a, in ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  for (int q = 0; q < kStages - 1; ++q) issue(q);
  float acc[64], tail[64];
  for (int it = 0; it < my_tiles; ++it) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = 0.f;
      if (kSplit) tail[i] = 0.f;
    }
    for (int ch = 0; ch < chunks; ++ch) {
      const int q = it * chunks + ch;
      cp_async_wait<kStages - 2>();  // this thread's copies of chunk q have landed
      group_sync(group);             // and the warpgroup's; chunk q - 1's stage is free
      issue(q + kStages - 1);
      const float* st = ring + (q % kStages) * kStageFloats;
      const int steps = min(2, (sh.K - ch * kKC + 15) / 16);  // the same for the warpgroup
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (s < steps) {
          const float* p = st + (warp * 16 + g) * kLdA + s * 16 + 2 * t4;
          const float2 v0 = *reinterpret_cast<const float2*>(p);                 // row g, k
          const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * kLdA);      // row g+8, k
          const float2 v2 = *reinterpret_cast<const float2*>(p + 8);             // row g, k+8
          const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * kLdA + 8);  // row g+8, k+8
          split2<MODE>(v0.x, v0.y, ah[s][0], al[s][0]);
          split2<MODE>(v1.x, v1.y, ah[s][1], al[s][1]);
          split2<MODE>(v2.x, v2.y, ah[s][2], al[s][2]);
          split2<MODE>(v3.x, v3.y, ah[s][3], al[s][3]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (s < steps) {
          const int kstep = ch * (kKC / 16) + s;
          const uint64_t dh = smem_desc(b_hi + kstep * 16 * kTN);
          wgmma_m64n128k16(acc, ah[s], dh);
          if (kSplit) {
            wgmma_m64n128k16(tail, ah[s], smem_desc(b_lo + kstep * 16 * kTN));
            wgmma_m64n128k16(tail, al[s], dh);
          }
        }
      }
      wgmma_commit();
      // The fragments' registers are rewritten next chunk: wait for every
      // product that reads them.
      wgmma_wait_all();
    }
    // Head plus tails, 32 columns at a time through this warp's staging
    // rows, then stored as whole rows of 32 columns.
    const long long m0 = (long long)(first + it * step) * kTM + warp * 16;
#pragma unroll
    for (int pass = 0; pass < 4; ++pass) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = 16 * pass + j;
        const int row = g + 8 * ((j >> 1) & 1);
        const int col = (j >> 2) * 8 + 2 * t4 + (j & 1);
        cstage[row * kLdC + col] = kSplit ? acc[i] + tail[i] : acc[i];
      }
      __syncwarp();
      const int gn = n0 + 32 * pass + lane;
      for (int row = 0; row < 16; ++row) {
        const long long gm = m0 + row;
        if (gm < sh.M && gn < sh.N) {
          float* dst = c + gm * sh.N + gn;
          const float v = cstage[row * kLdC + lane];
          *dst = sh.accumulate ? *dst + v : v;
        }
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
}

size_t bf16_shared_bytes(int mode, int k) {
  const int k16 = (k + 15) & ~15;
  return (size_t)(mode == kDefault ? 1 : 2) * k16 * kTN * 2 + kRingBytes + kStoreBytes;
}

template <int MODE>
cudaError_t launch_bf16(const float* a, const float* b, float* c, int M, int K, int N,
                        cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  Shape sh{M, 0, N, K, 0, 0, (M + kTM - 1) / kTM, (N + kTN - 1) / kTN};
  const int per_col = std::max(1, std::min((sh.m_tiles + kGroups - 1) / kGroups, sms / sh.n_tiles));
  const long long blocks = (long long)per_col * sh.n_tiles;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  err = speedy::grant_shared_bytes(bf16_split_kernel<MODE>, bf16_shared_bytes(MODE, kMaxK));
  if (err != cudaSuccess) return err;
  // Longer K in segments of kMaxK, each launch adding its segment's product.
  for (int k0 = 0; k0 < K; k0 += kMaxK) {
    sh.K = std::min(kMaxK, K - k0);
    sh.accumulate = k0 > 0;
    sh.a_vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
    bf16_split_kernel<MODE><<<(unsigned)blocks, kThreads, bf16_shared_bytes(MODE, sh.K), s>>>(
        a + k0, b + (long long)k0 * N, c, sh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// highest: float32 FMA
// ---------------------------------------------------------------------------

constexpr int kFM = 128, kFN = 128, kFK = 8, kFThreads = 256;
constexpr int kLdF = kFM + 4;  // a's k-major rows: conflict-free transposed stores

__global__ void __launch_bounds__(kFThreads)
f32_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int M, int K, int N, int a_vec, int b_vec, int c_vec) {
  __shared__ __align__(16) float as[2][kFK][kLdF];  // as[k][m]
  __shared__ __align__(16) float bs[2][kFK][kFN];   // bs[k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.x * kFM;
  const int n0 = blockIdx.y * kFN;
  // a's tile: row tid / 2, k quarter (tid & 1) * 4 of each 8-deep step.
  const int ar = tid >> 1, ak = (tid & 1) * 4;
  float4 av4;
  auto load_a = [&](int k0) {
    const long long gm = m0 + ar;
    const int gk = k0 + ak;
    if (a_vec && gm < M && gk + 3 < K) {
      av4 = *reinterpret_cast<const float4*>(a + gm * K + gk);
    } else {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = (gm < M && gk + q < K) ? a[gm * K + gk + q] : 0.f;
      av4 = make_float4(v[0], v[1], v[2], v[3]);
    }
  };
  auto store_a = [&](int buf) {
    as[buf][ak + 0][ar] = av4.x;
    as[buf][ak + 1][ar] = av4.y;
    as[buf][ak + 2][ar] = av4.z;
    as[buf][ak + 3][ar] = av4.w;
  };
  auto load_b = [&](int k0, int buf) {
    if (b_vec) {  // 8 rows of 32 float4s, one a thread
      const int kk = tid >> 5, q = tid & 31;
      const int gk = k0 + kk, gn = n0 + 4 * q;
      const int bytes = gk < K ? max(0, min(16, (N - gn) * 4)) : 0;
      cp_async16_zfill(&bs[buf][kk][4 * q], bytes > 0 ? b + (long long)gk * N + gn : b, bytes);
    } else {
      for (int e = tid; e < kFK * kFN; e += kFThreads) {
        const int kk = e >> 7, n = e & (kFN - 1);
        const int gk = k0 + kk, gn = n0 + n;
        const bool in = gk < K && gn < N;
        cp_async4_zfill(&bs[buf][kk][n], in ? b + (long long)gk * N + gn : b, in ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int steps = (K + kFK - 1) / kFK;
  load_a(0);
  store_a(0);
  load_b(0, 0);
  cp_async_wait<0>();
  __syncthreads();
  for (int kt = 0; kt < steps; ++kt) {
    const int buf = kt & 1;
    const bool next = kt + 1 < steps;
    if (next) {  // the other buffers were last read before the barrier below
      load_b((kt + 1) * kFK, buf ^ 1);
      load_a((kt + 1) * kFK);
    }
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (next) {
      store_a(buf ^ 1);
      cp_async_wait<0>();
    }
    __syncthreads();
  }
  // Row i of the thread's 8 is ty * 4 + i (i < 4) or 64 + ty * 4 + i - 4;
  // columns likewise with tx, in two runs of 4.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + h * 64 + tx * 4;
      float* dst = c + gm * N + gn;
      if (c_vec && gn + 3 < N) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (gn + q < N) dst[q] = acc[i][4 * h + q];
      }
    }
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
    if (grid.y > 65535) return cudaErrorInvalidValue;
    const auto aligned = [](const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    f32_matmul_kernel<<<grid, kFThreads, 0, s>>>(a, b, c, M, K, N, K % 4 == 0 && aligned(a),
                                                 N % 4 == 0 && aligned(b),
                                                 N % 4 == 0 && aligned(c));
    return cudaGetLastError();
  }
  if (mode == kConv3) return launch_bf16<kConv3>(a, b, c, M, K, N, s);
  if (mode == kBitcast) return launch_bf16<kBitcast>(a, b, c, M, K, N, s);
  return launch_bf16<kDefault>(a, b, c, M, K, N, s);
}
