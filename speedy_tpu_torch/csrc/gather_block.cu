// Block-span row gather, on two schedules: rows[b, k, j] = x[b, s + j] for
// j < width, with s = clamp(starts[b, k], 0, L - width), and rows k >=
// n_valid[b] written as zeros. The same function as csrc/gather_rows.cu.
//
// Replaces:
//   - speedy_tpu/ops/pallas_kernels.py:980 gather_rows_block_pallas (body
//     _gather_block_kernel, :917), reached through _gather_rows_spans
//     (speedy_tpu/ops/wsola_fast.py:149-184): speedy_gather_rows_block, one
//     block of threads per block of R consecutive rows;
//   - experiments/gather_v2.py:75 gather_v2 (body _kernel_v2, :27), the same
//     function with one program per utterance looping over its blocks and
//     double-buffering the span copies: speedy_gather_rows_block_v2.
// The TPU kernels copy one span of w_span samples per block of R rows into
// VMEM and cut the rows out of it with a one-hot matmul and a 7-step barrel
// shift; they need every block's rows to lie within w_span (the speed
// ceiling's contract), a 1024-aligned span base, and leave the rows of blocks
// past n_valid unspecified. Here no result depends on the span contract:
// any starts give the per-row gather's rows.
//
// Bound on the H100: bytes. The output is written once and each live row's
// samples are read once; there is no arithmetic. At 16 kHz, B=128, K=1,009,
// width 321 and 286 live rows an utterance that is 166 MB written and 47 MB
// read, 0.064 ms at 3.35 TB/s.
//
// Design: a span of w_span samples (520 KiB at 16 kHz with R=128 under the
// engine's 6.5x ceiling) does not fit a block's 227 KB of shared memory, so
// a block walks its rows in tiles of kTileRows. Each tile copies the union
// of its rows, [min start, max start + width), into shared memory with
// cp.async, then writes its rows out from there, a warp per row, consecutive
// lanes on consecutive samples. The span plan bounds a tile's union by
// w_span, so the tile buffer holds min(w_span, kMaxTileSamples) samples; a
// tile whose union is larger (the contract broken, or a wide tile at
// 44.1 kHz) reads its rows straight from global memory. Rows at or past
// n_valid read nothing and are stored as zeros. The v2 schedule keeps two
// tile buffers and copies tile t+1 while tile t is written.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "shared_grant.cuh"

namespace {

using speedy::cp_async4;
using speedy::cp_async_commit;
using speedy::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 16;
constexpr int kMaxTileSamples = 16384;  // 64 KiB of float

// Threads 0..n-1 load the clamped starts of the tile's rows k0..k0+n-1.
__device__ __forceinline__ void load_starts(const int* __restrict__ sb, int k0, int n,
                                            int max_start, int* s_start) {
  if (threadIdx.x < n) s_start[threadIdx.x] = min(max(sb[k0 + threadIdx.x], 0), max_start);
}

// After a barrier over load_starts: the union [lo, max start + width) of the
// tile's n rows. Every thread issues its share of the union's copy into buf
// when it fits in cap samples, then commits one group (empty otherwise).
// Returns whether the union was staged.
__device__ __forceinline__ bool stage(const float* __restrict__ xb, const int* s_start, int n,
                                      int width, int cap, float* buf, int& lo) {
  bool staged = false;
  lo = 0;
  if (n > 0) {
    int l = s_start[0], h = s_start[0];
    for (int i = 1; i < n; ++i) {
      l = min(l, s_start[i]);
      h = max(h, s_start[i]);
    }
    const int len = h - l + width;
    lo = l;
    staged = len <= cap;
    if (staged) {
      for (int i = threadIdx.x; i < len; i += kThreads) cp_async4(buf + i, xb + l + i);
    }
  }
  cp_async_commit();
  return staged;
}

// Warp w writes the tile's rows w, w + kWarps, ... to rows (row k0 first).
__device__ __forceinline__ void write_rows(const float* __restrict__ xb, const float* buf,
                                           const int* s_start, int n, int width, int lo,
                                           bool staged, float* __restrict__ rows) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < n; i += kWarps) {
    const float* src = staged ? buf + (s_start[i] - lo) : xb + s_start[i];
    float* dst = rows + (long long)i * width;
    for (int j = lane; j < width; j += 32) dst[j] = src[j];
  }
}

__device__ __forceinline__ void write_zeros(float* __restrict__ out, long long count) {
  for (long long i = threadIdx.x; i < count; i += kThreads) out[i] = 0.f;
}

__device__ __forceinline__ int live_rows(const int* __restrict__ n_valid, int b, int K) {
  return n_valid == nullptr ? K : min(max(n_valid[b], 0), K);
}

// Grid (ceil(K / R), B): block nb of utterance b holds rows [nb*R, nb*R + R).
__global__ void __launch_bounds__(kThreads)
gather_block_kernel(const float* __restrict__ x, const int* __restrict__ starts,
                    const int* __restrict__ n_valid, float* __restrict__ out, int L, int K,
                    int width, int R, int cap) {
  extern __shared__ float buf[];
  __shared__ int s_start[kTileRows];
  const int b = blockIdx.y;
  const int k_begin = blockIdx.x * R;
  const int k_end = min(k_begin + R, K);
  const int live_end = min(k_end, max(live_rows(n_valid, b, K), k_begin));
  const float* xb = x + (long long)b * L;
  const int* sb = starts + (long long)b * K;
  float* ob = out + (long long)b * K * width;
  for (int k0 = k_begin; k0 < live_end; k0 += kTileRows) {
    const int n = min(kTileRows, live_end - k0);
    load_starts(sb, k0, n, L - width, s_start);
    __syncthreads();
    int lo;
    const bool staged = stage(xb, s_start, n, width, cap, buf, lo);
    cp_async_wait<0>();
    __syncthreads();
    write_rows(xb, buf, s_start, n, width, lo, staged, ob + (long long)k0 * width);
    __syncthreads();  // buf and s_start are reused by the next tile
  }
  write_zeros(ob + (long long)live_end * width, (long long)(k_end - live_end) * width);
}

// Grid (B): one block per utterance walks the tiles of its live blocks
// (blocks nb < ceil(n_valid / R)), tile q of block nb holding rows
// nb*R + q*kTileRows onward, no further than the block's end or n_valid.
// Two buffers: tile t+1's copy is in flight while tile t is written.
__global__ void __launch_bounds__(kThreads)
gather_block_v2_kernel(const float* __restrict__ x, const int* __restrict__ starts,
                       const int* __restrict__ n_valid, float* __restrict__ out, int L, int K,
                       int width, int R, int cap) {
  extern __shared__ float bufs[];  // [2][cap]
  __shared__ int s_start[2][kTileRows];
  const int b = blockIdx.x;
  const int nv = live_rows(n_valid, b, K);
  const int tiles_per_block = (R + kTileRows - 1) / kTileRows;
  const int n_tiles = (nv + R - 1) / R * tiles_per_block;
  const float* xb = x + (long long)b * L;
  const int* sb = starts + (long long)b * K;
  float* ob = out + (long long)b * K * width;
  const int max_start = L - width;

  // Rows [k0, k0 + n) of tile t.
  auto tile = [&](int t, int& k0) {
    const int nb = t / tiles_per_block;
    k0 = nb * R + (t % tiles_per_block) * kTileRows;
    return max(0, min(min(k0 + kTileRows, nb * R + R), nv) - k0);
  };

  int cur_k0 = 0, cur_n = 0, cur_lo = 0;
  bool cur_staged = false;
  if (n_tiles > 0) {
    cur_n = tile(0, cur_k0);
    load_starts(sb, cur_k0, cur_n, max_start, s_start[0]);
    __syncthreads();
    cur_staged = stage(xb, s_start[0], cur_n, width, cap, bufs, cur_lo);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t & 1;
    int nxt_k0 = 0, nxt_n = 0, nxt_lo = 0;
    bool nxt_staged = false;
    if (t + 1 < n_tiles) {
      nxt_n = tile(t + 1, nxt_k0);
      load_starts(sb, nxt_k0, nxt_n, max_start, s_start[slot ^ 1]);
      __syncthreads();
      nxt_staged = stage(xb, s_start[slot ^ 1], nxt_n, width, cap,
                         bufs + (slot ^ 1) * cap, nxt_lo);
      cp_async_wait<1>();  // tile t's group is done; tile t+1's may fly
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    write_rows(xb, bufs + slot * cap, s_start[slot], cur_n, width, cur_lo, cur_staged,
               ob + (long long)cur_k0 * width);
    __syncthreads();  // this slot is refilled by tile t+2
    cur_k0 = nxt_k0;
    cur_n = nxt_n;
    cur_lo = nxt_lo;
    cur_staged = nxt_staged;
  }
  write_zeros(ob + (long long)nv * width, (long long)(K - nv) * width);
}

int tile_capacity(int w_span) { return w_span < kMaxTileSamples ? w_span : kMaxTileSamples; }

bool bad_args(int B, int L, int width, int R, int w_span) {
  return width < 1 || width > L || R < 1 || w_span < width || B > 65535;
}

}  // namespace

// x [B, L], starts [B, K] int32, n_valid [B] int32 or null (all K rows
// live), rows_per_block R >= 1, w_span >= width (the span plan, which sizes
// the tile buffer) -> out [B, K, width]. Returns a cudaError_t.
extern "C" int speedy_gather_rows_block(const float* x, const int* starts, const int* n_valid,
                                        float* out, int B, int L, int K, int width, int R,
                                        int w_span, void* stream) {
  if (B <= 0 || K <= 0) return cudaSuccess;
  if (bad_args(B, L, width, R, w_span)) return cudaErrorInvalidValue;
  const int cap = tile_capacity(w_span);
  const size_t smem = (size_t)cap * sizeof(float);
  cudaError_t err = speedy::grant_shared_bytes(gather_block_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((K + R - 1) / R, B);
  gather_block_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, starts, n_valid, out, L, K, width, R, cap);
  return cudaGetLastError();
}

// The same arguments and result as speedy_gather_rows_block, on the
// one-block-per-utterance schedule.
extern "C" int speedy_gather_rows_block_v2(const float* x, const int* starts,
                                           const int* n_valid, float* out, int B, int L, int K,
                                           int width, int R, int w_span, void* stream) {
  if (B <= 0 || K <= 0) return cudaSuccess;
  if (bad_args(B, L, width, R, w_span)) return cudaErrorInvalidValue;
  const int cap = tile_capacity(w_span);
  const size_t smem = 2 * (size_t)cap * sizeof(float);
  cudaError_t err = speedy::grant_shared_bytes(gather_block_v2_kernel, smem);
  if (err != cudaSuccess) return err;
  gather_block_v2_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, starts, n_valid, out, L, K, width, R, cap);
  return cudaGetLastError();
}
