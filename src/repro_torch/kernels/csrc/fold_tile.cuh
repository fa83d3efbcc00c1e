// Tile machinery shared by the per-lane fold kernels (product_fold.cu,
// perclient_fold.cu, hetero_fold.cu), for Hopper (sm_90a).
//
// One block of 256 threads owns a 32 x 128 output tile of one stacked layer
// (the layer index is blockIdx.z). Thread (tx, ty) = (lane, warp) holds the
// 4 x 4 outputs at rows ty + 8 i and columns tx + 32 j of the tile.
// A client lane's factor tiles stream through shared memory: its a tile
// (32 x r) and b tile (r x 128), of which only the first `k_live` rank
// columns (rows of b) are ever read from device memory; the rest are zeroed
// in shared memory and skipped by the product loop. So a masked rank column
// is never read, whatever it holds. Products run in IEEE f32 on CUDA cores
// (fmaf over k, no TF32, no tensor cores).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fold_tile {

constexpr int kTileM = 32;
constexpr int kTileN = 128;
constexpr int kThreads = 256;               // 32 x 8: lane -> column, warp -> row
constexpr int kRows = kTileM / 8;           // 4 output rows a thread
constexpr int kCols = kTileN / 32;          // 4 output columns a thread

// Load one lane's (kTileM x r) a tile and (r x kTileN) b tile into shared
// memory. a_l / b_l point at the lane's (m, r) / (r, n) block of this layer.
__device__ __forceinline__ void load_lane(float* a_s, float* b_s,
                                          const float* __restrict__ a_l,
                                          const float* __restrict__ b_l, int m,
                                          int n, int r, int k_live, int row0,
                                          int col0) {
  for (int idx = threadIdx.x; idx < kTileM * r; idx += kThreads) {
    const int gi = row0 + idx / r;
    const int k = idx % r;
    a_s[idx] = (gi < m && k < k_live) ? a_l[(int64_t)gi * r + k] : 0.f;
  }
  for (int idx = threadIdx.x; idx < r * kTileN; idx += kThreads) {
    const int k = idx / kTileN;
    const int gj = col0 + idx % kTileN;
    b_s[idx] = (gj < n && k < k_live) ? b_l[(int64_t)k * n + gj] : 0.f;
  }
}

// d = a_s[:, :k_live] @ b_s[:k_live, :] for this thread's 4 x 4 outputs.
__device__ __forceinline__ void tile_product(float (&d)[kRows][kCols],
                                             const float* a_s, const float* b_s,
                                             int r, int k_live) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) d[i][j] = 0.f;
  for (int k = 0; k < k_live; ++k) {
    float av[kRows], bv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) av[i] = a_s[(ty + 8 * i) * r + k];
#pragma unroll
    for (int j = 0; j < kCols; ++j) bv[j] = b_s[k * kTileN + tx + 32 * j];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) d[i][j] = fmaf(av[i], bv[j], d[i][j]);
  }
}

// This thread's 4 x 4 elements of an (m, n) matrix at `base` (0 outside).
__device__ __forceinline__ void load_out_tile(float (&v)[kRows][kCols],
                                              const float* base, int m, int n,
                                              int row0, int col0) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int gi = row0 + ty + 8 * i;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int gj = col0 + tx + 32 * j;
      v[i][j] = (gi < m && gj < n) ? base[(int64_t)gi * n + gj] : 0.f;
    }
  }
}

// out = w0 + scale * (ideal - own), elementwise, rounded as separate ops.
__device__ __forceinline__ void store_fold(float* out, const float (&w0)[kRows][kCols],
                                           const float (&ideal)[kRows][kCols],
                                           const float (&own)[kRows][kCols],
                                           float scale, int m, int n, int row0,
                                           int col0) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int gi = row0 + ty + 8 * i;
    if (gi >= m) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int gj = col0 + tx + 32 * j;
      if (gj >= n) continue;
      out[(int64_t)gi * n + gj] = __fadd_rn(
          w0[i][j], __fmul_rn(scale, __fsub_rn(ideal[i][j], own[i][j])));
    }
  }
}

// Shared memory of one lane's a and b tiles: r * (kTileM + kTileN) floats.
inline size_t lane_smem_bytes(int r) {
  return (size_t)r * (kTileM + kTileN) * sizeof(float);
}

// Grant `kernel` more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

inline dim3 grid_for(int num_layers, int m, int n) {
  return dim3((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM, num_layers);
}

}  // namespace fold_tile
