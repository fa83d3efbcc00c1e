// Per-client fold (the keep_local close), for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/fedex_residual.py::perclient_fold_apply
// (body _kernel_perclient; wrapper ops.perclient_fold) of the JAX package.
// For every produced lane c, stacked layer l and element (i, j):
//
//   out_c = W0_c + scale * ( sum_j w_j (a_j @ b_j) - a_c @ b_c )
//
// Layout: each lane's W0 and output is its own (L, m, n) contiguous leaf,
// reached through a device array of C lane pointers (w0_lanes, out_lanes),
// so the close folds straight into every delivered client's own base and no
// (C, L, m, n) stacked copy of the bases exists. A null out_lanes[c] means
// lane c is not produced (a non-delivered lane). a is (C, L, m, r) and b is
// (C, L, r, n) addressed through their client and layer strides. out_lanes[c]
// may equal w0_lanes[c] (in-place fold); the wrapper refuses any other
// overlap between lanes.
//
// Bound on the card: bytes. One f32 read and one f32 write of W0_c per
// produced lane and element (8 * C_out * L * m * n bytes); the factors are
// r/m and r/n as large; 2 * (C_live + C_out) * r flops per element.
// Design: fedex_fold.cu's tiling (32 x 128 output tile per block, the layer
// on grid.z, lanes streamed through shared memory one at a time). The ideal
// tile sum_j w_j a_j b_j is accumulated ONCE in registers; then for each
// produced lane the block re-reads that lane's small factor tiles (they sit
// in L2), recomputes a_c b_c and writes W0_c + scale * (ideal - own). A lane
// with w_j == 0 is never read for the ideal, and a lane that is neither
// weighted nor produced is never read at all, so a masked lane adds exactly
// 0 whatever it holds. Sums are explicitly rounded in the plain version's
// order.

#include "fold_tile.cuh"

namespace {

using namespace fold_tile;

__global__ void __launch_bounds__(kThreads)
perclient_fold_kernel(const float* const* __restrict__ w0_lanes,
                      float* const* __restrict__ out_lanes,
                      const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ w, int num_clients, int m,
                      int n, int r, int64_t sa_c, int64_t sa_l, int64_t sb_c,
                      int64_t sb_l, float scale) {
  extern __shared__ float smem[];
  float* a_s = smem;              // (kTileM, r)
  float* b_s = a_s + kTileM * r;  // (r, kTileN)
  const int l = blockIdx.z;
  const int row0 = blockIdx.y * kTileM;
  const int col0 = blockIdx.x * kTileN;
  const int64_t layer_off = (int64_t)l * m * n;

  float ideal[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) ideal[i][j] = 0.f;
  for (int c = 0; c < num_clients; ++c) {
    const float wc = w[c];
    if (wc == 0.0f) continue;  // uniform across the block: never read
    __syncthreads();
    load_lane(a_s, b_s, a + c * sa_c + l * sa_l, b + c * sb_c + l * sb_l, m, n,
              r, r, row0, col0);
    __syncthreads();
    float d[kRows][kCols];
    tile_product(d, a_s, b_s, r, r);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        ideal[i][j] = __fadd_rn(ideal[i][j], __fmul_rn(wc, d[i][j]));
  }

  for (int c = 0; c < num_clients; ++c) {
    float* out = out_lanes[c];
    if (out == nullptr) continue;  // lane not produced
    float w0v[kRows][kCols];
    load_out_tile(w0v, w0_lanes[c] + layer_off, m, n, row0, col0);
    __syncthreads();
    load_lane(a_s, b_s, a + c * sa_c + l * sa_l, b + c * sb_c + l * sb_l, m, n,
              r, r, row0, col0);
    __syncthreads();
    float own[kRows][kCols];
    tile_product(own, a_s, b_s, r, r);
    store_fold(out + layer_off, w0v, ideal, own, scale, m, n, row0, col0);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// w0_lanes / out_lanes are device arrays of num_clients pointers.
extern "C" int perclient_fold_launch(const float* const* w0_lanes,
                                     float* const* out_lanes, const float* a,
                                     const float* b, const float* w,
                                     int num_clients, int num_layers, int m,
                                     int n, int r, int64_t sa_c, int64_t sa_l,
                                     int64_t sb_c, int64_t sb_l, float scale,
                                     void* stream) {
  if (num_layers <= 0 || m <= 0 || n <= 0) return 0;
  const size_t smem = lane_smem_bytes(r);
  cudaError_t e = allow_smem(perclient_fold_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  perclient_fold_kernel<<<grid_for(num_layers, m, n), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      w0_lanes, out_lanes, a, b, w, num_clients, m, n, r, sa_c, sa_l, sb_c,
      sb_l, scale);
  return (int)cudaGetLastError();
}
