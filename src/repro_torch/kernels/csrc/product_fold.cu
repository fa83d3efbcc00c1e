// Signed product fold into W0, for Hopper (sm_90a).
//
// product_fold_launch replaces the TPU kernel
// kernels/fedex_residual.py::product_fold_apply (body _kernel_product;
// wrapper ops.product_fold) of the JAX package. For every stacked layer l
// and output element (i, j):
//
//   out = W0 + scale * sum_c s_c (a_c @ b_c)
//
// with a SIGNED per-lane vector s and no mean subtraction: the reinit close
// folds the ideal update (s = w), the fedex_svd close one factored rank-r'
// residual (one lane, s = [1]). Per output element the lanes are summed in
// slot order first and the sum is then added to W0, the reference's
// association. (The accumulating twin, product_accum_apply, has its own
// body in product_accum.cu, which rounds as this one does.)
//
// Layout: W0 / out are (L, m, n) contiguous; a is (C, L, m, r) and b is
// (C, L, r, n) addressed through their client and layer strides, trailing
// dims contiguous. out may alias W0 (in-place fold): every element is read
// and written by the same thread.
//
// Bound on the card: bytes. One f32 read and one f32 write of W0 per element
// (8 * L * m * n bytes); the factors are r/m and r/n as large, and the
// 2 * C_live * r flops per element stay far below the f32 CUDA-core roof.
// Design: fedex_fold.cu's without the abar / bbar tiles. One block per
// 32 x 128 output tile, the layer on grid.z; each thread issues its W0 loads
// first so they overlap the lane loop; lanes stream through shared memory
// one at a time (r * 640 bytes whatever C is). A lane with s_c == 0 is never
// read, so a masked lane adds exactly 0 whatever it holds. The lane sums are
// explicitly rounded (__fadd_rn / __fmul_rn) in the plain version's order.

#include "fold_tile.cuh"

namespace {

using namespace fold_tile;

__global__ void __launch_bounds__(kThreads)
product_fold_kernel(const float* w0, float* out, const float* __restrict__ a,
                    const float* __restrict__ b, const float* __restrict__ s,
                    int num_clients, int m, int n, int r, int64_t sa_c,
                    int64_t sa_l, int64_t sb_c, int64_t sb_l, float scale) {
  extern __shared__ float smem[];
  float* a_s = smem;              // (kTileM, r)
  float* b_s = a_s + kTileM * r;  // (r, kTileN)
  const int l = blockIdx.z;
  const int row0 = blockIdx.y * kTileM;
  const int col0 = blockIdx.x * kTileN;
  const int64_t layer_off = (int64_t)l * m * n;

  float w0v[kRows][kCols];
  load_out_tile(w0v, w0 + layer_off, m, n, row0, col0);
  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int c = 0; c < num_clients; ++c) {
    const float sc = s[c];
    if (sc == 0.0f) continue;  // uniform across the block: never read
    __syncthreads();           // the previous lane's tiles are no longer read
    load_lane(a_s, b_s, a + c * sa_c + l * sa_l, b + c * sb_c + l * sb_l, m, n,
              r, r, row0, col0);
    __syncthreads();
    float d[kRows][kCols];
    tile_product(d, a_s, b_s, r, r);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(sc, d[i][j]));
  }

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
      out[layer_off + (int64_t)gi * n + gj] =
          __fadd_rn(w0v[i][j], __fmul_rn(scale, acc[i][j]));
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int product_fold_launch(const float* w0, float* out, const float* a,
                                   const float* b, const float* s,
                                   int num_clients, int num_layers, int m,
                                   int n, int r, int64_t sa_c, int64_t sa_l,
                                   int64_t sb_c, int64_t sb_l, float scale,
                                   void* stream) {
  if (num_layers <= 0 || m <= 0 || n <= 0) return 0;
  const size_t smem = lane_smem_bytes(r);
  cudaError_t e = allow_smem(product_fold_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  product_fold_kernel<<<grid_for(num_layers, m, n), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      w0, out, a, b, s, num_clients, m, n, r, sa_c, sa_l, sb_c, sb_l, scale);
  return (int)cudaGetLastError();
}
