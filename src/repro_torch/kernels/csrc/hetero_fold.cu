// Rank-masked per-client fold (the hetero close), for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/fedex_residual.py::hetero_fold_apply
// (body _kernel_hetero; wrapper ops.hetero_fold) of the JAX package. With
// k_c = r if ranks[c] < 0 else min(ranks[c], r), for every produced lane c,
// stacked layer l and element (i, j):
//
//   out_c = W0_c + scale * ( sum_j w_j (a_j[:, :k_j] @ b_j[:k_j, :])
//                            - A'[:, :k_c] @ B'[:k_c, :] )
//
// i.e. the reference's (a_j o mask_j) b_j and (A' o mask_c) B' with the 0/1
// rank masks applied by never reading a masked column: rank columns of a_j
// (rows of b_j) past k_j are not loaded from device memory, so they add
// exactly 0 whatever they hold, and a lane with w_j == 0 or k_j == 0 is not
// read for the ideal at all. (A', B') is the shared rank-r truncation of the
// ideal update; each lane's own product is its leading-k_c slice.
//
// Layout: as perclient_fold.cu (one (L, m, n) leaf per lane through device
// arrays of lane pointers, null out = lane not produced; client-leading
// factor stacks read through their strides), plus A' (L, m, r) and B'
// (L, r, n) through their layer strides and an int32 rank vector.
//
// Bound on the card: bytes, 8 * C_out * L * m * n (each produced lane's W0
// read once and written once); the factors and A', B' are r/m and r/n as
// large. Design: perclient_fold.cu's, with A' and B' tiles loaded once per
// block into their own shared-memory buffers (r * 1280 bytes in all) and
// every lane's own product taken from them over its first k_c columns.

#include "fold_tile.cuh"

namespace {

using namespace fold_tile;

__device__ __forceinline__ int live_rank(int rank, int r) {
  return rank < 0 ? r : (rank < r ? rank : r);
}

__global__ void __launch_bounds__(kThreads)
hetero_fold_kernel(const float* const* __restrict__ w0_lanes,
                   float* const* __restrict__ out_lanes,
                   const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ w, const int* __restrict__ ranks,
                   const float* __restrict__ own_a,
                   const float* __restrict__ own_b, int num_clients, int m,
                   int n, int r, int64_t sa_c, int64_t sa_l, int64_t sb_c,
                   int64_t sb_l, int64_t so_a_l, int64_t so_b_l, float scale) {
  extern __shared__ float smem[];
  float* a_s = smem;                   // (kTileM, r)
  float* b_s = a_s + kTileM * r;       // (r, kTileN)
  float* oa_s = b_s + r * kTileN;      // (kTileM, r): A' tile
  float* ob_s = oa_s + kTileM * r;     // (r, kTileN): B' tile
  const int l = blockIdx.z;
  const int row0 = blockIdx.y * kTileM;
  const int col0 = blockIdx.x * kTileN;
  const int64_t layer_off = (int64_t)l * m * n;

  load_lane(oa_s, ob_s, own_a + l * so_a_l, own_b + l * so_b_l, m, n, r, r,
            row0, col0);
  float ideal[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) ideal[i][j] = 0.f;
  for (int c = 0; c < num_clients; ++c) {
    const float wc = w[c];
    const int kc = live_rank(ranks[c], r);
    if (wc == 0.0f || kc == 0) continue;  // uniform across the block
    __syncthreads();
    load_lane(a_s, b_s, a + c * sa_c + l * sa_l, b + c * sb_c + l * sb_l, m, n,
              r, kc, row0, col0);
    __syncthreads();
    float d[kRows][kCols];
    tile_product(d, a_s, b_s, r, kc);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        ideal[i][j] = __fadd_rn(ideal[i][j], __fmul_rn(wc, d[i][j]));
  }
  __syncthreads();  // the A' / B' tiles are complete

  for (int c = 0; c < num_clients; ++c) {
    float* out = out_lanes[c];
    if (out == nullptr) continue;  // lane not produced
    float w0v[kRows][kCols];
    load_out_tile(w0v, w0_lanes[c] + layer_off, m, n, row0, col0);
    float own[kRows][kCols];
    tile_product(own, oa_s, ob_s, r, live_rank(ranks[c], r));
    store_fold(out + layer_off, w0v, ideal, own, scale, m, n, row0, col0);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// w0_lanes / out_lanes are device arrays of num_clients pointers; ranks is
// a device int32 (num_clients,) vector (-1 = full rank r).
extern "C" int hetero_fold_launch(const float* const* w0_lanes,
                                  float* const* out_lanes, const float* a,
                                  const float* b, const float* w,
                                  const int* ranks, const float* own_a,
                                  const float* own_b, int num_clients,
                                  int num_layers, int m, int n, int r,
                                  int64_t sa_c, int64_t sa_l, int64_t sb_c,
                                  int64_t sb_l, int64_t so_a_l, int64_t so_b_l,
                                  float scale, void* stream) {
  if (num_layers <= 0 || m <= 0 || n <= 0) return 0;
  const size_t smem = 2 * lane_smem_bytes(r);
  cudaError_t e = allow_smem(hetero_fold_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  hetero_fold_kernel<<<grid_for(num_layers, m, n), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      w0_lanes, out_lanes, a, b, w, ranks, own_a, own_b, num_clients, m, n, r,
      sa_c, sa_l, sb_c, sb_l, so_a_l, so_b_l, scale);
  return (int)cudaGetLastError();
}
