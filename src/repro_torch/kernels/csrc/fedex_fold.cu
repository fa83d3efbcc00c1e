// FedEx-LoRA exact residual fold into W0, for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/fedex_residual.py::fedex_residual_apply
// (bodies _kernel and _kernel_weighted; wrapper ops.fedex_fold) of the JAX
// package. For every stacked layer l and output element (i, j):
//
//   out = W0 + scale * ( sum_c w_c (a_c @ b_c) - abar @ bbar ),
//   abar = sum_c w_c a_c,  bbar = sum_c w_c b_c          (weighted body)
//
// and with w == nullptr the uniform body: client sums in slot order, each of
// mean_prod, abar and bbar divided by C at the end (as the TPU _kernel does).
//
// Layout: W0 / out are (L, m, n) contiguous; a is (C, L, m, r) and b is
// (C, L, r, n) addressed through their client and layer strides (the
// engine's client-leading stacks, read in place: no transposed copies), with
// the trailing (m, r) / (r, n) dims contiguous. out may alias W0 (in-place
// fold): every element is read and written by the same thread.
//
// Bound on the card: bytes. One f32 read and one f32 write of W0 per element
// (8 * L * m * n bytes) dominate; the factors are r/m and r/n as large. The
// arithmetic, 2 * (C_live + 1) * r flops per element, stays below the f32
// CUDA-core roof for the cross-silo C and r the engine closes.
// Design: one block per (32 x 128) output tile, the layer index on grid.z
// (one launch per adapter leaf). Each thread first issues the loads of its
// 4 x 4 W0 elements into registers, so the W0 stream overlaps the work on
// the factors. Clients stream through shared memory one at a time: the
// block loads lane c's a tile (32 x r) and b tile (r x 128), adds
// w_c * (a_c @ b_c) into per-thread registers (4 x 4 outputs a thread, outer
// products over k), and accumulates the abar / bbar tiles in shared memory.
// Shared memory is r * 1280 bytes whatever C is (r <= 128 fits). abar @ bbar
// is recomputed per tile, so the dense residual never reaches device memory. A zero-weight lane is skipped (never read:
// it adds exactly 0, and a partial round reads only delivered lanes).
// Products run in IEEE f32 on CUDA cores (no TF32, no tensor cores): the
// exact-residual identity is the point of the method.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 32;
constexpr int kTileN = 128;
constexpr int kThreads = 256;  // 32 x 8: lane -> column, warp -> row
constexpr int kRowsPerThread = kTileM / 8;   // 4
constexpr int kColsPerThread = kTileN / 32;  // 4

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
fedex_fold_kernel(const float* w0, float* out, const float* __restrict__ a,
                  const float* __restrict__ b, const float* __restrict__ w,
                  int num_clients, int m, int n, int r, int64_t sa_c,
                  int64_t sa_l, int64_t sb_c, int64_t sb_l, float scale) {
  extern __shared__ float smem[];
  float* a_s = smem;                  // (kTileM, r)
  float* b_s = a_s + kTileM * r;      // (r, kTileN)
  float* abar_s = b_s + r * kTileN;   // (kTileM, r)
  float* bbar_s = abar_s + kTileM * r;  // (r, kTileN)

  const int l = blockIdx.z;
  const int row0 = blockIdx.y * kTileM;
  const int col0 = blockIdx.x * kTileN;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int a_elems = kTileM * r;
  const int b_elems = r * kTileN;

  // Issue this thread's W0 loads first: their latency then overlaps the
  // client loop instead of following it (the W0 stream is the bound).
  const int64_t layer_off = (int64_t)l * m * n;
  float w0v[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int gi = row0 + ty + 8 * i;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int gj = col0 + tx + 32 * j;
      w0v[i][j] = (gi < m && gj < n) ? w0[layer_off + (int64_t)gi * n + gj] : 0.f;
    }
  }

  for (int idx = threadIdx.x; idx < a_elems; idx += kThreads) abar_s[idx] = 0.f;
  for (int idx = threadIdx.x; idx < b_elems; idx += kThreads) bbar_s[idx] = 0.f;

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;

  for (int c = 0; c < num_clients; ++c) {
    const float wc = kWeighted ? w[c] : 1.0f;
    if (kWeighted && wc == 0.0f) continue;  // uniform across the block
    const float* a_c = a + c * sa_c + l * sa_l;  // (m, r)
    const float* b_c = b + c * sb_c + l * sb_l;  // (r, n)
    __syncthreads();  // the previous lane's tiles are no longer read
    for (int idx = threadIdx.x; idx < a_elems; idx += kThreads) {
      const int gi = row0 + idx / r;
      const float v = gi < m ? a_c[(int64_t)row0 * r + idx] : 0.f;
      a_s[idx] = v;
      abar_s[idx] = kWeighted ? __fadd_rn(abar_s[idx], __fmul_rn(wc, v))
                              : __fadd_rn(abar_s[idx], v);
    }
    for (int idx = threadIdx.x; idx < b_elems; idx += kThreads) {
      const int k = idx / kTileN;
      const int gj = col0 + idx % kTileN;
      const float v = gj < n ? b_c[(int64_t)k * n + gj] : 0.f;
      b_s[idx] = v;
      bbar_s[idx] = kWeighted ? __fadd_rn(bbar_s[idx], __fmul_rn(wc, v))
                              : __fadd_rn(bbar_s[idx], v);
    }
    __syncthreads();
    float d[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) d[i][j] = 0.f;
    for (int k = 0; k < r; ++k) {
      float av[kRowsPerThread], bv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) av[i] = a_s[(ty + 8 * i) * r + k];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) bv[j] = b_s[k * kTileN + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) d[i][j] = fmaf(av[i], bv[j], d[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        acc[i][j] = kWeighted ? __fadd_rn(acc[i][j], __fmul_rn(wc, d[i][j]))
                              : __fadd_rn(acc[i][j], d[i][j]);
  }
  __syncthreads();  // abar_s / bbar_s complete
  if (!kWeighted) {
    const float cf = (float)num_clients;
    for (int idx = threadIdx.x; idx < a_elems; idx += kThreads)
      abar_s[idx] = __fdiv_rn(abar_s[idx], cf);
    for (int idx = threadIdx.x; idx < b_elems; idx += kThreads)
      bbar_s[idx] = __fdiv_rn(bbar_s[idx], cf);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = __fdiv_rn(acc[i][j], cf);
  }
  float p[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) p[i][j] = 0.f;
  for (int k = 0; k < r; ++k) {
    float av[kRowsPerThread], bv[kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) av[i] = abar_s[(ty + 8 * i) * r + k];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) bv[j] = bbar_s[k * kTileN + tx + 32 * j];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) p[i][j] = fmaf(av[i], bv[j], p[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int gi = row0 + ty + 8 * i;
    if (gi >= m) continue;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int gj = col0 + tx + 32 * j;
      if (gj >= n) continue;
      const float residual = __fsub_rn(acc[i][j], p[i][j]);
      out[layer_off + (int64_t)gi * n + gj] =
          __fadd_rn(w0v[i][j], __fmul_rn(scale, residual));
    }
  }
}

template <bool kWeighted>
int launch(const float* w0, float* out, const float* a, const float* b,
           const float* w, int num_clients, int num_layers, int m, int n, int r,
           int64_t sa_c, int64_t sa_l, int64_t sb_c, int64_t sb_l, float scale,
           cudaStream_t stream) {
  const size_t smem = (size_t)r * (2 * kTileM + 2 * kTileN) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fedex_fold_kernel<kWeighted>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM, num_layers);
  fedex_fold_kernel<kWeighted><<<grid, kThreads, smem, stream>>>(
      w0, out, a, b, w, num_clients, m, n, r, sa_c, sa_l, sb_c, sb_l, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int fedex_fold_launch(const float* w0, float* out, const float* a,
                                 const float* b, const float* w,
                                 int num_clients, int num_layers, int m, int n,
                                 int r, int64_t sa_c, int64_t sa_l,
                                 int64_t sb_c, int64_t sb_l, float scale,
                                 void* stream) {
  if (num_layers <= 0 || m <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != nullptr)
    return launch<true>(w0, out, a, b, w, num_clients, num_layers, m, n, r,
                        sa_c, sa_l, sb_c, sb_l, scale, s);
  return launch<false>(w0, out, a, b, nullptr, num_clients, num_layers, m, n,
                       r, sa_c, sa_l, sb_c, sb_l, scale, s);
}
