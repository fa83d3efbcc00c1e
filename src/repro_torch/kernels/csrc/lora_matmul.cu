// Fused LoRA projection  y = x @ W + scale * (x @ a) @ b  for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/lora_matmul.py::lora_matmul (body _kernel;
// wrapper ops.lora_dense) of the JAX package. The serving path runs every
// adapted q/k/v/o projection of prefill and decode through it.
//
// x (M, K), W (K, N), a (K, r), b (r, N), y (M, N): f32, row-major and
// contiguous; r <= 64. Any M, N, K: ragged tiles are zero-filled on load
// and masked on store (the TPU kernel zero-pads to its tiles).
//
// Arithmetic: IEEE f32 FMAs on CUDA cores. Hopper's tensor cores take f32
// only as TF32, which the port keeps off, so this is a SIMT GEMM.
//
// Two bodies, picked by the caller from M:
//
// * tiled (prefill, M > 16): one block per 128 x 128 output tile, K streamed
//   through double-buffered shared memory in slices of 8, an 8 x 8 register
//   micro-tile per thread (rows ty*4.. and 64+ty*4.., columns tx*4.. and
//   64+tx*4.., so shared-memory reads are float4 and conflict-free). The
//   rank-r partial x@a of the block's 128 rows accumulates in shared memory
//   across the K stream, as the TPU kernel keeps it in VMEM scratch, and is
//   folded in with b on the last step: the adapter adds r/128 of the base
//   product's FMAs and no device-memory traffic beyond reading a and b.
//   Bound on the card: operations, 2*M*N*K + 2*M*r*(K + N) f32 FLOPs
//   (prefill q_proj at M = 4096: 77 GFLOP, 1.15 ms at 67 TFLOP/s).
// * split-K (decode, M <= 16): the tiled body at M = 8 would run 24-48
//   blocks on 132 SMs and 16x the needed FMAs. Here each block takes 128
//   columns and one K chunk (the caller sizes the chunks so the grid fills
//   the card), keeps the chunk of x in shared memory and streams W's rows
//   once, coalesced, one column per thread with all M rows in registers;
//   the blocks of column block 0 also write their chunk's partial x@a. A
//   second grid sums the partials in chunk order and adds scale*(x@a)@b.
//   Bound on the card: bytes, 4*(K*N + M*K + K*r + r*N + M*N) (decode q_proj:
//   37.8 MB, 11.3 us at 3.35 TB/s); the partials add 2*4*splits*M*N bytes.
//
// Both bodies sum in another order than torch.matmul; the wrapper's
// lora_matmul_error_bound states how far two evaluations may differ.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRank = 64;

// ---------------------------------------------------------------- tiled
constexpr int BM = 128, BN = 128, BK = 8, NT = 256;

// row of micro-tile entry i (0..7) for thread row ty; likewise columns
__device__ __forceinline__ int tile_off(int i, int t) {
  return (i < 4) ? t * 4 + i : 64 + t * 4 + (i - 4);
}

template <bool kVec>
__global__ void __launch_bounds__(NT, 2)
    lora_mm_tiled(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ y, int M, int N, int K, int r,
                  float scale) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [2][BK][BM], x transposed
  float* Bs = As + 2 * BK * BM;                 // [2][BK][BN]
  float* as = Bs + 2 * BK * BN;                 // [2][BK][r]
  float* xas = as + 2 * BK * r;                 // [BM][r], x@a of the rows

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // global -> register staging of one K slice
  const int xr = tid >> 1, xk = (tid & 1) * 4;   // x tile: row, first k
  const int wk = tid >> 5, wn = (tid & 31) * 4;  // W tile: k, first column
  float xv[4], wv[4], av[2];

  auto load = [&](int k0) {
    const int m = m0 + xr, kx = k0 + xk;
    if (kVec) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M && kx < K)
        t = *reinterpret_cast<const float4*>(x + (size_t)m * K + kx);
      xv[0] = t.x; xv[1] = t.y; xv[2] = t.z; xv[3] = t.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        xv[c] = (m < M && kx + c < K) ? x[(size_t)m * K + kx + c] : 0.f;
    }
    const int kw = k0 + wk, n = n0 + wn;
    if (kVec) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kw < K && n < N)
        t = *reinterpret_cast<const float4*>(w + (size_t)kw * N + n);
      wv[0] = t.x; wv[1] = t.y; wv[2] = t.z; wv[3] = t.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wv[c] = (kw < K && n + c < N) ? w[(size_t)kw * N + n + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int idx = tid + u * NT;  // BK * r <= 512 = 2 * NT
      const int kk = r > 0 ? idx / r : 0;
      av[u] = (idx < BK * r && k0 + kk < K)
                  ? a[(size_t)(k0 + kk) * r + (idx - kk * r)] : 0.f;
    }
  };
  auto store = [&](int buf) {
    float* A = As + buf * BK * BM;
#pragma unroll
    for (int c = 0; c < 4; ++c) A[(xk + c) * BM + xr] = xv[c];
    *reinterpret_cast<float4*>(Bs + buf * BK * BN + wk * BN + wn) =
        make_float4(wv[0], wv[1], wv[2], wv[3]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int idx = tid + u * NT;
      if (idx < BK * r) as[buf * BK * r + idx] = av[u];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int idx = tid; idx < BM * r; idx += NT) xas[idx] = 0.f;

  const int nk = (K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * BK);
    const float4* A4 = reinterpret_cast<const float4*>(As + cur * BK * BM);
    const float4* B4 = reinterpret_cast<const float4*>(Bs + cur * BK * BN);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = A4[kk * (BM / 4) + ty], a1 = A4[kk * (BM / 4) + 16 + ty];
      const float4 b0 = B4[kk * (BN / 4) + tx], b1 = B4[kk * (BN / 4) + 16 + tx];
      const float am[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bn[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(am[i], bn[j], acc[i][j]);
    }
    // the rank-r partial x@a of this slice; each entry has one owner thread
    const float* A = As + cur * BK * BM;
    const float* Ar = as + cur * BK * r;
    for (int idx = tid; idx < BM * r; idx += NT) {
      const int m = idx / r, j = idx - m * r;
      float s = xas[idx];
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) s = fmaf(A[kk * BM + m], Ar[kk * r + j], s);
      xas[idx] = s;
    }
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

  // epilogue: y = acc + scale * (x@a) @ b
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = tile_off(i, ty), m = m0 + row;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tile_off(j, tx);
      if (n >= N) continue;
      float ad = 0.f;
      for (int q = 0; q < r; ++q)
        ad = fmaf(xas[row * r + q], __ldg(b + (size_t)q * N + n), ad);
      y[(size_t)m * N + n] = acc[i][j] + scale * ad;
    }
  }
}

// -------------------------------------------------------------- split-K
constexpr int SK_THREADS = 128;

// partial products of one K chunk: P[s] = x[:, chunk] @ W[chunk, :], and
// (column block 0) XA[s] = x[:, chunk] @ a[chunk, :]
template <int MR>
__global__ void __launch_bounds__(SK_THREADS)
    lora_mm_partial(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ a, float* __restrict__ P,
                    float* __restrict__ XA, int M, int N, int K, int r,
                    int kc) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [MR][kc], zero-padded
  const int s = blockIdx.y, k0 = s * kc;
  const int klen = min(kc, K - k0);
  for (int i = threadIdx.x; i < MR * kc; i += SK_THREADS) {
    const int m = i / kc, kk = i - m * kc;
    xs[i] = (m < M && kk < klen) ? x[(size_t)m * K + k0 + kk] : 0.f;
  }
  __syncthreads();

  const int n = blockIdx.x * SK_THREADS + threadIdx.x;
  if (n < N) {
    float acc[MR];
#pragma unroll
    for (int m = 0; m < MR; ++m) acc[m] = 0.f;
    const float* wp = w + (size_t)k0 * N + n;
    int kk = 0;
    for (; kk + 8 <= klen; kk += 8) {
      float wv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) wv[u] = __ldg(wp + (size_t)(kk + u) * N);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float4 x0 = *reinterpret_cast<const float4*>(xs + m * kc + kk);
        const float4 x1 = *reinterpret_cast<const float4*>(xs + m * kc + kk + 4);
        float t = acc[m];
        t = fmaf(x0.x, wv[0], t); t = fmaf(x0.y, wv[1], t);
        t = fmaf(x0.z, wv[2], t); t = fmaf(x0.w, wv[3], t);
        t = fmaf(x1.x, wv[4], t); t = fmaf(x1.y, wv[5], t);
        t = fmaf(x1.z, wv[6], t); t = fmaf(x1.w, wv[7], t);
        acc[m] = t;
      }
    }
    for (; kk < klen; ++kk) {
      const float wk = __ldg(wp + (size_t)kk * N);
#pragma unroll
      for (int m = 0; m < MR; ++m) acc[m] = fmaf(xs[m * kc + kk], wk, acc[m]);
    }
#pragma unroll
    for (int m = 0; m < MR; ++m)
      if (m < M) P[((size_t)s * M + m) * N + n] = acc[m];
  }
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < M * r; i += SK_THREADS) {
      const int m = i / r, j = i - m * r;
      float t = 0.f;
      for (int kk = 0; kk < klen; ++kk)
        t = fmaf(xs[m * kc + kk], __ldg(a + (size_t)(k0 + kk) * r + j), t);
      XA[((size_t)s * M + m) * r + j] = t;
    }
  }
}

constexpr int FOLD_THREADS = 256;

// y[m, n] = sum_s P[s, m, n] + scale * sum_j (sum_s XA[s, m, j]) b[j, n]
__global__ void __launch_bounds__(FOLD_THREADS)
    lora_mm_fold(const float* __restrict__ P, const float* __restrict__ XA,
                 const float* __restrict__ b, float* __restrict__ y, int M,
                 int N, int r, int splits, float scale) {
  __shared__ float xa[kMaxRank];
  const int m = blockIdx.y;
  if (threadIdx.x < r) {
    float t = 0.f;
    for (int s = 0; s < splits; ++s)
      t += XA[((size_t)s * M + m) * r + threadIdx.x];
    xa[threadIdx.x] = t;
  }
  __syncthreads();
  const int n = blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (n >= N) return;
  float base = 0.f;
  for (int s = 0; s < splits; ++s) base += P[((size_t)s * M + m) * N + n];
  float ad = 0.f;
  for (int q = 0; q < r; ++q) ad = fmaf(xa[q], __ldg(b + (size_t)q * N + n), ad);
  y[(size_t)m * N + n] = base + scale * ad;
}

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 = launched).
//
// splits == 0 -> the tiled body (work unused). splits > 0 -> the split-K
// body with K chunks of kc rows (kc a multiple of 8, splits * kc >= K,
// M <= 16) and `work` holding splits * M * (N + r) floats.
// vec != 0 promises K % 4 == 0, N % 4 == 0 and 16-byte aligned x and w.
extern "C" int lora_matmul_launch(const float* x, const float* w,
                                  const float* a, const float* b, float* y,
                                  float* work, int M, int N, int K, int r,
                                  float scale, int splits, int kc, int vec,
                                  void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || r < 0 || r > kMaxRank) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (splits == 0) {
    const size_t smem = sizeof(float) * (size_t)(2 * BK * BM + 2 * BK * BN +
                                                 2 * BK * r + BM * r);
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    if (vec) {
      if ((err = allow_smem(lora_mm_tiled<true>, smem)) != cudaSuccess) return (int)err;
      lora_mm_tiled<true><<<grid, NT, smem, st>>>(x, w, a, b, y, M, N, K, r, scale);
    } else {
      if ((err = allow_smem(lora_mm_tiled<false>, smem)) != cudaSuccess) return (int)err;
      lora_mm_tiled<false><<<grid, NT, smem, st>>>(x, w, a, b, y, M, N, K, r, scale);
    }
    return (int)cudaGetLastError();
  }
  if (M > 16 || kc <= 0 || kc % 8 != 0 || (long long)splits * kc < K ||
      (long long)(splits - 1) * kc >= K)
    return (int)cudaErrorInvalidValue;
  float* P = work;
  float* XA = work + (size_t)splits * M * N;
  const dim3 grid((N + SK_THREADS - 1) / SK_THREADS, splits);
  if (M <= 8) {
    const size_t smem = sizeof(float) * 8 * (size_t)kc;
    if ((err = allow_smem(lora_mm_partial<8>, smem)) != cudaSuccess) return (int)err;
    lora_mm_partial<8><<<grid, SK_THREADS, smem, st>>>(x, w, a, P, XA, M, N, K, r, kc);
  } else {
    const size_t smem = sizeof(float) * 16 * (size_t)kc;
    if ((err = allow_smem(lora_mm_partial<16>, smem)) != cudaSuccess) return (int)err;
    lora_mm_partial<16><<<grid, SK_THREADS, smem, st>>>(x, w, a, P, XA, M, N, K, r, kc);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 fgrid((N + FOLD_THREADS - 1) / FOLD_THREADS, M);
  lora_mm_fold<<<fgrid, FOLD_THREADS, 0, st>>>(P, XA, b, y, M, N, r, splits, scale);
  return (int)cudaGetLastError();
}
