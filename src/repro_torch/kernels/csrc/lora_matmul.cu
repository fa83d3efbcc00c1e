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
// * tiled (prefill, M > 16), two grids.
//   - A prepass writes xa = x@a (M x r) into the caller's work buffer, so
//     the GEMM's K loop holds no adapter work. At r <= 4 with float4-
//     aligned x rows (prefill) lora_mm_xa4 reads x once, streaming (50 MB
//     at prefill q_proj: 15 us at 3.35 TB/s); otherwise lora_mm_xa64 stages
//     x and a through shared memory, 32 rows of x a block.
//   - The GEMM (lora_mm_tiled) runs one block of 256 threads per 128 x 128
//     output tile, tiles grouped by 8 row panels so that the blocks in
//     flight share W's column panels and x's row panels in L2. K streams
//     in slices of 64 through a ring of 2 shared-memory stages that
//     cp.async fills straight from device memory (16-byte cp.async.cg
//     where x and W allow it, 4-byte copies with zero-fill otherwise): one
//     barrier a slice, the next slice's copies in flight under this one's
//     products. x stays row-major in shared memory (rows padded to 68
//     floats, so a warp's 4 rows fall in distinct banks); a thread reads
//     its 8 rows as float4 along k and W's row at its 8 columns as 2
//     float4: 4 LDS.128 per 64 FFMAs of its 8 x 8 micro-tile (rows ty +
//     16i, columns tx*4.. and 64 + tx*4..). The block takes every register
//     the compiler wants (one block an SM): with 128 registers and two
//     blocks an SM the fragments are not prefetched and the loop runs
//     slower. b's r x 128 panel is copied at the start, the tile's x@a
//     rows near the end (after griddepcontrol.wait: the GEMM grid is a
//     programmatic dependent launch of the prepass), and the epilogue adds
//     scale*(x@a)@b from shared memory and stores y as float4 where rows
//     are 16-byte aligned.
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
constexpr int BM = 128, BN = 128, BK = 64, NT = 256;
constexpr int STAGES = 2;            // K slices in the shared-memory ring
constexpr int XP = BK + 4;           // padded row of the x tile, floats
constexpr int XS = BM * XP;          // floats of one x stage
constexpr int STAGE = XS + BK * BN;  // floats of one stage (x, then W)
constexpr int GROUP_M = 8;           // row panels a tile group spans

// the ring (137,216 bytes), then the epilogue's x@a rows [BM][r] and b
// panel [r][BN]: at most 202,752 bytes, one block an SM
size_t tiled_smem(int r) {
  return sizeof(float) * ((size_t)STAGES * STAGE + (size_t)(BM + BN) * r);
}

// cp.async of 16 or 4 bytes; src_bytes 0 fills the destination with zeros
// and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The copies that fill one ring stage with a K slice: x rows [m0, m0+BM)
// and W columns [n0, n0+BN). Each thread keeps two running source pointers
// (advanced one slice a call) and its fixed shared-memory offsets, so a
// copy costs an address add, not a 64-bit product: the loop's registers go
// to the accumulators.
template <bool kVec>
struct SliceLoader {
  // x: XV copies a row (16 or 4 bytes each), XR rows a pass, XU passes;
  // W: WV copies a row, WR rows a pass, WU passes
  static constexpr int XV = kVec ? BK / 4 : BK;
  static constexpr int XR = NT / XV, XU = BM / XR;
  static constexpr int WV = kVec ? BN / 4 : BN;
  static constexpr int WR = NT / WV, WU = BK / WR;
  static_assert(NT % XV == 0 && BM % XR == 0 && NT % WV == 0 && BK % WR == 0,
                "the copies tile the stage exactly");

  const float* __restrict__ x;
  const float* xp;  // x + (m0 + xrow) * K + k0 + xk
  const float* wp;  // w + (k0 + wrow) * N + n0 + wn
  int rows_left;    // M - m0 - xrow: pass u has a row iff u * XR < it
  int xk, wrow, xo, wo, K, N;
  bool wn_ok;

  __device__ SliceLoader(const float* x_, const float* w, int M, int N_,
                         int K_, int m0, int n0)
      : x(x_), K(K_), N(N_) {
    const int tid = threadIdx.x;
    const int xrow = tid / XV;
    xk = (tid % XV) * (kVec ? 4 : 1);
    wrow = tid / WV;
    const int wn = (tid % WV) * (kVec ? 4 : 1);
    xp = x + (size_t)(m0 + xrow) * K + xk;
    wp = w + (size_t)wrow * N + n0 + wn;
    rows_left = M - m0 - xrow;
    wn_ok = n0 + wn < N;
    xo = xrow * XP + xk;
    wo = wrow * BN + wn;
  }

  __device__ __forceinline__ void copy(float* dst, const float* src,
                                       bool ok) const {
    if (kVec)
      cp_async16(dst, ok ? src : x, ok ? 16 : 0);
    else
      cp_async4(dst, ok ? src : x, ok ? 4 : 0);
  }

  // slice k0 into stage; slices come in order, k0 = 0, BK, 2 BK, ...
  __device__ __forceinline__ void operator()(float* stage, int k0) {
    const bool xk_ok = k0 + xk < K;
#pragma unroll
    for (int u = 0; u < XU; ++u)
      copy(stage + xo + u * XR * XP, xp + (size_t)u * XR * K,
           xk_ok && u * XR < rows_left);
#pragma unroll
    for (int u = 0; u < WU; ++u)
      copy(stage + XS + wo + u * WR * BN, wp + (size_t)u * WR * N,
           wn_ok && k0 + wrow + u * WR < K);
    xp += BK;
    wp += (size_t)BK * N;
  }
};

// y = x @ w + scale * xa @ b, xa = x @ a from the prepass (unread if r = 0)
template <bool kVec>
__global__ void __launch_bounds__(NT, 1)
    lora_mm_tiled(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ xa, const float* __restrict__ b,
                  float* __restrict__ y, int M, int N, int K, int r,
                  float scale) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a warp is 4 thread rows x 8 thread columns: its x reads hit 4 rows in
  // distinct banks, its W reads 128 contiguous bytes
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);

  // tile order: groups of GROUP_M row panels, column by column in a group
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * tiles_n;
  const int group = blockIdx.x / per_group;
  const int first = group * GROUP_M;
  const int rows_in = min(GROUP_M, tiles_m - first);
  const int in_group = blockIdx.x - group * per_group;
  const int m0 = (first + in_group % rows_in) * BM;
  const int n0 = (in_group / rows_in) * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float* xas = sm + STAGES * STAGE;  // [BM][r], x@a of the tile's rows
  float* bs = xas + BM * r;          // [r][BN], b's panel
  if (r > 0) {  // b's panel, with the first slice's copies
    for (int idx = tid; idx < r * BN; idx += NT) {
      const int n = n0 + (idx & (BN - 1));
      const bool ok = n < N;
      cp_async4(bs + idx, ok ? b + (size_t)(idx / BN) * N + n : b, ok ? 4 : 0);
    }
  }
  SliceLoader<kVec> load(x, w, M, N, K, m0, n0);
  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(sm + s * STAGE, s * BK);
    cp_async_commit();
  }
  // x@a comes from the prepass grid, which may still run (programmatic
  // dependent launch): wait for it only STAGES - 1 slices before the end,
  // and copy the tile's rows with that slice's group
  const int xa_at = nk - STAGES + 1 > 0 ? nk - STAGES + 1 : 0;
  int cur = 0, nxt = STAGES - 1;  // ring stages of slices kt, kt + STAGES - 1
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slice kt landed
    __syncthreads();  // everyone's did, and slice kt - 1's stage is free
    if (kt + STAGES - 1 < nk) load(sm + nxt * STAGE, (kt + STAGES - 1) * BK);
    if (kt == xa_at && r > 0) {
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      const size_t base = (size_t)m0 * r, total = (size_t)M * r;
      for (int idx = tid; idx < BM * r; idx += NT) {
        const bool ok = base + idx < total;
        cp_async4(xas + idx, ok ? xa + base + idx : xa, ok ? 4 : 0);
      }
    }
    cp_async_commit();
    const float* xs = sm + cur * STAGE;
    const float* ws = xs + XS;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 xv[8];  // the thread's 8 rows at k = kq .. kq + 3
#pragma unroll
      for (int i = 0; i < 8; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xs + (ty + 16 * i) * XP + kq);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 b0 = *reinterpret_cast<const float4*>(ws + (kq + c) * BN + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(ws + (kq + c) * BN + 64 + tx * 4);
        const float bn[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float am = c == 0 ? xv[i].x : c == 1 ? xv[i].y
                         : c == 2 ? xv[i].z : xv[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(am, bn[j], acc[i][j]);
        }
      }
    }
    cur = cur == STAGES - 1 ? 0 : cur + 1;
    nxt = nxt == STAGES - 1 ? 0 : nxt + 1;
  }
  cp_async_wait<0>();  // x@a and b's panel; no copy outlives the block

  // epilogue: y = acc + scale * (x@a) @ b
  if (r > 0) {
    __syncthreads();  // every thread's copies of x@a and b have landed
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* xr = xas + (ty + 16 * i) * r;
      float ad[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) ad[j] = 0.f;
      for (int q = 0; q < r; ++q) {
        const float xq = xr[q];
        const float4 b0 = *reinterpret_cast<const float4*>(bs + q * BN + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + q * BN + 64 + tx * 4);
        const float bn[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) ad[j] = fmaf(xq, bn[j], ad[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = acc[i][j] + scale * ad[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    float* yr = y + (size_t)m * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (kVec) {
        if (n < N)
          *reinterpret_cast<float4*>(yr + n) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n + c < N) yr[n + c] = acc[i][4 * h + c];
      }
    }
  }
}

// --------------------------------------------------------- x@a prepass
constexpr int XA_THREADS = 256;

// r <= 4 and float4-aligned x rows: xa[m0 + i, c] = sum_k x[m0 + i, k] a[k, c]
// for the block's 16 rows from m0 = blockIdx.x * 16. Thread t takes
// k = 4t, 4(t + 256), ...: it reads x as float4 and a's 4 rows there once
// for all 16 rows, so the block reads each x row in 4 KB runs and the grid
// reads x once at close to the card's memory rate. No barrier until the
// sums over the warp's lanes (butterfly) and the 8 warps (shared memory).
__global__ void __launch_bounds__(XA_THREADS)
    lora_mm_xa4(const float* __restrict__ x, const float* __restrict__ a,
                float* __restrict__ xa, int M, int K, int r) {
  constexpr int RB = 16, RC = 4;
  // the GEMM grid may launch now: it reads x@a only after griddepcontrol.wait
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ float part[XA_THREADS / 32][RB * RC];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * RB, rows = min(RB, M - m0);
  float acc[RB][RC];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[i][c] = 0.f;
#pragma unroll 1
  for (int k = tid * 4; k < K; k += XA_THREADS * 4) {  // K % 4 == 0
    float av[4][RC];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < RC; ++c)
        av[q][c] = c < r ? __ldg(a + (size_t)(k + q) * r + c) : 0.f;
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < rows)
        t = __ldg(reinterpret_cast<const float4*>(x + (size_t)(m0 + i) * K + k));
      const float xv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < RC; ++c) acc[i][c] = fmaf(xv[q], av[q][c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int c = 0; c < RC; ++c) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], off);
      if (lane == 0) part[warp][i * RC + c] = acc[i][c];
    }
  __syncthreads();
  if (tid < RB * RC) {
    const int i = tid / RC, c = tid % RC;
    if (i < rows && c < r) {
      float t = 0.f;
#pragma unroll
      for (int w8 = 0; w8 < XA_THREADS / 32; ++w8) t += part[w8][tid];
      xa[(size_t)(m0 + i) * r + c] = t;
    }
  }
}

// Any r <= 64 and any x: xa for the block's 32 rows from m0 = blockIdx.x *
// 32, all r columns (padded to 64 with zeros). K streams in chunks of 32
// through a 2-stage ring that 4-byte cp.async fills (x rows and a's rows;
// a is read once a block, not once a row). Thread (i, g) = (tid / 8,
// tid % 8) owns row i at columns 4g.. and 32 + 4g..: per 4 k one float4 of
// x and 8 of a, read without bank conflicts, for 32 FMAs.
constexpr int XW_ROWS = 32, XW_KC = 32, XW_XP = XW_KC + 4;

__global__ void __launch_bounds__(XA_THREADS)
    lora_mm_xa64(const float* __restrict__ x, const float* __restrict__ a,
                 float* __restrict__ xa, int M, int K, int r) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ __align__(16) float xs[2][XW_ROWS * XW_XP];
  __shared__ __align__(16) float as[2][XW_KC * kMaxRank];
  const int tid = threadIdx.x, i = tid >> 3, g = tid & 7;
  const int m0 = blockIdx.x * XW_ROWS;
  auto load = [&](int s, int k0) {
#pragma unroll
    for (int u = 0; u < XW_ROWS * XW_KC / XA_THREADS; ++u) {
      const int idx = tid + u * XA_THREADS, row = idx / XW_KC,
                kk = idx % XW_KC, m = m0 + row, k = k0 + kk;
      const bool ok = m < M && k < K;
      cp_async4(&xs[s][row * XW_XP + kk], ok ? x + (size_t)m * K + k : x,
                ok ? 4 : 0);
    }
#pragma unroll
    for (int u = 0; u < XW_KC * kMaxRank / XA_THREADS; ++u) {
      const int idx = tid + u * XA_THREADS, kk = idx / kMaxRank,
                c = idx % kMaxRank, k = k0 + kk;
      const bool ok = c < r && k < K;
      cp_async4(&as[s][idx], ok ? a + (size_t)k * r + c : a, ok ? 4 : 0);
    }
    cp_async_commit();
  };
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  const int nk = (K + XW_KC - 1) / XW_KC;
  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk kt landed; chunk kt - 1's stage is free
    if (kt + 1 < nk) load(s ^ 1, (kt + 1) * XW_KC);
    const float* xr = &xs[s][i * XW_XP];
    const float* ar = &as[s][4 * g];
#pragma unroll
    for (int kq = 0; kq < XW_KC; kq += 4) {
      const float4 t = *reinterpret_cast<const float4*>(xr + kq);
      const float xv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 a0 = *reinterpret_cast<const float4*>(ar + (kq + q) * kMaxRank);
        const float4 a1 = *reinterpret_cast<const float4*>(ar + (kq + q) * kMaxRank + 32);
        acc[0] = fmaf(xv[q], a0.x, acc[0]); acc[1] = fmaf(xv[q], a0.y, acc[1]);
        acc[2] = fmaf(xv[q], a0.z, acc[2]); acc[3] = fmaf(xv[q], a0.w, acc[3]);
        acc[4] = fmaf(xv[q], a1.x, acc[4]); acc[5] = fmaf(xv[q], a1.y, acc[5]);
        acc[6] = fmaf(xv[q], a1.z, acc[6]); acc[7] = fmaf(xv[q], a1.w, acc[7]);
      }
    }
  }
  const int m = m0 + i;
  if (m < M) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (j < 4 ? 4 * g : 32 + 4 * g) + (j & 3);
      if (c < r) xa[(size_t)m * r + c] = acc[j];
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
// splits == 0 -> the tiled body, `work` holding M * r floats (x@a; unused
// and may be null when r == 0). splits > 0 -> the split-K body with K
// chunks of kc rows (kc a multiple of 8, splits * kc >= K, M <= 16) and
// `work` holding splits * M * (N + r) floats.
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
    if (r > 0 && work == nullptr) return (int)cudaErrorInvalidValue;
    const long long tiles =
        (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (r > 0) {
      if (r <= 4 && vec)
        lora_mm_xa4<<<(M + 15) / 16, XA_THREADS, 0, st>>>(x, a, work, M, K, r);
      else
        lora_mm_xa64<<<(M + XW_ROWS - 1) / XW_ROWS, XA_THREADS, 0, st>>>(
            x, a, work, M, K, r);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    // the GEMM grid may start while the prepass runs (it waits for x@a with
    // griddepcontrol.wait near its end); without r there is no prepass
    const size_t smem = tiled_smem(r);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)tiles);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute pdl[1];
    pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    pdl[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = pdl;
    cfg.numAttrs = r > 0 ? 1 : 0;
    if (vec) {
      if ((err = allow_smem(lora_mm_tiled<true>, smem)) != cudaSuccess) return (int)err;
      err = cudaLaunchKernelEx(&cfg, lora_mm_tiled<true>, x, w,
                               (const float*)work, b, y, M, N, K, r, scale);
    } else {
      if ((err = allow_smem(lora_mm_tiled<false>, smem)) != cudaSuccess) return (int)err;
      err = cudaLaunchKernelEx(&cfg, lora_mm_tiled<false>, x, w,
                               (const float*)work, b, y, M, N, K, r, scale);
    }
    if (err != cudaSuccess) return (int)err;
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
