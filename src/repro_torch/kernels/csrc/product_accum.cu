// Accumulating signed product fold, for Hopper (sm_90a).
//
// product_accum_launch replaces the TPU kernel
// kernels/fedex_residual.py::product_accum_apply (src/repro/, :215; body
// _kernel_product with input_output_aliases={1: 0}; wrapper
// ops.product_accum) of the JAX package. For every stacked layer l and
// output element (i, j), in place:
//
//   acc += scale * sum_c s_c (a_c @ b_c)
//
// The chunked round close folds each chunk of uplinks into its (L, m, n)
// product accumulator with it (scale 1, s = the chunk's raw ingest
// weights). Lanes with s_c == 0 (unwritten chunk rows) are never read.
// It rounds as product_fold.cu's body does with acc as W0, so the two agree
// bitwise: d_c is an fmaf chain over k = 0..r-1 from 0, the lanes are summed
// in slot order as sum = __fadd_rn(sum, __fmul_rn(s_c, d_c)) from 0, and
// acc = __fadd_rn(acc, __fmul_rn(scale, sum)). IEEE f32 on CUDA cores: no
// TF32, no tensor cores (the exact-residual identity is f32's).
//
// Layout: acc is (L, m, n) contiguous; a is (C, L, m, r) and b is
// (C, L, r, n) addressed through their client and layer strides, trailing
// dims contiguous.
//
// Bound on the card, with K = C_live * r rank columns: 8 bytes of acc per
// element (one read, one write) against 2K + 2 C_live + 2 flops. A chunk of
// 4 uplinks at r = 4 (K = 16) is bound by bytes; the documented chunk of 64
// uplinks at r = 8 (K = 512, ~1,150 flops an element) by operations.
//
// Design:
// - A persistent grid (as many blocks as fit, 2 an SM) walks the 64 x 128
//   output tiles, each block every gridDim.x-th tile. Each block holds a
//   ring of two acc tiles in shared memory: the next tile's acc is copied in
//   by cp.async (16-byte cp.async.cg where n % 4 == 0 and acc and b are
//   16-byte aligned, 4-byte copies in the kVec = false variant) while this
//   tile's products run, and the epilogue reads acc from the ring and
//   stores a float4 a thread where the rows are aligned.
// - Each block reads the C signs once and compacts the live lanes in slot
//   order with a ballot and a prefix over the warps (no host sync). The
//   live lanes' rank columns form one K axis, staged in slabs of kSlab
//   columns (a k-major, b row-major) by cp.async, double-buffered with one
//   barrier a slab; the slabs run on from one tile into the next. Each warp
//   stages the columns k = warp (mod 8) through a (lane, rank column)
//   cursor that steps by 8 without a division; a lane's chain of k runs on
//   across slab boundaries.
// - Each thread owns 8 rows x 4 contiguous columns (a warp is 4 x 8
//   threads, so a column's a values are 2 float4 reads of 4 addresses and
//   its b values 1 float4 read of 8, both conflict-free): 32 FMAs per 3
//   shared-memory reads. Where r % 4 == 0 (kQuad) lanes end on multiples of
//   4 columns, so the columns run in unrolled groups of 4 with one lane
//   test a group.
// The block's shared memory grows with C by 8 bytes a lane (the live
// list); a launch whose shared memory exceeds the card's limit returns the
// CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // 8 warps of 4 x 8 threads
constexpr int kTileM = 64;           // 8 row groups of kRows rows
constexpr int kTileN = 128;          // 32 column groups of 4
constexpr int kRows = kTileM / 8;    // output rows a thread
constexpr int kSlab = 32;            // rank columns a slab
constexpr int kRing = 2;             // acc tiles a block holds

size_t smem_bytes(int num_clients) {
  return sizeof(float) *
             (kRing * kTileM * kTileN + 2 * kSlab * (kTileM + kTileN)) +
         (sizeof(float) + sizeof(int)) * (size_t)num_clients;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The products of one staged slab (nk columns of the K axis) into this
// thread's outputs: d takes the current lane's fmaf chain; once the lane's
// last rank column is in, sum += s_c * d and d restarts from 0. (cp, ck)
// is the live lane and its rank column the chain is at.
template <bool kQuad>
__device__ __forceinline__ void slab_product(float (&d)[kRows][4],
                                             float (&sum)[kRows][4],
                                             const float* as, const float* bs,
                                             const float* live_s, int nk,
                                             int r, int& cp, int& ck) {
  auto column = [&](int e) {
    float av[kRows];
#pragma unroll
    for (int i = 0; i < kRows; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(as + e * kTileM + i);
      av[i] = v.x;
      av[i + 1] = v.y;
      av[i + 2] = v.z;
      av[i + 3] = v.w;
    }
    const float4 v = *reinterpret_cast<const float4*>(bs + e * kTileN);
    const float bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) d[i][j] = fmaf(av[i], bv[j], d[i][j]);
  };
  auto lane_done = [&]() {
    const float sc = live_s[cp];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sum[i][j] = __fadd_rn(sum[i][j], __fmul_rn(sc, d[i][j]));
        d[i][j] = 0.f;
      }
    ck = 0;
    ++cp;
  };
  if (kQuad) {
#pragma unroll
    for (int e = 0; e < kSlab; e += 4) {
      if (e >= nk) break;
#pragma unroll
      for (int u = 0; u < 4; ++u) column(e + u);
      ck += 4;
      if (ck == r) lane_done();
    }
  } else {
    for (int e = 0; e < nk; ++e) {
      column(e);
      if (++ck == r) lane_done();
    }
  }
}

// (layer, row tile, column tile) of one of a block's tiles
struct Tile {
  int l, by, bx;
};

template <bool kVec, bool kQuad>
__global__ void __launch_bounds__(kThreads, 2)
product_accum_kernel(float* __restrict__ acc, const float* __restrict__ a,
                     const float* __restrict__ b, const float* __restrict__ s,
                     int num_clients, int num_layers, int m, int n, int r,
                     int64_t sa_c, int64_t sa_l, int64_t sb_c, int64_t sb_l,
                     float scale) {
  constexpr int BM = kTileM, BN = kTileN, KS = kSlab;
  extern __shared__ __align__(16) float smem[];
  float* acc_s = smem;                     // kRing x (BM, BN)
  float* a_s = acc_s + kRing * BM * BN;    // 2 x (KS, BM), k-major
  float* b_s = a_s + 2 * KS * BM;          // 2 x (KS, BN)
  float* live_s = b_s + 2 * KS * BN;       // (C,) signs of the live lanes
  int* live_idx = reinterpret_cast<int*>(live_s + num_clients);  // slots
  __shared__ int warp_live[kThreads / 32];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // this block's tiles: blockIdx.x + k * gridDim.x for k < count, the
  // column tile fastest; three cursors (acc copies, slab copies, epilogue)
  // step by gridDim.x tiles with carries, so a tile costs no division
  const int tiles_n = (n + BN - 1) / BN, tiles_m = (m + BM - 1) / BM;
  const int tiles = tiles_n * tiles_m * num_layers;
  const int count = (int)blockIdx.x < tiles
                        ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                        : 0;
  const int g_rest = (int)gridDim.x / tiles_n;
  const Tile step{g_rest / tiles_m, g_rest % tiles_m,
                  (int)gridDim.x % tiles_n};
  const int b_rest = (int)blockIdx.x / tiles_n;
  const Tile first{b_rest / tiles_m, b_rest % tiles_m,
                   (int)blockIdx.x % tiles_n};
  auto advance = [&](Tile& x) {
    x.bx += step.bx;
    if (x.bx >= tiles_n) {
      x.bx -= tiles_n;
      ++x.by;
    }
    x.by += step.by;
    if (x.by >= tiles_m) {
      x.by -= tiles_m;
      ++x.l;
    }
    x.l += step.l;
  };
  Tile at_acc = first, at_slab = first, at_out = first;

  auto load_acc = [&](int k) {  // tile k's acc into ring slot k % kRing
    if (k >= count) return;
    if (k > 0) advance(at_acc);
    const int row0 = at_acc.by * BM, col0 = at_acc.bx * BN;
    float* dst = acc_s + (k % kRing) * BM * BN;
    const float* src = acc + (int64_t)at_acc.l * m * n;
    if (kVec) {
#pragma unroll
      for (int q = t; q < BM * BN / 4; q += kThreads) {
        const int i = q >> 5, j = (q & 31) << 2;
        if (row0 + i < m && col0 + j < n)
          cp_async16(dst + i * BN + j, src + (int64_t)(row0 + i) * n + col0 + j);
      }
    } else {
#pragma unroll 4
      for (int q = t; q < BM * BN; q += kThreads) {
        const int i = q >> 7, j = q & 127;
        if (row0 + i < m && col0 + j < n)
          cp_async4(dst + i * BN + j, src + (int64_t)(row0 + i) * n + col0 + j);
      }
    }
  };

  load_acc(0);  // in flight while the lanes are found
  // the live lanes (s_c != 0) in slot order, once for all tiles
  int live = 0;
  for (int c0 = 0; c0 < num_clients; c0 += kThreads) {
    const int c = c0 + t;
    const float sc = c < num_clients ? s[c] : 0.f;
    const unsigned ballot = __ballot_sync(0xffffffffu, sc != 0.f);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int pos = live + __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const int cw = warp_live[w];
      pos += w < warp ? cw : 0;
      live += cw;
    }
    if (sc != 0.f) {
      live_s[pos] = sc;
      live_idx[pos] = c;
    }
    __syncthreads();  // the list is complete; warp_live may be rewritten
  }
  const int K = live * r;  // rank columns of the live lanes
  const int nslab = (K + KS - 1) / KS;
  const int steps = nslab > 0 ? nslab : 1;  // steps a tile (1 when K = 0)

  // staging cursor of this warp: K column warp + 8 * i is rank column lk of
  // live lane lp; it restarts at each tile and steps by 8 without a division
  const int q8 = r > 0 ? 8 / r : 0, r8 = r > 0 ? 8 % r : 0;
  const int lp0 = r > 0 ? warp / r : live, lk0 = r > 0 ? warp % r : 0;
  int lp = lp0, lk = lk0;
  auto stage = [&](int k, int js) {  // slab js of tile k
    if (k >= count || nslab == 0) return;
    if (js == 0) {
      lp = lp0;
      lk = lk0;
      if (k > 0) advance(at_slab);
    }
    const int row0 = at_slab.by * BM, col0 = at_slab.bx * BN;
    const int buf = (k * steps + js) & 1;
    float* as = a_s + buf * KS * BM;
    float* bs = b_s + buf * KS * BN;
#pragma unroll
    for (int st = 0; st < KS / 8; ++st) {
      const int kk = warp + 8 * st;
      if (lp < live) {
        const int c = live_idx[lp];
        const float* a_p = a + c * sa_c + at_slab.l * sa_l + lk;
        const float* b_p =
            b + c * sb_c + at_slab.l * sb_l + (int64_t)lk * n + col0;
#pragma unroll
        for (int i = lane; i < BM; i += 32)
          if (row0 + i < m) cp_async4(as + kk * BM + i, a_p + (int64_t)(row0 + i) * r);
        if (kVec) {
          const int j = lane << 2;
          if (col0 + j < n) cp_async16(bs + kk * BN + j, b_p + j);
        } else {
#pragma unroll
          for (int j = lane; j < BN; j += 32)
            if (col0 + j < n) cp_async4(bs + kk * BN + j, b_p + j);
        }
      }
      lk += r8;
      lp += q8;
      if (lk >= r) {
        lk -= r;
        ++lp;
      }
    }
  };

  const int rg = ((t >> 3) & 3) + 4 * (warp >> 2);  // rows rg * kRows + i
  const int cg = (t & 7) + 8 * (warp & 3);          // columns cg * 4 + j
  float d[kRows][4], sum[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) d[i][j] = sum[i][j] = 0.f;

  stage(0, 0);
  cp_async_commit();
  int cp = 0, ck = 0;  // live lane and its rank column the products are at
  for (int k = 0, js = 0; k < count;) {
    cp_async_wait_all();
    __syncthreads();  // this step's slab and acc tile are in for all; the
                      // slots the next copies write are no longer read
    const bool last = js + 1 == steps;
    stage(last ? k + 1 : k, last ? 0 : js + 1);
    if (js == 0) load_acc(k + 1);
    cp_async_commit();

    if (js < nslab) {
      const int buf = (k * steps + js) & 1;
      slab_product<kQuad>(d, sum, a_s + buf * KS * BM + rg * kRows,
                          b_s + buf * KS * BN + cg * 4, live_s,
                          min(KS, K - js * KS), r, cp, ck);
    }
    if (!last) {
      ++js;
      continue;
    }

    // tile k is complete: acc + scale * sum, from the ring to acc
    if (r == 0)  // an empty product per live lane, as the per-lane loop has
      for (int p = 0; p < live; ++p)
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sum[i][j] = __fadd_rn(sum[i][j], __fmul_rn(live_s[p], 0.f));
    if (k > 0) advance(at_out);
    const int row0 = at_out.by * BM, gj = at_out.bx * BN + cg * 4;
    const float* ring = acc_s + (k % kRing) * BM * BN;
    float* out = acc + (int64_t)at_out.l * m * n;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int li = rg * kRows + i;
      const float4 w = *reinterpret_cast<const float4*>(ring + li * BN + cg * 4);
      const float o[4] = {__fadd_rn(w.x, __fmul_rn(scale, sum[i][0])),
                          __fadd_rn(w.y, __fmul_rn(scale, sum[i][1])),
                          __fadd_rn(w.z, __fmul_rn(scale, sum[i][2])),
                          __fadd_rn(w.w, __fmul_rn(scale, sum[i][3]))};
#pragma unroll
      for (int j = 0; j < 4; ++j) sum[i][j] = 0.f;
      if (row0 + li >= m) continue;
      float* dst = out + (int64_t)(row0 + li) * n + gj;
      if (kVec) {
        if (gj < n) *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gj + j < n) dst[j] = o[j];
      }
    }
    cp = 0;
    ++k;
    js = 0;
  }
  cp_async_wait_all();  // no copy outlives the block
}

template <bool kVec, bool kQuad>
cudaError_t launch(float* acc, const float* a, const float* b, const float* s,
                   int num_clients, int num_layers, int m, int n, int r,
                   int64_t sa_c, int64_t sa_l, int64_t sb_c, int64_t sb_l,
                   float scale, cudaStream_t stream) {
  auto kernel = product_accum_kernel<kVec, kQuad>;
  const size_t smem = smem_bytes(num_clients);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  // the persistent grid: as many blocks as fit on the card at once
  int device = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      smem);
  if (e != cudaSuccess) return e;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  const int64_t tiles = (int64_t)((n + kTileN - 1) / kTileN) *
                        ((m + kTileM - 1) / kTileM) * num_layers;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  const int64_t resident = (int64_t)sms * per_sm;
  const int grid = (int)(tiles < resident ? tiles : resident);
  kernel<<<grid, kThreads, smem, stream>>>(acc, a, b, s, num_clients,
                                           num_layers, m, n, r, sa_c, sa_l,
                                           sb_c, sb_l, scale);
  return cudaGetLastError();
}

}  // namespace

// acc += scale * sum_c s_c (a_c @ b_c) in place; launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int product_accum_launch(float* acc, const float* a, const float* b,
                                    const float* s, int num_clients,
                                    int num_layers, int m, int n, int r,
                                    int64_t sa_c, int64_t sa_l, int64_t sb_c,
                                    int64_t sb_l, float scale, void* stream) {
  if (num_layers <= 0 || m <= 0 || n <= 0) return 0;
  const bool vec = n % 4 == 0 && sb_c % 4 == 0 && sb_l % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(acc) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const bool quad = r % 4 == 0;
  decltype(&launch<true, true>) go =
      vec ? (quad ? &launch<true, true> : &launch<true, false>)
          : (quad ? &launch<false, true> : &launch<false, false>);
  return (int)go(acc, a, b, s, num_clients, num_layers, m, n, r, sa_c, sa_l,
                 sb_c, sb_l, scale, static_cast<cudaStream_t>(stream));
}
