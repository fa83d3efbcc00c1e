// Fused LoRA projection  y = x @ W + scale * (x @ a) @ b  for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/lora_matmul.py::lora_matmul (body _kernel;
// wrapper ops.lora_dense) of the JAX package. The serving path runs every
// adapted q/k/v/o projection of prefill and decode through it.
//
// x (M, K), W (K, N), a (K, r), b (r, N): all f32 or all bf16, row-major
// and contiguous; y (M, N) f32 (the TPU kernel's out_shape); r <= 64. Any
// M, N, K: ragged tiles are zero-filled on load and masked on store (the TPU
// kernel zero-pads to its tiles).
//
// Arithmetic: f32 operands run IEEE f32 FMAs on CUDA cores (Hopper's
// tensor cores take f32 only as TF32, which the port keeps off): SIMT
// bodies. bf16 operands (the reference's serving dtype) run on the tensor
// cores where TMA can describe x and W (K % 8 == 0, N % 8 == 0, both
// 16-byte aligned): the tensor-core body at M > 16, the tensor-core
// split-K body at M <= 16. The SIMT bodies take the other bf16 calls.
//
// bf16 in the SIMT bodies: every kernel is a template on the element type
// T. A bf16 x bf16 product is exact in f32, so bf16 operands are widened to
// f32 as they are staged and the shared-memory layouts, FMA loops and sums
// are f32's. cp.async copies bytes and has no 2-byte form, so bf16 stages
// through registers where f32 uses cp.async (single elements in the tiled
// body, which bf16 reaches only with odd K or N or an unaligned x or W),
// except for the split-K body's W and a streams, which cp.async 8 bytes (4
// bf16) into the same 16-byte ring slots and widen them when a slot is
// read. So bf16 keeps f32's shared memory (tiled_smem, splitk_smem) and the
// wrapper's plan. In every body, as the TPU kernel, x@a is summed in f32
// over the whole K and rounded once to bf16 (b's dtype, round to nearest
// even) before it is multiplied by b: where the prepass writes it (the
// tiled body), after the tensor-core body's K loop, in the split-K bodies
// after the chunks' partials are folded.
//
// Four bodies, picked by the caller (the wrapper's _body) from M, the
// dtype and alignment: bf16 that TMA can describe takes a tensor-core body,
// the tensor-core split-K one at M <= 16 and the tensor-core one above;
// the rest take the SIMT split-K body at M <= 16 and the tiled one above.
//
// * tiled (f32 prefill, M > 16; bf16 where TMA cannot describe x or W),
//   two grids.
//   - A prepass writes xa = x@a (M x r) into the caller's work buffer, so
//     the GEMM's K loop holds no adapter work. At r <= 4 with float4-
//     aligned f32 x rows (prefill) lora_mm_xa4 reads x once, streaming (50
//     MB at prefill q_proj: 15 us at 3.35 TB/s); otherwise lora_mm_xa64
//     stages x and a through shared memory, 32 rows of x a block.
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
// * tensor-core (bf16 prefill, M > 16, K % 8 == 0, N % 8 == 0, x and W
//   16-byte aligned: what TMA can describe), two grids: lora_mm_at writes
//   a^T zero-padded to NA rows (NA = r rounded up to 8, 16, 32 or 64) into
//   the work buffer (NA * K bf16: 48 KB at Llama's r 4, against the 25 MB
//   of x a prepass reads), then lora_mm_tc. The SIMT body widened bf16 to
//   f32 through registers and ran on f32 CUDA cores, 4% of the bf16 bound
//   (5.24 ms for a Llama prefill layer against 0.21); the bound is the
//   tensor cores' 989 TFLOP/s, so the products have to run there and
//   their operands have to arrive without threads. A persistent grid (one
//   block of three warpgroups an SM) walks the 128 x 128 output tiles. The
//   producer warpgroup (40 registers after setmaxnreg) has one thread
//   stream K in slices of 64 through a ring of 4-5 shared-memory stages
//   with TMA: x's 128 x 64 box (K-major), W's two 64 x 64 boxes (N-major:
//   W is read as it lies, never transposed) and a^T's NA x 64 box
//   (K-major), all with 128-byte swizzle, each stage's arrival on a `full`
//   mbarrier; its other three warps stage b's r x 128 panel of the next
//   tile while the consumers run this one. Two consumer warpgroups (232
//   registers) each own 64 rows of the tile and issue, per k16 step,
//   wgmma.mma_async m64n128k16 (x@W, 64 f32 registers a thread; W through
//   the instruction's transpose bit) and m64nNAk16 (x@a, its own f32
//   accumulator) straight from the swizzled stages; a slice's products stay
//   in flight while the next slice's are issued, and a stage goes back to
//   the producer (`empty` mbarrier) once its products are done. TMA
//   zero-fills the ragged M, N and K edges; the store masks rows and
//   columns. Epilogue, in the plain version's order: x@a, summed in f32
//   over the whole K, is rounded to bf16 once and stored into the tile's
//   x@a rows (K-major swizzled), and a third wgmma (K = NA, at least 16)
//   puts (x@a)@b, from b's panel, in its own accumulator; y = acc +
//   scale * acc2 (no contraction), stored as float2. x@a comes from a
//   second accumulator in the K loop, not from the tiled body's prepass:
//   the prepass reads all of x again for every projection and the epilogue
//   then waits on the tile's x@a rows, while the K loop has the x slices
//   in shared memory already and pays NA/128 more tensor-core work. Bound on
//   the card: operations, 2*M*N*K + 2*M*r*(K + N) at 989 TFLOP/s (a Llama
//   prefill layer: 206 GFLOP, 0.21 ms). The tensor cores sum each k16
//   step's products in f32 but do not round as IEEE FMAs do; the wrapper's
//   lora_matmul_error_bound holds them all the same (chip_smoke.py prints
//   each served shape's largest error as a share of it). Every sum has a
//   fixed order: two runs are bitwise equal.
// * SIMT split-K (f32 decode, and bf16 that TMA cannot describe; M <= 16),
//   one grid: the tiled body at M = 8 would run
//   24-48 blocks on 132 SMs and 16x the needed FMAs. A block streams one K
//   chunk of W's rows for bn columns once, each thread 16 rows of 16 bytes
//   in flight through a private cp.async ring in shared memory (64 KB a
//   block, no registers), with all M rows of x as FMA operands; a warp of
//   its own streams a's r columns of the same rows, so the chunk's x@a
//   comes with W's. The K chunks (at most 8) of a column block are one
//   thread-block cluster: the blocks fold their partials in chunk order
//   through distributed shared memory and add scale*(x@a)@b, so nothing
//   goes out to device memory but y. The caller picks the fewest chunks and
//   the widest columns that put blocks on half the SMs (decode q/o_proj:
//   4 chunks x 24 column blocks of 128; k/v_proj: 8 x 8).
//   Bound on the card: bytes, 4*(K*N + M*K + K*r + r*N + M*N) (decode q_proj:
//   37.8 MB, 11.3 us at 3.35 TB/s). `python3 chip_smoke.py --decode-sweep`
//   times the body at every plan of splits and bn; PERF.md has what it
//   measured and what holds the body back.
// * tensor-core split-K (bf16 decode, M <= 16, what TMA can describe), one
//   grid. The SIMT split-K body ran f32's loop with half the payload (8
//   bytes in each 16-byte ring slot, a widen and 4 MR FFMA a row of 4
//   columns): at a Llama decode layer 15% of its bytes bound, slower than
//   the f32 body on twice the bytes, so the instructions per row set its
//   pace, not memory. Here no thread spends instructions on W:
//   - Grid: block = (column block of DC_BN = 64 columns, K chunk of kc rows,
//     kc a multiple of 64 so that no box of W straddles two chunks); the
//     <= 8 chunks of a column block are one cluster (portable size). 64
//     columns is wgmma's M and gives the most blocks; the wrapper's
//     _tc_split_plan takes the fewest chunks (each <= 1024 rows, one
//     staging of x) that put >= 1.4 blocks on every SM. Wider blocks (128,
//     256 columns) and deeper rings (one block an SM) measured slower in
//     `chip_smoke.py --decode-sweep`'s design runs: fewer blocks, and waves.
//   - W by TMA: thread 128 streams the chunk's 64 x 64 boxes (N-major,
//     128-byte swizzle: W read as it lies) through a ring of DC_STAGES = 3
//     (24 KB a block, four blocks an SM) with full and empty mbarriers. W
//     is read once a call, so it goes through L2 with an evict-first
//     policy: its lines leave first and displace neither x nor lines that
//     another kernel left dirty (without it a decode layer measured 5-6 us
//     slower). The first slices and x's first staging are issued before the
//     block barrier.
//   - x by TMA too: boxes of 64 columns x MP rows (MP 8 or 16; rows past M
//     and columns past K zero-filled), up to DC_X_BYTES a staging. Both
//     maps are encoded on the host and cached by (pointer, shape, box): W's
//     once per weight, x's once per activation buffer the caching
//     allocator reuses, so a steady decode step encodes none. Copies by
//     threads (cp.async) stalled the issuing warp on address translation
//     and held the block barrier back by ~1 us.
//   - x@W on the tensor cores with A and B swapped: y^T = W^T x^T, wgmma
//     m64nMPk16 with A = W^T read from W's box through the transpose bit,
//     B = x^T from x's K-major box, D 64 columns x MP rows in f32 (MP / 2
//     registers a thread). A stage goes back to the producer as soon as its
//     products are done: the block waits on memory, not on the tensor
//     cores. The consumer warpgroup is threads 0-127, a branch ptxas can
//     see is warpgroup-uniform (else it serialises wgmma: C7518).
//   - x@a off W's path: warp 5 stages b's panel and a's rows (cp.async) and
//     runs mma.sync m16n8k16 on the staged x and a (f32 accumulators).
//   - The fold without a cluster barrier at the end: each chunk stores its
//     partial y^T (outputs inside M and N) into the shared memory of the
//     block that folds that share of the column block, and its x@a into
//     every block's, with st.async, whose bytes complete on the receiver's
//     mbarrier (expect_tx set at its start): a block folds as soon as its
//     inputs land, and no block waits for the cluster at its end (a
//     cluster barrier measured ~0.8 us even for a one-block cluster). A
//     split cluster barrier at the start (arrive at entry, wait before the
//     first remote store) makes sure every block of the cluster runs before
//     anything is written into it. The plain version's order: the chunks
//     summed in order, x@a rounded to bf16 once (round_to) after the whole
//     K, y = sum + scale * (x@a)@b with b's panel widened, no contraction.
//     Every sum has a fixed order: two runs are bitwise equal.
//   - No overlap across calls: the grid is not a programmatic dependent
//     launch, so stream order guards W and x. Every mbarrier wait traps
//     after ~4 s.
//   Bound on the card: bytes, 2 (K N + M K + K r + r N) + 4 M N (a Llama
//   decode layer: 50.3 MB, 15.2 us at 3.35 TB/s). What holds it below,
//   with the numbers, is in PERF.md: a launch's fixed part (start, first
//   data, fold), which decode pays 4 L times a step.
//
// Every body sums in another order than torch.matmul; the wrapper's
// lora_matmul_error_bound states how far two evaluations may differ (the
// tensor cores' f32 sums, which do not round as IEEE FMAs, are held to it
// by measurement).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <cstring>
#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

// bf16 bit patterns widened to f32 (exact): the low and the high half of a
// 32-bit word, which hold the element at the lower and the higher address
__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ float4 widen4(uint2 u) {
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}

// one element, read through the read-only cache, as f32
__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg1(const bf16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// 4 consecutive f32 (16-byte aligned)
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// v rounded to T (x@a's cast to b's dtype), kept as f32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (kF32<T>)
    return v;
  else
    return __bfloat162float(__float2bfloat16_rn(v));
}

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

// 8 bytes (4 bf16) into the first half of a 16-byte slot; src_bytes 0
// fills it with zeros and reads nothing
__device__ __forceinline__ void cp_async8(float* dst, const bf16* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// One element into f32 shared memory, zero where !ok: f32 by a 4-byte
// cp.async (`any` a valid address to name when !ok), bf16 through a
// register, widened
__device__ __forceinline__ void stage1(float* dst, const float* src,
                                       const float* any, bool ok) {
  cp_async4(dst, ok ? src : any, ok ? 4 : 0);
}
__device__ __forceinline__ void stage1(float* dst, const bf16* src,
                                       const bf16*, bool ok) {
  *dst = ok ? ldg1(src) : 0.f;
}

// The copies that fill one ring stage with a K slice: x rows [m0, m0+BM)
// and W columns [n0, n0+BN). Each thread keeps two running source pointers
// (advanced one slice a call) and its fixed shared-memory offsets, so a
// copy costs an address add, not a 64-bit product: the loop's registers go
// to the accumulators. A copy moves E elements: 4 f32 by a 16-byte cp.async
// where kVec (f32 only: aligned bf16 takes the tensor-core body), else one.
template <typename T, bool kVec>
struct SliceLoader {
  static_assert(kF32<T> || !kVec, "aligned bf16 takes the tensor-core body");
  static constexpr int E = kVec ? 4 : 1;
  // x: XV copies a row, XR rows a pass, XU passes; W: WV copies a row, WR
  // rows a pass, WU passes
  static constexpr int XV = BK / E;
  static constexpr int XR = NT / XV, XU = BM / XR;
  static constexpr int WV = BN / E;
  static constexpr int WR = NT / WV, WU = BK / WR;
  static_assert(NT % XV == 0 && BM % XR == 0 && NT % WV == 0 && BK % WR == 0,
                "the copies tile the stage exactly");

  const T* __restrict__ x;
  const T* xp;  // x + (m0 + xrow) * K + k0 + xk
  const T* wp;  // w + (k0 + wrow) * N + n0 + wn
  int rows_left;    // M - m0 - xrow: pass u has a row iff u * XR < it
  int xk, wrow, xo, wo, K, N;
  bool wn_ok;

  __device__ SliceLoader(const T* x_, const T* w, int M, int N_, int K_,
                         int m0, int n0)
      : x(x_), K(K_), N(N_) {
    const int tid = threadIdx.x;
    const int xrow = tid / XV;
    xk = (tid % XV) * E;
    wrow = tid / WV;
    const int wn = (tid % WV) * E;
    xp = x + (size_t)(m0 + xrow) * K + xk;
    wp = w + (size_t)wrow * N + n0 + wn;
    rows_left = M - m0 - xrow;
    wn_ok = n0 + wn < N;
    xo = xrow * XP + xk;
    wo = wrow * BN + wn;
  }

  __device__ __forceinline__ void copy(float* dst, const T* src,
                                       bool ok) const {
    if constexpr (kVec) {
      cp_async16(dst, ok ? src : x, ok ? 16 : 0);
    } else {
      stage1(dst, src, x, ok);
    }
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
template <typename T, bool kVec>
__global__ void __launch_bounds__(NT, 1)
    lora_mm_tiled(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ xa, const T* __restrict__ b,
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
      stage1(bs + idx, b + (size_t)(idx / BN) * N + n, b, n < N);
    }
  }
  SliceLoader<T, kVec> load(x, w, M, N, K, m0, n0);
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

// f32, r <= 4 and float4-aligned x rows: xa[m0 + i, c] =
// sum_k x[m0 + i, k] a[k, c] for the block's 16 rows from
// m0 = blockIdx.x * 16. Thread t takes
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
        av[q][c] = c < r ? ldg1(a + (size_t)(k + q) * r + c) : 0.f;
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < rows) t = ldg4(x + (size_t)(m0 + i) * K + k);
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

template <typename T>
__global__ void __launch_bounds__(XA_THREADS)
    lora_mm_xa64(const T* __restrict__ x, const T* __restrict__ a,
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
      stage1(&xs[s][row * XW_XP + kk], x + (size_t)m * K + k, x,
             m < M && k < K);
    }
#pragma unroll
    for (int u = 0; u < XW_KC * kMaxRank / XA_THREADS; ++u) {
      const int idx = tid + u * XA_THREADS, kk = idx / kMaxRank,
                c = idx % kMaxRank, k = k0 + kk;
      stage1(&as[s][idx], a + (size_t)k * r + c, a, c < r && k < K);
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
      if (c < r) xa[(size_t)m * r + c] = round_to<T>(acc[j]);
    }
  }
}

// -------------------------------------------------------- tensor-core
// bf16, M > 16, x and W described by TMA (K % 8 == 0, N % 8 == 0, both
// 16-byte aligned). A persistent grid (at most one block an SM) walks the
// 128 x 128 output tiles in the tiled body's grouped order. Shared memory,
// from a 1024-byte aligned base (what the 128-byte swizzle repeats over):
// the stages of the ring, each [x box 128 rows x 128 B | W box, columns
// n0.. : 64 K rows x 128 B | W box, columns n0 + 64.. | a^T box NA rows x
// 128 B]; the tile's x@a rows (128 x 128 B, K-major like x); b's panel
// (two halves of kMaxRank rows x 128 B, N-major like W); the mbarriers.
// NA, the adapter's rank padded to 8, 16, 32 or 64 (0: no adapter), is a
// template argument: the x@a product is m64nNAk16.
constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 64;
constexpr int TC_THREADS = 384;  // producer, two consumer warpgroups
constexpr int TC_X_BYTES = TC_BM * TC_BK * 2;  // 16 KB
constexpr int TC_W_HALF = TC_BK * 64 * 2;      // 8 KB
constexpr int TC_XA_BYTES = TC_BM * 128;
constexpr int TC_B_HALF = kMaxRank * 128;
constexpr int TC_LOADERS = 96;  // the producer's warps 1-3 stage b's panel

// K slices in the ring: 5, or 4 where a^T's box is 4-8 KB
__host__ __device__ constexpr int tc_stages(int na) { return na >= 32 ? 4 : 5; }
__host__ __device__ constexpr int tc_stage_bytes(int na) {
  return TC_X_BYTES + 2 * TC_W_HALF + na * 128;
}
__host__ __device__ constexpr size_t tc_smem(int na) {
  return 1024 + (size_t)tc_stages(na) * tc_stage_bytes(na) + TC_XA_BYTES +
         2 * TC_B_HALF + (2 * tc_stages(na) + 2) * 8;
}
static_assert(tc_smem(0) <= 232448 && tc_smem(8) <= 232448 &&
                  tc_smem(16) <= 232448 && tc_smem(32) <= 232448 &&
                  tc_smem(64) <= 232448,
              "one block an SM");

// (m0, n0) of tile t: groups of GROUP_M row panels, column by column in a
// group (the tiled body's order)
__device__ __forceinline__ void tc_tile(int t, int tiles_m, int tiles_n,
                                        int& m0, int& n0) {
  const int per_group = GROUP_M * tiles_n;
  const int group = t / per_group, first = group * GROUP_M;
  const int rows_in = min(GROUP_M, tiles_m - first);
  const int in_group = t - group * per_group;
  m0 = (first + in_group % rows_in) * TC_BM;
  n0 = (in_group / rows_in) * TC_BN;
}

// a (K, r) as a^T zero-padded to na rows, (na, K) row-major: the K-major
// box that TMA gives the x@a product
__global__ void __launch_bounds__(256)
    lora_mm_at(const bf16* __restrict__ a, bf16* __restrict__ at, int K,
               int r, int na) {
  // the GEMM grid may launch now: its TMA waits with griddepcontrol.wait
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)na * K) return;
  const int n = (int)(i / K), k = (int)(i - (long long)n * K);
  at[i] = n < r ? a[(size_t)k * r + n] : __float2bfloat16_rn(0.f);
}

// y = x @ w + scale * bf16(x @ a) @ b over the block's tiles; at = a^T
// padded to NA rows (unread if NA = 0, r = 0)
template <int NA>
__global__ void __launch_bounds__(TC_THREADS, 1)
    lora_mm_tc(const __grid_constant__ CUtensorMap tmx,
               const __grid_constant__ CUtensorMap tmw,
               const __grid_constant__ CUtensorMap tma,
               const bf16* __restrict__ b, float* __restrict__ y, int M,
               int N, int K, int r, float scale) {
  constexpr int S = tc_stages(NA), SB = tc_stage_bytes(NA);
  constexpr int KA = NA <= 16 ? 16 : NA;  // the adapter product's K
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  unsigned char* gbase = smem_raw + pad;  // the same address, generic
  const uint32_t base = raw + pad;
  const uint32_t xa_s = base + S * SB;
  const uint32_t b_s = xa_s + TC_XA_BYTES;
  const uint32_t full0 = b_s + 2 * TC_B_HALF;  // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * S;
  const uint32_t bfull = empty0 + 8 * S, bempty = bfull + 8;

  const int tiles_m = (M + TC_BM - 1) / TC_BM;
  const int tiles_n = (N + TC_BN - 1) / TC_BN;
  const int tiles = tiles_m * tiles_n;
  const int nk = (K + TC_BK - 1) / TC_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 2);  // one arrival a consumer warpgroup
    }
    mbar_init(bfull, TC_LOADERS);  // b's panel staged
    mbar_init(bempty, 2);          // and read by both consumer warpgroups
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (NA == 8) {  // the x@a rows' columns 8..15: zero for good
    for (int i = threadIdx.x; i < TC_XA_BYTES / 4; i += TC_THREADS)
      reinterpret_cast<uint32_t*>(gbase + (xa_s - base))[i] = 0u;
    fence_async_smem();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < 128) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 0) {
      if (lane == 0) {  // TMA: x, W and a^T, slice by slice
        // a^T comes from the grid before (a programmatic dependent launch)
        if (NA > 0) asm volatile("griddepcontrol.wait;\n" ::: "memory");
        int it = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          int m0, n0;
          tc_tile(t, tiles_m, tiles_n, m0, n0);
          // W's second box lies past N when N - n0 <= 64: not loaded (its
          // columns are never stored)
          const bool second = n0 + 64 < N;
          const uint32_t bytes =
              TC_X_BYTES + (second ? 2 : 1) * TC_W_HALF + NA * 128;
          for (int kt = 0; kt < nk; ++kt, ++it) {
            const int s = it % S;
            mbar_wait(empty0 + 8 * s, ((it / S) & 1) ^ 1);
            mbar_expect_tx(full0 + 8 * s, bytes);
            const uint32_t st = base + s * SB, bar = full0 + 8 * s;
            const int k0 = kt * TC_BK;
            tma_load(st, &tmx, k0, m0, bar);
            tma_load(st + TC_X_BYTES, &tmw, n0, k0, bar);
            if (second)
              tma_load(st + TC_X_BYTES + TC_W_HALF, &tmw, n0 + 64, k0, bar);
            if (NA > 0)
              tma_load(st + TC_X_BYTES + 2 * TC_W_HALF, &tma, k0, 0, bar);
          }
        }
      }
    } else if (NA > 0) {  // warps 1-3: b's r x 128 panel of each tile
      const int lt = threadIdx.x - 32;
      int j = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
        int m0, n0;
        tc_tile(t, tiles_m, tiles_n, m0, n0);
        mbar_wait(bempty, (j & 1) ^ 1);
        // rows [0, KA) (zero past r and past N), N-major swizzled
        for (int idx = lt; idx < KA * TC_BN; idx += TC_LOADERS) {
          const int q = idx / TC_BN, n = idx % TC_BN;
          unsigned short v = 0;
          if (q < r && n0 + n < N)
            v = __ldg(reinterpret_cast<const unsigned short*>(b) +
                      (size_t)q * N + n0 + n);
          *reinterpret_cast<unsigned short*>(
              gbase + (b_s - base) + (n >> 6) * TC_B_HALF +
              sw128_offset(q, n & 63)) = v;
        }
        fence_async_smem();
        mbar_arrive(bfull);
      }
    }
  } else {  // two consumer warpgroups, 64 rows of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int ct = threadIdx.x - 128;  // 0..255
    const int wg = ct >> 7;
    const int row0 = wg * 64;          // the warpgroup's first row
    const uint32_t xrow = row0 * 128;  // its rows in the x box
    // the accumulator fragment: register 4j + 2h + c holds row
    // 16 (warp in the warpgroup) + lane / 4 + 8h, column 8j + 2 (lane % 4) + c
    const int fr = ((ct & 127) >> 5) * 16 + (lane >> 2);
    const int fc = (lane & 3) * 2;
    int it = 0, j = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
      int m0, n0;
      tc_tile(t, tiles_m, tiles_n, m0, n0);
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      float xacc[NA > 0 ? NA / 2 : 1];
#pragma unroll
      for (int i = 0; i < (NA > 0 ? NA / 2 : 1); ++i) xacc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % S;
        mbar_wait(full0 + 8 * s, (it / S) & 1);
        const uint32_t st = base + s * SB;
        fence_regs(acc);
        if constexpr (NA > 0) fence_regs(xacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TC_BK / 16; ++kk) {
          const uint64_t dx = sw128_desc(st + xrow + kk * 32, 16);
          wgmma_m64n128k16(
              acc, dx,
              sw128_desc(st + TC_X_BYTES + kk * 16 * 128, TC_W_HALF));
          if constexpr (NA > 0)
            wgmma_kk<NA>(xacc, dx,
                         sw128_desc(st + TC_X_BYTES + 2 * TC_W_HALF + kk * 32,
                                    16));
        }
        wgmma_commit();
        fence_regs(acc);
        if constexpr (NA > 0) fence_regs(xacc);
        // the previous slice's products are done: its stage goes back
        wgmma_wait<1>();
        fence_regs(acc);
        if constexpr (NA > 0) fence_regs(xacc);
        if (kt > 0 && (ct & 127) == 0)
          mbar_arrive(empty0 + 8 * ((it - 1) % S));
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (nk > 0 && (ct & 127) == 0) mbar_arrive(empty0 + 8 * ((it - 1) % S));

      if constexpr (NA > 0) {
        fence_regs(xacc);
        // x@a over the whole K, rounded to bf16 once, into the warpgroup's
        // rows of the x@a box (K-major swizzled)
#pragma unroll
        for (int jj = 0; jj < NA / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                xacc[4 * jj + 2 * h], xacc[4 * jj + 2 * h + 1]);
            *reinterpret_cast<__nv_bfloat162*>(
                gbase + (xa_s - base) +
                sw128_offset(row0 + fr + 8 * h, 8 * jj + fc)) = v;
          }
        fence_async_smem();
        // the warpgroup's rows are in place (named barrier 1 + wg)
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        mbar_wait(bfull, j & 1);  // b's panel of this tile
        float ad[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) ad[i] = 0.f;
        fence_regs(ad);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KA / 16; ++kk)
          wgmma_m64n128k16(ad, sw128_desc(xa_s + xrow + kk * 32, 16),
                           sw128_desc(b_s + kk * 16 * 128, TC_B_HALF));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(ad);
        if ((ct & 127) == 0) mbar_arrive(bempty);
        // the plain version's order: base + scale * adapter
#pragma unroll
        for (int i = 0; i < 64; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(scale, ad[i]));
      }

      const int rr = m0 + row0 + fr;
#pragma unroll
      for (int jj = 0; jj < TC_BN / 8; ++jj) {
        const int c = n0 + fc + 8 * jj;
        if (c >= N) continue;  // N is even: c + 1 < N too
        if (rr < M)
          *reinterpret_cast<float2*>(y + (size_t)rr * N + c) =
              make_float2(acc[4 * jj], acc[4 * jj + 1]);
        if (rr + 8 < M)
          *reinterpret_cast<float2*>(y + (size_t)(rr + 8) * N + c) =
              make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
      }
    }
  }
}

// -------------------------------------------------------------- split-K
// One grid a call. Block (column block cb, K chunk s) streams W[chunk, cb's
// bn columns] once: SK_W threads, each 4 columns (a 16-byte cp.async where
// N % 4 == 0 and W is aligned, four 4-byte ones otherwise) of its own rows
// of the chunk (row lanes: bn / 4 threads share a row). Each thread keeps
// its next D rows in flight in a private ring of shared memory (16 bytes a
// slot; it reads back only what it copied, so the ring needs no barrier):
// D * 16 bytes in flight a thread without registers, refilled one row at a
// time. All MR rows of x are FMA operands per row, read as float4 from the
// chunk of x that cp.async stages transposed in shared memory. A 9th warp
// streams a's r columns of the same rows the same way (4 columns a lane,
// the rows split over the lanes), so the chunk's x@a comes with W's
// stream. The K chunks of a column block form a thread-block cluster: each
// block sums its row lanes in order, then folds a slice of the column
// block's outputs over the cluster's partials in chunk order through
// distributed shared memory and adds scale * (x@a) @ b (b's panel staged
// with x). No work buffer, no second grid; the order of every sum is
// fixed, so two runs are bitwise equal.
constexpr int SK_W = 256;              // threads that stream W
constexpr int SK_THREADS = SK_W + 32;  // and one warp that streams a
constexpr int SK_MAX_CLUSTER = 8;      // portable cluster size: K chunks
constexpr int SK_RED = 4 * SK_W;       // row lanes x columns of a block
constexpr int SK_D = 16;               // rows in flight a thread

// rows of x staged at once: at most 32 KB of them
__host__ __device__ constexpr int sk_xk(int mr, int kc) {
  return kc < 8192 / mr ? kc : 8192 / mr;
}

// shared memory, floats: the ring (then the W row lanes' sums), staged x,
// b's panel, the a lanes' sums, this chunk's x@a and the whole K's
__host__ __device__ constexpr size_t sk_ring(int mr) {
  return (size_t)SK_D * 4 * SK_THREADS > (size_t)SK_RED * mr
             ? (size_t)SK_D * 4 * SK_THREADS
             : (size_t)SK_RED * mr;
}

size_t splitk_smem(int mr, int kc, int M, int r, int bn) {
  return sizeof(float) * (sk_ring(mr) + (size_t)sk_xk(mr, kc) * mr +
                          (size_t)r * bn + 128 * (size_t)mr + 2 * (size_t)M * r);
}

// copies 4 consecutive columns [c, c + 4) of a row into a 16-byte slot,
// zero past `ncol`: f32 as it is (one 16-byte or four 4-byte cp.async), bf16
// as its 8 bytes in the slot's first half (one 8-byte cp.async, or four
// 2-byte loads through registers)
template <bool kVec>
__device__ __forceinline__ void copy4(float* slot, const float* p, int c,
                                      int ncol) {
  if (kVec) {
    cp_async16(slot, p, c < ncol ? 16 : 0);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) cp_async4(slot + i, p + i, c + i < ncol ? 4 : 0);
  }
}
template <bool kVec>
__device__ __forceinline__ void copy4(float* slot, const bf16* p, int c,
                                      int ncol) {
  if (kVec) {
    cp_async8(slot, p, c < ncol ? 8 : 0);
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    unsigned e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = c + i < ncol ? __ldg(h + i) : 0u;
    *reinterpret_cast<uint2*>(slot) =
        make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
  }
}

// a ring slot's 4 columns as f32
template <typename T>
__device__ __forceinline__ float4 read_slot(const float* slot) {
  if constexpr (kF32<T>)
    return *reinterpret_cast<const float4*>(slot);
  else
    return widen4(*reinterpret_cast<const uint2*>(slot));
}

// acc[m][c] += x[m] * v[c] for the MR rows of one staged x row
template <int MR>
__device__ __forceinline__ void fma_row(float (&acc)[MR][4], const float* xr,
                                        float4 v) {
#pragma unroll
  for (int m4 = 0; m4 < MR; m4 += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(xr + m4);
    const float xm[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[m4 + i][0] = fmaf(xm[i], v.x, acc[m4 + i][0]);
      acc[m4 + i][1] = fmaf(xm[i], v.y, acc[m4 + i][1]);
      acc[m4 + i][2] = fmaf(xm[i], v.z, acc[m4 + i][2]);
      acc[m4 + i][3] = fmaf(xm[i], v.w, acc[m4 + i][3]);
    }
  }
}

// avec (bf16 only; false for f32, whose a warp takes 4-byte copies): a's
// rows take 8-byte copies (r % 4 == 0, a 8-byte aligned)
template <typename T, int MR, bool kVec>
__global__ void __launch_bounds__(SK_THREADS, MR == 8 ? 2 : 1)
    lora_mm_splitk(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ a, const T* __restrict__ b,
                   float* __restrict__ y, int M, int N, int K, int r,
                   float scale, int kc, int bn, bool avec) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  const int xk = sk_xk(MR, kc);
  float* ring = reinterpret_cast<float*>(smem4);  // [SK_D][SK_THREADS][4]
  float* red = ring;  // after the stream: [RL][MR][bn], then [MR][bn]
  float* xs = ring + sk_ring(MR);          // [xk][MR], x transposed
  float* bs = xs + (size_t)xk * MR;        // [r][bn], b's panel
  float* reda = bs + (size_t)r * bn;       // [RLa][MR][4 GA]
  float* xa = reda + 128 * MR;             // [M * r], this chunk's x@a
  float* xat = xa + M * r;                 // [M * r], the whole K's
  const int tid = threadIdx.x;
  const bool wthread = tid < SK_W;
  const int G = bn >> 2, RL = SK_W / G;   // W: column groups, row lanes
  // a: GA (a power of two) groups of 4 of its r columns, RLa row lanes
  int GA = 1;
  while (4 * GA < r) GA <<= 1;
  const int RLA = 32 / GA;
  const int lane_a = tid - SK_W;
  const int q = wthread ? tid / G : lane_a / GA;  // row lane
  const int g = wthread ? tid - q * G : lane_a - q * GA;  // column group
  const int rl = wthread ? RL : RLA;
  const int s = blockIdx.y, k0 = s * kc, klen = min(kc, K - k0);
  const int n0 = blockIdx.x * bn;
  const int c = wthread ? n0 + 4 * g : 4 * g;  // first column of the group
  const int ncol = wthread ? N : r;
  const size_t ld = wthread ? (size_t)N : (size_t)r;
  const T* base = wthread ? w + n0 + 4 * g : a + 4 * g;
  const bool active = wthread || 4 * g < r;
  const bool vec = wthread ? kVec : avec;
  float* slot0 = ring + 4 * tid;  // slot d at slot0 + d * 4 * SK_THREADS
  const int npair = M * r;

  float acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;

  for (int sub = 0; sub < klen; sub += xk) {
    const int len = min(xk, klen - sub);
    if (sub > 0) __syncthreads();  // the previous rows of x are read
    // group 0: x's rows (and, once, b's panel)
    for (int i = tid; i < MR * len; i += SK_THREADS) {
      const int m = i / len, kk = i - m * len;
      stage1(xs + kk * MR + m, x + (size_t)m * K + k0 + sub + kk, x, m < M);
    }
    if (sub == 0) {
      for (int i = tid; i < r * bn; i += SK_THREADS) {
        const int j = i / bn, nn = n0 + i - j * bn;
        stage1(bs + i, b + (size_t)j * N + nn, b, nn < N);
      }
    }
    cp_async_commit();
    // groups 1..D: this thread's first D rows
    const int nrows = active && q < len ? (len - q + rl - 1) / rl : 0;
    const T* p = base + (size_t)(k0 + sub + q) * ld;
    const size_t step = (size_t)rl * ld;
#pragma unroll
    for (int d = 0; d < SK_D; ++d) {
      if (d < nrows) {
        if (vec)
          copy4<true>(slot0 + d * 4 * SK_THREADS, p + d * step, c, ncol);
        else
          copy4<false>(slot0 + d * 4 * SK_THREADS, p + d * step, c, ncol);
      }
      cp_async_commit();
    }
    cp_async_wait<SK_D>();  // x's group
    __syncthreads();
    const float* xr = xs + q * MR;
    for (int i = 0; i < nrows; ++i) {
      cp_async_wait<SK_D - 1>();  // row i's group
      float* slot = slot0 + (i % SK_D) * 4 * SK_THREADS;
      const float4 v = read_slot<T>(slot);
      fma_row<MR>(acc, xr, v);
      xr += rl * MR;
      if (i + SK_D < nrows) {
        if (vec)
          copy4<true>(slot, p + (size_t)(i + SK_D) * step, c, ncol);
        else
          copy4<false>(slot, p + (size_t)(i + SK_D) * step, c, ncol);
      }
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread's stream is done: the ring is free
  // every lane's sums, in shared memory
  float* rp = wthread ? red + (size_t)q * MR * bn + 4 * g
                      : reda + (size_t)q * MR * 4 * GA + 4 * g;
  const int rs = wthread ? bn : 4 * GA;
  if (active) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
      *reinterpret_cast<float4*>(rp + (size_t)m * rs) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();
  // the block's partial, row lanes summed in order: into red[0], and this
  // chunk's x@a
  const int outs = M * bn;
  for (int o = tid; o < outs; o += SK_THREADS) {
    float t = red[o];
    for (int l = 1; l < RL; ++l) t += red[(size_t)l * MR * bn + o];
    red[o] = t;
  }
  for (int pr = tid; pr < npair; pr += SK_THREADS) {
    const int m = pr / r, j = pr - m * r;
    float t = reda[m * 4 * GA + j];
    for (int l = 1; l < RLA; ++l) t += reda[((size_t)l * MR + m) * 4 * GA + j];
    xa[pr] = t;
  }
  cluster.sync();  // every chunk's partial and x@a is in place

  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  for (int pr = tid; pr < npair; pr += SK_THREADS) {  // x@a over the whole K
    float t = cluster.map_shared_rank(xa, 0)[pr];
    for (int cc = 1; cc < cs; ++cc) t += cluster.map_shared_rank(xa, cc)[pr];
    xat[pr] = round_to<T>(t);  // once, after the whole K
  }
  __syncthreads();
  // this block's slice of the column block's outputs, summed over the
  // chunks in order, plus scale * (x@a) @ b
  const int per = (outs + cs - 1) / cs, o_end = min(outs, (rank + 1) * per);
  for (int o = rank * per + tid; o < o_end; o += SK_THREADS) {
    const int m = o / bn, col = o - m * bn, nn = n0 + col;
    if (nn >= N) continue;
    float sum = cluster.map_shared_rank(red, 0)[o];
    for (int cc = 1; cc < cs; ++cc) sum += cluster.map_shared_rank(red, cc)[o];
    float ad = 0.f;
    for (int j = 0; j < r; ++j) ad = fmaf(xat[m * r + j], bs[j * bn + col], ad);
    y[(size_t)m * N + nn] = sum + scale * ad;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ------------------------------------------------- tensor-core split-K
// bf16, M <= 16, x and W described by TMA (K % 8 == 0, N % 8 == 0, both
// 16-byte aligned). Block (column block of DC_BN = 64 columns, K chunk s) of
// 192 threads: warps 0-3 (a warpgroup) run wgmma, warp 4's lane 0 issues
// every TMA (W's stream, x's boxes), warp 5 stages a and b and computes
// x@a. Shared memory from a 1024-byte aligned base: the W ring (DC_STAGES
// boxes of 64 K rows x 64 columns, N-major, 128-byte swizzle), x's staged
// columns (boxes of 64 columns x MP rows, K-major, swizzled), a's staged
// rows, b's panel (bf16), the partials of this block's share of the
// outputs from every chunk [cs][per], every chunk's x@a [cs][M r], the
// whole K's x@a [M r], the mbarriers.
constexpr int DC_THREADS = 192;
constexpr int DC_BN = 64;          // columns of a block: wgmma's M
constexpr int DC_BOX = 64 * 128;   // one W box (one slice), bytes
constexpr int DC_STAGES = 3;       // W slices in flight a block
constexpr int DC_X_BYTES = 16384;  // x's staged columns, at most
constexpr int DC_A_BYTES = 8192;   // a's staged rows, at most

// columns of x staged at once (a multiple of 64)
__host__ __device__ constexpr int dc_xk(int mp, int kc) {
  return kc < DC_X_BYTES / (2 * mp) ? kc : DC_X_BYTES / (2 * mp);
}
// rows of a staged at once (a multiple of 64)
__host__ __device__ constexpr int dc_arows(int r) {
  return r > 0 ? DC_A_BYTES / (2 * r) / 64 * 64 : 64;
}
// the received partials: a chunk's share of MP x 64 outputs, 8 chunks
__host__ __device__ constexpr int dc_recv(int mp) {
  return mp * DC_BN + SK_MAX_CLUSTER;
}
__host__ __device__ constexpr size_t dc_smem(int mp, int kc, int r) {
  return 1024 + (size_t)DC_STAGES * DC_BOX + (size_t)dc_xk(mp, kc) * mp * 2 +
         (r > 0 ? DC_A_BYTES : 0) + (size_t)r * DC_BN * 2 +
         (size_t)dc_recv(mp) * 4 +
         (size_t)(SK_MAX_CLUSTER + 1) * mp * r * 4 + (2 * DC_STAGES + 3) * 8;
}
static_assert(dc_smem(16, 1 << 20, kMaxRank) <= 232448, "one block an SM");

// `count` bf16 (a multiple of 8) from src into shared memory at dst by one
// warp, zero at and past `valid`: 16-byte cp.async where src is 16-byte
// aligned (`vec`), else 2-byte loads through registers
__device__ __forceinline__ void warp_stage(unsigned short* dst,
                                           const bf16* src, int count,
                                           int valid, bool vec, int lane) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  if (vec) {
    for (int i = lane * 8; i < count; i += 256) {
      if (i + 8 <= valid || i >= valid) {
        const bool ok = i < valid;
        cp_async16(reinterpret_cast<float*>(dst + i),
                   reinterpret_cast<const float*>(ok ? s + i : s),
                   ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[i + e] = i + e < valid ? __ldg(s + i + e) : (unsigned short)0;
      }
    }
  } else {
    for (int i = lane; i < count; i += 32)
      dst[i] = i < valid ? __ldg(s + i) : (unsigned short)0;
  }
}

__device__ __forceinline__ uint32_t pack2(unsigned short lo,
                                          unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// the split arrive / wait of the cluster barrier (every thread of every
// block arrives, then waits, once)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// y = x @ w + scale * bf16(x @ a) @ b for M <= MP rows (MP 8 or 16), a
// cluster of the column block's K chunks; tmx: x as 64-column boxes of MP
// rows, tmw: W as 64 x 64 boxes
template <int MP>
__global__ void __launch_bounds__(DC_THREADS, 1)
    lora_mm_dec(const __grid_constant__ CUtensorMap tmx,
                const __grid_constant__ CUtensorMap tmw,
                const bf16* __restrict__ a, const bf16* __restrict__ b,
                float* __restrict__ y, int M, int N, int K, int r,
                float scale, int kc) {
  constexpr int S = DC_STAGES, BN = DC_BN;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  unsigned char* gb = smem_raw + pad;  // the same address, generic
  const uint32_t base = raw + pad;
  const int xk = dc_xk(MP, kc), mr = M * r;
  const uint32_t xs_o = S * DC_BOX;
  const uint32_t as_o = xs_o + xk * MP * 2;
  const uint32_t bs_o = as_o + (r > 0 ? DC_A_BYTES : 0);
  const uint32_t ry_o = bs_o + r * BN * 2;
  const uint32_t rxa_o = ry_o + dc_recv(MP) * 4;
  const uint32_t xat_o = rxa_o + SK_MAX_CLUSTER * MP * r * 4;
  const uint32_t full0 = base + xat_o + MP * r * 4;  // full[s] at + 8 s
  const uint32_t empty0 = full0 + 8 * S;
  const uint32_t xfull = empty0 + 8 * S, xempty = xfull + 8;
  const uint32_t ybar = xempty + 8;  // every chunk's partials have landed
  float* ry = reinterpret_cast<float*>(gb + ry_o);    // [cs][per]
  float* rxa = reinterpret_cast<float*>(gb + rxa_o);  // [cs][M r]
  float* xat = reinterpret_cast<float*>(gb + xat_o);  // [M r]
  unsigned short* as = reinterpret_cast<unsigned short*>(gb + as_o);
  unsigned short* bs = reinterpret_cast<unsigned short*>(gb + bs_o);

  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * kc;
  const int kend = min(K, k0 + kc);
  const int nk = (kend - k0 + 63) / 64;  // W slices of 64 rows
  const int ps = xk / 64;                // slices a staging of x
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int per = (M * BN + cs - 1) / cs;  // outputs a block folds
  // slices that go out before the block barrier: the stages start empty,
  // and x's first staging covers them
  const int early = min(min(S, ps), nk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;

  // the producer: slice i of W into stage i % S (evict-first: W is read
  // once), x's staging from column kp (zero past M and past K)
  const uint64_t once = l2_evict_first();
  auto slice = [&](int i) {
    const int s = i % S;
    mbar_wait(empty0 + 8 * s, ((i / S) & 1) ^ 1);
    mbar_expect_tx(full0 + 8 * s, DC_BOX);
    tma_load_hint(base + s * DC_BOX, &tmw, n0, k0 + 64 * i, full0 + 8 * s,
                  once);
  };
  auto stage_x = [&](int kp) {
    const int boxes = (min(xk, kend - kp) + 63) / 64;
    mbar_expect_tx(xfull, boxes * MP * 128);
    for (int j = 0; j < boxes; ++j)
      tma_load(base + xs_o + j * MP * 128, &tmx, kp + 64 * j, 0, xfull);
  };
  if (threadIdx.x == 128) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 4);  // one arrival a consumer warp
    }
    mbar_init(xfull, 1);  // the producer's expect_tx
    // the consumer warps (and warp 5, which reads x for x@a) are done
    mbar_init(xempty, r > 0 ? 5 : 4);
    mbar_init(ybar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the first slices and x's first staging go out before the block
    // barrier (the stages start empty: no wait)
    slice(0);
    stage_x(k0);
    for (int i = 1; i < early; ++i) slice(i);
    // the bytes every chunk stores here: its partials of this block's share
    // of the outputs (those inside M and N) and its x@a
    const int lo = rank * per, hi = min(M * BN, lo + per);
    const int vc = min(BN, N - n0);
    int outs = 0;
    for (int m = 0; m < M; ++m)
      outs += max(0, min(hi, m * BN + vc) - max(lo, m * BN));
    mbar_expect_tx(ybar, 4 * cs * (outs + mr));
  }
  // every block of the cluster has started before any writes into another
  // one's shared memory (the wait comes before the first such write)
  cluster_arrive();
  __syncthreads();

  if (threadIdx.x < 128) {  // x@W on the tensor cores: y^T = W^T x^T
    float acc[MP / 2];
#pragma unroll
    for (int i = 0; i < MP / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < nk; ++i) {
      const int s = i % S, j = i % ps;
      if (j == 0) mbar_wait(xfull, (i / ps) & 1);
      mbar_wait(full0 + 8 * s, (i / S) & 1);
      const uint32_t wst = base + s * DC_BOX;
      const uint32_t xb = base + xs_o + j * MP * 128;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tn<MP>(acc, sw128_desc(wst + kk * 16 * 128, DC_BOX),
                     sw128_desc(xb + kk * 32, 16));
      wgmma_commit();
      // the slice's products are done: its stage goes back at once (the
      // block waits on memory, not on the tensor cores)
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) {
        mbar_arrive(empty0 + 8 * s);
        if (j == ps - 1 || i == nk - 1) mbar_arrive(xempty);  // staging done
      }
    }
    // the fragment: register 4 jj + 2 h + c holds y^T row (column of y)
    // 16 warp + lane / 4 + 8 h, column (row of y) 8 jj + 2 (lane % 4) + c;
    // output o = m BN + n goes to the block folding it (rank o / per), at
    // this chunk's row of its partials
    cluster_wait();
#pragma unroll
    for (int jj = 0; jj < MP / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = 16 * warp + gq + 8 * h, m = 8 * jj + 2 * tq + c;
          const int o = m * BN + n;
          if (m < M && n0 + n < N) {
            const uint32_t dst = o / per;
            st_async(map_rank(base + ry_o + 4 * (rank * per + o - dst * per),
                              dst),
                     acc[4 * jj + 2 * h + c], map_rank(ybar, dst));
          }
        }
  } else if (warp == 4) {  // TMA: the rest of W's stream, x's stagings
    if (lane == 0) {
      for (int i = early; i < nk; ++i) {
        if (i % ps == 0) {  // the next staging of x
          mbar_wait(xempty, (i / ps - 1) & 1);
          stage_x(k0 + 64 * i);
        }
        slice(i);
      }
    }
    cluster_wait();
  } else {  // warp 5: b's panel, a's rows and x@a on mma.sync
    float xacc[8][4];
#pragma unroll
    for (int jg = 0; jg < 8; ++jg)
#pragma unroll
      for (int c = 0; c < 4; ++c) xacc[jg][c] = 0.f;
    const int ng = (r + 7) >> 3, arows = dc_arows(r);
    const bool avec = ((uintptr_t)a & 15) == 0;
    if (r > 0) {
      for (int j = 0; j < r; ++j)  // b's r x BN panel, zero past N
        warp_stage(bs + j * BN, b + (size_t)j * N + n0, BN, min(BN, N - n0),
                   ((uintptr_t)b & 15) == 0, lane);
      for (int p = 0, kp = k0; kp < kend; ++p, kp += xk) {
        const int cols = min(xk, kend - kp);  // columns of K in this staging
        for (int q0 = 0; q0 < cols; q0 += arows) {
          const int rows = min(arows, cols - q0);  // a's rows, all below K
          __syncwarp();  // the last pass's reads of a's rows are done
          warp_stage(as, a + (size_t)(kp + q0) * r, ((rows + 15) & ~15) * r,
                     rows * r, avec, lane);
          cp_async_commit();
          cp_async_wait<0>();
          if (q0 == 0) mbar_wait(xfull, p & 1);
          __syncwarp();
          for (int kq = 0; kq < rows; kq += 16) {
            const int c0 = q0 + kq + 2 * tq;  // x's column in this staging
            const uint32_t xb = xs_o + (c0 >> 6) * MP * 128;
            uint32_t fa[4];
            fa[0] = *reinterpret_cast<const uint32_t*>(
                gb + xb + sw128_offset(gq, c0 & 63));
            fa[2] = *reinterpret_cast<const uint32_t*>(
                gb + xb + sw128_offset(gq, (c0 & 63) + 8));
            if (MP == 16) {
              fa[1] = *reinterpret_cast<const uint32_t*>(
                  gb + xb + sw128_offset(gq + 8, c0 & 63));
              fa[3] = *reinterpret_cast<const uint32_t*>(
                  gb + xb + sw128_offset(gq + 8, (c0 & 63) + 8));
            } else {
              fa[1] = fa[3] = 0u;
            }
            const unsigned short* ar = as + (size_t)(kq + 2 * tq) * r;
#pragma unroll
            for (int jg = 0; jg < 8; ++jg) {
              if (jg >= ng) break;
              const int j = jg * 8 + gq;
              uint32_t b0 = 0u, b1 = 0u;
              if (j < r) {
                b0 = pack2(ar[j], ar[r + j]);
                b1 = pack2(ar[8 * r + j], ar[9 * r + j]);
              }
              mma_m16n8k16(xacc[jg], fa, b0, b1);
            }
          }
        }
        __syncwarp();  // every lane is done with this staging of x
        if (lane == 0) mbar_arrive(xempty);
      }
    }
    // the chunk's x@a goes to every block of the cluster, at its row
    cluster_wait();
    if (r > 0) {
#pragma unroll
      for (int jg = 0; jg < 8; ++jg) {
        if (jg >= ng) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = gq + 8 * (e >> 1), j = jg * 8 + 2 * tq + (e & 1);
          if (m < M && j < r)
            for (int cc = 0; cc < cs; ++cc)
              st_async(map_rank(base + rxa_o + 4 * (rank * mr + m * r + j), cc),
                       xacc[jg][e], map_rank(ybar, cc));
        }
      }
    }
  }
  mbar_wait_cluster(ybar, 0);  // every chunk's partials and x@a are here

  const int tid = threadIdx.x;
  for (int pr = tid; pr < mr; pr += DC_THREADS) {  // x@a over the whole K
    float t = rxa[pr];
    for (int cc = 1; cc < cs; ++cc) t += rxa[cc * mr + pr];
    xat[pr] = round_to<bf16>(t);  // once, after the whole K
  }
  __syncthreads();
  // this block's share of the column block's outputs, the chunks summed in
  // order, then the plain version's y = base + scale * adapter
  for (int i = tid; i < per; i += DC_THREADS) {
    const int o = rank * per + i, m = o / BN, col = o - m * BN, n = n0 + col;
    if (m >= M || n >= N) continue;
    float sum = ry[i];
    for (int cc = 1; cc < cs; ++cc) sum += ry[cc * per + i];
    float ad = 0.f;
    for (int j = 0; j < r; ++j)
      ad = fmaf(xat[m * r + j],
                __uint_as_float((unsigned)bs[j * BN + col] << 16), ad);
    y[(size_t)m * N + n] = __fadd_rn(sum, __fmul_rn(scale, ad));
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory above 48 KB; the
// attribute is set once per kernel, device and size (a static table per
// kernel), not once per launch.
template <auto kKernel>
cudaError_t allow_smem(size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  constexpr int kDevices = 64;
  static int granted[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && granted[dev] >= (int)bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < kDevices) granted[dev] = (int)bytes;
  return err;
}

template <typename T, int MR, bool kVec>
cudaError_t launch_splitk(const T* x, const T* w, const T* a, const T* b,
                          float* y, int M, int N, int K, int r, float scale,
                          int splits, int kc, int bn, bool avec,
                          cudaStream_t st) {
  const size_t smem = splitk_smem(MR, kc, M, r, bn);
  cudaError_t err = allow_smem<lora_mm_splitk<T, MR, kVec>>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + bn - 1) / bn), (unsigned)splits);
  cfg.blockDim = dim3(SK_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = (unsigned)splits;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lora_mm_splitk<T, MR, kVec>, x, w, a, b, y,
                           M, N, K, r, scale, kc, bn, avec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// a row-major bf16 (rows, cols) matrix as TMA boxes of box_rows x 64
// columns (128 bytes, 128-byte swizzle), zero-filled past its edges; the
// caller promises a 16-byte aligned p and cols % 8 == 0
cudaError_t bf16_map(CUtensorMap* map, const bf16* p, int rows, int cols,
                     int box_rows) {
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// bf16_map, cached by (pointer, shape, box): a map holds only an address,
// a shape, strides and a box, so a cached map is right for any tensor at
// that address. Decode encodes W's map once per weight, not once a call,
// and x's once per activation buffer the caching allocator hands out.
cudaError_t cached_bf16_map(CUtensorMap* map, const bf16* p, int rows,
                            int cols, int box_rows) {
  struct Key {
    const void* p;
    int rows, cols, box;
    bool operator==(const Key& o) const {
      return p == o.p && rows == o.rows && cols == o.cols && box == o.box;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(k.p) ^
             ((size_t)k.rows * 0x9e3779b97f4a7c15ull) ^
             ((size_t)k.cols << 21) ^ (size_t)k.box;
    }
  };
  using Raw = std::array<unsigned long long, sizeof(CUtensorMap) / 8>;
  static std::mutex mu;
  static std::unordered_map<Key, Raw, Hash> maps;
  const Key key{p, rows, cols, box_rows};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = maps.find(key);
  if (it != maps.end()) {
    std::memcpy(map, it->second.data(), sizeof(CUtensorMap));
    return cudaSuccess;
  }
  const cudaError_t err = bf16_map(map, p, rows, cols, box_rows);
  if (err != cudaSuccess) return err;
  if (maps.size() >= 4096) maps.clear();
  Raw raw;
  std::memcpy(raw.data(), map, sizeof(CUtensorMap));
  maps.emplace(key, raw);
  return cudaSuccess;
}

template <int MP>
cudaError_t launch_dec_grid(const CUtensorMap& tmx, const CUtensorMap& tmw,
                            const bf16* a, const bf16* b, float* y, int M,
                            int N, int K, int r, float scale, int splits,
                            int kc, cudaStream_t st) {
  const size_t smem = dc_smem(MP, kc, r);
  cudaError_t err = allow_smem<lora_mm_dec<MP>>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + DC_BN - 1) / DC_BN), (unsigned)splits);
  cfg.blockDim = dim3(DC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = (unsigned)splits;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lora_mm_dec<MP>, tmx, tmw, a, b, y, M, N, K,
                           r, scale, kc);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the tensor-core split-K body: x's and W's maps (cached), then one grid
cudaError_t launch_dec(const bf16* x, const bf16* w, const bf16* a,
                       const bf16* b, float* y, int M, int N, int K, int r,
                       float scale, int splits, int kc, int bn,
                       cudaStream_t st) {
  if (K % 8 != 0 || N % 8 != 0 || ((uintptr_t)x & 15) != 0 ||
      ((uintptr_t)w & 15) != 0 || kc % 64 != 0 || bn != DC_BN)
    return cudaErrorInvalidValue;
  const int mp = M <= 8 ? 8 : 16;
  CUtensorMap tmx, tmw;
  cudaError_t err = cached_bf16_map(&tmx, x, M, K, mp);
  if (err != cudaSuccess) return err;
  if ((err = cached_bf16_map(&tmw, w, K, N, 64)) != cudaSuccess) return err;
  return mp == 8 ? launch_dec_grid<8>(tmx, tmw, a, b, y, M, N, K, r, scale,
                                      splits, kc, st)
                 : launch_dec_grid<16>(tmx, tmw, a, b, y, M, N, K, r, scale,
                                       splits, kc, st);
}

// SMs of the current device (queried once a device)
cudaError_t sm_count(int* sms) {
  constexpr int kDevices = 64;
  static int count[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && count[dev] > 0) {
    *sms = count[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kDevices) count[dev] = *sms;
  return err;
}

template <int NA>
cudaError_t launch_tc_grid(const CUtensorMap& tmx, const CUtensorMap& tmw,
                           const CUtensorMap& tma, const bf16* b, float* y,
                           int M, int N, int K, int r, float scale,
                           unsigned grid, cudaStream_t st) {
  cudaError_t err = allow_smem<lora_mm_tc<NA>>(tc_smem(NA));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = tc_smem(NA);
  cfg.stream = st;
  // the GEMM grid may start while lora_mm_at runs: its TMA thread waits
  // for a^T with griddepcontrol.wait
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = NA > 0 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, lora_mm_tc<NA>, tmx, tmw, tma, b, y, M, N,
                           K, r, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the tensor-core body: a^T (padded to NA rows) into `work`, then the GEMM
// grid, one block an SM at most
cudaError_t launch_tc(const bf16* x, const bf16* w, const bf16* a,
                      const bf16* b, float* y, float* work, int M, int N,
                      int K, int r, float scale, cudaStream_t st) {
  const int na = r == 0 ? 0 : r <= 8 ? 8 : r <= 16 ? 16 : r <= 32 ? 32 : 64;
  CUtensorMap tmx, tmw, tma;
  cudaError_t err;
  if ((err = bf16_map(&tmx, x, M, K, TC_BM)) != cudaSuccess) return err;
  if ((err = bf16_map(&tmw, w, K, N, TC_BK)) != cudaSuccess) return err;
  tma = tmx;  // unread without an adapter
  if (na > 0) {
    bf16* at = reinterpret_cast<bf16*>(work);
    if (at == nullptr) return cudaErrorInvalidValue;
    if ((err = bf16_map(&tma, at, na, K, na)) != cudaSuccess) return err;
    const long long total = (long long)na * K;
    lora_mm_at<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(a, at, K, r,
                                                                  na);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const long long tiles =
      (long long)((M + TC_BM - 1) / TC_BM) * ((N + TC_BN - 1) / TC_BN);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  switch (na) {
    case 0:
      return launch_tc_grid<0>(tmx, tmw, tma, b, y, M, N, K, r, scale, grid, st);
    case 8:
      return launch_tc_grid<8>(tmx, tmw, tma, b, y, M, N, K, r, scale, grid, st);
    case 16:
      return launch_tc_grid<16>(tmx, tmw, tma, b, y, M, N, K, r, scale, grid, st);
    case 32:
      return launch_tc_grid<32>(tmx, tmw, tma, b, y, M, N, K, r, scale, grid, st);
    default:
      return launch_tc_grid<64>(tmx, tmw, tma, b, y, M, N, K, r, scale, grid, st);
  }
}

template <typename T>
cudaError_t run(const T* x, const T* w, const T* a, const T* b, float* y,
                float* work, int M, int N, int K, int r, float scale,
                int splits, int kc, int bn, int vec, cudaStream_t st) {
  cudaError_t err;
  if (splits == 0) {
    const long long tiles =
        (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
    if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
    if constexpr (!kF32<T>) {  // aligned bf16: the tensor cores
      if (vec) return launch_tc(x, w, a, b, y, work, M, N, K, r, scale, st);
    }
    if (r > 0 && work == nullptr) return cudaErrorInvalidValue;
    if (r > 0) {
      if (kF32<T> && r <= 4 && vec)
        lora_mm_xa4<<<(M + 15) / 16, XA_THREADS, 0, st>>>(
            reinterpret_cast<const float*>(x),
            reinterpret_cast<const float*>(a), work, M, K, r);
      else
        lora_mm_xa64<T><<<(M + XW_ROWS - 1) / XW_ROWS, XA_THREADS, 0, st>>>(
            x, a, work, M, K, r);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
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
    if (kF32<T> && vec) {
      if ((err = allow_smem<lora_mm_tiled<float, true>>(smem)) != cudaSuccess)
        return err;
      err = cudaLaunchKernelEx(&cfg, lora_mm_tiled<float, true>,
                               reinterpret_cast<const float*>(x),
                               reinterpret_cast<const float*>(w),
                               (const float*)work,
                               reinterpret_cast<const float*>(b), y, M, N, K,
                               r, scale);
    } else {
      if ((err = allow_smem<lora_mm_tiled<T, false>>(smem)) != cudaSuccess)
        return err;
      err = cudaLaunchKernelEx(&cfg, lora_mm_tiled<T, false>, x, w,
                               (const float*)work, b, y, M, N, K, r, scale);
    }
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  if (M > 16 || splits > SK_MAX_CLUSTER || kc <= 0 ||
      (long long)splits * kc < K || (long long)(splits - 1) * kc >= K)
    return cudaErrorInvalidValue;
  if (vec & 4) {  // bf16 that TMA can describe: the tensor cores
    if constexpr (kF32<T>)
      return cudaErrorInvalidValue;
    else
      return launch_dec(x, w, a, b, y, M, N, K, r, scale, splits, kc, bn, st);
  }
  if (bn != 32 && bn != 64 && bn != 128) return cudaErrorInvalidValue;
  const bool avec = !kF32<T> && (vec & 2);
  if (M <= 8)
    return (vec & 1) ? launch_splitk<T, 8, true>(x, w, a, b, y, M, N, K, r,
                                                 scale, splits, kc, bn, avec, st)
                     : launch_splitk<T, 8, false>(x, w, a, b, y, M, N, K, r,
                                                  scale, splits, kc, bn, avec, st);
  return (vec & 1) ? launch_splitk<T, 16, true>(x, w, a, b, y, M, N, K, r,
                                                scale, splits, kc, bn, avec, st)
                   : launch_splitk<T, 16, false>(x, w, a, b, y, M, N, K, r,
                                                 scale, splits, kc, bn, avec, st);
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 = launched). x, w, a, b
// are float (is_bf16 == 0) or __nv_bfloat16 (is_bf16 != 0); y f32.
//
// splits == 0 -> the tiled body, `work` holding M * r floats (x@a; unused
// and may be null when r == 0); vec != 0 promises 16-byte aligned x and w
// and K % 4 == 0, N % 4 == 0 (f32) or K % 8 == 0, N % 8 == 0 (bf16), and
// with bf16 takes the tensor-core body, `work` then holding a^T padded to
// NA rows (NA * K bf16, 16-byte aligned; unused when r == 0).
// splits > 0 -> the split-K body (M <= 16): a cluster of `splits` <= 8 K
// chunks of kc rows (splits * kc >= K, no empty chunk) per column block of
// bn (32, 64 or 128) columns, no `work`; bit 0 of vec promises N % 4 == 0
// and a 16-byte (f32) or 8-byte (bf16) aligned w; bit 1 (bf16 only) r % 4
// == 0 and an 8-byte aligned a. Bit 2 (bf16 only) takes the tensor-core
// split-K body instead: K % 8 == 0, N % 8 == 0, 16-byte aligned x and w,
// kc a multiple of 64 and bn 64 or 128 (checked; otherwise an error).
extern "C" int lora_matmul_launch(const void* x, const void* w, const void* a,
                                  const void* b, float* y, float* work, int M,
                                  int N, int K, int r, float scale, int splits,
                                  int kc, int bn, int vec, int is_bf16,
                                  void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || r < 0 || r > kMaxRank) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)run(static_cast<const __nv_bfloat16*>(x),
                    static_cast<const __nv_bfloat16*>(w),
                    static_cast<const __nv_bfloat16*>(a),
                    static_cast<const __nv_bfloat16*>(b), y, work, M, N, K, r,
                    scale, splits, kc, bn, vec, st);
  return (int)run(static_cast<const float*>(x), static_cast<const float*>(w),
                  static_cast<const float*>(a), static_cast<const float*>(b), y,
                  work, M, N, K, r, scale, splits, kc, bn, vec, st);
}
