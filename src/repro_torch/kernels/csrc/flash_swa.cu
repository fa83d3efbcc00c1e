// Causal / sliding-window flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/flash_swa.py::flash_swa (body _kernel;
// wrapper ops.swa_attention) of the JAX package. The serving path runs every
// prefill attention through it.
//
//   out[b, i, h] = sum_j softmax_j(mask(q[b, i, h] . k[b, j, g(h)] * d^-1/2))
//                  v[b, j, g(h)],   g(h) = h / (H / KVH)
//   mask: j < Sk; causal -> j <= i; window w > 0 -> i - j < w; masked
//   scores are -1e30 (the reference's NEG_INF), l is clamped at 1e-30.
//
// q, o (B, Sq, H, d) and k, v (B, Sk, KVH, d), all f32 or all bf16 (o in
// q's dtype, as the TPU kernel's out_shape), each addressed through
// its own (batch, position, head) strides with a contiguous last dim, so
// the GQA heads read their K/V head in place (no repeated copy) and the
// (BH, S, d) layout is the case H = KVH = 1. d <= 256 (padded to DP = 64,
// 128 or 256); any Sq, Sk: rows and columns past the ends are zero-filled on
// load and masked.
//
// The SIMT body (f32, below). Bound on the card: operations, 4*d FLOPs per
// visible (query, key) pair (prefill at B 8, H 24, S 512, d 128, causal:
// 12.9 GFLOP, 0.19 ms at 67 TFLOP/s), IEEE f32 FMAs on CUDA cores (TF32 stays off). The bytes (q,
// k, v, o once: 134 MB there, 0.04 ms) are far below it, so the design is
// about keeping the FMA pipes fed:
//
// * One block of 4 warps per (b*h, 64 query rows), two blocks an SM (115 KB
//   of shared memory and at most 255 registers a thread each), so that one
//   block's barriers, softmax and start are covered by the other's FMAs.
//   At DP 256 (gemma3's head dim) the same tile runs one block an SM: the
//   K/V ring alone is 2 x 64 x 256 x 4 = 131 KB, so no query tile lets two
//   blocks share an SM's 227 KB, and 64 query rows (not 32) keep each K/V
//   tile's reuse and the band rules those of DP 64 and 128. A thread's
//   accumulators double to 8 x 16; the ptxas report shows what spills.
//   Blocks run the later (heavier, under a causal mask) query tiles first:
//   blockIdx.y counts the query tiles down, blockIdx.x the heads.
// * KV tiles of 64 positions stream through a ring of two shared-memory
//   slots, one for K and one for V, filled by cp.async straight from device
//   memory (16-byte cp.async.cg where d, strides and pointers allow, else
//   4-byte copies; rows past Sk and columns past d zero-filled by the copy).
//   Each half-step (Q.K^T of tile t, then P.V of tile t) starts with one
//   block barrier and issues the next half-step's copy into the slot the
//   last one freed: two barriers a KV tile, each copy in flight under a
//   half-step of FMAs, V's under Q.K^T. K and V stay row-major, nothing is
//   transposed on the way in.
// * The scaled Q tile (scale applied to q in f32, as the reference does) is
//   read once through registers into shared memory, row-major.
// * A warp owns 16 query rows in both products (the 8-row blocks w and
//   7 - w of the tile, so that every warp has the same work in the causal
//   diagonal tile), a thread 8 of them, so m, l and the accumulators stay
//   in registers and the P tile is private to the warp. Q.K^T: the
//   thread's 8 rows x 4 keys (kg + 16j, kg = lane % 16), d contracted in
//   float4 steps along both operands: a Q float4 feeds 16 FMAs, a K float4
//   32. P.V: 8 rows x 8 output columns (kg*4.. and 64 + kg*4.. at d > 64;
//   8 x 4 at d <= 64): a P float4 and a V float4 feed 32 FMAs each. P is
//   written once (a scalar a score) and read back as float4. Rows are
//   unpadded; Q's, P's and the slots' rows are set apart in groups so that
//   the lanes of a warp read distinct banks.
// * The online softmax follows the reference's order: m_new = max(m, row
//   max), corr = exp(m - m_new), l = l*corr + sum p, acc = acc*corr + P V;
//   the row max and sum reduce over the row's 16 lanes with shuffles, the
//   thread's 8 rows at once.
// * Scores are masked only in KV tiles that straddle the diagonal, a window
//   edge or Sk; interior tiles run unmasked. In a straddling tile a block
//   of 8 rows computes only the key groups that hold a visible key of its
//   rows, and none when they see none of the tile's keys, wherever that
//   changes nothing: its rows have all seen a key before (m > -1e30, so
//   corr = 1 and p = 0 exactly for the keys left out), or, under a causal
//   mask, each sees its own position in the tile. A row whose first tile
//   is wholly masked (a window's first tile) is computed as the reference
//   does: p = 1 until the first visible key makes corr = exp(-1e30 - m_new)
//   = 0. Blocks of rows past Sq compute nothing.
// * KV tiles wholly outside the causal-and-window band of the query tile
//   are never loaded. expf and IEEE division, as the reference.
//
// Two bodies, picked by the caller (kernels/flash_swa.py::_body) from the
// dtype, the head dim, the strides and the pointers alone.
//
// * SIMT (f32; and bf16 that TMA cannot describe: a head dim or a stride
//   that is not a multiple of 8 elements, a pointer off 16 bytes), the
//   kernel flash_swa_tile above. bf16 there is a template on the element
//   type T that follows the TPU kernel's casts: q and k are widened to f32
//   (exact) as they are staged, q scaled in f32 after; scores, the online
//   softmax, l and the PV sums stay f32. P is rounded to bf16 (v's dtype,
//   round to nearest even, kept as f32) where it is written to shared
//   memory, while l sums the unrounded p, as the reference's l_ref does;
//   the output acc / l is rounded to bf16 once. Shared memory and the tiles
//   are f32's: cp.async copies bytes and cannot widen, so bf16 K/V tiles
//   are loaded through registers (8 rows a batch, 8 bytes or one element a
//   copy) into the same f32 slots, and their copies are not asynchronous.
// * tensor-core (bf16 where TMA can describe q, k and v: every bf16
//   prefill attention of serving), the kernel flash_swa_tc. The SIMT body
//   ran bf16 on f32 CUDA cores at 2-5% of the bf16 bound and up to 19x
//   behind SDPA (gemma3's d 256: 2.77 ms against 0.14); the bound is the
//   tensor cores' 989 TFLOP/s (4*d FLOPs a visible pair: gemma3's prefill
//   69 GFLOP, 0.07 ms) or HBM's rate (paper-llama3.2-3b's: 67 MB, 0.02 ms),
//   so both products have to run there, fed without threads. The
//   reference's casts are exactly wgmma's contract: bf16 operands, f32
//   accumulators, P rounded to bf16 before P.V.
//   - One block of one or two warpgroups (64 query rows each) per (b*h,
//     query tile), the later (heavier) query tiles first: two at DP 128
//     and 256, which share every K/V tile, one block an SM; one at DP 64,
//     four blocks an SM (see tc_wgs). No producer warpgroup: with 384
//     threads ptxas held every thread to the launch's 168 registers,
//     setmaxnreg notwithstanding (DP 256's output accumulator alone is 128
//     a thread, and it spilled), and 288 threads (a producer warp) gave the
//     same 168, since warps share the SM's four register files by threes.
//     With 256 threads every thread may take 255.
//   - Thread 0 also issues TMA: the Q tile once, then the K and the V
//     tiles of BKV keys (128 at DP 128, else 64) into two rings of 2
//     stages, K's and V's, each stage's arrival on a `full` mbarrier. A
//     warpgroup releases a stage on its `empty` mbarrier when its products
//     are done with it (K's after Q.K^T, V's after P.V), and thread 0
//     refills it once both have. The maps are 4-D (d, head, position,
//     batch), built on the host per launch from the tensors' strides,
//     64-column boxes with 128-byte swizzle: a GQA head reads its K/V head
//     h / (H / KVH) in place; columns past d and rows past Sk or Sq arrive
//     as TMA's zero fill and are masked; column boxes wholly past d are
//     not loaded (Q's and K's are zeroed once instead: a branch between
//     the products of Q.K^T made ptxas serialise every wgmma).
//   - S = Q.K^T is wgmma m64nBKVk16 from shared memory, Q and K both
//     K-major (as they lie: nothing is transposed), f32. The scale is
//     applied to the f32 scores, s = acc * d^-1/2: rounding q * d^-1/2 to
//     bf16 first would put 2^-9 of relative error on every score. The
//     online softmax runs in the accumulator's fragment (a thread's 2
//     rows, reduced over the quad by shuffles) in the reference's order
//     with expf and IEEE division (l sums the unrounded p, and the
//     exact-rounding probes hold the output bitwise). p is rounded to bf16
//     straight into the A fragment of P.V, wgmma m64nDPk16 with A from
//     registers (the score fragment is the A fragment once pairs are
//     packed) and V N-major through the transpose bit, added to the f32
//     output accumulator.
//   - The products overlap the softmax: a tile's turn issues its Q.K^T,
//     then the previous tile's P.V behind it, and runs its softmax while
//     the tensor cores do that P.V (a second score buffer, to run the
//     next tile's Q.K^T under this tile's softmax as well, does not fit
//     the registers at DP 128; taking turns between the two warpgroups at
//     issuing products, with the producer's refills put off so as not to
//     wait on the other warpgroup, measured slower).
//   - Masking runs only where the warpgroup's rows and the tile straddle
//     the diagonal, a window edge or Sk (interior with the tile's BKV); a
//     warpgroup leaves a loaded tile out where none of its rows is real or,
//     under a causal mask, the tile lies past its last row (tc_skips).
//   - out = acc / max(l, 1e-30), rounded to bf16 once, written into the
//     warpgroup's rows of the Q tile in TMA's layout and stored by TMA
//     (rows past Sq and columns past d clipped), which measured faster than
//     4-byte stores from the fragment.
//   - Every mbarrier wait traps after ~4 s (hopper.cuh) rather than hang.
//   The tensor cores sum each k16 step's products in f32 without rounding
//   as IEEE FMAs do, and the scale follows the product where the plain
//   version scales q first; swa_error_bound's f32 terms hold both, and the
//   probes stay bitwise (chip_smoke.py phase 9). Every sum has a fixed
//   order: two runs are bitwise equal.
//
// Both bodies round p relative to the running max of their KV tiles (64
// or BKV keys), the TPU kernel relative to that of its 256-key blocks, so
// they agree to within the p-rounding term of the wrapper's bound, not
// bitwise.
//
// The band rules (the tile range, the interior test, the SIMT row blocks'
// key groups, the tensor-core warpgroups' skips) are mirrored in Python in
// kernels/flash_swa.py, where the CPU tests hold them against the mask by
// brute force for both bodies' tiles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

// bf16 bit patterns widened to f32 (exact): the element at the lower
// address of a 32-bit word is its low half
__device__ __forceinline__ float4 widen4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float widen1(const bf16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// v rounded to T (P's cast to v's dtype), kept as f32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (kF32<T>)
    return v;
  else
    return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int BQ = 64;   // query rows of a block
constexpr int NT = 128;  // threads of a block: 4 warps, 16 rows each
constexpr int BKV = 64;  // keys of a KV tile
constexpr float kNegInf = -1e30f;

// Shared memory, in floats. Rows are DP floats, unpadded; where the lanes of
// a warp read several rows at one column, the rows are set apart in groups
// instead, so that the reads fall in distinct banks:
// * Q [BQ][DP]: the even rows, then the odd ones from q_half on (4 floats
//   past the even rows);
// * two slots, K and V, of [BKV][DP]: 8 groups of rows by key % 8, k_group
//   apart (4 floats between groups);
// * P [BQ][BKV]: the even rows, then the odd ones from P_HALF on (16 floats
//   past the even rows).
__host__ __device__ constexpr int q_half(int dp) { return BQ / 2 * dp + 4; }
__host__ __device__ constexpr int k_group(int dp) { return 8 * dp + 4; }
__host__ __device__ constexpr int k_slot(int dp) {
  return 8 * k_group(dp) - 4;
}
constexpr int P_HALF = BQ / 2 * BKV + 16;
// 114,992 bytes at d 128: two blocks an SM; 213,296 at d 256: one
constexpr size_t smem_bytes(int dp) {
  return sizeof(float) * ((size_t)(q_half(dp) + BQ / 2 * dp) +
                          2 * (size_t)k_slot(dp) + (P_HALF + BQ / 2 * BKV));
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

// rows [k0, k0 + BKV) of K or V into a ring slot, in groups by row % 8; rows
// past Sk and columns past d are zero-filled. A thread copies rows row0 +
// u * STEP at one column: the source advances by STEP rows a copy, and the
// destination offsets are constants (row0 < STEP or STEP % 8 == 0, so row0
// and u * STEP never carry into each other's group bits).
// A row is COLS copies (float4s or floats); a thread takes PER columns'
// worth of them, CREP passes across the row where a row has more copies
// than the block has threads (the 4-byte copies at DP 256).
template <int DP, bool kVec>
struct RowCopies {
  static constexpr int COLS = kVec ? DP / 4 : DP;
  static constexpr int PER = COLS < NT ? COLS : NT;
  static constexpr int CREP = COLS / PER, STEP = NT / PER;
};

template <int DP, bool kVec>
__device__ __forceinline__ void copy_tile(float* slot,
                                          const float* __restrict__ src,
                                          int64_t stride, int k0, int Sk,
                                          int d) {
  using RC = RowCopies<DP, kVec>;
  constexpr int PER = RC::PER, STEP = RC::STEP;
  static_assert(NT % PER == 0 && RC::COLS % PER == 0 && BKV % STEP == 0 &&
                    (STEP < 8 || STEP % 8 == 0),
                "the copies tile a slot");
  const int row0 = threadIdx.x / PER;
  const int rows_left = Sk - k0 - row0;  // row0 + u * STEP is real below it
#pragma unroll
  for (int cr = 0; cr < RC::CREP; ++cr) {
    const int c = (threadIdx.x % PER + cr * PER) * (kVec ? 4 : 1);
    const bool c_ok = c < d;
    const float* p = src + (int64_t)(k0 + row0) * stride + c;
    float* dst = slot + (row0 & 7) * k_group(DP) + (row0 >> 3) * DP + c;
#pragma unroll
    for (int u = 0; u < BKV / STEP; ++u) {
      const bool ok = c_ok && u * STEP < rows_left;
      float* to =
          dst + ((u * STEP) & 7) * k_group(DP) + ((u * STEP) >> 3) * DP;
      if (kVec)
        cp_async16(to, ok ? p : src, ok ? 16 : 0);
      else
        cp_async4(to, ok ? p : src, ok ? 4 : 0);
      p += STEP * stride;
    }
  }
}

// The same tile from bf16 rows, widened into the f32 slot through
// registers: 8 rows a batch (loads first, then stores), so that a batch's
// loads are in flight together and no more than 8 are held at a time.
template <int DP, bool kVec>
__device__ __forceinline__ void copy_tile(float* slot,
                                          const bf16* __restrict__ src,
                                          int64_t stride, int k0, int Sk,
                                          int d) {
  using RC = RowCopies<DP, kVec>;
  constexpr int PER = RC::PER, STEP = RC::STEP, U = BKV / STEP;
  constexpr int NB = U < 8 ? U : 8;
  static_assert(U % NB == 0, "the batches tile a slot");
  const int row0 = threadIdx.x / PER;
  const int rows_left = Sk - k0 - row0;
#pragma unroll
  for (int cr = 0; cr < RC::CREP; ++cr) {
    const int c = (threadIdx.x % PER + cr * PER) * (kVec ? 4 : 1);
    const bool c_ok = c < d;
    const bf16* p = src + (int64_t)(k0 + row0) * stride + c;
    float* dst = slot + (row0 & 7) * k_group(DP) + (row0 >> 3) * DP + c;
#pragma unroll 1
    for (int u0 = 0; u0 < U; u0 += NB) {
      if constexpr (kVec) {
        uint2 t[NB];
#pragma unroll
        for (int u = 0; u < NB; ++u)
          t[u] = c_ok && (u0 + u) * STEP < rows_left
                     ? __ldg(reinterpret_cast<const uint2*>(
                           p + (int64_t)(u0 + u) * STEP * stride))
                     : make_uint2(0u, 0u);
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          const int uu = (u0 + u) * STEP;
          *reinterpret_cast<float4*>(dst + (uu & 7) * k_group(DP) +
                                     (uu >> 3) * DP) = widen4(t[u]);
        }
      } else {
        float t[NB];
#pragma unroll
        for (int u = 0; u < NB; ++u)
          t[u] = c_ok && (u0 + u) * STEP < rows_left
                     ? widen1(p + (int64_t)(u0 + u) * STEP * stride)
                     : 0.f;
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          const int uu = (u0 + u) * STEP;
          dst[(uu & 7) * k_group(DP) + (uu >> 3) * DP] = t[u];
        }
      }
    }
  }
}

// Q's row `row` = q[q0 + row] * scale (even rows, then odd ones), zeros past
// Sq or d
template <typename T, int DP, bool kVec>
__device__ __forceinline__ void load_q(float* Qs, const T* __restrict__ q,
                                       int64_t stride, int q0, int Sq, int d,
                                       float scale) {
  using RC = RowCopies<DP, kVec>;
  constexpr int PER = RC::PER, STEP = RC::STEP;
  static_assert(NT % PER == 0 && BQ % STEP == 0, "the loads tile Q");
#pragma unroll
  for (int cr = 0; cr < RC::CREP; ++cr) {
    const int c = (threadIdx.x % PER + cr * PER) * (kVec ? 4 : 1);
#pragma unroll
    for (int u = 0; u < BQ / STEP; ++u) {
      const int row = threadIdx.x / PER + u * STEP;
      const bool ok = q0 + row < Sq && c < d;
      const T* p = q + (int64_t)(q0 + row) * stride + c;
      float* dst = Qs + (row & 1) * q_half(DP) + (row >> 1) * DP + c;
      if constexpr (kF32<T>) {
        if (kVec) {
          float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
          if (ok) t = *reinterpret_cast<const float4*>(p);
          t.x *= scale; t.y *= scale; t.z *= scale; t.w *= scale;
          *reinterpret_cast<float4*>(dst) = t;
        } else {
          *dst = ok ? *p * scale : 0.f;
        }
      } else if (kVec) {  // 4 bf16, widened, then scaled in f32
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok) t = widen4(__ldg(reinterpret_cast<const uint2*>(p)));
        t.x *= scale; t.y *= scale; t.z *= scale; t.w *= scale;
        *reinterpret_cast<float4*>(dst) = t;
      } else {
        *dst = ok ? widen1(p) * scale : 0.f;
      }
    }
  }
}

// The band rules (mirrored by _kv_band, _interior, _rows_masked and
// _key_groups in kernels/flash_swa.py). The query rows [q0, q_last] (q_last
// the last real row) see the keys [key_lo, key_hi] and no others, each of
// them from at least one row; the block loads their tiles, none if the
// range is empty.
__device__ __forceinline__ int key_lo(int q0, int window) {
  return window > 0 ? max(0, q0 - window + 1) : 0;
}

__device__ __forceinline__ int key_hi(int q_last, int Sk, int causal) {
  return causal ? min(q_last, Sk - 1) : Sk - 1;
}

// every (row, key) pair of rows [q0, q_last] x keys [k0, k0 + bkv) visible
__device__ __forceinline__ bool interior(int q0, int q_last, int k0, int Sk,
                                         int causal, int window,
                                         int bkv = BKV) {
  return k0 + bkv <= Sk && (!causal || k0 + bkv - 1 <= q0) &&
         (window <= 0 || q_last - k0 < window);
}

// no row of [r0, r0 + 8) sees a key of [k0, k0 + BKV) (k0 < Sk)
__device__ __forceinline__ bool rows_masked(int r0, int k0, int Sk,
                                            int causal, int window) {
  return (causal && k0 > r0 + 7) ||
         (window > 0 && r0 - min(k0 + BKV - 1, Sk - 1) >= window);
}

// The key groups kg + 16j, j < result, that the 8 rows [r0, r0 + 8) compute
// in a tile. Rows past Sq compute none. In a masked tile, rows that have
// all seen a key before (seen: m > -1e30, so corr = 1 and p = 0 for masked
// keys) skip the tile when they see none of its keys; under a causal mask
// the groups past their last row are left out where that changes nothing,
// because they have seen a key or each sees its own position in the tile.
__device__ __forceinline__ int key_groups(int r0, int k0, int Sq, int Sk,
                                          int causal, int window, bool masked,
                                          bool seen) {
  if (r0 >= Sq) return 0;
  if (!masked) return 4;
  if (seen && rows_masked(r0, k0, Sk, causal, window)) return 0;
  if (causal && (seen || (k0 <= r0 && r0 + 7 < min(k0 + BKV, Sk))))
    return min(4, (r0 + 7 - k0) / 16 + 1);
  return 4;
}

// The thread's 8 rows are two blocks of 4 (rows rg + 2r' of a block of 8
// query rows), at qa and qb in the Q tile (pa and pb in the P tile).

// s[R0 + r][j], r < R: Q row R0 + r . K key kg + 16j (kr at key kg) for the
// first NJ key groups; -1e30 for the others. d is contracted in float4
// steps: a Q float4 feeds 4 NJ FMAs (16 in a whole tile), a K float4 4 R.
template <int R0, int R, int NJ, int DP>
__device__ __forceinline__ void scores(float (&s)[8][4],
                                       const float* __restrict__ qa,
                                       const float* __restrict__ qb,
                                       const float* __restrict__ kr) {
#pragma unroll
  for (int r = R0; r < R0 + R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[r][j] = j < NJ ? 0.f : kNegInf;
  if constexpr (NJ > 0) {
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 kf[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        kf[j] = *reinterpret_cast<const float4*>(kr + 2 * j * DP + c);
#pragma unroll
      for (int r = R0; r < R0 + R; ++r) {
        const float4 qf = *reinterpret_cast<const float4*>(
            (r < 4 ? qa : qb) + (r & 3) * DP + c);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[r][j] = fmaf(qf.x, kf[j].x, s[r][j]);
          s[r][j] = fmaf(qf.y, kf[j].y, s[r][j]);
          s[r][j] = fmaf(qf.z, kf[j].z, s[r][j]);
          s[r][j] = fmaf(qf.w, kf[j].w, s[r][j]);
        }
      }
    }
  }
}

// scores<R0, 4, nj> of one block of 4 rows (R0 0 or 4), nj in 0..4
template <int R0, int DP>
__device__ __forceinline__ void scores_half(int nj, float (&s)[8][4],
                                            const float* qa, const float* qb,
                                            const float* kr) {
  switch (nj) {
    case 0: scores<R0, 4, 0, DP>(s, qa, qb, kr); break;
    case 1: scores<R0, 4, 1, DP>(s, qa, qb, kr); break;
    case 2: scores<R0, 4, 2, DP>(s, qa, qb, kr); break;
    case 3: scores<R0, 4, 3, DP>(s, qa, qb, kr); break;
    default: scores<R0, 4, 4, DP>(s, qa, qb, kr);
  }
}

// acc[R0 + r] += P row R0 + r . V over keys [0, keys), r < R, 4 CH columns
// (kg*4.. and 64 + kg*4..): a P float4 feeds 16 CH FMAs, a V float4 4 R.
template <int R0, int R, int CH, int DP>
__device__ __forceinline__ void pv(float (&acc)[8][4 * CH],
                                   const float* __restrict__ pa,
                                   const float* __restrict__ pb,
                                   const float* __restrict__ slot, int kg,
                                   int keys) {
#pragma unroll 2
  for (int j = 0; j < keys; j += 4) {
    // V rows j.. j + 3 lie k_group apart (j % 8 is 0 or 4)
    const float* vr = slot + (j & 7) * k_group(DP) + (j >> 3) * DP + kg * 4;
    float4 pf[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      pf[r] = *reinterpret_cast<const float4*>(
          (R0 + r < 4 ? pa : pb) + ((R0 + r) & 3) * BKV + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) {
        const float4 vf =
            *reinterpret_cast<const float4*>(vr + jj * k_group(DP) + 64 * ch);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = jj == 0   ? pf[r].x
                          : jj == 1 ? pf[r].y
                          : jj == 2 ? pf[r].z
                                    : pf[r].w;
          float* a = acc[R0 + r] + 4 * ch;
          a[0] = fmaf(p, vf.x, a[0]);
          a[1] = fmaf(p, vf.y, a[1]);
          a[2] = fmaf(p, vf.z, a[2]);
          a[3] = fmaf(p, vf.w, a[3]);
        }
      }
    }
  }
}

// Blocks an SM: two at DP 64 and 128; at DP 256 the Q tile, the K/V ring
// and P take 213,296 bytes of shared memory, so one.
__host__ __device__ constexpr int blocks_per_sm(int dp) {
  return dp > 128 ? 1 : 2;
}

template <typename T, int DP, bool kVec>
__global__ void __launch_bounds__(NT, blocks_per_sm(DP))
    flash_swa_tile(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int H,
                   int KVH, int Sq, int Sk, int d, int64_t qsb, int64_t qss,
                   int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                   int64_t vsb, int64_t vss, int64_t vsh, int64_t osb,
                   int64_t oss, int64_t osh, int causal, int window,
                   float scale) {
  constexpr int CH = DP / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // scaled q
  float* ring = Qs + q_half(DP) + BQ / 2 * DP;  // the K slot, then V's
  float* Ps = ring + 2 * k_slot(DP);            // the warp's rows are its own

  // warp w owns the 8-row blocks w and BQ/8 - 1 - w of the query tile, so
  // that under a causal mask every warp has the same work in the diagonal
  // tile; the thread's rows there are rg + 2r', r' < 4
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int rg = lane >> 4, kg = lane & 15;
  const int ba = w, bb = BQ / 8 - 1 - w;
  const int bh = blockIdx.x, bi = bh / H, h = bh - bi * H;
  const int kh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* qb = q + bi * qsb + h * qsh;
  const T* kb = k + bi * ksb + kh * ksh;
  const T* vb = v + bi * vsb + kh * vsh;
  const float* Qa = Qs + rg * q_half(DP) + 4 * ba * DP;
  const float* Qb = Qs + rg * q_half(DP) + 4 * bb * DP;
  float* Pa = Ps + rg * P_HALF + 4 * ba * BKV;
  float* Pb = Ps + rg * P_HALF + 4 * bb * BKV;
  auto row = [&](int r) {
    return (r < 4 ? 8 * ba : 8 * bb) + rg + 2 * (r & 3);
  };

  const int q_last = min(q0 + BQ - 1, Sq - 1);
  const int lo = key_lo(q0, window), hi = key_hi(q_last, Sk, causal);
  const int kt_lo = lo / BKV;
  // half-steps: K of tile kt_lo, V of it, K of the next, ...
  const int steps = lo <= hi ? 2 * (hi / BKV - kt_lo + 1) : 0;
  auto issue = [&](int i) {  // half-step i's tile into its slot
    const int k0 = (kt_lo + (i >> 1)) * BKV;
    if (i & 1)
      copy_tile<DP, kVec>(ring + k_slot(DP), vb, vss, k0, Sk, d);
    else
      copy_tile<DP, kVec>(ring, kb, kss, k0, Sk, d);
  };
  if (steps > 0) issue(0);
  cp_async_commit();
  load_q<T, DP, kVec>(Qs, qb, qss, q0, Sq, d, scale);

  float m_i[8], l_i[8], acc[8][4 * CH];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CH; ++c) acc[i][c] = 0.f;
  }

  // the key groups of the current KV tile that the thread's two row blocks
  // compute (0 for both: the warp sits the tile out)
  int nja = 4, njb = 4;
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<0>();  // this thread's copies of half-step i landed
    __syncthreads();     // everyone's; and half-step i - 1 is done with the
                         // slot that half-step i + 1 fills
    if (i + 1 < steps) issue(i + 1);
    cp_async_commit();
    const int k0 = (kt_lo + (i >> 1)) * BKV;
    const float* slot = ring + (i & 1) * k_slot(DP);

    if ((i & 1) == 0) {
      // ---- S = Q K^T on the thread's 8 rows x 4 keys, then the softmax
      const bool masked = !interior(q0, q_last, k0, Sk, causal, window);
      bool seen = true;
#pragma unroll
      for (int r = 0; r < 8; ++r)
        seen = seen && (q0 + row(r) >= Sq || m_i[r] > kNegInf);
      seen = __all_sync(0xffffffffu, seen);
      nja = key_groups(q0 + 8 * ba, k0, Sq, Sk, causal, window, masked, seen);
      njb = key_groups(q0 + 8 * bb, k0, Sq, Sk, causal, window, masked, seen);
      if (nja == 0 && njb == 0) continue;

      float s[8][4];
      // key kg + 16j of K: group kg % 8, row kg / 8 + 2j of it
      const float* kr = slot + (kg & 7) * k_group(DP) + (kg >> 3) * DP;
      if (nja == 4 && njb == 4) {
        scores<0, 8, 4, DP>(s, Qa, Qb, kr);
      } else {
        scores_half<0, DP>(nja, s, Qa, Qb, kr);
        scores_half<4, DP>(njb, s, Qa, Qb, kr);
      }

      // the online softmax, each step over the 8 rows at once so that their
      // shuffle and exp latencies overlap
      if (masked) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int qpos = q0 + row(r);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kpos = k0 + kg + 16 * j;
            bool ok = kpos < Sk;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && qpos - kpos < window;
            if (!ok) s[r][j] = kNegInf;
          }
        }
      }
      float red[8], corr[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        red[r] = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) red[r] = fmaxf(red[r], s[r][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < 8; ++r)
          red[r] = fmaxf(red[r], __shfl_xor_sync(0xffffffffu, red[r], off));
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float m_new = fmaxf(m_i[r], red[r]);
        corr[r] = expf(m_i[r] - m_new);
        m_i[r] = m_new;
        red[r] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[r][j] = expf(s[r][j] - m_new);
          red[r] += s[r][j];
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < 8; ++r)
          red[r] += __shfl_xor_sync(0xffffffffu, red[r], off);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        l_i[r] = l_i[r] * corr[r] + red[r];
#pragma unroll
        for (int c = 0; c < 4 * CH; ++c) acc[r][c] *= corr[r];
        // P in v's dtype (bf16: rounded; l above summed it unrounded)
        float* pr = (r < 4 ? Pa : Pb) + (r & 3) * BKV + kg;
#pragma unroll
        for (int j = 0; j < 4; ++j) pr[16 * j] = round_to<T>(s[r][j]);
      }
    } else if (nja == 4 && njb == 4) {
      // ---- acc += P V on the thread's 8 rows x 4*CH columns
      pv<0, 8, CH, DP>(acc, Pa, Pb, slot, kg, BKV);
    } else {
      // ---- the same on each row block over the keys of its groups (p = 0
      // past them)
      if (nja) pv<0, 4, CH, DP>(acc, Pa, Pb, slot, kg, 16 * nja);
      if (njb) pv<4, 4, CH, DP>(acc, Pa, Pb, slot, kg, 16 * njb);
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int qrow = q0 + row(r);
    if (qrow >= Sq) continue;
    const float l = fmaxf(l_i[r], 1e-30f);
    T* out = o + bi * osb + h * osh + (int64_t)qrow * oss;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int col = 64 * ch + kg * 4;
      const float* a = acc[r] + 4 * ch;
      if constexpr (kF32<T>) {
        if (kVec) {
          if (col < d)
            *reinterpret_cast<float4*>(out + col) =
                make_float4(a[0] / l, a[1] / l, a[2] / l, a[3] / l);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (col + c < d) out[col + c] = a[c] / l;
        }
      } else if (kVec) {  // 4 bf16 in one 8-byte store
        if (col < d) {
          unsigned short e[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            e[c] = __bfloat16_as_ushort(__float2bfloat16_rn(a[c] / l));
          *reinterpret_cast<uint2*>(out + col) =
              make_uint2(e[0] | ((unsigned)e[1] << 16),
                         e[2] | ((unsigned)e[3] << 16));
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < d) out[col + c] = __float2bfloat16_rn(a[c] / l);
      }
    }
  }
}

// ------------------------------------------------------------ tensor-core
// bf16 where TMA can describe q, k and v (head dim a multiple of 8, every
// stride a multiple of 8 elements, 16-byte aligned pointers). Shared
// memory, from a 1024-byte aligned base: the Q tile (DP / 64 boxes of 128
// rows x 64 columns), TC_STAGES K tiles, TC_STAGES V tiles (each DP / 64
// boxes of BKV rows x 64 columns), all 128-byte swizzled as TMA writes
// them; then the mbarriers (Q's, then K's full[s] and empty[s], V's).
constexpr int TC_STAGES = 2;  // K tiles in their ring, V tiles in theirs

// The tile at each DP, chosen from timings of the alternatives on an H100
// (PERF.md): warpgroups of a block (64 query rows each), keys of a KV
// tile, blocks an SM. DP 128 and 256: two warpgroups, which share every
// K/V tile, one block an SM; 128 keys at DP 128 (faster than 64 at long
// S), 64 at DP 256, where the output accumulator alone takes 128
// registers a thread and a 128-key stage 128 KB. DP 64: one warpgroup and
// 64 keys, four blocks an SM (128 registers a thread), so that blocks'
// starts and ends run under other blocks' products (faster than one or two
// blocks of 128 keys). A thread holds DP / 2 + BKV / 2 + BKV / 4
// registers of operands: 176 at DP 256, 160 at 128, 80 at 64.
__host__ __device__ constexpr int tc_wgs(int dp) { return dp > 64 ? 2 : 1; }
__host__ __device__ constexpr int tc_bq(int dp) { return 64 * tc_wgs(dp); }
__host__ __device__ constexpr int tc_blocks(int dp) { return dp > 64 ? 1 : 4; }
__host__ __device__ constexpr int tc_bkv(int dp) { return dp == 128 ? 128 : 64; }
__host__ __device__ constexpr int tc_q_bytes(int dp) { return tc_bq(dp) * dp * 2; }
__host__ __device__ constexpr int tc_kv_bytes(int dp) {  // K's or V's tile
  return tc_bkv(dp) * dp * 2;
}
__host__ __device__ constexpr size_t tc_smem(int dp) {
  return 1024 + (size_t)tc_q_bytes(dp) +
         (size_t)TC_STAGES * 2 * tc_kv_bytes(dp) + (1 + 4 * TC_STAGES) * 8;
}
// 42,056 bytes at DP 64, 164,936 at 128, 197,704 at 256
static_assert(tc_smem(128) <= 232448 && tc_smem(256) <= 232448 &&
                  tc_blocks(64) * (tc_smem(64) + 1024) <= 233472,
              "the blocks fit an SM's shared memory");

// A warpgroup (query rows [r0, r_last], r_last the last real one) leaves
// a loaded KV tile out: none of its rows is real, or under a causal mask
// the tile lies past its last row. Its rows have then each seen a visible
// key in an earlier tile (their own position comes first), so computing
// the tile would change nothing: corr = 1, p = 0. The tiles it computes
// are a prefix of the block's.
__device__ __forceinline__ bool tc_skips(int r0, int r_last, int k0, int Sq,
                                         int causal) {
  return r0 >= Sq || (causal && k0 > r_last);
}

// two f32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DP>
__global__ void __launch_bounds__(128 * tc_wgs(DP), tc_blocks(DP))
    flash_swa_tc(const __grid_constant__ CUtensorMap tmq,
                 const __grid_constant__ CUtensorMap tmk,
                 const __grid_constant__ CUtensorMap tmv,
                 const __grid_constant__ CUtensorMap tmo, int H, int KVH,
                 int Sq, int Sk, int d, int causal, int window,
                 float scale) {
  constexpr int BQ = tc_bq(DP), WGS = tc_wgs(DP);
  constexpr int BK = tc_bkv(DP), S = TC_STAGES;
  constexpr int QB = tc_q_bytes(DP), KB = tc_kv_bytes(DP);
  constexpr int NS = BK / 2, NO = DP / 2;  // score and output registers
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const gq = smem_raw + (q_s - smem_u32(smem_raw));
  const uint32_t k_s = q_s + QB, v_s = k_s + S * KB;  // stage s at + s KB
  const uint32_t qbar = v_s + S * KB;
  const uint32_t kfull = qbar + 8, kempty = kfull + 8 * S;
  const uint32_t vfull = kempty + 8 * S, vempty = vfull + 8 * S;

  const int bh = blockIdx.x, bi = bh / H, h = bh - bi * H;
  const int kh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int q_last = min(q0 + BQ - 1, Sq - 1);
  const int lo = key_lo(q0, window), hi = key_hi(q_last, Sk, causal);
  const int kt_lo = lo / BK;
  const int tiles = lo <= hi ? hi / BK - kt_lo + 1 : 0;
  const int nc = (d + 63) / 64;  // column boxes that hold real columns
  const uint32_t tile_bytes = nc * BK * 128;  // a K or a V tile's

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const bool lead = (tid & 127) == 0;  // arrives for its warpgroup
  const bool producer = tid == 0;      // and issues every TMA load
  // Q's and K's column boxes wholly past d are never loaded: zeros, so that
  // Q.K^T runs over every box of DP without a branch between its products
  // (a branch there makes ptxas serialise them)
  for (int c = nc; c < DP / 64; ++c) {
    for (int i = tid; i < BQ * 32; i += 128 * WGS)
      reinterpret_cast<uint32_t*>(gq + c * BQ * 128)[i] = 0u;
    for (int s = 0; s < S; ++s)
      for (int i = tid; i < BK * 32; i += 128 * WGS)
        reinterpret_cast<uint32_t*>(gq + QB + s * KB + c * BK * 128)[i] = 0u;
  }
  fence_async_smem();
  if (producer) {
    mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(kfull + 8 * s, 1);   // the producer's expect_tx
      mbar_init(kempty + 8 * s, WGS);  // one arrival a warpgroup
      mbar_init(vfull + 8 * s, 1);
      mbar_init(vempty + 8 * s, WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // K's (V's) tile t into its stage, its bytes counted on the stage's full
  // barrier
  auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full,
                  int t) {
    const int s = t % S, k0 = (kt_lo + t) * BK;
    mbar_expect_tx(full + 8 * s, tile_bytes);
    for (int c = 0; c < nc; ++c)
      tma_load_4d(ring + s * KB + c * BK * 128, map, 64 * c, kh, k0, bi,
                  full + 8 * s);
  };
  if (producer) {
    mbar_expect_tx(qbar, nc * BQ * 128);
    for (int c = 0; c < nc; ++c)
      tma_load_4d(q_s + c * BQ * 128, &tmq, 64 * c, h, q0, bi, qbar);
    for (int t = 0; t < min(S, tiles); ++t) {
      load(&tmk, k_s, kfull, t);
      load(&tmv, v_s, vfull, t);
    }
  }
  // the warpgroup is done with the K (V) tile t: its lead arrives on the
  // stage's empty barrier, and the producer refills the stage with tile
  // t + S once both warpgroups have
  auto release = [&](const CUtensorMap* map, uint32_t ring, uint32_t full,
                     uint32_t empty, int t) {
    const int s = t % S;
    if (lead) mbar_arrive(empty + 8 * s);
    if (producer && t + S < tiles) {
      mbar_wait(empty + 8 * s, (t / S) & 1);
      load(map, ring, full, t + S);
    }
  };

  const int r0 = q0 + 64 * wg, r_last = min(r0 + 63, Sq - 1);
  int n = 0;  // the tiles the warpgroup computes: a prefix of the block's
  while (n < tiles && !tc_skips(r0, r_last, (kt_lo + n) * BK, Sq, causal))
    ++n;
  // the accumulators' fragment: register 4j + 2hh + c holds row fr + 8 hh
  // of the warpgroup's 64, column 8j + fc + c
  const int fr = ((tid & 127) >> 5) * 16 + (lane >> 2), fc = (lane & 3) * 2;
  const uint32_t qa = q_s + 64 * wg * 128;  // the warpgroup's Q rows
  float acc[NO], sc[NS], m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  float corr[2] = {1.f, 1.f};
  uint32_t pa[BK / 16][4];  // P's A fragment, one k16 step a row
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = 0u;
  mbar_wait(qbar, 0);

  // S(t) = Q K(t)^T into sc (f32), d contracted over DP (boxes past d hold
  // zeros); issued and committed, not waited for
  auto scores = [&](int t) {
    const int s = t % S;
    mbar_wait(kfull + 8 * s, (t / S) & 1);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < DP / 64; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_kk<BK>(sc, sw128_desc(qa + c * BQ * 128 + kk * 32, 16),
                     sw128_desc(k_s + s * KB + c * BK * 128 + kk * 32, 16),
                     c | kk);
    }
    wgmma_commit();
  };
  // the online softmax of tile t on the thread's 2 rows, S(t) in sc, the
  // reference's order: s = acc d^-1/2 in f32, m_new = max(m, row max),
  // corr = exp(m - m_new), p = exp(s - m_new) (in sc), l = l corr + sum p
  auto softmax = [&](int t) {
    const int k0 = (kt_lo + t) * BK;
    const bool masked = !interior(r0, r_last, k0, Sk, causal, window, BK);
    // the visible keys of the thread's row hh in the tile are its columns
    // 8j + c in [lo[hh], hi[hh]], one compare each with j and c unrolled
    // (at DP 64, whose 128 registers a thread leave the compiler less room,
    // each key's position is tested against the mask instead, which
    // measured faster there and slower at DP 128 and 256)
    int lo[2], hi[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qpos = r0 + fr + 8 * hh;
      hi[hh] = (causal ? min(qpos, Sk - 1) : Sk - 1) - k0 - fc;
      lo[hh] = window > 0 ? qpos - window + 1 - k0 - fc : -BK;
    }
    float red[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& v = sc[4 * j + 2 * hh + c];
          v = __fmul_rn(v, scale);
          if (masked) {
            const int col = 8 * j + c;
            bool ok;
            if constexpr (DP == 64) {
              const int qpos = r0 + fr + 8 * hh, kpos = k0 + fc + col;
              ok = kpos < Sk;
              if (causal) ok = ok && kpos <= qpos;
              if (window > 0) ok = ok && qpos - kpos < window;
            } else {
              ok = col <= hi[hh] && col >= lo[hh];
            }
            if (!ok) v = kNegInf;
          }
          red[hh] = fmaxf(red[hh], v);
        }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      red[hh] = fmaxf(red[hh], __shfl_xor_sync(0xffffffffu, red[hh], 1));
      red[hh] = fmaxf(red[hh], __shfl_xor_sync(0xffffffffu, red[hh], 2));
      const float m_new = fmaxf(m_i[hh], red[hh]);
      corr[hh] = expf(m_i[hh] - m_new);
      m_i[hh] = m_new;
      red[hh] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& v = sc[4 * j + 2 * hh + c];
          v = expf(v - m_i[hh]);
          red[hh] += v;
        }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      red[hh] += __shfl_xor_sync(0xffffffffu, red[hh], 1);
      red[hh] += __shfl_xor_sync(0xffffffffu, red[hh], 2);
      l_i[hh] = __fadd_rn(__fmul_rn(l_i[hh], corr[hh]), red[hh]);
    }
  };
  // p rounded to bf16 (v's dtype) straight into P's A fragment: the score
  // fragment's layout, pairs packed
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
  };
  // acc = acc corr + P(t) V(t), V N-major through the transpose bit;
  // issued and committed, not waited for
  auto pv = [&](int t) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * j + i] *= corr[i >> 1];
    const int s = t % S;
    mbar_wait(vfull + 8 * s, (t / S) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DP>(acc, pa[kk],
                   sw128_desc(v_s + s * KB + kk * 16 * 128, BK * 128));
    wgmma_commit();
    fence_regs(acc);
  };

  // Tile t's turn: Q.K^T of tile t, then P.V of tile t - 1 queued behind
  // it; tile t's softmax runs while the tensor cores do that P.V.
  if (n > 0) {
    scores(0);
    wgmma_wait<0>();
    fence_regs(sc);
    release(&tmk, k_s, kfull, kempty, 0);
    softmax(0);
    pack();
  }
  for (int t = 1; t < n; ++t) {
    scores(t);
    pv(t - 1);
    wgmma_wait<1>();  // S(t) is done: K's stage goes back
    fence_regs(sc);
    release(&tmk, k_s, kfull, kempty, t);
    softmax(t);
    wgmma_wait<0>();  // P.V of tile t - 1 is done: V's stage goes back
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
    release(&tmv, v_s, vfull, vempty, t - 1);
    pack();
  }
  if (n > 0) {
    pv(n - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    release(&tmv, v_s, vfull, vempty, n - 1);
  }
  for (int t = n; t < tiles; ++t) {  // tiles left out: waited and released
    mbar_wait(kfull + 8 * (t % S), (t / S) & 1);
    release(&tmk, k_s, kfull, kempty, t);
    mbar_wait(vfull + 8 * (t % S), (t / S) & 1);
    release(&tmv, v_s, vfull, vempty, t);
  }

  // ---- out = acc / max(l, 1e-30), rounded to bf16 once, into the
  // warpgroup's rows of the Q tile (which no product reads any more) in
  // TMA's swizzled layout, then stored by TMA: rows past Sq and columns
  // past d are clipped
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float l = fmaxf(l_i[hh], 1e-30f);
    const int row = 64 * wg + fr + 8 * hh;  // in the Q tile
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + fc;
      *reinterpret_cast<uint32_t*>(gq + (col >> 6) * BQ * 128 +
                                   sw128_offset(row, col & 63)) =
          pack_bf16(__fdiv_rn(acc[4 * j + 2 * hh], l),
                    __fdiv_rn(acc[4 * j + 2 * hh + 1], l));
    }
  }
  fence_async_smem();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (lead && r0 < Sq) {
    for (int c = 0; c < nc; ++c)
      tma_store_4d(&tmo, q_s + c * BQ * 128 + 64 * wg * 128, 64 * c, h, r0,
                   bi);
    bulk_commit();
    bulk_wait_read();
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
  // all of the SM's 228 KB as shared memory: two blocks fit an SM at DP
  // <= 128, one at DP 256
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kKernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kDevices) granted[dev] = (int)bytes;
  return err;
}

template <typename T, int DP, bool kVec>
cudaError_t launch(const T* q, const T* k, const T* v, T* o, int B, int H,
                   int KVH, int Sq, int Sk, int d, const int64_t* st,
                   int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(DP);
  cudaError_t err = allow_smem<flash_swa_tile<T, DP, kVec>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_swa_tile<T, DP, kVec><<<grid, NT, smem, stream>>>(
      q, k, v, o, H, KVH, Sq, Sk, d, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], causal, window, scale);
  return cudaGetLastError();
}

// q, k or v, (batch, position, head) element strides sb, ss, sh with a
// contiguous last dim, as a 4-D TMA map (d, head, position, batch) of
// 64-column x box_rows boxes, 128-byte swizzled, zero-filled past d and
// past the positions; the caller promises a 16-byte aligned p and strides
// that are multiples of 8 elements wherever the dimension has more than
// one index (a dimension of one index gets a stride of whole 16 bytes)
cudaError_t bf16_map4(CUtensorMap* map, const bf16* p, int d, int heads,
                      int rows, int batch, int64_t sh, int64_t ss,
                      int64_t sb, int box_rows) {
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t packed = (cuuint64_t)((d * 2 + 15) / 16 * 16);
  auto bytes = [&](int64_t st, int n) {
    return n == 1 ? packed : (cuuint64_t)st * sizeof(bf16);
  };
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {bytes(sh, heads), bytes(ss, rows),
                                 bytes(sb, batch)};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the tensor-core body: q's, k's and v's maps, then one grid
template <int DP>
cudaError_t launch_tc(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                      int B, int H, int KVH, int Sq, int Sk, int d,
                      const int64_t* st, int causal, int window, float scale,
                      cudaStream_t stream) {
  CUtensorMap tmq, tmk, tmv, tmo;
  cudaError_t err;
  if ((err = bf16_map4(&tmq, q, d, H, Sq, B, st[2], st[1], st[0],
                       tc_bq(DP))) !=
      cudaSuccess)
    return err;
  if ((err = bf16_map4(&tmk, k, d, KVH, Sk, B, st[5], st[4], st[3],
                       tc_bkv(DP))) != cudaSuccess)
    return err;
  if ((err = bf16_map4(&tmv, v, d, KVH, Sk, B, st[8], st[7], st[6],
                       tc_bkv(DP))) != cudaSuccess)
    return err;
  if ((err = bf16_map4(&tmo, o, d, H, Sq, B, st[11], st[10], st[9], 64)) !=
      cudaSuccess)
    return err;
  constexpr size_t smem = tc_smem(DP);
  if ((err = allow_smem<flash_swa_tc<DP>>(smem)) != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + tc_bq(DP) - 1) / tc_bq(DP));
  flash_swa_tc<DP><<<grid, 128 * tc_wgs(DP), smem, stream>>>(
      tmq, tmk, tmv, tmo, H, KVH, Sq, Sk, d, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const T* q, const T* k, const T* v, T* o, int B, int H,
                int KVH, int Sq, int Sk, int d, const int64_t* strides,
                int causal, int window, float scale, int vec,
                cudaStream_t s) {
  const int dp = d <= 64 ? 64 : d <= 128 ? 128 : 256;
#define FLASH_SWA_LAUNCH(DP)                                                  \
  (vec ? launch<T, DP, true>(q, k, v, o, B, H, KVH, Sq, Sk, d, strides,      \
                             causal, window, scale, s)                       \
       : launch<T, DP, false>(q, k, v, o, B, H, KVH, Sq, Sk, d, strides,     \
                              causal, window, scale, s))
  const cudaError_t err = dp == 64    ? FLASH_SWA_LAUNCH(64)
                          : dp == 128 ? FLASH_SWA_LAUNCH(128)
                                      : FLASH_SWA_LAUNCH(256);
#undef FLASH_SWA_LAUNCH
  return err;
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 = launched). q, k, v, o
// are float (is_bf16 == 0) or __nv_bfloat16 (is_bf16 != 0). `strides`
// holds 12 int64: (batch, position, head) strides of q, k, v and o, in
// elements. d <= 256, H % KVH == 0. vec == 1 promises d % 4 == 0, every
// stride % 4 == 0 and 16-byte (f32) or 8-byte (bf16) aligned pointers: the
// SIMT body's vector copies. vec == 2 (bf16 only) takes the tensor-core
// body: it promises d % 8 == 0, every stride of a dimension with more than
// one index % 8 == 0, 16-byte aligned q, k, v and a 4-byte aligned o.
// `smem` is the dynamic shared memory in bytes that the caller computed
// for the launch: it must equal this file's smem_bytes (SIMT, either
// dtype) or tc_smem (tensor-core) at the padded head dim (64, 128 or 256).
extern "C" int flash_swa_launch(const void* q, const void* k, const void* v,
                                void* o, int B, int H, int KVH, int Sq,
                                int Sk, int d, const int64_t* strides,
                                int causal, int window, float scale, int vec,
                                int smem, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  const int dp = d <= 64 ? 64 : d <= 128 ? 128 : 256;
  const bool tc = vec == 2;
  if (Sk <= 0 || d <= 0 || d > 256 || KVH <= 0 || H % KVH != 0 ||
      B * H > 65535 || (Sq + BQ - 1) / BQ > 65535 ||
      (tc && (!is_bf16 || d % 8 != 0)) ||
      (size_t)smem != (tc ? tc_smem(dp) : smem_bytes(dp)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    const bf16 *bq = static_cast<const bf16*>(q),
               *bk = static_cast<const bf16*>(k),
               *bv = static_cast<const bf16*>(v);
    bf16* bo = static_cast<bf16*>(o);
    return (int)(dp == 64 ? launch_tc<64>(bq, bk, bv, bo, B, H, KVH, Sq, Sk,
                                          d, strides, causal, window, scale,
                                          s)
                 : dp == 128
                     ? launch_tc<128>(bq, bk, bv, bo, B, H, KVH, Sq, Sk, d,
                                      strides, causal, window, scale, s)
                     : launch_tc<256>(bq, bk, bv, bo, B, H, KVH, Sq, Sk, d,
                                      strides, causal, window, scale, s));
  }
  if (is_bf16)
    return (int)run(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(o), B, H,
                    KVH, Sq, Sk, d, strides, causal, window, scale, vec, s);
  return (int)run(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o), B, H,
                  KVH, Sq, Sk, d, strides, causal, window, scale, vec, s);
}
