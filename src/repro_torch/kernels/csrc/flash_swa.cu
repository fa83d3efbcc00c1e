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
// Bound on the card: operations, 4*d FLOPs per visible (query, key) pair
// (prefill at B 8, H 24, S 512, d 128, causal: 12.9 GFLOP, 0.19 ms at
// 67 TFLOP/s), IEEE f32 FMAs on CUDA cores (TF32 stays off). The bytes (q,
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
// bf16 (the reference's serving dtype): the kernel is a template on the
// element type T, and follows the TPU kernel's casts. q and k are widened
// to f32 (exact) as they are staged, q scaled in f32 after; scores, the
// online softmax, l and the PV sums stay f32. P is rounded to bf16 (v's
// dtype, round to nearest even, kept as f32) where it is written to shared
// memory, while l sums the unrounded p, as the reference's l_ref does; the
// output acc / l is rounded to bf16 once. Shared memory and the tiles are
// f32's: cp.async copies bytes and cannot widen, so bf16 K/V tiles are
// loaded through registers (8 rows a batch, 8 bytes or one element a
// copy) into the same f32 slots, and their copies are not asynchronous.
// The TPU kernel rounds p relative to the running max of its 256-key
// blocks, this one relative to that of its 64-key tiles, so the two agree
// to within the p-rounding term of the wrapper's bound, not bitwise.
//
// The band rules (the tile range, the interior test and the row blocks'
// key groups) are mirrored in Python in kernels/flash_swa.py, where the CPU
// tests hold them against the mask by brute force.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

// every (row, key) pair of rows [q0, q_last] x keys [k0, k0 + BKV) visible
__device__ __forceinline__ bool interior(int q0, int q_last, int k0, int Sk,
                                         int causal, int window) {
  return k0 + BKV <= Sk && (!causal || k0 + BKV - 1 <= q0) &&
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
// elements. vec != 0 promises d % 4 == 0, every stride % 4 == 0 and
// 16-byte (f32) or 8-byte (bf16) aligned pointers. d <= 256, H % KVH == 0.
// `smem` is the dynamic shared memory in bytes that the caller computed for
// the launch: it must equal this file's smem_bytes at the padded head dim
// (64, 128 or 256), for either dtype.
extern "C" int flash_swa_launch(const void* q, const void* k, const void* v,
                                void* o, int B, int H, int KVH, int Sq,
                                int Sk, int d, const int64_t* strides,
                                int causal, int window, float scale, int vec,
                                int smem, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  const int dp = d <= 64 ? 64 : d <= 128 ? 128 : 256;
  if (Sk <= 0 || d <= 0 || d > 256 || KVH <= 0 || H % KVH != 0 ||
      B * H > 65535 || (Sq + BQ - 1) / BQ > 65535 ||
      (size_t)smem != smem_bytes(dp))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)run(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(o), B, H,
                    KVH, Sq, Sk, d, strides, causal, window, scale, vec, s);
  return (int)run(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o), B, H,
                  KVH, Sq, Sk, d, strides, causal, window, scale, vec, s);
}
