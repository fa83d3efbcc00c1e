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
// q, o (B, Sq, H, d) and k, v (B, Sk, KVH, d), f32, each addressed through
// its own (batch, position, head) strides with a contiguous last dim, so
// the GQA heads read their K/V head in place (no repeated copy) and the
// (BH, S, d) layout is the case H = KVH = 1. d <= 128; any Sq, Sk: rows and
// columns past the ends are zero-filled on load and masked.
//
// Design: one block of 256 threads per (b*h, 64 query rows), heavier
// (later) query tiles launched first. The scaled Q tile (scale applied to q
// in f32, as the reference does) sits transposed in shared memory; KV tiles
// of 64 positions stream through one shared buffer, K transposed for
// QK^T and then V row-major for PV. Each thread owns a 4 x 4 block of the
// score tile and a 4 x (d/16) block of the output: float4 reads of
// shared memory, conflict-free. The row max and sum of the online softmax
// reduce across the 16 threads of a row group with warp shuffles; m and l
// live in registers, updated in the reference's order (l = l*corr + sum p,
// acc = acc*corr + p v). KV tiles wholly outside the causal-and-window
// band of the query tile are never loaded. IEEE f32 FMAs on CUDA cores
// (TF32 stays off), expf and IEEE division.
//
// Bound on the card: operations, 4*d FLOPs per visible (query, key) pair
// (prefill at B 8, H 24, S 512, d 128, causal: 12.9 GFLOP, 0.19 ms at
// 67 TFLOP/s). Shared memory 81 KB a block at d 128, 2 blocks an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BKV = 64, NT = 256, PS = BKV + 4;
constexpr float kNegInf = -1e30f;

// tile[c * R + row] = src[row0 + row][c] * mul, for a 64-row tile of DP
// columns; zeros past `rows` or `d`. Each thread reads 8 consecutive floats
// of one row (a full 32-byte sector); a warp's lanes hold consecutive rows,
// so the transposed stores hit consecutive banks.
template <int DP, bool kVec>
__device__ __forceinline__ void load_transposed(float* tile,
                                                const float* __restrict__ src,
                                                int64_t stride, int row0,
                                                int rows, int d, float mul) {
  const int row = threadIdx.x & 63, cg = threadIdx.x >> 6;
  const bool in = row0 + row < rows;
  const float* p = src + (int64_t)(row0 + row) * stride;
#pragma unroll
  for (int g = 0; g < DP / 32; ++g) {
    const int c0 = cg * (DP / 4) + g * 8;
    float v[8];
    if (kVec) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in && c0 + 4 * h < d)
          t = *reinterpret_cast<const float4*>(p + c0 + 4 * h);
        v[4 * h] = t.x; v[4 * h + 1] = t.y; v[4 * h + 2] = t.z; v[4 * h + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = (in && c0 + c < d) ? p[c0 + c] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) tile[(c0 + c) * 64 + row] = v[c] * mul;
  }
}

// tile[row * DP + c] = src[row0 + row][c]; zeros past `rows` or `d`
template <int DP, bool kVec>
__device__ __forceinline__ void load_rows(float* tile,
                                          const float* __restrict__ src,
                                          int64_t stride, int row0, int rows,
                                          int d) {
  constexpr int PER = DP / 4, STEP = NT / PER;
  const int c = (threadIdx.x % PER) * 4;
  for (int row = threadIdx.x / PER; row < BKV; row += STEP) {
    const bool in = row0 + row < rows;
    const float* p = src + (int64_t)(row0 + row) * stride;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kVec) {
      if (in && c < d) t = *reinterpret_cast<const float4*>(p + c);
    } else if (in) {
      t.x = c < d ? p[c] : 0.f;
      t.y = c + 1 < d ? p[c + 1] : 0.f;
      t.z = c + 2 < d ? p[c + 2] : 0.f;
      t.w = c + 3 < d ? p[c + 3] : 0.f;
    }
    *reinterpret_cast<float4*>(tile + row * DP + c) = t;
  }
}

template <int DP, bool kVec>
__global__ void __launch_bounds__(NT, 2)
    flash_swa_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int H,
                     int KVH, int Sq, int Sk, int d, int64_t qsb, int64_t qss,
                     int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                     int64_t vsb, int64_t vss, int64_t vsh, int64_t osb,
                     int64_t oss, int64_t osh, int causal, int window,
                     float scale) {
  constexpr int CH = DP / 64;  // 4-column chunks of the output per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [DP][BQ], scaled q
  float* KV = Qt + DP * BQ;                     // [DP][BKV] K^T, then [BKV][DP] V
  float* Ps = KV + DP * BKV;                    // [BQ][PS] probabilities

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x, q0 = qt * BQ;
  const int bh = blockIdx.y, bi = bh / H, h = bh - bi * H;
  const int kh = h / (H / KVH);
  const float* qb = q + bi * qsb + h * qsh;
  const float* kb = k + bi * ksb + kh * ksh;
  const float* vb = v + bi * vsb + kh * vsh;

  load_transposed<DP, kVec>(Qt, qb, qss, q0, Sq, d, scale);

  float m_i[4], l_i[4], acc[4][4 * CH];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CH; ++c) acc[i][c] = 0.f;
  }

  // KV tiles that hold a visible pair for some real row of this tile
  const int q_last = min(q0 + BQ - 1, Sq - 1);
  const int kt_hi = (causal ? min(q_last, Sk - 1) : Sk - 1) / BKV;
  int kt_lo = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;
    kt_lo = lo > 0 ? lo / BKV : 0;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous tile's PV is done with KV (and Qt is in)
    load_transposed<DP, kVec>(KV, kb, kss, k0, Sk, d, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    const float4* Q4 = reinterpret_cast<const float4*>(Qt);
    const float4* K4 = reinterpret_cast<const float4*>(KV);
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      const float4 qa = Q4[c * (BQ / 4) + ty], kv = K4[c * (BKV / 4) + tx];
      const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kr[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

    // mask, then the online softmax update of each of the thread's 4 rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        s[i][j] = ok ? s[i][j] : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m_i[i], rmax);
      const float corr = expf(m_i[i] - m_new);
      float p[4], rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = expf(s[i][j] - m_new);
        rsum += p[j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l_i[i] = l_i[i] * corr + rsum;
#pragma unroll
      for (int c = 0; c < 4 * CH; ++c) acc[i][c] *= corr;
      m_i[i] = m_new;
      *reinterpret_cast<float4*>(Ps + (ty * 4 + i) * PS + tx * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();  // K^T reads done, P visible
    load_rows<DP, kVec>(KV, vb, vss, k0, Sk, d);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty * 4 + i) * PS + j];
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) {
        const float4 vv =
            *reinterpret_cast<const float4*>(KV + j * DP + ch * 64 + tx * 4);
        const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][ch * 4 + c] = fmaf(pr[i], vr[c], acc[i][ch * 4 + c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    float* out = o + bi * osb + h * osh + (int64_t)row * oss;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = ch * 64 + tx * 4 + c;
        if (col < d) out[col] = acc[i][ch * 4 + c] / l;
      }
  }
}

template <int DP, bool kVec>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int H, int KVH, int Sq, int Sk, int d,
                   const int64_t* st, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(DP * BQ + DP * BKV + BQ * PS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_swa_kernel<DP, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_swa_kernel<DP, kVec><<<grid, NT, smem, stream>>>(
      q, k, v, o, H, KVH, Sq, Sk, d, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 = launched). `strides`
// holds 12 int64: (batch, position, head) strides of q, k, v and o, in
// elements. vec != 0 promises d % 4 == 0, every stride % 4 == 0 and
// 16-byte aligned pointers. d <= 128, H % KVH == 0.
extern "C" int flash_swa_launch(const float* q, const float* k, const float* v,
                                float* o, int B, int H, int KVH, int Sq,
                                int Sk, int d, const int64_t* strides,
                                int causal, int window, float scale, int vec,
                                void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (Sk <= 0 || d <= 0 || d > 128 || KVH <= 0 || H % KVH != 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 64)
    err = vec ? launch<64, true>(q, k, v, o, B, H, KVH, Sq, Sk, d, strides,
                                 causal, window, scale, s)
              : launch<64, false>(q, k, v, o, B, H, KVH, Sq, Sk, d, strides,
                                  causal, window, scale, s);
  else
    err = vec ? launch<128, true>(q, k, v, o, B, H, KVH, Sq, Sk, d, strides,
                                  causal, window, scale, s)
              : launch<128, false>(q, k, v, o, B, H, KVH, Sq, Sk, d, strides,
                                   causal, window, scale, s);
  return (int)err;
}
