// Weighted LoRA factor mean over a stacked client axis, for Hopper (sm_90a),
// for a group of factor stacks in one launch.
//
// Replaces the TPU kernel kernels/factor_mean.py::lora_factor_mean (bodies
// _kernel and _kernel_weighted) of the JAX package.
//
// For each tensor t of the group, out_t[i] = sum_c w[c] * x_t[c, i]
// (weighted body; w == nullptr -> uniform body: x_t[0, i] + x_t[1, i] + ...
// in slot order, then / C). With `accumulate`, out_t[i] = out_t[i] + mean,
// rounded once after the mean is complete (the chunked fold's
// acc.add_(mean)).
//
// x_t is a client-leading stack (C, ...): lane c starts at x_t + c * stride_t
// and its block of count_t elements is contiguous. All tensors of a group
// share C and the (C,) weights.
//
// Bound on the card: bytes, (C_live + 1 (+ 1 accumulating)) * count * 4 per
// tensor, about one flop per byte. At the engine's sizes (a and b of 4 leaves
// at paper-llama3.2-3b width, 2.3 M outputs) one close moves 27.5 MB at
// C_live = 2: 8.2 us at 3.35 TB/s. A launch per tensor spent ~47 us each on
// the host's launch path (H100 80GB HBM3, 700 W), so the design is one
// launch per group:
// * the group's table (source, destination, count, lane stride, first block,
//   vector flag) is a kernel parameter (multi-tensor-apply style, at most
//   kMaxGroup tensors; the wrapper splits a larger group), so there is no
//   host-to-device copy;
// * each block finds its tensor from the first-block prefix and takes 1024
//   outputs: a thread a float4 of them (16-byte loads where the tensor's
//   count, lane stride and pointers allow it, four coalesced 4-byte loads
//   otherwise), with the loads of up to kBatch live lanes issued before
//   their products are summed (kBatch * 16 bytes in flight a thread);
// * the weights are read once a block into shared memory, where warp 0
//   compacts the live lanes (nonzero weight) in slot order with a ballot: a
//   lane whose weight is exactly 0 is never read, so it adds exactly 0 (an
//   acc that starts at +0 is never -0) whatever it holds.
// The products and sums use explicitly rounded intrinsics (no FMA
// contraction) in slot order, so the result equals the plain PyTorch
// version's op-for-op arithmetic bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroup = 32;  // tensors a launch; the table is 1.2 KB
constexpr int kThreads = 256;
constexpr int kPerBlock = 4 * kThreads;  // outputs a block
constexpr int kBatch = 8;                // live lanes loaded before summing

struct Table {
  const float* src[kMaxGroup];
  float* dst[kMaxGroup];
  int64_t count[kMaxGroup];
  int64_t stride[kMaxGroup];
  int first[kMaxGroup + 1];  // first block of each tensor; first[n] = grid
  unsigned vec;              // bit t: tensor t takes 16-byte loads
  int n;
};

// out = acc (+ prior)
__device__ __forceinline__ float finish(float acc, const float* prior,
                                        bool accumulate) {
  return accumulate ? __fadd_rn(*prior, acc) : acc;
}

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
    factor_mean_group(const __grid_constant__ Table tab,
                      const float* __restrict__ w, int num_clients,
                      int accumulate) {
  extern __shared__ int smem[];
  int* live = smem;                                           // [C]
  float* wl = reinterpret_cast<float*>(smem + num_clients);   // [C]
  __shared__ int num_live;

  // the live lanes in slot order, with their weights
  if (threadIdx.x < 32) {
    int base = 0;
    for (int c0 = 0; c0 < num_clients; c0 += 32) {
      const int c = c0 + (int)threadIdx.x;
      const float wc = c < num_clients ? (kWeighted ? w[c] : 1.0f) : 0.0f;
      const unsigned ballot = __ballot_sync(0xffffffffu, wc != 0.0f);
      if (wc != 0.0f) {
        const int at = base + __popc(ballot & ((1u << threadIdx.x) - 1u));
        live[at] = c;
        wl[at] = wc;
      }
      base += __popc(ballot);
    }
    if (threadIdx.x == 0) num_live = base;
  }

  // this block's tensor: the last t with first[t] <= blockIdx.x
  int t = 0;
  while (t + 1 < tab.n && tab.first[t + 1] <= (int)blockIdx.x) ++t;
  const float* __restrict__ x = tab.src[t];
  float* __restrict__ out = tab.dst[t];
  const int64_t count = tab.count[t], stride = tab.stride[t];
  const int64_t base = (int64_t)(blockIdx.x - tab.first[t]) * kPerBlock;
  const bool vec = (tab.vec >> t) & 1u;
  __syncthreads();
  const int nl = num_live;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  // the thread's 4 outputs: one float4, or 4 outputs kThreads apart
  const int64_t i0 = vec ? base + 4 * (int64_t)threadIdx.x : base + threadIdx.x;
  const int64_t step = vec ? 1 : kThreads;
  bool ok[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) ok[e] = i0 + e * step < count;

  for (int g = 0; g < nl; g += kBatch) {
    float v[kBatch][4];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (g + j < nl) {
        const float* p = x + (int64_t)live[g + j] * stride + i0;
        if (vec) {
          if (ok[0]) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(p));
            v[j][0] = q.x; v[j][1] = q.y; v[j][2] = q.z; v[j][3] = q.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (ok[e]) v[j][e] = __ldg(p + e * step);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (g + j < nl) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kWeighted)
            acc[e] = __fadd_rn(acc[e], __fmul_rn(wl[g + j], v[j][e]));
          else  // slot order: x[0] + x[1] + ... (acc starts at +0, and
                // +0 + x[0] is x[0] bitwise, -0 aside; see below)
            acc[e] = (g + j == 0) ? v[j][e] : __fadd_rn(acc[e], v[j][e]);
        }
      }
    }
  }
  if (!kWeighted) {
    const float c = (float)num_clients;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = __fdiv_rn(acc[e], c);
  }
  if (vec) {
    if (ok[0]) {
      float4* o = reinterpret_cast<float4*>(out + i0);
      float4 r = make_float4(acc[0], acc[1], acc[2], acc[3]);
      if (accumulate) {
        const float4 p = *o;
        r = make_float4(__fadd_rn(p.x, r.x), __fadd_rn(p.y, r.y),
                        __fadd_rn(p.z, r.z), __fadd_rn(p.w, r.w));
      }
      *o = r;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ok[e]) {
        float* o = out + i0 + e * step;
        *o = finish(acc[e], o, accumulate);
      }
  }
}

}  // namespace

// Launches one grid over a group of `num_tensors` <= 32 tensors on `stream`;
// returns a cudaError_t (0 = launched).
//
// `table` is a host array of 6 int64 per tensor: source, destination,
// count, lane stride (elements), first block, 16-byte flag. The first
// blocks are the prefix sum of ceil(count / 1024) from 0; the flag promises
// count, lane stride and both pointers divisible by 4 floats (16 bytes).
// w == nullptr -> the uniform body (all `num_clients` lanes, slot order,
// then / C); otherwise the weighted body over w (C floats on the device).
extern "C" int factor_mean_launch(const int64_t* table, int num_tensors,
                                  const float* w, int num_clients,
                                  int accumulate, void* stream) {
  if (num_tensors <= 0) return 0;
  if (num_tensors > kMaxGroup || num_clients < 1)
    return (int)cudaErrorInvalidValue;
  Table tab;
  tab.n = num_tensors;
  tab.vec = 0;
  int64_t blocks = 0;
  for (int t = 0; t < num_tensors; ++t) {
    const int64_t* e = table + 6 * t;
    tab.src[t] = reinterpret_cast<const float*>(e[0]);
    tab.dst[t] = reinterpret_cast<float*>(e[1]);
    tab.count[t] = e[2];
    tab.stride[t] = e[3];
    if (e[2] < 1 || e[4] != blocks) return (int)cudaErrorInvalidValue;
    if (e[5]) {
      if ((e[0] | e[1]) % 16 != 0 || e[2] % 4 != 0 || e[3] % 4 != 0)
        return (int)cudaErrorInvalidValue;
      tab.vec |= 1u << t;
    }
    tab.first[t] = (int)blocks;
    blocks += (e[2] + kPerBlock - 1) / kPerBlock;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  tab.first[num_tensors] = (int)blocks;
  for (int t = num_tensors + 1; t <= kMaxGroup; ++t) tab.first[t] = (int)blocks;
  const size_t smem = 8 * (size_t)num_clients;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != nullptr)
    factor_mean_group<true><<<(unsigned)blocks, kThreads, smem, s>>>(
        tab, w, num_clients, accumulate);
  else
    factor_mean_group<false><<<(unsigned)blocks, kThreads, smem, s>>>(
        tab, nullptr, num_clients, accumulate);
  return (int)cudaGetLastError();
}
