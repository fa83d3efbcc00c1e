// Weighted LoRA factor mean over a stacked client axis, for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/factor_mean.py::lora_factor_mean (bodies
// _kernel and _kernel_weighted) of the JAX package.
//
// out[i] = sum_c w[c] * x[c, i]   (weighted body; w == nullptr -> uniform body:
//          x[0, i] + x[1, i] + ... in slot order, then / C)
//
// x is the engine's client-leading stack (C, L, m, n): lane c starts at
// x + c * stride_c and its (L, m, n) block of `count` elements is contiguous.
//
// Bound on the card: bytes. Each output element reads C_live inputs and
// writes one: (C_live + 1) * count * 4 bytes, no reuse, ~C flops per element.
// Design: one thread per element with a grid-stride loop, so neighbouring
// threads touch neighbouring addresses of every lane (coalesced); a lane whose
// weight is exactly zero is never read, so it adds exactly 0 whatever it
// holds, and partial rounds read only the delivered lanes. The products and
// sums use explicitly rounded intrinsics (no FMA contraction), so the result
// equals the plain PyTorch version's op-for-op arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool kWeighted>
__global__ void factor_mean_kernel(const float* __restrict__ x,
                                   float* __restrict__ out,
                                   const float* __restrict__ w, int num_clients,
                                   int64_t count, int64_t stride_c) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += step) {
    float acc;
    if (kWeighted) {
      acc = 0.0f;
      for (int c = 0; c < num_clients; ++c) {
        const float wc = w[c];
        if (wc == 0.0f) continue;  // masked lane: never read, adds exactly 0
        acc = __fadd_rn(acc, __fmul_rn(wc, x[c * stride_c + i]));
      }
    } else {
      acc = x[i];
      for (int c = 1; c < num_clients; ++c)
        acc = __fadd_rn(acc, x[c * stride_c + i]);
      acc = __fdiv_rn(acc, (float)num_clients);
    }
    out[i] = acc;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int factor_mean_launch(const float* x, float* out, const float* w,
                                  int num_clients, int64_t count,
                                  int64_t stride_c, void* stream) {
  if (count <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (count + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != nullptr)
    factor_mean_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(
        x, out, w, num_clients, count, stride_c);
  else
    factor_mean_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(
        x, out, nullptr, num_clients, count, stride_c);
  return (int)cudaGetLastError();
}
