// Kernel B3: one fused Adam step on flat float32 vectors, for Hopper.
//
// Replaces the Pallas TPU kernel tpinn/kernels/adam.py (adam_update_flat,
// body _adam_kernel).  One grid-stride pass updates, in place,
//
//   m = (1 - b1) g + b1 m
//   v = (1 - b2) g^2 + b2 v
//   p = p - lr * (m / bc1) / (sqrt(v / bc2) + eps)
//
// optax.adam's form and order of operations, with bc1 = 1 - b1^t and
// bc2 = 1 - b2^t for the 1-based step t, computed by the wrapper.  The
// learning rate is read from a 1-element device tensor (the counterpart
// of the TPU kernel's SMEM scalar), so a plateau halving changes it on the
// device with no host sync.
//
// What bounds it on the card: device memory, 4 reads and 3 writes of 4
// bytes per element (28 bytes), a few flops each; for PINN-sized vectors
// (tens of thousands of elements) the launch itself.  Each multiply and
// add is rounded on its own (__fmul_rn, __fadd_rn: no FMA contraction),
// as the plain PyTorch version computes them.
//
// Plain C interface (no PyTorch headers), loaded with ctypes: the call
// returns 0 or an error code (cudaGetLastError after the launch, or a
// negative code for arguments the kernel does not take).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void adam_kernel(const float* __restrict__ g, float* __restrict__ p,
                            float* __restrict__ m, float* __restrict__ v,
                            const float* __restrict__ lr, long long n, float b1,
                            float b2, float one_minus_b1, float one_minus_b2,
                            float eps, float bc1, float bc2) {
  const float step = __ldg(lr);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float gi = g[i];
    const float mi = __fadd_rn(__fmul_rn(one_minus_b1, gi), __fmul_rn(b1, m[i]));
    const float vi = __fadd_rn(__fmul_rn(one_minus_b2, __fmul_rn(gi, gi)),
                               __fmul_rn(b2, v[i]));
    const float m_hat = __fdiv_rn(mi, bc1);
    const float v_hat = __fdiv_rn(vi, bc2);
    const float upd = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), eps));
    p[i] = __fsub_rn(p[i], __fmul_rn(step, upd));
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

extern "C" {

// Error codes below 0: the arguments are outside what the kernel takes.
int tpinn_adam_update(const float* g, float* p, float* m, float* v,
                      const float* lr, long long n, float b1, float b2,
                      float one_minus_b1, float one_minus_b2, float eps,
                      float bc1, float bc2, int blocks, void* stream) {
  if (n <= 0) return -1;
  if (blocks < 1) return -2;
  adam_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, p, m, v, lr, n, b1, b2, one_minus_b1, one_minus_b2, eps, bc1, bc2);
  return (int)cudaGetLastError();
}

}  // extern "C"
