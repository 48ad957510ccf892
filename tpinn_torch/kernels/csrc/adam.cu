// Kernel B3: one fused Adam step on flat float32 vectors, for Hopper.
//
// Replaces the Pallas TPU kernel tpinn/kernels/adam.py (adam_update_flat,
// body _adam_kernel).  One pass updates, in place,
//
//   m = (1 - b1) g + b1 m
//   v = (1 - b2) g^2 + b2 v
//   p = p - lr * (m / bc1) / (sqrt(v / bc2) + eps)
//
// optax.adam's form and order of operations, with bc1 = 1 - b1^t and
// bc2 = 1 - b2^t for the 1-based step t.  Each operation is rounded on its
// own (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no FMA contraction), as
// the plain PyTorch version computes them.
//
// What bounds it on the card: device memory, 4 reads and 3 writes of 4
// bytes per element (28 bytes), a few flops each; for PINN-sized vectors
// (tens of thousands of elements, under a microsecond of traffic) the
// launch itself, the host's part of it, and each thread's chain of
// dependent IEEE divisions and square roots (each with its own check for
// the slow path).
//
// What the design does about that:
// - Every launch argument but g's pointer is the same from step to step, so
//   the wrapper builds them once per Adam phase (AdamArgs, passed by
//   pointer) and a CUDA graph can replay the launch.  The per-step state
//   lives on the device, as the TPU kernel kept lr and t in SMEM: lr is a
//   1-element tensor (the plateau rule halves it in place), and the step t
//   with its bias corrections (1 - b1^t, 1 - b2^t) is a 16-byte slot per
//   block, {t, bc1, bc2, flag}.  The corrections come from a float32 table,
//   one row per step of the phase, formed on the host once (numpy float32,
//   the values the plain version uses).  Each block reads its own slot in
//   one load, beside its loads of g, p, m and v, and its thread 0 writes
//   {t + 1, next row} back once every thread of the block has used it: no
//   block waits on another (no atomics, no fence), and no load of the data
//   waits on the step's state.  A t outside the table (a graph replayed
//   past the phase's last step) updates nothing, stays where it is and
//   sets the slot's flag, on which the wrapper's step count raises.
// - One element a thread, blocks of 256 threads, at most 4 blocks an SM
//   (tpinn_adam_blocks): at n = 32,801, 129 blocks, as many threads as
//   elements, each thread's dependent chain one element long.  Past the
//   grid the threads loop.  (A float4 a thread was slower at PINN sizes:
//   it idles three quarters of the threads and chains four elements in
//   each.)  Indices are 32-bit (n <= 2^30), and g and lr, read-only
//   through the launch, go through the non-coherent cache (__ldg).  The
//   slot, which the block writes back, is read from L2 (__ldcg).
//
// Plain C interface (no PyTorch headers), loaded with ctypes: the call
// returns 0 or an error code (cudaGetLastError after the launch, or a
// negative code for arguments the kernel does not take).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // resident at once: at most 64 registers

}  // namespace

extern "C" {

// The launch arguments of one parameter vector for one Adam phase; the
// wrapper mirrors this layout in a ctypes Structure.
struct AdamArgs {
  float* p;
  float* m;
  float* v;
  const float* lr;   // [1]
  const float* bc;   // [steps + 1][2]: (1 - b1^t, 1 - b2^t), t = t_first + row
  int* state;        // [blocks][4]: {t, bc1, bc2 (float bits), flag}
  long long n;
  float b1;
  float b2;
  float one_minus_b1;
  float one_minus_b2;
  float eps;
  int t_first;
  int steps;
  int blocks;
};

}  // extern "C"

namespace {

struct Coeffs {
  float b1, b2, one_minus_b1, one_minus_b2, eps, bc1, bc2, lr;
};

__device__ __forceinline__ void adam1(const Coeffs& c, float g, float& p,
                                      float& m, float& v) {
  m = __fadd_rn(__fmul_rn(c.one_minus_b1, g), __fmul_rn(c.b1, m));
  v = __fadd_rn(__fmul_rn(c.one_minus_b2, __fmul_rn(g, g)),
                __fmul_rn(c.b2, v));
  const float m_hat = __fdiv_rn(m, c.bc1);
  const float v_hat = __fdiv_rn(v, c.bc2);
  const float upd = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), c.eps));
  p = __fsub_rn(p, __fmul_rn(c.lr, upd));
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    adam_kernel(const AdamArgs a, const float* __restrict__ g) {
  // This block's slot; no other block reads or writes it.  Nothing below
  // branches on it before the stores, so the data loads need not wait.
  int4* slot = reinterpret_cast<int4*>(a.state) + blockIdx.x;
  const int4 s = __ldcg(slot);
  const int row = s.x - a.t_first;
  const bool ok = row >= 0 && row < a.steps;  // the same in every block
  const Coeffs c{a.b1,  a.b2, a.one_minus_b1, a.one_minus_b2,
                 a.eps, __int_as_float(s.y), __int_as_float(s.z), __ldg(a.lr)};
  float2 next = make_float2(0.f, 0.f);
  if (threadIdx.x == 0 && ok)
    next = __ldg(reinterpret_cast<const float2*>(a.bc) + row + 1);

  float* __restrict__ p = a.p;
  float* __restrict__ m = a.m;
  float* __restrict__ v = a.v;
  const int n = static_cast<int>(a.n);
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float pi = p[i], mi = m[i], vi = v[i];
    adam1(c, __ldg(g + i), pi, mi, vi);
    if (ok) {
      p[i] = pi;
      m[i] = mi;
      v[i] = vi;
    }
  }

  // every thread of the block has used the slot: advance it, or flag a
  // step outside the table
  __syncthreads();
  if (threadIdx.x == 0)
    *slot = ok ? make_int4(s.x + 1, __float_as_int(next.x),
                           __float_as_int(next.y), 0)
               : make_int4(s.x, s.y, s.z, 1);
}

}  // namespace

extern "C" {

int tpinn_adam_args_size(void) { return (int)sizeof(AdamArgs); }

// Blocks of one launch on n elements on the given device: one thread an
// element, up to the blocks its SMs hold at once; below 0 an error code.
int tpinn_adam_blocks(long long n, int device) {
  int sms = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -(int)e;
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < (long long)sms * kBlocksPerSm ? blocks
                                                      : sms * kBlocksPerSm);
}

// Error codes below 0: the arguments are outside what the kernel takes.
int tpinn_adam_step(const AdamArgs* a, const float* g, void* stream) {
  if (a->n <= 0 || a->n > (1LL << 30)) return -1;
  if (a->blocks < 1) return -2;
  if (a->steps < 1 || a->t_first < 1) return -3;
  adam_kernel<<<a->blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *a, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
