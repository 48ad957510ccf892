// Kernel B1: fused Taylor-2 forward of a plain dense PINN MLP, for Hopper.
//
// Replaces the Pallas TPU kernel tpinn/kernels/mlp_taylor.py
// (taylor2_streams_pallas, body _make_kernel and _feature_streams_kernel).
// For a tile of points it builds the S derivative streams of the feature
// map (value, first derivatives, second derivatives) and carries them,
// stacked as [S, TP, W], through every dense layer without touching
// device memory between layers:
//
//   X_s   = H_s @ W                        (layer 0: X_s *= scl)
//   value : a = phi(X_0 + b)
//   first : phi'(x0) * X_i
//   pair  : phi''(x0) * X_i * X_j + phi'(x0) * X_ij
//   output: linear, bias on the value stream only, times epsil.
//
// Device traffic is the points in, the weights (read through L1/L2, a few
// tens of KB per layer, shared by every block) and [N, S] floats out.
// So the kernel is bound by fp32 arithmetic on the CUDA cores and by
// shared-memory reads, not by device memory: about 2*S*W*W FLOP per point
// and hidden layer.
//
// Design (a first, simple version):
// - One block of 256 threads takes TP points.  The streams of one layer
//   live in dynamic shared memory, double-buffered (input and output of
//   the layer): 2 * S * TP * KS floats, KS the widest layer rounded up to
//   4.  The wrapper picks TP so that two blocks fit on one SM.
// - A thread owns one output column c of PT = 4 points and keeps all S
//   streams of them in registers (acc[PT][S]).  One weight W[k][c] is then
//   reused for PT*S FMAs, the activation algebra between layers runs in
//   registers (it needs all streams of a point and column together), and
//   the H reads are float4 broadcasts (a warp shares its points).
// - Plain fp32 FMA: no TF32 or bf16, which would spoil the second
//   derivative streams.  The TPU kernel's three-pass bf16 split (dot_f32)
//   existed only because Mosaic refused full-precision dots.
// - The ragged last tile is masked; the TPU version padded z instead.
//
// Plain C interface (no PyTorch headers), loaded with ctypes: every call
// returns 0 or an error code (cudaGetLastError after the launch, or a
// negative code for arguments the kernel does not take).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kMaxCoords = 4;
constexpr int kMaxStreams = 10;   // 1 + 3 firsts + 6 pairs for 3 coordinates
constexpr int kMaxFeatures = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPointsPerThread = 4;

// feature kinds and activations, as numbered by the Python wrapper
constexpr int kMinmax = 0;
constexpr int kPeriodic = 1;
constexpr int kIdentity = 2;
constexpr int kTanh = 0;

// stream kinds
constexpr int kValue = 0;
constexpr int kFirst = 1;
constexpr int kPair = 2;

struct Net {
  const float* w[kMaxLayers];   // [dims[l], dims[l+1]] row-major
  const float* b[kMaxLayers];   // [dims[l+1]]
  int dims[kMaxLayers + 1];
  int n_layers;
  int d;                        // coordinates per point
  int kinds[kMaxCoords];
  float lb[kMaxCoords];
  float ub[kMaxCoords];
  int pad_to;
  int nf;                       // feature columns (dims[0])
  int st_kind[kMaxStreams];
  int st_i[kMaxStreams];
  int st_j[kMaxStreams];
  int st_pi[kMaxStreams];       // position of stream (i,) for a pair
  int st_pj[kMaxStreams];       // position of stream (j,) for a pair
  int act_first;
  int act_hidden;
  float scl;
  float epsil;
  int tp;                       // points per block
  int ks;                       // shared-memory row stride (floats, % 4 == 0)
};

__device__ __forceinline__ void act_derivs(int act, float x, float& a,
                                           float& d1, float& d2) {
  if (act == kTanh) {
    a = tanhf(x);
    d1 = 1.f - a * a;
    d2 = -2.f * a * d1;
  } else {
    a = sinf(x);
    d1 = cosf(x);
    d2 = -a;
  }
}

// Feature streams of the block's points into h: row (s, p) holds the nf
// feature columns of stream s at point p, zero-padded to a multiple of 4.
template <int S>
__device__ __forceinline__ void build_features(const float* __restrict__ z,
                                               long long n, long long p0,
                                               const Net& net, float* h) {
  const int k4 = (net.nf + 3) & ~3;
  for (int p = threadIdx.x; p < net.tp; p += kThreads) {
    const long long gp = p0 + p;
    const bool valid = gp < n;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float* row = h + (s * net.tp + p) * net.ks;
      const int sk = net.st_kind[s];
      const int si = net.st_i[s];
      const int sj = net.st_j[s];
      int col = 0;
      for (int ci = 0; ci < net.d; ++ci) {
        const float x = valid ? z[gp * net.d + ci] : 0.f;
        const int kind = net.kinds[ci];
        if (kind == kPeriodic) {
          const float c = cosf(x);
          const float sn = sinf(x);
          float v0 = 0.f, v1 = 0.f;
          if (sk == kValue) {
            v0 = c;
            v1 = sn;
          } else if (sk == kFirst && si == ci) {
            v0 = -sn;
            v1 = c;
          } else if (sk == kPair && si == ci && sj == ci) {
            v0 = -c;
            v1 = -sn;
          }
          row[col] = v0;
          row[col + 1] = v1;
          col += 2;
        } else {
          const bool mm = kind == kMinmax;
          const float scale = mm ? 2.f / (net.ub[ci] - net.lb[ci]) : 1.f;
          const float val = mm ? scale * (x - net.lb[ci]) - 1.f : x;
          float v = 0.f;
          if (sk == kValue) {
            v = val;
          } else if (sk == kFirst && si == ci) {
            v = scale;
          }
          row[col] = v;
          col += 1;
        }
      }
      // pad_to duplicates column 0 together with its derivative streams
      const float first = row[0];
      for (; col < net.pad_to; ++col) row[col] = first;
      for (; col < k4; ++col) row[col] = 0.f;
    }
  }
}

// One hidden layer: hout = Taylor-2 activation of (hin @ W + b).
template <int S>
__device__ __forceinline__ void dense_taylor_layer(const float* __restrict__ hin,
                                                   float* __restrict__ hout,
                                                   const Net& net, int li) {
  constexpr int PT = kPointsPerThread;
  const int tp = net.tp;
  const int ks = net.ks;
  const int K = net.dims[li];
  const int K4 = (K + 3) & ~3;
  const int dout = net.dims[li + 1];
  const int dout4 = (dout + 3) & ~3;
  const float* __restrict__ W = net.w[li];
  const float* __restrict__ B = net.b[li];
  const float scl = li == 0 ? net.scl : 1.f;
  const int act = li == 0 ? net.act_first : net.act_hidden;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_slots = (dout4 + 31) >> 5;
  const int n_units = (tp / PT) * n_slots;

  for (int u = warp; u < n_units; u += kWarps) {
    const int pb = (u / n_slots) * PT;
    const int c = (u % n_slots) * 32 + lane;
    if (c >= dout4) continue;
    if (c >= dout) {
      // zero padding columns: the next layer reads them as float4
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int pt = 0; pt < PT; ++pt) hout[(s * tp + pb + pt) * ks + c] = 0.f;
      continue;
    }

    float acc[PT][S];
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
#pragma unroll
      for (int s = 0; s < S; ++s) acc[pt][s] = 0.f;

    for (int k = 0; k < K4; k += 4) {
      const float w0 = __ldg(W + (size_t)k * dout + c);
      const float w1 = k + 1 < K ? __ldg(W + (size_t)(k + 1) * dout + c) : 0.f;
      const float w2 = k + 2 < K ? __ldg(W + (size_t)(k + 2) * dout + c) : 0.f;
      const float w3 = k + 3 < K ? __ldg(W + (size_t)(k + 3) * dout + c) : 0.f;
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float4 h = *reinterpret_cast<const float4*>(
              hin + (s * tp + pb + pt) * ks + k);
          float a = acc[pt][s];
          a = fmaf(h.x, w0, a);
          a = fmaf(h.y, w1, a);
          a = fmaf(h.z, w2, a);
          a = fmaf(h.w, w3, a);
          acc[pt][s] = a;
        }
      }
    }

    const float bc = __ldg(B + c);
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      float x[S];
#pragma unroll
      for (int s = 0; s < S; ++s) x[s] = acc[pt][s] * scl;
      float a, d1, d2;
      act_derivs(act, x[0] + bc, a, d1, d2);
      const int p = pb + pt;
      hout[p * ks + c] = a;
#pragma unroll
      for (int s = 1; s < S; ++s) {
        float v;
        if (net.st_kind[s] == kFirst) {
          v = d1 * x[s];
        } else {
          // select X_i, X_j by compare (a runtime index into x[] would
          // push the array out of registers)
          float xi = 0.f, xj = 0.f;
#pragma unroll
          for (int q = 1; q < S; ++q) {
            if (q == net.st_pi[s]) xi = x[q];
            if (q == net.st_pj[s]) xj = x[q];
          }
          v = d2 * xi * xj + d1 * x[s];
        }
        hout[(s * tp + p) * ks + c] = v;
      }
    }
  }
}

// Linear scalar output: out[p, s] = epsil * (H_s[p] . w (+ b on s == 0)).
template <int S>
__device__ __forceinline__ void output_layer(const float* __restrict__ hin,
                                             const Net& net, long long n,
                                             long long p0,
                                             float* __restrict__ out) {
  const int li = net.n_layers - 1;
  const int K = net.dims[li];
  const float* __restrict__ W = net.w[li];
  const float scl = li == 0 ? net.scl : 1.f;
  const float bias = __ldg(net.b[li]);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < S * net.tp; r += kWarps) {
    const float* h = hin + r * net.ks;
    float sum = 0.f;
    for (int k = lane; k < K; k += 32) sum = fmaf(h[k], __ldg(W + k), sum);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int s = r / net.tp;
    const long long gp = p0 + (r - s * net.tp);
    if (lane == 0 && gp < n) {
      float x = sum * scl;
      if (s == 0) x += bias;
      out[gp * S + s] = x * net.epsil;
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads, 2)
taylor2_fwd_kernel(const float* __restrict__ z, long long n,
                   const __grid_constant__ Net net, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* buf0 = reinterpret_cast<float*>(smem4);
  float* buf1 = buf0 + (size_t)S * net.tp * net.ks;
  const long long p0 = (long long)blockIdx.x * net.tp;

  build_features<S>(z, n, p0, net, buf0);
  __syncthreads();
  float* hin = buf0;
  float* hout = buf1;
  for (int li = 0; li < net.n_layers - 1; ++li) {
    dense_taylor_layer<S>(hin, hout, net, li);
    __syncthreads();
    float* t = hin;
    hin = hout;
    hout = t;
  }
  output_layer<S>(hin, net, n, p0, out);
}

template <int S>
int launch(const float* z, long long n, const Net& net, float* out,
           cudaStream_t stream) {
  const size_t smem = 2ull * S * net.tp * net.ks * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      taylor2_fwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (n + net.tp - 1) / net.tp;
  taylor2_fwd_kernel<S><<<(unsigned)blocks, kThreads, smem, stream>>>(
      z, n, net, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Error codes below 0: the arguments are outside what the kernel takes.
int tpinn_taylor2_fwd(const float* z, long long n, int d, const int* kinds,
                      const float* lb, const float* ub, int pad_to, int n_layers,
                      const void* const* w, const void* const* b,
                      const int* dims, int n_streams, const int* st_kind,
                      const int* st_i, const int* st_j, const int* st_pi,
                      const int* st_pj, int act_first, int act_hidden,
                      float scl, float epsil, int tile_points, float* out,
                      void* stream) {
  if (n <= 0) return -1;
  if (d < 1 || d > kMaxCoords) return -2;
  if (n_layers < 1 || n_layers > kMaxLayers) return -3;
  if (n_streams < 1 || n_streams > kMaxStreams) return -4;
  if (tile_points < kPointsPerThread || tile_points % kPointsPerThread) return -5;
  if (dims[0] > kMaxFeatures || dims[n_layers] != 1) return -6;

  Net net;
  int widest = 0;
  for (int l = 0; l < n_layers; ++l) {
    net.w[l] = static_cast<const float*>(w[l]);
    net.b[l] = static_cast<const float*>(b[l]);
  }
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return -6;
    net.dims[l] = dims[l];
    if (l < n_layers && dims[l] > widest) widest = dims[l];
  }
  net.n_layers = n_layers;
  net.d = d;
  for (int c = 0; c < d; ++c) {
    if (kinds[c] != kMinmax && kinds[c] != kPeriodic && kinds[c] != kIdentity)
      return -7;
    net.kinds[c] = kinds[c];
    net.lb[c] = lb[c];
    net.ub[c] = ub[c];
  }
  net.pad_to = pad_to;
  net.nf = dims[0];
  if (st_kind[0] != kValue) return -8;
  for (int s = 0; s < n_streams; ++s) {
    net.st_kind[s] = st_kind[s];
    net.st_i[s] = st_i[s];
    net.st_j[s] = st_j[s];
    net.st_pi[s] = st_pi[s];
    net.st_pj[s] = st_pj[s];
    if (st_kind[s] == kPair &&
        (st_pi[s] < 1 || st_pi[s] >= n_streams || st_pj[s] < 1 ||
         st_pj[s] >= n_streams))
      return -8;
  }
  net.act_first = act_first;
  net.act_hidden = act_hidden;
  net.scl = scl;
  net.epsil = epsil;
  net.tp = tile_points;
  net.ks = (widest + 3) & ~3;
  if (2ull * n_streams * net.tp * net.ks * sizeof(float) > 232448ull) return -9;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_streams) {
    case 1: return launch<1>(z, n, net, out, s);
    case 2: return launch<2>(z, n, net, out, s);
    case 3: return launch<3>(z, n, net, out, s);
    case 4: return launch<4>(z, n, net, out, s);
    case 5: return launch<5>(z, n, net, out, s);
    case 6: return launch<6>(z, n, net, out, s);
    case 7: return launch<7>(z, n, net, out, s);
    case 8: return launch<8>(z, n, net, out, s);
    case 9: return launch<9>(z, n, net, out, s);
    case 10: return launch<10>(z, n, net, out, s);
  }
  return -4;
}

}  // extern "C"
