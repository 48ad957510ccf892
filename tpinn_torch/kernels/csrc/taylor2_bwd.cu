// Kernel B2: closed-form reverse sweep of the fused Taylor-2 forward (B1),
// for Hopper.
//
// Replaces the Pallas TPU kernel tpinn/kernels/taylor_vjp.py
// (taylor2_backward_pallas, body _make_bwd_kernel and _act3).  Given the
// cotangent ct [N, S] of B1's stream columns it returns the parameter
// gradient of every dense layer, summed over all points:
//
//   forward:  X = (H @ W) * scl0,  x0 = X_value + b
//             H'_value = phi(x0), H'_k = phi' X_k,
//             H'_ij = phi'' X_i X_j + phi' X_ij
//   reverse:  dX_ij = phi' ct_ij
//             dX_k  = phi' ct_k + sum_{(i,j) owns k} phi'' X_other ct_ij
//             dx0   = phi' ct_value + sum_k phi'' X_k ct_k
//                     + sum_ij (phi''' X_i X_j + phi'' X_ij) ct_ij
//             db = sum_points dx0,  dW = H^T (dX * scl0),
//             dH = (dX * scl0) W^T
//   output layer: linear, bias on the value stream, times epsil.
//
// What bounds it on the card: fp32 FMAs on the CUDA cores, about
// 3 * 2*S*W*W FLOP per point and hidden layer (forward recompute, H^T dX
// and dX W^T), and shared-memory reads.  Device traffic: the points and
// cotangents in, a per-block workspace of pre-activations, and one row of
// partial gradients per block.
//
// Design (a first, simple version):
// - Blocks run in parallel and in no order, where the TPU grid ran in
//   order and summed dW/db in revisited output blocks.  So the grid is
//   persistent (a few blocks per SM); each block walks many point tiles
//   and adds its tiles' dW/db into its own row of a partial buffer
//   [n_blocks, n_params].  No atomics: within a block each gradient entry
//   belongs to one thread at a time.  A second kernel sums the rows in a
//   fixed order, so the gradient is bitwise repeatable.
// - Per tile of TP points, the forward is recomputed layer by layer as in
//   B1 (streams of a point/column in registers).  The pre-activations X
//   of every hidden layer go to the block's slice of a global workspace
//   (S * TP * W floats per layer), which the wrapper allocates; the
//   reverse sweep reads them back and recomputes the layer inputs H from
//   them (phi of the previous layer), so H is never stored.
// - Shared memory holds three [S, TP, KS] stream buffers: the layer input
//   H, the cotangent G (dH, turned into dX in place) and T (the next dH).
// - The products H^T dX and dX W^T are this kernel's own fp32 FMA loops:
//   no library, no tensor cores, no TF32 or bf16.
// - The ragged last tile is masked: its points get a zero cotangent.
//
// Plain C interface (no PyTorch headers), loaded with ctypes: the call
// returns 0 or an error code (cudaGetLastError after the launches, or a
// negative code for arguments the kernel does not take).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kMaxCoords = 4;
constexpr int kMaxStreams = 10;
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
  long long w_off[kMaxLayers];  // offsets of dW_l, db_l in the flat gradient
  long long b_off[kMaxLayers];
  long long ws_off[kMaxLayers]; // offset of hidden layer l's X in a block's workspace
  long long n_params;
  long long ws_stride;          // workspace floats per block
  int dims[kMaxLayers + 1];
  int n_layers;
  int d;
  int kinds[kMaxCoords];
  float lb[kMaxCoords];
  float ub[kMaxCoords];
  int pad_to;
  int nf;
  int st_kind[kMaxStreams];
  int st_i[kMaxStreams];
  int st_j[kMaxStreams];
  int st_pi[kMaxStreams];
  int st_pj[kMaxStreams];
  int act_first;
  int act_hidden;
  float scl;
  float epsil;
  int tp;                       // points per tile
  int ks;                       // shared-memory row stride (floats, % 4 == 0)
};

__device__ __forceinline__ void act_derivs(int act, float x, float& a,
                                           float& d1, float& d2, float& d3) {
  if (act == kTanh) {
    a = tanhf(x);
    d1 = 1.f - a * a;
    d2 = -2.f * a * d1;
    d3 = (6.f * a * a - 2.f) * d1;
  } else {
    a = sinf(x);
    d1 = cosf(x);
    d2 = -a;
    d3 = -d1;
  }
}

// Stream values of one (point, column) after the activation: the
// recurrence of B1.  x[] holds X (bias not added).
template <int S>
__device__ __forceinline__ void taylor_act(const Net& net, int act, float bc,
                                           const float (&x)[S], float (&h)[S]) {
  float a, d1, d2, d3;
  act_derivs(act, x[0] + bc, a, d1, d2, d3);
  h[0] = a;
#pragma unroll
  for (int s = 1; s < S; ++s) {
    if (net.st_kind[s] == kFirst) {
      h[s] = d1 * x[s];
    } else {
      // select X_i, X_j by compare: a runtime index into x[] would push
      // the array out of registers
      float xi = 0.f, xj = 0.f;
#pragma unroll
      for (int q = 1; q < S; ++q) {
        if (q == net.st_pi[s]) xi = x[q];
        if (q == net.st_pj[s]) xj = x[q];
      }
      h[s] = d2 * xi * xj + d1 * x[s];
    }
  }
}

// Feature streams of the tile's points into h (as B1's build_features):
// row (s, p) holds the nf feature columns of stream s at point p,
// zero-padded to a multiple of 4.
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
      const float first = row[0];
      for (; col < net.pad_to; ++col) row[col] = first;
      for (; col < k4; ++col) row[col] = 0.f;
    }
  }
}

// Forward of hidden layer li: X = (hin @ W) * scl goes to the workspace,
// hout = Taylor-2 activation of X + b (B1's dense_taylor_layer plus the
// store of X).
template <int S>
__device__ __forceinline__ void forward_layer(const float* __restrict__ hin,
                                              float* __restrict__ hout,
                                              float* __restrict__ wsx,
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
      const int p = pb + pt;
      float x[S], h[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        x[s] = acc[pt][s] * scl;
        wsx[(s * tp + p) * dout + c] = x[s];
      }
      taylor_act<S>(net, act, bc, x, h);
#pragma unroll
      for (int s = 0; s < S; ++s) hout[(s * tp + p) * ks + c] = h[s];
    }
  }
}

// The input H of hidden layer li >= 1, recomputed from the workspace X
// of layer li - 1 (zero padding columns included).
template <int S>
__device__ __forceinline__ void recompute_input(float* __restrict__ hin,
                                                const float* __restrict__ wsx,
                                                const Net& net, int li) {
  const int tp = net.tp;
  const int ks = net.ks;
  const int K = net.dims[li];
  const int K4 = (K + 3) & ~3;
  const float* __restrict__ B = net.b[li - 1];
  const int act = li - 1 == 0 ? net.act_first : net.act_hidden;
  for (int e = threadIdx.x; e < tp * K4; e += kThreads) {
    const int p = e / K4;
    const int c = e - p * K4;
    if (c >= K) {
#pragma unroll
      for (int s = 0; s < S; ++s) hin[(s * tp + p) * ks + c] = 0.f;
      continue;
    }
    float x[S], h[S];
#pragma unroll
    for (int s = 0; s < S; ++s) x[s] = wsx[(s * tp + p) * K + c];
    taylor_act<S>(net, act, __ldg(B + c), x, h);
#pragma unroll
    for (int s = 0; s < S; ++s) hin[(s * tp + p) * ks + c] = h[s];
  }
}

// Output layer: the cotangent of its X is ct * epsil (zero past n); db of
// the output bias sums the value stream.  g gets dX * scl, dbs the
// per-point-group sums of the unscaled value cotangent.
template <int S>
__device__ __forceinline__ void output_cotangent(const float* __restrict__ ct,
                                                 long long n, long long p0,
                                                 const Net& net, float* g,
                                                 float* dbs) {
  constexpr int PT = kPointsPerThread;
  const int tp = net.tp;
  const int ks = net.ks;
  const float scl = net.n_layers == 1 ? net.scl : 1.f;
  for (int e = threadIdx.x; e < S * tp; e += kThreads) {
    const int s = e / tp;
    const int p = e - s * tp;
    const long long gp = p0 + p;
    const float v = gp < n ? ct[gp * S + s] * net.epsil : 0.f;
    float* row = g + (s * tp + p) * ks;
    row[0] = v * scl;
    row[1] = 0.f;
    row[2] = 0.f;
    row[3] = 0.f;
  }
  for (int q = threadIdx.x; q < tp / PT; q += kThreads) {
    float sum = 0.f;
    for (int pt = 0; pt < PT; ++pt) {
      const long long gp = p0 + q * PT + pt;
      if (gp < n) sum += ct[gp * S] * net.epsil;
    }
    dbs[q * ks] = sum;
  }
}

// Hidden layer li, in place on g: the stream cotangents dH become
// dX * scl, and dbs gets the per-point-group sums of dx0.
template <int S>
__device__ __forceinline__ void hidden_cotangent(float* __restrict__ g,
                                                 const float* __restrict__ wsx,
                                                 const Net& net, int li,
                                                 float* __restrict__ dbs) {
  constexpr int PT = kPointsPerThread;
  const int tp = net.tp;
  const int ks = net.ks;
  const int dout = net.dims[li + 1];
  const int dout4 = (dout + 3) & ~3;
  const float* __restrict__ B = net.b[li];
  const float scl = li == 0 ? net.scl : 1.f;
  const int act = li == 0 ? net.act_first : net.act_hidden;
  const int groups = tp / PT;
  for (int e = threadIdx.x; e < groups * dout4; e += kThreads) {
    const int q = e / dout4;
    const int c = e - q * dout4;
    if (c >= dout) {
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int pt = 0; pt < PT; ++pt) g[(s * tp + q * PT + pt) * ks + c] = 0.f;
      continue;
    }
    const float bc = __ldg(B + c);
    float db = 0.f;
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      const int p = q * PT + pt;
      float x[S], ctv[S], dx[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        x[s] = wsx[(s * tp + p) * dout + c];
        ctv[s] = g[(s * tp + p) * ks + c];
        dx[s] = 0.f;
      }
      float a, d1, d2, d3;
      act_derivs(act, x[0] + bc, a, d1, d2, d3);
      float dx0 = ctv[0] * d1;
#pragma unroll
      for (int s = 1; s < S; ++s) {
        const float cs = ctv[s];
        if (net.st_kind[s] == kFirst) {
          dx0 += cs * d2 * x[s];
          dx[s] += cs * d1;
        } else {
          float xi = 0.f, xj = 0.f;
#pragma unroll
          for (int r = 1; r < S; ++r) {
            if (r == net.st_pi[s]) xi = x[r];
            if (r == net.st_pj[s]) xj = x[r];
          }
          dx0 += cs * (d3 * xi * xj + d2 * x[s]);
          // i == j adds both terms to one slot: 2 phi'' X_i, as required
#pragma unroll
          for (int r = 1; r < S; ++r) {
            if (r == net.st_pi[s]) dx[r] += cs * d2 * xj;
            if (r == net.st_pj[s]) dx[r] += cs * d2 * xi;
          }
          dx[s] += cs * d1;
        }
      }
      dx[0] = dx0;
      db += dx0;
#pragma unroll
      for (int s = 0; s < S; ++s) g[(s * tp + p) * ks + c] = dx[s] * scl;
    }
    dbs[q * ks + c] = db;
  }
}

// dW_li += H^T . G over the tile's points and streams, db_li += the
// point-group sums in dbs; into the block's row of partial gradients.
// A thread owns one output column c and four input rows k..k+3.
template <int S>
__device__ __forceinline__ void weight_grad(const float* __restrict__ hin,
                                            const float* __restrict__ g,
                                            const float* __restrict__ dbs,
                                            const Net& net, int li,
                                            float* __restrict__ part) {
  constexpr int PT = kPointsPerThread;
  const int tp = net.tp;
  const int ks = net.ks;
  const int K = net.dims[li];
  const int K4 = (K + 3) & ~3;
  const int dout = net.dims[li + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_slots = (dout + 31) >> 5;
  const int n_units = (K4 / 4) * n_slots;
  float* __restrict__ dW = part + net.w_off[li];
  float* __restrict__ db = part + net.b_off[li];

  for (int u = warp; u < n_units; u += kWarps) {
    const int k = (u / n_slots) * 4;
    const int c = (u % n_slots) * 32 + lane;
    if (c >= dout) continue;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      for (int p = 0; p < tp; ++p) {
        const int r = (s * tp + p) * ks;
        const float4 h = *reinterpret_cast<const float4*>(hin + r + k);
        const float gv = g[r + c];
        a0 = fmaf(h.x, gv, a0);
        a1 = fmaf(h.y, gv, a1);
        a2 = fmaf(h.z, gv, a2);
        a3 = fmaf(h.w, gv, a3);
      }
    }
    dW[(size_t)k * dout + c] += a0;
    if (k + 1 < K) dW[(size_t)(k + 1) * dout + c] += a1;
    if (k + 2 < K) dW[(size_t)(k + 2) * dout + c] += a2;
    if (k + 3 < K) dW[(size_t)(k + 3) * dout + c] += a3;
    if (k == 0) {
      float sum = 0.f;
      for (int q = 0; q < tp / PT; ++q) sum += dbs[q * ks + c];
      db[c] += sum;
    }
  }
}

// dH of layer li's input: hout[s, p, k] = sum_c g[s, p, c] * W[k, c].
// A thread owns one input column k of four points, all S streams in
// registers (B1's layout with W transposed).
template <int S>
__device__ __forceinline__ void input_cotangent(const float* __restrict__ g,
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
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_slots = (K4 + 31) >> 5;
  const int n_units = (tp / PT) * n_slots;

  for (int u = warp; u < n_units; u += kWarps) {
    const int pb = (u / n_slots) * PT;
    const int k = (u % n_slots) * 32 + lane;
    if (k >= K4) continue;
    if (k >= K) {
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int pt = 0; pt < PT; ++pt) hout[(s * tp + pb + pt) * ks + k] = 0.f;
      continue;
    }
    float acc[PT][S];
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
#pragma unroll
      for (int s = 0; s < S; ++s) acc[pt][s] = 0.f;
    const float* __restrict__ Wk = W + (size_t)k * dout;
    for (int c = 0; c < dout4; c += 4) {
      const float w0 = __ldg(Wk + c);
      const float w1 = c + 1 < dout ? __ldg(Wk + c + 1) : 0.f;
      const float w2 = c + 2 < dout ? __ldg(Wk + c + 2) : 0.f;
      const float w3 = c + 3 < dout ? __ldg(Wk + c + 3) : 0.f;
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float4 gv = *reinterpret_cast<const float4*>(
              g + (s * tp + pb + pt) * ks + c);
          float a = acc[pt][s];
          a = fmaf(gv.x, w0, a);
          a = fmaf(gv.y, w1, a);
          a = fmaf(gv.z, w2, a);
          a = fmaf(gv.w, w3, a);
          acc[pt][s] = a;
        }
      }
    }
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
#pragma unroll
      for (int s = 0; s < S; ++s) hout[(s * tp + pb + pt) * ks + k] = acc[pt][s];
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads, 2)
taylor2_bwd_kernel(const float* __restrict__ z, long long n,
                   const __grid_constant__ Net net,
                   const float* __restrict__ ct, float* __restrict__ workspace,
                   float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  const size_t buf = (size_t)S * net.tp * net.ks;
  float* bufs[3] = {reinterpret_cast<float*>(smem4),
                    reinterpret_cast<float*>(smem4) + buf,
                    reinterpret_cast<float*>(smem4) + 2 * buf};
  float* dbs = bufs[2] + buf;
  float* ws = workspace + blockIdx.x * net.ws_stride;
  float* part = partial + blockIdx.x * net.n_params;
  const int L = net.n_layers;
  const long long n_tiles = (n + net.tp - 1) / net.tp;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long p0 = tile * net.tp;
    // ---- forward recompute; X of every hidden layer to the workspace
    float* h = bufs[0];
    float* g = bufs[1];
    float* t = bufs[2];
    build_features<S>(z, n, p0, net, h);
    __syncthreads();
    for (int li = 0; li < L - 1; ++li) {
      forward_layer<S>(h, g, ws + net.ws_off[li], net, li);
      __syncthreads();
      float* tmp = h;
      h = g;
      g = tmp;
    }
    // ---- output layer (h holds its input)
    output_cotangent<S>(ct, n, p0, net, g, dbs);
    __syncthreads();
    weight_grad<S>(h, g, dbs, net, L - 1, part);
    if (L > 1) input_cotangent<S>(g, t, net, L - 1);
    __syncthreads();
    {
      float* tmp = g;
      g = t;
      t = tmp;
    }
    // ---- hidden layers, last to first
    for (int li = L - 2; li >= 0; --li) {
      hidden_cotangent<S>(g, ws + net.ws_off[li], net, li, dbs);
      if (li == 0) {
        build_features<S>(z, n, p0, net, h);
      } else {
        recompute_input<S>(h, ws + net.ws_off[li - 1], net, li);
      }
      __syncthreads();
      weight_grad<S>(h, g, dbs, net, li, part);
      if (li > 0) input_cotangent<S>(g, t, net, li);
      __syncthreads();
      float* tmp = g;
      g = t;
      t = tmp;
    }
  }
}

// grad[j] = sum over blocks of partial[block, j], blocks in order.
__global__ void sum_partials(const float* __restrict__ partial, int n_blocks,
                             long long n_params, float* __restrict__ grad) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_params) return;
  float s = 0.f;
  for (int bl = 0; bl < n_blocks; ++bl) s += partial[(size_t)bl * n_params + j];
  grad[j] = s;
}

template <int S>
int launch(const float* z, long long n, const Net& net, const float* ct,
           int n_blocks, float* workspace, float* partial, float* grad,
           cudaStream_t stream) {
  const size_t smem =
      (3ull * S * net.tp * net.ks + (size_t)(net.tp / kPointsPerThread) * net.ks) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      taylor2_bwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  taylor2_bwd_kernel<S><<<n_blocks, kThreads, smem, stream>>>(
      z, n, net, ct, workspace, partial);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long red_blocks = (net.n_params + kThreads - 1) / kThreads;
  sum_partials<<<(unsigned)red_blocks, kThreads, 0, stream>>>(
      partial, n_blocks, net.n_params, grad);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Sizes the wrapper allocates: n_params floats of gradient, n_blocks rows
// of n_params partials, n_blocks * ws_stride floats of workspace.
long long tpinn_taylor2_bwd_ws_stride(int n_layers, const int* dims,
                                      int n_streams, int tile_points) {
  long long total = 0;
  for (int l = 0; l + 1 < n_layers; ++l)
    total += (long long)n_streams * tile_points * dims[l + 1];
  return total;
}

// Error codes below 0: the arguments are outside what the kernel takes.
int tpinn_taylor2_bwd(const float* z, long long n, int d, const int* kinds,
                      const float* lb, const float* ub, int pad_to, int n_layers,
                      const void* const* w, const void* const* b,
                      const int* dims, int n_streams, const int* st_kind,
                      const int* st_i, const int* st_j, const int* st_pi,
                      const int* st_pj, int act_first, int act_hidden,
                      float scl, float epsil, int tile_points, const float* ct,
                      int n_blocks, float* workspace, long long ws_stride,
                      float* partial, float* grad, void* stream) {
  if (n <= 0) return -1;
  if (d < 1 || d > kMaxCoords) return -2;
  if (n_layers < 1 || n_layers > kMaxLayers) return -3;
  if (n_streams < 1 || n_streams > kMaxStreams) return -4;
  if (tile_points < kPointsPerThread || tile_points % kPointsPerThread) return -5;
  if (dims[0] > kMaxFeatures || dims[n_layers] != 1) return -6;
  if (n_blocks < 1) return -10;

  Net net;
  int widest = 0;
  long long off = 0;
  long long ws_off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return -6;
    net.dims[l] = dims[l];
    if (l < n_layers && dims[l] > widest) widest = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    net.w[l] = static_cast<const float*>(w[l]);
    net.b[l] = static_cast<const float*>(b[l]);
    net.w_off[l] = off;
    off += (long long)dims[l] * dims[l + 1];
    net.b_off[l] = off;
    off += dims[l + 1];
    net.ws_off[l] = ws_off;
    if (l + 1 < n_layers) ws_off += (long long)n_streams * tile_points * dims[l + 1];
  }
  net.n_params = off;
  if (ws_off != ws_stride) return -10;
  net.ws_stride = ws_stride;
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
  const size_t smem =
      (3ull * n_streams * net.tp * net.ks + (size_t)(net.tp / kPointsPerThread) * net.ks) *
      sizeof(float);
  if (smem > 232448ull) return -9;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_streams) {
    case 1: return launch<1>(z, n, net, ct, n_blocks, workspace, partial, grad, s);
    case 2: return launch<2>(z, n, net, ct, n_blocks, workspace, partial, grad, s);
    case 3: return launch<3>(z, n, net, ct, n_blocks, workspace, partial, grad, s);
    case 4: return launch<4>(z, n, net, ct, n_blocks, workspace, partial, grad, s);
    case 5: return launch<5>(z, n, net, ct, n_blocks, workspace, partial, grad, s);
    case 6: return launch<6>(z, n, net, ct, n_blocks, workspace, partial, grad, s);
    case 7: return launch<7>(z, n, net, ct, n_blocks, workspace, partial, grad, s);
    case 8: return launch<8>(z, n, net, ct, n_blocks, workspace, partial, grad, s);
    case 9: return launch<9>(z, n, net, ct, n_blocks, workspace, partial, grad, s);
    case 10: return launch<10>(z, n, net, ct, n_blocks, workspace, partial, grad, s);
  }
  return -4;
}

}  // extern "C"
