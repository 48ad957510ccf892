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
// What bounds it on the card: fp32 FMAs on the CUDA cores, about
// 2*S*W*W FLOP per point and hidden layer, and the shared-memory loads
// that feed them.  Device traffic is the points in, the weights (a few
// hundred KB, read once per block) and [N, S] floats out.
//
// Design:
// - A persistent grid of at most one block per SM.  Block b walks the
//   point tiles b, b + grid, b + 2 grid, ... (TP points each; the wrapper
//   chooses TP, the grid and the block's threads from the sizes alone).
// - The weights live in shared memory, staged by cp.async, in one of
//   three modes the wrapper chooses:
//     resident: every hidden layer's W beside the two stream buffers,
//               staged once per block before its first tile;
//     layer:    each layer's W staged per tile, in chunks of KC rows
//               where the whole does not fit, the next layer's copy
//               issued behind the current layer's epilogue;
//     l1:       for the widest nets, whose stream buffers alone nearly
//               fill the block, W read from device memory through L1.
// - Each layer's product is register-tiled, with the Taylor-2 activation
//   in registers as its epilogue.  Up to S = 7 a pair of lanes owns one
//   point's S streams x 8 columns; each lane takes every other step of 4
//   along the reduction, loading eight float4 of W and S float4 of the
//   streams for 32 S FMAs, then the pair swaps halves by one shuffle a
//   value, so that each lane holds 4 columns summed over the whole
//   reduction.  At S = 8-10 (the 8 S accumulators would not fit) a thread
//   owns one point's S streams x 4 columns, four float4 of W and S of the
//   streams for 16 S FMAs.  Shared-memory bandwidth bounds these loops:
//   measured on the H100, the product's cycles follow four 128-byte
//   wavefronts for each warp's 16-byte load, broadcast or not.  The 8
//   columns cut the loads per FMA from (4 + S) / 16 S to (8 + S) / 32 S
//   (0.113 to 0.081 at S = 5).  A warp spans one or two
//   points, so its loads of the streams are broadcasts and its stores
//   write whole rows.  Rows of the stream buffers and of the staged W are
//   padded to a stride of 4 mod 8 floats and each lane of a pair loads its
//   own 4 columns first, so the lanes of a quarter-warp fall on distinct
//   banks.
// - The output layer is the last hidden layer's epilogue: each thread
//   dots its 4 columns of each stream with w_out; the partial sums of a
//   point are added in shared memory in a fixed order, the bias goes on
//   the value stream, times epsil, and the [TP, S] block of the output is
//   stored in one coalesced pass.
// - The stream plan is a runtime argument; the pairs' partners X_i, X_j
//   are picked by multiply-adds with 0/1 weights from the parameter
//   block, so the per-stream arrays stay in registers.
// - Plain fp32 FMA (up to S = 7 the even and the odd steps of 4 along
//   the reduction each summed in k order, then added): no TF32 or bf16,
//   which would spoil the second derivative streams.  The TPU kernel's three-pass
//   bf16 split (dot_f32) existed only because Mosaic refused
//   full-precision dots.
// - The ragged last tile is masked; the TPU version padded z instead.
// - Shared memory: [W (resident: the whole net; layer: KC rows)]
//   [stream buffer 0][stream buffer 1].
//
// Plain C interface (no PyTorch headers), loaded with ctypes: every call
// returns 0 or an error code (cudaGetLastError after the launch, or a
// negative code for arguments the kernel does not take).

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kMaxCoords = 4;
constexpr int kMaxStreams = 10;   // 1 + 3 firsts + 6 pairs for 3 coordinates
constexpr int kMaxFeatures = 16;
// 16 warps, four on each of the SM's schedulers: a 64-wide layer on 32
// points, an 80-wide one on 24 (15 warps) take one thread per 4 columns
// of a point.  Four warps a scheduler cap a thread at 128 registers
constexpr int kMaxThreads = 512;
constexpr long long kSmemLimit = 232448;

// feature kinds and activations, as numbered by the Python wrapper
constexpr int kMinmax = 0;
constexpr int kPeriodic = 1;
constexpr int kIdentity = 2;
constexpr int kTanh = 0;

// stream kinds
constexpr int kValue = 0;
constexpr int kFirst = 1;
constexpr int kPair = 2;

// where the weights are read from (the wrapper's Plan.w_mode)
constexpr int kResident = 0;
constexpr int kLayer = 1;
constexpr int kL1 = 2;

struct Net {
  const float* w[kMaxLayers];   // [dims[l], dims[l+1]] row-major
  const float* b[kMaxLayers];   // [dims[l+1]]
  int w_off[kMaxLayers];        // resident: hidden layer l's W in the W region
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
  // pair stream s: sel_i[s][q] = 1 where q is the stream of its X_i, else 0
  float sel_i[kMaxStreams][kMaxStreams];
  float sel_j[kMaxStreams][kMaxStreams];
  int act_first;
  int act_hidden;
  float scl;
  float epsil;
  int tp;                       // points per tile
  int rows;                     // S * tp: rows of a stream buffer
  int ks;                       // row stride of the buffers and of staged W
  int w_mode;
  int kc;                       // rows of W staged at once (resident: all)
};

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ __forceinline__ int round8(int x) { return (x + 7) & ~7; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cp_async4(float* smem_dst, const float* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* smem_dst, const float* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

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

// sum_q sel[q] x[q] over the streams after the value: x of the one q
// whose weight is 1 (a runtime index into x[] would push the array out of
// registers)
template <int S>
__device__ __forceinline__ float pick(const float (&sel)[kMaxStreams],
                                      const float (&x)[S]) {
  float v = 0.f;
#pragma unroll
  for (int q = 1; q < S; ++q) v = fmaf(sel[q], x[q], v);
  return v;
}

// Stream values of one (point, column) after the activation; x[] holds X
// (bias not added).
template <int S>
__device__ __forceinline__ void taylor_act(const Net& net, int act, float bc,
                                           const float (&x)[S], float (&h)[S]) {
  float a, d1, d2;
  act_derivs(act, x[0] + bc, a, d1, d2);
  h[0] = a;
#pragma unroll
  for (int s = 1; s < S; ++s) {
    if (net.st_kind[s] == kFirst) {
      h[s] = d1 * x[s];
    } else {
      const float xi = pick<S>(net.sel_i[s], x);
      const float xj = pick<S>(net.sel_j[s], x);
      h[s] = d2 * xi * xj + d1 * x[s];
    }
  }
}

// Feature streams of the tile's points into h: row (s, p) holds the nf
// feature columns of stream s at point p, zero-padded to a multiple of 4;
// a thread writes one row.
template <int S>
__device__ __forceinline__ void build_features(const float* __restrict__ z,
                                               long long n, long long p0,
                                               const Net& net, float* h) {
  const int k4 = round4(net.nf);
  for (int e = threadIdx.x; e < S * net.tp; e += blockDim.x) {
    const int s = e / net.tp;
    const int p = e - s * net.tp;
    const long long gp = p0 + p;
    const bool valid = gp < n;
    float* row = h + e * net.ks;
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

// Issue the copy of rows [k0, k0 + nrows) of layer li's W into wsm (row
// stride ks), zero-padded to a multiple of 4 rows and of 8 columns: 16
// bytes a copy where the rows allow it, else 4.  The caller waits
// (cp_async_wait_all, then a barrier) before reading it.
__device__ __forceinline__ void stage_w(const Net& net, int li, int k0,
                                        int nrows, float* __restrict__ wsm) {
  const int K = net.dims[li];
  const int C = net.dims[li + 1];
  const int C8 = round8(C);
  const int nr = min(nrows, K - k0);
  const int nr4 = round4(nr);
  const float* __restrict__ src = net.w[li] + (size_t)k0 * C;
  if ((C & 3) == 0 && (reinterpret_cast<size_t>(src) & 15) == 0) {
    const int q8 = C8 >> 2;
    for (int e = threadIdx.x; e < nr4 * q8; e += blockDim.x) {
      const int r = e / q8;
      const int c = (e - r * q8) << 2;
      float* dst = wsm + r * net.ks + c;
      if (r < nr && c < C) {
        cp_async16(dst, src + (size_t)r * C + c);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < nr4 * C8; e += blockDim.x) {
    const int r = e / C8;
    const int c = e - r * C8;
    float* dst = wsm + r * net.ks + c;
    if (r < nr && c < C) {
      cp_async4(dst, src + (size_t)r * C + c);
    } else {
      *dst = 0.f;
    }
  }
}

__device__ __forceinline__ void wait_w() {
  cp_async_wait_all();
  __syncthreads();
}

// Columns of W a thread's product covers: 8 (a lane pair splitting the
// reduction, below) up to S = 7; at S = 8-10 the 8 S accumulators and
// their operands would not fit the 128 registers a thread has, and a
// thread takes 4 columns over the whole reduction.
template <int S>
__host__ __device__ constexpr int product_cols() { return S <= 7 ? 8 : 4; }

// Threads for one point of a layer C wide.
template <int S>
__host__ __device__ __forceinline__ int threads_per_point(int C) {
  return product_cols<S>() == 8 ? 2 * (round8(C) >> 3) : round4(C) >> 2;
}

// acc[s][j] += sum of a[s][k] w[k][c_j] over k: a_row points at the
// thread's point in stream 0 (streams s_stride floats apart), w at the
// staged W (rows ks floats apart).  CT = 8: the steps of 4 rows k0 = 4
// half, 4 half + 8, ... below k4, columns w_c0 .. +3 into acc[.][0..3]
// and w_c1 .. +3 into acc[.][4..7].  CT = 4: every step, columns w_c0 ..
// +3.
template <int S, int CT>
__device__ __forceinline__ void product_smem(const float* __restrict__ a_row,
                                             const float* __restrict__ w,
                                             int w_c0, int w_c1, int k4,
                                             int half, int s_stride, int ks,
                                             float (&acc)[S][CT]) {
  const int step = CT == 8 ? 8 : 4;
  for (int k = CT == 8 ? 4 * half : 0; k < k4; k += step) {
    float4 b[4][CT / 4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      b[q][0] = ld4(w + (k + q) * ks + w_c0);
      if constexpr (CT == 8) b[q][CT / 4 - 1] = ld4(w + (k + q) * ks + w_c1);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float4 a = ld4(a_row + s * s_stride + k);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < CT; ++j)
          acc[s][j] = fmaf(at(a, q), at(b[q][j >> 2], j & 3), acc[s][j]);
    }
  }
}

// The same product with W [K, C] read from device memory through L1
// (zero past K and C).
template <int S, int CT>
__device__ __forceinline__ void product_l1(const float* __restrict__ a_row,
                                           const float* __restrict__ W, int K,
                                           int C, int c0, int c1, int half,
                                           int s_stride, float (&acc)[S][CT]) {
  const int k4 = round4(K);
  const int step = CT == 8 ? 8 : 4;
  for (int k = CT == 8 ? 4 * half : 0; k < k4; k += step) {
    float b[4][CT];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int c = (j < 4 ? c0 : c1) + (j & 3);
        b[q][j] = k + q < K && c < C ? __ldg(W + (size_t)(k + q) * C + c) : 0.f;
      }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float4 a = ld4(a_row + s * s_stride + k);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < CT; ++j)
          acc[s][j] = fmaf(at(a, q), b[q][j], acc[s][j]);
    }
  }
}

// Hidden layer li: X = (H W) * scl, then its Taylor-2 activation into hout
// (pad columns zero).  For the last hidden layer the output layer is the
// epilogue instead: hout[(s, p), tx] gets the dot of columns 4 tx ..
// 4 tx + 3 of stream s with w_out.
//
// Up to S = 7 a lane pair owns point p's S streams x the 8 columns 8 g ..
// 8 g + 7.  Lane `half` of the pair keeps the 4 columns 4 tx .. 4 tx + 3,
// tx = 2 g + kb, kb = half ^ (p & 1), sums the steps of 4 rows of parity
// `half` for all 8 columns, and then takes its partner's sums of the
// other parity for its 4 columns (one shuffle each): each lane ends with
// its columns summed over the whole reduction.  Each lane loads its kept
// columns of W first; with rows a stride of 4 mod 8 floats apart, the 8
// lanes of a quarter-warp then fall on distinct banks, also where the
// quarter-warp spans two points.  At S = 8-10 a thread owns point p's S
// streams x columns 4 tx .. 4 tx + 3 over the whole reduction.
//
// In the layer mode chunk 0 of W is staged (or in flight) on entry, and
// after the last reads of W the copy of chunk 0 of the next layer starts,
// behind the epilogue.
template <int S>
__device__ __forceinline__ void forward_layer(const float* __restrict__ hin,
                                              float* __restrict__ hout,
                                              float* __restrict__ wsm,
                                              const Net& net, int li) {
  constexpr int CT = product_cols<S>();
  const int tp = net.tp;
  const int ks = net.ks;
  const int K = net.dims[li];
  const int C = net.dims[li + 1];
  const int per_point = threads_per_point<S>(C);
  const int n_t = tp * per_point;
  const int rounds = (n_t + blockDim.x - 1) / blockDim.x;
  const bool last = li == net.n_layers - 2;
  const int mode = net.w_mode;
  const int kc = mode == kLayer ? net.kc : K;
  const bool chunked = kc < K;
  const float* __restrict__ wl = mode == kResident ? wsm + net.w_off[li] : wsm;
  const float scl = li == 0 ? net.scl : 1.f;
  const int act = li == 0 ? net.act_first : net.act_hidden;
  const float* __restrict__ B = net.b[li];
  const int half = threadIdx.x & 1;
  for (int m = 0; m < rounds; ++m) {
    const int t = threadIdx.x + m * blockDim.x;
    const bool active = t < n_t;
    const int p = t / per_point;
    int tx, c1;   // kept columns 4 tx .., the other block's first column
    if constexpr (CT == 8) {
      const int g = (t - p * per_point) >> 1;
      const int kb = half ^ (p & 1);
      tx = 2 * g + kb;
      c1 = 8 * g + 4 * (kb ^ 1);
    } else {
      tx = t - p * per_point;
      c1 = 0;
    }
    const int c0 = 4 * tx;
    float acc[S][CT];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[s][j] = 0.f;
    if (mode == kL1) {
      if (active)
        product_l1<S, CT>(hin + p * ks, net.w[li], K, C, c0, c1, half,
                          tp * ks, acc);
    } else {
      for (int k0 = 0; k0 < K; k0 += kc) {
        if (mode == kLayer) {
          if (k0 > 0 || (m > 0 && chunked)) {
            __syncthreads();
            stage_w(net, li, k0, kc, wsm);
          }
          if (m == 0 || chunked) wait_w();
        }
        if (!active) continue;
        product_smem<S, CT>(hin + p * ks + k0, wl, c0, c1,
                            round4(min(kc, K - k0)), half, tp * ks, ks, acc);
      }
    }
    if (mode == kLayer && m == rounds - 1 && !last) {
      __syncthreads();
      stage_w(net, li + 1, 0, kc, wsm);
    }
    // x[s][j]: X of the kept columns, times scl
    float x[S][4];
    if constexpr (CT == 8) {
      // the pair's swap: both lanes of a pair are active or neither, and
      // the whole warp takes part
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          x[s][j] = (acc[s][j] +
                     __shfl_xor_sync(0xffffffffu, acc[s][4 + j], 1)) * scl;
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int j = 0; j < 4; ++j) x[s][j] = acc[s][j] * scl;
    }
    if (!active || c0 >= C) continue;
    float bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bias[j] = c0 + j < C ? __ldg(B + c0 + j) : 0.f;
    // the Taylor-2 activation, stream by stream over the 4 columns (the
    // stream kind is uniform, so each branch holds the 4 columns' work)
    float h[S][4], d1[4], d2[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      act_derivs(act, x[0][j] + bias[j], h[0][j], d1[j], d2[j]);
    }
#pragma unroll
    for (int s = 1; s < S; ++s) {
      if (net.st_kind[s] == kFirst) {
#pragma unroll
        for (int j = 0; j < 4; ++j) h[s][j] = d1[j] * x[s][j];
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float xs[S];
#pragma unroll
          for (int q = 0; q < S; ++q) xs[q] = x[q][j];
          const float xi = pick<S>(net.sel_i[s], xs);
          const float xj = pick<S>(net.sel_j[s], xs);
          h[s][j] = d2[j] * xi * xj + d1[j] * x[s][j];
        }
      }
    }
    if (!last) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        *reinterpret_cast<float4*>(hout + (s * tp + p) * ks + c0) =
            make_float4(h[s][0], h[s][1], h[s][2], h[s][3]);
    } else {
      const float* __restrict__ wo = net.w[li + 1];
      float wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = c0 + j < C ? __ldg(wo + c0 + j) : 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) part = fmaf(h[s][j], wv[j], part);
        hout[(s * tp + p) * ks + tx] = part;
      }
    }
  }
}

// out[p, s] = epsil * (sum over tx of part[(s, p), tx] (+ b on s == 0)):
// the partial dots of the last hidden layer's epilogue, added in column
// order; one coalesced store of the tile's [TP, S] block.
template <int S>
__device__ __forceinline__ void store_output(const float* __restrict__ part,
                                             const Net& net, long long n,
                                             long long p0,
                                             float* __restrict__ out) {
  const int li = net.n_layers - 1;
  const int tx_n = round4(net.dims[li]) >> 2;
  const float bias = __ldg(net.b[li]);
  for (int e = threadIdx.x; e < S * net.tp; e += blockDim.x) {
    const int p = e / S;
    const int s = e - p * S;
    const long long gp = p0 + p;
    if (gp >= n) continue;
    const float* r = part + (s * net.tp + p) * net.ks;
    float v = 0.f;
    for (int tx = 0; tx < tx_n; ++tx) v += r[tx];
    if (s == 0) v += bias;
    out[gp * S + s] = v * net.epsil;
  }
}

// A net with no hidden layer: out[p, s] = epsil * ((H_s[p] . w) * scl
// (+ b on s == 0)).
template <int S>
__device__ __forceinline__ void linear_output(const float* __restrict__ h,
                                              const Net& net, long long n,
                                              long long p0,
                                              float* __restrict__ out) {
  const float* __restrict__ W = net.w[0];
  const float bias = __ldg(net.b[0]);
  for (int e = threadIdx.x; e < S * net.tp; e += blockDim.x) {
    const int p = e / S;
    const int s = e - p * S;
    const long long gp = p0 + p;
    if (gp >= n) continue;
    const float* r = h + (s * net.tp + p) * net.ks;
    float v = 0.f;
    for (int k = 0; k < net.nf; ++k) v = fmaf(r[k], __ldg(W + k), v);
    v *= net.scl;
    if (s == 0) v += bias;
    out[gp * S + s] = v * net.epsil;
  }
}

template <int S>
__global__ void __launch_bounds__(kMaxThreads, 1)
taylor2_fwd_kernel(const float* __restrict__ z, long long n,
                   const __grid_constant__ Net net, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* const wsm = reinterpret_cast<float*>(smem4);
  float* const b0 = wsm + net.kc * net.ks;
  float* const b1 = b0 + net.rows * net.ks;
  const int L = net.n_layers;
  const long long n_tiles = (n + net.tp - 1) / net.tp;

  if (net.w_mode == kResident) {
    for (int l = 0; l < L - 1; ++l)
      stage_w(net, l, 0, net.dims[l], wsm + net.w_off[l]);
  }
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long p0 = tile * net.tp;
    if (net.w_mode == kLayer) stage_w(net, 0, 0, net.kc, wsm);
    build_features<S>(z, n, p0, net, b0);
    cp_async_wait_all();
    __syncthreads();
    float* h = b0;
    float* g = b1;
    for (int li = 0; li < L - 1; ++li) {
      forward_layer<S>(h, g, wsm, net, li);
      __syncthreads();
      float* tmp = h;
      h = g;
      g = tmp;
    }
    if (L > 1) {
      store_output<S>(h, net, n, p0, out);
    } else {
      linear_output<S>(h, net, n, p0, out);
    }
    // the next tile's features overwrite buffer 0
    __syncthreads();
  }
}

// bytes of shared memory of a block: [W region][two stream buffers]
long long smem_bytes(const Net& net) {
  return 4ll * net.ks * ((long long)net.kc + 2ll * net.rows);
}

template <int S>
int launch(const float* z, long long n, const Net& net, int n_blocks,
           int threads, float* out, cudaStream_t stream) {
  // the attribute is set once per device for each instance, not per launch
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  if ((ready.load() & bit) == 0) {
    e = cudaFuncSetAttribute(taylor2_fwd_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    ready.fetch_or(bit);
  }
  taylor2_fwd_kernel<S><<<n_blocks, threads, smem_bytes(net), stream>>>(
      z, n, net, out);
  return (int)cudaGetLastError();
}

// The sizes of a plan: tile, rows of W staged at once, row stride; the
// W region's offsets.  Returns 0, or the error code of a plan the kernel
// does not take.
int plan_net(int n_layers, const int* dims, int n_streams, int tile_points,
             int w_mode, int w_rows, int row_floats, Net& net) {
  int widest = 0;
  int k_max = 0;
  int resident_rows = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return -6;
    net.dims[l] = dims[l];
    if (l < n_layers && dims[l] > widest) widest = dims[l];
  }
  for (int l = 0; l + 1 < n_layers; ++l) {
    net.w_off[l] = resident_rows * row_floats;
    resident_rows += round4(dims[l]);
    if (round4(dims[l]) > k_max) k_max = round4(dims[l]);
  }
  // staged W is read up to 8 columns at a time, the stream buffers 4
  if (row_floats % 4 ||
      row_floats < (w_mode == kL1 ? round4(widest) : round8(widest)))
    return -12;
  if (w_mode == kResident) {
    if (w_rows != resident_rows) return -11;
  } else if (w_mode == kLayer) {
    if (n_layers < 2 || w_rows < 4 || w_rows % 4 || w_rows > k_max) return -11;
  } else if (w_mode == kL1) {
    if (w_rows != 0) return -11;
  } else {
    return -11;
  }
  net.n_layers = n_layers;
  net.tp = tile_points;
  net.rows = n_streams * tile_points;
  net.ks = row_floats;
  net.w_mode = w_mode;
  net.kc = w_rows;
  return smem_bytes(net) > kSmemLimit ? -9 : 0;
}

}  // namespace

extern "C" {

// Most threads a block may have, and the bytes of shared memory of one
// block of a plan, for the wrapper to check its own arithmetic against
// (-1 for a plan the kernel refuses).
int tpinn_taylor2_fwd_max_threads() { return kMaxThreads; }

long long tpinn_taylor2_fwd_smem(int n_layers, const int* dims, int n_streams,
                                 int tile_points, int w_mode, int w_rows,
                                 int row_floats) {
  Net net;
  if (n_layers < 1 || n_layers > kMaxLayers) return -1;
  if (plan_net(n_layers, dims, n_streams, tile_points, w_mode, w_rows,
               row_floats, net) != 0)
    return -1;
  return smem_bytes(net);
}

// Error codes below 0: the arguments are outside what the kernel takes.
// w_mode: 0 resident, 1 layer, 2 l1; w_rows: rows of W staged at once (the
// whole net's, padded to 4 per layer, when resident; 0 for l1);
// row_floats: row stride of the stream buffers and staged W.
int tpinn_taylor2_fwd(const float* z, long long n, int d, const int* kinds,
                      const float* lb, const float* ub, int pad_to, int n_layers,
                      const void* const* w, const void* const* b,
                      const int* dims, int n_streams, const int* st_kind,
                      const int* st_i, const int* st_j, const int* st_pi,
                      const int* st_pj, int act_first, int act_hidden,
                      float scl, float epsil, int tile_points, int n_blocks,
                      int threads, int w_mode, int w_rows, int row_floats,
                      float* out, void* stream) {
  if (n <= 0) return -1;
  if (d < 1 || d > kMaxCoords) return -2;
  if (n_layers < 1 || n_layers > kMaxLayers) return -3;
  if (n_streams < 1 || n_streams > kMaxStreams) return -4;
  if (tile_points < 4 || tile_points % 4) return -5;
  if (dims[0] > kMaxFeatures || dims[n_layers] != 1) return -6;
  if (n_blocks < 1 || threads < 32 || threads > kMaxThreads || threads % 32)
    return -10;

  Net net;
  const int err = plan_net(n_layers, dims, n_streams, tile_points, w_mode,
                           w_rows, row_floats, net);
  if (err != 0) return err;
  for (int l = 0; l < n_layers; ++l) {
    net.w[l] = static_cast<const float*>(w[l]);
    net.b[l] = static_cast<const float*>(b[l]);
  }
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
    if (st_kind[s] == kPair &&
        (st_pi[s] < 1 || st_pi[s] >= n_streams || st_pj[s] < 1 ||
         st_pj[s] >= n_streams))
      return -8;
    for (int q = 0; q < kMaxStreams; ++q) {
      net.sel_i[s][q] = st_kind[s] == kPair && q == st_pi[s] ? 1.f : 0.f;
      net.sel_j[s][q] = st_kind[s] == kPair && q == st_pj[s] ? 1.f : 0.f;
    }
  }
  net.act_first = act_first;
  net.act_hidden = act_hidden;
  net.scl = scl;
  net.epsil = epsil;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_streams) {
    case 1: return launch<1>(z, n, net, n_blocks, threads, out, s);
    case 2: return launch<2>(z, n, net, n_blocks, threads, out, s);
    case 3: return launch<3>(z, n, net, n_blocks, threads, out, s);
    case 4: return launch<4>(z, n, net, n_blocks, threads, out, s);
    case 5: return launch<5>(z, n, net, n_blocks, threads, out, s);
    case 6: return launch<6>(z, n, net, n_blocks, threads, out, s);
    case 7: return launch<7>(z, n, net, n_blocks, threads, out, s);
    case 8: return launch<8>(z, n, net, n_blocks, threads, out, s);
    case 9: return launch<9>(z, n, net, n_blocks, threads, out, s);
    case 10: return launch<10>(z, n, net, n_blocks, threads, out, s);
  }
  return -4;
}

}  // extern "C"
