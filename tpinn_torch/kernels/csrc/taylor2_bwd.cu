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
// and dX W^T).  Device traffic: the points and cotangents in, one row of
// partial gradients per block out, and a per-block workspace of
// pre-activations and layer outputs, most of it held in L2.
//
// Design:
// - A persistent grid of at most one block per SM.  Block b walks the
//   point tiles b, b + grid, b + 2 grid, ... (TP points each; the wrapper
//   chooses TP and the grid so that every block gets the same number of
//   tiles, or one fewer).
// - The gradient is summed on chip where it fits: the block keeps its
//   whole dW/db accumulator in shared memory over all its tiles and
//   writes it once, at the end, to its row of a partial buffer
//   [grid, n_params].  Where it does not fit (wide nets), the same code
//   adds each tile's dW/db into that row in device memory instead.  The
//   wrapper chooses the mode from the sizes alone.  Either way the block
//   zeroes its own row or accumulator, each entry belongs to one thread,
//   tiles are visited in a fixed order, and a second kernel sums the rows
//   in block order: the gradient is bitwise repeatable, with no atomics.
// - Per tile the forward is recomputed layer by layer.  The pre-
//   activations X and the outputs H of the hidden layers go to the
//   block's slice of a global workspace (S * TP * round4(W) floats each,
//   45 MB over the grid at 6x80, most of it in the 50 MB L2); the
//   reverse sweep reads X in the products' epilogues and copies H back
//   with cp.async, behind which the next layer's W follows.
// - The three products of a layer are register-tiled fp32 FMA loops over
//   shared memory.  X = H W and dH = dX W^T: a thread owns one point's S
//   streams x 4 columns, loads four float4 of W and S float4 of the
//   streams per step of 4 along the reduction for 16 S FMAs, and applies
//   the elementwise part in registers as the product's epilogue (the
//   Taylor-2 activation after X = H W; the cotangent through phi', phi'',
//   phi''' after dH = dX W^T).  dW += H^T dX: a thread owns a 4x4 block
//   of dW and reduces over the tile's S*TP rows, eight float4 per 64 FMAs.
//   Rows of the stream buffers are padded to a stride of 4 mod 8 floats,
//   so rows read together fall in distinct banks.  No library, no tensor
//   cores, no TF32 or bf16.
// - The stream plan is a runtime argument; the pairs' partners X_i, X_j
//   are picked by multiply-adds with 0/1 weights from the parameter block,
//   so the per-stream arrays stay in registers.
// - The layer's W is staged in shared memory by cp.async, issued while
//   the previous step's epilogue and elementwise work run.  The gradient
//   is kept on chip only beside the whole W.  With the gradient in device
//   memory, a net too wide for the whole W beside the stream buffers
//   (wider than 152 at S = 5 and 20 points a tile) stages it in chunks of
//   KC rows.
// - Shared memory: [accumulator][H][G][W chunk][per-point dx0].
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
// 13 warps: one block of outputs per thread covers each product of an
// 80-wide layer on 20 points
constexpr int kThreads = 416;
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

struct Net {
  const float* w[kMaxLayers];   // [dims[l], dims[l+1]] row-major
  const float* b[kMaxLayers];   // [dims[l+1]]
  long long w_off[kMaxLayers];  // offsets of dW_l, db_l in the flat gradient
  long long b_off[kMaxLayers];
  long long ws_off[kMaxLayers]; // offset of hidden layer l's X in a block's workspace
  long long hs_off[kMaxLayers]; // offset of hidden layer l's output H (l < L - 2)
  long long n_params;
  long long acc_floats;         // n_params rounded up to 4
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
  // pair stream s: sel_i[s][q] = 1 where q is the stream of its X_i, else 0
  float sel_i[kMaxStreams][kMaxStreams];
  float sel_j[kMaxStreams][kMaxStreams];
  int act_first;
  int act_hidden;
  float scl;
  float epsil;
  int tp;                       // points per tile
  int rows;                     // S * tp: rows of a stream buffer
  int ks;                       // row stride of the buffers and of staged W (4 mod 8)
  int kc;                       // rows of W staged at once (multiple of 4)
  int smem_acc;                 // 1: dW/db accumulated in shared memory
};

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// row stride of the stream buffers: the widest row, rounded up to a
// multiple of 4 floats that is 4 mod 8
__host__ __device__ __forceinline__ int row_stride(int widest) {
  const int k = round4(widest);
  return (k & 7) ? k : k + 4;
}

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for all but the most recent committed group of copies
__device__ __forceinline__ void cp_async_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

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
      const float xi = pick<S>(net.sel_i[s], x);
      const float xj = pick<S>(net.sel_j[s], x);
      h[s] = d2 * xi * xj + d1 * x[s];
    }
  }
}

// The cotangent of one (point, column) of hidden layer li through its
// activation: ct[] holds dH, x[] holds X; dx[] gets dX * scl, the return
// value is dx0 (unscaled, for db).
template <int S>
__device__ __forceinline__ float taylor_act_vjp(const Net& net, int li,
                                                float bc, const float (&x)[S],
                                                const float (&ct)[S],
                                                float (&dx)[S]) {
  const float scl = li == 0 ? net.scl : 1.f;
  const int act = li == 0 ? net.act_first : net.act_hidden;
  float a, d1, d2, d3;
  act_derivs(act, x[0] + bc, a, d1, d2, d3);
#pragma unroll
  for (int s = 0; s < S; ++s) dx[s] = 0.f;
  float dx0 = ct[0] * d1;
#pragma unroll
  for (int s = 1; s < S; ++s) {
    const float cs = ct[s];
    if (net.st_kind[s] == kFirst) {
      dx0 += cs * d2 * x[s];
      dx[s] += cs * d1;
    } else {
      const float xi = pick<S>(net.sel_i[s], x);
      const float xj = pick<S>(net.sel_j[s], x);
      dx0 += cs * (d3 * xi * xj + d2 * x[s]);
      // i == j adds both terms to one slot: 2 phi'' X_i, as required
      const float ti = cs * d2 * xj;
      const float tj = cs * d2 * xi;
#pragma unroll
      for (int r = 1; r < S; ++r) {
        dx[r] = fmaf(net.sel_i[s][r], ti, dx[r]);
        dx[r] = fmaf(net.sel_j[s][r], tj, dx[r]);
      }
      dx[s] += cs * d1;
    }
  }
  dx[0] = dx0;
#pragma unroll
  for (int s = 0; s < S; ++s) dx[s] *= scl;
  return dx0;
}

// Feature streams of the tile's points into h (as B1's build_features):
// row (s, p) holds the nf feature columns of stream s at point p,
// zero-padded to a multiple of 4; a thread writes one row.
template <int S>
__device__ __forceinline__ void build_features(const float* __restrict__ z,
                                               long long n, long long p0,
                                               const Net& net, float* h) {
  const int k4 = round4(net.nf);
  for (int e = threadIdx.x; e < S * net.tp; e += kThreads) {
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
    const float first = row[0];
    for (; col < net.pad_to; ++col) row[col] = first;
    for (; col < k4; ++col) row[col] = 0.f;
  }
}

// Issue the copy of rows [k0, k0 + kc) of layer li's W into wsm (row
// stride ks), zero-padded to a multiple of 4 rows and columns: 16 bytes a
// copy where the rows allow it, else 4.  The caller waits (wait_w)
// before reading it.
__device__ __forceinline__ void stage_w(const Net& net, int li, int k0,
                                        float* __restrict__ wsm) {
  const int K = net.dims[li];
  const int C = net.dims[li + 1];
  const int C4 = round4(C);
  const int nr = min(net.kc, K - k0);
  const int nr4 = round4(nr);
  const float* __restrict__ src = net.w[li] + (size_t)k0 * C;
  if ((C & 3) == 0 && (reinterpret_cast<size_t>(src) & 15) == 0) {
    const int q4 = C >> 2;
    for (int e = threadIdx.x; e < nr4 * q4; e += kThreads) {
      const int r = e / q4;
      const int c = (e - r * q4) << 2;
      float* dst = wsm + r * net.ks + c;
      if (r < nr) {
        cp_async16(dst, src + (size_t)r * C + c);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < nr4 * C4; e += kThreads) {
    const int r = e / C4;
    const int c = e - r * C4;
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

// Hidden layer li forward: X = (H W) * scl, H' = its Taylor-2 activation
// into hout (pad columns zero), X to the workspace wsx and, where the
// reverse sweep reads it back (wsh not null), H' to wsh (rows of
// round4(C) floats).  A thread owns point p's S streams x columns
// 4 tx .. 4 tx + 3; a warp spans one or two points, so its loads of H are
// broadcasts and its stores of X whole rows.  Chunk 0 of W is staged (or
// in flight) on entry; after the last reads of W the copy of chunk 0 of
// layer li_next starts, behind the epilogue.
template <int S>
__device__ __forceinline__ void forward_layer(const float* __restrict__ hin,
                                              float* __restrict__ hout,
                                              float* __restrict__ wsm,
                                              float* __restrict__ wsx,
                                              float* __restrict__ wsh,
                                              const Net& net, int li,
                                              int li_next) {
  const int tp = net.tp;
  const int ks = net.ks;
  const int K = net.dims[li];
  const int C = net.dims[li + 1];
  const int tx_n = round4(C) >> 2;
  const int n_t = tp * tx_n;
  const int rounds = (n_t + kThreads - 1) / kThreads;
  const bool chunked = net.kc < K;
  const float scl = li == 0 ? net.scl : 1.f;
  const int act = li == 0 ? net.act_first : net.act_hidden;
  const float* __restrict__ B = net.b[li];
  for (int m = 0; m < rounds; ++m) {
    const int t = threadIdx.x + m * kThreads;
    const bool active = t < n_t;
    const int p = t / tx_n;
    const int tx = t - p * tx_n;
    float acc[S][4];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[s][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += net.kc) {
      if (k0 > 0 || (m > 0 && chunked)) {
        __syncthreads();
        stage_w(net, li, k0, wsm);
      }
      if (m == 0 || chunked) wait_w();
      if (!active) continue;
      const int kc4 = round4(min(net.kc, K - k0));
      const float* __restrict__ a_row = hin + p * ks + k0;
      for (int k = 0; k < kc4; k += 4) {
        float4 b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = ld4(wsm + (k + q) * ks + 4 * tx);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float4 a = ld4(a_row + s * tp * ks + k);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[s][j] = fmaf(at(a, q), at(b[q], j), acc[s][j]);
        }
      }
    }
    if (m == rounds - 1 && li_next >= 0) {
      __syncthreads();
      stage_w(net, li_next, 0, wsm);
    }
    if (!active) continue;
#pragma unroll
    for (int s = 0; s < S; ++s)
      *reinterpret_cast<float4*>(wsx + (s * tp + p) * (4 * tx_n) + 4 * tx) =
          make_float4(acc[s][0] * scl, acc[s][1] * scl, acc[s][2] * scl,
                      acc[s][3] * scl);
    float h[S][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * tx + j;
      float x[S], hj[S];
#pragma unroll
      for (int s = 0; s < S; ++s) x[s] = acc[s][j] * scl;
      if (c < C) {
        taylor_act<S>(net, act, __ldg(B + c), x, hj);
      } else {
#pragma unroll
        for (int s = 0; s < S; ++s) hj[s] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < S; ++s) h[s][j] = hj[s];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float4 v = make_float4(h[s][0], h[s][1], h[s][2], h[s][3]);
      *reinterpret_cast<float4*>(hout + (s * tp + p) * ks + 4 * tx) = v;
      if (wsh != nullptr)
        *reinterpret_cast<float4*>(wsh + (s * tp + p) * (4 * tx_n) + 4 * tx) = v;
    }
  }
}

// Issue the copy of hidden layer li's input H (li >= 1), saved by the
// forward in wsh (rows of round4(K) floats), into hin (row stride ks).
__device__ __forceinline__ void load_input(float* __restrict__ hin,
                                           const float* __restrict__ wsh,
                                           const Net& net, int li) {
  const int q4 = round4(net.dims[li]) >> 2;
  for (int e = threadIdx.x; e < net.rows * q4; e += kThreads) {
    const int r = e / q4;
    const int c = (e - r * q4) << 2;
    cp_async16(hin + r * net.ks + c, wsh + 4 * e);
  }
}

// Output layer: the cotangent of its X is ct * epsil (zero past n), in
// column 0 of g (columns 1-3 zero) times scl; dbs[p] gets the unscaled
// value cotangent of point p (the output bias sums it).
template <int S>
__device__ __forceinline__ void output_cotangent(const float* __restrict__ ct,
                                                 long long n, long long p0,
                                                 const Net& net, float* g,
                                                 float* dbs) {
  const int tp = net.tp;
  const int ks = net.ks;
  const float scl = net.n_layers == 1 ? net.scl : 1.f;
  for (int e = threadIdx.x; e < S * tp; e += kThreads) {
    const int s = e / tp;
    const int p = e - s * tp;
    const long long gp = p0 + p;
    const float v = gp < n ? ct[gp * S + s] * net.epsil : 0.f;
    *reinterpret_cast<float4*>(g + (s * tp + p) * ks) =
        make_float4(v * scl, 0.f, 0.f, 0.f);
    if (s == 0) dbs[p * ks] = v;
  }
}

// dW_li += H^T G over the tile's rows (all streams and points), db_li +=
// the per-point dx0 in dbs; into acc (shared memory or the block's row of
// partial gradients).  A thread owns 4 input rows k x 4 output columns c.
__device__ __forceinline__ void weight_grad(const float* __restrict__ hin,
                                            const float* __restrict__ g,
                                            const float* __restrict__ dbs,
                                            const Net& net, int li,
                                            float* acc) {
  const int ks = net.ks;
  const int K = net.dims[li];
  const int C = net.dims[li + 1];
  const int tx_n = round4(C) >> 2;
  const int n_t = (round4(K) >> 2) * tx_n;
  float* dW = acc + net.w_off[li];
  float* db = acc + net.b_off[li];
  for (int t = threadIdx.x; t < n_t; t += kThreads) {
    const int ty = t / tx_n;
    const int tx = t - ty * tx_n;
    float sum[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sum[i][j] = 0.f;
    for (int r = 0; r < net.rows; r += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = ld4(hin + (r + q) * ks + 4 * ty);
        b[q] = ld4(g + (r + q) * ks + 4 * tx);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sum[i][j] = fmaf(at(a[q], i), at(b[q], j), sum[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * tx + j;
        if (k < K && c < C) dW[(size_t)k * C + c] += sum[i][j];
      }
    }
  }
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int p = 0; p < net.tp; ++p) s += dbs[p * ks + c];
    db[c] += s;
  }
}

// Layer li >= 1: dH = G W^T (G holds layer li's dX * scl), then through
// the activation of layer li - 1, whose X is in wsx: hout gets layer
// li - 1's dX * scl, dbs[p, k] its dx0.  A thread owns point p's S
// streams x 4 columns k strided by the column groups, so that a warp's
// loads of W fall on distinct banks, its loads of dX are broadcasts and
// its loads of X (fetched before the product) whole rows.  Chunk 0 of W
// is staged (or in flight) on entry; each chunk of KC rows of W gives KC
// columns.
template <int S>
__device__ __forceinline__ void input_cotangent(const float* __restrict__ g,
                                                float* __restrict__ hout,
                                                float* __restrict__ wsm,
                                                const float* __restrict__ wsx,
                                                float* __restrict__ dbs,
                                                const Net& net, int li) {
  const int tp = net.tp;
  const int ks = net.ks;
  const int K = net.dims[li];
  const int K4 = round4(K);
  const int C4 = round4(net.dims[li + 1]);
  const float* __restrict__ B = net.b[li - 1];
  for (int k0 = 0; k0 < K; k0 += net.kc) {
    if (k0 > 0) {
      __syncthreads();
      stage_w(net, li, k0, wsm);
    }
    const int tx_n = round4(min(net.kc, K - k0)) >> 2;
    const int n_t = tp * tx_n;
    const int rounds = (n_t + kThreads - 1) / kThreads;
    for (int m = 0; m < rounds; ++m) {
      const int t = threadIdx.x + m * kThreads;
      const bool active = t < n_t;
      const int p = t / tx_n;
      const int tx = t - p * tx_n;
      // X first: its latency overlaps the wait for W
      float x[4][S];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + tx + j * tx_n;
#pragma unroll
        for (int s = 0; s < S; ++s)
          x[j][s] = active && k < K ? wsx[(s * tp + p) * K4 + k] : 0.f;
      }
      if (m == 0) wait_w();
      if (!active) continue;
      float acc[S][4];
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[s][j] = 0.f;
      const float* __restrict__ g_row = g + p * ks;
      for (int c = 0; c < C4; c += 4) {
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ld4(wsm + (tx + j * tx_n) * ks + c);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float4 a = ld4(g_row + s * tp * ks + c);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[s][j] = fmaf(at(a, q), at(b[j], q), acc[s][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + tx + j * tx_n;
        float ctv[S], dx[S];
#pragma unroll
        for (int s = 0; s < S; ++s) ctv[s] = acc[s][j];
        float dx0 = 0.f;
        if (k < K) {
          dx0 = taylor_act_vjp<S>(net, li - 1, __ldg(B + k), x[j], ctv, dx);
        } else {
#pragma unroll
          for (int s = 0; s < S; ++s) dx[s] = 0.f;
        }
#pragma unroll
        for (int s = 0; s < S; ++s) hout[(s * tp + p) * ks + k] = dx[s];
        dbs[p * ks + k] = dx0;
      }
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads, 1)
taylor2_bwd_kernel(const float* __restrict__ z, long long n,
                   const __grid_constant__ Net net,
                   const float* __restrict__ ct, float* __restrict__ workspace,
                   float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* part = partial + blockIdx.x * net.n_params;
  float* acc = net.smem_acc ? sm : part;
  const int buf = net.rows * net.ks;
  float* const b0 = sm + (net.smem_acc ? net.acc_floats : 0);
  float* const b1 = b0 + buf;
  float* const wsm = b1 + buf;
  float* const dbs = wsm + net.kc * net.ks;
  float* ws = workspace + blockIdx.x * net.ws_stride;
  const int L = net.n_layers;
  const long long n_tiles = (n + net.tp - 1) / net.tp;

  for (long long j = threadIdx.x; j < net.n_params; j += kThreads) acc[j] = 0.f;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long p0 = tile * net.tp;
    float* h = b0;
    float* g = b1;
    // ---- forward recompute; X and H of the hidden layers to the workspace
    build_features<S>(z, n, p0, net, h);
    if (L > 1) stage_w(net, 0, 0, wsm);
    __syncthreads();
    for (int li = 0; li < L - 1; ++li) {
      // the copy of the next layer's W (the output layer's for the
      // reverse sweep) starts behind this layer's epilogue
      forward_layer<S>(h, g, wsm, ws + net.ws_off[li],
                       li < L - 2 ? ws + net.hs_off[li] : nullptr, net, li,
                       li + 1);
      __syncthreads();
      float* tmp = h;
      h = g;
      g = tmp;
    }
    // ---- output layer (h holds its input)
    output_cotangent<S>(ct, n, p0, net, g, dbs);
    __syncthreads();
    weight_grad(h, g, dbs, net, L - 1, acc);
    // ---- hidden layers, last to first: g holds layer li's dX * scl
    for (int li = L - 1; li >= 1; --li) {
      __syncthreads();
      input_cotangent<S>(g, h, wsm, ws + net.ws_off[li - 1], dbs, net, li);
      __syncthreads();
      if (li == 1) {
        build_features<S>(z, n, p0, net, g);
      } else {
        // layer li - 1's input, then (behind it) the next W
        load_input(g, ws + net.hs_off[li - 2], net, li - 1);
        cp_async_commit();
        stage_w(net, li - 1, 0, wsm);
        cp_async_commit();
        cp_async_wait_older();
      }
      __syncthreads();
      float* tmp = h;
      h = g;
      g = tmp;
      weight_grad(h, g, dbs, net, li - 1, acc);
    }
    __syncthreads();
  }
  if (net.smem_acc) {
    for (long long j = threadIdx.x; j < net.n_params; j += kThreads)
      part[j] = acc[j];
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

// bytes of shared memory of one block: [accumulator][2 stream buffers]
// [W chunk][per-point dx0]
long long smem_bytes(const Net& net) {
  return 4ll * ((net.smem_acc ? net.acc_floats : 0) +
                2ll * net.rows * net.ks + (long long)net.kc * net.ks +
                (long long)net.tp * net.ks);
}

template <int S>
int launch(const float* z, long long n, const Net& net, const float* ct,
           int n_blocks, float* workspace, float* partial, float* grad,
           cudaStream_t stream) {
  const int smem = (int)smem_bytes(net);
  cudaError_t e = cudaFuncSetAttribute(
      taylor2_bwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  taylor2_bwd_kernel<S><<<n_blocks, kThreads, smem, stream>>>(z, n, net, ct, workspace, partial);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long red_blocks = (net.n_params + 255) / 256;
  sum_partials<<<(unsigned)red_blocks, 256, 0, stream>>>(partial, n_blocks, net.n_params, grad);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Sizes the wrapper allocates: n_params floats of gradient, n_blocks rows
// of n_params partials, n_blocks * ws_stride floats of workspace, where
// ws_stride = S * TP * (sum of the hidden widths rounded up to 4, and
// again without the last): X of every hidden layer, H of all but the
// last; the kernel checks ws_stride against its own count.
// Threads per block and bytes of shared memory per block of a plan, for
// the wrapper to check its own arithmetic against.
int tpinn_taylor2_bwd_threads() { return kThreads; }

long long tpinn_taylor2_bwd_smem(int n_layers, const int* dims, int n_streams,
                                 int tile_points, int w_chunk, int smem_acc) {
  Net net;
  int widest = 0;
  long long n_params = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (dims[l] > widest) widest = dims[l];
    n_params += (long long)dims[l] * dims[l + 1] + dims[l + 1];
  }
  net.acc_floats = (n_params + 3) & ~3ll;
  net.smem_acc = smem_acc;
  net.tp = tile_points;
  net.rows = n_streams * tile_points;
  net.ks = row_stride(widest);
  net.kc = w_chunk;
  return smem_bytes(net);
}

// Error codes below 0: the arguments are outside what the kernel takes.
// smem_acc: 1 keeps the gradient in shared memory over all tiles, 0 adds
// each tile's into the block's row of partials; w_chunk: rows of W
// staged at once.
int tpinn_taylor2_bwd(const float* z, long long n, int d, const int* kinds,
                      const float* lb, const float* ub, int pad_to, int n_layers,
                      const void* const* w, const void* const* b,
                      const int* dims, int n_streams, const int* st_kind,
                      const int* st_i, const int* st_j, const int* st_pi,
                      const int* st_pj, int act_first, int act_hidden,
                      float scl, float epsil, int tile_points, int w_chunk,
                      int smem_acc, const float* ct, int n_blocks,
                      float* workspace, long long ws_stride, float* partial,
                      float* grad, void* stream) {
  if (n <= 0) return -1;
  if (d < 1 || d > kMaxCoords) return -2;
  if (n_layers < 1 || n_layers > kMaxLayers) return -3;
  if (n_streams < 1 || n_streams > kMaxStreams) return -4;
  if (tile_points < 4 || tile_points % 4) return -5;
  if (dims[0] > kMaxFeatures || dims[n_layers] != 1) return -6;
  if (n_blocks < 1) return -10;
  if (w_chunk < 4 || w_chunk % 4 || (smem_acc != 0 && smem_acc != 1))
    return -11;

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
    if (l + 1 < n_layers)
      ws_off += (long long)n_streams * tile_points * round4(dims[l + 1]);
    net.hs_off[l] = ws_off;
    if (l + 2 < n_layers)
      ws_off += (long long)n_streams * tile_points * round4(dims[l + 1]);
  }
  net.n_params = off;
  net.acc_floats = (off + 3) & ~3ll;
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
  net.tp = tile_points;
  net.rows = n_streams * tile_points;
  net.ks = row_stride(widest);
  net.kc = w_chunk;
  net.smem_acc = smem_acc;
  if (smem_bytes(net) > kSmemLimit) return -9;

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
