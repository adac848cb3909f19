// LRN (Caffe ACROSS_CHANNELS), hand-written for Hopper: the inference
// forward, the training forward (y plus the f32 residual d) and the
// backward.
//
// Replaces the three TPU kernels of sparknet_tpu/ops/lrn.py:
//   - `_fwd_only_kernel` (reached through `lrn_pallas`), inference: y only;
//   - `_fwd_kernel` (reached through `_lrn_fwd_impl`, the custom VJP's
//     forward): y and d;
//   - `_bwd_kernel` (reached through `_lrn_bwd_impl`, the custom VJP's
//     backward): dx.
// On the (M, C) row view of an NHWC activation, M = N*H*W:
//
//     d(c)  = k + (alpha/size) * sum_{c' in [c-a, c+b]} x(c')^2
//     y(c)  = x(c) * d(c)^-beta                 a = size/2, b = size-1-a
//     u(c)  = g(c) * x(c) * d(c)^(-beta-1)
//     dx(c) = g(c) * d(c)^-beta
//             - 2 (alpha/size) beta * x(c) * sum_{c' in [c-b, c+a]} u(c')
//
// The backward's window is the forward's transposed (the TPU kernel's
// `w_ref[...].T`): output c gathers u from b channels before it and a
// after. For odd local_size a == b and the two coincide; for even sizes
// they do not, and the backward takes `before = b`.
//
// f32 arithmetic inside; y, dx in x's dtype (f32 or bf16), d always f32.
//
// What bounds them: bytes. Each element costs about `size` adds plus one
// power, far below the card's operations-per-byte line. The inference
// forward reads x and writes y (8 bytes per f32 element); the training
// forward also writes d (12); the backward reads g, x and d and writes dx
// (16). The least time is those bytes over the memory rate, so each
// kernel reads each input once, in wide contiguous accesses, and keeps
// the per-element instruction count low enough that the loads stay in
// flight.
//
// The TPU kernels' (C, C) band matmul and VMEM row tiling are not carried
// over. Two routes, chosen by the caller (ops/lrn.py `lrn_route`) and
// checked again here:
//
// quad (`lrn_*_rows_quad_kernel`): C a multiple of 4, at most 1024, and
// every operand 16-byte aligned. A block owns whole rows, one thread per
// quad of 4 adjacent channels; a tile of rows is one contiguous run of
// memory and thread t's quad sits at element 4t of it, so each thread
// reads its g, x, d once as one 16-byte vector (bf16 g and x: 8 bytes)
// and writes once the same way, and its row and quad come from its index
// once, with no division per element. The thread keeps its centre (the
// forward: x; the backward: x and g d^-beta) in registers and writes one
// quad of the window's operand (x^2, or u = g x d^-beta / d) into its
// row in shared memory, which carries the window's zeros on both sides,
// so no row reads another's channels. After one barrier it sums each of
// its four outputs' windows in the plain version's order (t = 0 ..
// size-1) and stores the quad. One tile a block (C 96: 10 rows of 240
// threads; C 256: 4 rows of 256): the blocks resident on an SM keep
// enough loads in flight, so the kernel runs near its byte bound with no
// prefetch of its own.
//
// staged (`lrn_*_rows_staged_kernel`): every other shape (C not a
// multiple of 4, C beyond one chunk, an unaligned operand). One block
// stages a tile of rows (all their channels, or a chunk of up to 1024
// channels plus the window's halo) in shared memory as f32, element by
// element, then every thread slides the window for its outputs. The
// backward stages u over the chunk and halo, and g d^-beta and x over
// the chunk, so it too reads g, x and d once (a chunk's halo is read
// again by its neighbour chunk). Any C is taken.
//
// Both routes mask the ragged tail of rows, so the caller pads nothing.
//
// The backward keeps the TPU kernel's contract: d is a saved f32 residual
// of the training forward, not recomputed. A variant that recomputes d
// from x in the backward (12 bytes per element instead of 16, and no d
// written by the forward) is an option for a later change.
//
// Plain C interface, loaded with ctypes (sparknet_tpu_torch/ops/_build.py).
// Each launcher returns the cudaError_t of its launch; it launches on the
// caller's stream and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 1024;     // channels staged per pass; the quad route's widest row
constexpr int kTileFloats = 4096;   // the staged route's target shared floats per block
constexpr int kMaxSmemBytes = 48 * 1024;

enum Route { kQuad = 0, kStaged = 1 };  // ops/lrn.py ROUTES
enum BetaMode { kBeta075 = 0, kBeta05 = 1, kBeta1 = 2, kBetaAny = 3 };

// d^-beta; rsqrt/sqrt forms for the dyadic betas, as the TPU kernel's
// _inv_beta: 0.75 -> sqrt((d^-1/2)^3), 0.5 -> rsqrt, 1 -> 1/d.
template <int MODE>
__device__ __forceinline__ float inv_beta(float d, float beta) {
  if (MODE == kBeta075) {
    const float t = rsqrtf(d);
    return sqrtf(t * t * t);
  } else if (MODE == kBeta05) {
    return rsqrtf(d);
  } else if (MODE == kBeta1) {
    return 1.0f / d;
  } else {
    return expf(-beta * logf(d));
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// ------------------------------------------------------------------ quad
// A quad's load (16 bytes of f32, 8 of bf16), its f32 value, and its store
// (rounded once to bf16).
__device__ __forceinline__ float4 load_quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ uint2 load_quad(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ float4 quad_f32(float4 v) { return v; }
__device__ __forceinline__ float4 quad_f32(uint2 v) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store_quad(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store_quad(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// The windows of four adjacent outputs: out[j] = sum_{t < size} w[j + t],
// each summed from 0 in ascending t, the plain version's order; size + 3
// reads of shared memory, slid through four registers.
__device__ __forceinline__ float4 window_quad(const float* w, int size) {
  float w0 = w[0], w1 = w[1], w2 = w[2];
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int t = 0; t < size; ++t) {
    const float w3 = w[t + 3];
    a.x += w0;
    a.y += w1;
    a.z += w2;
    a.w += w3;
    w0 = w1;
    w1 = w2;
    w2 = w3;
  }
  return a;
}

// The quad route's geometry. A block owns `rows` whole rows (a tile), one
// thread per quad: rows * quads threads. Each row sits in shared memory at
// `lead` (before rounded up to 4) between zeros, `pitch` floats a row (a
// multiple of 4, at least lead + c + after).
struct QuadGeom {
  int quads, rows, lead, pitch;
};

__device__ __forceinline__ void zero_pads(float* s, int c, const QuadGeom& q) {
  const int pad = q.pitch - c;
  for (int i = threadIdx.x; i < q.rows * pad; i += blockDim.x) {
    const int row = i / pad;  // once per pad float of the block, not per element
    const int j = i - row * pad;
    s[row * q.pitch + (j < q.lead ? j : c + j)] = 0.0f;
  }
}

// This thread's quad: its first element in the (M, C) rows (the tile is one
// contiguous run, and thread t's quad sits at element 4t of it), and its
// channel 4q in the tile's shared rows. Row and quad come from the thread
// index once.
struct Quad {
  int64_t at;
  int mine;
};

__device__ __forceinline__ Quad quad_of_thread(int c, const QuadGeom& g) {
  const int r = threadIdx.x / g.quads;
  const int q = threadIdx.x - r * g.quads;
  return {static_cast<int64_t>(blockIdx.x) * g.rows * c + 4 * threadIdx.x,
          r * g.pitch + g.lead + 4 * q};
}

// Forward, quad route; with TRAIN it also writes d (f32).
template <typename T, int MODE, bool TRAIN>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_rows_quad_kernel(const T* __restrict__ x, T* __restrict__ y,
                         float* __restrict__ d, int64_t m, int c, int size,
                         int before, QuadGeom geom, float scale, float k,
                         float beta) {
  extern __shared__ float4 fwd_rows[];  // rows x pitch floats of x^2
  float* sq = reinterpret_cast<float*>(fwd_rows);
  const Quad me = quad_of_thread(c, geom);
  const bool live = me.at < m * c;  // whole rows are in or out of the tail together
  zero_pads(sq, c, geom);
  float4 xv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (live) xv = quad_f32(load_quad(x + me.at));
  *reinterpret_cast<float4*>(sq + me.mine) =
      make_float4(xv.x * xv.x, xv.y * xv.y, xv.z * xv.z, xv.w * xv.w);
  __syncthreads();
  if (!live) return;
  const float4 acc = window_quad(sq + me.mine - before, size);
  const float4 dv = make_float4(k + scale * acc.x, k + scale * acc.y,
                                k + scale * acc.z, k + scale * acc.w);
  store_quad(y + me.at, make_float4(xv.x * inv_beta<MODE>(dv.x, beta),
                                    xv.y * inv_beta<MODE>(dv.y, beta),
                                    xv.z * inv_beta<MODE>(dv.z, beta),
                                    xv.w * inv_beta<MODE>(dv.w, beta)));
  if (TRAIN) store_quad(d + me.at, dv);
}

// One element of the backward's first half: g d^-beta (kept for dx) and
// u = g x d^-beta / d, in the plain version's steps.
template <int MODE>
__device__ __forceinline__ void bwd_centre(float g, float x, float d, float beta,
                                           float& gi, float& u) {
  const float inv = inv_beta<MODE>(d, beta);
  gi = g * inv;
  u = g * x * inv / d;
}

// Backward, quad route: g, x and d read once each as vectors.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_rows_quad_kernel(const T* __restrict__ g, const T* __restrict__ x,
                         const float* __restrict__ d, T* __restrict__ dx,
                         int64_t m, int c, int size, int before, QuadGeom geom,
                         float coef, float beta) {
  extern __shared__ float4 bwd_rows[];  // rows x pitch floats of u
  float* us = reinterpret_cast<float*>(bwd_rows);
  const Quad me = quad_of_thread(c, geom);
  const bool live = me.at < m * c;
  zero_pads(us, c, geom);
  float4 gv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), xv = gv;
  float4 dv = make_float4(1.0f, 1.0f, 1.0f, 1.0f);  // d of a row past the tail
  if (live) {
    gv = quad_f32(load_quad(g + me.at));
    xv = quad_f32(load_quad(x + me.at));
    dv = load_quad(d + me.at);
  }
  float4 gi, u;
  bwd_centre<MODE>(gv.x, xv.x, dv.x, beta, gi.x, u.x);
  bwd_centre<MODE>(gv.y, xv.y, dv.y, beta, gi.y, u.y);
  bwd_centre<MODE>(gv.z, xv.z, dv.z, beta, gi.z, u.z);
  bwd_centre<MODE>(gv.w, xv.w, dv.w, beta, gi.w, u.w);
  *reinterpret_cast<float4*>(us + me.mine) = u;
  __syncthreads();
  if (!live) return;
  const float4 acc = window_quad(us + me.mine - before, size);  // the transposed window
  store_quad(dx + me.at, make_float4(gi.x - coef * xv.x * acc.x,
                                     gi.y - coef * xv.y * acc.y,
                                     gi.z - coef * xv.z * acc.z,
                                     gi.w - coef * xv.w * acc.w));
}

// ---------------------------------------------------------------- staged
// Forward over a tile of rows; with TRAIN it also writes d (f32).
template <typename T, int MODE, bool TRAIN>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_rows_staged_kernel(const T* __restrict__ x, T* __restrict__ y,
                           float* __restrict__ d, int64_t m, int c, int size,
                           int before, int rows_per_block, int chunk, float scale,
                           float k, float beta) {
  extern __shared__ float xs[];  // rows_per_block x (chunk + size - 1)
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t left = m - row0;
  const int rows = left < rows_per_block ? static_cast<int>(left) : rows_per_block;
  const T* xb = x + row0 * c;
  T* yb = y + row0 * c;
  float* db = TRAIN ? d + row0 * c : nullptr;
  for (int c0 = 0; c0 < c; c0 += chunk) {
    const int width = min(chunk, c - c0);
    const int span = width + size - 1;
    // stage channels [c0 - a, c0 + width - 1 + b] of each row; outside
    // [0, C) the window sees zeros, as Caffe's padded sum does
    for (int i = threadIdx.x; i < rows * span; i += kThreads) {
      const int r = i / span;
      const int j = i - r * span;
      const int ch = c0 - before + j;
      xs[i] = (ch >= 0 && ch < c)
                  ? to_f32(xb[static_cast<int64_t>(r) * c + ch])
                  : 0.0f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * width; i += kThreads) {
      const int r = i / width;
      const int j = i - r * width;
      const float* w = xs + r * span + j;  // window of output channel c0 + j
      float acc = 0.0f;
      for (int t = 0; t < size; ++t) acc += w[t] * w[t];
      const float dv = k + scale * acc;
      const int64_t at = static_cast<int64_t>(r) * c + c0 + j;
      store(yb + at, w[before] * inv_beta<MODE>(dv, beta));
      if (TRAIN) db[at] = dv;
    }
    __syncthreads();
  }
}

// Backward over a tile of rows: stage u = g x d^(-beta-1) for the chunk
// plus the transposed window's halo, and g d^-beta and x for the chunk,
// then slide that window.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_rows_staged_kernel(const T* __restrict__ g, const T* __restrict__ x,
                           const float* __restrict__ d, T* __restrict__ dx,
                           int64_t m, int c, int size, int before,
                           int rows_per_block, int chunk, float coef, float beta) {
  // rows_per_block x (chunk + size - 1) of u, then rows_per_block x chunk
  // of g d^-beta and of x
  extern __shared__ float us[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t left = m - row0;
  const int rows = left < rows_per_block ? static_cast<int>(left) : rows_per_block;
  const T* gb = g + row0 * c;
  const T* xb = x + row0 * c;
  const float* db = d + row0 * c;
  T* dxb = dx + row0 * c;
  float* gis = us + rows_per_block * (chunk + size - 1);
  float* xcs = gis + rows_per_block * chunk;
  for (int c0 = 0; c0 < c; c0 += chunk) {
    const int width = min(chunk, c - c0);
    const int span = width + size - 1;
    // stage u over channels [c0 - b, c0 + width - 1 + a]; zeros outside
    for (int i = threadIdx.x; i < rows * span; i += kThreads) {
      const int r = i / span;
      const int j = i - r * span;
      const int ch = c0 - before + j;
      float u = 0.0f;
      if (ch >= 0 && ch < c) {
        const int64_t at = static_cast<int64_t>(r) * c + ch;
        const float gv = to_f32(gb[at]), xv = to_f32(xb[at]);
        float gi;
        bwd_centre<MODE>(gv, xv, db[at], beta, gi, u);
        const int jc = ch - c0;  // inside the chunk: kept for the output
        if (jc >= 0 && jc < width) {
          gis[r * width + jc] = gi;
          xcs[r * width + jc] = xv;
        }
      }
      us[i] = u;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * width; i += kThreads) {
      const int r = i / width;
      const int j = i - r * width;
      const float* w = us + r * span + j;  // transposed window of c0 + j
      float acc = 0.0f;
      for (int t = 0; t < size; ++t) acc += w[t];
      store(dxb + static_cast<int64_t>(r) * c + c0 + j, gis[i] - coef * xcs[i] * acc);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------- launchers
bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }
int round4(int v) { return (v + 3) & ~3; }

// The quad route's geometry for rows of c channels and a window reaching
// `before` channels back and `after` forward, and its grid; an error where
// the route does not take the shape (ops/lrn.py `quad_geom` makes the same
// test).
cudaError_t quad_geom(int64_t m, int c, int before, int after, QuadGeom* g,
                      size_t* smem, dim3* grid) {
  if (c % 4 != 0 || c > kMaxChunk) return cudaErrorInvalidValue;
  g->quads = c / 4;
  g->lead = round4(before);
  g->pitch = round4(g->lead + c + after);
  g->rows = kThreads / g->quads;
  const int fit = kMaxSmemBytes / (g->pitch * static_cast<int>(sizeof(float)));
  if (g->rows > fit) g->rows = fit;
  if (g->rows < 1) return cudaErrorInvalidValue;
  *smem = static_cast<size_t>(g->rows) * g->pitch * sizeof(float);
  const int64_t tiles = (m + g->rows - 1) / g->rows;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  *grid = dim3(static_cast<unsigned>(tiles));
  return cudaSuccess;
}

// The staged route's tiling: channels in chunks of at most kMaxChunk, and
// as many rows per block as fill kTileFloats of staging. Each row stages
// span = chunk + size - 1 floats, plus `extra` x chunk more (the backward's
// g d^-beta and x); the chunk narrows for a window so wide that one row
// would not fit.
struct Tiling {
  int chunk, rows;
  size_t smem;
  dim3 grid;
};

cudaError_t tiling(int64_t m, int c, int size, int extra, Tiling* t) {
  const int room = kMaxSmemBytes / static_cast<int>(sizeof(float)) - (size - 1);
  t->chunk = c < kMaxChunk ? c : kMaxChunk;
  if (t->chunk * (1 + extra) > room) t->chunk = room / (1 + extra);
  if (t->chunk < 1) return cudaErrorInvalidValue;
  const int row_floats = t->chunk * (1 + extra) + size - 1;
  t->rows = kTileFloats / row_floats;
  if (t->rows < 1) t->rows = 1;
  t->smem = static_cast<size_t>(t->rows) * row_floats * sizeof(float);
  if (t->smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  const int64_t blocks = (m + t->rows - 1) / t->rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  t->grid = dim3(static_cast<unsigned>(blocks));
  return cudaSuccess;
}

// Calls f with the BetaMode of beta as a compile-time constant, then
// returns the launch's error.
template <typename F>
cudaError_t with_beta_mode(float beta, F&& f) {
  if (beta == 0.75f) {
    f(std::integral_constant<int, kBeta075>{});
  } else if (beta == 0.5f) {
    f(std::integral_constant<int, kBeta05>{});
  } else if (beta == 1.0f) {
    f(std::integral_constant<int, kBeta1>{});
  } else {
    f(std::integral_constant<int, kBetaAny>{});
  }
  return cudaGetLastError();
}

template <typename T, bool TRAIN>
cudaError_t launch_fwd(const void* x, void* y, float* d, int64_t m, int c,
                       int size, float scale, float k, float beta, int route,
                       cudaStream_t stream) {
  const int before = size / 2;  // a
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (route == kQuad) {
    QuadGeom g;
    size_t smem;
    dim3 grid;
    cudaError_t err = quad_geom(m, c, before, size - 1 - before, &g, &smem, &grid);
    if (err != cudaSuccess) return err;
    if (!aligned16(x) || !aligned16(y) || (TRAIN && !aligned16(d))) {
      return cudaErrorInvalidValue;
    }
    const dim3 block(g.rows * g.quads);
    return with_beta_mode(beta, [&](auto mode) {
      lrn_fwd_rows_quad_kernel<T, decltype(mode)::value, TRAIN>
          <<<grid, block, smem, stream>>>(xp, yp, d, m, c, size, before, g, scale, k, beta);
    });
  }
  if (route != kStaged) return cudaErrorInvalidValue;
  Tiling t;
  cudaError_t err = tiling(m, c, size, 0, &t);
  if (err != cudaSuccess) return err;
  return with_beta_mode(beta, [&](auto mode) {
    lrn_fwd_rows_staged_kernel<T, decltype(mode)::value, TRAIN>
        <<<t.grid, kThreads, t.smem, stream>>>(xp, yp, d, m, c, size, before, t.rows,
                                               t.chunk, scale, k, beta);
  });
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* x, const float* d, void* dx,
                       int64_t m, int c, int size, float scale, float beta,
                       int route, cudaStream_t stream) {
  const int before = size - 1 - size / 2;  // b: the transposed window
  const float coef = 2.0f * scale * beta;
  const T* gp = static_cast<const T*>(g);
  const T* xp = static_cast<const T*>(x);
  T* dxp = static_cast<T*>(dx);
  if (route == kQuad) {
    QuadGeom q;
    size_t smem;
    dim3 grid;
    cudaError_t err = quad_geom(m, c, before, size - 1 - before, &q, &smem, &grid);
    if (err != cudaSuccess) return err;
    if (!aligned16(g) || !aligned16(x) || !aligned16(d) || !aligned16(dx)) {
      return cudaErrorInvalidValue;
    }
    const dim3 block(q.rows * q.quads);
    return with_beta_mode(beta, [&](auto mode) {
      lrn_bwd_rows_quad_kernel<T, decltype(mode)::value>
          <<<grid, block, smem, stream>>>(gp, xp, d, dxp, m, c, size, before, q, coef, beta);
    });
  }
  if (route != kStaged) return cudaErrorInvalidValue;
  Tiling t;
  cudaError_t err = tiling(m, c, size, 2, &t);
  if (err != cudaSuccess) return err;
  return with_beta_mode(beta, [&](auto mode) {
    lrn_bwd_rows_staged_kernel<T, decltype(mode)::value>
        <<<t.grid, kThreads, t.smem, stream>>>(gp, xp, d, dxp, m, c, size, before,
                                               t.rows, t.chunk, coef, beta);
  });
}

cudaError_t begin(int size, int device) {
  if (size < 1) return cudaErrorInvalidValue;
  return cudaSetDevice(device);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. route: 0 = quad, 1 = staged. scale =
// alpha / size, computed by the caller in double precision. Each returns a
// cudaError_t (0 on success); a route that does not take the shape or the
// operands' alignment returns cudaErrorInvalidValue and launches nothing.

extern "C" int sparknet_lrn_fwd(const void* x, void* y, long long m, int c,
                                int size, float scale, float k, float beta,
                                int dtype, int route, int device, void* stream) {
  if (m <= 0 || c <= 0) return 0;
  cudaError_t err = begin(size, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_fwd<float, false>(x, y, nullptr, m, c, size, scale, k, beta, route, s);
  } else if (dtype == 1) {
    err = launch_fwd<__nv_bfloat16, false>(x, y, nullptr, m, c, size, scale, k, beta,
                                           route, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Training forward: y in x's dtype and d (f32), both (M, C).
extern "C" int sparknet_lrn_fwd_train(const void* x, void* y, void* d,
                                      long long m, int c, int size,
                                      float scale, float k, float beta,
                                      int dtype, int route, int device, void* stream) {
  if (m <= 0 || c <= 0) return 0;
  cudaError_t err = begin(size, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dp = static_cast<float*>(d);
  if (dtype == 0) {
    err = launch_fwd<float, true>(x, y, dp, m, c, size, scale, k, beta, route, s);
  } else if (dtype == 1) {
    err = launch_fwd<__nv_bfloat16, true>(x, y, dp, m, c, size, scale, k, beta, route, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Backward: dx (x's dtype) from g and x (x's dtype) and d (f32).
extern "C" int sparknet_lrn_bwd(const void* g, const void* x, const void* d,
                                void* dx, long long m, int c, int size,
                                float scale, float beta, int dtype, int route,
                                int device, void* stream) {
  if (m <= 0 || c <= 0) return 0;
  cudaError_t err = begin(size, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dp = static_cast<const float*>(d);
  if (dtype == 0) {
    err = launch_bwd<float>(g, x, dp, dx, m, c, size, scale, beta, route, s);
  } else if (dtype == 1) {
    err = launch_bwd<__nv_bfloat16>(g, x, dp, dx, m, c, size, scale, beta, route, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* sparknet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
