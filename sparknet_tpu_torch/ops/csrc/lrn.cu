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
// they do not, and the kernel stages with `before = b`.
//
// f32 arithmetic inside; y, dx in x's dtype (f32 or bf16), d always f32.
//
// What bounds them: bytes. Each element costs about `size` multiply-adds
// plus one power, far below the card's operations-per-byte line. The
// inference forward reads x and writes y (8 bytes per f32 element); the
// training forward also writes d (12); the backward reads g, x and d and
// writes dx (16). The least time is those bytes over the memory rate.
//
// Design. The TPU kernels' (C, C) band matmul and VMEM row tiling are not
// carried over. One block stages a tile of rows (all their channels, or a
// chunk of 1024 channels plus the window's halo) in shared memory as f32,
// then every thread slides the channel window for its outputs out of
// shared memory. The forwards stage x; the backward stages u, computed
// elementwise from g, x and d while staging, and reads the centre's g, x,
// d again (from L1/L2, just touched) for the output. Device memory sees
// each input read in contiguous runs and each output written once; the
// ragged tail of rows is masked, so the caller pads nothing. Any C is
// taken: channels beyond one chunk are walked chunk by chunk.
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
constexpr int kMaxChunk = 1024;     // channels staged per pass
constexpr int kTileFloats = 4096;   // target shared floats per block (16 KB)
constexpr int kMaxSmemBytes = 48 * 1024;

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

// Forward over a tile of rows; with TRAIN it also writes d (f32).
template <typename T, int MODE, bool TRAIN>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_rows_kernel(const T* __restrict__ x, T* __restrict__ y,
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
// plus the transposed window's halo, then slide that window.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_rows_kernel(const T* __restrict__ g, const T* __restrict__ x,
                    const float* __restrict__ d, T* __restrict__ dx,
                    int64_t m, int c, int size, int before,
                    int rows_per_block, int chunk, float coef, float beta) {
  extern __shared__ float us[];  // rows_per_block x (chunk + size - 1)
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t left = m - row0;
  const int rows = left < rows_per_block ? static_cast<int>(left) : rows_per_block;
  const T* gb = g + row0 * c;
  const T* xb = x + row0 * c;
  const float* db = d + row0 * c;
  T* dxb = dx + row0 * c;
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
        const float dv = db[at];
        u = to_f32(gb[at]) * to_f32(xb[at]) * inv_beta<MODE>(dv, beta) / dv;
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
      const int64_t at = static_cast<int64_t>(r) * c + c0 + j;
      const float dv = db[at];
      store(dxb + at, to_f32(gb[at]) * inv_beta<MODE>(dv, beta) -
                          coef * to_f32(xb[at]) * acc);
    }
    __syncthreads();
  }
}

// The tiling all three kernels share: channels in chunks of at most
// kMaxChunk, and as many rows per block as fill kTileFloats of staging.
struct Tiling {
  int chunk, rows;
  size_t smem;
  dim3 grid;
};

cudaError_t tiling(int64_t m, int c, int size, Tiling* t) {
  t->chunk = c < kMaxChunk ? c : kMaxChunk;
  const int span = t->chunk + size - 1;
  t->rows = kTileFloats / span;
  if (t->rows < 1) t->rows = 1;
  t->smem = static_cast<size_t>(t->rows) * span * sizeof(float);
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
                       int size, float scale, float k, float beta,
                       cudaStream_t stream) {
  Tiling t;
  cudaError_t err = tiling(m, c, size, &t);
  if (err != cudaSuccess) return err;
  const int before = size / 2;  // a
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  return with_beta_mode(beta, [&](auto mode) {
    lrn_fwd_rows_kernel<T, decltype(mode)::value, TRAIN>
        <<<t.grid, kThreads, t.smem, stream>>>(xp, yp, d, m, c, size, before,
                                               t.rows, t.chunk, scale, k, beta);
  });
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* x, const float* d, void* dx,
                       int64_t m, int c, int size, float scale, float beta,
                       cudaStream_t stream) {
  Tiling t;
  cudaError_t err = tiling(m, c, size, &t);
  if (err != cudaSuccess) return err;
  const int before = size - 1 - size / 2;  // b: the transposed window
  const float coef = 2.0f * scale * beta;
  const T* gp = static_cast<const T*>(g);
  const T* xp = static_cast<const T*>(x);
  T* dxp = static_cast<T*>(dx);
  return with_beta_mode(beta, [&](auto mode) {
    lrn_bwd_rows_kernel<T, decltype(mode)::value>
        <<<t.grid, kThreads, t.smem, stream>>>(gp, xp, d, dxp, m, c, size,
                                               before, t.rows, t.chunk, coef,
                                               beta);
  });
}

cudaError_t begin(int size, int device) {
  if (size < 1) return cudaErrorInvalidValue;
  return cudaSetDevice(device);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. scale = alpha / size, computed by the
// caller in double precision. Each returns a cudaError_t (0 on success).

extern "C" int sparknet_lrn_fwd(const void* x, void* y, long long m, int c,
                                int size, float scale, float k, float beta,
                                int dtype, int device, void* stream) {
  if (m <= 0 || c <= 0) return 0;
  cudaError_t err = begin(size, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_fwd<float, false>(x, y, nullptr, m, c, size, scale, k, beta, s);
  } else if (dtype == 1) {
    err = launch_fwd<__nv_bfloat16, false>(x, y, nullptr, m, c, size, scale, k,
                                           beta, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Training forward: y in x's dtype and d (f32), both (M, C).
extern "C" int sparknet_lrn_fwd_train(const void* x, void* y, void* d,
                                      long long m, int c, int size,
                                      float scale, float k, float beta,
                                      int dtype, int device, void* stream) {
  if (m <= 0 || c <= 0) return 0;
  cudaError_t err = begin(size, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dp = static_cast<float*>(d);
  if (dtype == 0) {
    err = launch_fwd<float, true>(x, y, dp, m, c, size, scale, k, beta, s);
  } else if (dtype == 1) {
    err = launch_fwd<__nv_bfloat16, true>(x, y, dp, m, c, size, scale, k, beta, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Backward: dx (x's dtype) from g and x (x's dtype) and d (f32).
extern "C" int sparknet_lrn_bwd(const void* g, const void* x, const void* d,
                                void* dx, long long m, int c, int size,
                                float scale, float beta, int dtype,
                                int device, void* stream) {
  if (m <= 0 || c <= 0) return 0;
  cudaError_t err = begin(size, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dp = static_cast<const float*>(d);
  if (dtype == 0) {
    err = launch_bwd<float>(g, x, dp, dx, m, c, size, scale, beta, s);
  } else if (dtype == 1) {
    err = launch_bwd<__nv_bfloat16>(g, x, dp, dx, m, c, size, scale, beta, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* sparknet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
