// LRN (Caffe ACROSS_CHANNELS) inference forward, hand-written for Hopper.
//
// Replaces the TPU kernel `_fwd_only_kernel` (sparknet_tpu/ops/lrn.py,
// reached through `lrn_pallas` / `lrn_nhwc`). On the (M, C) row view of
// an NHWC activation, M = N*H*W:
//
//     d(c) = k + (alpha/size) * sum_{c' in [c-a, c+b]} x(c')^2
//     y(c) = x(c) * d(c)^-beta          a = size/2, b = size-1-a
//
// f32 arithmetic inside, y in x's dtype (f32 or bf16).
//
// What bounds it: bytes. Each element is read once and written once and
// costs about `size` multiply-adds plus one power, far below the card's
// operations-per-byte line, so the least time is (read x + write y) over
// the memory rate. The TPU kernel's (C, C) band matmul and its VMEM row
// tiling are not carried over. Here one block stages a tile of rows
// (all their channels, or a chunk of 1024 channels plus the window's
// halo) in shared memory as f32, then every thread slides the channel
// window for its outputs out of shared memory. x is read from device
// memory exactly once, in contiguous runs, and y is written once; the
// ragged tail of rows is masked, so the caller pads nothing. Any C is
// taken: channels beyond one chunk are walked chunk by chunk.
//
// Plain C interface, loaded with ctypes (sparknet_tpu_torch/ops/_build.py).
// The launcher returns the cudaError_t of the launch; it launches on the
// caller's stream and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_rows_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t m,
                    int c, int size, int before, int rows_per_block,
                    int chunk, float scale, float k, float beta) {
  extern __shared__ float xs[];  // rows_per_block x (chunk + size - 1)
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t left = m - row0;
  const int rows = left < rows_per_block ? static_cast<int>(left) : rows_per_block;
  const T* xb = x + row0 * c;
  T* yb = y + row0 * c;
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
      const float d = k + scale * acc;
      store(yb + static_cast<int64_t>(r) * c + c0 + j,
            w[before] * inv_beta<MODE>(d, beta));
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int64_t m, int c, int size,
                   float scale, float k, float beta, cudaStream_t stream) {
  const int before = size / 2;
  const int chunk = c < kMaxChunk ? c : kMaxChunk;
  const int span = chunk + size - 1;
  int rows = kTileFloats / span;
  if (rows < 1) rows = 1;
  const size_t smem = static_cast<size_t>(rows) * span * sizeof(float);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  const int64_t blocks = (m + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (beta == 0.75f) {
    lrn_fwd_rows_kernel<T, kBeta075><<<grid, kThreads, smem, stream>>>(
        xp, yp, m, c, size, before, rows, chunk, scale, k, beta);
  } else if (beta == 0.5f) {
    lrn_fwd_rows_kernel<T, kBeta05><<<grid, kThreads, smem, stream>>>(
        xp, yp, m, c, size, before, rows, chunk, scale, k, beta);
  } else if (beta == 1.0f) {
    lrn_fwd_rows_kernel<T, kBeta1><<<grid, kThreads, smem, stream>>>(
        xp, yp, m, c, size, before, rows, chunk, scale, k, beta);
  } else {
    lrn_fwd_rows_kernel<T, kBetaAny><<<grid, kThreads, smem, stream>>>(
        xp, yp, m, c, size, before, rows, chunk, scale, k, beta);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. scale = alpha / size, computed by the
// caller in double precision. Returns a cudaError_t (0 on success).
extern "C" int sparknet_lrn_fwd(const void* x, void* y, long long m, int c,
                                int size, float scale, float k, float beta,
                                int dtype, int device, void* stream) {
  if (m <= 0 || c <= 0) return 0;
  if (size < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch<float>(x, y, m, c, size, scale, k, beta, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, y, m, c, size, scale, k, beta, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* sparknet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
