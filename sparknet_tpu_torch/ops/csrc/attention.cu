// Flash attention, hand-written for Hopper: the forward (o and lse), the
// backward's dq, and the backward's dk/dv.
//
// Replaces the three TPU kernels of sparknet_tpu/ops/attention.py:
//   - `_fwd_kernel` (reached through `_flash_fwd` and `flash_block_fwd`):
//     o and lse by an online softmax over K/V tiles;
//   - `_bwd_dq_kernel` (reached through `_flash_bwd` and `flash_block_bwd`):
//     dq = scale * sum_k ds K;
//   - `_bwd_dkv_kernel` (same callers): dv = sum_q p_drop^T dO and
//     dk = sum_q ds^T (scale q).
// On (B, H, S, D) with s = (scale q) k^T, a kv mask per (b, key), an
// optional causal mask with offsets (key k + kv_offset <= query q +
// q_offset), and dropout of p after the softmax's denominator l has
// summed the undropped p:
//
//     lse = m + log(l)                       (m the row max, l = sum exp(s - m))
//     o   = sum_k drop(p) v / l              p = exp(s - m)
//     p   = exp(s - lse)                     in the backward, 0 where masked
//     dp  = drop(dO v^T)                     drop(x) = keep ? x / (1 - rate) : 0
//     ds  = p (dp - delta)                   delta = sum_d dO o, computed outside
//
// A query row with no valid key gives o = 0 and lse = NEG_INF; the
// backward's masked-p guard then gives it zero gradients.
//
// What bounds them: operations. Per (query, key) pair the forward does 2D
// multiply-adds (s, then p v), dq 3D (s, dp, ds K), dk/dv 4D (s, dp,
// p^T dO, ds^T q); per byte of q, k, v, o and dO that is S/2 to S
// operations, so at BERT's S = 128 in f32 the operations over 67 TFLOP/s
// (f32 on the CUDA cores) exceed the bytes over 3.35 TB/s. The least time
// is the larger of the two, which the caller computes for its shapes.
//
// Design. Correct and simple first: f32 fused multiply-adds on the CUDA
// cores, no wgmma or TMA. One block of 256 threads (16 x 16) owns a tile
// of 64 rows (query rows for the forward and dq, key rows for dk/dv) and
// loops over tiles of COLS columns of the other side (64, or 32 at head
// dim 256 so that the tiles fit shared memory), so the TPU's sequential
// k-grid becomes this loop and nothing carries between blocks; the two
// backward kernels stay split, so no atomics are needed. Tiles are staged
// in shared memory as f32 (rows padded to D+1 floats, so the threads of a
// warp read distinct banks); each thread keeps a 4 x COLS/16 tile of s in
// registers, takes the row max and sum with warp shuffles over its 16
// lanes, writes p (or ds) to shared memory, and accumulates its 4 x D/16
// share of the output in registers. Ragged edges of S_q and S_k are masked
// in the kernel, so the caller pads nothing. A causal tile wholly above the
// diagonal ends the forward's and dq's loop and is skipped by dk/dv. The
// offsets and the dropout seed come from a (3,) int32 device tensor, so a
// traced offset or a seed drawn on the device needs no host read.
//
// Dropout is a counter-based hash of (seed, b*H + h, query index, key
// index): the element's own indices within the call, not its tile's, so
// the mask does not depend on tile sizes and sparknet_tpu_torch/ops/
// attention.py reproduces it bit for bit in int64 PyTorch arithmetic. A
// key is kept when its 32 hash bits, read unsigned, are >= rate * 2^32.
//
// Plain C interface, loaded with ctypes (sparknet_tpu_torch/ops/_build.py).
// Each launcher returns the cudaError_t of its launch; it launches on the
// caller's stream and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The launchers' one argument, mirrored field for field by _FlashArgs in
// ops/attention.py. It has external linkage, as the extern "C" entry
// points that take it must.
struct FlashArgs {
  const void* q;          // (B, H, Sq, D), strides below, last dim contiguous
  const void* k;          // (B, H, Sk, D)
  const void* v;          // (B, H, Sk, D)
  const void* dout;       // (B, H, Sq, D), backward only
  const int8_t* mask;     // (B, Sk), nonzero = valid key
  const int* offsets;     // (3,): q_offset, kv_offset, dropout seed
  const float* lse;       // (B, H, Sq), backward only
  const float* delta;     // (B, H, Sq), backward only
  void* o;                // (B, H, Sq, D) contiguous, forward
  float* lse_out;         // (B, H, Sq), forward
  void* dq;               // (B, H, Sq, D) contiguous
  void* dk;               // (B, H, Sk, D) contiguous
  void* dv;               // (B, H, Sk, D) contiguous
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
  int B, H, Sq, Sk;
  int causal;
  int dropout;
  float scale;
  float drop_scale;       // 1 / (1 - rate)
  unsigned int threshold; // keep when bits >= threshold = rate * 2^32
};

namespace {

constexpr float kNegInf = -1e30f;  // large but finite, as NEG_INF
constexpr int kThreads = 256;      // 16 x 16
constexpr int kRows = 64;          // tile rows
constexpr int kRowsPerThread = kRows / 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The dropout hash (a 32-bit integer mix: xor-shift, multiply, twice).
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t head_key(uint32_t seed, int bh) {
  return mix32(seed ^ (static_cast<uint32_t>(bh + 1) * 0xc2b2ae3du));
}
__device__ __forceinline__ uint32_t row_key(uint32_t hk, int qi) {
  return mix32(hk ^ (static_cast<uint32_t>(qi + 1) * 0x85ebca77u));
}
__device__ __forceinline__ bool keep_bit(uint32_t rk, int ki, uint32_t threshold) {
  return mix32(rk ^ (static_cast<uint32_t>(ki + 1) * 0x9e3779b9u)) >= threshold;
}

// Max and sum over the 16 lanes that share a tile row (lanes 0-15 and
// 16-31 of a warp are two rows).
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage rows [r0, r0 + n) of a (rows, D) operand with row stride `ss` into
// shared memory as f32 times `mul`, row pitch `pitch`; rows at or beyond
// `limit` become zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src, long long ss,
                                      int r0, int n, int limit, float mul) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int row = r0 + r;
    dst[r * pitch + c] = row < limit ? to_f32(src[row * ss + c]) * mul : 0.0f;
  }
}

// Forward: one block per (q tile, h, b). Replaces `_fwd_kernel`
// (sparknet_tpu/ops/attention.py:151). Bound: 4 B H Sq Sk D operations
// (s and p v) over 67 TFLOP/s; at BERT-base (B 32, H 12, S 128, D 64)
// 1.61 GFLOP, 0.024 ms, above the 0.015 ms its 50 MB take at 3.35 TB/s.
// Against it: each thread's 4 x COLS/16 register tile does 16 fused
// multiply-adds per 8 shared-memory reads; no tensor cores yet.
template <typename T, int D, int COLS>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashArgs a) {
  constexpr int CPT = COLS / 16;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                       // kRows x (D+1), q * scale
  float* ks = qs + kRows * (D + 1);       // COLS x (D+1)
  float* vs = ks + COLS * (D + 1);        // COLS x D
  float* ps = vs + COLS * D;              // kRows x (COLS+1), dropped p
  int* valid = reinterpret_cast<int*>(ps + kRows * (COLS + 1));  // COLS

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Sq = a.Sq, Sk = a.Sk;
  const int q_off = a.offsets[0];
  const int kv_off = a.offsets[1];
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const int8_t* mask = a.mask + static_cast<long long>(b) * Sk;

  stage<T, D>(qs, D + 1, q, a.q_ss, q0, kRows, Sq, a.scale);

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][DPT];
  uint32_t rk[kRowsPerThread];
  const uint32_t hk = head_key(static_cast<uint32_t>(a.offsets[2]), b * a.H + h);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
    rk[i] = row_key(hk, q0 + ty + 16 * i);
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.0f;
  }
  const int last_q = min(q0 + kRows, Sq) - 1 + q_off;

  for (int k0 = 0; k0 < Sk; k0 += COLS) {
    if (a.causal && k0 + kv_off > last_q) break;  // the rest is above the diagonal
    __syncthreads();  // the previous tile's readers are done
    stage<T, D>(ks, D + 1, k, a.k_ss, k0, COLS, Sk, 1.0f);
    stage<T, D>(vs, D, v, a.v_ss, k0, COLS, Sk, 1.0f);
    for (int c = threadIdx.x; c < COLS; c += kThreads)
      valid[c] = (k0 + c < Sk) && mask[k0 + c] != 0;
    __syncthreads();

    float s[kRowsPerThread][CPT];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRowsPerThread], kv[CPT];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int qpos = q0 + ty + 16 * i + q_off;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 16 * j;
        const bool ok = valid[c] && (!a.causal || k0 + c + kv_off <= qpos);
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 16 * j;
        float p = expf(s[i][j] - m_new);
        sum += p;
        if (a.dropout) p = keep_bit(rk[i], k0 + c, a.threshold) ? p * a.drop_scale : 0.0f;
        ps[(ty + 16 * i) * (COLS + 1) + c] = p;
      }
      l[i] = alpha * l[i] + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < COLS; ++c) {
      float pv[kRowsPerThread], vv[DPT];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) pv[i] = ps[(ty + 16 * i) * (COLS + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  const long long bh = static_cast<long long>(b) * a.H + h;
  T* o = static_cast<T*>(a.o) + bh * Sq * D;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const bool dead = m[i] <= kNegInf * 0.5f;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      store(o + static_cast<long long>(row) * D + tx + 16 * j, dead ? 0.0f : acc[i][j] / l_safe);
    if (tx == 0) a.lse_out[bh * Sq + row] = dead ? kNegInf : m[i] + logf(l_safe);
  }
}

// dq: one block per (q tile, h, b), looping over k tiles. Replaces
// `_bwd_dq_kernel` (sparknet_tpu/ops/attention.py:262). Bound: 6 B H Sq Sk
// D operations (s, dp, ds K) over 67 TFLOP/s; 2.42 GFLOP, 0.036 ms at
// BERT-base, above the 0.019 ms of its 63 MB. Against it: s and dp share
// one pass over D (16 shared-memory reads per 32 multiply-adds a thread),
// and p is recomputed from lse rather than stored by the forward.
template <typename T, int D, int COLS>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const FlashArgs a) {
  constexpr int CPT = COLS / 16;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                       // kRows x (D+1), q * scale
  float* dos = qs + kRows * (D + 1);      // kRows x (D+1)
  float* ks = dos + kRows * (D + 1);      // COLS x (D+1)
  float* vs = ks + COLS * (D + 1);        // COLS x (D+1)
  float* dss = vs + COLS * (D + 1);       // kRows x (COLS+1), ds
  int* valid = reinterpret_cast<int*>(dss + kRows * (COLS + 1));  // COLS

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Sq = a.Sq, Sk = a.Sk;
  const int q_off = a.offsets[0];
  const int kv_off = a.offsets[1];
  const long long bh = static_cast<long long>(b) * a.H + h;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const int8_t* mask = a.mask + static_cast<long long>(b) * Sk;

  stage<T, D>(qs, D + 1, q, a.q_ss, q0, kRows, Sq, a.scale);
  stage<T, D>(dos, D + 1, dout, a.do_ss, q0, kRows, Sq, 1.0f);

  float lse[kRowsPerThread], delta[kRowsPerThread], acc[kRowsPerThread][DPT];
  uint32_t rk[kRowsPerThread];
  const uint32_t hk = head_key(static_cast<uint32_t>(a.offsets[2]), static_cast<int>(bh));
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + ty + 16 * i;
    lse[i] = row < Sq ? a.lse[bh * Sq + row] : 0.0f;
    delta[i] = row < Sq ? a.delta[bh * Sq + row] : 0.0f;
    rk[i] = row_key(hk, row);
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.0f;
  }
  const int last_q = min(q0 + kRows, Sq) - 1 + q_off;

  for (int k0 = 0; k0 < Sk; k0 += COLS) {
    if (a.causal && k0 + kv_off > last_q) break;
    __syncthreads();
    stage<T, D>(ks, D + 1, k, a.k_ss, k0, COLS, Sk, 1.0f);
    stage<T, D>(vs, D + 1, v, a.v_ss, k0, COLS, Sk, 1.0f);
    for (int c = threadIdx.x; c < COLS; c += kThreads)
      valid[c] = (k0 + c < Sk) && mask[k0 + c] != 0;
    __syncthreads();

    float s[kRowsPerThread][CPT], dp[kRowsPerThread][CPT];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRowsPerThread], gv[kRowsPerThread], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        qv[i] = qs[(ty + 16 * i) * (D + 1) + d];
        gv[i] = dos[(ty + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
        vv[j] = vs[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int qpos = q0 + ty + 16 * i + q_off;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 16 * j;
        const bool ok = valid[c] && (!a.causal || k0 + c + kv_off <= qpos);
        const float sv = ok ? s[i][j] : kNegInf;
        // masked logits give p = 0 even where lse is itself NEG_INF
        const float p = sv <= kNegInf * 0.5f ? 0.0f : expf(sv - lse[i]);
        float g = dp[i][j];
        if (a.dropout) g = keep_bit(rk[i], k0 + c, a.threshold) ? g * a.drop_scale : 0.0f;
        dss[(ty + 16 * i) * (COLS + 1) + c] = p * (g - delta[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < COLS; ++c) {
      float dv_[kRowsPerThread], kv[DPT];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) dv_[i] = dss[(ty + 16 * i) * (COLS + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kv[j] = ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(dv_[i], kv[j], acc[i][j]);
    }
  }

  T* dq = static_cast<T*>(a.dq) + bh * Sq * D;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      store(dq + static_cast<long long>(row) * D + tx + 16 * j, acc[i][j] * a.scale);
  }
}

// dk/dv: one block per (k tile, h, b), looping over q tiles; the tile's
// rows are keys, its columns queries. Replaces `_bwd_dkv_kernel`
// (sparknet_tpu/ops/attention.py:341). Bound: 8 B H Sq Sk D operations
// (s, dp, p^T dO, ds^T q) over 67 TFLOP/s; 3.22 GFLOP, 0.048 ms at
// BERT-base, above the 0.023 ms of its 76 MB. Against it: as dq, and dk
// and dv accumulate in registers over the q loop, written once.
template <typename T, int D, int COLS>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const FlashArgs a) {
  constexpr int CPT = COLS / 16;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;                       // kRows x (D+1)
  float* vs = ks + kRows * (D + 1);       // kRows x (D+1)
  float* qs = vs + kRows * (D + 1);       // COLS x (D+1), q * scale
  float* dos = qs + COLS * (D + 1);       // COLS x (D+1)
  float* ps = dos + COLS * (D + 1);       // kRows x (COLS+1), dropped p
  float* dss = ps + kRows * (COLS + 1);   // kRows x (COLS+1), ds
  float* lses = dss + kRows * (COLS + 1); // COLS
  float* deltas = lses + COLS;            // COLS

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Sq = a.Sq, Sk = a.Sk;
  const int q_off = a.offsets[0];
  const int kv_off = a.offsets[1];
  const long long bh = static_cast<long long>(b) * a.H + h;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const int8_t* mask = a.mask + static_cast<long long>(b) * Sk;

  stage<T, D>(ks, D + 1, k, a.k_ss, k0, kRows, Sk, 1.0f);
  stage<T, D>(vs, D + 1, v, a.v_ss, k0, kRows, Sk, 1.0f);

  bool kvalid[kRowsPerThread];
  float dk[kRowsPerThread][DPT], dv[kRowsPerThread][DPT];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int key = k0 + ty + 16 * i;
    kvalid[i] = key < Sk && mask[key] != 0;
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk[i][j] = dv[i][j] = 0.0f;
  }
  const uint32_t hk = head_key(static_cast<uint32_t>(a.offsets[2]), static_cast<int>(bh));
  const int first_k = k0 + kv_off;

  for (int q0 = 0; q0 < Sq; q0 += COLS) {
    // queries before the diagonal cannot see this key tile
    if (a.causal && min(q0 + COLS, Sq) - 1 + q_off < first_k) continue;
    __syncthreads();
    stage<T, D>(qs, D + 1, q, a.q_ss, q0, COLS, Sq, a.scale);
    stage<T, D>(dos, D + 1, dout, a.do_ss, q0, COLS, Sq, 1.0f);
    for (int c = threadIdx.x; c < COLS; c += kThreads) {
      const bool in = q0 + c < Sq;
      lses[c] = in ? a.lse[bh * Sq + q0 + c] : 0.0f;
      deltas[c] = in ? a.delta[bh * Sq + q0 + c] : 0.0f;
    }
    __syncthreads();

    float s[kRowsPerThread][CPT], dp[kRowsPerThread][CPT];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[kRowsPerThread], vv[kRowsPerThread], qv[CPT], gv[CPT];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        kv[i] = ks[(ty + 16 * i) * (D + 1) + d];
        vv[i] = vs[(ty + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        qv[j] = qs[(tx + 16 * j) * (D + 1) + d];
        gv[j] = dos[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 16 * j;
      const int query = q0 + c;
      const uint32_t rk = row_key(hk, query);
      const float lse = lses[c];
      const float delta = deltas[c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int key = k0 + ty + 16 * i;
        const bool ok = kvalid[i] && query < Sq &&
                        (!a.causal || key + kv_off <= query + q_off);
        const float sv = ok ? s[i][j] : kNegInf;
        const float p = sv <= kNegInf * 0.5f ? 0.0f : expf(sv - lse);
        float p_drop = p;
        float g = dp[i][j];
        if (a.dropout) {
          const bool keep = keep_bit(rk, key, a.threshold);
          p_drop = keep ? p * a.drop_scale : 0.0f;
          g = keep ? g * a.drop_scale : 0.0f;
        }
        ps[(ty + 16 * i) * (COLS + 1) + c] = p_drop;
        dss[(ty + 16 * i) * (COLS + 1) + c] = p * (g - delta);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < COLS; ++c) {
      float pv[kRowsPerThread], dsv[kRowsPerThread], gv[DPT], qv[DPT];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        pv[i] = ps[(ty + 16 * i) * (COLS + 1) + c];
        dsv[i] = dss[(ty + 16 * i) * (COLS + 1) + c];
      }
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        gv[j] = dos[c * (D + 1) + tx + 16 * j];
        qv[j] = qs[c * (D + 1) + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          dv[i][j] = fmaf(pv[i], gv[j], dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
        }
    }
  }

  // q entered the products pre-scaled, so ds^T q already carries `scale`
  T* dkp = static_cast<T*>(a.dk) + bh * Sk * D;
  T* dvp = static_cast<T*>(a.dv) + bh * Sk * D;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      store(dkp + static_cast<long long>(key) * D + tx + 16 * j, dk[i][j]);
      store(dvp + static_cast<long long>(key) * D + tx + 16 * j, dv[i][j]);
    }
  }
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <int D>
constexpr int cols_for() { return D == 256 ? 32 : 64; }

template <int D, int COLS>
constexpr size_t smem_bytes(int which) {
  return which == kFwd
             ? sizeof(float) * (kRows * (D + 1) + COLS * (D + 1) + COLS * D +
                                kRows * (COLS + 1) + COLS)
         : which == kDq
             ? sizeof(float) * (2 * kRows * (D + 1) + 2 * COLS * (D + 1) +
                                kRows * (COLS + 1) + COLS)
             : sizeof(float) * (2 * kRows * (D + 1) + 2 * COLS * (D + 1) +
                                2 * kRows * (COLS + 1) + 2 * COLS);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int tiles, const FlashArgs& a,
                   cudaStream_t stream) {
  // above 48 KB a block's shared memory is dynamic only after this opt-in
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(a.H),
                  static_cast<unsigned>(a.B));
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_which(int which, const FlashArgs& a, cudaStream_t stream) {
  constexpr int COLS = cols_for<D>();
  const int q_tiles = (a.Sq + kRows - 1) / kRows;
  const int k_tiles = (a.Sk + kRows - 1) / kRows;
  if (which == kFwd)
    return launch(flash_fwd_kernel<T, D, COLS>, smem_bytes<D, COLS>(kFwd), q_tiles, a, stream);
  if (which == kDq)
    return launch(flash_bwd_dq_kernel<T, D, COLS>, smem_bytes<D, COLS>(kDq), q_tiles, a, stream);
  return launch(flash_bwd_dkv_kernel<T, D, COLS>, smem_bytes<D, COLS>(kDkv), k_tiles, a, stream);
}

template <typename T>
cudaError_t dispatch_d(int which, int d, const FlashArgs& a, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_which<T, 16>(which, a, stream);
    case 32: return launch_which<T, 32>(which, a, stream);
    case 64: return launch_which<T, 64>(which, a, stream);
    case 128: return launch_which<T, 128>(which, a, stream);
    case 256: return launch_which<T, 256>(which, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(int which, const FlashArgs* a, int head_dim, int dtype, int device, void* stream) {
  if (a->B <= 0 || a->H <= 0 || a->Sq <= 0 || a->Sk <= 0) return 0;
  if (a->H > 65535 || a->B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = dispatch_d<float>(which, head_dim, *a, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(which, head_dim, *a, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs alike; lse
// and delta are f32). head_dim: 16, 32, 64, 128 or 256. Each returns a
// cudaError_t (0 on success).

extern "C" int sparknet_flash_fwd(const FlashArgs* a, int head_dim, int dtype, int device,
                                  void* stream) {
  return run(kFwd, a, head_dim, dtype, device, stream);
}

extern "C" int sparknet_flash_bwd_dq(const FlashArgs* a, int head_dim, int dtype, int device,
                                     void* stream) {
  return run(kDq, a, head_dim, dtype, device, stream);
}

extern "C" int sparknet_flash_bwd_dkv(const FlashArgs* a, int head_dim, int dtype, int device,
                                      void* stream) {
  return run(kDkv, a, head_dim, dtype, device, stream);
}

extern "C" int sparknet_flash_args_size() { return static_cast<int>(sizeof(FlashArgs)); }

extern "C" const char* sparknet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
