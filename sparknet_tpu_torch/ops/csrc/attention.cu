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
// What bounds them: per (query, key) pair the forward does 2D
// multiply-adds (s, then p v), dq 3D (s, dp, ds K), dk/dv 4D (s, dp,
// p^T dO, ds^T q); per byte of q, k, v, o and dO that is S/2 to S
// operations. The least time is the larger of bytes over 3.35 TB/s and
// operations over the peak rate of the units that run them, which the
// caller computes for its shapes.
//
// All three run on the tensor cores: TF32 wgmma with operands split into
// hi and lo parts so that they keep f32 accuracy, tiles staged by cp.async
// (their sections below). Two head-dimension routes are the exception and
// keep SIMT kernels, by an explicit dispatch (launch_spec): f32 dq at D
// 256, because its q and dO as hi and lo alone would take 256 KB of shared
// memory, more than the 227 KB a block may have; and dk/dv at D 256 in
// both dtypes, because its dk and dv accumulators alone would take 256
// registers a thread, more than the 255 a thread may have.
// chip_smoke.py's build phase checks for HGMMA in every tensor-core
// instantiation and for none elsewhere, and its --ab mode times all three
// kernels against another checkout.
//
// Every kernel's block owns 64 rows (query rows for the forward and dq,
// key rows for dk/dv) and loops over tiles of the other side, so the TPU's
// sequential grid dimension becomes this loop and nothing carries between
// blocks; the two backward kernels stay split, so no atomics are needed.
// Ragged edges of S_q and S_k are masked in every kernel, so the caller
// pads nothing. A causal tile wholly above the diagonal ends the forward's
// and dq's loop and is skipped by dk/dv. The SIMT kernels are correct and
// simple: f32 fused multiply-adds on the CUDA cores (67 TFLOP/s), 256
// threads (16 x 16) a block, tiles of 32 columns staged in shared memory
// as f32 rows padded to D+1 floats. The offsets and the dropout seed come
// from a (3,) int32 device tensor, so a traced offset or a seed drawn on
// the device needs no host read.
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

#include <atomic>

// The launchers' one argument, mirrored field for field by _FlashArgs in
// ops/attention.py. It has external linkage, as the extern "C" entry
// points that take it must.
struct FlashArgs {
  const void* q;          // (B, H, Sq, D), strides below, last dim contiguous;
                          // q, k, v (and dO) 16-byte aligned (base, strides)
                          // for the tensor-core kernels
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

// ---------------------------------------------------------------------------
// Forward on Hopper's tensor cores: TF32 wgmma with split operands
// ---------------------------------------------------------------------------
//
// Replaces `_fwd_kernel` (sparknet_tpu/ops/attention.py:151), which casts
// q, k and v to f32 and runs both products in f32. One TF32 pass keeps
// about three decimal digits, too few for the forward's f32 tolerance (o
// and lse within 2e-5 of the plain version). So an f32 operand x is split
// into hi = tf32(x) and lo = tf32(x - hi), x - hi being exact in f32, and
// a product a b is taken as a_hi b_lo + a_lo b_hi + a_hi b_hi: three TF32
// wgmma terms into one f32 accumulator, the small ones first. What is left
// out (a_lo b_lo and the rounding of lo) is about 2^-21 of |a b|. bf16
// operands are exact in TF32 (8 significant bits of its 11), so at bf16
// s = q k^T takes one term and o += p v two (p_hi v + p_lo v: p is f32, as
// on the TPU). One instruction family, wgmma.mma_async m64nNk8 f32.tf32,
// serves both dtypes; TERMS follow from the dtype (FwdTiles::kSplit).
//
// Bound: per (query, key) pair 2 D multiply-adds (s, then p v), each
// taken as TERMS tensor-core products. At BERT-base (B 32, H 12, S 128,
// D 64, f32, 3 + 3 terms) 4.83 GFLOP over 495 TFLOP/s dense TF32 is
// 0.0098 ms, under the 0.015 ms its 50 MB take at 3.35 TB/s: bytes bound
// it. At B 8 x S 512 (19.3 GFLOP, 0.039 ms) operations do.
//
// Design. A block is one warpgroup (128 threads) that owns 64 query rows,
// the wgmma M, and loops over tiles of KN keys (32 at D 64 and 128, 64
// below, 8 at D 256 so that f32 fits one block). TF32 wgmma reads both
// operands K-major from shared memory, and the hardware transposes only
// 16-bit types, so:
//   - q and k are K-major as they come ((rows, D), D contiguous): q is
//     split once into q_hi / q_lo, each key tile into k_hi / k_lo;
//   - for o += p v the B operand is v with K = keys, so v is written
//     transposed, vt (D rows of keys), as vt_hi / vt_lo;
//   - p reaches the second product through shared memory as p_hi / p_lo:
//     the accumulator's fragment layout is not the A-register layout.
// Each is in the no-swizzle canonical layout: core matrices of 8 rows of
// 16 bytes (4 tf32), those adjacent along K 128 bytes apart (the
// descriptor's LBO), 8-row groups K/4 x 128 bytes apart (SBO), so a k8
// step moves the start address by 256 bytes. Raw K and V rows come in by
// cp.async, 16-byte chunks zero-filled past Sk, into a double-buffered
// staging area: the next tile's copy is in flight while this tile is split
// and multiplied. Staged rows are XOR-swizzled by chunk, so the split pass
// reads without bank conflicts. The softmax runs on the s accumulator: in
// a wgmma m64nN f32 accumulator, warp w's thread holds rows 16 w + lane/4
// and that + 8, at columns 8 j + 2 (lane % 4) + {0, 1}; a row's max and
// sum are two shuffles over the lane quad, and each register's (query,
// key) index, for the masks and the dropout hash, follows from the layout.
// No TMA, mbarrier ring or warp specialisation yet: each product waits for
// its own wgmma group.

constexpr int kTcThreads = 128;  // the tensor-core kernels' block: one warpgroup
constexpr int kTcRows = 64;      // wgmma M: the query rows of a block

// x rounded to TF32 (nearest, ties away): the f32 pattern, low 13 bits 0.
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// wgmma shared-memory descriptor, no swizzle: start address, LBO and SBO
// in 16-byte units at bits 0, 16 and 32; layout type 0 at bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(const float* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Makes this thread's shared-memory stores visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns those registers.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 16-byte global-to-shared copy; bytes beyond `n` (0 or 16) are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest group landed
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// d (64 x N, f32) += a (64 x 8) b (N x 8)^T, both tf32 from shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x N, f32) += a (64 x 8, tf32 in registers) b (N x 8, tf32 in shared
// memory)^T. Warp w's thread holds a at rows 16 w + lane/4 (a[0], a[2])
// and that + 8 (a[1], a[3]), columns lane % 4 (a[0], a[1]) and that + 4.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Four consecutive elements as f32 (8-byte aligned for bf16, 16 for f32).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// x as four tf32 at hi and, when SPLIT, the remainders x - hi at lo.
template <bool SPLIT>
__device__ __forceinline__ void store_split(float* hi, float* lo, float4 x) {
  const float4 h = make_float4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
  *reinterpret_cast<float4*>(hi) = h;
  if (SPLIT)
    *reinterpret_cast<float4*>(lo) =
        make_float4(tf32(x.x - h.x), tf32(x.y - h.y), tf32(x.z - h.z), tf32(x.w - h.w));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [0, n) of an (n, D) operand into the canonical K-major layout (core
// matrices of 8 rows of 4 values, K-adjacent ones 128 bytes apart), as hi
// and, when SPLIT, lo. load(r, c) gives row r's values c .. c + 3. Thread
// i takes row 8 rg + i % 8, so 8 neighbouring threads fill one core matrix.
template <int D, bool SPLIT, typename Load4>
__device__ __forceinline__ void split_kmajor(float* hi, float* lo, int n, Load4 load) {
  for (int i = threadIdx.x; i < n * D / 4; i += kTcThreads) {
    const int r8 = i & 7;
    const int kc = (i >> 3) % (D / 4);
    const int rg = (i >> 3) / (D / 4);
    const int at = (rg * (D / 4) + kc) * 32 + r8 * 4;
    store_split<SPLIT>(hi + at, lo + at, load(rg * 8 + r8, 4 * kc));
  }
}

// A (KN, D) tile written transposed, (D, KN), in the same layout; load(r,
// e) gives row r's element e.
template <int D, int KN, bool SPLIT, typename Load>
__device__ __forceinline__ void split_transposed(float* hi, float* lo, Load load) {
  for (int i = threadIdx.x; i < D * KN / 4; i += kTcThreads) {
    const int d = i % D;
    const int kq = i / D;
    const float4 x = make_float4(load(4 * kq, d), load(4 * kq + 1, d), load(4 * kq + 2, d),
                                 load(4 * kq + 3, d));
    const int at = ((d >> 3) * (KN / 4) + kq) * 32 + (d & 7) * 4;
    store_split<SPLIT>(hi + at, lo + at, x);
  }
}

// Raw rows of two (rows, D) operands (k and v in the forward and dq, q and
// dO in dk/dv), tiles of N rows staged by cp.async in two buffers of both:
// 16-byte chunks, zero-filled past the operands' last row, XOR-swizzled by
// chunk so that the split passes read without bank conflicts.
template <typename T, int D, int N>
struct TileStage {
  static constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;  // per staged row
  static constexpr int kSwz = (kChunks < 8 ? kChunks : 8) - 1;
  static constexpr int kTileBytes = N * kChunks * 16;  // one raw tile of one operand
  static constexpr int kFloats = kTileBytes;  // four tiles, counted in floats

  // Byte offset, in a staged tile, of row r's element e.
  static __device__ __forceinline__ int at(int r, int e) {
    constexpr int per = 16 / static_cast<int>(sizeof(T));
    return (r * kChunks + ((e / per) ^ (r & kSwz))) * 16 + (e % per) * static_cast<int>(sizeof(T));
  }
  // Row r's four values from element e (8-byte aligned for bf16, 16 for f32).
  static __device__ __forceinline__ float4 load4_at(const unsigned char* tile, int r, int e) {
    return load4(reinterpret_cast<const T*>(tile + at(r, e)));
  }
  static __device__ __forceinline__ float value_at(const unsigned char* tile, int r, int e) {
    return to_f32(*reinterpret_cast<const T*>(tile + at(r, e)));
  }
  // Buffer t % 2: its tile of the first operand, then that of the second.
  static __device__ __forceinline__ unsigned char* first(unsigned char* stage, int t) {
    return stage + (t & 1) * 2 * kTileBytes;
  }
  // Issues the copies of tile t's rows of x and y (each `rows` long) into
  // buffer t % 2.
  static __device__ __forceinline__ void prefetch(unsigned char* stage, const T* x, long long x_ss,
                                                  const T* y, long long y_ss, int t, int rows) {
    unsigned char* sx = first(stage, t);
    unsigned char* sy = sx + kTileBytes;
    for (int i = threadIdx.x; i < N * kChunks; i += kTcThreads) {
      const int r = i / kChunks;
      const int c = i % kChunks;
      const int at = t * N + r;
      const long long row = at < rows ? at : 0;  // a valid address; nothing is read
      const int n = at < rows ? 16 : 0;
      const int to = (r * kChunks + (c ^ (r & kSwz))) * 16;
      cp_async16(sx + to, reinterpret_cast<const unsigned char*>(x + row * x_ss) + c * 16, n);
      cp_async16(sy + to, reinterpret_cast<const unsigned char*>(y + row * y_ss) + c * 16, n);
    }
  }
};

// The forward's tiles and its shared memory, as float offsets; every
// buffer is a multiple of 128 bytes.
template <typename T, int D>
struct FwdTiles {
  static constexpr bool kSplit = sizeof(T) == 4;  // f32 q, k, v need a lo part
  static constexpr int KN = D == 256 ? 8 : D >= 64 ? 32 : 64;  // keys per tile
  static constexpr int NO = D < 64 ? D : 64;  // wgmma N of o += p v; D / NO of them
  using Stage = TileStage<T, D, KN>;
  static constexpr int kLo = kSplit ? 1 : 0;
  static constexpr int kQHi = 0;                               // 64 x D
  static constexpr int kQLo = kQHi + kTcRows * D;              // 64 x D (f32)
  static constexpr int kKHi = kQLo + kLo * kTcRows * D;        // KN x D
  static constexpr int kKLo = kKHi + KN * D;                   // KN x D (f32)
  static constexpr int kVHi = kKLo + kLo * KN * D;             // D x KN
  static constexpr int kVLo = kVHi + KN * D;                   // D x KN (f32)
  static constexpr int kPHi = kVLo + kLo * KN * D;             // 64 x KN
  static constexpr int kPLo = kPHi + kTcRows * KN;             // 64 x KN
  static constexpr int kStage = kPLo + kTcRows * KN;           // 2 x (k, v) raw
  static constexpr int kValid = kStage + Stage::kFloats;       // KN ints
  static constexpr size_t kBytes = sizeof(float) * (kValid + KN);
};

// Forward: one block per (64-query tile, h, b). See the section comment.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_kernel(const FlashArgs a) {
  using L = FwdTiles<T, D>;
  constexpr int KN = L::KN;
  constexpr int NO = L::NO;
  constexpr int kOut = D / NO;
  extern __shared__ __align__(128) float fwd_smem[];
  float* const q_hi = fwd_smem + L::kQHi;
  float* const q_lo = fwd_smem + L::kQLo;
  float* const k_hi = fwd_smem + L::kKHi;
  float* const k_lo = fwd_smem + L::kKLo;
  float* const vt_hi = fwd_smem + L::kVHi;
  float* const vt_lo = fwd_smem + L::kVLo;
  float* const p_hi = fwd_smem + L::kPHi;
  float* const p_lo = fwd_smem + L::kPLo;
  unsigned char* const stage = reinterpret_cast<unsigned char*>(fwd_smem + L::kStage);
  int* const valid = reinterpret_cast<int*>(fwd_smem + L::kValid);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Sq = a.Sq, Sk = a.Sk;
  const int q_off = a.offsets[0];
  const int kv_off = a.offsets[1];
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const int8_t* mask = a.mask + static_cast<long long>(b) * Sk;

  // keys this block can see; causal stops at its last query's diagonal
  int k_end = Sk;
  if (a.causal) k_end = min(Sk, min(q0 + kTcRows, Sq) + q_off - kv_off);
  const int n_tiles = k_end > 0 ? (k_end + KN - 1) / KN : 0;

  using S = typename L::Stage;
  if (n_tiles > 0) S::prefetch(stage, k, a.k_ss, v, a.v_ss, 0, Sk);
  cp_async_commit();

  // q, split once (rows past Sq are zeros); scale is applied to s
  split_kmajor<D, L::kSplit>(q_hi, q_lo, kTcRows, [&](int r, int c) {
    const int row = q0 + r;
    return row < Sq ? load4(q + row * a.q_ss + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  });

  const int row0 = warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const uint32_t hk = head_key(static_cast<uint32_t>(a.offsets[2]), b * a.H + h);
  const uint32_t rk[2] = {row_key(hk, q0 + row0), row_key(hk, q0 + row0 + 8)};
  const int qpos[2] = {q0 + row0 + q_off, q0 + row0 + 8 + q_off};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float o[kOut][NO / 2];
#pragma unroll
  for (int j = 0; j < kOut; ++j)
#pragma unroll
    for (int r = 0; r < NO / 2; ++r) o[j][r] = 0.0f;

  // LBO: 128 bytes between K-adjacent core matrices; SBO: K/4 of them
  const uint64_t dq_hi = smem_desc(q_hi, 128, D * 32), dq_lo = smem_desc(q_lo, 128, D * 32);
  const uint64_t dk_hi = smem_desc(k_hi, 128, D * 32), dk_lo = smem_desc(k_lo, 128, D * 32);
  const uint64_t dp_hi = smem_desc(p_hi, 128, KN * 32), dp_lo = smem_desc(p_lo, 128, KN * 32);
  const uint64_t dv_hi = smem_desc(vt_hi, 128, KN * 32), dv_lo = smem_desc(vt_lo, 128, KN * 32);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * KN;
    if (t + 1 < n_tiles) S::prefetch(stage, k, a.k_ss, v, a.v_ss, t + 1, Sk);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile t has landed; the last tile's products are done

    // split: k into k_hi / k_lo (K-major as staged), v transposed into vt
    const unsigned char* sk = S::first(stage, t);
    const unsigned char* sv = sk + S::kTileBytes;
    split_kmajor<D, L::kSplit>(k_hi, k_lo, KN,
                               [&](int r, int c) { return S::load4_at(sk, r, c); });
    split_transposed<D, KN, L::kSplit>(vt_hi, vt_lo,
                                       [&](int r, int e) { return S::value_at(sv, r, e); });
    if (tid < KN) valid[tid] = k0 + tid < Sk && mask[k0 + tid] != 0;
    fence_async_smem();
    __syncthreads();

    // s = q k^T: the small terms first, then hi hi
    float s[KN / 2];
#pragma unroll
    for (int r = 0; r < KN / 2; ++r) s[r] = 0.0f;
    fence_regs(s);
    wgmma_fence();
    if (L::kSplit) {
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        wgmma_tf32(s, dq_hi + 16 * ks, dk_lo + 16 * ks);
        wgmma_tf32(s, dq_lo + 16 * ks, dk_hi + 16 * ks);
      }
    }
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) wgmma_tf32(s, dq_hi + 16 * ks, dk_hi + 16 * ks);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // online softmax on the accumulator; p (dropped) to p_hi / p_lo
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int r = 0; r < KN / 2; ++r) {
      const int i = (r >> 1) & 1;
      const int c = 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
      const bool ok = valid[c] && (!a.causal || k0 + c + kv_off <= qpos[i]);
      s[r] = ok ? s[r] * a.scale : kNegInf;
      mx[i] = fmaxf(mx[i], s[r]);
    }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = quad_max(mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int r = 0; r < KN / 2; r += 2) {
      const int i = (r >> 1) & 1;
      const int c = 8 * (r >> 2) + 2 * (lane & 3);
      float p0 = expf(s[r] - m[i]);
      float p1 = expf(s[r + 1] - m[i]);
      sum[i] += p0;
      sum[i] += p1;
      if (a.dropout) {
        p0 = keep_bit(rk[i], k0 + c, a.threshold) ? p0 * a.drop_scale : 0.0f;
        p1 = keep_bit(rk[i], k0 + c + 1, a.threshold) ? p1 * a.drop_scale : 0.0f;
      }
      const int row = row0 + 8 * i;
      const int at = ((row >> 3) * (KN / 4) + (c >> 2)) * 32 + (row & 7) * 4 + (c & 3);
      const float h0 = tf32(p0), h1 = tf32(p1);
      store2(p_hi + at, h0, h1);
      store2(p_lo + at, tf32(p0 - h0), tf32(p1 - h1));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + quad_sum(sum[i]);
#pragma unroll
    for (int j = 0; j < kOut; ++j)
#pragma unroll
      for (int r = 0; r < NO / 2; ++r) o[j][r] *= alpha[(r >> 1) & 1];
    fence_async_smem();
    __syncthreads();

    // o += p v, D in chunks of NO columns (vt rows)
#pragma unroll
    for (int j = 0; j < kOut; ++j) fence_regs(o[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const uint64_t rows = static_cast<uint64_t>(j * NO * KN / 4);  // 16-byte units
#pragma unroll
      for (int ks = 0; ks < KN / 8; ++ks) {
        if (L::kSplit) wgmma_tf32(o[j], dp_hi + 16 * ks, dv_lo + rows + 16 * ks);
        wgmma_tf32(o[j], dp_lo + 16 * ks, dv_hi + rows + 16 * ks);
      }
#pragma unroll
      for (int ks = 0; ks < KN / 8; ++ks)
        wgmma_tf32(o[j], dp_hi + 16 * ks, dv_hi + rows + 16 * ks);
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int j = 0; j < kOut; ++j) fence_regs(o[j]);
  }

  const long long bh = static_cast<long long>(b) * a.H + h;
  T* out = static_cast<T*>(a.o) + bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row0 + 8 * i;
    if (row >= Sq) continue;
    const bool dead = m[i] <= kNegInf * 0.5f;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = out + static_cast<long long>(row) * D;
#pragma unroll
    for (int j = 0; j < kOut; ++j)
#pragma unroll
      for (int r = 2 * i; r < NO / 2; r += 4)  // row i's registers: r % 4 in {2i, 2i + 1}
        store2(orow + j * NO + 8 * (r >> 2) + 2 * (lane & 3),
               dead ? 0.0f : o[j][r] / l_safe, dead ? 0.0f : o[j][r + 1] / l_safe);
    if ((lane & 3) == 0) a.lse_out[bh * Sq + row] = dead ? kNegInf : m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// dq on Hopper's tensor cores: three TF32 wgmma products with split operands
// ---------------------------------------------------------------------------
//
// Replaces `_bwd_dq_kernel` (sparknet_tpu/ops/attention.py:262): per key
// tile, s = q k^T, p = exp(scale s - lse) (0 where masked), dp = dO v^T
// with the dropout mask regenerated, ds = p (dp - delta), dq += ds k;
// written once as dq scale. Bound: 6 B H Sq Sk D operations (its three
// products) over 495 TFLOP/s dense TF32, or its bytes (q, k, v, dO read,
// dq written) over 3.35 TB/s: at BERT-base (B 32, H 12, S 128, D 64, f32)
// 2.42 GFLOP is 0.0049 ms, under the 0.0189 ms of its 63 MB, so bytes
// bound it; at B 8 x S 512 operations do (9.66 GFLOP, 0.0195 ms).
//
// Design, the forward's carried over (its section comment): one warpgroup
// owns 64 query rows, the wgmma M, and loops over tiles of KN keys. f32
// operands are split into hi and lo and each product is taken as three
// TF32 terms, the small ones first: 3 + 3 + 3 at f32; at bf16 (exact in
// TF32) 1 for s, 1 for dp and 2 for dq += ds k (ds is f32: ds_hi k +
// ds_lo k). TF32 wgmma reads both operands K-major, so:
//   - q and dO, the A operands of s and dp, are split once per block:
//     at D <= 64 into registers, as wgmma A fragments (kRegA: D / 2 a
//     thread for each of q and dO, twice that at f32), which leaves the
//     shared-memory reads of the two products to their small B operands;
//     at D 128 and 256 (too many registers) into shared memory;
//   - each key tile's k is split K-major for s (the B operand, K = D),
//     and also written transposed, kt (D rows of keys), for dq += ds k,
//     whose reduction runs over keys: the forward's vt, applied to k;
//   - v is split K-major for dp; it needs no transpose;
//   - ds reaches the third product through shared memory as ds_hi /
//     ds_lo, like the forward's p.
// Raw K and V rows come in by cp.async, double-buffered and XOR-swizzled
// by chunk, as in the forward. The s and dp products are issued as one
// wgmma group before a single wait; the mask, p, dropout and ds run on
// their accumulators, indexed from the fragment layout; the dq
// accumulator (64 x D, in wgmma N-chunks of at most 64) stays in
// registers across the key loop. KN keeps two or more blocks on an SM
// where it can (f32 D 64: KN 32, 96.1 KiB); f32 D 256 does not fit at all
// (kFits) and keeps the SIMT kernel further below. At f32 D 64, on an
// H100, A in registers with KN 32 took 0.76x the card time of A in shared
// memory with KN 16, which took 0.72x that of KN 32 (PERF.md).

template <typename T, int D>
struct DqTiles {
  static constexpr bool kSplit = sizeof(T) == 4;  // f32 q, k, v, dO need a lo part
  // q and dO as hi and lo are 256 KB at f32 D 256: more than a block may have
  static constexpr bool kFits = !(kSplit && D == 256);
  // q and dO as wgmma A fragments in registers, not in shared memory
  static constexpr bool kRegA = D <= 64;
  static constexpr int kA = kRegA ? 0 : 1;  // q and dO tiles in shared memory
  static constexpr int KN =  // keys per tile
      D == 16 ? 64 : D == 32 ? (kSplit ? 32 : 64) : D == 64 ? 32 : 16;
  static constexpr int NQ = D < 64 ? D : 64;  // wgmma N of dq += ds k; D / NQ of them
  using Stage = TileStage<T, D, KN>;
  static constexpr int kLo = kSplit ? 1 : 0;
  static constexpr int kQHi = 0;                               // 64 x D
  static constexpr int kQLo = kQHi + kA * kTcRows * D;         // 64 x D (f32)
  static constexpr int kOHi = kQLo + kA * kLo * kTcRows * D;   // dO, 64 x D
  static constexpr int kOLo = kOHi + kA * kTcRows * D;         // 64 x D (f32)
  static constexpr int kKHi = kOLo + kA * kLo * kTcRows * D;   // KN x D
  static constexpr int kKLo = kKHi + KN * D;                   // KN x D (f32)
  static constexpr int kVHi = kKLo + kLo * KN * D;             // KN x D
  static constexpr int kVLo = kVHi + KN * D;                   // KN x D (f32)
  static constexpr int kTHi = kVLo + kLo * KN * D;             // kt, D x KN
  static constexpr int kTLo = kTHi + KN * D;                   // D x KN (f32)
  static constexpr int kSHi = kTLo + kLo * KN * D;             // ds, 64 x KN
  static constexpr int kSLo = kSHi + kTcRows * KN;             // 64 x KN
  static constexpr int kStage = kSLo + kTcRows * KN;           // 2 x (k, v) raw
  static constexpr int kValid = kStage + Stage::kFloats;       // KN ints
  static constexpr size_t kBytes = sizeof(float) * (kValid + KN);
  static_assert(!kFits || kBytes <= 232448, "dq tiles exceed a block's shared memory");
};

// dq: one block per (64-query tile, h, b). See the section comment.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dq_kernel(const FlashArgs a) {
  using L = DqTiles<T, D>;
  constexpr int KN = L::KN;
  constexpr int NQ = L::NQ;
  constexpr int kOut = D / NQ;
  extern __shared__ __align__(128) float dq_smem[];
  float* const q_hi = dq_smem + L::kQHi;
  float* const q_lo = dq_smem + L::kQLo;
  float* const do_hi = dq_smem + L::kOHi;
  float* const do_lo = dq_smem + L::kOLo;
  float* const k_hi = dq_smem + L::kKHi;
  float* const k_lo = dq_smem + L::kKLo;
  float* const v_hi = dq_smem + L::kVHi;
  float* const v_lo = dq_smem + L::kVLo;
  float* const kt_hi = dq_smem + L::kTHi;
  float* const kt_lo = dq_smem + L::kTLo;
  float* const ds_hi = dq_smem + L::kSHi;
  float* const ds_lo = dq_smem + L::kSLo;
  unsigned char* const stage = reinterpret_cast<unsigned char*>(dq_smem + L::kStage);
  int* const valid = reinterpret_cast<int*>(dq_smem + L::kValid);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kTcRows;
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

  // keys this block can see; causal stops at its last query's diagonal
  int k_end = Sk;
  if (a.causal) k_end = min(Sk, min(q0 + kTcRows, Sq) + q_off - kv_off);
  const int n_tiles = k_end > 0 ? (k_end + KN - 1) / KN : 0;

  using S = typename L::Stage;
  if (n_tiles > 0) S::prefetch(stage, k, a.k_ss, v, a.v_ss, 0, Sk);
  cp_async_commit();

  const int row0 = warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8

  // q and dO, split once (rows past Sq are zeros); scale is applied to s
  constexpr int kFrag = L::kRegA ? D / 8 : 1;
  uint32_t qa[2][kFrag][4], oa[2][kFrag][4];  // [hi, lo][k step][register]
  if constexpr (L::kRegA) {
#pragma unroll
    for (int ks = 0; ks < kFrag; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + row0 + 8 * (j & 1);
        const int col = 8 * ks + (lane & 3) + 4 * (j >> 1);
        const float x = row < Sq ? to_f32(q[row * a.q_ss + col]) : 0.0f;
        const float g = row < Sq ? to_f32(dout[row * a.do_ss + col]) : 0.0f;
        const float xh = tf32(x), gh = tf32(g);
        qa[0][ks][j] = __float_as_uint(xh);
        oa[0][ks][j] = __float_as_uint(gh);
        qa[1][ks][j] = __float_as_uint(tf32(x - xh));
        oa[1][ks][j] = __float_as_uint(tf32(g - gh));
      }
  } else {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    split_kmajor<D, L::kSplit>(q_hi, q_lo, kTcRows, [&](int r, int c) {
      return q0 + r < Sq ? load4(q + (q0 + r) * a.q_ss + c) : zero;
    });
    split_kmajor<D, L::kSplit>(do_hi, do_lo, kTcRows, [&](int r, int c) {
      return q0 + r < Sq ? load4(dout + (q0 + r) * a.do_ss + c) : zero;
    });
  }

  const uint32_t hk = head_key(static_cast<uint32_t>(a.offsets[2]), static_cast<int>(bh));
  float lse[2], delta[2];
  uint32_t rk[2];
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row0 + 8 * i;
    lse[i] = row < Sq ? a.lse[bh * Sq + row] : 0.0f;
    delta[i] = row < Sq ? a.delta[bh * Sq + row] : 0.0f;
    rk[i] = row_key(hk, row);
    qpos[i] = row + q_off;
  }
  float acc[kOut][NQ / 2];
#pragma unroll
  for (int j = 0; j < kOut; ++j)
#pragma unroll
    for (int r = 0; r < NQ / 2; ++r) acc[j][r] = 0.0f;

  // LBO: 128 bytes between K-adjacent core matrices; SBO: K/4 of them
  const uint64_t dq_hi = smem_desc(q_hi, 128, D * 32), dq_lo = smem_desc(q_lo, 128, D * 32);
  const uint64_t ddo_hi = smem_desc(do_hi, 128, D * 32), ddo_lo = smem_desc(do_lo, 128, D * 32);
  const uint64_t dk_hi = smem_desc(k_hi, 128, D * 32), dk_lo = smem_desc(k_lo, 128, D * 32);
  const uint64_t dv_hi = smem_desc(v_hi, 128, D * 32), dv_lo = smem_desc(v_lo, 128, D * 32);
  const uint64_t dkt_hi = smem_desc(kt_hi, 128, KN * 32), dkt_lo = smem_desc(kt_lo, 128, KN * 32);
  const uint64_t dds_hi = smem_desc(ds_hi, 128, KN * 32), dds_lo = smem_desc(ds_lo, 128, KN * 32);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * KN;
    if (t + 1 < n_tiles) S::prefetch(stage, k, a.k_ss, v, a.v_ss, t + 1, Sk);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile t has landed; the last tile's products are done

    // split: k and v as staged (K-major), k also transposed into kt
    const unsigned char* sk = S::first(stage, t);
    const unsigned char* sv = sk + S::kTileBytes;
    split_kmajor<D, L::kSplit>(k_hi, k_lo, KN,
                               [&](int r, int c) { return S::load4_at(sk, r, c); });
    split_kmajor<D, L::kSplit>(v_hi, v_lo, KN,
                               [&](int r, int c) { return S::load4_at(sv, r, c); });
    split_transposed<D, KN, L::kSplit>(kt_hi, kt_lo,
                                       [&](int r, int e) { return S::value_at(sk, r, e); });
    if (tid < KN) valid[tid] = k0 + tid < Sk && mask[k0 + tid] != 0;
    fence_async_smem();
    __syncthreads();

    // s = q k^T and dp = dO v^T, one wgmma group: small terms first
    float s[KN / 2], dp[KN / 2];
#pragma unroll
    for (int r = 0; r < KN / 2; ++r) s[r] = dp[r] = 0.0f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    if constexpr (L::kRegA) {
      if (L::kSplit) {
#pragma unroll
        for (int ks = 0; ks < D / 8; ++ks) {
          wgmma_tf32(s, qa[0][ks], dk_lo + 16 * ks);
          wgmma_tf32(s, qa[1][ks], dk_hi + 16 * ks);
        }
      }
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) wgmma_tf32(s, qa[0][ks], dk_hi + 16 * ks);
      if (L::kSplit) {
#pragma unroll
        for (int ks = 0; ks < D / 8; ++ks) {
          wgmma_tf32(dp, oa[0][ks], dv_lo + 16 * ks);
          wgmma_tf32(dp, oa[1][ks], dv_hi + 16 * ks);
        }
      }
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) wgmma_tf32(dp, oa[0][ks], dv_hi + 16 * ks);
    } else {
      if (L::kSplit) {
#pragma unroll
        for (int ks = 0; ks < D / 8; ++ks) {
          wgmma_tf32(s, dq_hi + 16 * ks, dk_lo + 16 * ks);
          wgmma_tf32(s, dq_lo + 16 * ks, dk_hi + 16 * ks);
        }
      }
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) wgmma_tf32(s, dq_hi + 16 * ks, dk_hi + 16 * ks);
      if (L::kSplit) {
#pragma unroll
        for (int ks = 0; ks < D / 8; ++ks) {
          wgmma_tf32(dp, ddo_hi + 16 * ks, dv_lo + 16 * ks);
          wgmma_tf32(dp, ddo_lo + 16 * ks, dv_hi + 16 * ks);
        }
      }
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) wgmma_tf32(dp, ddo_hi + 16 * ks, dv_hi + 16 * ks);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    // ds = p (dp - delta) on the accumulators, to ds_hi / ds_lo
#pragma unroll
    for (int r = 0; r < KN / 2; r += 2) {
      const int i = (r >> 1) & 1;
      const int c = 8 * (r >> 2) + 2 * (lane & 3);
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = valid[c + e] && (!a.causal || k0 + c + e + kv_off <= qpos[i]);
        // masked logits give p = 0 even where lse is itself NEG_INF
        const float sv = ok ? s[r + e] * a.scale : kNegInf;
        const float p = sv <= kNegInf * 0.5f ? 0.0f : expf(sv - lse[i]);
        float g = dp[r + e];
        if (a.dropout) g = keep_bit(rk[i], k0 + c + e, a.threshold) ? g * a.drop_scale : 0.0f;
        ds[e] = p * (g - delta[i]);
      }
      const int row = row0 + 8 * i;
      const int at = ((row >> 3) * (KN / 4) + (c >> 2)) * 32 + (row & 7) * 4 + (c & 3);
      const float h0 = tf32(ds[0]), h1 = tf32(ds[1]);
      store2(ds_hi + at, h0, h1);
      store2(ds_lo + at, tf32(ds[0] - h0), tf32(ds[1] - h1));
    }
    fence_async_smem();
    __syncthreads();

    // dq += ds k, D in chunks of NQ columns (kt rows)
#pragma unroll
    for (int j = 0; j < kOut; ++j) fence_regs(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const uint64_t rows = static_cast<uint64_t>(j * NQ * KN / 4);  // 16-byte units
#pragma unroll
      for (int ks = 0; ks < KN / 8; ++ks) {
        if (L::kSplit) wgmma_tf32(acc[j], dds_hi + 16 * ks, dkt_lo + rows + 16 * ks);
        wgmma_tf32(acc[j], dds_lo + 16 * ks, dkt_hi + rows + 16 * ks);
      }
#pragma unroll
      for (int ks = 0; ks < KN / 8; ++ks)
        wgmma_tf32(acc[j], dds_hi + 16 * ks, dkt_hi + rows + 16 * ks);
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int j = 0; j < kOut; ++j) fence_regs(acc[j]);
  }

  // a row whose every key is masked has ds = 0, so dq = 0 exactly
  T* out = static_cast<T*>(a.dq) + bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row0 + 8 * i;
    if (row >= Sq) continue;
    T* orow = out + static_cast<long long>(row) * D;
#pragma unroll
    for (int j = 0; j < kOut; ++j)
#pragma unroll
      for (int r = 2 * i; r < NQ / 2; r += 4)  // row i's registers: r % 4 in {2i, 2i + 1}
        store2(orow + j * NQ + 8 * (r >> 2) + 2 * (lane & 3), acc[j][r] * a.scale,
               acc[j][r + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// dk/dv on Hopper's tensor cores: four TF32 wgmma products with split operands
// ---------------------------------------------------------------------------
//
// Replaces `_bwd_dkv_kernel` (sparknet_tpu/ops/attention.py:341): per query
// tile, with keys as rows and queries as columns, s^T = k q^T, p = exp(scale
// s - lse) (0 where masked), dp^T = v dO^T with the dropout mask
// regenerated, ds^T = p (dp - delta), dv += drop(p)^T dO and dk += ds^T q;
// written once, dk times scale. Bound: 8 B H Sq Sk D operations (its four
// products) over 495 TFLOP/s dense TF32, or its bytes (q, k, v, dO read,
// dk and dv written) over 3.35 TB/s: at BERT-base (B 32, H 12, S 128, D 64,
// f32) 3.22 GFLOP is 0.0065 ms, under the 0.0227 ms of its 76 MB, so bytes
// bound it, and the design's 12 terms (9.66 GFLOP, 0.0195 ms) stay under
// them too; at B 8 x S 512 operations do (38.7 GFLOP of terms, 0.078 ms).
//
// Design, dq's carried over with rows and columns swapped: one warpgroup
// owns 64 key rows, the wgmma M, and loops over tiles of QN queries. TF32
// terms, the small ones first: 3 + 3 + 3 + 3 at f32; at bf16 (exact in
// TF32) 1 for s, 1 for dp and 2 each for dv and dk (p and ds are f32: their
// hi and lo parts times the bf16 operand). TF32 wgmma reads B K-major, so:
//   - k and v, the A operands of s^T and dp^T, are split once per block
//     into shared memory (as wgmma A fragments they would add 128
//     registers a thread at f32 D 64 beside the dk and dv accumulators);
//   - each query tile's q and dO are split K-major, the B operands of s^T
//     and dp^T (K = D), and also written transposed, qt and dOt (D rows of
//     queries), the B operands of dk += ds^T q and dv += p^T dO, whose
//     reduction runs over queries: the forward's vt, applied to q and dO;
//   - drop(p)^T and ds^T never leave registers: they are the A fragments
//     of those two products. An accumulator holds columns 2 (lane % 4) and
//     that + 1 of each 8, an A fragment columns lane % 4 and that + 4; the
//     order of a reduction is free, so qt and dOt hold each 8 queries in
//     the order 0 2 4 6 1 3 5 7 (frag_query), and accumulator registers
//     4 ks + {0, 2, 1, 3} are the fragment of k step ks as they stand;
//   - lse and delta, per column here (per row in dq), are staged per tile
//     in shared memory.
// Raw q and dO rows come in by cp.async, double-buffered and XOR-swizzled
// by chunk (TileStage). s^T and dp^T are one wgmma group before a single
// wait, dv and dk another; the masks, p, dropout and ds run on the
// accumulators, indexed from the fragment layout; dk and dv (64 x D each,
// in wgmma N-chunks of at most 64) stay in registers across the query
// loop. Query tiles wholly before a causal diagonal are skipped. Routes
// (DkvTiles::kFits): D 16, 32, 64 and 128 run here at f32 and bf16; at D
// 256 the dk and dv accumulators alone would take 256 registers a thread,
// more than a thread may have, so both dtypes keep the SIMT kernel further
// below. QN keeps two blocks on an SM where it can: at f32 D 64, 16
// queries take 112.1 KiB (32 would take 160.1 KiB, one block).

template <typename T, int D>
struct DkvTiles {
  static constexpr bool kSplit = sizeof(T) == 4;  // f32 q, k, v, dO need a lo part
  // dk and dv in registers: D / 2 + D / 2 a thread, 256 at D 256
  static constexpr bool kFits = D <= 128;
  static constexpr int QN = D <= 32 || (D == 64 && !kSplit) ? 32 : 16;  // queries per tile
  static constexpr int NO = D < 64 ? D : 64;  // wgmma N of dk and dv; D / NO of each
  using Stage = TileStage<T, D, QN>;
  static constexpr int kLo = kSplit ? 1 : 0;
  static constexpr int kKHi = 0;                          // 64 x D
  static constexpr int kKLo = kKHi + kTcRows * D;         // 64 x D (f32)
  static constexpr int kVHi = kKLo + kLo * kTcRows * D;   // 64 x D
  static constexpr int kVLo = kVHi + kTcRows * D;         // 64 x D (f32)
  static constexpr int kQHi = kVLo + kLo * kTcRows * D;   // QN x D
  static constexpr int kQLo = kQHi + QN * D;              // QN x D (f32)
  static constexpr int kOHi = kQLo + kLo * QN * D;        // dO, QN x D
  static constexpr int kOLo = kOHi + QN * D;              // QN x D (f32)
  static constexpr int kQtHi = kOLo + kLo * QN * D;       // qt, D x QN
  static constexpr int kQtLo = kQtHi + QN * D;            // D x QN (f32)
  static constexpr int kOtHi = kQtLo + kLo * QN * D;      // dOt, D x QN
  static constexpr int kOtLo = kOtHi + QN * D;            // D x QN (f32)
  static constexpr int kStage = kOtLo + kLo * QN * D;     // 2 x (q, dO) raw
  static constexpr int kLse = kStage + Stage::kFloats;    // QN
  static constexpr int kDelta = kLse + QN;                // QN
  static constexpr size_t kBytes = sizeof(float) * (kDelta + QN);
  static_assert(!kFits || kBytes <= 232448, "dk/dv tiles exceed a block's shared memory");
};

// The query that qt and dOt hold at position r of a tile: within each 8,
// position c holds query 2 c (c < 4) or 2 (c - 4) + 1, the order in which
// an accumulator's columns fall into an A fragment's.
__device__ __forceinline__ int frag_query(int r) {
  return (r & ~7) | ((r >> 2) & 1) | ((r & 3) << 1);
}

// Keeps wgmma A fragments in their registers until the products that read
// them have been waited for.
template <int S, int N>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[S][N][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(f[s][n][j])::"memory");
}

// dk/dv: one block per (64-key tile, h, b). See the section comment.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dkv_kernel(const FlashArgs a) {
  using L = DkvTiles<T, D>;
  constexpr int QN = L::QN;
  constexpr int NO = L::NO;
  constexpr int kOut = D / NO;
  constexpr int kSteps = QN / 8;  // k8 steps of dk += ds^T q and dv += p^T dO
  extern __shared__ __align__(128) float dkv_smem[];
  float* const k_hi = dkv_smem + L::kKHi;
  float* const k_lo = dkv_smem + L::kKLo;
  float* const v_hi = dkv_smem + L::kVHi;
  float* const v_lo = dkv_smem + L::kVLo;
  float* const q_hi = dkv_smem + L::kQHi;
  float* const q_lo = dkv_smem + L::kQLo;
  float* const do_hi = dkv_smem + L::kOHi;
  float* const do_lo = dkv_smem + L::kOLo;
  float* const qt_hi = dkv_smem + L::kQtHi;
  float* const qt_lo = dkv_smem + L::kQtLo;
  float* const dot_hi = dkv_smem + L::kOtHi;
  float* const dot_lo = dkv_smem + L::kOtLo;
  unsigned char* const stage = reinterpret_cast<unsigned char*>(dkv_smem + L::kStage);
  float* const lse_s = dkv_smem + L::kLse;
  float* const delta_s = dkv_smem + L::kDelta;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * kTcRows;
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

  // query tiles that can see these keys; causal starts at the tile of the
  // first query on key k0's diagonal
  const int n_tiles = (Sq + QN - 1) / QN;
  int t_begin = 0;
  if (a.causal) {
    const int first_q = k0 + kv_off - q_off;
    t_begin = first_q >= Sq ? n_tiles : first_q > 0 ? first_q / QN : 0;
  }

  using S = typename L::Stage;
  if (t_begin < n_tiles) S::prefetch(stage, q, a.q_ss, dout, a.do_ss, t_begin, Sq);
  cp_async_commit();

  // k and v, split once (rows past Sk are zeros)
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  split_kmajor<D, L::kSplit>(k_hi, k_lo, kTcRows, [&](int r, int c) {
    return k0 + r < Sk ? load4(k + (k0 + r) * a.k_ss + c) : zero;
  });
  split_kmajor<D, L::kSplit>(v_hi, v_lo, kTcRows, [&](int r, int c) {
    return k0 + r < Sk ? load4(v + (k0 + r) * a.v_ss + c) : zero;
  });

  const int row0 = warp * 16 + (lane >> 2);  // this thread's keys: row0, row0 + 8
  const uint32_t hk = head_key(static_cast<uint32_t>(a.offsets[2]), static_cast<int>(bh));
  bool kvalid[2];
  int kpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + row0 + 8 * i;
    kvalid[i] = key < Sk && mask[key] != 0;
    kpos[i] = key + kv_off;
  }
  float dk[kOut][NO / 2], dv[kOut][NO / 2];
#pragma unroll
  for (int j = 0; j < kOut; ++j)
#pragma unroll
    for (int r = 0; r < NO / 2; ++r) dk[j][r] = dv[j][r] = 0.0f;

  // wgmma descriptors of the A (k, v) and B operands; LBO: 128 bytes
  // between K-adjacent core matrices; SBO: K/4 of them
  const uint64_t ak_hi = smem_desc(k_hi, 128, D * 32), ak_lo = smem_desc(k_lo, 128, D * 32);
  const uint64_t av_hi = smem_desc(v_hi, 128, D * 32), av_lo = smem_desc(v_lo, 128, D * 32);
  const uint64_t bq_hi = smem_desc(q_hi, 128, D * 32), bq_lo = smem_desc(q_lo, 128, D * 32);
  const uint64_t bdo_hi = smem_desc(do_hi, 128, D * 32), bdo_lo = smem_desc(do_lo, 128, D * 32);
  const uint64_t bqt_hi = smem_desc(qt_hi, 128, QN * 32), bqt_lo = smem_desc(qt_lo, 128, QN * 32);
  const uint64_t bdot_hi = smem_desc(dot_hi, 128, QN * 32),
                 bdot_lo = smem_desc(dot_lo, 128, QN * 32);

  for (int t = t_begin; t < n_tiles; ++t) {
    const int q0 = t * QN;
    if (t + 1 < n_tiles) S::prefetch(stage, q, a.q_ss, dout, a.do_ss, t + 1, Sq);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile t has landed; the last tile's products are done

    // split: q and dO as staged (K-major), both also transposed into qt and
    // dOt in fragment order; the tile's lse and delta
    const unsigned char* sq = S::first(stage, t);
    const unsigned char* sd = sq + S::kTileBytes;
    split_kmajor<D, L::kSplit>(q_hi, q_lo, QN,
                               [&](int r, int c) { return S::load4_at(sq, r, c); });
    split_kmajor<D, L::kSplit>(do_hi, do_lo, QN,
                               [&](int r, int c) { return S::load4_at(sd, r, c); });
    split_transposed<D, QN, L::kSplit>(
        qt_hi, qt_lo, [&](int r, int e) { return S::value_at(sq, frag_query(r), e); });
    split_transposed<D, QN, L::kSplit>(
        dot_hi, dot_lo, [&](int r, int e) { return S::value_at(sd, frag_query(r), e); });
    if (tid < QN) {
      const bool in = q0 + tid < Sq;
      lse_s[tid] = in ? a.lse[bh * Sq + q0 + tid] : 0.0f;
      delta_s[tid] = in ? a.delta[bh * Sq + q0 + tid] : 0.0f;
    }
    fence_async_smem();
    __syncthreads();

    // s^T = k q^T and dp^T = v dO^T, one wgmma group: small terms first
    float s[QN / 2], dp[QN / 2];
#pragma unroll
    for (int r = 0; r < QN / 2; ++r) s[r] = dp[r] = 0.0f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    if (L::kSplit) {
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        wgmma_tf32(s, ak_hi + 16 * ks, bq_lo + 16 * ks);
        wgmma_tf32(s, ak_lo + 16 * ks, bq_hi + 16 * ks);
      }
    }
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) wgmma_tf32(s, ak_hi + 16 * ks, bq_hi + 16 * ks);
    if (L::kSplit) {
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        wgmma_tf32(dp, av_hi + 16 * ks, bdo_lo + 16 * ks);
        wgmma_tf32(dp, av_lo + 16 * ks, bdo_hi + 16 * ks);
      }
    }
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) wgmma_tf32(dp, av_hi + 16 * ks, bdo_hi + 16 * ks);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    // drop(p) and ds = p (drop(dp) - delta) on the accumulators, as the hi
    // and lo A fragments of each k step: register r of the accumulator is
    // register ((r & 1) << 1) | ((r >> 1) & 1) of step r / 4's fragment
    uint32_t pa[2][kSteps][4], sa[2][kSteps][4];  // [hi, lo][k step][register]
#pragma unroll
    for (int r = 0; r < QN / 2; ++r) {
      const int i = (r >> 1) & 1;
      const int c = 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
      const int query = q0 + c;
      const bool ok = kvalid[i] && query < Sq && (!a.causal || kpos[i] <= query + q_off);
      // masked logits give p = 0 even where lse is itself NEG_INF
      const float sv = ok ? s[r] * a.scale : kNegInf;
      const float p = sv <= kNegInf * 0.5f ? 0.0f : expf(sv - lse_s[c]);
      float pd = p, g = dp[r];
      if (a.dropout) {
        const bool keep = keep_bit(row_key(hk, query), k0 + row0 + 8 * i, a.threshold);
        pd = keep ? p * a.drop_scale : 0.0f;
        g = keep ? g * a.drop_scale : 0.0f;
      }
      const float ds = p * (g - delta_s[c]);
      const int j = ((r & 1) << 1) | i;
      const float ph = tf32(pd), dh = tf32(ds);
      pa[0][r >> 2][j] = __float_as_uint(ph);
      pa[1][r >> 2][j] = __float_as_uint(tf32(pd - ph));
      sa[0][r >> 2][j] = __float_as_uint(dh);
      sa[1][r >> 2][j] = __float_as_uint(tf32(ds - dh));
    }

    // dv += drop(p)^T dO and dk += ds^T q, D in chunks of NO columns (dOt
    // and qt rows), one wgmma group
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      fence_regs(dv[j]);
      fence_regs(dk[j]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const uint64_t rows = static_cast<uint64_t>(j * NO * QN / 4);  // 16-byte units
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        if (L::kSplit) wgmma_tf32(dv[j], pa[0][ks], bdot_lo + rows + 16 * ks);
        wgmma_tf32(dv[j], pa[1][ks], bdot_hi + rows + 16 * ks);
      }
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) wgmma_tf32(dv[j], pa[0][ks], bdot_hi + rows + 16 * ks);
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        if (L::kSplit) wgmma_tf32(dk[j], sa[0][ks], bqt_lo + rows + 16 * ks);
        wgmma_tf32(dk[j], sa[1][ks], bqt_hi + rows + 16 * ks);
      }
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) wgmma_tf32(dk[j], sa[0][ks], bqt_hi + rows + 16 * ks);
    }
    wgmma_commit();
    wgmma_wait();
    fence_frags(pa);
    fence_frags(sa);
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      fence_regs(dv[j]);
      fence_regs(dk[j]);
    }
  }

  // rows of a masked key took p = ds = 0 from every query, so they are 0
  // exactly; q entered unscaled, so dk takes `scale` here
  T* dkp = static_cast<T*>(a.dk) + bh * Sk * D;
  T* dvp = static_cast<T*>(a.dv) + bh * Sk * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + row0 + 8 * i;
    if (key >= Sk) continue;
    const long long at = static_cast<long long>(key) * D;
#pragma unroll
    for (int j = 0; j < kOut; ++j)
#pragma unroll
      for (int r = 2 * i; r < NO / 2; r += 4) {  // row i's registers: r % 4 in {2i, 2i + 1}
        const int col = j * NO + 8 * (r >> 2) + 2 * (lane & 3);
        store2(dkp + at + col, dk[j][r] * a.scale, dk[j][r + 1] * a.scale);
        store2(dvp + at + col, dv[j][r], dv[j][r + 1]);
      }
  }
}

// dq on the CUDA cores, for f32 at head dim 256 only (DqTiles::kFits):
// one block per (q tile, h, b), looping over k tiles. Bound: 6 B H Sq Sk
// D operations (s, dp, ds K) over 67 TFLOP/s. Against it: s and dp share
// one pass over D (16 shared-memory reads per 32 multiply-adds a thread),
// and p is recomputed from lse rather than stored by the forward.
template <typename T, int D, int COLS>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_simt_kernel(const FlashArgs a) {
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

// dk/dv on the CUDA cores, for head dim 256 only (DkvTiles::kFits): one
// block per (k tile, h, b), looping over q tiles; the tile's rows are
// keys, its columns queries. Bound: 8 B H Sq Sk D operations (s, dp, p^T
// dO, ds^T q) over 67 TFLOP/s. Against it: as dq's, and dk and dv
// accumulate in registers over the q loop, written once.
template <typename T, int D, int COLS>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_simt_kernel(const FlashArgs a) {
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

constexpr int kSimtCols = 32;  // the SIMT kernels' column tile (they run at D 256)

template <int D, int COLS>
constexpr size_t smem_bytes(int which) {
  return which == kDq
             ? sizeof(float) * (2 * kRows * (D + 1) + 2 * COLS * (D + 1) +
                                kRows * (COLS + 1) + COLS)
             : sizeof(float) * (2 * kRows * (D + 1) + 2 * COLS * (D + 1) +
                                2 * kRows * (COLS + 1) + 2 * COLS);
}

// One kernel instantiation as it is launched: its dynamic shared memory,
// whether it asks for the largest carveout (so that two 112 KB blocks fit
// one SM), its block size, and the devices on which its attributes are
// set (bit `device`). Every kernel's grid tile has 64 rows.
struct Spec {
  void (*kernel)(FlashArgs);
  size_t smem;
  bool max_carveout;
  int threads;
  std::atomic<unsigned long long>* set_on;
};

template <auto Kernel>
Spec make_spec(size_t smem, bool max_carveout, int threads) {
  static std::atomic<unsigned long long> set_on{0};
  return {Kernel, smem, max_carveout, threads, &set_on};
}

// The kernel that runs `which` at (T, D): every one on the tensor cores,
// except dq at f32 D 256, whose tiles do not fit a block (DqTiles::kFits),
// and dk/dv at D 256, whose accumulators do not fit a thread's registers
// (DkvTiles::kFits): there the SIMT kernels run.
template <typename T, int D>
Spec launch_spec(int which) {
  constexpr int COLS = kSimtCols;
  if (which == kFwd)
    return make_spec<flash_fwd_kernel<T, D>>(FwdTiles<T, D>::kBytes, true, kTcThreads);
  if (which == kDq) {
    if constexpr (DqTiles<T, D>::kFits)
      return make_spec<flash_bwd_dq_kernel<T, D>>(DqTiles<T, D>::kBytes, true, kTcThreads);
    else
      return make_spec<flash_bwd_dq_simt_kernel<T, D, COLS>>(smem_bytes<D, COLS>(kDq), false,
                                                             kThreads);
  }
  if constexpr (DkvTiles<T, D>::kFits)
    return make_spec<flash_bwd_dkv_kernel<T, D>>(DkvTiles<T, D>::kBytes, true, kTcThreads);
  else
    return make_spec<flash_bwd_dkv_simt_kernel<T, D, COLS>>(smem_bytes<D, COLS>(kDkv), false,
                                                            kThreads);
}

template <typename T>
bool spec_d(int which, int d, Spec* s) {
  switch (d) {
    case 16: *s = launch_spec<T, 16>(which); return true;
    case 32: *s = launch_spec<T, 32>(which); return true;
    case 64: *s = launch_spec<T, 64>(which); return true;
    case 128: *s = launch_spec<T, 128>(which); return true;
    case 256: *s = launch_spec<T, 256>(which); return true;
    default: return false;
  }
}

bool find_spec(int which, int head_dim, int dtype, Spec* s) {
  if (which < kFwd || which > kDkv) return false;
  if (dtype == 0) return spec_d<float>(which, head_dim, s);
  if (dtype == 1) return spec_d<__nv_bfloat16>(which, head_dim, s);
  return false;
}

// A kernel's attributes belong to each device's context. They are set on
// the first launch on a device, not on every launch: each call costs host
// time. Above 48 KB a block's shared memory is dynamic only after the
// opt-in.
cudaError_t set_attributes(const Spec& s, int device) {
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (bit && (s.set_on->load(std::memory_order_acquire) & bit)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(s.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(s.smem));
  if (err == cudaSuccess && s.max_carveout)
    err = cudaFuncSetAttribute(s.kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) s.set_on->fetch_or(bit, std::memory_order_acq_rel);
  return err;
}

int run(int which, const FlashArgs* a, int head_dim, int dtype, int device, void* stream) {
  if (a->B <= 0 || a->H <= 0 || a->Sq <= 0 || a->Sk <= 0) return 0;
  if (a->H > 65535 || a->B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Spec s;
  if (!find_spec(which, head_dim, dtype, &s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = set_attributes(s, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = which == kDkv ? a->Sk : a->Sq;
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), static_cast<unsigned>(a->H),
                  static_cast<unsigned>(a->B));
  s.kernel<<<grid, s.threads, s.smem, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
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

// The kernel that runs `which` (0 forward, 1 dq, 2 dk/dv) at head_dim and
// dtype: its dynamic shared memory per block (out[0], bytes), registers
// per thread (out[1]), blocks resident per SM (out[2]) and threads per
// block (out[3]: 128, one warpgroup, on the tensor cores; 256 on the CUDA
// cores). The build log's ptxas report has the registers only.
extern "C" int sparknet_flash_info(int which, int head_dim, int dtype, int device, int* out) {
  Spec s;
  if (!find_spec(which, head_dim, dtype, &s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = set_attributes(s, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, s.kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], s.kernel, s.threads, s.smem);
  out[0] = static_cast<int>(s.smem);
  out[1] = err == cudaSuccess ? attr.numRegs : 0;
  out[3] = s.threads;
  return static_cast<int>(err);
}

extern "C" int sparknet_flash_args_size() { return static_cast<int>(sizeof(FlashArgs)); }

extern "C" const char* sparknet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
