// Causal GQA flash attention for prefill, for Hopper (sm_90a).
//
// Replaces the TPU kernel localai_tpu/ops/flash.py::_flash_kernel (launched
// by flash_prefill_attention, flash.py:144). Same contract: q [B,S,H,D],
// k/v [B,S,K,D] (bf16 or f32), lengths [B] int32 -> out [B,S,H,D] in q's
// type. Query head h reads kv head h / (H/K); key j is visible to query row
// i iff j <= i and j < lengths[b]; query rows at or past lengths[b] are
// written as exact zeros. Softmax runs online in f32.
//
// Design. One block of 256 threads owns one (batch, head, 64-row query
// tile) and walks the kv tiles of 64 keys in a loop; the TPU kernel walked
// them as a sequential grid axis with its softmax state in VMEM scratch,
// which Hopper's unordered blocks cannot carry. Q (pre-scaled), the K and V
// tiles and the probability tile live in shared memory as f32 (66 KB at
// D=64, 116 KB at D=128 of the 227 KB a block may use). Thread (ty, tx) of
// a 16x16 grid owns query rows 4ty..4ty+3 and key columns tx+16j, so a
// row's max and sum reduce over 16 lanes of one warp with shuffles; the
// same thread owns output columns tx+16c of its four rows, which keeps
// the running max, sum and accumulator of a row in the registers of the
// threads that update them. Tiles above the diagonal and past lengths[b]
// are never loaded; query tiles entirely past lengths[b] only write zeros.
// Blocks are issued last query tile first, since the last tiles walk the
// most keys.
//
// What bounds it. Prefill attention at long S is bound by operations: at
// S=2048, D=64, 4 query heads per kv head it does ~800 FLOPs per byte it
// must move, well past the card's bf16 ridge of ~295, and the work grows
// as S^2 while the bytes grow as S. This
// first version does its products with scalar f32 FMAs, not tensor cores,
// so it runs far below the 989 TFLOP/s bf16 rate: it is the simple,
// correct baseline. The next step is mma.sync / wgmma on bf16 tiles with
// cp.async or TMA loads (the tiles and the thread-to-row ownership are
// already laid out for a per-warp row split).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per kv tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "load_tile serves both the query and the kv tiles");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Copy `valid` rows of D elements (row stride `stride` elements) into a
// 64-row f32 tile of pitch P, multiplied by `mul`; rows >= valid are zero.
template <typename T, int D, int P>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t stride, int valid, float mul) {
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * P + c] = r < valid ? to_f32(src[r * stride + c]) * mul : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lengths,
                     T* __restrict__ out, int S, int H, int KH, float scale) {
  constexpr int P = D + 1;      // padded pitch: a column walk hits 16 banks
  constexpr int PP = kBK + 1;
  constexpr int NC = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [kBQ][P]  q * scale
  float* ks = qs + kBQ * P;     // [kBK][P]
  float* vs = ks + kBK * P;     // [kBK][D]
  float* ps = vs + kBK * D;     // [kBQ][PP] probabilities of this kv tile

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int kvh = h / (H / KH);
  const int len = min(lengths[b], S);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)KH * D;
  T* o = out + ((int64_t)b * S + q0) * q_stride + (int64_t)h * D;

  if (q0 >= len) {  // the whole tile is padding
    for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
      const int r = i / D, c = i % D;
      if (q0 + r < S) store(o + r * q_stride + c, 0.f);
    }
    return;
  }

  load_tile<T, D, P>(qs, q + ((int64_t)b * S + q0) * q_stride + (int64_t)h * D,
                     q_stride, min(kBQ, S - q0), scale);

  float acc[4][NC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const T* kb = k + (int64_t)b * S * kv_stride + (int64_t)kvh * D;
  const T* vb = v + (int64_t)b * S * kv_stride + (int64_t)kvh * D;
  const int kv_end = min(q0 + kBQ, len);  // no valid row of this tile sees past it
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's ks / vs / ps reads are done
    const int krows = min(kBK, S - k0);
    load_tile<T, D, P>(ks, kb + k0 * kv_stride, kv_stride, krows, 1.f);
    load_tile<T, D, D>(vs, vb + k0 * kv_stride, kv_stride, krows, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * P + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col > row || col >= len) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // ps complete

#pragma unroll 4
    for (int j = 0; j < krows; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * PP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vs[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= S) continue;
    const bool valid = q0 + r < len;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(o + r * q_stride + tx + 16 * c, valid ? acc[i][c] * inv : 0.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
           int B, int S, int H, int KH, float scale, cudaStream_t stream) {
  constexpr int P = D + 1, PP = kBK + 1;
  const int smem = (int)sizeof(float) * (kBQ * P + kBK * P + kBK * D + kBQ * PP);
  auto kern = flash_prefill_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, static_cast<T*>(out), S, H, KH, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Returns 0 or the cudaError_t of the failed launch.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const int* lengths, void* out, int B, int S, int H,
                             int KH, int D, int dtype, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (H <= 0 || KH <= 0 || H % KH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, lengths, out, B, S, H, KH, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, lengths, out, B, S, H, KH, scale, st);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, lengths, out, B, S, H, KH, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, lengths, out, B, S, H, KH, scale, st);
  return (int)cudaErrorInvalidValue;
}
