// Ragged paged-attention partials for Hopper (sm_90a).
//
// Replaces the TPU kernel localai_tpu/ops/paged_flash.py::_ragged_paged_kernel
// (launched by _paged_partials_rows, paged_flash.py:289). Same function:
// for each slot b, kv head kh and query row r, the online-softmax partials
// of q[b, kh, r] against the rows g < limits[b] of the slot's context,
// where row g lives in pool page table[b, g / page] at offset g % page:
//   s = q . k_g          (q rows arrive in f32 with 1/sqrt(D) applied)
//   s = softcap * tanh(s / softcap)          when softcap > 0, before masking
//   g is masked when g >= limits[b], or when window > 0 and
//     qpos[b, r] - g >= window (the layer's sliding flag is a runtime
//     operand: the wrapper passes window 0 for a global layer)
//   m = max over unmasked s, l = sum exp(s - m), acc = sum exp(s - m) v_g
// Inputs: q [B, K, QR, D] f32, pools [P, page, K, D] bf16, f32, fp8 e4m3
// or fp8 e5m2 (one layer's slice), table [B, MP] int32, limits [B] int32,
// qpos [B, QR] int32, and for fp8 pools kv_scale [2, K] f32 or null (all
// ones): such a pool stores value / scale, and the kernel multiplies each K
// element by kv_scale[0][kh] and each V element by kv_scale[1][kh] right
// after widening it to f32 in registers, as the TPU kernel does on its VMEM
// tile. bf16 and f32 pools are unscaled (the wrapper refuses a scale).
// Outputs: acc [B, K, QR, D], m [B, K, QR], l [B, K, QR], all f32. A slot
// with no unmasked row (limit 0: idle slots, the first prefill chunk)
// writes m = -1e30, l = 0, acc = 0. The walk covers min(limits[b], MP*page)
// rows, i.e. ceil(limits[b]/page) pages clamped to the table's width, as
// the TPU kernel does; rows of the last, partial page past the limit are
// masked, never assumed absent.
//
// Design. One block of 8 warps owns one (slot, kv head, tile of QT query
// rows); QT is 4 for decode (G = H/K query rows per kv head) and 16 for
// the multi-query rows of a prefill chunk (T*G rows, tiles in the grid).
// The TPU kernel walked a slot's pages as a sequential loop with its
// softmax state in VMEM; here the 8 warps split the slot's rows between
// them (warp w takes 32-row tiles w, w+8, ...), each keeping its own row
// max, sum and accumulator in registers, and the block merges the 8
// partial states in shared memory at the end. In a tile, lane i owns key
// row t0+i: it resolves the row's page through the table, reads the K row
// straight from the pool with 16-byte loads (nothing is staged, so shared
// memory does not grow with the page size) and scores it against the q
// tile held in shared memory (bf16/f32 rows in 16-byte loads of 8 values,
// fp8 rows in 8-byte loads of 8 values, so the row-to-lane mapping is the
// same for every pool type). Row max and sum reduce over the warp with
// shuffles; probabilities go through a per-warp shared buffer so every
// lane can weight the V rows, which the warp then reads coalesced (lane i
// holds columns i, i+32, ...). Probabilities are masked again after the
// exponential, so a wholly masked tile adds exp(0) to nothing.
//
// What bounds it. Decode reads each live K/V byte once for G query rows
// (~2 FLOPs per byte of bf16 KV per row, ~4 for fp8), far below the
// card's ridge: it is bound by bytes (an fp8 pool halves them), and a fast
// version spreads one slot's walk over many SMs (flash-decoding) and
// streams pages with cp.async/TMA. A prefill
// chunk scores T*G rows against the prefix, which is bound by operations;
// this first version does its products with scalar f32 FMAs, not tensor
// cores. Both are later work; this is the simple, correct baseline.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 32;  // rows per warp tile: one per lane
constexpr float kNegInf = -1e30f;

// Eight consecutive pool elements as f32, in 16-byte loads.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// Eight consecutive fp8 elements as f32, in one 8-byte load.
template <__nv_fp8_interpretation_t I>
__device__ __forceinline__ void load8_fp8(const void* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_fp8x2_storage_t* h = reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the low byte is the lower-addressed element
    const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(h[i], I)));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p, float* out) {
  load8_fp8<__NV_E4M3>(p, out);
}

__device__ __forceinline__ void load8(const __nv_fp8_e5m2* p, float* out) {
  load8_fp8<__NV_E5M2>(p, out);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 x) { return static_cast<float>(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D, int QT>
constexpr int smem_floats() {
  // q tile, per-warp probabilities, per-warp (m, l, acc) for the merge,
  // query positions.
  return QT * D + kWarps * kKeys * QT + kWarps * QT * (D + 2) + QT;
}

template <typename T, int D, int QT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool, const int* __restrict__ table,
                       const int* __restrict__ limits, const int* __restrict__ qpos,
                       const float* __restrict__ kv_scale, float* __restrict__ acc_out,
                       float* __restrict__ m_out, float* __restrict__ l_out, int KH, int QR,
                       int P, int page, int MP, int window, float softcap) {
  static_assert(D % 32 == 0 && QT % 4 == 0, "tile shape");
  constexpr int NC = D / 32;  // value columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                            // [QT][D]
  float* ps = qs + QT * D;                     // [kWarps][kKeys][QT]
  float* wm = ps + kWarps * kKeys * QT;        // [kWarps][QT]
  float* wl = wm + kWarps * QT;                // [kWarps][QT]
  float* wacc = wl + kWarps * QT;              // [kWarps][QT][D]
  int* qp = reinterpret_cast<int*>(wacc + kWarps * QT * D);  // [QT]

  const int b = blockIdx.z, kh = blockIdx.y, r0 = blockIdx.x * QT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row0 = ((int64_t)b * KH + kh) * QR + r0;  // first output row

  for (int i = threadIdx.x; i < QT * D; i += kThreads) {
    const int r = i / D;
    qs[i] = r0 + r < QR ? q[row0 * D + i] : 0.f;
  }
  if (threadIdx.x < QT)
    qp[threadIdx.x] = r0 + threadIdx.x < QR ? qpos[(int64_t)b * QR + r0 + threadIdx.x] : 0;
  __syncthreads();

  const int n_rows = min(max(limits[b], 0), MP * page);
  constexpr bool kFp8 = sizeof(T) == 1;  // only fp8 pools carry a scale
  const float ksc = kFp8 && kv_scale ? kv_scale[kh] : 1.f;
  const float vsc = kFp8 && kv_scale ? kv_scale[KH + kh] : 1.f;
  const int* trow = table + (int64_t)b * MP;
  const int64_t pool_row = (int64_t)KH * D;  // elements between pool rows
  float* pw = ps + warp * kKeys * QT;

  float m[QT], l[QT], acc[QT][NC];
#pragma unroll
  for (int r = 0; r < QT; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int t0 = warp * kKeys; t0 < n_rows; t0 += kWarps * kKeys) {
    const int g = t0 + lane;
    const bool live = g < n_rows;
    long long off = 0;  // this lane's row in the pool, as an element offset
    float s[QT];
#pragma unroll
    for (int r = 0; r < QT; ++r) s[r] = 0.f;
    if (live) {
      const int pid = min(max(trow[g / page], 0), P - 1);
      off = ((long long)pid * page + g % page) * pool_row + (long long)kh * D;
      const T* kr = k_pool + off;
#pragma unroll 2
      for (int d0 = 0; d0 < D; d0 += 8) {
        float kv[8];
        load8(kr + d0, kv);
        if (kFp8) {
#pragma unroll
          for (int i = 0; i < 8; ++i) kv[i] *= ksc;
        }
#pragma unroll
        for (int r = 0; r < QT; ++r) {
          const float4 qa = *reinterpret_cast<const float4*>(qs + r * D + d0);
          const float4 qb = *reinterpret_cast<const float4*>(qs + r * D + d0 + 4);
          s[r] = fmaf(qa.x, kv[0], s[r]);
          s[r] = fmaf(qa.y, kv[1], s[r]);
          s[r] = fmaf(qa.z, kv[2], s[r]);
          s[r] = fmaf(qa.w, kv[3], s[r]);
          s[r] = fmaf(qb.x, kv[4], s[r]);
          s[r] = fmaf(qb.y, kv[5], s[r]);
          s[r] = fmaf(qb.z, kv[6], s[r]);
          s[r] = fmaf(qb.w, kv[7], s[r]);
        }
      }
    }

    float p[QT];
#pragma unroll
    for (int r = 0; r < QT; ++r) {
      float x = s[r];
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);  // before the mask
      const bool ok = live && (window <= 0 || qp[r] - g < window);
      x = ok ? x : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float alpha = expf(fmaxf(m[r] - m_new, -80.f));
      p[r] = ok ? expf(x - m_new) : 0.f;  // masked again after the exp
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < QT / 4; ++i)
      reinterpret_cast<float4*>(pw + lane * QT)[i] =
          make_float4(p[4 * i], p[4 * i + 1], p[4 * i + 2], p[4 * i + 3]);
    __syncwarp();

    const int nk = min(kKeys, n_rows - t0);
    for (int j = 0; j < nk; ++j) {
      const long long offj = __shfl_sync(0xffffffffu, off, j);
      const T* vr = v_pool + offj;
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = kFp8 ? to_f32(vr[lane + 32 * c]) * vsc
                                                : to_f32(vr[lane + 32 * c]);
      const float4* pj = reinterpret_cast<const float4*>(pw + j * QT);
#pragma unroll
      for (int i = 0; i < QT / 4; ++i) {
        const float4 p4 = pj[i];
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[4 * i + u][c] = fmaf(pr[u], vv[c], acc[4 * i + u][c]);
      }
    }
    __syncwarp();  // pw is rewritten by the next tile
  }

  // Merge the warps' partial states: rescale each to the block's max.
#pragma unroll
  for (int r = 0; r < QT; ++r) {
    if (lane == 0) {
      wm[warp * QT + r] = m[r];
      wl[warp * QT + r] = l[r];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) wacc[(warp * QT + r) * D + lane + 32 * c] = acc[r][c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < QT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (r0 + r >= QR) continue;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * QT + r]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += wacc[(w * QT + r) * D + c] * expf(wm[w * QT + r] - mx);
    acc_out[(row0 + r) * D + c] = a;
  }
  if (threadIdx.x < QT && r0 + threadIdx.x < QR) {
    const int r = threadIdx.x;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * QT + r]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += wl[w * QT + r] * expf(wm[w * QT + r] - mx);
    m_out[row0 + r] = mx;
    l_out[row0 + r] = sum;
  }
}

template <typename T, int D, int QT>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* table,
           const int* limits, const int* qpos, const float* kv_scale, void* acc, void* m,
           void* l, int B, int KH, int QR, int P, int page, int MP, int window, float softcap,
           cudaStream_t stream) {
  const int smem = (int)sizeof(float) * smem_floats<D, QT>();
  auto kern = paged_attention_kernel<T, D, QT>;
  // Once per kernel variant (thread-safe static init): the attribute does
  // not change between launches.
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((QR + QT - 1) / QT, KH, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, limits, qpos, kv_scale, static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), KH, QR, P, page, MP, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_rows(const void* q, const void* k_pool, const void* v_pool, const int* table,
                const int* limits, const int* qpos, const float* kv_scale, void* acc, void* m,
                void* l, int B, int KH, int QR, int P, int page, int MP, int window,
                float softcap, cudaStream_t stream) {
  if (QR <= 4)
    return launch<T, D, 4>(q, k_pool, v_pool, table, limits, qpos, kv_scale, acc, m, l, B, KH,
                           QR, P, page, MP, window, softcap, stream);
  return launch<T, D, 16>(q, k_pool, v_pool, table, limits, qpos, kv_scale, acc, m, l, B, KH,
                          QR, P, page, MP, window, softcap, stream);
}

template <typename T>
int launch_dim(const void* q, const void* k_pool, const void* v_pool, const int* table,
               const int* limits, const int* qpos, const float* kv_scale, void* acc, void* m,
               void* l, int B, int KH, int QR, int D, int P, int page, int MP, int window,
               float softcap, cudaStream_t stream) {
  if (D == 64)
    return launch_rows<T, 64>(q, k_pool, v_pool, table, limits, qpos, kv_scale, acc, m, l, B,
                              KH, QR, P, page, MP, window, softcap, stream);
  if (D == 128)
    return launch_rows<T, 128>(q, k_pool, v_pool, table, limits, qpos, kv_scale, acc, m, l, B,
                               KH, QR, P, page, MP, window, softcap, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype (of the pools): 0 = float32,
// 1 = bfloat16, 2 = fp8 e4m3, 3 = fp8 e5m2. kv_scale: [2, KH] f32, or null
// for all ones; read for fp8 pools only. window: the sliding window of this layer, 0 for none.
// softcap: 0 for none. Returns 0 or the cudaError_t of the failed launch.
extern "C" int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                               const int* table, const int* limits, const int* qpos,
                               const float* kv_scale, void* acc, void* m, void* l, int B,
                               int KH, int QR, int D, int P, int page, int MP, int dtype,
                               int window, float softcap, void* stream) {
  if (B <= 0 || KH <= 0 || QR <= 0) return 0;
  if (P <= 0 || page <= 0 || MP <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(q, k_pool, v_pool, table, limits, qpos, kv_scale, acc, m, l, B,
                             KH, QR, D, P, page, MP, window, softcap, st);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(q, k_pool, v_pool, table, limits, qpos, kv_scale, acc, m,
                                     l, B, KH, QR, D, P, page, MP, window, softcap, st);
  if (dtype == 2)
    return launch_dim<__nv_fp8_e4m3>(q, k_pool, v_pool, table, limits, qpos, kv_scale, acc, m,
                                     l, B, KH, QR, D, P, page, MP, window, softcap, st);
  if (dtype == 3)
    return launch_dim<__nv_fp8_e5m2>(q, k_pool, v_pool, table, limits, qpos, kv_scale, acc, m,
                                     l, B, KH, QR, D, P, page, MP, window, softcap, st);
  return (int)cudaErrorInvalidValue;
}
