// Weight-only quantized matmuls for Hopper (sm_90a): the fused
// dequant-matmul (B3) and the int8 unembed (B4).
//
// B3 replaces the TPU kernel localai_tpu/ops/quant_matmul.py::_qmm_kernel
// (launched by _qmm_call, quant_matmul.py:246) for its three dense forms.
// Same function: out[n, o] = sum_k x[n, k] * w[k, o] for x [N, IN] (f32 or
// bf16, N <= 256 on the serving path), accumulated in f32, written in x's
// dtype, with the weight in one of:
//   form 0, flat int8:    q [IN, OUT] int8, s [OUT] f32; the scale is applied
//                         once to the finished sum (the TPU kernel's _emit);
//   form 1, grouped int8: gq [G, gs, OUT] int8, gs [G, OUT] f32; each group's
//                         partial sum is multiplied by its scale;
//   form 2, packed int4:  g4 [G, gs/2, OUT] uint8, gs and gz [G, OUT] f32;
//                         the byte at (g, i, o) holds in-row g*gs + i in its
//                         low nibble and g*gs + gs/2 + i in its high nibble;
//                         value = nibble * s - z, so a group adds
//                         s * sum(x * nibble) - z * sum(x) (the zero point's
//                         rank-1 correction).
//
// B4 replaces localai_tpu/ops/quant_matmul.py::_unembed_kernel (launched by
// _plain_unembed, quant_matmul.py:326): logits[n, v] = (h[n] . q[v]) * s[v]
// for the vocab-major int8 head q [V, D], s [V] f32, h [N, D] f32 or bf16,
// f32 logits [N, V]. The transpose is never materialized.
//
// What bounds them. At decode (N = 1..8 rows) each weight byte feeds at
// most 2*8 FLOPs, far below the card's ridge: both are bound by the weight
// bytes they read (B3 at llama-3-8b's w_gate: 58.7 MB int8, 29.4 MB int4
// payload; B4: 525 MB of int8 head). The design reads every weight byte
// once, coalesced, and keeps the dequantized values in registers only.
//
// B3 design. A block of 8 warps owns 128 output columns (lane l: columns
// 4l..4l+3, one 32-bit load = 4 int8 weights or 8 int4 nibbles of 4
// columns, so a warp reads a contiguous 128-byte stretch of a weight row)
// and a tile of RT rows (1 for a single row, else 8). The TPU kernel walked
// the reduction as a sequential grid axis; here the 8 warps split it
// inside the block: per stage the block stages x[RT rows][8 chunks of 32
// in-rows] in shared memory as f32, warp w takes chunk w (one group of the
// grouped forms, whose group size is 32) and requests all of its weight
// words before using any, and at the end the 8 warps' sums are added in
// shared memory in a fixed order, so results do not depend on scheduling.
// Known limits, recorded rather than fixed in this version: at OUT = 1024
// (wk, wv) the grid has 8 blocks for 132 SMs, and above 8 rows each row
// tile re-reads the weights; split-K across blocks (with a deterministic
// second pass) and tensor cores are later work.
//
// B4 design. A block of 8 warps owns 32 vocab rows (4 per warp) and a tile
// of RT h rows; it walks D in 512-column stages, staging h in shared
// memory (padded so the lanes' 16-float reads hit distinct banks). In a
// stage lane l reads 16 contiguous bytes of each of its warp's vocab rows
// (one 16-byte load per row), reads each staged h row once and dots it
// with all 4, and keeps 4 x RT partial sums; a warp shuffle reduces them
// at the end and the scale is applied on the write. V = 128256 gives 4008
// blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 4;                // output columns per lane
constexpr int kBlockCols = 32 * kCols;  // output columns per block
constexpr int kGroup = 32;              // in-rows per warp and stage; the group size
constexpr int kStage = kWarps * kGroup; // in-rows per stage
constexpr int kVocabPerWarp = 4;
constexpr int kHStage = 512;            // h columns per stage in B4 (16 per lane)
constexpr int kHSeg = 20;               // 16 floats + 4 pad: bank-conflict-free float4 reads

enum Form { kFlat = 0, kGrouped = 1, kInt4 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Byte c of w as a signed int8, in f32.
__device__ __forceinline__ float i8(uint32_t w, int c) {
  return (float)(((int32_t)(w << (24 - 8 * c))) >> 24);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// dst[r][c] += sum over the 32 in-rows u of x[r][u] * int8 byte c of wv[u];
// xw: row r's 32 staged values at xw[r * kStage], in-row order.
template <int RT>
__device__ __forceinline__ void fma_int8_chunk(const uint32_t (&wv)[kGroup], const float* xw,
                                               float (&dst)[RT][kCols]) {
#pragma unroll
  for (int u4 = 0; u4 < kGroup; u4 += 4) {
    float f[4][kCols];
#pragma unroll
    for (int uu = 0; uu < 4; ++uu)
#pragma unroll
      for (int c = 0; c < kCols; ++c) f[uu][c] = i8(wv[u4 + uu], c);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float4 x4 = *reinterpret_cast<const float4*>(xw + r * kStage + u4);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int uu = 0; uu < 4; ++uu)
#pragma unroll
        for (int c = 0; c < kCols; ++c) dst[r][c] = fmaf(xv[uu], f[uu][c], dst[r][c]);
    }
  }
}

template <typename XT, int RT, int FORM>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
           const float* __restrict__ s, const float* __restrict__ z, XT* __restrict__ out,
           int N, int IN, int OUT) {
  // The x stage (+ the int4 per-group x sums), then the warps' sums.
  constexpr int kSmem = (RT * kStage + RT * kWarps) > (kWarps * RT * kBlockCols)
                            ? (RT * kStage + RT * kWarps)
                            : (kWarps * RT * kBlockCols);
  __shared__ __align__(16) float smem[kSmem];
  float* xs = smem;                  // [RT][kStage]
  float* xsum = xs + RT * kStage;    // [RT][kWarps], int4 only

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * RT;
  const int col = blockIdx.x * kBlockCols + lane * kCols;
  const bool col_ok = col < OUT;  // OUT % 4 == 0: a lane's columns are all in or all out

  float acc[RT][kCols];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < IN; k0 += kStage) {
    __syncthreads();  // the previous stage has been consumed
    for (int i = threadIdx.x; i < RT * kStage; i += kThreads) {
      const int r = i / kStage, k = k0 + i % kStage;
      xs[i] = (r0 + r < N && k < IN) ? to_f32(x[(int64_t)(r0 + r) * IN + k]) : 0.f;
    }
    __syncthreads();
    if (FORM == kInt4) {
      if (threadIdx.x < RT * kWarps) {  // sum of x over each staged group
        const float* xr =
            xs + (threadIdx.x / kWarps) * kStage + (threadIdx.x % kWarps) * kGroup;
        float t = 0.f;
#pragma unroll
        for (int i = 0; i < kGroup; ++i) t += xr[i];
        xsum[threadIdx.x] = t;
      }
      __syncthreads();
    }
    const int kw = k0 + warp * kGroup;  // this warp's first in-row
    if (!col_ok || kw >= IN) continue;
    const float* xw = xs + warp * kGroup;  // row r, in-row kw + u at xw[r * kStage + u]

    // Every weight word of the chunk is requested before any is used, so
    // the warp waits for memory once per stage.
    if (FORM == kInt4) {
      const uint8_t* wg = w + (int64_t)(kw / kGroup) * (kGroup / 2) * OUT + col;
      uint32_t wv[kGroup / 2];
#pragma unroll
      for (int u = 0; u < kGroup / 2; ++u)
        wv[u] = *reinterpret_cast<const uint32_t*>(wg + (int64_t)u * OUT);
      float part[RT][kCols];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) part[r][c] = 0.f;
#pragma unroll
      for (int u4 = 0; u4 < kGroup / 2; u4 += 4) {
        float lo[4][kCols], hi[4][kCols];
#pragma unroll
        for (int uu = 0; uu < 4; ++uu)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            lo[uu][c] = (float)((wv[u4 + uu] >> (8 * c)) & 0xfu);
            hi[uu][c] = (float)((wv[u4 + uu] >> (8 * c + 4)) & 0xfu);
          }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4 xl4 = *reinterpret_cast<const float4*>(xw + r * kStage + u4);
          const float4 xh4 =
              *reinterpret_cast<const float4*>(xw + r * kStage + kGroup / 2 + u4);
          const float xl[4] = {xl4.x, xl4.y, xl4.z, xl4.w};
          const float xh[4] = {xh4.x, xh4.y, xh4.z, xh4.w};
#pragma unroll
          for (int uu = 0; uu < 4; ++uu)
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              part[r][c] = fmaf(xh[uu], hi[uu][c], fmaf(xl[uu], lo[uu][c], part[r][c]));
        }
      }
      const int g = kw / kGroup;
      const float4 s4 = *reinterpret_cast<const float4*>(s + (int64_t)g * OUT + col);
      const float4 z4 = *reinterpret_cast<const float4*>(z + (int64_t)g * OUT + col);
      const float sc[kCols] = {s4.x, s4.y, s4.z, s4.w};
      const float zc[kCols] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float xg = xsum[r * kWarps + warp];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[r][c] = fmaf(part[r][c], sc[c], fmaf(-xg, zc[c], acc[r][c]));
      }
    } else {
      const int n = min(kGroup, IN - kw);  // a flat weight's last chunk may be short
      uint32_t wv[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        wv[u] = u < n ? *reinterpret_cast<const uint32_t*>(w + (int64_t)(kw + u) * OUT + col)
                      : 0u;
      if (FORM == kFlat) {
        fma_int8_chunk<RT>(wv, xw, acc);
      } else {
        float part[RT][kCols];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < kCols; ++c) part[r][c] = 0.f;
        fma_int8_chunk<RT>(wv, xw, part);
        const float4 s4 =
            *reinterpret_cast<const float4*>(s + (int64_t)(kw / kGroup) * OUT + col);
        const float sc[kCols] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(part[r][c], sc[c], acc[r][c]);
      }
    }
  }

  // The warps' sums, added in warp order.
  __syncthreads();
  float* red = smem;  // [kWarps][RT][kBlockCols]
#pragma unroll
  for (int r = 0; r < RT; ++r)
    *reinterpret_cast<float4*>(red + (warp * RT + r) * kBlockCols + lane * kCols) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int i = threadIdx.x; i < RT * kBlockCols; i += kThreads) {
    const int r = i / kBlockCols, c = i % kBlockCols;
    const int o = blockIdx.x * kBlockCols + c;
    if (r0 + r >= N || o >= OUT) continue;
    float v = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < kWarps; ++w8) v += red[(w8 * RT + r) * kBlockCols + c];
    if (FORM == kFlat) v *= s[o];
    store(out + (int64_t)(r0 + r) * OUT + o, v);
  }
}

template <typename XT, int RT>
__global__ void __launch_bounds__(kThreads)
unembed_kernel(const XT* __restrict__ h, const int8_t* __restrict__ q,
               const float* __restrict__ s, float* __restrict__ out, int N, int D, int V) {
  __shared__ __align__(16) float hs[RT][(kHStage / 16) * kHSeg];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * RT;
  const int v0 = (blockIdx.x * kWarps + warp) * kVocabPerWarp;

  float acc[kVocabPerWarp][RT];
#pragma unroll
  for (int j = 0; j < kVocabPerWarp; ++j)
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[j][r] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kHStage) {
    __syncthreads();
    for (int i = threadIdx.x; i < RT * kHStage; i += kThreads) {
      const int r = i / kHStage, e = i % kHStage, k = k0 + e;
      hs[r][(e / 16) * kHSeg + e % 16] =
          (r0 + r < N && k < D) ? to_f32(h[(int64_t)(r0 + r) * D + k]) : 0.f;
    }
    __syncthreads();
    const int k = k0 + lane * 16;
    if (k >= D) continue;  // D % 16 == 0
    float f[kVocabPerWarp][16];
#pragma unroll
    for (int j = 0; j < kVocabPerWarp; ++j) {
      const uint4 wv = v0 + j < V
                           ? *reinterpret_cast<const uint4*>(q + (int64_t)(v0 + j) * D + k)
                           : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c) f[j][4 * t + c] = i8(words[t], c);
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {  // each h row is read once and used for every vocab row
      const float4* hr = reinterpret_cast<const float4*>(&hs[r][lane * kHSeg]);
      float hv[16];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 h4 = hr[e];
        hv[4 * e] = h4.x;
        hv[4 * e + 1] = h4.y;
        hv[4 * e + 2] = h4.z;
        hv[4 * e + 3] = h4.w;
      }
#pragma unroll
      for (int j = 0; j < kVocabPerWarp; ++j) {
        float t = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) t = fmaf(hv[e], f[j][e], t);
        acc[j][r] += t;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kVocabPerWarp; ++j)
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float v = warp_sum(acc[j][r]);  // every lane holds the row's sum
      if (lane == (j * RT + r) % 32 && v0 + j < V && r0 + r < N)
        out[(int64_t)(r0 + r) * V + v0 + j] = v * s[v0 + j];
    }
}

template <typename XT, int RT, int FORM>
int launch_qmm(const void* x, const void* w, const void* s, const void* z, void* out, int N,
               int IN, int OUT, cudaStream_t stream) {
  const dim3 grid((OUT + kBlockCols - 1) / kBlockCols, (N + RT - 1) / RT);
  qmm_kernel<XT, RT, FORM><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(w), static_cast<const float*>(s),
      static_cast<const float*>(z), static_cast<XT*>(out), N, IN, OUT);
  return (int)cudaGetLastError();
}

template <typename XT, int RT>
int qmm_form(const void* x, const void* w, const void* s, const void* z, void* out, int N,
             int IN, int OUT, int form, cudaStream_t st) {
  if (form == kFlat) return launch_qmm<XT, RT, kFlat>(x, w, s, z, out, N, IN, OUT, st);
  if (form == kGrouped) return launch_qmm<XT, RT, kGrouped>(x, w, s, z, out, N, IN, OUT, st);
  if (form == kInt4) return launch_qmm<XT, RT, kInt4>(x, w, s, z, out, N, IN, OUT, st);
  return (int)cudaErrorInvalidValue;
}

template <typename XT>
int qmm_rows(const void* x, const void* w, const void* s, const void* z, void* out, int N,
             int IN, int OUT, int form, cudaStream_t st) {
  if (N == 1) return qmm_form<XT, 1>(x, w, s, z, out, N, IN, OUT, form, st);
  return qmm_form<XT, 8>(x, w, s, z, out, N, IN, OUT, form, st);
}

template <typename XT, int RT>
int launch_unembed(const void* h, const void* q, const void* s, void* out, int N, int D, int V,
                   cudaStream_t stream) {
  const int per_block = kWarps * kVocabPerWarp;
  const dim3 grid((V + per_block - 1) / per_block, (N + RT - 1) / RT);
  unembed_kernel<XT, RT><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(h), static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), N, D, V);
  return (int)cudaGetLastError();
}

template <typename XT>
int unembed_rows(const void* h, const void* q, const void* s, void* out, int N, int D, int V,
                 cudaStream_t st) {
  if (N == 1) return launch_unembed<XT, 1>(h, q, s, out, N, D, V, st);
  return launch_unembed<XT, 8>(h, q, s, out, N, D, V, st);
}

}  // namespace

// Plain C entry points, loaded with ctypes. x_dtype: 0 = float32,
// 1 = bfloat16 (x and out share it). form: 0 flat int8 (s [OUT]), 1 grouped
// int8, 2 packed int4 (s, z [G, OUT]); gs: the group size of forms 1 and 2,
// which must be 32. The caller guarantees OUT % 4 == 0, 4-byte aligned
// weights and 16-byte aligned scales. Returns 0 or the cudaError_t of the
// failed launch.
extern "C" int quant_matmul(const void* x, const void* w, const void* s, const void* z,
                            void* out, int N, int IN, int OUT, int form, int gs, int x_dtype,
                            void* stream) {
  if (N <= 0 || OUT <= 0) return 0;
  if (IN <= 0 || OUT % kCols) return (int)cudaErrorInvalidValue;
  if (form != kFlat && (gs != kGroup || IN % kGroup)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return qmm_rows<float>(x, w, s, z, out, N, IN, OUT, form, st);
  if (x_dtype == 1) return qmm_rows<__nv_bfloat16>(x, w, s, z, out, N, IN, OUT, form, st);
  return (int)cudaErrorInvalidValue;
}

// h [N, D] (h_dtype 0 = float32, 1 = bfloat16), q [V, D] int8 with D % 16
// == 0 and 16-byte aligned rows, s [V] f32, out [N, V] f32.
extern "C" int quant_unembed(const void* h, const void* q, const void* s, void* out, int N,
                             int D, int V, int h_dtype, void* stream) {
  if (N <= 0 || V <= 0) return 0;
  if (D <= 0 || D % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h_dtype == 0) return unembed_rows<float>(h, q, s, out, N, D, V, st);
  if (h_dtype == 1) return unembed_rows<__nv_bfloat16>(h, q, s, out, N, D, V, st);
  return (int)cudaErrorInvalidValue;
}
