// Causal GQA flash attention for prefill, for Hopper (sm_90a).
//
// Replaces the TPU kernel localai_tpu/ops/flash.py::_flash_kernel (launched
// by flash_prefill_attention, flash.py:144). Same contract: q [B,S,H,D],
// k/v [B,S,K,D] (bf16 or f32), lengths [B] int32 -> out [B,S,H,D] in q's
// type. Query head h reads kv head h / (H/K); key j is visible to query row
// i iff j <= i and j < lengths[b]; query rows at or past lengths[b] are
// written as exact zeros. Softmax runs online in f32.
//
// What bounds it. Prefill attention at long S is bound by operations: at
// S=2048, D=64, 4 query heads per kv head it does ~800 FLOPs per byte it
// must move, well past the card's bf16 ridge of ~295, and the work grows
// as S^2 while the bytes grow as S. So the products run on the tensor
// cores, and the exponentials (one per score) on the special-function unit.
//
// bf16: flash_prefill_mma_kernel. One block of 4 warps owns one (batch,
// head, query tile) and walks the kv tiles of 64 keys in a loop (the TPU
// kernel walked them as a sequential grid axis with its softmax state in
// VMEM scratch, which Hopper's unordered blocks cannot carry).
// - Rows. Each warp owns 16 * MT query rows: MT = 2 at D=64 (128-row
//   tiles, half the K/V tiles read per query row), MT = 1 at D=128, where
//   the O accumulator alone takes 64 f32 registers a thread for 16 rows.
// - Products. S = Q.K^T and O += P.V are mma.sync m16n8k16 bf16 with f32
//   accumulators. Q is copied to shared memory once and held in registers
//   as A fragments (ldmatrix). The S accumulator of two 8-key n-tiles is,
//   element for element, the A fragment of a 16-key k-step, so P is
//   rounded to bf16 in registers and never touches shared memory.
// - Loads. K and V tiles stay bf16 and arrive by 16-byte cp.async.cg in a
//   two-stage ring: tile j+1 is in flight while tile j is computed, with
//   one barrier a tile. Each row's 16-byte chunks are XOR-swizzled by the
//   row's low 3 bits, so ldmatrix (K) and ldmatrix.trans (V) read 8 rows
//   from 8 different bank groups.
// - Softmax. Online, in f32: the max is taken on the raw scores and
//   p = 2^(s c - m c), c = scale * log2(e), is one FFMA and one ex2.approx
//   (cheaper than a pass that scales every score first). A row lives in
//   the 4 lanes of a quad: its max is reduced with two shuffles a tile, its
//   sum once at the end. The running max starts at -1e30; a row masked so
//   far gives p = 0 (m c taken as 0), so it stays finite, and the sum is
//   divided as max(l, 1e-30).
// - Masks. Tiles above the diagonal and past lengths[b] are never loaded;
//   the element mask runs only where a tile crosses a warp's diagonal or
//   holds lengths[b], and a warp skips a tile wholly above its rows. Query
//   tiles wholly past lengths[b] write zeros, as do rows past it in a live
//   tile; rows past S are never read (cp.async zero-fills them) nor
//   written.
// - Order. Grid (H, query tiles, B) with the tile order reversed: the
//   heaviest query tiles run first, and the G heads of a kv head sit side
//   by side, sharing its K/V tiles in L2.
//
// f32: flash_prefill_kernel keeps the first version's scalar f32 FMAs. On
// the tensor cores f32 would run as TF32, and the f32 model checks hold
// the card to the CPU at 1e-3 on the logits.
//
// Left for later. wgmma with Q in registers and K/V read from shared
// memory, TMA loads on an mbarrier ring filled by a producer warp, and a
// persistent grid: mma.sync with 8 warps an SM stays far below the card's
// bf16 rate. GQA packing is not done: stacking the G query heads of a kv
// head into one block's rows only saves K/V loads if the block grows to
// G x 64 rows, which the register file does not hold next to these
// accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block (f32 kernel)
constexpr int kBK = 64;        // keys per kv tile (both kernels)
constexpr int kThreads = 256;  // f32 kernel: 16 row groups x 16 column lanes
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "load_tile serves both the query and the kv tiles");

// ------------------------------------------------------------------------ //
// f32: scalar FMAs on f32 tiles in shared memory
// ------------------------------------------------------------------------ //

// Copy `valid` rows of D elements (row stride `stride` elements) into a
// 64-row f32 tile of pitch P, multiplied by `mul`; rows >= valid are zero.
template <typename T, int D, int P>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t stride, int valid, float mul) {
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * P + c] = r < valid ? src[r * stride + c] * mul : 0.f;
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
      if (q0 + r < S) o[r * q_stride + c] = 0.f;
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
      o[r * q_stride + tx + 16 * c] = valid ? acc[i][c] * inv : 0.f;
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

// ------------------------------------------------------------------------ //
// bf16: mma.sync tensor-core tiles fed by cp.async
// ------------------------------------------------------------------------ //

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kMmaThreads = kWarps * 32;
constexpr int kStages = 2;  // K/V ring depth (>= 2)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; nothing is read and zeros are
// written when `pred` is false.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (flushes subnormals; 2^-1e30 = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of 16-byte chunk c of row r in a [rows][D] bf16 tile: the
// chunk index is XORed with the row's low 3 bits, so the same logical
// chunk of 8 consecutive rows lands in 8 different groups of 4 banks.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((r * (D / 8) + (c ^ (r & 7))) * 16);
}

// cp.async ROWS rows of D bf16 (row stride `stride` elements) into a
// swizzled tile; rows at or past `valid` (>= 1) are zero-filled, not read.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* __restrict__ src,
                                                int64_t stride, int valid) {
  constexpr int C = D / 8;
  static_assert(ROWS * C % kMmaThreads == 0, "every thread copies the same number of chunks");
#pragma unroll
  for (int j = 0; j < ROWS * C / kMmaThreads; ++j) {
    const int i = threadIdx.x + j * kMmaThreads;
    const int r = i / C, c = i % C;
    const bool ok = r < valid;
    cp_async16(dst + swz<D>(r, c), src + (ok ? r * stride : 0) + c * 8, ok);
  }
}

template <int D, int MT>
__global__ void __launch_bounds__(kMmaThreads)
flash_prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const int* __restrict__ lengths,
                         bf16* __restrict__ out, int S, int H, int KH, float scale_log2) {
  constexpr int BQ = kWarps * 16 * MT;  // query rows per block
  constexpr int WQ = 16 * MT;           // query rows per warp
  constexpr int KD = D / 16;            // k-steps of Q.K^T; d-tile pairs of P.V
  constexpr int NT = kBK / 8;           // 8-key n-tiles of S
  constexpr int DT = D / 8;             // 8-column d-tiles of O
  constexpr uint32_t kTile = kBK * D * 2;  // bytes of one K or V tile
  extern __shared__ __align__(128) unsigned char smem_mma[];
  const uint32_t qs = smem_u32(smem_mma);  // [BQ][D] swizzled
  const uint32_t ring = qs + BQ * D * 2;   // stage s: K at ring + 2 s kTile, V after it

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kvh = h / (H / KH);
  const int len = min(lengths[b], S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group, lane in quad
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)KH * D;
  bf16* o = out + ((int64_t)b * S + q0) * q_stride + (int64_t)h * D;

  if (q0 >= len) {  // the whole tile is padding
    constexpr int C = D / 8;
    for (int i = threadIdx.x; i < BQ * C; i += kMmaThreads) {
      const int r = i / C, c = i % C;
      if (q0 + r < S) *reinterpret_cast<uint4*>(o + r * q_stride + c * 8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const bf16* kb = k + (int64_t)b * S * kv_stride + (int64_t)kvh * D;
  const bf16* vb = v + (int64_t)b * S * kv_stride + (int64_t)kvh * D;
  const int n_tiles = (min(q0 + BQ, len) + kBK - 1) / kBK;  // no valid row sees past it

  // Tile j's K and V go to stage j % kStages. Group j of cp.async holds
  // tile j (group 0 also Q); a group is committed every step, empty or not,
  // so that wait_group counts alike on every step.
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      const uint32_t st = ring + (j % kStages) * 2 * kTile;
      const int64_t off = (int64_t)j * kBK * kv_stride;
      load_tile_async<D, kBK>(st, kb + off, kv_stride, S - j * kBK);
      load_tile_async<D, kBK>(st + kTile, vb + off, kv_stride, S - j * kBK);
    }
    cp_async_commit();
  };
  load_tile_async<D, BQ>(qs, q + ((int64_t)b * S + q0) * q_stride + (int64_t)h * D,
                         q_stride, S - q0);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_kv(j);

  const int row0 = q0 + warp * WQ;  // this warp's first query row
  uint32_t qf[MT][KD][4];
  float acc[MT][DT][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[mt][hh] = kNegInf;
      l[mt][hh] = 0.f;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dt][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();               // for every thread, and tile t-1's reads are done
    load_kv(t + kStages - 1);      // into the stage tile t-1 used

    if (t == 0) {  // Q into registers as A fragments, once
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
          ldsm_x4(qs + swz<D>(warp * WQ + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                              kd * 2 + (lane >> 4)),
                  qf[mt][kd]);
    }

    if (k0 <= row0 + WQ - 1) {  // else every key of the tile is above this warp's rows
      const uint32_t ks = ring + (t % kStages) * 2 * kTile, vs = ks + kTile;
      float s[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;

      // S = Q.K^T: one ldmatrix.x4 gives the B fragments of two n-tiles.
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bk[4];
          ldsm_x4(ks + swz<D>(np * 16 + (lane & 7) + (lane >> 4) * 8,
                              kd * 2 + ((lane >> 3) & 1)),
                  bk);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * np], qf[mt][kd], bk[0], bk[1]);
            mma_bf16(s[mt][2 * np + 1], qf[mt][kd], bk[2], bk[3]);
          }
        }
      }

      // Raw scores, masked where the tile crosses this warp's diagonal or
      // holds lengths[b]; scale * log2(e) is applied inside the exponent.
      const bool edge = k0 + kBK - 1 > row0 || k0 + kBK > len;
      if (edge) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = row0 + mt * 16 + g + (e >> 1) * 8;
              const int col = k0 + nt * 8 + 2 * tig + (e & 1);
              if (col > row || col >= len) s[mt][nt][e] = kNegInf;
            }
      }

      // Online softmax: rows g and g+8 of each m-tile, over the quad.
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = kNegInf;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mx = fmaxf(mx, fmaxf(s[mt][nt][2 * hh], s[mt][nt][2 * hh + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[mt][hh], mx);
          const float alpha = fast_exp2((m[mt][hh] - m_new) * scale_log2);
          m[mt][hh] = m_new;
          // A row masked so far keeps m = -1e30: then p = 2^(-1e30 c) = 0.
          const float ms = m_new == kNegInf ? 0.f : m_new * scale_log2;
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
              const float p = fast_exp2(fmaf(s[mt][nt][e], scale_log2, -ms));
              s[mt][nt][e] = p;
              sum += p;
            }
          l[mt][hh] = l[mt][hh] * alpha + sum;
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            acc[mt][dt][2 * hh] *= alpha;
            acc[mt][dt][2 * hh + 1] *= alpha;
          }
        }

      // P as bf16 A fragments: n-tiles 2kk and 2kk+1 form k-step kk.
      uint32_t pa[MT][NT / 2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          pa[mt][kk][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][kk][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][kk][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pa[mt][kk][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }

      // O += P.V: one ldmatrix.x4.trans gives the B fragments of two d-tiles.
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
        for (int dp = 0; dp < KD; ++dp) {
          uint32_t bv[4];
          ldsm_x4_trans(vs + swz<D>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                    dp * 2 + (lane >> 4)),
                        bv);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * dp], pa[mt][kk], bv[0], bv[1]);
            mma_bf16(acc[mt][2 * dp + 1], pa[mt][kk], bv[2], bv[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lt = l[mt][hh];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int r = warp * WQ + mt * 16 + g + hh * 8;  // row within the tile
      if (q0 + r >= S) continue;
      const bool valid = q0 + r < len;
      const float inv = 1.f / fmaxf(lt, 1e-30f);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const uint32_t w =
            valid ? pack_bf16(acc[mt][dt][2 * hh] * inv, acc[mt][dt][2 * hh + 1] * inv) : 0u;
        *reinterpret_cast<uint32_t*>(o + r * q_stride + dt * 8 + 2 * tig) = w;
      }
    }
}

template <int D, int MT>
int launch_mma(const void* q, const void* k, const void* v, const int* lengths, void* out,
               int B, int S, int H, int KH, float scale, cudaStream_t stream) {
  constexpr int BQ = kWarps * 16 * MT;
  const int smem = 2 * D * (BQ + kStages * 2 * kBK);  // Q tile + K/V ring, bf16
  auto kern = flash_prefill_mma_kernel<D, MT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, (S + BQ - 1) / BQ, B);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      lengths, static_cast<bf16*>(out), S, H, KH, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q, k, v and out must be 16-byte aligned (cp.async). Returns 0 or the
// cudaError_t of the failed launch.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const int* lengths, void* out, int B, int S, int H,
                             int KH, int D, int dtype, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (H <= 0 || KH <= 0 || H % KH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return launch_mma<64, 2>(q, k, v, lengths, out, B, S, H, KH, scale, st);
  if (dtype == 1 && D == 128)
    return launch_mma<128, 1>(q, k, v, lengths, out, B, S, H, KH, scale, st);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, lengths, out, B, S, H, KH, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, lengths, out, B, S, H, KH, scale, st);
  return (int)cudaErrorInvalidValue;
}
