// The ragged per-row LoRA delta for multi-tenant decode on Hopper (sm_90a),
// kernel B5.
//
// It replaces the TPU kernel localai_tpu/ops/lora_matmul.py::_lora_kernel
// (launched by _lora_call, lora_matmul.py:137). Same function, with
// id = ids[n]: t[n, r] = sum_i x[n, i] * A[id, i, r] and
// out[n, o] = sum_r t[n, r] * B[id, r, o], for x [N, IN] (f32 or bf16,
// N <= 256 on the serving path), the stacked factors A [NA, IN, R] and
// B [NA, R, OUT] (f32 or bf16, the model dtype) and int32 ids [N]. The rank-r intermediate t stays in f32
// between the two products; the output is written once, in x's dtype. Id 0
// is the all-zero null adapter: its rows are written as exact zeros and
// read no factors. An id outside [0, NA) reads no factors either: its row
// is written as NaN, so a bad id is loud instead of reading past the stack.
//
// What bounds it. Per row the delta reads R * (IN + OUT) factor values and
// does 2 * R * (IN + OUT) FLOPs: about one FLOP per factor byte in bf16,
// far below the card's ridge, and the factor blocks are small (64 KB for A
// at IN = 2048, R = 16, bf16). So the byte bound is microseconds and what
// sets the time is launch latency and how many SMs have work.
//
// Design: shrink, then expand (BGMV-style), two launches per call. The TPU
// kernel ran one program per (row, out tile), each recomputing x . A; here
// t is computed once per row.
// - Shrink: one block of 128 threads per (row, slice of 64 rows of A). A
//   thread owns one rank column r of the slice and one of L = 128 / Rp
//   lanes over the slice's rows (Rp: R rounded up to a power of two), so
//   for each step the block reads L consecutive rows of A[id], contiguous
//   in memory. x's slice is staged in shared memory as f32. The lanes'
//   partial sums are added in shared memory in a fixed order and each
//   slice writes its partial t to an f32 scratch [N, S, R]: no atomics, so
//   greedy output does not depend on scheduling. Short slices keep each
//   thread's chain of loads short: the first version's 256-row slices made
//   the kernel wait on 32 to 128 loads in a row per thread.
// - Expand: one block of 128 threads per (row, tile of OUT columns). Its
//   threads first add the S slice partials of its row into t in shared
//   memory (the same lanes-per-rank split, then a fixed-order add), then
//   each thread owns 16 bytes of columns (8 bf16 or 4 f32) and walks the R
//   rows of B[id] with one 16-byte load per row.
// Later work, recorded rather than done here: tensor cores, fusing the two
// launches, fusing the add into the base product's epilogue, and one
// launch for all targets of a layer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int SLICE = 64;  // rows of A per shrink block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, typename W>
__global__ void __launch_bounds__(THREADS)
lora_shrink(const T* __restrict__ x, const W* __restrict__ a, const int* __restrict__ ids,
            float* __restrict__ part, int IN, int R, int NA, int S, int Rp) {
  const int n = blockIdx.x, s = blockIdx.y;
  const int id = ids[n];
  if (id <= 0 || id >= NA) return;  // null or bad id: the expand writes the row
  __shared__ float xs[SLICE];
  __shared__ float red[THREADS];
  const int i0 = s * SLICE;
  const int rows = min(SLICE, IN - i0);
  for (int i = threadIdx.x; i < rows; i += THREADS) {
    xs[i] = to_f32(x[(size_t)n * IN + i0 + i]);
  }
  __syncthreads();
  const int r = threadIdx.x % Rp, lane = threadIdx.x / Rp, L = THREADS / Rp;
  float acc = 0.f;
  if (r < R) {
    const W* ap = a + ((size_t)id * IN + i0) * R + r;
#pragma unroll 8
    for (int i = lane; i < rows; i += L) acc = fmaf(xs[i], to_f32(ap[(size_t)i * R]), acc);
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < R) {  // rank column r's lanes sit at r, r + Rp, r + 2Rp, ...
    float t = 0.f;
    for (int l = 0; l < L; ++l) t += red[l * Rp + threadIdx.x];
    part[((size_t)n * S + s) * R + threadIdx.x] = t;
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(THREADS)
lora_expand(const W* __restrict__ b, const int* __restrict__ ids, const float* __restrict__ part,
            T* __restrict__ out, int R, int OUT, int NA, int S, int Rp) {
  constexpr int V = 16 / sizeof(W);  // columns per 16-byte load
  __shared__ float ts[128];
  __shared__ float red[THREADS];
  const int n = blockIdx.x;
  const int c0 = (blockIdx.y * THREADS + threadIdx.x) * V;
  const int id = ids[n];
  T* orow = out + (size_t)n * OUT;
  if (id <= 0 || id >= NA) {
    const float fill = id == 0 ? 0.f : __int_as_float(0x7fc00000);
    if (c0 < OUT) {
#pragma unroll
      for (int v = 0; v < V; ++v) orow[c0 + v] = from_f32<T>(fill);
    }
    return;
  }
  {  // t[r] = sum over the slices, lanes over s, then lanes in a fixed order
    const int r = threadIdx.x % Rp, lane = threadIdx.x / Rp, L = THREADS / Rp;
    float acc = 0.f;
    if (r < R) {
#pragma unroll 4
      for (int s = lane; s < S; s += L) acc += part[((size_t)n * S + s) * R + r];
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.x < R) {
      float t = 0.f;
      for (int l = 0; l < L; ++l) t += red[l * Rp + threadIdx.x];
      ts[threadIdx.x] = t;
    }
    __syncthreads();
  }
  if (c0 >= OUT) return;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  const W* bp = b + (size_t)id * R * OUT + c0;
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    const float t = ts[r];
    const uint4 raw = *reinterpret_cast<const uint4*>(bp + (size_t)r * OUT);
    const W* w = reinterpret_cast<const W*>(&raw);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = fmaf(t, to_f32(w[v]), acc[v]);
  }
#pragma unroll
  for (int v = 0; v < V; ++v) orow[c0 + v] = from_f32<T>(acc[v]);
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* a, const void* b, const void* ids, void* part,
                   void* out, int N, int IN, int R, int OUT, int NA, cudaStream_t stream) {
  const int S = (IN + SLICE - 1) / SLICE;
  int Rp = 1;
  while (Rp < R) Rp *= 2;
  lora_shrink<T, W><<<dim3(N, S), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(a), static_cast<const int*>(ids),
      static_cast<float*>(part), IN, R, NA, S, Rp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int V = 16 / sizeof(W);
  const int tiles = (OUT + THREADS * V - 1) / (THREADS * V);
  lora_expand<T, W><<<dim3(N, tiles), THREADS, 0, stream>>>(
      static_cast<const W*>(b), static_cast<const int*>(ids), static_cast<const float*>(part),
      static_cast<T*>(out), R, OUT, NA, S, Rp);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. part: f32 scratch [N, ceil(IN /
// 64), R]. The caller checks shapes, alignment (B rows 16-byte aligned:
// OUT % 8 == 0 and an aligned base) and 1 <= R <= 128. Returns the CUDA
// error of the launches (0 on success).
extern "C" int lora_bgmv(const void* x, const void* a, const void* b, const void* ids,
                         void* part, void* out, int N, int IN, int R, int OUT, int NA,
                         int x_dtype, int w_dtype, void* stream) {
  if (N <= 0) return 0;
  if (R < 1 || R > 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 1 && w_dtype == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, a, b, ids, part, out, N, IN, R, OUT, NA, st);
  } else if (x_dtype == 1 && w_dtype == 0) {
    err = launch<__nv_bfloat16, float>(x, a, b, ids, part, out, N, IN, R, OUT, NA, st);
  } else if (x_dtype == 0 && w_dtype == 1) {
    err = launch<float, __nv_bfloat16>(x, a, b, ids, part, out, N, IN, R, OUT, NA, st);
  } else if (x_dtype == 0 && w_dtype == 0) {
    err = launch<float, float>(x, a, b, ids, part, out, N, IN, R, OUT, NA, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
