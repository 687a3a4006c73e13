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
// What bounds them. At decode (N = 1..16 rows) a weight byte feeds at most
// 2*16 FLOPs (int8) or 4*16 (int4: two weights a byte), far below the
// card's bf16 ridge of ~295 FLOPs a byte: both kernels are bound by the
// weight bytes they read (B3 at llama-3-8b's w_gate: 58.7 MB int8; 29.4 MB
// int4 payload plus 14.7 MB of its f32 scales and zero points; B4: 525 MB
// of int8 head). At 3.35 TB/s the card feeds an SM ~13 bytes a cycle,
// ~26 int4 weights, against 128 thread-instructions a cycle: all the work
// on one weight has to fit in ~5 instructions (~10 for int8).
//
// B3, bf16 x: qmm_mma_kernel<FORM, MT, NT>. The first, scalar kernel was
// issue-bound (a shift and mask, a convert and one FMA per row for each
// weight, ~11 instructions at 8 rows), waited for every load, and ran
// grids of 8 (wk, wv) to 112 blocks. This one:
// - Operands. out^T = W^T x^T: the weight's output columns are the M side
//   of mma.sync m16n8k16 (bf16 in, f32 accumulate) and x's rows the n = 8
//   side, so decode's 1-8 rows pad no 16-row half tile (NT = 1; NT = 2
//   serves 9-16 rows; above 16 rows NT = 8, row tiles of 64, so 256 rows
//   read the weights 4 times). A block is 4 warps; a warp owns 16*MT output
//   columns (MT = 2: 128 columns a block, one full 128-byte line of a
//   weight row; MT = 1 above 16 rows, where the NT = 8 accumulators need
//   the registers).
// - Integers exact, scales outside the product. Every int8 value and int4
//   nibble is exact in bf16, so the raw integers are multiplied by x; flat
//   int8 scales the finished f32 sum, the grouped forms scale each group's
//   32-row partial (two k16 steps into a fresh fragment): acc = part * s_g
//   + acc, and int4 subtracts xsum_g * z_g, xsum_g coming from one more
//   mma of x against an all-ones A fragment. Folding the scale into a bf16
//   weight would round every weight to bf16.
// - Unpack in registers, ~1.5 (int4) / ~2.8 (int8) instructions a weight.
//   The output column that an A-fragment row stands for is chosen so that
//   lane group g reads 2*MT adjacent columns of 4 weight rows (k = 2t,
//   2t+1, 2t+8, 2t+9) with one 32-bit (MT = 2) or 16-bit load each. One
//   prmt interleaves two rows' bytes so that each half-word holds one
//   weight of a column; int4: one lop3 puts a nibble into the mantissa of
//   bf16 128.0 (0x4300 | n = 128 + n) and one bf16x2 subtraction gives two
//   exact values (a byte holds in-rows i and i + 16 of its group, so its
//   high nibble feeds the group's second k16 step, after a shift); int8:
//   the biased byte (q ^ 0x80) goes into the mantissa of f32 2^23 by prmt,
//   one FADD removes 2^23 + 128, and a prmt packs the upper halves of two
//   such f32 (exact: |q| <= 128 has 8 significant bits) into bf16x2.
// - Loads. Weight tiles of 64 byte-rows (64 in-rows int8, 128 int4) with
//   their scale / zero-point rows and x's k-slice in bf16 arrive by 16-byte
//   cp.async.cg in a ring of 3 stages, one barrier a stage, so two stages
//   are in flight while one is converted and multiplied (a stage is 10-25
//   KB; 3-7 blocks fit an SM; a 4-stage ring measured no faster at decode
//   and slower above 16 rows, where it fits fewer blocks). Weight and x rows
//   are padded by 16 bytes: a warp's 4 weight rows and ldmatrix's 8 x rows
//   hit distinct banks. A stage's groups are unrolled into one stretch of
//   code, so the loads and conversions of one group overlap another's mma.
// - Split-K, one launch. The grid is (column tiles, k-splits, row tiles);
//   the wrapper's plan (ops/quant_matmul.qmm_plan) picks the split count
//   so that the grid fills the SMs twice over, in k-slices of whole stages.
//   With one split a block writes bf16 out directly. With more, each writes
//   its f32 partial tile to a workspace, fences, and bumps a per-tile
//   counter; the last block to arrive sums the splits in order 0..S-1
//   (8 loads in flight a thread), applies the flat scale, writes bf16, and
//   resets the counter to 0. The workspace and counters are the wrapper's,
//   one per device: the port issues every product in order on one stream,
//   so one product's partials are never live beside another's.
// - Determinism. Launches repeat bit for bit. For N <= 16 the plan and the
//   order of every sum depend only on (IN, OUT, form), not on N (NT = 1
//   and NT = 2 do the same arithmetic for a row), so a row's bits do not
//   depend on how many rows decode beside it.
//
// B3, f32 x: qmm_kernel<float, RT, FORM>, the first kernel unchanged: a bf16
// tensor-core operand would round x, and the f32 checks need exact f32
// products. A block of 8 warps owns 128 output columns (lane l: columns
// 4l..4l+3, one 32-bit weight load) and RT rows (1, else 8); the warps
// split each 256-row stage into 32-row chunks, FMA in f32 and add their
// sums in warp order at the end.
//
// Left for later: an offline weight repack so that each lane's fragment is
// one 16-byte load with no prmt (Marlin's layout, Frantar et al. 2024), a
// TMA ring fed by a producer warp, and bf16 scales (the f32 scale and zero
// rows are a third of an int4 product's bytes). wgmma does little here:
// its M is 64 and decode has 1-16 rows.
//
// B4, bf16 h: unembed_mma_kernel<NT>. B4 moves the whole head once per
// call (llama-3-8b: 525 MB of int8 at V = 128256, D = 4096), so at 3.35
// TB/s it cannot take less than ~0.158 ms; with 1-16 rows a byte feeds at
// most 32 FLOPs. The first, scalar kernel converted each byte to f32 and
// FMA'd it once per row (~10 instructions a weight at 8 rows, over the ~9
// an SM can spend on each byte it is fed) and read the head again for
// every 8 rows. This one:
// - Operands. Vocab rows are the M side of mma.sync m16n8k16 (bf16 in, f32
//   accumulate), h's rows the n = 8 side: NT = 1 n-tile for 1-8 rows,
//   NT = 2 for 9-16 (no padded 16-row half tile at decode), NT = 8 (row
//   tiles of 64) above 16 rows, so 256 rows read the head 4 times. A warp
//   sums one 16-row vocab tile at a time and converts each A fragment once
//   for all its n-tiles.
// - Weights straight to registers. Each head byte is used by one warp only,
//   so it never passes through shared memory: in a 64-column chunk lane
//   (g, t) loads bytes 16t..16t+15 of vocab rows g and g + 8, one 16-byte
//   streaming load each (ld.global.nc, no L1 line: the head is 10x the L2).
//   Word s of a load feeds k16 step s: its bytes 0-1 are A's k slots
//   (2t, 2t + 1), bytes 2-3 slots (2t + 8, 2t + 9). The sum over k does not
//   care which slot holds which column as long as B uses the same map, so
//   B's fragment for step s is the 8 contiguous bytes h[n][16t + 4s .. +3]
//   of a staged h row.
// - Loads in flight, whole lines. A warp keeps a register ring of S chunks
//   (UnembedRing: 8, or 4 beside NT = 8's accumulators) and asks for L of a
//   row's consecutive chunks back to back (4: 256 bytes of each row; 2 with
//   NT = 8), S - L chunks ahead of the one it multiplies: 64 KB an SM in
//   flight at 16 warps. Measured against each other on the card, one chunk
//   a row at a time was the slowest, four the fastest; a 256-byte L2
//   prefetch hint lost to the 128-byte one, and 8 warps a block to 16.
// - Integers exact, scale outside. Every int8 value is exact in bf16: the
//   biased byte (q ^ 0x80) goes into the mantissa of f32 2^23, one FADD
//   removes 2^23 + 128, and a prmt packs two such f32 (two bytes of one
//   word: one vocab row) into bf16x2. The raw integers multiply h; s[v]
//   scales the finished f32 sum on the store, as the TPU kernel's _emit.
// - h in shared memory. One persistent block of 16 warps an SM (the plan's
//   `blocks`, ops/quant_matmul.qunembed_plan) stages its h rows as bf16
//   once, rows padded by 4 bf16 so that a warp's 8-byte reads hit distinct
//   banks, and walks a contiguous range of vocab tiles. Where h does not
//   fit (more than 16 rows, or a very wide D) it is staged in k-slices, the
//   block's warps meeting at each slice while the weight loads of their
//   next chunks are already in flight.
// - Shapes. Any V (the ragged vocab tile is masked), D % 16 == 0 (a last
//   chunk of 16, 32 or 48 columns: masked lanes load zeros and the staged h
//   is zero past D), any h alignment (16-byte staging loads when aligned).
// - Determinism. No split-K, no atomics: one warp sums a vocab tile over
//   the chunks in order. For N <= 16 that order depends on D only, and NT
//   = 1 and 2 do the same arithmetic for a row, so a row's logits have the
//   same bits whether it decodes alone or beside 15 others.
// Left for later: a Marlin-style offline repack of the head (longer runs
// of a row a load, fewer prmt), bf16 scales, a TMA ring fed by a producer
// warp.
//
// B4, f32 h: unembed_kernel<RT>, the first kernel unchanged (a bf16
// operand would round h, and the f32 checks need exact f32 products): a
// block of 8 warps owns 32 vocab rows and RT h rows, walks D in 512-column
// stages with h staged in shared memory, lane l dots 16 contiguous bytes of
// each of its warp's 4 vocab rows with every staged h row in f32, and a
// warp shuffle reduces the sums; the scale is applied on the write.

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

template <int RT>
__global__ void __launch_bounds__(kThreads)
unembed_kernel(const float* __restrict__ h, const int8_t* __restrict__ q,
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
          (r0 + r < N && k < D) ? h[(int64_t)(r0 + r) * D + k] : 0.f;
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

// ------------------------------------------------------------------------ //
// B3, bf16 x: mma.sync tensor-core tiles fed by a cp.async ring, split-K
// ------------------------------------------------------------------------ //

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kRing = 3;       // cp.async stages
constexpr int kTileRows = 64;  // weight byte-rows a stage: 64 in-rows int8, 128 int4

// The tile shapes and the shared memory of one instance.
template <int FORM, int MT, int NT>
struct QmmTile {
  static constexpr int kBO = kMmaWarps * 16 * MT;  // output columns a block
  static constexpr int kRT = 8 * NT;               // x rows a block
  static constexpr int kIn = FORM == kInt4 ? 2 * kTileRows : kTileRows;  // in-rows a stage
  static constexpr int kGroups = kIn / kGroup;
  static constexpr int kWPitch = kBO + 16;  // bytes: 4 rows 2 apart start 8 banks apart
  static constexpr int kXPitch = kIn + 8;   // bf16: ldmatrix's 8 rows hit 8 bank groups
  static constexpr int kWBytes = kTileRows * kWPitch;
  static constexpr int kSBytes = FORM == kFlat ? 0 : kGroups * kBO * 4;  // scale rows
  static constexpr int kZBytes = FORM == kInt4 ? kSBytes : 0;           // zero-point rows
  static constexpr int kXBytes = kRT * kXPitch * 2;
  static constexpr int kStageBytes = kWBytes + kSBytes + kZBytes + kXBytes;
  static constexpr int kSmem = kRing * kStageBytes;
  static_assert(kStageBytes % 16 == 0, "cp.async writes 16-byte chunks");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zeros, and nothing read, when
// `pred` is false.
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

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes of {b, a} picked by the selector's nibbles (a = bytes 0-3).
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// The nibbles at bits 0-3 and 16-19 of w as bf16x2 (bits 0-3 in the low
// half), exact: OR them into the mantissa of 128.0 (0x4300), subtract 128.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t w) {
  uint32_t h;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(h) : "r"(w), "n"(0x000F000F), "n"(0x43004300));
  const uint32_t k128 = 0x43004300u;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&h),
                                   *reinterpret_cast<const __nv_bfloat162*>(&k128));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte c of xa and byte c of xb, signed int8 already XORed with 0x80, as
// bf16x2 (xa's in the low half), exact: the biased byte goes into the
// mantissa of f32 2^23, one FADD removes 2^23 + 128, and the f32's upper
// half is the bf16 (|q| <= 128 has 8 significant bits).
__device__ __forceinline__ uint32_t bytes_bf16x2(uint32_t xa, uint32_t xb, int c) {
  const float fa = __uint_as_float(prmt(xa, 0x4B000000u, 0x7650u | c)) - 8388736.f;
  const float fb = __uint_as_float(prmt(xb, 0x4B000000u, 0x7650u | c)) - 8388736.f;
  return prmt(__float_as_uint(fa), __float_as_uint(fb), 0x7632u);
}

// The 2 * MT weight bytes (adjacent output columns) a lane takes from one
// weight row in shared memory.
template <int MT>
__device__ __forceinline__ uint32_t lds_w(const uint8_t* p) {
  if constexpr (MT == 2) return *reinterpret_cast<const uint32_t*>(p);
  else return *reinterpret_cast<const uint16_t*>(p);
}

// The lane's 2 * MT scales (or zero points) of one group row in shared
// memory, in one 16-byte (MT = 2) or 8-byte load.
template <int MT>
__device__ __forceinline__ void lds_f32(const float* p, float (&v)[2 * MT]) {
  if constexpr (MT == 2) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  }
}

// B fragments of NT n-tiles for the k16 step at column kk of the x tile.
template <int NT, int XP>
__device__ __forceinline__ void x_frags(uint32_t xs, int kk, int lane, uint32_t (&b)[NT][2]) {
  if constexpr (NT == 1) {
    const int l = lane & 15;  // x2: lanes 0-7 address k kk, lanes 8-15 k kk + 8
    ldsm_x2(xs + ((l & 7) * XP + kk + (l >> 3) * 8) * 2, b[0][0], b[0][1]);
  } else {
    const int mat = lane >> 3;  // x4: (n-tile 2p, kk), (2p, kk + 8), (2p + 1, kk), (2p + 1, kk + 8)
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      const int n = (2 * p + (mat >> 1)) * 8 + (lane & 7);
      ldsm_x4(xs + (n * XP + kk + (mat & 1) * 8) * 2, b[2 * p][0], b[2 * p][1],
              b[2 * p + 1][0], b[2 * p + 1][1]);
    }
  }
}

// 2 * MT bf16 of v to p.
template <int MT>
__device__ __forceinline__ void store_bf16(bf16* p, const float (&v)[2 * MT]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  if constexpr (MT == 2) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = a;
  }
}

// Group gi (32 in-rows) of a stage: the lane's A and B fragments, the
// mma products, and the group's scale and zero point for the grouped forms.
template <int FORM, int MT, int NT>
__device__ __forceinline__ void qmm_group(const unsigned char* stage, int gi, int wcol, int lane,
                                          float (&acc)[MT][NT][4]) {
  using T = QmmTile<FORM, MT, NT>;
  const int t = lane & 3;
  const uint8_t* wt = stage + wcol;
  const float* sc = reinterpret_cast<const float*>(stage + T::kWBytes) + wcol;
  const float* zp = reinterpret_cast<const float*>(stage + T::kWBytes + T::kSBytes) + wcol;
  const uint32_t xs = smem_u32(stage + T::kWBytes + T::kSBytes + T::kZBytes);
  const uint32_t kOnes[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};
  uint32_t b[2][NT][2];  // x of the group's two k16 steps
  x_frags<NT, T::kXPitch>(xs, gi * kGroup, lane, b[0]);
  x_frags<NT, T::kXPitch>(xs, gi * kGroup + 16, lane, b[1]);
  float part[MT][NT][4];  // the group's sum (grouped forms)
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][n][e] = 0.f;

  if constexpr (FORM == kInt4) {
    // Byte-rows 2t, 2t + 1, 2t + 8, 2t + 9 of the group: low nibbles are
    // k-step 0's A rows k = 2t.., high nibbles k-step 1's.
    const uint8_t* wr = wt + gi * 16 * T::kWPitch;
    const uint32_t w0 = lds_w<MT>(wr + (2 * t) * T::kWPitch);
    const uint32_t w1 = lds_w<MT>(wr + (2 * t + 1) * T::kWPitch);
    const uint32_t w8 = lds_w<MT>(wr + (2 * t + 8) * T::kWPitch);
    const uint32_t w9 = lds_w<MT>(wr + (2 * t + 9) * T::kWPitch);
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      // [row k col 2j, row k col 2j + 1, row k+1 col 2j, row k+1 col 2j + 1]
      const uint32_t sel = j ? 0x7632u : 0x5410u;
      const uint32_t lo = prmt(w0, w1, sel), hi = prmt(w8, w9, sel);
#pragma unroll
      for (int step = 0; step < 2; ++step) {
        const int sh = 4 * step;
        const uint32_t a[4] = {nibbles_bf16x2(lo >> sh), nibbles_bf16x2(lo >> (sh + 8)),
                               nibbles_bf16x2(hi >> sh), nibbles_bf16x2(hi >> (sh + 8))};
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_bf16(part[j][n], a, b[step][n][0], b[step][n][1]);
      }
    }
  } else {
#pragma unroll
    for (int step = 0; step < 2; ++step) {
      const uint8_t* wr = wt + (gi * kGroup + step * 16) * T::kWPitch;
      const uint32_t w0 = lds_w<MT>(wr + (2 * t) * T::kWPitch) ^ 0x80808080u;
      const uint32_t w1 = lds_w<MT>(wr + (2 * t + 1) * T::kWPitch) ^ 0x80808080u;
      const uint32_t w8 = lds_w<MT>(wr + (2 * t + 8) * T::kWPitch) ^ 0x80808080u;
      const uint32_t w9 = lds_w<MT>(wr + (2 * t + 9) * T::kWPitch) ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const uint32_t a[4] = {bytes_bf16x2(w0, w1, 2 * j), bytes_bf16x2(w0, w1, 2 * j + 1),
                               bytes_bf16x2(w8, w9, 2 * j), bytes_bf16x2(w8, w9, 2 * j + 1)};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if constexpr (FORM == kFlat) mma_bf16(acc[j][n], a, b[step][n][0], b[step][n][1]);
          else mma_bf16(part[j][n], a, b[step][n][0], b[step][n][1]);
        }
      }
    }
  }

  if constexpr (FORM != kFlat) {
    float sv[2 * MT], zv[2 * MT];
    lds_f32<MT>(sc + gi * T::kBO, sv);
    if constexpr (FORM == kInt4) lds_f32<MT>(zp + gi * T::kBO, zv);
    float xsum[NT][4];  // Σ x over the group: c0 row 2t, c1 row 2t + 1
    if constexpr (FORM == kInt4) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) xsum[n][e] = 0.f;
        mma_bf16(xsum[n], kOnes, b[0][n][0], b[0][n][1]);
        mma_bf16(xsum[n], kOnes, b[1][n][0], b[1][n][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 2 * j + (e >> 1);
          acc[j][n][e] = fmaf(part[j][n][e], sv[c], acc[j][n][e]);
          if constexpr (FORM == kInt4)
            acc[j][n][e] = fmaf(-xsum[n][e & 1], zv[c], acc[j][n][e]);
        }
  }
}

template <int FORM, int MT, int NT>
__global__ void __launch_bounds__(kMmaThreads)
qmm_mma_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ s, const float* __restrict__ z, bf16* __restrict__ out,
               float* __restrict__ ws, int* __restrict__ counters, int N, int IN, int OUT,
               int k_slice) {
  using T = QmmTile<FORM, MT, NT>;
  extern __shared__ __align__(128) unsigned char smem_mma[];
  __shared__ int is_last;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int S = gridDim.y;
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  const int c0 = blockIdx.x * T::kBO, r0 = blockIdx.z * T::kRT;
  const int kbeg = blockIdx.y * k_slice, kend = min(kbeg + k_slice, IN);
  const int n_stages = (kend - kbeg + T::kIn - 1) / T::kIn;
  // The lane's 2 * MT output columns start here in the block's tile; A-row g
  // of m-tile j is column 2j, A-row g + 8 column 2j + 1.
  const int wcol = warp * 16 * MT + g * 2 * MT;

  // Stage st of this split: weight rows, scale / zero-point rows and x's
  // k-slice, in 16-byte chunks; chunks past the slice, IN, OUT or N are
  // zero-filled and not read (OUT % 16 == 0, IN % 8 == 0, slices of 32).
  auto load_stage = [&](int st) {
    const uint32_t base = smem_u32(smem_mma) + (st % kRing) * T::kStageBytes;
    const int k0 = kbeg + st * T::kIn;
    constexpr int kWChunks = kTileRows * (T::kBO / 16);
    static_assert(kWChunks % kMmaThreads == 0, "every thread copies as many weight chunks");
#pragma unroll
    for (int it = 0; it < kWChunks / kMmaThreads; ++it) {
      const int i = threadIdx.x + it * kMmaThreads;
      const int r = i / (T::kBO / 16), col = c0 + (i % (T::kBO / 16)) * 16;
      int64_t row;  // byte-row of the payload
      bool ok;
      if constexpr (FORM == kInt4) {  // [G][16][OUT]: byte-row r of the stage is in group k0/32 + r/16
        row = k0 / 2 + r;
        ok = k0 + (r / 16) * kGroup < kend;
      } else {
        row = k0 + r;
        ok = row < kend;
      }
      ok = ok && col < OUT;
      cp_async16(base + r * T::kWPitch + (i % (T::kBO / 16)) * 16, w + (ok ? row * OUT + col : 0),
                 ok);
    }
    if constexpr (FORM != kFlat) {
      for (int i = threadIdx.x; i < T::kGroups * (T::kBO / 4); i += kMmaThreads) {
        const int gi = i / (T::kBO / 4), ch = i % (T::kBO / 4);
        const int grp = k0 / kGroup + gi, col = c0 + ch * 4;
        const bool ok = grp * kGroup < kend && col < OUT;
        const int64_t off = ok ? (int64_t)grp * OUT + col : 0;
        const uint32_t dst = base + T::kWBytes + (gi * T::kBO + ch * 4) * 4;
        cp_async16(dst, s + off, ok);
        if constexpr (FORM == kInt4) cp_async16(dst + T::kSBytes, z + off, ok);
      }
    }
    for (int i = threadIdx.x; i < T::kRT * (T::kIn / 8); i += kMmaThreads) {
      const int r = i / (T::kIn / 8), kc = (i % (T::kIn / 8)) * 8;
      const bool ok = r0 + r < N && k0 + kc < kend;
      cp_async16(base + T::kWBytes + T::kSBytes + T::kZBytes + (r * T::kXPitch + kc) * 2,
                 x + (ok ? (int64_t)(r0 + r) * IN + k0 + kc : 0), ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;
#pragma unroll
  for (int st = 0; st < kRing - 1; ++st) {
    if (st < n_stages) load_stage(st);
    cp_async_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // stage st has landed for every thread; stage st - 1 is consumed
    if (st + kRing - 1 < n_stages) load_stage(st + kRing - 1);
    cp_async_commit();

    const unsigned char* stage = smem_mma + (st % kRing) * T::kStageBytes;
    const int ng = min(T::kGroups, (kend - kbeg - st * T::kIn + kGroup - 1) / kGroup);
    if (ng == T::kGroups) {  // a whole stage: every group unrolled, for ILP
#pragma unroll
      for (int gi = 0; gi < T::kGroups; ++gi) qmm_group<FORM, MT, NT>(stage, gi, wcol, lane, acc);
    } else {  // the short last stage of a product whose in is not a multiple of the stage
#pragma unroll 1
      for (int gi = 0; gi < ng; ++gi) qmm_group<FORM, MT, NT>(stage, gi, wcol, lane, acc);
    }
  }
  cp_async_wait<0>();

  // Row n = r0 + 8 n-tile + 2t + h of the lane's columns: acc[j][n][h] is
  // column 2j, acc[j][n][2 + h] column 2j + 1.
  const int col = c0 + wcol;
  if (S == 1) {
    if (col >= OUT) return;
    float sf[2 * MT];
#pragma unroll
    for (int c = 0; c < 2 * MT; ++c) sf[c] = FORM == kFlat ? s[col + c] : 1.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + n * 8 + 2 * t + h;
        if (row >= N) continue;
        float v[2 * MT];
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          v[2 * j] = acc[j][n][h] * sf[2 * j];
          v[2 * j + 1] = acc[j][n][2 + h] * sf[2 * j + 1];
        }
        store_bf16<MT>(out + (int64_t)row * OUT + col, v);
      }
    return;
  }

  // Split-K: this split's f32 tile to the workspace; the last split of the
  // tile to arrive adds all of them in split order.
  constexpr int kTileFloats = T::kRT * T::kBO;
  float* mine = ws + ((int64_t)tile * S + blockIdx.y) * kTileFloats;
  if (col < OUT) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = n * 8 + 2 * t + h;
        if (r0 + r >= N) continue;
        float* p = mine + r * T::kBO + wcol;
        if constexpr (MT == 2) {
          *reinterpret_cast<float4*>(p) =
              make_float4(acc[0][n][h], acc[0][n][2 + h], acc[1][n][h], acc[1][n][2 + h]);
        } else {
          *reinterpret_cast<float2*>(p) = make_float2(acc[0][n][h], acc[0][n][2 + h]);
        }
      }
  }
  __threadfence();  // the partial is visible to every SM before the count moves
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counters + tile, 1) == S - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* all = ws + (int64_t)tile * S * kTileFloats;
  for (int i = threadIdx.x; i < kTileFloats / 4; i += kMmaThreads) {
    const int r = i / (T::kBO / 4), c = (i % (T::kBO / 4)) * 4;
    if (r0 + r >= N || c0 + c >= OUT) continue;
    const float* p = all + r * T::kBO + c;
    float o[4];
    for (int q0 = 0; q0 < S; q0 += 8) {  // 8 loads in flight, added in split order
      float4 u[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q0 + q < S)
          u[q] = __ldcg(reinterpret_cast<const float4*>(p + (int64_t)(q0 + q) * kTileFloats));
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (q0 + q >= S) break;
        if (q0 + q == 0) {
          o[0] = u[q].x;
          o[1] = u[q].y;
          o[2] = u[q].z;
          o[3] = u[q].w;
        } else {
          o[0] += u[q].x;
          o[1] += u[q].y;
          o[2] += u[q].z;
          o[3] += u[q].w;
        }
      }
    }
    if constexpr (FORM == kFlat) {
      const float4 f = *reinterpret_cast<const float4*>(s + c0 + c);
      o[0] *= f.x;
      o[1] *= f.y;
      o[2] *= f.z;
      o[3] *= f.w;
    }
    store_bf16<2>(out + (int64_t)(r0 + r) * OUT + c0 + c, o);
  }
  if (threadIdx.x == 0) counters[tile] = 0;  // every split has counted: ready for the next product
}

template <int FORM, int MT, int NT>
int launch_qmm_mma(const void* x, const void* w, const void* s, const void* z, void* out,
                   void* ws, void* counters, int N, int IN, int OUT, int splits, int k_slice,
                   cudaStream_t stream) {
  using T = QmmTile<FORM, MT, NT>;
  auto kern = qmm_mma_kernel<FORM, MT, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((OUT + T::kBO - 1) / T::kBO, splits, (N + T::kRT - 1) / T::kRT);
  kern<<<grid, kMmaThreads, T::kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(w), static_cast<const float*>(s),
      static_cast<const float*>(z), static_cast<bf16*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), N, IN, OUT, k_slice);
  return (int)cudaGetLastError();
}

// The instance for a plan's (row tile, block columns): 8 or 16 rows on 128
// columns, 64 rows on 64 columns.
template <int FORM>
int qmm_mma_tile(const void* x, const void* w, const void* s, const void* z, void* out,
                 void* ws, void* counters, int N, int IN, int OUT, int row_tile, int block_cols,
                 int splits, int k_slice, cudaStream_t st) {
  if (row_tile == 8 && block_cols == 128)
    return launch_qmm_mma<FORM, 2, 1>(x, w, s, z, out, ws, counters, N, IN, OUT, splits,
                                      k_slice, st);
  if (row_tile == 16 && block_cols == 128)
    return launch_qmm_mma<FORM, 2, 2>(x, w, s, z, out, ws, counters, N, IN, OUT, splits,
                                      k_slice, st);
  if (row_tile == 64 && block_cols == 64)
    return launch_qmm_mma<FORM, 1, 8>(x, w, s, z, out, ws, counters, N, IN, OUT, splits,
                                      k_slice, st);
  return (int)cudaErrorInvalidValue;
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

template <int RT>
int launch_unembed(const void* h, const void* q, const void* s, void* out, int N, int D, int V,
                   cudaStream_t stream) {
  const int per_block = kWarps * kVocabPerWarp;
  const dim3 grid((V + per_block - 1) / per_block, (N + RT - 1) / RT);
  unembed_kernel<RT><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), N, D, V);
  return (int)cudaGetLastError();
}

int unembed_rows(const void* h, const void* q, const void* s, void* out, int N, int D, int V,
                 cudaStream_t st) {
  if (N == 1) return launch_unembed<1>(h, q, s, out, N, D, V, st);
  return launch_unembed<8>(h, q, s, out, N, D, V, st);
}


// ------------------------------------------------------------------------ //
// B4, bf16 h: mma.sync tiles over vocab rows, the head streamed once into
// registers, h staged in shared memory by persistent blocks
// ------------------------------------------------------------------------ //

constexpr int kUnembedWarps = 16;
constexpr int kUnembedThreads = 32 * kUnembedWarps;
constexpr int kChunk = 64;  // head columns a chunk: one 16-byte load a lane and vocab row
constexpr int kHPad = 4;    // bf16 past each staged h row: a warp's 8-byte reads hit 32 banks

// A warp's register ring: S chunks, loaded L at a time (L consecutive
// chunks of a row back to back, so the row's lines are asked for together),
// S - L of them in flight while the rest are used. NT = 8 keeps a smaller
// ring beside its 32 accumulators.
template <int NT>
struct UnembedRing {
  static constexpr int S = NT == 8 ? 4 : 8;
  static constexpr int L = NT == 8 ? 2 : 4;
  static_assert(S % L == 0 && S >= 2 * L, "whole groups, one in flight beside one in use");
};

// 16 head bytes, streamed: read once, so no L1 line; L2 fetches the whole
// 128-byte line.
__device__ __forceinline__ uint4 ldg_stream(const int8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::128B.v4.u32 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Bytes c and c + 1 of w (signed int8 already XORed with 0x80) as bf16x2,
// byte c in the low half, exact (see bytes_bf16x2).
__device__ __forceinline__ uint32_t pair_bf16x2(uint32_t w, int c) {
  const float fa = __uint_as_float(prmt(w, 0x4B000000u, 0x7650u | c)) - 8388736.f;
  const float fb = __uint_as_float(prmt(w, 0x4B000000u, 0x7650u | (c + 1))) - 8388736.f;
  return prmt(__float_as_uint(fa), __float_as_uint(fb), 0x7632u);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

// h rows r0 .. r0 + RT and columns k0 .. k0 + ks into hs (row pitch `pitch`
// bf16), zero past N and D; 16-byte loads when h is 16-byte aligned.
template <int RT>
__device__ __forceinline__ void stage_h(bf16* hs, int pitch, const bf16* __restrict__ h, int N,
                                        int D, int r0, int k0, int ks, bool vec) {
  const int per_row = ks / 8;
  for (int i = threadIdx.x; i < RT * per_row; i += kUnembedThreads) {
    const int r = i / per_row, kc = (i % per_row) * 8, k = k0 + kc;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N && k < D) {  // D % 16 == 0: the 8 columns are all in or all out
      const bf16* src = h + (int64_t)(r0 + r) * D + k;
      if (vec) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        const uint16_t* e = reinterpret_cast<const uint16_t*>(src);
        v = make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16,
                       e[4] | (uint32_t)e[5] << 16, e[6] | (uint32_t)e[7] << 16);
      }
    }
    uint2* dst = reinterpret_cast<uint2*>(hs + r * pitch + kc);  // rows are 8-byte aligned
    dst[0] = make_uint2(v.x, v.y);
    dst[1] = make_uint2(v.z, v.w);
  }
}

// One 64-column chunk of the warp's vocab tile against its NT n-tiles:
// wa[0] / wa[1] are the lane's 16 bytes of vocab rows g / g + 8, hb the
// lane's staged h at (row g, the chunk's column 16t).
template <int NT>
__device__ __forceinline__ void unembed_chunk(const uint4 (&wa)[2], const bf16* hb, int pitch,
                                              float (&acc)[NT][4]) {
#pragma unroll
  for (int st = 0; st < 4; ++st) {
    const uint32_t w0 = word_of(wa[0], st) ^ 0x80808080u;
    const uint32_t w8 = word_of(wa[1], st) ^ 0x80808080u;
    const uint32_t a[4] = {pair_bf16x2(w0, 0), pair_bf16x2(w8, 0), pair_bf16x2(w0, 2),
                           pair_bf16x2(w8, 2)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      // h[n][16t + 4st .. +1] for k slots (2t, 2t + 1), +2 .. +3 for (2t + 8, 2t + 9)
      const uint2 b = *reinterpret_cast<const uint2*>(hb + n * 8 * pitch + 4 * st);
      mma_bf16(acc[n], a, b.x, b.y);
    }
  }
}

// Block b of `gridDim.x` walks the 16-row vocab tiles
// [b * tiles / blocks, (b + 1) * tiles / blocks), its warps taking
// consecutive tiles of each round (ops/quant_matmul.UnembedPlan).
template <int NT>
__global__ void __launch_bounds__(kUnembedThreads, 1)
unembed_mma_kernel(const bf16* __restrict__ h, const int8_t* __restrict__ q,
                   const float* __restrict__ s, float* __restrict__ out, int N, int D, int V,
                   int k_slice) {
  constexpr int S = UnembedRing<NT>::S, L = UnembedRing<NT>::L;
  constexpr int RT = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem_unembed[];
  bf16* hs = reinterpret_cast<bf16*>(smem_unembed);  // [RT][pitch]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pitch = k_slice + kHPad;
  const int r0 = blockIdx.y * RT;
  const int nch = (D + kChunk - 1) / kChunk;
  const int cps = k_slice / kChunk;  // chunks a staged slice
  const bool streamed = cps < nch;   // h is staged again for every slice of every round
  const int tiles = (V + 15) / 16;
  const int tb = (int)((int64_t)blockIdx.x * tiles / gridDim.x);
  const int te = (int)((int64_t)(blockIdx.x + 1) * tiles / gridDim.x);
  const bool vec_h = (reinterpret_cast<uintptr_t>(h) & 15) == 0;
  const bf16* hb = hs + g * pitch + 16 * t;
  bool staged = false;

  // Every warp of the block runs the same rounds and chunks (they meet at
  // the staging barriers); a warp past the block's range loads nothing.
  for (int t0 = tb; t0 < te; t0 += kUnembedWarps) {
    const int tile = t0 + warp;
    const bool active = tile < te;
    const int v0 = tile * 16;
    const int8_t* qrow[2];  // the lane's vocab rows g and g + 8, at its column 16t
    bool vok[2];
    float sc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int v = v0 + g + 8 * r;
      vok[r] = active && v < V;
      qrow[r] = q + (vok[r] ? (int64_t)v * D + 16 * t : 0);
      sc[r] = vok[r] ? s[v] : 0.f;
    }
    auto load = [&](uint4(&dst)[2], int c) {
      const bool kin = c < nch && c * kChunk + 16 * t < D;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dst[r] = make_uint4(0u, 0u, 0u, 0u);
        if (kin && vok[r]) dst[r] = ldg_stream(qrow[r] + (int64_t)c * kChunk);
      }
    };

    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    uint4 wa[S][2];
#pragma unroll
    for (int i = 0; i < S - L; ++i) load(wa[i], i);
    int cin = 0;  // the chunk's place in the staged slice (block-uniform, like c)
    for (int c0 = 0; c0 < nch; c0 += S) {
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int c = c0 + i;
        if (c < nch) {
          if (cin == cps) cin = 0;
          if (cin == 0 && (streamed || !staged)) {
            __syncthreads();  // every warp is done with the previous slice
            stage_h<RT>(hs, pitch, h, N, D, r0, c * kChunk, k_slice, vec_h);
            __syncthreads();
            staged = true;
          }
          if (i % L == 0)  // the next group, into the slots of the group just used
#pragma unroll
            for (int l = 0; l < L; ++l) load(wa[(i + S - L + l) % S], c + S - L + l);
          if (active) unembed_chunk<NT>(wa[i], hb + cin * kChunk, pitch, acc);
          ++cin;
        }
      }
    }

    // acc[n][2r + e]: vocab row v0 + g + 8r, h row r0 + 8n + 2t + e.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!vok[r]) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = r0 + 8 * n + 2 * t + e;
          if (row < N) out[(int64_t)row * V + v0 + g + 8 * r] = acc[n][2 * r + e] * sc[r];
        }
    }
  }
}

template <int NT>
int launch_unembed_mma(const void* h, const void* q, const void* s, void* out, int N, int D,
                       int V, int k_slice, int blocks, cudaStream_t stream) {
  auto kern = unembed_mma_kernel<NT>;
  const int smem = 8 * NT * (k_slice + kHPad) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(blocks, (N + 8 * NT - 1) / (8 * NT));
  kern<<<grid, kUnembedThreads, smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), N, D, V, k_slice);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. x_dtype: 0 = float32,
// 1 = bfloat16 (x and out share it). form: 0 flat int8 (s [OUT]), 1 grouped
// int8, 2 packed int4 (s, z [G, OUT]); gs: the group size of forms 1 and 2,
// which must be 32. The caller guarantees OUT % 4 == 0, 4-byte aligned
// weights and 16-byte aligned scales. bf16 x also needs OUT % 16 == 0,
// IN % 8 == 0 and 16-byte aligned x and weights (cp.async), and the plan of
// ops/quant_matmul.qmm_plan: row_tile / block_cols one of 8 / 128, 16 / 128,
// 64 / 64; `splits` k-slices of k_slice in-rows (a multiple of 32) that
// cover IN, none empty; with splits > 1, ws holds splits x tiles x row_tile
// x block_cols f32 and counters one zeroed int per output tile. f32 x
// ignores the plan. Returns 0 or the cudaError_t of the failed launch.
extern "C" int quant_matmul(const void* x, const void* w, const void* s, const void* z,
                            void* out, void* ws, void* counters, int N, int IN, int OUT,
                            int form, int gs, int x_dtype, int row_tile, int block_cols,
                            int splits, int k_slice, void* stream) {
  if (N <= 0 || OUT <= 0) return 0;
  if (IN <= 0 || OUT % kCols) return (int)cudaErrorInvalidValue;
  if (form != kFlat && (gs != kGroup || IN % kGroup)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return qmm_rows<float>(x, w, s, z, out, N, IN, OUT, form, st);
  if (x_dtype != 1) return (int)cudaErrorInvalidValue;
  if (OUT % 16 || IN % 8 || splits < 1 || k_slice <= 0 || k_slice % kGroup ||
      (int64_t)(splits - 1) * k_slice >= IN || (int64_t)splits * k_slice < IN ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (form == kFlat)
    return qmm_mma_tile<kFlat>(x, w, s, z, out, ws, counters, N, IN, OUT, row_tile, block_cols,
                               splits, k_slice, st);
  if (form == kGrouped)
    return qmm_mma_tile<kGrouped>(x, w, s, z, out, ws, counters, N, IN, OUT, row_tile,
                                  block_cols, splits, k_slice, st);
  if (form == kInt4)
    return qmm_mma_tile<kInt4>(x, w, s, z, out, ws, counters, N, IN, OUT, row_tile, block_cols,
                               splits, k_slice, st);
  return (int)cudaErrorInvalidValue;
}

// h [N, D] (h_dtype 0 = float32, 1 = bfloat16), q [V, D] int8 with D % 16
// == 0 and 16-byte aligned rows, s [V] f32, out [N, V] f32. bf16 h takes
// the plan of ops/quant_matmul.qunembed_plan: row_tile 8, 16 or 64; k_slice
// a multiple of 64; `blocks` persistent blocks a row tile. f32 h ignores the
// plan. Returns 0 or the cudaError_t of the failed launch.
extern "C" int quant_unembed(const void* h, const void* q, const void* s, void* out, int N,
                             int D, int V, int h_dtype, int row_tile, int k_slice, int blocks,
                             void* stream) {
  if (N <= 0 || V <= 0) return 0;
  if (D <= 0 || D % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h_dtype == 0) return unembed_rows(h, q, s, out, N, D, V, st);
  if (h_dtype != 1 || k_slice <= 0 || k_slice % kChunk || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (row_tile == 8) return launch_unembed_mma<1>(h, q, s, out, N, D, V, k_slice, blocks, st);
  if (row_tile == 16) return launch_unembed_mma<2>(h, q, s, out, N, D, V, k_slice, blocks, st);
  if (row_tile == 64) return launch_unembed_mma<8>(h, q, s, out, N, D, V, k_slice, blocks, st);
  return (int)cudaErrorInvalidValue;
}
