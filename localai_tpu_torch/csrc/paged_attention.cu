// Ragged paged-attention partials for Hopper (sm_90a).
//
// Replaces the TPU kernel localai_tpu/ops/paged_flash.py::_ragged_paged_kernel
// (launched by _paged_partials_rows, paged_flash.py:289), both of its
// table layouts and its sink + window skip. Same function: for each slot
// b, kv head kh and query row r, the online-softmax partials of
// q[b, kh, r] against the rows g < limits[b] of the slot's context, where
// row g lives in pool page tab(b, g / page) at offset g % page:
//   tab(b, j) = table[b, j]                          (flat table, span 0)
//   tab(b, j) = l0[table[b, j / span], j % span]    (hierarchical: table is
//               the L1 directory [B, MP / span] of table-page ids into the
//               global l0 [NTP, span]; both indices clamped)
//   s = q . k_g          (q rows arrive in f32 with 1/sqrt(D) applied)
//   s = softcap * tanh(s / softcap)          when softcap > 0, before masking
//   g is masked when g >= limits[b], or when window > 0 and
//     qpos[b, r] - g >= window (the layer's sliding flag is a runtime
//     operand: the wrapper passes window 0 for a global layer), or when
//     swin > 0 and neither g < sink nor qpos[b, r] - g < swin (the
//     engine's sink + window)
//   m = max over unmasked s, l = sum exp(s - m), acc = sum exp(s - m) v_g
// With swin > 0 the slot never reads its cold middle: it walks the
// virtual rows [0, n_v), virtual row v being real row v below the sink
// pages (sink_cols = ceil(sink / page)) and v + gap above them, where
// win_lo = clamp((qmin - swin + 1) / page, sink_cols, n_live) from the
// smallest query position qmin of the slot's whole qpos row, and gap =
// (win_lo - sink_cols) * page (ops/paged_flash.walk_rows). Every skipped
// row is masked for every query row, so the skip is exact, and pages it
// never reads may point at SCRATCH (spilled to the host).
// Inputs: q [B, K, QR, D] f32, pools [P, page, K, D] bf16, f32, fp8 e4m3
// or fp8 e5m2 (one layer's slice), table [B, MP] int32 or L1 [B, MP / span]
// with l0 [NTP, span] int32, limits [B] int32,
// qpos [B, QR] int32, and for fp8 pools kv_scale [2, K] f32 or null (all
// ones): such a pool stores value / scale. The K scale of head kh is folded
// into its q rows (s = (ksc q) . k_stored) and the V scale multiplies the
// head's finished acc (acc = vsc sum p v_stored): one factor per (slot,
// head) instead of one per element, the same function in f32. bf16 and f32
// pools are unscaled (the wrapper refuses a scale).
// Outputs: acc [B, K, QR, D], m [B, K, QR], l [B, K, QR], all f32. A slot
// with no unmasked row (limit 0: idle slots, the first prefill chunk)
// writes m = -1e30, l = 0, acc = 0. The walk covers min(limits[b], MP*page)
// rows; rows of the last, partial tile past it are masked, never read.
//
// What bounds it. Decode reads each live K/V byte once for G query rows
// (~2 FLOPs per byte of bf16 KV per row, ~4 for fp8), far below the
// card's ridge: it is bound by bytes, and the whole card has to read them.
// A prefill chunk scores T*G rows against the prefix, which is bound by
// operations.
//
// Design.
// - Split-KV over the SMs, merged in the same launch. The grid is (splits,
//   K x row tiles, B). The wrapper's plan (ops/paged_flash.paged_plan)
//   sets the most splits a slot may use and a unit of rows (a multiple of
//   the 64-row key tile); it depends on the capacity, the page, K, QR, D,
//   the pool type and the SM count, never on B or on the limits. Each slot
//   cuts its own visited (virtual) rows into splits of the fewest whole
//   units that keep it within `splits`: a short context, or a long one
//   whose middle is skipped, spreads over as many blocks as a full one, in
//   short splits, and a slot's partials depend on its own limit and query
//   positions alone, never on what else is in the batch. A block whose split
//   starts at or past its slot's live rows exits at once; split 0 of a
//   slot with none writes the empty partial.
//   A slot whose live rows fit one split writes its outputs directly.
//   Otherwise each live split writes its f32 (m, l, acc) to a workspace,
//   fences, and bumps the tile's counter; the last of the slot's live
//   splits to arrive adds them in split order 0..n-1, writes the outputs
//   and resets the counter. No float atomics: launches repeat bit for bit.
//   The workspace and counters are the wrapper's, one pair per device,
//   grown on demand (the port issues every call in order on one stream).
// - Staged loads. bf16 and fp8 pools go through paged_mma_kernel: tiles of
//   64 key rows of K and V arrive by 16-byte cp.async.cg in a two-stage
//   shared-memory ring, so one tile is in flight while the other is
//   computed. Each chunk's source row is resolved through the split's
//   slice of the page table (virtual columns resolved to real ones, then
//   through one or two table levels), staged in shared memory once, so
//   pages smaller than a tile (down to one row) work, and the walk never
//   touches the directory again. bf16 tiles land XOR-
//   swizzled by row (ldmatrix reads 8 rows from 8 bank groups). fp8 tiles
//   land as stored; after each barrier the block widens the tile exactly to
//   bf16, two values at a time (__nv_cvt_fp8x2_to_halfraw2, then f32 and
//   bf16: every e4m3 / e5m2 value is a bf16 value), into a swizzled tile.
// - Tensor cores. S = Q.K^T and acc += P.V are mma.sync m16n8k16 (bf16 in,
//   f32 accumulate) with query rows on M and keys on n, K fragments by
//   ldmatrix and V fragments by ldmatrix.trans from the ring; P stays in
//   registers (the S accumulator of two 8-key n-tiles is the A fragment of
//   a 16-key k-step). Q arrives in f32 and the plain version computes in
//   f32, so q is split into bf16 hi + lo (lo = bf16(q - hi)), and so is p:
//   two mma a product, relative error ~2^-16 against one bf16 rounding's
//   2^-9. K and V are exact in bf16. Row tiles: up to 16 query rows (decode:
//   G rows; a speculation verify: T*G <= 16) a block owns 16 rows and its
//   4 warps split each key tile (16 keys a warp, each its own softmax
//   state, combined in warp order); more rows go in 64-row tiles, a warp
//   owning 16 rows and walking all 64 keys of a tile.
// - Softmax. Online, in f32, on the raw (softcapped) scores: m is their
//   max, p = 2^(s log2e - m log2e) on the special-function unit, masked
//   keys give p = 0 by a select.
// - f32 pools: paged_scalar_kernel, the first kernel's scalar f32 FMAs (a
//   tensor-core operand would round the f32 pool), split the same way: 8
//   warps split the split's rows in 32-row tiles, a lane owning a key row
//   read straight from the pool, and the warps' states combine in shared
//   memory. f32 pools serve the small test models, not the serving path.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKeyTile = 64;  // key rows a ring stage holds; a split unit is a multiple

// ------------------------------------------------------------------------ //
// A block's partial -> the outputs, through the split merge
// ------------------------------------------------------------------------ //

// Shared memory holds NW softmax states for each of the tile's QT rows:
// st_m [NW][QT], st_l [NW][QT], st_acc [NW][QT][D]. They are combined in
// state order into the block's partial (acc times vsc). With one live split
// the partial is the output; otherwise it goes to this split's slot of the
// tile's workspace ([QT] m, [QT] l, [QT][D] acc per split) and the last
// live split to arrive merges the n_live partials in split order, with each
// split's row weights exp(m_s - max) kept in the states' space (n_live <=
// 64 <= NW * (D + 2): the plan's kMaxSplits).
template <int NW, int QT, int D, int THREADS>
__device__ void emit_tile(float* st_m, const float* st_l, const float* st_acc, int rows,
                          float vsc, int split, int n_live, float* __restrict__ ws_tile,
                          int* __restrict__ counter, float* __restrict__ acc_out,
                          float* __restrict__ m_out, float* __restrict__ l_out) {
  constexpr int kPart = QT * (D + 2);
  __shared__ int is_last;
  __shared__ float wst[NW * QT];  // each state's weight exp(m_w - max) in its row
  const bool direct = n_live == 1;
  float* part = ws_tile + (int64_t)split * kPart;
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, st_m[w * QT + r]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(st_m[w * QT + r] - mx);
      wst[w * QT + r] = f;
      sum += st_l[w * QT + r] * f;
    }
    if (direct) {
      m_out[r] = mx;
      l_out[r] = sum;
    } else {
      part[r] = mx;
      part[QT + r] = sum;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * (D / 4); i += THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(st_acc + (w * QT + r) * D + c);
      const float f = wst[w * QT + r];
      a.x += x.x * f;
      a.y += x.y * f;
      a.z += x.z * f;
      a.w += x.w * f;
    }
    a = make_float4(a.x * vsc, a.y * vsc, a.z * vsc, a.w * vsc);
    *reinterpret_cast<float4*>((direct ? acc_out : part + 2 * QT) + r * D + c) = a;
  }
  if (direct) return;
  __threadfence();  // the partial is visible to every SM before the count moves
  __syncthreads();  // and every thread is done with the states
  if (threadIdx.x == 0) is_last = atomicAdd(counter, 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float* wt = st_m;  // [n_live][QT] split weights of each row
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    float mx = kNegInf;
    for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, __ldcg(ws_tile + s * kPart + r));
    float sum = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float f = expf(__ldcg(ws_tile + s * kPart + r) - mx);
      wt[s * QT + r] = f;
      sum += __ldcg(ws_tile + s * kPart + QT + r) * f;
    }
    m_out[r] = mx;
    l_out[r] = sum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * (D / 4); i += THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const float* src = ws_tile + 2 * QT + r * D + c;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_live; s0 += 8) {  // 8 loads in flight, added in split order
      float4 u[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (s0 + q < n_live)
          u[q] = __ldcg(reinterpret_cast<const float4*>(src + (int64_t)(s0 + q) * kPart));
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (s0 + q >= n_live) break;
        const float f = wt[(s0 + q) * QT + r];
        o.x += u[q].x * f;
        o.y += u[q].y * f;
        o.z += u[q].z * f;
        o.w += u[q].w * f;
      }
    }
    *reinterpret_cast<float4*>(acc_out + r * D + c) = o;
  }
  if (threadIdx.x == 0) *counter = 0;  // every live split has counted: ready for the next call
}

// The page table of either layout: `t` is the flat table [B, stride] or
// the L1 directory [B, stride] of table-page ids into l0 [ntp, span].
struct Table {
  const int* t;
  const int* l0;  // null for a flat table
  int stride, span, ntp, P;
};

// Pool page of column `col` (< the logical width) of slot b, clamped into
// the pool as the flat id always was.
__device__ __forceinline__ int page_id(const Table& T, int b, int col) {
  const int* row = T.t + (int64_t)b * T.stride;
  int id;
  if (T.l0) {
    const int tp = min(max(row[col / T.span], 0), T.ntp - 1);
    id = T.l0[(int64_t)tp * T.span + col % T.span];
  } else {
    id = row[col];
  }
  return min(max(id, 0), T.P - 1);
}

// The smallest of a slot's query positions, over its whole qpos row (so
// every row tile of the slot walks the same columns). Every thread of the
// block calls it; nThreads is a multiple of 32, at most 1024.
template <int nThreads>
__device__ int slot_qmin(const int* __restrict__ qrow, int QR) {
  __shared__ int red[32];
  int v = 0x7fffffff;
  for (int i = threadIdx.x; i < QR; i += nThreads) v = min(v, qrow[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < nThreads / 32; ++w) v = min(v, red[w]);
  return v;
}

// Where a block stands, from its slot's limit and smallest query position:
// the slot's visited (virtual) rows, its split's virtual rows [sb, se), the
// number of live splits, its output rows, and the map of the skip (virtual
// row v is real row v < sink_rows ? v : v + gap; gap 0 without the skip).
struct Where {
  int b, kh, r0, rows, n_rows, n_live, sb, se;
  int sink_rows, gap;
  int64_t row0;  // first output row in [B*K*QR]
  int tile;      // (b, kh, row tile): counter and workspace index
  __device__ __forceinline__ int real(int v) const { return v < sink_rows ? v : v + gap; }
  __device__ __forceinline__ int real_col(int vc, int page) const {
    return vc * page < sink_rows ? vc : vc + gap / page;
  }
};

template <int QT>
__device__ __forceinline__ Where where(int limit, int qmin, int KH, int QR, int MP, int page,
                                       int splits, int unit, int sink, int swin) {
  Where w;
  const int row_tiles = (QR + QT - 1) / QT;
  w.b = blockIdx.z;
  w.kh = blockIdx.y / row_tiles;
  const int rt = blockIdx.y % row_tiles;
  w.r0 = rt * QT;
  w.rows = min(QT, QR - w.r0);
  const int real_rows = min(max(limit, 0), MP * page);
  w.sink_rows = real_rows;
  w.gap = 0;
  if (swin > 0) {  // ops/paged_flash.walk_rows
    const int n_live = (real_rows + page - 1) / page;
    const int sink_cols = min(sink > 0 ? (sink + page - 1) / page : 0, n_live);
    const int lo = qmin - swin + 1;
    const int win_lo = max(min(lo > 0 ? lo / page : 0, n_live), sink_cols);
    w.sink_rows = sink_cols * page;
    w.gap = (win_lo - sink_cols) * page;
  }
  // The window's part [win_lo * page, real_rows) is empty when the
  // queries are a window past the last, partial page: the sink pages remain.
  w.n_rows = min(real_rows, max(real_rows - w.gap, w.sink_rows));
  // The fewest whole units a split that keep the slot within `splits`
  // splits (ops/paged_flash.PagedPlan.split_rows), from this slot's rows.
  const int units = (w.n_rows + unit - 1) / unit;
  const int rows = max(1, (units + splits - 1) / splits) * unit;
  w.n_live = max(1, (w.n_rows + rows - 1) / rows);
  w.sb = blockIdx.x * rows;
  w.se = min(w.sb + rows, w.n_rows);
  w.row0 = ((int64_t)w.b * KH + w.kh) * QR + w.r0;
  w.tile = (w.b * KH + w.kh) * row_tiles + rt;
  return w;
}

// ------------------------------------------------------------------------ //
// f32 pools: scalar FMAs
// ------------------------------------------------------------------------ //

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 32;  // rows per warp tile: one per lane

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
constexpr int scalar_smem_floats() {
  // q tile, per-warp probabilities, per-warp (m, l, acc) states, query positions.
  return QT * D + kWarps * kKeys * QT + kWarps * QT * (D + 2) + QT;
}

template <int D, int QT>
__global__ void __launch_bounds__(kThreads)
paged_scalar_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
                    const float* __restrict__ v_pool, const Table T,
                    const int* __restrict__ limits, const int* __restrict__ qpos,
                    float* __restrict__ acc_out, float* __restrict__ m_out,
                    float* __restrict__ l_out, float* __restrict__ ws, int* __restrict__ counters,
                    int KH, int QR, int page, int MP, int window, float softcap, int sink,
                    int swin, int splits, int unit) {
  static_assert(D % 32 == 0 && QT % 4 == 0, "tile shape");
  constexpr int NC = D / 32;  // value columns per lane
  const int qmin = swin > 0 ? slot_qmin<kThreads>(qpos + (int64_t)blockIdx.z * QR, QR) : 0;
  const Where w = where<QT>(limits[blockIdx.z], qmin, KH, QR, MP, page, splits, unit, sink,
                            swin);
  if ((int)blockIdx.x >= w.n_live) return;
  extern __shared__ float smem[];
  float* qs = smem;                            // [QT][D]
  float* ps = qs + QT * D;                     // [kWarps][kKeys][QT]
  float* wm = ps + kWarps * kKeys * QT;        // [kWarps][QT]
  float* wl = wm + kWarps * QT;                // [kWarps][QT]
  float* wacc = wl + kWarps * QT;              // [kWarps][QT][D]
  int* qp = reinterpret_cast<int*>(wacc + kWarps * QT * D);  // [QT]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < QT * D; i += kThreads) {
    const int r = i / D;
    qs[i] = r < w.rows ? q[w.row0 * D + i] : 0.f;
  }
  if (threadIdx.x < QT)
    qp[threadIdx.x] = threadIdx.x < w.rows ? qpos[(int64_t)w.b * QR + w.r0 + threadIdx.x] : 0;
  __syncthreads();

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

  for (int t0 = w.sb + warp * kKeys; t0 < w.se; t0 += kWarps * kKeys) {
    const int v = t0 + lane;  // this lane's virtual row
    const int g = w.real(v);  // and its real row
    const bool live = v < w.se;
    long long off = 0;  // this lane's row in the pool, as an element offset
    float s[QT];
#pragma unroll
    for (int r = 0; r < QT; ++r) s[r] = 0.f;
    if (live) {
      const int pid = page_id(T, w.b, g / page);
      off = ((long long)pid * page + g % page) * pool_row + (long long)w.kh * D;
      const float* kr = k_pool + off;
#pragma unroll 2
      for (int d0 = 0; d0 < D; d0 += 8) {
        const float4 ka = *reinterpret_cast<const float4*>(kr + d0);
        const float4 kb = *reinterpret_cast<const float4*>(kr + d0 + 4);
#pragma unroll
        for (int r = 0; r < QT; ++r) {
          const float4 qa = *reinterpret_cast<const float4*>(qs + r * D + d0);
          const float4 qb = *reinterpret_cast<const float4*>(qs + r * D + d0 + 4);
          s[r] = fmaf(qa.x, ka.x, s[r]);
          s[r] = fmaf(qa.y, ka.y, s[r]);
          s[r] = fmaf(qa.z, ka.z, s[r]);
          s[r] = fmaf(qa.w, ka.w, s[r]);
          s[r] = fmaf(qb.x, kb.x, s[r]);
          s[r] = fmaf(qb.y, kb.y, s[r]);
          s[r] = fmaf(qb.z, kb.z, s[r]);
          s[r] = fmaf(qb.w, kb.w, s[r]);
        }
      }
    }

    float p[QT];
#pragma unroll
    for (int r = 0; r < QT; ++r) {
      float x = s[r];
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);  // before the mask
      const bool ok = live && (window <= 0 || qp[r] - g < window) &&
                      (swin <= 0 || g < sink || qp[r] - g < swin);
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

    const int nk = min(kKeys, w.se - t0);
    for (int j = 0; j < nk; ++j) {
      const long long offj = __shfl_sync(0xffffffffu, off, j);
      const float* vr = v_pool + offj;
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vr[lane + 32 * c];
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
  emit_tile<kWarps, QT, D, kThreads>(wm, wl, wacc, w.rows, 1.f, blockIdx.x, w.n_live,
                                     ws + (int64_t)w.tile * splits * QT * (D + 2),
                                     counters + w.tile, acc_out + w.row0 * D, m_out + w.row0,
                                     l_out + w.row0);
}

// ------------------------------------------------------------------------ //
// bf16 / fp8 pools: mma.sync tiles fed by a cp.async ring
// ------------------------------------------------------------------------ //

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kStages = 2;  // K/V ring depth
// Page-table entries a split's slice may hold (the plan keeps a full
// slot's split within it: split rows / page + 2 entries).
constexpr int kTableSlice = 512;
// Splits a plan may have: emit_tile keeps their row weights in the space of
// the block's states, at least 64 x QT floats.
constexpr int kMaxSplits = 64;

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

// 2^x on the special-function unit (flushes subnormals).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as bf16x2 hi + lo: hi = bf16(x), lo = bf16(x - hi) (x in the low half).
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - f.x, y - f.y));
}

// Byte offset of 16-byte chunk c of row r in a [rows][D] bf16 tile: the
// chunk index is XORed with the row's low 3 bits, so the same logical
// chunk of 8 consecutive rows lands in 8 different groups of 4 banks.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((r * (D / 8) + (c ^ (r & 7))) * 16);
}

// Sixteen fp8 values (one 16-byte chunk) as two 16-byte chunks of bf16,
// exactly: fp8 -> half (hardware pairs), half -> f32 -> bf16.
template <__nv_fp8_interpretation_t I>
__device__ __forceinline__ void widen16(const uint4 raw, uint4& lo, uint4& hi) {
  const __nv_fp8x2_storage_t* h = reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {  // the low byte is the lower-addressed element
    const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(h[i], I)));
    out[i] = bits(__floats2bfloat162_rn(f.x, f.y));
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

template <typename T> struct Fp8Kind;
template <> struct Fp8Kind<__nv_fp8_e4m3> { static constexpr __nv_fp8_interpretation_t I = __NV_E4M3; };
template <> struct Fp8Kind<__nv_fp8_e5m2> { static constexpr __nv_fp8_interpretation_t I = __NV_E5M2; };

template <typename T, int D, int WK>
struct MmaTile {
  static constexpr bool kFp8 = sizeof(T) == 1;
  static constexpr int QT = WK == 1 ? 64 : 16;     // query rows a block
  static constexpr int NKW = kKeyTile / WK;        // keys a warp takes of each tile
  static constexpr int kRowChunks = D * (int)sizeof(T) / 16;  // 16-byte chunks a stored row
  static constexpr int kRawTile = kKeyTile * D * (int)sizeof(T);  // one K or V tile as stored
  static constexpr int kTile = kKeyTile * D * 2;   // one K or V tile in bf16
  static constexpr int kQ = QT * D * 2;            // q hi (and again q lo), bf16
  static constexpr int kRing = kStages * 2 * kRawTile;
  static constexpr int kCvt = kFp8 ? 2 * kTile : 0;  // the current tile's K and V, widened
  static constexpr int kWalk = 2 * kQ + kRing + kCvt;
  static constexpr int kStates = WK * QT * (D + 2) * 4;  // emit's states, over the walk's space
  static constexpr int kMain = kWalk > kStates ? kWalk : kStates;
  static constexpr int kSmem = kMain + QT * 4 + kTableSlice * 4;
  static_assert(QT == 16 * (kMmaWarps / WK), "a warp owns 16 query rows");
  static_assert(kRawTile % (16 * kMmaThreads) == 0, "every thread copies the same chunks");
  static_assert(kMain % 16 == 0, "16-byte aligned regions");
};

template <typename T, int D, int WK>
__global__ void __launch_bounds__(kMmaThreads)
paged_mma_kernel(const float* __restrict__ q, const T* __restrict__ k_pool,
                 const T* __restrict__ v_pool, const Table tb,
                 const int* __restrict__ limits, const int* __restrict__ qpos,
                 const float* __restrict__ kv_scale, float* __restrict__ acc_out,
                 float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ ws,
                 int* __restrict__ counters, int KH, int QR, int page, int MP, int window,
                 float softcap, int sink, int swin, int splits, int unit) {
  using Tl = MmaTile<T, D, WK>;
  constexpr int QT = Tl::QT, NKW = Tl::NKW;
  constexpr int KD = D / 16;    // k-steps of Q.K^T; d-tile pairs of P.V
  constexpr int NT = NKW / 8;   // 8-key n-tiles of a warp's S
  constexpr int DT = D / 8;     // 8-column d-tiles of acc
  const int qmin = swin > 0 ? slot_qmin<kMmaThreads>(qpos + (int64_t)blockIdx.z * QR, QR) : 0;
  const Where w = where<QT>(limits[blockIdx.z], qmin, KH, QR, MP, page, splits, unit, sink,
                            swin);
  if ((int)blockIdx.x >= w.n_live) return;

  extern __shared__ __align__(128) unsigned char smem_mma[];
  const uint32_t qhi = smem_u32(smem_mma), qlo = qhi + Tl::kQ;  // [QT][D] swizzled
  const uint32_t ring = qlo + Tl::kQ;         // stage s: K at ring + 2 s kRawTile, V after it
  const uint32_t cvt = ring + Tl::kRing;      // fp8: the current K tile, V after it
  int* qp = reinterpret_cast<int*>(smem_mma + Tl::kMain);  // [QT]
  int* tab = qp + QT;                         // page ids of the split's (virtual) columns

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;    // mma fragment row group, lane in quad
  const float ksc = Tl::kFp8 && kv_scale ? kv_scale[w.kh] : 1.f;
  const float vsc = Tl::kFp8 && kv_scale ? kv_scale[KH + w.kh] : 1.f;
  const int n_tiles = (w.se - w.sb + kKeyTile - 1) / kKeyTile;  // 0 for an idle slot
  const int pbase = w.sb / page;  // the split's first virtual column

  // The split's page ids, the query positions, and q * ksc as bf16 hi + lo.
  const int n_tab = n_tiles ? (w.se - 1) / page - pbase + 1 : 0;
  for (int i = threadIdx.x; i < n_tab; i += kMmaThreads)
    tab[i] = page_id(tb, w.b, w.real_col(pbase + i, page));
  if (threadIdx.x < QT)
    qp[threadIdx.x] = threadIdx.x < w.rows ? qpos[(int64_t)w.b * QR + w.r0 + threadIdx.x] : 0;
  for (int i = threadIdx.x; i < QT * D / 4; i += kMmaThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < w.rows) {  // q rows need no 16-byte alignment
      const float* qr = q + (w.row0 + r) * D + c;
      x = make_float4(qr[0], qr[1], qr[2], qr[3]);
    }
    uint32_t h0, l0, h1, l1;
    split_bf16x2(x.x * ksc, x.y * ksc, h0, l0);
    split_bf16x2(x.z * ksc, x.w * ksc, h1, l1);
    const uint32_t at = swz<D>(r, c / 8) + (c % 8) * 2;
    asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(qhi + at), "r"(h0), "r"(h1));
    asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(qlo + at), "r"(l0), "r"(l1));
  }
  __syncthreads();

  // Tile j's K and V go to stage j % kStages. Group j of cp.async holds
  // tile j; a group is committed every step, empty or not, so that
  // wait_group counts alike on every step.
  const int64_t head = (int64_t)w.kh * D;
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      const uint32_t st = ring + (j % kStages) * 2 * Tl::kRawTile;
      const int k0 = w.sb + j * kKeyTile;
#pragma unroll
      for (int u = 0; u < kKeyTile * Tl::kRowChunks / kMmaThreads; ++u) {
        const int i = threadIdx.x + u * kMmaThreads;
        const int r = i / Tl::kRowChunks, c = i % Tl::kRowChunks;
        const int gr = k0 + r;
        const bool ok = gr < w.se;
        int64_t off = 0;
        if (ok) off = ((int64_t)tab[gr / page - pbase] * page + gr % page) * KH * D + head;
        const uint32_t at = Tl::kFp8 ? (uint32_t)(r * Tl::kRowChunks + c) * 16 : swz<D>(r, c);
        const char* kb = reinterpret_cast<const char*>(k_pool + off) + c * 16;
        const char* vb = reinterpret_cast<const char*>(v_pool + off) + c * 16;
        cp_async16(st + at, kb, ok);
        cp_async16(st + Tl::kRawTile + at, vb, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_kv(j);

  const int rw0 = WK == 1 ? warp * 16 : 0;          // this warp's first row in the tile
  const int kw0 = WK == 1 ? 0 : warp * NKW;         // this warp's first key in a tile
  int qpr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) qpr[hh] = qp[rw0 + g + hh * 8];
  float acc[DT][4], m[2], l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = kNegInf;
    l[hh] = 0.f;
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = w.sb + t * kKeyTile;
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();               // for every thread, and tile t-1's reads are done
    load_kv(t + kStages - 1);      // into the stage tile t-1 used
    uint32_t kt = ring + (t % kStages) * 2 * Tl::kRawTile;
    if constexpr (Tl::kFp8) {  // widen the stage into the bf16 tiles
      const unsigned char* raw = smem_mma + (kt - qhi);
      for (int i = threadIdx.x; i < 2 * kKeyTile * Tl::kRowChunks; i += kMmaThreads) {
        const int kv = i / (kKeyTile * Tl::kRowChunks), j = i % (kKeyTile * Tl::kRowChunks);
        const int r = j / Tl::kRowChunks, c = j % Tl::kRowChunks;
        const uint4 in = *reinterpret_cast<const uint4*>(raw + kv * Tl::kRawTile + j * 16);
        uint4 lo, hi;
        widen16<Fp8Kind<T>::I>(in, lo, hi);
        unsigned char* dst = smem_mma + (cvt - qhi) + kv * Tl::kTile;
        *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * c)) = lo;
        *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * c + 1)) = hi;
      }
      __syncthreads();
      kt = cvt;
    }
    const uint32_t vt = kt + (Tl::kFp8 ? Tl::kTile : Tl::kRawTile);

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;

    // S = (q hi + q lo).K^T: one ldmatrix.x4 gives the B fragments of two n-tiles.
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t ah[4], al[4];
      const uint32_t qa = swz<D>(rw0 + (lane & 7) + ((lane >> 3) & 1) * 8, kd * 2 + (lane >> 4));
      ldsm_x4(qhi + qa, ah);
      ldsm_x4(qlo + qa, al);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(kt + swz<D>(kw0 + np * 16 + (lane & 7) + (lane >> 4) * 8,
                            kd * 2 + ((lane >> 3) & 1)),
                bk);
        mma_bf16(s[2 * np], ah, bk[0], bk[1]);
        mma_bf16(s[2 * np], al, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], ah, bk[2], bk[3]);
        mma_bf16(s[2 * np + 1], al, bk[2], bk[3]);
      }
    }

    // Softcap, then the masks: past the visited rows, outside the layer's
    // window, outside the sink + window (on real rows). A tile needs none
    // only when it is whole and neither window applies.
    const bool whole = k0 + kKeyTile <= w.se && window <= 0 && swin <= 0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (!whole) {
          const int key = k0 + kw0 + nt * 8 + 2 * tig + (e & 1);
          const int gk = w.real(key);
          const int dist = qpr[e >> 1] - gk;
          if (key >= w.se || (window > 0 && dist >= window) ||
              (swin > 0 && gk >= sink && dist >= swin))
            x = kNegInf;
        }
        s[nt][e] = x;
      }

    // Online softmax: rows g and g+8, over the quad.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = fast_exp2((m[hh] - m_new) * kLog2e);
      m[hh] = m_new;
      const float ml = m_new * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const float x = s[nt][e];
          const float p = x == kNegInf ? 0.f : fast_exp2(fmaf(x, kLog2e, -ml));
          s[nt][e] = p;
          sum += p;
        }
      l[hh] = l[hh] * alpha + sum;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][2 * hh] *= alpha;
        acc[dt][2 * hh + 1] *= alpha;
      }
    }

    // acc += (p hi + p lo).V: n-tiles 2kk and 2kk+1 of S form k-step kk;
    // one ldmatrix.x4.trans gives the B fragments of two d-tiles.
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16x2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16x2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < KD; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(vt + swz<D>(kw0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  dp * 2 + (lane >> 4)),
                      bv);
        mma_bf16(acc[2 * dp], ph, bv[0], bv[1]);
        mma_bf16(acc[2 * dp], pl, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[2 * dp + 1], pl, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the walk's shared memory becomes emit's states

  // This warp's state: rows rw0 + g and rw0 + g + 8 of state (WK == 1 ? 0 : warp).
  float* st_m = reinterpret_cast<float*>(smem_mma);
  float* st_l = st_m + WK * QT;
  float* st_acc = st_l + WK * QT;
  const int sw = WK == 1 ? 0 : warp;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = sw * QT + rw0 + g + hh * 8;
    if (tig == 0) {
      st_m[r] = m[hh];
      st_l[r] = lt;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(st_acc + r * D + dt * 8 + 2 * tig) =
          make_float2(acc[dt][2 * hh], acc[dt][2 * hh + 1]);
  }
  __syncthreads();
  emit_tile<WK, QT, D, kMmaThreads>(st_m, st_l, st_acc, w.rows, vsc, blockIdx.x, w.n_live,
                                    ws + (int64_t)w.tile * splits * QT * (D + 2),
                                    counters + w.tile, acc_out + w.row0 * D, m_out + w.row0,
                                    l_out + w.row0);
}

struct Args {
  const void *q, *k_pool, *v_pool;
  Table table;
  const int *limits, *qpos;
  const float* kv_scale;
  void *acc, *m, *l, *ws, *counters;
  int B, KH, QR, page, MP, window;
  float softcap;
  int sink, swin, row_tile, splits, unit;
  cudaStream_t stream;
};

template <int D, int QT>
int launch_scalar(const Args& a) {
  const int smem = (int)sizeof(float) * scalar_smem_floats<D, QT>();
  auto kern = paged_scalar_kernel<D, QT>;
  // Once per kernel variant (thread-safe static init): the attribute does
  // not change between launches.
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(a.splits, a.KH * ((a.QR + QT - 1) / QT), a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k_pool),
      static_cast<const float*>(a.v_pool), a.table, a.limits, a.qpos,
      static_cast<float*>(a.acc), static_cast<float*>(a.m), static_cast<float*>(a.l),
      static_cast<float*>(a.ws), static_cast<int*>(a.counters), a.KH, a.QR, a.page, a.MP,
      a.window, a.softcap, a.sink, a.swin, a.splits, a.unit);
  return (int)cudaGetLastError();
}

template <typename T, int D, int WK>
int launch_mma(const Args& a) {
  using Tl = MmaTile<T, D, WK>;
  auto kern = paged_mma_kernel<T, D, WK>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(a.splits, a.KH * ((a.QR + Tl::QT - 1) / Tl::QT), a.B);
  kern<<<grid, kMmaThreads, Tl::kSmem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), a.table, a.limits, a.qpos, a.kv_scale,
      static_cast<float*>(a.acc), static_cast<float*>(a.m), static_cast<float*>(a.l),
      static_cast<float*>(a.ws), static_cast<int*>(a.counters), a.KH, a.QR, a.page, a.MP,
      a.window, a.softcap, a.sink, a.swin, a.splits, a.unit);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_pool(const Args& a) {
  if (a.row_tile == 16) return launch_mma<T, D, 4>(a);
  if (a.row_tile == 64) return launch_mma<T, D, 1>(a);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int launch_dim(const Args& a, int dtype) {
  if (dtype == 0) {
    if (a.row_tile == 4) return launch_scalar<D, 4>(a);
    if (a.row_tile == 16) return launch_scalar<D, 16>(a);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1) return launch_pool<bf16, D>(a);
  if (dtype == 2) return launch_pool<__nv_fp8_e4m3, D>(a);
  if (dtype == 3) return launch_pool<__nv_fp8_e5m2, D>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype (of the pools): 0 = float32,
// 1 = bfloat16, 2 = fp8 e4m3, 3 = fp8 e5m2. kv_scale: [2, KH] f32, or null
// for all ones; read for fp8 pools only. The table: l0 null, span 0 and
// table [B, MP] (stride MP) for a flat table; l0 [ntp, span] and table the
// L1 directory [B, stride] with MP = stride * span for a hierarchical one.
// window: the sliding window of this layer, 0 for none. softcap: 0 for
// none. sink, swin: the sink + window skip, swin 0 for none. The plan
// (ops/paged_flash.paged_plan):
// row_tile 4 or 16 (f32 pools), 16 or 64 (bf16 / fp8); at most `splits`
// (<= 64) splits a slot, each of whole `unit`s of rows (a multiple of 64),
// a full slot's split within a 512-entry page-table slice; with splits > 1,
// ws holds splits x row_tile x (D + 2) f32 for each (slot, head, row tile)
// and counters one zeroed int for each. Pools must be 16-byte aligned. Returns
// 0 or the cudaError_t of the failed launch.
extern "C" int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                               const int* table, const int* l0, const int* limits,
                               const int* qpos, const float* kv_scale, void* acc, void* m,
                               void* l, void* ws, void* counters, int B, int KH, int QR, int D,
                               int P, int page, int MP, int stride, int span, int ntp,
                               int dtype, int window, float softcap, int sink, int swin,
                               int row_tile, int splits, int unit, void* stream) {
  if (B <= 0 || KH <= 0 || QR <= 0) return 0;
  if (P <= 0 || page <= 0 || MP <= 0 || sink < 0 || swin < 0) return (int)cudaErrorInvalidValue;
  if (l0 ? (span <= 0 || ntp <= 0 || (int64_t)stride * span != MP) : (span != 0 || stride != MP))
    return (int)cudaErrorInvalidValue;
  const int64_t capacity = (int64_t)MP * page;
  const int64_t widest = ((capacity + unit - 1) / max(unit, 1) + splits - 1) / max(splits, 1) *
                         unit;  // a full slot's split
  if (capacity > 0x7fffffff || splits < 1 || splits > kMaxSplits || unit <= 0 ||
      unit % kKeyTile || widest / page + 2 > kTableSlice ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Table tb{table, l0, stride, span, ntp, P};
  const Args a{q,       k_pool,   v_pool, tb,     limits, qpos,  kv_scale, acc,
               m,       l,        ws,     counters, B,    KH,    QR,       page,
               MP,      window,   softcap, sink,  swin,   row_tile, splits, unit,
               static_cast<cudaStream_t>(stream)};
  if (D == 64) return launch_dim<64>(a, dtype);
  if (D == 128) return launch_dim<128>(a, dtype);
  return (int)cudaErrorInvalidValue;
}
