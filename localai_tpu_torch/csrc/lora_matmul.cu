// The ragged per-row LoRA delta for multi-tenant decode on Hopper (sm_90a),
// kernel B5.
//
// It replaces the TPU kernel localai_tpu/ops/lora_matmul.py::_lora_kernel
// (launched by _lora_call, lora_matmul.py:137). Same function, for each of
// 1-3 targets that share the input x, with id = ids[n]:
// t[n, r] = sum_i x[n, i] * A[id, i, r] and out[n, o] = sum_r t[n, r] *
// B[id, r, o], for x [N, IN] (f32 or bf16, N <= 256 on the serving path),
// each target's stacked factors A [NA, IN, R] and B [NA, R, OUT] (f32 or
// bf16, the model dtype; OUT may differ between targets, IN, R and NA may
// not) and int32 ids [N]. t stays in f32 between the two products; the
// output is written once, in x's dtype. Id 0 is the all-zero null adapter:
// its rows are written as exact zeros and read no factors. An id outside
// [0, NA) reads no factors either: its row is written as NaN, so a bad id is
// loud instead of reading past the stack.
//
// What bounds it. The delta reads each distinct adapter's factors once,
// R * (IN + OUT) values a target, and does 2 * R * (IN + OUT) FLOPs a row:
// about one FLOP a factor byte in bf16, far below the card's ridge. At
// decode the bytes are a few hundred KB (the byte bound is a fraction of a
// microsecond), so the time is set by launch latency and by the chain of
// dependent memory round trips inside the launch.
//
// Design: one launch per group of targets, shrink and expand inside it.
// - Segments. The rows carrying one adapter id form a segment, and one
//   thread-block cluster serves a (segment, target), so a segment's factors
//   are read once whatever its row count. The grid cannot depend on which
//   ids are present (they live on the card), so it has min(N, NA - 1)
//   segment slots: every block loads the ids, finds the first row of each
//   distinct valid id (a table over the NA stack rows, atomicMin in shared
//   memory), and slot k takes the k-th such id in row order and gathers its
//   rows, in row order, with warp ballots. A slot past the number of
//   distinct ids has no work.
// - Shrink and expand in one launch, through the cluster. Block c of a
//   cluster of C owns rows [c*IR, (c+1)*IR) of IN and a range of the
//   target's output columns (the plan, ops/lora_matmul.lora_plan, sets C,
//   IR, the column ranges and the pass sizes from the shapes only). It
//   issues its B columns' loads first, computes its slice's f32 partial t
//   for up to 32 segment rows into its own shared memory, and after a
//   cluster barrier adds the C partials of each row in rank order, read
//   from the other blocks' shared memory (distributed shared memory), then
//   runs its columns. A second barrier, waited on only after the expand,
//   keeps each block's partials alive until every block has read them. No
//   workspace, no counters, no fences, no atomics in device memory: a
//   launch allocates nothing, reads nothing back, leaves no state behind,
//   and repeats bit for bit. (A first version handed the partials over
//   through device memory, with arrival counts and an atomic ticket that
//   ordered the items; on the H100 that hand-off took more than half of
//   the time the kernel adds at decode.)
// - Loads. A's slice rows, x's slice of the segment rows and B's column
//   rows come in by 16-byte cp.async.cg into shared memory, each issued as
//   soon as its address is known. A rank that is not a multiple of 8 makes
//   A's rows narrower than 16 bytes: its slice is loaded element by element.
// - Tensor cores on every bf16 segment (x and factors bf16). Shrink:
//   mma.sync m16n8k16 with the rank on M (R padded to 16 with zeros), the
//   slice on K and 8 segment rows on n; each (row tile, rank tile) is one
//   warp's accumulator over the whole slice. A 1-row segment is one live
//   column of eight, so a row's bits never depend on the rows beside it.
//   Expand: output columns on M, the rank on K, rows on n, with t split
//   into bf16 hi + lo (two products into one f32 accumulator): one bf16
//   rounding of t would cost up to 2^-9 of the output, hi + lo about 2^-17.
// - f32 x or f32 factors: the same clusters with scalar f32 FMAs in a fixed
//   order (the f32 checks want exact f32 products).
// Later work, recorded rather than done here: fusing the delta into the
// base product's epilogue, and one launch for every group of a layer.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 256;   // rows a launch takes (LORA_KERNEL_MAX_ROWS)
constexpr int kMaxTargets = 3;  // targets a launch takes
constexpr int kChunk = 32;      // segment rows a pass: four mma row tiles
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;

struct Targets {
  const void* a[kMaxTargets];
  const void* b[kMaxTargets];
  void* out[kMaxTargets];
  int out_dim[kMaxTargets];
  int cols[kMaxTargets];  // output columns a block owns (a multiple of 16)
};

struct Plan {
  int N, IN, R, Rp, NA, T;
  int C;      // blocks a cluster
  int IR;     // rows of IN a block owns (a multiple of 16)
  int SL;     // rows of A a shrink pass (a multiple of 16)
  int OT;     // output columns an expand pass (a multiple of 16)
  int slots;  // segment slots
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// v[t] for a runtime t without indexing the kernel parameter (which would
// copy the array to local memory).
template <typename P>
__device__ __forceinline__ P pick(const P (&v)[kMaxTargets], int t) {
  return t == 0 ? v[0] : (t == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zeros, and nothing read, when
// `pred` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The cluster barrier in its two halves: arrive publishes this thread's
// shared-memory writes to the cluster, wait returns once every thread of
// every block of the cluster has arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x2(const void* p, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(const void* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of a 16x16 tile stored K-major (row k holds M contiguous
// values, `pitch` elements apart): ldmatrix.trans of its four 8x8 blocks.
// Lane l addresses row l % 8 of block l / 8: blocks (k 0-7, m 0-7), (k 0-7,
// m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15) are a0..a3.
__device__ __forceinline__ void frag_a_kmajor(const bf16* tile, int pitch, int lane,
                                              uint32_t (&a)[4]) {
  const int blk = lane >> 3;
  ldsm_x4_trans(tile + ((blk >> 1) * 8 + (lane & 7)) * pitch + (blk & 1) * 8, a);
}
// The B fragment of a 16x8 tile stored N-major (row n holds K contiguous
// values): blocks (n 0-7, k 0-7) and (n 0-7, k 8-15) are b0, b1.
__device__ __forceinline__ void frag_b_nmajor(const bf16* tile, int pitch, int lane,
                                              uint32_t& b0, uint32_t& b1) {
  ldsm_x2(tile + (lane & 7) * pitch + ((lane >> 3) & 1) * 8, b0, b1);
}

// Offsets into dynamic shared memory, the same in every block of a cluster.
struct Layout {
  int table;   // NA ints: the first row of each id
  int part;    // [kChunk][Rp] f32: this block's partial t
  int as, xs;  // bf16: A's pass rows [SL][Rp + 8], x's [kChunk][SL + 8]
  int th, tl;  // bf16: t hi / lo [kChunk][Rp + 8]; f32: t [kChunk][Rp] at th
  int bs, os;  // bf16: B's pass [Rp][OT + 8], the out stage [8][OT + 8]
  int total;
};

__host__ __device__ inline int align16(int v) { return (v + 15) & ~15; }

template <bool kMma>
__host__ __device__ inline Layout layout(const Plan& p) {
  Layout L{};
  L.table = 0;
  L.part = align16(4 * p.NA);
  const int after = L.part + kChunk * p.Rp * 4;
  if (kMma) {
    L.as = after;
    L.xs = L.as + align16(p.SL * (p.Rp + 8) * 2);
    L.th = L.xs + align16(kChunk * (p.SL + 8) * 2);
    L.tl = L.th + align16(kChunk * (p.Rp + 8) * 2);
    L.bs = L.tl + align16(kChunk * (p.Rp + 8) * 2);
    L.os = L.bs + align16(p.Rp * (p.OT + 8) * 2);
    L.total = L.os + align16(8 * (p.OT + 8) * 2);
  } else {
    L.th = after;
    L.total = L.th + kChunk * p.Rp * 4;
  }
  return L;
}

// Slot k's segment: the k-th distinct valid non-null id in row order, and
// its rows in row order (s_rows[0..count)). Returns the id, or -1 when the
// slot has no segment. Every thread of the block calls it.
__device__ __forceinline__ int find_segment(const int* s_ids, int* first, int* s_rows,
                                            unsigned* s_words, int* s_info, int N, int NA,
                                            int k) {
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < NA; i += kThreads) first[i] = INT_MAX;
  __syncthreads();
  for (int n = tid; n < N; n += kThreads) {
    const int id = s_ids[n];
    if (id > 0 && id < NA) atomicMin(first + id, n);
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < kMaxRows / kThreads; ++h) {
    const int n = h * kThreads + tid;
    const int id = n < N ? s_ids[n] : 0;
    const bool lead = id > 0 && id < NA && first[id] == n;
    const unsigned w = __ballot_sync(0xffffffffu, lead);
    if (lane == 0) s_words[n >> 5] = w;
  }
  __syncthreads();
  if (tid == 0) {
    int rem = k, row = -1;
    for (int w = 0; w < kMaxRows / 32 && row < 0; ++w) {
      unsigned bits = s_words[w];
      const int c = __popc(bits);
      if (rem < c) {
        for (int j = 0; j < rem; ++j) bits &= bits - 1;
        row = w * 32 + __ffs(bits) - 1;
      } else {
        rem -= c;
      }
    }
    s_info[0] = row < 0 ? -1 : s_ids[row];
  }
  __syncthreads();
  const int id = s_info[0];
  if (id < 0) return -1;
#pragma unroll
  for (int h = 0; h < kMaxRows / kThreads; ++h) {
    const int n = h * kThreads + tid;
    const unsigned w = __ballot_sync(0xffffffffu, n < N && s_ids[n] == id);
    if (lane == 0) s_words[8 + (n >> 5)] = w;
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < kMaxRows / kThreads; ++h) {
    const int n = h * kThreads + tid;
    const unsigned w = s_words[8 + (n >> 5)];
    if ((w >> lane) & 1u) {
      int pos = __popc(w & ((1u << lane) - 1u));
      for (int j = 0; j < (n >> 5); ++j) pos += __popc(s_words[8 + j]);
      s_rows[pos] = n;
    }
  }
  if (tid == 0) {
    int c = 0;
    for (int j = 0; j < kMaxRows / 32; ++j) c += __popc(s_words[8 + j]);
    s_info[1] = c;
  }
  __syncthreads();
  return id;
}

// t for the chunk's rows: the C blocks' partials of each row added in rank
// order, read from their shared memory at `part`'s offset. Writes f32 t
// ([kChunk][Rp], rows past the chunk zero) to `t32` when given, else bf16
// hi / lo to th / tl ([kChunk][Rp + 8]).
__device__ __forceinline__ void gather_t(const Plan& p, cg::cluster_group& cluster,
                                         float* part, int rows, float* t32, bf16* th,
                                         bf16* tl) {
  constexpr int kBatch = kMaxCluster;  // remote loads in flight a thread: one round
  const int Q = p.Rp / 4;
  for (int u = threadIdx.x; u < kChunk * Q; u += kThreads) {
    const int rho = u / Q, q = u % Q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rho < rows) {
      for (int c0 = 0; c0 < p.C; c0 += kBatch) {
        float4 w[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (c0 + j < p.C)
            w[j] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, c0 + j) +
                                                    rho * p.Rp + 4 * q);
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (c0 + j >= p.C) break;
          if (c0 + j == 0) {
            v = w[j];
          } else {
            v.x += w[j].x;
            v.y += w[j].y;
            v.z += w[j].z;
            v.w += w[j].w;
          }
        }
      }
    }
    if (t32) {
      *reinterpret_cast<float4*>(t32 + rho * p.Rp + 4 * q) = v;
    } else {
      const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16 hi = __float2bfloat16(f[j]);
        th[rho * (p.Rp + 8) + 4 * q + j] = hi;
        tl[rho * (p.Rp + 8) + 4 * q + j] = __float2bfloat16(f[j] - __bfloat162float(hi));
      }
    }
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
lora_group_kernel(const T* __restrict__ x, const int* __restrict__ ids, Targets tg, Plan p) {
  constexpr bool kMma = sizeof(T) == 2 && sizeof(W) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_ids[kMaxRows];
  __shared__ int s_rows[kMaxRows];
  __shared__ unsigned s_words[2 * kMaxRows / 32];
  __shared__ int s_info[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = static_cast<int>(cluster.block_rank());
  const int q = blockIdx.x / p.C;
  const int k = q / p.T, t = q % p.T;
  const Layout L = layout<kMma>(p);
  int* first = reinterpret_cast<int*>(smem + L.table);
  float* part = reinterpret_cast<float*>(smem + L.part);

  for (int n = tid; n < p.N; n += kThreads) s_ids[n] = ids[n];
  __syncthreads();
  const int OUT = pick(tg.out_dim, t), cols = pick(tg.cols, t);
  const int o_lo = c * cols, o_hi = min(OUT, o_lo + cols);
  T* out = static_cast<T*>(pick(tg.out, t));
  if (k == 0) {  // slot 0's clusters write the null (zero) and bad-id (NaN) rows
    constexpr int V = 16 / sizeof(T);  // a 16-byte store holds V values
    const uint32_t nan = sizeof(T) == 2 ? 0x7fc07fc0u : 0x7fc00000u;  // quiet NaNs
    for (int n = warp; n < p.N; n += kWarps) {  // a warp a row, 16 bytes a lane
      const int id = s_ids[n];
      if (id > 0 && id < p.NA) continue;
      const uint4 v = id == 0 ? make_uint4(0, 0, 0, 0) : make_uint4(nan, nan, nan, nan);
      for (int col = o_lo + lane * V; col < o_hi; col += 32 * V)
        *reinterpret_cast<uint4*>(out + (size_t)n * OUT + col) = v;
    }
  }
  const int id = find_segment(s_ids, first, s_rows, s_words, s_info, p.N, p.NA, k);
  if (id < 0) return;  // the same in every block of the cluster: none waits on another
  const int count = s_info[1];
  const int i_lo = c * p.IR, i_hi = min(p.IN, i_lo + p.IR);
  const W* a = static_cast<const W*>(pick(tg.a, t)) + (size_t)id * p.IN * p.R;
  const W* b = static_cast<const W*>(pick(tg.b, t)) + (size_t)id * p.R * OUT;
  const int g = lane >> 2, tq = lane & 3;

  if constexpr (kMma) {
    bf16* As = reinterpret_cast<bf16*>(smem + L.as);
    bf16* Xs = reinterpret_cast<bf16*>(smem + L.xs);
    bf16* Th = reinterpret_cast<bf16*>(smem + L.th);
    bf16* Tl = reinterpret_cast<bf16*>(smem + L.tl);
    bf16* Bs = reinterpret_cast<bf16*>(smem + L.bs);
    bf16* Os = reinterpret_cast<bf16*>(smem + L.os);
    const bf16* ab = reinterpret_cast<const bf16*>(a);
    const bf16* bb = reinterpret_cast<const bf16*>(b);
    const bf16* xb = reinterpret_cast<const bf16*>(x);
    const int ap = p.Rp + 8, xp = p.SL + 8, tp = p.Rp + 8, bp = p.OT + 8;
    const int MT = p.Rp / 16;
    auto load_b = [=](int oo) {  // B's rows [0, Rp) x this block's columns [oo, oo + OT)
      const int cpr = p.OT / 8;
      for (int u = tid; u < p.Rp * cpr; u += kThreads) {
        const int r = u / cpr, col = oo + (u % cpr) * 8;
        const bool ok = r < p.R && col < o_hi;
        cp_async16(Bs + r * bp + (u % cpr) * 8, bb + (ok ? (size_t)r * OUT + col : 0), ok);
      }
    };
    auto load_a = [=](int i0) {  // A's rows [i0, i0 + SL) of this block, ranks padded
      if (p.R % 8 == 0) {
        const int cpr = p.R / 8;
        for (int u = tid; u < p.SL * cpr; u += kThreads) {
          const int i = u / cpr, cc = u % cpr;
          const bool ok = i0 + i < i_hi;
          cp_async16(As + i * ap + cc * 8, ab + (ok ? (size_t)(i0 + i) * p.R + cc * 8 : 0), ok);
        }
        const int zpr = (p.Rp - p.R) / 8;
        for (int u = tid; u < p.SL * zpr; u += kThreads)
          *reinterpret_cast<uint4*>(As + (u / zpr) * ap + p.R + (u % zpr) * 8) =
              make_uint4(0, 0, 0, 0);
      } else {  // rows narrower than 16 bytes: element by element
        for (int u = tid; u < p.SL * p.Rp; u += kThreads) {
          const int i = u / p.Rp, r = u % p.Rp;
          As[i * ap + r] = (r < p.R && i0 + i < i_hi) ? ab[(size_t)(i0 + i) * p.R + r]
                                                      : __float2bfloat16(0.f);
        }
      }
    };
    auto load_x = [=](int c0, int rows, int i0) {  // x's chunk rows, columns [i0, i0 + SL)
      const int cpr = p.SL / 8, tiles8 = (rows + 7) / 8 * 8;  // rows the mma tiles read
      for (int u = tid; u < tiles8 * cpr; u += kThreads) {
        const int rho = u / cpr, col = i0 + (u % cpr) * 8;
        const bool ok = rho < rows && col < i_hi;
        cp_async16(Xs + rho * xp + (u % cpr) * 8,
                   xb + (ok ? (size_t)s_rows[c0 + rho] * p.IN + col : 0), ok);
      }
    };
    const bool b_once = o_hi - o_lo <= p.OT;  // the block's columns fit one pass
    const bool a_once = i_hi - i_lo <= p.SL;  // the block's slice fits one pass
    if (b_once && o_lo < o_hi) load_b(o_lo);
    if (a_once && i_lo < i_hi) load_a(i_lo);
    for (int c0 = 0; c0 < count; c0 += kChunk) {
      const int rows = min(kChunk, count - c0);
      const int NT = (rows + 7) / 8;
      // Shrink: warp w owns the (row tile, rank tile) units w, w + 4, ...;
      // each unit's accumulator walks the whole slice in order.
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int i0 = i_lo; i0 < i_hi; i0 += p.SL) {
        if (!a_once) load_a(i0);
        load_x(c0, rows, i0);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        const int KS = (min(p.SL, i_hi - i0) + 15) / 16;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int u = warp + j * kWarps;
          if (u < NT * MT) {
            const int nt = u / MT, mt = u % MT;
            for (int ks = 0; ks < KS; ++ks) {
              uint32_t af[4], b0, b1;
              frag_a_kmajor(As + ks * 16 * ap + mt * 16, ap, lane, af);
              frag_b_nmajor(Xs + nt * 8 * xp + ks * 16, xp, lane, b0, b1);
              mma_bf16(acc[j], af, b0, b1);
            }
          }
        }
        __syncthreads();
      }
      // D[r][rho]: lane (g, tq) holds ranks g, g + 8 of rows 2tq, 2tq + 1.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int u = warp + j * kWarps;
        if (u < NT * MT) {
          const int nt = u / MT, mt = u % MT;
          float* pr = part + (nt * 8 + 2 * tq) * p.Rp + mt * 16 + g;
          pr[0] = acc[j][0];
          pr[p.Rp] = acc[j][1];
          pr[8] = acc[j][2];
          pr[p.Rp + 8] = acc[j][3];
        }
      }
      cluster_arrive();  // every block's partial is complete and visible
      cluster_wait();
      gather_t(p, cluster, part, rows, nullptr, Th, Tl);
      cluster_arrive();  // done reading the others' partials; waited on below
      __syncthreads();
      // Expand: the block's columns in passes of OT; warps split the
      // column tiles of each row tile.
      for (int oo = o_lo; oo < o_hi; oo += p.OT) {
        if (!b_once) load_b(oo);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        const int MO = (min(p.OT, o_hi - oo) + 15) / 16;
        for (int nt = 0; nt < NT; ++nt) {
          for (int m = warp; m < MO; m += kWarps) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            for (int ks = 0; ks < MT; ++ks) {
              uint32_t af[4], h0, h1, l0, l1;
              frag_a_kmajor(Bs + ks * 16 * bp + m * 16, bp, lane, af);
              frag_b_nmajor(Th + nt * 8 * tp + ks * 16, tp, lane, h0, h1);
              frag_b_nmajor(Tl + nt * 8 * tp + ks * 16, tp, lane, l0, l1);
              mma_bf16(d, af, h0, h1);
              mma_bf16(d, af, l0, l1);
            }
            // D[o][rho]: lane (g, tq) holds columns g, g + 8 of rows 2tq, 2tq + 1.
            Os[(2 * tq) * bp + m * 16 + g] = __float2bfloat16(d[0]);
            Os[(2 * tq + 1) * bp + m * 16 + g] = __float2bfloat16(d[1]);
            Os[(2 * tq) * bp + m * 16 + g + 8] = __float2bfloat16(d[2]);
            Os[(2 * tq + 1) * bp + m * 16 + g + 8] = __float2bfloat16(d[3]);
          }
          __syncthreads();
          const int cpr = p.OT / 8, live = min(8, rows - nt * 8);
          for (int u = tid; u < live * cpr; u += kThreads) {
            const int rho = u / cpr, col = oo + (u % cpr) * 8;
            if (col < o_hi)
              *reinterpret_cast<uint4*>(out + (size_t)s_rows[c0 + nt * 8 + rho] * OUT + col) =
                  *reinterpret_cast<const uint4*>(Os + rho * bp + (u % cpr) * 8);
          }
          __syncthreads();
        }
      }
      cluster_wait();  // every block has read this block's partial
    }
  } else {
    float* tf = reinterpret_cast<float*>(smem + L.th);
    for (int c0 = 0; c0 < count; c0 += kChunk) {
      const int rows = min(kChunk, count - c0);
      for (int e = tid; e < kChunk * p.Rp; e += kThreads) {
        const int rho = e / p.Rp, r = e % p.Rp;
        float v = 0.f;
        if (rho < rows && r < p.R) {
          const T* xr = x + (size_t)s_rows[c0 + rho] * p.IN;
          for (int i = i_lo; i < i_hi; ++i)
            v = fmaf(to_f32(xr[i]), to_f32(a[(size_t)i * p.R + r]), v);
        }
        part[e] = v;
      }
      cluster_arrive();
      cluster_wait();
      gather_t(p, cluster, part, rows, tf, nullptr, nullptr);
      cluster_arrive();
      __syncthreads();
      const int w = max(o_hi - o_lo, 0);
      for (int u = tid; u < rows * w; u += kThreads) {
        const int rho = u / w, col = o_lo + u % w;
        const float* tr = tf + rho * p.Rp;
        float v = 0.f;
        for (int r = 0; r < p.R; ++r) v = fmaf(tr[r], to_f32(b[(size_t)r * OUT + col]), v);
        out[(size_t)s_rows[c0 + rho] * OUT + col] = from_f32<T>(v);
      }
      __syncthreads();
      cluster_wait();
    }
  }
}

template <typename T, typename W>
int launch(const void* x, const void* ids, const Targets& tg, const Plan& p,
           cudaStream_t stream) {
  constexpr bool kMma = sizeof(T) == 2 && sizeof(W) == 2;
  auto kern = lora_group_kernel<T, W>;
  const int smem = layout<kMma>(p).total;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  // Above 48 KB with the ~2 KB of static shared memory, and clusters of more
  // than 8 blocks, only by opting in (on the current device).
  if (smem > 40 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (p.C > 8) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.C * p.T * p.slots, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), static_cast<const int*>(ids),
                           tg, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch of the grouped delta: T (1-3) targets sharing x [N, IN] and
// ids [N]; a_i [NA, IN, R], b_i [NA, R, out_i], out_i [N, out_i].
// dtype codes: 0 = float32, 1 = bfloat16. The plan (cluster, slice_rows,
// cols_i, pass_rows, pass_cols, slots) comes from ops/lora_matmul.lora_plan.
// The caller checks shapes, alignment (16-byte bases, IN and every out a
// multiple of 8) and 1 <= R <= 128. Returns the CUDA error of the launch
// (0 on success).
extern "C" int lora_bgmv_group(const void* x, const void* ids, const void* a0, const void* a1,
                               const void* a2, const void* b0, const void* b1, const void* b2,
                               void* o0, void* o1, void* o2, int out0, int out1, int out2,
                               int cols0, int cols1, int cols2, int T, int N, int IN, int R,
                               int NA, int x_dtype, int w_dtype, int cluster, int slice_rows,
                               int pass_rows, int pass_cols, int slots, void* stream) {
  if (N <= 0) return 0;
  const void* as[kMaxTargets] = {a0, a1, a2};
  const void* bs[kMaxTargets] = {b0, b1, b2};
  void* os[kMaxTargets] = {o0, o1, o2};
  const int outs[kMaxTargets] = {out0, out1, out2};
  const int cols[kMaxTargets] = {cols0, cols1, cols2};
  if (T < 1 || T > kMaxTargets || R < 1 || R > 128 || N > kMaxRows || NA < 1 || cluster < 1 ||
      cluster > kMaxCluster || slice_rows % 16 || slice_rows * cluster < IN || pass_rows < 16 ||
      pass_rows % 16 || pass_rows > slice_rows || pass_cols < 16 || pass_cols % 16 ||
      slots < 1 || slots > N)
    return static_cast<int>(cudaErrorInvalidValue);
  Targets tg{};
  for (int i = 0; i < kMaxTargets; ++i) {
    const bool on = i < T;
    if (on && (cols[i] < 16 || cols[i] % 16 || cols[i] * cluster < outs[i]))
      return static_cast<int>(cudaErrorInvalidValue);
    tg.a[i] = on ? as[i] : nullptr;
    tg.b[i] = on ? bs[i] : nullptr;
    tg.out[i] = on ? os[i] : nullptr;
    tg.out_dim[i] = on ? outs[i] : 0;
    tg.cols[i] = on ? cols[i] : 0;
  }
  Plan p{};
  p.N = N;
  p.IN = IN;
  p.R = R;
  p.Rp = (R + 15) / 16 * 16;
  p.NA = NA;
  p.T = T;
  p.C = cluster;
  p.IR = slice_rows;
  p.SL = pass_rows;
  p.OT = pass_cols;
  p.slots = slots;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1) return launch<bf16, bf16>(x, ids, tg, p, st);
  if (x_dtype == 1 && w_dtype == 0) return launch<bf16, float>(x, ids, tg, p, st);
  if (x_dtype == 0 && w_dtype == 1) return launch<float, bf16>(x, ids, tg, p, st);
  if (x_dtype == 0 && w_dtype == 0) return launch<float, float>(x, ids, tg, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
