// What the two bf16 backward kernels on wgmma (flash_bwd_dq.cu,
// flash_bwd_dkv.cu) share, on the building blocks of wgmma_blocks.cuh: the
// swizzled layout of a tile, the loads that bring one, the two kinds of
// product, the split of an accumulator into bf16 hi + lo fragments, the
// store of an accumulator into a strided (B, H, T, D) view, and one
// launch's scalars; the last two, the work items and the rows' terms serve
// their f32 instances (wgmma_tf32.cuh) too.
//
// The products of the backward are
//   s = q.k^T, dp = do.v^T     ss: both operands K-major, summed over the
//                              head's columns
//   dq += ds.k                 rs: ds from registers, k MN-major
//   dv += p^T.do, dk += ds^T.q rs: p^T and ds^T from registers, do and q
//                              MN-major
// (the dk/dv kernel computes s^T = k.q^T and dp^T = v.do^T, so that its
// rows are keys).  One swizzled tile serves both kinds: k in the dq kernel,
// q and do in the dk/dv kernel.  p and ds are split into bf16 hi = rn(x)
// and lo = rn(x - hi) and both halves go through the tensor cores, so the
// products keep them at f32 accuracy, as the TPU kernels keep them in f32.

#pragma once

#include "wgmma_blocks.cuh"

namespace attn_wg {
namespace {

constexpr float kLog2e = 1.4426950408889634f;

// The swizzled layout of a tile at padded head width kDp: kCount atoms of
// kCols columns side by side, each its tile's rows tall, a row kRowBytes
// (64-byte rows at width 32, else 128-byte rows of 64 columns).
template <int kDp>
struct Atoms {
  static constexpr int kCols = kDp == 32 ? 32 : 64;
  static constexpr int kCount = kDp / kCols;
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr uint32_t kSwizzle = kDp == 32 ? 2 : 1;  // 64 B : 128 B
  static constexpr uint32_t kSbo = 8 * kRowBytes;  // 8-row groups
  static_assert(kDp == 32 || kDp % 64 == 0, "head width");
};

// The `rows` x kDp tile at (h, t0, b) of a tensor map into dst, atom by
// atom; its bytes are counted on `bar`.
template <int kDp>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int rows, int h,
                                          int t0, int b) {
  using A = Atoms<kDp>;
#pragma unroll
  for (int a = 0; a < A::kCount; ++a)
    tma_load_4d(dst + a * rows * A::kRowBytes, map, bar, a * A::kCols, h, t0,
                b);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory by one bulk copy, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// d = A.B^T over the kDp columns (ss): A the 64 rows at shared address a of
// a K-major tile whose atoms are a_rows tall, B the kN rows of the K-major
// tile at b (atoms kN tall).  Not committed.
template <int kDp, int kN>
__device__ __forceinline__ void product_ss(float (&d)[kN / 2], uint32_t a,
                                           int a_rows, uint32_t b) {
  using A = Atoms<kDp>;
#pragma unroll
  for (int kk = 0; kk < kDp / 16; ++kk) {
    const int at = 16 * kk / A::kCols;
    const uint32_t in_atom = 2 * (16 * kk % A::kCols);
    Wgmma<kN>::ss(d,
                  make_desc(a + at * a_rows * A::kRowBytes + in_atom, 16,
                            A::kSbo, A::kSwizzle),
                  make_desc(b + at * kN * A::kRowBytes + in_atom, 16, A::kSbo,
                            A::kSwizzle),
                  kk);
  }
}

// d += (hi + lo).B (rs): hi and lo the A fragments of kK / 16 k16 steps, B
// kK rows of an MN-major tile whose atoms are kK tall, kCols columns from
// the atom at b.  Each step adds hi, then lo.  Not committed.
template <int kDp, int kCols, int kK>
__device__ __forceinline__ void product_rs(float (&d)[kCols / 2],
                                           const uint32_t (&hi)[kK / 16][4],
                                           const uint32_t (&lo)[kK / 16][4],
                                           uint32_t b) {
  using A = Atoms<kDp>;
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
    const uint64_t desc = make_desc(b + kk * 16 * A::kRowBytes,
                                    kK * A::kRowBytes, A::kSbo, A::kSwizzle);
    Wgmma<kCols>::rs(d, hi[kk], desc);
    Wgmma<kCols>::rs(d, lo[kk], desc);
  }
}

// An accumulator of kN columns as the bf16 hi and lo A fragments of kN / 16
// k16 steps.
template <int kN>
__device__ __forceinline__ void split_frags(const float (&x)[kN / 2],
                                            uint32_t (&hi)[kN / 16][4],
                                            uint32_t (&lo)[kN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1], hi[kk][e],
                 lo[kk][e]);
}

// A consumer's accumulator (64 rows x kCols columns) into rows row_w + 16
// warp .. of a (b, h) slice at `head` (row stride st), columns col0 .. ,
// as bf16 (rounded to nearest even) or f32; rows past T and columns past D
// are not written.  The accumulator is read outside any branch (a
// divergent read of a wgmma register serialises the wgmmas); the stores
// are predicated.  With `pairs` (D even, rows aligned to two elements) two
// columns a store.
template <typename T>
struct Pair;
template <>
struct Pair<bf16> {
  using Type = __nv_bfloat162;
  static __device__ Type make(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};
template <>
struct Pair<float> {
  using Type = float2;
  static __device__ Type make(float a, float b) { return make_float2(a, b); }
};

template <int kCols, typename T>
__device__ __forceinline__ void store_acc(const float (&acc)[kCols / 2],
                                          T* head, long long st, int row_w,
                                          int rows_T, int col0, int D,
                                          bool pairs, int lane) {
  using P = Pair<T>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    typename P::Type packed[kCols / 8];
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n)
      packed[n] = P::make(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
    const int row = row_w + g + 8 * r;
    if (row >= rows_T) continue;
    T* out = head + row * st;
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      const int d = col0 + 8 * n + 2 * t;
      if (pairs && d + 1 < D) {
        *reinterpret_cast<typename P::Type*>(out + d) = packed[n];
      } else {
        if (d < D) out[d] = packed[n].x;
        if (d + 1 < D) out[d + 1] = packed[n].y;
      }
    }
  }
}

// One backward launch's scalars, its inputs and outputs of element type E
// (bf16, or f32 for the TF32 instances).  Strides are (b, h, t) in
// elements, of (B, H, T, D) views (o and do as views of their (B, T, H, D)
// tensors).
template <typename E>
struct BwdParamsT {
  E* out0;            // dq, or dk
  E* out1;            // dv (the dk/dv kernel)
  const E* o;         // the dq kernel's delta: o and do rows
  const E* dout;
  const float* lse;   // (B, H, T)
  float* rows;        // the dk/dv kernel's (B * H, Tpad) rows of lse *
  float* deltas;      // log2(e) and of delta, zeros past T
  long long so[3], sd[3], s0[3], s1[3];  // o, do, out0, out1
  int H, T, D;
  int Tpad;           // T rounded up to kRowsPad
  float scale;
  float c;            // scale * log2(e)
  int n_items;        // work items a head: row (or key) tiles x groups
  int n_groups;       // column groups a row (or key) tile
  int n_loop;         // tiles an item walks: key tiles (dq), query (dk/dv)
  int total;          // work items
  bool pairs;         // outputs stored two columns at a time
};
using BwdParams = BwdParamsT<bf16>;

__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(float x) { return x; }

// A work item's place: item = (bh * tiles + tile) * n_groups + group.
struct Item {
  int b, h, bh, tile, group;
  template <typename P>
  __device__ Item(const P& p, int item) {
    bh = item / p.n_items;
    const int rest = item - bh * p.n_items;
    tile = rest / p.n_groups;
    group = rest - tile * p.n_groups;
    b = bh / p.H;
    h = bh - b * p.H;
  }
};

// How an instance of kDp columns whose consumers hold kCols columns each
// cuts its work: kCols == kDp, a work item is 128 rows (or keys), 64 a
// consumer, all columns; kCols < kDp (column chunks), a work item is 64
// rows, both consumers on them, consumer c taking chunk 2 * group + c of
// kCols columns (the last chunk again where the chunks are odd in number:
// computed, not stored).
template <int kDp, int kCols>
struct Cut {
  static constexpr bool kSplit = kCols < kDp;
  static constexpr int kRows = kSplit ? 64 : 128;      // rows an item
  static constexpr int kChunks = kDp / kCols;
  static constexpr int kGroups = kSplit ? (kChunks + 1) / 2 : 1;
  static_assert(kDp % kCols == 0, "whole chunks");
  // consumer c's rows in the item, and its chunk (clamped) of group g
  static __device__ int row0(int c) { return kSplit ? 0 : 64 * c; }
  static __device__ int chunk(int g, int c) {
    return kSplit ? min(2 * g + c, kChunks - 1) : 0;
  }
  static __device__ bool stores(int g, int c) {
    return !kSplit || 2 * g + c < kChunks;
  }
};

// lse * log2(e) and delta = sum_d do * o of this thread's rows g and g+8
// from the warp's first row row_w, delta from the o and do rows as the TPU
// kernel computes it at j == 0 (the four lanes of a quad over every fourth
// column); both 0 past T, where ds is then 0.  The dq kernels' rows.
template <typename T>
__device__ __forceinline__ void row_terms(const BwdParamsT<T>& p,
                                          const Item& it,
                                          int row_w, int lane,
                                          float (&lse2)[2],
                                          float (&delta)[2]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_w + g + 8 * r;
    float l2 = 0.f, dl = 0.f;
    if (row < p.T) {
      const T* orow = p.o + it.b * p.so[0] + it.h * p.so[1] + row * p.so[2];
      const T* drow =
          p.dout + it.b * p.sd[0] + it.h * p.sd[1] + row * p.sd[2];
      for (int d = t; d < p.D; d += 4)
        dl = fmaf(to_float(drow[d]), to_float(orow[d]), dl);
      l2 = p.lse[static_cast<long long>(it.bh) * p.T + row] * kLog2e;
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    dl += __shfl_xor_sync(0xffffffffu, dl, 2);
    lse2[r] = l2;
    delta[r] = dl;
  }
}

// The dq kernels' ds = p * (dp - delta) * scale into s, p = exp2(s * c -
// lse2) as one FFMA into ex2; in the first key tile taken (kMasked, keys
// from k0) keys past T get p = 0 by a select.
template <int kN, bool kMasked, typename P>
__device__ __forceinline__ void dq_grads(float (&s)[kN / 2],
                                         const float (&dp)[kN / 2],
                                         const float (&lse2)[2],
                                         const float (&delta)[2],
                                         const P& p, int k0, int t) {
#pragma unroll
  for (int nb = 0; nb < kN / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float x = ex2(fmaf(s[4 * nb + e], p.c, -lse2[r]));
      if constexpr (kMasked)
        x = k0 + 8 * nb + 2 * t + (e & 1) >= p.T ? 0.f : x;
      s[4 * nb + e] = x * (dp[4 * nb + e] - delta[r]) * p.scale;
    }
}

// The dk/dv kernels' p^T into s and ds^T into dp, with the query tile's
// rows of lse * log2(e) (lt) and delta (dt) in shared memory: this
// thread's columns 2t and 2t+1 of every 8.
template <int kNq, typename P>
__device__ __forceinline__ void dkv_grads(float (&s)[kNq / 2],
                                          float (&dp)[kNq / 2],
                                          const float* lt, const float* dt,
                                          const P& p, int t) {
#pragma unroll
  for (int nb = 0; nb < kNq / 8; ++nb) {
    const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * nb + 2 * t);
    const float2 d2 = *reinterpret_cast<const float2*>(dt + 8 * nb + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = ex2(fmaf(s[4 * nb + e], p.c, -(e & 1 ? l2.y : l2.x)));
      s[4 * nb + e] = x;
      dp[4 * nb + e] =
          x * (dp[4 * nb + e] - (e & 1 ? d2.y : d2.x)) * p.scale;
    }
  }
}

// d (+)= A.B^T over one swizzle atom of 64 columns (ss): A the 64 rows of
// the atom at shared address a, B the kN rows of the atom at b, both
// K-major; with `acc` the first step adds to d, else it overwrites d.  The
// streamed instances sum s and dp over D this way, a chunk a stage of the
// ring.  Not committed.
template <int kN>
__device__ __forceinline__ void product_ss_atom(float (&d)[kN / 2],
                                                uint32_t a, uint32_t b,
                                                bool acc) {
  using A = Atoms<64>;
#pragma unroll
  for (int kk = 0; kk < A::kCols / 16; ++kk)
    Wgmma<kN>::ss(d, make_desc(a + 32 * kk, 16, A::kSbo, A::kSwizzle),
                  make_desc(b + 32 * kk, 16, A::kSbo, A::kSwizzle),
                  acc || kk > 0);
}

// How a streamed instance -- the rows past the table's widest width,
// DQ_STREAMED and DKV_STREAMED -- cuts its work: a work item is 64 rows
// (or keys) and a group of two chunks of kCols columns of the gradients,
// both consumers on the same rows, consumer c taking chunk 2 * group + c
// (the last chunk again where the chunks are odd in number: computed, not
// stored).  s and dp are summed over D a 64-column chunk a stage of the
// ring, so nothing in shared memory grows with D.
struct StreamCut {
  int chunks;  // of kCols columns: ceil(D / kCols)
  __device__ int chunk(int group, int c) const {
    return min(2 * group + c, chunks - 1);
  }
  __device__ bool stores(int group, int c) const {
    return 2 * group + c < chunks;
  }
};

// The chunks of 64 columns of the sums over a head of D columns.
__host__ __device__ constexpr int atoms_of(int D) { return (D + 63) / 64; }

// The rows of lse and delta the dk/dv kernel's producer copies are padded
// to a multiple of this many (every query tile divides it), zeros past T.
constexpr int kRowsPad = 128;

}  // namespace
}  // namespace attn_wg
