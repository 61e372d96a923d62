// mma.sync building blocks of the bf16 attention kernels that are not on
// wgmma (the column-chunk kernels of the tiled backward pair past 512
// columns, in flash_bwd_dq.cu and flash_bwd_dkv.cu, and of the forward past
// 512 columns, fwd_bf16_chunk.cuh): cp.async staging of rows as bf16 in
// shared memory, ldmatrix fragments, mma.sync.m16n8k16 (bf16 in, f32
// accumulate), the two products every kernel is made of (a 16-row tile
// against 16 staged rows transposed, and an accumulator tile split into
// bf16 hi + lo times 16 staged rows), and the online softmax of one warp's
// 16 query rows over a chunk of up to 64 keys.
//
// Fragment layout (PTX ISA, mma.m16n8k16 with .bf16): lane = 4g + t.  A
// (16 rows x 16 k) holds (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
// (g+8, 2t+8..); B (16 k x 8 cols) holds (2t..2t+1, g) and (2t+8.., g); the
// f32 accumulator (16 x 8) holds (g, 2t..2t+1) and (g+8, 2t..2t+1).  So a
// thread owns two rows, g and g+8, and a row's max or sum over a tile
// reduces over the four lanes of a quad.  Two accumulator tiles side by
// side (16 x 16) are, element for element, the A fragment of a 16 x 16
// matrix: that is how p and ds go from one product into the next.
//
// Numerics.  s = q.k^T is exact bf16 products summed in f32.  The logits
// are scaled once by scale*log2(e), so that every exp is one exp2f; lse is
// returned in natural log.  p (and in the backward ds) stays f32; for the
// product that follows it is split into bf16 hi = rn(p) and lo =
// rn(p - hi), and both halves go through the tensor cores, so the product
// carries about 16 bits of p instead of bf16's 8 -- the TPU kernels keep
// p and ds in f32.
//
// Staged matrices.  A (n, D) matrix is staged as n rows of W = D rounded up
// to 8 columns (zero past D) with a row stride of an odd number of 16-byte
// chunks (stride_elems), so the 8 row addresses of one ldmatrix fall in 8
// different bank groups.  Rows past n and 8-column chunks past W are never
// stored: their ldmatrix addresses point at one 16-byte chunk of zeros.

#pragma once

#include <cuda_bf16.h>
#include <math_constants.h>

#include <cstdint>

namespace attn_mma {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 64;  // keys per online-softmax step
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// D rounded up to 8: the columns a staged row holds.
__host__ __device__ constexpr int staged_width(int D) {
  return (D + 7) / 8 * 8;
}

// The row stride of a staged matrix in elements: an odd number of 16-byte
// chunks, at most staged_width(D) + 8.
__host__ __device__ constexpr int stride_elems(int D) {
  return 8 * ((staged_width(D) / 8) | 1);
}

// Whether matrices can be staged by cp.async in whole 16-byte chunks: rows
// of D % 8 == 0 elements (so any row stride that is a multiple of D keeps
// them aligned) from 16-byte aligned bases (else stage_rows copies element
// by element).
template <typename... Ptr>
bool can_copy_chunks(int D, const Ptr*... bases) {
  return D % 8 == 0 &&
         ((reinterpret_cast<uintptr_t>(bases) | ...) % 16) == 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a.b, m16n8k16, bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (a, b) -> bf16 hi = rn(a, b) and lo = rn(a - hi, b - hi), packed with a
// in the low half as the fragments want it.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// Stages rows [0, n) of the matrix at g (already offset to its first row;
// rows ld elements apart, D columns) into s, row stride stride_elems(D),
// columns [0, staged_width(D)), zero past D.  With vec (can_copy_chunks)
// every row is D / 8 cp.async copies of 16 bytes, which the caller commits
// and waits for; otherwise it is element by element.
__device__ __forceinline__ void stage_rows(bf16* s, const bf16* __restrict__ g,
                                           int64_t ld, int n, int D, bool vec,
                                           int tid, int nthreads) {
  const int stride = stride_elems(D);
  if (vec) {
    const int per_row = D / 8;
    for (int i = tid; i < n * per_row; i += nthreads) {
      const int r = i / per_row;
      const int c = i - r * per_row;
      cp_async16(s + r * stride + 8 * c, g + r * ld + 8 * c);
    }
  } else {
    const int W = staged_width(D);
    for (int i = tid; i < n * W; i += nthreads) {
      const int r = i / W;
      const int d = i - r * W;
      s[r * stride + d] = d < D ? g[r * ld + d] : __float2bfloat16(0.f);
    }
  }
}

// The running state of one warp's 16 query rows: q's A fragments (kDp / 16
// of them, zero past D and past the sequence), the unnormalised context o
// (kDp / 8 accumulators), and for rows g and g+8 the running max m (in
// log2 units) and this thread's share l of the normaliser.
template <int kDp>
struct RowTile {
  uint32_t q[kDp / 16][4];
  float o[kDp / 8][4];
  float m[2];
  float l[2];
};

// The A fragments of rows row0 .. row0+15 of the (n, D) matrix at g (rows
// ld elements apart), straight from device memory (each thread reads its own
// pairs); zero past D and past n.
template <int kDp>
__device__ __forceinline__ void load_rows_a(uint32_t (&a)[kDp / 16][4],
                                            const bf16* __restrict__ g,
                                            int64_t ld, int row0, int n,
                                            int D, int lane) {
  const int g4 = lane >> 2, t = lane & 3;
  const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int kc = 0; kc < kDp / 16; ++kc) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + g4 + ((e & 1) << 3);
      const int d = 16 * kc + 2 * t + ((e >> 1) << 3);
      const bf16* p = g + r * ld + d;
      const bool row_ok = r < n;
      a[kc][e] = as_u32(__halves2bfloat162(
          row_ok && d < D ? p[0] : zero, row_ok && d + 1 < D ? p[1] : zero));
    }
  }
}

// Clears the running state of a tile: o, m and l.
template <int kDp>
__device__ __forceinline__ void clear_rows(RowTile<kDp>& st) {
#pragma unroll
  for (int n = 0; n < kDp / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[n][e] = 0.f;
  st.m[0] = st.m[1] = -CUDART_INF_F;
  st.l[0] = st.l[1] = 0.f;
}

// The shared-memory address of columns [8c, 8c+8) of row r of a staged
// matrix of n rows; rows past n and chunks past its width read zeros.
__device__ __forceinline__ const bf16* chunk_at(const bf16* s, int r, int c,
                                                int n, int D,
                                                const bf16* zeros) {
  return (r < n && 8 * c < staged_width(D)) ? s + r * stride_elems(D) + 8 * c
                                            : zeros;
}

// c0, c1 += a . s[j0 .. j0+15]^T: the 16-row tile whose A fragments are a
// against rows j0 .. j0+15 of a staged matrix of n rows, over kDp columns;
// c0 holds the products with rows j0 .. j0+7, c1 with j0+8 .. j0+15.
// Matrix i of each x4 load is rows j0 + 8(i/2).., column half i%2.
template <int kDp>
__device__ __forceinline__ void mma_a_bt(float (&c0)[4], float (&c1)[4],
                                         const uint32_t (&a)[kDp / 16][4],
                                         const bf16* s, int j0, int n, int D,
                                         const bf16* zeros, int lane) {
  const int r = j0 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
  for (int kc = 0; kc < kDp / 16; ++kc) {
    uint32_t b[4];
    ldmatrix_x4(b, chunk_at(s, r, 2 * kc + ((lane >> 3) & 1), n, D, zeros));
    mma_bf16(c0, a[kc], b[0], b[1]);
    mma_bf16(c1, a[kc], b[2], b[3]);
  }
}

// acc += p . s[j0 .. j0+15]: the 16 x 16 f32 tile p (its columns j0 ..
// j0+7 in p0, j0+8 .. j0+15 in p1, as mma_a_bt leaves them), split into
// bf16 hi + lo, times rows j0 .. j0+15 of a staged matrix of n rows, all
// kDp columns.  Matrix i of each x4.trans load is rows j0 + 8(i%2)..,
// column block 16nd + 8(i/2)..
template <int kDp>
__device__ __forceinline__ void mma_p_b(float (&acc)[kDp / 8][4],
                                        const float (&p0)[4],
                                        const float (&p1)[4], const bf16* s,
                                        int j0, int n, int D,
                                        const bf16* zeros, int lane) {
  uint32_t hi[4], lo[4];
  split_bf16(p0[0], p0[1], hi[0], lo[0]);
  split_bf16(p0[2], p0[3], hi[1], lo[1]);
  split_bf16(p1[0], p1[1], hi[2], lo[2]);
  split_bf16(p1[2], p1[3], hi[3], lo[3]);
  const int r = j0 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int nd = 0; nd < kDp / 16; ++nd) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, chunk_at(s, r, 2 * nd + (lane >> 4), n, D, zeros));
    mma_bf16(acc[2 * nd], hi, b[0], b[1]);
    mma_bf16(acc[2 * nd], lo, b[0], b[1]);
    mma_bf16(acc[2 * nd + 1], hi, b[2], b[3]);
    mma_bf16(acc[2 * nd + 1], lo, b[2], b[3]);
  }
}

// s += a . k[j0 .. j0+nk-1]^T for the 16-row tile whose A fragments are a,
// against keys j0 .. j0+nk-1 (nk <= kChunk) of the staged K (n rows), over
// kDp columns: s[nb] holds keys j0 + 8nb .. j0 + 8nb + 7.  Groups of 16 keys
// past nk are not computed.
template <int kDp>
__device__ __forceinline__ void chunk_logits(float (&s)[kChunk / 8][4],
                                             const uint32_t (&a)[kDp / 16][4],
                                             const bf16* k_s, int j0, int nk,
                                             int n, int D, const bf16* zeros,
                                             int lane) {
  const int groups = (nk + 15) / 16;  // groups of 16 keys holding a key
#pragma unroll
  for (int kb = 0; kb < kChunk / 16; ++kb) {
    if (kb >= groups) break;  // warp-uniform
    mma_a_bt<kDp>(s[2 * kb], s[2 * kb + 1], a, k_s, j0 + 16 * kb, n, D,
                  zeros, lane);
  }
}

// The online-softmax step that follows chunk_logits: scale the logits s
// into log2 units (c = scale*log2(e)), mask keys past nk, update the running
// max and normaliser, rescale o, and o += p.v[j0 .. j0+nk-1] with p = hi + lo
// (V staged with n rows and D columns).
template <int kDp>
__device__ __forceinline__ void softmax_pv(RowTile<kDp>& st,
                                           float (&s)[kChunk / 8][4],
                                           const bf16* v_s, int j0, int nk,
                                           int n, int D, const bf16* zeros,
                                           float c, int lane) {
  const int t = lane & 3;
  const int groups = (nk + 15) / 16;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int nb = 0; nb < kChunk / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * nb + 2 * t + (e & 1);
      const float x = key < nk ? s[nb][e] * c : -CUDART_INF_F;
      s[nb][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(st.m[i], mx[i]);
    // a chunk of -inf logits keeps m at -inf; exp2(-inf - -inf) would be NaN
    const float safe_m = isfinite(m_new) ? m_new : 0.f;
    corr[i] = isfinite(st.m[i]) ? exp2f(st.m[i] - safe_m) : 0.f;
    st.m[i] = m_new;
    mx[i] = safe_m;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < kChunk / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[nb][e] - mx[e >> 1]);  // masked: exp2(-inf) = 0
      s[nb][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) st.l[i] = st.l[i] * corr[i] + sum[i];
#pragma unroll
  for (int n2 = 0; n2 < kDp / 8; ++n2) {
    st.o[n2][0] *= corr[0];
    st.o[n2][1] *= corr[0];
    st.o[n2][2] *= corr[1];
    st.o[n2][3] *= corr[1];
  }

  // o += p.v with p = hi + lo
#pragma unroll
  for (int kb = 0; kb < kChunk / 16; ++kb) {
    if (kb >= groups) break;  // warp-uniform
    mma_p_b<kDp>(st.o, s[2 * kb], s[2 * kb + 1], v_s, j0 + 16 * kb, n, D,
                 zeros, lane);
  }
}

// o / l for the tile's rows below seq, written to out (B, T, H, D) bf16 at
// (b, row, h), columns [0, width) (out offset to the tile's first column;
// width = D unless o holds one column chunk); lse (B, H, T) f32 at
// bh * seq + row unless it is null.
template <int kDp>
__device__ __forceinline__ void finish_rows(RowTile<kDp>& st,
                                            bf16* __restrict__ out,
                                            float* __restrict__ lse, int b,
                                            int h, int H, int bh, int row0,
                                            int seq, int D, int width,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = st.l[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + g + 8 * i;
    if (row >= seq) continue;
    bf16* orow = out + ((static_cast<int64_t>(b) * seq + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < kDp / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < width) orow[d] = __float2bfloat16(st.o[n][2 * i] / l);
      if (d + 1 < width)
        orow[d + 1] = __float2bfloat16(st.o[n][2 * i + 1] / l);
    }
    if (lse != nullptr && t == 0)
      lse[static_cast<int64_t>(bh) * seq + row] = st.m[i] * kLn2 + logf(l);
  }
}

// For the tile's rows g and g+8 (row0 + g + 8i below n), the sum over the
// D columns of x (A fragments, as load_a gives them) times the same rows of
// y (device memory, rows ld elements apart, offset to row 0), in f32; 0
// for rows past n.  The quad of lanes that shares a row holds all its
// columns.
template <int kDp>
__device__ __forceinline__ void rows_dot(float (&out)[2],
                                         const uint32_t (&x)[kDp / 16][4],
                                         const bf16* __restrict__ y,
                                         int64_t ld, int row0, int n, int D,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  out[0] = out[1] = 0.f;
#pragma unroll
  for (int kc = 0; kc < kDp / 16; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e & 1;
      const int r = row0 + g + 8 * i;
      const int d = 16 * kc + 2 * t + ((e >> 1) << 3);
      if (r >= n) continue;
      // a bf16 is the top half of the f32 of the same value
      const float x0 = __uint_as_float(x[kc][e] << 16);
      const float x1 = __uint_as_float(x[kc][e] & 0xffff0000u);
      const bf16* yr = y + r * ld + d;
      if (d < D) out[i] = fmaf(x0, __bfloat162float(yr[0]), out[i]);
      if (d + 1 < D) out[i] = fmaf(x1, __bfloat162float(yr[1]), out[i]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    out[i] += __shfl_xor_sync(0xffffffffu, out[i], 1);
    out[i] += __shfl_xor_sync(0xffffffffu, out[i], 2);
  }
}

// Writes the accumulator tile acc (16 rows x kDp columns) as bf16 to rows
// row0 .. row0+15 below n of the (n, D) matrix at out, rows ld elements
// apart; rows past n and columns past D are not written.
template <int kDp>
__device__ __forceinline__ void store_rows(const float (&acc)[kDp / 8][4],
                                           bf16* __restrict__ out, int64_t ld,
                                           int row0, int n, int D, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r >= n) continue;
    bf16* orow = out + r * ld;
#pragma unroll
    for (int nb = 0; nb < kDp / 8; ++nb) {
      const int d = 8 * nb + 2 * t;
      if (d < D) orow[d] = __float2bfloat16(acc[nb][2 * i]);
      if (d + 1 < D) orow[d + 1] = __float2bfloat16(acc[nb][2 * i + 1]);
    }
  }
}

}  // namespace attn_mma
