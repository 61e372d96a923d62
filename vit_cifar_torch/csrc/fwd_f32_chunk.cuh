// The f32 attention forward on the CUDA cores for heads wider than
// kColChunk columns: one tile of kWarps * 8 query rows against every key,
// for one column chunk of the output.  flash_fwd.cu runs one such tile a
// block; mhsa_fwd.cu runs every tile of a head in one block.
//
// For each tile of 64 keys, the logits s = q.k^T are summed over the
// head's column chunks: each chunk of the query rows and of the keys is
// staged in f32 shared memory in turn (keys with a row stride of w+1), and
// each lane keeps its two keys' partial sums for the warp's 8 rows in
// registers.  Then the value tile's output chunk is staged, and the online
// softmax (running max m, normaliser l, the TPU kernel's safe_m/corr guard)
// and o += p.v run as in the un-split f32 kernel.  Every output chunk
// computes the same softmax; the chunk-0 pass writes lse.  Shared memory is
// independent of T and of D.

#pragma once

#include <math_constants.h>

#include <cstdint>

#include "attention_common.cuh"

namespace attn {

constexpr int kChunkRows = 8;                     // query rows per warp
constexpr int kChunkTileQ = kChunkRows * kWarps;  // query rows per tile
constexpr int kChunkTileK = 64;                   // keys per tile: two a lane

// Dynamic shared memory, in floats:
//   Q    kChunkTileQ * kColChunk        (one column chunk of the query rows)
//   K    kChunkTileK * (kColChunk + 1)  (the same chunk of a key tile)
//   V    kChunkTileK * kColChunk        (the output chunk of the key tile)
//   p    kWarps * kChunkTileK           (each warp's row of probabilities)
constexpr size_t fwd_f32_chunk_smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kChunkTileQ) * kColChunk +
          static_cast<size_t>(kChunkTileK) * (kColChunk + 1) +
          static_cast<size_t>(kChunkTileK) * kColChunk + kWarps * kChunkTileK);
}

// Query rows q0 .. q0 + kChunkTileQ - 1 of head bh (= b * H + h), output
// columns [cc * kColChunk, +chunk_width(D, cc)): q, k, v (B, H, T, D) views
// with strides L, out (B, T, H, D), lse (B, H, T) or null.  Every thread of
// the block calls it.
template <typename T>
__device__ __forceinline__ void fwd_f32_chunk_tile(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, const Qkv& L, int H,
    int seq, int D, float scale, int bh, int q0, int cc, float* smem) {
  float* q_s = smem;
  float* k_s = q_s + kChunkTileQ * kColChunk;
  float* v_s = k_s + kChunkTileK * (kColChunk + 1);
  float* p_s = v_s + kChunkTileK * kColChunk;

  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t qo = L.head(0, b, h), ko = L.head(1, b, h);
  const int64_t vo = L.head(2, b, h);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nq = min(kChunkTileQ, seq - q0);
  const int nc = col_chunks(D);
  const int c0 = cc * kColChunk;
  const int wc = chunk_width(D, cc);

  float m[kChunkRows], l[kChunkRows], acc[kChunkRows][kColChunk / 32];
#pragma unroll
  for (int r = 0; r < kChunkRows; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kColChunk / 32; ++c) acc[r][c] = 0.f;
  }

  const int row0 = warp * kChunkRows;  // this warp's first row in the tile
  float* prow = p_s + warp * kChunkTileK;
  for (int k0 = 0; k0 < seq; k0 += kChunkTileK) {
    const int nk = min(kChunkTileK, seq - k0);
    float s[kChunkRows][2];
#pragma unroll
    for (int r = 0; r < kChunkRows; ++r) s[r][0] = s[r][1] = 0.f;
    for (int e = 0; e < nc; ++e) {
      const int w = chunk_width(D, e);
      const int ks = w + 1;
      const int col = e * kColChunk;
      __syncthreads();  // the previous chunk (or tile) is no longer read
      for (int i = threadIdx.x; i < nq * w; i += kThreads) {
        const int r = i / w;
        q_s[i] = to_f32(q[qo + (q0 + r) * L.st[0] + col + i - r * w]);
      }
      for (int i = threadIdx.x; i < nk * w; i += kThreads) {
        const int j = i / w;
        const int d = i - j * w;
        k_s[j * ks + d] = to_f32(k[ko + (k0 + j) * L.st[1] + col + d]);
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kChunkRows; ++r) {
        if (row0 + r >= nq) break;  // warp-uniform: rows past T
        const float* qrow = q_s + (row0 + r) * w;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = lane + 32 * half;
          if (j < nk) {
            const float* krow = k_s + j * ks;
            float a = 0.f;
            for (int d = 0; d < w; ++d) a = fmaf(qrow[d], krow[d], a);
            s[r][half] += a;
          }
        }
      }
    }
    // every thread is past the syncs above, so the previous tile's V and p
    // are no longer read
    for (int i = threadIdx.x; i < nk * wc; i += kThreads) {
      const int j = i / wc;
      v_s[i] = to_f32(v[vo + (k0 + j) * L.st[2] + c0 + i - j * wc]);
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kChunkRows; ++r) {
      if (row0 + r >= nq) break;  // warp-uniform: rows past T
      const float s0 = lane < nk ? s[r][0] * scale : -CUDART_INF_F;
      const float s1 = lane + 32 < nk ? s[r][1] * scale : -CUDART_INF_F;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      // a tile of -inf logits keeps m at -inf; exp(-inf - -inf) would be NaN
      const float safe_m = isfinite(m_new) ? m_new : 0.f;
      const float corr = isfinite(m[r]) ? expf(m[r] - safe_m) : 0.f;
      const float p0 = expf(s0 - safe_m);  // missing keys: exp(-inf) = 0
      const float p1 = expf(s1 - safe_m);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
      prow[lane] = p0;
      prow[lane + 32] = p1;
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kColChunk / 32; ++c) {
        const int d = lane + 32 * c;
        if (d < wc) {
          float a = acc[r][c] * corr;
          for (int j = 0; j < nk; ++j) a = fmaf(prow[j], v_s[j * wc + d], a);
          acc[r][c] = a;
        }
      }
      __syncwarp();  // prow is rewritten for the next row
    }
  }

#pragma unroll
  for (int r = 0; r < kChunkRows; ++r) {
    const int i = q0 + row0 + r;
    if (i >= seq) break;
    T* orow = out + ((static_cast<int64_t>(b) * seq + i) * H + h) * D + c0;
#pragma unroll
    for (int c = 0; c < kColChunk / 32; ++c) {
      const int d = lane + 32 * c;
      if (d < wc) orow[d] = from_f32<T>(acc[r][c] / l[r]);
    }
    if (lse != nullptr && cc == 0 && lane == 0)
      lse[static_cast<int64_t>(bh) * seq + i] = m[r] + logf(l[r]);
  }
}

}  // namespace attn
