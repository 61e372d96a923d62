// The bf16 attention forward for heads wider than 512 columns, past the
// widest head the wgmma forward (wgmma_attention.cuh) holds, in one pass
// or in column chunks (forward_tiles.cuh): its q at full width and two
// stages of the ring no longer fit shared memory.  One block of 4 warps per
// (b, h, 64 query rows, 128-column output chunk) on the tensor cores
// (mma.sync, mma_attention.cuh).  flash_fwd.cu and mhsa_fwd.cu both launch
// it there.
//
// The logits are summed over the head's 128-column chunks, one staged
// chunk of K (and of q, read from device memory) at a time, and the block
// accumulates only its own chunk of o, so every output chunk recomputes the
// softmax.  Each 64-key tile takes ceil(D/128) pipeline steps, one K chunk
// each (two stages by cp.async), the block's own chunk last, whose step
// also stages the V chunk.  Shared memory does not grow with T or D.

#pragma once

#include <cstdint>

#include "attention_common.cuh"
#include "mma_attention.cuh"

namespace attn {

constexpr int kChunkMmaWarps = 4;
constexpr int kChunkMmaTileQ = 16 * kChunkMmaWarps;  // query rows a block
constexpr int kChunkMmaThreads = 32 * kChunkMmaWarps;

// Dynamic shared memory, in bf16: 8 zeros (the chunk that rows past a tile
// and columns past D read), then two stages, each a K chunk and a V chunk
// of kChunk rows of stride_elems(kColChunk).
inline size_t chunk_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         (8 + 4 * static_cast<size_t>(attn_mma::kChunk) *
                  attn_mma::stride_elems(kColChunk));
}

__global__ void __launch_bounds__(kChunkMmaThreads)
    fwd_chunk_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, Qkv L, int H, int seq,
                         int D, float c, bool vec) {
  using namespace attn_mma;
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf16[];
  const int tile = kChunk * stride_elems(kColChunk);
  __nv_bfloat16* zeros = smem_bf16;
  __nv_bfloat16* ring = smem_bf16 + 8;  // stage i: K at + 2i*tile, then V

  const int tiles = (seq + kChunkMmaTileQ - 1) / kChunkMmaTileQ;
  const int bh = blockIdx.x / tiles;  // b * H + h
  const int q0 = (blockIdx.x - bh * tiles) * kChunkMmaTileQ;
  const int b = bh / H;
  const int h = bh - b * H;
  const bf16* qh = q + L.head(0, b, h);
  const bf16* kh = k + L.head(1, b, h);
  const bf16* vh = v + L.head(2, b, h);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + 16 * warp;
  const bool active = row0 < seq;  // warp-uniform
  const int nc = col_chunks(D);
  const int cc = blockIdx.y;  // the block's output chunk
  const int c0 = cc * kColChunk;
  const int wc = chunk_width(D, cc);

  // step i: key tile i / nc against column chunk (cc + 1 + i % nc) % nc, so
  // that a tile's last step is the block's own chunk, which also stages the
  // tile's V chunk
  auto chunk_of = [&](int i) { return (cc + 1 + i % nc) % nc; };
  auto stage = [&](int i) {
    const int k0 = i / nc * kChunk;
    const int n = min(kChunk, seq - k0);
    const int e = chunk_of(i);
    __nv_bfloat16* dst = ring + (i & 1) * 2 * tile;
    stage_rows(dst, kh + k0 * L.st[1] + e * kColChunk, L.st[1], n,
               chunk_width(D, e), vec, threadIdx.x, kChunkMmaThreads);
    if (e == cc)
      stage_rows(dst + tile, vh + k0 * L.st[2] + c0, L.st[2], n, wc, vec,
                 threadIdx.x, kChunkMmaThreads);
    cp_async_commit();
  };

  const int steps = (seq + kChunk - 1) / kChunk * nc;
  stage(0);
  if (threadIdx.x < 8) zeros[threadIdx.x] = __float2bfloat16(0.f);
  RowTile<kColChunk> st;  // st.q holds one chunk of q at a time
  clear_rows(st);
  float s[kChunk / 8][4];
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) {
      stage(i + 1);  // its buffer was last read before the previous sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step i has landed for every thread
    if (active) {
      const int n = min(kChunk, seq - i / nc * kChunk);
      const int e = chunk_of(i);
      const int we = chunk_width(D, e);
      const __nv_bfloat16* kt = ring + (i & 1) * 2 * tile;
      if (i % nc == 0) {
#pragma unroll
        for (int nb = 0; nb < kChunk / 8; ++nb)
#pragma unroll
          for (int x = 0; x < 4; ++x) s[nb][x] = 0.f;
      }
      load_rows_a<kColChunk>(st.q, qh + e * kColChunk, L.st[0], row0, seq,
                             we, lane);
      chunk_logits<kColChunk>(s, st.q, kt, 0, n, n, we, zeros, lane);
      if (e == cc)
        softmax_pv<kColChunk>(st, s, kt + tile, 0, n, n, wc, zeros, c, lane);
    }
    __syncthreads();  // step i is no longer read
  }
  if (active)
    finish_rows(st, out + c0, cc == 0 ? lse : nullptr, b, h, H, bh, row0, seq,
                D, wc, lane);
}

// Launches the kernel on (B, H, T, D) views with strides L (in elements);
// c = scale * log2(e).  Rows are staged by 16-byte cp.async where every row
// of k and v starts 16-byte aligned, else element by element.
inline cudaError_t launch_chunk_mma(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    const Qkv& L, int B, int H, int seq,
                                    int D, float scale, cudaStream_t stream) {
  bool vec = attn_mma::can_copy_chunks(D, k, v);
  for (int x = 1; x < 3; ++x)
    vec = vec && L.sb[x] % 8 == 0 && L.sh[x] % 8 == 0 && L.st[x] % 8 == 0;
  const int tiles = (seq + kChunkMmaTileQ - 1) / kChunkMmaTileQ;
  return launch_with_smem(
      fwd_chunk_mma_kernel, dim3(B * H * tiles, col_chunks(D)),
      kChunkMmaThreads, chunk_mma_smem_bytes(), stream,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), L, H, seq, D, scale * attn_mma::kLog2e, vec);
}

}  // namespace attn
