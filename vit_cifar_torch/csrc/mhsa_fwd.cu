// Fused multi-head self-attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel vit_cifar_tpu/ops/pallas/attention.py::_mhsa_kernel
// in both its variants: the inference one (kernel3, reached through
// fused_attention) and the training one (kernel3l, reached through the
// custom VJP's _fwd), which also writes the row logsumexp.  For every
// (batch, head): s = q.k^T * scale, p = exp(s - rowmax), o = (p / rowsum).v,
// with f32 softmax and sums whatever the input type, and o is written in the
// (B, T, H, D) layout that fused_attention returns.  When `lse` is given,
// each row also writes lse = rowmax + log(rowsum) in f32, the one residual
// the backward kernels (the tiled flash_bwd_dq.cu and flash_bwd_dkv.cu, as
// the TPU kernel's custom VJP runs them) need besides q, k, v and o.  It is
// (B, H, T), not the TPU's lane-broadcast (B, H, Tp, 128).
//
// What bounds it on this card: at the model's shape (T=65, head_dim=32) one
// head is two 65x65x32 products, about 0.5 MFLOP against 12 KB of q/k/v in
// bf16, some 45 FLOP per byte -- under the ~295 FLOP/byte at which the
// tensor cores and not device memory become the limit, so the bound is the
// bytes.  The design keeps the (H, T, T) logits out of device memory: one
// block per (b, h) stages the head's K and V in shared memory once, and
// device memory sees only q, k, v in and the context (and lse) out.  What
// held the first version back was not the bytes but the shared-memory
// loads of its f32 FMAs, and a key loop of 32 lanes over 65 keys whose last
// pass had one lane working.  So the bf16 instance moves the arithmetic
// into registers and onto the tensor cores:
//
//   bf16 (dtype 1), on the tensor cores (mma_attention.cuh).  K and V are
//   staged once as bf16 with cp.async, rows an odd number of 16-byte chunks
//   apart (ldmatrix without bank conflicts), nothing past T stored: keys
//   past T read a chunk of zeros.  The block has one warp per 16-row query
//   tile, at most 8 (at T=65: five warps, one tile each), and a warp takes
//   the tiles w, w + warps, ...  A tile's q are mma A fragments read from
//   device memory; it walks the keys in chunks of 64 with the online
//   softmax on the accumulator fragments -- s = q.k^T and o += p.v on
//   mma.sync.m16n8k16, p split into bf16 hi + lo so that p.v keeps p at
//   f32 accuracy as the TPU kernel does, scale*log2(e) folded into one
//   multiply so that each exp is one exp2f, lse returned in natural log.
//   Rows past T are zero rows that are never written.  Its shared memory,
//   4 * T * stride_elems(D) + 16 bytes, is never more than the f32
//   formula's 4 * (T * (D + 1) + T * D + 8 * D + 8 * T), which
//   mhsa_fwd_smem_bytes reports and the router reads: stride_elems(D) is
//   8 for D <= 8 and at most D + 15 beyond, and 4 * (D + 15) <= 8 * D + 36
//   for D >= 6.
//
//   f32 (dtype 0), on the CUDA cores.  The tensor cores would take f32 only
//   as TF32, whose 10-bit mantissa breaks the 1e-5 the f32 path is held
//   to; so f32 keeps the first design: K (row stride D+1) and V in f32
//   shared memory, kWarps warps, warp w taking the query rows w,
//   w + kWarps, ..., lanes over keys for the logits (max and sum by warp
//   shuffles), then lanes over D for p.v.  This is a dispatch by dtype,
//   not a fallback.
//
// Heads wider than kColChunk = 128 columns (the TPU kernel pads D to a
// multiple of 128 and holds such heads too) keep one block per (b, h), and
// cut the head into column chunks of 128; each output chunk is one pass
// that recomputes the softmax, its logits summed over the chunks.
//   bf16: K and V are staged whole, each as ceil(D/128) matrices of T rows
//   (one per column chunk, 136 elements a row), so that the mma helpers of
//   a 128-column head apply; a warp's q fragments of a chunk are read from
//   device memory for every 64 keys.  Shared memory 2 * (8 + 2 * T *
//   (136 * (ceil(D/128) - 1) + stride_elems(last chunk))) bytes: at D=192
//   T <= 279, at D=256 T <= 213, at D=384 T <= 142.
//   f32: K and V in f32 would not fit, so the block walks them in tiles of
//   64 keys with the online softmax, every 64 query rows and column chunk
//   in turn (fwd_f32_chunk.cuh, the tile flash_fwd.cu runs a block):
//   100,608 bytes of shared memory at any T.
//
// Past the whole head: where the layouts above need more shared memory
// than a block may have (T > 792 at head_dim 32, > 215 at 128, > 279 at
// 192), the block still takes the whole (b, h), as the TPU kernel does at
// any T, but walks K and V in tiles of 64 keys instead of staging them
// whole.  The f32 instance is the key-tile walk above at any D.  The bf16
// instance takes the block's 8 warps over groups of 128 query rows; for each
// group it stages every key tile in turn (K, and V by the output's column
// chunk past 128 columns) with cp.async and runs the same online-softmax
// step on it.  K and V are read once per query-row group and column chunk:
// a simple loop, slower than flash_fwd.cu's grid of query tiles, which is
// the default route there.  Shared memory does not grow with T
// (mhsa_fwd_key_tiled_smem_bytes).
//
// Built by vit_cifar_torch/ops/cuda/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C function mhsa_fwd below (ctypes).

#include <math_constants.h>

#include <cstdint>

#include "attention_common.cuh"
#include "fwd_f32_chunk.cuh"
#include "mma_attention.cuh"

namespace {

using namespace attn;

// ---- f32: the CUDA-core instance -----------------------------------------
// Dynamic shared memory, in floats:
//   K    T * (D + 1)   (padded row stride against bank conflicts)
//   V    T * D
//   q    kWarps * D    (this warp's query row)
//   p    kWarps * T    (this warp's logits, then probabilities)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mhsa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    float* __restrict__ lse, int H, int seq, int D,
                    float scale) {
  extern __shared__ float smem[];
  const int ks = D + 1;
  float* k_s = smem;
  float* v_s = k_s + seq * ks;
  float* q_s = v_s + seq * D;
  float* p_s = q_s + kWarps * D;

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t head = static_cast<int64_t>(bh) * seq * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < seq * D; i += kThreads) {
    const int j = i / D;
    const int d = i - j * D;
    k_s[j * ks + d] = to_f32(k[head + i]);
    v_s[i] = to_f32(v[head + i]);
  }
  __syncthreads();

  float* qrow = q_s + warp * D;
  float* prow = p_s + warp * seq;
  for (int i = warp; i < seq; i += kWarps) {
    for (int d = lane; d < D; d += 32) qrow[d] = to_f32(q[head + i * D + d]);
    __syncwarp();

    float m = -CUDART_INF_F;
    for (int j = lane; j < seq; j += 32) {
      const float* krow = k_s + j * ks;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
      s *= scale;
      prow[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);

    float l = 0.f;
    for (int j = lane; j < seq; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < seq; j += 32) prow[j] /= l;
    if (lse != nullptr && lane == 0)
      lse[static_cast<int64_t>(bh) * seq + i] = m + logf(l);
    __syncwarp();

    T* orow = out + ((static_cast<int64_t>(b) * seq + i) * H + h) * D;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < seq; ++j) acc = fmaf(prow[j], v_s[j * D + d], acc);
      orow[d] = from_f32<T>(acc);
    }
    __syncwarp();  // qrow and prow are rewritten for the next row
  }
}

size_t smem_bytes(int seq, int D) {
  return sizeof(float) * (static_cast<size_t>(seq) * (D + 1) +
                          static_cast<size_t>(seq) * D + kWarps * D +
                          kWarps * seq);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int H, int seq, int D, float scale,
                   cudaStream_t stream) {
  return launch_with_smem(
      mhsa_fwd_kernel<T>, B * H, kThreads, smem_bytes(seq, D), stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, seq, D, scale);
}

// ---- bf16: the tensor-core instance --------------------------------------
// Dynamic shared memory, in bf16: 8 zeros (the chunk that keys past T and
// columns past D read), then K and V, T rows of stride_elems(D) each.
size_t mma_smem_bytes(int seq, int D) {
  return sizeof(__nv_bfloat16) *
         (8 + 2 * static_cast<size_t>(seq) * attn_mma::stride_elems(D));
}

template <int kDp>
__global__ void __launch_bounds__(kThreads)
    mhsa_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, int H, int seq, int D,
                        float c, bool vec) {
  using namespace attn_mma;
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf16[];
  __nv_bfloat16* zeros = smem_bf16;
  __nv_bfloat16* k_s = smem_bf16 + 8;
  __nv_bfloat16* v_s = k_s + seq * stride_elems(D);

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t head = static_cast<int64_t>(bh) * seq * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;

  stage_rows(k_s, k + head, D, seq, D, vec, threadIdx.x, blockDim.x);
  stage_rows(v_s, v + head, D, seq, D, vec, threadIdx.x, blockDim.x);
  cp_async_commit();
  if (threadIdx.x < 8) zeros[threadIdx.x] = __float2bfloat16(0.f);
  cp_async_wait<0>();
  __syncthreads();

  for (int row0 = 16 * warp; row0 < seq; row0 += 16 * warps) {
    RowTile<kDp> st;
    start_rows(st, q + head, row0, seq, D, lane);
    for (int j0 = 0; j0 < seq; j0 += kChunk)
      attend_chunk(st, k_s, v_s, j0, min(kChunk, seq - j0), seq, D, zeros, c,
                   lane);
    finish_rows(st, out, lse, b, h, H, bh, row0, seq, D, D, lane);
  }
}

template <int kDp>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       void* lse, int B, int H, int seq, int D, float scale,
                       cudaStream_t stream) {
  // one warp per 16-row query tile, at most kWarps
  const int warps = min((seq + 15) / 16, kWarps);
  const bool vec = attn_mma::can_copy_chunks(D, k, v);
  return launch_with_smem(
      mhsa_fwd_mma_kernel<kDp>, B * H, 32 * warps, mma_smem_bytes(seq, D),
      stream, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, seq, D, scale * attn_mma::kLog2e, vec);
}

// ---- past kColChunk columns ----------------------------------------------
__global__ void __launch_bounds__(kThreads)
    mhsa_fwd_chunk_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out,
                          float* __restrict__ lse, int H, int seq, int D,
                          float scale) {
  extern __shared__ float smem[];
  for (int q0 = 0; q0 < seq; q0 += kChunkTileQ)
    for (int cc = 0; cc < col_chunks(D); ++cc)
      fwd_f32_chunk_tile(q, k, v, out, lse, H, seq, D, scale,
                         static_cast<int>(blockIdx.x), q0, cc, smem);
}

// Dynamic shared memory, in bf16: 8 zeros, then K and V, each one matrix of
// T rows per column chunk, stride_elems(kColChunk) a row but the last
// chunk's, stride_elems(its width).
__host__ __device__ size_t chunk_mma_head_elems(int seq, int D) {
  const int nc = col_chunks(D);
  return static_cast<size_t>(seq) *
         ((nc - 1) * attn_mma::stride_elems(kColChunk) +
          attn_mma::stride_elems(chunk_width(D, nc - 1)));
}

size_t chunk_mma_smem_bytes(int seq, int D) {
  return sizeof(__nv_bfloat16) * (8 + 2 * chunk_mma_head_elems(seq, D));
}

__global__ void __launch_bounds__(kThreads)
    mhsa_fwd_chunk_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ out,
                              float* __restrict__ lse, int H, int seq, int D,
                              float c, bool vec) {
  using namespace attn_mma;
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf16[];
  const int nc = col_chunks(D);
  // column chunk e of K (of V) starts e * chunk rows of 136 in
  const int64_t chunk = static_cast<int64_t>(seq) * stride_elems(kColChunk);
  __nv_bfloat16* zeros = smem_bf16;
  __nv_bfloat16* k_s = smem_bf16 + 8;
  __nv_bfloat16* v_s = k_s + chunk_mma_head_elems(seq, D);

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t head = static_cast<int64_t>(bh) * seq * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;

  for (int e = 0; e < nc; ++e) {
    stage_rows(k_s + e * chunk, k + head + e * kColChunk, D, seq,
               chunk_width(D, e), vec, threadIdx.x, blockDim.x);
    stage_rows(v_s + e * chunk, v + head + e * kColChunk, D, seq,
               chunk_width(D, e), vec, threadIdx.x, blockDim.x);
  }
  cp_async_commit();
  if (threadIdx.x < 8) zeros[threadIdx.x] = __float2bfloat16(0.f);
  cp_async_wait<0>();
  __syncthreads();

  for (int row0 = 16 * warp; row0 < seq; row0 += 16 * warps) {
    for (int cc = 0; cc < nc; ++cc) {
      RowTile<kColChunk> st;  // st.q holds one chunk of q at a time
      clear_rows(st);
      for (int j0 = 0; j0 < seq; j0 += kChunk) {
        const int nk = min(kChunk, seq - j0);
        float s[kChunk / 8][4];
#pragma unroll
        for (int nb = 0; nb < kChunk / 8; ++nb)
#pragma unroll
          for (int x = 0; x < 4; ++x) s[nb][x] = 0.f;
        for (int e = 0; e < nc; ++e) {
          const int we = chunk_width(D, e);
          load_rows_a<kColChunk>(st.q, q + head + e * kColChunk, D, row0,
                                 seq, we, lane);
          chunk_logits<kColChunk>(s, st.q, k_s + e * chunk, j0, nk, seq, we,
                                  zeros, lane);
        }
        softmax_pv<kColChunk>(st, s, v_s + cc * chunk, j0, nk, seq,
                              chunk_width(D, cc), zeros, c, lane);
      }
      finish_rows(st, out + cc * kColChunk, cc == 0 ? lse : nullptr, b, h, H,
                  bh, row0, seq, D, chunk_width(D, cc), lane);
    }
  }
}

// The whole-head layouts' dynamic shared memory at (T, D), in bytes: up to
// kColChunk columns the f32 instance's, which is never less than the bf16
// one's (see the note at the top); past it the larger of the two
// column-chunk layouts'.  It takes no dtype, so both dtypes leave the
// whole-head layouts at the same T.
size_t whole_head_smem_bytes(int seq, int D) {
  if (D <= kColChunk) return smem_bytes(seq, D);
  const size_t bf16 = chunk_mma_smem_bytes(seq, D);
  const size_t f32 = fwd_f32_chunk_smem_bytes();
  return bf16 > f32 ? bf16 : f32;
}

bool whole_head_fits(int seq, int D) {
  return whole_head_smem_bytes(seq, D) <= kMaxSmemBytes;
}

// ---- past the whole head: K and V walked in key tiles --------------------
// Dynamic shared memory, in bf16: 8 zeros, then one key tile of K and one
// of V, kChunk rows of stride_elems(D) each.
size_t key_tiled_mma_smem_bytes(int D) {
  return sizeof(__nv_bfloat16) *
         (8 + 2 * static_cast<size_t>(attn_mma::kChunk) *
                  attn_mma::stride_elems(D));
}

template <int kDp>
__global__ void __launch_bounds__(kThreads)
    mhsa_fwd_key_tiled_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  __nv_bfloat16* __restrict__ out,
                                  float* __restrict__ lse, int H, int seq,
                                  int D, float c, bool vec) {
  using namespace attn_mma;
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf16[];
  __nv_bfloat16* zeros = smem_bf16;
  __nv_bfloat16* k_s = smem_bf16 + 8;
  __nv_bfloat16* v_s = k_s + kChunk * stride_elems(D);

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t head = static_cast<int64_t>(bh) * seq * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x < 8) zeros[threadIdx.x] = __float2bfloat16(0.f);

  for (int rows = 0; rows < seq; rows += 16 * kWarps) {
    const int row0 = rows + 16 * warp;
    const bool active = row0 < seq;  // warp-uniform
    RowTile<kDp> st;
    if (active) start_rows(st, q + head, row0, seq, D, lane);
    for (int j0 = 0; j0 < seq; j0 += kChunk) {
      const int n = min(kChunk, seq - j0);
      const int64_t off = head + static_cast<int64_t>(j0) * D;
      __syncthreads();  // the previous tile is no longer read
      stage_rows(k_s, k + off, D, n, D, vec, threadIdx.x, kThreads);
      stage_rows(v_s, v + off, D, n, D, vec, threadIdx.x, kThreads);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();  // the tile (and the zeros) have landed
      if (active) attend_chunk(st, k_s, v_s, 0, n, n, D, zeros, c, lane);
    }
    if (active) finish_rows(st, out, lse, b, h, H, bh, row0, seq, D, D, lane);
  }
}

template <int kDp>
cudaError_t launch_key_tiled_mma(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int B, int H, int seq,
                                 int D, float scale, cudaStream_t stream) {
  const bool vec = attn_mma::can_copy_chunks(D, k, v);
  return launch_with_smem(
      mhsa_fwd_key_tiled_mma_kernel<kDp>, B * H, kThreads,
      key_tiled_mma_smem_bytes(D), stream,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, seq, D, scale * attn_mma::kLog2e, vec);
}

// Dynamic shared memory, in bf16: 8 zeros, then a key tile of K as one
// matrix of kChunk rows per column chunk and one such matrix of V (the
// output's column chunk), each row stride_elems(kColChunk).
size_t key_tiled_chunk_mma_smem_bytes(int D) {
  return sizeof(__nv_bfloat16) *
         (8 + static_cast<size_t>(col_chunks(D) + 1) * attn_mma::kChunk *
                  attn_mma::stride_elems(kColChunk));
}

__global__ void __launch_bounds__(kThreads)
    mhsa_fwd_key_tiled_chunk_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                        const __nv_bfloat16* __restrict__ k,
                                        const __nv_bfloat16* __restrict__ v,
                                        __nv_bfloat16* __restrict__ out,
                                        float* __restrict__ lse, int H,
                                        int seq, int D, float c, bool vec) {
  using namespace attn_mma;
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf16[];
  const int nc = col_chunks(D);
  const int tile = kChunk * stride_elems(kColChunk);
  __nv_bfloat16* zeros = smem_bf16;
  __nv_bfloat16* k_s = smem_bf16 + 8;  // column chunk e at k_s + e * tile
  __nv_bfloat16* v_s = k_s + nc * tile;

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t head = static_cast<int64_t>(bh) * seq * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x < 8) zeros[threadIdx.x] = __float2bfloat16(0.f);

  for (int rows = 0; rows < seq; rows += 16 * kWarps) {
    const int row0 = rows + 16 * warp;
    const bool active = row0 < seq;  // warp-uniform
    for (int cc = 0; cc < nc; ++cc) {
      const int wc = chunk_width(D, cc);
      RowTile<kColChunk> st;  // st.q holds one chunk of q at a time
      clear_rows(st);
      for (int j0 = 0; j0 < seq; j0 += kChunk) {
        const int n = min(kChunk, seq - j0);
        const int64_t off = head + static_cast<int64_t>(j0) * D;
        __syncthreads();  // the previous tile is no longer read
        for (int e = 0; e < nc; ++e)
          stage_rows(k_s + e * tile, k + off + e * kColChunk, D, n,
                     chunk_width(D, e), vec, threadIdx.x, kThreads);
        stage_rows(v_s, v + off + cc * kColChunk, D, n, wc, vec, threadIdx.x,
                   kThreads);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();  // the tile (and the zeros) have landed
        if (active) {
          float s[kChunk / 8][4];
#pragma unroll
          for (int nb = 0; nb < kChunk / 8; ++nb)
#pragma unroll
            for (int x = 0; x < 4; ++x) s[nb][x] = 0.f;
          for (int e = 0; e < nc; ++e) {
            const int we = chunk_width(D, e);
            load_rows_a<kColChunk>(st.q, q + head + e * kColChunk, D, row0,
                                   seq, we, lane);
            chunk_logits<kColChunk>(s, st.q, k_s + e * tile, 0, n, n, we,
                                    zeros, lane);
          }
          softmax_pv<kColChunk>(st, s, v_s, 0, n, n, wc, zeros, c, lane);
        }
      }
      if (active)
        finish_rows(st, out + cc * kColChunk, cc == 0 ? lse : nullptr, b, h,
                    H, bh, row0, seq, D, wc, lane);
    }
  }
}

size_t key_tiled_smem_bytes(int D) {
  const size_t bf16 = D <= kColChunk ? key_tiled_mma_smem_bytes(D)
                                     : key_tiled_chunk_mma_smem_bytes(D);
  const size_t f32 = fwd_f32_chunk_smem_bytes();
  return bf16 > f32 ? bf16 : f32;
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       void* lse, int B, int H, int seq, int D, float scale,
                       cudaStream_t stream) {
  // up to kColChunk columns the whole head where it fits; else (and past
  // kColChunk always) the walk over key tiles, any T and any D
  if (D <= kColChunk && whole_head_fits(seq, D))
    return launch<float>(q, k, v, out, lse, B, H, seq, D, scale, stream);
  return launch_with_smem(
      mhsa_fwd_chunk_kernel, B * H, kThreads, fwd_f32_chunk_smem_bytes(),
      stream, static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), H, seq, D, scale);
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, void* lse, int B, int H, int seq, int D,
                        float scale, cudaStream_t stream) {
  if (!whole_head_fits(seq, D)) {
    if (D <= 16)
      return launch_key_tiled_mma<16>(q, k, v, out, lse, B, H, seq, D, scale,
                                      stream);
    if (D <= 32)
      return launch_key_tiled_mma<32>(q, k, v, out, lse, B, H, seq, D, scale,
                                      stream);
    if (D <= 64)
      return launch_key_tiled_mma<64>(q, k, v, out, lse, B, H, seq, D, scale,
                                      stream);
    if (D <= kColChunk)
      return launch_key_tiled_mma<128>(q, k, v, out, lse, B, H, seq, D,
                                       scale, stream);
    return launch_with_smem(
        mhsa_fwd_key_tiled_chunk_mma_kernel, B * H, kThreads,
        key_tiled_chunk_mma_smem_bytes(D), stream,
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H, seq,
        D, scale * attn_mma::kLog2e, attn_mma::can_copy_chunks(D, k, v));
  }
  if (D <= 16) return launch_mma<16>(q, k, v, out, lse, B, H, seq, D, scale,
                                     stream);
  if (D <= 32) return launch_mma<32>(q, k, v, out, lse, B, H, seq, D, scale,
                                     stream);
  if (D <= 64) return launch_mma<64>(q, k, v, out, lse, B, H, seq, D, scale,
                                     stream);
  if (D <= kColChunk)
    return launch_mma<128>(q, k, v, out, lse, B, H, seq, D, scale, stream);
  // one warp per 16-row query tile, at most kWarps
  const int warps = min((seq + 15) / 16, kWarps);
  const bool vec = attn_mma::can_copy_chunks(D, k, v);
  return launch_with_smem(
      mhsa_fwd_chunk_mma_kernel, B * H, 32 * warps,
      chunk_mma_smem_bytes(seq, D), stream,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, seq, D, scale * attn_mma::kLog2e, vec);
}

}  // namespace

// q, k, v: (B, H, T, D) contiguous; out: (B, T, H, D) contiguous, same type;
// lse: (B, H, T) float32 contiguous, or null for the inference variant.
// Any T and any D; dtype 0 is float32, 1 is bfloat16.  Returns the
// cudaError_t of the launch (0 on success); the caller checks shapes.
extern "C" int mhsa_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, int B, int H, int T, int D,
                        float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_f32(q, k, v, out, lse, B, H, T, D, scale, s);
    case 1:
      return launch_bf16(q, k, v, out, lse, B, H, T, D, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The whole-head layouts' dynamic shared memory, in bytes (see
// whole_head_smem_bytes).  Where it is more than a block may use, the launch
// walks K and V in key tiles instead and needs
// mhsa_fwd_key_tiled_smem_bytes.
extern "C" long long mhsa_fwd_smem_bytes(int T, int D) {
  return static_cast<long long>(whole_head_smem_bytes(T, D));
}

// The dynamic shared memory of the walk over key tiles, in bytes: the
// larger of the f32 and the bf16 layouts', which depend on D alone (T is
// taken for the interface the other entry points share).
extern "C" long long mhsa_fwd_key_tiled_smem_bytes(int T, int D) {
  (void)T;
  return static_cast<long long>(key_tiled_smem_bytes(D));
}
