// Tiled ("flash") multi-head self-attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel vit_cifar_tpu/ops/pallas/attention.py::
// _flash_fwd_body in both its variants: the inference one (reached through
// flash_attention) and the training one (reached through the custom VJP's
// _flash_fwd), which also writes the row logsumexp.  For every (batch,
// head): s = q.k^T * scale, then the online softmax over key tiles --
// running row max m, normaliser l and unnormalised context acc, rescaled
// whenever a tile raises the max -- and finally o = acc / l and
// lse = m + log(l), with f32 softmax and sums whatever the input type.  o is
// written in the (B, T, H, D) layout that flash_attention returns; lse, when
// given, is (B, H, T) f32, not the TPU's lane-broadcast (B, H, Tp, 128).
// Offsets into q, k, v and o are int64; nothing is padded in device memory.
//
// What bounds it on this card: at the pixel-token ViT's shape (B, H, T, D)
// = (128, 12, 1025, 32), one head is two 1025x1025x32 products and 1.05 M
// exps against 262 KB of q, k, v and o in bf16, some 500 FLOP per byte --
// compute-bound, and the exps (one per logit, 16 a clock per SM on the
// special-function units) take longer than the products at the tensor
// cores' peak.  So the bf16 instance keeps every logit in registers and
// spends as little as it can besides one exp2f per logit:
//
//   bf16 (dtype 1), on the tensor cores (mma_attention.cuh).  One block of
//   4 warps per (b, h, 64 query rows); a warp owns 16 rows, their q as mma
//   A fragments read once from device memory, and m, l and o in
//   accumulator registers.  K and V tiles of 64 keys are staged as bf16 in
//   shared memory with cp.async, two stages deep, so the next tile loads
//   while this one computes; their rows are an odd number of 16-byte
//   chunks apart, so ldmatrix is free of bank conflicts.  s = q.k^T and
//   o += p.v are mma.sync.m16n8k16 (bf16 in, f32 accumulate), V through
//   ldmatrix.trans; p is split into bf16 hi + lo and both go through the
//   tensor cores, so p.v keeps p at f32 accuracy as the TPU kernel does.
//   The softmax runs on the accumulator fragments (row max and sum over a
//   quad of lanes), with scale*log2(e) folded into one multiply so that
//   each exp is one exp2f.  Keys past T read zeros and get -inf logits;
//   columns past D read zeros (any D <= 128); rows past T in a warp's
//   16 are zero rows that are never written, and a warp whose 16 rows all
//   lie past T computes nothing.
//
//   f32 (dtype 0), on the CUDA cores.  The tensor cores would take f32 only
//   as TF32, whose 10-bit mantissa breaks the 1e-5 the f32 path is held
//   to; so f32 keeps the first design: one block of 8 warps per 64 query
//   rows, q, K and V converted into f32 shared memory, each warp walking
//   its 8 rows with lanes over keys for the logits and over d for p.v.
//   This is a dispatch by dtype, not a fallback.
//
// Heads wider than kColChunk = 128 columns (the TPU kernel pads D to a
// multiple of 128 and runs any D) are cut into column chunks of 128.  A
// second grid axis gives each output chunk its own block, whose registers
// and shared memory are those of a 128-column head whatever D is: the
// logits are summed over the chunks, one staged chunk of K (and of q) at a
// time, and the block accumulates only its own chunk of o.  Every output
// chunk recomputes the softmax (exps and q.k^T), ceil(D/128) times in all.
//   bf16: each 64-key tile takes ceil(D/128) pipeline steps, one K chunk
//   each (two stages by cp.async), the block's own chunk last, whose step
//   also stages the V chunk; q's fragments for a chunk are read from device
//   memory at each step, so nothing of the block grows with D.
//   f32: fwd_f32_chunk.cuh, shared with mhsa_fwd.cu.
//
// Every instance keeps the TPU kernel's guard: a tile whose logits are all
// -inf keeps m at -inf and must not turn it into NaN, so exp uses m_new = 0
// there and the rescale factor of an empty history is 0.  Shared memory
// does not grow with T, so any T and any D run.
//
// Built by vit_cifar_torch/ops/cuda/build.py (nvcc, sm_90a, plain C
// interface bound with ctypes).

#include <math_constants.h>

#include <cstdint>

#include "attention_common.cuh"
#include "fwd_f32_chunk.cuh"
#include "mma_attention.cuh"

namespace {

using namespace attn;

constexpr int kRows = 8;                 // query rows per warp
constexpr int kTileQ = kRows * kWarps;   // query rows per block
constexpr int kTileK = 64;               // keys per tile: two per lane

// ---- f32: the CUDA-core instance -----------------------------------------
// Dynamic shared memory, in floats:
//   Q    kTileQ * D         (the block's query rows)
//   K    kTileK * (D + 1)   (the key tile, padded row stride)
//   V    kTileK * D         (the value tile)
//   p    kWarps * kTileK    (each warp's row of probabilities)
template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int H, int seq, int D,
                     float scale) {
  extern __shared__ float smem[];
  const int ks = D + 1;
  float* q_s = smem;
  float* k_s = q_s + kTileQ * D;
  float* v_s = k_s + kTileK * ks;
  float* p_s = v_s + kTileK * D;

  const int tiles = (seq + kTileQ - 1) / kTileQ;
  const int bh = blockIdx.x / tiles;  // b * H + h
  const int q0 = (blockIdx.x - bh * tiles) * kTileQ;
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t head = static_cast<int64_t>(bh) * seq * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nq = min(kTileQ, seq - q0);

  for (int i = threadIdx.x; i < nq * D; i += kThreads)
    q_s[i] = to_f32(q[head + static_cast<int64_t>(q0) * D + i]);

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int row0 = warp * kRows;  // this warp's first row in the tile
  float* prow = p_s + warp * kTileK;
  for (int k0 = 0; k0 < seq; k0 += kTileK) {
    const int nk = min(kTileK, seq - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < nk * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      const int64_t g = head + static_cast<int64_t>(k0) * D + i;
      k_s[j * ks + d] = to_f32(k[g]);
      v_s[i] = to_f32(v[g]);
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row0 + r >= nq) break;  // warp-uniform: rows past T
      const float* qrow = q_s + (row0 + r) * D;
      float s0 = -CUDART_INF_F, s1 = -CUDART_INF_F;
      if (lane < nk) {
        const float* krow = k_s + lane * ks;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qrow[d], krow[d], a);
        s0 = a * scale;
      }
      if (lane + 32 < nk) {
        const float* krow = k_s + (lane + 32) * ks;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qrow[d], krow[d], a);
        s1 = a * scale;
      }
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
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          float a = acc[r][c] * corr;
          for (int j = 0; j < nk; ++j) a = fmaf(prow[j], v_s[j * D + d], a);
          acc[r][c] = a;
        }
      }
      __syncwarp();  // prow is rewritten for the next row
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + row0 + r;
    if (i >= seq) break;
    T* orow = out + ((static_cast<int64_t>(b) * seq + i) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = from_f32<T>(acc[r][c] / l[r]);
    }
    if (lse != nullptr && lane == 0)
      lse[static_cast<int64_t>(bh) * seq + i] = m[r] + logf(l[r]);
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kTileQ) * D +
                          static_cast<size_t>(kTileK) * (D + 1) +
                          static_cast<size_t>(kTileK) * D + kWarps * kTileK);
}

template <int kCols>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       void* lse, int B, int H, int seq, int D, float scale,
                       cudaStream_t stream) {
  const int tiles = (seq + kTileQ - 1) / kTileQ;
  return launch_with_smem(
      flash_fwd_kernel<float, kCols>, B * H * tiles, kThreads, smem_bytes(D),
      stream, static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), H, seq, D, scale);
}

// ---- bf16: the tensor-core instance --------------------------------------
constexpr int kMmaWarps = 4;
constexpr int kMmaTileQ = 16 * kMmaWarps;  // query rows per block
constexpr int kMmaThreads = 32 * kMmaWarps;

// Dynamic shared memory, in bf16: 8 zeros (the chunk that rows past a tile
// and columns past D read), then K stage 0, K stage 1, V stage 0, V stage 1,
// each kChunk rows of stride_elems(D).
size_t mma_smem_bytes(int D) {
  return sizeof(__nv_bfloat16) *
         (8 + 4 * static_cast<size_t>(attn_mma::kChunk) *
                  attn_mma::stride_elems(D));
}

template <int kDp>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int H, int seq, int D,
                         float c, bool vec) {
  using namespace attn_mma;
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf16[];
  const int tile = kChunk * stride_elems(D);
  __nv_bfloat16* zeros = smem_bf16;
  __nv_bfloat16* k_s = smem_bf16 + 8;  // stage i at k_s + i * tile
  __nv_bfloat16* v_s = k_s + 2 * tile;

  const int tiles = (seq + kMmaTileQ - 1) / kMmaTileQ;
  const int bh = blockIdx.x / tiles;  // b * H + h
  const int q0 = (blockIdx.x - bh * tiles) * kMmaTileQ;
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t head = static_cast<int64_t>(bh) * seq * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + 16 * warp;
  const bool active = row0 < seq;  // warp-uniform

  auto stage = [&](int it) {
    const int k0 = it * kChunk;
    const int n = min(kChunk, seq - k0);
    const int64_t off = head + static_cast<int64_t>(k0) * D;
    stage_rows(k_s + (it & 1) * tile, k + off, D, n, D, vec, threadIdx.x,
               kMmaThreads);
    stage_rows(v_s + (it & 1) * tile, v + off, D, n, D, vec, threadIdx.x,
               kMmaThreads);
    cp_async_commit();
  };

  const int nkt = (seq + kChunk - 1) / kChunk;
  stage(0);
  if (threadIdx.x < 8) zeros[threadIdx.x] = __float2bfloat16(0.f);
  RowTile<kDp> st;
  start_rows(st, q + head, row0, seq, D, lane);
  for (int it = 0; it < nkt; ++it) {
    if (it + 1 < nkt) {
      stage(it + 1);  // its buffer was last read before the previous sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it has landed for every thread
    if (active) {
      const int n = min(kChunk, seq - it * kChunk);
      attend_chunk(st, k_s + (it & 1) * tile, v_s + (it & 1) * tile, 0, n, n,
                   D, zeros, c, lane);
    }
    __syncthreads();  // tile it is no longer read
  }
  if (active) finish_rows(st, out, lse, b, h, H, bh, row0, seq, D, D, lane);
}

template <int kDp>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       void* lse, int B, int H, int seq, int D, float scale,
                       cudaStream_t stream) {
  const int tiles = (seq + kMmaTileQ - 1) / kMmaTileQ;
  const bool vec = attn_mma::can_copy_chunks(D, k, v);
  return launch_with_smem(
      flash_fwd_mma_kernel<kDp>, B * H * tiles, kMmaThreads, mma_smem_bytes(D),
      stream, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, seq, D, scale * attn_mma::kLog2e, vec);
}

// ---- past kColChunk columns: one block per (b, h, query tile, column
// chunk) -------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    flash_fwd_chunk_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, float* __restrict__ lse,
                           int H, int seq, int D, float scale) {
  extern __shared__ float smem[];
  const int tiles = (seq + kChunkTileQ - 1) / kChunkTileQ;
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - bh * tiles) * kChunkTileQ;
  fwd_f32_chunk_tile(q, k, v, out, lse, H, seq, D, scale, bh, q0,
                     static_cast<int>(blockIdx.y), smem);
}

// Dynamic shared memory, in bf16: 8 zeros, then two stages, each a K chunk
// and a V chunk of kChunk rows of stride_elems(kColChunk).
size_t chunk_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         (8 + 4 * static_cast<size_t>(attn_mma::kChunk) *
                  attn_mma::stride_elems(kColChunk));
}

__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_chunk_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ out,
                               float* __restrict__ lse, int H, int seq, int D,
                               float c, bool vec) {
  using namespace attn_mma;
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf16[];
  const int tile = kChunk * stride_elems(kColChunk);
  __nv_bfloat16* zeros = smem_bf16;
  __nv_bfloat16* ring = smem_bf16 + 8;  // stage i: K at + 2i*tile, then V

  const int tiles = (seq + kMmaTileQ - 1) / kMmaTileQ;
  const int bh = blockIdx.x / tiles;  // b * H + h
  const int q0 = (blockIdx.x - bh * tiles) * kMmaTileQ;
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t head = static_cast<int64_t>(bh) * seq * D;
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
    const int64_t off = head + static_cast<int64_t>(k0) * D;
    __nv_bfloat16* dst = ring + (i & 1) * 2 * tile;
    stage_rows(dst, k + off + e * kColChunk, D, n, chunk_width(D, e), vec,
               threadIdx.x, kMmaThreads);
    if (e == cc)
      stage_rows(dst + tile, v + off + c0, D, n, wc, vec, threadIdx.x,
                 kMmaThreads);
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
      load_rows_a<kColChunk>(st.q, q + head + e * kColChunk, D, row0, seq,
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

cudaError_t launch_f32_for_d(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int H, int seq,
                             int D, float scale, cudaStream_t stream) {
  if (D <= 32) return launch_f32<1>(q, k, v, out, lse, B, H, seq, D, scale,
                                    stream);
  if (D <= 64) return launch_f32<2>(q, k, v, out, lse, B, H, seq, D, scale,
                                    stream);
  if (D <= kColChunk)
    return launch_f32<4>(q, k, v, out, lse, B, H, seq, D, scale, stream);
  const int tiles = (seq + kChunkTileQ - 1) / kChunkTileQ;
  return launch_with_smem(
      flash_fwd_chunk_kernel, dim3(B * H * tiles, col_chunks(D)), kThreads,
      fwd_f32_chunk_smem_bytes(), stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), H, seq, D, scale);
}

cudaError_t launch_mma_for_d(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int H, int seq,
                             int D, float scale, cudaStream_t stream) {
  if (D <= 16) return launch_mma<16>(q, k, v, out, lse, B, H, seq, D, scale,
                                     stream);
  if (D <= 32) return launch_mma<32>(q, k, v, out, lse, B, H, seq, D, scale,
                                     stream);
  if (D <= 64) return launch_mma<64>(q, k, v, out, lse, B, H, seq, D, scale,
                                     stream);
  if (D <= kColChunk)
    return launch_mma<128>(q, k, v, out, lse, B, H, seq, D, scale, stream);
  const int tiles = (seq + kMmaTileQ - 1) / kMmaTileQ;
  const bool vec = attn_mma::can_copy_chunks(D, k, v);
  return launch_with_smem(
      flash_fwd_chunk_mma_kernel, dim3(B * H * tiles, col_chunks(D)),
      kMmaThreads, chunk_mma_smem_bytes(), stream,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, seq, D, scale * attn_mma::kLog2e, vec);
}

}  // namespace

// q, k, v: (B, H, T, D) contiguous; out: (B, T, H, D) contiguous, same type;
// lse: (B, H, T) float32 contiguous, or null for the inference variant.
// Any D; dtype 0 is float32, 1 is bfloat16.  Returns the cudaError_t of
// the launch (0 on success); the caller checks shapes.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int H, int T, int D,
                         float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_f32_for_d(q, k, v, out, lse, B, H, T, D, scale, s);
    case 1:
      return launch_mma_for_d(q, k, v, out, lse, B, H, T, D, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory one launch needs, in bytes: the larger of the
// two instances' needs, which depend on D alone and stop growing past
// kColChunk (T is taken for the interface the whole-head kernel shares).
extern "C" long long flash_fwd_smem_bytes(int T, int D) {
  (void)T;
  const size_t f32 =
      D <= kColChunk ? smem_bytes(D) : fwd_f32_chunk_smem_bytes();
  const size_t bf16 =
      D <= kColChunk ? mma_smem_bytes(D) : chunk_mma_smem_bytes();
  return static_cast<long long>(f32 > bf16 ? f32 : bf16);
}
