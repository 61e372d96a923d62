// Tiled ("flash") attention backward, the query gradient, for Hopper
// (sm_90a), at any T.
//
// Replaces the TPU kernel
// vit_cifar_tpu/ops/pallas/attention.py::_flash_bwd_dq_kernel (pass 1 of
// _flash_bwd_impl) where flash_attention's custom VJP reaches it.  For
// every (batch, head) and query row i:
//   delta_i = sum_d do_i[d] * o_i[d]
//   s_ij = q_i . k_j * scale,  p_ij = exp(s_ij - lse_i),  dp_ij = do_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i) * scale
//   dq_i = sum_j ds_ij k_j
// in f32 whatever the input type; lse is the forward's (flash_fwd.cu).  o
// and do are read in place in the (B, T, H, D) layout that flash_attention
// returns, as the JAX backward receives them, and dq is written in
// (B, H, T, D) in the input type.
//
// What bounds it on this card: at the pixel-token ViT's shape (128, 12,
// 1025, 32) one head is three 1025x1025x32 products (q.k, do.v, ds.k) and
// 1.05 M exps against some 0.4 MB in and out in bf16, about 750 FLOP per
// byte: not device memory but arithmetic bounds it, and the exps (16 a
// clock per SM on the special-function units) take longer than the
// products at the tensor cores' peak.  So the bf16 instance keeps every
// logit in registers and spends one exp2f per logit:
//
//   bf16 (dtype 1), on the tensor cores (mma_attention.cuh): the forward's
//   shape with V used twice.  One block of 4 warps per (b, h, 64 query
//   rows); a warp owns 16 rows.  The block's q rows and dO rows (row
//   stride H*D, do being (B, T, H, D)) are staged once by cp.async; each
//   warp takes its rows' A fragments from them, its rows' lse (times
//   log2(e)) and delta, computed once from o and dO as the TPU kernel does
//   at j == 0.  K and V tiles of 64 keys are staged as bf16 by cp.async,
//   two stages deep.  For each 16 keys of a tile: s = q.k^T and dp =
//   dO.v^T (mma.sync.m16n8k16, K and V through ldmatrix), p = exp2(s *
//   scale*log2(e) - lse*log2(e)) with keys past T masked to 0, ds = p *
//   (dp - delta) * scale in the accumulator registers, and dq += ds.K with
//   ds repacked as A fragments, split into bf16 hi + lo (so that ds keeps
//   f32 accuracy, as the TPU kernel keeps it) and K through ldmatrix.trans.
//   The accumulators of dq stay in registers; no atomics, and no block
//   depends on another.  Rows past T read zeros (lse 0, delta 0, so ds is
//   0) and are never written; columns past D read zeros.
//   Up to D = 64 a warp keeps its q and dO fragments in registers for the
//   whole loop; at D = 128 it reloads them from shared memory for every 16
//   keys, which keeps its registers under the limit.
//
//   f32 (dtype 0), on the CUDA cores.  The tensor cores would take f32 only
//   as TF32, whose 10-bit mantissa breaks the 1e-5 the f32 path is held
//   to; so f32 keeps the first design: one block of 8 warps per 64 query
//   rows, q, dO, K and V converted into f32 shared memory (K and V with a
//   row stride of D+1), each warp walking its 8 rows with lanes over keys
//   for s and dp and over d for ds.K.  This is a dispatch by dtype, not a
//   fallback.
//
// Heads wider than kColChunk = 128 columns (the TPU kernel pads D to a
// multiple of 128 and runs any D) are cut into column chunks of 128.  A
// second grid axis gives each chunk of dq its own block, whose registers
// and shared memory are those of a 128-column head whatever D is: s and dp
// are summed over the chunks, one staged chunk of K and V at a time, for a
// whole tile of 64 keys (kept in registers), the block's own chunk last;
// that step turns them into ds and adds ds.K into the block's chunk of dq.
// s and dp are recomputed for every chunk of dq, ceil(D/128) times in all.
//   bf16: two pipeline stages by cp.async, each a K and a V chunk; the
//   warp's q and dO fragments of a chunk are read from device memory at each
//   step, and delta is summed chunk by chunk at the start.
//   f32: each chunk of the block's q and dO rows and of the key tile's K and
//   V is staged in f32 shared memory in turn; lanes over keys as above.
//
// Shared memory does not grow with T or D, so any T and any D run.  Offsets
// are int64; nothing is padded in device memory.
//
// Built by vit_cifar_torch/ops/cuda/build.py (nvcc, sm_90a, plain C
// interface bound with ctypes).

#include <cstdint>

#include "attention_common.cuh"
#include "mma_attention.cuh"

namespace {

using namespace attn;

// ---- f32: the CUDA-core instance -----------------------------------------
constexpr int kRows = 8;                 // query rows per warp
constexpr int kTileQ = kRows * kWarps;   // query rows per block
constexpr int kTileK = 64;               // keys per tile: two per lane

// Dynamic shared memory, in floats:
//   Q    kTileQ * D         (the block's query rows)
//   dO   kTileQ * D         (their output gradients)
//   K    kTileK * (D + 1)
//   V    kTileK * (D + 1)
//   ds   kWarps * kTileK    (each warp's row of ds)
template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse, T* __restrict__ dq,
                        int H, int seq, int D, float scale) {
  extern __shared__ float smem[];
  const int ks = D + 1;
  float* q_s = smem;
  float* do_s = q_s + kTileQ * D;
  float* k_s = do_s + kTileQ * D;
  float* v_s = k_s + kTileK * ks;
  float* ds_s = v_s + kTileK * ks;

  const int tiles = (seq + kTileQ - 1) / kTileQ;
  const int bh = blockIdx.x / tiles;  // b * H + h
  const int q0 = (blockIdx.x - bh * tiles) * kTileQ;
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t head = static_cast<int64_t>(bh) * seq * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nq = min(kTileQ, seq - q0);

  for (int idx = threadIdx.x; idx < nq * D; idx += kThreads) {
    const int i = idx / D;
    const int d = idx - i * D;
    q_s[idx] = to_f32(q[head + static_cast<int64_t>(q0) * D + idx]);
    // (B, T, H, D) offset of row q0 + i of this head in do
    const int64_t bthd = ((static_cast<int64_t>(b) * seq + q0 + i) * H + h) * D;
    do_s[idx] = to_f32(dout[bthd + d]);
  }
  __syncthreads();

  const int row0 = warp * kRows;  // this warp's first row in the tile
  float delta[kRows], lse_r[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    delta[r] = 0.f;
    lse_r[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
    if (row0 + r < nq) {  // warp-uniform
      const int i = q0 + row0 + r;
      const T* orow = o + ((static_cast<int64_t>(b) * seq + i) * H + h) * D;
      float a = 0.f;
      for (int d = lane; d < D; d += 32)
        a = fmaf(do_s[(row0 + r) * D + d], to_f32(orow[d]), a);
      delta[r] = warp_sum(a);
      lse_r[r] = lse[static_cast<int64_t>(bh) * seq + i];
    }
  }

  float* dsrow = ds_s + warp * kTileK;
  for (int k0 = 0; k0 < seq; k0 += kTileK) {
    const int nk = min(kTileK, seq - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < nk * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int64_t g = head + static_cast<int64_t>(k0) * D + idx;
      k_s[j * ks + d] = to_f32(k[g]);
      v_s[j * ks + d] = to_f32(v[g]);
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row0 + r >= nq) break;  // warp-uniform: rows past T
      const float* qrow = q_s + (row0 + r) * D;
      const float* dorow = do_s + (row0 + r) * D;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = lane + 32 * half;
        float ds = 0.f;  // missing keys of a ragged tile
        if (j < nk) {
          const float* krow = k_s + j * ks;
          const float* vrow = v_s + j * ks;
          float s = 0.f, dp = 0.f;
          for (int d = 0; d < D; ++d) {
            s = fmaf(qrow[d], krow[d], s);
            dp = fmaf(dorow[d], vrow[d], dp);
          }
          const float p = expf(s * scale - lse_r[r]);
          ds = p * (dp - delta[r]) * scale;
        }
        dsrow[j] = ds;
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          float a = acc[r][c];
          for (int j = 0; j < nk; ++j) a = fmaf(dsrow[j], k_s[j * ks + d], a);
          acc[r][c] = a;
        }
      }
      __syncwarp();  // dsrow is rewritten for the next row
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row0 + r >= nq) break;
    T* dqrow = dq + head + static_cast<int64_t>(q0 + row0 + r) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dqrow[d] = from_f32<T>(acc[r][c]);
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * (2 * static_cast<size_t>(kTileQ) * D +
                          2 * static_cast<size_t>(kTileK) * (D + 1) +
                          kWarps * kTileK);
}

template <int kCols>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* lse,
                       void* dq, int B, int H, int seq, int D, float scale,
                       cudaStream_t stream) {
  const int tiles = (seq + kTileQ - 1) / kTileQ;
  return launch_with_smem(
      flash_bwd_dq_kernel<float, kCols>, B * H * tiles, kThreads,
      smem_bytes(D), stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(dq), H, seq, D,
      scale);
}

// ---- bf16: the tensor-core instance --------------------------------------
constexpr int kMmaWarps = 4;
constexpr int kMmaTileQ = 16 * kMmaWarps;  // query rows per block
constexpr int kMmaThreads = 32 * kMmaWarps;

// Dynamic shared memory, in bf16: 8 zeros (the chunk that rows past a tile
// and columns past D read), then the block's q rows, its dO rows, K stage
// 0, K stage 1, V stage 0, V stage 1, each kChunk rows of stride_elems(D).
size_t mma_smem_bytes(int D) {
  return sizeof(__nv_bfloat16) *
         (8 + 6 * static_cast<size_t>(attn_mma::kChunk) *
                  attn_mma::stride_elems(D));
}

// kRegs: the warp keeps its q and dO fragments in registers for the whole
// loop (else it reloads them from shared memory for every 16 keys).
template <int kDp, bool kRegs>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            __nv_bfloat16* __restrict__ dq, int H, int seq,
                            int D, float scale, float c, bool vec) {
  using namespace attn_mma;
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf16[];
  const int tile = kChunk * stride_elems(D);
  __nv_bfloat16* zeros = smem_bf16;
  __nv_bfloat16* q_s = smem_bf16 + 8;
  __nv_bfloat16* do_s = q_s + tile;
  __nv_bfloat16* k_s = do_s + tile;  // stage i at k_s + i * tile
  __nv_bfloat16* v_s = k_s + 2 * tile;

  const int tiles = (seq + kMmaTileQ - 1) / kMmaTileQ;
  const int bh = blockIdx.x / tiles;  // b * H + h
  const int q0 = (blockIdx.x - bh * tiles) * kMmaTileQ;
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t head = static_cast<int64_t>(bh) * seq * D;
  const int64_t ld = static_cast<int64_t>(H) * D;  // row stride of o, do
  // (b, q0, h) in the (B, T, H, D) layout of o and do
  const int64_t bthd = ((static_cast<int64_t>(b) * seq + q0) * H + h) * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nq = min(kMmaTileQ, seq - q0);
  const int row0 = 16 * warp;  // this warp's first row in the block's tile
  const bool active = row0 < nq;  // warp-uniform

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

  if (threadIdx.x < 8) zeros[threadIdx.x] = __float2bfloat16(0.f);
  stage_rows(q_s, q + head + static_cast<int64_t>(q0) * D, D, nq, D, vec,
             threadIdx.x, kMmaThreads);
  stage_rows(do_s, dout + bthd, ld, nq, D, vec, threadIdx.x, kMmaThreads);
  stage(0);
  cp_async_wait<0>();
  __syncthreads();

  // rows g and g+8 of the warp's 16: lse in log2 units and delta, both 0
  // past T (so that ds is 0 there)
  const int g = lane >> 2, t = lane & 3;
  uint32_t qa[kDp / 16][4], da[kDp / 16][4];
  float lse2[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  if (active) {
    if constexpr (kRegs) load_a<kDp>(qa, q_s, row0, nq, D, zeros, lane);
    load_a<kDp>(da, do_s, row0, nq, D, zeros, lane);
    rows_dot<kDp>(delta, da, o + bthd, ld, row0, nq, D, lane);
    const float* lse_rows = lse + static_cast<int64_t>(bh) * seq + q0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + g + 8 * i;
      if (r < nq) lse2[i] = lse_rows[r] * kLog2e;
    }
  }
  float acc[kDp / 8][4];
#pragma unroll
  for (int nb = 0; nb < kDp / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  const int nkt = (seq + kChunk - 1) / kChunk;
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
      const __nv_bfloat16* kt = k_s + (it & 1) * tile;
      const __nv_bfloat16* vt = v_s + (it & 1) * tile;
#pragma unroll
      for (int kb = 0; kb < kChunk / 16; ++kb) {
        if (16 * kb >= n) break;  // warp-uniform
        float s[2][4] = {}, dp[2][4] = {};
        if constexpr (!kRegs) load_a<kDp>(qa, q_s, row0, nq, D, zeros, lane);
        mma_a_bt<kDp>(s[0], s[1], qa, kt, 16 * kb, n, D, zeros, lane);
        if constexpr (!kRegs) load_a<kDp>(da, do_s, row0, nq, D, zeros, lane);
        mma_a_bt<kDp>(dp[0], dp[1], da, vt, 16 * kb, n, D, zeros, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 16 * kb + 8 * j + 2 * t + (e & 1);
            const float p =
                key < n ? exp2f(s[j][e] * c - lse2[e >> 1]) : 0.f;
            s[j][e] = p * (dp[j][e] - delta[e >> 1]) * scale;  // ds
          }
        mma_p_b<kDp>(acc, s[0], s[1], kt, 16 * kb, n, D, zeros, lane);
      }
    }
    __syncthreads();  // tile it is no longer read
  }
  if (active)
    store_rows<kDp>(acc, dq + head + static_cast<int64_t>(q0) * D, D, row0,
                    nq, D, lane);
}

template <int kDp>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* lse,
                       void* dq, int B, int H, int seq, int D, float scale,
                       cudaStream_t stream) {
  const int tiles = (seq + kMmaTileQ - 1) / kMmaTileQ;
  const bool vec = attn_mma::can_copy_chunks(D, q, k, v, dout);
  return launch_with_smem(
      flash_bwd_dq_mma_kernel<kDp, (kDp <= 64)>, B * H * tiles, kMmaThreads,
      mma_smem_bytes(D), stream, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<__nv_bfloat16*>(dq), H, seq, D, scale,
      scale * attn_mma::kLog2e, vec);
}

// ---- past kColChunk columns: one block per (b, h, query tile, column
// chunk of dq) ---------------------------------------------------------------
// f32 dynamic shared memory, in floats: the block's q and dO rows, one
// column chunk (kTileQ * kColChunk each); the key tile's K and V, the same
// chunk (kTileK * (kColChunk + 1) each); each warp's row of ds.
size_t chunk_smem_bytes() {
  return sizeof(float) * (2 * static_cast<size_t>(kTileQ) * kColChunk +
                          2 * static_cast<size_t>(kTileK) * (kColChunk + 1) +
                          kWarps * kTileK);
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_chunk_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ o,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              float* __restrict__ dq, int H, int seq, int D,
                              float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTileQ * kColChunk;
  float* k_s = do_s + kTileQ * kColChunk;
  float* v_s = k_s + kTileK * (kColChunk + 1);
  float* ds_s = v_s + kTileK * (kColChunk + 1);

  const int tiles = (seq + kTileQ - 1) / kTileQ;
  const int bh = blockIdx.x / tiles;  // b * H + h
  const int q0 = (blockIdx.x - bh * tiles) * kTileQ;
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t head = static_cast<int64_t>(bh) * seq * D;
  // (b, q0, h) in the (B, T, H, D) layout of o and do; rows H*D apart
  const int64_t bthd = ((static_cast<int64_t>(b) * seq + q0) * H + h) * D;
  const int64_t ld = static_cast<int64_t>(H) * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nq = min(kTileQ, seq - q0);
  const int nc = col_chunks(D);
  const int cc = blockIdx.y;  // the block's chunk of dq
  const int wc = chunk_width(D, cc);

  const int row0 = warp * kRows;  // this warp's first row in the tile
  float delta[kRows], lse_r[kRows], acc[kRows][kColChunk / 32];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    delta[r] = 0.f;
    lse_r[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kColChunk / 32; ++c) acc[r][c] = 0.f;
    if (row0 + r < nq) {  // warp-uniform
      const int64_t row = bthd + (row0 + r) * ld;
      float a = 0.f;
      for (int d = lane; d < D; d += 32) a = fmaf(dout[row + d], o[row + d], a);
      delta[r] = warp_sum(a);
      lse_r[r] = lse[static_cast<int64_t>(bh) * seq + q0 + row0 + r];
    }
  }

  float* dsrow = ds_s + warp * kTileK;
  for (int k0 = 0; k0 < seq; k0 += kTileK) {
    const int nk = min(kTileK, seq - k0);
    float s[kRows][2], dp[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    // the block's own chunk last: its K stays staged for ds.K
    for (int step = 1; step <= nc; ++step) {
      const int e = (cc + step) % nc;
      const int w = chunk_width(D, e);
      const int ks = w + 1;
      const int col = e * kColChunk;
      __syncthreads();  // the previous chunk (or tile) is no longer read
      for (int idx = threadIdx.x; idx < nq * w; idx += kThreads) {
        const int i = idx / w;
        const int d = idx - i * w;
        q_s[idx] = q[head + static_cast<int64_t>(q0 + i) * D + col + d];
        do_s[idx] = dout[bthd + i * ld + col + d];
      }
      for (int idx = threadIdx.x; idx < nk * w; idx += kThreads) {
        const int j = idx / w;
        const int d = idx - j * w;
        const int64_t g = head + static_cast<int64_t>(k0 + j) * D + col + d;
        k_s[j * ks + d] = k[g];
        v_s[j * ks + d] = v[g];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (row0 + r >= nq) break;  // warp-uniform: rows past T
        const float* qrow = q_s + (row0 + r) * w;
        const float* dorow = do_s + (row0 + r) * w;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = lane + 32 * half;
          if (j < nk) {
            const float* krow = k_s + j * ks;
            const float* vrow = v_s + j * ks;
            float a = 0.f, bq = 0.f;
            for (int d = 0; d < w; ++d) {
              a = fmaf(qrow[d], krow[d], a);
              bq = fmaf(dorow[d], vrow[d], bq);
            }
            s[r][half] += a;
            dp[r][half] += bq;
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row0 + r >= nq) break;  // warp-uniform: rows past T
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = lane + 32 * half;
        float ds = 0.f;  // missing keys of a ragged tile
        if (j < nk) {
          const float p = expf(s[r][half] * scale - lse_r[r]);
          ds = p * (dp[r][half] - delta[r]) * scale;
        }
        dsrow[j] = ds;
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kColChunk / 32; ++c) {
        const int d = lane + 32 * c;
        if (d < wc) {
          float a = acc[r][c];
          for (int j = 0; j < nk; ++j)
            a = fmaf(dsrow[j], k_s[j * (wc + 1) + d], a);
          acc[r][c] = a;
        }
      }
      __syncwarp();  // dsrow is rewritten for the next row
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row0 + r >= nq) break;
    float* dqrow = dq + head + static_cast<int64_t>(q0 + row0 + r) * D +
                   cc * kColChunk;
#pragma unroll
    for (int c = 0; c < kColChunk / 32; ++c) {
      const int d = lane + 32 * c;
      if (d < wc) dqrow[d] = acc[r][c];
    }
  }
}

// bf16 dynamic shared memory, in bf16: 8 zeros, then two stages, each a K
// chunk and a V chunk of kChunk rows of stride_elems(kColChunk).
size_t chunk_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         (8 + 4 * static_cast<size_t>(attn_mma::kChunk) *
                  attn_mma::stride_elems(kColChunk));
}

__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_chunk_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const __nv_bfloat16* __restrict__ o,
                                  const __nv_bfloat16* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  __nv_bfloat16* __restrict__ dq, int H,
                                  int seq, int D, float scale, float c,
                                  bool vec) {
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
  const int64_t ld = static_cast<int64_t>(H) * D;  // row stride of o, do
  // (b, q0, h) in the (B, T, H, D) layout of o and do
  const int64_t bthd = ((static_cast<int64_t>(b) * seq + q0) * H + h) * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nq = min(kMmaTileQ, seq - q0);
  const int row0 = 16 * warp;  // this warp's first row in the block's tile
  const bool active = row0 < nq;  // warp-uniform
  const int nc = col_chunks(D);
  const int cc = blockIdx.y;  // the block's chunk of dq
  const int wc = chunk_width(D, cc);

  // step i: key tile i / nc against column chunk (cc + 1 + i % nc) % nc, so
  // that a tile's last step is the block's own chunk
  auto chunk_of = [&](int i) { return (cc + 1 + i % nc) % nc; };
  auto stage = [&](int i) {
    const int k0 = i / nc * kChunk;
    const int n = min(kChunk, seq - k0);
    const int e = chunk_of(i);
    const int64_t off =
        head + static_cast<int64_t>(k0) * D + e * kColChunk;
    __nv_bfloat16* dst = ring + (i & 1) * 2 * tile;
    stage_rows(dst, k + off, D, n, chunk_width(D, e), vec, threadIdx.x,
               kMmaThreads);
    stage_rows(dst + tile, v + off, D, n, chunk_width(D, e), vec, threadIdx.x,
               kMmaThreads);
    cp_async_commit();
  };

  stage(0);
  if (threadIdx.x < 8) zeros[threadIdx.x] = __float2bfloat16(0.f);
  // rows g and g+8 of the warp's 16: lse in log2 units and delta, both 0
  // past T (so that ds is 0 there)
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[kColChunk / 16][4];  // one chunk of q or dO rows at a time
  float lse2[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  if (active) {
    for (int e = 0; e < nc; ++e) {
      const int we = chunk_width(D, e);
      float part[2];
      load_rows_a<kColChunk>(a, dout + bthd + e * kColChunk, ld, row0, nq,
                             we, lane);
      rows_dot<kColChunk>(part, a, o + bthd + e * kColChunk, ld, row0, nq, we,
                          lane);
      delta[0] += part[0];
      delta[1] += part[1];
    }
    const float* lse_rows = lse + static_cast<int64_t>(bh) * seq + q0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + g + 8 * i;
      if (r < nq) lse2[i] = lse_rows[r] * kLog2e;
    }
  }
  float acc[kColChunk / 8][4];
#pragma unroll
  for (int nb = 0; nb < kColChunk / 8; ++nb)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[nb][x] = 0.f;

  float s[kChunk / 8][4], dp[kChunk / 8][4];
  const int steps = (seq + kChunk - 1) / kChunk * nc;
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
          for (int x = 0; x < 4; ++x) s[nb][x] = dp[nb][x] = 0.f;
      }
      load_rows_a<kColChunk>(
          a, q + head + static_cast<int64_t>(q0) * D + e * kColChunk, D, row0,
          nq, we, lane);
      chunk_logits<kColChunk>(s, a, kt, 0, n, n, we, zeros, lane);
      load_rows_a<kColChunk>(a, dout + bthd + e * kColChunk, ld, row0, nq, we,
                             lane);
      chunk_logits<kColChunk>(dp, a, kt + tile, 0, n, n, we, zeros, lane);
      if (e == cc) {
#pragma unroll
        for (int nb = 0; nb < kChunk / 8; ++nb)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int key = 8 * nb + 2 * t + (x & 1);
            const float p =
                key < n ? exp2f(s[nb][x] * c - lse2[x >> 1]) : 0.f;
            s[nb][x] = p * (dp[nb][x] - delta[x >> 1]) * scale;  // ds
          }
#pragma unroll
        for (int kb = 0; kb < kChunk / 16; ++kb) {
          if (16 * kb >= n) break;  // warp-uniform
          mma_p_b<kColChunk>(acc, s[2 * kb], s[2 * kb + 1], kt, 16 * kb, n,
                             wc, zeros, lane);
        }
      }
    }
    __syncthreads();  // step i is no longer read
  }
  if (active)
    store_rows<kColChunk>(acc,
                          dq + head + static_cast<int64_t>(q0) * D +
                              cc * kColChunk,
                          D, row0, nq, wc, lane);
}

cudaError_t launch_f32_for_d(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* dq, int B, int H, int seq, int D,
                             float scale, cudaStream_t s) {
  if (D <= 32)
    return launch_f32<1>(q, k, v, o, dout, lse, dq, B, H, seq, D, scale, s);
  if (D <= 64)
    return launch_f32<2>(q, k, v, o, dout, lse, dq, B, H, seq, D, scale, s);
  if (D <= kColChunk)
    return launch_f32<4>(q, k, v, o, dout, lse, dq, B, H, seq, D, scale, s);
  const int tiles = (seq + kTileQ - 1) / kTileQ;
  return launch_with_smem(
      flash_bwd_dq_chunk_kernel, dim3(B * H * tiles, col_chunks(D)), kThreads,
      chunk_smem_bytes(), s, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(dq), H, seq, D,
      scale);
}

cudaError_t launch_mma_for_d(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* dq, int B, int H, int seq, int D,
                             float scale, cudaStream_t s) {
  if (D <= 16)
    return launch_mma<16>(q, k, v, o, dout, lse, dq, B, H, seq, D, scale, s);
  if (D <= 32)
    return launch_mma<32>(q, k, v, o, dout, lse, dq, B, H, seq, D, scale, s);
  if (D <= 64)
    return launch_mma<64>(q, k, v, o, dout, lse, dq, B, H, seq, D, scale, s);
  if (D <= kColChunk)
    return launch_mma<128>(q, k, v, o, dout, lse, dq, B, H, seq, D, scale, s);
  const int tiles = (seq + kMmaTileQ - 1) / kMmaTileQ;
  const bool vec = attn_mma::can_copy_chunks(D, k, v);
  return launch_with_smem(
      flash_bwd_dq_chunk_mma_kernel, dim3(B * H * tiles, col_chunks(D)),
      kMmaThreads, chunk_mma_smem_bytes(), s,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<__nv_bfloat16*>(dq), H, seq, D, scale,
      scale * attn_mma::kLog2e, vec);
}

}  // namespace

// q, k, v: (B, H, T, D) contiguous; o, dout: (B, T, H, D) contiguous, same
// type; lse: (B, H, T) float32; dq: (B, H, T, D), same type as q.  Any D;
// dtype 0 is float32, 1 is bfloat16.  Returns the cudaError_t of the launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* dq, int B, int H, int T, int D, float scale,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_f32_for_d(q, k, v, o, dout, lse, dq, B, H, T, D, scale,
                              s);
    case 1:
      return launch_mma_for_d(q, k, v, o, dout, lse, dq, B, H, T, D, scale,
                              s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory one launch needs, in bytes: the larger of the
// two instances' needs, which depend on D alone and stop growing past
// kColChunk.
extern "C" long long flash_bwd_dq_smem_bytes(int T, int D) {
  (void)T;
  const size_t f32 = D <= kColChunk ? smem_bytes(D) : chunk_smem_bytes();
  const size_t bf16 =
      D <= kColChunk ? mma_smem_bytes(D) : chunk_mma_smem_bytes();
  return static_cast<long long>(f32 > bf16 ? f32 : bf16);
}
