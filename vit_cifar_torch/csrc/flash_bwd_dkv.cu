// Tiled ("flash") attention backward, the key and value gradients, for
// Hopper (sm_90a), at any T.
//
// Replaces the TPU kernel
// vit_cifar_tpu/ops/pallas/attention.py::_flash_bwd_dkv_kernel (pass 2 of
// _flash_bwd_impl) where flash_attention's custom VJP reaches it.  For
// every (batch, head) and key row j:
//   p_ij = exp(q_i . k_j * scale - lse_i),  dp_ij = do_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i) * scale,  delta_i = sum_d do_i * o_i
//   dv_j = sum_i p_ij do_i,   dk_j = sum_i ds_ij q_i
// in f32 whatever the input type; lse is the forward's (flash_fwd.cu).  o
// and do are read in place in the (B, T, H, D) layout that flash_attention
// returns; dk and dv are written in (B, H, T, D) in the input type.
//
// What bounds it on this card: at the pixel-token ViT's shape (128, 12,
// 1025, 32) one head is four 1025x1025x32 products (q.k, do.v, p^T.do,
// ds^T.q) and 1.05 M exps against about 0.46 MB in and out in bf16, some
// 900 FLOP per byte: arithmetic, not device memory, bounds it, the
// products at the tensor cores' peak a little more than the exps.
//
//   bf16 (dtype 1), on the tensor cores (mma_attention.cuh): the forward
//   with the roles of the rows swapped.  One block of 4 warps per (b, h,
//   64 keys); a warp owns 16 keys, their K and V rows as A fragments and
//   their dk and dv accumulators in registers.  The loop runs over tiles
//   of 64 query rows: Q and dO (row stride H*D, do being (B, T, H, D)) are
//   staged as bf16 by cp.async, two stages deep, and beside them the
//   tile's lse (times log2(e)) and delta in shared memory.  delta is
//   recomputed for every query tile from o and dO, as the TPU kernel does:
//   the dq pass computes it too, but handing it over would need a (B, H,
//   T) buffer between the two launches, for under 1% of this kernel's
//   products.  For each 16 query rows of a tile: s^T = k.q^T and dp^T =
//   v.dO^T (mma.sync.m16n8k16, Q and dO through ldmatrix), p^T =
//   exp2(s^T * scale*log2(e) - lse*log2(e)) with the columns' lse, ds^T =
//   p^T * (dp^T - delta) * scale, then dv += p^T.dO and dk += ds^T.Q with
//   p^T and ds^T repacked as A fragments and split into bf16 hi + lo (so
//   that both keep f32 accuracy, as the TPU kernel keeps them), dO and Q
//   through ldmatrix.trans.  No atomics, and no block depends on another.
//   Query rows past T read zeros and get lse = +inf and delta = 0, so p^T
//   and ds^T are 0 there; keys past T are never written, and a warp whose
//   16 keys all lie past T computes nothing; columns past D read zeros
//   (any D up to 128).  Up to D = 64 a warp keeps its K and V fragments in
//   registers for the whole loop; at D = 128 it reloads them from shared
//   memory for every 16 query rows, which keeps its registers (dk and dv
//   alone take 128 a thread there) under the limit.
//
//   f32 (dtype 0), on the CUDA cores.  The tensor cores would take f32 only
//   as TF32, whose 10-bit mantissa breaks the 1e-5 the f32 path is held
//   to; so f32 keeps the first design: one block of 8 warps per 64 keys,
//   K, V, Q and dO converted into f32 shared memory (Q and dO with a row
//   stride of D+1), each warp walking its 8 keys with lanes over query
//   rows for p and ds and over d for p^T.dO and ds^T.Q.  This is a
//   dispatch by dtype, not a fallback.
//
// Heads wider than kColChunk = 128 columns (the TPU kernel pads D to a
// multiple of 128 and runs any D) are cut into column chunks of 128, and a
// second grid axis gives each output chunk its own blocks, whose registers
// and shared memory are those of a 128-column head whatever D is.  s^T and
// dp^T are summed over the chunks for a whole tile of 64 query rows (kept in
// registers), one staged chunk of Q and dO at a time, the block's own chunk
// last; that step turns them into p^T and ds^T and adds p^T.dO and ds^T.Q
// into the block's chunks.  They are recomputed for every output chunk.
//   bf16: dk and dv of a chunk get separate blocks (2 * ceil(D/128) of them
//   per 64 keys), so that a thread holds one 128-column accumulator, as dq
//   does; a dv block needs only s^T, so it stages dO for its own chunk
//   alone.  The warp's K (and V) fragments of a chunk are read from device
//   memory at each step; a query tile's lse and delta are computed at its
//   first step into one of two slots, by tile parity.
//   f32: one block computes both chunks of dk and dv; each chunk of the
//   block's K and V rows and of the query tile's Q and dO is staged in f32
//   shared memory in turn, lanes over query rows as above.
//
// Shared memory does not grow with T or D, so any T and any D run.  Offsets
// are int64; nothing is padded in device memory.
//
// Built by vit_cifar_torch/ops/cuda/build.py (nvcc, sm_90a, plain C
// interface bound with ctypes).

#include <math_constants.h>

#include <cstdint>

#include "attention_common.cuh"
#include "mma_attention.cuh"

namespace {

using namespace attn;

// ---- f32: the CUDA-core instance -----------------------------------------
constexpr int kRows = 8;                 // keys per warp
constexpr int kTileK = kRows * kWarps;   // keys per block
constexpr int kTileQ = 64;               // query rows per tile: two per lane

// Dynamic shared memory, in floats:
//   K      kTileK * D         (the block's keys)
//   V      kTileK * D         (their values)
//   Q      kTileQ * (D + 1)   (the query tile, padded row stride)
//   dO     kTileQ * (D + 1)
//   lse    kTileQ
//   delta  kTileQ
//   p      kWarps * kTileQ    (each warp's column of p)
//   ds     kWarps * kTileQ    (each warp's column of ds)
template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int seq, int D,
                         float scale) {
  extern __shared__ float smem[];
  const int qs = D + 1;
  float* k_s = smem;
  float* v_s = k_s + kTileK * D;
  float* q_s = v_s + kTileK * D;
  float* do_s = q_s + kTileQ * qs;
  float* lse_s = do_s + kTileQ * qs;
  float* delta_s = lse_s + kTileQ;
  float* p_s = delta_s + kTileQ;
  float* ds_s = p_s + kWarps * kTileQ;

  const int tiles = (seq + kTileK - 1) / kTileK;
  const int bh = blockIdx.x / tiles;  // b * H + h
  const int k0 = (blockIdx.x - bh * tiles) * kTileK;
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t head = static_cast<int64_t>(bh) * seq * D;
  const int64_t row0 = static_cast<int64_t>(b) * seq * H + h;  // (b, 0, h)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nk = min(kTileK, seq - k0);

  for (int idx = threadIdx.x; idx < nk * D; idx += kThreads) {
    const int64_t g = head + static_cast<int64_t>(k0) * D + idx;
    k_s[idx] = to_f32(k[g]);
    v_s[idx] = to_f32(v[g]);
  }

  float dk_acc[kRows][kCols], dv_acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  }

  const int key0 = warp * kRows;  // this warp's first key in the tile
  float* pcol = p_s + warp * kTileQ;
  float* dscol = ds_s + warp * kTileQ;
  for (int q0 = 0; q0 < seq; q0 += kTileQ) {
    const int nq = min(kTileQ, seq - q0);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < nq * D; idx += kThreads) {
      const int i = idx / D;
      const int d = idx - i * D;
      q_s[i * qs + d] = to_f32(q[head + static_cast<int64_t>(q0) * D + idx]);
      do_s[i * qs + d] =
          to_f32(dout[(row0 + static_cast<int64_t>(q0 + i) * H) * D + d]);
    }
    for (int i = threadIdx.x; i < nq; i += kThreads)
      lse_s[i] = lse[static_cast<int64_t>(bh) * seq + q0 + i];
    __syncthreads();
    // delta of the tile's rows, recomputed per tile as the TPU kernel does
    for (int i = warp; i < nq; i += kWarps) {
      const T* orow = o + (row0 + static_cast<int64_t>(q0 + i) * H) * D;
      float a = 0.f;
      for (int d = lane; d < D; d += 32)
        a = fmaf(do_s[i * qs + d], to_f32(orow[d]), a);
      a = warp_sum(a);
      if (lane == 0) delta_s[i] = a;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (key0 + r >= nk) break;  // warp-uniform: keys past T
      const float* krow = k_s + (key0 + r) * D;
      const float* vrow = v_s + (key0 + r) * D;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = lane + 32 * half;
        float p = 0.f, ds = 0.f;  // missing rows of a ragged tile
        if (i < nq) {
          const float* qi = q_s + i * qs;
          const float* doi = do_s + i * qs;
          float s = 0.f, dp = 0.f;
          for (int d = 0; d < D; ++d) {
            s = fmaf(qi[d], krow[d], s);
            dp = fmaf(doi[d], vrow[d], dp);
          }
          p = expf(s * scale - lse_s[i]);
          ds = p * (dp - delta_s[i]) * scale;
        }
        pcol[i] = p;
        dscol[i] = ds;
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          float av = dv_acc[r][c], ak = dk_acc[r][c];
          for (int i = 0; i < nq; ++i) {
            av = fmaf(pcol[i], do_s[i * qs + d], av);
            ak = fmaf(dscol[i], q_s[i * qs + d], ak);
          }
          dv_acc[r][c] = av;
          dk_acc[r][c] = ak;
        }
      }
      __syncwarp();  // pcol and dscol are rewritten for the next key
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (key0 + r >= nk) break;
    const int64_t out_row = head + static_cast<int64_t>(k0 + key0 + r) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk[out_row + d] = from_f32<T>(dk_acc[r][c]);
        dv[out_row + d] = from_f32<T>(dv_acc[r][c]);
      }
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * (2 * static_cast<size_t>(kTileK) * D +
                          2 * static_cast<size_t>(kTileQ) * (D + 1) +
                          2 * kTileQ + 2 * kWarps * kTileQ);
}

template <int kCols>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* lse,
                       void* dk, void* dv, int B, int H, int seq, int D,
                       float scale, cudaStream_t stream) {
  const int tiles = (seq + kTileK - 1) / kTileK;
  return launch_with_smem(
      flash_bwd_dkv_kernel<float, kCols>, B * H * tiles, kThreads,
      smem_bytes(D), stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(dk),
      static_cast<float*>(dv), H, seq, D, scale);
}

// ---- bf16: the tensor-core instance --------------------------------------
constexpr int kMmaWarps = 4;
constexpr int kMmaTileK = 16 * kMmaWarps;  // keys per block
constexpr int kMmaThreads = 32 * kMmaWarps;
static_assert(kMmaThreads == 2 * attn_mma::kChunk,
              "stage() gives each query row of a tile two threads");

// Dynamic shared memory: in bf16, 8 zeros (the chunk that rows past a tile
// and columns past D read), then the block's K rows, its V rows, Q stage 0,
// Q stage 1, dO stage 0, dO stage 1, each kChunk rows of stride_elems(D);
// then in f32 the query tiles' lse (log2 units) and delta, kChunk each for
// each of the two stages.
size_t mma_smem_bytes(int D) {
  return sizeof(__nv_bfloat16) *
             (8 + 6 * static_cast<size_t>(attn_mma::kChunk) *
                      attn_mma::stride_elems(D)) +
         sizeof(float) * 4 * attn_mma::kChunk;
}

// acc + the dot product of 8 bf16 pairs, x and y 16 bytes each, in f32.
__device__ __forceinline__ float dot8(uint4 x, uint4 y, float acc) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the top half of the f32 of the same value
    acc = fmaf(__uint_as_float(xs[i] << 16), __uint_as_float(ys[i] << 16),
               acc);
    acc = fmaf(__uint_as_float(xs[i] & 0xffff0000u),
               __uint_as_float(ys[i] & 0xffff0000u), acc);
  }
  return acc;
}

// kRegs: the warp keeps its K and V fragments in registers for the whole
// loop (else it reloads them from shared memory for every 16 query rows).
template <int kDp, bool kRegs>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ o,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int H, int seq,
                             int D, float scale, float c, bool vec) {
  using namespace attn_mma;
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf16[];
  const int tile = kChunk * stride_elems(D);
  __nv_bfloat16* zeros = smem_bf16;
  __nv_bfloat16* k_s = smem_bf16 + 8;
  __nv_bfloat16* v_s = k_s + tile;
  __nv_bfloat16* q_s = v_s + tile;   // stage i at q_s + i * tile
  __nv_bfloat16* do_s = q_s + 2 * tile;
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * tile);  // + i * kChunk
  float* delta_s = lse_s + 2 * kChunk;

  const int tiles = (seq + kMmaTileK - 1) / kMmaTileK;
  const int bh = blockIdx.x / tiles;  // b * H + h
  const int k0 = (blockIdx.x - bh * tiles) * kMmaTileK;
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t head = static_cast<int64_t>(bh) * seq * D;
  const int64_t ld = static_cast<int64_t>(H) * D;  // row stride of o, do
  // (b, 0, h) in the (B, T, H, D) layout of o and do
  const int64_t bthd = (static_cast<int64_t>(b) * seq * H + h) * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nk = min(kMmaTileK, seq - k0);
  const int key0 = 16 * warp;  // this warp's first key in the block's tile
  const bool active = key0 < nk;  // warp-uniform

  // query tile it: Q and dO by cp.async, then the rows' lse and delta (two
  // threads a row, each over every other 8-column chunk, or every other
  // column without vec), +inf and 0 past T
  auto stage = [&](int it) {
    const int q0 = it * kChunk;
    const int n = min(kChunk, seq - q0);
    stage_rows(q_s + (it & 1) * tile, q + head + static_cast<int64_t>(q0) * D,
               D, n, D, vec, threadIdx.x, kMmaThreads);
    stage_rows(do_s + (it & 1) * tile, dout + bthd + q0 * ld, ld, n, D, vec,
               threadIdx.x, kMmaThreads);
    cp_async_commit();
    const int r = threadIdx.x >> 1;
    float a = 0.f;
    if (r < n) {
      const int64_t row = bthd + (q0 + r) * ld;
      if (vec) {
        for (int ch = threadIdx.x & 1; ch < D / 8; ch += 2)
          a = dot8(*reinterpret_cast<const uint4*>(dout + row + 8 * ch),
                   *reinterpret_cast<const uint4*>(o + row + 8 * ch), a);
      } else {
        for (int d = threadIdx.x & 1; d < D; d += 2)
          a = fmaf(__bfloat162float(dout[row + d]),
                   __bfloat162float(o[row + d]), a);
      }
    }
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    if ((threadIdx.x & 1) == 0) {
      lse_s[(it & 1) * kChunk + r] =
          r < n ? lse[static_cast<int64_t>(bh) * seq + q0 + r] * kLog2e
                : CUDART_INF_F;
      delta_s[(it & 1) * kChunk + r] = a;
    }
  };

  if (threadIdx.x < 8) zeros[threadIdx.x] = __float2bfloat16(0.f);
  stage_rows(k_s, k + head + static_cast<int64_t>(k0) * D, D, nk, D, vec,
             threadIdx.x, kMmaThreads);
  stage_rows(v_s, v + head + static_cast<int64_t>(k0) * D, D, nk, D, vec,
             threadIdx.x, kMmaThreads);
  stage(0);
  cp_async_wait<0>();
  __syncthreads();

  const int t = lane & 3;
  uint32_t ka[kDp / 16][4], va[kDp / 16][4];
  if constexpr (kRegs) {
    if (active) {
      load_a<kDp>(ka, k_s, key0, nk, D, zeros, lane);
      load_a<kDp>(va, v_s, key0, nk, D, zeros, lane);
    }
  }
  float dk_acc[kDp / 8][4], dv_acc[kDp / 8][4];
#pragma unroll
  for (int nb = 0; nb < kDp / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nb][e] = dv_acc[nb][e] = 0.f;

  const int nqt = (seq + kChunk - 1) / kChunk;
  for (int it = 0; it < nqt; ++it) {
    if (it + 1 < nqt) {
      stage(it + 1);  // its buffers were last read before the previous sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it has landed for every thread
    if (active) {
      const int n = min(kChunk, seq - it * kChunk);
      const __nv_bfloat16* qt = q_s + (it & 1) * tile;
      const __nv_bfloat16* dot_s = do_s + (it & 1) * tile;
      const float* lt = lse_s + (it & 1) * kChunk;
      const float* dlt = delta_s + (it & 1) * kChunk;
#pragma unroll
      for (int kb = 0; kb < kChunk / 16; ++kb) {
        if (16 * kb >= n) break;  // warp-uniform
        float s[2][4] = {}, dp[2][4] = {};
        if constexpr (!kRegs) load_a<kDp>(ka, k_s, key0, nk, D, zeros, lane);
        mma_a_bt<kDp>(s[0], s[1], ka, qt, 16 * kb, n, D, zeros, lane);
        if constexpr (!kRegs) load_a<kDp>(va, v_s, key0, nk, D, zeros, lane);
        mma_a_bt<kDp>(dp[0], dp[1], va, dot_s, 16 * kb, n, D, zeros, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // this thread's columns 2t and 2t+1 of the 8 at 16kb + 8j
          const int col = 16 * kb + 8 * j + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(lt + col);
          const float2 d2 = *reinterpret_cast<const float2*>(dlt + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lc = e & 1 ? l2.y : l2.x;
            const float dc = e & 1 ? d2.y : d2.x;
            const float p = exp2f(s[j][e] * c - lc);  // lse +inf: p = 0
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - dc) * scale;  // ds^T
          }
        }
        mma_p_b<kDp>(dv_acc, s[0], s[1], dot_s, 16 * kb, n, D, zeros, lane);
        mma_p_b<kDp>(dk_acc, dp[0], dp[1], qt, 16 * kb, n, D, zeros, lane);
      }
    }
    __syncthreads();  // tile it is no longer read
  }
  if (active) {
    const int64_t out = head + static_cast<int64_t>(k0) * D;
    store_rows<kDp>(dk_acc, dk + out, D, key0, nk, D, lane);
    store_rows<kDp>(dv_acc, dv + out, D, key0, nk, D, lane);
  }
}

template <int kDp>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* lse,
                       void* dk, void* dv, int B, int H, int seq, int D,
                       float scale, cudaStream_t stream) {
  const int tiles = (seq + kMmaTileK - 1) / kMmaTileK;
  const bool vec = attn_mma::can_copy_chunks(D, q, k, v, o, dout);
  return launch_with_smem(
      flash_bwd_dkv_mma_kernel<kDp, (kDp <= 64)>, B * H * tiles, kMmaThreads,
      mma_smem_bytes(D), stream, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, seq,
      D, scale, scale * attn_mma::kLog2e, vec);
}

// ---- past kColChunk columns: blocks per (b, h, 64 keys, column chunk) ---
// f32 dynamic shared memory, in floats: the block's K and V rows, one
// column chunk (kTileK * kColChunk each); the query tile's Q and dO, the
// same chunk (kTileQ * (kColChunk + 1) each); the tile's lse and delta;
// each warp's columns of p and ds.
size_t chunk_smem_bytes() {
  return sizeof(float) * (2 * static_cast<size_t>(kTileK) * kColChunk +
                          2 * static_cast<size_t>(kTileQ) * (kColChunk + 1) +
                          2 * kTileQ + 2 * kWarps * kTileQ);
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_chunk_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ o,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               float* __restrict__ dk, float* __restrict__ dv,
                               int H, int seq, int D, float scale) {
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTileK * kColChunk;
  float* q_s = v_s + kTileK * kColChunk;
  float* do_s = q_s + kTileQ * (kColChunk + 1);
  float* lse_s = do_s + kTileQ * (kColChunk + 1);
  float* delta_s = lse_s + kTileQ;
  float* p_s = delta_s + kTileQ;
  float* ds_s = p_s + kWarps * kTileQ;

  const int tiles = (seq + kTileK - 1) / kTileK;
  const int bh = blockIdx.x / tiles;  // b * H + h
  const int k0 = (blockIdx.x - bh * tiles) * kTileK;
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t head = static_cast<int64_t>(bh) * seq * D;
  const int64_t row0 = static_cast<int64_t>(b) * seq * H + h;  // (b, 0, h)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nk = min(kTileK, seq - k0);
  const int nc = col_chunks(D);
  const int cc = blockIdx.y;  // the block's chunk of dk and dv
  const int wc = chunk_width(D, cc);

  float dk_acc[kRows][kColChunk / 32], dv_acc[kRows][kColChunk / 32];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kColChunk / 32; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  }

  const int key0 = warp * kRows;  // this warp's first key in the tile
  float* pcol = p_s + warp * kTileQ;
  float* dscol = ds_s + warp * kTileQ;
  for (int q0 = 0; q0 < seq; q0 += kTileQ) {
    const int nq = min(kTileQ, seq - q0);
    __syncthreads();  // the previous tile's lse and delta are no longer read
    for (int i = threadIdx.x; i < nq; i += kThreads)
      lse_s[i] = lse[static_cast<int64_t>(bh) * seq + q0 + i];
    // delta of the tile's rows, recomputed per tile as the TPU kernel does
    for (int i = warp; i < nq; i += kWarps) {
      const int64_t row = (row0 + static_cast<int64_t>(q0 + i) * H) * D;
      float a = 0.f;
      for (int d = lane; d < D; d += 32) a = fmaf(dout[row + d], o[row + d], a);
      a = warp_sum(a);
      if (lane == 0) delta_s[i] = a;
    }
    float sT[kRows][2], dpT[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      sT[r][0] = sT[r][1] = dpT[r][0] = dpT[r][1] = 0.f;
    // the block's own chunk last: its Q and dO stay staged for the sums
    for (int step = 1; step <= nc; ++step) {
      const int e = (cc + step) % nc;
      const int w = chunk_width(D, e);
      const int qs = w + 1;
      const int col = e * kColChunk;
      __syncthreads();  // the previous chunk is no longer read
      for (int idx = threadIdx.x; idx < nk * w; idx += kThreads) {
        const int j = idx / w;
        const int64_t g = head + static_cast<int64_t>(k0 + j) * D + col + idx -
                          j * w;
        k_s[idx] = k[g];
        v_s[idx] = v[g];
      }
      for (int idx = threadIdx.x; idx < nq * w; idx += kThreads) {
        const int i = idx / w;
        const int d = idx - i * w;
        q_s[i * qs + d] = q[head + static_cast<int64_t>(q0 + i) * D + col + d];
        do_s[i * qs + d] =
            dout[(row0 + static_cast<int64_t>(q0 + i) * H) * D + col + d];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (key0 + r >= nk) break;  // warp-uniform: keys past T
        const float* krow = k_s + (key0 + r) * w;
        const float* vrow = v_s + (key0 + r) * w;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = lane + 32 * half;
          if (i < nq) {
            const float* qi = q_s + i * qs;
            const float* doi = do_s + i * qs;
            float a = 0.f, bq = 0.f;
            for (int d = 0; d < w; ++d) {
              a = fmaf(qi[d], krow[d], a);
              bq = fmaf(doi[d], vrow[d], bq);
            }
            sT[r][half] += a;
            dpT[r][half] += bq;
          }
        }
      }
    }

    const int qs = wc + 1;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (key0 + r >= nk) break;  // warp-uniform: keys past T
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = lane + 32 * half;
        float p = 0.f, ds = 0.f;  // missing rows of a ragged tile
        if (i < nq) {
          p = expf(sT[r][half] * scale - lse_s[i]);
          ds = p * (dpT[r][half] - delta_s[i]) * scale;
        }
        pcol[i] = p;
        dscol[i] = ds;
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kColChunk / 32; ++c) {
        const int d = lane + 32 * c;
        if (d < wc) {
          float av = dv_acc[r][c], ak = dk_acc[r][c];
          for (int i = 0; i < nq; ++i) {
            av = fmaf(pcol[i], do_s[i * qs + d], av);
            ak = fmaf(dscol[i], q_s[i * qs + d], ak);
          }
          dv_acc[r][c] = av;
          dk_acc[r][c] = ak;
        }
      }
      __syncwarp();  // pcol and dscol are rewritten for the next key
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (key0 + r >= nk) break;
    const int64_t out_row =
        head + static_cast<int64_t>(k0 + key0 + r) * D + cc * kColChunk;
#pragma unroll
    for (int c = 0; c < kColChunk / 32; ++c) {
      const int d = lane + 32 * c;
      if (d < wc) {
        dk[out_row + d] = dk_acc[r][c];
        dv[out_row + d] = dv_acc[r][c];
      }
    }
  }
}

// bf16 dynamic shared memory: in bf16, 8 zeros, then two stages, each a Q
// chunk and a dO chunk of kChunk rows of stride_elems(kColChunk); then in
// f32 the lse (log2 units) and delta of two query tiles, kChunk each.
size_t chunk_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
             (8 + 4 * static_cast<size_t>(attn_mma::kChunk) *
                      attn_mma::stride_elems(kColChunk)) +
         sizeof(float) * 4 * attn_mma::kChunk;
}

__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkv_chunk_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                   const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v,
                                   const __nv_bfloat16* __restrict__ o,
                                   const __nv_bfloat16* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   __nv_bfloat16* __restrict__ dk,
                                   __nv_bfloat16* __restrict__ dv, int H,
                                   int seq, int D, float scale, float c,
                                   bool vec) {
  using namespace attn_mma;
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf16[];
  const int tile = kChunk * stride_elems(kColChunk);
  __nv_bfloat16* zeros = smem_bf16;
  __nv_bfloat16* ring = smem_bf16 + 8;  // stage i: Q at + 2i*tile, then dO
  float* lse_s = reinterpret_cast<float*>(ring + 4 * tile);  // + slot*kChunk
  float* delta_s = lse_s + 2 * kChunk;

  const int tiles = (seq + kMmaTileK - 1) / kMmaTileK;
  const int bh = blockIdx.x / tiles;  // b * H + h
  const int k0 = (blockIdx.x - bh * tiles) * kMmaTileK;
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t head = static_cast<int64_t>(bh) * seq * D;
  const int64_t ld = static_cast<int64_t>(H) * D;  // row stride of o, do
  // (b, 0, h) in the (B, T, H, D) layout of o and do
  const int64_t bthd = (static_cast<int64_t>(b) * seq * H + h) * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nk = min(kMmaTileK, seq - k0);
  const int key0 = 16 * warp;  // this warp's first key in the block's tile
  const bool active = key0 < nk;  // warp-uniform
  const int nc = col_chunks(D);
  const bool dv_block = blockIdx.y >= nc;  // else a dk block
  const int cc = blockIdx.y - (dv_block ? nc : 0);  // the block's chunk
  const int wc = chunk_width(D, cc);

  // step i: query tile i / nc against column chunk (cc + 1 + i % nc) % nc,
  // so that a tile's last step is the block's own chunk; a dv block stages
  // dO for that step alone.  A tile's first step also writes its rows' lse
  // and delta (two threads a row, +inf and 0 past T) into slot tile % 2.
  auto chunk_of = [&](int i) { return (cc + 1 + i % nc) % nc; };
  auto stage = [&](int i) {
    const int it = i / nc;
    const int q0 = it * kChunk;
    const int n = min(kChunk, seq - q0);
    const int e = chunk_of(i);
    const int we = chunk_width(D, e);
    __nv_bfloat16* dst = ring + (i & 1) * 2 * tile;
    stage_rows(dst, q + head + static_cast<int64_t>(q0) * D + e * kColChunk,
               D, n, we, vec, threadIdx.x, kMmaThreads);
    if (!dv_block || e == cc)
      stage_rows(dst + tile, dout + bthd + q0 * ld + e * kColChunk, ld, n, we,
                 vec, threadIdx.x, kMmaThreads);
    cp_async_commit();
    if (i % nc == 0) {  // block-uniform
      const int r = threadIdx.x >> 1;
      float a = 0.f;
      if (r < n) {
        const int64_t row = bthd + (q0 + r) * ld;
        if (vec) {
          for (int ch = threadIdx.x & 1; ch < D / 8; ch += 2)
            a = dot8(*reinterpret_cast<const uint4*>(dout + row + 8 * ch),
                     *reinterpret_cast<const uint4*>(o + row + 8 * ch), a);
        } else {
          for (int d = threadIdx.x & 1; d < D; d += 2)
            a = fmaf(__bfloat162float(dout[row + d]),
                     __bfloat162float(o[row + d]), a);
        }
      }
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      if ((threadIdx.x & 1) == 0) {
        lse_s[(it & 1) * kChunk + r] =
            r < n ? lse[static_cast<int64_t>(bh) * seq + q0 + r] * kLog2e
                  : CUDART_INF_F;
        delta_s[(it & 1) * kChunk + r] = a;
      }
    }
  };

  stage(0);
  if (threadIdx.x < 8) zeros[threadIdx.x] = __float2bfloat16(0.f);
  const int t = lane & 3;
  uint32_t a[kColChunk / 16][4];  // one chunk of K or V rows at a time
  float acc[kColChunk / 8][4];
#pragma unroll
  for (int nb = 0; nb < kColChunk / 8; ++nb)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[nb][x] = 0.f;

  float sT[kChunk / 8][4], dpT[kChunk / 8][4];
  const int steps = (seq + kChunk - 1) / kChunk * nc;
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) {
      stage(i + 1);  // its buffers were last read before the previous sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step i has landed for every thread
    if (active) {
      const int it = i / nc;
      const int n = min(kChunk, seq - it * kChunk);
      const int e = chunk_of(i);
      const int we = chunk_width(D, e);
      const __nv_bfloat16* qt = ring + (i & 1) * 2 * tile;
      const __nv_bfloat16* dot_s = qt + tile;
      if (i % nc == 0) {
#pragma unroll
        for (int nb = 0; nb < kChunk / 8; ++nb)
#pragma unroll
          for (int x = 0; x < 4; ++x) sT[nb][x] = dpT[nb][x] = 0.f;
      }
      const int64_t keys = head + static_cast<int64_t>(k0) * D + e * kColChunk;
      load_rows_a<kColChunk>(a, k + keys, D, key0, nk, we, lane);
      chunk_logits<kColChunk>(sT, a, qt, 0, n, n, we, zeros, lane);
      if (!dv_block) {
        load_rows_a<kColChunk>(a, v + keys, D, key0, nk, we, lane);
        chunk_logits<kColChunk>(dpT, a, dot_s, 0, n, n, we, zeros, lane);
      }
      if (e == cc) {
        const float* lt = lse_s + (it & 1) * kChunk;
        const float* dlt = delta_s + (it & 1) * kChunk;
#pragma unroll
        for (int nb = 0; nb < kChunk / 8; ++nb) {
          // this thread's columns 2t and 2t+1 of the 8 at 8nb
          const float2 l2 =
              *reinterpret_cast<const float2*>(lt + 8 * nb + 2 * t);
          const float2 d2 =
              *reinterpret_cast<const float2*>(dlt + 8 * nb + 2 * t);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float p = exp2f(sT[nb][x] * c - (x & 1 ? l2.y : l2.x));
            sT[nb][x] = p;  // lse +inf: p = 0
            dpT[nb][x] = p * (dpT[nb][x] - (x & 1 ? d2.y : d2.x)) * scale;
          }
        }
#pragma unroll
        for (int kb = 0; kb < kChunk / 16; ++kb) {
          if (16 * kb >= n) break;  // warp-uniform
          if (dv_block)
            mma_p_b<kColChunk>(acc, sT[2 * kb], sT[2 * kb + 1], dot_s, 16 * kb,
                               n, wc, zeros, lane);
          else
            mma_p_b<kColChunk>(acc, dpT[2 * kb], dpT[2 * kb + 1], qt, 16 * kb,
                               n, wc, zeros, lane);
        }
      }
    }
    __syncthreads();  // step i is no longer read
  }
  if (active)
    store_rows<kColChunk>(acc,
                          (dv_block ? dv : dk) + head +
                              static_cast<int64_t>(k0) * D + cc * kColChunk,
                          D, key0, nk, wc, lane);
}

cudaError_t launch_f32_for_d(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* dk, void* dv, int B, int H, int seq, int D,
                             float scale, cudaStream_t s) {
  if (D <= 32)
    return launch_f32<1>(q, k, v, o, dout, lse, dk, dv, B, H, seq, D, scale,
                         s);
  if (D <= 64)
    return launch_f32<2>(q, k, v, o, dout, lse, dk, dv, B, H, seq, D, scale,
                         s);
  if (D <= kColChunk)
    return launch_f32<4>(q, k, v, o, dout, lse, dk, dv, B, H, seq, D, scale,
                         s);
  const int tiles = (seq + kTileK - 1) / kTileK;
  return launch_with_smem(
      flash_bwd_dkv_chunk_kernel, dim3(B * H * tiles, col_chunks(D)),
      kThreads, chunk_smem_bytes(), s, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(dk),
      static_cast<float*>(dv), H, seq, D, scale);
}

cudaError_t launch_mma_for_d(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* dk, void* dv, int B, int H, int seq, int D,
                             float scale, cudaStream_t s) {
  if (D <= 16)
    return launch_mma<16>(q, k, v, o, dout, lse, dk, dv, B, H, seq, D, scale,
                          s);
  if (D <= 32)
    return launch_mma<32>(q, k, v, o, dout, lse, dk, dv, B, H, seq, D, scale,
                          s);
  if (D <= 64)
    return launch_mma<64>(q, k, v, o, dout, lse, dk, dv, B, H, seq, D, scale,
                          s);
  if (D <= kColChunk)
    return launch_mma<128>(q, k, v, o, dout, lse, dk, dv, B, H, seq, D, scale,
                           s);
  const int tiles = (seq + kMmaTileK - 1) / kMmaTileK;
  const bool vec = attn_mma::can_copy_chunks(D, q, k, v, o, dout);
  return launch_with_smem(
      flash_bwd_dkv_chunk_mma_kernel, dim3(B * H * tiles, 2 * col_chunks(D)),
      kMmaThreads, chunk_mma_smem_bytes(), s,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, seq,
      D, scale, scale * attn_mma::kLog2e, vec);
}

}  // namespace

// q, k, v: (B, H, T, D) contiguous; o, dout: (B, T, H, D) contiguous, same
// type; lse: (B, H, T) float32; dk, dv: (B, H, T, D), same type as k and v.
// Any D; dtype 0 is float32, 1 is bfloat16.  Returns the cudaError_t of
// the launch.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* dk, void* dv, int B, int H, int T, int D,
                             float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_f32_for_d(q, k, v, o, dout, lse, dk, dv, B, H, T, D,
                              scale, s);
    case 1:
      return launch_mma_for_d(q, k, v, o, dout, lse, dk, dv, B, H, T, D,
                              scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory one launch needs, in bytes: the larger of the
// two instances' needs, which depend on D alone and stop growing past
// kColChunk.
extern "C" long long flash_bwd_dkv_smem_bytes(int T, int D) {
  (void)T;
  const size_t f32 = D <= kColChunk ? smem_bytes(D) : chunk_smem_bytes();
  const size_t bf16 =
      D <= kColChunk ? mma_smem_bytes(D) : chunk_mma_smem_bytes();
  return static_cast<long long>(f32 > bf16 ? f32 : bf16);
}
