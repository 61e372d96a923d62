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
// byte: not device memory but arithmetic bounds it.  This first version
// runs the products on the CUDA cores in f32, each FMA reading shared
// memory, and that is its limit.  Unlike mhsa_bwd_dq.cu, which holds a
// whole head's K and V in shared memory and stops at T=778 for D=32, its
// shared memory does not grow with T.
//
// Layout of the work: one block per (b, h, tile of 64 query rows); warp w
// owns 8 rows and keeps their dq accumulators in registers (spread over
// lanes by d), their delta (computed once per row, when the block starts)
// and their lse.  The TPU's sequential innermost kv grid axis is the loop
// over key tiles inside the block, so no block depends on another and no
// atomics are needed.  For each tile of 64 keys the block stages K and V
// in shared memory with a row stride of D+1 (32 lanes reading 32 keys at
// one d hit 32 banks); for each of its rows a warp computes s and dp for
// the tile's keys (lanes over keys), ds into a row buffer in shared
// memory, then ds.K (lanes over d).  The last key tile is ragged: its
// missing keys are never read and their ds is 0.  Query rows past T are
// neither computed nor written.  Offsets are int64.
//
// Built by vit_cifar_torch/ops/cuda/build.py (nvcc, sm_90a, plain C
// interface bound with ctypes).

#include <cstdint>

#include "attention_common.cuh"

namespace {

using namespace attn;

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

template <typename T, int kCols>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* dq, int B, int H, int seq, int D, float scale,
                   cudaStream_t stream) {
  const int tiles = (seq + kTileQ - 1) / kTileQ;
  return launch_with_smem(
      flash_bwd_dq_kernel<T, kCols>, B * H * tiles, kThreads, smem_bytes(D),
      stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dq), H, seq, D, scale);
}

template <typename T>
cudaError_t launch_for_d(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* dq, int B, int H, int seq, int D, float scale,
                         cudaStream_t s) {
  if (D <= 32)
    return launch<T, 1>(q, k, v, o, dout, lse, dq, B, H, seq, D, scale, s);
  if (D <= 64)
    return launch<T, 2>(q, k, v, o, dout, lse, dq, B, H, seq, D, scale, s);
  if (D <= kMaxHeadDim)
    return launch<T, 4>(q, k, v, o, dout, lse, dq, B, H, seq, D, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: (B, H, T, D) contiguous; o, dout: (B, T, H, D) contiguous, same
// type; lse: (B, H, T) float32; dq: (B, H, T, D), same type as q.  D <= 128;
// dtype 0 is float32, 1 is bfloat16.  Returns the cudaError_t of the launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* dq, int B, int H, int T, int D, float scale,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_for_d<float>(q, k, v, o, dout, lse, dq, B, H, T, D,
                                 scale, s);
    case 1:
      return launch_for_d<__nv_bfloat16>(q, k, v, o, dout, lse, dq, B, H, T,
                                         D, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one launch, in bytes; it depends on D alone.
extern "C" long long flash_bwd_dq_smem_bytes(int T, int D) {
  (void)T;
  return static_cast<long long>(smem_bytes(D));
}
