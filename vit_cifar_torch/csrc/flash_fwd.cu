// Tiled ("flash") multi-head self-attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel vit_cifar_tpu/ops/pallas/attention.py::
// _flash_fwd_body in both its variants: the inference one (reached through
// flash_attention) and the training one (reached through the custom VJP's
// _flash_fwd), which also writes the row logsumexp.  For every (batch,
// head): s = q.k^T * scale, then the online softmax over key tiles --
// running row max m, normaliser l and unnormalised context acc, rescaled by
// exp(m_old - m_new) whenever a tile raises the max -- and finally
// o = acc / l and lse = m + log(l), all in f32 whatever the input type.  o
// is written in the (B, T, H, D) layout that flash_attention returns; lse,
// when given, is (B, H, T) f32, not the TPU's lane-broadcast (B, H, Tp, 128).
//
// What bounds it on this card: at the pixel-token ViT's shape (B, H, T, D)
// = (128, 12, 1025, 32), one head is two 1025x1025x32 products and 1.05 M
// exps against 262 KB of q, k, v and o in bf16, some 500 FLOP per byte --
// above the ~295 FLOP per byte at which the tensor cores and not device
// memory become the limit, and the exps alone (one per logit, on the
// special-function units) take longer than either.  This first version
// runs the products on the CUDA cores in f32, each FMA reading shared
// memory, and that is what bounds it; the tensor cores are later work.
// Its shared memory does not grow with T: a block holds one tile of 64
// query rows and one tile of 64 keys and values at a time, so any T works
// (the whole-head kernel mhsa_fwd.cu stops at T=792 for D=32).
//
// Layout of the work: one block per (b, h, tile of kRows*kWarps = 64 query
// rows); warp w owns rows w*kRows .. w*kRows+kRows-1 of the tile and keeps
// their m, l and acc in registers (acc spread over lanes by d).  The TPU's
// sequential innermost kv grid axis is the loop over key tiles inside the
// block; nothing carries from one block to another.  For each key tile the
// block stages K (row stride D+1, so that 32 lanes reading 32 keys at one d
// hit 32 banks) and V in shared memory; for each of its rows a warp
// computes the logits of the tile's keys (lanes over keys), the tile max
// and sum with warp shuffles, then p.V (lanes over d).  The last key tile
// is ragged: its missing keys are never read, and their logits are -inf.
// As in the TPU kernel, a tile whose logits are all -inf keeps m at -inf
// and must not turn it into NaN: exp(s - m_new) uses m_new = 0 there and
// the rescale factor of an empty history is 0.  Query rows past T are
// neither computed nor written.  Offsets into q, k, v and o are int64.
//
// Built by vit_cifar_torch/ops/cuda/build.py (nvcc, sm_90a, plain C
// interface bound with ctypes).

#include <math_constants.h>

#include <cstdint>

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kRows = 8;                 // query rows per warp
constexpr int kTileQ = kRows * kWarps;   // query rows per block
constexpr int kTileK = 64;               // keys per tile: two per lane

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

template <typename T, int kCols>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int H, int seq, int D, float scale,
                   cudaStream_t stream) {
  const int tiles = (seq + kTileQ - 1) / kTileQ;
  return launch_with_smem(
      flash_fwd_kernel<T, kCols>, B * H * tiles, smem_bytes(D), stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, seq, D, scale);
}

template <typename T>
cudaError_t launch_for_d(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int H, int seq, int D,
                         float scale, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 1>(q, k, v, out, lse, B, H, seq, D, scale, stream);
  if (D <= 64)
    return launch<T, 2>(q, k, v, out, lse, B, H, seq, D, scale, stream);
  if (D <= kMaxHeadDim)
    return launch<T, 4>(q, k, v, out, lse, B, H, seq, D, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: (B, H, T, D) contiguous; out: (B, T, H, D) contiguous, same type;
// lse: (B, H, T) float32 contiguous, or null for the inference variant.
// D <= 128; dtype 0 is float32, 1 is bfloat16.  Returns the cudaError_t of
// the launch (0 on success); the caller checks shapes.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int H, int T, int D,
                         float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_for_d<float>(q, k, v, out, lse, B, H, T, D, scale, s);
    case 1:
      return launch_for_d<__nv_bfloat16>(q, k, v, out, lse, B, H, T, D,
                                         scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory one launch needs, in bytes; it depends on D
// alone (T is taken for the interface the whole-head kernels share).
extern "C" long long flash_fwd_smem_bytes(int T, int D) {
  (void)T;
  return static_cast<long long>(smem_bytes(D));
}
