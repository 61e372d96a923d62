// Fused attention backward, the key and value gradients, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// vit_cifar_tpu/ops/pallas/attention.py::_flash_bwd_dkv_kernel (pass 2 of
// _flash_bwd_impl, reached through fused_attention's custom VJP).  For
// every (batch, head) and key row j:
//   p_ij = exp(q_i . k_j * scale - lse_i),  dp_ij = do_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i) * scale,  delta_i = sum_d do_i * o_i
//   dv_j = sum_i p_ij do_i,   dk_j = sum_i ds_ij q_i
// in f32 whatever the input type; lse is the forward's (mhsa_fwd.cu).
// o and do are read in the (B, T, H, D) layout that fused_attention
// returns; dk and dv are written in (B, H, T, D) in the input type.
//
// What bounds it on this card: at the model's shape (T=65, head_dim=32) one
// head is four 65x65x32 products (q.k, do.v, p^T.do, ds^T.q), about 1.1
// MFLOP against 24 KB in and out in bf16 -- some 45 FLOP per byte, far
// under the tensor cores' ~295.  So nothing of size (T, T) reaches device
// memory: one block owns a whole head and stages Q, dO, lse and delta in
// shared memory (delta computed once per row at the start, where the TPU
// kernel recomputed it for every kv tile), and each warp works one key row
// at a time with its rows of p and ds in shared memory.  A block owns its
// head, so there are no atomics; T=65 is one tile, so there is no loop
// over query tiles and no padding.  The FMAs read shared memory, which
// bounds the kernel; Q and dO have a row stride of D+1 so that 32 lanes
// reading 32 query rows at one d hit 32 banks.
//
// Built by vit_cifar_torch/ops/cuda/build.py (nvcc, sm_90a, plain C
// interface bound with ctypes).

#include <cstdint>

#include "attention_common.cuh"

namespace {

using namespace attn;

// Dynamic shared memory, in floats:
//   Q      T * (D + 1)
//   dO     T * (D + 1)
//   lse    T
//   delta  T
//   k      kWarps * D   (this warp's key row)
//   v      kWarps * D   (this warp's value row)
//   p      kWarps * T   (this warp's column of p)
//   ds     kWarps * T   (this warp's column of ds)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mhsa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse, T* __restrict__ dk,
                        T* __restrict__ dv, int H, int seq, int D,
                        float scale) {
  extern __shared__ float smem[];
  const int ks = D + 1;
  float* q_s = smem;
  float* do_s = q_s + seq * ks;
  float* lse_s = do_s + seq * ks;
  float* delta_s = lse_s + seq;
  float* k_w = delta_s + seq;
  float* v_w = k_w + kWarps * D;
  float* p_w = v_w + kWarps * D;
  float* ds_w = p_w + kWarps * seq;

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t head = static_cast<int64_t>(bh) * seq * D;
  const int64_t row0 = static_cast<int64_t>(b) * seq * H + h;  // (b, 0, h)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int idx = threadIdx.x; idx < seq * D; idx += kThreads) {
    const int i = idx / D;
    const int d = idx - i * D;
    q_s[i * ks + d] = to_f32(q[head + idx]);
    do_s[i * ks + d] = to_f32(dout[(row0 + static_cast<int64_t>(i) * H) * D + d]);
  }
  for (int i = threadIdx.x; i < seq; i += kThreads)
    lse_s[i] = lse[static_cast<int64_t>(bh) * seq + i];
  __syncthreads();

  for (int i = warp; i < seq; i += kWarps) {
    const T* orow = o + (row0 + static_cast<int64_t>(i) * H) * D;
    float delta = 0.f;
    for (int d = lane; d < D; d += 32)
      delta = fmaf(do_s[i * ks + d], to_f32(orow[d]), delta);
    delta = warp_sum(delta);
    if (lane == 0) delta_s[i] = delta;
  }
  __syncthreads();

  float* krow = k_w + warp * D;
  float* vrow = v_w + warp * D;
  float* pcol = p_w + warp * seq;
  float* dscol = ds_w + warp * seq;
  for (int j = warp; j < seq; j += kWarps) {
    for (int d = lane; d < D; d += 32) {
      krow[d] = to_f32(k[head + j * D + d]);
      vrow[d] = to_f32(v[head + j * D + d]);
    }
    __syncwarp();

    for (int i = lane; i < seq; i += 32) {
      const float* qi = q_s + i * ks;
      const float* doi = do_s + i * ks;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(qi[d], krow[d], s);
        dp = fmaf(doi[d], vrow[d], dp);
      }
      const float p = expf(s * scale - lse_s[i]);
      pcol[i] = p;
      dscol[i] = p * (dp - delta_s[i]) * scale;
    }
    __syncwarp();

    const int64_t out_row = head + static_cast<int64_t>(j) * D;
    for (int d = lane; d < D; d += 32) {
      float acc_v = 0.f, acc_k = 0.f;
      for (int i = 0; i < seq; ++i) {
        acc_v = fmaf(pcol[i], do_s[i * ks + d], acc_v);
        acc_k = fmaf(dscol[i], q_s[i * ks + d], acc_k);
      }
      dv[out_row + d] = from_f32<T>(acc_v);
      dk[out_row + d] = from_f32<T>(acc_k);
    }
    __syncwarp();  // krow, vrow, pcol and dscol are rewritten for the next row
  }
}

size_t smem_bytes(int seq, int D) {
  return sizeof(float) * (2 * static_cast<size_t>(seq) * (D + 1) + 2 * seq +
                          2 * kWarps * D + 2 * kWarps * seq);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* dk, void* dv, int B, int H, int seq, int D,
                   float scale, cudaStream_t stream) {
  return launch_with_smem(
      mhsa_bwd_dkv_kernel<T>, B * H, kThreads, smem_bytes(seq, D), stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dk), static_cast<T*>(dv), H, seq, D, scale);
}

}  // namespace

// q, k, v: (B, H, T, D) contiguous; o, dout: (B, T, H, D) contiguous, same
// type; lse: (B, H, T) float32; dk, dv: (B, H, T, D), same type as k and v.
// dtype 0 is float32, 1 is bfloat16.  Returns the cudaError_t of the launch.
extern "C" int mhsa_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* dk, void* dv, int B, int H, int T, int D,
                            float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, dout, lse, dk, dv, B, H, T, D, scale,
                           s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, o, dout, lse, dk, dv, B, H, T, D,
                                   scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" long long mhsa_bwd_dkv_smem_bytes(int T, int D) {
  return static_cast<long long>(smem_bytes(T, D));
}
