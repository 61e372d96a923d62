// Fused attention backward, the query gradient, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// vit_cifar_tpu/ops/pallas/attention.py::_flash_bwd_dq_kernel (pass 1 of
// _flash_bwd_impl, reached through fused_attention's custom VJP).  For
// every (batch, head) and query row i:
//   delta_i = sum_d do_i[d] * o_i[d]
//   s_ij = q_i . k_j * scale,  p_ij = exp(s_ij - lse_i),  dp_ij = do_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i) * scale
//   dq_i = sum_j ds_ij k_j
// in f32 whatever the input type; lse is the forward's (mhsa_fwd.cu).
// o and do are read in the (B, T, H, D) layout that fused_attention
// returns, as the JAX backward receives them, and dq is written in
// (B, H, T, D) in the input type.
//
// What bounds it on this card: at the model's shape (T=65, head_dim=32) one
// head is three 65x65x32 products (q.k, do.v, ds.k), some 0.8 MFLOP against
// 20 KB of inputs in bf16 -- about 40 FLOP per byte, far under the ~295 at
// which the tensor cores and not device memory become the limit.  So, as in
// the forward, nothing of size (T, T) reaches device memory: one block owns
// a whole head, stages K and V in shared memory, and each warp works one
// query row at a time with its row of ds in shared memory.  Because a block
// owns the whole head it needs no atomics, and because T=65 is one tile it
// needs no loop over key tiles either; the TPU's tiling over (q, kv) tiles
// is gone, and so is its padding.  Inside, the FMAs read shared memory,
// which bounds the kernel; K and V have a row stride of D+1 so that 32
// lanes reading 32 keys at one d hit 32 banks.
//
// Built by vit_cifar_torch/ops/cuda/build.py (nvcc, sm_90a, plain C
// interface bound with ctypes).

#include <cstdint>

#include "attention_common.cuh"

namespace {

using namespace attn;

// Dynamic shared memory, in floats:
//   K     T * (D + 1)
//   V     T * (D + 1)
//   q     kWarps * D   (this warp's query row)
//   do    kWarps * D   (this warp's output-gradient row)
//   ds    kWarps * T   (this warp's row of ds)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mhsa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ o,
                       const T* __restrict__ dout,
                       const float* __restrict__ lse, T* __restrict__ dq,
                       int H, int seq, int D, float scale) {
  extern __shared__ float smem[];
  const int ks = D + 1;
  float* k_s = smem;
  float* v_s = k_s + seq * ks;
  float* q_s = v_s + seq * ks;
  float* do_s = q_s + kWarps * D;
  float* ds_s = do_s + kWarps * D;

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
    v_s[j * ks + d] = to_f32(v[head + i]);
  }
  __syncthreads();

  float* qrow = q_s + warp * D;
  float* dorow = do_s + warp * D;
  float* dsrow = ds_s + warp * seq;
  for (int i = warp; i < seq; i += kWarps) {
    // (B, T, H, D) offset of row i of this head in o and do
    const int64_t bthd = ((static_cast<int64_t>(b) * seq + i) * H + h) * D;
    float delta = 0.f;
    for (int d = lane; d < D; d += 32) {
      qrow[d] = to_f32(q[head + i * D + d]);
      const float g = to_f32(dout[bthd + d]);
      dorow[d] = g;
      delta = fmaf(g, to_f32(o[bthd + d]), delta);
    }
    delta = warp_sum(delta);
    const float lse_i = lse[static_cast<int64_t>(bh) * seq + i];
    __syncwarp();

    for (int j = lane; j < seq; j += 32) {
      const float* krow = k_s + j * ks;
      const float* vrow = v_s + j * ks;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(qrow[d], krow[d], s);
        dp = fmaf(dorow[d], vrow[d], dp);
      }
      const float p = expf(s * scale - lse_i);
      dsrow[j] = p * (dp - delta) * scale;
    }
    __syncwarp();

    T* dqrow = dq + head + static_cast<int64_t>(i) * D;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < seq; ++j) acc = fmaf(dsrow[j], k_s[j * ks + d], acc);
      dqrow[d] = from_f32<T>(acc);
    }
    __syncwarp();  // qrow, dorow and dsrow are rewritten for the next row
  }
}

size_t smem_bytes(int seq, int D) {
  return sizeof(float) * (2 * static_cast<size_t>(seq) * (D + 1) +
                          2 * kWarps * D + kWarps * seq);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* dq, int B, int H, int seq, int D, float scale,
                   cudaStream_t stream) {
  return launch_with_smem(
      mhsa_bwd_dq_kernel<T>, B * H, kThreads, smem_bytes(seq, D), stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dq), H, seq, D, scale);
}

}  // namespace

// q, k, v: (B, H, T, D) contiguous; o, dout: (B, T, H, D) contiguous, same
// type; lse: (B, H, T) float32; dq: (B, H, T, D), same type as q.  dtype 0
// is float32, 1 is bfloat16.  Returns the cudaError_t of the launch.
extern "C" int mhsa_bwd_dq(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* lse,
                           void* dq, int B, int H, int T, int D, float scale,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, dout, lse, dq, B, H, T, D, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, o, dout, lse, dq, B, H, T, D,
                                   scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" long long mhsa_bwd_dq_smem_bytes(int T, int D) {
  return static_cast<long long>(smem_bytes(T, D));
}
