// Fused multi-head self-attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel vit_cifar_tpu/ops/pallas/attention.py::_mhsa_kernel
// in both its variants: the inference one (kernel3, reached through
// fused_attention) and the training one (kernel3l, reached through the
// custom VJP's _fwd), which also writes the row logsumexp.  For every
// (batch, head): s = q.k^T * scale, p = exp(s - rowmax), o = (p / rowsum).v,
// all in f32 whatever the input type, and o is written in the (B, T, H, D)
// layout that fused_attention returns.  When `lse` is given, each row also
// writes lse = rowmax + log(rowsum) in f32, the one residual the backward
// kernels (mhsa_bwd_dq.cu, mhsa_bwd_dkv.cu) need besides q, k, v and o.  It
// is (B, H, T), not the TPU's lane-broadcast (B, H, Tp, 128), which existed
// only for the TPU's tiling.
//
// What bounds it on this card: at the model's shape (T=65, head_dim=32) one
// head is two 65x65x32 products, about 0.5 MFLOP against 12 KB of q/k/v in
// bf16, some 45 FLOP per byte -- far under the ~295 FLOP/byte at which the
// tensor cores and not device memory become the limit.  The kernel is bound
// by memory traffic and by latency.  So the design keeps the (H, T, T)
// logits and probabilities out of device memory altogether: each block
// stages one head's K and V in shared memory, each warp works one query row
// at a time with its logits in shared memory, and device memory sees only
// q, k, v in and the context (and lse) out.  There is no padding: every loop
// is bound by T and D, so any T and D work up to the shared-memory limit.
//
// Layout of the work: one block per (b, h), kWarps warps.  Warp w takes the
// query rows w, w + kWarps, ...; for a row, lanes run over keys for the
// logits and reduce max and sum with warp shuffles, then lanes run over D
// for p.v.  K is stored with a row stride of D+1 (odd for even D) so that
// 32 lanes reading 32 different keys at the same d hit 32 different banks.
//
// Built by vit_cifar_torch/ops/cuda/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C function mhsa_fwd below (ctypes).

#include <math_constants.h>

#include <cstdint>

#include "attention_common.cuh"

namespace {

using namespace attn;

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
      mhsa_fwd_kernel<T>, B * H, smem_bytes(seq, D), stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, seq, D, scale);
}

}  // namespace

// q, k, v: (B, H, T, D) contiguous; out: (B, T, H, D) contiguous, same type;
// lse: (B, H, T) float32 contiguous, or null for the inference variant.
// dtype 0 is float32, 1 is bfloat16.  Returns the cudaError_t of the launch
// (0 on success); the caller checks shapes and the shared-memory bound.
extern "C" int mhsa_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, int B, int H, int T, int D,
                        float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, out, lse, B, H, T, D, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, out, lse, B, H, T, D, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory one launch needs, in bytes, so that the caller
// can refuse a shape before launching.
extern "C" long long mhsa_fwd_smem_bytes(int T, int D) {
  return static_cast<long long>(smem_bytes(T, D));
}
