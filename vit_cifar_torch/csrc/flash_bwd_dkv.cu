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
// 900 FLOP per byte: arithmetic, not device memory, bounds it.  This first
// version runs the products on the CUDA cores in f32, each FMA reading
// shared memory, and that is its limit.  Unlike mhsa_bwd_dkv.cu, which
// holds a whole head's Q and dO in shared memory and stops at T=685 for
// D=32, its shared memory does not grow with T.
//
// Layout of the work: one block per (b, h, tile of 64 keys); warp w owns 8
// keys and keeps their dk and dv accumulators in registers (spread over
// lanes by d).  The TPU's sequential innermost q grid axis is the loop over
// query tiles inside the block, so no block depends on another and no
// atomics are needed.  For each tile of 64 query rows the block stages Q
// and dO in shared memory with a row stride of D+1 (32 lanes reading 32
// rows at one d hit 32 banks), the rows' lse, and their delta, which it
// recomputes from o and dO for every query tile, as the TPU kernel does:
// the dq pass (flash_bwd_dq.cu) computes it too, but passing it on would
// need a (B, H, T) buffer between the two launches for a few percent of
// this kernel's work.  Then for each of its keys a warp computes p and ds
// for the tile's rows (lanes over rows) into two buffers in shared memory,
// then p^T.dO and ds^T.Q (lanes over d).  The last query tile is ragged:
// its missing rows are never read and their p and ds are 0.  Keys past T
// are neither computed nor written.  Offsets are int64.
//
// Built by vit_cifar_torch/ops/cuda/build.py (nvcc, sm_90a, plain C
// interface bound with ctypes).

#include <cstdint>

#include "attention_common.cuh"

namespace {

using namespace attn;

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

template <typename T, int kCols>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* dk, void* dv, int B, int H, int seq, int D,
                   float scale, cudaStream_t stream) {
  const int tiles = (seq + kTileK - 1) / kTileK;
  return launch_with_smem(
      flash_bwd_dkv_kernel<T, kCols>, B * H * tiles, kThreads, smem_bytes(D),
      stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dk), static_cast<T*>(dv), H, seq, D, scale);
}

template <typename T>
cudaError_t launch_for_d(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* dk, void* dv, int B, int H, int seq, int D,
                         float scale, cudaStream_t s) {
  if (D <= 32)
    return launch<T, 1>(q, k, v, o, dout, lse, dk, dv, B, H, seq, D, scale,
                        s);
  if (D <= 64)
    return launch<T, 2>(q, k, v, o, dout, lse, dk, dv, B, H, seq, D, scale,
                        s);
  if (D <= kMaxHeadDim)
    return launch<T, 4>(q, k, v, o, dout, lse, dk, dv, B, H, seq, D, scale,
                        s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: (B, H, T, D) contiguous; o, dout: (B, T, H, D) contiguous, same
// type; lse: (B, H, T) float32; dk, dv: (B, H, T, D), same type as k and v.
// D <= 128; dtype 0 is float32, 1 is bfloat16.  Returns the cudaError_t of
// the launch.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* dk, void* dv, int B, int H, int T, int D,
                             float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_for_d<float>(q, k, v, o, dout, lse, dk, dv, B, H, T, D,
                                 scale, s);
    case 1:
      return launch_for_d<__nv_bfloat16>(q, k, v, o, dout, lse, dk, dv, B, H,
                                         T, D, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one launch, in bytes; it depends on D alone.
extern "C" long long flash_bwd_dkv_smem_bytes(int T, int D) {
  (void)T;
  return static_cast<long long>(smem_bytes(D));
}
