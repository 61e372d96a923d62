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
// (B, H, T), not the TPU's lane-broadcast (B, H, Tp, 128).  q, k and v are
// the caller's (B, H, T, D) views, read in place through their strides.
//
// What bounds it on this card: at the model's shape (T=65, head_dim=32) one
// head is two 65x65x32 products, about 0.5 MFLOP against 12 KB of q/k/v in
// bf16, some 45 FLOP per byte -- under the ~295 FLOP/byte at which the
// tensor cores and not device memory become the limit, so the bound is the
// bytes, and a head is too small to hide its own loads.  The design keeps
// the (H, T, T) logits out of device memory and keeps many heads' loads in
// flight:
//
//   bf16 (dtype 1), whole head: the warp-specialised wgmma kernel of
//   wgmma_attention.cuh with the whole head as its one key tile, where a
//   consumer's registers hold it (T <= 128 at 32 columns, 96 at 64, 64 at
//   128: the WHOLE rows of forward_tiles.cuh).  A persistent block walks
//   the heads (the TPU kernel takes every head of one batch element a
//   step); its producer thread brings each head's q (two buffers) and its
//   K and V (a ring of stages) by TMA, so that the next heads' loads
//   overlap this head's products.  The logits of a 64-row tile are one
//   wgmma of N = round_up(T, 8) columns -- the instance of the smallest
//   width in {16, 32, 64, 72, 96, 128} that holds it: 72 at T=65 -- and
//   its softmax is exact: one max, no rescale.  p.v has depth
//   round_up(N, 16).  Rows and keys past T and columns past D arrive as
//   zeros; keys past T get -inf logits; a warp whose rows all lie past T
//   computes no exps.
//   Past it: the same kernel's tiled work items, as flash_fwd.cu launches
//   them, so that "fused" at any (T, D) runs no slower than the tiled
//   forward; past 256 columns those cut o into column chunks and past 512
//   stream the sum over D (flash_fwd.cu says how), and no whole-head row
//   holds such a head.
//
//   f32 (dtype 0), on the CUDA cores: one TF32 product would miss the 1e-5
//   the f32 path is held to, and this forward has not yet taken the
//   three-product split (big.big + big.small + small.big) that puts the
//   f32 backward pair on TF32 wgmma (wgmma_tf32.cuh); so f32 keeps the
//   first design: K (row stride D+1) and V in f32
//   shared memory, kWarps warps, warp w taking the query rows w,
//   w + kWarps, ..., lanes over keys for the logits (max and sum by warp
//   shuffles), then lanes over D for p.v.  Where that layout does not fit
//   in shared memory (whole_head_fits), and past 128 columns always, the
//   block walks K and V in tiles of 64 keys with the online softmax, every
//   64 query rows and 128-column chunk in turn (fwd_f32_chunk.cuh).  This
//   is a dispatch by dtype, not a fallback.
//
// whole_head_fits sets the router's threshold (ops/attention.py::route):
// the f32 layout's shared memory up to 128 columns, past it the larger of
// the f32 tile's and the earlier bf16 design's column-chunk layout (T <=
// 279 at head_dim 192, 213 at 256), kept so that the same shapes take the
// same kernel.
//
// Built by vit_cifar_torch/ops/cuda/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C function mhsa_fwd below (ctypes).

#include <math_constants.h>

#include <cstdint>

#include "attention_common.cuh"
#include "fwd_f32_chunk.cuh"
#include "wgmma_attention.cuh"

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
                    float* __restrict__ lse, Qkv L, int H, int seq, int D,
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
  const T* qh = q + L.head(0, b, h);
  const T* kh = k + L.head(1, b, h);
  const T* vh = v + L.head(2, b, h);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < seq * D; i += kThreads) {
    const int j = i / D;
    const int d = i - j * D;
    k_s[j * ks + d] = to_f32(kh[j * L.st[1] + d]);
    v_s[i] = to_f32(vh[j * L.st[2] + d]);
  }
  __syncthreads();

  float* qrow = q_s + warp * D;
  float* prow = p_s + warp * seq;
  for (int i = warp; i < seq; i += kWarps) {
    for (int d = lane; d < D; d += 32) qrow[d] = to_f32(qh[i * L.st[0] + d]);
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

// ---- f32 past the whole head, or past kColChunk columns ------------------
__global__ void __launch_bounds__(kThreads)
    mhsa_fwd_chunk_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out,
                          float* __restrict__ lse, Qkv L, int H, int seq,
                          int D, float scale) {
  extern __shared__ float smem[];
  for (int q0 = 0; q0 < seq; q0 += kChunkTileQ)
    for (int cc = 0; cc < col_chunks(D); ++cc)
      fwd_f32_chunk_tile(q, k, v, out, lse, L, H, seq, D, scale,
                         static_cast<int>(blockIdx.x), q0, cc, smem);
}

// The router's threshold at (T, D), in bytes (see the note at the top): up
// to kColChunk columns the f32 layout's shared memory; past it the larger
// of the f32 tile's and that of the earlier bf16 layout, K and V staged
// whole as one matrix of T rows per 128-column chunk, each row an odd
// number of 16-byte chunks (136 elements but the last chunk's), plus 16
// bytes of zeros.
size_t whole_head_smem_bytes(int seq, int D) {
  if (D <= kColChunk) return smem_bytes(seq, D);
  const int nc = col_chunks(D);
  const size_t row = (nc - 1) * stride_elems(kColChunk) +
                     stride_elems(chunk_width(D, nc - 1));
  const size_t bf16 = sizeof(__nv_bfloat16) * (8 + 2 * seq * row);
  const size_t f32 = fwd_f32_chunk_smem_bytes();
  return bf16 > f32 ? bf16 : f32;
}

bool whole_head_fits(int seq, int D) {
  return whole_head_smem_bytes(seq, D) <= kMaxSmemBytes;
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       void* lse, const Qkv& L, int B, int H, int seq, int D,
                       float scale, cudaStream_t stream) {
  // up to kColChunk columns the whole head where it fits; else (and past
  // kColChunk always) the walk over key tiles, any T and any D
  if (D <= kColChunk && whole_head_fits(seq, D))
    return launch_with_smem(
        mhsa_fwd_kernel<float>, B * H, kThreads, smem_bytes(seq, D), stream,
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), L, H, seq, D, scale);
  return launch_with_smem(
      mhsa_fwd_chunk_kernel, B * H, kThreads, fwd_f32_chunk_smem_bytes(),
      stream, static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), L, H, seq, D, scale);
}

// ---- bf16 ------------------------------------------------------------------
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, void* lse, const Qkv& L, int B, int H,
                        int seq, int D, float scale, cudaStream_t stream) {
  using attn_wg::View;
  return attn_wg::launch_whole_or_tiled(
      View{q, L.sb[0], L.sh[0], L.st[0]}, View{k, L.sb[1], L.sh[1], L.st[1]},
      View{v, L.sb[2], L.sh[2], L.st[2]}, out, lse, B, H, seq, D, scale,
      stream);
}

}  // namespace

// q, k, v: (B, H, T, D) views, their (b, h, t) strides in elements in
// `strides` (q's three, then k's, then v's; d's stride is 1); bf16 views
// meet TMA's rules (16-byte aligned bases, strides multiples of 8
// elements), which the wrapper sees to.  out: (B, T, H, D) contiguous, same
// type; lse: (B, H, T) float32 contiguous, or null for the inference
// variant.  Any T and any D; dtype 0 is float32, 1 is bfloat16.  Returns
// the cudaError_t of the launch (0 on success); the caller checks shapes.
extern "C" int mhsa_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, const long long* strides, int B,
                        int H, int T, int D, float scale, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Qkv L = Qkv::from(strides);
  switch (dtype) {
    case 0:
      return launch_f32(q, k, v, out, lse, L, B, H, T, D, scale, s);
    case 1:
      return launch_bf16(q, k, v, out, lse, L, B, H, T, D, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The router's threshold at (T, D), in bytes (see whole_head_smem_bytes):
// where it is more than a block may use, the f32 instance walks K and V in
// key tiles (fwd_f32_chunk.cuh), whose shared memory grows with neither.
extern "C" long long mhsa_fwd_smem_bytes(int T, int D) {
  return static_cast<long long>(whole_head_smem_bytes(T, D));
}
