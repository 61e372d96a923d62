// Helpers shared by the attention kernels (mhsa_fwd.cu, flash_*.cu): the
// block shape, the column chunks of wide heads, conversions between the
// storage type and f32, and warp reductions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace attn {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// The widest head every kernel holds whole: a row of D values spread over a
// warp's lanes at most four a lane, or 128 columns of mma fragments.  A
// wider head is cut into column chunks of this many columns (the last one
// narrower): the products that sum over D (q.k, do.v) run chunk by chunk,
// and each output chunk has its own block or pass.
constexpr int kColChunk = 128;

__host__ __device__ constexpr int col_chunks(int D) {
  return (D + kColChunk - 1) / kColChunk;
}

// The width of column chunk e of a head of D columns.
__host__ __device__ constexpr int chunk_width(int D, int e) {
  return D - e * kColChunk < kColChunk ? D - e * kColChunk : kColChunk;
}

// The (b, h, t) strides in elements of n (B, H, T, D) views as the caller
// has them, d's being 1.
template <int n>
struct Views {
  int64_t sb[n], sh[n], st[n];

  // from the entry points' array: each view's (sb, sh, st) in turn
  static Views from(const long long* s) {
    Views l;
    for (int x = 0; x < n; ++x) {
      l.sb[x] = s[3 * x];
      l.sh[x] = s[3 * x + 1];
      l.st[x] = s[3 * x + 2];
    }
    return l;
  }
  // the offset of row 0 of head (b, h) of view x
  __host__ __device__ int64_t head(int x, int b, int h) const {
    return b * sb[x] + h * sh[x];
  }
};

// The forwards': index 0 is q, 1 k, 2 v.
using Qkv = Views<3>;
// The backward pair's: 0 q, 1 k, 2 v, 3 o, 4 do (o and do as views of their
// (B, T, H, D) tensors), 5 dq or dk, 6 dv.
using BwdLayout = Views<7>;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sets the block's dynamic shared memory and launches a grid of `blocks`
// blocks of `threads` threads; returns the launch's cudaError_t.
template <typename Kernel, typename... Args>
cudaError_t launch_with_smem(Kernel kernel, dim3 blocks, int threads,
                             size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace attn
