// Helpers shared by the attention kernels (mhsa_*.cu, flash_*.cu): the
// block shape, conversions between the storage type and f32, and warp
// reductions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// the tiled kernels keep a row of D values spread over a warp's lanes, at
// most four a lane
constexpr int kMaxHeadDim = 128;

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

// Sets the block's dynamic shared memory and launches blocks of `threads`
// threads; returns the launch's cudaError_t.
template <typename Kernel, typename... Args>
cudaError_t launch_with_smem(Kernel kernel, int blocks, int threads,
                             size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace attn
