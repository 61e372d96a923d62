// Hopper building blocks of the bf16 attention forwards (flash_fwd.cu,
// mhsa_fwd.cu), and the warp-specialised forward kernel both launch.
//
// The tools are Hopper's own (sm_90a):
//   * TMA: the host encodes a 4-D tensor map over (D, H, T, B) of each of
//     q, k and v from the caller's strides (cuTensorMapEncodeTiled, reached
//     through cudaGetDriverEntryPoint), so the kernels read the (B, H, T, D)
//     views in place -- on the model's path transposed views of (B, T, H, D)
//     projections.  One thread asks for a whole tile; rows past T and
//     columns past D arrive as zeros (TMA's out-of-bounds fill), so nothing
//     is padded in device memory.  Tiles land swizzled (64-byte rows at
//     head dims up to 32, else 128-byte rows in atoms of 64 columns), the
//     layout wgmma reads.
//   * mbarrier: every tile's arrival is a transaction count on a "full"
//     barrier, and its release by the consumers an arrival on an "empty"
//     one; the K/V tiles cycle through a ring of stages.
//   * wgmma: a warpgroup (4 warps) issues 64-row products asynchronously.
//     s = q.k^T reads both operands from shared memory (K-major); o += p.v
//     takes p from registers and V from shared memory (MN-major).
//   * Warp specialisation: warpgroup 2 is the producer (one thread issues
//     every TMA load; setmaxnreg gives its registers away), warpgroups 0
//     and 1 the consumers (setmaxnreg 240), 64 query rows each, 128 a work
//     item.  At the widths where it was measured to win (32 and 192
//     columns; forward_tiles.cuh), two named barriers make the consumers
//     take turns issuing their products (ping-pong), so that one
//     warpgroup's softmax runs on the CUDA cores while the other's products
//     run on the tensor cores; inside a warpgroup the p.v of one key tile
//     runs while the softmax of the next does.  The block is persistent:
//     one an SM, walking the work items (b, h, 128 query rows) with a
//     stride of the grid, so that the producer brings the next item's q,
//     K and V while this one computes.
//
// What ptxas needs for the wgmmas to run asynchronously (it serialises
// them otherwise, and says so as C7510-C7520 in the -Xptxas -v report,
// which the smoke run refuses): no wgmma, and no write to a register a
// wgmma reads or writes, under a branch it cannot prove warpgroup-uniform
// (the products are issued by a warpgroup whose rows all lie past T too);
// every such register settled before wgmma.fence (fence_regs); no wait,
// rescale or p.v under a branch on the loop counter (the first key tile's
// turn is peeled off the loop); and s, p and o of a consumer within its
// registers.  ptxas gives the consumers the launch's 168 registers,
// whatever setmaxnreg asks, so the key tile is sized to fit (the table of
// instances, forward_tiles.cuh).
//
// The key tiles of a work item are taken last to first: the first one
// taken holds the keys past T and is the only one masked (a select, and no
// exps for a block of 8 keys wholly past T).
//
// Numerics are the mma.sync design's (mma_attention.cuh): s = q.k^T of bf16
// values summed in f32; the online softmax keeps the running max m of the
// scaled logits (log2 units: c = scale*log2(e)), the normaliser l and the
// context o in f32 registers, with the TPU kernel's safe_m/corr guard for a
// fully masked tile; the max is taken on the raw logits and scaled once a
// row, and each exponent is one FFMA into ex2, exp2(s*c - m); p is split
// into bf16 hi = rn(p) and lo = rn(p - hi), and both go through the tensor
// cores, so p.v keeps p at f32 accuracy as the TPU kernel keeps it in f32.
// lse is returned in natural log: m * ln(2) + log(l).
//
// Fragment layouts (PTX ISA, wgmma .m64nNk16): warp w of a warpgroup owns
// rows 16w .. 16w+15; lane 4g + t holds, for every 8 columns n, the f32
// accumulator values (g, 8n+2t..8n+2t+1) and (g+8, same columns) -- the
// mma.sync m16n8 layout -- so two 8-column blocks of s are, element for
// element, the A fragment of one k16 step of p.v.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <atomic>
#include <cstring>
#include <mutex>
#include <type_traits>

namespace attn_wg {
// Internal linkage, so that each library that includes this (flash_fwd,
// mhsa_fwd) has its own kernels and host state: a function-local static
// of an inline function would be one object for every library of the
// process (a unique symbol), and one library's shared-memory opt-in would
// then pass for the other's kernel.
namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumerWGs = 2;
constexpr int kConsumerWarps = 4 * kConsumerWGs;
constexpr int kThreads = 128 * (kConsumerWGs + 1);  // consumers + producer
constexpr int kTileQ = 64 * kConsumerWGs;            // query rows an item
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// Hopper's opt-in maximum of dynamic shared memory for one block, less the
// slack that aligns the tiles to 1024 bytes and the barriers
constexpr int kSmemBudget = 232448 - 1024 - 256;

// ---- shared memory, barriers, TMA ----------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// The producer's arrival that also announces the bytes TMA will deliver.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `phase` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(phase)
      : "memory");
}

// Makes initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// One tile of a 4-D tensor map, at element coordinates (d, h, t, b), into
// shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int d, int h,
                                            int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d),
      "r"(h), "r"(t), "r"(b)
      : "memory");
}

// Named barriers 1 and 2: the consumers' turns (0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- wgmma -----------------------------------------------------------------
// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(swizzle) << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most n of the warpgroup's committed groups are in flight.
template <int n>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

// Ties registers that an asynchronous wgmma reads or writes to this point,
// so the compiler neither reads them earlier nor reuses them before it.
template <int n>
__device__ __forceinline__ void fence_regs(float (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int n>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[n][4]) {
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 in, f32 accumulate.  ss: d (+)= A.B^T with
// A (64 x 16) and B (N x 16) K-major in shared memory (scale_d 0 overwrites
// d); rs: d += A.B with A from registers and B (16 x N) MN-major in shared
// memory.  The operand lists are written out, one width each: s = q.k^T
// takes N in {16, 32, 64, 72, 96, 128} (key tiles), o += p.v N in {32,
// 64, 128, 192, 256} (head widths).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d (+)= A.B^T, A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da,
                                           uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  // d (+)= A.B^T, A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                           uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d += A.B, A (16 x 16 per warp) from registers, B MN-major in
  // shared memory
  static __device__ __forceinline__ void rs(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // d (+)= A.B^T, A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d += A.B, A (16 x 16 per warp) from registers, B MN-major in
  // shared memory
  static __device__ __forceinline__ void rs(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<72> {
  // d (+)= A.B^T, A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[36], uint64_t da,
                                           uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35"
        "}, %36, %37, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  // d (+)= A.B^T, A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[48], uint64_t da,
                                           uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  // d (+)= A.B^T, A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d += A.B, A (16 x 16 per warp) from registers, B MN-major in
  // shared memory
  static __device__ __forceinline__ void rs(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  // d += A.B, A (16 x 16 per warp) from registers, B MN-major in
  // shared memory
  static __device__ __forceinline__ void rs(float (&d)[96],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  // d += A.B, A (16 x 16 per warp) from registers, B MN-major in
  // shared memory
  static __device__ __forceinline__ void rs(float (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// ---- the softmax's arithmetic ----------------------------------------------
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (a, b) -> bf16 hi = rn(a, b) and lo = rn(a - hi, b - hi), packed with a
// in the low half as the A fragment wants it.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// ---- the forward kernel ----------------------------------------------------
// Shared memory of one instance: kQBufs query tiles (kTileQ rows), then
// kStages stages of a K tile (kN rows) and a V tile (kKV rows, kN rounded up
// to the 16-key depth of p.v), then the barriers.  Each tile is kAtoms
// swizzle atoms of kAtomCols columns side by side, an atom's rows
// kRowBytes apart.
template <int kDp, int kN, int kQBufs>
struct Shape {
  static constexpr int kKV = (kN + 15) / 16 * 16;
  static constexpr int kAtomCols = kDp == 32 ? 32 : 64;
  static constexpr int kAtoms = kDp / kAtomCols;
  static constexpr int kRowBytes = 2 * kAtomCols;
  static constexpr uint32_t kSwizzle = kDp == 32 ? 2 : 1;  // 64 B : 128 B
  static constexpr int kQBytes = 2 * kTileQ * kDp;
  static constexpr int kKBytes = 2 * kN * kDp;
  static constexpr int kVBytes = 2 * kKV * kDp;
  // as many stages as fit, at most 4
  static constexpr int kStages =
      (kSmemBudget - kQBufs * kQBytes) / (kKBytes + kVBytes) < 4
          ? (kSmemBudget - kQBufs * kQBytes) / (kKBytes + kVBytes)
          : 4;
  static constexpr int kKOff = kQBufs * kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKBytes;
  static constexpr int kBarOff = kVOff + kStages * kVBytes;
  static constexpr int kBytes = kBarOff + 8 * 2 * (kQBufs + kStages) + 1024;
  static_assert(kDp == 32 || kDp % 64 == 0, "head width");
  static_assert(kN % 8 == 0 && kN <= 256, "key tile");
  static_assert(kStages >= 2, "a ring of at least two stages");
};

// One launch's scalars.  The work items are the (b * H + h, query tile)
// pairs, n_qt tiles of kTileQ rows a head, in that order; the grid is
// persistent: block x takes items x, x + gridDim.x, ...
struct Params {
  bf16* out;     // (B, T, H, D)
  float* lse;    // (B, H, T), or null
  int H, T, D;
  float scale;   // softmax scale
  float c;       // scale * log2(e)
  int n_qt;      // query tiles a head
  int n_kt;      // key tiles a head
  int total;     // work items
};

template <int kDp, int kN, int kQBufs, bool kPingpong>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const Params p) {
  using S = Shape<kDp, kN, kQBufs>;
  constexpr int kStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::kBarOff);
  uint64_t* q_empty = q_full + kQBufs;
  uint64_t* kv_full = q_empty + kQBufs;
  uint64_t* kv_empty = kv_full + kStages;
  const int items =
      (p.total - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], kConsumerWarps);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_empty[i], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, warp-uniform for the compiler, so that each role's
  // code is compiled for its own register count
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == kConsumerWGs) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x != 128 * kConsumerWGs) return;
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    int stage = 0, sph = 0, qb = 0, qph = 0;
    for (int i = 0; i < items; ++i) {
      const int bh = (blockIdx.x + i * gridDim.x) / p.n_qt;
      const int qt = blockIdx.x + i * gridDim.x - bh * p.n_qt;
      const int b = bh / p.H;
      const int h = bh - b * p.H;
      mbar_wait(&q_empty[qb], qph ^ 1);  // a fresh barrier passes at once
      mbar_expect_tx(&q_full[qb], S::kQBytes);
      for (int a = 0; a < S::kAtoms; ++a)
        tma_load_4d(smem + qb * S::kQBytes + a * kTileQ * S::kRowBytes,
                    &qmap, &q_full[qb], a * S::kAtomCols, h, qt * kTileQ, b);
      if (++qb == kQBufs) qb = 0, qph ^= 1;
      for (int j = 0; j < p.n_kt; ++j) {
        mbar_wait(&kv_empty[stage], sph ^ 1);
        mbar_expect_tx(&kv_full[stage], S::kKBytes + S::kVBytes);
        uint8_t* kt = smem + S::kKOff + stage * S::kKBytes;
        uint8_t* vt = smem + S::kVOff + stage * S::kVBytes;
        const int k0 = (p.n_kt - 1 - j) * kN;  // last tile first
        for (int a = 0; a < S::kAtoms; ++a) {
          tma_load_4d(kt + a * kN * S::kRowBytes, &kmap, &kv_full[stage],
                      a * S::kAtomCols, h, k0, b);
          tma_load_4d(vt + a * S::kKV * S::kRowBytes, &vmap,
                      &kv_full[stage], a * S::kAtomCols, h, k0, b);
        }
        if (++stage == kStages) stage = 0, sph ^= 1;
      }
    }
    return;
  }

  // ---- consumers: warpgroup c takes rows 64c .. 64c+63 of every item ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = role;
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  [[maybe_unused]] const int my_turn = 1 + c, other_turn = 2 - c;
  constexpr int kNB = kN / 8;        // 8-key blocks of s
  constexpr int kPV = S::kKV / 16;   // k16 steps of p.v
  constexpr uint32_t kSbo = 8 * S::kRowBytes;

  float s[kN / 2];
  float o[kDp / 2];
  uint32_t ph[kPV][4], pl[kPV][4];
  float m[2], l[2], corr[2];

  // o += p.v of the key tile in `stage`, p = hi + lo
  auto pv = [&](int stage) {
    const uint32_t vb = smem_u32(smem + S::kVOff + stage * S::kVBytes);
#pragma unroll
    for (int kk = 0; kk < kPV; ++kk) {
      const uint64_t d = make_desc(vb + kk * 16 * S::kRowBytes,
                                   S::kKV * S::kRowBytes, kSbo, S::kSwizzle);
      Wgmma<kDp>::rs(o, ph[kk], d);
      Wgmma<kDp>::rs(o, pl[kk], d);
    }
  };
  auto rescale = [&]() {
#pragma unroll
    for (int n = 0; n < kDp / 8; ++n) {
      o[4 * n] *= corr[0];
      o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1];
      o[4 * n + 3] *= corr[1];
    }
  };

  if (kPingpong && c == 1) bar_arrive(1, 256);  // consumer 0 issues first
  [[maybe_unused]] const int total = items * p.n_kt;
  [[maybe_unused]] int done = 0;
  int stage = 0, sph = 0, qb = 0, qph = 0;
  for (int i = 0; i < items; ++i) {
    const int bh = (blockIdx.x + i * gridDim.x) / p.n_qt;
    const int qt = blockIdx.x + i * gridDim.x - bh * p.n_qt;
    const int b = bh / p.H;
    const int h = bh - b * p.H;
    const int row_wg = qt * kTileQ + 64 * c;
    // warp-uniform, and shown so to ptxas: a branch it takes for divergent
    // around the accumulator registers serialises the wgmmas
    const bool warp_active =
        __shfl_sync(0xffffffffu, row_wg + 16 * warp < p.T, 0);
    const uint32_t qa =
        smem_u32(smem + qb * S::kQBytes) + 64 * c * S::kRowBytes;
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int x = 0; x < kDp / 2; ++x) o[x] = 0.f;
    mbar_wait(&q_full[qb], qph);

    // Key tiles are taken last to first: the first one taken holds the
    // keys past T, and it alone is masked.  Its turn is peeled off the loop
    // so that no wait, rescale or p.v of the loop sits under a branch:
    // ptxas serialises wgmmas whose registers such a branch touches.
    auto products = [&](int st, int from, auto with_pv) {
      if constexpr (kPingpong) bar_sync(my_turn, 256);
      if constexpr (decltype(with_pv)::value) rescale();
      // every register the products read or write is settled before the
      // pipeline stage opens
      fence_regs(s);
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
      wg_fence();
      const uint32_t kb = smem_u32(smem + S::kKOff + st * S::kKBytes);
#pragma unroll
      for (int kk = 0; kk < kDp / 16; ++kk) {
        const int a = 16 * kk / S::kAtomCols;
        const uint32_t in_atom = 2 * (16 * kk % S::kAtomCols);
        Wgmma<kN>::ss(
            s,
            make_desc(qa + a * kTileQ * S::kRowBytes + in_atom, 16, kSbo,
                      S::kSwizzle),
            make_desc(kb + a * kN * S::kRowBytes + in_atom, 16, kSbo,
                      S::kSwizzle),
            kk);
      }
      wg_commit();
      if constexpr (decltype(with_pv)::value) {
        pv(from);
        wg_commit();
      }
      // the last turn of consumer 1 would release a turn nobody takes
      if constexpr (kPingpong)
        if (++done < total || c == 0) bar_arrive(other_turn, 256);
      if constexpr (decltype(with_pv)::value)
        wg_wait<1>();  // s; the p.v runs on
      else
        wg_wait<0>();
      fence_regs(s);
    };

    // the online softmax of a tile, on the accumulator registers
    auto softmax = [&](int k0, auto masked) {
      if (warp_active) {
        if constexpr (decltype(masked)::value) {  // keys past T
#pragma unroll
          for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[4 * nb + e] = k0 + 8 * nb + 2 * t + (e & 1) >= p.T
                                  ? -CUDART_INF_F
                                  : s[4 * nb + e];
        }
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * nb + e]);
        float mc[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          // the row max of the scaled logits, rn(max(s) * c) = max(rn(s *
          // c)), in log2 units
          const float m_new = fmaxf(m[r], mx[r] * p.c);
          // a tile of -inf logits keeps m at -inf; exp(-inf - -inf) is NaN
          const float safe = isfinite(m_new) ? m_new : 0.f;
          corr[r] = isfinite(m[r]) ? ex2(m[r] - safe) : 0.f;
          m[r] = m_new;
          mc[r] = safe;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb) {
          // in the masked tile, a block of 8 keys all past T (a uniform
          // test) computes no exps: p = 0
          if (decltype(masked)::value && k0 + 8 * nb >= p.T) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[4 * nb + e] = 0.f;
            continue;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // masked keys: ex2(-inf) = 0
            const float x = ex2(fmaf(s[4 * nb + e], p.c, -mc[e >> 1]));
            s[4 * nb + e] = x;
            sum[e >> 1] += x;
          }
        }
        l[0] = l[0] * corr[0] + sum[0];
        l[1] = l[1] * corr[1] + sum[1];
      } else {  // rows past T: p = 0, no exps
#pragma unroll
        for (int x = 0; x < kN / 2; ++x) s[x] = 0.f;
        corr[0] = corr[1] = 0.f;
      }
    };

    // p as the bf16 hi and lo A fragments of p.v
    auto split_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kPV; ++kk) {
        split_bf16(s[8 * kk], s[8 * kk + 1], ph[kk][0], pl[kk][0]);
        split_bf16(s[8 * kk + 2], s[8 * kk + 3], ph[kk][1], pl[kk][1]);
        if (2 * kk + 1 < kNB) {
          split_bf16(s[8 * kk + 4], s[8 * kk + 5], ph[kk][2], pl[kk][2]);
          split_bf16(s[8 * kk + 6], s[8 * kk + 7], ph[kk][3], pl[kk][3]);
        } else {  // keys past the tile's kN: p = 0
          ph[kk][2] = ph[kk][3] = pl[kk][2] = pl[kk][3] = 0u;
        }
      }
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    mbar_wait(&kv_full[stage], sph);
    products(stage, 0, std::false_type{});
    if (p.n_kt == 1) release(&q_empty[qb]);  // q is no longer read
    softmax((p.n_kt - 1) * kN, std::true_type{});
    split_p();
    int prev = stage;
    if (++stage == kStages) stage = 0, sph ^= 1;
    for (int j = 1; j < p.n_kt; ++j) {
      mbar_wait(&kv_full[stage], sph);
      products(stage, prev, std::true_type{});
      if (j == p.n_kt - 1) release(&q_empty[qb]);
      softmax(0, std::false_type{});
      wg_wait<0>();  // the p.v of the tile before is done
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
      release(&kv_empty[prev]);
      split_p();
      prev = stage;
      if (++stage == kStages) stage = 0, sph ^= 1;
    }

    // the last tile's p.v
    rescale();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    wg_fence();
    pv(prev);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    release(&kv_empty[prev]);

    // o / l to (B, T, H, D) bf16, lse to (B, H, T) f32; o is read outside
    // any branch (a divergent read of an accumulator serialises the
    // wgmmas), the stores are predicated
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float inv = 1.f / lt;  // inf for rows past T, never stored
      __nv_bfloat162 packed[kDp / 8];
#pragma unroll
      for (int n = 0; n < kDp / 8; ++n)
        packed[n] = __floats2bfloat162_rn(o[4 * n + 2 * r] * inv,
                                          o[4 * n + 2 * r + 1] * inv);
      const int row = row_wg + 16 * warp + g + 8 * r;
      if (!warp_active || row >= p.T) continue;
      bf16* orow =
          p.out + ((static_cast<int64_t>(b) * p.T + row) * p.H + h) * p.D;
#pragma unroll
      for (int n = 0; n < kDp / 8; ++n) {
        const int d = 8 * n + 2 * t;
        if (d + 1 < p.D && (p.D & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + d) = packed[n];
        } else {
          if (d < p.D) orow[d] = packed[n].x;
          if (d + 1 < p.D) orow[d + 1] = packed[n].y;
        }
      }
      if (p.lse != nullptr && t == 0)
        p.lse[static_cast<int64_t>(bh) * p.T + row] =
            m[r] * 0.6931471805599453f + logf(lt);
    }
    if (++qb == kQBufs) qb = 0, qph ^= 1;
  }
}

// ---- host: tensor maps and the launch --------------------------------------
// The caller's view of one of q, k, v: its base and its (b, h, t) strides in
// elements; the d stride is 1.
struct View {
  const void* base;
  long long sb, sh, st;
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A tensor map over (D, H, T, B) of one view, boxes of (cols, 1, rows, 1),
// swizzled.  Encoded maps are kept in a small cache keyed by everything
// they are made of, so a step that launches the same views again encodes
// nothing.
struct MapKey {
  const void* base;
  long long sb, sh, st;
  int B, H, T, D, cols, rows, swizzle;
};

inline bool tensor_map(CUtensorMap* map, const View& view, int B, int H,
                       int T, int D, int cols, int rows, int swizzle) {
  constexpr int kCache = 64;  // a step's q, k, v of every layer
  static MapKey keys[kCache];
  static CUtensorMap maps[kCache];
  static int used = 0, next = 0;
  static std::mutex mu;
  MapKey key;
  std::memset(&key, 0, sizeof(key));  // padding compares equal
  key.base = view.base;
  key.sb = view.sb;
  key.sh = view.sh;
  key.st = view.st;
  key.B = B;
  key.H = H;
  key.T = T;
  key.D = D;
  key.cols = cols;
  key.rows = rows;
  key.swizzle = swizzle;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (std::memcmp(&keys[i], &key, sizeof(key)) == 0) {
      *map = maps[i];
      return true;
    }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * view.sh),
                                 static_cast<cuuint64_t>(2 * view.st),
                                 static_cast<cuuint64_t>(2 * view.sb)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(view.base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle == 2 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return false;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % kCache;
  if (used < kCache) ++used;
  return true;
}

inline int sm_count() {
  static int n = [] {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

// Launches fwd_kernel<kDp, kN, kQBufs, kPingpong> on q, k, v: a persistent
// grid, one block an SM.
template <int kDp, int kN, int kQBufs, bool kPingpong>
cudaError_t launch(const View& q, const View& k, const View& v, void* out,
                   void* lse, int B, int H, int T, int D, float scale,
                   cudaStream_t stream) {
  using S = Shape<kDp, kN, kQBufs>;
  auto kernel = fwd_kernel<kDp, kN, kQBufs, kPingpong>;
  // the opt-in to more than 48 KB of shared memory is an attribute of the
  // kernel on a device: set once a device (a bit each)
  static std::atomic<uint64_t> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if ((opted_in.load(std::memory_order_relaxed) & bit) == 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (err != cudaSuccess) return err;
    opted_in.fetch_or(bit, std::memory_order_relaxed);
  }
  CUtensorMap qm, km, vm;
  if (!tensor_map(&qm, q, B, H, T, D, S::kAtomCols, kTileQ, S::kSwizzle) ||
      !tensor_map(&km, k, B, H, T, D, S::kAtomCols, kN, S::kSwizzle) ||
      !tensor_map(&vm, v, B, H, T, D, S::kAtomCols, S::kKV, S::kSwizzle))
    return cudaErrorInvalidValue;
  Params p;
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.T = T;
  p.D = D;
  p.scale = scale;
  p.c = scale * 1.4426950408889634f;
  p.n_qt = (T + kTileQ - 1) / kTileQ;
  p.n_kt = (T + kN - 1) / kN;
  p.total = B * H * p.n_qt;
  kernel<<<min(p.total, sm_count()), kThreads, S::kBytes, stream>>>(qm, km,
                                                                    vm, p);
  return cudaGetLastError();
}

// The instances, one table row each (forward_tiles.cuh): the tiled grid at
// a padded head width, and mhsa_fwd's whole-head grid.

// Whether the consumers of a width's instances take turns at the tensor
// cores (the tiled row's pingpong column).
constexpr bool pingpong_at(int width) {
#define TILED(w, n, pp) \
  if (width == w) return pp != 0;
#define WHOLE(w, n)
#include "forward_tiles.cuh"
#undef TILED
#undef WHOLE
  return true;
}

// The head width an instance holds: the first table width >= D, 0 past the
// widest (256, wgmma's widest N).
inline int padded_width(int D) {
#define TILED(w, n, pp) \
  if (D <= w) return w;
#define WHOLE(w, n)
#include "forward_tiles.cuh"
#undef TILED
#undef WHOLE
  return 0;
}

// The tiled forward at any T, D <= 256: the width's key tile, two query
// buffers.
inline cudaError_t launch_tiled(const View& q, const View& k, const View& v,
                                void* out, void* lse, int B, int H, int T,
                                int D, float scale, cudaStream_t stream) {
#define TILED(w, n, pp)                                                  \
  if (D <= w)                                                            \
    return launch<w, n, 2, pp != 0>(q, k, v, out, lse, B, H, T, D, scale, \
                                    stream);
#define WHOLE(w, n)
#include "forward_tiles.cuh"
#undef TILED
#undef WHOLE
  return cudaErrorInvalidValue;
}

// The whole head as one key tile: the first whole-head row of the head's
// width whose keys hold round_up(T, 8); else the tiled forward.
inline cudaError_t launch_whole_or_tiled(const View& q, const View& k,
                                         const View& v, void* out, void* lse,
                                         int B, int H, int T, int D,
                                         float scale, cudaStream_t stream) {
  const int width = padded_width(D);
  const int keys = (T + 7) / 8 * 8;
#define TILED(w, n, pp)
#define WHOLE(w, n)                                                        \
  if (width == w && keys <= n)                                             \
    return launch<w, n, 2, pingpong_at(w)>(q, k, v, out, lse, B, H, T, D, \
                                           scale, stream);
#include "forward_tiles.cuh"
#undef TILED
#undef WHOLE
  return launch_tiled(q, k, v, out, lse, B, H, T, D, scale, stream);
}

}  // namespace
}  // namespace attn_wg
