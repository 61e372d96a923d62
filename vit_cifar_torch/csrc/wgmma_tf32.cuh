// What the f32 kernels on TF32 wgmma (dtype 0: the backward pair,
// flash_bwd_dq.cu and flash_bwd_dkv.cu, and the forward of
// wgmma_forward_tf32.cuh, for flash_fwd.cu and mhsa_fwd.cu) share, beside
// the bf16 kernels' blocks (wgmma_blocks.cuh, wgmma_backward.cuh): the
// TF32 wgmma products, the splits that keep them at f32 accuracy, and the
// converter warps' passes over the tiles TMA brings.
//
// The tensor cores take f32 as TF32 (8 exponent, 10 mantissa bits): one
// product misses the 1e-5 the f32 path is held to.  Each operand x is split
// into big = rna(x) and small = rna(x - big), both exact TF32 values (rna:
// cvt.rna.tf32.f32, round to nearest, ties away from zero), and a product
// is big.big + big.small + small.big, accumulated in f32: small.small and
// the roundings left are about 2^-21 of a term, as the bf16 pair's hi + lo
// split of p and ds keeps its products at f32 accuracy.
//
// small_first: a wgmma adds its products and the accumulator with each
// addend's bits below the largest one's last bit truncated, toward zero.
// So the products of a split go into the accumulator smallest first, over
// all the k steps of a call, and big.big (x1.y1) last: the small terms add
// while the accumulator is still as small as they are, and only the last k
// steps truncate at the sum's own scale.  Added into an accumulator
// already at the sum's scale, each small product would lose up to a unit
// of its last place: the streamed pair's gradients then sat 2-2.5x further
// from f64 (rms; tools/f32_grad_noise.py, PERF.md §6).  Every gradient
// product (p and ds are finite) and the streamed kernels' 32-column chunks
// of s and dp take this order.  A whole tile's s or dp (up to 128 columns) keeps
// big.big first in each k8 step: where a logit overflows to -inf (big.big
// -inf, as the fully masked key tile tests make it), its 256 small
// products can overflow the other way before big.big lands, and -inf +
// inf is NaN; a chunk's 64 cannot at those tests' 1e40.
//
// TF32 wgmma has no transpose: both shared-memory operands are K-major.
// s = q.k^T and dp = do.v^T read the tiles as TMA lands them (128-byte
// rows of 32 f32 columns, 128-byte swizzle; big in place, small beside it
// at the same offsets).  The gradient products (dq += ds.k; dv += p^T.do,
// dk += ds^T.q) sum over keys or queries, so their B operand is read
// MN-major, and a table column (bf16x3) chooses how:
//   * the tile's transpose, which the converter warps write, big and
//     small, as 8-row x 4-column core matrices without swizzle; the A
//     operand, p or ds split in the consumers' registers, comes from the
//     accumulator, whose thread holds columns 2t and 2t+1 of every 8 where
//     a TF32 A fragment holds columns t and t+4: the fragment takes them
//     as they lie, and the transposed tile holds its keys (queries) in
//     that order (slot_key), so no value moves between threads;
//   * or three bf16 terms of both operands (below), six bf16 products
//     with the transpose bit, the tensor time of three TF32 products: the
//     converter writes the terms with 16-byte loads and 8-byte stores
//     where the transpose takes 4-byte ones, and bf16 A fragments lie as
//     the accumulator does.  It measured 1.12-1.45x faster
//     (tools/backward_choices.py) and is taken wherever the tile is a
//     multiple of 16 (backward_tiles.cuh).
//
// The converter: warps 1-3 of the producer warpgroup (warp 0's first
// thread issues the TMA loads) wait for a stage's tiles, split them in
// place and into the small halves (and the transposes or bf16 terms), make
// their writes visible to the tensor cores' async proxy, and arrive on the
// stage's "ready" barrier, which the consumers wait for; the consumers
// release the stage to the producer as the bf16 pair does.  Past 128
// columns the pair's streamed instances take the same blocks a 32-column
// chunk (one f32 atom) a stage, each chunk's products of s and dp in fresh
// accumulators added in f32 (flash_bwd_dq.cu, flash_bwd_dkv.cu).

#pragma once

#include "wgmma_backward.cuh"

namespace attn_wg {
namespace {

// wgmma.mma_async m64nNk8, TF32 in, f32 accumulate; both shared-memory
// operands K-major (TF32 has no transpose).  ss: d (+)= A.B^T, A and B in
// shared memory (scale_d 0 overwrites d); rs: the same with A from
// registers (scale_d 1 unless given).  N in {8, 16, 32, 48, 64}: the key
// or query tiles and the columns a consumer holds; and 72 (ss), the f32
// whole-head forward's one key tile at T = 65.
template <int N>
struct Tf32;

template <>
struct Tf32<8> {
  // d (+)= A.B^T, A (64 x 8) and B (8 x 8) K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[4], uint64_t da,
                                           uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d (+)= A.B^T, A (16 x 8 per warp) from registers, B (8 x 8) K-major in
  // shared memory
  static __device__ __forceinline__ void rs(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Tf32<16> {
  // d (+)= A.B^T, A (64 x 8) and B (16 x 8) K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da,
                                           uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d (+)= A.B^T, A (16 x 8 per warp) from registers, B (16 x 8) K-major in
  // shared memory
  static __device__ __forceinline__ void rs(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Tf32<32> {
  // d (+)= A.B^T, A (64 x 8) and B (32 x 8) K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                           uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d (+)= A.B^T, A (16 x 8 per warp) from registers, B (32 x 8) K-major in
  // shared memory
  static __device__ __forceinline__ void rs(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Tf32<48> {
  // d (+)= A.B^T, A (64 x 8) and B (48 x 8) K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[24], uint64_t da,
                                           uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d (+)= A.B^T, A (16 x 8 per warp) from registers, B (48 x 8) K-major in
  // shared memory
  static __device__ __forceinline__ void rs(float (&d)[24],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Tf32<64> {
  // d (+)= A.B^T, A (64 x 8) and B (64 x 8) K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
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
  // d (+)= A.B^T, A (16 x 8 per warp) from registers, B (64 x 8) K-major in
  // shared memory
  static __device__ __forceinline__ void rs(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Tf32<72> {
  // d (+)= A.B^T, A (64 x 8) and B (72 x 8) K-major in shared memory: the
  // f32 whole-head forward's logits at T = 65
  static __device__ __forceinline__ void ss(float (&d)[36], uint64_t da,
                                           uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35"
        "}, %36, %37, p, 1, 1;\n}\n"
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

constexpr int kConverterWarps = 3;  // warps 1-3 of the producer warpgroup

// x as TF32, rounded to nearest with ties away from zero: its low 13 bits 0.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x = big + small, both TF32.
__device__ __forceinline__ void split_tf32(float x, float& big, float& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - big);
}

// The key (query) a slot of a transposed tile holds within its 8: slots t
// and t + 4 hold keys 2t and 2t + 1, as a TF32 A fragment split from an
// accumulator holds them (split_frags_tf32).
__host__ __device__ constexpr int slot_key(int slot) {
  return slot < 4 ? 2 * slot : 2 * (slot - 4) + 1;
}

// An f32 tile as TMA lands it: atoms of 32 columns (128-byte rows, 128-byte
// swizzle) side by side, each the tile's rows tall.
template <int kDp>
struct F32Atoms {
  static constexpr int kCols = 32;
  static constexpr int kCount = kDp / kCols;
  static constexpr int kRowBytes = 128;
  static constexpr uint32_t kSbo = 8 * kRowBytes;  // 8-row groups
  static_assert(kDp % kCols == 0, "f32 head width: whole atoms");
};

// The `rows` x kDp f32 tile at (h, t0, b) of a tensor map into dst, atom
// by atom; its bytes are counted on `bar`.
template <int kDp>
__device__ __forceinline__ void load_tile_f32(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int rows, int h,
                                              int t0, int b) {
#pragma unroll
  for (int a = 0; a < F32Atoms<kDp>::kCount; ++a)
    tma_load_4d(dst + a * rows * 128, map, bar, 32 * a, h, t0, b);
}

// d = A.B^T over kDp columns in three products a k8 step, Ab.Bb^T +
// Ab.Bs^T + As.Bb^T: A the 64 rows at shared address a (big; small at
// a_small) of a tile whose atoms are a_rows tall, B the kN rows at b (big;
// small at b_small), both as TMA lands them.  With kSmallFirst the small
// products of every k8 step come first and big.big last (small_first: the
// streamed kernels' 32-column chunks); without it each k8 step's big.big
// comes first (a whole tile's width).  Not committed.
template <int kDp, int kN, bool kSmallFirst = false>
__device__ __forceinline__ void product_ss_tf32(float (&d)[kN / 2],
                                                uint32_t a, uint32_t a_small,
                                                int a_rows, uint32_t b,
                                                uint32_t b_small) {
  using A = F32Atoms<kDp>;
  // the k8 step kk of the tile at x (a_rows or kN rows an atom)
  auto desc = [](uint32_t x, int rows, int kk) {
    return make_desc(x + kk / 4 * rows * A::kRowBytes + 32 * (kk % 4), 16,
                     A::kSbo, 1);
  };
  if constexpr (kSmallFirst) {
#pragma unroll
    for (int kk = 0; kk < kDp / 8; ++kk) {
      Tf32<kN>::ss(d, desc(a, a_rows, kk), desc(b_small, kN, kk), kk);
      Tf32<kN>::ss(d, desc(a_small, a_rows, kk), desc(b, kN, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kDp / 8; ++kk)
      Tf32<kN>::ss(d, desc(a, a_rows, kk), desc(b, kN, kk), 1);
  } else {
#pragma unroll
    for (int kk = 0; kk < kDp / 8; ++kk) {
      Tf32<kN>::ss(d, desc(a, a_rows, kk), desc(b, kN, kk), kk);
      Tf32<kN>::ss(d, desc(a, a_rows, kk), desc(b_small, kN, kk), 1);
      Tf32<kN>::ss(d, desc(a_small, a_rows, kk), desc(b, kN, kk), 1);
    }
  }
}

// d = (big + small).B over kK keys (queries) in three products a k8 step,
// big.Bs + small.Bb + big.Bb: big and small the A fragments of kK / 8 k8
// steps (split_frags_tf32), B kCols rows of a transposed tile (core
// matrices of 8 rows x 4 keys, kK / 4 of them along a row group) from the
// row at b (big; small at b_small).  The small products come first and
// big.big last (small_first).  Not committed.
template <int kCols, int kK>
__device__ __forceinline__ void product_rs_tf32(
    float (&d)[kCols / 2], const uint32_t (&big)[kK / 8][4],
    const uint32_t (&small)[kK / 8][4], uint32_t b, uint32_t b_small) {
  constexpr uint32_t kSbo = kK / 4 * 128;  // the next 8 rows
  auto desc = [](uint32_t x, int kk) {
    return make_desc(x + 256 * kk, 128, kSbo, 0);
  };
#pragma unroll
  for (int kk = 0; kk < kK / 8; ++kk) {
    // the first overwrites d
    Tf32<kCols>::rs(d, big[kk], desc(b_small, kk), kk);
    Tf32<kCols>::rs(d, small[kk], desc(b, kk));
  }
#pragma unroll
  for (int kk = 0; kk < kK / 8; ++kk)
    Tf32<kCols>::rs(d, big[kk], desc(b, kk));
}

// An accumulator of kN columns as the TF32 big and small A fragments of kN
// / 8 k8 steps.  A fragment holds (g, t), (g + 8, t), (g, t + 4) and (g +
// 8, t + 4) of its 16 x 8; this thread's accumulator columns 2t and 2t + 1
// go to slots t and t + 4 (slot_key).
template <int kN>
__device__ __forceinline__ void split_frags_tf32(const float (&x)[kN / 2],
                                                 uint32_t (&big)[kN / 8][4],
                                                 uint32_t (&small)[kN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kN / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // slot e: (g, t) (g + 8, t) (g, t + 4) (g + 8, t + 4) from the
      // accumulator's (g, 2t) (g + 8, 2t) (g, 2t + 1) (g + 8, 2t + 1)
      float b, s;
      split_tf32(x[4 * kk + ((e & 1) << 1 | e >> 1)], b, s);
      big[kk][e] = __float_as_uint(b);
      small[kk][e] = __float_as_uint(s);
    }
}

// x, opaque to the compiler: an item's operand address passed through it
// at each tile has its descriptors made there, not hoisted out of the tile
// loop and held in registers (three products a k8 step make many).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The converter's passes.  `cw` is the converter warp (0 .. 2), `lane` its
// lane.

// A tile of `bytes` split in place (big) and into `small` at the same
// offsets, four values a thread and step.
__device__ __forceinline__ void split_tile(uint8_t* tile, uint8_t* small,
                                           int bytes, int cw, int lane) {
  for (int i = 16 * (32 * cw + lane); i < bytes;
       i += 16 * 32 * kConverterWarps) {
    const float4 x = *reinterpret_cast<const float4*>(tile + i);
    float4 b, s;
    split_tf32(x.x, b.x, s.x);
    split_tf32(x.y, b.y, s.y);
    split_tf32(x.z, b.z, s.z);
    split_tf32(x.w, b.w, s.w);
    *reinterpret_cast<float4*>(tile + i) = b;
    *reinterpret_cast<float4*>(small + i) = s;
  }
}

// A kRows x kDp tile as TMA lands it split in place and into `small`, and
// its transpose (kDp rows, of kRows keys in slot order) written as big into
// tb and small into ts: core matrix m = (column / 8) * kRows / 4 + slot / 4
// at byte 128 m, row (column % 8) at 16 bytes, slot % 4 at 4.  A warp takes
// one core matrix a step, lane 4 (column % 8) + slot % 4: its reads of the
// swizzled tile and its writes fall on 32 banks.
// Without kKeep (the forward's V, read only as that B) the tile's halves
// are not written back, and `small` is not read.
template <int kDp, int kRows, bool kKeep = true>
__device__ __forceinline__ void split_transpose(uint8_t* tile, uint8_t* small,
                                                uint8_t* tb, uint8_t* ts,
                                                int cw, int lane) {
  constexpr int kAlongK = kRows / 4;  // core matrices along a row group
  const int cl = lane >> 2, sl = lane & 3;
  for (int m = cw; m < kDp / 8 * kAlongK; m += kConverterWarps) {
    const int col = 8 * (m / kAlongK) + cl;
    const int slot = 4 * (m % kAlongK) + sl;
    const int key = (slot & ~7) + slot_key(slot & 7);
    const int cc = col & 31;
    const int off = ((col >> 5) * kRows + key) * 128 +
                    (((cc >> 2) ^ (key & 7)) << 4) + ((cc & 3) << 2);
    float b, s;
    split_tf32(*reinterpret_cast<const float*>(tile + off), b, s);
    if constexpr (kKeep) {
      *reinterpret_cast<float*>(tile + off) = b;
      *reinterpret_cast<float*>(small + off) = s;
    }
    const int t_off = 128 * m + 16 * cl + 4 * sl;
    *reinterpret_cast<float*>(tb + t_off) = b;
    *reinterpret_cast<float*>(ts + t_off) = s;
  }
}

// The other route for the products that need a transposed operand: a
// three-term bf16 split, x = x1 + x2 + x3 (x1 = rn(x), x2 = rn(x - x1),
// x3 = rn(x - x1 - x2), about 24 bits), six bf16 products a k16 step
// (x1.y1 + x1.y2 + x2.y1 + x1.y3 + x2.y2 + x3.y1, the tensor time of three
// TF32 products), whose B is read MN-major through bf16 wgmma's transpose
// bit from tiles in the bf16 swizzled layout (Atoms), so nothing is
// transposed.  A table column chooses it (DQ_F32's and DKV_F32's bf16x3;
// its k16 steps want tiles of a multiple of 16).

// (a, b) as three bf16 terms, packed with a in the low half as an A
// fragment wants it.
__device__ __forceinline__ void split_bf16x3(float a, float b, uint32_t& t1,
                                             uint32_t& t2, uint32_t& t3) {
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(a, b);
  const float2 f1 = __bfloat1622float2(h1);
  const float ra = a - f1.x, rb = b - f1.y;
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(ra, rb);
  const float2 f2 = __bfloat1622float2(h2);
  t1 = as_u32(h1);
  t2 = as_u32(h2);
  t3 = as_u32(__floats2bfloat162_rn(ra - f2.x, rb - f2.y));
}

// An accumulator of kN columns as the three bf16 terms' A fragments of kN
// / 16 k16 steps (the accumulator's layout is the bf16 A fragment's).
template <int kN>
__device__ __forceinline__ void split_frags_bf16x3(
    const float (&x)[kN / 2], uint32_t (&t)[3][kN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_bf16x3(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1], t[0][kk][e],
                   t[1][kk][e], t[2][kk][e]);
}

// The same for an accumulator of kN columns as the fragments of a depth of
// kK (kN rounded up to 16): the keys past kN get 0 (the f32 forward's p at
// a key tile of an odd number of 8-key blocks).
template <int kN, int kK>
__device__ __forceinline__ void split_frags_bf16x3_padded(
    const float (&x)[kN / 2], uint32_t (&t)[3][kK / 16][4]) {
  static_assert(kK == (kN + 15) / 16 * 16, "the depth of whole k16 steps");
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e >= 2 && 2 * kk + 1 >= kN / 8) {  // keys past kN
        t[0][kk][e] = t[1][kk][e] = t[2][kk][e] = 0u;
        continue;
      }
      split_bf16x3(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1], t[0][kk][e],
                   t[1][kk][e], t[2][kk][e]);
    }
}

// d = (t1 + t2 + t3).(y1 + y2 + y3) over kK rows in six bf16 products a
// k16 step: t the A fragments (split_frags_bf16x3), y1 .. y3 the three
// terms' tiles (kK rows, in the bf16 layout of a kDp-column tile, each
// `term` bytes after the last), kCols columns from the atom at b, read
// MN-major.  By size, smallest first (small_first): x3.y1 + x2.y2 +
// x1.y3 over every k16 step, then x2.y1 + x1.y2, then x1.y1.  Not
// committed.
template <int kDp, int kCols, int kK>
__device__ __forceinline__ void product_rs_bf16x3(
    float (&d)[kCols / 2], const uint32_t (&t)[3][kK / 16][4], uint32_t b,
    uint32_t term) {
  using A = Atoms<kDp>;
  // term i of B's k16 step kk
  auto y = [&](int i, int kk) {
    return make_desc(b + i * term + kk * 16 * A::kRowBytes,
                     kK * A::kRowBytes, A::kSbo, A::kSwizzle);
  };
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
    Wgmma<kCols>::rs(d, t[2][kk], y(0, kk), kk);  // the first overwrites d
    Wgmma<kCols>::rs(d, t[1][kk], y(1, kk));
    Wgmma<kCols>::rs(d, t[0][kk], y(2, kk));
  }
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
    Wgmma<kCols>::rs(d, t[1][kk], y(0, kk));
    Wgmma<kCols>::rs(d, t[0][kk], y(1, kk));
  }
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk)
    Wgmma<kCols>::rs(d, t[0][kk], y(0, kk));
}

// A kRows x kDp tile as TMA lands it split in place and into `small`, and
// written as three bf16 terms into the tiles at tb, tb + term, tb + 2 term
// in the bf16 swizzled layout (Atoms<kDp>: 64-byte rows at width 32, else
// 128-byte rows of 64 columns), four values a thread and step.  Without
// kKeep only the terms are written (the forward's V).
template <int kDp, int kRows, bool kKeep = true>
__device__ __forceinline__ void split_terms(uint8_t* tile, uint8_t* small,
                                            uint8_t* tb, int term, int cw,
                                            int lane) {
  using A = Atoms<kDp>;
  for (int i = 32 * cw + lane; i < kDp / 4 * kRows;
       i += 32 * kConverterWarps) {
    // f32 chunk i: atom i / (8 kRows), row (i / 8) % kRows, 16 bytes at i
    const int row = i / 8 % kRows;
    const int col = 32 * (i / (8 * kRows)) + 4 * ((i & 7) ^ (row & 7));
    const float4 x = *reinterpret_cast<const float4*>(tile + 16 * i);
    if constexpr (kKeep) {
      float4 b, s;
      split_tf32(x.x, b.x, s.x);
      split_tf32(x.y, b.y, s.y);
      split_tf32(x.z, b.z, s.z);
      split_tf32(x.w, b.w, s.w);
      *reinterpret_cast<float4*>(tile + 16 * i) = b;
      *reinterpret_cast<float4*>(small + 16 * i) = s;
    }
    const int cc = col % A::kCols;
    const int swz = A::kSwizzle == 1 ? row & 7 : (row >> 1) & 3;
    const int off = (col / A::kCols * kRows + row) * A::kRowBytes +
                    ((cc / 8 ^ swz) << 4) + 2 * (cc % 8);
    uint2 t1, t2, t3;
    split_bf16x3(x.x, x.y, t1.x, t2.x, t3.x);
    split_bf16x3(x.z, x.w, t1.y, t2.y, t3.y);
    *reinterpret_cast<uint2*>(tb + off) = t1;
    *reinterpret_cast<uint2*>(tb + term + off) = t2;
    *reinterpret_cast<uint2*>(tb + 2 * term + off) = t3;
  }
}

// p or ds as the A fragments of a gradient product over kK keys or queries
// (a tile's part of dq = ds.k; of dv = p^T.do and dk = ds^T.q): TF32 big +
// small with the tile's transpose (three TF32 products a k8 step); or,
// with kBf16x3, three bf16 terms with the tile's three bf16 terms read
// MN-major (six bf16 products a k16 step).  The product overwrites its
// accumulator: the tensor cores add a product into it with its low bits
// truncated, toward zero, so a gradient summed in it over every tile of
// T shrinks by a few parts in 1e5 (dv at T=1025); each tile's part is
// added into the gradient in the consumers' f32 registers instead (FADD,
// to nearest), and the truncations of the parts, whose signs vary, do not
// pile up.
template <int kK, bool kBf16x3>
struct GradFrags;
template <int kK>
struct GradFrags<kK, false> {
  uint32_t big[kK / 8][4], small[kK / 8][4];
  __device__ void fence() {
    fence_regs(big);
    fence_regs(small);
  }
  __device__ void split(const float (&x)[kK / 2]) {
    split_frags_tf32<kK>(x, big, small);
  }
  // acc = frags.B over the kCols columns from col0: B the stage's
  // transpose at b (kDp rows of kK keys), its small half `apart` bytes on
  template <int kDp, int kCols>
  __device__ void product(float (&acc)[kCols / 2], uint32_t b, int apart,
                          int col0) {
    const uint32_t rows = b + col0 * kK * 4;  // the rows from col0
    product_rs_tf32<kCols, kK>(acc, big, small, rows, rows + apart);
  }
};
template <int kK>
struct GradFrags<kK, true> {
  uint32_t t[3][kK / 16][4];
  __device__ void fence() {
    fence_regs(t[0]);
    fence_regs(t[1]);
    fence_regs(t[2]);
  }
  __device__ void split(const float (&x)[kK / 2]) {
    split_frags_bf16x3<kK>(x, t);
  }
  // acc = frags.B over the kCols columns from col0: B the stage's three
  // bf16 terms of the tile (kK rows, the bf16 layout) from b, `apart`
  // bytes apart
  template <int kDp, int kCols>
  __device__ void product(float (&acc)[kCols / 2], uint32_t b, int apart,
                          int col0) {
    using A = Atoms<kDp>;
    product_rs_bf16x3<kDp, kCols, kK>(
        acc, t, b + col0 / A::kCols * kK * A::kRowBytes, apart);
  }
};

// A tile's part of a gradient into its f32 sum, to nearest.
template <int n>
__device__ __forceinline__ void add_part(float (&sum)[n],
                                         const float (&part)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) sum[i] += part[i];
}

// The converter warp's end of a stage: its writes made visible to the
// tensor cores' async proxy, then one arrival on `bar`.
__device__ __forceinline__ void converted(uint64_t* bar, int lane) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

}  // namespace
}  // namespace attn_wg
