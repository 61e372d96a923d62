// Tiled ("flash") multi-head self-attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel vit_cifar_tpu/ops/pallas/attention.py::
// _flash_fwd_body in both its variants: the inference one (reached through
// flash_attention) and the training one (reached through the custom VJP's
// _flash_fwd), which also writes the row logsumexp.  For every (batch,
// head): s = q.k^T * scale, then the online softmax over key tiles --
// running row max m, normaliser l and unnormalised context acc, rescaled
// whenever a tile raises the max -- and finally o = acc / l and
// lse = m + log(l), with f32 softmax and sums whatever the input type.  o is
// written in the (B, T, H, D) layout that flash_attention returns; lse, when
// given, is (B, H, T) f32, not the TPU's lane-broadcast (B, H, Tp, 128).
// q, k and v are the caller's (B, H, T, D) views, read in place through
// their strides (on the model's path, transposed views of (B, T, H, D)
// projections); nothing is copied or padded in device memory.
//
// What bounds it on this card: at the pixel-token ViT's shape (B, H, T, D)
// = (128, 12, 1025, 32), one head is two 1025x1025x32 products and 1.05 M
// exps against 262 KB of q, k, v and o in bf16, some 500 FLOP per byte --
// compute-bound, and the exps (one per logit, 16 a clock per SM on the
// special-function units) take longer than the products at the tensor
// cores' peak.  So the design keeps the products off the critical path and
// the special-function units busy:
//
//   bf16 (dtype 1): the warp-specialised wgmma kernel of
//   wgmma_attention.cuh, a persistent grid of one block an SM walking the
//   (b, h, 128 query rows) work items.  A producer thread brings each
//   item's q once (two buffers up to 256 columns, so the next item's
//   arrives early) and its K and V tiles (128 keys at 32 columns, 96 at
//   64, 64 at 128 and 192, 32 at 256: what fits the registers;
//   forward_tiles.cuh) through a ring of 2-4 stages by TMA, under
//   mbarriers; two consumer warpgroups of 64 rows each run s = q.k^T and
//   o += p.v (p split into bf16 hi + lo, so p.v keeps p at f32 accuracy)
//   as wgmma, and at the widths where it measured faster take turns at
//   the tensor cores, so that one's softmax overlaps the other's
//   products; inside a warpgroup the p.v of one tile runs while the
//   softmax of the next does.  A head of up to 256 columns is one pass
//   (wgmma's N reaches 256): the logits and the exps are computed once.
//   Past 256 columns o is cut into chunks of 192 or 256 columns, a work
//   item each: s = q.k^T is summed over the whole head (q at full width,
//   one buffer; K tiles at full width, 64 keys at 320 columns, 32 at 384,
//   16 at 448 and 512), only the item's chunk of V comes, and each chunk
//   computes the softmax again.  Past 512 columns q and K no longer fit at
//   full width: the streamed instance brings them a 64-column chunk a
//   stage of the ring and sums s over the chunks in registers, so any
//   width runs (forward_tiles.cuh's STREAMED row).  Rows and keys past T
//   and columns past D arrive as zeros from TMA; keys past T get -inf
//   logits (the last key tile, taken first); a warp whose 16 rows all lie
//   past T computes no exps.
//
//   f32 (dtype 0): the same design on TF32 wgmma
//   (wgmma_forward_tf32.cuh).  One TF32 product (10-bit mantissa) would
//   miss the 1e-5 the f32 path is held to: q and each K tile are split into
//   TF32 big + small, and s = q.k^T is three TF32 products (big.big +
//   big.small + small.big); p.V, which TF32 wgmma cannot read MN-major,
//   takes V's three bf16 terms (six bf16 products with the transpose bit)
//   or its TF32 transpose, by the row; each key tile's p.V lands in a fresh
//   accumulator and is added into o in f32.  Up to 128 columns
//   fwd_split_kernel (the FWD_F32 rows of forward_tiles.cuh): converter
//   warps split q and each key tile as they land.  At the pixel shape it is
//   bound by the products (two, three TF32 ones each).  Past 128 columns
//   the streamed instance (fwd_split_stream_kernel, the FWD_F32_STREAMED
//   row): 64 query rows and two chunks of o an item, one a consumer, s
//   summed over 32-column chunks of q and K brought through the ring and
//   computed once an item and key tile (the two consumers take alternate
//   chunks and add each other's part), q, K and V split once a call by a
//   split pass into a scratch that TMA reads.

// Every instance keeps the TPU kernel's guard: a tile whose logits are all
// -inf keeps m at -inf and must not turn it into NaN, so exp uses m_new = 0
// there and the rescale factor of an empty history is 0.  Shared memory
// does not grow with T, so any T and any D run.
//
// Built by vit_cifar_torch/ops/cuda/build.py (nvcc, sm_90a, plain C
// interface bound with ctypes).

#include <math_constants.h>

#include <cstdint>

#include "attention_common.cuh"
#include "wgmma_attention.cuh"
#include "wgmma_forward_tf32.cuh"

namespace {

using namespace attn;

// ---- f32: TF32 wgmma at every width ----------------------------------------
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       void* lse, void* scratch, const Qkv& L, int B, int H,
                       int seq, int D, float scale, cudaStream_t stream) {
  using attn_wg::View;
  return attn_wg::launch_f32_tiled(View{q, L.sb[0], L.sh[0], L.st[0]},
                                   View{k, L.sb[1], L.sh[1], L.st[1]},
                                   View{v, L.sb[2], L.sh[2], L.st[2]}, out,
                                   lse, scratch, B, H, seq, D, scale, stream);
}

// ---- bf16 ------------------------------------------------------------------
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, void* lse, const Qkv& L, int B, int H,
                        int seq, int D, float scale, cudaStream_t stream) {
  using attn_wg::View;
  return attn_wg::launch_tiled(View{q, L.sb[0], L.sh[0], L.st[0]},
                               View{k, L.sb[1], L.sh[1], L.st[1]},
                               View{v, L.sb[2], L.sh[2], L.st[2]}, out, lse,
                               B, H, seq, D, scale, stream);
}

}  // namespace

// q, k, v: (B, H, T, D) views, their (b, h, t) strides in elements in
// `strides` (q's three, then k's, then v's; d's stride is 1); the views
// meet TMA's rules (16-byte aligned bases, strides multiples of 16 bytes),
// which the wrapper sees to, except in f32 past 128 columns, where the
// split pass reads them with plain loads through any strides.  out:
// (B, T, H, D) contiguous, same type;
// lse: (B, H, T) float32 contiguous, or null for the inference variant;
// scratch: flash_fwd_scratch_floats(B, H, T, D) floats in f32 where that
// is not 0, else unused.  Any D; dtype 0 is float32, 1 is bfloat16.
// Returns the cudaError_t of the launch (0 on success); the caller checks
// shapes.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, void* scratch,
                         const long long* strides, int B, int H, int T, int D,
                         float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Qkv L = Qkv::from(strides);
  switch (dtype) {
    case 0:
      return launch_f32(q, k, v, out, lse, scratch, L, B, H, T, D, scale, s);
    case 1:
      return launch_bf16(q, k, v, out, lse, L, B, H, T, D, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The f32 forward's scratch at (B, H, T, D), in floats (0: none): the split
// pass's copies of q and K (TF32 halves) and V (bf16 terms) past 128
// columns.
extern "C" long long flash_fwd_scratch_floats(int B, int H, int T, int D) {
  return attn_wg::f32_scratch_floats(B, H, T, D);
}
