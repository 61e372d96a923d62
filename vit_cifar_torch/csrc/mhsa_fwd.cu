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
//   f32 (dtype 0): the same grids on TF32 wgmma
//   (wgmma_forward_tf32.cuh): the whole head as one key tile where a
//   consumer holds it (round_up(T, 8) keys up to 72 at 32 columns, 64 at
//   64, 32 at 128: the WHOLE_F32 rows of forward_tiles.cuh; 72 at T=65),
//   else the tiled items of the FWD_F32 rows, and past 128 columns those
//   of the streamed FWD_F32_STREAMED row, as flash_fwd.cu launches them.
//   q and K are split into TF32 big + small and s = q.k^T is three TF32
//   products; p.V takes V's three bf16 terms (six bf16 products with the
//   transpose bit) or its TF32 transpose, by the row (flash_fwd.cu says
//   why and how the streamed instance cuts a head).

// The router (ops/attention.py::route) takes this forward by default where
// a whole-head instance holds the head in the module's dtype (a WHOLE or
// WHOLE_F32 row), the tiled forward elsewhere.
//
// Built by vit_cifar_torch/ops/cuda/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C function mhsa_fwd below (ctypes).

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
  return attn_wg::launch_f32_whole_or_tiled(
      View{q, L.sb[0], L.sh[0], L.st[0]}, View{k, L.sb[1], L.sh[1], L.st[1]},
      View{v, L.sb[2], L.sh[2], L.st[2]}, out, lse, scratch, B, H, seq, D,
      scale, stream);
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
// `strides` (q's three, then k's, then v's; d's stride is 1); the views
// meet TMA's rules (16-byte aligned bases, strides multiples of 16 bytes),
// which the wrapper sees to, except in f32 past 128 columns, where the
// split pass reads them with plain loads through any strides.  out:
// (B, T, H, D) contiguous, same type;
// lse: (B, H, T) float32 contiguous, or null for the inference variant;
// scratch: mhsa_fwd_scratch_floats(B, H, T, D) floats in f32 where that is
// not 0, else unused.  Any T and any D; dtype 0 is float32, 1 is bfloat16.
// Returns the cudaError_t of the launch (0 on success); the caller checks
// shapes.
extern "C" int mhsa_fwd(const void* q, const void* k, const void* v,
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

// The f32 forward's scratch at (B, H, T, D), in floats (0: none), as
// flash_fwd_scratch_floats.
extern "C" long long mhsa_fwd_scratch_floats(int B, int H, int T, int D) {
  return attn_wg::f32_scratch_floats(B, H, T, D);
}
