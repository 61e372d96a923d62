// Tiled ("flash") attention backward, the key and value gradients, for
// Hopper (sm_90a), at any T.
//
// Replaces the TPU kernel
// vit_cifar_tpu/ops/pallas/attention.py::_flash_bwd_dkv_kernel (pass 2 of
// _flash_bwd_impl) where flash_attention's and fused_attention's custom
// VJPs reach it.  For every (batch, head) and key row j:
//   p_ij = exp(q_i . k_j * scale - lse_i),  dp_ij = do_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i) * scale,  delta_i = sum_d do_i * o_i
//   dv_j = sum_i p_ij do_i,   dk_j = sum_i ds_ij q_i
// in f32 whatever the input type; lse is the forward's.  q, k, v, o and do
// are the caller's views, read in place through their strides (o and do in
// the (B, T, H, D) layout the forward returns), and dk and dv are written
// in the input type in the strides the wrapper gives them (k's and v's
// own, torch.empty_like).
//
// What bounds it on this card: at the pixel-token ViT's shape (128, 12,
// 1025, 32) one head is four 1025x1025x32 products (q.k, do.v, p^T.do,
// ds^T.q) and 1.05 M exps against about 0.46 MB in and out in bf16: the
// products at the tensor cores' peak a little more than the exps, and with
// p and ds split into hi + lo the products are six.  At the flagship's T=65
// it is bytes.  So:
//
//   bf16 (dtype 1): first a pass over the rows (dkv_rows_kernel)
//   writes every query row's lse * log2(e) and delta into a scratch the
//   wrapper gives, padded with zeros to whole query tiles; then the
//   warp-specialised wgmma kernel below, on the blocks of wgmma_blocks.cuh
//   and wgmma_backward.cuh.  A persistent grid of one block an SM walks the
//   work items (b, h, key tile: 128 keys, or 64 from 128 columns on), so a head
//   of T <= 128 is one item.  A producer thread brings an item's K and V
//   once by TMA (two buffers) and, through a ring, each query tile's Q and
//   dO (TMA) and its rows of lse and delta (bulk copies).  Two consumer
//   warpgroups run s^T = k.q^T and dp^T = v.do^T as ss-wgmmas, p^T and
//   ds^T in their registers (one FFMA into ex2 an exponent), each split
//   into bf16 hi + lo, and dv += p^T.do and dk += ds^T.q as rs-wgmmas that
//   read the same Q and dO tiles MN-major; the next tile's s^T and dp^T are
//   issued first, so the exps of one tile run while the tensor cores add
//   the last.  dk and dv stay in registers until the item ends: no atomics,
//   two calls give equal bits.  The consumers hold dk and dv of 64 keys
//   (width registers a thread) beside s^T and dp^T of a query tile and
//   their fragments, within the 168 registers ptxas gives them: the query
//   tile is 64 up to 128 columns and 32 past (backward_tiles.cuh, the
//   fastest measured: tools/backward_choices.py; 128 has ptxas serialise
//   the wgmmas), and from 128 columns on the two consumers split the
//   columns of the same 64 keys into chunks of 64 (backward_tiles.cuh),
//   each computing p^T and ds^T over all the head's columns (padded to a
//   multiple of 128), a work item two chunks: 2 * D/128 times in all.  The
//   item's keys at the full width fit shared memory beside the ring up to
//   512 columns (16-row query tiles there); past the table the streamed
//   instance (dkv_stream_kernel) brings K, V, Q and dO a 64-column chunk a
//   stage and sums s^T and dp^T over the chunks in its registers, and Q
//   and dO at the item's columns through a second ring, so any width
//   runs.  Query rows past T arrive as zeros with lse and delta 0, so they
//   add exactly 0; keys past T are never written.
//
//   f32 (dtype 0) up to 128 columns: the rows pass over f32 o and do,
//   then the same kernel's design on TF32 wgmma (dkv_split_kernel;
//   wgmma_tf32.cuh): each operand split into TF32 big + small, a product
//   big.big + big.small + small.big in f32 (one TF32 product would miss
//   the f32 path's 1e-5); three converter warps of the producer warpgroup
//   split the tiles TMA brings (K and V an item, Q and dO a query tile) and
//   write the B of ds^T.q and p^T.do (TF32 wgmma reads both operands
//   K-major only): Q's and dO's three bf16 terms, read MN-major by six
//   bf16 products, or at 128 columns their TF32 transposes; p^T and ds^T
//   are split in the consumers' registers; each query tile's parts of dk
//   and dv are added into them in f32 (GradFrags says why).  Tiles and
//   route by width in backward_tiles.cuh's DKV_F32 rows.  Past 128 columns
//   the streamed instance (dkv_split_stream_kernel, the DKV_F32_STREAMED
//   row): K, V, Q and dO come a 32-column chunk a stage, split by the
//   converter warps, and s^T and dp^T are summed over the chunks in f32 in
//   the consumers' registers, the B of the gradient products at the item's
//   columns through a second ring, so any width runs on the tensor
//   cores.
//
// Shared memory does not grow with T, so any T and any D run.  Offsets are
// int64; nothing is padded in device memory but the rows' scratch.
//
// Built by vit_cifar_torch/ops/cuda/build.py (nvcc, sm_90a, plain C
// interface bound with ctypes).

#include <math_constants.h>

#include <cstdint>

#include "attention_common.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace attn;

// acc + the dot product of 8 bf16 pairs, x and y 16 bytes each, in f32.
__device__ __forceinline__ float dot8(uint4 x, uint4 y, float acc) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the top half of the f32 of the same value
    acc = fmaf(__uint_as_float(xs[i] << 16), __uint_as_float(ys[i] << 16),
               acc);
    acc = fmaf(__uint_as_float(xs[i] & 0xffff0000u),
               __uint_as_float(ys[i] & 0xffff0000u), acc);
  }
  return acc;
}

// acc + the dot product of 4 f32 pairs.
__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

// acc + sum_d do * o over a row of D values, 16 bytes at a time.
__device__ __forceinline__ float dot_rows(const __nv_bfloat16* d,
                                          const __nv_bfloat16* o, int D,
                                          float acc) {
  for (int ch = 0; ch < D / 8; ++ch)
    acc = dot8(*reinterpret_cast<const uint4*>(d + 8 * ch),
               *reinterpret_cast<const uint4*>(o + 8 * ch), acc);
  return acc;
}
__device__ __forceinline__ float dot_rows(const float* d, const float* o,
                                          int D, float acc) {
  for (int ch = 0; ch < D / 4; ++ch)
    acc = dot4(*reinterpret_cast<const float4*>(d + 4 * ch),
               *reinterpret_cast<const float4*>(o + 4 * ch), acc);
  return acc;
}

// ---- the rows pass of the wgmma instances ----------------------------------
// lse * log2(e) and delta of every query row of every head into the rows
// the dk/dv kernel's producer copies with each query tile (4 * queries
// bytes each; lse's own rows, T floats, need not be 16-byte aligned), zeros
// past T.  delta = sum_d do * o, from the o and do rows (bf16, or f32 for
// the TF32 instances) as the TPU kernel computes it; once a row here, not
// once a query tile and work item.  With `vec` 16 bytes of a row a load.
template <typename T>
__global__ void __launch_bounds__(256)
    dkv_rows_kernel(const attn_wg::BwdParamsT<T> p, int BH, bool vec) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= BH * p.Tpad) return;
  const int bh = idx / p.Tpad;
  const int t = idx - bh * p.Tpad;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  float l2 = 0.f, dl = 0.f;
  if (t < p.T) {
    const T* orow = p.o + b * p.so[0] + h * p.so[1] + t * p.so[2];
    const T* drow = p.dout + b * p.sd[0] + h * p.sd[1] + t * p.sd[2];
    if (vec) {
      dl = dot_rows(drow, orow, p.D, dl);
    } else {
      for (int d = 0; d < p.D; ++d)
        dl = fmaf(attn_wg::to_float(drow[d]), attn_wg::to_float(orow[d]),
                  dl);
    }
    l2 = p.lse[static_cast<long long>(bh) * p.T + t] * attn_wg::kLog2e;
  }
  p.rows[idx] = l2;
  p.deltas[idx] = dl;
}

// Fills the rows and deltas of `p` (a scratch of 2 * B * H * Tpad floats
// at `rows`) and launches the rows pass; returns its cudaError_t.
template <typename T>
cudaError_t launch_rows(attn_wg::BwdParamsT<T>& p, float* rows,
                        const void* o, const void* dout, const BwdLayout& L,
                        int BH, int D, cudaStream_t s) {
  p.Tpad =
      (p.T + attn_wg::kRowsPad - 1) / attn_wg::kRowsPad * attn_wg::kRowsPad;
  p.rows = rows;
  p.deltas = rows + static_cast<int64_t>(BH) * p.Tpad;
  // 16-byte rows of o and do for the rows' dot products
  constexpr int kPer16 = 16 / sizeof(T);
  const bool vec = D % kPer16 == 0 &&
                   (reinterpret_cast<uintptr_t>(o) |
                    reinterpret_cast<uintptr_t>(dout)) % 16 == 0 &&
                   (L.sb[3] | L.sh[3] | L.st[3] | L.sb[4] | L.sh[4] |
                    L.st[4]) % kPer16 == 0;
  dkv_rows_kernel<T><<<(BH * p.Tpad + 255) / 256, 256, 0, s>>>(p, BH, vec);
  return cudaGetLastError();
}

// ---- bf16, D <= 512: the warp-specialised wgmma kernel ---------------------
// Shared memory of an instance: kKBufs buffers of an item's K and V tiles
// (kKeys rows each, all columns), kStages stages of a Q and a dO tile (kNq
// rows each) and of their rows' lse * log2(e) and delta, then the
// barriers.
template <int kDp, int kNq, int kCols>
struct DkvShape {
  static constexpr int kKeys = attn_wg::Cut<kDp, kCols>::kRows;  // an item's
  static constexpr int kKBytes = 2 * kKeys * kDp;  // K or V
  static constexpr int kQBytes = 2 * kNq * kDp;    // Q or dO
  static constexpr int kLineBytes = 4 * kNq;       // lse or delta of a tile
  // two buffers where they leave room for two stages
  static constexpr int kKBufs = attn_wg::kSmemBudget - 4 * kKBytes >=
                                        4 * kQBytes + 4 * kLineBytes
                                    ? 2
                                    : 1;
  // as many stages as fit, at most 4
  static constexpr int kFit = (attn_wg::kSmemBudget - 2 * kKBufs * kKBytes) /
                              (2 * kQBytes + 2 * kLineBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kVOff = kKBufs * kKBytes;
  static constexpr int kQOff = 2 * kKBufs * kKBytes;
  static constexpr int kDOff = kQOff + kStages * kQBytes;
  static constexpr int kLOff = kDOff + kStages * kQBytes;
  static constexpr int kDeltaOff = kLOff + kStages * kLineBytes;
  static constexpr int kBarOff = kDeltaOff + kStages * kLineBytes;
  static constexpr int kBytes = kBarOff + 8 * 2 * (kKBufs + kStages) + 1024;
  static_assert(kNq % 16 == 0, "query tile: whole k16 steps of dk, dv");
  static_assert(attn_wg::kRowsPad % kNq == 0,
                "a query tile lies within the padded rows");
  static_assert(kCols % attn_wg::Atoms<kDp>::kCols == 0,
                "a consumer's columns are whole swizzle atoms");
  static_assert(kStages >= 2, "a ring of at least two stages");
};

// Work items are the (b * H + h, keys, column group) triples, n_items a
// head (Cut: 128 keys and all columns, or 64 keys and two chunks of kCols
// columns); the grid is persistent.  The producer (warpgroup 2) brings an
// item's K and V once (two buffers where they fit, so the next item's
// arrive early), and through the ring each query tile's Q and dO and its
// rows of lse * log2(e) and delta.  Consumer c takes keys 64c .. 64c+63
// and all columns, or the item's 64 keys and its chunk.  For each
// query tile: s^T = k.q^T and dp^T = v.do^T (ss), p^T = exp2(s^T * c -
// lse2) and ds^T = p^T * (dp^T - delta) * scale in the accumulator
// registers, each split into bf16 hi + lo, then dv += p^T.do and dk +=
// ds^T.q (rs, do and q read MN-major from the same tiles).  The next tile's
// s^T and dp^T are issued before this tile's gradient products, so that its
// exps run while the tensor cores add them.  Query rows past T arrive as
// zeros with lse2 = delta = 0, so p^T is 1 and ds^T 0 there and both
// products add exactly 0; keys past T are never written.  dk and dv stay in
// registers until the item ends.
template <int kDp, int kNq, int kCols>
__global__ void __launch_bounds__(attn_wg::kThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap domap,
               const attn_wg::BwdParams p) {
  using namespace attn_wg;
  using S = DkvShape<kDp, kNq, kCols>;
  using A = Atoms<kDp>;
  using C = Cut<kDp, kCols>;
  constexpr int kStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + S::kBarOff);
  uint64_t* k_empty = k_full + S::kKBufs;
  uint64_t* full = k_empty + S::kKBufs;
  uint64_t* empty = full + kStages;
  const int items =
      (p.total - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::kKBufs; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&k_empty[i], kConsumerWarps);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, warp-uniform for the compiler, so that each role's code
  // is compiled for its own register count
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == kConsumerWGs) {
    // ---- producer: one thread keeps the loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x != 128 * kConsumerWGs) return;
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    prefetch_map(&qmap);
    prefetch_map(&domap);
    int stage = 0, sph = 0, kb = 0, kph = 0;
    for (int i = 0; i < items; ++i) {
      const Item it(p, blockIdx.x + i * gridDim.x);
      const int b = it.b, h = it.h;
      const int k0 = it.tile * S::kKeys;
      mbar_wait(&k_empty[kb], kph ^ 1);  // a fresh barrier passes at once
      mbar_expect_tx(&k_full[kb], 2 * S::kKBytes);
      load_tile<kDp>(smem + kb * S::kKBytes, &kmap, &k_full[kb], S::kKeys, h,
                     k0, b);
      load_tile<kDp>(smem + S::kVOff + kb * S::kKBytes, &vmap, &k_full[kb],
                     S::kKeys, h, k0, b);
      if (++kb == S::kKBufs) kb = 0, kph ^= 1;
      const long long line = static_cast<long long>(it.bh) * p.Tpad;
      for (int j = 0; j < p.n_loop; ++j) {
        const int q0 = j * kNq;
        mbar_wait(&empty[stage], sph ^ 1);
        mbar_expect_tx(&full[stage], 2 * S::kQBytes + 2 * S::kLineBytes);
        load_tile<kDp>(smem + S::kQOff + stage * S::kQBytes, &qmap,
                       &full[stage], kNq, h, q0, b);
        load_tile<kDp>(smem + S::kDOff + stage * S::kQBytes, &domap,
                       &full[stage], kNq, h, q0, b);
        bulk_load(smem + S::kLOff + stage * S::kLineBytes,
                  p.rows + line + q0, S::kLineBytes, &full[stage]);
        bulk_load(smem + S::kDeltaOff + stage * S::kLineBytes,
                  p.deltas + line + q0, S::kLineBytes, &full[stage]);
        if (++stage == kStages) stage = 0, sph ^= 1;
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = role;
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  // the consumer's key rows in the item's K and V tiles
  const uint32_t key_off = C::row0(c) * A::kRowBytes;

  float s[kNq / 2], dp[kNq / 2];
  float dk[kCols / 2], dv[kCols / 2];
  uint32_t ph[kNq / 16][4], pl[kNq / 16][4];
  uint32_t dsh[kNq / 16][4], dsl[kNq / 16][4];

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto fence_grads = [&]() {
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(dsh);
    fence_regs(dsl);
  };

  int stage = 0, sph = 0, kb = 0, kph = 0;
  for (int i = 0; i < items; ++i) {
    const Item it(p, blockIdx.x + i * gridDim.x);
    const int b = it.b, h = it.h;
    // the warp's first key, the consumer's first column and its atom in a
    // Q or dO tile
    const int key_w = it.tile * S::kKeys + C::row0(c) + 16 * warp;
    const int col0 = C::chunk(it.group, c) * kCols;
    const uint32_t col_off = col0 / A::kCols * kNq * A::kRowBytes;
#pragma unroll
    for (int x = 0; x < kCols / 2; ++x) dk[x] = dv[x] = 0.f;
    mbar_wait(&k_full[kb], kph);
    const uint32_t ka = smem_u32(smem + kb * S::kKBytes) + key_off;
    const uint32_t va = smem_u32(smem + S::kVOff + kb * S::kKBytes) + key_off;

    // s^T and dp^T of the query tile in stage st, one commit group; every
    // register the products read or write is settled before it opens
    auto logits = [&](int st) {
      fence_regs(s);
      fence_regs(dp);
      fence_grads();
      wg_fence();
      product_ss<kDp, kNq>(s, ka, S::kKeys,
                           smem_u32(smem + S::kQOff + st * S::kQBytes));
      product_ss<kDp, kNq>(dp, va, S::kKeys,
                           smem_u32(smem + S::kDOff + st * S::kQBytes));
      wg_commit();
    };
    // dv += p^T.do and dk += ds^T.q of the query tile in stage st
    auto accumulate = [&](int st) {
      product_rs<kDp, kCols, kNq>(
          dv, ph, pl, smem_u32(smem + S::kDOff + st * S::kQBytes) + col_off);
      product_rs<kDp, kCols, kNq>(
          dk, dsh, dsl, smem_u32(smem + S::kQOff + st * S::kQBytes) + col_off);
      wg_commit();
    };
    // p^T into s and ds^T into dp, with the lse2 and delta of the tile's
    // columns (query rows)
    auto grads = [&](int st) {
      dkv_grads<kNq>(
          s, dp,
          reinterpret_cast<const float*>(smem + S::kLOff +
                                         st * S::kLineBytes),
          reinterpret_cast<const float*>(smem + S::kDeltaOff +
                                         st * S::kLineBytes),
          p, t);
    };
    auto split = [&]() {
      split_frags<kNq>(s, ph, pl);
      split_frags<kNq>(dp, dsh, dsl);
    };

    // The first query tile's turn is peeled off the loop so that no wait
    // or product of the loop sits under a branch.
    mbar_wait(&full[stage], sph);
    logits(stage);
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (p.n_loop == 1) release(&k_empty[kb]);  // k and v are read no more
    grads(stage);
    split();
    int prev = stage;
    if (++stage == kStages) stage = 0, sph ^= 1;
    for (int j = 1; j < p.n_loop; ++j) {
      mbar_wait(&full[stage], sph);
      logits(stage);
      accumulate(prev);
      wg_wait<1>();  // s^T and dp^T; the tile before's products run on
      fence_regs(s);
      fence_regs(dp);
      if (j == p.n_loop - 1) release(&k_empty[kb]);
      grads(stage);
      wg_wait<0>();
      fence_grads();
      release(&empty[prev]);
      split();
      prev = stage;
      if (++stage == kStages) stage = 0, sph ^= 1;
    }
    // the last tile's products
    fence_grads();
    wg_fence();
    accumulate(prev);
    wg_wait<0>();
    fence_grads();
    release(&empty[prev]);

    // a clamped chunk's copy is not stored (no rows below 0)
    const int rows = C::stores(it.group, c) ? p.T : 0;
    store_acc<kCols>(dk, p.out0 + b * p.s0[0] + h * p.s0[1], p.s0[2], key_w,
                     rows, col0, p.D, p.pairs, lane);
    store_acc<kCols>(dv, p.out1 + b * p.s1[0] + h * p.s1[1], p.s1[2], key_w,
                     rows, col0, p.D, p.pairs, lane);
    if (++kb == S::kKBufs) kb = 0, kph ^= 1;
  }
}

// Launches dkv_kernel<kDp, kNq, kCols>: a persistent grid, one block an
// SM.
template <int kDp, int kNq, int kCols>
cudaError_t launch_dkv(const attn_wg::View& q, const attn_wg::View& k,
                       const attn_wg::View& v, const attn_wg::View& dout,
                       attn_wg::BwdParams p, int B, int H, int T, int D,
                       cudaStream_t stream) {
  using namespace attn_wg;
  using S = DkvShape<kDp, kNq, kCols>;
  using A = Atoms<kDp>;
  using C = Cut<kDp, kCols>;
  auto kernel = dkv_kernel<kDp, kNq, kCols>;
  static thread_local uint64_t opted_in = 0;
  const cudaError_t err = opt_in(kernel, S::kBytes, opted_in);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm, dm;
  int maps =
      tensor_map(&qm, q, B, H, T, D, A::kCols, kNq, A::kSwizzle);
  if (maps == 0)
    maps = tensor_map(&dm, dout, B, H, T, D, A::kCols, kNq, A::kSwizzle);
  if (maps == 0)
    maps = tensor_map(&km, k, B, H, T, D, A::kCols, S::kKeys, A::kSwizzle);
  if (maps == 0)
    maps = tensor_map(&vm, v, B, H, T, D, A::kCols, S::kKeys, A::kSwizzle);
  if (maps != 0) return static_cast<cudaError_t>(maps);
  p.n_groups = C::kGroups;
  p.n_items = (T + S::kKeys - 1) / S::kKeys * C::kGroups;
  p.n_loop = (T + kNq - 1) / kNq;
  p.total = B * H * p.n_items;
  kernel<<<min(p.total, sm_count()), attn_wg::kThreads, S::kBytes, stream>>>(
      qm, km, vm, dm, p);
  return cudaGetLastError();
}

// ---- bf16 past the table: the streamed dk/dv kernel ------------------------
// Past the table's widest row an item's K and V at the full width no
// longer fit shared memory beside the ring.  Here nothing is held at the
// full width: each stage of the ring holds one 64-column chunk of the
// item's K and V (64 keys) and of a query tile's Q and dO, and the
// consumers add each chunk's products into s^T and dp^T in their
// registers; then dv += p^T.do and dk += ds^T.q read the query tile's Q
// and dO at the item's columns, which come through a second ring
// (kOutStages) with the tile's rows of lse * log2(e) and delta, so that
// the gradient products of one query tile run while the next tile's exps
// do.  Work items are (b * H + h, 64 keys, group of two chunks of kCols
// columns of dk and dv), consumer c on chunk 2 * group + c (StreamCut).
//
// Shared memory: kStages stages of a K, a V, a Q and a dO chunk (64, 64,
// kNq and kNq rows of 64 columns); kOutStages stages of Q and dO at the
// consumers' columns (a slot each: consumer c's Q, then its dO); their
// rows of lse and delta; the barriers.
template <int kNq, int kCols>
struct DkvStreamShape {
  static constexpr int kKeys = 64;                    // keys an item
  static constexpr int kKBytes = kKeys * 128;         // a chunk of K or V
  static constexpr int kQBytes = kNq * 128;           // a chunk of Q or dO
  static constexpr int kVOff = kKBytes;               // within a stage
  static constexpr int kQOff = 2 * kKBytes;
  static constexpr int kDOff = kQOff + kQBytes;
  static constexpr int kStageBytes = 2 * kKBytes + 2 * kQBytes;
  static constexpr int kOutAtoms = kCols / 64;        // a consumer's
  static constexpr int kSlotBytes = kOutAtoms * kQBytes;
  static constexpr int kOutBytes = 4 * kSlotBytes;
  static constexpr int kLineBytes = 4 * kNq;          // lse or delta
  static constexpr int kOutStages = 2;
  // as many stages as fit, at most 6
  static constexpr int kFit =
      (attn_wg::kSmemBudget - kOutStages * (kOutBytes + 2 * kLineBytes)) /
      kStageBytes;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kOutOff = kStages * kStageBytes;
  static constexpr int kLOff = kOutOff + kOutStages * kOutBytes;
  static constexpr int kBarOff = kLOff + kOutStages * 2 * kLineBytes;
  static constexpr int kBytes =
      kBarOff + 8 * 2 * (kStages + kOutStages) + 1024;
  static_assert(kNq % 16 == 0 && kNq <= 128, "query tile");
  static_assert(attn_wg::kRowsPad % kNq == 0,
                "a query tile lies within the padded rows");
  static_assert(kCols % 64 == 0 && kCols <= 256, "whole atoms, wgmma's N");
  static_assert(kStages >= 2, "a ring of at least two stages");
};

template <int kNq, int kCols>
__global__ void __launch_bounds__(attn_wg::kThreads, 1)
    dkv_stream_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap,
                      const attn_wg::BwdParams p) {
  using namespace attn_wg;
  using S = DkvStreamShape<kNq, kCols>;
  constexpr int kStages = S::kStages;
  constexpr int kOutStages = S::kOutStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBarOff);
  uint64_t* empty = full + kStages;
  uint64_t* out_full = empty + kStages;
  uint64_t* out_empty = out_full + kOutStages;
  const int items =
      (p.total - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int n_dc = atoms_of(p.D);
  const StreamCut cut{(p.D + kCols - 1) / kCols};

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    for (int i = 0; i < kOutStages; ++i) {
      mbar_init(&out_full[i], 1);
      mbar_init(&out_empty[i], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == kConsumerWGs) {
    // ---- producer: one thread keeps the loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x != 128 * kConsumerWGs) return;
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    prefetch_map(&qmap);
    prefetch_map(&domap);
    int st = 0, sph = 0, os = 0, oph = 0;
    for (int i = 0; i < items; ++i) {
      const Item it(p, blockIdx.x + i * gridDim.x);
      const int k0 = it.tile * S::kKeys;
      // the atoms of the consumers' chunks that hold columns < D (atoms
      // wholly past D feed only columns never stored)
      int atoms[2];
      for (int c = 0; c < 2; ++c)
        atoms[c] = cut.stores(it.group, c)
                       ? min(S::kOutAtoms,
                             atoms_of(p.D - cut.chunk(it.group, c) * kCols))
                       : 0;
      const long long line = static_cast<long long>(it.bh) * p.Tpad;
      for (int j = 0; j < p.n_loop; ++j) {
        const int q0 = j * kNq;
        for (int d = 0; d < n_dc; ++d) {
          mbar_wait(&empty[st], sph ^ 1);  // a fresh barrier passes at once
          mbar_expect_tx(&full[st], S::kStageBytes);
          uint8_t* dst = smem + st * S::kStageBytes;
          tma_load_4d(dst, &kmap, &full[st], 64 * d, it.h, k0, it.b);
          tma_load_4d(dst + S::kVOff, &vmap, &full[st], 64 * d, it.h, k0,
                      it.b);
          tma_load_4d(dst + S::kQOff, &qmap, &full[st], 64 * d, it.h, q0,
                      it.b);
          tma_load_4d(dst + S::kDOff, &domap, &full[st], 64 * d, it.h, q0,
                      it.b);
          if (++st == kStages) st = 0, sph ^= 1;
        }
        mbar_wait(&out_empty[os], oph ^ 1);
        mbar_expect_tx(&out_full[os], 2 * (atoms[0] + atoms[1]) * S::kQBytes +
                                          2 * S::kLineBytes);
        uint8_t* out = smem + S::kOutOff + os * S::kOutBytes;
        for (int c = 0; c < 2; ++c)
          for (int a = 0; a < atoms[c]; ++a) {
            const int col = cut.chunk(it.group, c) * kCols + 64 * a;
            tma_load_4d(out + 2 * c * S::kSlotBytes + a * S::kQBytes, &qmap,
                        &out_full[os], col, it.h, q0, it.b);
            tma_load_4d(out + (2 * c + 1) * S::kSlotBytes + a * S::kQBytes,
                        &domap, &out_full[os], col, it.h, q0, it.b);
          }
        uint8_t* lines = smem + S::kLOff + os * 2 * S::kLineBytes;
        bulk_load(lines, p.rows + line + q0, S::kLineBytes, &out_full[os]);
        bulk_load(lines + S::kLineBytes, p.deltas + line + q0,
                  S::kLineBytes, &out_full[os]);
        if (++os == kOutStages) os = 0, oph ^= 1;
      }
    }
    return;
  }

  // ---- consumers: both on the item's 64 keys, each its chunk ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = role;
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;

  float s[kNq / 2], dp[kNq / 2];
  float dk[kCols / 2], dv[kCols / 2];
  uint32_t ph[kNq / 16][4], pl[kNq / 16][4];
  uint32_t dsh[kNq / 16][4], dsl[kNq / 16][4];

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto fence_grads = [&]() {
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(dsh);
    fence_regs(dsl);
  };
  int st = 0, sph = 0;
  // s^T = k.q^T and dp^T = v.do^T of one query tile, their 64-column
  // chunks in turn from the ring, each stage released once its products
  // are done
  auto logits = [&]() {
    for (int d = 0; d < n_dc; ++d) {
      mbar_wait(&full[st], sph);
      const uint32_t base = smem_u32(smem + st * S::kStageBytes);
      fence_regs(s);
      fence_regs(dp);
      wg_fence();
      product_ss_atom<kNq>(s, base, base + S::kQOff, d > 0);
      product_ss_atom<kNq>(dp, base + S::kVOff, base + S::kDOff, d > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      release(&empty[st]);
      if (++st == kStages) st = 0, sph ^= 1;
    }
  };
  // the n-th stage of the second ring the block takes, and its phase
  auto out_stage = [](int n) { return n % kOutStages; };
  auto out_phase = [](int n) { return (n / kOutStages) & 1; };
  // dv += p^T.do and dk += ds^T.q of the query tile in the second ring's
  // n-th stage, over the consumer's columns
  auto accumulate = [&](int n) {
    fence_grads();
    wg_fence();
    const uint32_t out =
        smem_u32(smem + S::kOutOff + out_stage(n) * S::kOutBytes);
    product_rs<64, kCols, kNq>(dv, ph, pl,
                               out + (2 * c + 1) * S::kSlotBytes);
    product_rs<64, kCols, kNq>(dk, dsh, dsl, out + 2 * c * S::kSlotBytes);
    wg_commit();
  };
  auto accumulated = [&](int n) {
    wg_wait<0>();
    fence_grads();
    release(&out_empty[out_stage(n)]);
  };
  // p^T into s and ds^T into dp, with the lse2 and delta of the query tile
  // in the second ring's n-th stage
  auto grads = [&](int n) {
    mbar_wait(&out_full[out_stage(n)], out_phase(n));
    const float* lt = reinterpret_cast<const float*>(
        smem + S::kLOff + out_stage(n) * 2 * S::kLineBytes);
    dkv_grads<kNq>(s, dp, lt, lt + kNq, p, t);
  };
  auto split = [&]() {
    split_frags<kNq>(s, ph, pl);
    split_frags<kNq>(dp, dsh, dsl);
  };

  int n = 0;  // second-ring stages taken
  for (int i = 0; i < items; ++i) {
    const Item it(p, blockIdx.x + i * gridDim.x);
    const int b = it.b, h = it.h;
    const int key_w = it.tile * S::kKeys + 16 * warp;  // the warp's first
    const int col0 = cut.chunk(it.group, c) * kCols;   // the consumer's
#pragma unroll
    for (int x = 0; x < kCols / 2; ++x) dk[x] = dv[x] = 0.f;

    // The first query tile's turn is peeled off the loop.  In the loop the
    // gradient products of the tile before run while this tile's exps do.
    logits();
    grads(n);
    split();
    for (int j = 1; j < p.n_loop; ++j) {
      logits();
      accumulate(n);
      grads(n + 1);
      accumulated(n);
      split();
      ++n;
    }
    accumulate(n);
    accumulated(n);
    ++n;

    // a clamped chunk's copy is not stored (no rows below 0)
    const int rows = cut.stores(it.group, c) ? p.T : 0;
    store_acc<kCols>(dk, p.out0 + b * p.s0[0] + h * p.s0[1], p.s0[2], key_w,
                     rows, col0, p.D, p.pairs, lane);
    store_acc<kCols>(dv, p.out1 + b * p.s1[0] + h * p.s1[1], p.s1[2], key_w,
                     rows, col0, p.D, p.pairs, lane);
  }
}

// Launches dkv_stream_kernel<kNq, kCols>: a persistent grid, one block an
// SM.
template <int kNq, int kCols>
cudaError_t launch_dkv_stream(const attn_wg::View& q,
                              const attn_wg::View& k,
                              const attn_wg::View& v,
                              const attn_wg::View& dout,
                              attn_wg::BwdParams p, int B, int H, int T,
                              int D, cudaStream_t stream) {
  using namespace attn_wg;
  using S = DkvStreamShape<kNq, kCols>;
  auto kernel = dkv_stream_kernel<kNq, kCols>;
  static thread_local uint64_t opted_in = 0;
  const cudaError_t err = opt_in(kernel, S::kBytes, opted_in);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm, dm;
  int maps =
      tensor_map(&qm, q, B, H, T, D, 64, kNq, 1);
  if (maps == 0)
    maps = tensor_map(&dm, dout, B, H, T, D, 64, kNq, 1);
  if (maps == 0)
    maps = tensor_map(&km, k, B, H, T, D, 64, S::kKeys, 1);
  if (maps == 0)
    maps = tensor_map(&vm, v, B, H, T, D, 64, S::kKeys, 1);
  if (maps != 0) return static_cast<cudaError_t>(maps);
  const int chunks = (D + kCols - 1) / kCols;
  p.n_groups = (chunks + 1) / 2;
  p.n_items = (T + S::kKeys - 1) / S::kKeys * p.n_groups;
  p.n_loop = (T + kNq - 1) / kNq;
  p.total = B * H * p.n_items;
  kernel<<<min(p.total, sm_count()), attn_wg::kThreads, S::kBytes, stream>>>(
      qm, km, vm, dm, p);
  return cudaGetLastError();
}

// The instance of the first table width >= D (backward_tiles.cuh), past
// the widest the streamed row's.
cudaError_t launch_wgmma(const attn_wg::View& q, const attn_wg::View& k,
                         const attn_wg::View& v, const attn_wg::View& dout,
                         const attn_wg::BwdParams& p, int B, int H, int T,
                         int D, cudaStream_t stream) {
#define DKV(w, n, cols)                                                  \
  if (D <= w)                                                            \
    return launch_dkv<w, n, cols>(q, k, v, dout, p, B, H, T, D, stream);
#define DKV_STREAMED(n, cols)                                            \
  return launch_dkv_stream<n, cols>(q, k, v, dout, p, B, H, T, D, stream);
#include "backward_tiles.cuh"
  return cudaErrorInvalidValue;  // a table without a DKV_STREAMED row
}

// The wgmma instance's dynamic shared memory at D.
size_t wgmma_smem_bytes(int D) {
#define DKV(w, n, cols) \
  if (D <= w) return DkvShape<w, n, cols>::kBytes;
#define DKV_STREAMED(n, cols) return DkvStreamShape<n, cols>::kBytes;
#include "backward_tiles.cuh"
  return 0;
}


// ---- f32 up to the table's widest row: the TF32 wgmma kernel -------------
// Shared memory of an instance: an item's K and V tiles (kKeys rows, all
// columns; each big, then small); kStages stages of a query tile's Q and
// dO (kNq rows; each big, then small) and of the B of dk += ds^T.q and dv
// += p^T.do: their transposes Q^T and dO^T (big, then small; TF32) or,
// with kBf16x3, their three bf16 terms each (the bf16 layout, read
// MN-major); then each stage's rows of lse * log2(e) and delta, then the
// barriers.
template <int kDp, int kNq, int kCols, bool kBf16x3>
struct DkvF32Shape {
  static constexpr int kKeys = attn_wg::Cut<kDp, kCols>::kRows;  // an item's
  static constexpr int kKBytes = 4 * kKeys * kDp;  // a half of K or V
  static constexpr int kVOff = 2 * kKBytes;
  static constexpr int kItemBytes = 4 * kKBytes;
  static constexpr int kQBytes = 4 * kNq * kDp;    // a half of Q, dO, ...
  static constexpr int kDOff = 2 * kQBytes;        // within a stage
  static constexpr int kTermBytes = 2 * kNq * kDp;  // a bf16 term of Q, dO
  // the B operands' halves (terms) this many bytes apart
  static constexpr int kApart = kBf16x3 ? kTermBytes : kQBytes;
  static constexpr int kQTOff = 4 * kQBytes;
  static constexpr int kDTOff = kQTOff + (kBf16x3 ? 3 : 2) * kApart;
  static constexpr int kStageBytes = kDTOff + (kBf16x3 ? 3 : 2) * kApart;
  static constexpr int kLineBytes = 4 * kNq;       // lse or delta of a tile
  // as many stages as fit, at most 4
  static constexpr int kFit = (attn_wg::kSmemBudget - kItemBytes) /
                              (kStageBytes + 2 * kLineBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kLOff = kItemBytes + kStages * kStageBytes;
  static constexpr int kBarOff = kLOff + kStages * 2 * kLineBytes;
  static constexpr int kBytes = kBarOff + 8 * 3 * (1 + kStages) + 1024;
  static_assert(kNq % (kBf16x3 ? 16 : 8) == 0 && kNq <= 64,
                "query tile: whole k8 (k16) steps");
  static_assert(!kBf16x3 || kCols % attn_wg::Atoms<kDp>::kCols == 0,
                "a consumer's columns of the bf16 terms: whole atoms");
  static_assert(attn_wg::kRowsPad % kNq == 0,
                "a query tile lies within the padded rows");
  static_assert(kStages >= 2, "a ring of at least two stages");
};

// The dk/dv kernel's arithmetic in f32 on TF32 wgmma (wgmma_tf32.cuh): its
// work items, producer, ring and consumers as dkv_kernel's above, each
// product three TF32 products of big and small halves, and the converter
// warps between the producer and the consumers: an item's K and V split in
// place, each query tile's Q and dO split and transposed (with kBf16x3
// split into three bf16 terms each instead).  p^T and ds^T are split in
// the consumers' registers (GradFrags).  dk and dv stay in registers until
// the item ends and are written in f32: no atomics, two calls give equal
// bits.
template <int kDp, int kNq, int kCols, bool kBf16x3>
__global__ void __launch_bounds__(attn_wg::kThreads, 1)
    dkv_split_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const attn_wg::BwdParamsT<float> p) {
  using namespace attn_wg;
  using S = DkvF32Shape<kDp, kNq, kCols, kBf16x3>;
  using C = Cut<kDp, kCols>;
  constexpr int kStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + S::kBarOff);
  uint64_t* k_ready = k_full + 1;
  uint64_t* k_empty = k_full + 2;
  uint64_t* full = k_full + 3;
  uint64_t* ready = full + kStages;
  uint64_t* empty = ready + kStages;
  uint8_t* ring = smem + S::kItemBytes;
  const int items =
      (p.total - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;

  if (threadIdx.x == 0) {
    mbar_init(k_full, 1);
    mbar_init(k_ready, kConverterWarps);
    mbar_init(k_empty, kConsumerWarps);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&ready[i], kConverterWarps);
      mbar_init(&empty[i], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31;
  if (role == kConsumerWGs) {
    const int pw = (threadIdx.x / 32) & 3;
    if (pw == 0) {
      // ---- producer: one thread keeps the loads in flight ----
      if (lane != 0) return;
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      prefetch_map(&qmap);
      prefetch_map(&domap);
      int stage = 0, sph = 0, kph = 0;
      for (int i = 0; i < items; ++i) {
        const Item it(p, blockIdx.x + i * gridDim.x);
        const int k0 = it.tile * S::kKeys;
        mbar_wait(k_empty, kph ^ 1);  // a fresh barrier passes at once
        mbar_expect_tx(k_full, 2 * S::kKBytes);
        load_tile_f32<kDp>(smem, &kmap, k_full, S::kKeys, it.h, k0, it.b);
        load_tile_f32<kDp>(smem + S::kVOff, &vmap, k_full, S::kKeys, it.h,
                           k0, it.b);
        kph ^= 1;
        const long long line = static_cast<long long>(it.bh) * p.Tpad;
        for (int j = 0; j < p.n_loop; ++j) {
          const int q0 = j * kNq;
          mbar_wait(&empty[stage], sph ^ 1);
          mbar_expect_tx(&full[stage], 2 * S::kQBytes + 2 * S::kLineBytes);
          uint8_t* st = ring + stage * S::kStageBytes;
          load_tile_f32<kDp>(st, &qmap, &full[stage], kNq, it.h, q0, it.b);
          load_tile_f32<kDp>(st + S::kDOff, &domap, &full[stage], kNq, it.h,
                             q0, it.b);
          uint8_t* lines = smem + S::kLOff + stage * 2 * S::kLineBytes;
          bulk_load(lines, p.rows + line + q0, S::kLineBytes, &full[stage]);
          bulk_load(lines + S::kLineBytes, p.deltas + line + q0,
                    S::kLineBytes, &full[stage]);
          if (++stage == kStages) stage = 0, sph ^= 1;
        }
      }
      return;
    }
    // ---- converter: warps 1-3 split the tiles as they arrive ----
    const int cw = pw - 1;
    int stage = 0, sph = 0, kph = 0;
    for (int i = 0; i < items; ++i) {
      mbar_wait(k_full, kph);
      split_tile(smem, smem + S::kKBytes, S::kKBytes, cw, lane);
      split_tile(smem + S::kVOff, smem + S::kVOff + S::kKBytes, S::kKBytes,
                 cw, lane);
      converted(k_ready, lane);
      kph ^= 1;
      for (int j = 0; j < p.n_loop; ++j) {
        mbar_wait(&full[stage], sph);
        uint8_t* st = ring + stage * S::kStageBytes;
        if constexpr (kBf16x3) {
          split_terms<kDp, kNq>(st, st + S::kQBytes, st + S::kQTOff,
                                S::kApart, cw, lane);
          split_terms<kDp, kNq>(st + S::kDOff, st + S::kDOff + S::kQBytes,
                                st + S::kDTOff, S::kApart, cw, lane);
        } else {
          split_transpose<kDp, kNq>(st, st + S::kQBytes, st + S::kQTOff,
                                    st + S::kQTOff + S::kApart, cw, lane);
          split_transpose<kDp, kNq>(st + S::kDOff,
                                    st + S::kDOff + S::kQBytes,
                                    st + S::kDTOff,
                                    st + S::kDTOff + S::kApart, cw, lane);
        }
        converted(&ready[stage], lane);
        if (++stage == kStages) stage = 0, sph ^= 1;
      }
    }
    return;
  }

  // ---- consumers ----
  const int c = role;
  const int warp = (threadIdx.x / 32) & 3;
  const int t = lane & 3;

  float s[kNq / 2], dp[kNq / 2];
  float dk[kCols / 2], dv[kCols / 2];
  float dk_part[kCols / 2], dv_part[kCols / 2];  // a query tile's parts
  GradFrags<kNq, kBf16x3> pf, dsf;  // p^T and ds^T

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto fence_grads = [&]() {
    fence_regs(dk_part);
    fence_regs(dv_part);
    pf.fence();
    dsf.fence();
  };

  int stage = 0, sph = 0, kph = 0;
  for (int i = 0; i < items; ++i) {
    const Item it(p, blockIdx.x + i * gridDim.x);
    const int b = it.b, h = it.h;
    // the warp's first key, the consumer's first column
    const int key_w = it.tile * S::kKeys + C::row0(c) + 16 * warp;
    const int col0 = C::chunk(it.group, c) * kCols;
#pragma unroll
    for (int x = 0; x < kCols / 2; ++x) dk[x] = dv[x] = 0.f;
    mbar_wait(k_ready, kph);
    const uint32_t ka = smem_u32(smem) + C::row0(c) * 128;  // V at kVOff

    // s^T and dp^T of the query tile in stage st, one commit group; every
    // register the products read or write is settled before it opens
    auto logits = [&](int st) {
      fence_regs(s);
      fence_regs(dp);
      fence_grads();
      wg_fence();
      const uint32_t q = smem_u32(ring + st * S::kStageBytes);
      const uint32_t k = opaque(ka), v = k + S::kVOff;
      product_ss_tf32<kDp, kNq>(s, k, k + S::kKBytes, S::kKeys, q,
                                q + S::kQBytes);
      product_ss_tf32<kDp, kNq>(dp, v, v + S::kKBytes, S::kKeys,
                                q + S::kDOff, q + S::kDOff + S::kQBytes);
      wg_commit();
    };
    // the parts p^T.do of dv and ds^T.q of dk of the query tile in stage
    // st
    auto accumulate = [&](int st) {
      const uint32_t q = smem_u32(ring + st * S::kStageBytes);
      pf.template product<kDp, kCols>(dv_part, q + S::kDTOff, S::kApart,
                                      col0);
      dsf.template product<kDp, kCols>(dk_part, q + S::kQTOff, S::kApart,
                                       col0);
      wg_commit();
    };
    auto add_parts = [&]() {
      add_part(dk, dk_part);
      add_part(dv, dv_part);
    };
    // p^T into s and ds^T into dp, with the lse2 and delta of the tile's
    // columns (query rows)
    auto grads = [&](int st) {
      const float* lt = reinterpret_cast<const float*>(
          smem + S::kLOff + st * 2 * S::kLineBytes);
      dkv_grads<kNq>(s, dp, lt, lt + kNq, p, t);
    };
    auto split = [&]() {
      pf.split(s);
      dsf.split(dp);
    };

    // The first query tile's turn is peeled off the loop so that no wait
    // or product of the loop sits under a branch.
    mbar_wait(&ready[stage], sph);
    logits(stage);
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (p.n_loop == 1) release(k_empty);  // k and v are read no more
    grads(stage);
    split();
    int prev = stage;
    if (++stage == kStages) stage = 0, sph ^= 1;
    for (int j = 1; j < p.n_loop; ++j) {
      mbar_wait(&ready[stage], sph);
      logits(stage);
      accumulate(prev);
      wg_wait<1>();  // s^T and dp^T; the tile before's products run on
      fence_regs(s);
      fence_regs(dp);
      if (j == p.n_loop - 1) release(k_empty);
      grads(stage);
      wg_wait<0>();
      fence_grads();
      release(&empty[prev]);
      add_parts();
      split();
      prev = stage;
      if (++stage == kStages) stage = 0, sph ^= 1;
    }
    // the last tile's products
    fence_grads();
    wg_fence();
    accumulate(prev);
    wg_wait<0>();
    fence_grads();
    release(&empty[prev]);
    add_parts();

    // a clamped chunk's copy is not stored (no rows below 0)
    const int rows = C::stores(it.group, c) ? p.T : 0;
    store_acc<kCols>(dk, p.out0 + b * p.s0[0] + h * p.s0[1], p.s0[2], key_w,
                     rows, col0, p.D, p.pairs, lane);
    store_acc<kCols>(dv, p.out1 + b * p.s1[0] + h * p.s1[1], p.s1[2], key_w,
                     rows, col0, p.D, p.pairs, lane);
    kph ^= 1;
  }
}

// Launches dkv_split_kernel<kDp, kNq, kCols, kBf16x3>: a persistent grid,
// one block an SM.
template <int kDp, int kNq, int kCols, bool kBf16x3>
cudaError_t launch_dkv_tf32(const attn_wg::View& q, const attn_wg::View& k,
                            const attn_wg::View& v, const attn_wg::View& dout,
                            attn_wg::BwdParamsT<float> p, int B, int H,
                            int T, int D, cudaStream_t stream) {
  using namespace attn_wg;
  using S = DkvF32Shape<kDp, kNq, kCols, kBf16x3>;
  using C = Cut<kDp, kCols>;
  auto kernel = dkv_split_kernel<kDp, kNq, kCols, kBf16x3>;
  static thread_local uint64_t opted_in = 0;
  const cudaError_t err = opt_in(kernel, S::kBytes, opted_in);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm, dm;
  // f32 views, boxes of 32 columns (an atom), 128-byte swizzle
  int maps = tensor_map(&qm, q, B, H, T, D, 32, kNq, 1, 4);
  if (maps == 0) maps = tensor_map(&dm, dout, B, H, T, D, 32, kNq, 1, 4);
  if (maps == 0) maps = tensor_map(&km, k, B, H, T, D, 32, S::kKeys, 1, 4);
  if (maps == 0) maps = tensor_map(&vm, v, B, H, T, D, 32, S::kKeys, 1, 4);
  if (maps != 0) return static_cast<cudaError_t>(maps);
  p.n_groups = C::kGroups;
  p.n_items = (T + S::kKeys - 1) / S::kKeys * C::kGroups;
  p.n_loop = (T + kNq - 1) / kNq;
  p.total = B * H * p.n_items;
  kernel<<<min(p.total, sm_count()), attn_wg::kThreads, S::kBytes, stream>>>(
      qm, km, vm, dm, p);
  return cudaGetLastError();
}

// ---- f32 past the table: the streamed TF32 dk/dv kernel -------------------
// Past the widest DKV_F32 row an item's K and V at the full width, each held
// twice (big and small), no longer fit shared memory beside the ring.  Here
// nothing is held at the full width, as in dkv_stream_kernel: each stage of
// the ring holds one 32-column chunk (an f32 swizzle atom) of the item's 64
// K and V rows and of a query tile's Q and dO, which the converter warps
// split in place and into their small halves; the consumers take the
// chunk's three TF32 products of s^T and of dp^T into fresh accumulators and
// add them into s^T and dp^T in f32 (as dq_split_stream_kernel, and for the
// same reason).  Then dv += p^T.do and dk += ds^T.q read the query tile's Q
// and dO at the consumers' columns, which come through a second ring
// (kOutStages) with the tile's rows of lse * log2(e) and delta, and where
// the converter writes each consumer's B of both products: their three bf16
// terms, or their TF32 transposes (the table's bf16x3); each query tile's
// parts of dk and dv land in fresh accumulators and are added in f32
// (GradFrags), and the gradient products of one query tile run while the
// next tile's exps do.  Work items are (b * H + h, 64 keys, group of two
// chunks of kCols columns of dk and dv), consumer c on chunk 2 * group + c
// (StreamCut); the grid is persistent.  dk and dv stay in registers until
// the item ends: no atomics, two calls give equal bits.
//
// Shared memory: kStages stages of a K, a V, a Q and a dO chunk (64, 64,
// kNq and kNq rows of 32 f32 columns) as TMA lands them, then their small
// halves; kOutStages stages of Q and dO at the consumers' columns (consumer
// c's Q in slot 2c, its dO in slot 2c + 1, kCols / 32 atoms of kNq rows
// each), then each slot's B; their rows of lse and delta; the barriers.
template <int kNq, int kCols, bool kBf16x3>
struct DkvSplitStreamShape {
  static constexpr int kKeys = 64;                // keys an item
  static constexpr int kKBytes = kKeys * 128;     // a chunk of K or V
  static constexpr int kQBytes = kNq * 128;       // a chunk of Q or dO
  static constexpr int kVOff = kKBytes;           // within a stage
  static constexpr int kQOff = 2 * kKBytes;
  static constexpr int kDOff = kQOff + kQBytes;
  static constexpr int kRawBytes = 2 * kKBytes + 2 * kQBytes;
  static constexpr int kStageBytes = 2 * kRawBytes;  // big, then small
  static constexpr int kSlotBytes = kCols / 32 * kQBytes;
  // a slot's B: its bf16 terms, or its transpose's halves, this far apart
  static constexpr int kApart = (kBf16x3 ? 2 : 4) * kNq * kCols;
  static constexpr int kBBytes = (kBf16x3 ? 3 : 2) * kApart;
  static constexpr int kBOff = 4 * kSlotBytes;    // within an out stage
  static constexpr int kOutBytes = 4 * kSlotBytes + 4 * kBBytes;
  static constexpr int kLineBytes = 4 * kNq;      // lse or delta of a tile
  static constexpr int kOutStages = 2;
  // as many stages as fit, at most 6
  static constexpr int kFit =
      (attn_wg::kSmemBudget - kOutStages * (kOutBytes + 2 * kLineBytes)) /
      kStageBytes;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kOutOff = kStages * kStageBytes;
  static constexpr int kLOff = kOutOff + kOutStages * kOutBytes;
  static constexpr int kBarOff = kLOff + kOutStages * 2 * kLineBytes;
  static constexpr int kBytes =
      kBarOff + 8 * 3 * (kStages + kOutStages) + 1024;
  static_assert(kNq % (kBf16x3 ? 16 : 8) == 0 && kNq <= 64,
                "query tile: whole k8 (k16) steps");
  static_assert(attn_wg::kRowsPad % kNq == 0,
                "a query tile lies within the padded rows");
  static_assert(kCols % 32 == 0 && kCols <= 64, "whole f32 atoms, Tf32's N");
  static_assert(kStages >= 2, "a ring of at least two stages");
};

template <int kNq, int kCols, bool kBf16x3>
__global__ void __launch_bounds__(attn_wg::kThreads, 1)
    dkv_split_stream_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap domap,
                            const attn_wg::BwdParamsT<float> p) {
  using namespace attn_wg;
  using S = DkvSplitStreamShape<kNq, kCols, kBf16x3>;
  constexpr int kStages = S::kStages;
  constexpr int kOutStages = S::kOutStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBarOff);
  uint64_t* ready = full + kStages;
  uint64_t* empty = ready + kStages;
  uint64_t* out_full = empty + kStages;
  uint64_t* out_ready = out_full + kOutStages;
  uint64_t* out_empty = out_ready + kOutStages;
  const int items =
      (p.total - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int n_dc = (p.D + 31) / 32;  // the chunks of the sums over D
  const StreamCut cut{(p.D + kCols - 1) / kCols};

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&ready[i], kConverterWarps);
      mbar_init(&empty[i], kConsumerWarps);
    }
    for (int i = 0; i < kOutStages; ++i) {
      mbar_init(&out_full[i], 1);
      mbar_init(&out_ready[i], kConverterWarps);
      mbar_init(&out_empty[i], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31;
  if (role == kConsumerWGs) {
    const int pw = (threadIdx.x / 32) & 3;
    if (pw == 0) {
      // ---- producer: one thread keeps the loads in flight ----
      if (lane != 0) return;
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      prefetch_map(&qmap);
      prefetch_map(&domap);
      int st = 0, sph = 0, os = 0, oph = 0;
      for (int i = 0; i < items; ++i) {
        const Item it(p, blockIdx.x + i * gridDim.x);
        const int k0 = it.tile * S::kKeys;
        // the atoms of the consumers' chunks that hold columns < D (atoms
        // wholly past D feed only columns never stored)
        int atoms[2];
        for (int c = 0; c < 2; ++c)
          atoms[c] = cut.stores(it.group, c)
                         ? min(kCols / 32,
                               (p.D - cut.chunk(it.group, c) * kCols + 31) /
                                   32)
                         : 0;
        const long long line = static_cast<long long>(it.bh) * p.Tpad;
        for (int j = 0; j < p.n_loop; ++j) {
          const int q0 = j * kNq;
          for (int d = 0; d < n_dc; ++d) {
            mbar_wait(&empty[st], sph ^ 1);  // a fresh barrier passes at once
            mbar_expect_tx(&full[st], S::kRawBytes);
            uint8_t* dst = smem + st * S::kStageBytes;
            tma_load_4d(dst, &kmap, &full[st], 32 * d, it.h, k0, it.b);
            tma_load_4d(dst + S::kVOff, &vmap, &full[st], 32 * d, it.h, k0,
                        it.b);
            tma_load_4d(dst + S::kQOff, &qmap, &full[st], 32 * d, it.h, q0,
                        it.b);
            tma_load_4d(dst + S::kDOff, &domap, &full[st], 32 * d, it.h, q0,
                        it.b);
            if (++st == kStages) st = 0, sph ^= 1;
          }
          mbar_wait(&out_empty[os], oph ^ 1);
          mbar_expect_tx(&out_full[os],
                         2 * (atoms[0] + atoms[1]) * S::kQBytes +
                             2 * S::kLineBytes);
          uint8_t* out = smem + S::kOutOff + os * S::kOutBytes;
          for (int c = 0; c < 2; ++c)
            for (int a = 0; a < atoms[c]; ++a) {
              const int col = cut.chunk(it.group, c) * kCols + 32 * a;
              tma_load_4d(out + 2 * c * S::kSlotBytes + a * S::kQBytes,
                          &qmap, &out_full[os], col, it.h, q0, it.b);
              tma_load_4d(out + (2 * c + 1) * S::kSlotBytes + a * S::kQBytes,
                          &domap, &out_full[os], col, it.h, q0, it.b);
            }
          uint8_t* lines = smem + S::kLOff + os * 2 * S::kLineBytes;
          bulk_load(lines, p.rows + line + q0, S::kLineBytes, &out_full[os]);
          bulk_load(lines + S::kLineBytes, p.deltas + line + q0,
                    S::kLineBytes, &out_full[os]);
          if (++os == kOutStages) os = 0, oph ^= 1;
        }
      }
      return;
    }
    // ---- converter: warps 1-3 split the chunks as they arrive ----
    const int cw = pw - 1;
    int st = 0, sph = 0, os = 0, oph = 0;
    for (int i = 0; i < items; ++i)
      for (int j = 0; j < p.n_loop; ++j) {
        for (int d = 0; d < n_dc; ++d) {
          mbar_wait(&full[st], sph);
          uint8_t* stage = smem + st * S::kStageBytes;
          split_tile(stage, stage + S::kRawBytes, S::kRawBytes, cw, lane);
          converted(&ready[st], lane);
          if (++st == kStages) st = 0, sph ^= 1;
        }
        mbar_wait(&out_full[os], oph);
        uint8_t* out = smem + S::kOutOff + os * S::kOutBytes;
        for (int x = 0; x < 4; ++x) {
          uint8_t* b = out + S::kBOff + x * S::kBBytes;
          if constexpr (kBf16x3)
            split_terms<kCols, kNq, false>(out + x * S::kSlotBytes, nullptr,
                                           b, S::kApart, cw, lane);
          else
            split_transpose<kCols, kNq, false>(out + x * S::kSlotBytes,
                                               nullptr, b, b + S::kApart, cw,
                                               lane);
        }
        converted(&out_ready[os], lane);
        if (++os == kOutStages) os = 0, oph ^= 1;
      }
    return;
  }

  // ---- consumers: both on the item's 64 keys, each its chunk ----
  const int c = role;
  const int warp = (threadIdx.x / 32) & 3;
  const int t = lane & 3;

  float s[kNq / 2], dp[kNq / 2];
  float dk[kCols / 2], dv[kCols / 2];
  float dk_part[kCols / 2], dv_part[kCols / 2];  // a query tile's parts
  GradFrags<kNq, kBf16x3> pf, dsf;  // p^T and ds^T

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto fence_grads = [&]() {
    fence_regs(dk_part);
    fence_regs(dv_part);
    pf.fence();
    dsf.fence();
  };
  int st = 0, sph = 0;
  // s^T = k.q^T and dp^T = v.do^T of one query tile, their 32-column
  // chunks in turn from the ring, each chunk's products in fresh
  // accumulators added into s^T and dp^T in f32, each stage released once
  // its products are done
  auto logits = [&]() {
#pragma unroll
    for (int x = 0; x < kNq / 2; ++x) s[x] = dp[x] = 0.f;
    for (int d = 0; d < n_dc; ++d) {
      float sp[kNq / 2], dpp[kNq / 2];
      mbar_wait(&ready[st], sph);
      const uint32_t big = smem_u32(smem + st * S::kStageBytes);
      const uint32_t small = big + S::kRawBytes;
      fence_regs(sp);
      fence_regs(dpp);
      wg_fence();
      product_ss_tf32<32, kNq, true>(sp, big, small, S::kKeys,
                                     big + S::kQOff, small + S::kQOff);
      product_ss_tf32<32, kNq, true>(dpp, big + S::kVOff, small + S::kVOff,
                                     S::kKeys, big + S::kDOff,
                                     small + S::kDOff);
      wg_commit();
      wg_wait<0>();
      fence_regs(sp);
      fence_regs(dpp);
      release(&empty[st]);
      add_part(s, sp);
      add_part(dp, dpp);
      if (++st == kStages) st = 0, sph ^= 1;
    }
  };
  // the n-th stage of the second ring the block takes, and its phase
  auto out_stage = [](int n) { return n % kOutStages; };
  auto out_phase = [](int n) { return (n / kOutStages) & 1; };
  // the parts p^T.do of dv and ds^T.q of dk of the query tile in the second
  // ring's n-th stage, over the consumer's columns
  auto accumulate = [&](int n) {
    fence_grads();
    wg_fence();
    const uint32_t b = smem_u32(smem + S::kOutOff +
                                out_stage(n) * S::kOutBytes + S::kBOff) +
                       2 * c * S::kBBytes;
    pf.template product<kCols, kCols>(dv_part, b + S::kBBytes, S::kApart, 0);
    dsf.template product<kCols, kCols>(dk_part, b, S::kApart, 0);
    wg_commit();
  };
  auto accumulated = [&](int n) {
    wg_wait<0>();
    fence_grads();
    release(&out_empty[out_stage(n)]);
    add_part(dk, dk_part);
    add_part(dv, dv_part);
  };
  // p^T into s and ds^T into dp, with the lse2 and delta of the query tile
  // in the second ring's n-th stage
  auto grads = [&](int n) {
    mbar_wait(&out_ready[out_stage(n)], out_phase(n));
    const float* lt = reinterpret_cast<const float*>(
        smem + S::kLOff + out_stage(n) * 2 * S::kLineBytes);
    dkv_grads<kNq>(s, dp, lt, lt + kNq, p, t);
  };
  auto split = [&]() {
    pf.split(s);
    dsf.split(dp);
  };

  int n = 0;  // second-ring stages taken
  for (int i = 0; i < items; ++i) {
    const Item it(p, blockIdx.x + i * gridDim.x);
    const int key_w = it.tile * S::kKeys + 16 * warp;  // the warp's first
    const int col0 = cut.chunk(it.group, c) * kCols;   // the consumer's
#pragma unroll
    for (int x = 0; x < kCols / 2; ++x) dk[x] = dv[x] = 0.f;

    // The first query tile's turn is peeled off the loop.  In the loop the
    // gradient products of the tile before run while this tile's exps do.
    logits();
    grads(n);
    split();
    for (int j = 1; j < p.n_loop; ++j) {
      logits();
      accumulate(n);
      grads(n + 1);
      accumulated(n);
      split();
      ++n;
    }
    accumulate(n);
    accumulated(n);
    ++n;

    // a clamped chunk's copy is not stored (no rows below 0)
    const int rows = cut.stores(it.group, c) ? p.T : 0;
    store_acc<kCols>(dk, p.out0 + it.b * p.s0[0] + it.h * p.s0[1], p.s0[2],
                     key_w, rows, col0, p.D, p.pairs, lane);
    store_acc<kCols>(dv, p.out1 + it.b * p.s1[0] + it.h * p.s1[1], p.s1[2],
                     key_w, rows, col0, p.D, p.pairs, lane);
  }
}

// Launches dkv_split_stream_kernel<kNq, kCols, kBf16x3>: a persistent grid,
// one block an SM.
template <int kNq, int kCols, bool kBf16x3>
cudaError_t launch_dkv_tf32_stream(const attn_wg::View& q,
                                   const attn_wg::View& k,
                                   const attn_wg::View& v,
                                   const attn_wg::View& dout,
                                   attn_wg::BwdParamsT<float> p, int B, int H,
                                   int T, int D, cudaStream_t stream) {
  using namespace attn_wg;
  using S = DkvSplitStreamShape<kNq, kCols, kBf16x3>;
  auto kernel = dkv_split_stream_kernel<kNq, kCols, kBf16x3>;
  static thread_local uint64_t opted_in = 0;
  const cudaError_t err = opt_in(kernel, S::kBytes, opted_in);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm, dm;
  // f32 views, boxes of 32 columns (an atom), 128-byte swizzle
  int maps = tensor_map(&qm, q, B, H, T, D, 32, kNq, 1, 4);
  if (maps == 0) maps = tensor_map(&dm, dout, B, H, T, D, 32, kNq, 1, 4);
  if (maps == 0) maps = tensor_map(&km, k, B, H, T, D, 32, S::kKeys, 1, 4);
  if (maps == 0) maps = tensor_map(&vm, v, B, H, T, D, 32, S::kKeys, 1, 4);
  if (maps != 0) return static_cast<cudaError_t>(maps);
  const int chunks = (D + kCols - 1) / kCols;
  p.n_groups = (chunks + 1) / 2;
  p.n_items = (T + S::kKeys - 1) / S::kKeys * p.n_groups;
  p.n_loop = (T + kNq - 1) / kNq;
  p.total = B * H * p.n_items;
  kernel<<<min(p.total, sm_count()), attn_wg::kThreads, S::kBytes, stream>>>(
      qm, km, vm, dm, p);
  return cudaGetLastError();
}

// The f32 instance of the first DKV_F32 row (backward_tiles.cuh) of width
// >= D, past the widest the streamed row's.
cudaError_t launch_tf32(const attn_wg::View& q, const attn_wg::View& k,
                        const attn_wg::View& v, const attn_wg::View& dout,
                        const attn_wg::BwdParamsT<float>& p, int B, int H,
                        int T, int D, cudaStream_t stream) {
#define DKV_F32(w, n, cols, bf16x3)                                       \
  if (D <= w)                                                             \
    return launch_dkv_tf32<w, n, cols, bf16x3 != 0>(q, k, v, dout, p, B,  \
                                                    H, T, D, stream);
#define DKV_F32_STREAMED(n, cols, bf16x3)                                 \
  return launch_dkv_tf32_stream<n, cols, bf16x3 != 0>(q, k, v, dout, p,   \
                                                      B, H, T, D, stream);
#include "backward_tiles.cuh"
  return cudaErrorInvalidValue;  // a table without a DKV_F32_STREAMED row
}

// The f32 instance's dynamic shared memory at D.
size_t tf32_smem_bytes(int D) {
#define DKV_F32(w, n, cols, bf16x3) \
  if (D <= w) return DkvF32Shape<w, n, cols, bf16x3 != 0>::kBytes;
#define DKV_F32_STREAMED(n, cols, bf16x3) \
  return DkvSplitStreamShape<n, cols, bf16x3 != 0>::kBytes;
#include "backward_tiles.cuh"
  return 0;
}

// One launch's scalars with outputs of type T, its rows not yet filled.
template <typename T>
attn_wg::BwdParamsT<T> params(const void* o, const void* dout,
                              const void* lse, void* dk, void* dv,
                              const BwdLayout& L, int H, int seq, int D,
                              float scale) {
  attn_wg::BwdParamsT<T> p{};
  p.out0 = static_cast<T*>(dk);
  p.out1 = static_cast<T*>(dv);
  p.o = static_cast<const T*>(o);
  p.dout = static_cast<const T*>(dout);
  p.lse = static_cast<const float*>(lse);
  for (int x = 0; x < 3; ++x) {
    const int64_t* st[3] = {L.sb, L.sh, L.st};
    p.so[x] = st[x][3];
    p.sd[x] = st[x][4];
    p.s0[x] = st[x][5];
    p.s1[x] = st[x][6];
  }
  p.H = H;
  p.T = seq;
  p.D = D;
  p.scale = scale;
  p.c = scale * attn_wg::kLog2e;
  p.pairs = D % 2 == 0 &&
            (reinterpret_cast<uintptr_t>(dk) |
             reinterpret_cast<uintptr_t>(dv)) % (2 * sizeof(T)) == 0 &&
            (L.sb[5] | L.sh[5] | L.st[5] | L.sb[6] | L.sh[6] | L.st[6]) %
                    2 == 0;
  return p;
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* lse,
                       void* dk, void* dv, float* rows, const BwdLayout& L,
                       int B, int H, int seq, int D, float scale,
                       cudaStream_t s) {
  using attn_wg::View;
  auto p = params<float>(o, dout, lse, dk, dv, L, H, seq, D, scale);
  const cudaError_t err = launch_rows(p, rows, o, dout, L, B * H, D, s);
  if (err != cudaSuccess) return err;
  return launch_tf32(View{q, L.sb[0], L.sh[0], L.st[0]},
                     View{k, L.sb[1], L.sh[1], L.st[1]},
                     View{v, L.sb[2], L.sh[2], L.st[2]},
                     View{dout, L.sb[4], L.sh[4], L.st[4]}, p, B, H, seq, D,
                     s);
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* dk, void* dv, float* rows, const BwdLayout& L,
                        int B, int H, int seq, int D, float scale,
                        cudaStream_t s) {
  using attn_wg::View;
  auto p = params<__nv_bfloat16>(o, dout, lse, dk, dv, L, H, seq, D, scale);
  const cudaError_t err = launch_rows(p, rows, o, dout, L, B * H, D, s);
  if (err != cudaSuccess) return err;
  return launch_wgmma(View{q, L.sb[0], L.sh[0], L.st[0]},
                      View{k, L.sb[1], L.sh[1], L.st[1]},
                      View{v, L.sb[2], L.sh[2], L.st[2]},
                      View{dout, L.sb[4], L.sh[4], L.st[4]}, p, B, H, seq, D,
                      s);
}

}  // namespace

// q, k, v, o, dout, dk, dv: (B, H, T, D) views (o and dout as views of their
// (B, T, H, D) tensors), their (b, h, t) strides in elements in `strides`,
// three each in that order (d's stride is 1); every instance reads q, k, v
// and dout through tensor maps, so their bases are 16-byte aligned and
// those strides multiples of 16 bytes, which the wrapper sees to.  lse: (B,
// H, T) float32 contiguous.  rows: the scratch of
// flash_bwd_dkv_scratch_floats(B, H, T, D) floats.  dk and dv have k's
// type.  Any D; dtype 0 is float32, 1 is bfloat16.  Returns the
// cudaError_t of the launch, or kTensorMapFailed + the CUresult of a
// tensor map cuTensorMapEncodeTiled refused.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* dk, void* dv, void* rows,
                             const long long* strides, int B, int H, int T,
                             int D, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdLayout L = BwdLayout::from(strides);
  switch (dtype) {
    case 0:
      return launch_f32(q, k, v, o, dout, lse, dk, dv,
                        static_cast<float*>(rows), L, B, H, T, D, scale, s);
    case 1:
      return launch_bf16(q, k, v, o, dout, lse, dk, dv,
                         static_cast<float*>(rows), L, B, H, T, D, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The floats of scratch one launch needs, every instance's: the rows of lse
// * log2(e) and of delta, each (B * H, T rounded up to kRowsPad), at any D
// and in either dtype.
extern "C" long long flash_bwd_dkv_scratch_floats(int B, int H, int T, int D) {
  (void)D;
  const long long pad = (T + attn_wg::kRowsPad - 1) / attn_wg::kRowsPad *
                        attn_wg::kRowsPad;
  return 2LL * B * H * pad;
}

// The dynamic shared memory one launch needs, in bytes: the larger of the
// two instances' needs, which depend on D alone.
extern "C" long long flash_bwd_dkv_smem_bytes(int T, int D) {
  (void)T;
  const size_t f32 = tf32_smem_bytes(D);
  const size_t bf16 = wgmma_smem_bytes(D);
  return static_cast<long long>(f32 > bf16 ? f32 : bf16);
}
