// Tiled ("flash") attention backward, the query gradient, for Hopper
// (sm_90a), at any T.
//
// Replaces the TPU kernel
// vit_cifar_tpu/ops/pallas/attention.py::_flash_bwd_dq_kernel (pass 1 of
// _flash_bwd_impl) where flash_attention's and fused_attention's custom
// VJPs reach it.  For every (batch, head) and query row i:
//   delta_i = sum_d do_i[d] * o_i[d]
//   s_ij = q_i . k_j * scale,  p_ij = exp(s_ij - lse_i),  dp_ij = do_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i) * scale
//   dq_i = sum_j ds_ij k_j
// in f32 whatever the input type; lse is the forward's.  q, k, v, o and do
// are the caller's views, read in place through their strides (o and do in
// the (B, T, H, D) layout the forward returns; on the model's path q, k
// and v are transposed views of (B, T, H, D) projections), and dq is
// written in the input type in the strides the wrapper gives it (q's own,
// torch.empty_like), so nothing is copied around a call.
//
// What bounds it on this card: at the pixel-token ViT's shape (128, 12,
// 1025, 32) one head is three 1025x1025x32 products (q.k, do.v, ds.k) and
// 1.05 M exps against some 0.4 MB in and out in bf16: the exps (16 a clock
// per SM on the special-function units) take longer than the products at
// the tensor cores' peak, and with ds split into hi + lo the products are
// four.  At the flagship's T=65 it is bytes: a head is 65 rows.  In f32 the
// products come first (see below).  So:
//
//   bf16 (dtype 1): the warp-specialised wgmma kernels below, on
//   the blocks of wgmma_blocks.cuh and wgmma_backward.cuh.  A persistent
//   grid of one block an SM walks the work items (b, h, 128 query rows), so
//   a head of T <= 128 (the flagship's 65) is one item.  A producer thread
//   brings an item's Q and dO once by TMA (two buffers: the next item's
//   arrive while this one computes) and its K and V tiles through a ring,
//   last tile first, so that only the first tile taken holds keys past T
//   and only it is masked (a select).  Two consumer warpgroups of 64 rows
//   each run s = q.k^T and dp = do.v^T as ss-wgmmas, turn them into ds in
//   their registers (one FFMA into ex2 an exponent: p = exp2(s * c - lse *
//   log2(e)), c = scale * log2(e)), split ds into bf16 hi + lo, and add
//   ds.k as rs-wgmmas that read the same K tile MN-major; the next tile's
//   s and dp are issued before that, so the exps of one tile run while the
//   tensor cores add the last.  dq stays in registers until the item ends:
//   no atomics, so two calls give equal bits.  The key tile (96 keys at
//   32 columns, 64 at 64 and 128, 32 past: backward_tiles.cuh) is the
//   fastest measured within the 168 registers ptxas gives a consumer
//   (tools/backward_choices.py).  Past 128 columns the same kernel cuts dq
//   into column chunks of 128: a work item is 64 query rows and two chunks,
//   its two consumers on the same rows, each summing s and dp over all the
//   head's columns (padded to a multiple of 128) and holding its chunk of
//   dq; s, dp and the exps are computed twice an item, 2 * ceil(D/256)
//   times in all.  The item's rows at the full width fit shared memory
//   beside the ring up to 512 columns (16-key tiles there); past the
//   table the streamed instance (dq_stream_kernel) brings Q, dO, K and V a
//   64-column chunk a stage and sums s and dp over the chunks in its
//   registers, and the K tile at the item's columns through a second
//   ring, so any width runs.  Rows and keys past T and columns past D
//   arrive as zeros from TMA; rows past T read lse = delta = 0 (so ds is
//   0) and are never written.
//
//   f32 (dtype 0) up to 128 columns: the same kernel's design on TF32
//   wgmma (dq_split_kernel; wgmma_tf32.cuh).  One TF32 product (10-bit
//   mantissa) would miss the 1e-5 the f32 path is held to; each operand is
//   split into TF32 big + small and a product is big.big + big.small +
//   small.big in f32, about 21 bits.  In f32 the work at the pixel shape is
//   bound by the products: five of them, three TF32 products each.  Three
//   converter warps of the producer warpgroup split the tiles TMA brings
//   (Q and dO an item, K and V a key tile) and write the B of ds.k: K's
//   three bf16 terms, read MN-major by six bf16 products (TF32 wgmma reads
//   both operands K-major only; K's TF32 transpose is the table's other
//   route); ds is split in the consumers' registers, and each key tile's
//   part of dq is added into it in f32 (GradFrags says why).  Tiles and
//   route by width in backward_tiles.cuh's DQ_F32 rows.  Past 128 columns
//   the streamed instance (dq_split_stream_kernel, the DQ_F32_STREAMED
//   row): Q, dO, K and V come a 32-column chunk a stage, split by the
//   converter warps, and s and dp are summed over the chunks in f32 in the
//   consumers' registers, the B of ds.k at the item's columns through a
//   second ring, so any width runs on the tensor cores.
//
// Shared memory does not grow with T, so any T and any D run.  Offsets are
// int64; nothing is padded in device memory.
//
// Built by vit_cifar_torch/ops/cuda/build.py (nvcc, sm_90a, plain C
// interface bound with ctypes).

#include <cstdint>

#include "attention_common.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace attn;

// ---- f32 up to the table's widest row: the TF32 wgmma kernel -------------
// Shared memory of an instance: an item's Q and dO tiles (kRows rows, all
// columns; each big, then small), kStages stages of a key tile's K and V
// (kN keys; each big, then small) and of ds.k's B: K^T (big, then small;
// TF32) or, with kBf16x3, K's three bf16 terms (the bf16 layout, read
// MN-major), then the barriers.
template <int kDp, int kN, int kCols, bool kBf16x3>
struct DqF32Shape {
  static constexpr int kRows = attn_wg::Cut<kDp, kCols>::kRows;
  static constexpr int kQBytes = 4 * kRows * kDp;  // a half of Q or dO
  static constexpr int kKBytes = 4 * kN * kDp;     // a half of K, V or K^T
  static constexpr int kDOff = 2 * kQBytes;
  static constexpr int kItemBytes = 4 * kQBytes;
  static constexpr int kVOff = 2 * kKBytes;        // within a stage
  static constexpr int kTOff = 4 * kKBytes;
  static constexpr int kTermBytes = 2 * kN * kDp;  // a bf16 term of K
  static constexpr int kStageBytes =
      4 * kKBytes + (kBf16x3 ? 3 * kTermBytes : 2 * kKBytes);
  // as many stages as fit, at most 4
  static constexpr int kFit =
      (attn_wg::kSmemBudget - kItemBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kBarOff = kItemBytes + kStages * kStageBytes;
  static constexpr int kBytes = kBarOff + 8 * 3 * (1 + kStages) + 1024;
  static_assert(kN % (kBf16x3 ? 16 : 8) == 0 && kN <= 64,
                "key tile: whole k8 (k16) steps");
  static_assert(!kBf16x3 || kCols % attn_wg::Atoms<kDp>::kCols == 0,
                "a consumer's columns of the bf16 terms: whole atoms");
  static_assert(kStages >= 2, "a ring of at least two stages");
};

// The dq kernel's arithmetic in f32 on TF32 wgmma (wgmma_tf32.cuh): its
// work items, producer, ring and consumers as dq_kernel's below, each
// product three TF32 products of big and small halves, and the converter
// warps between the producer and the consumers: an item's Q and dO split
// in place, each key tile's K split and transposed (K^T, the B of ds.k;
// with kBf16x3 its three bf16 terms instead) and its V split.  ds is split
// in the consumers' registers (GradFrags).  dq stays in registers until the
// item ends and is written in f32: no atomics, two calls give equal bits.
template <int kDp, int kN, int kCols, bool kBf16x3>
__global__ void __launch_bounds__(attn_wg::kThreads, 1)
    dq_split_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap,
                   const attn_wg::BwdParamsT<float> p) {
  using namespace attn_wg;
  using S = DqF32Shape<kDp, kN, kCols, kBf16x3>;
  using C = Cut<kDp, kCols>;
  constexpr int kStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::kBarOff);
  uint64_t* q_ready = q_full + 1;
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_full + 3;
  uint64_t* ready = full + kStages;
  uint64_t* empty = ready + kStages;
  uint8_t* ring = smem + S::kItemBytes;
  const int items =
      (p.total - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_ready, kConverterWarps);
    mbar_init(q_empty, kConsumerWarps);
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
      // ---- producer: one thread keeps the TMA loads in flight ----
      if (lane != 0) return;
      prefetch_map(&qmap);
      prefetch_map(&domap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      int stage = 0, sph = 0, qph = 0;
      for (int i = 0; i < items; ++i) {
        const Item it(p, blockIdx.x + i * gridDim.x);
        const int q0 = it.tile * S::kRows;
        mbar_wait(q_empty, qph ^ 1);  // a fresh barrier passes at once
        mbar_expect_tx(q_full, 2 * S::kQBytes);
        load_tile_f32<kDp>(smem, &qmap, q_full, S::kRows, it.h, q0, it.b);
        load_tile_f32<kDp>(smem + S::kDOff, &domap, q_full, S::kRows, it.h,
                           q0, it.b);
        qph ^= 1;
        for (int j = 0; j < p.n_loop; ++j) {
          mbar_wait(&empty[stage], sph ^ 1);
          mbar_expect_tx(&full[stage], 2 * S::kKBytes);
          const int k0 = (p.n_loop - 1 - j) * kN;  // last tile first
          uint8_t* st = ring + stage * S::kStageBytes;
          load_tile_f32<kDp>(st, &kmap, &full[stage], kN, it.h, k0, it.b);
          load_tile_f32<kDp>(st + S::kVOff, &vmap, &full[stage], kN, it.h,
                             k0, it.b);
          if (++stage == kStages) stage = 0, sph ^= 1;
        }
      }
      return;
    }
    // ---- converter: warps 1-3 split the tiles as they arrive ----
    const int cw = pw - 1;
    int stage = 0, sph = 0, qph = 0;
    for (int i = 0; i < items; ++i) {
      mbar_wait(q_full, qph);
      split_tile(smem, smem + S::kQBytes, S::kQBytes, cw, lane);
      split_tile(smem + S::kDOff, smem + S::kDOff + S::kQBytes, S::kQBytes,
                 cw, lane);
      converted(q_ready, lane);
      qph ^= 1;
      for (int j = 0; j < p.n_loop; ++j) {
        mbar_wait(&full[stage], sph);
        uint8_t* st = ring + stage * S::kStageBytes;
        if constexpr (kBf16x3)
          split_terms<kDp, kN>(st, st + S::kKBytes, st + S::kTOff,
                               S::kTermBytes, cw, lane);
        else
          split_transpose<kDp, kN>(st, st + S::kKBytes, st + S::kTOff,
                                   st + S::kTOff + S::kKBytes, cw, lane);
        split_tile(st + S::kVOff, st + S::kVOff + S::kKBytes, S::kKBytes, cw,
                   lane);
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

  float s[kN / 2], dp[kN / 2];
  float dq[kCols / 2], part[kCols / 2];  // dq, a key tile's part of it
  GradFrags<kN, kBf16x3> ds;
  float lse2[2], delta[2];
  // ds.k's B: K^T's halves, or K's bf16 terms, this many bytes apart
  constexpr int kApart = kBf16x3 ? S::kTermBytes : S::kKBytes;

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  int stage = 0, sph = 0, qph = 0;
  for (int i = 0; i < items; ++i) {
    const Item it(p, blockIdx.x + i * gridDim.x);
    const int b = it.b, h = it.h;
    // the warp's first row, the consumer's first column
    const int row_w = it.tile * S::kRows + C::row0(c) + 16 * warp;
    const int col0 = C::chunk(it.group, c) * kCols;
    // q and do rows past T arrive as zeros, and lse = delta = 0 there
    row_terms(p, it, row_w, lane, lse2, delta);
#pragma unroll
    for (int x = 0; x < kCols / 2; ++x) dq[x] = 0.f;
    mbar_wait(q_ready, qph);
    const uint32_t qa = smem_u32(smem) + C::row0(c) * 128;  // dO at kDOff

    // s and dp of the key tile in stage st, one commit group; every
    // register the products read or write is settled before it opens
    auto logits = [&](int st) {
      fence_regs(s);
      fence_regs(dp);
      fence_regs(part);
      ds.fence();
      wg_fence();
      const uint32_t k = smem_u32(ring + st * S::kStageBytes);
      const uint32_t q = opaque(qa), d = q + S::kDOff;
      product_ss_tf32<kDp, kN>(s, q, q + S::kQBytes, S::kRows, k,
                               k + S::kKBytes);
      product_ss_tf32<kDp, kN>(dp, d, d + S::kQBytes, S::kRows,
                               k + S::kVOff, k + S::kVOff + S::kKBytes);
      wg_commit();
    };
    // part = ds.k of the key tile in stage st over the consumer's columns
    auto accumulate = [&](int st) {
      ds.template product<kDp, kCols>(
          part, smem_u32(ring + st * S::kStageBytes) + S::kTOff, kApart,
          col0);
      wg_commit();
    };
    // Key tiles are taken last to first: the first one taken holds the
    // keys past T, and it alone is masked.  Its turn is peeled off the loop
    // so that no wait or product of the loop sits under a branch.
    mbar_wait(&ready[stage], sph);
    logits(stage);
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (p.n_loop == 1) release(q_empty);  // q and do are read no more
    dq_grads<kN, true>(s, dp, lse2, delta, p, (p.n_loop - 1) * kN, t);
    ds.split(s);
    int prev = stage;
    if (++stage == kStages) stage = 0, sph ^= 1;
    for (int j = 1; j < p.n_loop; ++j) {
      mbar_wait(&ready[stage], sph);
      logits(stage);
      accumulate(prev);
      wg_wait<1>();  // s and dp; ds.k of the tile before runs on
      fence_regs(s);
      fence_regs(dp);
      if (j == p.n_loop - 1) release(q_empty);
      dq_grads<kN, false>(s, dp, lse2, delta, p, 0, t);
      wg_wait<0>();
      fence_regs(part);
      ds.fence();
      release(&empty[prev]);
      add_part(dq, part);
      ds.split(s);
      prev = stage;
      if (++stage == kStages) stage = 0, sph ^= 1;
    }
    // the last tile's ds.k
    fence_regs(part);
    ds.fence();
    wg_fence();
    accumulate(prev);
    wg_wait<0>();
    fence_regs(part);
    ds.fence();
    release(&empty[prev]);
    add_part(dq, part);

    // a clamped chunk's copy is not stored (no rows below 0)
    store_acc<kCols>(dq, p.out0 + b * p.s0[0] + h * p.s0[1], p.s0[2], row_w,
                     C::stores(it.group, c) ? p.T : 0, col0, p.D, p.pairs,
                     lane);
    qph ^= 1;
  }
}

// Launches dq_split_kernel<kDp, kN, kCols, kBf16x3>: a persistent grid,
// one block an SM.
template <int kDp, int kN, int kCols, bool kBf16x3>
cudaError_t launch_dq_tf32(const attn_wg::View& q, const attn_wg::View& k,
                           const attn_wg::View& v, const attn_wg::View& dout,
                           attn_wg::BwdParamsT<float> p, int B, int H, int T,
                           int D, cudaStream_t stream) {
  using namespace attn_wg;
  using S = DqF32Shape<kDp, kN, kCols, kBf16x3>;
  using C = Cut<kDp, kCols>;
  auto kernel = dq_split_kernel<kDp, kN, kCols, kBf16x3>;
  static thread_local uint64_t opted_in = 0;
  const cudaError_t err = opt_in(kernel, S::kBytes, opted_in);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm, dm;
  // f32 views, boxes of 32 columns (an atom), 128-byte swizzle
  int maps = tensor_map(&qm, q, B, H, T, D, 32, S::kRows, 1, 4);
  if (maps == 0)
    maps = tensor_map(&dm, dout, B, H, T, D, 32, S::kRows, 1, 4);
  if (maps == 0) maps = tensor_map(&km, k, B, H, T, D, 32, kN, 1, 4);
  if (maps == 0) maps = tensor_map(&vm, v, B, H, T, D, 32, kN, 1, 4);
  if (maps != 0) return static_cast<cudaError_t>(maps);
  p.n_groups = C::kGroups;
  p.n_items = (T + S::kRows - 1) / S::kRows * C::kGroups;
  p.n_loop = (T + kN - 1) / kN;
  p.total = B * H * p.n_items;
  kernel<<<min(p.total, sm_count()), attn_wg::kThreads, S::kBytes, stream>>>(
      qm, km, vm, dm, p);
  return cudaGetLastError();
}

// ---- f32 past the table: the streamed TF32 dq kernel ----------------------
// Past the widest DQ_F32 row an item's Q and dO rows at the full width, each
// held twice (big and small), no longer fit shared memory beside the ring.
// Here nothing is held at the full width, as in dq_stream_kernel: each stage
// of the ring holds one 32-column chunk (an f32 swizzle atom) of the item's
// 64 Q and dO rows and of a K and a V tile, which the converter warps split
// in place and into their small halves; the consumers take the chunk's three
// TF32 products of s and of dp into fresh accumulators and add them into s
// and dp in f32 (the tensor cores truncate what they add into an
// accumulator, and s summed there over 17-22 chunks at 520-704 columns
// would drift).  Then ds.k reads the K tile at the consumers' columns of dq,
// which comes through a second ring (kOutStages), where the converter writes
// each consumer's B of ds.k: K's three bf16 terms, or its TF32 transpose
// (the table's bf16x3); each key tile's part of dq lands in a fresh
// accumulator and is added into dq in f32 (GradFrags), and the ds.k of one
// key tile runs while the next tile's exps do.  Work items are (b * H + h,
// 64 query rows, group of two chunks of kCols columns of dq), consumer c on
// chunk 2 * group + c (StreamCut); the grid is persistent.  dq stays in
// registers until the item ends: no atomics, two calls give equal bits.
//
// Shared memory: kStages stages of a Q, a dO, a K and a V chunk (64, 64, kN
// and kN rows of 32 f32 columns) as TMA lands them, then their small
// halves; kOutStages stages of the K tile at the consumers' columns (a slot
// each, kCols / 32 atoms of kN rows), then each consumer's B of ds.k; the
// barriers.
template <int kN, int kCols, bool kBf16x3>
struct DqSplitStreamShape {
  static constexpr int kRows = 64;                // query rows an item
  static constexpr int kQBytes = kRows * 128;     // a chunk of Q or dO
  static constexpr int kKBytes = kN * 128;        // a chunk of K or V
  static constexpr int kDOff = kQBytes;           // within a stage
  static constexpr int kKOff = 2 * kQBytes;
  static constexpr int kVOff = kKOff + kKBytes;
  static constexpr int kRawBytes = 2 * kQBytes + 2 * kKBytes;
  static constexpr int kStageBytes = 2 * kRawBytes;  // big, then small
  static constexpr int kSlotBytes = kCols / 32 * kKBytes;  // a consumer's K
  // ds.k's B of a consumer: K's bf16 terms, or K^T's halves, this far apart
  static constexpr int kApart = (kBf16x3 ? 2 : 4) * kN * kCols;
  static constexpr int kBBytes = (kBf16x3 ? 3 : 2) * kApart;
  static constexpr int kBOff = 2 * kSlotBytes;    // within an out stage
  static constexpr int kOutBytes = 2 * kSlotBytes + 2 * kBBytes;
  static constexpr int kOutStages = 2;
  // as many stages as fit, at most 6
  static constexpr int kFit =
      (attn_wg::kSmemBudget - kOutStages * kOutBytes) / kStageBytes;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kOutOff = kStages * kStageBytes;
  static constexpr int kBarOff = kOutOff + kOutStages * kOutBytes;
  static constexpr int kBytes =
      kBarOff + 8 * 3 * (kStages + kOutStages) + 1024;
  static_assert(kN % (kBf16x3 ? 16 : 8) == 0 && kN <= 64,
                "key tile: whole k8 (k16) steps");
  static_assert(kCols % 32 == 0 && kCols <= 64, "whole f32 atoms, Tf32's N");
  static_assert(kStages >= 2, "a ring of at least two stages");
};

template <int kN, int kCols, bool kBf16x3>
__global__ void __launch_bounds__(attn_wg::kThreads, 1)
    dq_split_stream_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap,
                           const attn_wg::BwdParamsT<float> p) {
  using namespace attn_wg;
  using S = DqSplitStreamShape<kN, kCols, kBf16x3>;
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
      // ---- producer: one thread keeps the TMA loads in flight ----
      if (lane != 0) return;
      prefetch_map(&qmap);
      prefetch_map(&domap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      int st = 0, sph = 0, os = 0, oph = 0;
      for (int i = 0; i < items; ++i) {
        const Item it(p, blockIdx.x + i * gridDim.x);
        const int q0 = it.tile * S::kRows;
        // the atoms of the consumers' chunks of dq that hold columns < D
        // (atoms wholly past D feed only columns never stored)
        int atoms[2];
        for (int c = 0; c < 2; ++c)
          atoms[c] = cut.stores(it.group, c)
                         ? min(kCols / 32,
                               (p.D - cut.chunk(it.group, c) * kCols + 31) /
                                   32)
                         : 0;
        for (int j = 0; j < p.n_loop; ++j) {
          const int k0 = (p.n_loop - 1 - j) * kN;  // last tile first
          for (int d = 0; d < n_dc; ++d) {
            mbar_wait(&empty[st], sph ^ 1);  // a fresh barrier passes at once
            mbar_expect_tx(&full[st], S::kRawBytes);
            uint8_t* dst = smem + st * S::kStageBytes;
            tma_load_4d(dst, &qmap, &full[st], 32 * d, it.h, q0, it.b);
            tma_load_4d(dst + S::kDOff, &domap, &full[st], 32 * d, it.h, q0,
                        it.b);
            tma_load_4d(dst + S::kKOff, &kmap, &full[st], 32 * d, it.h, k0,
                        it.b);
            tma_load_4d(dst + S::kVOff, &vmap, &full[st], 32 * d, it.h, k0,
                        it.b);
            if (++st == kStages) st = 0, sph ^= 1;
          }
          mbar_wait(&out_empty[os], oph ^ 1);
          mbar_expect_tx(&out_full[os], (atoms[0] + atoms[1]) * S::kKBytes);
          uint8_t* out = smem + S::kOutOff + os * S::kOutBytes;
          for (int c = 0; c < 2; ++c)
            for (int a = 0; a < atoms[c]; ++a)
              tma_load_4d(out + c * S::kSlotBytes + a * S::kKBytes, &kmap,
                          &out_full[os],
                          cut.chunk(it.group, c) * kCols + 32 * a, it.h, k0,
                          it.b);
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
        for (int c = 0; c < 2; ++c) {
          uint8_t* b = out + S::kBOff + c * S::kBBytes;
          if constexpr (kBf16x3)
            split_terms<kCols, kN, false>(out + c * S::kSlotBytes, nullptr, b,
                                          S::kApart, cw, lane);
          else
            split_transpose<kCols, kN, false>(out + c * S::kSlotBytes,
                                              nullptr, b, b + S::kApart, cw,
                                              lane);
        }
        converted(&out_ready[os], lane);
        if (++os == kOutStages) os = 0, oph ^= 1;
      }
    return;
  }

  // ---- consumers: both on the item's 64 rows, each its chunk of dq ----
  const int c = role;
  const int warp = (threadIdx.x / 32) & 3;
  const int t = lane & 3;

  float s[kN / 2], dp[kN / 2];
  float dq[kCols / 2], part[kCols / 2];  // dq, a key tile's part of it
  GradFrags<kN, kBf16x3> ds;
  float lse2[2], delta[2];

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  int st = 0, sph = 0, os = 0, oph = 0;
  // s = q.k^T and dp = do.v^T of one key tile, their 32-column chunks in
  // turn from the ring, each chunk's products in fresh accumulators added
  // into s and dp in f32, each stage released once its products are done
  auto logits = [&]() {
#pragma unroll
    for (int x = 0; x < kN / 2; ++x) s[x] = dp[x] = 0.f;
    for (int d = 0; d < n_dc; ++d) {
      float sp[kN / 2], dpp[kN / 2];
      mbar_wait(&ready[st], sph);
      const uint32_t big = smem_u32(smem + st * S::kStageBytes);
      const uint32_t small = big + S::kRawBytes;
      fence_regs(sp);
      fence_regs(dpp);
      wg_fence();
      product_ss_tf32<32, kN, true>(sp, big, small, S::kRows,
                                    big + S::kKOff, small + S::kKOff);
      product_ss_tf32<32, kN, true>(dpp, big + S::kDOff, small + S::kDOff,
                                    S::kRows, big + S::kVOff,
                                    small + S::kVOff);
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
  // part = ds.k of the oldest K tile of the second ring over the
  // consumer's columns
  auto accumulate = [&]() {
    mbar_wait(&out_ready[os], oph);
    fence_regs(part);
    ds.fence();
    wg_fence();
    ds.template product<kCols, kCols>(
        part,
        smem_u32(smem + S::kOutOff + os * S::kOutBytes + S::kBOff +
                 c * S::kBBytes),
        S::kApart, 0);
    wg_commit();
  };
  auto accumulated = [&]() {
    wg_wait<0>();
    fence_regs(part);
    ds.fence();
    release(&out_empty[os]);
    add_part(dq, part);
    if (++os == kOutStages) os = 0, oph ^= 1;
  };

  for (int i = 0; i < items; ++i) {
    const Item it(p, blockIdx.x + i * gridDim.x);
    const int row_w = it.tile * S::kRows + 16 * warp;  // the warp's first
    const int col0 = cut.chunk(it.group, c) * kCols;   // the consumer's
    // q and do rows past T arrive as zeros, and lse = delta = 0 there
    row_terms(p, it, row_w, lane, lse2, delta);
#pragma unroll
    for (int x = 0; x < kCols / 2; ++x) dq[x] = 0.f;

    // Key tiles last to first; the first one taken, alone masked, is
    // peeled off the loop.  In the loop the ds.k of the tile before runs
    // while this tile's exps do.
    logits();
    dq_grads<kN, true>(s, dp, lse2, delta, p, (p.n_loop - 1) * kN, t);
    ds.split(s);
    for (int j = 1; j < p.n_loop; ++j) {
      logits();
      accumulate();
      dq_grads<kN, false>(s, dp, lse2, delta, p, 0, t);
      accumulated();
      ds.split(s);
    }
    accumulate();
    accumulated();

    // a clamped chunk's copy is not stored (no rows below 0)
    store_acc<kCols>(dq, p.out0 + it.b * p.s0[0] + it.h * p.s0[1], p.s0[2],
                     row_w, cut.stores(it.group, c) ? p.T : 0, col0, p.D,
                     p.pairs, lane);
  }
}

// Launches dq_split_stream_kernel<kN, kCols, kBf16x3>: a persistent grid,
// one block an SM.
template <int kN, int kCols, bool kBf16x3>
cudaError_t launch_dq_tf32_stream(const attn_wg::View& q,
                                  const attn_wg::View& k,
                                  const attn_wg::View& v,
                                  const attn_wg::View& dout,
                                  attn_wg::BwdParamsT<float> p, int B, int H,
                                  int T, int D, cudaStream_t stream) {
  using namespace attn_wg;
  using S = DqSplitStreamShape<kN, kCols, kBf16x3>;
  auto kernel = dq_split_stream_kernel<kN, kCols, kBf16x3>;
  static thread_local uint64_t opted_in = 0;
  const cudaError_t err = opt_in(kernel, S::kBytes, opted_in);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm, dm;
  // f32 views, boxes of 32 columns (an atom), 128-byte swizzle
  int maps = tensor_map(&qm, q, B, H, T, D, 32, S::kRows, 1, 4);
  if (maps == 0)
    maps = tensor_map(&dm, dout, B, H, T, D, 32, S::kRows, 1, 4);
  if (maps == 0) maps = tensor_map(&km, k, B, H, T, D, 32, kN, 1, 4);
  if (maps == 0) maps = tensor_map(&vm, v, B, H, T, D, 32, kN, 1, 4);
  if (maps != 0) return static_cast<cudaError_t>(maps);
  const int chunks = (D + kCols - 1) / kCols;
  p.n_groups = (chunks + 1) / 2;
  p.n_items = (T + S::kRows - 1) / S::kRows * p.n_groups;
  p.n_loop = (T + kN - 1) / kN;
  p.total = B * H * p.n_items;
  kernel<<<min(p.total, sm_count()), attn_wg::kThreads, S::kBytes, stream>>>(
      qm, km, vm, dm, p);
  return cudaGetLastError();
}

// The f32 instance of the first DQ_F32 row (backward_tiles.cuh) of width
// >= D, past the widest the streamed row's.
cudaError_t launch_tf32(const attn_wg::View& q, const attn_wg::View& k,
                        const attn_wg::View& v, const attn_wg::View& dout,
                        const attn_wg::BwdParamsT<float>& p, int B, int H,
                        int T, int D, cudaStream_t stream) {
#define DQ_F32(w, n, cols, bf16x3)                                        \
  if (D <= w)                                                             \
    return launch_dq_tf32<w, n, cols, bf16x3 != 0>(q, k, v, dout, p, B, H, \
                                                  T, D, stream);
#define DQ_F32_STREAMED(n, cols, bf16x3)                                  \
  return launch_dq_tf32_stream<n, cols, bf16x3 != 0>(q, k, v, dout, p, B, \
                                                     H, T, D, stream);
#include "backward_tiles.cuh"
  return cudaErrorInvalidValue;  // a table without a DQ_F32_STREAMED row
}

// The f32 instance's dynamic shared memory at D.
size_t tf32_smem_bytes(int D) {
#define DQ_F32(w, n, cols, bf16x3) \
  if (D <= w) return DqF32Shape<w, n, cols, bf16x3 != 0>::kBytes;
#define DQ_F32_STREAMED(n, cols, bf16x3) \
  return DqSplitStreamShape<n, cols, bf16x3 != 0>::kBytes;
#include "backward_tiles.cuh"
  return 0;
}

// ---- bf16, D <= 512: the warp-specialised wgmma kernel ---------------------
// Shared memory of an instance: kQBufs buffers of an item's Q and dO tiles
// (kRows rows each, all columns), kStages stages of a K and a V tile (kN
// rows each), then the barriers.
template <int kDp, int kN, int kCols>
struct DqShape {
  static constexpr int kRows = attn_wg::Cut<kDp, kCols>::kRows;
  static constexpr int kQBytes = 2 * kRows * kDp;  // Q or dO
  static constexpr int kKBytes = 2 * kN * kDp;     // K or V
  // two buffers where they leave room for two stages
  static constexpr int kQBufs =
      attn_wg::kSmemBudget - 4 * kQBytes >= 4 * kKBytes ? 2 : 1;
  // as many stages as fit, at most 4
  static constexpr int kFit =
      (attn_wg::kSmemBudget - 2 * kQBufs * kQBytes) / (2 * kKBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kDOff = kQBufs * kQBytes;
  static constexpr int kKOff = 2 * kQBufs * kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKBytes;
  static constexpr int kBarOff = kVOff + kStages * kKBytes;
  static constexpr int kBytes = kBarOff + 8 * 2 * (kQBufs + kStages) + 1024;
  static_assert(kN % 16 == 0, "key tile: whole k16 steps of dq += ds.k");
  static_assert(kStages >= 2, "a ring of at least two stages");
};

// Work items are the (b * H + h, query rows, column group) triples,
// n_items a head (Cut: 128 rows and all columns, or 64 rows and two chunks
// of kCols columns); the grid is persistent: block x takes items x, x +
// gridDim.x, ...  The producer (warpgroup 2) brings an item's Q and dO
// once (two buffers where they fit, so the next item's arrive early) and
// its K and V tiles, last to first, through the ring; consumer c takes
// rows 64c .. 64c+63, or all 64 rows and its chunk.  For each key tile: s =
// q.k^T and dp = do.v^T (ss, summed over all the head's columns), then ds
// = p * (dp - delta) * scale with p = exp2(s * c - lse * log2(e)) in the
// accumulator registers, split into bf16 hi + lo, and dq += ds.k over the
// consumer's columns (rs, k read MN-major from the same tile).  The next
// tile's s and dp are issued before this tile's ds.k, so that its exps run
// while the tensor cores add ds.k.  dq stays in registers until the item
// ends.
template <int kDp, int kN, int kCols>
__global__ void __launch_bounds__(attn_wg::kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap domap,
              const attn_wg::BwdParams p) {
  using namespace attn_wg;
  using S = DqShape<kDp, kN, kCols>;
  using A = Atoms<kDp>;
  using C = Cut<kDp, kCols>;
  constexpr int kStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::kBarOff);
  uint64_t* q_empty = q_full + S::kQBufs;
  uint64_t* kv_full = q_empty + S::kQBufs;
  uint64_t* kv_empty = kv_full + kStages;
  const int items =
      (p.total - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::kQBufs; ++i) {
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

  // the warpgroup, warp-uniform for the compiler, so that each role's code
  // is compiled for its own register count
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == kConsumerWGs) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x != 128 * kConsumerWGs) return;
    prefetch_map(&qmap);
    prefetch_map(&domap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    int stage = 0, sph = 0, qb = 0, qph = 0;
    for (int i = 0; i < items; ++i) {
      const Item it(p, blockIdx.x + i * gridDim.x);
      const int q0 = it.tile * S::kRows;
      mbar_wait(&q_empty[qb], qph ^ 1);  // a fresh barrier passes at once
      mbar_expect_tx(&q_full[qb], 2 * S::kQBytes);
      load_tile<kDp>(smem + qb * S::kQBytes, &qmap, &q_full[qb], S::kRows,
                     it.h, q0, it.b);
      load_tile<kDp>(smem + S::kDOff + qb * S::kQBytes, &domap, &q_full[qb],
                     S::kRows, it.h, q0, it.b);
      if (++qb == S::kQBufs) qb = 0, qph ^= 1;
      for (int j = 0; j < p.n_loop; ++j) {
        mbar_wait(&kv_empty[stage], sph ^ 1);
        mbar_expect_tx(&kv_full[stage], 2 * S::kKBytes);
        const int k0 = (p.n_loop - 1 - j) * kN;  // last tile first
        load_tile<kDp>(smem + S::kKOff + stage * S::kKBytes, &kmap,
                       &kv_full[stage], kN, it.h, k0, it.b);
        load_tile<kDp>(smem + S::kVOff + stage * S::kKBytes, &vmap,
                       &kv_full[stage], kN, it.h, k0, it.b);
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

  float s[kN / 2], dp[kN / 2];
  float dq[kCols / 2];
  uint32_t hi[kN / 16][4], lo[kN / 16][4];
  float lse2[2], delta[2];

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  int stage = 0, sph = 0, qb = 0, qph = 0;
  for (int i = 0; i < items; ++i) {
    const Item it(p, blockIdx.x + i * gridDim.x);
    const int b = it.b, h = it.h;
    // the warp's first row, the consumer's first column
    const int row_w = it.tile * S::kRows + C::row0(c) + 16 * warp;
    const int col0 = C::chunk(it.group, c) * kCols;
    // q and do rows past T arrive as zeros, and lse = delta = 0 there
    row_terms(p, it, row_w, lane, lse2, delta);
#pragma unroll
    for (int x = 0; x < kCols / 2; ++x) dq[x] = 0.f;
    mbar_wait(&q_full[qb], qph);
    const uint32_t qa =
        smem_u32(smem + qb * S::kQBytes) + C::row0(c) * A::kRowBytes;
    const uint32_t da = smem_u32(smem + S::kDOff + qb * S::kQBytes) +
                        C::row0(c) * A::kRowBytes;
    // the consumer's first column atom in a K tile
    const uint32_t col_off = col0 / A::kCols * kN * A::kRowBytes;

    // s and dp of the key tile in stage st, one commit group; every
    // register the products read or write is settled before it opens
    auto logits = [&](int st) {
      fence_regs(s);
      fence_regs(dp);
      fence_regs(dq);
      fence_regs(hi);
      fence_regs(lo);
      wg_fence();
      product_ss<kDp, kN>(s, qa, S::kRows,
                          smem_u32(smem + S::kKOff + st * S::kKBytes));
      product_ss<kDp, kN>(dp, da, S::kRows,
                          smem_u32(smem + S::kVOff + st * S::kKBytes));
      wg_commit();
    };
    // dq += ds.k of the key tile in stage st, ds = hi + lo, over the
    // consumer's columns
    auto accumulate = [&](int st) {
      product_rs<kDp, kCols, kN>(
          dq, hi, lo, smem_u32(smem + S::kKOff + st * S::kKBytes) + col_off);
      wg_commit();
    };
    // Key tiles are taken last to first: the first one taken holds the
    // keys past T, and it alone is masked.  Its turn is peeled off the loop
    // so that no wait or product of the loop sits under a branch.
    mbar_wait(&kv_full[stage], sph);
    logits(stage);
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (p.n_loop == 1) release(&q_empty[qb]);  // q and do are read no more
    dq_grads<kN, true>(s, dp, lse2, delta, p, (p.n_loop - 1) * kN, t);
    split_frags<kN>(s, hi, lo);
    int prev = stage;
    if (++stage == kStages) stage = 0, sph ^= 1;
    for (int j = 1; j < p.n_loop; ++j) {
      mbar_wait(&kv_full[stage], sph);
      logits(stage);
      accumulate(prev);
      wg_wait<1>();  // s and dp; ds.k of the tile before runs on
      fence_regs(s);
      fence_regs(dp);
      if (j == p.n_loop - 1) release(&q_empty[qb]);
      dq_grads<kN, false>(s, dp, lse2, delta, p, 0, t);
      wg_wait<0>();
      fence_regs(dq);
      fence_regs(hi);
      fence_regs(lo);
      release(&kv_empty[prev]);
      split_frags<kN>(s, hi, lo);
      prev = stage;
      if (++stage == kStages) stage = 0, sph ^= 1;
    }
    // the last tile's ds.k
    fence_regs(dq);
    fence_regs(hi);
    fence_regs(lo);
    wg_fence();
    accumulate(prev);
    wg_wait<0>();
    fence_regs(dq);
    fence_regs(hi);
    fence_regs(lo);
    release(&kv_empty[prev]);

    // a clamped chunk's copy is not stored (no rows below 0)
    store_acc<kCols>(dq, p.out0 + b * p.s0[0] + h * p.s0[1], p.s0[2], row_w,
                     C::stores(it.group, c) ? p.T : 0, col0, p.D, p.pairs,
                     lane);
    if (++qb == S::kQBufs) qb = 0, qph ^= 1;
  }
}

// Launches dq_kernel<kDp, kN, kCols>: a persistent grid, one block an SM.
template <int kDp, int kN, int kCols>
cudaError_t launch_dq(const attn_wg::View& q, const attn_wg::View& k,
                      const attn_wg::View& v, const attn_wg::View& dout,
                      attn_wg::BwdParams p, int B, int H, int T, int D,
                      cudaStream_t stream) {
  using namespace attn_wg;
  using S = DqShape<kDp, kN, kCols>;
  using A = Atoms<kDp>;
  using C = Cut<kDp, kCols>;
  auto kernel = dq_kernel<kDp, kN, kCols>;
  static thread_local uint64_t opted_in = 0;
  const cudaError_t err = opt_in(kernel, S::kBytes, opted_in);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm, dm;
  int maps =
      tensor_map(&qm, q, B, H, T, D, A::kCols, S::kRows, A::kSwizzle);
  if (maps == 0)
    maps = tensor_map(&dm, dout, B, H, T, D, A::kCols, S::kRows, A::kSwizzle);
  if (maps == 0)
    maps = tensor_map(&km, k, B, H, T, D, A::kCols, kN, A::kSwizzle);
  if (maps == 0)
    maps = tensor_map(&vm, v, B, H, T, D, A::kCols, kN, A::kSwizzle);
  if (maps != 0) return static_cast<cudaError_t>(maps);
  p.n_groups = C::kGroups;
  p.n_items = (T + S::kRows - 1) / S::kRows * C::kGroups;
  p.n_loop = (T + kN - 1) / kN;
  p.total = B * H * p.n_items;
  kernel<<<min(p.total, sm_count()), attn_wg::kThreads, S::kBytes, stream>>>(
      qm, km, vm, dm, p);
  return cudaGetLastError();
}

// ---- bf16 past the table: the streamed dq kernel --------------------------
// Past the table's widest row an item's Q and dO rows at the full width no
// longer fit shared memory beside the ring.  Here nothing is held at the
// full width: each stage of the ring holds one 64-column chunk of the
// item's Q and dO rows and of a K and a V tile, and the consumers add each
// chunk's products into s and dp in their registers; then dq += ds.k reads
// the K tile at the item's columns of dq, which comes through a second
// ring (kOutStages), so that the ds.k of one key tile runs while the
// next tile's exps do.  Work items are (b * H + h, 64 query rows, group of
// two chunks of kCols columns of dq), consumer c on chunk 2 * group + c
// (StreamCut); the grid is persistent.
//
// Shared memory: kStages stages of a Q, a dO, a K and a V chunk (64, 64,
// kN and kN rows of 64 columns), kOutStages stages of the K tile at the
// item's columns (both consumers' chunks, kN rows each), the barriers.
template <int kN, int kCols>
struct DqStreamShape {
  static constexpr int kRows = 64;                    // query rows an item
  static constexpr int kQBytes = kRows * 128;         // a chunk of Q or dO
  static constexpr int kKBytes = kN * 128;            // a chunk of K or V
  static constexpr int kDOff = kQBytes;               // within a stage
  static constexpr int kKOff = 2 * kQBytes;
  static constexpr int kVOff = kKOff + kKBytes;
  static constexpr int kStageBytes = 2 * kQBytes + 2 * kKBytes;
  static constexpr int kOutAtoms = kCols / 64;        // a consumer's
  static constexpr int kSlotBytes = kOutAtoms * kKBytes;
  static constexpr int kOutBytes = 2 * kSlotBytes;
  static constexpr int kOutStages = 2;
  // as many stages as fit, at most 6
  static constexpr int kFit =
      (attn_wg::kSmemBudget - kOutStages * kOutBytes) / kStageBytes;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kOutOff = kStages * kStageBytes;
  static constexpr int kBarOff = kOutOff + kOutStages * kOutBytes;
  static constexpr int kBytes =
      kBarOff + 8 * 2 * (kStages + kOutStages) + 1024;
  static_assert(kN % 16 == 0 && kN <= 128, "key tile");
  static_assert(kCols % 64 == 0 && kCols <= 256, "whole atoms, wgmma's N");
  static_assert(kStages >= 2, "a ring of at least two stages");
};

template <int kN, int kCols>
__global__ void __launch_bounds__(attn_wg::kThreads, 1)
    dq_stream_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap domap,
                     const attn_wg::BwdParams p) {
  using namespace attn_wg;
  using S = DqStreamShape<kN, kCols>;
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
    // ---- producer: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x != 128 * kConsumerWGs) return;
    prefetch_map(&qmap);
    prefetch_map(&domap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    int st = 0, sph = 0, os = 0, oph = 0;
    for (int i = 0; i < items; ++i) {
      const Item it(p, blockIdx.x + i * gridDim.x);
      const int q0 = it.tile * S::kRows;
      // the atoms of the consumers' chunks of dq that hold columns < D
      // (atoms wholly past D feed only columns never stored)
      int atoms[2];
      for (int c = 0; c < 2; ++c)
        atoms[c] = cut.stores(it.group, c)
                       ? min(S::kOutAtoms,
                             atoms_of(p.D - cut.chunk(it.group, c) * kCols))
                       : 0;
      for (int j = 0; j < p.n_loop; ++j) {
        const int k0 = (p.n_loop - 1 - j) * kN;  // last tile first
        for (int d = 0; d < n_dc; ++d) {
          mbar_wait(&empty[st], sph ^ 1);  // a fresh barrier passes at once
          mbar_expect_tx(&full[st], S::kStageBytes);
          uint8_t* dst = smem + st * S::kStageBytes;
          tma_load_4d(dst, &qmap, &full[st], 64 * d, it.h, q0, it.b);
          tma_load_4d(dst + S::kDOff, &domap, &full[st], 64 * d, it.h, q0,
                      it.b);
          tma_load_4d(dst + S::kKOff, &kmap, &full[st], 64 * d, it.h, k0,
                      it.b);
          tma_load_4d(dst + S::kVOff, &vmap, &full[st], 64 * d, it.h, k0,
                      it.b);
          if (++st == kStages) st = 0, sph ^= 1;
        }
        mbar_wait(&out_empty[os], oph ^ 1);
        mbar_expect_tx(&out_full[os], (atoms[0] + atoms[1]) * S::kKBytes);
        for (int c = 0; c < 2; ++c)
          for (int a = 0; a < atoms[c]; ++a)
            tma_load_4d(smem + S::kOutOff + os * S::kOutBytes +
                            c * S::kSlotBytes + a * S::kKBytes,
                        &kmap, &out_full[os],
                        cut.chunk(it.group, c) * kCols + 64 * a, it.h, k0,
                        it.b);
        if (++os == kOutStages) os = 0, oph ^= 1;
      }
    }
    return;
  }

  // ---- consumers: both on the item's 64 rows, each its chunk of dq ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = role;
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;

  float s[kN / 2], dp[kN / 2];
  float dq[kCols / 2];
  uint32_t hi[kN / 16][4], lo[kN / 16][4];
  float lse2[2], delta[2];

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  int st = 0, sph = 0, os = 0, oph = 0;
  // s = q.k^T and dp = do.v^T of one key tile, their 64-column chunks in
  // turn from the ring, each stage released once its products are done
  auto logits = [&]() {
    for (int d = 0; d < n_dc; ++d) {
      mbar_wait(&full[st], sph);
      const uint32_t base = smem_u32(smem + st * S::kStageBytes);
      fence_regs(s);
      fence_regs(dp);
      wg_fence();
      product_ss_atom<kN>(s, base, base + S::kKOff, d > 0);
      product_ss_atom<kN>(dp, base + S::kDOff, base + S::kVOff, d > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      release(&empty[st]);
      if (++st == kStages) st = 0, sph ^= 1;
    }
  };
  // dq += ds.k of the oldest K tile of the second ring, ds = hi + lo, over
  // the consumer's columns
  auto accumulate = [&]() {
    mbar_wait(&out_full[os], oph);
    fence_regs(dq);
    fence_regs(hi);
    fence_regs(lo);
    wg_fence();
    product_rs<64, kCols, kN>(
        dq, hi, lo,
        smem_u32(smem + S::kOutOff + os * S::kOutBytes + c * S::kSlotBytes));
    wg_commit();
  };
  auto accumulated = [&]() {
    wg_wait<0>();
    fence_regs(dq);
    fence_regs(hi);
    fence_regs(lo);
    release(&out_empty[os]);
    if (++os == kOutStages) os = 0, oph ^= 1;
  };

  for (int i = 0; i < items; ++i) {
    const Item it(p, blockIdx.x + i * gridDim.x);
    const int b = it.b, h = it.h;
    const int row_w = it.tile * S::kRows + 16 * warp;  // the warp's first
    const int col0 = cut.chunk(it.group, c) * kCols;   // the consumer's
    row_terms(p, it, row_w, lane, lse2, delta);
#pragma unroll
    for (int x = 0; x < kCols / 2; ++x) dq[x] = 0.f;

    // Key tiles last to first; the first one taken, alone masked, is
    // peeled off the loop.  In the loop the ds.k of the tile before runs
    // while this tile's exps do.
    logits();
    dq_grads<kN, true>(s, dp, lse2, delta, p, (p.n_loop - 1) * kN, t);
    split_frags<kN>(s, hi, lo);
    for (int j = 1; j < p.n_loop; ++j) {
      logits();
      accumulate();
      dq_grads<kN, false>(s, dp, lse2, delta, p, 0, t);
      accumulated();
      split_frags<kN>(s, hi, lo);
    }
    accumulate();
    accumulated();

    // a clamped chunk's copy is not stored (no rows below 0)
    store_acc<kCols>(dq, p.out0 + b * p.s0[0] + h * p.s0[1], p.s0[2], row_w,
                     cut.stores(it.group, c) ? p.T : 0, col0, p.D, p.pairs,
                     lane);
  }
}

// Launches dq_stream_kernel<kN, kCols>: a persistent grid, one block an SM.
template <int kN, int kCols>
cudaError_t launch_dq_stream(const attn_wg::View& q, const attn_wg::View& k,
                             const attn_wg::View& v,
                             const attn_wg::View& dout, attn_wg::BwdParams p,
                             int B, int H, int T, int D,
                             cudaStream_t stream) {
  using namespace attn_wg;
  using S = DqStreamShape<kN, kCols>;
  auto kernel = dq_stream_kernel<kN, kCols>;
  static thread_local uint64_t opted_in = 0;
  const cudaError_t err = opt_in(kernel, S::kBytes, opted_in);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm, dm;
  int maps =
      tensor_map(&qm, q, B, H, T, D, 64, S::kRows, 1);
  if (maps == 0)
    maps = tensor_map(&dm, dout, B, H, T, D, 64, S::kRows, 1);
  if (maps == 0)
    maps = tensor_map(&km, k, B, H, T, D, 64, kN, 1);
  if (maps == 0)
    maps = tensor_map(&vm, v, B, H, T, D, 64, kN, 1);
  if (maps != 0) return static_cast<cudaError_t>(maps);
  const int chunks = (D + kCols - 1) / kCols;
  p.n_groups = (chunks + 1) / 2;
  p.n_items = (T + S::kRows - 1) / S::kRows * p.n_groups;
  p.n_loop = (T + kN - 1) / kN;
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
#define DQ(w, n, cols)                                                   \
  if (D <= w)                                                            \
    return launch_dq<w, n, cols>(q, k, v, dout, p, B, H, T, D, stream);
#define DQ_STREAMED(n, cols)                                             \
  return launch_dq_stream<n, cols>(q, k, v, dout, p, B, H, T, D, stream);
#include "backward_tiles.cuh"
  return cudaErrorInvalidValue;  // a table without a DQ_STREAMED row
}

// The wgmma instance's dynamic shared memory at D.
size_t wgmma_smem_bytes(int D) {
#define DQ(w, n, cols) \
  if (D <= w) return DqShape<w, n, cols>::kBytes;
#define DQ_STREAMED(n, cols) return DqStreamShape<n, cols>::kBytes;
#include "backward_tiles.cuh"
  return 0;
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* lse,
                       void* dq, const BwdLayout& L, int B, int H, int seq,
                       int D, float scale, cudaStream_t s) {
  using attn_wg::View;
  attn_wg::BwdParamsT<float> p{};
  p.out0 = static_cast<float*>(dq);
  p.o = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  for (int x = 0; x < 3; ++x) {
    const int64_t* st[3] = {L.sb, L.sh, L.st};
    p.so[x] = st[x][3];
    p.sd[x] = st[x][4];
    p.s0[x] = st[x][5];
  }
  p.H = H;
  p.T = seq;
  p.D = D;
  p.scale = scale;
  p.c = scale * attn_wg::kLog2e;
  p.pairs = D % 2 == 0 && reinterpret_cast<uintptr_t>(dq) % 8 == 0 &&
            (L.sb[5] | L.sh[5] | L.st[5]) % 2 == 0;
  return launch_tf32(View{q, L.sb[0], L.sh[0], L.st[0]},
                     View{k, L.sb[1], L.sh[1], L.st[1]},
                     View{v, L.sb[2], L.sh[2], L.st[2]},
                     View{dout, L.sb[4], L.sh[4], L.st[4]}, p, B, H, seq, D,
                     s);
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* dq, const BwdLayout& L, int B, int H, int seq,
                        int D, float scale, cudaStream_t s) {
  using attn_wg::View;
  attn_wg::BwdParams p{};
  p.out0 = static_cast<__nv_bfloat16*>(dq);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  for (int x = 0; x < 3; ++x) {
    const int64_t* st[3] = {L.sb, L.sh, L.st};
    p.so[x] = st[x][3];
    p.sd[x] = st[x][4];
    p.s0[x] = st[x][5];
  }
  p.H = H;
  p.T = seq;
  p.D = D;
  p.scale = scale;
  p.c = scale * attn_wg::kLog2e;
  p.pairs = D % 2 == 0 && reinterpret_cast<uintptr_t>(dq) % 4 == 0 &&
            (L.sb[5] | L.sh[5] | L.st[5]) % 2 == 0;
  return launch_wgmma(View{q, L.sb[0], L.sh[0], L.st[0]},
                      View{k, L.sb[1], L.sh[1], L.st[1]},
                      View{v, L.sb[2], L.sh[2], L.st[2]},
                      View{dout, L.sb[4], L.sh[4], L.st[4]}, p, B, H, seq, D,
                      s);
}

}  // namespace

// q, k, v, o, dout, dq: (B, H, T, D) views (o and dout as views of their
// (B, T, H, D) tensors), their (b, h, t) strides in elements in `strides`,
// three each in that order (d's stride is 1); every instance reads q, k, v
// and dout through tensor maps, so their bases are 16-byte aligned and
// those strides multiples of 16 bytes, which the wrapper sees to.  lse: (B, H, T) float32
// contiguous.  dq has q's type.  Any D; dtype 0 is float32, 1 is bfloat16.
// Returns the cudaError_t of the launch, or kTensorMapFailed + the
// CUresult of a tensor map cuTensorMapEncodeTiled refused.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* dq, const long long* strides, int B, int H,
                            int T, int D, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdLayout L = BwdLayout::from(strides);
  switch (dtype) {
    case 0:
      return launch_f32(q, k, v, o, dout, lse, dq, L, B, H, T, D, scale, s);
    case 1:
      return launch_bf16(q, k, v, o, dout, lse, dq, L, B, H, T, D, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory one launch needs, in bytes: the larger of the
// two instances' needs, which depend on D alone.
extern "C" long long flash_bwd_dq_smem_bytes(int T, int D) {
  (void)T;
  const size_t f32 = tf32_smem_bytes(D);
  const size_t bf16 = wgmma_smem_bytes(D);
  return static_cast<long long>(f32 > bf16 ? f32 : bf16);
}
