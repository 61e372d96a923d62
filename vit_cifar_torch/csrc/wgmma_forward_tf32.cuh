// The f32 attention forward (dtype 0) on TF32 wgmma at every width, which
// flash_fwd.cu (tiled) and mhsa_fwd.cu (the whole head as one key tile
// where a consumer holds it, else tiled) launch, with and without lse: up
// to 128 columns fwd_split_kernel (below), past them the streamed instance
// fwd_split_stream_kernel (further below, "past 128 columns").
//
// It is the bf16 forward's design (wgmma_attention.cuh: a persistent grid
// of work items (b, h, query rows), a producer thread bringing each item's
// q once and its K and V tiles, last to first, through an mbarrier ring by
// TMA over the caller's (B, H, T, D) views; two consumer warpgroups running
// the online softmax in f32 registers with the TPU kernel's safe_m guard)
// with the f32 backward pair's arithmetic (wgmma_tf32.cuh), so that it
// keeps f32 accuracy on tensor cores that take f32 as TF32:
//   * s = q.k^T as three TF32 products of big and small halves, big.big +
//     big.small + small.big: q and K read K-major as TMA lands them;
//   * o += p.V sums over keys, so V is read MN-major, which TF32 wgmma
//     cannot: V as three bf16 terms read through bf16 wgmma's transpose
//     bit (six bf16 products), or as its TF32 transpose (three TF32
//     products), the FWD_F32 row's bf16x3 column; p is split in the
//     consumers' registers (GradFrags);
//   * each key tile's p.V lands in a fresh accumulator and is added into o
//     in f32 registers, o = o * corr + part: the tensor cores truncate what
//     a wgmma adds into its accumulator, and summed there over the 33 key
//     tiles of T=1025 o would shrink (as dv did, PERF.md).
// Converter warps 1-3 of the producer warpgroup split each tile as it lands
// (q into big + small in place, K the same, V into its terms or transpose)
// and arrive on the stage's "ready" barrier, which the consumers wait for.
// Within a warpgroup the p.V of one key tile runs while the softmax of the
// next does.  Tiles and routes by width: forward_tiles.cuh's FWD_F32,
// WHOLE_F32 and FWD_F32_STREAMED rows.
//
// What bounds it on this card: at the pixel shape (128, 12, 1025, 32) two
// 1025x1025x32 products a head, each three TF32 products (165 TFLOP/s for
// an f32-accurate product), against 4 bytes an element: the products.  At
// the flagship's (128, 12, 65, 32) the bytes.

#pragma once

#include "wgmma_attention.cuh"
#include "wgmma_tf32.cuh"

namespace attn_wg {
namespace {

// One f32 forward launch's scalars.  Work items (b * H + h, query tile,
// group) as the backward pair's (Item, Cut): n_items a head.
struct F32Params {
  float* out;   // (B, T, H, D)
  float* lse;   // (B, H, T), or null
  int H, T, D;
  float c;      // softmax scale * log2(e)
  int n_items;  // work items a head: query tiles x groups
  int n_groups; // column groups a query tile (Cut)
  int n_kt;     // key tiles a head
  int total;    // work items
  bool pairs;   // o stored two columns at a time
};

// Shared memory of an instance: kQBufs buffers of an item's q (kRows rows,
// all columns; big, then small), kStages stages of a key tile's K (kN
// keys; big, then small), V as TMA lands it (kK rows: the depth of p.V)
// and p.V's B (V's three bf16 terms in the bf16 layout, or its TF32
// transpose, big then small), then the barriers.
template <int kDp, int kN, int kCols, bool kBf16x3>
struct FwdF32Shape {
  static constexpr int kRows = Cut<kDp, kCols>::kRows;
  static constexpr int kK = kBf16x3 ? (kN + 15) / 16 * 16 : kN;
  static constexpr int kQBytes = 4 * kRows * kDp;  // a half of q
  static constexpr int kItemBytes = 2 * kQBytes;
  static constexpr int kKBytes = 4 * kN * kDp;     // a half of K
  static constexpr int kVOff = 2 * kKBytes;        // within a stage
  static constexpr int kVBytes = 4 * kK * kDp;     // V, or a half of V^T
  static constexpr int kTOff = kVOff + kVBytes;
  static constexpr int kTermBytes = 2 * kK * kDp;  // a bf16 term of V
  // p.V's B: V^T's halves, or V's terms, this many bytes apart
  static constexpr int kApart = kBf16x3 ? kTermBytes : kVBytes;
  static constexpr int kStageBytes =
      kTOff + (kBf16x3 ? 3 * kTermBytes : 2 * kVBytes);
  // two q buffers where they leave room for three stages
  static constexpr int kQBufs =
      kSmemBudget - 2 * kItemBytes >= 3 * kStageBytes ? 2 : 1;
  // as many stages as fit, at most 4
  static constexpr int kFit =
      (kSmemBudget - kQBufs * kItemBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kBarOff = kQBufs * kItemBytes + kStages * kStageBytes;
  static constexpr int kBytes = kBarOff + 8 * 3 * (kQBufs + kStages) + 1024;
  static_assert(kN % 8 == 0 && kN <= 72, "key tile: whole k8 steps");
  static_assert(!kBf16x3 || kCols % Atoms<kDp>::kCols == 0,
                "a consumer's columns of V's bf16 terms: whole atoms");
  static_assert(kStages >= 2, "a ring of at least two stages");
};

// o / l into the consumer's kCols columns from col0 of its rows (from the
// warp's first row row_w) of the (B, T, H, D) f32 output, and with
// `lse_too` lse = m * ln(2) + log(l) into (B, H, T).  o is scaled and read
// outside any branch; rows past T are not written (their l is 0).
template <int kCols>
__device__ __forceinline__ void store_o_f32(float (&o)[kCols / 2],
                                            const float (&m)[2],
                                            const float (&l)[2],
                                            const F32Params& p,
                                            const Item& it, int row_w,
                                            int col0, bool stores,
                                            bool lse_too, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / lt;
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      o[4 * n + 2 * r] *= inv;
      o[4 * n + 2 * r + 1] *= inv;
    }
    const int row = row_w + g + 8 * r;
    if (lse_too && p.lse != nullptr && t == 0 && row < p.T)
      p.lse[static_cast<long long>(it.bh) * p.T + row] =
          m[r] * 0.6931471805599453f + logf(lt);
  }
  store_acc<kCols>(
      o, p.out + (static_cast<long long>(it.b) * p.T * p.H + it.h) * p.D,
      static_cast<long long>(p.H) * p.D, row_w, stores ? p.T : 0, col0, p.D,
      p.pairs, lane);
}

// The forward on TF32 wgmma at padded width kDp: key tiles of kN keys,
// kCols columns of o a consumer (Cut), p.V's route kBf16x3; kWhole: the
// head is one key tile (mhsa_fwd's WHOLE_F32 rows, n_kt == 1), whose p.V
// lands in o itself.
template <int kDp, int kN, int kCols, bool kBf16x3, bool kWhole>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_split_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const F32Params p) {
  using S = FwdF32Shape<kDp, kN, kCols, kBf16x3>;
  using C = Cut<kDp, kCols>;
  constexpr int kStages = S::kStages;
  constexpr int kQBufs = S::kQBufs;
  constexpr int kK = S::kK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::kBarOff);
  uint64_t* q_ready = q_full + kQBufs;
  uint64_t* q_empty = q_ready + kQBufs;
  uint64_t* full = q_empty + kQBufs;
  uint64_t* ready = full + kStages;
  uint64_t* empty = ready + kStages;
  uint8_t* ring = smem + kQBufs * S::kItemBytes;
  const int items =
      (p.total - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_ready[i], kConverterWarps);
      mbar_init(&q_empty[i], kConsumerWarps);
    }
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
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      int stage = 0, sph = 0, qb = 0, qph = 0;
      for (int i = 0; i < items; ++i) {
        const Item it(p, blockIdx.x + i * gridDim.x);
        mbar_wait(&q_empty[qb], qph ^ 1);  // a fresh barrier passes at once
        mbar_expect_tx(&q_full[qb], S::kQBytes);
        load_tile_f32<kDp>(smem + qb * S::kItemBytes, &qmap, &q_full[qb],
                           S::kRows, it.h, it.tile * S::kRows, it.b);
        if (++qb == kQBufs) qb = 0, qph ^= 1;
        for (int j = 0; j < p.n_kt; ++j) {
          mbar_wait(&empty[stage], sph ^ 1);
          mbar_expect_tx(&full[stage], S::kKBytes + S::kVBytes);
          const int k0 = (p.n_kt - 1 - j) * kN;  // last tile first
          uint8_t* st = ring + stage * S::kStageBytes;
          load_tile_f32<kDp>(st, &kmap, &full[stage], kN, it.h, k0, it.b);
          load_tile_f32<kDp>(st + S::kVOff, &vmap, &full[stage], kK, it.h,
                             k0, it.b);
          if (++stage == kStages) stage = 0, sph ^= 1;
        }
      }
      return;
    }
    // ---- converter: warps 1-3 split the tiles as they arrive ----
    const int cw = pw - 1;
    int stage = 0, sph = 0, qb = 0, qph = 0;
    for (int i = 0; i < items; ++i) {
      uint8_t* q = smem + qb * S::kItemBytes;
      mbar_wait(&q_full[qb], qph);
      split_tile(q, q + S::kQBytes, S::kQBytes, cw, lane);
      converted(&q_ready[qb], lane);
      if (++qb == kQBufs) qb = 0, qph ^= 1;
      for (int j = 0; j < p.n_kt; ++j) {
        mbar_wait(&full[stage], sph);
        uint8_t* st = ring + stage * S::kStageBytes;
        split_tile(st, st + S::kKBytes, S::kKBytes, cw, lane);
        if constexpr (kBf16x3)
          split_terms<kDp, kK, false>(st + S::kVOff, nullptr, st + S::kTOff,
                                      S::kTermBytes, cw, lane);
        else
          split_transpose<kDp, kK, false>(st + S::kVOff, nullptr,
                                          st + S::kTOff,
                                          st + S::kTOff + S::kVBytes, cw,
                                          lane);
        converted(&ready[stage], lane);
        if (++stage == kStages) stage = 0, sph ^= 1;
      }
    }
    return;
  }

  // ---- consumers: warpgroup c on rows row0(c) .., its columns of o ----
  const int c = role;
  const int warp = (threadIdx.x / 32) & 3;
  const int t = lane & 3;

  float s[kN / 2];
  float o[kCols / 2];
  float part[kCols / 2];  // a key tile's p.V (not used by kWhole)
  GradFrags<kK, kBf16x3> pf;           // p as p.V's A fragments
  float m[2], l[2], corr[2], cp[2];    // cp: the corr of part's tile

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto split_p = [&]() {
    if constexpr (kBf16x3)
      split_frags_bf16x3_padded<kN, kK>(s, pf.t);
    else
      pf.split(s);
  };

  int stage = 0, sph = 0, qb = 0, qph = 0;
  for (int i = 0; i < items; ++i) {
    const Item it(p, blockIdx.x + i * gridDim.x);
    const int row_w = it.tile * S::kRows + C::row0(c) + 16 * warp;
    const int col0 = C::chunk(it.group, c) * kCols;
    // warp-uniform, and shown so to ptxas: a branch it takes for divergent
    // around the accumulator registers serialises the wgmmas
    const bool warp_active = __shfl_sync(0xffffffffu, row_w < p.T, 0);
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int x = 0; x < kCols / 2; ++x) o[x] = 0.f;
    mbar_wait(&q_ready[qb], qph);
    const uint32_t qa = smem_u32(smem + qb * S::kItemBytes) + C::row0(c) * 128;

    // s of the key tile in stage st, one commit group; every register the
    // products read or write is settled before it opens
    auto logits = [&](int st) {
      fence_regs(s);
      fence_regs(o);
      if constexpr (!kWhole) fence_regs(part);
      pf.fence();
      wg_fence();
      const uint32_t k = smem_u32(ring + st * S::kStageBytes);
      const uint32_t q = opaque(qa);
      product_ss_tf32<kDp, kN>(s, q, q + S::kQBytes, S::kRows, k,
                               k + S::kKBytes);
      wg_commit();
    };
    // acc = p.V of the key tile in stage st over the consumer's columns
    auto accumulate = [&](float (&acc)[kCols / 2], int st) {
      pf.template product<kDp, kCols>(
          acc, smem_u32(ring + st * S::kStageBytes) + S::kTOff, S::kApart,
          col0);
      wg_commit();
    };
    // o = o * corr of part's tile + part, in f32
    auto fold = [&]() {
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n) {
        o[4 * n] = fmaf(o[4 * n], cp[0], part[4 * n]);
        o[4 * n + 1] = fmaf(o[4 * n + 1], cp[0], part[4 * n + 1]);
        o[4 * n + 2] = fmaf(o[4 * n + 2], cp[1], part[4 * n + 2]);
        o[4 * n + 3] = fmaf(o[4 * n + 3], cp[1], part[4 * n + 3]);
      }
    };

    // Key tiles are taken last to first: the first one taken holds the
    // keys past T, and it alone is masked.  Its turn is peeled off the loop
    // so that no wait or product of the loop sits under a branch.
    mbar_wait(&ready[stage], sph);
    logits(stage);
    wg_wait<0>();
    fence_regs(s);
    if (p.n_kt == 1) release(&q_empty[qb]);  // q is read no more
    online_softmax<kN, true>(s, m, l, corr, p, (p.n_kt - 1) * kN, t,
                             warp_active);
    split_p();
    if constexpr (kWhole) {  // the one tile's p.V is o
      fence_regs(o);
      pf.fence();
      wg_fence();
      accumulate(o, stage);
      wg_wait<0>();
      fence_regs(o);
      pf.fence();
      release(&empty[stage]);
      if (++stage == kStages) stage = 0, sph ^= 1;
    } else {
      cp[0] = corr[0];
      cp[1] = corr[1];
      int prev = stage;
      if (++stage == kStages) stage = 0, sph ^= 1;
      for (int j = 1; j < p.n_kt; ++j) {
        mbar_wait(&ready[stage], sph);
        logits(stage);
        accumulate(part, prev);
        wg_wait<1>();  // s; the p.V of the tile before runs on
        fence_regs(s);
        if (j == p.n_kt - 1) release(&q_empty[qb]);
        online_softmax<kN, false>(s, m, l, corr, p, 0, t, warp_active);
        wg_wait<0>();
        fence_regs(part);
        pf.fence();
        release(&empty[prev]);
        fold();
        cp[0] = corr[0];
        cp[1] = corr[1];
        split_p();
        prev = stage;
        if (++stage == kStages) stage = 0, sph ^= 1;
      }
      // the last tile's p.V
      fence_regs(part);
      pf.fence();
      wg_fence();
      accumulate(part, prev);
      wg_wait<0>();
      fence_regs(part);
      pf.fence();
      release(&empty[prev]);
      fold();
    }

    // the two consumers of a column-chunk item hold the same rows: the
    // first writes lse
    store_o_f32<kCols>(o, m, l, p, it, row_w, col0, C::stores(it.group, c),
                       !C::kSplit || c == 0, lane);
    if (++qb == kQBufs) qb = 0, qph ^= 1;
  }
}

// Launches fwd_split_kernel<kDp, kN, kCols, kBf16x3, kWhole>: a persistent
// grid, one block an SM.
template <int kDp, int kN, int kCols, bool kBf16x3, bool kWhole>
cudaError_t launch_split(const View& q, const View& k, const View& v,
                         void* out, void* lse, void* /*scratch*/, int B,
                         int H, int T, int D, float scale,
                         cudaStream_t stream) {
  using S = FwdF32Shape<kDp, kN, kCols, kBf16x3>;
  using C = Cut<kDp, kCols>;
  auto kernel = fwd_split_kernel<kDp, kN, kCols, kBf16x3, kWhole>;
  static thread_local uint64_t opted_in = 0;
  const cudaError_t err = opt_in(kernel, S::kBytes, opted_in);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm;
  // f32 views, boxes of 32 columns (an atom), 128-byte swizzle
  int maps = tensor_map(&qm, q, B, H, T, D, 32, S::kRows, 1, 4);
  if (maps == 0) maps = tensor_map(&km, k, B, H, T, D, 32, kN, 1, 4);
  if (maps == 0) maps = tensor_map(&vm, v, B, H, T, D, 32, S::kK, 1, 4);
  if (maps != 0) return static_cast<cudaError_t>(maps);
  F32Params p;
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.T = T;
  p.D = D;
  p.c = scale * kLog2e;
  p.n_groups = C::kGroups;
  p.n_items = (T + S::kRows - 1) / S::kRows * C::kGroups;
  p.n_kt = (T + kN - 1) / kN;
  p.total = B * H * p.n_items;
  p.pairs = D % 2 == 0;  // out is (B, T, H, D) contiguous
  kernel<<<min(p.total, sm_count()), kThreads, S::kBytes, stream>>>(qm, km,
                                                                    vm, p);
  return cudaGetLastError();
}


// ---- past 128 columns: the streamed f32 forward ---------------------------
// Past the widest FWD_F32 row an item's q rows at the full width, held
// twice (big and small), no longer fit shared memory beside the ring.  The
// streamed instance (fwd_split_stream_kernel, the table's FWD_F32_STREAMED
// row) holds nothing at the full width:
//   * a split pass (split_qkv_kernel, one launch before the kernel, on the
//     same stream) writes q and K as TF32 big and small and V as its three
//     bf16 terms into a scratch the wrapper allocates, once a call, and TMA
//     reads the halves and terms from there: no stage of the ring is split
//     again (q would be split again for every key tile, K and V for every
//     query tile);
//   * a work item is (b * H + h, 64 query rows, a group of two column
//     chunks of o of kCols columns), both consumers on its rows, consumer
//     c holding chunk 2 * group + c of o in registers (StreamCut), its p.V
//     one product of up to 64 columns (kPart) at a time;
//   * s = q.k^T of a key tile is summed over 32-column chunks (an f32
//     atom) of q and K that come through the ring, each chunk's three TF32
//     products in a fresh accumulator added into s in f32, smallest
//     product first (small_first: wgmma truncates what it adds into an
//     accumulator);
//   * the two consumers share that sum: consumer c takes the chunks of its
//     parity (their number rounded up to even, the last a chunk of zeros),
//     and each adds the other's part through shared memory (one named
//     barrier a key tile), s = s_0 + s_1 in both, so s is computed once an
//     item and key tile, ceil(D / (2 kCols)) times a row in all;
//   * the softmax runs in both consumers on the same s (the TPU kernel's
//     safe_m guard, keys past T set to -inf only once s is summed over
//     every chunk), and p.V at the consumer's columns reads V's three bf16
//     terms, which come through a second ring; each key tile's p.V lands in
//     a fresh accumulator and is added into o in f32, o = o * corr + part.
// The converter warps of the producer warpgroup have nothing to split and
// leave at once.  Two calls give equal bits: no atomics, and the sums'
// order is fixed.

// The columns of the split pass's rows: q's and K's halves and V's terms
// are (B * H, T, round_up(D, kSplitCols)), zeros past D, so that every
// chunk of the ring, the rounded-up one included, lies in the scratch.
// ops/cuda/common.py reads this line.
constexpr int kSplitCols = 64;

__host__ __device__ constexpr int split_width(int D) {
  return (D + kSplitCols - 1) / kSplitCols * kSplitCols;
}

// The scratch of the split pass in floats: q's and K's big and small
// halves (f32) and V's three bf16 terms, 5.5 floats an element.
inline long long split_floats(int B, int H, int T, int D) {
  const long long n = static_cast<long long>(B) * H * T * split_width(D);
  return 2 * n + 2 * n + 3 * n / 2;
}

// q and K into TF32 big = rna(x) and small = rna(x - big), V into its three
// bf16 terms (as split_bf16x3), one (b, h, t) row a block, read through the
// views' strides (d's 1): qs and ks are (2, B * H, T, W) f32 (big, then
// small), vt (3, B * H, T, W) bf16, n = B * H * T * W elements apart.
__global__ void __launch_bounds__(128)
    split_qkv_kernel(const View q, const View k, const View v, float* qs,
                     float* ks, bf16* vt, int H, int T, int D, int W,
                     long long n) {
  const int row = blockIdx.x;  // bh * T + t
  const int bh = row / T, t = row - bh * T;
  const int b = bh / H, h = bh - b * H;
  auto at = [&](const View& x) {
    return static_cast<const float*>(x.base) + b * x.sb + h * x.sh +
           t * x.st;
  };
  const float* qr = at(q);
  const float* kr = at(k);
  const float* vr = at(v);
  const long long o = static_cast<long long>(row) * W;
  for (int d = threadIdx.x; d < W; d += blockDim.x) {
    const bool in = d < D;
    float big, small;
    split_tf32(in ? qr[d] : 0.f, big, small);
    qs[o + d] = big;
    qs[n + o + d] = small;
    split_tf32(in ? kr[d] : 0.f, big, small);
    ks[o + d] = big;
    ks[n + o + d] = small;
    const float x = in ? vr[d] : 0.f;
    const bf16 x1 = __float2bfloat16_rn(x);
    const float r = x - __bfloat162float(x1);
    const bf16 x2 = __float2bfloat16_rn(r);
    vt[o + d] = x1;
    vt[n + o + d] = x2;
    vt[2 * n + o + d] = __float2bfloat16_rn(r - __bfloat162float(x2));
  }
}

// Shared memory of a streamed instance: kStages stages of a 32-column chunk
// of the item's 64 q rows and of a K tile (kN rows), big then small, as TMA
// lands them; kOutStages stages of V's three bf16 terms at both consumers'
// columns, p.V's B (two stages where they leave room for two of the ring,
// else one); two buffers of both consumers' parts of s; the barriers.
template <int kN, int kCols>
struct FwdStreamShape {
  static constexpr int kRows = 64;                // query rows an item
  static constexpr int kQBytes = kRows * 128;     // a chunk of q
  static constexpr int kKBytes = kN * 128;        // a chunk of K
  static constexpr int kKOff = kQBytes;           // within a stage
  static constexpr int kRawBytes = kQBytes + kKBytes;
  static constexpr int kStageBytes = 2 * kRawBytes;  // big, then small
  using A = Atoms<kCols>;                         // p.V's B, bf16
  // the columns of one p.V product (Tf32's and the registers' limit)
  static constexpr int kPart = kCols < 64 ? kCols : 64;
  // p.V's B of a consumer: V's bf16 terms, this far apart
  static constexpr int kApart = 2 * kN * kCols;
  static constexpr int kBBytes = 3 * kApart;
  static constexpr int kOutBytes = 2 * kBBytes;
  // [buffer][consumer][register][thread] floats
  static constexpr int kXBytes = 2 * 2 * (kN / 2) * 128 * 4;
  // two stages of V where they leave room for two of the ring
  static constexpr int kOutStages =
      kSmemBudget - 2 * kOutBytes - kXBytes >= 2 * kStageBytes ? 2 : 1;
  // as many stages as fit, at most 6
  static constexpr int kFit =
      (kSmemBudget - kOutStages * kOutBytes - kXBytes) / kStageBytes;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kOutOff = kStages * kStageBytes;
  static constexpr int kXOff = kOutOff + kOutStages * kOutBytes;
  static constexpr int kBarOff = kXOff + kXBytes;
  static constexpr int kBytes =
      kBarOff + 8 * 2 * (kStages + kOutStages) + 1024;
  static_assert(kN % 16 == 0 && kN <= 64, "key tile: whole k16 steps");
  static_assert(kCols % kPart == 0 && kPart % 32 == 0,
                "whole f32 atoms, products of Tf32's N");
  static_assert(kStages >= 2, "a ring of at least two stages");
  // the chunks of a key tile's sum over D, rounded up to even: one half
  // each consumer
  static __host__ __device__ int sums(int D) {
    return ((D + 31) / 32 + 1) / 2 * 2;
  }
};

template <int kN, int kCols>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_split_stream_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const F32Params p) {
  using S = FwdStreamShape<kN, kCols>;
  using A = typename S::A;
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
  const int n_dc = S::sums(p.D);  // stages of the ring a key tile
  const StreamCut cut{(p.D + kCols - 1) / kCols};

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps / 2);  // a stage is one consumer's
    }
    for (int i = 0; i < kOutStages; ++i) {
      mbar_init(&out_full[i], 1);
      mbar_init(&out_empty[i], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31;
  if (role == kConsumerWGs) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    if (((threadIdx.x / 32) & 3) != 0 || lane != 0) return;
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    constexpr int kAtomBytes = kN * A::kRowBytes;  // V's term, an atom
    int st = 0, sph = 0, os = 0, oph = 0;
    for (int i = 0; i < items; ++i) {
      const Item it(p, blockIdx.x + i * gridDim.x);
      const int q0 = it.tile * S::kRows;
      // the atoms of the consumers' chunks of o that hold columns < D
      // (atoms wholly past D feed only columns never stored)
      int atoms[2];
      for (int c = 0; c < 2; ++c)
        atoms[c] = cut.stores(it.group, c)
                       ? min(kCols / A::kCols,
                             (p.D - cut.chunk(it.group, c) * kCols +
                              A::kCols - 1) / A::kCols)
                       : 0;
      for (int j = 0; j < p.n_kt; ++j) {
        const int k0 = (p.n_kt - 1 - j) * kN;  // last tile first
        for (int d = 0; d < n_dc; ++d) {
          mbar_wait(&empty[st], sph ^ 1);  // a fresh barrier passes at once
          uint8_t* dst = smem + st * S::kStageBytes;
          mbar_expect_tx(&full[st], S::kStageBytes);
          for (int x = 0; x < 2; ++x) {  // big (0) and small (1) halves
            tma_load_4d(dst + x * S::kRawBytes, &qmap, &full[st], 32 * d,
                        it.bh, q0, x);
            tma_load_4d(dst + x * S::kRawBytes + S::kKOff, &kmap, &full[st],
                        32 * d, it.bh, k0, x);
          }
          if (++st == kStages) st = 0, sph ^= 1;
        }
        mbar_wait(&out_empty[os], oph ^ 1);
        mbar_expect_tx(&out_full[os], 3 * (atoms[0] + atoms[1]) * kAtomBytes);
        uint8_t* out = smem + S::kOutOff + os * S::kOutBytes;
        for (int c = 0; c < 2; ++c) {
          const int col0 = cut.chunk(it.group, c) * kCols;
          for (int a = 0; a < atoms[c]; ++a)
            for (int x = 0; x < 3; ++x)  // into the consumer's B, term x
              tma_load_4d(out + c * S::kBBytes + x * S::kApart +
                              a * kAtomBytes,
                          &vmap, &out_full[os], col0 + A::kCols * a, it.bh,
                          k0, x);
        }
        if (++os == kOutStages) os = 0, oph ^= 1;
      }
    }
    return;
  }

  // ---- consumers: both on the item's 64 rows, each its chunk of o ----
  const int c = role;
  const int warp = (threadIdx.x / 32) & 3;
  const int t = lane & 3;
  const int tid = threadIdx.x & 127;

  constexpr int kPart = S::kPart;
  float s[kN / 2], sp[kN / 2];           // s, a chunk's part of it
  float o[kCols / 2], part[kPart / 2];   // o, a key tile's part of it
  GradFrags<kN, true> pf;                // p as p.V's A fragments
  float m[2], l[2], corr[2], cp[2];      // cp: the corr of part's tile
  float* xbuf = reinterpret_cast<float*>(smem + S::kXOff);

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  const int own = n_dc / 2;  // the consumer's chunks: c, c + 2, ...
  unsigned seq = 0;  // the ring's first stage of this key tile, in order
  int os = 0, oph = 0, par = 0;
  // the consumer's part of s = q.k^T of one key tile, over its chunks,
  // each chunk's products in a fresh accumulator added into s in f32, each
  // stage released once its products are done
  auto logits = [&]() {
#pragma unroll
    for (int x = 0; x < kN / 2; ++x) s[x] = 0.f;
    for (int i = 0; i < own; ++i) {
      const unsigned at = seq + 2 * i + c;
      const int st = static_cast<int>(at % kStages);
      mbar_wait(&full[st], static_cast<int>((at / kStages) & 1));
      const uint32_t big = smem_u32(smem + st * S::kStageBytes);
      const uint32_t small = big + S::kRawBytes;
      fence_regs(sp);
      wg_fence();
      product_ss_tf32<32, kN, true>(sp, big, small, S::kRows,
                                    big + S::kKOff, small + S::kKOff);
      wg_commit();
      wg_wait<0>();
      fence_regs(sp);
      release(&empty[st]);
      add_part(s, sp);
    }
    seq += n_dc;
  };
  // s = s_0 + s_1 in both consumers, the other's part through shared
  // memory (a buffer a key tile, two in turn: one barrier a tile)
  auto exchange = [&]() {
    float* mine = xbuf + ((par * 2 + c) * (kN / 2)) * 128 + tid;
    const float* other =
        xbuf + ((par * 2 + (c ^ 1)) * (kN / 2)) * 128 + tid;
#pragma unroll
    for (int x = 0; x < kN / 2; ++x) mine[x * 128] = s[x];
    bar_sync(1, 256);
#pragma unroll
    for (int x = 0; x < kN / 2; ++x) s[x] += other[x * 128];
    par ^= 1;
  };
  // part = p.V of the oldest V tile of the second ring over kPart of the
  // consumer's columns, from column x0 of its chunk
  auto product = [&](int x0) {
    fence_regs(part);
    pf.fence();
    wg_fence();
    pf.template product<kCols, kPart>(
        part,
        smem_u32(smem + S::kOutOff + os * S::kOutBytes + c * S::kBBytes),
        S::kApart, x0);
    wg_commit();
  };
  // o = o * corr of part's tile + part, in f32, at those columns
  auto fold = [&](int x0) {
    wg_wait<0>();
    fence_regs(part);
    pf.fence();
#pragma unroll
    for (int n = 0; n < kPart / 8; ++n) {
      float* y = o + x0 / 2 + 4 * n;
      y[0] = fmaf(y[0], cp[0], part[4 * n]);
      y[1] = fmaf(y[1], cp[0], part[4 * n + 1]);
      y[2] = fmaf(y[2], cp[1], part[4 * n + 2]);
      y[3] = fmaf(y[3], cp[1], part[4 * n + 3]);
    }
  };
  // the first product of the oldest V tile, issued
  auto accumulate = [&]() {
    mbar_wait(&out_full[os], oph);
    product(0);
  };
  // the rest of its products, each folded into o as it ends
  auto accumulated = [&]() {
    fold(0);
#pragma unroll
    for (int x0 = kPart; x0 < kCols; x0 += kPart) {
      product(x0);
      fold(x0);
    }
    release(&out_empty[os]);
    if (++os == kOutStages) os = 0, oph ^= 1;
  };

  for (int i = 0; i < items; ++i) {
    const Item it(p, blockIdx.x + i * gridDim.x);
    const int row_w = it.tile * S::kRows + 16 * warp;  // the warp's first
    const int col0 = cut.chunk(it.group, c) * kCols;   // the consumer's
    // warp-uniform, and shown so to ptxas
    const bool warp_active = __shfl_sync(0xffffffffu, row_w < p.T, 0);
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int x = 0; x < kCols / 2; ++x) o[x] = 0.f;

    // Key tiles last to first; the first one taken, alone masked (once s
    // is summed over every chunk), is peeled off the loop.  In the loop the
    // p.V of the tile before runs while the consumers exchange their parts
    // of this tile's s, and is folded into o before this tile's softmax:
    // o, the p.V's fragments and its part are not live beside the
    // softmax's values (at 128 columns of o they would spill).
    logits();
    exchange();
    online_softmax<kN, true>(s, m, l, corr, p, (p.n_kt - 1) * kN, t,
                             warp_active);
    pf.split(s);
    cp[0] = corr[0];
    cp[1] = corr[1];
    for (int j = 1; j < p.n_kt; ++j) {
      logits();
      accumulate();
      exchange();
      accumulated();
      online_softmax<kN, false>(s, m, l, corr, p, 0, t, warp_active);
      cp[0] = corr[0];
      cp[1] = corr[1];
      pf.split(s);
    }
    accumulate();
    accumulated();

    // both consumers hold the same rows: the first writes lse; a clamped
    // chunk's copy is not stored
    store_o_f32<kCols>(o, m, l, p, it, row_w, col0,
                       cut.stores(it.group, c), c == 0, lane);
  }
}

// Launches the split pass into `scratch` (split_floats(B, H, T, D)
// floats), then fwd_split_stream_kernel<kN, kCols> on a persistent grid,
// one block an SM, both on the same stream.
template <int kN, int kCols>
cudaError_t launch_split_stream(const View& q, const View& k, const View& v,
                                void* out, void* lse, void* scratch, int B,
                                int H, int T, int D, float scale,
                                cudaStream_t stream) {
  using S = FwdStreamShape<kN, kCols>;
  using A = typename S::A;
  auto kernel = fwd_split_stream_kernel<kN, kCols>;
  static thread_local uint64_t opted_in = 0;
  const cudaError_t err = opt_in(kernel, S::kBytes, opted_in);
  if (err != cudaSuccess) return err;
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int W = split_width(D);
  const long long n = static_cast<long long>(B) * H * T * W;
  const long long st = static_cast<long long>(T) * W;
  float* qs = static_cast<float*>(scratch);
  float* ks = qs + 2 * n;
  bf16* vt = reinterpret_cast<bf16*>(ks + 2 * n);
  // (W, B * H, T, halves or terms): f32 boxes of 32 columns, 128-byte
  // swizzle; V's terms in atoms of the bf16 layout of kCols columns
  CUtensorMap qm, km, vm;
  int maps = tensor_map(&qm, View{qs, n, st, W}, 2, B * H, T, W, 32,
                        S::kRows, 1, 4);
  if (maps == 0)
    maps = tensor_map(&km, View{ks, n, st, W}, 2, B * H, T, W, 32, kN, 1, 4);
  if (maps == 0)
    maps = tensor_map(&vm, View{vt, n, st, W}, 3, B * H, T, W, A::kCols, kN,
                      A::kSwizzle, 2);
  if (maps != 0) return static_cast<cudaError_t>(maps);
  split_qkv_kernel<<<B * H * T, 128, 0, stream>>>(q, k, v, qs, ks, vt, H, T,
                                                  D, W, n);
  const cudaError_t split = cudaGetLastError();
  if (split != cudaSuccess) return split;
  F32Params p;
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.T = T;
  p.D = D;
  p.c = scale * kLog2e;
  p.n_groups = ((D + kCols - 1) / kCols + 1) / 2;
  p.n_items = (T + S::kRows - 1) / S::kRows * p.n_groups;
  p.n_kt = (T + kN - 1) / kN;
  p.total = B * H * p.n_items;
  p.pairs = D % 2 == 0;  // out is (B, T, H, D) contiguous
  kernel<<<min(p.total, sm_count()), kThreads, S::kBytes, stream>>>(qm, km,
                                                                    vm, p);
  return cudaGetLastError();
}

// The FWD_F32 row's width that holds a head of D columns (the first >= D),
// 0 past the widest: there the FWD_F32_STREAMED row runs.
constexpr int f32_width(int D) {
#define TILED(w, n, pp)
#define CHUNKED(w, n, cols, pp)
#define STREAMED(w, n, cols)
#define WHOLE(w, n)
#define FWD_F32(w, n, cols, bf16x3) \
  if (D <= w) return w;
#define WHOLE_F32(w, n)
#include "forward_tiles.cuh"
#undef TILED
#undef CHUNKED
#undef STREAMED
#undef WHOLE
#undef FWD_F32
#undef WHOLE_F32
  return 0;
}

// The columns of o a consumer holds, and p.V's route, of a width's row.
constexpr int f32_cols(int width) {
#define TILED(w, n, pp)
#define CHUNKED(w, n, cols, pp)
#define STREAMED(w, n, cols)
#define WHOLE(w, n)
#define FWD_F32(w, n, cols, bf16x3) \
  if (width == w) return cols;
#define WHOLE_F32(w, n)
#include "forward_tiles.cuh"
#undef TILED
#undef CHUNKED
#undef STREAMED
#undef WHOLE
#undef FWD_F32
#undef WHOLE_F32
  return width;
}
constexpr bool f32_bf16x3(int width) {
#define TILED(w, n, pp)
#define CHUNKED(w, n, cols, pp)
#define STREAMED(w, n, cols)
#define WHOLE(w, n)
#define FWD_F32(w, n, cols, bf16x3) \
  if (width == w) return bf16x3 != 0;
#define WHOLE_F32(w, n)
#include "forward_tiles.cuh"
#undef TILED
#undef CHUNKED
#undef STREAMED
#undef WHOLE
#undef FWD_F32
#undef WHOLE_F32
  return false;
}

// The scratch (floats) the f32 forward at (B, H, T, D) wants: the split
// pass's past the widest FWD_F32 row, else none.
inline long long f32_scratch_floats(int B, int H, int T, int D) {
  return f32_width(D) != 0 ? 0 : split_floats(B, H, T, D);
}

// The tiled f32 forward at any D: the first FWD_F32 row of width >= D,
// past the widest the FWD_F32_STREAMED row.
inline cudaError_t launch_f32_tiled(const View& q, const View& k,
                                    const View& v, void* out, void* lse,
                                    void* scratch, int B, int H, int T, int D,
                                    float scale, cudaStream_t stream) {
#define TILED(w, n, pp)
#define CHUNKED(w, n, cols, pp)
#define STREAMED(w, n, cols)
#define WHOLE(w, n)
#define FWD_F32(w, n, cols, bf16x3)                                       \
  if (D <= w)                                                             \
    return launch_split<w, n, cols, bf16x3 != 0, false>(                  \
        q, k, v, out, lse, scratch, B, H, T, D, scale, stream);
#define WHOLE_F32(w, n)
#define FWD_F32_STREAMED(n, cols)                                         \
  return launch_split_stream<n, cols>(q, k, v, out, lse, scratch, B, H, T, \
                                      D, scale, stream);
#include "forward_tiles.cuh"
#undef TILED
#undef CHUNKED
#undef STREAMED
#undef WHOLE
#undef FWD_F32
#undef WHOLE_F32
  return cudaErrorInvalidValue;  // a table without a FWD_F32_STREAMED row
}

// The whole head as one key tile: the first WHOLE_F32 row of the head's
// width whose keys hold round_up(T, 8); else the tiled f32 forward.
inline cudaError_t launch_f32_whole_or_tiled(const View& q, const View& k,
                                             const View& v, void* out,
                                             void* lse, void* scratch, int B,
                                             int H, int T, int D, float scale,
                                             cudaStream_t stream) {
  const int width = f32_width(D);
  const int keys = (T + 7) / 8 * 8;
#define TILED(w, n, pp)
#define CHUNKED(w, n, cols, pp)
#define STREAMED(w, n, cols)
#define WHOLE(w, n)
#define FWD_F32(w, n, cols, bf16x3)
#define WHOLE_F32(w, n)                                                   \
  if (width == w && keys <= n)                                            \
    return launch_split<w, n, f32_cols(w), f32_bf16x3(w), true>(          \
        q, k, v, out, lse, scratch, B, H, T, D, scale, stream);
#include "forward_tiles.cuh"
#undef TILED
#undef CHUNKED
#undef STREAMED
#undef WHOLE
#undef FWD_F32
#undef WHOLE_F32
  return launch_f32_tiled(q, k, v, out, lse, scratch, B, H, T, D, scale,
                          stream);
}

}  // namespace
}  // namespace attn_wg
