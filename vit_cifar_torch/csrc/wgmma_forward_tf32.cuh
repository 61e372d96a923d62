// The f32 attention forward (dtype 0) up to 128 columns on TF32 wgmma,
// which flash_fwd.cu (tiled) and mhsa_fwd.cu (the whole head as one key
// tile where a consumer holds it, else tiled) launch, with and without lse.
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
// next does.  Tiles and routes by width: forward_tiles.cuh's FWD_F32 and
// WHOLE_F32 rows.
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
                         void* out, void* lse, int B, int H, int T, int D,
                         float scale, cudaStream_t stream) {
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

// The FWD_F32 row's width that holds a head of D columns (the first >= D),
// 0 past the widest: there the CUDA-core column-chunk tile runs.
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

// The tiled f32 forward up to the widest FWD_F32 row: the first row of
// width >= D (f32_width(D) != 0, which the caller checks).
inline cudaError_t launch_f32_tiled(const View& q, const View& k,
                                    const View& v, void* out, void* lse,
                                    int B, int H, int T, int D, float scale,
                                    cudaStream_t stream) {
#define TILED(w, n, pp)
#define CHUNKED(w, n, cols, pp)
#define STREAMED(w, n, cols)
#define WHOLE(w, n)
#define FWD_F32(w, n, cols, bf16x3)                                       \
  if (D <= w)                                                             \
    return launch_split<w, n, cols, bf16x3 != 0, false>(                  \
        q, k, v, out, lse, B, H, T, D, scale, stream);
#define WHOLE_F32(w, n)
#include "forward_tiles.cuh"
#undef TILED
#undef CHUNKED
#undef STREAMED
#undef WHOLE
#undef FWD_F32
#undef WHOLE_F32
  return cudaErrorInvalidValue;
}

// The whole head as one key tile: the first WHOLE_F32 row of the head's
// width whose keys hold round_up(T, 8); else the tiled f32 forward.
inline cudaError_t launch_f32_whole_or_tiled(const View& q, const View& k,
                                             const View& v, void* out,
                                             void* lse, int B, int H, int T,
                                             int D, float scale,
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
        q, k, v, out, lse, B, H, T, D, scale, stream);
#include "forward_tiles.cuh"
#undef TILED
#undef CHUNKED
#undef STREAMED
#undef WHOLE
#undef FWD_F32
#undef WHOLE_F32
  return launch_f32_tiled(q, k, v, out, lse, B, H, T, D, scale, stream);
}

}  // namespace
}  // namespace attn_wg
