// The warp-specialised bf16 attention forward that flash_fwd.cu and
// mhsa_fwd.cu launch, on the building blocks of wgmma_blocks.cuh: q, k and
// v read in place through TMA tensor maps over the caller's (B, H, T, D)
// views; s = q.k^T reads both operands from shared memory (K-major); o +=
// p.v takes p from registers and V from shared memory (MN-major).  Two
// consumer warpgroups of 64 query rows each, 128 rows a work item.  A
// head of up to 256 columns (wgmma's widest N) is one pass: a consumer
// holds all its columns of o.  Past 256 columns, up to 512, o is cut into
// column chunks of at most 256, a work item each (the CHUNKED rows of
// forward_tiles.cuh): s = q.k^T is summed over the whole head from q and
// K tiles at full width, and only the item's chunk of V is brought, so an
// item costs the one-pass instance's registers.  Past the table's widest
// row the streamed instance (fwd_stream_kernel, the STREAMED rows) sums s
// over column chunks of q and K that come through the ring, so that
// nothing in shared memory grows with D.  At the widths where it
// was measured to win (forward_tiles.cuh), two named barriers make the
// consumers take turns issuing their products (ping-pong), so that one
// warpgroup's softmax runs on the CUDA cores while the other's products
// run on the tensor cores; inside a warpgroup the p.v of one key tile runs
// while the softmax of the next does.  The producer brings the next item's
// K and V while this one computes, and its q too where two query buffers
// fit (up to 256 columns; past them once this item's last products have
// read its q).
//
// The key tiles of a work item are taken last to first: the first one
// taken holds the keys past T and is the only one masked (a select, and no
// exps for a block of 8 keys wholly past T).
//
// Numerics: s = q.k^T of bf16 values summed in f32; the online softmax
// keeps the running max m of the scaled logits (log2 units: c =
// scale*log2(e)), the normaliser l and the context o in f32 registers,
// with the TPU kernel's safe_m/corr guard for a fully masked tile; the
// max is taken on the raw logits and scaled once a row, and each exponent
// is one FFMA into ex2, exp2(s*c - m); p is split into bf16 hi = rn(p) and
// lo = rn(p - hi), and both go through the tensor cores, so p.v keeps p at
// f32 accuracy as the TPU kernel keeps it in f32.
// lse is returned in natural log: m * ln(2) + log(l).

#pragma once

#include "wgmma_blocks.cuh"

namespace attn_wg {
namespace {

// ---- the forward kernel ----------------------------------------------------
// Shared memory of one instance: kQBufs query tiles (kTileQ rows of the
// padded width kDp), then kStages stages of a K tile (kN rows, kDp
// columns) and a V tile (kKV rows, kN rounded up to the 16-key depth of
// p.v, and the kCols columns of an item's chunk of o), then the barriers.
// Each tile is swizzle atoms of kAtomCols columns side by side, an atom's
// rows kRowBytes apart.
template <int kDp, int kN, int kQBufs, int kCols>
struct Shape {
  static constexpr int kKV = (kN + 15) / 16 * 16;
  static constexpr int kAtomCols = kDp == 32 ? 32 : 64;
  static constexpr int kAtoms = kDp / kAtomCols;    // of a q or K tile
  static constexpr int kVAtoms = kCols / kAtomCols;  // of a V tile
  static constexpr int kRowBytes = 2 * kAtomCols;
  static constexpr uint32_t kSwizzle = kDp == 32 ? 2 : 1;  // 64 B : 128 B
  static constexpr int kQBytes = 2 * kTileQ * kDp;
  static constexpr int kKBytes = 2 * kN * kDp;
  static constexpr int kVAtomBytes = kKV * kRowBytes;
  static constexpr int kVBytes = kVAtoms * kVAtomBytes;
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
  static_assert(kCols <= kDp && kCols <= 256 && kCols % kAtomCols == 0,
                "columns of o a consumer holds: wgmma's N, whole atoms");
  static_assert(kN % 8 == 0 && kN <= 256, "key tile");
  static_assert(kStages >= 2, "a ring of at least two stages");
};

// The query buffers of an instance: two (the next item's q arrives while
// this one computes) where they leave room for two stages of the ring,
// else one (q at full width past 256 columns).
constexpr int q_buffers(int dp, int n, int cols) {
  return 2 * (2 * kTileQ * dp) +
                     2 * (2 * n * dp + 2 * ((n + 15) / 16 * 16) * cols) <=
                 kSmemBudget
             ? 2
             : 1;
}

// One launch's scalars.  The work items are the (b * H + h, query tile,
// column chunk) triples, n_qt tiles of kTileQ rows a head and n_ch chunks
// of o a tile, in that order; the grid is persistent: block x takes items
// x, x + gridDim.x, ...  Neighbouring blocks thus take the chunks of one
// query tile at once, and its q and K tiles come from L2 for all but one.
struct Params {
  bf16* out;     // (B, T, H, D)
  float* lse;    // (B, H, T), or null
  int H, T, D;
  float scale;   // softmax scale
  float c;       // scale * log2(e)
  int n_qt;      // query tiles a head
  int n_kt;      // key tiles a head
  int n_ch;      // column chunks of o a query tile (1: one pass)
  int total;     // work items
};

// A work item's place: item = (bh * n_qt + qt) * n_ch + ch.
struct Place {
  int b, h, bh, qt, ch;
  template <bool kChunked>
  __device__ static Place of(const Params& p, int item) {
    Place w;
    w.ch = kChunked ? item % p.n_ch : 0;
    const int rest = kChunked ? item / p.n_ch : item;
    w.bh = rest / p.n_qt;
    w.qt = rest - w.bh * p.n_qt;
    w.b = w.bh / p.H;
    w.h = w.bh - w.b * p.H;
    return w;
  }
};

// ---- what both forward kernels do on a tile's accumulators ---------------
// The online softmax of one key tile on the accumulator registers s (kN
// keys of this thread's rows g and g+8, lane 4g + t): the running max m of
// the scaled logits (log2 units), the normaliser l and the history's
// rescale factor corr, with the TPU kernel's safe_m guard (a tile of -inf
// logits keeps m at -inf; exp(-inf - -inf) would be NaN).  p replaces s.
// In the first tile taken (kMasked, keys from k0) keys past T get -inf by
// a select and a block of 8 keys wholly past T computes no exps (p = 0); a
// warp whose rows all lie past T computes none at all.
// p is the launch's scalars (Params, or the f32 forward's F32Params: T and
// c are read).
template <int kN, bool kMasked, typename P>
__device__ __forceinline__ void online_softmax(float (&s)[kN / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2],
                                               const P& p, int k0,
                                               int t, bool warp_active) {
  constexpr int kNB = kN / 8;  // 8-key blocks of s
  if (warp_active) {
    if constexpr (kMasked) {  // keys past T
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
      // the row max of the scaled logits, rn(max(s) * c) = max(rn(s * c)),
      // in log2 units
      const float m_new = fmaxf(m[r], mx[r] * p.c);
      const float safe = isfinite(m_new) ? m_new : 0.f;
      corr[r] = isfinite(m[r]) ? ex2(m[r] - safe) : 0.f;
      m[r] = m_new;
      mc[r] = safe;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      // in the masked tile, a block of 8 keys all past T (a uniform test)
      // computes no exps: p = 0
      if (kMasked && k0 + 8 * nb >= p.T) {
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
}

// p (in s) as the bf16 hi and lo A fragments of p.v's kPV k16 steps; keys
// past the tile's kN get p = 0.
template <int kN, int kPV>
__device__ __forceinline__ void split_p(const float (&s)[kN / 2],
                                        uint32_t (&ph)[kPV][4],
                                        uint32_t (&pl)[kPV][4]) {
#pragma unroll
  for (int kk = 0; kk < kPV; ++kk) {
    split_bf16(s[8 * kk], s[8 * kk + 1], ph[kk][0], pl[kk][0]);
    split_bf16(s[8 * kk + 2], s[8 * kk + 3], ph[kk][1], pl[kk][1]);
    if (2 * kk + 1 < kN / 8) {
      split_bf16(s[8 * kk + 4], s[8 * kk + 5], ph[kk][2], pl[kk][2]);
      split_bf16(s[8 * kk + 6], s[8 * kk + 7], ph[kk][3], pl[kk][3]);
    } else {  // keys past the tile's kN: p = 0
      ph[kk][2] = ph[kk][3] = pl[kk][2] = pl[kk][3] = 0u;
    }
  }
}

// o / l to the item's kCols columns of (B, T, H, D) bf16 (the chunk's on,
// from the warp's first row row_w), lse = m * ln(2) + log(l) to (B, H, T)
// f32 by the first chunk.  o is read outside any branch (a divergent read
// of an accumulator serialises the wgmmas); the stores are predicated.
template <int kCols>
__device__ __forceinline__ void store_o(const float (&o)[kCols / 2],
                                        const float (&m)[2],
                                        const float (&l)[2], const Params& p,
                                        const Place& w, int row_w,
                                        bool warp_active, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / lt;  // inf for rows past T, never stored
    __nv_bfloat162 packed[kCols / 8];
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n)
      packed[n] = __floats2bfloat162_rn(o[4 * n + 2 * r] * inv,
                                        o[4 * n + 2 * r + 1] * inv);
    const int row = row_w + g + 8 * r;
    if (!warp_active || row >= p.T) continue;
    bf16* orow = p.out +
                 ((static_cast<int64_t>(w.b) * p.T + row) * p.H + w.h) *
                     p.D +
                 w.ch * kCols;
    const int cols = p.D - w.ch * kCols;  // the head's, from the chunk's on
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d + 1 < cols && (p.D & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = packed[n];
      } else {
        if (d < cols) orow[d] = packed[n].x;
        if (d + 1 < cols) orow[d + 1] = packed[n].y;
      }
    }
    if (p.lse != nullptr && t == 0 && w.ch == 0)
      p.lse[static_cast<int64_t>(w.bh) * p.T + row] =
          m[r] * 0.6931471805599453f + logf(lt);
  }
}

template <int kDp, int kN, int kQBufs, bool kPingpong, int kCols>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const Params p) {
  using S = Shape<kDp, kN, kQBufs, kCols>;
  constexpr int kStages = S::kStages;
  constexpr bool kChunked = kCols < kDp;
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
      const Place w = Place::of<kChunked>(p, blockIdx.x + i * gridDim.x);
      mbar_wait(&q_empty[qb], qph ^ 1);  // a fresh barrier passes at once
      mbar_expect_tx(&q_full[qb], S::kQBytes);
      for (int a = 0; a < S::kAtoms; ++a)
        tma_load_4d(smem + qb * S::kQBytes + a * kTileQ * S::kRowBytes,
                    &qmap, &q_full[qb], a * S::kAtomCols, w.h,
                    w.qt * kTileQ, w.b);
      if (++qb == kQBufs) qb = 0, qph ^= 1;
      // the item's chunk of V; its atoms wholly past D are not brought:
      // they feed only columns of o that are never stored
      const int col0 = w.ch * kCols;
      const int v_atoms =
          kChunked ? min(S::kVAtoms,
                         (p.D - col0 + S::kAtomCols - 1) / S::kAtomCols)
                   : S::kVAtoms;
      for (int j = 0; j < p.n_kt; ++j) {
        mbar_wait(&kv_empty[stage], sph ^ 1);
        mbar_expect_tx(&kv_full[stage],
                       S::kKBytes + v_atoms * S::kVAtomBytes);
        uint8_t* kt = smem + S::kKOff + stage * S::kKBytes;
        uint8_t* vt = smem + S::kVOff + stage * S::kVBytes;
        const int k0 = (p.n_kt - 1 - j) * kN;  // last tile first
        for (int a = 0; a < S::kAtoms; ++a)
          tma_load_4d(kt + a * kN * S::kRowBytes, &kmap, &kv_full[stage],
                      a * S::kAtomCols, w.h, k0, w.b);
        for (int a = 0; a < v_atoms; ++a)
          tma_load_4d(vt + a * S::kVAtomBytes, &vmap, &kv_full[stage],
                      col0 + a * S::kAtomCols, w.h, k0, w.b);
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
  const int t = lane & 3;
  [[maybe_unused]] const int my_turn = 1 + c, other_turn = 2 - c;
  constexpr int kPV = S::kKV / 16;   // k16 steps of p.v
  constexpr uint32_t kSbo = 8 * S::kRowBytes;

  float s[kN / 2];
  float o[kCols / 2];
  uint32_t ph[kPV][4], pl[kPV][4];
  float m[2], l[2], corr[2];

  // o += p.v of the key tile in `stage`, p = hi + lo
  auto pv = [&](int stage) {
    const uint32_t vb = smem_u32(smem + S::kVOff + stage * S::kVBytes);
#pragma unroll
    for (int kk = 0; kk < kPV; ++kk) {
      const uint64_t d = make_desc(vb + kk * 16 * S::kRowBytes,
                                   S::kKV * S::kRowBytes, kSbo, S::kSwizzle);
      Wgmma<kCols>::rs(o, ph[kk], d);
      Wgmma<kCols>::rs(o, pl[kk], d);
    }
  };
  auto rescale = [&]() {
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
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
    const Place w = Place::of<kChunked>(p, blockIdx.x + i * gridDim.x);
    const int row_wg = w.qt * kTileQ + 64 * c;
    // warp-uniform, and shown so to ptxas: a branch it takes for divergent
    // around the accumulator registers serialises the wgmmas
    const bool warp_active =
        __shfl_sync(0xffffffffu, row_wg + 16 * warp < p.T, 0);
    const uint32_t qa =
        smem_u32(smem + qb * S::kQBytes) + 64 * c * S::kRowBytes;
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int x = 0; x < kCols / 2; ++x) o[x] = 0.f;
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

    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    mbar_wait(&kv_full[stage], sph);
    products(stage, 0, std::false_type{});
    if (p.n_kt == 1) release(&q_empty[qb]);  // q is no longer read
    online_softmax<kN, true>(s, m, l, corr, p, (p.n_kt - 1) * kN, t,
                             warp_active);
    split_p<kN, kPV>(s, ph, pl);
    int prev = stage;
    if (++stage == kStages) stage = 0, sph ^= 1;
    for (int j = 1; j < p.n_kt; ++j) {
      mbar_wait(&kv_full[stage], sph);
      products(stage, prev, std::true_type{});
      if (j == p.n_kt - 1) release(&q_empty[qb]);
      online_softmax<kN, false>(s, m, l, corr, p, 0, t, warp_active);
      wg_wait<0>();  // the p.v of the tile before is done
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
      release(&kv_empty[prev]);
      split_p<kN, kPV>(s, ph, pl);
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

    store_o<kCols>(o, m, l, p, w, row_wg + 16 * warp, warp_active, lane);
    if (++qb == kQBufs) qb = 0, qph ^= 1;
  }
}

// Launches fwd_kernel<kDp, kN, kQBufs, kPingpong, kCols> on q, k, v: a
// persistent grid, one block an SM.
template <int kDp, int kN, int kQBufs, bool kPingpong, int kCols>
cudaError_t launch(const View& q, const View& k, const View& v, void* out,
                   void* lse, int B, int H, int T, int D, float scale,
                   cudaStream_t stream) {
  using S = Shape<kDp, kN, kQBufs, kCols>;
  auto kernel = fwd_kernel<kDp, kN, kQBufs, kPingpong, kCols>;
  static thread_local uint64_t opted_in = 0;
  const cudaError_t err = opt_in(kernel, S::kBytes, opted_in);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm;
  int maps =
      tensor_map(&qm, q, B, H, T, D, S::kAtomCols, kTileQ, S::kSwizzle);
  if (maps == 0)
    maps = tensor_map(&km, k, B, H, T, D, S::kAtomCols, kN, S::kSwizzle);
  if (maps == 0)
    maps = tensor_map(&vm, v, B, H, T, D, S::kAtomCols, S::kKV, S::kSwizzle);
  if (maps != 0) return static_cast<cudaError_t>(maps);
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
  p.n_ch = (D + kCols - 1) / kCols;
  p.total = B * H * p.n_qt * p.n_ch;
  kernel<<<min(p.total, sm_count()), kThreads, S::kBytes, stream>>>(qm, km,
                                                                    vm, p);
  return cudaGetLastError();
}

// ---- the streamed forward: heads past the table ----------------------------
// fwd_kernel holds an item's q and a K tile at the full width in shared
// memory, and at 704 columns they stop fitting beside two stages of the
// ring.  Here the sum over D of s = q.k^T is streamed instead: each stage
// of the ring holds one column chunk -- a swizzle atom of 64 columns -- of
// the item's 128 query rows and the same chunk of a K tile, and the
// consumers add each chunk's product into s in their registers, so that
// shared memory does not grow with D and any width runs.  o is cut into
// chunks of kCols columns, a work item each, as in the CHUNKED rows; the
// item's chunk of V comes through a ring of its own (kVStages), so that
// the p.v of one key tile runs while the softmax of the next does.  q is
// brought again for every key tile: neighbouring blocks take the chunks of
// one query tile, and it comes from L2.
//
// Shared memory: kStages stages of a q chunk (kTileQ rows) and a K chunk
// (kN rows), then kVStages stages of a V tile (kKV rows, kCols columns),
// then the barriers.
template <int kN, int kCols>
struct StreamShape {
  static constexpr int kKV = (kN + 15) / 16 * 16;
  static constexpr int kAtomCols = 64;  // a chunk of the sum over D
  static constexpr int kRowBytes = 128;
  static constexpr uint32_t kSwizzle = 1;  // 128 B
  static constexpr int kQBytes = kTileQ * kRowBytes;
  static constexpr int kKBytes = kN * kRowBytes;
  static constexpr int kStageBytes = kQBytes + kKBytes;
  static constexpr int kVAtoms = kCols / kAtomCols;
  static constexpr int kVAtomBytes = kKV * kRowBytes;
  static constexpr int kVBytes = kVAtoms * kVAtomBytes;
  static constexpr int kVStages = 2;
  // as many stages as fit, at most 8
  static constexpr int kFit =
      (kSmemBudget - kVStages * kVBytes) / kStageBytes;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kVOff = kStages * kStageBytes;
  static constexpr int kBarOff = kVOff + kVStages * kVBytes;
  static constexpr int kBytes = kBarOff + 8 * 2 * (kStages + kVStages) + 1024;
  static_assert(kCols <= 256 && kCols % kAtomCols == 0,
                "columns of o a consumer holds: wgmma's N, whole atoms");
  static_assert(kN % 8 == 0 && kN <= 256, "key tile");
  static_assert(kStages >= 2, "a ring of at least two stages");
};

template <int kN, int kCols>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_stream_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const Params p) {
  using S = StreamShape<kN, kCols>;
  constexpr int kStages = S::kStages;
  constexpr int kVStages = S::kVStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBarOff);
  uint64_t* empty = full + kStages;
  uint64_t* v_full = empty + kStages;
  uint64_t* v_empty = v_full + kVStages;
  const int items =
      (p.total - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int n_dc = (p.D + S::kAtomCols - 1) / S::kAtomCols;  // chunks of D

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    for (int i = 0; i < kVStages; ++i) {
      mbar_init(&v_full[i], 1);
      mbar_init(&v_empty[i], kConsumerWarps);
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
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    int st = 0, sph = 0, vs = 0, vph = 0;
    for (int i = 0; i < items; ++i) {
      const Place w = Place::of<true>(p, blockIdx.x + i * gridDim.x);
      const int col0 = w.ch * kCols;
      // V atoms wholly past D feed only columns of o that are never stored
      const int v_atoms =
          min(S::kVAtoms, (p.D - col0 + S::kAtomCols - 1) / S::kAtomCols);
      for (int j = 0; j < p.n_kt; ++j) {
        const int k0 = (p.n_kt - 1 - j) * kN;  // last tile first
        for (int d = 0; d < n_dc; ++d) {
          mbar_wait(&empty[st], sph ^ 1);  // a fresh barrier passes at once
          mbar_expect_tx(&full[st], S::kStageBytes);
          uint8_t* dst = smem + st * S::kStageBytes;
          tma_load_4d(dst, &qmap, &full[st], d * S::kAtomCols, w.h,
                      w.qt * kTileQ, w.b);
          tma_load_4d(dst + S::kQBytes, &kmap, &full[st], d * S::kAtomCols,
                      w.h, k0, w.b);
          if (++st == kStages) st = 0, sph ^= 1;
        }
        mbar_wait(&v_empty[vs], vph ^ 1);
        mbar_expect_tx(&v_full[vs], v_atoms * S::kVAtomBytes);
        uint8_t* vt = smem + S::kVOff + vs * S::kVBytes;
        for (int a = 0; a < v_atoms; ++a)
          tma_load_4d(vt + a * S::kVAtomBytes, &vmap, &v_full[vs],
                      col0 + a * S::kAtomCols, w.h, k0, w.b);
        if (++vs == kVStages) vs = 0, vph ^= 1;
      }
    }
    return;
  }

  // ---- consumers: warpgroup c takes rows 64c .. 64c+63 of every item ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = role;
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  constexpr int kPV = S::kKV / 16;   // k16 steps of p.v
  constexpr uint32_t kSbo = 8 * S::kRowBytes;

  float s[kN / 2];
  float o[kCols / 2];
  uint32_t ph[kPV][4], pl[kPV][4];
  float m[2], l[2], corr[2];

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // s = q.k^T of one key tile, its column chunks in turn from the ring,
  // each stage released once its products are done
  int st = 0, sph = 0, vs = 0, vph = 0;
  auto logits = [&]() {
    for (int d = 0; d < n_dc; ++d) {
      mbar_wait(&full[st], sph);
      const uint32_t qa = smem_u32(smem + st * S::kStageBytes) +
                          64 * c * S::kRowBytes;
      const uint32_t kb = smem_u32(smem + st * S::kStageBytes + S::kQBytes);
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < S::kAtomCols / 16; ++kk)
        Wgmma<kN>::ss(s, make_desc(qa + 32 * kk, 16, kSbo, S::kSwizzle),
                      make_desc(kb + 32 * kk, 16, kSbo, S::kSwizzle),
                      d > 0 || kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      release(&empty[st]);
      if (++st == kStages) st = 0, sph ^= 1;
    }
  };
  // o += p.v of the oldest V stage, p = hi + lo; rescaled first
  auto pv = [&]() {
    mbar_wait(&v_full[vs], vph);
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      o[4 * n] *= corr[0];
      o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1];
      o[4 * n + 3] *= corr[1];
    }
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    wg_fence();
    const uint32_t vb = smem_u32(smem + S::kVOff + vs * S::kVBytes);
#pragma unroll
    for (int kk = 0; kk < kPV; ++kk) {
      const uint64_t d = make_desc(vb + kk * 16 * S::kRowBytes,
                                   S::kKV * S::kRowBytes, kSbo, S::kSwizzle);
      Wgmma<kCols>::rs(o, ph[kk], d);
      Wgmma<kCols>::rs(o, pl[kk], d);
    }
    wg_commit();
  };
  // the end of the p.v: its V stage released
  auto pv_done = [&]() {
    wg_wait<0>();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    release(&v_empty[vs]);
    if (++vs == kVStages) vs = 0, vph ^= 1;
  };

  for (int i = 0; i < items; ++i) {
    const Place w = Place::of<true>(p, blockIdx.x + i * gridDim.x);
    const int row_wg = w.qt * kTileQ + 64 * c;
    // warp-uniform, and shown so to ptxas
    const bool warp_active =
        __shfl_sync(0xffffffffu, row_wg + 16 * warp < p.T, 0);
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int x = 0; x < kCols / 2; ++x) o[x] = 0.f;

    // Key tiles last to first: the first one taken alone is masked, and
    // its turn is peeled off the loop.  In the loop the p.v of the tile
    // before runs while this tile's softmax does.
    logits();
    online_softmax<kN, true>(s, m, l, corr, p, (p.n_kt - 1) * kN, t,
                             warp_active);
    split_p<kN, kPV>(s, ph, pl);
    for (int j = 1; j < p.n_kt; ++j) {
      logits();
      pv();
      online_softmax<kN, false>(s, m, l, corr, p, 0, t, warp_active);
      pv_done();
      split_p<kN, kPV>(s, ph, pl);
    }
    pv();
    pv_done();

    store_o<kCols>(o, m, l, p, w, row_wg + 16 * warp, warp_active, lane);
  }
}

// Launches fwd_stream_kernel<kN, kCols> on q, k, v: a persistent grid, one
// block an SM.
template <int kN, int kCols>
cudaError_t launch_stream(const View& q, const View& k, const View& v,
                          void* out, void* lse, int B, int H, int T, int D,
                          float scale, cudaStream_t stream) {
  using S = StreamShape<kN, kCols>;
  auto kernel = fwd_stream_kernel<kN, kCols>;
  static thread_local uint64_t opted_in = 0;
  const cudaError_t err = opt_in(kernel, S::kBytes, opted_in);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm;
  int maps =
      tensor_map(&qm, q, B, H, T, D, S::kAtomCols, kTileQ, S::kSwizzle);
  if (maps == 0)
    maps = tensor_map(&km, k, B, H, T, D, S::kAtomCols, kN, S::kSwizzle);
  if (maps == 0)
    maps = tensor_map(&vm, v, B, H, T, D, S::kAtomCols, S::kKV, S::kSwizzle);
  if (maps != 0) return static_cast<cudaError_t>(maps);
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
  p.n_ch = (D + kCols - 1) / kCols;
  p.total = B * H * p.n_qt * p.n_ch;
  kernel<<<min(p.total, sm_count()), kThreads, S::kBytes, stream>>>(qm, km,
                                                                    vm, p);
  return cudaGetLastError();
}

// The instances, one table row each (forward_tiles.cuh): the tiled grid at
// a padded head width (in one pass, or in column chunks past 256 columns),
// the streamed grid past the widest row, and mhsa_fwd's whole-head grid.

// Whether the consumers of a width's instances take turns at the tensor
// cores (the tiled row's pingpong column).
constexpr bool pingpong_at(int width) {
#define TILED(w, n, pp) \
  if (width == w) return pp != 0;
#define CHUNKED(w, n, cols, pp)
#define STREAMED(w, n, cols)
#define WHOLE(w, n)
#define FWD_F32(w, n, cols, bf16x3)
#define WHOLE_F32(w, n)
#include "forward_tiles.cuh"
#undef TILED
#undef CHUNKED
#undef STREAMED
#undef WHOLE
#undef FWD_F32
#undef WHOLE_F32
  return true;
}

// The widest STREAMED row's width: it takes every wider head too.
constexpr int last_streamed() {
  int widest = 0;
#define TILED(w, n, pp)
#define CHUNKED(w, n, cols, pp)
#define STREAMED(w, n, cols) widest = w;
#define WHOLE(w, n)
#define FWD_F32(w, n, cols, bf16x3)
#define WHOLE_F32(w, n)
#include "forward_tiles.cuh"
#undef TILED
#undef CHUNKED
#undef STREAMED
#undef WHOLE
#undef FWD_F32
#undef WHOLE_F32
  return widest;
}

// The head width an instance holds: the first table width >= D, 0 past the
// widest (the streamed grid).
inline int padded_width(int D) {
#define TILED(w, n, pp) \
  if (D <= w) return w;
#define CHUNKED(w, n, cols, pp) \
  if (D <= w) return w;
#define STREAMED(w, n, cols)
#define WHOLE(w, n)
#define FWD_F32(w, n, cols, bf16x3)
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

// The tiled forward at any T and D: the first row of the head's width
// (its key tile and columns of o an item, one or two query buffers), past
// the widest the first streamed row of the head's width, or the last.
inline cudaError_t launch_tiled(const View& q, const View& k, const View& v,
                                void* out, void* lse, int B, int H, int T,
                                int D, float scale, cudaStream_t stream) {
#define TILED(w, n, pp)                                                     \
  if (D <= w)                                                               \
    return launch<w, n, q_buffers(w, n, w), pp != 0, w>(                    \
        q, k, v, out, lse, B, H, T, D, scale, stream);
#define CHUNKED(w, n, cols, pp)                                             \
  if (D <= w)                                                               \
    return launch<w, n, q_buffers(w, n, cols), pp != 0, cols>(              \
        q, k, v, out, lse, B, H, T, D, scale, stream);
#define STREAMED(w, n, cols)                                                \
  if (D <= w || w == last_streamed())                                       \
    return launch_stream<n, cols>(q, k, v, out, lse, B, H, T, D, scale,     \
                                  stream);
#define WHOLE(w, n)
#define FWD_F32(w, n, cols, bf16x3)
#define WHOLE_F32(w, n)
#include "forward_tiles.cuh"
#undef TILED
#undef CHUNKED
#undef STREAMED
#undef WHOLE
#undef FWD_F32
#undef WHOLE_F32
  return cudaErrorInvalidValue;  // a table without a STREAMED row
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
#define CHUNKED(w, n, cols, pp)
#define STREAMED(w, n, cols)
#define WHOLE(w, n)                                                         \
  if (width == w && keys <= n)                                              \
    return launch<w, n, 2, pingpong_at(w), w>(q, k, v, out, lse, B, H, T, \
                                              D, scale, stream);
#define FWD_F32(w, n, cols, bf16x3)
#define WHOLE_F32(w, n)
#include "forward_tiles.cuh"
#undef TILED
#undef CHUNKED
#undef STREAMED
#undef WHOLE
#undef FWD_F32
#undef WHOLE_F32
  return launch_tiled(q, k, v, out, lse, B, H, T, D, scale, stream);
}

}  // namespace
}  // namespace attn_wg
