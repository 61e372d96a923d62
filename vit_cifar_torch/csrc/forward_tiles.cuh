// The instances of the wgmma forward, one row each: bf16
// (wgmma_attention.cuh) and f32 on TF32 (wgmma_forward_tf32.cuh).  This one
// table is what the CUDA dispatch (flash_fwd.cu and mhsa_fwd.cu, through
// those headers) expands and what the wrappers' plans
// (ops/cuda/common.py::forward_plan, f32_forward_plan) and the CPU models
// read, so they cannot disagree.  No include guard: each includer defines
// the first six macros; FWD_F32_STREAMED, which only the f32 dispatch
// expands, is empty unless the includer defines it, and undefined after.
//
// TILED(width, keys, pingpong): the tiled grid at a padded head width in
//   one pass, the whole head's columns of o in a consumer -- the widest
//   key tile whose s, p and o fit a consumer warpgroup's 168 registers
//   with the products in flight, and whether the two consumer warpgroups
//   take turns at the tensor cores (ping-pong: on where
//   tools/forward_choices.py read it faster, 0.3-0.5% at 32 columns and
//   6-7% at 192; off where none was, 2% at 64, 4-8% at 128, 0-5% at 256).
// CHUNKED(width, keys, cols, pingpong): the tiled grid past 256 columns
//   (wgmma's widest N), o cut into chunks of `cols` columns, a work item
//   each (128 query rows and one chunk; the last chunk ragged).  s = q.k^T
//   is summed over the whole width from q and K tiles at full width; V
//   comes only for the item's chunk.  q (one buffer at full width) and at
//   least two stages of the ring fit shared memory: 64 keys fit at 320
//   columns, 32 at 384-512.  Each row is the fastest of
//   tools/forward_choices.py's measurements against half and twice its
//   key tile, chunks of 128, 192 and 256 columns and ping-pong flipped,
//   in three runs: at 448 and 512 columns 16 keys (four stages) read
//   0.93-0.96x the 32 (32 read 1.04-1.09x 16); at 384 ping-pong off
//   0.90x (on 1.05-1.08x off); every other neighbour 1.01-1.77x.  Both
//   16-key instances spill 8 bytes (16 loaded back).  At 192 and 256
//   columns the one pass beats chunks of 128 columns (which read 1.20x
//   and 1.58-1.61x).
//   Widths step by 64 columns, so no q or K box lies wholly past D.
//   Rows of both kinds by ascending width: a head of D columns takes the
//   first width >= D; past the last, the STREAMED row.
// STREAMED(width, keys, cols): the heads wider than the rows above: the
//   tiled grid with o cut into chunks of `cols` columns, a work item each,
//   and s = q.k^T summed over column chunks of 64 columns of q and of a K
//   tile of `keys` keys that come through the ring, so that shared memory
//   holds no q or K at full width (fwd_stream_kernel).  A head takes the
//   first STREAMED row of width >= D, and the last one every wider head,
//   so any width runs.  Each row is the fastest of
//   tools/forward_choices.py's measurements against half and twice its key
//   tile and chunks of 128, 192 and 256 columns at the widths it takes:
//   up to 576 columns three chunks of 192 (0.91x chunks of 256, which are
//   three too); past it chunks of 256 (0.73-0.82x chunks of 192, one
//   chunk fewer); 32 keys 1.38-1.51x, 128 serialised by ptxas; PR 17's
//   CHUNKED rows, q at full width, 1.65-1.73x at 576 and 640.
// WHOLE(width, keys): mhsa_fwd's whole-head instances, the head's
//   round_up(T, 8) keys as one tile of `keys` keys, the first row of the
//   head's width that holds them (past the last: the tiled grid).  Rows by
//   width, then ascending keys.  They take the TILED row's ping-pong.
// FWD_F32(width, keys, cols, bf16x3): the f32 forward up to 128 columns
//   (fwd_split_kernel), tiled: the key tile, the columns of o a consumer
//   holds and the route of p.V.  cols == width: a work item is 128 query
//   rows, 64 a consumer; cols < width: 64 rows, the two consumers on the
//   same rows, each its chunk of cols columns (both compute s).  q and
//   each key tile are split into TF32 big + small (four bytes a value,
//   twice), and s = q.k^T is three TF32 products; V, whose p.V sums over
//   keys (MN-major, which TF32 wgmma cannot read), is taken as three bf16
//   terms (bf16x3 1: six bf16 products with the transpose bit, a depth of
//   keys rounded up to 16) or as its TF32 transpose (0: three TF32
//   products).  A consumer holds o and the key tile's part of it, which
//   is added into o in f32 (wgmma_tf32.cuh, GradFrags), beside s and p's
//   fragments; so the tiles are smaller than the bf16 rows'.  The rows
//   are tools/forward_choices.py --only f32's measurements against half
//   and twice the key tile and the other route: at 32 columns 32 keys
//   read 1.12x (128 keys do not build: no Tf32<128>); at 64 columns 16
//   keys 1.24x and 64 keys 1.21x (they spill); at 128 columns 16 keys
//   0.99x, a tie within a run's spread (64 keys leave no second stage of
//   the ring); V's TF32 transpose 1.59-1.64x the bf16 terms everywhere.
// WHOLE_F32(width, keys): mhsa_fwd's f32 whole-head instances, the head's
//   round_up(T, 8) keys as one tile (no loop: s, p's fragments and o),
//   the first row of the head's width that holds them, as WHOLE; they take
//   the FWD_F32 row's columns and route.  Past them the tiled items.  A
//   row's q, two stages of K and V and their splits fit shared memory.  At
//   each width's last row the whole head read 1.45x (32 columns), 1.14x
//   (64) and 1.00x (128) faster than the tiled items
//   (tools/forward_choices.py --only f32, device ms at (128, 12, T, D)).
// FWD_F32_STREAMED(keys, cols): every f32 head wider than the FWD_F32
//   rows, at any width, both forwards (fwd_split_stream_kernel): a split
//   pass writes q and K as TF32 big + small and V as its three bf16 terms
//   into a scratch once a call, which TMA reads; a work item 64 query rows
//   and a group of two chunks of `cols` columns of o, one a consumer; s =
//   q.k^T summed over 32-column chunks of q and of a K tile of `keys` keys
//   that come through the ring, each chunk's three TF32 products added in
//   f32, the two consumers taking alternate chunks and adding each other's
//   part through shared memory, so s is computed once an item and key
//   tile; p.V at the consumer's columns on V's bf16 terms.  The row is the
//   fastest of tools/forward_choices.py --only f32s's measurements at
//   (128,8,512,192|256), (16,2,1024,520) and the wide-head model's
//   (128,2,257,192) (H100, PERF.md §6): 16 keys read 1.26-1.69x, 48 and 64
//   keys spill (not run); 64 columns of o a consumer 1.39-1.66x, 32
//   columns 1.77-2.79x (s is computed once per two chunks: 128 columns
//   halve it).  The 128 columns fit a consumer's 168 registers because the
//   p.V of a tile is folded into o before the next softmax (the kernel
//   says how).
#ifndef FWD_F32_STREAMED
#define FWD_F32_STREAMED(n, cols)
#endif

TILED(32, 128, 1)
TILED(64, 96, 0)
TILED(128, 64, 0)
TILED(192, 64, 1)
TILED(256, 32, 0)
CHUNKED(320, 64, 192, 1)
CHUNKED(384, 32, 192, 0)
CHUNKED(448, 16, 256, 0)
CHUNKED(512, 16, 256, 0)
STREAMED(576, 64, 192)
STREAMED(640, 64, 256)

WHOLE(32, 16)
WHOLE(32, 32)
WHOLE(32, 64)
WHOLE(32, 72)
WHOLE(32, 96)
WHOLE(32, 128)
WHOLE(64, 16)
WHOLE(64, 32)
WHOLE(64, 64)
WHOLE(64, 72)
WHOLE(64, 96)
WHOLE(128, 16)
WHOLE(128, 32)
WHOLE(128, 64)

FWD_F32(32, 64, 32, 1)
FWD_F32(64, 32, 64, 1)
FWD_F32(128, 32, 64, 1)
FWD_F32_STREAMED(32, 128)

WHOLE_F32(32, 16)
WHOLE_F32(32, 32)
WHOLE_F32(32, 64)
WHOLE_F32(32, 72)
WHOLE_F32(64, 16)
WHOLE_F32(64, 32)
WHOLE_F32(64, 64)
WHOLE_F32(128, 16)
WHOLE_F32(128, 32)

#undef FWD_F32_STREAMED
