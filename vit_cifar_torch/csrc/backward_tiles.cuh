// The instances of the wgmma backward pair, bf16 (wgmma_backward.cuh) and
// f32 on TF32 (wgmma_tf32.cuh), one row each.  This one table is what the
// CUDA dispatch (flash_bwd_dq.cu and flash_bwd_dkv.cu) expands and what
// the wrappers' plan (ops/cuda/common.py::backward_plan) and the CPU
// models of the kernels' arithmetic read, so they cannot disagree.  No
// include guard: an includer defines the macros it expands, the others
// expand to nothing here, and all eight are undefined at the end.  Rows
// by ascending padded width: a head of D columns takes the first width >=
// D; past the last, the STREAMED rows.
//
// ptxas gives a consumer warpgroup 168 registers, and each kernel keeps one
// tile's s and dp accumulators (f32) in flight beside the previous tile's
// hi + lo fragments and its gradient accumulators; shared memory holds an
// item's rows at the full width beside the ring.  Each tile up to 256
// columns is the fastest of tools/backward_choices.py's measurements
// against its neighbours in this table (half and 1.5 or 2 times the
// tile): the larger neighbours spill, or have ptxas serialise the wgmmas,
// or are slower though they fit; past 256 columns the tiles shrink so
// that the rows fit shared memory.
//
// DQ(width, keys, cols): the dq kernel's key tile, and the columns of dq a
//   consumer holds (cols / 2 registers a thread; s and dp take keys / 2
//   each, ds as hi + lo fragments keys / 2).  cols == width: a work item is
//   128 query rows, 64 a consumer.  cols < width (the column chunks): a
//   work item is 64 query rows and 2 * cols columns of dq, the two
//   consumers on the same rows, each its own chunk of cols columns; both
//   sum s and dp over all the columns.
// DKV(width, queries, cols): the dk/dv kernel's query tile, and the
//   columns of dk and of dv a consumer holds (cols registers a thread
//   between them; s^T, dp^T and their fragments take 2 * queries).
//   cols == width: a work item is 128 keys, 64 a consumer; cols < width:
//   64 keys and 2 * cols columns an item, as for dq.
// DQ_STREAMED(keys, cols), DKV_STREAMED(queries, cols): every head wider
//   than the rows above, at any width (dq_stream_kernel,
//   dkv_stream_kernel): a work item is 64 rows (or keys) and two chunks
//   of `cols` columns of the gradients, one a consumer, and s and dp (s^T
//   and dp^T) are summed over 64-column chunks of both operands that come
//   through the ring, so that shared memory holds nothing at the full
//   width.  The tiles are the fastest of tools/backward_choices.py's
//   measurements against their neighbours at (16,2,1024,520): dq 32 keys
//   1.42x, chunks of 64 columns 1.59x, 32 keys by 256 columns 1.08x; dk/dv
//   64 queries 0.69x the 32 (which 16 queries read 1.61x, 16 by 128
//   columns 1.04x).
// DQ_F32(width, keys, cols, bf16x3), DKV_F32(width, queries, cols,
//   bf16x3): the f32 instances on TF32 wgmma (dq_split_kernel,
//   dkv_split_kernel), as DQ and DKV above, up to 128 columns.  Every
//   tile is held twice in shared memory (TF32 big and small halves) and a
//   stage's key (query) tile also as the B of
//   the gradient products, which sum over keys (queries): each value four
//   bytes, so the rows of an item and two or more stages of the ring fill
//   a block's 227 KB with smaller tiles than the bf16 rows'.  bf16x3
//   chooses that B's route: 0, the tile's transpose written by the
//   converter warps, three TF32 products a k8 step; 1, the tile's three
//   bf16 terms read MN-major, six bf16 products a k16 step (tiles of a
//   multiple of 16, a consumer's columns whole bf16 atoms).  The consumers
//   hold each gradient twice, the tile's part and its f32 sum
//   (wgmma_tf32.cuh, GradFrags): dk/dv's consumers hold 32 columns, so
//   past 32 columns a work item is 64 keys and two chunks, as is dq's at
//   128.  Each row is the fastest of tools/backward_choices.py's
//   measurements against its neighbours (half and twice the tile, the
//   other route): the transposes read 1.13-1.35x the bf16 terms for dq at
//   32-128 columns and 1.30x for dk/dv at 32, where its 16-query tile
//   reads 1.29x the 32; past 32 columns dk/dv's 32-column chunks of the
//   bf16 terms would cut a 64-column atom, so they take the transposes.
// DQ_F32_STREAMED(keys, cols, bf16x3), DKV_F32_STREAMED(queries, cols,
//   bf16x3): every f32 head wider than the rows above, at any width
//   (dq_split_stream_kernel, dkv_split_stream_kernel): as DQ_STREAMED and
//   DKV_STREAMED, a work item 64 rows (keys) and two chunks of `cols`
//   columns of the gradients, one a consumer, s and dp (s^T and dp^T)
//   summed over 32-column chunks (an f32 swizzle atom) that the converter
//   warps split as they come through the ring, each chunk's three TF32
//   products added in f32; the gradient products' B at the consumers'
//   columns through a second ring, by the bf16x3 route (a consumer's chunk
//   its own tile there, so 32 columns take the bf16 terms too).  s and dp
//   are computed once a consumer and item: 2 * ceil(D / (2 cols)) times.
//   Each row is the fastest of tools/backward_choices.py --only f32s's
//   measurements at (128,8,512,192|256) and (16,2,1024,520): dq 16 keys
//   1.59-1.67x, 32 columns a consumer 1.42-1.90x, K's TF32 transpose
//   1.07-1.19x, 64 keys past shared memory; dk/dv 16 queries 1.65-1.71x,
//   the transposes 1.08-1.18x (and they spill), 64 queries or 64 columns
//   past shared memory.

#ifndef DQ
#define DQ(w, n, cols)
#endif
#ifndef DKV
#define DKV(w, n, cols)
#endif
#ifndef DQ_STREAMED
#define DQ_STREAMED(n, cols)
#endif
#ifndef DKV_STREAMED
#define DKV_STREAMED(n, cols)
#endif
#ifndef DQ_F32
#define DQ_F32(w, n, cols, bf16x3)
#endif
#ifndef DKV_F32
#define DKV_F32(w, n, cols, bf16x3)
#endif
#ifndef DQ_F32_STREAMED
#define DQ_F32_STREAMED(n, cols, bf16x3)
#endif
#ifndef DKV_F32_STREAMED
#define DKV_F32_STREAMED(n, cols, bf16x3)
#endif

DQ(32, 96, 32)
DQ(64, 64, 64)
DQ(128, 64, 128)
DQ(256, 32, 128)
DQ(384, 32, 128)
DQ(512, 16, 128)
DQ_STREAMED(64, 128)

DKV(32, 64, 32)
DKV(64, 64, 64)
DKV(128, 64, 64)
DKV(256, 32, 64)
DKV(384, 32, 64)
DKV(512, 16, 64)
DKV_STREAMED(64, 64)

DQ_F32(32, 48, 32, 1)
DQ_F32(64, 16, 64, 1)
DQ_F32(128, 16, 64, 1)
DQ_F32_STREAMED(32, 64, 1)

DKV_F32(32, 32, 32, 1)
DKV_F32(64, 16, 32, 0)
DKV_F32(128, 8, 32, 0)
DKV_F32_STREAMED(32, 32, 1)

#undef DQ
#undef DKV
#undef DQ_STREAMED
#undef DKV_STREAMED
#undef DQ_F32
#undef DKV_F32
#undef DQ_F32_STREAMED
#undef DKV_F32_STREAMED
