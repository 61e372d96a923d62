// The instances of the bf16 wgmma forward (wgmma_attention.cuh), one row
// each.  This one table is what the CUDA dispatch (flash_fwd.cu and
// mhsa_fwd.cu, through wgmma_attention.cuh) expands and what the wrappers'
// tensor-map plan (ops/cuda/common.py::forward_plan) reads, so the two
// cannot disagree.  No include guard: each includer defines both macros.
//
// TILED(width, keys, pingpong): the tiled grid at a padded head width --
//   the widest key tile whose s, p and o fit a consumer warpgroup's 168
//   registers with the products in flight, and whether the two consumer
//   warpgroups take turns at the tensor cores (ping-pong: on where
//   tools/forward_choices.py read it faster, 0.3-0.5% at 32 columns and
//   6-7% at 192; off where none was, 2% at 64, 4-8% at 128, 0-5% at 256).
//   Rows by ascending width: a head of D columns takes the first width
//   >= D.  The whole-head instances of a width take its ping-pong.
// WHOLE(width, keys): mhsa_fwd's whole-head instances, the head's
//   round_up(T, 8) keys as one tile of `keys` keys, the first row of the
//   head's width that holds them (past the last: the tiled grid).  Rows by
//   width, then ascending keys.

TILED(32, 128, 1)
TILED(64, 96, 0)
TILED(128, 64, 0)
TILED(192, 64, 1)
TILED(256, 32, 0)

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
