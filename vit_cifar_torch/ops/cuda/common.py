"""What the whole-head (``attention.py``) and tiled (``flash_attention.py``)
attention wrappers share: the ctypes binding and launch of a kernel
library, the wgmma kernels' tables of instances and TMA plan of the
caller's views, the checks of their arguments, and the terms of the plain
backward passes."""

from __future__ import annotations

import ctypes
import functools
import re

import torch

# Hopper's opt-in maximum of dynamic shared memory for one block.
MAX_SMEM_BYTES = 232_448
# Heads wider than this many columns are cut into column chunks by the bf16
# backward pair and by every f32 kernel (its streamed instances).
COL_CHUNK = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# a launch's return code for a tensor map cuTensorMapEncodeTiled refused:
# this base plus its CUresult (``kTensorMapFailed``,
# ``csrc/wgmma_blocks.cuh``), apart from every cudaError_t
TENSOR_MAP_FAILED = 8192


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built at first use."""
    from .build import load_library

    return bind(load_library(name), name)


def bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """``lib``, a build of ``csrc/<name>.cu``, with the return and argument
    types of its entry point and of its size functions set."""
    getattr(lib, name).restype = ctypes.c_int
    smem = getattr(lib, f"{name}_smem_bytes", None)
    if smem is not None:
        smem.argtypes = [ctypes.c_int, ctypes.c_int]
        smem.restype = ctypes.c_longlong
    scratch = getattr(lib, f"{name}_scratch_floats", None)
    if scratch is not None:
        scratch.argtypes = [ctypes.c_int] * 4
        scratch.restype = ctypes.c_longlong
    return lib


def _forward_tiles() -> tuple[dict, dict, dict, dict, dict]:
    """The bf16 wgmma forward's table of instances
    (``csrc/forward_tiles.cuh``, which the CUDA dispatch expands), by
    padded head width in ascending width: the tiled grid's key tile and the
    columns of o a work item holds (the width in one pass, ``TILED`` rows;
    a chunk of it, ``CHUNKED`` rows); whether the consumers of a width's
    instances take turns (ping-pong); mhsa_fwd's whole-head key tiles by
    width, ascending; and the ``STREAMED`` rows' (key tile, columns of o a
    work item) by width, ascending, which the heads past the widest row
    take (the first of width >= D, the last every wider head)."""
    from .build import CSRC_DIR

    text = (CSRC_DIR / "forward_tiles.cuh").read_text()
    rows = [(int(w), int(n), int(w), pp) for w, n, pp in re.findall(
        r"^TILED\((\d+), (\d+), ([01])\)$", text, re.M)]
    rows += [(int(w), int(n), int(c), pp) for w, n, c, pp in re.findall(
        r"^CHUNKED\((\d+), (\d+), (\d+), ([01])\)$", text, re.M)]
    rows.sort()
    whole = {}
    for w, n in re.findall(r"^WHOLE\((\d+), (\d+)\)$", text, re.M):
        whole.setdefault(int(w), []).append(int(n))
    streamed = {int(w): (int(n), int(c)) for w, n, c in sorted(
        re.findall(r"^STREAMED\((\d+), (\d+), (\d+)\)$", text, re.M),
        key=lambda row: int(row[0]))}
    return ({w: n for w, n, _, _ in rows}, {w: c for w, _, c, _ in rows},
            {w: pp == "1" for w, _, _, pp in rows}, whole, streamed)


TILED_KEYS, TILED_COLS, PINGPONG, WHOLE_KEYS, STREAMED = _forward_tiles()
QUERY_TILE = 128  # query rows a work item: two warpgroups of 64
# the widest head in one pass (wgmma's widest N, 256), and the widest row of
# the table (in column chunks); past it the streamed row
WIDEST_ONE_PASS = max(w for w, c in TILED_COLS.items() if c == w)
WIDEST_FORWARD = max(TILED_KEYS)
# the columns of one chunk of the streamed sums over D: a swizzle atom
STREAM_COLS = 64


def streamed_row(D: int) -> tuple[int, int]:
    """(key tile, columns of o a work item) of the ``STREAMED`` row a head
    of D columns past ``WIDEST_FORWARD`` takes: the first of width >= D,
    else the last."""
    return next((row for w, row in STREAMED.items() if D <= w),
                STREAMED[max(STREAMED)])


def _f32_forward_tiles() -> tuple[dict, dict, tuple, int]:
    """The f32 forward's instances on TF32 wgmma
    (``csrc/forward_tiles.cuh``'s ``FWD_F32``, ``WHOLE_F32`` and
    ``FWD_F32_STREAMED`` rows, which the CUDA dispatch expands): by padded
    head width, ascending, the tiled grid's (key tile, columns of o a
    consumer holds, whether p.V takes V's three bf16 terms); mhsa_fwd's
    whole-head key tiles by width, ascending; the streamed row's (key tile,
    columns of o a consumer), which every head past the widest ``FWD_F32``
    row takes; and the columns of its split pass's rows (``kSplitCols`` of
    ``csrc/wgmma_forward_tf32.cuh``)."""
    from .build import CSRC_DIR

    text = (CSRC_DIR / "forward_tiles.cuh").read_text()
    rows = {int(w): (int(n), int(c), x == "1") for w, n, c, x in sorted(
        re.findall(r"^FWD_F32\((\d+), (\d+), (\d+), ([01])\)$", text, re.M),
        key=lambda row: int(row[0]))}
    whole = {}
    for w, n in re.findall(r"^WHOLE_F32\((\d+), (\d+)\)$", text, re.M):
        whole.setdefault(int(w), []).append(int(n))
    streamed = tuple(map(int, re.findall(
        r"^FWD_F32_STREAMED\((\d+), (\d+)\)$", text, re.M)[0]))
    split_cols = int(re.findall(
        r"^constexpr int kSplitCols = (\d+);$",
        (CSRC_DIR / "wgmma_forward_tf32.cuh").read_text(), re.M)[0])
    return rows, whole, streamed, split_cols


FWD_F32_TILES, WHOLE_F32_KEYS, F32_FWD_STREAMED, F32_SPLIT_COLS = \
    _f32_forward_tiles()


def _backward_tiles() -> tuple[dict, dict, dict, dict, dict, dict, dict]:
    """The wgmma backward pair's table of instances
    (``csrc/backward_tiles.cuh``, which the CUDA dispatch expands): by
    padded head width, in ascending width, the bf16 dq kernel's (key tile,
    columns a consumer holds) and dk/dv kernel's (query tile, columns a
    consumer holds); the bf16 streamed rows' (tile, columns) of each kernel
    (``"dq"``, ``"dkv"``), which every head past the widest row takes; the
    f32 (TF32) instances' DQ_F32 and DKV_F32 rows by width, as the bf16
    ones; for each f32 kernel (``"dq"``, ``"dkv"``), by width, whether its
    gradient products take the tile's three bf16 terms (the rows'
    ``bf16x3`` column) in place of its transpose; and the f32 streamed rows'
    (tile, columns, bf16x3) of each kernel, which every f32 head past the
    widest f32 row takes."""
    from .build import CSRC_DIR

    text = (CSRC_DIR / "backward_tiles.cuh").read_text()
    # DQ_F32's fourth column, the route of ds.k, changes no sum's tiles
    rows = {kind: {int(w): (int(n), int(cols)) for w, n, cols in re.findall(
        rf"^{kind}\((\d+), (\d+), (\d+)(?:, [01])?\)$", text, re.M)}
        for kind in ("DQ", "DKV", "DQ_F32", "DKV_F32")}
    streamed = {kind.lower(): tuple(map(int, re.findall(
        rf"^{kind}_STREAMED\((\d+), (\d+)\)$", text, re.M)[0]))
        for kind in ("DQ", "DKV")}
    routes = {kind.lower(): {int(w): x == "1" for w, x in re.findall(
        rf"^{kind}_F32\((\d+), \d+, \d+, ([01])\)$", text, re.M)}
        for kind in ("DQ", "DKV")}
    f32_streamed = {}
    for kind in ("DQ", "DKV"):
        n, cols, x = re.findall(
            rf"^{kind}_F32_STREAMED\((\d+), (\d+), ([01])\)$", text,
            re.M)[0]
        f32_streamed[kind.lower()] = (int(n), int(cols), x == "1")
    return (rows["DQ"], rows["DKV"], streamed, rows["DQ_F32"],
            rows["DKV_F32"], routes, f32_streamed)


(DQ_TILES, DKV_TILES, BWD_STREAMED, DQ_F32_TILES, DKV_F32_TILES,
 F32_BF16X3, F32_BWD_STREAMED) = _backward_tiles()
WIDEST_BACKWARD = max(DQ_TILES)  # the widest row; past it the streamed
# the widest f32 row; past it the f32 streamed rows
WIDEST_F32_BACKWARD = max(DQ_F32_TILES)
# the columns of one chunk of the f32 streamed sums over D: an f32 atom
F32_STREAM_COLS = 32


def _cut(width: int, T: int, tile: int, cols: int, streamed: bool,
         D: int) -> dict:
    """One kernel's cut of a head of a width's instance: its tile, the
    columns of the gradient a consumer holds, whether the consumers split
    the columns ("split": fewer columns than the width), the rows (dq) or
    keys (dk/dv) of a work item (128, or 64 split), its column chunks (the
    last ragged when streamed), the work items a head at T (row tiles times
    groups of two chunks) and whether the sums over D are streamed."""
    split = cols < width
    rows = 64 if split else QUERY_TILE
    chunks = -(-D // cols) if streamed else width // cols
    return {"tile": tile, "cols": cols, "split": split, "rows": rows,
            "chunks": chunks, "streamed": streamed,
            "items": -(-T // rows) * (-(-chunks // 2) if split else 1)}


def backward_plan(T: int, D: int) -> dict:
    """How the bf16 backward pair cuts a (T, D) head, from the table its
    CUDA dispatch expands (``_backward_tiles``): the instance's width (the
    first table width >= D; past ``WIDEST_BACKWARD`` the streamed rows,
    and D rounded up to their 64-column chunks), its swizzle and the
    columns of one swizzle atom (as ``forward_plan``), and for each kernel
    (``"dq"``: its key tile; ``"dkv"``: its query tile) its cut
    (``_cut``)."""
    streamed = D > WIDEST_BACKWARD
    width = (-(-D // STREAM_COLS) * STREAM_COLS if streamed
             else min(w for w in DQ_TILES if w >= D))
    tiles = (BWD_STREAMED if streamed
             else {"dq": DQ_TILES[width], "dkv": DKV_TILES[width]})
    return {"width": width, "swizzle": 64 if width == 32 else 128,
            "atom_cols": 32 if width == 32 else 64,
            **{kind: _cut(width, T, *tiles[kind], streamed, D)
               for kind in ("dq", "dkv")}}


def f32_backward_plan(T: int, D: int) -> dict:
    """How the f32 backward pair cuts a (T, D) head on TF32 wgmma, from the
    table's DQ_F32 and DKV_F32 rows, as ``backward_plan`` (f32 tiles are
    128-byte swizzle atoms of 32 columns), and each kernel's route of its
    gradient products (``"bf16x3"``); past ``WIDEST_F32_BACKWARD`` the
    DQ_F32_STREAMED and DKV_F32_STREAMED rows, D rounded up to their
    32-column chunks (``F32_STREAM_COLS``) as the width."""
    streamed = D > WIDEST_F32_BACKWARD
    width = (-(-D // F32_STREAM_COLS) * F32_STREAM_COLS if streamed
             else min(w for w in DQ_F32_TILES if w >= D))
    plan = {"width": width, "swizzle": 128, "atom_cols": 32}
    for kind, tiles in (("dq", DQ_F32_TILES), ("dkv", DKV_F32_TILES)):
        tile, cols, bf16x3 = (F32_BWD_STREAMED[kind] if streamed else
                              (*tiles[width], F32_BF16X3[kind][width]))
        plan[kind] = {**_cut(width, T, tile, cols, streamed, D),
                      "bf16x3": bf16x3}
    return plan


def forward_plan(name: str, T: int, D: int) -> dict:
    """How the bf16 forward ``name`` (``mhsa_fwd`` or ``flash_fwd``) tiles
    a (T, D) head, from the table its CUDA dispatch expands
    (``_forward_tiles``): the instance's width (the first table width >=
    D; past ``WIDEST_FORWARD`` D rounded up to the streamed row's 64-column
    chunks) and whether its consumers ping-pong, its swizzle (64-byte rows
    at width 32, else 128-byte rows), the columns of one swizzle atom (a
    TMA box's inner extent), the rows of the q, k and v boxes, the grid
    ("whole": mhsa_fwd's whole head as one key tile, the first of its
    width's that holds round_up(T, 8) keys; "tiled": the width's
    ``TILED_KEYS``; "streamed": past the table, the ``STREAMED`` row, s
    summed over 64-column chunks of q and K brought through the ring), the
    columns of o a work item holds ("cols": the width in one pass, else a
    chunk), the chunks of o ("chunks": ceil(D / cols), the last ragged; 1
    in one pass) and the work items a head (query tiles of ``QUERY_TILE``
    rows times chunks)."""
    if D > WIDEST_FORWARD:
        width, grid, pingpong = -(-D // STREAM_COLS) * STREAM_COLS, \
            "streamed", False
        keys, cols = streamed_row(D)
    else:
        width = min(w for w in TILED_KEYS if w >= D)
        pingpong, cols = PINGPONG[width], TILED_COLS[width]
        n = -(-T // 8) * 8
        keys = None
        if name == "mhsa_fwd":
            keys = min((w for w in WHOLE_KEYS.get(width, ()) if w >= n),
                       default=None)
        grid = "tiled" if keys is None else "whole"
        keys = keys or TILED_KEYS[width]
    chunks = -(-D // cols)
    return {"width": width, "grid": grid, "pingpong": pingpong,
            "swizzle": 64 if width == 32 else 128,
            "atom_cols": 32 if width == 32 else 64,
            "rows": {"q": QUERY_TILE, "k": keys,
                     "v": -(-keys // 16) * 16},
            "cols": cols, "chunks": chunks,
            "items": -(-T // QUERY_TILE) * chunks}


def f32_forward_plan(name: str, T: int, D: int) -> dict:
    """How the f32 forward ``name`` (``mhsa_fwd`` or ``flash_fwd``) tiles a
    (T, D) head on TF32 wgmma, from the table's ``FWD_F32``, ``WHOLE_F32``
    and ``FWD_F32_STREAMED`` rows (``_f32_forward_tiles``): the instance's
    width (the first ``FWD_F32`` row of width >= D; past the widest D
    rounded up to the streamed sums' 32-column chunks), the grid ("whole":
    mhsa_fwd's whole head as one key tile, the first of its width's
    whole-head tiles that holds round_up(T, 8) keys; "tiled"; past the
    widest row "streamed", both forwards), its key tile and key tiles a
    head, the columns of o a consumer holds and whether the consumers split
    the width ("split": a work item 64 query rows, both consumers on them;
    else 128 rows, 64 a consumer), the route of p.V ("bf16x3": V's three
    bf16 terms; else its TF32 transpose) and p.V's depth (the key tile,
    rounded up to 16 for the bf16 terms' k16 steps: the rows of V's box),
    the swizzle and columns of an f32 atom (128-byte rows of 32 columns),
    the rows of the q, k and v boxes, the chunks of o and the work items a
    head (query tiles times groups of two chunks).  A streamed plan also
    gives the 32-column chunks of s's sum, rounded up to even so that the
    two consumers take alternate ones ("sums"), how many times s is
    computed a query tile ("s_passes": once a group) and the columns of
    the split pass's rows, which TMA reads ("split_cols": D rounded up to
    ``F32_SPLIT_COLS``)."""
    if D > max(FWD_F32_TILES):
        keys, cols = F32_FWD_STREAMED
        chunks = -(-D // cols)
        sums = -(-D // F32_STREAM_COLS)
        groups = -(-chunks // 2)
        return {"width": -(-D // F32_STREAM_COLS) * F32_STREAM_COLS,
                "grid": "streamed", "keys": keys,
                "key_tiles": -(-T // keys), "cols": cols, "split": True,
                "bf16x3": True, "depth": keys, "swizzle": 128,
                "atom_cols": F32_STREAM_COLS,
                "rows": {"q": 64, "k": keys, "v": keys}, "chunks": chunks,
                "items": -(-T // 64) * groups, "sums": sums + sums % 2,
                "s_passes": groups,
                "split_cols": -(-D // F32_SPLIT_COLS) * F32_SPLIT_COLS}
    width = min(w for w in FWD_F32_TILES if w >= D)
    keys, cols, bf16x3 = FWD_F32_TILES[width]
    whole = None
    if name == "mhsa_fwd":
        n = -(-T // 8) * 8
        whole = min((w for w in WHOLE_F32_KEYS.get(width, ()) if w >= n),
                    default=None)
    keys = whole or keys
    split = cols < width
    rows = 64 if split else QUERY_TILE
    depth = -(-keys // 16) * 16 if bf16x3 else keys
    return {"width": width, "grid": "whole" if whole else "tiled",
            "keys": keys, "key_tiles": -(-T // keys), "cols": cols,
            "split": split, "bf16x3": bf16x3, "depth": depth,
            "swizzle": 128, "atom_cols": 32,
            "rows": {"q": rows, "k": keys, "v": depth},
            "chunks": width // cols, "items": -(-T // rows)}


def whole_head_holds(T: int, D: int, dtype: torch.dtype) -> bool:
    """Whether a whole-head instance of mhsa_fwd in ``dtype`` holds a (T,
    D) head as its one key tile (a ``WHOLE`` row in bf16, a ``WHOLE_F32``
    row in f32): the router's default rule (``ops/attention.py::route``)."""
    if dtype == torch.bfloat16:
        return forward_plan("mhsa_fwd", T, D)["grid"] == "whole"
    return f32_forward_plan("mhsa_fwd", T, D)["grid"] == "whole"


def tma_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """t's (b, h, t) strides in elements as a tensor map over (D, H, T, B)
    takes them: a dimension of size 1 is addressed only at 0, so its
    stride is given as 8 (any multiple of 8 elements reads alike)."""
    (B, H, T, _), (sb, sh, st, _) = t.shape, t.stride()
    return (sb if B > 1 else 8, sh if H > 1 else 8, st if T > 1 else 8)


def tma_reads_in_place(t: torch.Tensor) -> bool:
    """Whether a tensor map can read the (B, H, T, D) view t where it lies:
    a 16-byte aligned base, d stride 1, and b, h and t strides (of the
    dimensions longer than 1) multiples of 16 bytes (8 bf16 or 4 f32
    elements)."""
    per16 = 16 // t.element_size()
    sb, sh, st = tma_strides(t)
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and not (sb % per16 or sh % per16 or st % per16))


def forward_reads_in_place(t: torch.Tensor, plan: dict) -> bool:
    """Whether the forward whose plan (``forward_plan``,
    ``f32_forward_plan``) is ``plan`` reads the (B, H, T, D) view t where
    it lies: the split pass of a streamed f32 plan reads any view whose d
    stride is 1 through its strides; every other instance reads through
    tensor maps (``tma_reads_in_place``)."""
    if "split_cols" in plan:
        return t.stride(-1) == 1
    return tma_reads_in_place(t)


def tma_plan(name: str, q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor) -> dict:
    """The tensor maps the forward ``name`` encodes over (D, H, T, B) for
    each of q, k, v ((B, H, T, D) views): extents, strides in bytes, box
    and swizzle (bf16: ``forward_plan``; f32: ``f32_forward_plan``), and
    the views the forward cannot read in place (``forward_reads_in_place``)
    -- for a tensor map a base not 16-byte aligned, a d stride other than
    1, or a b, h or t stride that is not a multiple of 16 bytes (8 bf16 or
    4 f32 elements), which every layout of a head of D % 8 != 0 (bf16) or D
    % 4 != 0 (f32) columns whose rows follow each other has.  Those go
    through ``padded_copy``.  The streamed f32 plan's maps are over its
    split pass's scratch, (W, B * H, T, 2) f32 halves of q and K and (W,
    B * H, T, 3) bf16 terms of V, W its "split_cols"."""
    B, H, T, D = q.shape
    f32 = q.dtype == torch.float32
    plan = f32_forward_plan(name, T, D) if f32 else forward_plan(name, T, D)
    out = {"plan": plan, "maps": {}, "copies": []}
    size = q.element_size()
    for key, t in zip("qkv", (q, k, v)):
        if not forward_reads_in_place(t, plan):
            out["copies"].append(key)
            t = padded_copy(t, meta=True)
        sb, sh, st = tma_strides(t)
        out["maps"][key] = {
            "extents": (D, H, T, B),
            "strides": (size * sh, size * st, size * sb),
            "box": (plan["atom_cols"], 1, plan["rows"][key], 1),
            "swizzle": plan["swizzle"]}
    if "split_cols" in plan:
        W = plan["split_cols"]
        n = B * H * T * W
        atom = 32 if plan["cols"] == 32 else 64  # V's terms: bf16 atoms
        for key, parts, elem in (("q", 2, 4), ("k", 2, 4), ("v", 3, 2)):
            out["maps"][key] = {
                "extents": (W, B * H, T, parts),
                "strides": (elem * T * W, elem * W, elem * n),
                "box": ((atom, 1, plan["keys"], 1) if key == "v"
                        else (plan["atom_cols"], 1, plan["rows"][key], 1)),
                "swizzle": 64 if key == "v" and atom == 32 else 128}
    return out


def padded_copy(t: torch.Tensor, meta: bool = False) -> torch.Tensor:
    """t copied into a contiguous (B, H, T, D') buffer, D' = D rounded up
    to a multiple of 8, zeros past D, and returned as the view of its first
    D columns: a layout TMA reads (``tma_plan``).  With ``meta`` only the
    view's layout, on the meta device."""
    D = t.shape[-1]
    wide = -(-D // 8) * 8
    make = torch.zeros if wide > D else torch.empty
    buf = make((*t.shape[:-1], wide), dtype=t.dtype,
               device="meta" if meta else t.device)
    if not meta:
        buf[..., :D] = t
    return buf[..., :D]


def readable(*views, plan: dict | None = None):
    """(B, H, T, D) views as a kernel reads them: each in place where its
    layout allows, else its ``padded_copy`` -- through tensor maps
    (``tma_reads_in_place``), or as the forward of ``plan`` reads them
    (``forward_reads_in_place``, as ``tma_plan`` reports)."""
    return tuple(t if (tma_reads_in_place(t) if plan is None else
                       forward_reads_in_place(t, plan)) else padded_copy(t)
                 for t in views)


def launch_error(name: str, err: int) -> str:
    """The message of a failed launch of kernel ``name`` that returned
    ``err``: a tensor map cuTensorMapEncodeTiled refused (with its
    CUresult), or the launch's cudaError_t."""
    if TENSOR_MAP_FAILED <= err < 2 * TENSOR_MAP_FAILED:
        return (f"{name} launch failed: a tensor map was refused "
                f"(CUresult {err - TENSOR_MAP_FAILED})")
    return f"{name} launch failed: cudaError {err}"


# the (b, h, t) strides of q, k and v, as the forward entry points take them
_STRIDES = ctypes.c_longlong * 9


def launch_forward(name: str, q, k, v, scale: float, with_lse: bool):
    """Launch forward kernel ``name`` (``mhsa_fwd`` or ``flash_fwd``) after
    its checks on the views q, k, v as given, through their strides
    (``readable``: only a layout the kernel cannot read is copied), with
    the scratch the f32 instance asks for (``<name>_scratch_floats``: the
    split pass's past 128 columns): (out (B, T, H, D), lse (B, H, T) f32 or
    None)."""
    check(q, k, v)
    B, H, T, D = q.shape
    # every bf16 instance reads through tensor maps
    plan = (f32_forward_plan(name, T, D) if q.dtype == torch.float32
            else None)
    q, k, v = readable(q, k, v, plan=plan)
    lib = library(name)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    floats = (getattr(lib, f"{name}_scratch_floats")(B, H, T, D)
              if q.dtype == torch.float32 else 0)
    scratch = (torch.empty(floats, dtype=torch.float32, device=q.device)
               if floats else None)
    strides = _STRIDES(*tma_strides(q), *tma_strides(k), *tma_strides(v))

    def run() -> int:
        return getattr(lib, name)(
            *(ctypes.c_void_p(None if t is None else t.data_ptr())
              for t in (q, k, v, out, lse, scratch)),
            strides, *(ctypes.c_int(n) for n in (B, H, T, D)),
            ctypes.c_float(scale), ctypes.c_int(_DTYPE_CODES[q.dtype]),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))

    # the kernel launches on the current device: switch only where q lies
    # on another
    if q.device.index == torch.cuda.current_device():
        err = run()
    else:
        with torch.cuda.device(q.device):
            err = run()
    if err != 0:
        raise RuntimeError(launch_error(name, err))
    return out, lse


# the (b, h, t) strides of the backward's seven views, as its entry points
# take them
_BWD_STRIDES = ctypes.c_longlong * 21


@functools.lru_cache(maxsize=256)
def check_shared_memory(lib: ctypes.CDLL, name: str, T: int, D: int) -> None:
    """Raises if kernel ``name`` of ``lib`` needs more shared memory at (T,
    D) than a block may use (its ``<name>_smem_bytes``); a shape that fits
    is remembered."""
    smem = getattr(lib, f"{name}_smem_bytes")(T, D)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{name} at T={T}, D={D} needs {smem} bytes of shared memory, "
            f"over the {MAX_SMEM_BYTES} a block may use")


def launch_backward(name: str, q, k, v, o, do, lse, outs, scale: float,
                    lib: ctypes.CDLL | None = None):
    """Launch backward kernel ``name`` (``flash_bwd_dq``: outs (dq,);
    ``flash_bwd_dkv``: (dk, dv)) of ``lib`` (default: the repo's build,
    ``library``) after its checks on the views as given, through their
    strides (``readable``: only a layout the kernel cannot read is
    copied), writing each output through its own strides; raises if the
    shape needs too much shared memory or the launch fails."""
    check_bwd(q, k, v, o, do, lse)
    # q, k, v, and o and do as (B, H, T, D) views; o is read by rows, any
    # strides with d's 1.  Tensor maps read the rest
    q, k, v, dot = readable(q, k, v, do.transpose(1, 2))
    ot = o.transpose(1, 2)
    views = (q, k, v, ot if ot.stride(-1) == 1 else padded_copy(ot), dot)
    B, H, T, D = q.shape
    lib = lib or library(name)
    check_shared_memory(lib, name, T, D)
    lse = lse.contiguous()
    pointers = [*views, lse, *outs]
    floats = getattr(lib, f"{name}_scratch_floats", None)
    if floats is not None:  # the dk/dv kernels' rows of lse and delta
        pointers.append(torch.empty(floats(B, H, T, D), dtype=torch.float32,
                                    device=q.device))
    # seven views' strides: the dq pass's seventh, dv's, is not read
    seven = (*views, *outs) if len(outs) == 2 else (*views, *outs, *outs)
    strides = _BWD_STRIDES(*[x for t in seven for x in tma_strides(t)])

    def run() -> int:
        return getattr(lib, name)(
            *[ctypes.c_void_p(None if t is None else t.data_ptr())
              for t in pointers],
            strides, ctypes.c_int(B), ctypes.c_int(H), ctypes.c_int(T),
            ctypes.c_int(D), ctypes.c_float(scale),
            ctypes.c_int(_DTYPE_CODES[q.dtype]),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))

    # the kernel launches on the current device: switch only where q lies
    # on another
    if q.device.index == torch.cuda.current_device():
        err = run()
    else:
        with torch.cuda.device(q.device):
            err = run()
    if err != 0:
        raise RuntimeError(launch_error(name, err))


def plain_impl(fn, checks=None, like=None):
    """An operator's CPU implementation: the plain version ``fn`` after the
    kernel's checks (``checks``, default ``check``, of every argument but
    the scale), its outputs laid out as the kernel writes them: contiguous,
    or where ``like`` (a function of the arguments) names a tensor for each
    output, in that tensor's layout (``torch.empty_like``)."""
    checks = checks or check

    def run(*args):
        checks(*args[:-1])
        out = fn(*args)
        outs = out if isinstance(out, tuple) else (out,)
        refs = like(*args) if like else (None,) * len(outs)
        laid = tuple(t.contiguous() if r is None
                     else torch.empty_like(r).copy_(t)
                     for t, r in zip(outs, refs))
        return laid if isinstance(out, tuple) else laid[0]
    return run


def check_device(q: torch.Tensor) -> None:
    """A wrapper's refusal of a device that neither the plain version (the
    CPU) nor the kernel (CUDA) runs on, before the operator's dispatch,
    which would answer a meta tensor from the fake implementation."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q.device}")


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention takes q, k, v of one (B, H, T, D) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError("attention takes float32 or bfloat16 q, k, v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if min(q.shape) < 1:
        raise ValueError(f"empty shape {tuple(q.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q.device}")


def check_bwd(q, k, v, o, do, lse) -> None:
    check(q, k, v)
    B, H, T, D = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != (B, T, H, D) or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(
                f"{name} must be {(B, T, H, D)} {q.dtype} on {q.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if lse.shape != (B, H, T) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"lse must be {(B, H, T)} float32 on {q.device}, "
                         f"got {tuple(lse.shape)} {lse.dtype} on {lse.device}")


def bwd_terms(q, k, v, o, do, lse, scale):
    """p and ds of the flash backward, in f32, from the formulas of
    ``_flash_bwd_dq_kernel``: p = exp(s - lse), dp = do.v^T,
    delta = rowsum(do * o), ds = p * (dp - delta) * scale."""
    qf, kf, vf = (a.to(torch.float32) for a in (q, k, v))
    of, dof = (a.to(torch.float32).transpose(1, 2) for a in (o, do))
    s = torch.einsum("bhid,bhjd->bhij", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhid,bhjd->bhij", dof, vf)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    return qf, kf, dof, p, p * (dp - delta) * scale
