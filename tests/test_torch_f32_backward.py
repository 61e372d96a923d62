"""The f32 tiled backward pair on TF32 wgmma (``csrc/flash_bwd_dq.cu``,
``csrc/flash_bwd_dkv.cu``, dtype 0; ``csrc/wgmma_tf32.cuh``), modelled in
torch on the CPU and held against ``jax.vjp`` of the JAX package's
``flash_attention`` in f32 (its Pallas kernels in interpret mode, as
``tests/test_pallas_attention.py`` runs them).

No CPU can run the kernels.  ``tf32_backward_model`` repeats their
arithmetic: every operand of s = q.k^T and dp = do.v^T split into TF32
big = rna(x) and small = rna(x - big) (rna: round to nearest, ties away
from zero, the low 13 bits of the f32 cleared -- ``cvt.rna.tf32.f32``),
each product the three products big.big + big.small + small.big summed in
f32 (the tensor cores' own sum modelled exact, then rounded to f32; past
128 columns, the streamed instances, s and dp summed so a 32-column chunk
at a time, each chunk's part added into them in f32, in column order); the
gradient products (ds.k; ds^T.q and p^T.do) the same, or where the
table's ``bf16x3`` column says so, each operand split into three bf16
terms x1 = rn(x), x2 = rn(x - x1), x3 = rn(x - x1 - x2) (round to nearest
even) and the six products x1.y1 + x1.y2 + x2.y1 + x1.y3 + x2.y2 + x3.y1;
p = exp2(s*c - lse*log2(e))
with c the f32 product scale*log2(e) as one FFMA (its single rounding
modelled in f64); delta = rowsum(do*o) and ds = p*(dp - delta)*scale in
f32; dq summed key tile by key tile, last to first, and dk and dv query
tile by query tile, each tile's sum added to the f32 accumulator, with the
tiles and routes of ``csrc/backward_tiles.cuh``'s DQ_F32 and DKV_F32 rows
(``f32_backward_plan``; past 128 columns the DQ_F32_STREAMED and
DKV_F32_STREAMED rows).  The limit is the card tests' f32 backward limit,
rtol 1e-4 / atol 1e-5; the model with one TF32 product in place of each
split product misses it, so the split is what keeps the pair at f32
accuracy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cifar_torch.ops.cuda.common import (DKV_F32_TILES, DQ_F32_TILES,
                                             F32_BWD_STREAMED,
                                             F32_STREAM_COLS,
                                             WIDEST_F32_BACKWARD,
                                             f32_backward_plan)
from vit_cifar_torch.ops.cuda.flash_attention import (
    flash_tiled_bwd_dkv_reference, flash_tiled_bwd_dq_reference)
from vit_cifar_tpu.ops.pallas.attention import \
    _flash_forward_impl as jax_flash_forward_impl
from vit_cifar_tpu.ops.pallas.attention import \
    flash_attention as jax_flash_attention
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

LOG2E = 1.4426950408889634
BWD_TOL = dict(rtol=1e-4, atol=1e-5)
# (B, H, T, D, block_q, block_kv): tests/test_torch_flash_attention.py's
# tile-splitting cases and the pixel-token ViT's T=1025
CASES = [(2, 3, 65, 32, 1024, 32), (1, 2, 130, 64, 64, 64),
         (2, 2, 257, 128, 128, 128), (1, 1, 8, 128, 8, 512),
         (1, 2, 300, 32, 96, 128), (2, 2, 1025, 32, 1024, 512)]
# where a 16-row fragment, a key or query tile (8 to 48) or a work item
# (64 or 128 rows) ends; each T at one of the three widths, in turn
RAGGED_T = (1, 7, 63, 64, 65, 66, 127, 128, 129)
# past 128 columns, the streamed instances: (B, H, T, D) at 192 columns
# (three dq chunks, six of dk/dv), at 520 (17 chunks of the sums, the last
# ragged) and 704 (22), at 129 (D % 4 != 0: the padded copy on the card)
# and 256; each at a ragged T
STREAMED_CASES = [(1, 2, 130, 192), (1, 1, 65, 520), (1, 1, 33, 704),
                  (2, 1, 63, 129), (1, 2, 97, 256)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32``: to nearest, ties away
    from zero (half an ulp added to the magnitude's bits), the low 13 bits
    cleared."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = tf32(x)
    return big, tf32(x - big)


def products(eq: str, a: torch.Tensor, b: torch.Tensor,
             three: bool = True) -> torch.Tensor:
    """einsum ``eq`` of a and b as the kernels take it on TF32 wgmma: the
    three products of the big and small halves (with ``three``), else one
    product of the big halves, summed exactly and rounded to f32."""
    ab, as_ = split(a)
    bb, bs = split(b)
    terms = [(ab, bb), (ab, bs), (as_, bb)] if three else [(ab, bb)]
    return sum(torch.einsum(eq, x.double(), y.double())
               for x, y in terms).to(torch.float32)


def terms(x: torch.Tensor) -> list[torch.Tensor]:
    """x as three bf16 terms (round to nearest even), in f32."""
    x1 = x.to(torch.bfloat16).to(torch.float32)
    x2 = (x - x1).to(torch.bfloat16).to(torch.float32)
    return [x1, x2, (x - x1 - x2).to(torch.bfloat16).to(torch.float32)]


def products_bf16x3(eq: str, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """einsum ``eq`` of a and b in six bf16 products of their three terms
    (x1.y1 + x1.y2 + x2.y1 + x1.y3 + x2.y2 + x3.y1), summed exactly and
    rounded to f32."""
    at, bt = terms(a), terms(b)
    return sum(torch.einsum(eq, at[i].double(), bt[j].double())
               for i, j in ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))
               ).to(torch.float32)


def tf32_backward_model(q, k, v, o, do, lse, scale: float,
                        three: bool = True):
    """The f32 pair's arithmetic (the module docstring) at q's (T, D):
    (dq, dk, dv), f32.  ``o`` and ``do`` are (B, T, H, D), ``lse`` (B, H,
    T) f32; ``three=False`` takes one TF32 product of the big halves in
    place of each split product."""
    T, D = q.shape[2:]
    plan = f32_backward_plan(T, D)
    keys, queries = plan["dq"]["tile"], plan["dkv"]["tile"]

    def grad(kind, eq, x, y):  # a gradient product, as the kind's route
        if three and plan[kind]["bf16x3"]:
            return products_bf16x3(eq, x, y)
        return products(eq, x, y, three)

    def logits(a, b):  # s or dp: a sum over D, chunk by chunk if streamed
        if not plan["dq"]["streamed"]:
            return products("bhid,bhjd->bhij", a, b, three)
        out = torch.zeros(a.shape[:3] + b.shape[2:3])
        for c0 in range(0, D, F32_STREAM_COLS):
            cut = slice(c0, c0 + F32_STREAM_COLS)
            out = out + products("bhid,bhjd->bhij", a[..., cut], b[..., cut],
                                 three)
        return out

    of, dof = o.transpose(1, 2), do.transpose(1, 2)
    c = float(np.float32(scale) * np.float32(LOG2E))
    lse2 = lse[..., None] * float(np.float32(LOG2E))
    delta = (dof * of).sum(dim=-1, keepdim=True)
    s = logits(q, k)
    p = torch.exp2((s.double() * c - lse2.double()).to(torch.float32))
    ds = p * (logits(dof, v) - delta) * scale
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    for k0 in reversed(range(0, T, keys)):  # dq: a key tile at a time
        t = slice(k0, k0 + keys)
        dq += grad("dq", "bhij,bhjd->bhid", ds[..., t], k[:, :, t])
    for q0 in range(0, T, queries):  # dk, dv: a query tile at a time
        t = slice(q0, q0 + queries)
        dk += grad("dkv", "bhij,bhid->bhjd", ds[:, :, t], q[:, :, t])
        dv += grad("dkv", "bhij,bhid->bhjd", p[:, :, t], dof[:, :, t])
    return dq, dk, dv


def _jax_case(B, H, T, D, bq, bk, seed):
    """Inputs made with numpy from ``seed`` (q, k, v (B, H, T, D), a
    cotangent (B, T, H, D), the model's scale 1/sqrt(H*D)); JAX's
    ``flash_attention`` VJP of them at the case's blocks, and JAX's own
    forward output and lse, which the model reads as the pair reads the
    forward's.  Returns (torch (q, k, v, o, g, lse, scale), JAX's (dq, dk,
    dv))."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, T, D)).astype(np.float32)
               for _ in range(3))
    g = rng.normal(size=(B, T, H, D)).astype(np.float32)
    scale = float(1.0 / np.sqrt(H * D))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, scale, bq,
                                                         bk), jq, jk, jv)
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    jout, jlse = jax_flash_forward_impl(jq, jk, jv, scale, bq, bk,
                                        with_lse=True)
    o = np.asarray(jout)[:, :, :T, :D].transpose(0, 2, 1, 3).copy()
    lse = np.asarray(jlse)[:, :, :T, 0].copy()
    args = tuple(torch.from_numpy(a) for a in (q, k, v, o, g, lse))
    return (*args, scale), want


def _misses(got, want) -> list[str]:
    return [name for name, a, w in zip(("dq", "dk", "dv"), got, want)
            if not np.allclose(a.numpy(), w, **BWD_TOL)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_tf32_backward_model_matches_jax_vjp_in_f32(case):
    """The three-product model against JAX's f32 VJP within rtol 1e-4 /
    atol 1e-5, and against the port's plain passes too."""
    B, H, T, D, bq, bk = case
    args, want = _jax_case(B, H, T, D, bq, bk, seed=20)
    got = tf32_backward_model(*args)
    plain = (flash_tiled_bwd_dq_reference(*args),
             *flash_tiled_bwd_dkv_reference(*args))
    for name, a, w, pl in zip(("dq", "dk", "dv"), got, want, plain):
        assert a.shape == (B, H, T, D) and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), w, **BWD_TOL,
                                   err_msg=f"{name} {case}")
        np.testing.assert_allclose(a.numpy(), pl.numpy(), **BWD_TOL,
                                   err_msg=f"{name} {case} vs plain")


@pytest.mark.parametrize("T", RAGGED_T)
def test_tf32_backward_model_matches_jax_vjp_at_ragged_t(T):
    """At every T where a tile or a work item of the f32 instances ends,
    at widths 32, 64 and 128 in turn (D 32, 44 and 100: a head the padded
    copy widens, D % 4 != 0, among them), against JAX's f32 VJP."""
    D = (32, 44, 100)[RAGGED_T.index(T) % 3]
    args, want = _jax_case(1, 2, T, D, 64, 64, seed=T + D)
    for name, a, w in zip(("dq", "dk", "dv"),
                          tf32_backward_model(*args), want):
        np.testing.assert_allclose(a.numpy(), w, **BWD_TOL,
                                   err_msg=f"{name} T={T} D={D}")


@pytest.mark.parametrize("case", [CASES[0], CASES[5]],
                         ids=lambda c: "x".join(map(str, c)))
def test_one_tf32_product_misses_the_f32_limit(case):
    """The same model with one TF32 product (the big halves) in place of
    three misses rtol 1e-4 / atol 1e-5 against JAX's f32 VJP, at the
    flagship's T=65 and the pixel ViT's T=1025, where the three products
    hold it: the split is what keeps the pair at f32 accuracy."""
    args, want = _jax_case(*case, seed=21)
    assert _misses(tf32_backward_model(*args), want) == []
    assert _misses(tf32_backward_model(*args, three=False), want) != []


@pytest.mark.parametrize("case", STREAMED_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_streamed_tf32_backward_model_matches_jax_vjp_in_f32(case):
    """Past 128 columns (the streamed instances: s and dp summed a 32-column
    chunk at a time, each chunk's three products added in f32; the
    gradient products by the streamed rows' tiles and route) the model
    against JAX's f32 VJP within rtol 1e-4 / atol 1e-5, at 129, 192, 256,
    520 and 704 columns and ragged T, and against the port's plain
    passes."""
    B, H, T, D = case
    assert f32_backward_plan(T, D)["dq"]["streamed"]
    args, want = _jax_case(B, H, T, D, 64, 64, seed=T + D)
    got = tf32_backward_model(*args)
    plain = (flash_tiled_bwd_dq_reference(*args),
             *flash_tiled_bwd_dkv_reference(*args))
    for name, a, w, pl in zip(("dq", "dk", "dv"), got, want, plain):
        assert a.shape == (B, H, T, D) and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), w, **BWD_TOL,
                                   err_msg=f"{name} {case}")
        np.testing.assert_allclose(a.numpy(), pl.numpy(), **BWD_TOL,
                                   err_msg=f"{name} {case} vs plain")


@pytest.mark.parametrize("case", STREAMED_CASES[:2],
                         ids=lambda c: "x".join(map(str, c)))
def test_one_tf32_product_misses_the_f32_limit_past_128_columns(case):
    """Past 128 columns too, one TF32 product in place of each split
    product misses rtol 1e-4 / atol 1e-5 against JAX's f32 VJP where the
    streamed model's three products hold it."""
    args, want = _jax_case(*case, 64, 64, seed=22)
    assert _misses(tf32_backward_model(*args), want) == []
    assert _misses(tf32_backward_model(*args, three=False), want) != []


def test_tf32_rounding_is_to_nearest_ties_away():
    """``tf32`` as ``cvt.rna.tf32.f32``: 10 mantissa bits kept, the 13
    below rounded half away from zero, and big + small exact."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # a TF32 ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + ulp * 0.75, 3.0, 0.0], dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + ulp, 3.0, 0.0]
    np.testing.assert_array_equal(tf32(x).numpy(),
                                  np.array(want, np.float32))
    y = torch.from_numpy(np.random.default_rng(0).normal(size=1000)
                         .astype(np.float32))
    big, small = split(y)
    assert torch.equal(tf32(big), big) and torch.equal(tf32(small), small)
    # small keeps the next 11 bits: big + small is within 2**-21 of y
    rel = ((big.double() + small.double() - y.double()).abs()
           / y.double().abs())
    assert rel.max().item() <= 2.0 ** -21


def test_f32_plans_tile_as_the_dispatch_does():
    """The f32 instances' tiles by padded width, from the table the CUDA
    dispatch expands: dq key tiles of 48 keys at 32 columns and 16 at 64
    and 128, a work item 128 query rows up to 64 columns (64 a consumer)
    and at 128 64 rows with the consumers splitting the columns (64 each);
    dk/dv query tiles of 32, 16 and 8, its consumers holding 32 columns of
    dk and dv each (beside their f32 sums), so 128 keys an item at 32
    columns and past it 64 keys and a column chunk each.  The gradient
    products take three bf16 terms but dk/dv's past 32 columns (the
    transposes).  Past 128 columns the streamed rows: the width D rounded
    up to 32-column chunks, dq 32 keys a tile and 64 columns a consumer,
    dk/dv 32 queries and 32 columns, both on the bf16 terms, a work item 64
    rows (keys) and a group of two chunks, never a CUDA-core kernel."""
    def tiles(T, D):
        plan = f32_backward_plan(T, D)
        return (plan["width"],) + tuple(
            (k["tile"], k["cols"], k["rows"])
            for k in (plan["dq"], plan["dkv"]))

    assert WIDEST_F32_BACKWARD == 128
    assert sorted(DQ_F32_TILES) == sorted(DKV_F32_TILES) == [32, 64, 128]
    assert tiles(65, 32) == (32, (48, 32, 128), (32, 32, 128))
    assert tiles(1025, 8) == (32, (48, 32, 128), (32, 32, 128))
    assert tiles(130, 33) == (64, (16, 64, 128), (16, 32, 64))
    assert tiles(257, 100) == (128, (16, 64, 64), (8, 32, 64))
    assert tiles(257, 128) == (128, (16, 64, 64), (8, 32, 64))
    assert [f32_backward_plan(65, D)[kind]["bf16x3"] for D in (32, 64, 128)
            for kind in ("dq", "dkv")] == [True, True, True, False, True,
                                           False]
    for T, items in ((1, 1), (65, 1), (128, 1), (129, 2), (1025, 9)):
        assert f32_backward_plan(T, 32)["dq"]["items"] == items
        assert f32_backward_plan(T, 32)["dkv"]["items"] == items
    # 64 rows (keys), one group of two 64-column (32-column) chunks for dq
    # (dk/dv at 64 columns); two groups for dk/dv at 128
    assert f32_backward_plan(257, 128)["dq"]["items"] == 5
    assert f32_backward_plan(257, 64)["dkv"]["items"] == 5
    assert f32_backward_plan(257, 128)["dkv"]["items"] == 10
    assert not f32_backward_plan(129, 128)["dq"]["streamed"]
    assert F32_BWD_STREAMED == {"dq": (32, 64, True), "dkv": (32, 32, True)}
    plan = f32_backward_plan(65, 129)
    assert plan["width"] == 160 and plan["atom_cols"] == F32_STREAM_COLS
    assert tiles(65, 129) == (160, (32, 64, 64), (32, 32, 64))
    # 2 row (key) tiles of 64; dq 3 chunks of 64 columns in 2 groups,
    # dk/dv 5 of 32 in 3
    for kind, chunks, items in (("dq", 3, 4), ("dkv", 5, 6)):
        assert plan[kind]["streamed"] and plan[kind]["split"]
        assert plan[kind]["bf16x3"]
        assert (plan[kind]["chunks"], plan[kind]["items"]) == (chunks, items)
    # the wide-head model's (T=257, head_dim 192): 5 row (key) tiles of 64
    plan = f32_backward_plan(257, 192)
    assert (plan["width"], plan["dq"]["items"], plan["dkv"]["items"]) == (
        192, 10, 15)
    plan = f32_backward_plan(1024, 520)
    assert (plan["width"], plan["dq"]["chunks"], plan["dkv"]["chunks"]) == (
        544, 9, 17)
    assert (plan["dq"]["items"], plan["dkv"]["items"]) == (80, 144)
