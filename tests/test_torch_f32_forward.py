"""The f32 attention forwards on TF32 wgmma (``csrc/flash_fwd.cu`` and
``csrc/mhsa_fwd.cu``, dtype 0; ``csrc/wgmma_forward_tf32.cuh``), modelled
in torch on the CPU and held against the JAX package's f32 forwards:
``flash_attention`` / ``_flash_forward_impl`` and
``_fused_attention_fwd_impl(..., with_lse=True)``, their Pallas kernels in
interpret mode, as ``tests/test_pallas_attention.py`` runs them.

No CPU can run the kernel.  ``tf32_forward_model`` repeats its arithmetic:
q and each key tile split into TF32 big = rna(x) and small = rna(x - big)
(``tests/test_torch_f32_backward.py``'s ``tf32``: round to nearest, ties
away from zero), s = q.k^T the three products big.big + big.small +
small.big summed exactly and rounded to f32; the online softmax key tile
by key tile, last to first, in the tiles of the table's ``FWD_F32`` and
``WHOLE_F32`` rows (``f32_forward_plan``), in log2 units -- m the running
max of rn(max(s) * c), c = rn(scale * log2(e)), the TPU kernel's safe_m
guard, p = exp2(s * c - m) as one FFMA (its single rounding modelled in
f64), l = l * corr + sum(p); each tile's p.V in a fresh sum, as six bf16
products of both operands' three bf16 terms (x1 = rn(x), x2 = rn(x - x1),
x3 = rn(x - x1 - x2); the row's ``bf16x3``) or three TF32 products, added
into o in f32 as o = fma(o, corr, part); o = o * (1 / l) and lse = m *
ln(2) + log(l).  Past 128 columns (the streamed instance, the table's
``FWD_F32_STREAMED`` row) s is summed a 32-column chunk at a time, each
chunk's three products rounded to f32 and added in f32, the two
consumers each summing the chunks of its parity (their number rounded up
to even, the last a chunk of zeros) and s = s_0 + s_1; p.V as above, by
the row's key tile and route.  The limit is the card tests' f32 forward
limit, rtol 1e-5 / atol 1e-5; the model with one TF32 product in place of
each split product misses it, so the split is what keeps the forward at
f32 accuracy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cifar_torch.ops.attention import route
from vit_cifar_torch.ops.cuda.attention import (
    fused_attention, fused_attention_lse, fused_attention_lse_reference,
    fused_attention_reference)
from vit_cifar_torch.ops.cuda.common import (
    F32_FWD_STREAMED, F32_SPLIT_COLS, F32_STREAM_COLS, FWD_F32_TILES,
    WHOLE_F32_KEYS, f32_forward_plan, padded_copy, readable, tma_plan,
    whole_head_holds)
from vit_cifar_torch.ops.cuda.flash_attention import (
    flash_attention, flash_attention_lse, flash_attention_lse_reference,
    flash_attention_reference)
from vit_cifar_tpu.ops.pallas.attention import \
    _flash_forward_impl as jax_flash_forward_impl
from vit_cifar_tpu.ops.pallas.attention import \
    _fused_attention_fwd_impl as jax_fused_forward_impl
from test_torch_f32_backward import products, products_bf16x3
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
# (B, H, T, D, block_q, block_kv): tests/test_pallas_attention.py's cases
# and the pixel-token ViT's T=1025
CASES = [(2, 3, 65, 32, 1024, 32), (1, 2, 130, 64, 64, 64),
         (2, 2, 257, 128, 128, 128), (1, 1, 8, 128, 8, 512),
         (1, 2, 300, 32, 96, 128), (2, 2, 1025, 32, 1024, 512)]
# where a 16-row fragment, a key tile (16 to 72) or a work item (64 or 128
# rows) ends
RAGGED_T = (1, 7, 63, 64, 65, 66, 127, 128, 129)
# every f32 width and heads between them (odd, and D % 4 != 0: the padded
# copy widens those on the card), one a ragged T in turn
WIDTHS = (32, 17, 64, 44, 128, 100, 127, 33, 8)
NAMES = ("flash_fwd", "mhsa_fwd")
# past 128 columns, the streamed instance: (B, H, T, D) at 129 (D % 4 !=
# 0: the padded copy on the card; 5 chunks of the sum, rounded up to 6),
# 192 (two chunks of o of 128 columns, the second clamped), 256 (one
# group), 520 (17 chunks, the last ragged) and 704 (22), each at a ragged
# T
STREAMED_CASES = [(2, 1, 63, 129), (1, 2, 130, 192), (1, 2, 97, 256),
                  (1, 1, 65, 520), (1, 1, 33, 704)]


def tf32_forward_model(q, k, v, scale: float, name: str,
                       three: bool = True):
    """The f32 forward's arithmetic (the module docstring) for ``name``
    (``flash_fwd``: the tiled items; ``mhsa_fwd``: the whole head as one
    key tile where a WHOLE_F32 row holds it): (out (B, T, H, D), lse (B,
    H, T)), f32.  ``three=False`` takes one TF32 product of the big halves
    in place of each split product."""
    B, H, T, D = q.shape
    plan = f32_forward_plan(name, T, D)
    keys = plan["keys"]
    c = float(np.float32(scale) * np.float32(LOG2E))
    m = torch.full((B, H, T, 1), -torch.inf)
    l = torch.zeros((B, H, T, 1))
    o = torch.zeros((B, H, T, D))

    def logits(kt):  # s over D: in one product, or chunk by chunk
        if plan["grid"] != "streamed":
            return products("bhid,bhjd->bhij", q, kt, three)
        parts = [torch.zeros((B, H, T, kt.shape[2])) for _ in range(2)]
        for i, c0 in enumerate(range(0, D, F32_STREAM_COLS)):
            cut = slice(c0, c0 + F32_STREAM_COLS)
            parts[i % 2] = parts[i % 2] + products(
                "bhid,bhjd->bhij", q[..., cut], kt[..., cut], three)
        return parts[0] + parts[1]

    for k0 in reversed(range(0, T, keys)):  # last to first
        t = slice(k0, k0 + keys)
        s = logits(k[:, :, t])
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * c)
        safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp2(m - safe), 0.0)
        p = torch.exp2((s.double() * c - safe.double()).to(torch.float32))
        l = l * corr + p.sum(dim=-1, keepdim=True)
        if three and plan["bf16x3"]:
            part = products_bf16x3("bhij,bhjd->bhid", p, v[:, :, t])
        else:
            part = products("bhij,bhjd->bhid", p, v[:, :, t], three)
        o = (o.double() * corr.double() + part.double()).to(torch.float32)
        m = m_new
    out = o * (1.0 / l)
    lse = (m * LN2 + torch.log(l)).squeeze(-1)
    return out.transpose(1, 2), lse


def _jax_case(B, H, T, D, bq, bk, seed, name):
    """Inputs made with numpy from ``seed`` (q, k, v (B, H, T, D), the
    model's scale 1/sqrt(H*D)) and JAX's f32 forward of them: the flash
    forward at the case's blocks (``flash_fwd``) or the fused one
    (``mhsa_fwd``), each with lse.  Returns (torch (q, k, v, scale), JAX's
    (out (B, T, H, D), lse (B, H, T)))."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, T, D)).astype(np.float32)
               for _ in range(3))
    scale = float(1.0 / np.sqrt(H * D))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if name == "flash_fwd":
        jout, jlse = jax_flash_forward_impl(jq, jk, jv, scale, bq, bk,
                                            with_lse=True)
    else:
        jout, jlse = jax_fused_forward_impl(jq, jk, jv, scale,
                                            with_lse=True)
    out = np.asarray(jout)[:, :, :T, :D].transpose(0, 2, 1, 3)
    lse = np.asarray(jlse)[:, :, :T, 0]
    return ((*(torch.from_numpy(a) for a in (q, k, v)), scale),
            (out, lse))


def _misses(got, want) -> list[str]:
    return [what for what, a, w in zip(("out", "lse"), got, want)
            if not np.allclose(a.numpy(), w, **FWD_TOL)]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_tf32_forward_model_matches_jax_in_f32(case, name):
    """The three-product model against JAX's f32 forward (o and lse)
    within rtol 1e-5 / atol 1e-5, and against the port's plain version."""
    B, H, T, D, bq, bk = case
    args, want = _jax_case(B, H, T, D, bq, bk, seed=30, name=name)
    out, lse = tf32_forward_model(*args, name)
    assert out.shape == (B, T, H, D) and lse.shape == (B, H, T)
    assert out.dtype == lse.dtype == torch.float32
    plain = flash_attention_lse_reference(*args)
    for what, a, w, pl in zip(("out", "lse"), (out, lse), want, plain):
        np.testing.assert_allclose(a.numpy(), w, **FWD_TOL,
                                   err_msg=f"{what} {name} {case}")
        np.testing.assert_allclose(a.numpy(), pl.numpy(), **FWD_TOL,
                                   err_msg=f"{what} {name} {case} vs plain")


@pytest.mark.parametrize("T", RAGGED_T)
def test_tf32_forward_model_matches_jax_at_ragged_t(T):
    """At every T where a tile or a work item of the f32 instances ends,
    at a width of the table or a head between in turn, both forwards (the
    whole-head grid where it holds the head), against JAX's f32 forward."""
    D = WIDTHS[RAGGED_T.index(T) % len(WIDTHS)]
    for name in NAMES:
        args, want = _jax_case(1, 2, T, D, 64, 64, seed=T + D, name=name)
        np.testing.assert_equal(_misses(tf32_forward_model(*args, name),
                                        want), [], err_msg=f"T={T} D={D}")


@pytest.mark.parametrize("D", [32, 64, 128, 17, 100])
def test_tf32_forward_model_matches_jax_at_each_width(D):
    """Both forwards at the pixel ViT's T=1025 and the flagship's T=65 (the
    whole head at 32 columns) at each width of the table and two between,
    against JAX's f32 forward."""
    for T in (65, 1025):
        for name in NAMES:
            args, want = _jax_case(1, 1, T, D, 1024, 512, seed=D + T,
                                   name=name)
            np.testing.assert_equal(
                _misses(tf32_forward_model(*args, name), want), [],
                err_msg=f"{name} T={T} D={D}")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", [CASES[0], CASES[5]],
                         ids=lambda c: "x".join(map(str, c)))
def test_one_tf32_product_misses_the_f32_limit(case, name):
    """The same model with one TF32 product (the big halves) in place of
    each split product misses rtol 1e-5 / atol 1e-5 against JAX's f32
    forward at the flagship's T=65 and the pixel ViT's T=1025, where the
    split products hold it."""
    args, want = _jax_case(*case, seed=31, name=name)
    assert _misses(tf32_forward_model(*args, name), want) == []
    assert _misses(tf32_forward_model(*args, name, three=False), want) != []


def test_f32_forward_plans_tile_as_the_dispatch_does():
    """The f32 instances by padded width, from the table the CUDA dispatch
    expands: 64-key tiles at 32 columns (work items of 128 query rows, 64
    a consumer), 32-key tiles at 64 (the same) and at 128 (64 rows, each
    consumer 64 columns of o); p.V on V's three bf16 terms, so a depth of
    the key tile rounded up to 16; mhsa_fwd's whole head up to 72 keys at
    32 columns (T=65: one tile of 72, a depth of 80), 64 at 64 and 32 at
    128; past 128 columns the streamed row at every width, both forwards:
    32-key tiles, 64 query rows and two chunks of o of 128 columns an
    item, one a consumer, s summed over 32-column chunks that the two
    consumers share (their number rounded up to even), q, K and V split
    once a call, never a CUDA-core kernel."""
    assert max(FWD_F32_TILES) == 128
    assert FWD_F32_TILES == {32: (64, 32, True), 64: (32, 64, True),
                             128: (32, 64, True)}
    assert {w: max(n) for w, n in WHOLE_F32_KEYS.items()} == {
        32: 72, 64: 64, 128: 32}
    assert F32_FWD_STREAMED == (32, 128)

    def cut(name, T, D):
        plan = f32_forward_plan(name, T, D)
        return (plan["width"], plan["grid"], plan["keys"], plan["cols"],
                plan["rows"]["q"], plan["depth"], plan["key_tiles"],
                plan["items"])

    assert cut("mhsa_fwd", 65, 32) == (32, "whole", 72, 32, 128, 80, 1, 1)
    assert cut("flash_fwd", 65, 32) == (32, "tiled", 64, 32, 128, 64, 2, 1)
    assert cut("flash_fwd", 1025, 32) == (32, "tiled", 64, 32, 128, 64, 17,
                                          9)
    assert cut("mhsa_fwd", 1025, 8) == cut("flash_fwd", 1025, 8)
    assert cut("mhsa_fwd", 9, 8) == (32, "whole", 16, 32, 128, 16, 1, 1)
    assert cut("mhsa_fwd", 73, 33) == (64, "tiled", 32, 64, 128, 32, 3, 1)
    assert cut("mhsa_fwd", 64, 33) == (64, "whole", 64, 64, 128, 64, 1, 1)
    assert cut("flash_fwd", 257, 100) == (128, "tiled", 32, 64, 64, 32, 9,
                                          5)
    assert cut("mhsa_fwd", 32, 128) == (128, "whole", 32, 64, 64, 32, 1, 1)
    # past 128 columns: the streamed row, the same for both forwards
    for T, D, want in ((65, 129, (160, "streamed", 32, 128, 64, 32, 3, 2)),
                       (1, 129, (160, "streamed", 32, 128, 64, 32, 1, 1)),
                       (257, 192, (192, "streamed", 32, 128, 64, 32, 9, 5)),
                       (512, 256, (256, "streamed", 32, 128, 64, 32, 16,
                                   8)),
                       (1024, 520, (544, "streamed", 32, 128, 64, 32, 32,
                                    48))):
        assert cut("flash_fwd", T, D) == cut("mhsa_fwd", T, D) == want
    plan = f32_forward_plan("mhsa_fwd", 1024, 520)
    assert (plan["chunks"], plan["sums"], plan["s_passes"]) == (5, 18, 3)
    assert plan["bf16x3"] and plan["split_cols"] == 576
    plan = f32_forward_plan("flash_fwd", 257, 192)
    assert (plan["chunks"], plan["sums"], plan["s_passes"]) == (2, 6, 1)
    assert not whole_head_holds(1, 129, torch.float32)
    # each whole-head row is the first of its width that holds its keys
    for width, keys in WHOLE_F32_KEYS.items():
        below = 0
        for n in sorted(keys):
            for T in (below + 1, n):
                assert f32_forward_plan("mhsa_fwd", T, width)["keys"] == n
            below = n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tma_plan_of_the_f32_views(dtype):
    """The f32 forwards read the model's views in place through f32 tensor
    maps (boxes of 32 columns, 128-byte swizzle, 4-byte strides) up to 128
    columns; a head of D % 4 != 0 goes through the padded copy (D % 8 !=
    0 in bf16); past 128 columns the streamed instance's maps are over its
    split pass's scratch: q's and K's TF32 halves, (W, B * H, T, 2) f32,
    and V's three bf16 terms, (W, B * H, T, 3), W = D rounded up to 64,
    boxes of 32 f32 columns (64 rows of q, a key tile of K) and of 64 bf16
    columns (V's key tile), 128-byte swizzle; the views themselves as up
    to 128 columns, except that the split pass reads any view whose d
    stride is 1 in place, so nothing is copied at 130 columns."""
    B, T, H = 2, 65, 3
    for D, f32_copies in ((32, ""), (44, ""), (30, "qkv"), (136, ""),
                          (130, "")):
        x = torch.zeros((3, B, T, H * D), dtype=dtype)
        q, k, v = (t.view(B, T, H, D).transpose(1, 2) for t in x)
        plan = tma_plan("mhsa_fwd", q, k, v)
        if dtype == torch.bfloat16:
            assert "".join(plan["copies"]) == ("" if D % 8 == 0 else "qkv")
            continue
        assert "".join(plan["copies"]) == f32_copies, D
        if D > 128:
            assert plan["plan"]["grid"] == "streamed"
            W = -(-D // F32_SPLIT_COLS) * F32_SPLIT_COLS
            n = B * H * T * W
            assert plan["maps"] == {
                "q": {"extents": (W, B * H, T, 2),
                      "strides": (4 * T * W, 4 * W, 4 * n),
                      "box": (32, 1, 64, 1), "swizzle": 128},
                "k": {"extents": (W, B * H, T, 2),
                      "strides": (4 * T * W, 4 * W, 4 * n),
                      "box": (32, 1, 32, 1), "swizzle": 128},
                "v": {"extents": (W, B * H, T, 3),
                      "strides": (2 * T * W, 2 * W, 2 * n),
                      "box": (64, 1, 32, 1), "swizzle": 128}}, D
        else:
            for key in "qkv":
                tmap = plan["maps"][key]
                assert tmap["swizzle"] == 128
                assert tmap["box"][0] == 32
                assert all(s % 16 == 0 for s in tmap["strides"])
            if not f32_copies:
                assert plan["maps"]["q"]["strides"] == (4 * D, 4 * H * D,
                                                        4 * T * H * D)
        if f32_copies:
            assert padded_copy(q).stride(2) == -(-D // 8) * 8
        else:
            assert all(a is b for a, b in zip(
                readable(q, k, v, plan=plan["plan"]), (q, k, v)))
        assert tma_plan("mhsa_fwd", *readable(
            q, k, v, plan=plan["plan"]))["copies"] == []


@pytest.mark.parametrize("width", sorted(FWD_F32_TILES))
def test_route_takes_the_whole_head_where_an_f32_row_holds_it(width):
    """The router's default in f32: "fused" exactly where a WHOLE_F32 row
    of the head's width holds round_up(T, 8) keys, at the row's last T and
    "flash" one past it; the same head in bf16 follows the bf16 rows."""
    last = max(WHOLE_F32_KEYS[width])
    for D in (width, width - 1):
        assert route(last, D, None, dtype=torch.float32) == "fused"
        assert route(last + 1, D, None, dtype=torch.float32) == "flash"
        assert whole_head_holds(last, D, torch.float32)
        assert not whole_head_holds(last + 1, D, torch.float32)
        assert route(last + 1, D, None, dtype=torch.bfloat16) == "fused"


@pytest.mark.parametrize("wrapper,plain", [
    (fused_attention_lse, fused_attention_lse_reference),
    (flash_attention_lse, flash_attention_lse_reference),
    (fused_attention, fused_attention_reference),
    (flash_attention, flash_attention_reference)],
    ids=["mhsa_fwd_lse", "flash_fwd_lse", "mhsa_fwd", "flash_fwd"])
def test_cpu_tensors_take_the_plain_twins(wrapper, plain):
    """On the CPU each f32 forward runs its plain version, bit for bit, on
    the model's views, and counts no launch: the kernel runs only for a
    CUDA tensor."""
    B, T, H, D = 2, 65, 3, 32
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(3, B, T, H * D)).astype(np.float32))
    q, k, v = (t.view(B, T, H, D).transpose(1, 2) for t in x)
    before = wrapper.launches
    got, want = wrapper(q, k, v, 0.1), plain(q, k, v, 0.1)
    for a, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, w)
    assert wrapper.launches == before


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", STREAMED_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_streamed_tf32_forward_model_matches_jax_in_f32(case, name):
    """Past 128 columns (the streamed instance: s summed a 32-column chunk
    at a time, the two consumers each summing the chunks of its parity and
    adding the other's part, each chunk's three products added in f32; p.V
    by the streamed row's key tile and route) the model against JAX's f32
    forward (o and lse) within rtol 1e-5 / atol 1e-5, at 129, 192, 256,
    520 and 704 columns and ragged T, for both forwards (``mhsa_fwd`` takes
    the same tiled items there), and against the port's plain version."""
    B, H, T, D = case
    assert f32_forward_plan(name, T, D)["grid"] == "streamed"
    args, want = _jax_case(B, H, T, D, 64, 64, seed=T + D, name=name)
    out, lse = tf32_forward_model(*args, name)
    assert out.shape == (B, T, H, D) and lse.shape == (B, H, T)
    plain = flash_attention_lse_reference(*args)
    for what, a, w, pl in zip(("out", "lse"), (out, lse), want, plain):
        np.testing.assert_allclose(a.numpy(), w, **FWD_TOL,
                                   err_msg=f"{what} {name} {case}")
        np.testing.assert_allclose(a.numpy(), pl.numpy(), **FWD_TOL,
                                   err_msg=f"{what} {name} {case} vs plain")


@pytest.mark.parametrize("case", STREAMED_CASES[1:3],
                         ids=lambda c: "x".join(map(str, c)))
def test_one_tf32_product_misses_the_f32_limit_past_128_columns(case):
    """Past 128 columns too, one TF32 product in place of each split
    product misses rtol 1e-5 / atol 1e-5 against JAX's f32 forward where
    the streamed model's three products hold it."""
    args, want = _jax_case(*case, 64, 64, seed=32, name="flash_fwd")
    assert _misses(tf32_forward_model(*args, "flash_fwd"), want) == []
    assert _misses(tf32_forward_model(*args, "flash_fwd", three=False),
                   want) != []
