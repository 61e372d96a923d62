"""The port's fused attention and MultiHeadSelfAttention against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and fed to both sides; weights are
the JAX module's init, carried across with ``state_dict_from_flax``.  The
JAX fused attention runs its Pallas kernel in interpret mode, as
``tests/test_pallas_attention.py`` runs it.  In f32 only the order of sums
differs, hence rtol 1e-4 / atol 1e-5; bf16 results may differ by one bf16
rounding step (2**-7 relative), hence 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cifar_torch.ops.attention import MultiHeadSelfAttention
from vit_cifar_torch.ops.cuda.attention import (fused_attention,
                                                fused_attention_lse,
                                                fused_attention_reference)
from vit_cifar_torch.ops.cuda.common import padded_copy, readable, tma_plan
from vit_cifar_torch.ops.cuda.flash_attention import (flash_attention,
                                                      flash_attention_lse)
from vit_cifar_torch.utils.transplant import state_dict_from_flax
from vit_cifar_tpu.ops.attention import \
    MultiHeadSelfAttention as JaxMultiHeadSelfAttention
from vit_cifar_tpu.ops.pallas.attention import \
    fused_attention as jax_fused_attention
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

# the JAX kernel tests' ragged shapes, plus the model's 12 heads at T=65
SHAPES = [(2, 4, 9, 16), (2, 3, 65, 32), (1, 2, 130, 64), (2, 2, 96, 128),
          (2, 12, 65, 32)]
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _f32(t):
    return np.asarray(t.to(torch.float32) if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_attention_matches_jax(shape, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    B, H, T, D = shape
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(H * D)
    want = _f32(jax_fused_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                    scale))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    for fn in (fused_attention_reference, fused_attention):
        got = fn(tq, tk, tv, scale)
        assert got.shape == (B, T, H, D) and got.dtype == tdt
        np.testing.assert_allclose(_f32(got), want, **tol, err_msg=fn.__name__)


def _mhsa_pair(seed=0, features=32, head=4, T=9, jax_kw=None, torch_kw=None,
               precision="f32"):
    jdt, tdt, _ = DTYPES[precision]
    x = np.random.default_rng(seed).normal(size=(2, T, features)).astype(
        np.float32)
    jm = JaxMultiHeadSelfAttention(features=features, head=head, dtype=jdt,
                                   **(jax_kw or {}))
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    tm = MultiHeadSelfAttention(features, head, dtype=tdt,
                                generator=torch.Generator().manual_seed(seed),
                                **(torch_kw or {}))
    tm.load_state_dict(state_dict_from_flax(variables["params"]))
    return jm, variables, tm, x


@pytest.mark.parametrize("precision", sorted(DTYPES))
@pytest.mark.parametrize("jax_kernel,torch_kernel",
                         [("einsum", "einsum"), ("fused", "fused"),
                          ("fused", None), ("flash", "flash")])
def test_mhsa_matches_jax(jax_kernel, torch_kernel, precision):
    """The port's module on its plain path and on its kernel paths (the
    default, and the forced tiled one) against the JAX module's einsum,
    fused and flash paths."""
    jm, variables, tm, x = _mhsa_pair(
        jax_kw=dict(pallas_kernel=jax_kernel),
        torch_kw=dict(pallas_kernel=torch_kernel), precision=precision)
    want = _f32(jm.apply(variables, jnp.asarray(x), deterministic=True))
    with torch.no_grad():
        got = _f32(tm(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, **DTYPES[precision][2])


def test_save_attn_map_matches_jax_intermediates():
    jm, variables, tm, x = _mhsa_pair(seed=1, jax_kw=dict(save_attn_map=True),
                                      torch_kw=dict(save_attn_map=True))
    want, inter = jm.apply(variables, jnp.asarray(x), mutable=["intermediates"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    (jax_map,) = inter["intermediates"]["attn_map"]
    assert tm.attn_map.shape == (2, 4, 9, 9)
    np.testing.assert_allclose(_f32(tm.attn_map), np.asarray(jax_map), **F32_TOL)
    np.testing.assert_allclose(_f32(got), np.asarray(want), **F32_TOL)


def test_valid_len_masks_padded_keys_like_jax():
    jm, variables, tm, x = _mhsa_pair(seed=2, jax_kw=dict(valid_len=6),
                                      torch_kw=dict(valid_len=6))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _f32(tm(torch.from_numpy(x)))
        # padded keys never reach a real token's output
        x2 = x.copy()
        x2[:, 6:] = 100.0
        got2 = _f32(tm(torch.from_numpy(x2)))
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got2[:, :6], got[:, :6], **F32_TOL)


def test_flash_kernel_raises_until_ported():
    """The tiled flash kernel is ported: ``"flash"`` is taken, and only a
    name the JAX module does not know raises."""
    m = MultiHeadSelfAttention(32, 4, generator=torch.Generator(),
                               pallas_kernel="flash")
    with torch.no_grad():
        assert m(torch.zeros(1, 9, 32)).shape == (1, 9, 32)
    with pytest.raises(ValueError, match="pallas_kernel"):
        MultiHeadSelfAttention(32, 4, generator=torch.Generator(),
                               pallas_kernel="sdpa")


@pytest.mark.parametrize("bad", ["shape", "dtype", "device"])
def test_fused_attention_refuses_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 2, 5, 8)
    k, v = q.clone(), q.clone()
    if bad == "shape":
        k = torch.zeros(1, 2, 6, 8)
    elif bad == "dtype":
        q, k, v = (a.half() for a in (q, k, v))
    else:  # neither CPU (plain version) nor CUDA (kernel)
        q, k, v = (a.to("meta") for a in (q, k, v))
    with pytest.raises(ValueError):
        fused_attention(q, k, v, 0.1)


def _projection_views(B, T, H, D, dtype=torch.bfloat16, extra=0, offset=0,
                      seed=0):
    """q, k, v as ``MultiHeadSelfAttention`` makes them: each (B, T, H*D)
    projection (rows ``extra`` elements wider, the first ``offset``
    elements of its storage skipped) viewed as (B, T, H, D) and transposed
    to (B, H, T, D)."""
    F_ = H * D + extra
    rng = np.random.default_rng(seed)
    views = []
    for _ in range(3):
        flat = torch.from_numpy(rng.normal(
            size=offset + B * T * F_).astype(np.float32)).to(dtype)
        x = flat[offset:].view(B, T, F_)[..., :H * D]
        views.append(x.view(B, T, H, D).transpose(1, 2))
    return views


# (name, view arguments, the copies the plan makes): the model's own views
# at the flagship's and the pixel ViT's shapes and at head_dim 192, a head
# of D % 8 != 0 (no row stride can be a multiple of 8), rows whose stride
# (the projection's width) is not a multiple of 8 though D is, an
# unaligned base, and a d stride other than 1
PLAN_CASES = [
    ("flagship", dict(B=2, T=65, H=12, D=32), ""),
    ("pixel", dict(B=2, T=1025, H=12, D=32), ""),
    ("head_dim_192", dict(B=2, T=257, H=2, D=192), ""),
    ("d_100", dict(B=2, T=65, H=3, D=100), "qkv"),
    ("row_stride_4", dict(B=2, T=65, H=3, D=32, extra=4), "qkv"),
    ("unaligned_base", dict(B=2, T=65, H=3, D=32, offset=1), "qkv"),
]


@pytest.mark.parametrize("name", ["mhsa_fwd", "flash_fwd"])
@pytest.mark.parametrize("case,kw,copies", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_tma_plan_of_the_models_views(case, kw, copies, name):
    """The tensor maps of the bf16 forwards over (D, H, T, B): extents,
    strides in bytes (the views' own where TMA can read them in place),
    box and swizzle; and the layouts sent through the padded copy, whose
    view the plan then reads in place."""
    q, k, v = _projection_views(**kw)
    B, H, T, D = q.shape
    plan = tma_plan(name, q, k, v)
    assert "".join(plan["copies"]) == copies
    width = 32 if D <= 32 else -(-D // 64) * 64
    whole = name == "mhsa_fwd" and T <= {32: 128, 64: 96, 128: 64}.get(
        width, 0)
    keys = {65: 72}[T] if whole else {32: 128, 64: 96}.get(width, 64)
    for key, t in zip("qkv", (q, k, v)):
        tmap = plan["maps"][key]
        assert tmap["extents"] == (D, H, T, B)
        if not copies:
            assert tmap["strides"] == (2 * D, 2 * (H * D), 2 * T * H * D)
            assert tmap["strides"] == tuple(2 * s for s in (
                t.stride(1), t.stride(2), t.stride(0)))
        else:
            Dp = -(-D // 8) * 8
            assert tmap["strides"] == (2 * T * Dp, 2 * Dp, 2 * H * T * Dp)
        assert all(s % 16 == 0 for s in tmap["strides"])
        rows = {"q": 128, "k": keys, "v": -(-keys // 16) * 16}[key]
        assert tmap["box"] == (32 if width == 32 else 64, 1, rows, 1)
        assert tmap["swizzle"] == (64 if width == 32 else 128)
    copied = readable(q, k, v)
    for key, got, t in zip("qkv", copied, (q, k, v)):
        assert torch.equal(got, t)
        assert (got.data_ptr() == t.data_ptr()) == (key not in copies)
    assert tma_plan(name, *copied)["copies"] == []


def test_tma_plan_copies_a_d_stride_other_than_1_and_passes_wide_heads():
    q, k, v = _projection_views(B=2, T=9, H=2, D=32)
    qt = q.transpose(-1, -2).contiguous().transpose(-1, -2)  # d stride T
    assert tma_plan("flash_fwd", qt, k, v)["copies"] == ["q"]
    assert padded_copy(qt).stride(-1) == 1
    # past the table's widest row the streamed instance reads the views
    # through tensor maps too, 64-column boxes of q, K and V
    from vit_cifar_torch.ops.cuda.common import streamed_row

    wide = _projection_views(B=1, T=9, H=1, D=520)
    plan = tma_plan("mhsa_fwd", *wide)
    assert plan["plan"]["grid"] == "streamed" and plan["copies"] == []
    keys = streamed_row(520)[0]
    assert [plan["maps"][key]["box"] for key in "qkv"] == [
        (64, 1, 128, 1), (64, 1, keys, 1), (64, 1, -(-keys // 16) * 16, 1)]
    chunked = tma_plan("mhsa_fwd", *_projection_views(B=1, T=9, H=1, D=384))
    assert chunked["plan"]["chunks"] == 2 and chunked["copies"] == []
    assert chunked["maps"]["v"]["box"] == (64, 1, 32, 1)


@pytest.mark.parametrize("wrapper", [fused_attention, fused_attention_lse,
                                     flash_attention, flash_attention_lse],
                         ids=lambda w: w.__name__)
def test_wrappers_take_strided_views_on_the_cpu(wrapper):
    """On the CPU each wrapper (its plain version) gives from the model's
    transposed views what it gives from contiguous copies of them, bit for
    bit, and its outputs are contiguous as the kernel writes them."""
    q, k, v = _projection_views(B=2, T=33, H=3, D=16, dtype=torch.float32)
    got = wrapper(q, k, v, 0.1)
    want = wrapper(*(t.contiguous() for t in (q, k, v)), 0.1)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        assert torch.equal(g, w) and g.is_contiguous()
