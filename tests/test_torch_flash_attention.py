"""The port's tiled flash attention -- the forward with and without
logsumexp, the tiled dq and dk/dv passes, the autograd Function around them,
and the route that picks between it and the whole-head kernels -- against
the JAX package's ``flash_attention`` and its custom VJP, on the CPU.

Inputs and cotangents are made with numpy from a seed, in f32, and fed to
both sides.  The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_pallas_attention.py`` runs them, at that file's tile-splitting
cases and at the pixel-token ViT's T=1025 with the default blocks (2 query
tiles, 3 key tiles).  The port's plain versions tile the keys by the
case's ``block_kv`` (``BLOCK_KV`` patched), so that their online softmax is
split where the JAX kernel's is.  Tolerances are the JAX tests' own: rtol
1e-5 / atol 1e-6 for the forward (the same online softmax, sums in another
order) and rtol 1e-4 / atol 1e-5 for the gradients (sums chained twice over
T).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cifar_torch.ops.attention import MultiHeadSelfAttention, route
from vit_cifar_torch.ops.cuda import flash_attention as flash_module
from vit_cifar_torch.ops.cuda import KERNEL_WRAPPERS
from vit_cifar_torch.ops.cuda.attention import (fused_attention_reference,
                                                whole_head_fits)
from vit_cifar_torch.ops.cuda.flash_attention import (
    FlashAttentionFunction, flash_attention, flash_attention_lse,
    flash_attention_lse_reference, flash_attention_reference,
    flash_tiled_bwd_dkv, flash_tiled_bwd_dkv_reference, flash_tiled_bwd_dq,
    flash_tiled_bwd_dq_reference)
from vit_cifar_tpu.ops.pallas.attention import \
    _flash_forward_impl as jax_flash_forward_impl
from vit_cifar_tpu.ops.pallas.attention import \
    flash_attention as jax_flash_attention

# (B, H, T, D, block_q, block_kv): tests/test_pallas_attention.py's cases,
# then the pixel-token ViT's sequence at the default blocks
CASES = [(2, 3, 65, 32, 1024, 32), (1, 2, 130, 64, 64, 64),
         (2, 2, 257, 128, 128, 128), (1, 1, 8, 128, 8, 512),
         (1, 2, 300, 32, 96, 128), (2, 2, 1025, 32, 1024, 512)]
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
cases = pytest.mark.parametrize("case", CASES,
                                ids=lambda c: "x".join(map(str, c)))


def _inputs(B, H, T, D, seed):
    """q, k, v (B, H, T, D), a cotangent (B, T, H, D) and the model's
    scale 1/sqrt(H*D), f32 numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, T, D)).astype(np.float32)
               for _ in range(3))
    g = rng.normal(size=(B, T, H, D)).astype(np.float32)
    return q, k, v, g, float(1.0 / np.sqrt(H * D))


@cases
def test_flash_forward_matches_jax(case, monkeypatch):
    B, H, T, D, bq, bk = case
    monkeypatch.setattr(flash_module, "BLOCK_KV", bk)
    q, k, v, _, scale = _inputs(B, H, T, D, seed=0)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jax_flash_attention(jq, jk, jv, scale, bq, bk))
    jout, jlse = jax_flash_forward_impl(jq, jk, jv, scale, bq, bk,
                                        with_lse=True)
    want_lse = np.asarray(jlse)[:, :, :T, 0]  # drop the TPU's padding
    np.testing.assert_allclose(
        np.asarray(jout)[:, :, :T, :D].transpose(0, 2, 1, 3), want, **FWD_TOL)

    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for fn in (flash_attention_reference, flash_attention):
        got = fn(tq, tk, tv, scale)
        assert got.shape == (B, T, H, D) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **FWD_TOL,
                                   err_msg=fn.__name__)
    for fn in (flash_attention_lse_reference, flash_attention_lse):
        out, lse = fn(tq, tk, tv, scale)
        assert lse.shape == (B, H, T) and lse.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), want, **FWD_TOL,
                                   err_msg=fn.__name__)
        np.testing.assert_allclose(lse.numpy(), want_lse, **FWD_TOL,
                                   err_msg=fn.__name__)


@cases
def test_flash_grads_match_jax_vjp(case, monkeypatch):
    B, H, T, D, bq, bk = case
    monkeypatch.setattr(flash_module, "BLOCK_KV", bk)
    q, k, v, g, scale = _inputs(B, H, T, D, seed=1)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, scale, bq,
                                                         bk),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]

    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = flash_attention_lse(tq, tk, tv, scale)
    args = (tq, tk, tv, out, tg, lse, scale)
    plain = [flash_tiled_bwd_dq_reference(*args),
             *flash_tiled_bwd_dkv_reference(*args)]
    wrapped = [flash_tiled_bwd_dq(*args), *flash_tiled_bwd_dkv(*args)]
    leaves = [a.clone().requires_grad_() for a in (tq, tk, tv)]
    out = flash_attention(*leaves, scale)
    assert out.grad_fn.name() == "FlashAttentionFunctionBackward"
    through_function = torch.autograd.grad(out, leaves, tg)
    for how, got in (("plain", plain), ("wrapper", wrapped),
                     ("Function", through_function)):
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert a.shape == (B, H, T, D) and a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), w, **GRAD_TOL,
                                       err_msg=f"{name} via {how}")


def test_flash_matches_the_whole_head_plain_version_in_bf16():
    """In bf16 the online softmax keeps f32 inside and rounds only its
    output, as the one-block plain version does: one bf16 step apart."""
    q, k, v, _, scale = _inputs(2, 3, 150, 32, seed=2)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, scale)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, fused_attention_reference(tq, tk, tv,
                                                              scale),
                               rtol=1e-2, atol=1e-2)


def test_plain_forward_guards_a_fully_masked_tile(monkeypatch):
    """A first key tile whose logits are all -inf keeps the running max at
    -inf without a NaN (``safe_m``), and the next tile rescales that empty
    history by 0 (``corr``), as ``_flash_fwd_body`` does."""
    q = torch.zeros(1, 1, 3, 4)
    q[..., 0] = 1.0
    k = torch.zeros(1, 1, 3, 4)
    k[0, 0, 0, 0] = -1e30  # its logit is -inf in f32 once scaled by 1e10
    v = torch.arange(12.0).reshape(1, 1, 3, 4)
    monkeypatch.setattr(flash_module, "BLOCK_KV", 1)
    out, lse = flash_attention_lse_reference(q, k, v, 1e10)
    torch.testing.assert_close(out[0, :, 0], v[0, 0, 1:].mean(0).expand(3, 4))
    torch.testing.assert_close(lse, torch.full((1, 1, 3), float(np.log(2))))


def test_flash_function_saves_no_t_by_t_tensor():
    """The flash path saves exactly (q, k, v, out, lse) per attention, and
    a whole attention module on it saves nothing of size (T, T)."""
    B, H, T, D = 2, 2, 1025, 32
    q, k, v, g, scale = _inputs(B, H, T, D, seed=4)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        out = flash_attention(*leaves, scale)
    assert sorted(saved) == sorted([(B, H, T, D)] * 3 + [(B, T, H, D),
                                                         (B, H, T)])
    torch.autograd.grad(out, leaves, torch.from_numpy(g))

    m = MultiHeadSelfAttention(64, 2, generator=torch.Generator(),
                               pallas_kernel="")
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, T, 64)).astype(np.float32))
    saved.clear()
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        y = m(x.requires_grad_())
    assert y.shape == (B, T, 64) and saved
    assert not any(len(s) >= 2 and s[-2:] == (T, T) for s in saved), saved


@pytest.mark.parametrize("T,D,kernel,training,want", [
    (65, 32, "", False, "fused"),        # the flagship ViT, serving
    (65, 32, None, True, "fused"),       # the flagship ViT, training
    (1025, 32, "", False, "flash"),      # the pixel-token ViT, serving
    (1025, 32, None, True, "flash"),     # the pixel-token ViT, training
    (792, 32, "", False, "fused"),       # the last T the forward holds
    (793, 32, "", False, "flash"),
    (685, 32, "", True, "fused"),        # the last T dk/dv holds
    (686, 32, "", True, "flash"),
    (215, 128, "", False, "fused"),
    (216, 128, "", False, "flash"),
    (65, 32, "flash", True, "flash"),    # forced: any T
    (4096, 128, "flash", False, "flash"),
    (1025, 32, "einsum", True, "einsum"),
    (65, 32, "einsum", False, "einsum"),
    (700, 32, "fused", False, "fused"),
])
def test_route(T, D, kernel, training, want):
    assert route(T, D, kernel, training) == want
    if kernel in ("", None):
        assert whole_head_fits(T, D, training) == (want == "fused")


@pytest.mark.parametrize("T,D,training", [(1025, 32, False), (700, 32, True),
                                          (4096, 128, False)])
def test_route_refuses_fused_beyond_shared_memory(T, D, training):
    with pytest.raises(ValueError, match="fused"):
        route(T, D, "fused", training)


def test_pixel_token_attention_module_routes_to_flash_and_matches_einsum():
    """The default module at T=1025 takes the tiled path (on the CPU its
    plain version) and agrees with the einsum path on the same weights."""
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 1025, 64)).astype(np.float32))
    kw = dict(generator=torch.Generator().manual_seed(0))
    m = MultiHeadSelfAttention(64, 2, **kw)
    ref = MultiHeadSelfAttention(64, 2, pallas_kernel="einsum", **kw)
    ref.load_state_dict(m.state_dict())
    before = flash_attention.launches
    with torch.no_grad():
        np.testing.assert_allclose(m(x).numpy(), ref(x).numpy(), rtol=1e-4,
                                   atol=1e-5)
    assert flash_attention.launches == before  # the CPU launches nothing


def test_flash_wrappers_check_their_inputs():
    q, k, v, g, scale = _inputs(1, 2, 9, 16, seed=7)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = flash_attention_lse(tq, tk, tv, scale)
    with pytest.raises(ValueError):
        flash_attention(tq, tk[:, :, :5], tv, scale)
    with pytest.raises(ValueError):
        flash_attention_lse(tq.half(), tk.half(), tv.half(), scale)
    for fn in (flash_tiled_bwd_dq, flash_tiled_bwd_dkv):
        with pytest.raises(ValueError):
            fn(tq, tk, tv, out.transpose(1, 2), tg, lse, scale)
        with pytest.raises(ValueError):
            fn(tq, tk, tv, out, tg, lse[..., None], scale)


def test_flash_wrappers_are_registered_and_the_cpu_counts_no_launch():
    assert {"flash_fwd": flash_attention, "flash_fwd_lse": flash_attention_lse,
            "flash_bwd_dq_tiled": flash_tiled_bwd_dq,
            "flash_bwd_dkv_tiled": flash_tiled_bwd_dkv}.items() \
        <= KERNEL_WRAPPERS.items()
    before = {n: w.launches for n, w in KERNEL_WRAPPERS.items()}
    q, k, v, g, scale = _inputs(1, 2, 9, 16, seed=8)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    torch.autograd.grad(FlashAttentionFunction.apply(*leaves, scale),
                        leaves, torch.from_numpy(g))
    assert {n: w.launches for n, w in KERNEL_WRAPPERS.items()} == before
