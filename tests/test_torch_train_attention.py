"""The port's training attention -- the whole-head forward with logsumexp,
the tiled dq and dk/dv passes that its backward runs (as the JAX ``_bwd``
runs ``_flash_bwd_impl``), and the autograd Function around them -- against
the JAX package's ``fused_attention`` and its custom VJP, on the CPU.

Inputs and cotangents are made with numpy from a seed and fed to both
sides.  The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_pallas_attention.py`` runs them.  In f32 only the order of sums
differs, hence rtol 1e-4 / atol 1e-5; in bf16 each side rounds its output
(and the forward output the backward reads) to bf16, so results may differ
by a bf16 rounding step (2**-7 relative), hence 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cifar_torch.ops.cuda import KERNEL_WRAPPERS
from vit_cifar_torch.ops.cuda import flash_attention as flash_module
from vit_cifar_torch.ops.cuda.attention import (
    FusedAttentionFunction, fused_attention, fused_attention_lse,
    fused_attention_lse_reference, fused_attention_reference)
from vit_cifar_torch.ops.cuda.flash_attention import (
    flash_tiled_bwd_dkv, flash_tiled_bwd_dkv_reference, flash_tiled_bwd_dq,
    flash_tiled_bwd_dq_reference)
from vit_cifar_tpu.ops.pallas.attention import \
    _fused_attention_fwd_impl as jax_fwd_impl
from vit_cifar_tpu.ops.pallas.attention import \
    fused_attention as jax_fused_attention
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

# the JAX kernel tests' ragged shapes (odd T, D < 128, T over one tile)
SHAPES = [(2, 4, 9, 16), (2, 3, 65, 32), (1, 2, 130, 64), (2, 2, 96, 128)]
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
shape_ids = pytest.mark.parametrize(
    "shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
dtype_ids = pytest.mark.parametrize("dtype", sorted(DTYPES))


def _f32(t):
    return np.asarray(t.to(torch.float32).detach() if isinstance(
        t, torch.Tensor) else jnp.asarray(t, jnp.float32))


def _inputs(shape, seed=0):
    """q, k, v (B, H, T, D) and a cotangent g (B, T, H, D), f32 numpy."""
    B, H, T, D = shape
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    g = rng.normal(size=(B, T, H, D)).astype(np.float32)
    return q, k, v, g, 1.0 / np.sqrt(H * D)


@dtype_ids
@shape_ids
def test_forward_with_lse_matches_jax(shape, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    B, H, T, D = shape
    q, k, v, _, scale = _inputs(shape)
    jout, jlse = jax_fwd_impl(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                              scale, with_lse=True)
    want_lse = np.asarray(jlse)[:, :, :T, 0]  # drop the TPU's padding
    want_out = _f32(jnp.asarray(jout).transpose(0, 2, 1, 3))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    for fn in (fused_attention_lse_reference, fused_attention_lse):
        out, lse = fn(tq, tk, tv, scale)
        assert out.shape == (B, T, H, D) and out.dtype == tdt
        assert lse.shape == (B, H, T) and lse.dtype == torch.float32
        np.testing.assert_allclose(lse.numpy(), want_lse, **tol,
                                   err_msg=fn.__name__)
        np.testing.assert_allclose(_f32(out), want_out, **tol,
                                   err_msg=fn.__name__)
    # the training forward's output is the inference forward's
    np.testing.assert_allclose(
        _f32(fused_attention_lse(tq, tk, tv, scale)[0]),
        _f32(fused_attention_reference(tq, tk, tv, scale)), **tol)


@dtype_ids
@shape_ids
def test_backward_passes_match_jax_vjp(shape, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, g, scale = _inputs(shape, seed=1)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: jax_fused_attention(a, b, c, scale),
                     jq, jk, jv)
    want = [_f32(w) for w in vjp(jg)]

    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    out, lse = fused_attention_lse(tq, tk, tv, scale)
    # the tiled passes on the whole-head forward's residuals
    plain = [flash_tiled_bwd_dq_reference(tq, tk, tv, out, tg, lse, scale),
             *flash_tiled_bwd_dkv_reference(tq, tk, tv, out, tg, lse, scale)]
    wrapped = [flash_tiled_bwd_dq(tq, tk, tv, out, tg, lse, scale),
               *flash_tiled_bwd_dkv(tq, tk, tv, out, tg, lse, scale)]
    leaves = [a.clone().requires_grad_() for a in (tq, tk, tv)]
    through_function = torch.autograd.grad(
        fused_attention(*leaves, scale), leaves, tg)
    for how, got in (("plain", plain), ("wrapper", wrapped),
                     ("Function", through_function)):
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert a.shape == shape and a.dtype == tdt
            np.testing.assert_allclose(_f32(a), w, **tol,
                                       err_msg=f"{name} via {how}")


@pytest.mark.parametrize("shape", [(2, 3, 65, 32), (1, 2, 257, 192)],
                         ids=lambda s: "x".join(map(str, s)))
def test_function_backward_runs_the_tiled_pair_and_matches_jax(shape,
                                                              monkeypatch):
    """``FusedAttentionFunction``'s grads against ``jax.vjp`` of JAX's
    ``fused_attention`` in f32 (rtol 1e-4 / atol 1e-5) at the flagship's
    head and at head_dim 192, which the tiled passes cut into column chunks
    on the card; a spy shows that the backward runs ``flash_tiled_bwd_dq``
    and then ``flash_tiled_bwd_dkv``, once each, as the JAX ``_bwd`` runs
    ``_flash_bwd_impl``."""
    q, k, v, g, scale = _inputs(shape, seed=7)
    _, vjp = jax.vjp(lambda a, b, c: jax_fused_attention(a, b, c, scale),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    calls = []

    def spy(fn):
        def wrapped(*args):
            calls.append(fn.__name__)
            return fn(*args)
        return wrapped

    # the backward both Functions share (``AttentionFunction``) calls the
    # passes of flash_attention.py
    for name in ("flash_tiled_bwd_dq", "flash_tiled_bwd_dkv"):
        monkeypatch.setattr(flash_module, name,
                            spy(getattr(flash_module, name)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fused_attention(*leaves, scale)
    assert out.grad_fn.name() == "FusedAttentionFunctionBackward"
    assert calls == []
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert calls == ["flash_tiled_bwd_dq", "flash_tiled_bwd_dkv"]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), w, **F32_TOL, err_msg=name)


def test_function_matches_autograd_of_the_plain_forward():
    q, k, v, g, scale = _inputs((2, 3, 17, 8), seed=2)
    tq, tk, tv, tg = (torch.from_numpy(a).double() for a in (q, k, v, g))

    def grads(fn):
        leaves = [a.float().clone().requires_grad_() for a in (tq, tk, tv)]
        return torch.autograd.grad(fn(*leaves, scale), leaves, tg.float())

    for a, w in zip(grads(fused_attention), grads(fused_attention_reference)):
        torch.testing.assert_close(a, w, **F32_TOL)


def test_function_saves_only_q_k_v_out_and_lse():
    B, H, T, D = 2, 3, 65, 32
    q, k, v, g, scale = _inputs((B, H, T, D), seed=3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        out = fused_attention(*leaves, scale)
    assert out.grad_fn.name() == "FusedAttentionFunctionBackward"
    assert sorted(saved) == sorted([(B, H, T, D)] * 3 + [(B, T, H, D),
                                                         (B, H, T)])
    assert not any(s[-2:] == (T, T) for s in saved)  # no (B,H,T,T) residual
    torch.autograd.grad(out, leaves, torch.from_numpy(g))


def test_scale_gets_no_gradient_and_inference_skips_the_function():
    q, k, v, _, scale = _inputs((1, 2, 9, 16), seed=4)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    assert fused_attention(tq, tk, tv, scale).grad_fn is None
    leaf = tq.clone().requires_grad_()
    with torch.no_grad():
        assert fused_attention(leaf, tk, tv, scale).grad_fn is None
    out = FusedAttentionFunction.apply(leaf, tk, tv, scale)
    (dq,) = torch.autograd.grad(out.sum(), [leaf])
    assert dq.shape == leaf.shape


@pytest.mark.parametrize("bad", ["o_layout", "do_dtype", "lse_shape"])
def test_backward_wrappers_check_their_inputs(bad):
    B, H, T, D = 1, 2, 9, 16
    q, k, v, g, scale = _inputs((B, H, T, D), seed=5)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = fused_attention_lse(tq, tk, tv, scale)
    if bad == "o_layout":
        out = out.transpose(1, 2)  # (B, H, T, D), not (B, T, H, D)
    elif bad == "do_dtype":
        tg = tg.to(torch.bfloat16)
    else:
        lse = lse[..., None]
    for fn in (flash_tiled_bwd_dq, flash_tiled_bwd_dkv):
        with pytest.raises(ValueError):
            fn(tq, tk, tv, out, tg, lse, scale)


def test_cpu_training_attention_counts_no_launch():
    before = {n: w.launches for n, w in KERNEL_WRAPPERS.items()}
    q, k, v, g, scale = _inputs((1, 2, 9, 16), seed=6)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    torch.autograd.grad(fused_attention(*leaves, scale), leaves,
                        torch.from_numpy(g))
    assert {n: w.launches for n, w in KERNEL_WRAPPERS.items()} == before
    assert set(KERNEL_WRAPPERS) == {"mhsa_fwd", "mhsa_fwd_lse", "flash_fwd",
                                    "flash_fwd_lse", "flash_bwd_dq_tiled",
                                    "flash_bwd_dkv_tiled"}
