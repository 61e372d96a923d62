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
                                                fused_attention_reference)
from vit_cifar_torch.utils.transplant import state_dict_from_flax
from vit_cifar_tpu.ops.attention import \
    MultiHeadSelfAttention as JaxMultiHeadSelfAttention
from vit_cifar_tpu.ops.pallas.attention import \
    fused_attention as jax_fused_attention

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
