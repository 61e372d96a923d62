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

``wgmma_forward_model`` models the arithmetic of the bf16 forwards
(``csrc/wgmma_attention.cuh``): the key tile of each forward's dispatch
(the whole head as one tile of N = round_up(T, 8) in the whole-head grid,
tiles of 128 to 32 keys, last to first, in the tiled one; past 256
columns each chunk of o a work item of its own; past 512 the streamed
instance, s summed over 64-column chunks of q and K), the exponent as one
FFMA, and the hi/lo p.v.  ``wgmma_backward_model`` models the tiled
backward pair (``csrc/wgmma_backward.cuh``, with the tiles of
``csrc/backward_tiles.cuh``; past 512 columns the streamed instances, s
and dp summed over 64-column chunks).  Either model takes the streamed
shape at any width on request, so that it is held against JAX where
JAX's interpret mode is cheap.  No CPU can run the kernels; the models
are held against JAX's kernels in bf16 and against the plain versions at
ragged T: lse within 1e-5, outputs and grads within one bf16 step, and
before their rounding within 1e-5 of the largest value of the f32 plain
versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cifar_torch.ops import attention as attention_module
from vit_cifar_torch.ops.attention import MultiHeadSelfAttention, route
from vit_cifar_torch.ops.cuda import flash_attention as flash_module
from vit_cifar_torch.ops.cuda import KERNEL_WRAPPERS
from vit_cifar_torch.ops.cuda.attention import (
    fused_attention_lse_reference, fused_attention_reference)
from vit_cifar_torch.ops.cuda.common import (
    BWD_STREAMED, COL_CHUNK, STREAM_COLS, STREAMED, WHOLE_F32_KEYS,
    WHOLE_KEYS, WIDEST_BACKWARD, WIDEST_FORWARD, WIDEST_ONE_PASS,
    backward_plan, f32_forward_plan, forward_plan, streamed_row,
    whole_head_holds)
from vit_cifar_torch.ops.cuda.flash_attention import (
    FlashAttentionFunction, flash_attention, flash_attention_lse,
    flash_attention_lse_reference, flash_attention_reference,
    flash_tiled_bwd_dkv, flash_tiled_bwd_dkv_reference, flash_tiled_bwd_dq,
    flash_tiled_bwd_dq_reference)
from vit_cifar_torch.utils.transplant import state_dict_from_flax
from vit_cifar_tpu.ops.attention import \
    MultiHeadSelfAttention as JaxMultiHeadSelfAttention
from vit_cifar_tpu.ops.pallas.attention import \
    _flash_forward_impl as jax_flash_forward_impl
from vit_cifar_tpu.ops.pallas.attention import \
    _fused_attention_fwd_impl as jax_fused_forward_impl
from vit_cifar_tpu.ops.pallas.attention import \
    fused_attention as jax_fused_attention
from vit_cifar_tpu.ops.pallas.attention import \
    flash_attention as jax_flash_attention
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

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


# heads wider than the kernels' 128-column chunks, at ragged T: the JAX
# kernels pad D to a multiple of 128 (``_flash_tiles``), the port's kernels
# cut it into chunks; the plain versions take any D as it is
WIDE_CASES = [(1, 2, 130, 192, 64, 64), (2, 1, 97, 256, 32, 128)]


@pytest.mark.parametrize("case", WIDE_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_tiled_plain_versions_past_128_columns_match_jax(case, monkeypatch):
    """The forward with lse and the tiled dq and dk/dv passes (plain
    versions; on the CPU the wrappers are the same) against JAX's
    ``flash_attention`` and ``jax.vjp`` of it at head_dim 192 and 256, in
    f32 at rtol 1e-4 / atol 1e-5."""
    B, H, T, D, bq, bk = case
    assert D > COL_CHUNK
    monkeypatch.setattr(flash_module, "BLOCK_KV", bk)
    q, k, v, g, scale = _inputs(B, H, T, D, seed=13)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, scale,
                                                            bq, bk), jq, jk, jv)
    want_grads = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    _, jlse = jax_flash_forward_impl(jq, jk, jv, scale, bq, bk, with_lse=True)

    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    for fn in (flash_attention_lse_reference, flash_attention_lse):
        out, lse = fn(tq, tk, tv, scale)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **GRAD_TOL,
                                   err_msg=fn.__name__)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, :T, 0],
                                   **GRAD_TOL, err_msg=fn.__name__)
    args = (tq, tk, tv, out, tg, lse, scale)
    for how, got in (("plain", [flash_tiled_bwd_dq_reference(*args),
                                *flash_tiled_bwd_dkv_reference(*args)]),
                     ("wrapper", [flash_tiled_bwd_dq(*args),
                                  *flash_tiled_bwd_dkv(*args)])):
        for name, a, w in zip(("dq", "dk", "dv"), got, want_grads):
            assert a.shape == (B, H, T, D)
            np.testing.assert_allclose(a.numpy(), w, **GRAD_TOL,
                                       err_msg=f"{name} via {how}")


LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _qk(q, k, streamed: bool):
    """q.k^T of f32 (B, H, T, D) tensors; ``streamed``: summed over
    64-column chunks in turn, as the streamed instances add each chunk's
    product into s."""
    if not streamed:
        return torch.einsum("bhid,bhjd->bhij", q, k)
    D = q.shape[-1]
    s = 0
    for c0 in range(0, D, STREAM_COLS):
        s = s + torch.einsum("bhid,bhjd->bhij", q[..., c0:c0 + STREAM_COLS],
                             k[..., c0:c0 + STREAM_COLS])
    return s


def wgmma_forward_model(q, k, v, scale: float, name: str,
                        streamed: bool = False):
    """A torch model of the arithmetic of the bf16 wgmma forward
    (``csrc/wgmma_attention.cuh``) as forward ``name`` (``mhsa_fwd`` or
    ``flash_fwd``) dispatches it at q's (T, D): keys in tiles of the plan's
    width (``forward_plan``: the whole head as one tile of N =
    round_up(T, 8), rounded up to an instance width, in the whole-head
    grid, so its softmax is exact; else tiles of ``TILED_KEYS`` keys, taken
    last to first as the kernel's ring brings them), s = q.k^T of bf16
    values summed in f32, the running
    max m of the scaled logits in log2 units, rn(max(s) * c) with c =
    scale*log2(e), each exponent one FFMA into exp2, exp2(s*c - m) (the
    FFMA's single rounding modelled in f64), the ``safe_m``/``corr`` guard,
    p split into bf16 hi + lo and both multiplied into v, and lse =
    m*ln(2) + log(l).  Each chunk of o of the plan's ``cols`` columns (the
    whole head up to 256 columns, one chunk; past it ``chunks`` of them,
    the last ragged) is a work item of its own: s over the whole head
    again, the same key tiles in the same order, p.v from the chunk's own
    columns of v; lse is the first chunk's.  Past 512 columns (the
    streamed grid), or at any width with ``streamed``, the key tile and
    chunks of o of the ``STREAMED`` row the width takes, s summed over
    64-column chunks.
    Returns (out (B, T, H, D) bf16, lse (B, H, T) f32, and out before its
    rounding to bf16)."""
    B, H, T, D = q.shape
    plan = forward_plan(name, T, D)
    streamed = streamed or plan["grid"] == "streamed"
    keys, cols = (streamed_row(D) if streamed
                  else (plan["rows"]["k"], plan["cols"]))
    qf, kf, vf = (a.to(torch.float32) for a in (q, k, v))
    c = float(np.float32(scale) * np.float32(LOG2E))
    out = torch.empty((B, H, T, D))
    for c0 in range(0, D, cols):  # a work item each chunk of o
        m = torch.full((B, H, T, 1), -torch.inf)
        l = torch.zeros((B, H, T, 1))
        acc = torch.zeros((B, H, T, min(cols, D - c0)))
        for k0 in reversed(range(0, T, keys)):  # last tile first
            kt = kf[:, :, k0:k0 + keys]
            vt = vf[:, :, k0:k0 + keys, c0:c0 + cols]
            s = _qk(qf, kt, streamed)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * c)
            safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp2(m - safe_m),
                               0.0)
            p = torch.exp2((s.double() * c
                            - safe_m.double()).to(torch.float32))
            l = l * corr + p.sum(dim=-1, keepdim=True)
            hi = p.to(torch.bfloat16).to(torch.float32)
            lo = (p - hi).to(torch.bfloat16).to(torch.float32)
            acc = acc * corr + torch.einsum("bhij,bhjd->bhid", hi, vt) \
                + torch.einsum("bhij,bhjd->bhid", lo, vt)
            m = m_new
        out[..., c0:c0 + cols] = acc / l
        if c0 == 0:
            lse = (m * LN2 + torch.log(l)).squeeze(-1)
    out = out.transpose(1, 2)
    return out.to(torch.bfloat16), lse, out


def _bf16_inputs(B, H, T, D, seed):
    """q, k, v rounded to bf16, as numpy f32 (exact) and torch bf16."""
    q, k, v, _, scale = _inputs(B, H, T, D, seed)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    return [a.to(torch.float32).numpy() for a in t], t, scale


def _assert_within_one_bf16_step(got, want, what):
    """|got - want| <= the bf16 spacing at want, 2**(floor(log2|want|) - 7),
    plus 2e-6 of max |want|: near zero one bf16 step is finer than the f32
    sums' own difference before rounding."""
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                   - 7)
    worst = np.max(np.abs(got - want)
                   / (step + 2e-6 * np.abs(want).max()))
    assert worst <= 1.0, f"{what}: {worst:.2f} bf16 steps apart"


@cases
@pytest.mark.parametrize("path", ["flash", "fused"])
def test_mma_forward_model_matches_jax_in_bf16(case, path):
    """The bf16 forwards' arithmetic, modelled in torch -- the wgmma
    forward's as each forward tiles the case, and the streamed instance's
    (s summed over 64-column chunks, its key tile and chunks of o) at the
    case's width -- against
    JAX's ``flash_attention`` (at the case's tile split) and
    ``fused_attention`` in interpret mode on the same bf16 inputs: lse
    within 1e-5, the bf16 output within one bf16 step, and the output
    before rounding within 1e-5 of max |out| of the plain f32 version's --
    the hi/lo split keeps p.v at f32 accuracy (p rounded to bf16 alone
    misses by about 1e-3)."""
    B, H, T, D, bq, bk = case
    (q, k, v), (tq, tk, tv), scale = _bf16_inputs(B, H, T, D, seed=9)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    if path == "flash":
        jout, jlse = jax_flash_forward_impl(jq, jk, jv, scale, bq, bk,
                                            with_lse=True)
        want = np.asarray(jax_flash_attention(jq, jk, jv, scale, bq, bk),
                          np.float32)
    else:
        jout, jlse = jax_fused_forward_impl(jq, jk, jv, scale, with_lse=True)
        want = np.asarray(jax_fused_attention(jq, jk, jv, scale), np.float32)
    want_lse = np.asarray(jlse)[:, :, :T, 0]
    assert jout.dtype == jnp.bfloat16

    exact = flash_attention_lse_reference(*(torch.from_numpy(a)
                                            for a in (q, k, v)), scale)[0]
    name = "flash_fwd" if path == "flash" else "mhsa_fwd"
    for model, (out, lse, unrounded) in (
            ("streamed", wgmma_forward_model(tq, tk, tv, scale, name,
                                             streamed=True)),
            ("wgmma", wgmma_forward_model(tq, tk, tv, scale, name))):
        assert out.shape == (B, T, H, D) and lse.shape == (B, H, T)
        np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5,
                                   atol=1e-5, err_msg=model)
        _assert_within_one_bf16_step(out.to(torch.float32).numpy(), want,
                                     f"{model} {path}")
        np.testing.assert_allclose(unrounded.numpy(), exact.numpy(), rtol=0,
                                   atol=1e-5 * exact.abs().max().item(),
                                   err_msg=model)


# (B, H, T, D, block_q, block_kv): heads past wgmma's widest N, at ragged T
# -- the wgmma forward's column chunks up to 512 columns (two chunks of
# 192 columns at 320 and 384, of 256 at 512), and the streamed instance
# past them (D % 64 == 8, D % 8 == 2, and one chunk of the sum past 640)
WIDE_CASES = [(1, 2, 77, 320, 1024, 512), (1, 1, 130, 384, 64, 128),
              (1, 2, 65, 512, 1024, 512), (1, 1, 77, 520, 1024, 128),
              (1, 2, 33, 522, 1024, 512), (1, 1, 97, 704, 64, 64)]


@pytest.mark.parametrize("case", WIDE_CASES,
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("path", ["flash", "fused"])
def test_chunked_forward_models_match_jax_in_bf16(case, path):
    """The bf16 forwards past 256 columns, modelled in torch as each forward
    dispatches the case -- the wgmma forward's column chunks (s over the
    whole head, each chunk of o from its own columns of v, the kernel's
    key tiles last to first) up to 512 columns, the streamed instance (s
    summed over 64-column chunks of q and K) past them -- against JAX's
    ``flash_attention`` (at the case's tile split) and ``fused_attention``
    in interpret mode on the same bf16 inputs: lse within 1e-5, the bf16
    output within one bf16 step, and the output before rounding within
    1e-5 of max |out| of the plain f32 version's."""
    B, H, T, D, bq, bk = case
    (q, k, v), (tq, tk, tv), scale = _bf16_inputs(B, H, T, D, seed=12)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    if path == "flash":
        jlse = jax_flash_forward_impl(jq, jk, jv, scale, bq, bk,
                                      with_lse=True)[1]
        want = np.asarray(jax_flash_attention(jq, jk, jv, scale, bq, bk),
                          np.float32)
    else:
        jlse = jax_fused_forward_impl(jq, jk, jv, scale, with_lse=True)[1]
        want = np.asarray(jax_fused_attention(jq, jk, jv, scale), np.float32)
    want_lse = np.asarray(jlse)[:, :, :T, 0]

    name = "flash_fwd" if path == "flash" else "mhsa_fwd"
    plan = forward_plan(name, T, D)
    assert (plan["grid"] == "streamed") == (D > 512)
    assert plan["chunks"] == -(-D // plan["cols"]) >= 2
    out, lse, unrounded = wgmma_forward_model(tq, tk, tv, scale, name)
    exact = flash_attention_lse_reference(*(torch.from_numpy(a)
                                            for a in (q, k, v)), scale)[0]
    assert out.shape == (B, T, H, D) and lse.shape == (B, H, T)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)
    _assert_within_one_bf16_step(out.to(torch.float32).numpy(), want,
                                 f"{name} D={D}")
    np.testing.assert_allclose(unrounded.numpy(), exact.numpy(), rtol=0,
                               atol=1e-5 * exact.abs().max().item())


@pytest.mark.parametrize("T", [1, 7, 8, 15, 16, 17, 63, 64, 65, 66, 127, 128,
                               129])
def test_mma_forward_model_matches_the_plain_versions_at_ragged_edges(T):
    """The streamed instance's key tiles and 64-column chunks of the sum
    end at every T of the card's ragged-edge phase; its model (forced to
    the streamed shape below 512 columns) stays within one bf16 step and
    1e-5 of lse of the plain versions, at head dims that are and are not a
    multiple of 16, and past 512 columns, where the instance runs."""
    for D in (16, 24, 32, 64, 128, 520):
        _, (tq, tk, tv), scale = _bf16_inputs(1, 2, T, D, seed=T + D)
        out, lse, _ = wgmma_forward_model(tq, tk, tv, scale, "flash_fwd",
                                          streamed=True)
        for plain in (fused_attention_lse_reference,
                      flash_attention_lse_reference):
            want_out, want_lse = plain(tq, tk, tv, scale)
            torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
            _assert_within_one_bf16_step(out.to(torch.float32).numpy(),
                                         want_out.to(torch.float32).numpy(),
                                         f"{plain.__name__} T={T} D={D}")


@pytest.mark.parametrize("D", [8, 32, 100, 128, 192, 256, 320, 456, 512,
                               522, 704])
@pytest.mark.parametrize("T", [1, 7, 64, 65, 127, 257])
def test_wgmma_forward_model_matches_the_plain_versions(T, D):
    """The wgmma forward's key tiles end at every T here: the whole-head
    grid's one tile of 16 to 128 keys and the tiled grid's tiles of 32 to
    128 keys, taken last to first; for both forwards the model
    stays within one bf16 step and 1e-5 of lse of both plain versions, at
    head dims that are and are not a multiple of 8 and 16, up to the widest
    one-pass head, past it in column chunks up to 512 columns (the last
    chunk ragged at 320 and 456), and past 512 streamed."""
    _, (tq, tk, tv), scale = _bf16_inputs(1, 2, T, D, seed=3 * T + D)
    wants = [plain(tq, tk, tv, scale) for plain in (
        fused_attention_lse_reference, flash_attention_lse_reference)]
    models = {}  # past the table both forwards take the one streamed plan
    for name in ("mhsa_fwd", "flash_fwd"):
        plan = forward_plan(name, T, D)
        key = name if plan["grid"] != "streamed" else "streamed"
        if key not in models:
            models[key] = wgmma_forward_model(tq, tk, tv, scale, name)
        out, lse, _ = models[key]
        for want_out, want_lse in wants:
            torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
            _assert_within_one_bf16_step(out.to(torch.float32).numpy(),
                                         want_out.to(torch.float32).numpy(),
                                         f"{name} T={T} D={D}")


def test_wgmma_forward_model_tiles_as_the_dispatch_does():
    """The key tile of each forward: the whole head as one tile of N =
    round_up(T, 8), as an instance width (72 at the flagship's T=65), in
    the whole-head grid of ``mhsa_fwd`` up to 128 keys at 32 columns, 96
    at 64 and 64 at 128; tiles of 128, 96, 64, 64 and 32 keys at 32, 64,
    128, 192 and 256 columns in the tiled grid, which ``flash_fwd`` always
    takes and ``mhsa_fwd`` past those; past 256 columns the tiled grid in
    two chunks of o a query tile (192 columns and 64 keys at width 320,
    192 and 32 at 384, 256 and 16 at 448 and 512); past 512 columns the
    streamed grid of the ``STREAMED`` row at every width."""
    def keys(name, T, D):
        plan = forward_plan(name, T, D)
        return plan["grid"], plan["rows"]["k"], plan["rows"]["v"]

    assert keys("mhsa_fwd", 65, 32) == ("whole", 72, 80)
    assert keys("mhsa_fwd", 9, 16) == ("whole", 16, 16)
    assert keys("mhsa_fwd", 128, 32) == ("whole", 128, 128)
    assert keys("mhsa_fwd", 33, 64) == ("whole", 64, 64)
    assert keys("mhsa_fwd", 73, 64) == ("whole", 96, 96)
    assert keys("mhsa_fwd", 64, 128) == ("whole", 64, 64)
    assert keys("mhsa_fwd", 65, 128) == ("tiled", 64, 64)
    assert keys("mhsa_fwd", 97, 64) == ("tiled", 96, 96)
    assert keys("mhsa_fwd", 129, 32) == ("tiled", 128, 128)
    assert keys("mhsa_fwd", 65, 136) == ("tiled", 64, 64)
    assert keys("flash_fwd", 65, 32) == ("tiled", 128, 128)
    assert keys("flash_fwd", 512, 64) == ("tiled", 96, 96)
    assert keys("flash_fwd", 512, 128) == ("tiled", 64, 64)
    assert keys("flash_fwd", 1025, 256) == ("tiled", 32, 32)

    def chunks(name, T, D):
        plan = forward_plan(name, T, D)
        return (plan["grid"], plan["width"], plan["rows"]["k"],
                plan["cols"], plan["chunks"], plan["items"])

    assert chunks("flash_fwd", 1025, 256) == ("tiled", 256, 32, 256, 1, 9)
    assert chunks("mhsa_fwd", 65, 128) == ("tiled", 128, 64, 128, 1, 1)
    assert chunks("flash_fwd", 65, 257) == ("tiled", 320, 64, 192, 2, 2)
    assert chunks("mhsa_fwd", 65, 320) == ("tiled", 320, 64, 192, 2, 2)
    assert chunks("mhsa_fwd", 65, 384) == ("tiled", 384, 32, 192, 2, 2)
    assert chunks("flash_fwd", 512, 384) == ("tiled", 384, 32, 192, 2, 8)
    assert chunks("flash_fwd", 130, 400) == ("tiled", 448, 16, 256, 2, 4)
    assert chunks("mhsa_fwd", 9, 456) == ("tiled", 512, 16, 256, 2, 2)
    assert chunks("flash_fwd", 1025, 512) == ("tiled", 512, 16, 256, 2, 18)
    assert forward_plan("flash_fwd", 65, 513)["grid"] == "streamed"
    assert forward_plan("mhsa_fwd", 65, 520)["grid"] == "streamed"
    assert (WIDEST_ONE_PASS, WIDEST_FORWARD) == (256, 512)
    for name in ("mhsa_fwd", "flash_fwd"):
        assert forward_plan(name, 65, WIDEST_ONE_PASS)["chunks"] == 1
        assert forward_plan(name, 65, WIDEST_ONE_PASS + 1)["chunks"] == 2
        assert forward_plan(name, 65, WIDEST_FORWARD)["chunks"] == 2
        assert forward_plan(name, 65, WIDEST_FORWARD)["grid"] == "tiled"
        assert forward_plan(name, 65,
                            WIDEST_FORWARD + 1)["grid"] == "streamed"


@pytest.mark.parametrize("D", [513, 520, 640, 704, 1040, 2048])
def test_plans_past_the_table_stream_at_any_width(D):
    """Past the tables' widest rows both forwards and the backward pair
    have a plan at every width: the streamed rows' tiles and chunks of the
    outputs (the last ragged; the forward's first ``STREAMED`` row of
    width >= D, or the last), D rounded up to the 64-column chunks of the
    sums over it, 128-byte swizzle, and the work items a head."""
    keys, cols = next((row for w, row in STREAMED.items() if D <= w),
                      STREAMED[max(STREAMED)])
    assert (keys, cols) == streamed_row(D)
    for name in ("mhsa_fwd", "flash_fwd"):
        for T in (1, 65, 1025):
            plan = forward_plan(name, T, D)
            assert plan["grid"] == "streamed" and not plan["pingpong"]
            assert plan["width"] == -(-D // 64) * 64 >= D
            assert (plan["swizzle"], plan["atom_cols"]) == (128, 64)
            assert plan["rows"] == {"q": 128, "k": keys,
                                    "v": -(-keys // 16) * 16}
            assert plan["cols"] == cols and plan["chunks"] == -(-D // cols)
            assert plan["items"] == -(-T // 128) * plan["chunks"]
    assert D > WIDEST_BACKWARD
    for T in (1, 65, 1025):
        plan = backward_plan(T, D)
        assert plan["width"] == -(-D // 64) * 64
        for kind in ("dq", "dkv"):
            tile, cols = BWD_STREAMED[kind]
            cut = plan[kind]
            assert cut["streamed"] and cut["split"] and cut["rows"] == 64
            assert (cut["tile"], cut["cols"]) == (tile, cols)
            assert cut["chunks"] == -(-D // cols)
            assert cut["items"] == -(-T // 64) * -(-cut["chunks"] // 2)


def wgmma_backward_model(q, k, v, o, do, lse, scale: float,
                         streamed: bool = False):
    """A torch model of the arithmetic of the bf16 backward pair as its
    dispatch takes q's (T, D) (``backward_plan``, from the table of
    instances ``csrc/backward_tiles.cuh``): s = q.k^T and dp = do.v^T of
    bf16 values summed in f32; p = exp2(s*c - lse*log2(e)) as one FFMA
    (its single rounding modelled in f64) with c the f32 product
    scale*log2(e); delta = rowsum(do*o) and ds = p*(dp - delta)*scale in
    f32; p and ds split into bf16 hi = rn(x) and lo = rn(x - hi), both
    multiplied into k (dq, key tile by key tile, last to first), q (dk) and
    do (dv, query tile by query tile, first to last), each tile's hi then
    lo.  The tiles are the wgmma kernels' (the dq kernel's key tile, the
    dk/dv kernel's query tile; cutting the columns among consumers changes
    no sum); past 512 columns, or at any width with ``streamed``, the
    streamed rows' tiles, s and dp summed over 64-column chunks.  ``o``
    and ``do`` are (B, T, H, D), ``lse`` (B, H, T) f32.  Returns ((dq, dk,
    dv) in bf16, the same before their rounding)."""
    T, D = q.shape[2:]
    plan = backward_plan(T, D)
    streamed = streamed or plan["dq"]["streamed"]
    keys, queries = ((BWD_STREAMED["dq"][0], BWD_STREAMED["dkv"][0])
                     if streamed else
                     (plan["dq"]["tile"], plan["dkv"]["tile"]))
    qf, kf, vf = (a.to(torch.float32) for a in (q, k, v))
    of, dof = (a.to(torch.float32).transpose(1, 2) for a in (o, do))
    c = float(np.float32(scale) * np.float32(LOG2E))
    lse2 = lse[..., None] * float(np.float32(LOG2E))
    delta = (dof * of).sum(dim=-1, keepdim=True)
    s = _qk(qf, kf, streamed)
    p = torch.exp2((s.double() * c - lse2.double()).to(torch.float32))
    ds = p * (_qk(dof, vf, streamed) - delta) * scale

    def hi_lo(x):
        hi = x.to(torch.bfloat16).to(torch.float32)
        return hi, (x - hi).to(torch.bfloat16).to(torch.float32)

    dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    for k0 in reversed(range(0, T, keys)):  # dq: a key tile at a time
        t = slice(k0, k0 + keys)
        for half in hi_lo(ds[..., t]):
            dq += torch.einsum("bhij,bhjd->bhid", half, kf[:, :, t])
    for q0 in range(0, T, queries):  # dk, dv: a query tile at a time
        t = slice(q0, q0 + queries)
        for half in hi_lo(ds[:, :, t]):
            dk += torch.einsum("bhij,bhid->bhjd", half, qf[:, :, t])
        for half in hi_lo(p[:, :, t]):
            dv += torch.einsum("bhij,bhid->bhjd", half, dof[:, :, t])
    return tuple(a.to(torch.bfloat16) for a in (dq, dk, dv)), (dq, dk, dv)


def _bf16_cotangent(B, H, T, D, seed):
    return torch.from_numpy(_inputs(B, H, T, D, seed)[3]).to(torch.bfloat16)


def _plain_passes(*args):
    return (flash_tiled_bwd_dq_reference(*args),
            *flash_tiled_bwd_dkv_reference(*args))


def _check_backward_model_against_jax(case, shapes=(False,)):
    """The backward model, in each of ``shapes`` (``streamed`` or not),
    against ``jax.vjp`` of JAX's ``flash_attention`` at ``case``
    (interpret mode, at the case's tile split) on the same bf16 inputs,
    reading JAX's own forward output and lse: dq, dk and dv each within
    one bf16 step, and before rounding within 1e-5 of max |grad| of the f32
    plain passes."""
    B, H, T, D, bq, bk = case
    (q, k, v), (tq, tk, tv), scale = _bf16_inputs(B, H, T, D, seed=10)
    g = _bf16_cotangent(B, H, T, D, seed=11)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jg = jnp.asarray(g.to(torch.float32).numpy(), jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, scale, bq,
                                                         bk), jq, jk, jv)
    want = [np.asarray(w, np.float32) for w in vjp(jg)]
    jout, jlse = jax_flash_forward_impl(jq, jk, jv, scale, bq, bk,
                                        with_lse=True)
    o = torch.from_numpy(np.asarray(
        jout[:, :, :T, :D].transpose(0, 2, 1, 3), np.float32)).to(
            torch.bfloat16)
    lse = torch.from_numpy(np.asarray(jlse)[:, :, :T, 0].copy())

    exact = _plain_passes(*(a.to(torch.float32) for a in (tq, tk, tv, o, g)),
                          lse, scale)
    for streamed in shapes:
        got, unrounded = wgmma_backward_model(tq, tk, tv, o, g, lse, scale,
                                              streamed)
        for name, a, u, w, e in zip(("dq", "dk", "dv"), got, unrounded,
                                    want, exact):
            what = f"{name} D={D} streamed={streamed}"
            assert a.shape == (B, H, T, D) and a.dtype == torch.bfloat16
            _assert_within_one_bf16_step(a.to(torch.float32).numpy(), w,
                                         what)
            np.testing.assert_allclose(u.numpy(), e.numpy(), rtol=0,
                                       atol=1e-5 * e.abs().max().item(),
                                       err_msg=what)


@cases
def test_mma_backward_model_matches_jax_vjp_in_bf16(case):
    """The bf16 backward pair's arithmetic, modelled in torch as its
    dispatch tiles the case and in the streamed instances' shape, against
    ``jax.vjp`` of JAX's ``flash_attention`` (``_check_backward_model_
    against_jax``; the hi/lo split keeps p and ds at f32 accuracy: 2-5e-6
    apart here, where p and ds rounded to bf16 alone miss by about
    2e-3)."""
    _check_backward_model_against_jax(case, shapes=(False, True))


# (B, H, T, D, block_q, block_kv): the streamed backward past 512 columns
# at ragged T, D % 64 == 8, D % 8 == 2 and one chunk of the sum past 640
STREAMED_BWD_CASES = [(1, 1, 77, 520, 1024, 128), (1, 2, 33, 522, 1024, 512),
                      (1, 1, 97, 704, 64, 64)]


@pytest.mark.parametrize("case", STREAMED_BWD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_streamed_backward_model_matches_jax_vjp_in_bf16(case):
    """Past 512 columns, where the streamed instances run, their model
    against ``jax.vjp`` of JAX's ``flash_attention``
    (``_check_backward_model_against_jax``)."""
    assert backward_plan(*case[2:4])["dq"]["streamed"]
    _check_backward_model_against_jax(case)


@pytest.mark.parametrize("T", [1, 7, 8, 15, 16, 17, 63, 64, 65, 66, 127, 128,
                               129])
def test_mma_backward_model_matches_the_plain_passes_at_ragged_edges(T):
    """The pair's key and query tiles (32 to 96) and work items (64 and
    128 rows) end at every T of the card's ragged-edge phase; the model's
    grads, as the dispatch tiles each head and in the streamed instances'
    shape (their tiles, s and dp summed over 64-column chunks), stay
    within one bf16 step of the plain passes' at head dims that are and
    are not a multiple of 16.  At T=1 the softmax over one key is
    constant, so dq and dk are 0 in exact arithmetic and both sides return
    the rounding noise of dp - delta; a sum over D in chunks rounds
    otherwise than the plain passes' einsum, so the streamed shape is held
    there only from T=2 (the card's ragged-edge checks give that noise a
    floor)."""
    for D in (16, 24, 32, 64, 128):
        _, (tq, tk, tv), scale = _bf16_inputs(1, 2, T, D, seed=T + D)
        g = _bf16_cotangent(1, 2, T, D, seed=T + D + 1)
        o, lse = flash_attention_lse_reference(tq, tk, tv, scale)
        args = (tq, tk, tv, o, g, lse, scale)
        want = _plain_passes(*args)
        for streamed in (False, True) if T > 1 else (False,):
            got, _ = wgmma_backward_model(*args, streamed=streamed)
            for name, a, w in zip(("dq", "dk", "dv"), got, want):
                _assert_within_one_bf16_step(
                    a.to(torch.float32).numpy(), w.to(torch.float32).numpy(),
                    f"{name} T={T} D={D} streamed={streamed}")


def test_wgmma_backward_model_tiles_as_the_dispatch_does():
    """The backward pair's tiles by padded width, from the table its CUDA
    dispatch expands: the dq kernel's key tiles of 96 keys at 32 columns,
    64 at 64 and 128, 32 at 256 and 384 and 16 at 512; the dk/dv kernel's
    query tiles of 64 up to 128 columns, 32 at 256 and 384 and 16 at 512.
    Up to 128 columns a dq work item is 128 query rows
    and a dk/dv one 128 keys (64 at 128, its consumers splitting the
    columns); past 128 both cut the columns into chunks (dq 128, dk/dv 64)
    over 64 rows or keys, two chunks an item, the widths padded to a
    multiple of 128.  One work item a head at the flagship's T=65, nine at
    the pixel ViT's T=1025; past 512 columns the streamed rows."""
    def tiles(T, D):
        plan = backward_plan(T, D)
        return tuple((k["tile"], k["cols"], k["rows"])
                     for k in (plan["dq"], plan["dkv"]))

    assert tiles(65, 32) == ((96, 32, 128), (64, 32, 128))
    assert tiles(1025, 8) == ((96, 32, 128), (64, 32, 128))
    assert tiles(130, 64) == ((64, 64, 128), (64, 64, 128))
    assert tiles(300, 33) == ((64, 64, 128), (64, 64, 128))
    assert tiles(257, 128) == ((64, 128, 128), (64, 64, 64))
    assert tiles(4096, 100) == ((64, 128, 128), (64, 64, 64))
    assert tiles(257, 192) == ((32, 128, 64), (32, 64, 64))
    assert tiles(142, 384) == ((32, 128, 64), (32, 64, 64))
    assert tiles(65, 512) == ((16, 128, 64), (16, 64, 64))
    assert [backward_plan(65, D)["width"] for D in (129, 256, 257, 385)] \
        == [256, 256, 384, 512]
    for T, items in ((1, 1), (65, 1), (128, 1), (129, 2), (1025, 9)):
        assert backward_plan(T, 32)["dq"]["items"] == items
        assert backward_plan(T, 32)["dkv"]["items"] == items
    assert backward_plan(257, 128)["dkv"]["items"] == 5
    # 64 rows times groups of two chunks: 3 at 384 columns for dk/dv
    assert backward_plan(257, 192)["dq"]["items"] == 5
    assert backward_plan(142, 384)["dq"]["items"] == 3 * 2
    assert backward_plan(142, 384)["dkv"]["items"] == 3 * 3
    assert backward_plan(65, 32)["swizzle"] == 64
    assert backward_plan(65, 64)["swizzle"] == 128
    assert backward_plan(65, 512)["dq"]["streamed"] is False
    assert backward_plan(65, 513)["dq"]["streamed"] is True
    assert backward_plan(257, 640)["dkv"]["streamed"] is True


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


@pytest.mark.parametrize("which", ["fused", "flash"])
def test_functions_save_the_callers_views(which, monkeypatch):
    """Both autograd Functions save q, k and v as the caller gave them --
    the module's transposed views of its (B, T, H, D) projections -- and no
    copy of them: the saved tensors share the views' storage and strides.
    Their one backward (``AttentionFunction``'s) hands those views, the
    forward's out and the cotangent to the two backward operators as they
    are, and dq, dk and dv come back in q's, k's and v's strides, so that
    the module's transposes take them as views."""
    from vit_cifar_torch.ops.cuda.attention import FusedAttentionFunction
    from vit_cifar_torch.ops.cuda.flash_attention import AttentionFunction

    fn = {"fused": FusedAttentionFunction,
          "flash": FlashAttentionFunction}[which]
    assert issubclass(fn, AttentionFunction)
    assert fn.backward is AttentionFunction.backward
    B, H, T, D = 2, 3, 9, 16
    x = torch.from_numpy(np.random.default_rng(11).normal(
        size=(3, B, T, H * D)).astype(np.float32)).requires_grad_()
    q, k, v = (t.reshape(B, T, H, D).transpose(1, 2) for t in x)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        out = fn.apply(q, k, v, 0.125)
    views = [t for t in saved if t.shape == (B, H, T, D)]
    assert len(views) == 3
    for got, want in zip(views, (q, k, v)):
        assert got.data_ptr() == want.data_ptr()
        assert got.stride() == want.stride() != got.contiguous().stride()

    calls = []

    def spy(name):
        real = getattr(flash_module, name)

        def run(*args):
            grads = real(*args)
            calls.append((name, args, grads if isinstance(grads, tuple)
                          else (grads,)))
            return grads
        return run

    for name in ("flash_tiled_bwd_dq", "flash_tiled_bwd_dkv"):
        monkeypatch.setattr(flash_module, name, spy(name))
    g = torch.from_numpy(np.random.default_rng(12).normal(
        size=(B, T, H, D)).astype(np.float32))
    dx, = torch.autograd.grad(out, x, g)
    assert [c[0] for c in calls] == ["flash_tiled_bwd_dq",
                                     "flash_tiled_bwd_dkv"]
    for name, args, grads in calls:
        for got, want in zip(args[:3], (q, k, v)):  # the caller's views
            assert got.data_ptr() == want.data_ptr(), name
            assert got.stride() == want.stride(), name
        assert args[3].data_ptr() == out.data_ptr(), name  # o as returned
        assert args[3].stride() == out.stride(), name
        assert args[4].data_ptr() == g.data_ptr(), name  # do as given
        assert args[4].stride() == g.stride(), name
        wants = (q,) if name == "flash_tiled_bwd_dq" else (k, v)
        for got, want in zip(grads, wants):  # in q's, k's and v's strides
            assert got.stride() == want.stride(), name
    assert dx.shape == x.shape


@pytest.mark.parametrize("T,D,kernel,want", [
    (65, 32, "", "fused"),            # the flagship ViT
    (65, 32, None, "fused"),
    (1025, 32, "", "flash"),          # the pixel-token ViT
    (1025, 32, None, "flash"),
    (72, 32, "", "fused"),            # the last T the f32 whole head holds
    (73, 32, "", "flash"),
    (64, 64, None, "fused"),          # at 64 and 128 columns
    (65, 64, None, "flash"),
    (32, 128, "", "fused"),
    (33, 128, "", "flash"),
    (65, 32, "flash", "flash"),       # forced: any T
    (4096, 128, "flash", "flash"),
    (1025, 32, "einsum", "einsum"),
    (65, 32, "einsum", "einsum"),
    (700, 32, "fused", "fused"),
    # past COL_CHUNK columns no whole-head f32 instance: the tiled kernels
    (257, 192, "", "flash"),
    (257, 192, None, "flash"),
    (136, 192, "", "flash"),
    (9, 384, None, "flash"),
    (257, 192, "flash", "flash"),
    (257, 128, "", "flash"),
    # ... and "fused" runs as asked, at any T
    (257, 192, "fused", "fused"),
    (279, 192, "fused", "fused"),
    (213, 256, "fused", "fused"),
    (142, 384, "fused", "fused"),
    (1025, 32, "fused", "fused"),
    (300, 192, "fused", "fused"),
])
def test_route(T, D, kernel, want):
    """The router in f32 (its default dtype): the forced paths as asked,
    and by default the whole-head forward exactly where a WHOLE_F32 row
    holds the head."""
    assert route(T, D, kernel) == want
    assert route(T, D, kernel, dtype=torch.float32) == want
    if kernel in ("", None):
        assert whole_head_holds(T, D, torch.float32) == (want == "fused")


# (dtype, T, D, the default route): each whole-head table's last T at each
# width and one past it, a head a column narrower than the width, and one
# past the widest whole-head width (bf16 WHOLE rows: 128 keys at 32
# columns, 96 at 64, 64 at 128; f32 WHOLE_F32 rows: 72, 64, 32)
BOUNDARIES = [
    (torch.bfloat16, 128, 32, "fused"), (torch.bfloat16, 129, 32, "flash"),
    (torch.bfloat16, 96, 64, "fused"), (torch.bfloat16, 97, 64, "flash"),
    (torch.bfloat16, 96, 33, "fused"), (torch.bfloat16, 64, 128, "fused"),
    (torch.bfloat16, 65, 128, "flash"), (torch.bfloat16, 64, 65, "fused"),
    (torch.bfloat16, 1, 129, "flash"),
    (torch.float32, 72, 32, "fused"), (torch.float32, 73, 32, "flash"),
    (torch.float32, 64, 64, "fused"), (torch.float32, 65, 64, "flash"),
    (torch.float32, 64, 33, "fused"), (torch.float32, 32, 128, "fused"),
    (torch.float32, 33, 128, "flash"), (torch.float32, 32, 65, "fused"),
    (torch.float32, 1, 129, "flash"),
]


@pytest.mark.parametrize("dtype,T,D,want", BOUNDARIES,
                         ids=lambda x: str(x).replace("torch.", ""))
def test_route_default_at_each_whole_head_boundary(dtype, T, D, want):
    """The router's default rule in the module's dtype: "fused" exactly
    where mhsa_fwd's plan (from the table the CUDA dispatch expands) takes
    the whole head as one key tile, "flash" one key past it, and the
    module's own path (its forward's dtype) agrees."""
    assert route(T, D, None, dtype=dtype) == want
    assert route(T, D, "", dtype=dtype) == want
    plan = (forward_plan("mhsa_fwd", T, D) if dtype == torch.bfloat16
            else f32_forward_plan("mhsa_fwd", T, D))
    assert (plan["grid"] == "whole") == (want == "fused")
    keys = WHOLE_KEYS if dtype == torch.bfloat16 else WHOLE_F32_KEYS
    width = min((w for w in keys if w >= D), default=None)
    assert (width is not None and -(-T // 8) * 8 <= max(keys[width])) == (
        want == "fused")


def test_default_module_past_the_tiled_head_dim_matches_jax(monkeypatch):
    """hidden 384 in 2 heads (head_dim 192) at T=257 (patch 16): the default
    config takes the tiled kernels, which cut the head into column chunks
    (it took the einsum path while they stopped at head_dim 128); the
    module's output and grads (input and every parameter) on that path
    match the JAX module's in f32 (the order of sums differs: rtol 1e-4 /
    atol 1e-5)."""
    features, head, T = 384, 2, 257
    assert route(T, features // head, None) == "flash"
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return flash_attention(*args)

    monkeypatch.setattr(attention_module, "flash_attention", spy)
    rng = np.random.default_rng(12)
    x, g = (rng.normal(size=(2, T, features)).astype(np.float32)
            for _ in range(2))
    jm = JaxMultiHeadSelfAttention(features=features, head=head)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want, vjp = jax.vjp(lambda p, a: jm.apply({"params": p}, a), params,
                        jnp.asarray(x))
    want_params, want_x = vjp(jnp.asarray(g))

    tm = MultiHeadSelfAttention(features, head, generator=torch.Generator())
    tm.load_state_dict(state_dict_from_flax(params))
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **GRAD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x),
                               **GRAD_TOL)
    want_grads = state_dict_from_flax(want_params)
    assert set(want_grads) == {n for n, _ in tm.named_parameters()}
    for name, param in tm.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(),
                                   want_grads[name].numpy(), **GRAD_TOL,
                                   err_msg=name)
    assert calls == [(2, head, T, features // head)]


@pytest.mark.parametrize("T,D", [(1025, 32), (129, 32), (4096, 128),
                                 (280, 192), (143, 384)])
def test_route_runs_fused_as_asked_past_every_whole_head(T, D):
    """Where no whole-head instance holds the head in either dtype, the
    default takes the tiled kernels and ``"fused"`` still runs as asked,
    as JAX's ``fused_attention`` does at any T: the whole-head forward's
    plan runs the tiled work items there (bf16; and f32, past 128 columns
    the streamed items)."""
    for dtype in (torch.float32, torch.bfloat16):
        assert not whole_head_holds(T, D, dtype)
        assert route(T, D, None, dtype=dtype) == "flash"
        assert route(T, D, "fused", dtype=dtype) == "fused"
    assert forward_plan("mhsa_fwd", T, D)["grid"] in ("tiled", "streamed")
    plan = f32_forward_plan("mhsa_fwd", T, D)
    assert plan["grid"] == ("streamed" if D > 128 else "tiled")


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
