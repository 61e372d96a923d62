"""The port's CUDA kernels on the card, against their plain PyTorch
versions: the whole-head forward (``ops/cuda/attention.py``), whose
autograd Function runs the tiled backward pair, and the tiled flash kernels
(``ops/cuda/flash_attention.py``), at head dims up to and past their
128-column chunks, with the launches a model makes through each and the
route the default config takes at patch 32 and at head_dim 192; and
AutoAugment on the card against the CPU, and ``train()`` with
``--autoaugment`` for 2 epochs that resumes.

Marked ``gpu``: skipped where there is no CUDA card.  This file imports no
jax, so it also runs on a machine without the JAX package:
``python -m pytest --noconftest tests/test_torch_cuda.py -m gpu``.
Tolerances: forward f32 1e-5 (the same f32 math, sums in another order);
backward f32 rtol 1e-4 / atol 1e-5 (two chained sums over T); bf16 1e-2
against the plain version (one bf16 rounding step either way); the
Function's bf16 grads against autograd through the plain forward 2e-2 (the
backward reads the forward's output rounded to bf16, autograd its f32
probabilities).  The bf16 instances of the forwards and of the tiled
backward pair run on the tensor cores, their f32 instances on TF32 wgmma
with split products (past 128 columns the streamed instances); all are
held to the same limits, at ragged T and D.  The flash kernels' bf16 limit
is 1e-2 of the reference's largest magnitude, since one bf16 step is at
most 2**-7 of a value and the values shrink as T grows (about 4x from T=65
to T=1025).
"""

import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from vit_cifar_torch import Config
from vit_cifar_torch.data.autoaugment import (apply_autoaugment,
                                              autoaugment_draws)
from vit_cifar_torch.data.datasets import RawData
from vit_cifar_torch.models import get_model
from vit_cifar_torch.ops.attention import MultiHeadSelfAttention
from vit_cifar_torch.ops.cuda import KERNEL_WRAPPERS
from vit_cifar_torch.ops.cuda.attention import (
    fused_attention, fused_attention_lse, fused_attention_lse_reference,
    fused_attention_reference)
from vit_cifar_torch.ops.cuda.common import whole_head_holds
from vit_cifar_torch.ops.cuda.flash_attention import (
    flash_attention, flash_attention_lse, flash_attention_lse_reference,
    flash_attention_reference, flash_tiled_bwd_dkv,
    flash_tiled_bwd_dkv_reference, flash_tiled_bwd_dq,
    flash_tiled_bwd_dq_reference)
from vit_cifar_torch.train import loop
from vit_cifar_torch.train.checkpoint import load_checkpoint
from vit_cifar_torch.train.loop import init_state
from vit_cifar_torch.train.optim import make_optimizer
from vit_cifar_torch.train.steps import make_train_step

pytestmark = pytest.mark.gpu

# the flagship's head, the JAX kernel tests' ragged shapes, and heads past
# the kernels' 128-column chunks (the whole-head forward's column-chunk
# layout, up to its last T at head_dim 384)
SHAPES = [(128, 12, 65, 32), (2, 4, 9, 16), (2, 3, 65, 32), (1, 2, 130, 64),
          (2, 2, 96, 128), (2, 2, 257, 192), (1, 1, 142, 384)]
# head dims past one 128-column chunk: ragged (129), one 8-column chunk
# over (136), 1.5 chunks (192), two (256) and three (384)
WIDE_D = (129, 136, 192, 256, 384)
# the flash kernels: the JAX flash tests' tile-splitting shapes, the
# pixel-token ViT's T=1025, a long sequence and the wide heads
FLASH_SHAPES = [(2, 3, 65, 32), (1, 2, 130, 64), (2, 2, 257, 128),
                (1, 1, 8, 128), (1, 2, 300, 32), (4, 12, 1025, 32),
                (2, 1, 4096, 128), (2, 2, 300, 129), (2, 2, 257, 136),
                (2, 2, 257, 192), (1, 2, 130, 256), (1, 1, 200, 384)]
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
           torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
GRAD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def flash_tol(tol: dict, dtype, want: torch.Tensor) -> dict:
    """``tol[dtype]`` in f32; in bf16 one percent of max |want|."""
    if dtype == torch.float32:
        return tol[dtype]
    return dict(rtol=0.0, atol=1e-2 * want.float().abs().max().item())

dtypes = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])
shapes = pytest.mark.parametrize("shape", SHAPES,
                                 ids=lambda s: "x".join(map(str, s)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_version(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    scale = 1.0 / math.sqrt(shape[1] * shape[3])
    before = fused_attention.launches
    got = fused_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    torch.testing.assert_close(got, fused_attention_reference(q, k, v, scale),
                               **TOL[dtype])


def _inputs(cuda, shape, dtype, seed=0):
    """q, k, v (B, H, T, D), the cotangent (B, T, H, D) and the model's
    scale 1/sqrt(H*D)."""
    B, H, T, D = shape
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    g = torch.randn((B, T, H, D), generator=gen, device=cuda).to(dtype)
    return q, k, v, g, 1.0 / math.sqrt(H * D)


@dtypes
@shapes
def test_lse_kernel_matches_plain_version(cuda, shape, dtype):
    q, k, v, _, scale = _inputs(cuda, shape, dtype)
    before = fused_attention_lse.launches
    out, lse = fused_attention_lse(q, k, v, scale)
    torch.cuda.synchronize()
    assert fused_attention_lse.launches == before + 1
    want_out, want_lse = fused_attention_lse_reference(q, k, v, scale)
    torch.testing.assert_close(out, want_out, **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])


@dtypes
@shapes
def test_backward_kernels_match_plain_versions(cuda, shape, dtype):
    """The tiled pair on the whole-head forward's residuals: the fused
    Function's backward."""
    q, k, v, g, scale = _inputs(cuda, shape, dtype, seed=1)
    out, lse = fused_attention_lse_reference(q, k, v, scale)
    before = (flash_tiled_bwd_dq.launches, flash_tiled_bwd_dkv.launches)
    dq = flash_tiled_bwd_dq(q, k, v, out, g, lse, scale)
    dk, dv = flash_tiled_bwd_dkv(q, k, v, out, g, lse, scale)
    torch.cuda.synchronize()
    assert (flash_tiled_bwd_dq.launches, flash_tiled_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = [flash_tiled_bwd_dq_reference(q, k, v, out, g, lse, scale),
            *flash_tiled_bwd_dkv_reference(q, k, v, out, g, lse, scale)]
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, **BWD_TOL[dtype])


@dtypes
@shapes
def test_function_grads_match_autograd_of_plain_forward(cuda, shape, dtype):
    q, k, v, g, scale = _inputs(cuda, shape, dtype, seed=2)

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        return torch.autograd.grad(fn(*leaves, scale), leaves, g)

    for got, w in zip(grads(fused_attention),
                      grads(fused_attention_reference)):
        torch.testing.assert_close(got, w, **GRAD_TOL[dtype])


def test_kernel_refuses_shapes_over_shared_memory(cuda):
    """Past the whole head's shared memory the forward no longer refuses
    (since the walk over key tiles, as JAX's ``fused_attention`` runs at
    any T): both variants run there and match the plain version."""
    for shape in ((1, 1, 2048, 64), (1, 1, 280, 192)):
        assert not whole_head_holds(*shape[2:], torch.float32)
        q, k, v, _, scale = _inputs(cuda, shape, torch.float32, seed=3)
        want_out, want_lse = fused_attention_lse_reference(q, k, v, scale)
        torch.testing.assert_close(fused_attention(q, k, v, scale), want_out,
                                   **TOL[torch.float32])
        out, lse = fused_attention_lse(q, k, v, scale)
        torch.testing.assert_close(out, want_out, **TOL[torch.float32])
        torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])


def test_vit_training_step_launches_each_kernel_once_per_layer(cuda):
    cfg = Config(model_name="vit", num_layers=2, hidden=64, mlp_hidden=64,
                 head=4, batch_size=16, label_smoothing=True, warmup_epoch=0)
    model, _ = get_model(cfg, device=cuda)
    tx = make_optimizer(cfg, 2)
    state = init_state(cfg, model, tx)
    step = make_train_step(cfg, model, tx)
    x = torch.randint(0, 256, (32, 32, 32, 3), dtype=torch.uint8,
                      device=cuda)
    y = torch.randint(0, 10, (32,), device=cuda)
    perm = torch.randperm(32, device=cuda)
    before = {n: w.launches for n, w in KERNEL_WRAPPERS.items()}
    state, metrics = step(state, x, y, perm, 0)
    torch.cuda.synchronize()
    launched = {n: w.launches - before[n] for n, w in KERNEL_WRAPPERS.items()}
    assert launched == {"mhsa_fwd": 0, "mhsa_fwd_lse": cfg.num_layers,
                        "flash_fwd": 0, "flash_fwd_lse": 0,
                        "flash_bwd_dq_tiled": cfg.num_layers,
                        "flash_bwd_dkv_tiled": cfg.num_layers}
    assert torch.isfinite(metrics["loss"]) and metrics["skipped_nonfinite"] == 0
    assert int(state.opt_state["count"]) == 1


def test_model_forward_launches_once_per_layer(cuda):
    cfg = Config(model_name="vit", num_layers=3, hidden=64, mlp_hidden=64,
                 head=4)
    model, _ = get_model(cfg, device=cuda)
    model.eval().requires_grad_(False)
    before = fused_attention.launches
    with torch.inference_mode():
        out = model(torch.randn(2, 32, 32, 3, device=cuda))
    assert fused_attention.launches == before + cfg.num_layers
    assert out.shape == (2, 10) and torch.isfinite(out.float()).all()


flash_shapes = pytest.mark.parametrize("shape", FLASH_SHAPES,
                                       ids=lambda s: "x".join(map(str, s)))


@dtypes
@flash_shapes
def test_flash_forward_kernels_match_plain_versions(cuda, shape, dtype):
    q, k, v, _, scale = _inputs(cuda, shape, dtype, seed=3)
    before = (flash_attention.launches, flash_attention_lse.launches)
    got = flash_attention(q, k, v, scale)
    out, lse = flash_attention_lse(q, k, v, scale)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_lse.launches) == (
        before[0] + 1, before[1] + 1)
    want_out, want_lse = flash_attention_lse_reference(q, k, v, scale)
    want = flash_attention_reference(q, k, v, scale)
    torch.testing.assert_close(got, want, **flash_tol(TOL, dtype, want))
    torch.testing.assert_close(out, want_out,
                               **flash_tol(TOL, dtype, want_out))
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])


@dtypes
@flash_shapes
def test_flash_backward_kernels_match_plain_versions(cuda, shape, dtype):
    q, k, v, g, scale = _inputs(cuda, shape, dtype, seed=4)
    out, lse = flash_attention_lse_reference(q, k, v, scale)
    args = (q, k, v, out, g, lse, scale)
    before = (flash_tiled_bwd_dq.launches, flash_tiled_bwd_dkv.launches)
    dq = flash_tiled_bwd_dq(*args)
    dk, dv = flash_tiled_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert (flash_tiled_bwd_dq.launches, flash_tiled_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = [flash_tiled_bwd_dq_reference(*args),
            *flash_tiled_bwd_dkv_reference(*args)]
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, **flash_tol(BWD_TOL, dtype, w))


@dtypes
@pytest.mark.parametrize("shape", [(2, 3, 65, 32), (1, 2, 300, 32),
                                   (2, 2, 257, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_function_grads_match_autograd_of_plain_forward(cuda, shape,
                                                              dtype):
    q, k, v, g, scale = _inputs(cuda, shape, dtype, seed=5)

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        return torch.autograd.grad(fn(*leaves, scale), leaves, g)

    for got, w in zip(grads(flash_attention),
                      grads(fused_attention_reference)):
        torch.testing.assert_close(got, w, **GRAD_TOL[dtype])


# every T where a 16-row tile, a 64-key chunk or a 64-row block of the
# tensor-core forwards ends or begins
RAGGED_T = (1, 7, 8, 15, 16, 17, 63, 64, 65, 66, 127, 128, 129)


@pytest.mark.parametrize("kernel", ["mhsa", "flash"])
@pytest.mark.parametrize("T", RAGGED_T)
def test_bf16_forwards_match_plain_versions_at_ragged_edges(cuda, T, kernel):
    """The bf16 (tensor-core) instances of both forwards, with and without
    lse, at head dims that are and are not a multiple of 16."""
    fwd, fwd_lse, plain = {
        "mhsa": (fused_attention, fused_attention_lse,
                 fused_attention_lse_reference),
        "flash": (flash_attention, flash_attention_lse,
                  flash_attention_lse_reference)}[kernel]
    for D in (16, 24, 32, 64, 128, *WIDE_D):
        q, k, v, _, scale = _inputs(cuda, (2, 3, T, D), torch.bfloat16,
                                    seed=T + D)
        got = fwd(q, k, v, scale)
        out, lse = fwd_lse(q, k, v, scale)
        torch.cuda.synchronize()
        want_out, want_lse = plain(q, k, v, scale)
        tol = (TOL[torch.bfloat16] if kernel == "mhsa"
               else flash_tol(TOL, torch.bfloat16, want_out))
        torch.testing.assert_close(got, want_out, **tol)
        torch.testing.assert_close(out, want_out, **tol)
        torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])


# at T=1 the softmax over one key is constant, so dq and dk are 0 in exact
# arithmetic and kernel and plain version both return f32 rounding noise
# of sums over D terms (6e-8 measured at D <= 128, 1.3e-6 at D=384): the
# backward's ragged-edge limit is 1% of max |grad| but no tighter than this
# floor per 128 columns
RAGGED_BWD_ATOL_FLOOR = 1e-6


@pytest.mark.parametrize("T", RAGGED_T)
def test_bf16_flash_backward_matches_plain_versions_at_ragged_edges(cuda, T):
    """The bf16 (tensor-core) instances of the tiled dq and dk/dv kernels,
    where a 16-row tile and a 64-row tile of keys or query rows end, at
    head dims that are and are not a multiple of 16."""
    for D in (16, 24, 32, 64, 128, *WIDE_D):
        q, k, v, g, scale = _inputs(cuda, (2, 3, T, D), torch.bfloat16,
                                    seed=T + D)
        out, lse = flash_attention_lse_reference(q, k, v, scale)
        args = (q, k, v, out, g, lse, scale)
        got = (flash_tiled_bwd_dq(*args), *flash_tiled_bwd_dkv(*args))
        torch.cuda.synchronize()
        want = (flash_tiled_bwd_dq_reference(*args),
                *flash_tiled_bwd_dkv_reference(*args))
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            tol = flash_tol(BWD_TOL, torch.bfloat16, w)
            tol["atol"] = max(tol["atol"],
                              RAGGED_BWD_ATOL_FLOOR * max(1.0, D / 128))
            torch.testing.assert_close(
                a, w, **tol, msg=lambda m: f"{name} T={T} D={D}: {m}")


# the bf16 wgmma forwards (csrc/wgmma_attention.cuh) on the model's
# strided views: odd and ragged T (ends of the whole-head tiles of 16 to
# 128 keys and of the tiled grid's 32- to 128-key tiles and 128-row query
# tiles), and D below 128, past it up to 256 (one pass), D % 8 != 0 (the
# padded copy), past 256 up to 512 (two column chunks of o, the last
# ragged at 320 and 456) and past 512 (the streamed instance: D % 64 == 8,
# D % 8 == 2, whole chunks of the sum at 640 and 704, and 1040)
WGMMA_T = (1, 9, 65, 72, 73, 97, 129, 257, 1025)
WGMMA_D = (8, 32, 64, 100, 128, 192, 256, 320, 384, 456, 512, 520, 522, 640,
           704, 1040)
FORWARDS = {"mhsa": (fused_attention, fused_attention_lse,
                     fused_attention_lse_reference),
            "flash": (flash_attention, flash_attention_lse,
                      flash_attention_lse_reference)}


def _model_views(shape, seed, scale_q=1.0):
    """q, k, v in bf16 as the model makes them: (B, T, H*D) projections
    viewed as (B, H, T, D)."""
    B, H, T, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [(torch.randn((B, T, H * D), generator=g, device="cuda") * s)
            .to(torch.bfloat16).view(B, T, H, D).transpose(1, 2)
            for s in (scale_q, 1.0, 1.0)]


@pytest.mark.parametrize("kernel", ["mhsa", "flash"])
@pytest.mark.parametrize("T", WGMMA_T)
def test_bf16_forwards_match_plain_versions_on_the_models_views(cuda, T,
                                                                kernel):
    """Both bf16 forwards, with and without lse, read the model's
    transposed views in place and match their plain version."""
    fwd, fwd_lse, plain = FORWARDS[kernel]
    for D in WGMMA_D:
        q, k, v = _model_views((2, 3, T, D), seed=T + D)
        scale = 1.0 / math.sqrt(3 * D)
        got = fwd(q, k, v, scale)
        out, lse = fwd_lse(q, k, v, scale)
        torch.cuda.synchronize()
        want_out, want_lse = plain(q, k, v, scale)
        tol = flash_tol(TOL, torch.bfloat16, want_out)
        torch.testing.assert_close(got, want_out, **tol,
                                   msg=lambda m: f"D={D}: {m}")
        torch.testing.assert_close(out, want_out, **tol,
                                   msg=lambda m: f"D={D}: {m}")
        torch.testing.assert_close(lse, want_lse, **TOL[torch.float32],
                                   msg=lambda m: f"D={D}: {m}")


@pytest.mark.parametrize("kernel", ["mhsa", "flash"])
def test_bf16_forwards_read_the_views_in_place(cuda, kernel, monkeypatch):
    """Where TMA's rules hold (D % 8 == 0), no copy of q, k or v is made;
    where they do not (D=100), the stated padded copy is, and the result
    is the same."""
    from vit_cifar_torch.ops.cuda import common

    copies = []
    real = common.padded_copy
    monkeypatch.setattr(common, "padded_copy",
                        lambda t, meta=False: copies.append(meta)
                        or real(t, meta))
    fwd, _, plain = FORWARDS[kernel]
    for D, want_copies in ((32, 0), (100, 3)):
        q, k, v = _model_views((2, 3, 65, D), seed=D)
        copies.clear()
        got = fwd(q, k, v, 0.1)
        torch.cuda.synchronize()
        assert copies.count(False) == want_copies, (D, copies)
        torch.testing.assert_close(got, plain(q, k, v, 0.1)[0],
                                   **TOL[torch.bfloat16])


@pytest.mark.parametrize("kernel", ["mhsa", "flash"])
@pytest.mark.parametrize("T,D", [(256, 32), (200, 32), (193, 64), (300, 128),
                                 (300, 192), (300, 256), (300, 320),
                                 (200, 512), (300, 704), (65, 32)])
def test_bf16_forwards_guard_a_fully_masked_key_tile(cuda, T, D, kernel):
    """The key tile the kernel takes first (the last one: tiles are taken
    last to first) has logits that all overflow to -inf (every q.k there
    is -1e40), with finite keys in the tiles before it: the running max
    stays at -inf through that tile without a NaN, and the rows equal the
    plain version's softmax over the other keys.  At T=65 the whole head
    is one tile (``mhsa_fwd``'s whole-head grid, ``flash_fwd``'s 128-key
    tile), which cannot be wholly masked and keep a finite key: there every
    key but the first is masked."""
    from vit_cifar_torch.ops.cuda.common import forward_plan

    fwd, fwd_lse, plain = FORWARDS[kernel]
    keys = forward_plan(f"{kernel}_fwd", T, D)["rows"]["k"]
    first = (T - 1) // keys * keys  # the first key of the first tile taken
    assert (first > 0) == (T > 65), (keys, T)
    g = torch.Generator(device="cuda").manual_seed(T + D)
    q = torch.full((2, 2, T, D), 1e20, device="cuda").to(torch.bfloat16)
    k = (torch.randn((2, 2, T, D), generator=g, device="cuda")
         * 1e-20).to(torch.bfloat16)
    k[:, :, max(first, 1):] = -1e20
    v = torch.randn((2, 2, T, D), generator=g,
                    device="cuda").to(torch.bfloat16)
    out, lse = fwd_lse(q, k, v, 0.1)
    torch.cuda.synchronize()
    want_out, want_lse = plain(q, k, v, 0.1)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out, want_out, **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])


def _kernel_names(fn) -> set:
    """The names of the card's kernels that ``fn`` launches, by
    torch.profiler; a window that comes back with none of them is run
    again, up to 3 times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {a.key for a in prof.key_averages()
                 if a.self_device_time_total > 0
                 and a.self_cpu_time_total == 0}
        if names:
            return names
    raise AssertionError("the profiler recorded no kernel of the card")


# every bf16 width: the one-pass rows, the column chunks of o and the
# streamed instance past 512 columns
INSTANCE_D = (32, 64, 128, 192, 256, 320, 384, 456, 512, 520, 640, 1040)


@pytest.mark.parametrize("kernel", ["mhsa", "flash"])
def test_bf16_forwards_launch_a_wgmma_instance_at_every_width(cuda, kernel):
    """At every bf16 width both forwards, with and without lse, count one
    launch a call (the wrappers' counters), and the card runs one wgmma
    instance of the forward and no other kernel: ``fwd_kernel`` up to 512
    columns, ``fwd_stream_kernel`` past them (the forward plan's
    "streamed" grid)."""
    from vit_cifar_torch.ops.cuda.common import forward_plan

    fwd, fwd_lse, _ = FORWARDS[kernel]
    for D in INSTANCE_D:
        q, k, v = _model_views((2, 3, 257, D), seed=D)
        counts = (fwd.launches, fwd_lse.launches)
        fwd(q, k, v, 0.1)
        fwd_lse(q, k, v, 0.1)
        torch.cuda.synchronize()
        assert (fwd.launches - counts[0], fwd_lse.launches - counts[1]) \
            == (1, 1), (D, fwd.launches, fwd_lse.launches)
        names = _kernel_names(lambda: (fwd(q, k, v, 0.1),
                                       fwd_lse(q, k, v, 0.1)))
        want = ("fwd_stream_kernel"
                if forward_plan(f"{kernel}_fwd", 257, D)["grid"] == "streamed"
                else "fwd_kernel")
        got = {m.group(0) for n in names
               if (m := re.search(r"fwd_(?:stream_)?kernel", n))}
        assert got == {want} and len(names) == len(
            [n for n in names if want in n]), (D, sorted(names))


@pytest.mark.parametrize("D", (32, 128, 256, 512, 520, 704, 1040))
def test_bf16_backward_pair_launches_a_wgmma_instance_at_every_width(cuda,
                                                                      D):
    """At every bf16 width the pair counts one launch of each pass (the
    wrappers' counters) and its plan names the wgmma instances that run:
    ``dq_kernel`` and ``dkv_kernel`` (after the rows pass) up to 512
    columns, ``dq_stream_kernel`` and ``dkv_stream_kernel`` past them, both
    passes' with the same sums over D streamed or not."""
    from vit_cifar_torch.ops.cuda.common import backward_plan

    args = _views_and_cotangent((2, 3, 257, D), seed=D)
    counts = (flash_tiled_bwd_dq.launches, flash_tiled_bwd_dkv.launches)
    _check_pair(_pair(args), _plain_pair(args), D, f"D={D}")
    assert (flash_tiled_bwd_dq.launches - counts[0],
            flash_tiled_bwd_dkv.launches - counts[1]) == (1, 1), D
    plan = backward_plan(257, D)
    assert plan["dq"]["streamed"] == plan["dkv"]["streamed"] == (D > 512)


# the bf16 backward pair: wgmma (csrc/wgmma_backward.cuh, tiles in
# csrc/backward_tiles.cuh; column chunks past 128, the streamed instances
# past 512)
BACKWARD_D = (8, 16, 24, 32, 64, 100, 128, 136, 192, 256, 320, 384, 456,
              520, 522, 640, 704, 1040)


def _pair(args):
    return (flash_tiled_bwd_dq(*args), *flash_tiled_bwd_dkv(*args))


def _plain_pair(args):
    return (flash_tiled_bwd_dq_reference(*args),
            *flash_tiled_bwd_dkv_reference(*args))


def _check_pair(got, want, D, what):
    """dq, dk, dv against the plain passes: 1% of max |grad| (one bf16
    step), no tighter than RAGGED_BWD_ATOL_FLOOR per 128 columns."""
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        tol = flash_tol(BWD_TOL, torch.bfloat16, w)
        tol["atol"] = max(tol["atol"],
                          RAGGED_BWD_ATOL_FLOOR * max(1.0, D / 128))
        assert torch.isfinite(a.float()).all(), f"{name} {what}"
        torch.testing.assert_close(a, w, **tol,
                                   msg=lambda m: f"{name} {what}: {m}")


def _views_and_cotangent(shape, seed):
    """q, k, v as the model makes them, out and lse as the forward returns
    them ((B, T, H, D) and (B, H, T)), and a (B, T, H, D) cotangent."""
    B, H, T, D = shape
    q, k, v = _model_views(shape, seed)
    scale = 1.0 / math.sqrt(H * D)
    out, lse = flash_attention_lse(q, k, v, scale)
    g = torch.randn((B, T, H, D), generator=torch.Generator(
        device="cuda").manual_seed(seed + 1), device="cuda").to(torch.bfloat16)
    return (q, k, v, out, g, lse, scale)


@pytest.mark.parametrize("T", WGMMA_T)
def test_bf16_backward_pair_on_the_models_views(cuda, T):
    """The bf16 pair on the model's views (q, k, v transposed (B, T, H, D)
    projections, o and do as the forward returns them) at odd and ragged T
    and head widths to 1040 (D % 8 != 0 included; every width of the table
    and the streamed instances past it): dq, dk and dv against the plain
    passes, written in q's, k's and v's strides, and two calls equal bit
    for bit."""
    for D in BACKWARD_D:
        args = _views_and_cotangent((2, 3, T, D), seed=T + D)
        got = _pair(args)
        again = _pair(args)
        torch.cuda.synchronize()
        _check_pair(got, _plain_pair(args), D, f"T={T} D={D}")
        for a, ref in zip(got, args[:3]):
            assert a.stride() == ref.stride(), (T, D, a.stride())
        assert all(torch.equal(a, b) for a, b in zip(got, again)), (T, D)


@pytest.mark.parametrize("T", RAGGED_T)
def test_bf16_backward_pair_at_ragged_edges_on_the_models_views(cuda, T):
    """Where a 16-row tile, a key or query tile (32 to 128) or a work item
    (64 or 128 rows) ends, on the model's views, at head dims that are and
    are not a multiple of 16."""
    for D in (16, 24, 32, 64, 128, *WIDE_D):
        args = _views_and_cotangent((2, 3, T, D), seed=2 * T + D)
        got = _pair(args)
        torch.cuda.synchronize()
        _check_pair(got, _plain_pair(args), D, f"T={T} D={D}")


@pytest.mark.parametrize("T,D", [(256, 32), (200, 32), (193, 64),
                                 (300, 128), (300, 640), (65, 32)])
def test_bf16_backward_pair_guards_a_fully_masked_key_tile(cuda, T, D):
    """The dq kernel takes its key tiles last to first; where every logit
    of the first tile it takes is -inf in f32 (q = 1e20, k = -1e20 there)
    and the keys before it are finite, p is exactly 0 there: dq, dk and dv
    finite and equal to the plain passes'.  At T=65 (one tile) every key
    but the first 8 is masked: over one key the softmax is constant, dk is
    0 in exact arithmetic and both sides would return rounding noise of dp
    - delta times q = 1e20."""
    from vit_cifar_torch.ops.cuda.common import backward_plan

    keys = backward_plan(T, D)["dq"]["tile"]
    first = max((T - 1) // keys * keys, 8)  # the first tile taken
    g = torch.Generator(device="cuda").manual_seed(T + D)
    q = torch.full((2, 2, T, D), 1e20, device="cuda").to(torch.bfloat16)
    k = (torch.randn((2, 2, T, D), generator=g, device="cuda")
         * 1e-20).to(torch.bfloat16)
    k[:, :, first:] = -1e20
    v = torch.randn((2, 2, T, D), generator=g,
                    device="cuda").to(torch.bfloat16)
    out, lse = flash_attention_lse_reference(q, k, v, 0.1)
    do = torch.randn((2, T, 2, D), generator=g,
                     device="cuda").to(torch.bfloat16)
    args = (q, k, v, out, do, lse, 0.1)
    got = _pair(args)
    torch.cuda.synchronize()
    _check_pair(got, _plain_pair(args), D, f"T={T} D={D}")


@pytest.mark.parametrize("T", (65, 129, 300, 1025))
def test_bf16_backward_pair_reads_nothing_past_T(cuda, T):
    """Query rows past T (the last work item's and query tile's) arrive as
    TMA's zeros and read lse = delta = 0, so they add exactly 0: with o,
    do and lse the leading part of buffers whose bytes past them are NaN,
    every gradient is finite and equals the plain passes'."""
    for D in (32, 64, 128):
        B, H = 2, 3
        q, k, v, out, g, lse, scale = _views_and_cotangent((B, H, T, D),
                                                           seed=T + 3 * D)

        def nan_tail(t):
            buf = torch.full((t.numel() + 4096,), float("nan"),
                             dtype=t.dtype, device="cuda")
            buf[:t.numel()] = t.reshape(-1)
            return buf[:t.numel()].view(t.shape)

        args = (q, k, v, nan_tail(out), nan_tail(g), nan_tail(lse), scale)
        got = _pair(args)
        torch.cuda.synchronize()
        _check_pair(got, _plain_pair((q, k, v, out, g, lse, scale)), D,
                    f"T={T} D={D}")


def test_bf16_backward_pair_copies_nothing_on_the_models_path(cuda,
                                                               monkeypatch):
    """On the model's views the pair makes no copy of q, k, v, o or do
    where TMA reads them (D % 8 == 0), and where it cannot (D=100) one
    padded copy of each of q, k, v and do a pass (o is read by rows), 8
    for the pair; through the Function no copy, and the views' gradients
    in their own strides."""
    from vit_cifar_torch.ops.cuda import common

    copies = []
    real = common.padded_copy
    monkeypatch.setattr(common, "padded_copy",
                        lambda t, meta=False: copies.append(meta)
                        or real(t, meta))
    for D, want_copies in ((32, 0), (100, 8)):
        args = _views_and_cotangent((2, 3, 65, D), seed=D)
        copies.clear()
        got = _pair(args)
        torch.cuda.synchronize()
        assert copies.count(False) == want_copies, (D, copies)
        _check_pair(got, _plain_pair(args), D, f"D={D}")
    # through the Function: no copy, and the views' grads in their strides
    B, T, H, D = 2, 65, 3, 32
    x = torch.randn((3, B, T, H * D), device="cuda").to(
        torch.bfloat16).requires_grad_()
    q, k, v = (t.view(B, T, H, D).transpose(1, 2) for t in x)
    copies.clear()
    grads = torch.autograd.grad(flash_attention(q, k, v, 0.1), [q, k, v],
                                torch.ones((B, T, H, D), device="cuda",
                                           dtype=torch.bfloat16))
    assert copies.count(False) == 0, copies
    for a, ref in zip(grads, (q, k, v)):
        assert a.stride() == ref.stride()


# the f32 backward pair: TF32 wgmma with the three-product split
# (csrc/wgmma_tf32.cuh, DQ_F32 and DKV_F32 rows of csrc/backward_tiles.cuh)
# up to 128 columns, past them the streamed rows (DQ_F32_STREAMED,
# DKV_F32_STREAMED); D < 32, D % 4 != 0 (the padded copy: 6, 30, 66, 127),
# every f32 width and, streamed, 136, 192 and 520
F32_BACKWARD_D = (6, 8, 16, 30, 32, 44, 64, 66, 100, 127, 128, 136, 192, 520)
# the streamed instances' widths: D % 4 != 0 (129, 130: the padded copy),
# a clamped dq chunk (192: three), whole groups (256), and the sums over
# 12, 17 and 22 chunks of 32 columns
F32_STREAMED_D = (129, 130, 136, 192, 256, 384, 520, 704)
F32_STREAMED_T = (1, 63, 65, 127, 129, 257)


def _f32_views_and_cotangent(shape, seed):
    """q, k, v in f32 as the model makes them ((B, T, H*D) projections
    viewed as (B, H, T, D)), out and lse of the tiled forward, and a
    (B, T, H, D) cotangent."""
    B, H, T, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((B, T, H * D), generator=g, device="cuda")
               .view(B, T, H, D).transpose(1, 2) for _ in range(3))
    scale = 1.0 / math.sqrt(H * D)
    out, lse = flash_attention_lse(q, k, v, scale)
    do = torch.randn((B, T, H, D), generator=g, device="cuda")
    return (q, k, v, out, do, lse, scale)


def _check_f32_pair(got, want, what):
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), what
        torch.testing.assert_close(a, w, **BWD_TOL[torch.float32],
                                   msg=lambda m: f"{name} {what}: {m}")


@pytest.mark.parametrize("T", WGMMA_T)
def test_f32_backward_pair_on_the_models_views(cuda, T):
    """The f32 pair on the model's views at odd and ragged T and head widths
    8-520 (D < 32, D % 4 != 0 through the padded copy, every f32 width and
    the streamed instances past 128): dq, dk and dv against the plain passes within
    rtol 1e-4 / atol 1e-5, written in q's, k's and v's strides, and two
    calls equal bit for bit."""
    for D in F32_BACKWARD_D:
        args = _f32_views_and_cotangent((2, 3, T, D), seed=T + D)
        got = _pair(args)
        again = _pair(args)
        torch.cuda.synchronize()
        _check_f32_pair(got, _plain_pair(args), f"T={T} D={D}")
        for a, ref in zip(got, args[:3]):
            assert a.stride() == ref.stride(), (T, D, a.stride())
        assert all(torch.equal(a, b) for a, b in zip(got, again)), (T, D)


@pytest.mark.parametrize("T", F32_STREAMED_T)
def test_f32_streamed_backward_pair_at_ragged_edges(cuda, T):
    """Past 128 columns (the streamed instances, s and dp summed over
    32-column chunks, the gradients' B through the second ring) at ragged T
    and D 129-704 (D % 4 != 0 through the padded copy), on the model's
    views and on contiguous inputs: dq, dk and dv against the plain passes
    within rtol 1e-4 / atol 1e-5, in q's, k's and v's strides, and two
    calls equal bit for bit."""
    for D in F32_STREAMED_D:
        views = _f32_views_and_cotangent((2, 3, T, D), seed=7 * T + D)
        q, k, v, g, scale = _inputs(cuda, (2, 3, T, D), torch.float32,
                                    seed=5 * T + D)
        out, lse = flash_attention_lse_reference(q, k, v, scale)
        for what, args in (("views", views),
                           ("contiguous", (q, k, v, out, g, lse, scale))):
            got = _pair(args)
            again = _pair(args)
            torch.cuda.synchronize()
            _check_f32_pair(got, _plain_pair(args), f"{what} T={T} D={D}")
            for a, ref in zip(got, args[:3]):
                assert a.stride() == ref.stride(), (what, T, D, a.stride())
            assert all(torch.equal(a, b) for a, b in zip(got, again)), (
                what, T, D)


@pytest.mark.parametrize("T", RAGGED_T)
def test_f32_backward_pair_at_ragged_edges(cuda, T):
    """Where a 16-row fragment, a key or query tile (8 to 48) or a work
    item (64 or 128 rows) ends, on contiguous inputs, at head dims that are
    and are not a multiple of 4."""
    for D in (16, 30, 32, 64, 100, 128):
        q, k, v, g, scale = _inputs(cuda, (2, 3, T, D), torch.float32,
                                    seed=3 * T + D)
        out, lse = flash_attention_lse_reference(q, k, v, scale)
        args = (q, k, v, out, g, lse, scale)
        got = _pair(args)
        torch.cuda.synchronize()
        _check_f32_pair(got, _plain_pair(args), f"T={T} D={D}")


@pytest.mark.parametrize("T,D", [(200, 32), (193, 64), (300, 128),
                                 (33, 32), (300, 192), (200, 520)])
def test_f32_backward_pair_guards_a_fully_masked_key_tile(cuda, T, D):
    """The f32 dq kernel takes its key tiles last to first; where every
    logit of the first tile it takes is -inf in f32 (q = 1e20, k = -1e20
    there; each TF32 product of the split is -inf or finite, never NaN) and
    the keys before it are finite, p is exactly 0 there: dq, dk and dv
    finite and equal to the plain passes' (the f32 limit, its atol
    scaled to the gradients' size).  At T=33 one tile (48 keys) holds
    every key, and every key but the first 8 is masked there."""
    from vit_cifar_torch.ops.cuda.common import f32_backward_plan

    keys = f32_backward_plan(T, D)["dq"]["tile"]
    first = max((T - 1) // keys * keys, 8)  # the first tile taken
    g = torch.Generator(device="cuda").manual_seed(T + D)
    q = torch.full((2, 2, T, D), 1e20, device="cuda")
    k = torch.randn((2, 2, T, D), generator=g, device="cuda") * 1e-20
    k[:, :, first:] = -1e20
    v = torch.randn((2, 2, T, D), generator=g, device="cuda")
    out, lse = flash_attention_lse_reference(q, k, v, 0.1)
    do = torch.randn((2, T, 2, D), generator=g, device="cuda")
    args = (q, k, v, out, do, lse, 0.1)
    got = _pair(args)
    torch.cuda.synchronize()
    # the gradients are about 1e20 times their usual size (dk = ds^T.q with
    # q = 1e20): atol 1e-5 stands for 1e-5 of a gradient's largest value
    for name, a, w in zip(("dq", "dk", "dv"), got, _plain_pair(args)):
        assert torch.isfinite(a).all(), (name, T, D)
        torch.testing.assert_close(
            a, w, rtol=BWD_TOL[torch.float32]["rtol"],
            atol=BWD_TOL[torch.float32]["atol"] * max(
                1.0, w.abs().max().item()),
            msg=lambda m: f"{name} T={T} D={D}: {m}")


@pytest.mark.parametrize("T", (65, 129, 1025))
def test_f32_backward_pair_reads_nothing_past_T(cuda, T):
    """Query rows past T arrive as TMA's zeros and read lse = delta = 0:
    with o, do and lse the leading part of buffers whose values past them
    are NaN, every f32 gradient is finite and equals the plain passes'."""
    def nan_tail(t):
        buf = torch.full((t.numel() + 4096,), float("nan"), device="cuda")
        buf[:t.numel()] = t.reshape(-1)
        return buf[:t.numel()].view(t.shape)

    for D in (32, 64, 128, 192):
        q, k, v, out, g, lse, scale = _f32_views_and_cotangent(
            (2, 3, T, D), seed=T + 5 * D)
        got = _pair((q, k, v, nan_tail(out), nan_tail(g), nan_tail(lse),
                     scale))
        torch.cuda.synchronize()
        _check_f32_pair(got, _plain_pair((q, k, v, out, g, lse, scale)),
                        f"T={T} D={D}")


def test_f32_backward_pair_copies_nothing_on_the_models_path(cuda,
                                                              monkeypatch):
    """On the model's f32 views the pair copies nothing where tensor maps
    read them (D % 4 == 0), and where they cannot (D=30) one padded copy of
    each of q, k, v and do a pass, 8 for the pair, past 128 columns (the
    streamed instances) too; through the Function no copy, and the views'
    gradients in their own strides."""
    from vit_cifar_torch.ops.cuda import common

    copies = []
    real = common.padded_copy
    monkeypatch.setattr(common, "padded_copy",
                        lambda t, meta=False: copies.append(meta)
                        or real(t, meta))
    for D, want_copies in ((32, 0), (30, 8), (136, 0), (130, 8)):
        args = _f32_views_and_cotangent((2, 3, 65, D), seed=D)
        copies.clear()
        got = _pair(args)
        torch.cuda.synchronize()
        assert copies.count(False) == want_copies, (D, copies)
        _check_f32_pair(got, _plain_pair(args), f"D={D}")
    B, T, H, D = 2, 65, 3, 32
    x = torch.randn((3, B, T, H * D), device="cuda").requires_grad_()
    q, k, v = (t.view(B, T, H, D).transpose(1, 2) for t in x)
    copies.clear()
    grads = torch.autograd.grad(flash_attention(q, k, v, 0.1), [q, k, v],
                                torch.ones((B, T, H, D), device="cuda"))
    assert copies.count(False) == 0, copies
    for a, ref in zip(grads, (q, k, v)):
        assert a.stride() == ref.stride()


@pytest.mark.parametrize("D,want", [(8, "split"), (32, "split"),
                                    (64, "split"), (128, "split"),
                                    (129, "split_stream"),
                                    (256, "split_stream"),
                                    (704, "split_stream")])
def test_f32_backward_pair_launches_the_split_kernels_up_to_128_columns(
        cuda, D, want):
    """Up to 128 columns the f32 pair launches the TF32 instances
    (``dq_split_kernel``, ``dkv_split_kernel`` after the rows pass), past
    them the streamed TF32 instances (``dq_split_stream_kernel``,
    ``dkv_split_stream_kernel``, after the rows pass too), never a
    CUDA-core kernel, by the profiler's kernel names; one launch of each
    pass by the wrappers' counters, on a call of its own (the profiler's
    window may run the pair again)."""
    from vit_cifar_torch.ops.cuda.common import f32_backward_plan

    args = _f32_views_and_cotangent((2, 3, 257, D), seed=D)
    counts = (flash_tiled_bwd_dq.launches, flash_tiled_bwd_dkv.launches)
    _pair(args)
    assert (flash_tiled_bwd_dq.launches - counts[0],
            flash_tiled_bwd_dkv.launches - counts[1]) == (1, 1), D
    names = _kernel_names(lambda: _pair(args))
    for kind in ("dq", "dkv"):
        hits = [n for n in names if f"{kind}_{want}_kernel" in n]
        assert hits, (D, kind, sorted(names))
    assert f32_backward_plan(257, D)["dq"]["streamed"] == (
        want == "split_stream")
    assert not any("chunk" in n for n in names), sorted(names)


# the f32 forwards: TF32 wgmma with the three-product split
# (csrc/wgmma_forward_tf32.cuh, FWD_F32 and WHOLE_F32 rows of
# csrc/forward_tiles.cuh) up to 128 columns, the streamed instance past
# them (FWD_F32_STREAMED); 12 head widths, D < 32, D % 4 != 0 (the padded
# copy: 6, 30, 66, 127), every f32 width and, at 136, the hand-off to the
# streamed instance
F32_FORWARD_D = (6, 8, 16, 30, 32, 44, 64, 66, 100, 127, 128, 136)
# the streamed instance's widths: D % 4 != 0 (129, 130: the padded copy;
# an odd number of 32-column chunks of s), a clamped chunk of o (192: two
# of 128 columns), whole groups (256), and 12, 17 and 22 chunks of s
F32_STREAMED_FWD_D = (129, 130, 136, 192, 256, 384, 520, 704)


def _f32_model_views(shape, seed):
    """q, k, v in f32 as the model makes them: (B, T, H*D) projections
    viewed as (B, H, T, D)."""
    B, H, T, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B, T, H * D), generator=g, device="cuda")
            .view(B, T, H, D).transpose(1, 2) for _ in range(3)]


def _check_f32_forwards(kernel, q, k, v, scale, what, bits=False):
    """Both variants of forward ``kernel`` against its plain version within
    the f32 limit (rtol 1e-5 / atol 1e-5); with ``bits`` a second call of
    each equal bit for bit."""
    fwd, fwd_lse, plain = FORWARDS[kernel]
    got = fwd(q, k, v, scale)
    out, lse = fwd_lse(q, k, v, scale)
    if bits:
        again = (fwd(q, k, v, scale), *fwd_lse(q, k, v, scale))
    torch.cuda.synchronize()
    want_out, want_lse = plain(q, k, v, scale)
    for name, a, w in (("out", got, want_out), ("out (lse)", out, want_out),
                       ("lse", lse, want_lse)):
        assert a.dtype == torch.float32, what
        torch.testing.assert_close(a, w, **TOL[torch.float32],
                                   msg=lambda m: f"{name} {what}: {m}")
    if bits:
        assert all(torch.equal(a, b) for a, b in zip((got, out, lse), again))


@pytest.mark.parametrize("kernel", ["mhsa", "flash"])
@pytest.mark.parametrize("T", WGMMA_T)
def test_f32_forwards_on_the_models_views(cuda, T, kernel):
    """Both f32 forwards, with and without lse, on the model's views at odd
    and ragged T (the whole-head tiles' and the 32- and 64-key tiles' ends,
    T=1025) and 12 head widths 6-136: against the plain version within
    rtol 1e-5 / atol 1e-5, and two calls equal bit for bit."""
    for D in F32_FORWARD_D:
        q, k, v = _f32_model_views((2, 3, T, D), seed=T + D)
        _check_f32_forwards(kernel, q, k, v, 1.0 / math.sqrt(3 * D),
                            f"T={T} D={D}", bits=True)


@pytest.mark.parametrize("kernel", ["mhsa", "flash"])
@pytest.mark.parametrize("T", RAGGED_T)
def test_f32_forwards_at_ragged_edges(cuda, T, kernel):
    """Where a 16-row fragment, a key tile (16 to 72 keys) or a work item
    (64 or 128 rows) ends, on contiguous inputs, at head dims that are and
    are not a multiple of 4."""
    for D in (16, 30, 32, 64, 100, 128):
        q, k, v, _, scale = _inputs(cuda, (2, 3, T, D), torch.float32,
                                    seed=5 * T + D)
        _check_f32_forwards(kernel, q, k, v, scale, f"T={T} D={D}")


@pytest.mark.parametrize("kernel", ["mhsa", "flash"])
@pytest.mark.parametrize("T,D", [(200, 32), (129, 32), (193, 64),
                                 (300, 128), (65, 32), (33, 128),
                                 (300, 192), (200, 520), (33, 256)])
def test_f32_forwards_guard_a_fully_masked_key_tile(cuda, T, D, kernel):
    """The key tile the f32 kernel takes first (the last one) has logits
    that all overflow to -inf (every q.k there is -1e40; each TF32 product
    of the split is -inf or finite, never NaN), with finite keys in the
    tiles before it: the running max stays at -inf through that tile
    without a NaN, and the rows equal the plain version's.  Where the head
    is one tile (mhsa_fwd's whole head at T=65 and 33) every key but the
    first 8 is masked; past 128 columns (the streamed instance) each
    consumer's part of s over its 32-column chunks is -inf there, and so
    is their sum."""
    from vit_cifar_torch.ops.cuda.common import f32_forward_plan

    _, fwd_lse, plain = FORWARDS[kernel]
    keys = f32_forward_plan(f"{kernel}_fwd", T, D)["keys"]
    first = max((T - 1) // keys * keys, 8)  # the first tile taken
    g = torch.Generator(device="cuda").manual_seed(T + D)
    q = torch.full((2, 2, T, D), 1e20, device="cuda")
    k = torch.randn((2, 2, T, D), generator=g, device="cuda") * 1e-20
    k[:, :, first:] = -1e20
    v = torch.randn((2, 2, T, D), generator=g, device="cuda")
    out, lse = fwd_lse(q, k, v, 0.1)
    torch.cuda.synchronize()
    want_out, want_lse = plain(q, k, v, 0.1)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out, want_out, **TOL[torch.float32])
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])


@pytest.mark.parametrize("kernel", ["mhsa", "flash"])
def test_f32_forwards_read_the_views_in_place(cuda, kernel, monkeypatch):
    """Where f32 tensor maps read the model's views (D % 4 == 0) no copy of
    q, k or v is made; where they cannot (D=30) the stated padded copy of
    each, 3 a call; past 128 columns (the streamed instance, whose split
    pass reads any view whose d stride is 1 in place) none, at 130 columns
    too."""
    from vit_cifar_torch.ops.cuda import common

    copies = []
    real = common.padded_copy
    monkeypatch.setattr(common, "padded_copy",
                        lambda t, meta=False: copies.append(meta)
                        or real(t, meta))
    fwd, _, plain = FORWARDS[kernel]
    for D, want_copies in ((32, 0), (44, 0), (30, 3), (136, 0), (192, 0),
                           (130, 0)):
        q, k, v = _f32_model_views((2, 3, 65, D), seed=D)
        copies.clear()
        got = fwd(q, k, v, 0.1)
        torch.cuda.synchronize()
        assert copies.count(False) == want_copies, (D, copies)
        torch.testing.assert_close(got, plain(q, k, v, 0.1)[0],
                                   **TOL[torch.float32])


@pytest.mark.parametrize("T,D,want", [
    (65, 8, "split"), (65, 32, "split"), (1025, 32, "split"),
    (65, 64, "split"), (257, 128, "split"), (33, 128, "split"),
    (65, 129, "stream"), (257, 256, "stream"), (257, 192, "stream"),
    (33, 704, "stream")])
def test_f32_forwards_launch_the_split_kernels_up_to_128_columns(
        cuda, T, D, want):
    """Up to 128 columns each f32 forward launches a TF32 instance
    (``fwd_split_kernel``: mhsa_fwd's whole-head one where the plan takes
    the whole head, the tiled one otherwise, and flash_fwd's tiled one),
    past them the streamed TF32 instance of the FWD_F32_STREAMED row
    (``fwd_split_stream_kernel``, after its split pass), never a CUDA-core
    kernel, by the profiler's kernel names; one launch each by the
    wrappers' counters."""
    from vit_cifar_torch.ops.cuda.common import f32_forward_plan

    q, k, v = _f32_model_views((2, 3, T, D), seed=D)
    for kernel in ("mhsa", "flash"):
        for fn in FORWARDS[kernel][:2]:
            before = fn.launches
            names = _kernel_names(lambda: fn(q, k, v, 0.1))
            assert fn.launches == before + 1, (kernel, fn.__name__)
            plan = f32_forward_plan(f"{kernel}_fwd", T, D)
            assert not any("chunk" in n for n in names), sorted(names)
            if want == "stream":
                # fwd_split_stream_kernel<keys, cols>, after its split
                # pass
                assert plan["grid"] == "streamed"
                hits = [n for n in names if (m := re.search(
                    r"fwd_split_stream_kernel<(\d+), ?(\d+)>", n))
                    and (int(m.group(1)), int(m.group(2))) == (
                        plan["keys"], plan["cols"])]
                assert any("split_qkv_kernel" in n for n in names), \
                    sorted(names)
            else:
                # fwd_split_kernel<width, keys, cols, bf16x3, whole>
                whole = plan["grid"] == "whole"
                hits = [n for n in names if (m := re.search(
                    r"fwd_split_kernel<(\d+), ?(\d+), ?\d+, ?\w+, ?(\w+)>",
                    n)) and (int(m.group(1)), int(m.group(2))) == (
                        plan["width"], plan["keys"])
                    and (m.group(3) in ("true", "1")) == whole]
            assert hits, (T, D, kernel, sorted(names))


FIRST_FORWARD_ON_AUTOGRADS_THREAD = r"""
import sys
import torch
import torch.utils.checkpoint
from vit_cifar_torch.ops.cuda.attention import fused_attention
from vit_cifar_torch.ops.cuda.flash_attention import flash_attention
fn = {"fused": fused_attention, "flash": flash_attention}[sys.argv[1]]
B, T, H, D = 2, 65, 3, int(sys.argv[2]) if len(sys.argv) > 2 else 32
x = torch.randn((3, B, T, H * D), device="cuda", requires_grad=True)

def attend(x):
    q, k, v = (t.view(B, T, H, D).transpose(1, 2) for t in x)
    return fn(q, k, v, 0.1)

# the first pass keeps no activation; the backward recomputes the forward
# with lse on autograd's device thread, that instance's first launch there
out = torch.utils.checkpoint.checkpoint(attend, x, use_reentrant=False)
(grad,) = torch.autograd.grad(out, [x], torch.ones_like(out))
torch.cuda.synchronize()
assert torch.isfinite(grad).all()
print("ok")
"""


@pytest.mark.parametrize("kernel", ["fused", "flash"])
def test_f32_forward_launches_first_on_autograds_thread(cuda, kernel):
    """In a fresh process, an f32 forward with lse recomputed by activation
    checkpointing in the backward: its first launch on autograd's device
    thread (each host thread sets the shared-memory opt-in of each kernel
    it launches, ``opt_in``), finite gradients.  The child imports only
    torch and the port."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-c", FIRST_FORWARD_ON_AUTOGRADS_THREAD, kernel],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and run.stdout.strip() == "ok", (
        run.stdout[-2000:], run.stderr[-2000:])


def _streamed_f32_inputs(shape, seed, contiguous):
    """f32 q, k, v: the model's views, or contiguous (B, H, T, D)."""
    if not contiguous:
        return _f32_model_views(shape, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda") for _ in range(3)]


@pytest.mark.parametrize("kernel", ["mhsa", "flash"])
@pytest.mark.parametrize("T", WGMMA_T)
def test_f32_streamed_forwards_on_the_models_views(cuda, T, kernel):
    """Past 128 columns (the streamed instance, s summed over 32-column
    chunks that the two consumers share, q, K and V split once a call) both
    f32 forwards, with and without lse, on the model's views at odd and
    ragged T (the 32-key tiles' and 64-row items' ends, T=1025) and D
    129-704: against the plain version within rtol 1e-5 / atol 1e-5, and
    two calls equal bit for bit."""
    for D in F32_STREAMED_FWD_D:
        q, k, v = _f32_model_views((2, 3, T, D), seed=T + D)
        _check_f32_forwards(kernel, q, k, v, 1.0 / math.sqrt(3 * D),
                            f"T={T} D={D}", bits=True)


@pytest.mark.parametrize("kernel", ["mhsa", "flash"])
@pytest.mark.parametrize("T", F32_STREAMED_T)
def test_f32_streamed_forwards_at_ragged_edges(cuda, T, kernel):
    """Past 128 columns, where a 16-row fragment, a 32-key tile or a
    64-row item ends, on contiguous inputs and on the model's views, at D
    129-704: both forwards, with and without lse, against the plain
    version, and two calls equal bit for bit."""
    for D in F32_STREAMED_FWD_D:
        for contiguous in (True, False):
            q, k, v = _streamed_f32_inputs((2, 3, T, D), 11 * T + D,
                                           contiguous)
            _check_f32_forwards(kernel, q, k, v, 1.0 / math.sqrt(3 * D),
                                f"T={T} D={D} contiguous={contiguous}",
                                bits=True)


@pytest.mark.parametrize("kernel", ["fused", "flash"])
def test_f32_streamed_forward_launches_first_on_autograds_thread(cuda,
                                                                  kernel):
    """The same at head_dim 192 in f32: the streamed forward's (and its
    split pass's) first launch in the process on autograd's device
    thread, recomputed by activation checkpointing."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-c", FIRST_FORWARD_ON_AUTOGRADS_THREAD, kernel,
         "192"], cwd=root, env=env, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0 and run.stdout.strip() == "ok", (
        run.stdout[-2000:], run.stderr[-2000:])


FIRST_BACKWARD_ON_AUTOGRADS_THREAD = r"""
import sys
import torch
from vit_cifar_torch.ops.cuda.flash_attention import (
    flash_attention, flash_attention_lse, flash_tiled_bwd_dkv,
    flash_tiled_bwd_dq)
dtype, main_first = getattr(torch, sys.argv[1]), sys.argv[2] == "main"
B, T, H, D = 2, 65, 3, int(sys.argv[3])
x = torch.randn((3, B, T, H * D), device="cuda").to(dtype)
if main_first:  # the pair's first launch on this (the main) thread
    q, k, v = (t.view(B, T, H, D).transpose(1, 2) for t in x)
    out, lse = flash_attention_lse(q, k, v, 0.1)
    g = torch.randn(out.shape, device="cuda").to(dtype)
    flash_tiled_bwd_dq(q, k, v, out, g, lse, 0.1)
    flash_tiled_bwd_dkv(q, k, v, out, g, lse, 0.1)
    torch.cuda.synchronize()
x.requires_grad_()
q, k, v = (t.view(B, T, H, D).transpose(1, 2) for t in x)
(grad,) = torch.autograd.grad(flash_attention(q, k, v, 0.1), [x],
                              torch.ones((B, T, H, D), device="cuda",
                                         dtype=dtype))
torch.cuda.synchronize()
assert torch.isfinite(grad.float()).all()
print("ok")
"""


@pytest.mark.parametrize("first", ["main", "autograd"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_backward_pair_launches_first_on_autograds_thread(cuda, dtype,
                                                          first):
    """In a fresh process: the Function's forward, then its backward, the
    pair's first launch in the process on autograd's device thread; and
    the pair first launched on the main thread, then the Function's
    backward on autograd's thread (the order in which each thread's first
    launch used to be refused, cudaError 1, before the shared-memory
    opt-in was made once a thread and kernel).  The child imports only
    torch and the port."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-c", FIRST_BACKWARD_ON_AUTOGRADS_THREAD, dtype,
         first, "32"], cwd=root, env=env, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0 and run.stdout.strip() == "ok", (
        run.stdout[-2000:], run.stderr[-2000:])


@pytest.mark.parametrize("first", ["main", "autograd"])
def test_f32_streamed_pair_launches_first_on_autograds_thread(cuda, first):
    """The same at head_dim 192 in f32: the streamed instances'
    (``dq_split_stream_kernel``, ``dkv_split_stream_kernel``) first launch
    in the process on autograd's device thread, or first on the main
    thread and then on autograd's."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-c", FIRST_BACKWARD_ON_AUTOGRADS_THREAD, "float32",
         first, "192"], cwd=root, env=env, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0 and run.stdout.strip() == "ok", (
        run.stdout[-2000:], run.stderr[-2000:])


def test_f32_streamed_function_grads_match_autograd_of_plain_forward(cuda):
    """The Function's gradients at (2, 2, 257, 192) in f32 (its forward
    with lse, then the streamed pair) against autograd through the plain
    forward, within the f32 gradient limit."""
    q, k, v, g, scale = _inputs(cuda, (2, 2, 257, 192), torch.float32,
                                seed=9)

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        return torch.autograd.grad(fn(*leaves, scale), leaves, g)

    for got, w in zip(grads(flash_attention),
                      grads(fused_attention_reference)):
        torch.testing.assert_close(got, w, **GRAD_TOL[torch.float32])


def _layer_grads(mod, x, g):
    return torch.autograd.grad(mod(x), [x, *mod.parameters()], g)


def test_default_config_past_the_tiled_head_dim_trains_on_the_card(cuda):
    """hidden 384 in 2 heads (head_dim 192) at T=257: the default config
    takes the tiled kernels, which cut the head into two column chunks (it
    took the einsum path while they stopped at head_dim 128), once each in
    forward and backward; the input's and parameters' grads match the
    einsum module's in f32 (the kernels sum in another order, chained twice
    over T in the backward: rtol 1e-4 / atol 1e-5)."""
    kw = dict(generator=torch.Generator().manual_seed(0), device=cuda)
    m = MultiHeadSelfAttention(384, 2, **kw)
    ref = MultiHeadSelfAttention(384, 2, pallas_kernel="einsum", **kw)
    ref.load_state_dict(m.state_dict())
    x = torch.randn(2, 257, 384, device=cuda, requires_grad=True)
    g = torch.randn(2, 257, 384, device=cuda)
    before = {n: w.launches for n, w in KERNEL_WRAPPERS.items()}
    got = _layer_grads(m, x, g)
    torch.cuda.synchronize()
    launched = {n: w.launches - before[n] for n, w in KERNEL_WRAPPERS.items()}
    assert launched == {"mhsa_fwd": 0, "mhsa_fwd_lse": 0, "flash_fwd": 0,
                        "flash_fwd_lse": 1, "flash_bwd_dq_tiled": 1,
                        "flash_bwd_dkv_tiled": 1}
    for a, w in zip(got, _layer_grads(ref, x, g)):
        torch.testing.assert_close(a, w, **GRAD_TOL[torch.float32])


@dtypes
def test_fused_at_head_dim_192_serves_and_trains_on_the_card(cuda, dtype):
    """``pallas_kernel="fused"`` at T=257, head_dim 192 (the whole-head
    forward's column-chunk layout, then the tiled pair): the forward
    launches the whole-head kernel once, a gradient the forward with lse
    and the tiled pair once each.  Output and grads match the einsum
    module's: in f32 within ``TOL`` and ``GRAD_TOL``; in bf16 the output and
    the flat vector of all grads within 2e-2 relative L2, the bound of a
    training step against the einsum path (which rounds its logits and
    probabilities to bf16, the kernels keep them in f32; the key bias's
    grad is 0 in exact arithmetic, so only noise, and is not compared
    alone)."""
    kw = dict(generator=torch.Generator().manual_seed(1), device=cuda,
              dtype=dtype)
    m = MultiHeadSelfAttention(384, 2, pallas_kernel="fused", **kw)
    ref = MultiHeadSelfAttention(384, 2, pallas_kernel="einsum", **kw)
    ref.load_state_dict(m.state_dict())
    x = torch.randn(2, 257, 384, device=cuda).to(dtype)
    g = torch.randn(2, 257, 384, device=cuda).to(dtype)
    before = {n: w.launches for n, w in KERNEL_WRAPPERS.items()}
    with torch.no_grad():
        out, want = m(x), ref(x)
    torch.cuda.synchronize()
    assert fused_attention.launches == before["mhsa_fwd"] + 1

    def close(got, want, tol):
        if dtype == torch.float32:
            for a, w in zip(got, want):
                torch.testing.assert_close(a, w, **tol)
        else:
            a, w = (torch.cat([t.float().reshape(-1) for t in ts])
                    for ts in (got, want))
            rel = ((a - w).norm() / w.norm()).item()
            assert rel <= 2e-2, rel

    close([out], [want], TOL[dtype])
    x.requires_grad_()
    got = _layer_grads(m, x, g)
    torch.cuda.synchronize()
    launched = {n: w.launches - before[n] for n, w in KERNEL_WRAPPERS.items()}
    assert launched == {"mhsa_fwd": 1, "mhsa_fwd_lse": 1, "flash_fwd": 0,
                        "flash_fwd_lse": 0, "flash_bwd_dq_tiled": 1,
                        "flash_bwd_dkv_tiled": 1}
    close(got, _layer_grads(ref, x, g), GRAD_TOL[dtype])


@pytest.mark.parametrize("shape,dtype", [
    ((1, 1, 1025, 32), torch.float32), ((1, 1, 1025, 32), torch.bfloat16),
    ((1, 1, 300, 192), torch.float32), ((1, 1, 300, 192), torch.bfloat16),
    ((128, 12, 1025, 32), torch.bfloat16)],
    ids=["1x1x1025x32-f32", "1x1x1025x32-bf16", "1x1x300x192-f32",
         "1x1x300x192-bf16", "128x12x1025x32-bf16"])
def test_fused_past_the_whole_head_matches_plain_version(cuda, shape, dtype):
    """``pallas_kernel="fused"`` where the head does not fit: both
    whole-head forwards (key tiles) against their plain versions, each
    launched once, and no tiled forward."""
    q, k, v, _, scale = _inputs(cuda, shape, dtype)
    before = {n: w.launches for n, w in KERNEL_WRAPPERS.items()}
    out = fused_attention(q, k, v, scale)
    out_l, lse = fused_attention_lse(q, k, v, scale)
    torch.cuda.synchronize()
    launched = {n: w.launches - before[n] for n, w in KERNEL_WRAPPERS.items()}
    assert launched == dict({n: 0 for n in KERNEL_WRAPPERS}, mhsa_fwd=1,
                            mhsa_fwd_lse=1)
    want, want_lse = fused_attention_lse_reference(q, k, v, scale)
    tol = flash_tol(TOL, dtype, want)
    torch.testing.assert_close(out, want, **tol)
    torch.testing.assert_close(out_l, want, **tol)
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])


def test_serving_artifact_launches_the_kernel_operator(cuda, tmp_path):
    """``serving.pt2`` exported on the card: its graph calls the whole-head
    operator, and serving it launches the kernel once a layer."""
    from vit_cifar_torch.deploy import export_model, load_inference

    cfg = Config(model_name="vit", num_layers=2, hidden=64, mlp_hidden=64,
                 head=2)
    model, _ = get_model(cfg, device=cuda)
    served = load_inference(export_model(model, cfg, str(tmp_path), cuda),
                            device="cuda")
    assert "vit_cifar_torch.mhsa_fwd.default" in {
        str(n.target) for n in served.program.graph.nodes}
    before = fused_attention.launches
    logits = served.predict(np.zeros((3, 32, 32, 3), np.uint8))
    assert fused_attention.launches == before + 2
    assert logits.shape == (3, 10) and np.isfinite(logits).all()


def _pixel_cfg(**kw):
    return Config(model_name="vit", num_layers=2, hidden=64, mlp_hidden=64,
                  head=2, patch=32, **kw)


def test_pixel_vit_training_step_launches_each_flash_kernel_per_layer(cuda):
    cfg = _pixel_cfg(batch_size=4, label_smoothing=True, warmup_epoch=0)
    model, _ = get_model(cfg, device=cuda)
    tx = make_optimizer(cfg, 2)
    state = init_state(cfg, model, tx)
    step = make_train_step(cfg, model, tx)
    x = torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8, device=cuda)
    y = torch.randint(0, 10, (8,), device=cuda)
    perm = torch.randperm(8, device=cuda)
    before = {n: w.launches for n, w in KERNEL_WRAPPERS.items()}
    state, metrics = step(state, x, y, perm, 0)
    torch.cuda.synchronize()
    launched = {n: w.launches - before[n] for n, w in KERNEL_WRAPPERS.items()}
    assert launched == {"mhsa_fwd": 0, "mhsa_fwd_lse": 0, "flash_fwd": 0,
                        "flash_fwd_lse": cfg.num_layers,
                        "flash_bwd_dq_tiled": cfg.num_layers,
                        "flash_bwd_dkv_tiled": cfg.num_layers}
    assert torch.isfinite(metrics["loss"]) and metrics["skipped_nonfinite"] == 0


def test_default_config_at_patch_32_routes_to_flash_on_the_card(cuda):
    """At T=1025 the whole-head kernels would raise; the default config
    takes the tiled kernel instead, once per layer, and agrees with the
    einsum path."""
    cfg = _pixel_cfg(precision="32")
    model, _ = get_model(cfg, device=cuda)
    model.eval().requires_grad_(False)
    plain, _ = get_model(cfg.replace(pallas_kernel="einsum"), device=cuda)
    plain.load_state_dict(model.state_dict())
    plain.eval().requires_grad_(False)
    x = torch.randn(2, 32, 32, 3, device=cuda)
    before = {n: w.launches for n, w in KERNEL_WRAPPERS.items()}
    with torch.inference_mode():
        out = model(x)
        want = plain(x)
    launched = {n: w.launches - before[n] for n, w in KERNEL_WRAPPERS.items()}
    assert launched["flash_fwd"] == cfg.num_layers
    assert sum(launched.values()) == cfg.num_layers
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-5)


# AutoAugment on the card against the CPU on the same draws: the shear's
# four-tap sum may round a tie one level apart, rotate's cos/sin may move a
# pixel at a tie, and a second stage may carry such a value further
AA_CARD_SHARE = 1e-3


@pytest.mark.parametrize("policy", ["cifar10", "svhn", "imagenet"])
def test_autoaugment_on_the_card_matches_the_cpu(cuda, policy):
    gen = torch.Generator(device=cuda).manual_seed(1)
    imgs = torch.randint(0, 256, (64, 32, 32, 3), dtype=torch.uint8,
                         device=cuda, generator=gen)
    draws = autoaugment_draws(gen, 64, policy)
    got = apply_autoaugment(imgs, *draws, policy)
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    want = apply_autoaugment(imgs.cpu(), *(d.cpu() for d in draws), policy)
    assert (got.cpu() != want).float().mean().item() <= AA_CARD_SHARE


def test_train_with_autoaugment_resumes_on_the_card(cuda, tmp_path,
                                                    monkeypatch):
    """2 epochs of a 2-layer ViT with AutoAugment through ``train()``,
    straight and stopped after epoch 1 then resumed: the same step count,
    the training kernels launched once a layer and step, and params within
    1e-2 relative L2 of the straight run (the card's reductions need not
    sum in one order from run to run)."""
    rng = np.random.default_rng(0)
    data = RawData(rng.integers(0, 256, (256, 32, 32, 3), dtype=np.uint8),
                   rng.integers(0, 10, 256).astype(np.int32),
                   rng.integers(0, 256, (100, 32, 32, 3), dtype=np.uint8),
                   rng.integers(0, 10, 100).astype(np.int32), 10, True)
    monkeypatch.setattr(loop, "load_dataset", lambda *a, **k: data)
    cfg = Config(model_name="vit", num_layers=2, hidden=64, mlp_hidden=64,
                 head=4, batch_size=32, eval_batch_size=50,
                 label_smoothing=True, warmup_epoch=0, max_epochs=2,
                 autoaugment=True, log_dir=str(tmp_path / "logs"))

    def run(name, **kw):
        before = {n: w.launches for n, w in KERNEL_WRAPPERS.items()}
        res = loop.train(cfg.replace(ckpt_dir=str(tmp_path / name), **kw),
                         verbose=False)
        steps = 8 * len(res["history"])
        launched = {n: w.launches - before[n]
                    for n, w in KERNEL_WRAPPERS.items()}
        assert launched["mhsa_fwd_lse"] == launched["flash_bwd_dq_tiled"] \
            == launched["flash_bwd_dkv_tiled"] == 2 * steps
        return res, load_checkpoint(res["ckpt_dir"], prefer="last")[0]

    precision = torch.get_float32_matmul_precision()
    res_a, pa = run("a")
    assert all(math.isfinite(r["loss"]) for r in res_a["history"])
    before = {n: w.launches for n, w in KERNEL_WRAPPERS.items()}
    res_b1 = loop.train(cfg.replace(ckpt_dir=str(tmp_path / "b1")),
                        verbose=False, stop_after=1)
    assert len(res_b1["history"]) == 1
    assert KERNEL_WRAPPERS["mhsa_fwd_lse"].launches \
        - before["mhsa_fwd_lse"] == 2 * 8
    res_b2, pb = run("b2", resume=res_b1["ckpt_dir"])
    assert len(res_b2["history"]) == 1
    assert pa["step"] == pb["step"] == 16
    assert int(pb["opt_state"]["count"]) == 16
    flat = [torch.cat([t.reshape(-1) for t in p["params"].values()])
            for p in (pa, pb)]
    assert ((flat[1] - flat[0]).norm() / flat[0].norm()).item() <= 1e-2
    assert torch.get_float32_matmul_precision() == precision
