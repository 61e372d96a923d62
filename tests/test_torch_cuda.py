"""The port's CUDA kernels on the card, against their plain PyTorch
versions.

Marked ``gpu``: skipped where there is no CUDA card.  This file imports no
jax, so it also runs on a machine without the JAX package:
``python -m pytest --noconftest tests/test_torch_cuda.py -m gpu``.
Tolerances: forward f32 1e-5 (the same f32 math, sums in another order);
backward f32 rtol 1e-4 / atol 1e-5 (two chained sums over T); bf16 1e-2
against the plain version (one bf16 rounding step either way); the
Function's bf16 grads against autograd through the plain forward 2e-2 (the
backward reads the forward's output rounded to bf16, autograd its f32
probabilities).
"""

import math

import pytest
import torch

from vit_cifar_torch import Config
from vit_cifar_torch.models import get_model
from vit_cifar_torch.ops.cuda.attention import (
    KERNEL_WRAPPERS, flash_bwd_dkv, flash_bwd_dkv_reference, flash_bwd_dq,
    flash_bwd_dq_reference, fused_attention, fused_attention_lse,
    fused_attention_lse_reference, fused_attention_reference)
from vit_cifar_torch.train.loop import init_state
from vit_cifar_torch.train.optim import make_optimizer
from vit_cifar_torch.train.steps import make_train_step

pytestmark = pytest.mark.gpu

SHAPES = [(128, 12, 65, 32), (2, 4, 9, 16), (2, 3, 65, 32), (1, 2, 130, 64),
          (2, 2, 96, 128)]
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
           torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
GRAD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
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
    q, k, v, g, scale = _inputs(cuda, shape, dtype, seed=1)
    out, lse = fused_attention_lse_reference(q, k, v, scale)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    dq = flash_bwd_dq(q, k, v, out, g, lse, scale)
    dk, dv = flash_bwd_dkv(q, k, v, out, g, lse, scale)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = [flash_bwd_dq_reference(q, k, v, out, g, lse, scale),
            *flash_bwd_dkv_reference(q, k, v, out, g, lse, scale)]
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
    q = torch.zeros(1, 1, 2048, 64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fused_attention(q, q, q, 0.1)
    with pytest.raises(ValueError, match="shared memory"):
        fused_attention_lse(q, q, q, 0.1)
    o = torch.zeros(1, 2048, 1, 64, device=cuda)
    lse = torch.zeros(1, 1, 2048, device=cuda)
    for fn in (flash_bwd_dq, flash_bwd_dkv):
        with pytest.raises(ValueError, match="shared memory"):
            fn(q, q, q, o, o, lse, 0.1)


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
                        "mhsa_bwd_dq": cfg.num_layers,
                        "mhsa_bwd_dkv": cfg.num_layers}
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
