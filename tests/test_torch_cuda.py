"""The port's CUDA kernel on the card, against its plain PyTorch version.

Marked ``gpu``: skipped where there is no CUDA card.  This file imports no
jax, so it also runs on a machine without the JAX package:
``python -m pytest --noconftest tests/test_torch_cuda.py -m gpu``.
Tolerances: f32 1e-5 (the same f32 math, sums in another order); bf16
1e-2 (one bf16 rounding step either way).
"""

import math

import pytest
import torch

from vit_cifar_torch import Config
from vit_cifar_torch.models import get_model
from vit_cifar_torch.ops.cuda.attention import (fused_attention,
                                                fused_attention_reference)

pytestmark = pytest.mark.gpu

SHAPES = [(128, 12, 65, 32), (2, 4, 9, 16), (2, 3, 65, 32), (1, 2, 130, 64),
          (2, 2, 96, 128)]
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


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


def test_kernel_refuses_inputs_that_need_a_gradient(cuda):
    q = torch.randn(1, 2, 9, 16, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        fused_attention(q, q.detach(), q.detach(), 0.1)


def test_kernel_refuses_shapes_over_shared_memory(cuda):
    q = torch.zeros(1, 1, 2048, 64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fused_attention(q, q, q, 0.1)


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
