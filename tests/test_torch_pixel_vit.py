"""The pixel-token ViT (``patch=32``: one pixel a token, T=1025 with the
cls token) through the port's tiled flash attention, against the JAX model
on its ``pallas_kernel="flash"`` path, on the CPU.

A 2-layer ViT of hidden 64 and 2 heads (head_dim 32) at B=2, f32, with the
JAX init carried across by ``state_dict_from_flax``; inputs are made with
numpy from a seed, and the training step gets the JAX step's own augmented
batch.  The JAX flash kernels run in interpret mode.  Tolerances are those
of ``tests/test_torch_train.py``: rtol 1e-4 / atol 1e-5 (the order of sums
differs).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_cifar_torch.config as tconfig
import vit_cifar_tpu.config as jconfig
from vit_cifar_torch.data.augment import normalize
from vit_cifar_torch.models import get_model
from vit_cifar_torch.ops.attention import route
from vit_cifar_torch.ops.cuda import KERNEL_WRAPPERS
from vit_cifar_torch.ops.patchify import to_words
from vit_cifar_torch.train import losses as tlosses
from vit_cifar_torch.train.loop import init_state
from vit_cifar_torch.train.optim import make_optimizer
from vit_cifar_torch.train.steps import make_train_step
from vit_cifar_torch.utils.transplant import state_dict_from_flax
from vit_cifar_tpu.data import augment as jaug
from vit_cifar_tpu.models import get_model as jax_get_model
from vit_cifar_tpu.ops.patchify import to_words as jax_to_words
from vit_cifar_tpu.train.loop import init_state as jax_init_state
from vit_cifar_tpu.train.optim import make_optimizer as jax_make_optimizer
from vit_cifar_tpu.train.steps import \
    make_grad_debug_step as jax_make_grad_debug_step
from vit_cifar_tpu.train.steps import make_train_step as jax_make_train_step
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

F32_TOL = dict(rtol=1e-4, atol=1e-5)
PIXEL = dict(model_name="vit", num_layers=2, hidden=64, mlp_hidden=64,
             head=2, patch=32, batch_size=2, eval_batch_size=2,
             label_smoothing=True, warmup_epoch=0, precision="32",
             dropout=0.0)
N_TRAIN = 4


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@functools.cache
def _jax_side():
    jcfg = jconfig.Config(**dict(PIXEL, pallas_kernel="flash"))
    jmodel, _ = jax_get_model(jcfg)
    jtx = jax_make_optimizer(jcfg, N_TRAIN // jcfg.batch_size)
    jstate = jax_init_state(jcfg, jmodel, jtx,
                            jnp.zeros((2, 32, 32, 3), jnp.float32))
    return (jcfg, jmodel, jtx, jstate,
            jax.jit(jax_make_grad_debug_step(jcfg, jmodel)))


def _port(pallas_kernel=""):
    *_, jstate, _ = _jax_side()
    tcfg = tconfig.Config(**dict(PIXEL, pallas_kernel=pallas_kernel))
    tmodel, _ = get_model(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(jstate.params))
    return tcfg, tmodel


def _data():
    rng = np.random.default_rng(11)
    return (rng.integers(0, 256, (N_TRAIN, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 10, N_TRAIN).astype(np.int32),
            rng.permutation(N_TRAIN).astype(np.int32))


def test_pixel_tokens_match_jax():
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    got = to_words(torch.from_numpy(x), 32)
    assert got.shape == (2, 1024, 3)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_to_words(jnp.asarray(x), 32)))


def test_pixel_vit_full_width_param_count_and_route():
    """The README recipe's width at patch 32: Linear(3 -> 384) embedding and
    a (1, 1025, 384) position table, 6,620,170 parameters; its attention
    (T=1025, head_dim 32) is past the whole-head forward, so the default
    config takes the tiled kernels in serving and in training."""
    cfg = tconfig.Config(model_name="vit", num_layers=7, hidden=384,
                         mlp_hidden=384, head=12, patch=32)
    model, _ = get_model(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 6_620_170
    assert model.emb.weight.shape == (384, 3)
    assert model.pos_emb.shape == (1, 1025, 384)
    assert route(1025, cfg.hidden // cfg.head, cfg.pallas_kernel) == "flash"


@pytest.mark.parametrize("pallas_kernel", ["", "flash"],
                         ids=["default", "flash"])
def test_pixel_vit_eval_logits_match_jax_flash(pallas_kernel):
    jcfg, jmodel, _, jstate, _ = _jax_side()
    _, tmodel = _port(pallas_kernel)
    imgs = _data()[0][:2]
    x = jaug.normalize(jnp.asarray(imgs), jcfg.mean, jcfg.std)
    want = np.asarray(jmodel.apply({"params": jstate.params}, x,
                                   deterministic=True))
    before = {n: w.launches for n, w in KERNEL_WRAPPERS.items()}
    with torch.no_grad():
        got = tmodel(normalize(torch.from_numpy(imgs), jcfg.mean, jcfg.std))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(_np(got), want, **F32_TOL)
    assert {n: w.launches for n, w in KERNEL_WRAPPERS.items()} == before


def test_pixel_vit_train_step_matches_jax():
    """One training step: the loss and every gradient at the same weights
    and batch, then the step's metrics and updated parameters."""
    jcfg, jmodel, jtx, jstate, jgrads = _jax_side()
    tcfg, tmodel = _port()
    ttx = make_optimizer(tcfg, N_TRAIN // tcfg.batch_size)
    tstate = init_state(tcfg, tmodel, ttx)
    x, y, perm = _data()
    jx, jy, jperm = (jnp.asarray(a) for a in (x, y, perm))

    # the JAX step's batch: its crop/flip draw, then normalize
    key = jax.random.fold_in(jstate.rng, jstate.step)
    idx = perm[:jcfg.batch_size]
    img = jaug.random_crop_flip(jax.random.split(key, 6)[0],
                                jnp.asarray(x[idx]), jcfg.padding, flip=True)
    img = torch.from_numpy(np.array(jaug.normalize(img, jcfg.mean, jcfg.std),
                                    np.float32))
    label = torch.from_numpy(y[idx])

    want_g, want_loss = jgrads(jstate, jx, jy, jperm, 0)
    loss = tlosses.make_criterion(tcfg)(
        tmodel(img, deterministic=False, generator=tstate.generator), label)
    names = [n for n, _ in tmodel.named_parameters()]
    got_g = dict(zip(names, torch.autograd.grad(loss,
                                                list(tmodel.parameters()))))
    np.testing.assert_allclose(_np(loss), np.asarray(want_loss), **F32_TOL)
    for name, g in state_dict_from_flax(want_g).items():
        np.testing.assert_allclose(_np(got_g[name]), _np(g), **F32_TOL,
                                   err_msg=f"grad {name}")

    jstate, jm = jax.jit(jax_make_train_step(jcfg, jmodel, jtx))(
        jstate, jx, jy, jperm, 0)
    tstate, tm = make_train_step(tcfg, tmodel, ttx).on_batch(tstate, img,
                                                             label)
    for name in ("loss", "acc", "skipped_nonfinite"):
        np.testing.assert_allclose(_np(tm[name]), np.asarray(jm[name]),
                                   **F32_TOL, err_msg=name)
    # Adam's first update is nearly lr * sign(g): atol 1e-4 as in
    # tests/test_torch_train.py
    for name, p in state_dict_from_flax(jstate.params).items():
        np.testing.assert_allclose(_np(tmodel.state_dict()[name]), _np(p),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
