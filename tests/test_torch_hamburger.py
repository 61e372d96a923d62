"""The port's burgers (``vit_cifar_torch/ops/hamburger.py``: the bread,
V1/V2/V2+, ``Hamburger`` and ``HamburgerAttention``), the hamburger models
through ``get_model`` and their training, against the JAX package on the
CPU.

Weights, running statistics and persistent bases are carried across with
``flax_from_state_dict`` (``batch_stats`` and ``state``); the random bases
of ``rand_init`` are JAX's own draw (its ``PRNGKey(0)`` fallback when no
``mask`` rng is given), handed to the port through ``bases_draw``.  MD_D is
the reference's 512 here too: a narrow model does not shrink the burger.
Tolerances: the bread's outputs and statistics rtol 1e-5 / atol 1e-6, as
``tests/test_torch_cnn.py``; whatever holds the matrix decomposition rtol
1e-4 / atol 1e-5, as ``tests/test_torch_nnmf.py`` holds it (six or seven
multiplicative updates amplify rounding: a V2 burger's outputs move by up
to 3e-5 at values near 8 between the two sides); gradients rtol 1e-4 /
atol 1e-5, the models' rtol 1e-4 / atol 4e-5, bf16-mixed logits 2e-2 and
training steps as ``tests/test_torch_cnn.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_cifar_torch.config as tconfig
from test_torch_ae_train import _raw
from test_torch_cnn import (BF16_TOL, F32_TOL, MODEL_GRAD_TOL, TRAIN,
                            check_module, check_round_trip,
                            check_train_steps, images, models, variables_of)
from test_torch_gnnmf import _inject_draws
from test_torch_nnmf import one_torch_thread  # noqa: F401
from test_torch_train import _np
from vit_cifar_torch import cli
from vit_cifar_torch.data.augment import normalize
from vit_cifar_torch.models import get_model
from vit_cifar_torch.ops import hamburger as tham
from vit_cifar_torch.train import loop
from vit_cifar_tpu.data.augment import normalize as jax_normalize
from vit_cifar_tpu.ops import hamburger as jham

B = 4


def _g():
    return torch.Generator().manual_seed(0)


def _rand(shape, seed, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape)
            + shift).astype(np.float32)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_conv_bn_relu_matches_jax(train):
    tmod = tham.ConvBNReLU(5, 7, generator=_g(), dtype=torch.float32)
    with torch.no_grad():
        bn = tmod.bn.TorchBatchNorm_0
        bn.mean.uniform_(-0.5, 0.5, generator=_g())
        bn.var.uniform_(0.5, 2.0, generator=_g())
    check_module(jham.ConvBNReLU(features=7), tmod,
                 [_rand((B, 3, 2, 5), 1)], train)


BURGERS = {
    "V1": dict(version="V1"),
    "V2": dict(version="V2"),
    "V2+": dict(version="V2+"),
    "V1_depthwise": dict(version="V1", spatial=False),
    "V2+_bases": dict(version="V2+", rand_init=False),
    "V1_bases_depthwise": dict(version="V1", rand_init=False, spatial=False),
}
H, W, IN_C = 6, 2, 5


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", list(BURGERS))
def test_burger_matches_jax(case, train):
    """Output, gradients, running statistics and the bases' EMA; the input
    is positive, as the burgers see it after the encoder's LayerNorm and
    the NMF's ReLU."""
    kw = BURGERS[case]
    tmod = tham.HamburgerBurger(IN_C, spatial_size=H * W, generator=_g(),
                                **kw)
    _inject_draws(tmod, B)
    jmod = jham.HamburgerBurger(in_c=IN_C, **kw)
    check_module(jmod, tmod, [_rand((B, H, W, IN_C), 2)], train,
                 out_tol=F32_TOL)


def test_gated_burger_raises():
    with pytest.raises(NotImplementedError, match="Gated"):
        tham.HamburgerBurger(IN_C, "Gated", spatial_size=H * W,
                             generator=_g())
    with pytest.raises(NotImplementedError, match="burger-mode"):
        get_model(tconfig.Config(**dict(TINY, model_name="hamburger",
                                        burger_mode="Gated")), device="cpu")


T, FEAT = 17, 32


@pytest.mark.parametrize("mixer,kw", [
    ("hamburger", {}), ("hamburger", dict(burger_mode="V2+")),
    ("attention", {}), ("attention", dict(query=False, depthwise=True))],
    ids=["hamburger_V1", "hamburger_V2+", "attention", "attention_no_query"])
def test_mixers_match_jax(mixer, kw):
    """The (B, T, F) -> (B, F, 1, T) token view and back, in training
    mode; HamburgerAttention's softmax over the tokens and its gate."""
    if mixer == "hamburger":
        tmod = tham.Hamburger(T, FEAT, generator=_g(), **kw)
        jmod = jham.Hamburger(seq_len=T, features=FEAT, **kw)
    else:
        tmod = tham.HamburgerAttention(T, FEAT, generator=_g(), **kw)
        jmod = jham.HamburgerAttention(seq_len=T, features=FEAT, **kw)
    _inject_draws(tmod, B)
    if mixer == "attention":
        assert (tmod.Wq is not None) == kw.get("query", True)
    check_module(jmod, tmod, [_rand((B, T, FEAT), 3, shift=1.0)], train=True,
                 out_tol=F32_TOL)


# -- the models, through get_model --------------------------------------------

TINY = dict(num_layers=1, hidden=FEAT, ffn_features=64, mlp_hidden=64,
            head=4, patch=4, precision="32")
MODELS = {
    "hamburger": dict(model_name="hamburger"),
    "hamburger_V2": dict(model_name="hamburger", burger_mode="V2"),
    "hamburger_V2+_bases": dict(model_name="hamburger", burger_mode="V2+",
                                train_md_bases=True),
    "hamburger_depthwise": dict(model_name="hamburger", depthwise=True),
    "hamburger_attention": dict(model_name="hamburger_attention"),
    "hamburger_attention_bases": dict(model_name="hamburger_attention",
                                      burger_mode="V2", train_md_bases=True),
}


def _models(name, **extra):
    jcfg, jmodel, tcfg, (tmodel, unsup) = models(
        dict(TINY, **MODELS[name], **extra))
    assert not unsup
    _inject_draws(tmodel, B)
    return jcfg, jmodel, tcfg, tmodel


MODEL_CASES = [(n, True) for n in MODELS] + [("hamburger_V2+_bases", False),
                                             ("hamburger_attention", False)]


@pytest.mark.parametrize("name,train", MODEL_CASES, ids=[
    f"{n}-{'train' if t else 'eval'}" for n, t in MODEL_CASES])
def test_hamburger_models_match_jax(name, train):
    """Logits, every gradient, the running statistics and the bases."""
    jcfg, jmodel, _, tmodel = _models(name)
    x = jax_normalize(jnp.asarray(images(14)), jcfg.mean, jcfg.std)
    check_module(jmodel, tmodel, [np.array(x, np.float32)], train,
                 out_tol=F32_TOL, grad_tol=MODEL_GRAD_TOL)


@pytest.mark.parametrize("name", ["hamburger_V2+_bases",
                                  "hamburger_attention"])
def test_hamburger_models_logits_match_jax_bf16(name):
    """bf16-mixed: the decomposition in f32 inside, BatchNorm in f32 cast
    back; V2+'s f32 coefficients leave its residual stream in f32, as in
    JAX."""
    jcfg, jmodel, tcfg, tmodel = _models(name, precision="bf16-mixed")
    imgs = images(15)
    x = jax_normalize(jnp.asarray(imgs), jcfg.mean, jcfg.std).astype(
        jcfg.compute_dtype)
    want = jax.jit(lambda v: jmodel.apply(v, x))(variables_of(tmodel))
    with torch.no_grad():
        got = tmodel(normalize(torch.from_numpy(imgs), tcfg.mean, tcfg.std))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32),
                               **BF16_TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_hamburger_transplant_round_trip(name):
    _, jmodel, _, tmodel = _models(name)
    check_round_trip(jmodel, tmodel, {"params", "batch_stats"} | (
        {"state"} if MODELS[name].get("train_md_bases") else set()))


# -- training -----------------------------------------------------------------

V2P_BASES = dict(TRAIN, num_layers=1, model_name="hamburger",
                 burger_mode="V2+", train_md_bases=True)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_hamburger_v2plus_train_steps_match_jax(n_steps):
    """hamburger V2+ with --train-md-bases: metrics, parameters, both
    moments, the running statistics and the bases after the EMA.  V2+
    starts at ``coef_ham`` = 0, so the first step's gradient reaches only
    ``coef_ham`` and the trunk; the later steps reach the burger's weights
    through the coefficient the first one moved."""
    check_train_steps(V2P_BASES, n_steps)


def test_cli_dry_run_of_hamburger(tmp_path, monkeypatch):
    monkeypatch.setattr(loop, "load_dataset", lambda *a, **k: _raw(2))
    res = cli.main(["--model-name", "hamburger", "--num-layers", "1",
                    "--hidden", "32", "--mlp-hidden", "32", "--dry-run",
                    "--precision", "32", "--batch-size", "8",
                    "--eval-batch-size", "8", "--device", "cpu",
                    "--log-dir", str(tmp_path / "logs"),
                    "--ckpt-dir", str(tmp_path / "models")])
    assert len(res["history"]) == 1 and np.isfinite(res["val_loss"])
    assert res["experiment"].startswith("hamburger_c10_1l_")
