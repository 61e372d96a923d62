"""The port's Mixture-of-Experts MLP (``vit_cifar_torch/ops/moe.py``), the
ViT with ``--moe-experts`` through ``get_model`` and its training (the
Switch aux loss in the loss and the metric ``moe_aux``), against the JAX
package on the CPU.

Inputs are made with numpy from a seed; weights are the port's init
carried across with ``flax_from_state_dict`` (the stacked ``expert_*``
keep their layout).  Tolerances, as ``tests/test_torch_cnn.py``: f32
module outputs and the aux loss rtol 1e-5 / atol 1e-6, gradients rtol
1e-4 / atol 1e-5, model logits rtol 1e-4 / atol 1e-5, bf16-mixed outputs
2e-2, training steps (metrics, moments, parameters) as there.  The port's
own paths (remat, E=1 against the dense MLP) are held to 1e-6 or exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_cifar_torch.config as tconfig
import vit_cifar_tpu.config as jconfig
from test_torch_ae import _cotangent
from test_torch_ae_train import _raw
from test_torch_cnn import (BF16_TOL, F32_TOL, GRAD_TOL, MOD_TOL, TRAIN,
                            check_module, check_round_trip,
                            check_train_steps, images, models, variables_of)
from test_torch_nnmf import one_torch_thread  # noqa: F401
from test_torch_train import _np
from vit_cifar_torch.data.augment import normalize
from vit_cifar_torch.models import get_model
from vit_cifar_torch.ops.common import EncoderMLP
from vit_cifar_torch.ops.moe import MoEMLP, collect_moe_aux
from vit_cifar_torch.train import loop
from vit_cifar_torch.train.losses import make_criterion
from vit_cifar_torch.train.optim import make_optimizer
from vit_cifar_torch.train.steps import make_metrics_zeros, make_train_step
from vit_cifar_torch.utils.transplant import (flax_from_state_dict,
                                              state_dict_from_flax)
from vit_cifar_tpu.data.augment import normalize as jax_normalize
from vit_cifar_tpu.models import get_model as jax_get_model
from vit_cifar_tpu.ops import moe as jmoe

B, T, FEAT, HID = 4, 17, 16, 24


def _g():
    return torch.Generator().manual_seed(0)


def _x(seed=1, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=(B, T, FEAT)).astype(dtype)


MOE_CASES = {
    "E4": dict(num_experts=4),
    "E2_overflow": dict(num_experts=2, capacity_factor=0.5),
    "E8_cf4": dict(num_experts=8, capacity_factor=4.0),
    "E1": dict(num_experts=1),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_mlp_matches_jax(case):
    """Output, the aux loss and the gradients of <out, r> + aux / 2: the
    router's through the gate and through the aux; capacity
    C = min(T, max(1, ceil(T/E cf))), overflow tokens out as zero."""
    kw = MOE_CASES[case]
    tmod = MoEMLP(FEAT, HID, generator=_g(), **kw)
    jmod = jmoe.MoEMLP(features=FEAT, mlp_hidden=HID, **kw)
    assert {n for n, _ in tmod.named_parameters()} == {
        "router.weight", "router.bias", "expert_w1", "expert_b1",
        "expert_w2", "expert_b2"}
    x = _x()
    r = _cotangent((B, T, FEAT))

    def loss(p):
        out, upd = jmod.apply({"params": p}, jnp.asarray(x),
                              mutable=["intermediates"])
        aux = upd["intermediates"]["moe_aux"][0]
        return jnp.sum(out * r) + 0.5 * aux, (out, aux)

    (_, (want, want_aux)), want_g = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(flax_from_state_dict(tmod))
    got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **MOD_TOL)
    np.testing.assert_allclose(_np(tmod.aux), _np(want_aux), **MOD_TOL)
    if case == "E2_overflow":  # C = 5 a expert: at least 7 tokens dropped
        assert int((got.abs().sum(-1) == 0).sum(1).min()) >= T - 2 * 5
    names, params = zip(*tmod.named_parameters())
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(r))
                                + 0.5 * tmod.aux, params)
    want_g = state_dict_from_flax(want_g)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(_np(g), _np(want_g[name]), **GRAD_TOL,
                                   err_msg=name)


def test_one_expert_is_the_dense_mlp():
    """E = 1: every token goes to the expert with gate 1, so the layer is
    the encoder MLP with the same weights."""
    moe = MoEMLP(FEAT, HID, num_experts=1, generator=_g())
    dense = EncoderMLP(HID, FEAT, generator=_g())
    with torch.no_grad():
        dense.fc1.weight.copy_(moe.expert_w1[0].T)
        dense.fc1.bias.copy_(moe.expert_b1[0])
        dense.fc2.weight.copy_(moe.expert_w2[0].T)
        dense.fc2.bias.copy_(moe.expert_b2[0])
    x = torch.from_numpy(_x(2))
    with torch.no_grad():
        torch.testing.assert_close(moe(x), dense(x), rtol=1e-6, atol=1e-6)
    assert float(moe.aux) == 1.0


def test_moe_mlp_bf16_matches_jax():
    """The router in f32, the experts in bf16."""
    tmod = MoEMLP(FEAT, HID, num_experts=4, generator=_g(),
                  dtype=torch.bfloat16)
    jmod = jmoe.MoEMLP(features=FEAT, mlp_hidden=HID, num_experts=4,
                       dtype=jnp.bfloat16)
    x = torch.from_numpy(_x(3)).to(torch.bfloat16)
    want = jax.jit(lambda p, a: jmod.apply({"params": p}, a))(
        flax_from_state_dict(tmod), jnp.asarray(_np(x.float()), jnp.bfloat16))
    with torch.no_grad():
        got = tmod(x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32),
                               **BF16_TOL)


# -- get_model ----------------------------------------------------------------

TINY = dict(model_name="vit", num_layers=2, hidden=32, mlp_hidden=64, head=4,
            patch=4, precision="32", moe_experts=4)


@pytest.mark.parametrize("kw", [dict(model_name="lgcnn"),
                                dict(model_name="cnn_baseline"),
                                dict(use_encoder_mlp=False)],
                         ids=["lgcnn", "cnn_baseline", "no_encoder_mlp"])
def test_moe_validation_errors_are_jax_errors(kw):
    """JAX's two ValueErrors, word for word: a CNN has no encoder MLP to
    replace, and the MoE needs the encoder MLP."""
    cfg = dict(TINY, **kw)
    with pytest.raises(ValueError) as want:
        jax_get_model(jconfig.Config(**cfg))
    with pytest.raises(ValueError) as got:
        get_model(tconfig.Config(**cfg), device="cpu")
    assert str(got.value) == str(want.value)


def test_moe_vit_logits_and_grads_match_jax():
    jcfg, jmodel, _, (tmodel, unsup) = models(TINY)
    assert not unsup
    assert [type(getattr(tmodel, f"enc{i}").mlp) for i in range(2)] == [
        MoEMLP, MoEMLP]
    x = jax_normalize(jnp.asarray(images(16)), jcfg.mean, jcfg.std)
    check_module(jmodel, tmodel, [np.array(x, np.float32)], train=True,
                 out_tol=F32_TOL)


def test_moe_vit_logits_match_jax_bf16():
    jcfg, jmodel, tcfg, (tmodel, _) = models(dict(TINY,
                                                  precision="bf16-mixed"))
    imgs = images(17)
    x = jax_normalize(jnp.asarray(imgs), jcfg.mean, jcfg.std).astype(
        jcfg.compute_dtype)
    want = jax.jit(lambda v: jmodel.apply(v, x))(variables_of(tmodel))
    with torch.no_grad():
        got = tmodel(normalize(torch.from_numpy(imgs), tcfg.mean, tcfg.std))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32),
                               **BF16_TOL)


def test_moe_vit_transplant_round_trip():
    _, jmodel, _, (tmodel, _) = models(TINY)
    check_round_trip(jmodel, tmodel, {"params"})
    assert flax_from_state_dict(tmodel)["enc0"]["mlp"]["expert_w1"].shape \
        == (4, 32, 64)


# -- training -----------------------------------------------------------------

MOE_TRAIN = dict(TRAIN, model_name="vit", mlp_hidden=64, moe_experts=4)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_moe_train_steps_match_jax(n_steps):
    """vit --moe-experts 4: the loss with the aux term, the ``moe_aux``
    metric, parameters and both moments."""
    metrics = check_train_steps(MOE_TRAIN, n_steps)
    assert "moe_aux" in metrics and float(metrics["moe_aux"]) >= 1.0


def test_moe_aux_is_added_once_and_not_lambda_weighted():
    """Under MixUp the two criteria are lambda-mixed and the aux term is
    added once, from the step's own forward; with weight 0 there is no
    term and no metric."""
    cfg = tconfig.Config(**dict(MOE_TRAIN, mixup=True))
    assert "moe_aux" in make_metrics_zeros(cfg, "cpu")
    assert "moe_aux" not in make_metrics_zeros(
        cfg.replace(moe_aux_weight=0.0), "cpu")
    model, _ = get_model(cfg, device="cpu")
    tx = make_optimizer(cfg, 4, model)
    state = loop.init_state(cfg, model, tx)
    step = make_train_step(cfg, model, tx)
    img = torch.from_numpy(np.array(jax_normalize(
        jnp.asarray(images(18)), cfg.mean, cfg.std)))
    label, rand_label = torch.arange(B), torch.arange(B).flip(0)
    lam = torch.tensor(0.3)
    rewind = state.generator.get_state()
    loss, logits, _, aux = step.loss_and_grads(state, img, label, rand_label,
                                               lam)
    crit = make_criterion(cfg)
    want = crit(logits, label) * lam + crit(logits, rand_label) * (1 - lam) \
        + cfg.moe_aux_weight * aux
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(aux, collect_moe_aux(model).detach())
    state.generator.set_state(rewind)
    assert step.loss_and_grads(state, img, label)[3] is not None


def test_remat_takes_the_aux_of_the_first_forward():
    """``--remat``: the same loss, gradients and ``moe_aux`` as without."""
    cfg = tconfig.Config(**MOE_TRAIN)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, 32, 32, 3)).astype(np.float32))
    label = torch.tensor([1, 2, 3, 4])
    out = []
    for remat in (False, True):
        model, _ = get_model(cfg.replace(remat=remat), device="cpu")
        logits = model(x, deterministic=False)
        aux = collect_moe_aux(model)
        loss = make_criterion(cfg)(logits, label) + cfg.moe_aux_weight * aux
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out.append((loss, aux.detach(), grads))
    (l0, a0, g0), (l1, a1, g1) = out
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_history_has_moe_aux(tmp_path, monkeypatch):
    monkeypatch.setattr(loop, "load_dataset", lambda *a, **k: _raw(2))
    res = loop.train(tconfig.Config(
        **dict(MOE_TRAIN, max_epochs=1, synthetic_data=True),
        log_dir=str(tmp_path / "logs"), ckpt_dir=str(tmp_path / "m")),
        verbose=False, device="cpu")
    row = res["history"][0]
    assert np.isfinite(row["moe_aux"]) and row["moe_aux"] >= 1.0
    with open(os.path.join(res["log_dir"], "metrics.csv")) as f:
        assert "moe_aux" in f.readline().strip().split(",")

