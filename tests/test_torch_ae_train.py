"""Training the port's AE family (``vit_cifar_torch/train/unsupervised.py``,
the AE branch of ``train/steps.py``, the ``aece`` criterion, the frozen
entries of the main optimizer, ``--semi-supervised`` and the AE state in
``train()``'s checkpoints) against the JAX package, on the CPU.

The JAX step's batch (its crop/flip key) is handed to the port's
``on_batch``, as in ``tests/test_torch_train.py``; weights are the JAX init
carried across.  Tolerances, with the limits of that file: f32 losses and
metrics rtol 1e-4 / atol 1e-5; parameters after Adam steps atol 1e-4
(Adam's first updates move a parameter by nearly lr whatever the size of
its gradient); the first moments rtol 1e-4 / atol 1e-5 (0.1 of a gradient
and its history) and the square roots of the second moments the same (of
the order of the gradients).  Where the two sides run the same f32
operations in the same order on the port's side (the AE entries under
``ce``, the NaN skip, resume), the checks are exact.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import vit_cifar_torch.config as tconfig
import vit_cifar_tpu.config as jconfig
from test_torch_train import _jax_batch, _np
from vit_cifar_torch import cli
from vit_cifar_torch.data.datasets import RawData, semi_supervised_split
from vit_cifar_torch.models import get_model
from vit_cifar_torch.train import loop
from vit_cifar_torch.train import losses as tlosses
from vit_cifar_torch.train.checkpoint import load_checkpoint
from vit_cifar_torch.train.optim import make_optimizer
from vit_cifar_torch.train.steps import make_metrics_zeros, make_train_step
from vit_cifar_torch.train.unsupervised import (is_ae_param,
                                                make_unsupervised_update)
from vit_cifar_torch.utils.transplant import state_dict_from_flax
from vit_cifar_tpu.data.datasets import \
    semi_supervised_split as jax_semi_supervised_split
from vit_cifar_tpu.models import get_model as jax_get_model
from vit_cifar_tpu.train import losses as jlosses
from vit_cifar_tpu.train.loop import init_state as jax_init_state
from vit_cifar_tpu.train.optim import make_optimizer as jax_make_optimizer
from vit_cifar_tpu.train.steps import make_train_step as jax_make_train_step
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

F32_TOL = dict(rtol=1e-4, atol=1e-5)
ADAM_PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
TINY = dict(model_name="ae", num_layers=2, hidden=32, ffn_features=64,
            mlp_hidden=64, head=4, patch=4, batch_size=4, eval_batch_size=4,
            warmup_epoch=0, precision="32", dropout=0.0,
            ae_hidden_features=16, ae_hidden_seq_len=5)
CASES = {
    # the AE moved by the inner loop alone (ce: no main-gradient path)
    "ce_unsupervised": dict(unsupervised_steps=1),
    "aece": dict(criterion="aece", aece_l1_regularization=0.1,
                 aece_l1_outputs=True),
    "heads_unsupervised_2": dict(ae_type="heads", unsupervised_steps=2),
}
N_TRAIN = 16


def _by_name(model, flat, select=lambda name: True):
    """Slices of a flat vector over ``model``'s parameters (or those that
    ``select`` takes, packed), by name, shaped as the parameters."""
    out, offset = {}, 0
    for name, p in model.named_parameters():
        if select(name):
            out[name] = flat[offset:offset + p.numel()].view(p.shape)
            offset += p.numel()
    return out


def _adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))


@functools.cache
def _jax_side(case: str):
    jcfg = jconfig.Config(**TINY, **CASES[case])
    jmodel, _ = jax_get_model(jcfg)
    jtx = jax_make_optimizer(jcfg, N_TRAIN // jcfg.batch_size)
    jstate = jax_init_state(jcfg, jmodel, jtx,
                            jnp.zeros((2, 32, 32, 3), jnp.float32))
    return jcfg, jstate, jax.jit(jax_make_train_step(jcfg, jmodel, jtx))


def _port_side(case: str, jstate):
    tcfg = tconfig.Config(**TINY, **CASES[case])
    model, _ = get_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(jstate.params))
    tx = make_optimizer(tcfg, N_TRAIN // tcfg.batch_size)
    state = loop.init_state(tcfg, model, tx)
    return tcfg, model, tx, state


def _data():
    rng = np.random.default_rng(7)
    return (rng.integers(0, 256, (N_TRAIN, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 10, N_TRAIN).astype(np.int32),
            rng.permutation(N_TRAIN).astype(np.int32))


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_ae_train_steps_match_jax(case, n_steps):
    jcfg, jstate, jstep = _jax_side(case)
    tcfg, model, tx, state = _port_side(case, jstate)
    step = make_train_step(tcfg, model, tx)
    x, y, perm = _data()
    jx, jy, jperm = (jnp.asarray(a) for a in (x, y, perm))
    for i in range(n_steps):
        img, label = _jax_batch(jcfg, jstate, x, y, perm, i)
        jstate, jm = jstep(jstate, jx, jy, jperm, i)
        state, tm = step.on_batch(state, img, label)
        assert set(tm) == set(jm)
        for name in jm:
            np.testing.assert_allclose(_np(tm[name]), _np(jm[name]),
                                       **F32_TOL, err_msg=f"{name}, step {i}")
    sd = model.state_dict()
    for name, p in state_dict_from_flax(jstate.params).items():
        np.testing.assert_allclose(_np(sd[name]), _np(p), **ADAM_PARAM_TOL,
                                   err_msg=name)
    # the main moments, on the flat vector on both sides
    unravel = ravel_pytree(jstate.params)[1]
    jadam = _adam_state(jstate.opt_state)
    assert int(state.opt_state["count"]) == int(jadam.count) == n_steps
    for k, f in (("mu", lambda a: a), ("nu", np.sqrt)):
        want = state_dict_from_flax(unravel(getattr(jadam, k)))
        got = _by_name(model, state.opt_state[k])
        for name, w in want.items():
            np.testing.assert_allclose(f(_np(got[name])), f(_np(w)),
                                       **F32_TOL, err_msg=f"{k} {name}")
    # the AE-internal optimizer's state
    if jstate.ae_opt_state is None:
        assert state.ae_opt_state is None
        return
    jae = _adam_state(jstate.ae_opt_state)
    assert int(state.ae_opt_state["count"]) == int(jae.count) == \
        n_steps * tcfg.unsupervised_steps
    for k, f in (("mu", lambda a: a), ("nu", np.sqrt)):
        want = state_dict_from_flax({layer: {"mixer": {"AE": tree}}
                                     for layer, tree in
                                     getattr(jae, k).items()})
        got = _by_name(model, state.ae_opt_state[k], is_ae_param)
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(f(_np(got[name])), f(_np(w)),
                                       **F32_TOL, err_msg=f"ae {k} {name}")


@pytest.mark.parametrize("ae_type", ["simple", "heads"])
def test_under_ce_the_main_update_leaves_the_ae_where_the_inner_loop_put_it(
        ae_type):
    """The inner loop run alone on the same forward's inputs gives the AE
    entries the step ends with, bit for bit; the main moments stay zero
    there, and norm1 (no gradient path but for heads without --chunk)
    keeps its value."""
    cfg = tconfig.Config(**dict(TINY, ae_type=ae_type, unsupervised_steps=2))
    model, _ = get_model(cfg, device="cpu")
    tx = make_optimizer(cfg, 4)
    state = loop.init_state(cfg, model, tx)
    step = make_train_step(cfg, model, tx)
    x, y, perm = (torch.from_numpy(a) for a in _data())
    img, label = step.make_batch(state, x, y, perm, 0)[:2]
    before = state.params.clone()
    ae_state = {k: v.clone() for k, v in state.ae_opt_state.items()}
    # the inner loop alone, after the same forward
    model(img, deterministic=False, generator=state.generator)
    make_unsupervised_update(cfg, model)[1](state)
    alone = state.params.clone()
    state.params.copy_(before)
    state.ae_opt_state = ae_state
    state, _ = step.on_batch(state, img, label)
    ae = torch.cat([torch.full((p.numel(),), is_ae_param(n))
                    for n, p in model.named_parameters()])
    norm1 = torch.cat([torch.full((p.numel(),), ".norm1." in n)
                       for n, p in model.named_parameters()])
    assert not torch.equal(alone[ae], before[ae])  # the inner loop moved it
    assert torch.equal(state.params[ae], alone[ae])
    for k in ("mu", "nu"):
        assert not torch.any(state.opt_state[k][ae]), k
    if ae_type == "simple":
        assert torch.equal(state.params[norm1], before[norm1])
        assert not torch.any(state.opt_state["mu"][norm1])
    else:  # heads without --chunk: x itself is normalized by norm1
        assert torch.any(state.opt_state["mu"][norm1])
    assert torch.any(state.opt_state["mu"][~(ae | norm1)])


@pytest.mark.parametrize("ae_type", ["heads", "simple"])
def test_heads_inner_loop_skips_a_nonfinite_loss(ae_type):
    """The heads variant skips an update whose loss is nan/inf: AE entries,
    count and moments keep their values and the loss adds 0; the others
    apply it, as the reference does."""
    cfg = tconfig.Config(**dict(TINY, ae_type=ae_type, unsupervised_steps=1))
    model, _ = get_model(cfg, device="cpu")
    state = loop.init_state(cfg, model, make_optimizer(cfg, 4))
    init, run = make_unsupervised_update(cfg, model)
    model(torch.zeros(2, 32, 32, 3))
    run(state)  # one applied step first
    mixer = model.enc0.mixer
    mixer.ae_input = mixer.ae_input.clone()
    mixer.ae_input.view(-1)[0] = float("nan")
    params = state.params.clone()
    ae_state = {k: v.clone() for k, v in state.ae_opt_state.items()}
    loss = run(state)
    if ae_type == "heads":
        assert float(loss) == 0.0
        assert torch.equal(state.params, params)
        for k, v in ae_state.items():
            assert torch.equal(state.ae_opt_state[k], v), k
        assert int(state.ae_opt_state["count"]) == 1
    else:
        assert not torch.isfinite(loss)
        assert int(state.ae_opt_state["count"]) == 2
        assert not torch.isfinite(state.params).all()


def test_aece_criterion_matches_jax():
    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(8, 10))).astype(np.float32)
    labels = rng.integers(0, 10, 8).astype(np.int32)
    terms = [tuple(rng.normal(size=s).astype(np.float32) for s in
                   ((8, 17, 5), (8, 17, 12), (8, 17, 12)))
             for _ in range(2)]
    for l1, outputs in ((0.0, False), (0.1, True)):
        kw = dict(criterion="aece", aece_l1_regularization=l1,
                  aece_l1_outputs=outputs)
        want = jlosses.make_criterion(jconfig.Config(**kw))(
            jnp.asarray(logits), jnp.asarray(labels),
            {"ae": [tuple(jnp.asarray(a) for a in t) for t in terms]})
        got = tlosses.make_criterion(tconfig.Config(**kw))(
            torch.from_numpy(logits), torch.from_numpy(labels),
            {"ae": [tuple(torch.from_numpy(a) for a in t) for t in terms]})
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
        # eval falls back to plain CE
        np.testing.assert_allclose(
            _np(tlosses.make_per_example_loss(tconfig.Config(**kw))(
                torch.from_numpy(logits), torch.from_numpy(labels))),
            _np(jlosses.make_per_example_loss(jconfig.Config(**kw))(
                jnp.asarray(logits), jnp.asarray(labels))), **F32_TOL)
    with pytest.raises(ValueError, match="AE tensors"):
        tlosses.make_criterion(tconfig.Config(criterion="aece"))(
            torch.from_numpy(logits), torch.from_numpy(labels), {"ae": []})


def test_unsupervised_loss_has_its_metric_slot():
    cfg = tconfig.Config(**dict(TINY, unsupervised_steps=1))
    assert set(make_metrics_zeros(cfg, "cpu")) == {
        "loss", "acc", "skipped_nonfinite", "unsupervised_loss"}
    assert "unsupervised_loss" not in make_metrics_zeros(
        cfg.replace(model_name="ae_baseline"), "cpu")


# -- semi-supervised ---------------------------------------------------------

def _raw(per_class: int, n_test: int = 12) -> RawData:
    rng = np.random.default_rng(1)
    n = 10 * per_class
    y = rng.permutation(np.tile(np.arange(10, dtype=np.int32), per_class))
    return RawData(rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8), y,
                   rng.integers(0, 256, (n_test, 32, 32, 3), dtype=np.uint8),
                   rng.integers(0, 10, n_test).astype(np.int32), 10,
                   synthetic=True)


@pytest.mark.parametrize("quota", [(500, 400), (3, 2)])
def test_semi_supervised_split_equals_jax(quota):
    raw = _raw(8 if quota == (3, 2) else 95)
    got = semi_supervised_split(raw, *quota)
    want = jax_semi_supervised_split(raw, *quota)
    assert set(got) == set(want)
    for k in want:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert np.all(got["unlabeled"][1] == -1)


def _train_cfg(tmp_path, name="run", **kw):
    return tconfig.Config(**{**TINY, "max_epochs": 2,
                             "matmul_precision": "highest",
                             "synthetic_data": True, **kw},
                          log_dir=str(tmp_path / "logs"),
                          ckpt_dir=str(tmp_path / name))


def test_semi_supervised_train_paces_the_epoch(tmp_path, monkeypatch):
    """The labeled split (2 a class here) repeats |unlabeled| // |labeled|
    = 3 times an epoch, and the schedule counts those steps."""
    monkeypatch.setattr(loop, "load_dataset", lambda *a, **k: _raw(11))
    monkeypatch.setattr(loop, "semi_supervised_split", functools.partial(
        semi_supervised_split, n_valid=3, n_labeled=2))
    cfg = _train_cfg(tmp_path, semi_supervised=True, warmup_epoch=1)
    res = loop.train(cfg, verbose=False, device="cpu")
    payload, _ = load_checkpoint(res["ckpt_dir"], prefer="last")
    # 20 labeled images, batch 4: 5 steps a pass, 3 passes an epoch
    assert payload["step"] == int(payload["opt_state"]["count"]) == 2 * 15
    np.testing.assert_allclose([row["lr_0"] for row in res["history"]],
                               [0.0, cfg.lr], rtol=1e-6)
    flat = cfg.replace(ss_combined_epoch=False, ckpt_dir=str(tmp_path / "b"))
    payload, _ = load_checkpoint(loop.train(flat, verbose=False,
                                            device="cpu")["ckpt_dir"],
                                 prefer="last")
    assert payload["step"] == 2 * 5
    with pytest.raises(NotImplementedError, match="semi-supervised"):
        loop.train(cfg.replace(dataset="c100"), verbose=False, device="cpu")


def test_resume_of_an_unsupervised_run_is_bit_for_bit(tmp_path, monkeypatch):
    monkeypatch.setattr(loop, "load_dataset", lambda *a, **k: _raw(2))
    kw = dict(ae_type="heads", unsupervised_steps=1, max_epochs=3)
    res_a = loop.train(_train_cfg(tmp_path, "a", **kw), verbose=False,
                       device="cpu")
    res_b1 = loop.train(_train_cfg(tmp_path, "b1", **kw), verbose=False,
                        device="cpu", stop_after=1)
    res_b2 = loop.train(_train_cfg(tmp_path, "b2", resume=res_b1["ckpt_dir"],
                                   **kw), verbose=False, device="cpu")
    assert len(res_b2["history"]) == 2
    pa, _ = load_checkpoint(res_a["ckpt_dir"], prefer="last")
    pb, _ = load_checkpoint(res_b2["ckpt_dir"], prefer="last")
    assert pa["step"] == pb["step"] == 3 * 5
    for name in pa["params"]:
        assert torch.equal(pa["params"][name], pb["params"][name]), name
    for key in ("opt_state", "ae_opt_state"):
        for k in ("count", "mu", "nu"):
            assert torch.equal(pa[key][k], pb[key][k]), (key, k)
    assert int(pb["ae_opt_state"]["count"]) == 15
    assert torch.equal(pa["generator"], pb["generator"])
    for a, b in zip(res_a["history"][1:], res_b2["history"]):
        assert a == {**b, **{k: a[k] for k in ("epoch_time", "eval_time",
                                               "images_per_sec")}}
        assert a["unsupervised_loss"] > 0


def test_cli_with_no_model_name_trains_the_default_aevit(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    monkeypatch.setattr(loop, "load_dataset", lambda *a, **k: _raw(2))
    res = cli.main(["--dry-run", "--device", "cpu", "--precision", "32",
                    "--batch-size", "8", "--eval-batch-size", "8",
                    "--log-dir", str(tmp_path / "logs"),
                    "--ckpt-dir", str(tmp_path / "models")])
    assert res["experiment"].startswith("ae_c10_1l_")
    assert len(res["history"]) == 1 and np.isfinite(res["val_loss"])
    assert np.isfinite(res["history"][0]["loss"])
    payload, cfg = load_checkpoint(res["ckpt_dir"], prefer="last")
    assert cfg == dataclasses.replace(tconfig.Config(), **{
        "dry_run": True, "precision": "32", "batch_size": 8,
        "eval_batch_size": 8, "log_dir": str(tmp_path / "logs"),
        "ckpt_dir": str(tmp_path / "models")})
    assert cfg.model_name == "ae" and cfg.num_layers == 1
    assert "enc0.mixer.AE.encoder.fc.weight" in payload["params"]
    assert os.path.exists(os.path.join(res["ckpt_dir"], "last", "state.pt"))
    assert "Finished 'ae_c10_1l_" in capsys.readouterr().out
