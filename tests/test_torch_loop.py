"""The port's training loop (``vit_cifar_torch/train/loop.py``), its
checkpoints, logging, observability and CLI, on the CPU, with a 2-layer ViT
on a small uint8 dataset (``load_dataset`` is replaced, as the JAX
package's loop tests do).

* The loop against a hand loop over ``make_train_step``/``make_eval_step``
  with the same generator: bit for bit (the same f32 operations in the
  same order).  ``matmul_precision="highest"``, so that the loop and the
  hand loop run the same f32 matmuls.
* Resume against a straight run: bit for bit on params, moments, count,
  generator state and history.
* ``lr_0`` against the JAX schedule: rtol 1e-6 (``cos`` in f32 on both
  sides, a few ulps).
* The train step with AutoAugment, RandomCropPaste and a pre-augmented
  dataset against the JAX step, on the JAX batch handed to ``on_batch``:
  loss and parameters after two Adam steps within the limits of
  ``tests/test_torch_train.py`` (f32 sums in another order; Adam's first
  steps move a parameter by nearly lr whatever the size of its gradient).
  With AutoAugment in the step, JAX's compiled blends round some ties one
  level apart (``tests/test_torch_autoaugment.py``), which can turn a
  near-zero gradient's sign and move one parameter by 2 lr; the step's
  augmentation order is held against the port's own draws instead.
* ``config_from_args`` against the JAX parser for every option: equal.
"""

import dataclasses
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_cifar_torch.config as tconfig
import vit_cifar_tpu.config as jconfig
from vit_cifar_torch import cli
from vit_cifar_torch.data import augment as taug
from vit_cifar_torch.data.autoaugment import apply_autoaugment, \
    autoaugment_draws
from vit_cifar_torch.data.datasets import RawData
from vit_cifar_torch.deploy import export_inference
from vit_cifar_torch.models import get_model
from vit_cifar_torch.train import loop
from vit_cifar_torch.train.checkpoint import BestCheckpointer, load_checkpoint
from vit_cifar_torch.train.losses import make_criterion
from vit_cifar_torch.train.optim import make_optimizer
from vit_cifar_torch.train.steps import (make_eval_step, make_metrics_zeros,
                                         make_train_step)
from vit_cifar_torch.utils import logging as tlogging
from vit_cifar_torch.utils import observability as obs
from vit_cifar_torch.utils.transplant import state_dict_from_flax
from vit_cifar_tpu.data import augment as jaug
from vit_cifar_tpu.models import get_model as jax_get_model
from vit_cifar_tpu.train.loop import init_state as jax_init_state
from vit_cifar_tpu.train.optim import make_optimizer as jax_make_optimizer
from vit_cifar_tpu.train.optim import \
    warmup_cosine_epoch_schedule as jax_schedule
from vit_cifar_tpu.train.steps import make_train_step as jax_make_train_step
from vit_cifar_tpu.utils import logging as jlogging
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = dict(rtol=1e-6, atol=1e-7)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
ADAM_PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
TINY = dict(model_name="vit", num_layers=2, hidden=32, mlp_hidden=32, head=4,
            batch_size=8, eval_batch_size=8, label_smoothing=True,
            warmup_epoch=0, precision="32", matmul_precision="highest",
            max_epochs=3, autoaugment=True, synthetic_data=True)
N_TRAIN, N_TEST = 48, 20  # 6 steps an epoch, 3 eval batches (one padded)
HISTORY_KEYS = ("loss", "acc", "val_loss", "val_acc", "lr_0",
                "skipped_nonfinite")


@pytest.fixture
def raw(monkeypatch):
    rng = np.random.default_rng(0)
    data = RawData(
        rng.integers(0, 256, (N_TRAIN, 32, 32, 3), dtype=np.uint8),
        rng.integers(0, 10, N_TRAIN).astype(np.int32),
        rng.integers(0, 256, (N_TEST, 32, 32, 3), dtype=np.uint8),
        rng.integers(0, 10, N_TEST).astype(np.int32), 10, synthetic=True)
    monkeypatch.setattr(loop, "load_dataset", lambda *a, **k: data)
    return data


def _cfg(tmp_path, name="run", **kw):
    return tconfig.Config(**{**TINY, **kw}, log_dir=str(tmp_path / "logs"),
                          ckpt_dir=str(tmp_path / name))


def _train(cfg, **kw):
    return loop.train(cfg, verbose=False, device="cpu", **kw)


def _hand_loop(cfg, raw):
    """What the loop computes, written out over the step functions."""
    model, _ = get_model(cfg, device="cpu")
    spe = N_TRAIN // cfg.batch_size
    tx = make_optimizer(cfg, spe)
    state = loop.init_state(cfg, model, tx)
    state.metrics_acc = make_metrics_zeros(cfg, "cpu")
    step = make_train_step(cfg, model, tx, pre_augmented=cfg.preaugment_epoch)
    evaluate = make_eval_step(cfg, model)
    x, y = torch.from_numpy(raw.x_train), torch.from_numpy(raw.y_train)
    xt, yt, mask, n_eval = loop._pad_eval(raw.x_test, raw.y_test, 8)
    xt, yt, mask = (torch.from_numpy(a) for a in (xt, yt, mask))
    rows = []
    for epoch in range(cfg.max_epochs):
        perm = torch.randperm(N_TRAIN, generator=state.generator)
        xe = taug.augment_dataset(state.generator, x, 4,
                                  autoaugment_policy="cifar10") \
            if cfg.preaugment_epoch else x
        for i in range(spe):
            state, _ = step(state, xe, y, perm, i)
        row = {k: v.item() / spe for k, v in state.metrics_acc.items()}
        state.metrics_acc = make_metrics_zeros(cfg, "cpu")
        sums = torch.zeros(3)
        for b in range(n_eval):
            out = evaluate(xt[8 * b:8 * b + 8], yt[8 * b:8 * b + 8],
                           mask[8 * b:8 * b + 8])
            sums += torch.stack([out["loss_sum"], out["correct_sum"],
                                 out["count"]])
        loss_sum, correct, count = sums.tolist()
        rows.append(dict(row, val_loss=loss_sum / count,
                         val_acc=correct / count))
    return rows, state


@pytest.mark.parametrize("kw", [dict(), dict(preaugment_epoch=True),
                                dict(rcpaste=True, warmup_epoch=1)],
                         ids=["in_step_aa", "preaugment", "rcpaste"])
def test_history_equals_a_hand_loop(tmp_path, raw, kw):
    cfg = _cfg(tmp_path, **kw)
    res = _train(cfg)
    want, state = _hand_loop(cfg, raw)
    assert len(res["history"]) == cfg.max_epochs
    for epoch, (got, w) in enumerate(zip(res["history"], want)):
        for k in ("loss", "acc", "val_loss", "val_acc", "skipped_nonfinite"):
            assert got[k] == w[k], (epoch, k, got[k], w[k])
    payload, _ = load_checkpoint(res["ckpt_dir"], prefer="last")
    assert payload["step"] == state.step == 3 * 6
    assert torch.equal(torch.cat([p.reshape(-1) for p in
                                  payload["params"].values()]), state.params)
    assert torch.equal(payload["generator"], state.generator.get_state())
    assert res["val_loss"] == want[-1]["val_loss"]
    assert res["n_params"] == state.params.numel()


def test_lr_column_follows_the_jax_schedule(tmp_path, raw):
    cfg = _cfg(tmp_path, warmup_epoch=1, autoaugment=False)
    res = _train(cfg)
    sched = jax_schedule(cfg.lr, cfg.min_lr, 1, cfg.max_epochs, 6)
    got = [row["lr_0"] for row in res["history"]]
    want = [float(sched(e * 6 + 1)) for e in range(cfg.max_epochs)]
    np.testing.assert_allclose(got, want, **EXACT)
    # warmup from 0; epochs W and W+1 both at the base lr (reference quirk)
    assert got[0] == 0.0 and got[1] == got[2]


def test_resume_continues_bit_for_bit(tmp_path, raw):
    res_a = _train(_cfg(tmp_path, "a"))
    res_b1 = _train(_cfg(tmp_path, "b1"), stop_after=2)
    assert len(res_b1["history"]) == 2
    res_b2 = _train(_cfg(tmp_path, "b2", resume=res_b1["ckpt_dir"]))
    assert len(res_b2["history"]) == 1  # epoch 2 only
    pa, _ = load_checkpoint(res_a["ckpt_dir"], prefer="last")
    pb, _ = load_checkpoint(res_b2["ckpt_dir"], prefer="last")
    assert pa["step"] == pb["step"] == 18 and pa["epoch"] == pb["epoch"] == 2
    for name in pa["params"]:
        assert torch.equal(pa["params"][name], pb["params"][name]), name
    for k in ("count", "mu", "nu"):
        assert torch.equal(pa["opt_state"][k], pb["opt_state"][k]), k
    assert int(pb["opt_state"]["count"]) == 18
    assert torch.equal(pa["generator"], pb["generator"])
    for k in HISTORY_KEYS:
        assert res_a["history"][2][k] == res_b2["history"][0][k], k
    # the best val_loss carries over (Lightning restores best_model_score)
    assert res_b2["best_val_loss"] == res_a["best_val_loss"]


def test_resume_of_a_finished_run_evaluates(tmp_path, raw):
    res = _train(_cfg(tmp_path, "a", max_epochs=1))
    res2 = _train(_cfg(tmp_path, "b", max_epochs=1, resume=res["ckpt_dir"]))
    assert len(res2["history"]) == 1
    assert res2["val_loss"] == res["val_loss"]
    assert res2["val_acc"] == res["val_acc"]
    assert np.isnan(res2["history"][0]["loss"])


def test_nan_parameters_stop_training_before_the_histograms(tmp_path, raw):
    cfg = _cfg(tmp_path, lr=1e25, nonfinite_guard=False, max_epochs=1,
               autoaugment=False)
    with pytest.raises(ValueError, match="NaN parameter"):
        _train(cfg)
    assert not glob.glob(str(tmp_path / "logs" / "**" / "*.npz"),
                         recursive=True)


def test_checkpoints_hold_the_full_state_and_serve(tmp_path, raw):
    res = _train(_cfg(tmp_path, max_epochs=2))
    root = res["ckpt_dir"]
    for name in ("best/state.pt", "last/state.pt", "best.json",
                 "config.json"):
        assert os.path.exists(os.path.join(root, name)), name
    payload, cfg = load_checkpoint(root, prefer="last")
    assert cfg == _cfg(tmp_path, max_epochs=2)
    assert set(payload) == {"params", "opt_state", "step", "epoch",
                            "best_val_loss", "generator"}
    assert set(payload["opt_state"]) == {"count", "mu", "nu"}
    assert payload["opt_state"]["mu"].abs().max() > 0
    assert payload["best_val_loss"] == res["best_val_loss"]
    # the weights are the model's state dict: the serving export takes them
    out = export_inference(root, str(tmp_path / "art"), device="cpu")
    assert os.path.exists(os.path.join(out, "serving.pt2"))
    ckpt = BestCheckpointer(str(tmp_path / "m2"), "exp", cfg)
    ckpt.seed_best_from(root)
    assert ckpt.best_val_loss == res["best_val_loss"]
    assert not ckpt.maybe_save_best(res["best_val_loss"] + 1.0, 0, payload)


def test_logs_histograms_and_gradients_without_changing_the_run(tmp_path,
                                                                 raw):
    plain = _train(_cfg(tmp_path, "a", autoaugment=False))
    cfg = _cfg(tmp_path, "b", autoaugment=False, log_gradients=True,
               log_gradients_interval=4)
    res = _train(cfg)
    for a, b in zip(plain["history"], res["history"]):
        for k in HISTORY_KEYS:
            assert a[k] == b[k], k
    names = sorted(os.listdir(os.path.join(res["log_dir"], "histograms")))
    assert [n for n in names if n.startswith("grads")] == [
        f"grads_e{e:04d}_s{s}.npz" for e, s in ((0, 0), (0, 4), (1, 8),
                                                (2, 12), (2, 16))]
    assert {n.split("_")[0] for n in names} == {"grads", "weights", "layer"}
    weights = np.load(os.path.join(res["log_dir"], "histograms",
                                   "weights_e0000_s0.npz"))
    assert weights["emb.weight__counts"].sum() == 32 * 48
    for f in ("metrics.csv", "model_summary.txt", "config.json"):
        assert os.path.exists(os.path.join(res["log_dir"], f)), f
    with open(os.path.join(res["log_dir"], "metrics.csv")) as f:
        header = f.readline().strip().split(",")
    assert header[:5] == ["step", "epoch", "time", "trainable_params",
                          "total_params"]
    assert set(HISTORY_KEYS) <= set(header)


def test_profile_dir_writes_a_trace(tmp_path, raw):
    prof = tmp_path / "prof"
    _train(_cfg(tmp_path, dry_run=True, profile_dir=str(prof)))
    assert os.path.getsize(prof / "trace.json") > 0


def test_matmul_precision_is_restored(tmp_path, raw):
    before = torch.get_float32_matmul_precision()
    seen = []
    real = loop._train

    def spy(*a):
        seen.append(torch.get_float32_matmul_precision())
        return real(*a)

    loop._train = spy
    try:
        _train(_cfg(tmp_path, dry_run=True, matmul_precision="medium"))
    finally:
        loop._train = real
    assert seen == ["medium"]
    assert torch.get_float32_matmul_precision() == before


@pytest.mark.parametrize("kw", [
    dict(mesh_shape=(2,)), dict(multihost=True),
    dict(mesh_shape=(2,), mesh_axes=("pipe",)),
    dict(mesh_shape=(1, 2), mesh_axes=("data", "seq"))],
    ids=["mesh_shape", "multihost", "pipe", "seq"])
def test_runs_without_a_model_in_the_port_raise(tmp_path, raw, kw, capsys):
    """A mesh of more devices than this process (no torchrun) raises,
    naming torchrun, over the pipe and seq axes as over data;
    ``--multihost`` with no cluster described trains as one process after
    JAX's warning."""
    if "multihost" in kw:
        res = _train(_cfg(tmp_path, dry_run=True, **kw))
        assert "continuing as a SINGLE process" in capsys.readouterr().out
        assert np.isfinite(res["val_loss"])
    else:
        with pytest.raises(ValueError, match="torchrun"):
            _train(_cfg(tmp_path, **kw))


# -- the CLI and its parser -------------------------------------------------

def _options():
    parser = jconfig.build_parser()
    return [a for a in parser._actions if a.option_strings
            and a.dest != "help"]


def _argv(action):
    """Arguments that set ``action`` to a value other than its default."""
    flag = action.option_strings[0]
    if action.nargs == 0:
        return [flag]
    special = {"mesh_shape": "2,1", "mesh_axes": "data,model",
               "precision": "32", "comet_api_key": "key"}
    if action.dest in special:
        return [flag, special[action.dest]]
    if action.choices:
        return [flag, next(c for c in action.choices if c != action.default)]
    if action.type is int:
        return [flag, str(action.default + 3)]
    if action.type is float:
        return [flag, repr(action.default * 2 + 0.25)]
    return [flag, f"{action.default}x"]


@pytest.mark.parametrize("action", _options(),
                         ids=lambda a: a.option_strings[0])
def test_config_from_args_matches_jax_for_every_option(action):
    argv = _argv(action)
    want = dataclasses.asdict(jconfig.config_from_args(argv))
    got = dataclasses.asdict(tconfig.config_from_args(argv))
    assert got == want
    assert got != dataclasses.asdict(tconfig.Config()) or action.dest in (
        "pin_memory",)  # the host loader's flag, in no Config


def test_parsers_have_the_same_options_and_defaults():
    def options(p):
        return sorted(s for a in p._actions for s in a.option_strings)

    assert options(tconfig.build_parser()) == options(jconfig.build_parser())
    assert tconfig.config_from_args([]) == tconfig.Config()
    assert dataclasses.asdict(tconfig.config_from_args([])) == \
        dataclasses.asdict(jconfig.config_from_args([]))


def test_cli_dry_run_on_the_cpu(tmp_path, raw, capsys):
    res = cli.main(["--model-name", "vit", "--num-layers", "2", "--hidden",
                    "32", "--mlp-hidden", "32", "--head", "4",
                    "--label-smoothing", "--autoaugment", "--dry-run",
                    "--precision", "32", "--batch-size", "8",
                    "--eval-batch-size", "8", "--device", "cpu",
                    "--log-dir", str(tmp_path / "logs"),
                    "--ckpt-dir", str(tmp_path / "models")])
    assert len(res["history"]) == 1 and np.isfinite(res["val_loss"])
    assert res["experiment"].startswith("vit_c10_2l_aa_ls_")
    assert "Finished 'vit_c10_2l_aa_ls_" in capsys.readouterr().out
    assert os.path.exists(os.path.join(res["ckpt_dir"], "last", "state.pt"))


def test_module_entry_point_is_the_cli():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "vit_cifar_torch", "--help"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--autoaugment" in res.stdout and "--device" in res.stdout


# -- the train step with the whole augmentation chain, against JAX ----------

STEP = dict(TINY, max_epochs=100, autoaugment=True, rcpaste=True)


def test_train_step_with_augmentation_matches_jax():
    """``autoaugment``, ``rcpaste`` and a pre-augmented dataset: the step
    normalizes and crop-pastes the gathered batch (AutoAugment ran in the
    dataset pass).  The JAX batch, drawn from the JAX step's keys, is
    handed to ``on_batch``."""
    jcfg = jconfig.Config(**STEP)
    jmodel, _ = jax_get_model(jcfg)
    jtx = jax_make_optimizer(jcfg, 4)
    jstate = jax_init_state(jcfg, jmodel, jtx,
                            jnp.zeros((2, 32, 32, 3), jnp.float32))
    jstep = jax.jit(jax_make_train_step(jcfg, jmodel, jtx,
                                        pre_augmented=True))
    tcfg = tconfig.Config(**STEP)
    tmodel, _ = get_model(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(jstate.params))
    ttx = make_optimizer(tcfg, 4)
    tstate = loop.init_state(tcfg, tmodel, ttx)
    tstep = make_train_step(tcfg, tmodel, ttx, pre_augmented=True)
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (32, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, 32).astype(np.int32)
    perm = rng.permutation(32).astype(np.int32)
    for i in range(2):
        idx = perm[8 * i:8 * i + 8]
        key = jax.random.fold_in(jstate.rng, jstate.step)
        k_rcp = jax.random.split(key, 6)[4]
        img = jaug.random_crop_paste(k_rcp, jaug.normalize(
            jnp.asarray(x[idx]), jcfg.mean, jcfg.std))
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(perm), i)
        tstate, tm = tstep.on_batch(tstate, torch.from_numpy(
            np.array(img, np.float32)), torch.from_numpy(y[idx]))
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                                   **F32_TOL)
    for name, p in state_dict_from_flax(jstate.params).items():
        np.testing.assert_allclose(tmodel.state_dict()[name].numpy(),
                                   np.asarray(p), **ADAM_PARAM_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("pre_augmented", [False, True],
                         ids=["in_step", "pre_augmented"])
def test_make_batch_augments_in_the_reference_order(pre_augmented):
    """crop/flip -> AutoAugment -> normalize -> RandomCropPaste, from one
    generator in that order; a pre-augmented step skips the first two."""
    cfg = tconfig.Config(**STEP)
    model, _ = get_model(cfg, device="cpu")
    tx = make_optimizer(cfg, 4)
    state = loop.init_state(cfg, model, tx)
    step = make_train_step(cfg, model, tx, pre_augmented=pre_augmented)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(0, 256, (16, 32, 32, 3), np.uint8))
    y = torch.from_numpy(rng.integers(0, 10, 16).astype(np.int32))
    perm = torch.randperm(16, generator=torch.Generator().manual_seed(0))
    start = state.generator.get_state()
    img, label, rand_label, lam = step.make_batch(state, x, y, perm, 1)
    gen = torch.Generator().manual_seed(0)
    gen.set_state(start)
    want = x[perm[8:16]]
    if not pre_augmented:
        want = taug.apply_crop_flip(want, 4, *taug.crop_flip_draws(gen, 8, 4))
        want = apply_autoaugment(want, *autoaugment_draws(gen, 8, "cifar10"),
                                 "cifar10")
    want = taug.apply_crop_paste(taug.normalize(want, cfg.mean, cfg.std),
                                 *taug.crop_paste_draws(gen, 8, 32))
    assert torch.equal(img, want)
    assert torch.equal(label, y[perm[8:16]])
    assert rand_label is None and lam is None
    assert torch.equal(state.generator.get_state(), gen.get_state())


# -- remat -------------------------------------------------------------------

def test_remat_recomputes_blocks_with_the_same_dropout():
    cfg = tconfig.Config(**dict(TINY, dropout=0.1))
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, 32, 32, 3)).astype(np.float32))
    label = torch.tensor([1, 2, 3, 4])
    crit = make_criterion(cfg)
    out = []
    for remat in (False, True):
        model, _ = get_model(cfg.replace(remat=remat), device="cpu")
        gen = torch.Generator().manual_seed(9)
        loss = crit(model(x, deterministic=False, generator=gen), label)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out.append((loss, grads, gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = out
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- observability and logging ---------------------------------------------

def test_model_summary_and_layer_outputs():
    cfg = tconfig.Config(**TINY)
    model, _ = get_model(cfg, device="cpu")
    s = obs.model_summary(model.named_parameters())
    assert f"{loop.count_params(model):,}" in s.splitlines()[-1]
    assert "enc0/mixer/Wq/weight" in s
    s1 = obs.model_summary(model.named_parameters(), depth=1)
    assert "enc0 " in s1 and "enc0/mixer" not in s1
    outs = obs.get_layer_outputs(model, torch.zeros(2, 32, 32, 3))
    assert outs["enc1"].shape == (2, 65, 32) and outs["fc"].shape == (2, 10)
    assert "enc0.mixer" in outs
    assert not any(m._forward_hooks for m in model.modules())


def test_histograms_match_numpy():
    v = torch.from_numpy(np.random.default_rng(6).normal(size=1000)
                         .astype(np.float32))
    hists = obs.compute_histograms({"v": v, "flat": torch.ones(7)}, bins=16)
    counts, edges = hists["v"]
    want_counts, want_edges = np.histogram(v.numpy(), bins=16)
    np.testing.assert_allclose(edges, want_edges, rtol=1e-6, atol=1e-6)
    assert counts.sum() == 1000
    assert np.abs(counts - want_counts).max() <= 1  # a value on an edge
    np.testing.assert_array_equal(hists["flat"][0],
                                  np.histogram(np.ones(7), bins=16)[0])


@pytest.mark.parametrize("kw", [dict(), dict(autoaugment=True,
                                             label_smoothing=True),
                                dict(query=False, use_encoder_mlp=False,
                                     rcpaste=True, cutmix=True, mixup=True,
                                     is_cls_token=False)],
                         ids=["plain", "recipe", "every_flag"])
def test_experiment_names_and_tags_match_jax(kw):
    tcfg, jcfg = tconfig.Config(**kw), jconfig.Config(**kw)
    got, want = tlogging.get_experiment_name(tcfg), \
        jlogging.get_experiment_name(jcfg)
    # the last two parts are a random string and the time
    assert got.split("_")[:-2] == want.split("_")[:-2]
    assert tlogging.get_experiment_tags(tcfg) == \
        jlogging.get_experiment_tags(jcfg)


def test_comet_logger_is_taken_only_with_a_key(tmp_path, monkeypatch):
    cfg = tconfig.Config(log_dir=str(tmp_path))
    assert type(tlogging.make_logger(cfg, "a")) is tlogging.CSVLogger
    monkeypatch.setitem(sys.modules, "comet_ml", None)  # not installed
    logger = tlogging.make_logger(cfg.replace(comet_api_key="k"), "b")
    assert isinstance(logger, tlogging.CometLogger) and logger.comet is None
    logger.log(1, 0, loss=0.5)
    logger.finalize()
    assert os.path.exists(os.path.join(str(tmp_path), "b", "metrics.csv"))
