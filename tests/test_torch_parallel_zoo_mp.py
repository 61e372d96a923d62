"""The parallel port over the zoo, on the CPU with gloo: the 4-rank meshes
against JAX, BatchNorm's global statistics, the gMLP family's split of U,
the AEViT's unsupervised steps, the mixers that couple a batch's rows, and
one step of every model on (2,) and of every trunk model on (1,2).

The harness and the tolerances are those of
``tests/test_torch_parallel_mp.py``.  BatchNorm is held against JAX's
global statistics (GSPMD takes them over the sharded batch) with a forward
of JAX's model on the batch sharded over 2 devices: the port takes one
step at lr 0, so its weights stay the init and its running statistics and
its eval by them are JAX's, within ``F32_TOL``.  lgcnn's BatchNorm is
shared with a cls token that is the same for every image at layer 0 (the
reference's design): its zero variance turns the order of a sum into
visible noise, so that model is held to the statistics and the eval only.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
import vit_cifar_tpu.config as jconfig
from test_torch_parallel_mp import (BASE, STEPS, assert_same_run, case,
                                    check_mesh_case, jax_cases,
                                    run_reference, write_data)
from test_torch_train import F32_TOL
from vit_cifar_torch.config import MODEL_NAMES
from vit_cifar_torch.models import CNN_MODELS
from vit_cifar_torch.utils.transplant import state_dict_from_flax
from vit_cifar_tpu.data import augment as jaug
from vit_cifar_tpu.models import get_model as jax_get_model
from vit_cifar_tpu.parallel.mesh import batch_sharding
from vit_cifar_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vit_cifar_tpu.train import losses as jlosses
from vit_cifar_tpu.train.loop import _pad_eval as jax_pad_eval
from vit_cifar_tpu.train.loop import init_state as jax_init_state
from vit_cifar_tpu.train.optim import make_optimizer as jax_make_optimizer
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

DM = ((1, 2), ("data", "model"))
BN_MODELS = {
    "lgcnn": dict(model_name="lgcnn", cnn_normalization="batch_norm"),
    "burger": dict(model_name="hamburger", train_md_bases=True),
}
# one small config every model builds with (wlgcnn needs hidden = ffn /
# 2), for the cases held against the one-process port
MATRIX = dict(num_layers=1, hidden=32, mlp_hidden=64, ffn_features=64,
              head=4, batch_size=8)
TRUNK = [m for m in MODEL_NAMES if m not in CNN_MODELS]
GATED = ["gmlp", "wgmlp", "linear", "gnnmf_sbs"]
# mixers whose batch rows meet: AFT-Full's max over the batch axis, the
# burger's random bases, the AE's random fill scaled by the batch's mean
# and deviation, and the NNMF backward's max and count over the batch
COUPLED = {
    "aftfull": dict(model_name="aftfull"),
    "hamburger_random_bases": dict(model_name="hamburger"),
    "ae_random_mask": dict(model_name="ae", mask_type="random"),
    "gnnmf_sbs_data": dict(model_name="gnnmf_sbs"),
}


def jax_bn_reference(name: str, tmp: str) -> dict:
    """JAX's training forward of ``BN_MODELS[name]`` on the global batch
    sharded over 2 devices (its running statistics after it), and its eval
    sums by those statistics over the padded eval set; writes the init and
    the batch for the port."""
    kw = dict(BASE, **BN_MODELS[name], lr=0.0, min_lr=0.0)
    jcfg = jconfig.Config(**kw)
    mesh = jax_make_mesh((2,), ("data",))
    jmodel, _ = jax_get_model(jcfg)
    jstate = jax_init_state(jcfg, jmodel, jax_make_optimizer(jcfg, 1),
                            jnp.zeros((2, 32, 32, 3), jnp.float32))
    torch.save(state_dict_from_flax(
        jstate.params, jstate.model_state.get("state"),
        jstate.model_state.get("batch_stats")),
        os.path.join(tmp, f"bn_{name}_init.pt"))
    rng = np.random.default_rng(3)
    img = rng.normal(size=(1, jcfg.batch_size, 32, 32, 3)).astype(np.float32)
    label = rng.integers(0, 10, (1, jcfg.batch_size)).astype(np.int64)
    np.savez(os.path.join(tmp, f"bn_{name}_batches.npz"), img=img,
             label=label)
    variables = {"params": jstate.params, **jstate.model_state}
    key = jax.random.PRNGKey(0)
    shard = batch_sharding(mesh, 4)
    _, upd = jax.jit(lambda v, x: jmodel.apply(
        v, x, deterministic=False, mutable=list(jstate.model_state),
        rngs={"dropout": key, "mask": key}))(
        variables, jax.device_put(jnp.asarray(img[0]), shard))
    stats = state_dict_from_flax({}, upd.get("state"), upd.get("batch_stats"))
    e = np.load(os.path.join(tmp, "evalset.npz"))
    x, y, mask, steps = jax_pad_eval(e["x"], e["y"].astype(np.int32),
                                     jcfg.eval_batch_size)
    evaluate = jax.jit(lambda v, a: jmodel.apply(v, a, deterministic=True))
    per_example = jlosses.make_per_example_loss(jcfg)
    sums, eb = [], jcfg.eval_batch_size
    for b in range(steps):
        sl = slice(b * eb, (b + 1) * eb)
        a = jaug.normalize(jnp.asarray(x[sl]), jcfg.mean, jcfg.std)
        logits = evaluate({**variables, **upd}, jax.device_put(a, shard))
        m = np.asarray(mask[sl])
        sums.append([float(np.sum(per_example(logits, y[sl]) * m)),
                     float(np.sum((np.argmax(logits, -1) == y[sl]) * m)),
                     float(m.sum())])
    return {"stats": stats, "eval": sums}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parallel_zoo"))
    write_data(tmp)
    jax_out, world4 = jax_cases(["data2_model2", "data2_expert2"], tmp)
    bn = {name: jax_bn_reference(name, tmp) for name in BN_MODELS}
    cases = {f"bn_{name}": case(steps=1, lr=0.0, min_lr=0.0,
                                init=f"bn_{name}_init.pt",
                                batches=f"bn_{name}_batches.npz",
                                eval="evalset.npz", **kw)
             for name, kw in BN_MODELS.items()}
    cases["burger_steps"] = case(**BN_MODELS["burger"], **MATRIX)
    cases.update({f"{m}_split": case(*DM, model_name=m, **MATRIX)
                  for m in GATED})
    cases["ae_unsupervised"] = case(model_name="ae", criterion="aece",
                                    unsupervised_steps=2, **MATRIX)
    cases.update({name: case(**kw, **MATRIX) for name, kw in COUPLED.items()})
    cases.update({f"matrix_data_{m}": case(steps=1, model_name=m, **MATRIX)
                  for m in MODEL_NAMES})
    cases.update({f"matrix_data_model_{m}": case(*DM, steps=1, model_name=m,
                                                 **MATRIX) for m in TRUNK})
    W.spawn(W.run_cases, 4, tmp, cases=world4)
    W.spawn(W.run_cases, 2, tmp, cases=cases)
    return tmp, jax_out, {**world4, **cases}, bn


def _got(tmp: str, name: str) -> dict:
    return torch.load(os.path.join(tmp, f"{name}.pt"))


@pytest.mark.parametrize("name", ["data2_model2", "data2_expert2"])
def test_four_ranks_match_one_process_and_jax(runs, name):
    """(2,2) data x model, and (2,2) data x expert with --moe-experts 4
    (its moe_aux the global Switch statistic), on 4 ranks: 3 steps of a
    2-layer ViT against the port on one process and JAX on the same
    mesh."""
    tmp, jax_out, specs, _ = runs
    check_mesh_case(tmp, name, specs[name], jax_out[name])


@pytest.mark.parametrize("name", list(BN_MODELS))
def test_batchnorm_takes_the_global_statistics(runs, name):
    """lgcnn --cnn-normalization batch_norm and the hamburger burger on
    (2,): the running statistics after a training step are JAX's over the
    global batch, and so is the eval by them (masked sums, padded last
    batch); the burger's statistics and persistent bases agree with the
    one-process port too."""
    tmp, _, specs, bn = runs
    got = _got(tmp, f"bn_{name}")
    want = bn[name]
    assert set(got["model_state"]) == set(want["stats"])
    for k, w in want["stats"].items():
        np.testing.assert_allclose(got["model_state"][k].numpy(), w.numpy(),
                                   **F32_TOL, err_msg=k)
    np.testing.assert_allclose(got["eval"], want["eval"], **F32_TOL)
    one = W.run_case(dict(specs[f"bn_{name}"], cfg=dict(
        specs[f"bn_{name}"]["cfg"], mesh_shape=(), mesh_axes=("data",))),
        tmp, None)
    for k, w in one["model_state"].items():
        np.testing.assert_allclose(got["model_state"][k].numpy(), w.numpy(),
                                   **F32_TOL, err_msg=k)


def test_burger_steps_match_one_process(runs):
    """3 steps of the burger with persistent bases on (2,): parameters,
    moments, BatchNorm statistics and the bases' EMA over the global
    batch, against the one-process port."""
    tmp, _, specs, _ = runs
    assert_same_run(_got(tmp, "burger_steps"),
                    run_reference(specs["burger_steps"], tmp), STEPS,
                    label="burger")


@pytest.mark.parametrize("model", GATED)
def test_gated_mixers_split_u_by_halves(runs, model):
    """gmlp, wgmlp, linear and gnnmf_sbs on (1,2): U's output is chunked
    into (z1, z2), so each rank holds the matching slices of both halves;
    3 steps against the one-process port, whose checkpoint layout of U the
    gathered state has."""
    tmp, _, specs, _ = runs
    name = f"{model}_split"
    assert_same_run(_got(tmp, name), run_reference(specs[name], tmp), STEPS,
                    label=name)


def test_ae_unsupervised_steps_on_the_data_axis(runs):
    """The AEViT with aece and 2 unsupervised AE steps a batch on (2,):
    the inner steps' gradients and losses are the means over the data
    axis; 3 steps against the one-process port."""
    tmp, _, specs, _ = runs
    got = _got(tmp, "ae_unsupervised")
    assert got["history"][-1]["unsupervised_loss"] > 0
    assert_same_run(got, run_reference(specs["ae_unsupervised"], tmp), STEPS,
                    label="ae")


@pytest.mark.parametrize("name", list(COUPLED))
def test_batch_coupled_mixers_on_the_data_axis(runs, name):
    """Where a mixer couples the rows of a batch, the ranks take the global
    batch's statistic or draw: 3 steps on (2,) against the one-process
    port."""
    tmp, _, specs, _ = runs
    assert_same_run(_got(tmp, name), run_reference(specs[name], tmp), STEPS,
                    label=name)


@pytest.mark.parametrize("model", MODEL_NAMES)
def test_every_model_steps_on_the_data_axis(runs, model):
    tmp, _, _, _ = runs
    h = _got(tmp, f"matrix_data_{model}")["history"]
    assert np.isfinite(h[0]["loss"]) and h[0]["skipped_nonfinite"] == 0.0


@pytest.mark.parametrize("model", TRUNK)
def test_every_trunk_model_steps_on_the_model_axis(runs, model):
    tmp, _, _, _ = runs
    h = _got(tmp, f"matrix_data_model_{model}")["history"]
    assert np.isfinite(h[0]["loss"]) and h[0]["skipped_nonfinite"] == 0.0
