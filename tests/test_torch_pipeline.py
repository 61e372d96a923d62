"""GPipe of the port (``vit_cifar_torch/parallel/pipeline.py``) on the pipe
axis alone, on the CPU with gloo, against JAX's ``PipelineViT`` on the same
mesh and against the port on one process; the one-stage tick loop; the new
modules' imports.  The two-axis meshes, the padded eval, the stateful
routes and the checkpoint are in ``tests/test_torch_pipeline_mesh.py``.

The harness is ``tests/test_torch_parallel_mp.py``'s: ranks spawned by
``torch_parallel_worker.spawn`` (one spawn a world size, every case of the
file in it), JAX in this process on its 8-virtual-device CPU mesh, arrays
exchanged through files.  The weights are JAX's init transplanted; the
probe batch and the dataset are numpy draws from a seed; the CutMix draws
of JAX's step are handed to the port's ``on_batch``.  Tolerances:

* against JAX's ``PipelineViT`` on the same mesh, those of JAX's own
  ``tests/test_pipeline.py``: the eval forward rtol 1e-5 / atol 1e-6, the
  gradients rtol 1e-4 / atol 1e-6, the parameters and Adam's moments
  after two steps with CutMix and label smoothing rtol 1e-4 / atol 5e-5
  (its losses ``F32_TOL``);
* against the port on one process, ``tests/test_torch_parallel_mp.py``'s
  rtol 1e-5 / atol 2e-5 (``assert_same_run``; Adam's entries with a
  gradient within 1e-7 of zero held to 3 lr a step).
"""

from __future__ import annotations

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import torch_parallel_worker as W
import vit_cifar_tpu.config as jconfig
from test_torch_parallel_mp import (PORT_TOL, assert_same_run, by_name,
                                    run_reference)
from test_torch_train import F32_TOL
from vit_cifar_torch.utils.transplant import state_dict_from_flax
from vit_cifar_tpu.data import augment as jaug
from vit_cifar_tpu.models import get_model as jax_get_model
from vit_cifar_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vit_cifar_tpu.parallel.mesh import replicated_sharding
from vit_cifar_tpu.parallel.mesh import shard_params as jax_shard_params
from vit_cifar_tpu.parallel.pipeline import PipelineViT
from vit_cifar_tpu.parallel.sequence import seq_parallel_model
from vit_cifar_tpu.train import losses as jlosses
from vit_cifar_tpu.train.loop import init_state as jax_init_state
from vit_cifar_tpu.train.optim import make_optimizer as jax_make_optimizer
from vit_cifar_tpu.train.steps import _collect_moe_aux
from vit_cifar_tpu.train.steps import make_train_step as jax_make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(model_name="vit", num_layers=4, hidden=32, mlp_hidden=32,
            head=4, batch_size=16, eval_batch_size=8, label_smoothing=True,
            warmup_epoch=0, precision="32", dropout=0.0)
N_TRAIN = 48
STEPS = 2
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=5e-5)
# name -> (mesh shape, axes, microbatches)
# name -> (mesh shape, axes, microbatches, Config fields over BASE): the
# one-axis meshes, a block a stage (JAX compiles the unrolled ticks); the
# two-axis ones are in tests/test_torch_pipeline_mesh.py
MESHES = {
    "pipe2_m1": ((2,), ("pipe",), 1, dict(num_layers=2)),
    "pipe2_m2": ((2,), ("pipe",), 2, dict(num_layers=2)),
    "pipe4_m2": ((4,), ("pipe",), 2, {}),
}


def spec(shape, axes, steps=STEPS, **kw) -> dict:
    """A ``run_case`` spec on the mesh (shape, axes): ``kw`` are Config
    fields over ``BASE`` and the spec's own keys."""
    keys = ("init", "batches", "eval", "probe", "pad_stream")
    out = {k: kw.pop(k) for k in keys if k in kw}
    if "batches" not in out:
        out["data"] = "data.npz"
    return dict(out, steps=steps, cfg=dict(BASE, mesh_shape=shape,
                                           mesh_axes=axes, **kw))


def write_inputs(tmp: str) -> None:
    """The dataset, a probe batch and a padded eval set, from a seed."""
    rng = np.random.default_rng(0)
    np.savez(os.path.join(tmp, "data.npz"),
             x=rng.integers(0, 256, (N_TRAIN, 32, 32, 3), dtype=np.uint8),
             y=rng.integers(0, 10, N_TRAIN).astype(np.int64),
             perm=rng.permutation(N_TRAIN))
    np.savez(os.path.join(tmp, "probe.npz"),
             img=rng.normal(size=(16, 32, 32, 3)).astype(np.float32),
             label=rng.integers(0, 10, 16).astype(np.int64))
    # 13 images: the last eval batch of 8 is padded with 3 masked rows
    np.savez(os.path.join(tmp, "evalset.npz"),
             x=rng.integers(0, 256, (13, 32, 32, 3), dtype=np.uint8),
             y=rng.integers(0, 10, 13).astype(np.int64))


# -- the JAX side -------------------------------------------------------------

def _cutmix_batch(jcfg, jstate, x, y, perm, i):
    """The batch JAX's step draws at (state, i) with CutMix: its crop/flip
    and mix keys (``steps._make_batch_grads``)."""
    key = jax.random.fold_in(jstate.rng, jstate.step)
    k_crop, k_mix = jax.random.split(key, 6)[:2]
    idx = perm[i * jcfg.batch_size:(i + 1) * jcfg.batch_size]
    img = jaug.random_crop_flip(k_crop, jnp.asarray(x[idx]), jcfg.padding,
                                flip=True)
    img = jaug.normalize(img, jcfg.mean, jcfg.std)
    img, label, rand, lam = jaug.cutmix(k_mix, img, jnp.asarray(y[idx]),
                                        jcfg.img_size, beta=1.0)
    return {"img": np.asarray(img, np.float32),
            "label": np.asarray(label).astype(np.int64),
            "rand_label": np.asarray(rand).astype(np.int64),
            "lam": np.float32(lam)}


def jax_init(kw: dict):
    """(JAX's config over ``BASE`` + ``kw``, its model, optimizer and
    initial train state on one device): one init for every mesh of a
    config, as the parameters depend on the seed alone."""
    jcfg = jconfig.Config(**dict(BASE, **kw, pallas_kernel="einsum"))
    jmodel, _ = jax_get_model(jcfg)
    jtx = jax_make_optimizer(jcfg, N_TRAIN // jcfg.batch_size)
    jstate = jax_init_state(jcfg, jmodel, jtx,
                            jnp.zeros((2, 32, 32, 3), jnp.float32))
    return jcfg, jmodel, jtx, jstate


def jax_reference(name: str, init, shape, axes, mode: str, tmp: str,
                  microbatches: int = 0, steps: int = 0) -> dict:
    """JAX's model of ``init`` (``jax_init``) on the mesh (shape, axes),
    wrapped by ``mode`` ("pipe": ``PipelineViT``; "seq":
    ``seq_parallel_model``): its init (written as ``{name}_init.pt``), the
    logits, loss and gradients of a forward on the probe batch, and ``steps`` train steps of the pipeline with
    their batches (``{name}_batches.npz``), on the mesh with a data axis of
    1 in front where it has none (JAX's step cuts its batch over
    ``data``)."""
    jcfg, jmodel, jtx, jstate = init
    jcfg = jcfg.replace(mesh_shape=shape, mesh_axes=axes)

    def wrap(mesh):
        return (PipelineViT(jmodel, mesh, microbatches) if mode == "pipe"
                else seq_parallel_model(jmodel, mesh))

    mesh = jax_make_mesh(shape, axes)
    wrapped = wrap(mesh)
    torch.save(state_dict_from_flax(jstate.params),
               os.path.join(tmp, f"{name}_init.pt"))
    p = np.load(os.path.join(tmp, "probe.npz"))
    img, label = jnp.asarray(p["img"]), jnp.asarray(p["label"], jnp.int32)
    criterion = jlosses.make_criterion(jcfg)
    moe = jcfg.moe_experts > 0 and jcfg.moe_aux_weight > 0

    def loss_fn(params):
        """(loss, logits): with dropout 0 the training forward's logits
        are the eval forward's, so one compile serves both."""
        if not moe:
            logits = wrapped.apply({"params": params}, img,
                                   deterministic=False)
            return criterion(logits, label, {}), logits
        logits, upd = wrapped.apply({"params": params}, img,
                                    deterministic=False,
                                    mutable=["intermediates"])
        return criterion(logits, label, {}) + jcfg.moe_aux_weight * \
            _collect_moe_aux(upd["intermediates"]), logits

    assert jcfg.dropout == 0.0
    with mesh:
        (loss, logits), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(jstate.params)
    out = {"logits": np.asarray(logits), "loss": float(loss),
           "grads": state_dict_from_flax(jax.device_get(grads))}
    if not steps:
        return out
    if "data" not in axes:  # JAX's step cuts its batch over 'data'
        shape, axes = (1, *shape), ("data", *axes)
        jcfg = jcfg.replace(mesh_shape=shape, mesh_axes=axes)
        mesh = jax_make_mesh(shape, axes)
        wrapped = wrap(mesh)
    repl = replicated_sharding(mesh)
    jstate = jax.device_put(jstate, repl)
    if "model" in axes:
        jstate = jstate.replace(params=jax_shard_params(mesh, jstate.params))
    d = np.load(os.path.join(tmp, "data.npz"))
    x, y, perm = d["x"], d["y"].astype(np.int32), d["perm"].astype(np.int32)
    jx, jy, jperm = (jax.device_put(a, repl) for a in (x, y, perm))
    # the state leaves the step laid out as it entered: one compile
    layout = jax.tree_util.tree_map(lambda a: a.sharding, jstate)
    step = jax.jit(jax_make_train_step(jcfg, wrapped, jtx, mesh=mesh),
                   out_shardings=(layout, None))
    batches, history = [], []
    for i in range(steps):
        batches.append(_cutmix_batch(jcfg, jstate, x, y, perm, i))
        jstate, m = step(jstate, jx, jy, jperm, i)
        history.append({k: float(v) for k, v in m.items()})
    np.savez(os.path.join(tmp, f"{name}_batches.npz"),
             **{k: np.stack([b[k] for b in batches]) for k in batches[0]})
    params = jax.device_get(jstate.params)
    adam = next(s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu"))
    moments = {}
    for k in ("mu", "nu"):
        tree = jax.device_get(getattr(adam, k))
        if not isinstance(tree, dict):  # the flat optimizer's vector
            tree = ravel_pytree(params)[1](tree)
        moments[k] = state_dict_from_flax(tree)
    out.update(history=history, params=state_dict_from_flax(params),
               moments=moments)
    return out


def assert_probe(got: dict, want: dict, fwd_tol, grad_tol, label: str):
    """Logits, loss and every gradient of two probes."""
    np.testing.assert_allclose(np.asarray(got["logits"]),
                               np.asarray(want["logits"]), **fwd_tol,
                               err_msg=f"{label} logits")
    np.testing.assert_allclose(got["loss"], want["loss"], **fwd_tol,
                               err_msg=f"{label} loss")
    assert set(got["grads"]) == set(want["grads"])
    for k, w in want["grads"].items():
        np.testing.assert_allclose(np.asarray(got["grads"][k]),
                                   np.asarray(w), **grad_tol,
                                   err_msg=f"{label} grad {k}")


def assert_steps_match_jax(got: dict, want: dict, label: str):
    for i, (g, w) in enumerate(zip(got["history"], want["history"])):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], **F32_TOL,
                                       err_msg=f"{label} {k}, step {i}")
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), w.numpy(),
                                   **STEP_TOL, err_msg=f"{label} {k}")
    for m in ("mu", "nu"):
        moments = by_name(got["params"], got["opt_state"][m])
        for k, w in want["moments"][m].items():
            np.testing.assert_allclose(moments[k].numpy(), w.numpy(),
                                       **STEP_TOL,
                                       err_msg=f"{label} {m} {k}")


# -- the runs -----------------------------------------------------------------

def mesh_cases(meshes: dict, tmp: str) -> tuple[dict, dict]:
    """JAX on each mesh of ``meshes`` (one init a config), and the port's
    specs, by world size, fed JAX's init and its CutMix batches."""
    inits, jax_out, cases = {}, {}, {2: {}, 4: {}}
    for name, (shape, axes, M, kw) in meshes.items():
        kw = dict(kw, cutmix=True)
        key = tuple(sorted(kw.items()))
        if key not in inits:
            inits[key] = jax_init(kw)
        jax_out[name] = jax_reference(name, inits[key], shape, axes, "pipe",
                                      tmp, M, STEPS)
        cases[math.prod(shape)][name] = spec(
            shape, axes, init=f"{name}_init.pt", probe="probe.npz",
            batches=f"{name}_batches.npz", pipeline_microbatches=M, **kw)
    return jax_out, cases


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side at these tests' small sizes: torch's intra-op
    threads would only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_against_jax(tmp: str, jax_out: dict, name: str) -> None:
    """The probe at JAX's forward and gradient bounds, and the steps at
    its step bounds."""
    got = torch.load(os.path.join(tmp, f"{name}.pt"))
    assert_probe(got["probe"], jax_out[name], FWD_TOL, GRAD_TOL, name)
    assert_steps_match_jax(got, jax_out[name], name)


def check_against_one_process(tmp: str, specs: dict, name: str) -> None:
    got = torch.load(os.path.join(tmp, f"{name}.pt"))
    want = run_reference(specs[name], tmp)
    assert_probe(got["probe"], want["probe"], PORT_TOL, PORT_TOL, name)
    assert_same_run(got, want, STEPS, label=name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX on each mesh of ``MESHES``; the 2-rank cases in one spawn, the
    4-rank one in another."""
    torch.set_num_threads(1)
    tmp = str(tmp_path_factory.mktemp("pipeline"))
    write_inputs(tmp)
    jax_out, cases = mesh_cases(MESHES, tmp)
    for world, specs in cases.items():
        W.spawn(W.run_cases, world, tmp, cases=specs)
    return tmp, jax_out, {**cases[2], **cases[4]}


@pytest.mark.parametrize("name", list(MESHES))
def test_pipe_axis_matches_jax(runs, name):
    """At JAX's init: the eval forward through the tick loop, the loss and
    gradients of a training forward, then two steps with CutMix (JAX's
    draws) and label smoothing (losses, parameters, both moments), against
    JAX's ``PipelineViT`` on the same mesh."""
    tmp, jax_out, _ = runs
    check_against_jax(tmp, jax_out, name)


@pytest.mark.parametrize("name", list(MESHES))
def test_pipe_axis_matches_one_process(runs, name):
    """The same probe and steps on one process with no pipeline."""
    tmp, _, specs = runs
    check_against_one_process(tmp, specs, name)


def test_one_stage_runs_the_tick_loop():
    """``pipeline_forward`` at a pipe axis of one (no mesh): M=4
    microbatches through the tick loop give the sequential logits and
    gradients, with and without ``--remat``."""
    from vit_cifar_torch.config import Config
    from vit_cifar_torch.models import get_model
    from vit_cifar_torch.parallel.pipeline import pipeline_forward

    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 32, 32, 3)).astype(np.float32))
    for remat in (False, True):
        model, _ = get_model(Config(**dict(BASE, num_layers=2, remat=remat)),
                             device="cpu")
        params = list(model.parameters())
        want = model(x)
        got = pipeline_forward(model, None, 4, x)
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), **FWD_TOL)
        g_want = torch.autograd.grad(want.square().sum(), params)
        g_got = torch.autograd.grad(got.square().sum(), params)
        for a, b in zip(g_got, g_want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)
        with torch.no_grad():
            np.testing.assert_allclose(
                pipeline_forward(model, None, 4, x).numpy(),
                want.detach().numpy(), **FWD_TOL)


def test_one_device_forward_lifts_the_hooks():
    """Within ``one_device_forward`` (the loop's layer-output histograms)
    the model runs as one device: no pipeline, no seq axis on any module,
    a padded stream still padded and masked; after it the hooks are back."""
    from vit_cifar_torch.config import Config
    from vit_cifar_torch.models import get_model
    from vit_cifar_torch.parallel.collectives import Axis
    from vit_cifar_torch.parallel.mesh import one_device_forward
    from vit_cifar_torch.parallel.pipeline import Pipeline
    from vit_cifar_torch.parallel.sequence import pad_stream

    model, _ = get_model(Config(**BASE), device="cpu")
    x = torch.zeros(2, 32, 32, 3)
    want = model(x)
    pad_stream(model, 4)
    axis = Axis("seq", None, 0, 4)
    hooked = [m for m in model.modules() if hasattr(type(m), "seq_axis")]
    for m in hooked:
        m.seq_axis = axis
    model.pipeline = Pipeline(None, 2)
    with one_device_forward(model):
        assert model.pipeline is None
        assert all(m.seq_axis is None for m in hooked)
        got = model(x)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert model.pipeline is not None and model.seq_pad == 3
    assert all(m.seq_axis is axis for m in hooked)


def test_new_modules_import_no_jax():
    """The pipe and seq modules, the ViT and the train step import torch
    and the port only."""
    code = ("import sys; import vit_cifar_torch.parallel.pipeline, "
            "vit_cifar_torch.parallel.sequence, vit_cifar_torch.train.loop; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'vit_cifar_tpu', 'flax', 'optax')]; "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
