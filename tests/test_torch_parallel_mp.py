"""Data, tensor and expert parallelism of the port on several ranks, on the
CPU with gloo, against the port on one process and against the JAX package
on the same mesh.

The ranks are spawned (``torch_parallel_worker.spawn``: the ``spawn`` start
method, a ``FileStore`` rendezvous under ``tmp_path``, a timeout of its own
that kills them and fails); they import torch, numpy and
``vit_cifar_torch`` only, and each asserts that no JAX module is loaded.
JAX runs here, on the 8-virtual-device CPU mesh of ``tests/conftest.py``
(a mesh of n devices takes the first n); the two sides exchange arrays
through files in ``tmp_path``.  Every case of a module runs in one spawn
per world size.

The same numpy inputs, made from a seed, go to every side; the weights are
the JAX init transplanted; dropout is 0 unless a case says otherwise.  Each
case compares the losses and the whole state after its steps: every
parameter, both Adam moments and the count, in the one-device layout the
checkpoints keep.  Tolerances:

* the port on N ranks against the port on one process, same global batch:
  losses rtol 1e-5, state rtol 1e-5 / atol 2e-5, the contract of JAX's own
  ``tests/test_parallel.py`` (dp against dp x tp).  Adam's update of an
  entry whose gradient (decay included) was within 1e-7 of zero at some
  step is lr in the direction of its rounding noise, so those entries are
  held to Adam's bound of 3 lr a step, as ``tests/test_torch_cnn.py`` does;
* the port on N ranks against JAX on the same mesh: the state
  ``ADAM_PARAM_TOL`` (rtol 1e-4 / atol 1e-4) and the losses ``F32_TOL``
  (``tests/test_torch_train.py``).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import torch_parallel_worker as W
import vit_cifar_tpu.config as jconfig
from test_torch_train import ADAM_PARAM_TOL, F32_TOL, _jax_batch
from vit_cifar_torch.utils.transplant import state_dict_from_flax
from vit_cifar_tpu.models import get_model as jax_get_model
from vit_cifar_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vit_cifar_tpu.parallel.mesh import replicated_sharding
from vit_cifar_tpu.parallel.mesh import shard_params as jax_shard_params
from vit_cifar_tpu.train.loop import init_state as jax_init_state
from vit_cifar_tpu.train.optim import make_optimizer as jax_make_optimizer
from vit_cifar_tpu.train.steps import make_train_step as jax_make_train_step
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

BASE = dict(model_name="vit", num_layers=2, hidden=64, mlp_hidden=64,
            head=4, batch_size=16, eval_batch_size=8, label_smoothing=True,
            warmup_epoch=0, precision="32", dropout=0.0, ffn_features=64)
N_TRAIN = 48
STEPS = 3
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
PORT_TOL = dict(rtol=1e-5, atol=2e-5)
ADAM_FLOOR = 1e-7
DM = ((1, 2), ("data", "model"))


def case(shape=(2,), axes=("data",), steps=STEPS, **kw) -> dict:
    """A run spec for ``torch_parallel_worker.run_case`` on the mesh
    (shape, axes); ``kw`` are Config fields over ``BASE``, and the
    ``init``, ``batches``, ``data``, ``eval``, ``nan_*`` keys of the spec."""
    spec = {k: kw.pop(k) for k in ("init", "batches", "eval", "nan_rank",
                                   "nan_param", "nan_step", "keep_before")
            if k in kw}
    if "batches" not in spec:
        spec["data"] = "data.npz"
    return dict(spec, steps=steps, cfg=dict(BASE, mesh_shape=shape,
                                            mesh_axes=axes, **kw))


def one_process(spec: dict) -> dict:
    """The same spec on this process, with no mesh."""
    return dict(spec, cfg=dict(spec["cfg"], mesh_shape=(),
                               mesh_axes=("data",)))


def write_data(tmp: str) -> None:
    rng = np.random.default_rng(0)
    np.savez(os.path.join(tmp, "data.npz"),
             x=rng.integers(0, 256, (N_TRAIN, 32, 32, 3), dtype=np.uint8),
             y=rng.integers(0, 10, N_TRAIN).astype(np.int64),
             perm=rng.permutation(N_TRAIN))
    # 13 images: the last eval batch of 8 is padded with 3 masked rows
    np.savez(os.path.join(tmp, "evalset.npz"),
             x=rng.integers(0, 256, (13, 32, 32, 3), dtype=np.uint8),
             y=rng.integers(0, 10, 13).astype(np.int64))


def run_reference(spec: dict, tmp: str) -> dict:
    """The spec on one process, recording the Adam gradient of every step
    (from the first moment) to find the ill-posed entries."""
    out = W.run_case(one_process(spec), tmp, None)
    b1 = spec["cfg"].get("beta1", 0.9)
    prev = torch.zeros_like(out["mus"][0])
    ill = torch.zeros_like(prev, dtype=torch.bool)
    for mu in out["mus"]:
        ill |= ((mu - b1 * prev) / (1.0 - b1)).abs() < ADAM_FLOOR
        prev = mu
    out["ill"] = ill
    return out


def by_name(params: dict, flat: torch.Tensor) -> dict:
    """Named views of a one-device flat vector, in ``params``' order."""
    out, offset = {}, 0
    for name, p in params.items():
        out[name] = flat[offset:offset + p.numel()].view(p.shape)
        offset += p.numel()
    return out


def assert_same_run(got: dict, want: dict, steps: int, lr: float = 1e-3,
                    tol=PORT_TOL, loss_tol=LOSS_TOL, label: str = ""):
    """Losses and metrics of every step, every parameter, both moments and
    the count, and the buffers, of two runs in the one-device layout;
    entries that ``want["ill"]`` marks are held to Adam's bound."""
    assert len(got["history"]) == len(want["history"]) == steps
    for i, (g, w) in enumerate(zip(got["history"], want["history"])):
        assert set(g) == set(w), label
        for k in w:
            np.testing.assert_allclose(g[k], w[k], **loss_tol,
                                       err_msg=f"{label} {k}, step {i}")
    ill = by_name(want["params"], want["ill"])
    assert set(got["params"]) == set(want["params"])
    for name, w in want["params"].items():
        g, bad = got["params"][name], ill[name]
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g[~bad].numpy(), w[~bad].numpy(), **tol,
                                   err_msg=f"{label} param {name}")
        assert bool(((g - w).abs()[bad] <= 3 * lr * steps).all()), name
    assert int(got["opt_state"]["count"]) == int(want["opt_state"]["count"])
    for k in ("mu", "nu"):
        np.testing.assert_allclose(got["opt_state"][k].numpy(),
                                   want["opt_state"][k].numpy(), **tol,
                                   err_msg=f"{label} {k}")
    for name, w in want.get("model_state", {}).items():
        np.testing.assert_allclose(got["model_state"][name].numpy(),
                                   w.numpy(), **tol,
                                   err_msg=f"{label} buffer {name}")


# -- the JAX side --------------------------------------------------------------

def jax_run(kw: dict, shape, axes, steps: int, tmp: str, name: str) -> dict:
    """JAX's train step on the mesh (shape, axes) for ``steps`` steps from
    its init; writes the init (``{name}_init.pt``, the port's state dict)
    and its augmented batches (``{name}_batches.npz``) for the port, and
    returns its losses and metrics, params, moments and buffers by the
    port's names."""
    # JAX's einsum attention: it is JAX's fused kernel's result to f32
    # rounding (tests/test_torch_train.py), and compiles in a third of
    # the time of its interpret-mode Pallas
    jcfg = jconfig.Config(**dict(BASE, **kw, pallas_kernel="einsum"),
                          mesh_shape=shape, mesh_axes=axes)
    mesh = jax_make_mesh(shape, axes)
    jmodel, _ = jax_get_model(jcfg)
    jtx = jax_make_optimizer(jcfg, N_TRAIN // jcfg.batch_size)
    jstate = jax_init_state(jcfg, jmodel, jtx,
                            jnp.zeros((2, 32, 32, 3), jnp.float32))
    torch.save(state_dict_from_flax(
        jstate.params, jstate.model_state.get("state"),
        jstate.model_state.get("batch_stats")),
        os.path.join(tmp, f"{name}_init.pt"))
    if "model" in axes or "expert" in axes:
        jstate = jstate.replace(params=jax_shard_params(mesh, jstate.params))
    d = np.load(os.path.join(tmp, "data.npz"))
    x, y, perm = d["x"], d["y"].astype(np.int32), d["perm"].astype(np.int32)
    repl = replicated_sharding(mesh)
    jx, jy, jperm = (jax.device_put(a, repl) for a in (x, y, perm))
    step = jax.jit(jax_make_train_step(jcfg, jmodel, jtx, mesh=mesh))
    imgs, labels, history = [], [], []
    for i in range(steps):
        img, label = _jax_batch(jcfg, jstate, x, y, perm, i)
        imgs.append(img.numpy())
        labels.append(label.numpy().astype(np.int64))
        jstate, m = step(jstate, jx, jy, jperm, i)
        history.append({k: float(v) for k, v in m.items()})
    np.savez(os.path.join(tmp, f"{name}_batches.npz"), img=np.stack(imgs),
             label=np.stack(labels))
    params = state_dict_from_flax(jax.device_get(jstate.params))
    adam = next(s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu"))
    moments = {}
    for k in ("mu", "nu"):
        tree = jax.device_get(getattr(adam, k))
        if not isinstance(tree, dict):  # the flat optimizer's vector
            tree = ravel_pytree(jax.device_get(jstate.params))[1](tree)
        moments[k] = state_dict_from_flax(tree)
    return {"history": history, "params": params, "moments": moments,
            "count": int(adam.count)}


def assert_matches_jax(got: dict, want: dict, label: str = ""):
    for i, (g, w) in enumerate(zip(got["history"], want["history"])):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], **F32_TOL,
                                       err_msg=f"{label} {k}, step {i}")
    for name, w in want["params"].items():
        np.testing.assert_allclose(got["params"][name].numpy(), w.numpy(),
                                   **ADAM_PARAM_TOL, err_msg=f"{label} {name}")
    assert int(got["opt_state"]["count"]) == want["count"]
    for k in ("mu", "nu"):
        moments = by_name(got["params"], got["opt_state"][k])
        for name, w in want["moments"][k].items():
            np.testing.assert_allclose(moments[name].numpy(), w.numpy(),
                                       **ADAM_PARAM_TOL,
                                       err_msg=f"{label} {k} {name}")


# -- the runs ------------------------------------------------------------------

# the meshes held against JAX: name -> (shape, axes, Config fields); the
# 4-rank ones run in tests/test_torch_parallel_zoo_mp.py
MESHES = {
    "data": ((2,), ("data",), {}),
    "data_model": ((1, 2), ("data", "model"), {}),
    "data2_model2": ((2, 2), ("data", "model"), {}),
    "data2_expert2": ((2, 2), ("data", "expert"), dict(moe_experts=4)),
}
README = dict(num_layers=7, hidden=384, mlp_hidden=384, head=12,
              batch_size=8)
CKPT = dict(BASE, batch_size=8, eval_batch_size=8, max_epochs=2,
            log_weights=False)


def jax_cases(names, tmp: str) -> tuple[dict, dict]:
    """JAX on each named mesh, and the port's specs fed JAX's init and
    batches."""
    jax_out, specs = {}, {}
    for name in names:
        shape, axes, kw = MESHES[name]
        jax_out[name] = jax_run(kw, shape, axes, STEPS, tmp, name)
        specs[name] = case(shape, axes, init=f"{name}_init.pt",
                           batches=f"{name}_batches.npz", **kw)
    return jax_out, specs


def check_mesh_case(tmp: str, name: str, spec: dict, want_jax: dict):
    got = torch.load(os.path.join(tmp, f"{name}.pt"))
    assert_same_run(got, run_reference(spec, tmp), STEPS, label=name)
    assert_matches_jax(got, want_jax, label=name)
    if "expert" in name:  # the global Switch statistic, as JAX's
        assert "moe_aux" in got["history"][-1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX on (2,) and (1,2); every 2-rank case in one spawn; a checkpoint
    written by train() on (1,2) after epoch 1, resumed on (2,1) in a second
    spawn and on one process, each beside the straight run."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    write_data(tmp)
    jax_out, specs = jax_cases(["data", "data_model"], tmp)
    specs.update({
        "readme_width": case(*DM, steps=1, **README),
        "ragged_heads": case(*DM, hidden=48, mlp_hidden=48, head=3),
        "dropout_data": case(dropout=0.1),
        "dropout_data_model": case(*DM, dropout=0.1),
        "cutmix": case(cutmix=True),
        "mixup": case(mixup=True),
        "eval_padded": case(eval="evalset.npz"),
        "nan_one_rank": case(*DM, steps=2, nan_rank=1, nan_step=1,
                             nan_param="enc0.mixer.Wq.weight",
                             keep_before=True),
    })
    W.spawn(W.run_cases, 2, tmp, cases=specs)
    d = np.load(os.path.join(tmp, "data.npz"))
    e = np.load(os.path.join(tmp, "evalset.npz"))
    np.savez(os.path.join(tmp, "raw.npz"), x=d["x"][:16], y=d["y"][:16],
             xt=e["x"], yt=e["y"])
    dm = dict(CKPT, mesh_shape=(1, 2), mesh_axes=("data", "model"),
              ckpt_dir=os.path.join(tmp, "ckpt_dm"),
              log_dir=os.path.join(tmp, "logs"))
    md = dict(dm, mesh_shape=(2, 1), ckpt_dir=os.path.join(tmp, "ckpt_md"))
    W.spawn(W.run_train, 2, tmp, data="raw.npz", runs=[
        ("written", dm, 1, None), ("straight", dm, None, None),
        ("resumed_md", md, None, "written")])
    one = dict(CKPT, ckpt_dir=os.path.join(tmp, "ckpt_one"),
               log_dir=os.path.join(tmp, "logs"))
    written = torch.load(os.path.join(tmp, "written.pt"))
    W.run_train(0, tmp, data="raw.npz", runs=[
        ("one_straight", one, None, None),
        ("resumed_one", dict(one, resume=written["ckpt_dir"]), None, None)])
    return tmp, jax_out, specs


def _got(tmp: str, name: str) -> dict:
    return torch.load(os.path.join(tmp, f"{name}.pt"))


@pytest.mark.parametrize("name", ["data", "data_model"])
def test_port_on_a_mesh_matches_one_process_and_jax(runs, name):
    """(2,) data and (1,2) data x model: 3 steps of a 2-layer ViT against
    the port on one process and JAX on the same mesh."""
    tmp, jax_out, specs = runs
    check_mesh_case(tmp, name, specs[name], jax_out[name])


@pytest.mark.parametrize("name", ["readme_width", "ragged_heads"])
def test_data_model_at_the_readme_width_and_with_ragged_heads(runs, name):
    """One step at the README width (7 layers, hidden 384, 12 heads, 6 a
    rank) and 3 steps of 3 heads over 2 model ranks (each rank gathers q,
    k, v, runs every head and keeps its columns), on (1,2), against the
    port on one process."""
    tmp, _, specs = runs
    spec = specs[name]
    assert_same_run(_got(tmp, name), run_reference(spec, tmp), spec["steps"],
                    label=name)


@pytest.mark.parametrize("name", ["dropout_data", "dropout_data_model",
                                  "cutmix", "mixup"])
def test_random_draws_are_the_global_ones(runs, name):
    """Dropout 0.1 on (2,) and (1,2), CutMix and MixUp on (2,): every rank
    draws at the one-device shape from the same generator and keeps its
    block, so the run is the one-process run (mixup and cutmix pair rows
    across ranks)."""
    tmp, _, specs = runs
    assert_same_run(_got(tmp, name), run_reference(specs[name], tmp), STEPS,
                    label=name)


def test_one_rank_nan_skips_the_step_on_every_rank(runs):
    """A NaN in rank 1's gradient of its Wq shard at step 2, on (1,2): the
    guard's verdict is the world's, so both ranks skip, and the state stays
    bit for bit what it was before the step."""
    tmp, _, _ = runs
    got = _got(tmp, "nan_one_rank")
    assert [h["skipped_nonfinite"] for h in got["history"]] == [0.0, 1.0]
    before = got["before"]
    for key in ("params", "opt_state"):
        for k, v in before[key].items():
            assert torch.equal(got[key][k], v), f"{key} {k}"


def test_eval_sums_with_a_padded_last_batch(runs):
    """Each data rank evaluates its rows and the masked sums are summed
    over the data axis: 13 images in two batches of 8, the last padded."""
    tmp, _, specs = runs
    got = _got(tmp, "eval_padded")["eval"]
    want = W.run_case(one_process(specs["eval_padded"]), tmp, None)["eval"]
    assert [s[2] for s in got] == [s[2] for s in want] == [8.0, 5.0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_checkpoint_keeps_the_one_device_layout_and_resumes_anywhere(runs):
    """A checkpoint written by train() on (1,2) after epoch 1 holds the
    keys and shapes of a one-process one; resumed on (2,1) it ends where
    the straight (1,2) run ends, and resumed on one process where the
    straight one-process run ends, which is the (1,2) run's end too."""
    from vit_cifar_torch.train.checkpoint import load_checkpoint

    tmp, _, _ = runs
    res = {n: _got(tmp, n) for n in ("written", "straight", "resumed_md",
                                     "one_straight", "resumed_one")}
    payload = {n: load_checkpoint(r["ckpt_dir"], prefer="last")[0]
               for n, r in res.items()}
    a, b = payload["written"], payload["one_straight"]
    assert set(a) == set(b)
    for key in ("params", "opt_state"):
        assert {k: tuple(v.shape) for k, v in a[key].items()} == \
            {k: tuple(v.shape) for k, v in b[key].items()}, key
    for resumed, straight in (("resumed_md", "straight"),
                              ("resumed_one", "one_straight"),
                              ("straight", "one_straight")):
        p, q = payload[resumed], payload[straight]
        assert p["step"] == q["step"] == 4
        for key in ("params", "opt_state"):
            for k, v in q[key].items():
                np.testing.assert_allclose(p[key][k].numpy(), v.numpy(),
                                           **PORT_TOL,
                                           err_msg=f"{resumed} {key} {k}")
        np.testing.assert_allclose(res[resumed]["val_loss"],
                                   res[straight]["val_loss"], rtol=1e-5)
