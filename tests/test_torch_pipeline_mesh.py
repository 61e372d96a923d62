"""GPipe of the port on two-axis meshes, on the CPU with gloo: (2,2) data x
pipe and (2,2) pipe x model (tensor parallelism inside a stage) against
JAX's ``PipelineViT`` on the same mesh and against the port on one
process; the eval through the tick loop with a padded last batch; the
stateful routes; a checkpoint written on data x pipe and resumed on data.

Harness, inputs and tolerances are ``tests/test_torch_pipeline.py``'s.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from test_torch_parallel_mp import (PORT_TOL, assert_same_run, one_process,
                                    run_reference)
from test_torch_pipeline import (BASE, STEPS, check_against_jax,
                                 check_against_one_process, mesh_cases, spec,
                                 write_inputs)
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)

MESHES = {
    "data2_pipe2": ((2, 2), ("data", "pipe"), 2, dict(num_layers=2)),
    "pipe2_model2": ((2, 2), ("pipe", "model"), 2, dict(num_layers=2)),
}
DP = ((2, 2), ("data", "pipe"))
# one small config of each stateful route (model state, AE intermediates)
STATEFUL = {
    "hamburger_bases": dict(model_name="hamburger", train_md_bases=True,
                            head=1, num_layers=2, batch_size=8,
                            ffn_features=16, md_iter=2),
    "ae_unsupervised": dict(model_name="ae", criterion="aece",
                            unsupervised_steps=2, head=1, num_layers=2,
                            batch_size=8, ffn_features=16),
}
CKPT = dict(BASE, batch_size=8, eval_batch_size=8, max_epochs=2,
            log_weights=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX on each mesh of ``MESHES``; the 4-rank cases, then train() on
    (2,2) data x pipe stopped after epoch 1, in one spawn; its checkpoint
    resumed on (2,) data in a 2-rank spawn; the straight run on one
    process."""
    torch.set_num_threads(1)
    tmp = str(tmp_path_factory.mktemp("pipeline_mesh"))
    write_inputs(tmp)
    jax_out, cases = mesh_cases(MESHES, tmp)
    specs = dict(cases[4])
    specs["eval_padded"] = spec(*DP, steps=1, eval="evalset.npz",
                                pipeline_microbatches=2)
    specs.update({name: spec(*DP, pipeline_microbatches=2, **kw)
                  for name, kw in STATEFUL.items()})
    d = np.load(os.path.join(tmp, "data.npz"))
    e = np.load(os.path.join(tmp, "evalset.npz"))
    np.savez(os.path.join(tmp, "raw.npz"), x=d["x"][:16], y=d["y"][:16],
             xt=e["x"], yt=e["y"])
    logs = os.path.join(tmp, "logs")
    dpp = dict(CKPT, mesh_shape=DP[0], mesh_axes=DP[1],
               pipeline_microbatches=2, log_dir=logs,
               ckpt_dir=os.path.join(tmp, "ckpt_dp"))
    W.spawn(W.run_cases, 4, tmp, cases=specs, data="raw.npz",
            runs=[("written", dpp, 1, None)])
    written = torch.load(os.path.join(tmp, "written.pt"))
    W.spawn(W.run_train, 2, tmp, data="raw.npz", runs=[
        ("resumed_data", dict(CKPT, mesh_shape=(2,), mesh_axes=("data",),
                              log_dir=logs, resume=written["ckpt_dir"],
                              ckpt_dir=os.path.join(tmp, "ckpt_data")),
         None, None)])
    W.run_train(0, tmp, data="raw.npz", runs=[
        ("one_straight", dict(CKPT, log_dir=logs,
                              ckpt_dir=os.path.join(tmp, "ckpt_one")),
         None, None)])
    return tmp, jax_out, specs


def _got(tmp: str, name: str) -> dict:
    return torch.load(os.path.join(tmp, f"{name}.pt"))


@pytest.mark.parametrize("name", list(MESHES))
def test_two_axis_mesh_matches_jax(runs, name):
    """(2,2) data x pipe, each data shard its own pipeline, and (2,2) pipe
    x model, the Megatron layout inside each stage: the probe and two
    CutMix steps against JAX's ``PipelineViT`` on the same mesh."""
    tmp, jax_out, _ = runs
    check_against_jax(tmp, jax_out, name)


@pytest.mark.parametrize("name", list(MESHES))
def test_two_axis_mesh_matches_one_process(runs, name):
    tmp, _, specs = runs
    check_against_one_process(tmp, specs, name)


def test_eval_through_the_tick_loop_with_a_padded_last_batch(runs):
    """(2,2) data x pipe at M=2: the eval forward is pipelined and the
    masked sums over 13 images in two batches of 8 are the one-process
    ones."""
    tmp, _, specs = runs
    got = _got(tmp, "eval_padded")["eval"]
    want = W.run_case(one_process(specs["eval_padded"]), tmp, None)["eval"]
    assert [s[2] for s in got] == [s[2] for s in want] == [8.0, 5.0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(STATEFUL))
def test_stateful_models_train_the_whole_trunk(runs, name):
    """The burger with persistent EMA bases (model state) and the AEViT
    with aece and unsupervised steps (AE intermediates) on (2,2) data x
    pipe take the sequential route, as JAX's ``mutable`` apply does: two
    steps equal the one-process run, buffers included."""
    tmp, _, specs = runs
    got = _got(tmp, name)
    assert_same_run(got, run_reference(specs[name], tmp), STEPS, label=name)
    if name == "ae_unsupervised":
        assert got["history"][-1]["unsupervised_loss"] > 0


def test_checkpoint_from_a_pipe_mesh_resumes_on_data(runs):
    """A checkpoint written by train() on (2,2) data x pipe after epoch 1
    keeps the one-device keys and shapes; resumed on (2,) data it ends
    where the straight one-process run ends."""
    from vit_cifar_torch.train.checkpoint import load_checkpoint

    tmp, _, _ = runs
    res = {n: _got(tmp, n) for n in ("written", "resumed_data",
                                     "one_straight")}
    payload = {n: load_checkpoint(r["ckpt_dir"], prefer="last")[0]
               for n, r in res.items()}
    a, b = payload["written"], payload["one_straight"]
    assert set(a) == set(b) and a["step"] == 2
    for key in ("params", "opt_state"):
        assert {k: tuple(v.shape) for k, v in a[key].items()} == \
            {k: tuple(v.shape) for k, v in b[key].items()}, key
    p, q = payload["resumed_data"], b
    assert p["step"] == q["step"] == 4
    for key in ("params", "opt_state"):
        for k, v in q[key].items():
            np.testing.assert_allclose(p[key][k].numpy(), v.numpy(),
                                       **PORT_TOL, err_msg=f"{key} {k}")
    np.testing.assert_allclose(res["resumed_data"]["val_loss"],
                               res["one_straight"]["val_loss"], rtol=1e-5)
