"""The rows of the guard matrix (``tests/test_guard_matrix.py``) that the
pipe and seq axes add, for the port, on the CPU with gloo: every ``pp_*``
and ``sp_*`` guard raises JAX's ValueError message, word for word, on the
same mesh; the seq + pipe refusal through ``train()``; the pipeline's
refusal of other axes; and one finite step of every model JAX pipelines
(``PP_MODELS``, the ``_ema`` variants with persistent bases included) on
(2,2) data x pipe and of ``vit`` and the no-cls MoE ViT on (2,2) data x
seq.  Every case runs in one spawn of 4 ranks; the configs are the JAX
matrix's own (``_cfg``), carried over field for field.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re

import pytest
import torch

import torch_parallel_worker as W
from test_guard_matrix import GUARDS, PP_MODELS, _cfg, _pp, _sp
from vit_cifar_torch.config import Config
from vit_cifar_torch.train.loop import train
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

PIPE = ((4,), ("pipe",))
DATA_SEQ = ((2, 2), ("data", "seq"))
DATA = ((4,), ("data",))
# label -> (kind, model, Config fields, mesh shape, axes), the GUARDS rows'
# triggers on meshes of 4 devices
ROWS = {
    "pp_non_vit": ("pp", "lgcnn", {}, *PIPE),
    "pp_dropout": ("pp", "vit", dict(dropout=0.1), *PIPE),
    "pp_moe": ("pp", "vit", dict(moe_experts=4), *PIPE),
    "pp_mask_rng": ("pp", "hamburger", {}, *PIPE),
    "pp_mask_rng_gnnmf_ham": ("pp", "gnnmf_ham", {}, *PIPE),
    "pp_no_pipe_axis": ("pp", "vit", {}, *DATA),
    "pp_layer_split": ("pp", "vit", dict(num_layers=3), *PIPE),
    "sp_non_vit": ("sp", "lgcnn", {}, *DATA_SEQ),
    "sp_non_mhsa": ("sp", "gmlp", {}, *DATA_SEQ),
    "sp_no_seq_axis": ("sp", "vit", {}, *DATA),
    "sp_pad_moe": ("sp", "vit", dict(moe_experts=4), *DATA_SEQ),
}


def port_kw(name: str, **kw) -> dict:
    """The JAX matrix's ``_cfg(name, **kw)`` as the port's Config fields."""
    return dataclasses.asdict(_cfg(name, **kw))


def _step_kw(name: str) -> dict:
    """A matrix model name as its model and Config fields
    (``test_allowed_zoo_parallel_combination_trains``)."""
    if name.endswith("_ema"):
        return port_kw(name[:-len("_ema")], train_md_bases=True)
    if name == "vit_moe_nocls":
        return port_kw("vit", moe_experts=4, is_cls_token=False)
    return port_kw(name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("guards"))
    guards = {label: (kind, port_kw(name, **kw), shape, axes)
              for label, (kind, name, kw, shape, axes) in ROWS.items()}
    # JAX checks the other axes when the pipeline runs
    guards["pp_other_axes"] = ("pp_apply", port_kw("vit"), (2, 2),
                               ("pipe", "expert"))
    # JAX's test_pipeline_batch_divisibility_validated_up_front: 20 / 2
    # per data shard does not divide into 4 microbatches
    guards["pp_batches_up_front"] = ("loop", port_kw(
        "vit", num_layers=4, batch_size=16, eval_batch_size=20,
        mesh_shape=(2, 2), mesh_axes=("data", "pipe"),
        pipeline_microbatches=4), (2, 2), ("data", "pipe"))
    cases = {}
    for name, shape, axes in (
            [(m, (2, 2), ("data", "pipe")) for m in PP_MODELS]
            + [(m, *DATA_SEQ) for m in ("vit", "vit_moe_nocls")]):
        kw = dict(_step_kw(name), batch_size=8, mesh_shape=shape,
                  mesh_axes=axes, pipeline_microbatches=2)
        cases[f"{name}_{axes[1]}"] = dict(data="data.npz", steps=1, cfg=kw)
    from test_torch_pipeline import write_inputs

    write_inputs(tmp)
    W.spawn(W.run_guards, 4, tmp, guards=guards, cases=cases)
    return tmp, torch.load(os.path.join(tmp, "guards.pt"))


def _jax_message(label: str) -> str:
    kind, name, kw, shape, axes = ROWS[label]
    with pytest.raises(ValueError) as e:
        (_pp if kind == "pp" else _sp)(name, shape, axes, **kw)
    return str(e.value)


@pytest.mark.parametrize("label", list(ROWS))
def test_guard_raises_jax_message(runs, label):
    """The port raises JAX's message on the same mesh, and it matches the
    JAX matrix's pattern for the row."""
    _, got = runs
    match = {g[0]: g[2] for g in GUARDS}[label]
    assert got[label] is not None, f"{label}: nothing raised"
    assert got[label] == _jax_message(label)
    assert re.search(match, got[label])


def test_every_pipe_and_seq_row_of_the_matrix_is_held():
    assert set(ROWS) == {g[0] for g in GUARDS
                         if g[0].startswith(("pp_", "sp_"))}


def test_pipeline_rejects_other_big_axes(runs):
    """(2,2) pipe x expert: the pipeline is laid out, and its forward
    raises JAX's "supports (data, pipe[, model])" error."""
    _, got = runs
    assert got["pp_other_axes"] is not None
    assert re.search("supports \\(data, pipe", got["pp_other_axes"])


def test_pipeline_batch_divisibility_validated_up_front(runs):
    """Both batch sizes are held against the microbatches a data shard
    when the model is laid out, before any step."""
    _, got = runs
    assert got["pp_batches_up_front"] == (
        "eval_batch_size=20: per-data-shard batch 10 must divide into 4 "
        "pipeline microbatches")


def test_seq_plus_pipe_mesh_rejected(tmp_path):
    """JAX's refusal, with its config, before any process group."""
    kw = port_kw("vit", mesh_shape=(2, 2, 2),
                 mesh_axes=("data", "seq", "pipe"), max_epochs=1,
                 eval_batch_size=8, log_dir=str(tmp_path / "l"),
                 ckpt_dir=str(tmp_path / "m"))
    with pytest.raises(ValueError, match="do not compose"):
        train(Config(**kw), verbose=False, device="cpu")


@pytest.mark.parametrize("name", PP_MODELS)
def test_every_pipelined_model_trains_a_step(runs, name):
    tmp, _ = runs
    h = torch.load(os.path.join(tmp, f"{name}_pipe.pt"))["history"]
    assert math.isfinite(h[0]["loss"]) and h[0]["skipped_nonfinite"] == 0.0


@pytest.mark.parametrize("name", ["vit", "vit_moe_nocls"])
def test_seq_models_train_a_step(runs, name):
    tmp, _ = runs
    h = torch.load(os.path.join(tmp, f"{name}_seq.pt"))["history"]
    assert math.isfinite(h[0]["loss"]) and h[0]["skipped_nonfinite"] == 0.0
