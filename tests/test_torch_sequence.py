"""Sequence parallelism of the port (``vit_cifar_torch/parallel/sequence.py``)
on several ranks, on the CPU with gloo, against JAX's ``seq_parallel_model``
on the same mesh and against the port on one process.

Harness and inputs are ``tests/test_torch_pipeline.py``'s.  Tolerances:
against JAX, those of JAX's own ``tests/test_sequence.py``: the eval
forward rtol 2e-6 / atol 2e-6, the loss and gradients of a training
forward rtol 1e-4 / atol 1e-5; against the port on one process (the
unpadded model, or with dropout the padded one, whose draws a seq run
takes), ``tests/test_torch_parallel_mp.py``'s rtol 1e-5 / atol 2e-5 for
the probe and two steps.
"""

from __future__ import annotations

import math
import os

import pytest
import torch

import torch_parallel_worker as W
from test_torch_parallel_mp import PORT_TOL, assert_same_run, run_reference
from test_torch_pipeline import (assert_probe, jax_init, jax_reference,
                                 spec, write_inputs)
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)

SEQ_FWD_TOL = dict(rtol=2e-6, atol=2e-6)
SEQ_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 2
SMALL = dict(num_layers=2, mlp_hidden=64)
# name -> (mesh shape, axes, Config fields over BASE + SMALL)
CASES = {
    "seq2": ((2,), ("seq",), {}),  # T=65 + 1 pad token
    "seq4": ((4,), ("seq",), {}),  # + 3 pad tokens, 17 a rank
    "data2_seq2": ((2, 2), ("data", "seq"), {}),
    "seq2_model2": ((2, 2), ("seq", "model"), {}),
    "nocls_seq2": ((2,), ("seq",), dict(is_cls_token=False)),  # T=64
    "moe_nocls_seq2": ((2,), ("seq",), dict(is_cls_token=False,
                                           moe_experts=4)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX on each case's mesh (one init a config); every case of a world
    size in one spawn, with a dropout run on (2,) seq beside them."""
    torch.set_num_threads(1)
    tmp = str(tmp_path_factory.mktemp("sequence"))
    write_inputs(tmp)
    inits, jax_out, cases = {}, {}, {2: {}, 4: {}}
    for name, (shape, axes, kw) in CASES.items():
        kw = dict(SMALL, **kw)
        key = tuple(sorted(kw.items()))
        if key not in inits:
            inits[key] = jax_init(kw)
        jax_out[name] = jax_reference(name, inits[key], shape, axes, "seq",
                                      tmp)
        cases[math.prod(shape)][name] = spec(
            shape, axes, init=f"{name}_init.pt", probe="probe.npz", **kw)
    cases[2]["dropout_seq2"] = spec((2,), ("seq",), dropout=0.1,
                                    pad_stream=2, **SMALL)
    for world, specs in cases.items():
        W.spawn(W.run_cases, world, tmp, cases=specs)
    return tmp, jax_out, {**cases[2], **cases[4]}


def _got(tmp: str, name: str) -> dict:
    return torch.load(os.path.join(tmp, f"{name}.pt"))


@pytest.mark.parametrize("name", list(CASES))
def test_seq_axis_matches_jax(runs, name):
    """At JAX's init, on the probe batch: the eval forward of the cut
    stream (padded where T does not divide the axis, keys masked by their
    global index, the pooled row summed over the axis) and the loss and
    gradients of a training forward, against JAX's ``seq_parallel_model``
    on the same mesh; for the MoE, its Switch term over the whole stream
    in the loss."""
    tmp, jax_out, _ = runs
    assert_probe(_got(tmp, name)["probe"], jax_out[name], SEQ_FWD_TOL,
                 SEQ_GRAD_TOL, name)


@pytest.mark.parametrize("name", list(CASES))
def test_seq_axis_matches_one_process(runs, name):
    """The probe and two steps against the unpadded model on one process:
    every parameter's gradient whole after the step's sum over the axis,
    the loss and accuracy those of the global batch."""
    tmp, _, specs = runs
    got = _got(tmp, name)
    want = run_reference(specs[name], tmp)
    assert_probe(got["probe"], want["probe"], PORT_TOL, PORT_TOL, name)
    assert_same_run(got, want, STEPS, label=name)


def test_dropout_draws_at_the_padded_global_shape(runs):
    """Dropout 0.1 on (2,) seq: every rank draws at (B, T + pad, F) from
    the same generator and keeps its tokens, so two steps are those of the
    padded model on one process."""
    tmp, _, specs = runs
    assert_same_run(_got(tmp, "dropout_seq2"),
                    run_reference(specs["dropout_seq2"], tmp), STEPS,
                    label="dropout")
