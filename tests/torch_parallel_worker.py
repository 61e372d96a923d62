"""Multi-rank runs of the port for the parallel tests, on the CPU with gloo.

This module imports torch, numpy and ``vit_cifar_torch`` only: it is what
each spawned rank imports (``spawn``), and every rank asserts that no JAX
module is loaded.  The JAX reference runs in the test process; both sides
exchange arrays through files in the test's ``tmp_path``.

``spawn(job, world, tmp_path, **kw)`` starts ``world`` ranks with the
``spawn`` start method, joins them through a ``FileStore`` under
``tmp_path`` (no TCP port to collide on between pytest workers), runs
``job(rank, tmp, **kw)`` on each, and kills them and fails past its own
timeout.  ``run_case`` is one training run on a mesh (or on one process,
``mesh=None``) that writes its state in the one-device layout.
"""

from __future__ import annotations

import math
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

SPAWN_TIMEOUT = 120.0


def spawn(job, world: int, tmp_path, timeout: float = SPAWN_TIMEOUT, **kw):
    """Run ``job(rank, tmp, **kw)`` on ``world`` gloo ranks; a rank's error
    fails the call with its traceback, and so does the timeout."""
    store = tempfile.mkdtemp(dir=str(tmp_path))
    ctx = torch.multiprocessing.start_processes(
        _entry, args=(world, os.path.join(store, "store"), str(tmp_path),
                      job, kw),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{job.__name__} on {world} ranks did "
                                   f"not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)


def _entry(rank: int, world: int, store: str, tmp: str, job, kw) -> None:
    torch.set_num_threads(1)
    assert "jax" not in sys.modules, "a rank imported jax"
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        job(rank, tmp, **kw)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    assert "jax" not in sys.modules, "a rank imported jax"


# -- one training run --------------------------------------------------------

def run_case(spec: dict, tmp: str, mesh) -> dict:
    """Train ``spec`` on ``mesh`` (None: one process) and return its state
    in the one-device layout: params, opt_state, model_state, the losses
    and metrics of each step.

    ``spec``: ``cfg`` (Config kwargs), ``steps``, ``init`` (a file of the
    one-device initial state dict, or None for the port's own init), and
    either ``batches`` (a .npz of the global augmented batches, fed to
    ``on_batch``, with CutMix's ``rand_label`` and ``lam`` where it has
    them) or ``data`` (a .npz of the uint8 dataset and the permutation, fed
    to the step, which builds the batches); optional ``nan_rank`` (that
    rank's gradient of ``nan_param`` is made NaN at ``nan_step``),
    ``pad_stream`` (the stream padded as a seq axis of that size pads it)
    and ``probe`` (a .npz of a normalized batch ``img`` and its ``label``:
    the eval forward's logits, and the loss and gradients at the initial
    state)."""
    from vit_cifar_torch.config import Config
    from vit_cifar_torch.models import get_model
    from vit_cifar_torch.parallel.mesh import shard_params
    from vit_cifar_torch.parallel.sequence import pad_stream
    from vit_cifar_torch.train.loop import init_state, parallel_model
    from vit_cifar_torch.train.optim import make_optimizer
    from vit_cifar_torch.train.steps import make_metrics_zeros, make_train_step

    cfg = Config(**spec["cfg"])
    model, _ = get_model(cfg, device="cpu")
    if spec.get("init"):
        model.load_state_dict(torch.load(os.path.join(tmp, spec["init"])))
    if spec.get("pad_stream"):
        pad_stream(model, spec["pad_stream"])
    model = parallel_model(cfg, model, mesh)
    layout = shard_params(mesh, model)
    tx = make_optimizer(cfg, spec.get("steps_per_epoch", 4), model)
    state = init_state(cfg, model, tx)
    state.metrics_acc = make_metrics_zeros(cfg, "cpu")
    step = make_train_step(cfg, model, tx, mesh=mesh)
    rank = 0 if mesh is None else mesh.rank
    if spec.get("nan_rank") == rank:
        param = dict(model.named_parameters())[spec["nan_param"]]
        nan_at = [spec["nan_step"]]

        def poison(g):
            return g * float("nan") if state.step in nan_at else g

        param.register_hook(poison)
    data = None if mesh is None else mesh.axis("data")
    rows = (lambda t: t) if data is None else (lambda t: data.block(t, 0))
    probe = None
    if spec.get("probe"):
        probe = _probe(model, step, state, layout, data, rows,
                       np.load(os.path.join(tmp, spec["probe"])))
    if "batches" in spec:
        b = np.load(os.path.join(tmp, spec["batches"]))

        def train_step(i):
            mix = {}
            if "lam" in b:
                mix = dict(rand_label=rows(torch.from_numpy(
                    b["rand_label"][i])), lam=torch.tensor(b["lam"][i]))
            return step.on_batch(state, rows(torch.from_numpy(b["img"][i])),
                                 rows(torch.from_numpy(b["label"][i])),
                                 **mix)
    else:
        d = np.load(os.path.join(tmp, spec["data"]))
        x, y, perm = (torch.from_numpy(d[k]) for k in ("x", "y", "perm"))

        def train_step(i):
            return step(state, x, y, perm, i)
    history, mus, before = [], [], None
    for i in range(spec["steps"]):
        if spec.get("keep_before"):
            before = _payload(state, layout)
        m = train_step(i)[1]
        history.append({k: float(v) for k, v in m.items()})
        if mesh is None:  # the reference's moments, step by step
            mus.append(state.opt_state["mu"].clone())
    out = _payload(state, layout)
    out["history"] = history
    out["mus"] = mus
    if before is not None:
        out["before"] = before
    if spec.get("eval"):
        out["eval"] = _eval_sums(cfg, model, mesh, tmp, spec["eval"])
    if probe is not None:
        out["probe"] = probe
    return out


def _probe(model, step, state, layout, data, rows, batch) -> dict:
    """The eval forward's logits on the whole batch, and the loss and the
    gradients (one-device layout) of a training forward on it."""
    img, label = (torch.from_numpy(batch[k]) for k in ("img", "label"))
    with torch.no_grad():
        logits = model(rows(img), deterministic=True)
    if data is not None:
        logits = data.all_gather(logits, 0)
    loss, _, grads, _ = step.loss_and_grads(state, rows(img), rows(label))
    grads = dict(zip([n for n, _ in model.named_parameters()], grads))
    if layout is not None:
        grads = layout.full_named(grads)
    return {"logits": logits, "loss": float(loss),
            "grads": {k: v.clone() for k, v in grads.items()}}


def _payload(state, layout) -> dict:
    from vit_cifar_torch.train.loop import _full_payload

    p = _full_payload(state, 0, math.inf, layout)
    return {k: p[k] for k in ("params", "opt_state", "model_state")
            if k in p}


def _eval_sums(cfg, model, mesh, tmp: str, name: str) -> list:
    """The eval step's masked sums over a padded eval set."""
    from vit_cifar_torch.train.loop import _pad_eval
    from vit_cifar_torch.train.steps import make_eval_step

    d = np.load(os.path.join(tmp, name))
    x, y, mask, steps = _pad_eval(d["x"], d["y"], cfg.eval_batch_size)
    step = make_eval_step(cfg, model, mesh)
    eb = cfg.eval_batch_size
    sums = []
    for b in range(steps):
        sl = slice(b * eb, (b + 1) * eb)
        out = step(*(torch.from_numpy(a[sl]) for a in (x, y, mask)))
        sums.append([float(out[k]) for k in ("loss_sum", "correct_sum",
                                             "count")])
    return sums


def run_cases(rank: int, tmp: str, cases: dict, runs: list = (),
              data: str | None = None) -> None:
    """Each case of ``cases`` (name -> spec with ``mesh_shape`` and
    ``mesh_axes`` in its ``cfg``) on its mesh; rank 0 writes
    ``{name}.pt``.  A case that raises writes its message instead when the
    spec says ``expect_error``.  Then the ``train()`` ``runs`` on
    ``data``, as ``run_train``."""
    from vit_cifar_torch.parallel.mesh import make_mesh

    for name, spec in cases.items():
        cfg = spec["cfg"]
        try:
            mesh = make_mesh(cfg["mesh_shape"], cfg["mesh_axes"], "cpu")
            out = run_case(spec, tmp, mesh)
        except ValueError as e:
            if not spec.get("expect_error"):
                raise
            out = {"error": str(e)}
        if rank == 0:
            torch.save(out, os.path.join(tmp, f"{name}.pt"))
    if runs:
        run_train(rank, tmp, runs, data)


def run_train(rank: int, tmp: str, runs: list, data: str) -> None:
    """``train()`` runs in order (cfg kwargs, stop_after, the name of a
    run whose checkpoint to resume or None) on the dataset ``data``; rank 0
    writes each result as ``{name}.pt``."""
    from vit_cifar_torch.config import Config
    from vit_cifar_torch.data.datasets import RawData
    from vit_cifar_torch.train import loop

    d = np.load(os.path.join(tmp, data))
    raw = RawData(d["x"], d["y"], d["xt"], d["yt"], 10, synthetic=True)
    real, loop.load_dataset = loop.load_dataset, lambda *a, **k: raw
    done = {}
    try:
        for name, kw, stop_after, resume in runs:
            if resume is not None:
                kw = dict(kw, resume=done[resume]["ckpt_dir"])
            done[name] = loop.train(Config(**kw), verbose=False,
                                    device="cpu", stop_after=stop_after)
            if rank == 0:
                torch.save(done[name], os.path.join(tmp, f"{name}.pt"))
    finally:
        loop.load_dataset = real


def run_guards(rank: int, tmp: str, guards: dict, cases: dict) -> None:
    """The ValueError message of each guard (label -> (kind, Config kwargs,
    mesh shape, axes)): kind "pp" lays the model out with
    ``pipeline_model``, "sp" with ``seq_parallel_model``, "loop" with the
    loop's ``parallel_model``, "pp_apply" runs a pipelined forward after
    ``pipeline_model``; rank 0 writes ``guards.pt`` (label -> message, or
    None where nothing raised).  Then ``cases``, as ``run_cases``."""
    from vit_cifar_torch.config import Config
    from vit_cifar_torch.models import get_model
    from vit_cifar_torch.parallel.mesh import make_mesh
    from vit_cifar_torch.parallel.pipeline import pipeline_model
    from vit_cifar_torch.parallel.sequence import seq_parallel_model
    from vit_cifar_torch.train.loop import parallel_model

    out = {}
    for label, (kind, kw, shape, axes) in guards.items():
        mesh = make_mesh(shape, axes, "cpu")
        try:
            model, _ = get_model(Config(**kw), device="cpu")
            if kind == "sp":
                seq_parallel_model(model, mesh)
            elif kind == "loop":
                parallel_model(Config(**kw), model, mesh)
            else:
                pipeline_model(model, mesh, 2)
            if kind == "pp_apply":
                with torch.no_grad():
                    model(torch.zeros(8, 32, 32, 3))
            out[label] = None
        except ValueError as e:
            out[label] = str(e)
    if rank == 0:
        torch.save(out, os.path.join(tmp, "guards.pt"))
    run_cases(rank, tmp, cases)
