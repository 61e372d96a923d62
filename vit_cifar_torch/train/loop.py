"""The training harness, as ``vit_cifar_tpu/train/loop.py``, on one device.

Reference: the Lightning ``Trainer`` and the ``Net`` hooks (main.py:196-243,
network.py).  ``train`` keeps their behaviour:

  * the per-epoch warmup -> cosine schedule, its lr logged as ``lr_0``
    (and, under ``madam``, the NNMF group's as ``lr_1``);
  * the NaN-parameter guard that stops training (network.py:226-228), read
    with the eval's sums and checked before the epoch's histograms;
  * the val loop's val_loss and val_acc over the padded, masked test set;
  * the best checkpoint by val_loss and a last one, each the full training
    state, so ``--resume`` continues a run where it stopped;
  * the parameter count, the model summary, experiment naming and tags,
    weight and layer-output histograms each epoch (every
    ``max_epochs // 10`` epochs without Comet), gradient histograms every
    ``log_gradients_interval`` steps;
  * ``dry_run`` (fast_dev_run): one train step and one eval batch.

The dataset lives on the device as uint8.  Each epoch draws its permutation
from the state's generator, optionally augments the whole dataset once
(``--preaugment-epoch``), runs its steps with no host read, then reads the
epoch's metric sums and the eval's sums once each.

At fit start, as the JAX loop does, it writes the model-graph artifacts
(``analysis/graph_render.py``): ``model_graph.txt``, ``model_graph.png``
and ``<experiment>_encoder_block.png``, from the module tree traced on fake
tensors (no device work), and, except on dry runs, ``input_grid.png`` of
the first ten training images.  Only the drawing sits in a ``try``, so
that a drawing failure (matplotlib missing) is printed and never stops
training.

On a mesh over ``data``, ``model``, ``expert``, ``pipe`` and ``seq``
(``--mesh-shape``, ``--mesh-axes``; one process per device under torchrun,
``--multihost`` joining the process group first; ``parallel/``) the batch
sizes must divide the data axis, a ``seq`` axis cuts the token stream
(``sequence.seq_parallel_model``) and a ``pipe`` axis pipelines the trunk
(``pipeline.pipeline_model``, ``--pipeline-microbatches``; both batch sizes
are checked against the microbatches up front), the two refused together
as in JAX; the model is laid out by ``shard_params`` after init and after
resume, and rank 0 alone logs, writes metrics, histograms (of the gathered
weights), graph artifacts and checkpoints, which keep the one-device
layout: sharded parameters and both moments are gathered before the write,
and a resume on any mesh takes each rank's block of them.  The parameter
count, the summary and the graph are the one-device model's, and the
layer-output histograms run its forward on every rank
(``mesh.one_device_forward``).

``--semi-supervised`` (c10 only, utils.py:404-416) trains on the
400-per-class labeled split of ``semi_supervised_split``; with
``ss_combined_epoch`` an epoch runs |unlabeled| // |labeled| passes over
it, each with its own permutation (the reference's CombinedLoader is paced
by the larger loader, utils.py:419-436), and the schedule counts those
steps as the epoch's.  The unlabeled batches feed a no-op hook in the
reference (network.py:213-214), so nothing is computed for them.  The TPU
relay's knobs (``compile_cache_dir``, ``donate_buffers``) and the switches
of paths the port always takes (``device_data``, ``flat_optimizer``,
``use_pallas``) are accepted and ignored, and the JAX step's
``contiguous_batches`` has no counterpart (ROADMAP "Not to port").
"""

from __future__ import annotations

import math
import os
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config, torch_dtype
from ..data.augment import augment_dataset, normalize
from ..data.autoaugment import policy_for_dataset
from ..data.datasets import load_dataset, semi_supervised_split
from ..models import get_model
from ..parallel.mesh import (Mesh, ParamLayout, initialize_multihost,
                             make_mesh, one_device_forward, shard_params)
from ..parallel.pipeline import has_pipe_axis, pipeline_model
from ..parallel.sequence import has_seq_axis, seq_parallel_model
from ..utils.logging import get_experiment_name, make_logger
from ..utils.observability import (get_layer_outputs, log_histograms,
                                   model_summary, profile_trace)
from .checkpoint import BestCheckpointer, load_checkpoint
from .optim import (FlatOptimizer, flatten_params, make_optimizer,
                    warmup_cosine_epoch_schedule)
from .state import TrainState
from .steps import make_eval_step, make_metrics_zeros, make_train_step
from .unsupervised import make_unsupervised_update, uses_unsupervised


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def init_state(cfg: Config, model: torch.nn.Module,
               tx: FlatOptimizer) -> TrainState:
    """The state of a fresh run: ``model``'s parameters become views of one
    flat f32 vector on their device, the optimizer states (the AE-internal
    one too, with ``--unsupervised-steps``) start at zero, and every random
    draw of the steps comes from a generator on that device seeded with
    ``cfg.seed``."""
    params = flatten_params(model)
    gen = torch.Generator(device=params.device).manual_seed(cfg.seed)
    ae_opt_state = (make_unsupervised_update(cfg, model)[0](params)
                    if uses_unsupervised(cfg) else None)
    return TrainState(step=0, model=model, params=params,
                      opt_state=tx.init(params), generator=gen,
                      ae_opt_state=ae_opt_state)


def _full_payload(state: TrainState, epoch: int, best_val_loss: float,
                  layout: ParamLayout | None = None) -> dict[str, Any]:
    """Everything a resumed run needs, as Lightning's checkpoints embed the
    optimizer and scheduler state: the weights (named views of one copy of
    the flat vector, so they are stored once and load as the model's state
    dict), the model's buffers where it has any (``model_state``), the
    optimizer state (count and moments) and the AE-internal one where there
    is one, the step, the epoch, the best val_loss and the generator's
    state.  The lr needs no state of its own: the schedule is a function of
    the restored count.  With a ``layout`` the weights and moments are
    gathered to the one-device layout (every rank takes part)."""
    if layout is None:
        flat = state.params.detach().to("cpu", copy=True)
        params, offset = {}, 0
        for name, p in state.model.named_parameters():
            params[name] = flat[offset:offset + p.numel()].view(p.shape)
            offset += p.numel()
        opt_state = state.opt_state
    else:
        params = _to_cpu(layout.full_named(
            layout.split_flat(state.params.detach())))
        opt_state = {k: v if v.dim() == 0 else layout.full_flat(v)
                     for k, v in state.opt_state.items()}
    payload = {"params": params,
               "opt_state": _to_cpu(opt_state),
               "step": state.step, "epoch": epoch,
               "best_val_loss": float(best_val_loss),
               "generator": state.generator.get_state()}
    if state.ae_opt_state is not None:
        payload["ae_opt_state"] = _to_cpu(state.ae_opt_state)
    buffers = dict(state.model.named_buffers())
    if buffers:
        payload["model_state"] = _to_cpu(buffers)
    return payload


def _to_cpu(tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _restore_state(cfg: Config, state: TrainState,
                   layout: ParamLayout | None = None):
    """Load the last checkpoint of ``cfg.resume`` into a fresh state, in
    place; returns (state, the epoch to start at).  The checkpoint keeps
    the one-device layout; with a ``layout`` each rank takes its block."""
    payload, _ = load_checkpoint(cfg.resume, prefer="last")
    dev = state.params.device
    local = ((lambda name, t: t) if layout is None else layout.local)
    with torch.no_grad():
        state.params.copy_(torch.cat([
            local(name, payload["params"][name]).reshape(-1)
            for name, _ in state.model.named_parameters()]))
    state.opt_state = {
        k: (v if layout is None or v.dim() == 0
            else layout.local_flat(v)).to(dev)
        for k, v in payload["opt_state"].items()}
    if "ae_opt_state" in payload:
        state.ae_opt_state = {k: v.to(dev)
                              for k, v in payload["ae_opt_state"].items()}
    with torch.no_grad():
        for name, buf in state.model.named_buffers():
            buf.copy_(payload["model_state"][name])
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    return state, int(payload["epoch"]) + 1


def _pad_eval(x: np.ndarray, y: np.ndarray, batch: int):
    """Pad eval data to a whole number of batches; returns (x, y, mask,
    steps)."""
    n = len(x)
    steps = -(-n // batch)
    pad = steps * batch - n
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        y = np.concatenate([y, np.zeros((pad,), y.dtype)])
    return x, y, mask, steps


def _check_run_supported(cfg: Config) -> None:
    sizes = dict(zip(cfg.mesh_axes, cfg.mesh_shape))
    if sizes.get("seq", 1) > 1 and sizes.get("pipe", 1) > 1:
        # the two split the same stack (its tokens, its depth), and the
        # cut stream runs only on the whole trunk, as in JAX
        raise ValueError(
            "mesh has both 'seq' and 'pipe' axes > 1; sequence and "
            "pipeline parallelism do not compose — pick one (plus "
            "data/model axes).")
    if cfg.semi_supervised and cfg.dataset != "c10":
        # parity: only c10 is implemented (utils.py:404-416)
        raise NotImplementedError(
            f"{cfg.dataset} is not implemented yet for semi-supervised.")


def _check_batches(cfg: Config, n_data: int) -> None:
    """The train and eval batches are cut over the data axis
    (``steps.make_batch``, ``steps.make_eval_step``)."""
    for label, b in (("batch_size", cfg.batch_size),
                     ("eval_batch_size", cfg.eval_batch_size)):
        if b % n_data:
            raise ValueError(f"{label}={b} must divide over the data axis "
                             f"of {n_data} devices")


def parallel_model(cfg: Config, model: torch.nn.Module,
                   mesh: Mesh | None) -> torch.nn.Module:
    """``model`` with the ``seq`` and ``pipe`` hooks of ``mesh``, as the
    JAX loop clones and wraps it; both batch sizes are checked against the
    pipeline's microbatches a data shard."""
    if has_seq_axis(mesh):
        model = seq_parallel_model(model, mesh)
    if has_pipe_axis(mesh):
        model = pipeline_model(model, mesh, cfg.pipeline_microbatches)
        n_data, M = mesh.shape.get("data", 1), model.pipeline.microbatches
        for label, b in (("batch_size", cfg.batch_size),
                         ("eval_batch_size", cfg.eval_batch_size)):
            if (b // n_data) % M:
                raise ValueError(
                    f"{label}={b}: per-data-shard batch {b // n_data} must "
                    f"divide into {M} pipeline microbatches")
    return model


def train(cfg: Config, verbose: bool = True, stop_after: int | None = None,
          *, device="cuda") -> dict[str, Any]:
    """Train ``cfg`` on ``device`` (default the CUDA card; pass
    ``device="cpu"`` for the CPU) and return the run's result dict.

    ``stop_after`` stops after that (absolute) epoch has finished, as a
    preemption would, without changing the lr schedule (which depends on
    ``max_epochs``).  ``cfg.matmul_precision`` is set with
    ``torch.set_float32_matmul_precision`` for the run, and the previous
    setting is restored on return."""
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(cfg.matmul_precision)
    try:
        return _train(cfg, verbose, stop_after, torch.device(device))
    finally:
        torch.set_float32_matmul_precision(previous)


def _log_graph_artifacts(cfg: Config, model, logger, experiment: str,
                         train_x: np.ndarray, device: torch.device) -> None:
    """The model-graph artifacts (the torchview.draw_graph equivalents,
    network.py:397-452) and the input grid (skipped on dry runs), as the
    JAX loop writes them; only the drawing is in a ``try``."""
    from ..analysis.graph_render import (encoder_block_rows, graph_table,
                                         module_rows, render_graph)

    sample = torch.zeros((2, cfg.img_size, cfg.img_size, cfg.in_c),
                         device=device)
    rows = module_rows(model, sample, depth=5, deterministic=True)
    logger.log_text("model_graph.txt", graph_table(rows, depth=4))
    enc = encoder_block_rows(rows)
    try:
        render_graph([r for r in rows if len(r.path) <= 2],
                     os.path.join(logger.dir, "model_graph.png"))
        if enc is not None:
            render_graph(enc, os.path.join(
                logger.dir, f"{experiment}_encoder_block.png"))
    except Exception as e:  # drawing must never stop training
        print(f"[vit_cifar_torch] model graph logging failed: {e}")
    if enc is None:
        # reference behavior for models without an encoder stack
        print("[WARNING] Failed to draw encoder graph.")
    if cfg.dry_run:
        return
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 5, figsize=(8, 3.5))
        for i, ax in enumerate(axes.flat):
            ax.imshow(train_x[i])
            ax.set_xticks([])
            ax.set_yticks([])
        fig.tight_layout()
        fig.savefig(os.path.join(logger.dir, "input_grid.png"), dpi=100)
        plt.close(fig)
    except Exception as e:  # matplotlib issues must never stop training
        print(f"[vit_cifar_torch] input grid logging failed: {e}")


def _train(cfg: Config, verbose: bool, stop_after: int | None,
           device: torch.device) -> dict[str, Any]:
    _check_run_supported(cfg)
    if cfg.multihost:
        topo = initialize_multihost(device=device)
        if verbose:
            print(f"[multihost] {topo}")
    mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axes, device)
    _check_batches(cfg, mesh.shape.get("data", 1) if mesh else 1)
    lead = mesh is None or mesh.rank == 0  # logs and writes
    raw = load_dataset(cfg.dataset, cfg.data_dir, cfg.synthetic_data)
    train_x, train_y, test_x, test_y = (raw.x_train, raw.y_train,
                                        raw.x_test, raw.y_test)
    epoch_passes = 1
    if cfg.semi_supervised:
        splits = semi_supervised_split(raw)
        train_x, train_y = splits["labeled"]
        test_x, test_y = splits["test"]
        if cfg.ss_combined_epoch:
            epoch_passes = max(1, len(splits["unlabeled"][0]) // len(train_x))
    experiment = [get_experiment_name(cfg)]
    if mesh is not None:  # the name has a random part: rank 0's is it
        dist.broadcast_object_list(experiment, src=0)
    experiment = experiment[0]
    logger = make_logger(cfg, experiment) if lead else None
    verbose = verbose and lead

    model, _ = get_model(cfg, device=device)
    steps_per_epoch = len(train_x) // cfg.batch_size
    # the schedule's epoch is count // sched_steps: the optimizer steps of
    # a whole epoch, all its passes
    sched_steps = steps_per_epoch * epoch_passes
    # the one-device model's count, summary and graph, before the layout
    # cuts it
    n_params = count_params(model)
    if lead:
        logger.log_text("config.json", cfg.to_json())
        logger.log(0, 0, trainable_params=n_params, total_params=n_params)
        summary = model_summary(model.named_parameters(),
                                cfg.model_summary_depth)
        logger.log_text("model_summary.txt", summary)
        _log_graph_artifacts(cfg, model, logger, experiment, train_x, device)
    model = parallel_model(cfg, model, mesh)
    layout = shard_params(mesh, model)
    tx = make_optimizer(cfg, sched_steps, model)
    state = init_state(cfg, model, tx)
    start_epoch = 0
    if cfg.resume:
        state, start_epoch = _restore_state(cfg, state, layout)
        if verbose:
            print(f"[resume] restored {cfg.resume}, continuing at epoch "
                  f"{start_epoch}")
    if verbose:
        where = device if mesh is None else f"mesh {mesh.shape} ({device})"
        print(f"[{experiment}] params: {n_params:,} | device: {where} | "
              f"steps/epoch: {steps_per_epoch}")
        print(summary)

    x_train = torch.from_numpy(train_x).to(device)
    y_train = torch.from_numpy(train_y).to(device)
    *test, eval_steps = _pad_eval(test_x, test_y, cfg.eval_batch_size)
    x_test, y_test, eval_mask = (torch.from_numpy(a).to(device) for a in test)
    state.metrics_acc = make_metrics_zeros(cfg, device)

    max_epochs = 1 if cfg.dry_run else cfg.max_epochs
    epoch_steps = 1 if cfg.dry_run else steps_per_epoch
    n_eval_steps = 1 if cfg.dry_run else eval_steps
    train_step = make_train_step(cfg, model, tx,
                                 pre_augmented=cfg.preaugment_epoch,
                                 mesh=mesh)
    eval_step = make_eval_step(cfg, model, mesh)
    aa_policy = policy_for_dataset(cfg.dataset) if cfg.autoaugment else None
    passes = 1 if cfg.dry_run else epoch_passes
    lr_sched = warmup_cosine_epoch_schedule(
        cfg.lr, cfg.min_lr, cfg.warmup_epoch, cfg.max_epochs, sched_steps)
    # the NNMF parameter group's lr under madam (network.py:98-105)
    lr_sched_nnmf = warmup_cosine_epoch_schedule(
        cfg.lr_nnmf, cfg.min_lr, cfg.warmup_epoch, cfg.max_epochs,
        sched_steps) if cfg.optimizer == "madam" else None
    # the fixed 10-image probe of the layer-output histograms (main.py:
    # 187-194, ``_sample_input_data``)
    probe_img = normalize(x_train[:10], cfg.mean, cfg.std).to(
        torch_dtype(cfg))
    # the reference emits histograms to Comet every epoch; the CSV path
    # writes .npz snapshots on a bounded cadence
    hist_every = 1 if cfg.comet_api_key else max(1, cfg.max_epochs // 10)
    names = [n for n, _ in model.named_parameters()]

    def whole(tree: dict) -> dict:
        """Named parameter-shaped tensors in the one-device layout."""
        return tree if layout is None else layout.full_named(tree)

    ckpt = BestCheckpointer(cfg.ckpt_dir, experiment, cfg, write=lead)
    if cfg.resume:
        ckpt.seed_best_from(cfg.resume)

    def run_eval():
        """(val_loss, val_acc, any parameter NaN), in one host read."""
        eb = cfg.eval_batch_size
        sums = torch.zeros(3, device=device)
        for b in range(n_eval_steps):
            sl = slice(b * eb, (b + 1) * eb)
            out = eval_step(x_test[sl], y_test[sl], eval_mask[sl])
            sums += torch.stack([out["loss_sum"], out["correct_sum"],
                                 out["count"]])
        nan = torch.isnan(state.params).any().to(sums.dtype)
        if mesh is not None:  # each rank holds its own shards
            mesh.world.all_reduce_(nan)
        loss_sum, correct, count, nan = torch.cat([sums, nan[None]]).tolist()
        return loss_sum / count, correct / count, bool(nan)

    history = []
    t_start = time.time()
    images_seen = 0
    last_epoch = max_epochs - 1
    for epoch in range(start_epoch, max_epochs):
        t_ep = time.time()
        perm = torch.randperm(len(x_train), generator=state.generator,
                              device=device)
        x_epoch = x_train
        if cfg.preaugment_epoch:
            x_epoch = augment_dataset(state.generator, x_train, cfg.padding,
                                      flip=cfg.dataset != "svhn",
                                      autoaugment_policy=aa_policy)
        # one steady epoch under the profiler
        profiled = bool(cfg.profile_dir) and epoch == min(1, max_epochs - 1)
        n_steps = epoch_steps * passes
        with profile_trace(cfg.profile_dir if profiled else ""):
            # passes > 1 only under semi-supervised pacing: the labeled
            # split again, with a new permutation
            for p in range(passes):
                if p:
                    perm = torch.randperm(len(x_train),
                                          generator=state.generator,
                                          device=device)
                for i in range(epoch_steps):
                    gstep = (epoch * passes + p) * epoch_steps + i
                    if (cfg.log_gradients and not cfg.dry_run
                            and gstep % cfg.log_gradients_interval == 0):
                        # the very gradients of this step: the generator
                        # and the buffers are rewound so that the step
                        # draws the same batch from the same state
                        rewind = state.generator.get_state()
                        buffers = [b.clone() for b in model.buffers()]
                        batch = train_step.make_batch(state, x_epoch,
                                                      y_train, perm, i)
                        grads = train_step.loss_and_grads(state, *batch)[2]
                        state.generator.set_state(rewind)
                        with torch.no_grad():
                            for b, old in zip(model.buffers(), buffers):
                                b.copy_(old)
                        grads = whole(dict(zip(names, grads)))
                        if lead:
                            log_histograms(logger, grads, "grads", gstep,
                                           epoch)
                    state, _ = train_step(state, x_epoch, y_train, perm, i)
            # epoch means of the metrics the step accumulates; also syncs
            keys = list(state.metrics_acc)
            sums = torch.stack([state.metrics_acc[k] for k in keys]).tolist()
        metrics = {k: v / n_steps for k, v in zip(keys, sums)}
        state.metrics_acc = {k: torch.zeros_like(v)
                             for k, v in state.metrics_acc.items()}
        images_seen += n_steps * cfg.batch_size
        ep_time = time.time() - t_ep

        t_eval = time.time()
        val_loss, val_acc, param_nan = run_eval()
        eval_time = time.time() - t_eval
        # before the histograms, as the reference orders them
        if param_nan:
            raise ValueError(f"[ERROR] NaN parameter detected at epoch "
                             f"{epoch}. Training stopped.")
        if cfg.log_weights and not cfg.dry_run and epoch % hist_every == 0:
            weights = whole(dict(model.named_parameters()))
            if lead:
                log_histograms(logger, weights, "weights", epoch, epoch)
            try:
                # every rank runs the probe: a sharded forward's
                # collectives need all of them
                with one_device_forward(model):
                    outs = get_layer_outputs(model, probe_img)
                if lead:
                    log_histograms(logger, outs, "layer_outputs", epoch,
                                   epoch)
            except Exception as e:  # the reference's IndexError fallback
                print(f"[vit_cifar_torch] layer-output histograms failed: "
                      f"{e}")
        first = torch.tensor(epoch * sched_steps + 1)
        row = dict(
            loss=metrics["loss"], acc=metrics["acc"], val_loss=val_loss,
            val_acc=val_acc, lr_0=float(lr_sched(first)),
            epoch_time=round(ep_time, 3), eval_time=round(eval_time, 3),
            images_per_sec=round(
                n_steps * cfg.batch_size / max(ep_time, 1e-9), 1))
        if lr_sched_nnmf is not None:
            row["lr_1"] = float(lr_sched_nnmf(first))
        # moe_aux: the epoch's mean Switch balance loss (1.0 = balanced)
        for k in ("unsupervised_loss", "skipped_nonfinite", "moe_aux"):
            if k in metrics:
                row[k] = metrics[k]
        history.append(row)
        if lead:
            logger.log(state.step, epoch, **row)
            logger.flush()
        if verbose:
            print(f"epoch {epoch:3d} | loss {row['loss']:.4f} acc "
                  f"{row['acc']:.4f} | val_loss {val_loss:.4f} val_acc "
                  f"{val_acc:.4f} | {row['images_per_sec']:.0f} img/s")
        if val_loss < ckpt.best_val_loss:  # the payload only on improvement
            ckpt.maybe_save_best(val_loss, epoch,
                                 _full_payload(state, epoch, val_loss,
                                               layout))
        last_epoch = epoch
        if stop_after is not None and epoch + 1 >= stop_after:
            break

    if not history:
        # resume of a finished run: evaluate the restored model
        val_loss, val_acc, _ = run_eval()
        history.append(dict(val_loss=val_loss, val_acc=val_acc,
                            loss=math.nan, acc=math.nan, lr_0=0.0,
                            epoch_time=0.0, eval_time=0.0,
                            images_per_sec=0.0))
        if verbose:
            print(f"[resume] nothing left to train (epoch {start_epoch} >= "
                  f"{max_epochs}); evaluated restored model: val_loss="
                  f"{val_loss:.4f} val_acc={val_acc:.4f}")

    total_time = time.time() - t_start
    ckpt.save_last(_full_payload(state, last_epoch, ckpt.best_val_loss,
                                 layout))
    if getattr(logger, "comet", None) is not None:  # main.py:239-242
        try:
            logger.comet.log_model(experiment, ckpt.root)
        except Exception as e:
            print(f"[vit_cifar_torch] comet model upload failed: {e}")
    if lead:
        logger.finalize()
    return {
        "experiment": experiment,
        "history": history,
        "val_loss": history[-1]["val_loss"],
        "val_acc": history[-1]["val_acc"],
        "best_val_loss": ckpt.best_val_loss,
        "total_time_s": total_time,
        "images_per_sec": images_seen / max(total_time, 1e-9),
        "n_params": n_params,
        "ckpt_dir": ckpt.root,
        "log_dir": os.path.join(cfg.log_dir, experiment),
        "synthetic_data": raw.synthetic,
    }
