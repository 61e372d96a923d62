"""The train and eval steps, as ``vit_cifar_tpu/train/steps.py``.

The dataset is resident on the device as uint8; a step receives the
epoch's permutation and its index in the epoch, gathers its batch, and
augments it on the device in the reference's order (utils.py:337-367):
random crop/flip -> AutoAugment -> normalize -> RandomCropPaste -> CutMix,
or MixUp behind the p=0.8 gate -> cast to the compute dtype.  With
``pre_augmented`` the crop/flip and AutoAugment already ran once for the
epoch over the whole dataset (``augment.augment_dataset``) and the step
skips them.  Then the forward
in training mode, the lambda-mixed criterion, the backward, the non-finite
guard and the optimizer update on the flat parameter vector.  Metrics stay
on the device; no step reads anything back to the host.

Parity details (reference network.py:149-220, 388-395):
  * mixup is applied with probability 0.8; otherwise lambda=1 and the
    random label is all zeros, without data-dependent control flow;
  * mixed loss = lam * CE(out, y) + (1 - lam) * CE(out, y_rand);
  * accuracy is measured against the original labels;
  * the guard skips a step whose loss or any gradient is not finite: the
    parameters, both moments and the optimizer's count (hence the lr) keep
    their old values.

The AE family (JAX :32-50, :232-262): the forward's AE tensors, collected
from the mixers, feed the ``aece`` criterion; with ``--unsupervised-steps``
the AE-internal steps run BEFORE the main update, which is computed from the
forward's gradients and added on top of the AE-updated values.  Parameters
outside the loss's graph (the AE and ``norm1`` under ``ce``: z and the
softmax are detached) get zero gradients, and under ``ae`` + ``ce`` the
decay term sees those entries as zero (``optim.frozen_mask``), so that the
main update leaves them exactly where the AE steps put them.

NNMF (JAX :352-372): after the update and the guard's ``torch.where``,
every trainable ``nnmf_weights`` gets the after-care (norm -> clamp at
``nnmf_learning_rate_threshold_w`` -> norm), on a skipped step too, as in
JAX; that includes the heads AE's weight under ``ae`` + ``ce``, which the
main optimizer leaves alone.  The model's buffers (the persistent bases of
``--train-md-bases`` and BatchNorm's running statistics, JAX's
``model_state``) are written by the forward in training mode and are not
rolled back by the guard, as in JAX.

MoE (JAX :96-97, :194-199, :380-382): ``cfg.moe_aux_weight`` times the mean
over layers of the Switch aux loss is added to the loss, after the
CutMix/MixUp lambda mix, and reported as the metric ``moe_aux``.

The batch is a seam: ``train_step.make_batch`` gathers and augments, and
``train_step.on_batch`` trains on a batch it is handed, so a test can feed
it the JAX package's augmented batch.  ``train_step.loss_and_grads`` is the
forward and backward of ``on_batch`` alone (the loop's gradient
histograms).

On a mesh (``parallel/mesh.py``), as GSPMD runs JAX's step: every rank
builds the global batch from the same generator and permutation and keeps
its rows of the data axis (mixup and cutmix pair rows across the whole
batch, and the crop, flip and AutoAugment draws are made per global row);
the flat gradient, with the loss and accuracy appended, takes one mean
over the data axis; the guard's verdict is taken over every rank, since
model and expert ranks hold different shards; the eval step evaluates the
rank's rows and sums the masked sums over the data axis.  Where the model
splits each example's work over a ``pipe`` or ``seq`` axis
(``mesh.trunk_split``: the pipelined training route, or the cut token
stream), each rank's part of the flat gradient is first summed over that
axis, with the head, the loss and the accuracy, which every rank of it
computes whole, counted once; on the pipe axis's sequential route (a
model with state or AE intermediates) every rank computes the whole
gradient and nothing is summed over ``pipe``.  The eval step's forward is
pipelined or cut alike, and its logits are whole on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import Config, torch_dtype
from ..data import augment
from ..data.autoaugment import autoaugment_batch, policy_for_dataset
from ..ops.moe import collect_moe_aux
from ..ops.nnmf.layers import (nnmf_after_care, nnmf_slices,
                               nnmf_weight_trainable)
from ..parallel.mesh import Mesh, trunk_split
from .losses import make_criterion, make_per_example_loss
from .optim import FlatOptimizer, frozen_mask
from .state import TrainState
from .unsupervised import (collect_ae_terms, make_unsupervised_update,
                           uses_unsupervised)


def uses_moe_aux(cfg: Config) -> bool:
    """Whether the loss has the Switch balance term (and the metrics
    ``moe_aux``), as JAX's ``needs_moe_aux``."""
    return cfg.moe_experts > 0 and cfg.moe_aux_weight > 0


def make_metrics_zeros(cfg: Config,
                       device="cuda") -> dict[str, torch.Tensor]:
    """Zero accumulator matching the train step's metrics, on ``device``
    (default the CUDA card; pass ``device="cpu"`` for the CPU)."""
    names = ["loss", "acc"]
    if cfg.nonfinite_guard:
        names.append("skipped_nonfinite")
    if uses_unsupervised(cfg):
        names.append("unsupervised_loss")
    if uses_moe_aux(cfg):
        names.append("moe_aux")
    return {n: torch.zeros((), dtype=torch.float32, device=device)
            for n in names}


def make_train_step(cfg: Config, model, tx: FlatOptimizer,
                    pre_augmented: bool = False,
                    mesh: Mesh | None = None) -> Callable:
    """``train_step(state, x_all, y_all, perm, i) -> (state, metrics)``.

    ``x_all`` (N, H, W, C) uint8 and ``y_all`` (N,) are the dataset on the
    device, ``perm`` the epoch's permutation (on the device) and ``i`` the
    step's index in the epoch.  ``state`` (whose ``model`` is ``model``)
    is updated in place and returned.  With ``pre_augmented`` the step
    takes ``x_all`` as already cropped, flipped and AutoAugmented.  On a
    ``mesh`` (``model`` laid out by ``shard_params``) the metrics are the
    global ones.
    """
    criterion = make_criterion(cfg)
    dtype = torch_dtype(cfg)
    B = cfg.batch_size
    needs_ae = cfg.criterion == "aece"
    moe_aux = uses_moe_aux(cfg)
    unsupervised = uses_unsupervised(cfg)
    data = None if mesh is None else mesh.axis("data")
    world = None if mesh is None else mesh.world
    split = trunk_split(model)
    run_ae_steps = (make_unsupervised_update(cfg, model, data)[1]
                    if unsupervised else None)
    frozen = frozen_mask(cfg, model)
    after_care = nnmf_slices(model, trainable=lambda names: (
        nnmf_weight_trainable(names, cfg.train_md_bases)))

    def make_batch(state: TrainState, x_all, y_all, perm, i: int):
        """Gather and augment step ``i``'s batch: (img in the compute
        dtype, label, rand_label or None, lam or None); on a mesh the
        rank's rows of the global batch."""
        gen = state.generator
        idx = perm[i * B:(i + 1) * B]
        img, label = x_all.index_select(0, idx), y_all.index_select(0, idx)
        if not pre_augmented:
            img = augment.random_crop_flip(gen, img, cfg.padding,
                                           flip=cfg.dataset != "svhn")
            if cfg.autoaugment:
                img = autoaugment_batch(gen, img,
                                        policy_for_dataset(cfg.dataset))
        img = augment.normalize(img, cfg.mean, cfg.std)
        if cfg.rcpaste:
            img = augment.random_crop_paste(gen, img)
        rand_label = lam = None
        if cfg.cutmix:
            img, label, rand_label, lam = augment.cutmix(gen, img, label,
                                                         cfg.img_size)
        elif cfg.mixup:
            mixed, _, rand_m, lam_m = augment.mixup(gen, img, label)
            gate = augment.uniform(gen) <= 0.8
            img = torch.where(gate, mixed, img)
            rand_label = torch.where(gate, rand_m, torch.zeros_like(label))
            lam = torch.where(gate, lam_m, torch.ones_like(lam_m))
        if data is not None:
            img, label = data.block(img, 0), data.block(label, 0)
            if rand_label is not None:
                rand_label = data.block(rand_label, 0)
        return img.to(dtype), label, rand_label, lam

    def forward_backward(state: TrainState, img, label, rand_label, lam):
        """(flat gradient, loss, accuracy, logits, the MoE aux loss or
        None) of a given batch, in training mode; on a mesh the gradient,
        loss and accuracy are the means over the data axis."""
        logits = model(img, deterministic=False, generator=state.generator)
        aux = {"ae": collect_ae_terms(model)} if needs_ae else None
        loss = criterion(logits, label, aux)
        if rand_label is not None:
            loss = loss * lam + criterion(logits, rand_label, aux) * (1.0 - lam)
        balance = None
        if moe_aux:
            # the Switch balance term, read from this forward (not from a
            # --remat recomputation) and not lambda-weighted: routing
            # balance does not depend on the labels
            balance = collect_moe_aux(model)
            loss = loss + cfg.moe_aux_weight * balance
        params = list(model.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            acc = (logits.argmax(-1) == label).float().mean()
            flat = torch.cat([(torch.zeros_like(p) if g is None else g)
                              .reshape(-1) for p, g in zip(params, grads)]
                             + [loss.detach()[None], acc[None]])
            del grads
            if split is not None:  # each rank's part, the head's once
                axis, keep = split
                flat = axis.all_reduce_(torch.where(keep, flat, 0.0))
            if data is not None:  # GSPMD's psum of the gradient
                data.all_reduce_(flat).div_(data.size)
        return (flat[:-2], flat[-2].clone(), flat[-1].clone(),
                logits.detach(),
                None if balance is None else balance.detach())

    def loss_and_grads(state: TrainState, img, label, rand_label=None,
                       lam=None):
        """(loss, logits, one gradient per parameter, the MoE aux loss or
        None) of a given batch, in training mode; dropout and the random AE
        mask draw from the state's generator.  A parameter outside the
        loss's graph gets zeros.  On a mesh the loss and gradients are the
        means over the data axis."""
        flat_g, loss, _, logits, balance = forward_backward(
            state, img, label, rand_label, lam)
        grads, offset = [], 0
        for p in model.parameters():
            grads.append(flat_g[offset:offset + p.numel()].view_as(p))
            offset += p.numel()
        return loss, logits, grads, balance

    def on_batch(state: TrainState, img, label, rand_label=None, lam=None):
        """Forward, loss, backward, guard and update on a given batch."""
        flat_g, loss, acc, _, balance = forward_backward(
            state, img, label, rand_label, lam)
        # the AE-internal steps first: they write the AE entries of
        # state.params, on which the main update then lands
        unsup_loss = run_ae_steps(state) if unsupervised else None
        with torch.no_grad():
            if cfg.nonfinite_guard:
                ok = torch.isfinite(loss) & torch.isfinite(flat_g).all()
                if world is not None:  # one rank's NaN skips every rank
                    bad = world.all_reduce_((~ok).to(torch.float32))
                    ok = bad == 0
                flat_g = torch.where(ok, flat_g, torch.zeros_like(flat_g))
            decay_params = state.params if frozen is None else torch.where(
                frozen, torch.zeros_like(state.params), state.params)
            updates, opt_state = tx.update(flat_g, state.opt_state,
                                           decay_params)
            new_params = state.params + updates
            metrics = {"loss": loss, "acc": acc}
            if cfg.nonfinite_guard:
                # zeroed grads still move the moments and the count: keep
                # the old state entirely on a skipped step
                new_params = torch.where(ok, new_params, state.params)
                opt_state = {k: torch.where(ok, v, state.opt_state[k])
                             for k, v in opt_state.items()}
                metrics["skipped_nonfinite"] = 1.0 - ok.float()
            if unsupervised:
                metrics["unsupervised_loss"] = unsup_loss
            if moe_aux:
                # router balance: 1.0 is perfectly balanced experts
                metrics["moe_aux"] = balance
            state.params.copy_(new_params)  # the model's weights are views
            nnmf_after_care(state.params, after_care,
                            cfg.nnmf_learning_rate_threshold_w)
            state.opt_state = opt_state
            if state.metrics_acc is not None:
                state.metrics_acc = {k: a + metrics[k].to(a.dtype)
                                     for k, a in state.metrics_acc.items()}
        state.step += 1
        return state, metrics

    def train_step(state: TrainState, x_all, y_all, perm, i: int):
        return on_batch(state, *make_batch(state, x_all, y_all, perm, i))

    train_step.make_batch = make_batch
    train_step.loss_and_grads = loss_and_grads
    train_step.on_batch = on_batch
    return train_step


def make_eval_step(cfg: Config, model, mesh: Mesh | None = None) -> Callable:
    """``eval_step(img_u8, label, mask) -> {loss_sum, correct_sum, count}``,
    masked sums over one batch on the device, from ``model``'s current
    weights, with no gradient (the inference kernel).  On a ``mesh`` each
    rank evaluates its rows of the batch and the sums are the global
    ones."""
    per_example_loss = make_per_example_loss(cfg)
    dtype = torch_dtype(cfg)
    data = None if mesh is None else mesh.axis("data")

    @torch.no_grad()
    def eval_step(img, label, mask):
        if data is not None:
            img, label, mask = (data.block(t, 0) for t in (img, label, mask))
        x = augment.normalize(img, cfg.mean, cfg.std).to(dtype)
        logits = model(x, deterministic=True)
        per_ex = per_example_loss(logits, label)
        correct = (logits.argmax(-1) == label).to(torch.float32)
        m = mask.to(torch.float32)
        sums = {"loss_sum": torch.sum(per_ex * m),
                "correct_sum": torch.sum(correct * m),
                "count": torch.sum(m)}
        if data is None:
            return sums
        total = data.all_reduce_(torch.stack(list(sums.values())))
        return dict(zip(sums, total))

    return eval_step
