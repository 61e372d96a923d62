"""Loss functions, as ``vit_cifar_tpu/train/losses.py``.

``label_smoothing_cross_entropy`` is the reference's (criterions.py:5-19):
the off-target mass is ``smoothing/(classes-1)`` and the target gets
``1-smoothing``.  torch's ``cross_entropy(label_smoothing=...)`` puts
``smoothing/classes`` on every class, so it is not used.  Logits are taken
to f32 before the log-softmax.

``aece`` (criterions.py:22-61) is plain CE plus a sparse-autoencoder term
per AE block: ``MSE(out, in) + l1_reg * L1``, where L1 always holds
``L1(out, in)`` and, with ``aece_l1_outputs``, the L1-to-zero of the hidden
and output activations.  The AE tensors arrive as ``aux["ae"]``, a list of
(hidden, input, output) triples that the train step collects from the AE
mixers after the forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import Config


def _smoothed_nll(logp: torch.Tensor, labels: torch.Tensor,
                  smoothing: float) -> torch.Tensor:
    """Per-example sum of -true_dist * logp, with true_dist
    ``smoothing/(C-1)`` off the target and ``1-smoothing`` on it."""
    off = smoothing / (logp.shape[-1] - 1)
    true_dist = torch.full_like(logp, off)
    true_dist.scatter_(-1, labels[:, None].long(), 1.0 - smoothing)
    return torch.sum(-true_dist * logp, dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(logp.gather(-1, labels[:, None].long()))


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  num_classes: int,
                                  smoothing: float) -> torch.Tensor:
    """criterions.py:5-19 exactly: off = smoothing/(C-1), on-target =
    1-smoothing."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    if logp.shape[-1] != num_classes:
        raise ValueError(f"{logp.shape[-1]} logits for {num_classes} classes")
    return torch.mean(_smoothed_nll(logp, labels, smoothing))


def sparse_autoencoder_loss(ae_hidden, ae_input, ae_output,
                            l1_regularization: float,
                            l1_outputs: bool) -> torch.Tensor:
    """criterions.py:48-61, in f32."""
    hidden, inp, out = (t.to(torch.float32)
                        for t in (ae_hidden, ae_input, ae_output))
    mse = torch.mean((out - inp) ** 2)
    l1 = torch.mean(torch.abs(out - inp))
    if l1_outputs:
        l1 = l1 + torch.mean(torch.abs(hidden)) + torch.mean(torch.abs(out))
    return mse + l1_regularization * l1


def make_per_example_loss(cfg: Config):
    """Per-example criterion for the masked eval sums (plain CE under
    ``aece``, as in the JAX package)."""
    use_smoothing = cfg.criterion == "ce" and cfg.label_smoothing

    def per_example(logits: torch.Tensor, labels: torch.Tensor):
        logp = F.log_softmax(logits.to(torch.float32), dim=-1)
        if use_smoothing:
            return _smoothed_nll(logp, labels, cfg.smoothing)
        return -logp.gather(-1, labels[:, None].long())[:, 0]

    return per_example


def make_criterion(cfg: Config):
    """``loss_fn(logits, labels, aux=None)`` of ``cfg.criterion``."""
    if cfg.criterion == "ce":
        if cfg.label_smoothing:
            def ce(logits, labels, aux=None):
                return label_smoothing_cross_entropy(
                    logits, labels, cfg.num_classes, cfg.smoothing)
        else:
            def ce(logits, labels, aux=None):
                return cross_entropy(logits, labels)
        return ce
    if cfg.criterion == "aece":
        def aece(logits, labels, aux=None):
            loss = cross_entropy(logits, labels)
            ae_terms = (aux or {}).get("ae", [])
            if not ae_terms:
                raise ValueError(
                    "the aece criterion needs a model exposing AE tensors")
            for hidden, inp, out in ae_terms:
                loss = loss + sparse_autoencoder_loss(
                    hidden, inp, out, cfg.aece_l1_regularization,
                    cfg.aece_l1_outputs)
            return loss
        return aece
    raise NotImplementedError(f"Unknown criterion: {cfg.criterion}")
