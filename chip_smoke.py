"""Smoke run of the PyTorch port (``vit_cifar_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.

1. Kernel phase: builds the attention kernels from ``vit_cifar_torch/csrc/``
   with nvcc (one process per source, all at once) and holds each against
   its plain PyTorch version on the card, at the model's shape, the JAX
   tests' ragged shapes and heads past the kernels' 128-column chunks, in
   f32 and bf16: the whole-head inference forward and forward with
   logsumexp, the tiled dq and dk/dv passes on its residuals (the fused
   Function's backward), and the Function's gradients against autograd
   through the plain forward.  Times each kernel and its plain version, and
   attention forward+backward, at the model's shape.
2. Serving phase: the serving path at the full width of the README recipe
   model (7 layers, hidden 384, 12 heads; random weights from the config's
   seed): ``get_model`` -> ``save_checkpoint`` -> ``export_inference``
   (``serving.pt2``, ``torch.export`` with a symbolic batch, whose graph
   must call ``vit_cifar_torch::mhsa_fwd``) -> ``make_http_server``, then
   POST /predict requests (raw .npy at B=1, 8 and 128, and one JSON body),
   each checked against a forward with the attention forced to the plain
   version, rebuilt from the checkpoint, and the kernel's launch counter
   checked to rise by one per attention layer and request.  Then the int8
   phase: ``--quantize int8`` of the same checkpoint, its bytes against the
   f32 artifact's (under 0.6x), its logits' deviation (JAX's bound) and
   top-1 agreement on 128 images, 7 launches a request, and both
   artifacts' latency at B=1 and B=128.  Before it, the flagship's
   training step timed with the kernels called through the
   ``torch.library`` dispatcher and directly, in turns.
3. Training phase: the README recipe without AutoAugment (7 layers, batch
   128, bf16-mixed with f32 params, label smoothing; ``warmup_epoch=0`` so
   that epoch 0 trains) on synthetic c10 resident on the card:
   ``load_dataset`` -> ``get_model`` -> ``make_optimizer`` -> ``init_state``
   -> ``make_train_step`` / ``make_eval_step``.  One step's loss and
   gradients are held against the plain-attention (``einsum``) model; then
   one epoch of 390 steps must give finite, falling losses with the
   forward with lse and the tiled dq and dk/dv kernels launched 7 times a
   step each, and the padded test set (40
   batches of 256) must reach val accuracy >= 0.5 with the inference kernel
   launched 7 times a batch.  Prints the step time, img/s and the device's
   busy share (torch.profiler).
4. Flash kernel phase: the tiled kernels (inference forward, forward with
   logsumexp, tiled dq, tiled dk/dv) and the autograd Function's gradients
   against their plain versions, at the pixel-token ViT's shape
   (128, 12, 1025, 32), the flagship's (128, 12, 65, 32) forced through
   them, the JAX flash tests' tile-splitting shapes, one long sequence
   (8, 1, 4096, 128), head dims 129, 136, 192, 256 and 384 (cut into
   column chunks) and past 512 columns, where the bf16 kernels stream
   the sums over D, 520, 522, 640, 704 and 1040 (with the whole-head
   forward's both variants there too) and (16, 2, 1024, 520), in f32
   and bf16; times each kernel and its plain
   version at the pixel shape, and ``F.scaled_dot_product_attention`` as
   the library's yardstick (timed only; the port never calls it).  Then
   the ragged-edge phase: the bf16 instances of both forwards (wgmma with
   TMA, in column chunks past 256 columns, streamed past 512), with and
   without lse, on contiguous inputs and on the model's
   strided views, and of the tiled dq and dk/dv kernels (wgmma with TMA,
   streamed past 512 columns), on contiguous
   inputs and on the model's views, against their plain versions at (2,
   3, T, D) for 13 T from 1 to 129 and D in 16, 24, 32, 64, 128, 129,
   136, 192, 256, 384, 520, 704.  Then each bf16
   forward against its library call (SDPA, or the flash forward with lse)
   on the model's views, in turns, at (128, 12, 65, 32) (device time),
   (128, 12, 1025, 32), (128, 8, 512, D) and (16, 2, 2048, D) for D = 128,
   192, 256, each beside its bound, and the host microseconds a forward
   call costs; past 256 columns both forwards at (128, 8, 512, D) for D =
   320, 384, 512 (the wgmma column chunks) and at (16, 2, 1024, 520) and
   (128, 8, 512, 640) (the streamed instance), each held against its
   plain version first, against SDPA in turns, beside its bound.  Then times the whole-head
   forwards and the fused Function against their tiled counterparts at
   (128, 12, T, 32) bf16 for T = 65,
   257 and 685, and the tiled kernels beside the library's calls at
   (128, 8, 512, D) and (16, 2, 2048, D) for D = 128, 192, 256.  Last the
   backward pair on the model's views against
   ``aten._scaled_dot_product_flash_attention_backward`` in turns at the
   pixel shape, the flagship's (device time) and those head dims, and
   past 512 columns ((16, 2, 1024, 520), (128, 8, 512, 640)), which the
   library's flash backward does not take, against the backward of SDPA
   on the backend it takes there (memory-efficient, else math), each
   beside its bound, with two calls of the pair equal bit for bit.  Then
   the f32 instances' rows (``F32_ROWS``): the f32 forwards with and
   without lse and the f32 pair (TF32 wgmma, split products) on the
   model's f32 views at (128, 12, 1025, 32) and (128, 12, 65, 32), against
   their plain versions (forwards 1e-5; the pair rtol 1e-4 / atol 1e-5),
   two calls of each bit for bit, each and its plain version in turns,
   beside its f32 bound and the library's f32 call (efficient attention
   with lse; SDPA in f32 for the inference forwards; SDPA's backward on
   the backend it takes) with that call's own error against the plain
   version.
5. Pixel serving phase: the same serving path for the README recipe model
   at ``patch=32`` (one pixel a token, T=1025, 6,620,170 params); each
   request must launch the tiled forward 7 times and no whole-head kernel,
   and match the plain-attention forward.
6. Pixel training phase: that model at B=128 (bf16-mixed, label smoothing,
   ``warmup_epoch=0``, synthetic c10 on the card): one step's loss and
   gradients at B=8 against the plain-attention model, then 20 steps with
   each training flash kernel launched 7 times a step, finite and falling
   losses, eval over 4 padded batches of 256, the step time, img/s, the
   device's busy share and its top ops (torch.profiler over 5 steps).
7. Wide-head phase: the README recipe's width in 2 heads at ``patch=2``
   (2 x 2 patches a side: T=5, head_dim 192), 2 layers,
   ``pallas_kernel="fused"``: one
   training step's loss and gradients against the plain-attention model,
   then served logits at B=8 against it with 2 launches of the whole-head
   forward a batch, and 3 steps with the forward with lse and the tiled
   pair launched twice a step each.
7b. Key-tiled phase: ``pallas_kernel="fused"`` past the whole head, where
   the whole-head forward walks K and V in key tiles: its shared memory
   against the Python formula, both variants against their plain versions
   at (1, 1, 1025, 32), (1, 1, 300, 192), (2, 3, 793, 64), (2, 2, 143, 384)
   in f32 and bf16 and at (128, 12, 1025, 32) in bf16, the module at T=1025
   forward and backward against the einsum module with one launch each of
   ``mhsa_fwd``, ``mhsa_fwd_lse`` and the tiled pair and none of the tiled
   forwards, and its time beside the tiled forwards' at the pixel shape.
8. Full-recipe phase: the README recipe with AutoAugment through the
   user's entry point ``train()`` (7 layers, hidden 384, 12 heads, B=128,
   bf16-mixed, label smoothing, ``--autoaugment``, synthetic c10,
   ``warmup_epoch=0``, 2 epochs of 390 steps).  First ``apply_autoaugment``
   at B=128 (cifar10 and svhn policies) on the card against the CPU on the
   same draws, from a card generator.  Then run (a) straight through, and
   run (b) stopped after epoch 1 and resumed from its checkpoint for epoch
   2: finite losses, falling from epoch 1 to 2, val accuracy >= 0.5, the
   resumed run trains one epoch to the same step count, its params and
   moments within ``RESUME_REL_L2`` of run (a)'s, and each run launches the
   training kernels 7 times a step and the inference kernel 7 times an
   eval batch and a probe forward (the layer-output histograms, once an
   epoch).  Then one epoch with ``--preaugment-epoch``, with the same
   launch checks.  Prints the recipe's ms a step and img/s beside the
   no-AutoAugment step of phase 3, AutoAugment's device ms and launches a
   batch (torch.profiler) and the recipe step's busy share.
8a. f32 phase: one ``--precision 32`` step of the flagship (B=128) and of
   the pixel ViT (B=8) against the plain-attention model (loss 1e-5,
   gradient 1e-4 relative L2); one eval (no-grad) forward of each at the
   same batch, counted from zero (7 launches of the f32 inference forward:
   ``mhsa_fwd`` for the flagship, ``flash_fwd`` for the pixel ViT), its
   logits against the plain model's (1e-4 relative L2); then 13 steps of
   each at B=128, counted from zero: 7 launches a step of the f32 forward
   with lse and of each backward pass (the f32 rows' launches), and the
   ms a step.
8b. Analysis phase: ``load_run_model`` and ``run_on_images`` of a
   README-width f32 checkpoint, the attention maps and their rollout
   row-stochastic and equal to the same model's on the CPU (1e-4),
   ``model_payload``, and one epoch of the regenerator study
   (``run_study``) on synthetic c10 (the card's machine has no matplotlib:
   the study says which pictures it did not draw).
9. Zoo phase (seed 2045, bf16-mixed, synthetic c10): the default run
   through the user's entry point, ``python -m vit_cifar_torch --dataset
   c10 --synthetic-data --max-epochs 1`` with no model flag (``cli.main``;
   AEViT, 1 layer, hidden 384, ffn 768, AE hidden 128, B=128, 390 steps;
   ``--warmup-epoch 0`` so that the epoch trains): its train and val loss
   must fall below the untrained model's val_loss; prints ms a step, img/s,
   val_acc and, over 20 more steps under torch.profiler, kernels a step and
   the busy share.  Then the heads AE (chunked eye mask) at 7 layers and 12
   heads with ``aece`` and one unsupervised step, 20 steps at B=128; one
   f32 step of the default model and of that one on the card and on the
   CPU from the same weights and batch (params, both moments and the AE
   optimizer's, in relative L2); under ``ce`` the AE entries left bit for
   bit where the unsupervised loop wrote them; ``ae_baseline``, ``aftfull``,
   ``aftsimple``, ``gmlp``, ``wgmlp`` and ``linear`` at the README width,
   20 steps each; one ``--semi-supervised`` epoch (310 steps) and an
   unsupervised run stopped after epoch 1 and resumed, equal to the
   straight run.  These mixers are plain PyTorch: the phase checks that no
   attention kernel launches.
10. NNMF phase (seed 2045, bf16-mixed, synthetic c10, B=128, the README
   depth and width): ``gnnmf_sbs --optimizer madam --train-md-bases`` for
   one uncut epoch through ``train()`` (its loss must fall below the
   untrained model's, no step skipped, every ``nnmf_weights`` column at
   sum 1 and above its after-care floor; ms a step, img/s, val_acc, and
   kernels, device ms and busy share under torch.profiler);
   ``gnnmf_sbsed`` and ``gnnmf_ham`` with and without ``--train-md-bases``,
   ``ae --use-nnmf-layers`` (1 layer; the reference's forward is not
   finite, so the guard skips its steps) and the heads NNMF AE (7 layers,
   12 heads, one unsupervised step), 20 steps each, with the skipped steps
   counted; one f32 step of ``gnnmf_sbs`` and of the heads NNMF AE on the
   card and on the CPU (params, moments and the AE's Madam moments in
   relative L2, beside the card's own spread under a one-ulp change of the
   input); and a short ``gnnmf_ham --train-md-bases`` run stopped after
   epoch 1 and resumed, bit for bit with its bases.  No attention kernel
   launches in it.
11. Rest-of-the-zoo phase (seed 2045, bf16-mixed, synthetic c10, B=128,
   7 layers, hidden 384, ffn 768, mlp 384, patch 8): ``lgcnn
   --cnn-normalization batch_norm`` for one epoch through ``train()``
   (val_acc >= 0.5 by the running statistics, printed beside val_acc with
   each batch's own statistics; kernels, device ms and busy share under
   torch.profiler), a short run stopped after epoch 1 and resumed, bit for
   bit with its running statistics, and its checkpoint exported and served
   at B=1 and B=128 with the eval path's logits; 20 steps each of
   ``lgcnn``, ``wlgcnn`` (both norms), ``cnn_baseline`` (held to finite
   losses only: the ReLU on its logits collapses it), ``hamburger`` V1
   (with and without ``--train-md-bases``), V2, V2+ and
   ``hamburger_attention``, none launching an attention kernel; the README
   recipe with ``--moe-experts 8``, 20 steps with 7 launches a step of the
   forward with lse and of each tiled backward kernel, an eval with 7 of
   the inference forward a batch, and its profile; one f32 step of
   ``lgcnn`` (both norms), ``hamburger`` V2+ with bases and the MoE ViT on
   the card and on the CPU (params, moments and buffers in relative L2,
   beside the card's own spread).
12. Parallel phase (``vit_cifar_torch/parallel/``): a NCCL process group
   of one rank (a ``FileStore`` under ``build/chip_smoke/``; NCCL takes
   one rank a card, and the machine has one), so ``train()`` takes the
   mesh path, a data axis of 1 with the flat gradient's all-reduce, the
   world's guard verdict, BatchNorm's and the MoE's global sums and the
   eval's all-reduce live.  The README flagship (7 layers, hidden 384, 12
   heads, bf16-mixed, B=128) for 20 steps, ``lgcnn --cnn-normalization
   batch_norm`` and the README recipe with ``--moe-experts 8`` for 5 each,
   each run four times in turns (without, with, with and without the
   group) on a CIFAR-10 data set of exactly those steps written under
   ``build/chip_smoke/``: every checkpoint on the mesh path equals every
   one without it bit for bit (params, moments, buffers), the launch
   counts are equal (7 a step of each training kernel for the ViTs), and
   the ms a step of each run and the NCCL version are printed.
   Runs over more ranks are held on the CPU by the gloo tests
   (``tests/test_torch_parallel*_mp.py``).
13. Pipe/seq phase (``parallel/pipeline.py``, ``parallel/sequence.py``;
   the flagship, B=128, bf16-mixed): (a) ``pipeline_forward`` at one stage
   runs M=4 microbatches of 32 through GPipe's tick loop, a training
   forward and backward and an eval batch, against the plain (einsum,
   sequential) model on the same weights and batch (loss 1e-2, gradient
   2e-2 relative L2, logits 5e-2); then 10 train steps and one eval batch
   with the model's forward on the tick loop, counted from zero: 28
   launches a step of ``mhsa_fwd_lse`` and of each tiled backward kernel
   (7 layers x 4 microbatches) and 28 of ``mhsa_fwd`` in eval; the tick
   loop's step and the sequential one timed in turns; (b) the flagship
   padded as a seq axis of 4 pads it (``seq_pad=3``, ``valid_len=65``)
   against the unpadded model: eval logits, and one step's loss and
   gradient.  Runs over more ranks on either axis are CPU gloo tests
   (``tests/test_torch_pipeline*.py``, ``tests/test_torch_sequence.py``).

The library's yardsticks, timed at both main shapes and called nowhere in
the port: SDPA forward and forward+backward,
``aten._scaled_dot_product_flash_attention`` (the forward with lse) and
``aten._scaled_dot_product_flash_attention_backward`` (dq, dk and dv from
the residuals, the work of the dq + dk/dv kernel pair).

Every kernel is held against its plain version, and the counts of launches
of each path are set to 0 just before it and read just after.  Each kernel
row names its design: the bf16 instances of the forwards and of the
backward pair run wgmma on tiles that TMA brings ("wgmma+TMA", with ptxas's
registers and spills of the instance at the row's shape; the build fails
where ptxas serialised the wgmmas of any library); the f32 instances have
rows of their own (``F32_ROWS``): the forwards, with and without lse, and
the backward pair on TF32 wgmma with each product split (three TF32
products, or six bf16 products of three-term splits) so that it keeps f32
accuracy, past 128 columns on their streamed instances, rows of their own
(the build fails where one of those instances spills).  The bound of a
kernel (``bound_ms``) is the larger of its bytes
(each input read once, each output written once) over 3.35 TB/s and its
operations: its products over the bf16 tensor-core peak (989 TFLOP/s;
in f32 a third of the TF32 peak, 495 TFLOP/s) and its exps over the
special-function units' peak (16 a clock on each of 132 SMs at 1.98 GHz).

Prints the card's name and power limit, every check and time, then a JSON
line of the kernels and, last, ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero before that line; with no CUDA card it exits
non-zero at once.  Work files go to ``build/chip_smoke/`` in the checkout.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from vit_cifar_torch import Config, cli, torch_dtype
from vit_cifar_torch.analysis.attention_maps import (collect_attention_maps,
                                                     get_joint_attentions)
from vit_cifar_torch.analysis.interactive import model_payload
from vit_cifar_torch.analysis.regenerator import run_study
from vit_cifar_torch.analysis.run_model import load_run_model, run_on_images
from vit_cifar_torch.config import config_from_args
from vit_cifar_torch.data.augment import normalize
from vit_cifar_torch.data.autoaugment import (apply_autoaugment,
                                              autoaugment_batch,
                                              autoaugment_draws)
from vit_cifar_torch.data.datasets import load_dataset
from vit_cifar_torch.deploy import (ServingModel, export_inference,
                                    make_http_server)
from vit_cifar_torch.models import get_model
from vit_cifar_torch.ops.attention import MultiHeadSelfAttention
from vit_cifar_torch.ops.cuda import KERNEL_WRAPPERS, registry
from vit_cifar_torch.ops.cuda.attention import (
    fused_attention, fused_attention_lse, fused_attention_lse_reference,
    fused_attention_reference)
from vit_cifar_torch.ops.cuda.build import build_libraries, library_path
from vit_cifar_torch.ops.cuda.common import WIDEST_FORWARD
from vit_cifar_torch.ops.cuda.flash_attention import (
    flash_attention, flash_attention_lse, flash_attention_lse_reference,
    flash_attention_reference, flash_tiled_bwd_dkv,
    flash_tiled_bwd_dkv_reference, flash_tiled_bwd_dq,
    flash_tiled_bwd_dq_reference)
from vit_cifar_torch.parallel.pipeline import Pipeline, pipeline_forward
from vit_cifar_torch.parallel.sequence import pad_stream
from vit_cifar_torch.train.checkpoint import load_checkpoint, save_checkpoint
from vit_cifar_torch.train.loop import _pad_eval, init_state, train
from vit_cifar_torch.train.losses import make_criterion
from vit_cifar_torch.train.optim import flat_mask, make_optimizer
from vit_cifar_torch.train.steps import (make_eval_step, make_metrics_zeros,
                                         make_train_step)
from vit_cifar_torch.train.unsupervised import (is_ae_param,
                                                make_unsupervised_update)

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
# the model's attention shape first, then the JAX kernel tests' ragged
# shapes, then heads past the 128-column chunks (the whole-head forward's
# column-chunk layout, up to its last T at head_dim 384)
SHAPES = [(128, 12, 65, 32), (2, 4, 9, 16), (2, 3, 65, 32), (1, 2, 130, 64),
          (2, 2, 96, 128), (2, 2, 257, 192), (1, 1, 142, 384)]
# kernel vs plain version: the same f32 math with sums in another order; in
# bf16 the output may round one bf16 step (2**-7 relative) the other way
KERNEL_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
              torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
# backward kernels vs plain versions: f32 sums chained twice over T (ds,
# then ds.k), so 1e-4 relative; bf16 as above
BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
           torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
# the Function's grads vs autograd through the plain forward: in bf16 the
# backward reads the forward's output rounded to bf16 where autograd keeps
# f32 probabilities (measured on the CPU: at most 4e-3 at these shapes)
GRAD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# the flash phase's bf16 limits, as a fraction of the reference's largest
# magnitude: kernel and plain version round one f32 value to bf16, so they
# differ by at most one bf16 step, 2**-7 (0.78%) of a value; the Function's
# grads read the kernel's rounded output where the plain passes read the
# plain forward's, hence 2%.  A fixed atol would not follow the values: at
# T=1025 they are about 4x smaller than at T=65 (|out| ~0.03, |dq| ~0.01)
FLASH_BF16_FRACTION = {"fwd": 1e-2, "bwd": 1e-2, "grad": 2e-2}
# one full-width bf16 training step, kernel path vs the plain-attention
# (einsum) path from the same weights and batch: the einsum path rounds
# logits and probabilities to bf16, the kernels keep them in f32.  Measured
# on the CPU at batch 16: loss 5.5e-4 apart, flat gradient 3.2e-3 apart
# (relative L2); the bounds leave a 6x margin or more
STEP_LOSS_ATOL = 1e-2
STEP_GRAD_REL_L2 = 2e-2
KERNELS = ("mhsa_fwd", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
REPLACES = {
    "mhsa_fwd": "vit_cifar_tpu/ops/pallas/attention.py:90",
    "mhsa_fwd_lse": "vit_cifar_tpu/ops/pallas/attention.py:90",
    "flash_fwd": "vit_cifar_tpu/ops/pallas/attention.py:203",
    "flash_fwd_lse": "vit_cifar_tpu/ops/pallas/attention.py:203",
    "flash_bwd_dq_tiled": "vit_cifar_tpu/ops/pallas/attention.py:338",
    "flash_bwd_dkv_tiled": "vit_cifar_tpu/ops/pallas/attention.py:383",
}
SOURCES = {"mhsa_fwd": "mhsa_fwd", "mhsa_fwd_lse": "mhsa_fwd",
           "flash_fwd": "flash_fwd", "flash_fwd_lse": "flash_fwd",
           "flash_bwd_dq_tiled": "flash_bwd_dq",
           "flash_bwd_dkv_tiled": "flash_bwd_dkv"}
# what each kernel computes, for its bound: "fwd" (two T x T x D products,
# q, k, v in and o out), "fwd_lse" (the same and lse out), "dq" (three
# products; q, k, v, o, do and lse in, dq out), "dkv" (four products; dk
# and dv out)
KERNEL_WORK = {"mhsa_fwd": "fwd", "mhsa_fwd_lse": "fwd_lse",
               "flash_fwd": "fwd", "flash_fwd_lse": "fwd_lse",
               "flash_bwd_dq_tiled": "dq", "flash_bwd_dkv_tiled": "dkv"}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_FLOP_PER_S = 989e12    # H100 SXM tensor cores, dense bf16
EXP_PER_S = 132 * 16 * 1.98e9  # special-function units: 16/clk/SM, boost
TRAIN_STEPS = 390  # one epoch of c10 at batch 128
MIN_VAL_ACC = 0.5
# served logits (kernel path) vs the plain path in bf16-mixed: the plain
# path rounds logits and probabilities to bf16, the kernel keeps them in
# f32; through 7 layers that is a few bf16 steps at logits of order 1
LOGIT_TOL = dict(rtol=5e-2, atol=5e-2)
REQUESTS = [("npy", 1), ("npy", 8), ("npy", 128), ("json", 4)]
PARAMS = 6_268_810
# the pixel-token ViT: the README recipe at patch=32, one pixel a token
PIXEL_PARAMS = 6_620_170
PIXEL_SHAPE = (128, 12, 1025, 32)
# the flash kernels' shapes: the pixel model's, the flagship's forced
# through them, the JAX flash tests' tile-splitting shapes, a long sequence,
# heads past 128 columns and, last, past the tables' widest rows (the
# streamed instances: D % 64 == 8, D % 8 == 2, whole 64-column chunks,
# and the head of the timing cell past 512)
FLASH_SHAPES = [PIXEL_SHAPE, (128, 12, 65, 32), (2, 3, 65, 32),
                (1, 2, 130, 64), (2, 2, 257, 128), (1, 1, 8, 128),
                (1, 2, 300, 32), (8, 1, 4096, 128), (2, 2, 300, 129),
                (2, 2, 257, 136), (2, 2, 257, 192), (1, 2, 130, 256),
                (1, 1, 200, 384), (1, 1, 130, 520), (2, 2, 130, 522),
                (1, 2, 257, 640), (2, 1, 200, 704), (1, 1, 129, 1040),
                (16, 2, 1024, 520)]
PIXEL_STEPS = 20
PIXEL_STEP_BATCH = 8  # the einsum path's (B, H, T, T) tensors bound it
PIXEL_REQUESTS = (1, 32)
PIXEL_EVAL_IMAGES = 1000  # 4 padded batches of 256
# where the whole-head forward is timed against the tiled one: the
# flagship's T, and two longer heads it holds
ROUTE_T = (65, 257, 685)
# the tiled kernels beside the library's at head dims up to 256 (the
# library's flash attention takes no wider head): the docs/PERFORMANCE.md
# cells (128, 8, 512, 128) and (16, 2, 2048, 128), and the same at 192, 256
HEAD_DIM_SHAPES = [(128, 8, 512, D) for D in (128, 192, 256)] + [
    (16, 2, 2048, D) for D in (128, 192, 256)]
# the wide-head phase: hidden 384 in 2 heads at patch 2 (``patch`` counts
# patches a side: T=5, head_dim 192), 2 layers, through the whole-head
# forward
WIDE_LAYERS = 2
WIDE_BATCH = 8
WIDE_STEPS = 3
# the wide-head model in f32 (the streamed pair's path): 16 patches a side,
# T=257, so that the pair walks several key and query tiles
WIDE_F32_PATCH = 16
# the full-recipe phase: 2 epochs (the resumed run trains the second)
RECIPE_EPOCHS = 2
AA_BATCH = 128
# AutoAugment on the card against the CPU on the same draws: shear sums its
# four taps in another order and rotate floors coordinates from the card's
# cos/sin, so a tie may round a value one level apart or move a pixel, and a
# second stage (solarize's threshold, equalize's lut) may carry it further
AA_CARD_SHARE = 1e-3
# profiler windows tried before a device time is "not measured"
PROFILE_TRIES = 3
# resumed run (b) against the straight run (a), relative L2 of the flat
# params and of each moment: the same draws and the same kernels, but
# cuBLAS and the reductions need not sum in one order from run to run
RESUME_REL_L2 = 1e-2
# the zoo phase (bf16-mixed, synthetic c10, seed 2045): the default model
# (AEViT, 1 layer) through the CLI for one epoch, the heads AE at the README
# depth, the other mixers at the README width, ZOO_STEPS steps each (the
# first ZOO_WARM untimed)
ZOO_SEED = 2045
ZOO_STEPS = 20
ZOO_WARM = 3
ZOO_MIXERS = ("ae_baseline", "aftfull", "aftsimple", "gmlp", "wgmlp",
              "linear")
# one f32 step on the card against the CPU from the same weights and batch:
# relative L2 of the params after it and of the main moments; the same f32
# math (TF32 off) with sums in another order
ZOO_CARD_CPU_REL_L2 = 1e-4
# ... and of the AE optimizer's moments, whose gradient (the MSE of a
# ReLU'd reconstruction over 7 layers' inputs) magnifies the card's and the
# CPU's rounding of those inputs: the first chip run read 7.0e-5 here where
# the main moments agreed to 4.9e-6
ZOO_AE_CARD_CPU_REL_L2 = 1e-3
# the NNMF phase (bf16-mixed, synthetic c10, seed 2045, B=128): gnnmf_sbs
# with madam and --train-md-bases for one epoch through train(), the other
# NNMF models NNMF_STEPS steps each (the first ZOO_WARM untimed)
NNMF_STEPS = 20
NNMF_PROFILE_STEPS = 10
# one f32 step card vs CPU, relative L2 of params and moments.  The heads
# NNMF AE's main step meets the zoo's limits (its AE's Madam moments: the
# gradient of a 7-layer reconstruction MSE, as the zoo's AE moments).  A
# gnnmf_sbs step is far more sensitive to rounding (the NNMF layer's
# iterate and its max-normalized backward): card vs CPU read 2.0e-4 to
# 5.6e-4 on an H100 at 700 W, where the card's own step with its input one
# f32 ulp larger moved by 6.3e-5 to 1.5e-4 (the phase prints both); it is
# held to 2e-3
NNMF_CARD_CPU_REL_L2 = {"gnnmf_sbs": 2e-3, "heads NNMF AE": 1e-4}
NNMF_AE_CARD_CPU_REL_L2 = 1e-3
# the heads NNMF AE L1-normalizes its LayerNormed, signed input, and where
# a column's sum is small its iterate is chaotic (one f32 ulp of input
# moves the reference's own reconstruction loss several-fold); its
# card-vs-CPU step starts from norm1 biases raised by this much, which
# makes the AE's input positive
NNMF_NORM1_SHIFT = 4.0
# --semi-supervised on c10: 4,000 labeled images (31 steps at B=128) and
# 41,000 unlabeled, so 10 passes an epoch
SEMI_STEPS = 310
# the rest of the zoo (BatchNorm, the CNNs, the burgers, MoE; seed 2045,
# bf16-mixed, synthetic c10, B=128, the README depth and width): each of
# REST_MODELS trains ZOO_STEPS steps (the first ZOO_WARM untimed)
REST_MODELS = (
    ("lgcnn", dict(model_name="lgcnn")),
    ("wlgcnn", dict(model_name="wlgcnn")),
    ("wlgcnn batch_norm", dict(model_name="wlgcnn",
                               cnn_normalization="batch_norm")),
    ("cnn_baseline", dict(model_name="cnn_baseline")),
    ("hamburger V1", dict(model_name="hamburger")),
    ("hamburger V1 --train-md-bases", dict(model_name="hamburger",
                                           train_md_bases=True)),
    ("hamburger V2", dict(model_name="hamburger", burger_mode="V2")),
    ("hamburger V2+", dict(model_name="hamburger", burger_mode="V2+")),
    ("hamburger_attention", dict(model_name="hamburger_attention")),
)
REST_MOE_EXPERTS = 8
# steps under the profiler: lgcnn's 2,800 kernels a step make a large trace
REST_PROFILE_STEPS = 2
# the resumed lgcnn batch_norm run: 2 epochs over the 4,000 labeled images
# of --semi-supervised at B=512 (7 steps an epoch), evaluated at B=1,000;
# the bit-for-bit comparison needs no more, and a host-bound step costs
# about the same at 512 as at 128
RESUME_BATCH, RESUME_EVAL_BATCH = 512, 1000
# one f32 step card vs CPU at B=32 (the CPU's f32 step of a 7-layer burger
# at B=128 would take tens of seconds), relative L2 of params, moments and
# buffers: the zoo's limit, but for lgcnn with batch_norm.  It normalizes
# the cls token, the same for every image, at layer 0 (la1, then the
# mixer's norm) by a batch variance that is 0 in exact arithmetic: its
# rounding, which the card's and the CPU's reductions make differently,
# comes out multiplied by 1/sqrt(eps) = 316 at each, and reaches every
# layer through the cls path.  The first chip runs read 8.1e-4 for the
# params and 1.1e-3 for mu there (a loss 2.5e-5 apart; conv biases of
# layers 0-2 farthest, 3.4e-3), where its layer_norm twin, run beside it
# and held to the zoo's limit, read 2.1e-6.  The mean of 32 equal values
# is not exact in most channels on either side (the script counts them),
# and the two round differently.  The witness: the CPU's own step with
# the cls token one ulp larger, which moves only that rounding (the input
# never reaches the cls path at layer 0), must spread as far (at least
# LGCNN_BN_WITNESS_SHARE of the card-vs-CPU gap; it read 1.19e-3 for mu
# against a gap of 1.13e-3) while the layer_norm twin's stays within the
# zoo's limit; the card's own step with the cls token one ulp larger is
# printed beside it (5.2e-5).  The control: the same step in bf16-mixed
# against the f32 CPU must land above the limit (it read 0.37 for mu), so
# the limit, between the two, still tells a wrong result from this
# rounding
REST_CARD_CPU_BATCH = 32
LGCNN_BN_CARD_CPU_REL_L2 = 3e-3
LGCNN_BN_WITNESS_SHARE = 0.1
# the ragged-edge phase: every T where a 16-row tile, a 64-key chunk or a
# 64-row block ends or begins, at head dims that are and are not a multiple
# of 16, for the bf16 (tensor-core) instances of the two forwards and of
# the tiled backward pair
RAGGED_T = (1, 7, 8, 15, 16, 17, 63, 64, 65, 66, 127, 128, 129)
RAGGED_D = (16, 24, 32, 64, 128, 129, 136, 192, 256, 384, 520, 704)
RAGGED_BH = (2, 3)
# the ragged-edge phase holds the backward pair to the flash "bwd" limit,
# but no tighter than this floor per 128 columns: at T=1 the softmax over one
# key is constant, so dq and dk are 0 in exact arithmetic and kernel and
# plain version both return f32 rounding noise of dp - delta, sums over D
# terms (6e-8 measured on the card at D <= 128, 1.3e-6 at D=384); wherever
# a grad is not 0 the limit is 1% of it, far above this floor
RAGGED_BWD_ATOL_FLOOR = 1e-6


# "fused" past the whole head: the block walks K and V in key tiles.  The
# re-anchor's (1, 1, 1025, 32) and (1, 1, 300, 192), the pixel shape in
# bf16, and one head of each other instance (head_dim 64, and 384 in three
# column chunks) just past the whole-head layouts
KEY_TILED_SHAPES = [((1, 1, 1025, 32), (torch.float32, torch.bfloat16)),
                    ((1, 1, 300, 192), (torch.float32, torch.bfloat16)),
                    ((2, 3, 793, 64), (torch.float32, torch.bfloat16)),
                    ((2, 2, 143, 384), (torch.float32, torch.bfloat16)),
                    (PIXEL_SHAPE, (torch.bfloat16,))]
# the "fused" module at T=1025: (B, T, features, heads), head_dim 32, f32
KEY_TILED_MODULE = (2, 1025, 64, 2)
# the int8 artifact: JAX's bounds (tests/test_deploy.py), the bytes under
# 0.6x the f32 artifact's and the logits within 5% of the largest f32 logit
# + 0.05; top-1 agreement over INT8_IMAGES at least INT8_MIN_AGREE
INT8_BYTES_RATIO = 0.6
INT8_IMAGES = 128
INT8_MIN_AGREE = 0.9
DISPATCH_STEPS = 20  # steps a window of the dispatcher's timing
ANALYSIS_BATCH = 8
# maps and rollout on the card against the CPU, in f32
ANALYSIS_TOL = dict(rtol=0.0, atol=1e-4)


def ragged_bwd_floor(D: int) -> float:
    """``RAGGED_BWD_ATOL_FLOOR`` for head_dim D: the noise grows with the
    number of terms in dp and delta."""
    return RAGGED_BWD_ATOL_FLOOR * max(1.0, D / 128)
# how each kernel row's bf16 instance computes (the f32 instances' rows:
# F32_DESIGN)
FWD_DESIGN = ("wgmma+TMA; column chunks at 257-512 columns; past 512 the "
              "streamed instance (sum over D in 64-column chunks, PR 18)")
BWD_DESIGN = ("wgmma+TMA (PR 16); past 512 columns the streamed instance "
              "(sums over D in 64-column chunks, PR 18)")
DESIGN = {"mhsa_fwd": FWD_DESIGN, "mhsa_fwd_lse": FWD_DESIGN,
          "flash_fwd": FWD_DESIGN, "flash_fwd_lse": FWD_DESIGN,
          "flash_bwd_dq_tiled": BWD_DESIGN,
          "flash_bwd_dkv_tiled": BWD_DESIGN}
# each row's kernels among its library's instances (ptxas' names)
INSTANCE_KINDS = {"mhsa_fwd": ("fwd_kernel", "fwd_stream_kernel"),
                  "mhsa_fwd_lse": ("fwd_kernel", "fwd_stream_kernel"),
                  "flash_fwd": ("fwd_kernel", "fwd_stream_kernel"),
                  "flash_fwd_lse": ("fwd_kernel", "fwd_stream_kernel"),
                  "flash_bwd_dq_tiled": ("dq_kernel", "dq_stream_kernel"),
                  "flash_bwd_dkv_tiled": ("dkv_kernel", "dkv_stream_kernel")}
# each forward row's main shape, whose wgmma instance's ptxas report the
# row carries
FORWARD_MAIN_SHAPE = {"mhsa_fwd": (128, 12, 65, 32),
                      "mhsa_fwd_lse": (128, 12, 65, 32),
                      "flash_fwd": PIXEL_SHAPE, "flash_fwd_lse": PIXEL_SHAPE}
# the backward pair's rows: the pixel shape's instances (backward_plan)
BACKWARD_ROWS = ("flash_bwd_dq_tiled", "flash_bwd_dkv_tiled")
# past the tables' widest rows (512 columns), where the streamed instances
# run: a long head of few heads and the (128, 8, 512, D) cell
STREAMED_TIMING_SHAPES = ((16, 2, 1024, 520), (128, 8, 512, 640))
# the backward pair against the library's backward, in turns on the
# model's views: the pixel ViT's shape, the flagship's (device time) and
# head dims 128, 192 and 256 (past 128 the wgmma column chunks); and past
# 512 columns, where the library's flash backward takes no head, against
# the backward of SDPA on the backend it takes there
BACKWARD_TIMING_SHAPES = [PIXEL_SHAPE, (128, 12, 65, 32), *HEAD_DIM_SHAPES,
                          *STREAMED_TIMING_SHAPES]
LIBRARY_WIDEST = 256  # the library's flash attention takes no wider head
# each forward against its library call, in turns: the flagship's and the
# pixel ViT's shapes, and head dims 128, 192 and 256 (HEAD_DIM_SHAPES)
FORWARD_TIMING_SHAPES = [(128, 12, 65, 32), PIXEL_SHAPE, *HEAD_DIM_SHAPES]
# the bf16 forwards past 256 columns, the wgmma kernel's column chunks up
# to 512 columns (before them a column-chunk kernel on the warp-level mma
# read 13.75 ms at the first shape): their cost against SDPA; past 512
# the streamed instance at STREAMED_TIMING_SHAPES
CHUNK_TIMING_SHAPES = ((128, 8, 512, 320), (128, 8, 512, 384),
                       (128, 8, 512, 512))
# SDPA's backends past the library's flash attention, the first that takes
# the head timed: memory-efficient attention, else the math path
SDPA_BACKENDS = ("EFFICIENT_ATTENTION", "MATH")
# the batch of the chunked forwards' check against their plain version
# at each of CHUNK_TIMING_SHAPES' heads
CHUNK_CHECK_BATCH = 4
# a fully masked first key tile (the last one: tiles are taken last to
# first), with finite keys before it, at the 128-, 96-, 64- and 32-key
# tiles of head dims 32, 64, 192 and 256, in column chunks at the 64- and
# 16-key tiles of head dims 320 and 512, and streamed at 704
MASKED_TILE_SHAPES = ((2, 2, 256, 32), (2, 2, 193, 64), (2, 2, 300, 192),
                      (2, 2, 300, 256), (2, 2, 300, 320), (2, 2, 200, 512),
                      (2, 2, 300, 704))
# calls a window of the host's cost of one forward call
HOST_CALLS = 200
# the f32 instances (dtype 0, ``--precision 32``), rows of their own in the
# kernels line: the whole-head forward with and without lse (the
# flagship), the tiled forward with and without lse (the pixel ViT), all on
# TF32 wgmma with split products up to 128 columns
# (csrc/wgmma_forward_tf32.cuh), and the tiled backward pair the same way
# (csrc/wgmma_tf32.cuh); each timed at its main shape and the pair also at
# the flagship's, on the model's views.  The inference rows' launches come
# from the f32 phase's eval forwards
F32_ROWS = {"mhsa_fwd_lse_f32": "mhsa_fwd_lse",
            "flash_fwd_lse_f32": "flash_fwd_lse",
            "flash_bwd_dq_tiled_f32": "flash_bwd_dq_tiled",
            "flash_bwd_dkv_tiled_f32": "flash_bwd_dkv_tiled",
            "mhsa_fwd_f32": "mhsa_fwd",
            "flash_fwd_f32": "flash_fwd",
            "flash_fwd_lse_f32_wide": "flash_fwd_lse",
            "flash_fwd_f32_wide": "flash_fwd",
            "mhsa_fwd_lse_f32_wide": "mhsa_fwd_lse",
            "mhsa_fwd_f32_wide": "mhsa_fwd",
            "flash_bwd_dq_tiled_f32_streamed": "flash_bwd_dq_tiled",
            "flash_bwd_dkv_tiled_f32_streamed": "flash_bwd_dkv_tiled"}
# the f32 rows past 128 columns, whose launches the wide-head f32 path
# counts (the whole-head forward's in a pallas_kernel="fused" pass): both
# forwards' streamed TF32 instance (FWD_F32_STREAMED) and the streamed
# TF32 pair (DQ_F32_STREAMED, DKV_F32_STREAMED), timed at F32_WIDE_SHAPE
# and held against their plain versions there and at
# F32_WIDE_CHECK_SHAPES: the wide-head model's head at B=8, and 520 and
# 704 columns (17 and 22 chunks of the sums over D)
F32_WIDE_SHAPE = (128, 8, 512, 256)
F32_WIDE_CHECK_SHAPES = ((8, 2, 257, 192), (2, 2, 130, 520),
                         (2, 3, 65, 704))
F32_WIDE_ROWS = ("flash_fwd_lse_f32_wide", "flash_fwd_f32_wide",
                 "mhsa_fwd_lse_f32_wide", "mhsa_fwd_f32_wide",
                 "flash_bwd_dq_tiled_f32_streamed",
                 "flash_bwd_dkv_tiled_f32_streamed")
F32_MAIN_SHAPE = {"mhsa_fwd_lse_f32": (128, 12, 65, 32),
                  "flash_fwd_lse_f32": PIXEL_SHAPE,
                  "flash_bwd_dq_tiled_f32": PIXEL_SHAPE,
                  "flash_bwd_dkv_tiled_f32": PIXEL_SHAPE,
                  "mhsa_fwd_f32": (128, 12, 65, 32),
                  "flash_fwd_f32": PIXEL_SHAPE,
                  **dict.fromkeys(F32_WIDE_ROWS, F32_WIDE_SHAPE)}
F32_FWD_DESIGN = ("TF32 wgmma, split products (s: three TF32; p.V: six "
                  "bf16 of three-term splits, each key tile's part added "
                  "in f32); streamed past 128 columns (its own row)")
F32_WIDE_FWD_DESIGN = ("TF32 wgmma past 128 columns, streamed through the "
                       "TMA ring: a split pass writes q and K as TF32 "
                       "halves and V as three bf16 terms once a call; s "
                       "summed over 32-column chunks (three TF32 products "
                       "a chunk, added in f32) that the two consumers "
                       "share, once an item and key tile; each consumer "
                       "128 columns of o (six bf16 products a tile, added "
                       "in f32)")
F32_STREAMED_DESIGN = ("TF32 wgmma past 128 columns, streamed through the "
                       "TMA ring: s, dp summed over 32-column chunks that "
                       "the converter warps split (three TF32 products a "
                       "chunk, added in f32), the gradients' B at the "
                       "item's columns through a second ring (six bf16)")
F32_DESIGN = {
    "mhsa_fwd_lse_f32": F32_FWD_DESIGN + "; the whole head as one key tile",
    "flash_fwd_lse_f32": F32_FWD_DESIGN,
    "mhsa_fwd_f32": F32_FWD_DESIGN + "; the whole head as one key tile",
    "flash_fwd_f32": F32_FWD_DESIGN,
    "flash_bwd_dq_tiled_f32": "TF32 wgmma, split products (s, dp: three "
                              "TF32; the gradients': six bf16); streamed "
                              "past 128 columns (its own row)",
    "flash_bwd_dkv_tiled_f32": "TF32 wgmma, split products (s, dp: three "
                               "TF32; the gradients': six bf16, TF32 "
                               "transposes at 128 columns); streamed past "
                               "128 columns (its own row)",
    "flash_fwd_lse_f32_wide": F32_WIDE_FWD_DESIGN,
    "flash_fwd_f32_wide": F32_WIDE_FWD_DESIGN,
    "mhsa_fwd_lse_f32_wide": F32_WIDE_FWD_DESIGN
    + "; mhsa_fwd takes the same tiled items",
    "mhsa_fwd_f32_wide": F32_WIDE_FWD_DESIGN
    + "; mhsa_fwd takes the same tiled items",
    "flash_bwd_dq_tiled_f32_streamed": F32_STREAMED_DESIGN,
    "flash_bwd_dkv_tiled_f32_streamed": F32_STREAMED_DESIGN}
F32_INSTANCE_KINDS = {"mhsa_fwd_lse_f32": ("fwd_split_kernel",),
                      "flash_fwd_lse_f32": ("fwd_split_kernel",),
                      "mhsa_fwd_f32": ("fwd_split_kernel",),
                      "flash_fwd_f32": ("fwd_split_kernel",),
                      "flash_bwd_dq_tiled_f32": ("dq_split_kernel",),
                      "flash_bwd_dkv_tiled_f32": ("dkv_split_kernel",),
                      "flash_fwd_lse_f32_wide": ("fwd_split_stream_kernel",
                                                 "split_qkv_kernel"),
                      "flash_fwd_f32_wide": ("fwd_split_stream_kernel",
                                             "split_qkv_kernel"),
                      "mhsa_fwd_lse_f32_wide": ("fwd_split_stream_kernel",
                                                "split_qkv_kernel"),
                      "mhsa_fwd_f32_wide": ("fwd_split_stream_kernel",
                                            "split_qkv_kernel"),
                      "flash_bwd_dq_tiled_f32_streamed": (
                          "dq_split_stream_kernel",),
                      "flash_bwd_dkv_tiled_f32_streamed": (
                          "dkv_split_stream_kernel",)}
# an f32-accurate product on the tensor cores: three TF32 products
TF32_FLOP_PER_S = 495e12
F32_SPLIT_FLOP_PER_S = TF32_FLOP_PER_S / 3
# one --precision 32 step, kernel path vs the plain-attention (einsum) path
# from the same weights and batch: the same f32 math (TF32 off for the
# einsums) but the backward pair's products split (three TF32 or six bf16)
# (about 2**-21 of a term) and sums in another order
F32_STEP_LOSS_ATOL = 1e-5
F32_STEP_REL_L2 = 1e-4
F32_STEPS = 10  # timed steps of each --precision 32 model, after 3 more
# ptxas's note that it serialised a kernel's wgmmas (C7510-C7520): the
# products of the forwards and of the backward pair must run
# asynchronously
SERIALISED = re.compile(r"\((C75[12]\d)\) Potential Performance Loss: "
                        r"wgmma\.mma_async instructions are serialized")
PTXAS = {}  # library -> instance -> "N registers, ... spill ..."
STEP_KERNELS = {}  # path -> kernels a step (torch.profiler)
# the bf16 max_abs_err of the earlier designs at the main shapes: the
# forwards' first, CUDA-core designs' from their own chip runs (PERF.md;
# they matched the plain version's rounding exactly at T=65 and were one
# bf16 step off at T=1025), printed beside the wgmma forwards'; the tiled
# backward pair's warp-level mma design's from the flash phase (the pixel
# shape)
# and, in EARLIER_PAIR_AT_65, the training kernel phase (the flagship's
# shape, the fused Function's backward) of the commit before the pair's
# wgmma redesign, on the same inputs (each phase's own seed) on an H100:
# the wgmma pair must be no worse
EARLIER_MAX_ABS_ERR = {"mhsa_fwd": 0.0, "mhsa_fwd_lse": 0.0,
                       "flash_fwd": 4.9e-4, "flash_fwd_lse": 4.9e-4,
                       "flash_bwd_dq_tiled": 2 ** -12,   # 2.441e-4
                       "flash_bwd_dkv_tiled": 2 ** -10}  # 9.766e-4
EARLIER_PAIR_AT_65 = {"flash_bwd_dq_tiled": 2 ** -11,   # 4.883e-4
                      "flash_bwd_dkv_tiled": 2 ** -9}   # 1.953e-3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean ms of ``fn`` on the card over a CUDA-event window."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median host-clock ms of ``fn``, which ends in a host read."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def build_kernels() -> None:
    """Build every kernel library at once, print ptxas's report of each
    kernel instance (kept in ``PTXAS``), and fail where ptxas serialised
    the wgmmas of any library's kernel (the forwards' and the backward
    pair's)."""
    t0 = time.perf_counter()
    build_libraries(KERNELS)
    print(f"built {', '.join(KERNELS)} in {time.perf_counter() - t0:.1f} s "
          "(one nvcc each, in parallel)")
    for name in KERNELS:
        log = library_path(name).with_suffix(".log")
        print(f"  {os.path.relpath(library_path(name), ROOT)}")
        instance = spills = ""
        report = PTXAS.setdefault(name, {})
        for line in log.read_text().splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            serial = SERIALISED.search(line)
            if serial:
                raise AssertionError(f"{name}: ptxas serialised wgmmas "
                                     f"({serial.group(1)}): {line.strip()}")
            if entry:  # ...fwd_kernelILi32ELi128ELi2ELb1EEEv... -> <32,128,2,1>
                m = re.search(r"([a-z_]+_kernel)I(\w+?)EE", entry.group(1))
                args = m and (re.findall(r"L[ib](\d+)E", m.group(2) + "E")
                              or [m.group(2)])
                # a kernel that is no template by its own name
                plain = re.search(r"([a-z_]+_kernel)E", entry.group(1))
                instance = (f"{m.group(1)}<{','.join(args)}>" if m
                            else plain.group(1) if plain
                            else entry.group(1))
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line:
                regs = line.split(":", 1)[1].strip()
                report[instance] = f"{regs.split(',')[0]}; {spills}"
                print(f"    ptxas: {instance}: {regs}; {spills}")
                if "_split_" in instance and \
                        "0 bytes spill stores" not in spills:
                    raise AssertionError(f"{name}: the f32 instance "
                                         f"{instance} spills: {spills}")


def forward_ptxas(name: str, shape=None) -> str:
    """ptxas's registers and spills of the bf16 wgmma instance that forward
    row ``name`` runs at ``shape`` (default: its main shape;
    ``forward_plan`` names it, from the table of instances the CUDA
    dispatch expands: fwd_kernel<width, keys, query buffers, ping-pong,
    columns of o an item>)."""
    from vit_cifar_torch.ops.cuda.common import forward_plan

    lib = SOURCES[name]
    T, D = (shape or FORWARD_MAIN_SHAPE[name])[2:]
    plan = forward_plan(lib, T, D)
    if plan["grid"] == "streamed":
        instance = f"fwd_stream_kernel<{plan['rows']['k']},{plan['cols']}>"
        return f"{instance}: {PTXAS[lib][instance]}"
    head = f"fwd_kernel<{plan['width']},{plan['rows']['k']},"
    tail = f",{int(plan['pingpong'])},{plan['cols']}>"
    (instance,) = [i for i in PTXAS[lib]
                   if i.startswith(head) and i.endswith(tail)]
    return f"{instance}: {PTXAS[lib][instance]}"


def backward_ptxas(name: str) -> str:
    """ptxas's registers and spills of the bf16 wgmma instance that
    backward row ``name`` runs at the pixel shape (``backward_plan`` names
    it, from the table of instances the CUDA dispatch expands)."""
    from vit_cifar_torch.ops.cuda.common import backward_plan

    plan = backward_plan(*PIXEL_SHAPE[2:])
    kind = "dq" if name == "flash_bwd_dq_tiled" else "dkv"
    instance = (f"{kind}_kernel<{plan['width']},{plan[kind]['tile']},"
                f"{plan[kind]['cols']}>")
    return f"{instance}: {PTXAS[SOURCES[name]][instance]}"


def row_instances(name: str) -> list[str]:
    """ptxas's report of every bf16 instance of kernel row ``name`` that
    its library holds (the table's rows, the streamed one included)."""
    return [f"{i}: {r}" for i, r in PTXAS[SOURCES[name]].items()
            if i.split("<")[0] in INSTANCE_KINDS[name]]


def in_turns(fns: dict, rounds: int = 3, iters: int = 100) -> dict:
    """Median ms of each of two functions, timed in turns A, B, B, A."""
    a, b = fns
    times = {a: [], b: []}
    for _ in range(rounds):
        for name in (a, b, b, a):
            times[name].append(cuda_ms(fns[name], iters, min(10, iters)))
    return {name: statistics.median(t) for name, t in times.items()}


def bound(name: str, shape, dtype=torch.bfloat16) -> dict:
    """The least time the card could take for kernel ``name``'s work at
    (B, H, T, D) in ``dtype``: the larger of its bytes over the memory rate
    and its operations (products on the tensor cores, exps on the
    special-function units) over their peaks; an f32 product's peak is
    that of three TF32 products, the split that keeps f32 accuracy
    (``F32_SPLIT_FLOP_PER_S``)."""
    B, H, T, D = shape
    work = KERNEL_WORK[F32_ROWS.get(name, name)]
    size = 4 if dtype == torch.float32 else 2
    n, rows = size * B * H * T * D, 4 * B * H * T  # bytes of a tensor, lse
    product = 2 * B * H * T * T * D  # one T x T x D product, in FLOP
    moved = {"fwd": 4 * n, "fwd_lse": 4 * n + rows, "dq": 6 * n + rows,
             "dkv": 7 * n + rows}[work]
    flops = {"fwd": 2, "fwd_lse": 2, "dq": 3, "dkv": 4}[work] * product
    rate = (F32_SPLIT_FLOP_PER_S if dtype == torch.float32
            else BF16_FLOP_PER_S)
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = max(flops / rate, B * H * T * T / EXP_PER_S)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def device_ms(fn, n: int = 20) -> tuple[float, str]:
    """(device ms a call, its top kernels) of ``fn`` over ``n`` calls under
    torch.profiler: the device time of the kernels themselves, which an
    event window does not show where the host launches them more slowly
    than the card runs them (T=65), and the backend a library call took.
    The time is None where the profiler recorded no kernel."""
    fn()

    def run():
        for _ in range(n):
            fn()

    kernels, _ = profiled(run)
    if kernels is None:
        return None, "not measured"
    total = sum(a.self_device_time_total for a in kernels) / 1e3 / n
    return total, "; ".join(a.key[:80] for a in kernels[:3])


def profiled(run, trace: str | None = None):
    """(device kernel rows by device time, wall us) of ``run()`` under
    torch.profiler, and its chrome trace written to ``trace``.  The
    profiler at times hands back a window with none of the card's kernels
    in it; such a window is run again, up to ``PROFILE_TRIES`` times, and
    (None, None) comes back where every one was empty."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device rows carry no CPU time
        kernels = [a for a in prof.key_averages()
                   if a.self_device_time_total > 0
                   and a.self_cpu_time_total == 0]
        if kernels:
            kernels.sort(key=lambda a: a.self_device_time_total,
                         reverse=True)
            if trace:
                prof.export_chrome_trace(trace)
            return kernels, wall_us
    print(f"the profiler recorded no kernel of the card in "
          f"{PROFILE_TRIES} windows: not measured")
    return None, None


def ms_text(ms: float | None) -> str:
    """A device time as printed: ``device_ms`` gives None where the
    profiler recorded no kernel of the call."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def library_ms(shape, gen, iters: int, card: str) -> dict:
    """ms of the library's calls on bf16 (B, H, T, D) inputs, timed here
    and called nowhere in the port: ``F.scaled_dot_product_attention``
    forward ("fwd") and forward plus backward ("fwd+bwd"), and
    ``aten._scaled_dot_product_flash_attention`` ("fwd_lse"), the forward
    that also returns the (B, H, T) f32 logsumexp; each also as device time
    (key ``"<name> device"``).  Prints each call's kernels (its backend)
    and how far its lse is from the plain version's."""
    B, H, T, D = shape
    scale = 1.0 / math.sqrt(H * D)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    aten = torch.ops.aten
    o, lse, cq, ck, mq, mk, seed, offset, _ = \
        aten._scaled_dot_product_flash_attention(q, k, v, scale=scale)
    calls = {
        "fwd": lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
        "fwd+bwd": lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*leaves, scale=scale), leaves, g),
        "fwd_lse": lambda: aten._scaled_dot_product_flash_attention(
            q, k, v, scale=scale)[:2],
        # dq, dk and dv from (do, q, k, v, out, lse): the work of the dq
        # kernel and the dk/dv kernel together
        "bwd_pair": lambda: aten._scaled_dot_product_flash_attention_backward(
            g, q, k, v, o, lse, cq, ck, mq, mk, 0.0, False, seed, offset,
            scale=scale),
    }
    ms = {name: cuda_ms(fn, iters, min(10, iters))
          for name, fn in calls.items()}
    lse = calls["fwd_lse"]()[1]
    want = flash_attention_lse_reference(q, k, v, scale)[1]
    lse_err = (lse.float() - want).abs().max().item() \
        if lse.shape == want.shape else f"shape {tuple(lse.shape)}"
    for name, fn in calls.items():
        dev, kernels = device_ms(fn)
        ms[f"{name} device"] = dev
        print(f"library {name} {shape} bf16: {ms[name]:.4f} ms (windows of "
              f"{iters}), device {ms_text(dev)} ({card}); kernels: {kernels}")
    print(f"library lse vs the plain version's: max_abs_err {lse_err}")
    # the pair's yardstick computes what the plain passes compute
    out_bthd = o.transpose(1, 2)
    g_bthd = g.transpose(1, 2)
    want_lse = flash_attention_lse_reference(q, k, v, scale)[1]
    args = (q, k, v, out_bthd, g_bthd, want_lse, scale)
    want = (flash_tiled_bwd_dq_reference(*args),
            *flash_tiled_bwd_dkv_reference(*args))
    print("library bwd_pair (dq, dk, dv) vs the plain passes: max_abs_err "
          + ", ".join(f"{_max_err((a,), (w,)):.3e}"
                      for a, w in zip(calls["bwd_pair"](), want)))
    return ms


def kernel_phase(card: str) -> tuple[dict, dict]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = None
    for shape in SHAPES:
        B, H, T, D = shape
        scale = 1.0 / math.sqrt(H * D)  # the model's 1/sqrt(features)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            got = fused_attention(q, k, v, scale)
            want = fused_attention_reference(q, k, v, scale)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = KERNEL_TOL[dtype]
            torch.testing.assert_close(got, want, **tol)
            print(f"kernel check {shape} {str(dtype)[6:]}: max_abs_err "
                  f"{err:.3e} within rtol={tol['rtol']} atol={tol['atol']}")
            if shape == SHAPES[0] and dtype == torch.bfloat16:
                main_err = err

    # the model's shape in bf16, in turns: plain, kernel, kernel, plain
    B, H, T, D = SHAPES[0]
    q, k, v = (torch.randn(SHAPES[0], generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    scale = 1.0 / math.sqrt(H * D)
    times = {"kernel": [], "plain": []}
    fns = {"kernel": lambda: fused_attention(q, k, v, scale),
           "plain": lambda: fused_attention_reference(q, k, v, scale)}
    for _ in range(3):
        for name in ("plain", "kernel", "kernel", "plain"):
            times[name].append(cuda_ms(fns[name]))
    ms = {name: statistics.median(t) for name, t in times.items()}
    for name in ("kernel", "plain"):
        print(f"fused attention fwd {SHAPES[0]} bf16, {name}: "
              f"{ms[name]:.4f} ms (median of {len(times[name])} windows of "
              f"100), device {ms_text(device_ms(fns[name])[0])} ({card})")
    library = library_ms(SHAPES[0], gen, 100, card)
    print_against_earlier("mhsa_fwd", main_err)
    return {"name": "mhsa_fwd", "route": "cuda", "design": DESIGN["mhsa_fwd"],
            "source": "vit_cifar_torch/csrc/mhsa_fwd.cu",
            "replaces": "vit_cifar_tpu/ops/pallas/attention.py:90",
            "max_abs_err": main_err, "ms": ms["kernel"],
            "plain_ms": ms["plain"], **bound("mhsa_fwd", SHAPES[0]),
            "library_ms": library["fwd"]}, library


def flash_tol(kind: str, dtype, want: torch.Tensor) -> dict:
    """The flash phase's limit for ``kind`` ("fwd", "bwd" or "grad"):
    f32 as the earlier phases; bf16 a fraction of max |want|."""
    if dtype == torch.float32:
        return {"fwd": KERNEL_TOL, "bwd": BWD_TOL,
                "grad": GRAD_TOL}[kind][dtype]
    return dict(rtol=0.0, atol=FLASH_BF16_FRACTION[kind]
                * want.float().abs().max().item())


def _max_err(got, want) -> float:
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))


def training_kernel_phase(card: str, library: dict) -> list[dict]:
    """The whole-head forward with lse, the tiled dq and dk/dv passes on its
    residuals (the fused Function's backward), and the Function against
    autograd through the plain forward; then their times at the model's
    shape, where ``library`` holds the library's.  The tiled kernels' rows
    come from the flash phase, at the pixel model's shape."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    for shape in SHAPES:
        B, H, T, D = shape
        scale = 1.0 / math.sqrt(H * D)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            g = torch.randn((B, T, H, D), generator=gen,
                            device="cuda").to(dtype)
            out, lse = fused_attention_lse(q, k, v, scale)
            want_out, want_lse = fused_attention_lse_reference(q, k, v, scale)
            # each backward kernel reads the plain forward's out and lse, so
            # that it is held against its plain version on equal inputs
            args = (q, k, v, want_out, g, want_lse, scale)
            dq = flash_tiled_bwd_dq(*args)
            dk, dv = flash_tiled_bwd_dkv(*args)
            want_dq = flash_tiled_bwd_dq_reference(*args)
            want_dk, want_dv = flash_tiled_bwd_dkv_reference(*args)

            def grads(fn):
                leaves = [a.clone().requires_grad_() for a in (q, k, v)]
                return torch.autograd.grad(fn(*leaves, scale), leaves, g)

            fn_grads = grads(fused_attention)
            ag_grads = grads(fused_attention_reference)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, want_out, **KERNEL_TOL[dtype])
            torch.testing.assert_close(lse, want_lse,
                                       **KERNEL_TOL[torch.float32])
            torch.testing.assert_close(dq, want_dq, **BWD_TOL[dtype])
            torch.testing.assert_close(dk, want_dk, **BWD_TOL[dtype])
            torch.testing.assert_close(dv, want_dv, **BWD_TOL[dtype])
            for a, w in zip(fn_grads, ag_grads):
                torch.testing.assert_close(a, w, **GRAD_TOL[dtype])
            e = {"mhsa_fwd_lse": _max_err((out, lse), (want_out, want_lse)),
                 "flash_bwd_dq_tiled": _max_err((dq,), (want_dq,)),
                 "flash_bwd_dkv_tiled": _max_err((dk, dv), (want_dk, want_dv)),
                 "function": _max_err(fn_grads, ag_grads)}
            print(f"training kernels {shape} {str(dtype)[6:]}: max_abs_err "
                  + ", ".join(f"{n} {x:.3e}" for n, x in e.items())
                  + f" (tolerances: fwd {KERNEL_TOL[dtype]}, bwd "
                  f"{BWD_TOL[dtype]}, Function {GRAD_TOL[dtype]})")
            if shape == SHAPES[0] and dtype == torch.bfloat16:
                errs = e

    # the model's shape in bf16, each kernel against its plain version
    B, H, T, D = SHAPES[0]
    scale = 1.0 / math.sqrt(H * D)
    q, k, v = (torch.randn(SHAPES[0], generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    g = torch.randn((B, T, H, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    # out contiguous, as the forward kernel writes it for the main path's
    # backward: the plain forward's strided out would add a copy to every
    # backward launch
    out, lse = fused_attention_lse_reference(q, k, v, scale)
    args = (q, k, v, out.contiguous(), g, lse, scale)
    pairs = {
        "mhsa_fwd_lse": (lambda: fused_attention_lse(q, k, v, scale),
                         lambda: fused_attention_lse_reference(q, k, v,
                                                               scale)),
        "flash_bwd_dq_tiled": (lambda: flash_tiled_bwd_dq(*args),
                               lambda: flash_tiled_bwd_dq_reference(*args)),
        "flash_bwd_dkv_tiled": (lambda: flash_tiled_bwd_dkv(*args),
                                lambda: flash_tiled_bwd_dkv_reference(*args)),
    }
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(*leaves, scale), leaves, g)

    pairs["attention fwd+bwd"] = (fwd_bwd(fused_attention),
                                  fwd_bwd(fused_attention_reference))
    rows, pair_ms, pair_dev = [], {}, {}
    for name, (kernel, plain) in pairs.items():
        ms = in_turns({"kernel": kernel, "plain": plain})
        pair_dev[name] = device_ms(kernel)[0]
        line = (f"{name} {SHAPES[0]} bf16: kernel {ms['kernel']:.4f} ms, "
                f"plain {ms['plain']:.4f} ms (median of 6 windows of 100); "
                f"kernel device {ms_text(pair_dev[name])}")
        if name in KERNEL_WORK:
            b = bound(name, SHAPES[0])
            line += f"; bound {b['bound_ms']:.4f} ms by {b['bound_by']}"
        print(f"{line} ({card})")
        pair_ms[name] = ms["kernel"]
        if name == "flash_bwd_dkv_tiled":
            devs = (pair_dev["flash_bwd_dq_tiled"], pair_dev[name])
            pair_sum = None if None in devs else sum(devs)
            print(f"library dq+dk/dv pair {SHAPES[0]} bf16: "
                  f"{library['bwd_pair']:.4f} ms, device "
                  f"{ms_text(library['bwd_pair device'])}, against the tiled "
                  f"kernels' "
                  f"{pair_ms['flash_bwd_dq_tiled'] + ms['kernel']:.4f} ms, "
                  f"device {ms_text(pair_sum)} ({card})")
        if name == "mhsa_fwd_lse":
            print_against_earlier(name, errs[name])
            rows.append({"name": name, "route": "cuda",
                         "design": DESIGN[name],
                         "source": f"vit_cifar_torch/csrc/{SOURCES[name]}.cu",
                         "replaces": REPLACES[name],
                         "max_abs_err": errs[name], "ms": ms["kernel"],
                         "plain_ms": ms["plain"], **bound(name, SHAPES[0]),
                         "library_ms": library.get(KERNEL_WORK[name])})
    print(f"tiled pair at {SHAPES[0]} bf16 (the fused Function's backward): "
          f"max_abs_err dq {errs['flash_bwd_dq_tiled']:.3e}, dk/dv "
          f"{errs['flash_bwd_dkv_tiled']:.3e}")
    for name in BACKWARD_ROWS:
        print_against_earlier(name, errs[name], EARLIER_PAIR_AT_65, SHAPES[0])
    return rows


def device_activity(trace_path: str) -> tuple[float, int]:
    """(us of device activity, kernel launches) in a chrome trace; the
    activity is the union of kernel, copy and memset spans."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and "dur" in e)
    if not spans:
        raise AssertionError("the profiler saw no device activity")
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    kernels = sum(e.get("cat") == "kernel" for e in events)
    return busy, kernels


def flagship_cfg(**kw) -> Config:
    """The README recipe without AutoAugment, trained from epoch 0 on
    synthetic c10 at B=128 (``patch`` 8, T=65, unless ``kw`` says)."""
    return Config(**{"model_name": "vit", "num_layers": 7, "hidden": 384,
                     "mlp_hidden": 384, "head": 12, "batch_size": 128,
                     "label_smoothing": True, "warmup_epoch": 0,
                     "synthetic_data": True, **kw})


def training_setup(cfg: Config, n_train: int | None = None, raw=None):
    """What a training run of ``cfg`` needs, on the card, from the entry
    points a user calls: (raw data, x_train, y_train, model, state,
    train_step, perm), over the first ``n_train`` training images (all
    by default) of ``raw`` (default: ``cfg``'s data set, loaded here)."""
    if raw is None:
        raw = load_dataset(cfg.dataset, cfg.data_dir, cfg.synthetic_data)
    x_train = torch.from_numpy(raw.x_train[:n_train]).cuda()
    y_train = torch.from_numpy(raw.y_train[:n_train]).cuda()
    model, _ = get_model(cfg, device="cuda")
    tx = make_optimizer(cfg, len(x_train) // cfg.batch_size, model)
    state = init_state(cfg, model, tx)
    state.metrics_acc = make_metrics_zeros(cfg, "cuda")
    train_step = make_train_step(cfg, model, tx)
    perm = torch.randperm(len(x_train), device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(cfg.seed + 1))
    return raw, x_train, y_train, model, state, train_step, perm


def plain_twin(cfg: Config, model):
    """``model``'s weights in the plain-attention (einsum) model."""
    plain, _ = get_model(cfg.replace(pallas_kernel="einsum"), device="cuda")
    plain.load_state_dict(model.state_dict())
    return plain


def check_step(cfg: Config, model, plain, img, label, what: str,
               loss_atol: float = STEP_LOSS_ATOL,
               rel_l2: float = STEP_GRAD_REL_L2) -> None:
    """One step's loss and flat gradient on (img, label), the kernel path
    against the plain-attention path, within the step bounds (by default
    bf16-mixed's).  Run it before a path's launch counts are set to 0: its
    launches are not the path's."""
    criterion = make_criterion(cfg)

    def loss_and_grad(m):
        loss = criterion(m(img, deterministic=False), label)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        return loss.item(), torch.cat([g.reshape(-1) for g in grads])

    loss_k, grad_k = loss_and_grad(model)
    loss_p, grad_p = loss_and_grad(plain)
    rel = ((grad_k - grad_p).norm() / grad_p.norm()).item()
    print(f"{what}, kernel vs einsum path: loss {loss_k:.7f} vs {loss_p:.7f} "
          f"(|diff| {abs(loss_k - loss_p):.3e}, bound {loss_atol}); "
          f"gradient relative L2 {rel:.3e} (bound {rel_l2})")
    if not (abs(loss_k - loss_p) <= loss_atol and rel <= rel_l2):
        raise AssertionError(f"{what}: kernel path and einsum path disagree")


def training_phase(card: str) -> dict:
    cfg = flagship_cfg()
    t0 = time.perf_counter()
    raw, x_train, y_train, model, state, train_step, perm = \
        training_setup(cfg)
    steps_per_epoch = len(raw.x_train) // cfg.batch_size
    if steps_per_epoch != TRAIN_STEPS:
        raise AssertionError(f"{steps_per_epoch} steps per epoch")
    print(f"synthetic c10 on the card: x_train {tuple(x_train.shape)} uint8, "
          f"x_test {raw.x_test.shape}; set up in "
          f"{time.perf_counter() - t0:.1f} s")
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != PARAMS:
        raise AssertionError(f"{n_params} params, expected {PARAMS}")
    eval_step = make_eval_step(cfg, model)
    print(f"train: vit, 7 layers, hidden 384, 12 heads, {n_params} params, "
          f"{cfg.precision}, batch {cfg.batch_size}, label smoothing, "
          f"adam lr {cfg.lr}, warmup_epoch 0, no AutoAugment")

    img, label, _, _ = train_step.make_batch(state, x_train, y_train, perm, 0)
    check_step(cfg, model, plain_twin(cfg, model), img, label, "one step")

    # the main path starts here: every launch counted from now until the
    # last eval batch is the training path's
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    losses = torch.empty(TRAIN_STEPS, device="cuda")
    warm = 10
    for i in range(TRAIN_STEPS):
        if i == warm:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        state, metrics = train_step(state, x_train, y_train, perm, i)
        losses[i] = metrics["loss"]
        if i == 0:
            first = {n: w.launches for n, w in KERNEL_WRAPPERS.items()}
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_start) * 1e3 / (TRAIN_STEPS - warm)
    train_launches = {n: w.launches for n, w in KERNEL_WRAPPERS.items()}
    want = {n: 0 for n in KERNEL_WRAPPERS}
    # the fused Function: the whole-head forward, then the tiled pair
    want.update({"mhsa_fwd_lse": cfg.num_layers,
                 "flash_bwd_dq_tiled": cfg.num_layers,
                 "flash_bwd_dkv_tiled": cfg.num_layers})
    if first != want or train_launches != {
            n: c * TRAIN_STEPS for n, c in want.items()}:
        raise AssertionError(f"launches: first step {first}, epoch "
                             f"{train_launches}, expected {want} a step")
    losses = losses.cpu()
    acc = {k: v.item() for k, v in state.metrics_acc.items()}
    head, tail = losses[:20].mean().item(), losses[-20:].mean().item()
    print(f"epoch 0: {TRAIN_STEPS} steps, launches per step {first}; loss "
          f"first 20 steps {head:.4f}, last 20 {tail:.4f}; epoch-mean loss "
          f"{acc['loss'] / TRAIN_STEPS:.4f}, acc "
          f"{acc['acc'] / TRAIN_STEPS:.4f}, skipped "
          f"{acc['skipped_nonfinite']:.0f}")
    if not torch.isfinite(losses).all():
        raise AssertionError("a training loss is not finite")
    if not tail < head or acc["skipped_nonfinite"] != 0:
        raise AssertionError("training loss did not fall")
    print(f"train step: {step_ms:.3f} ms mean over steps {warm}-"
          f"{TRAIN_STEPS - 1} (host clock, synchronized), "
          f"{cfg.batch_size / step_ms * 1e3:.1f} img/s at B={cfg.batch_size}"
          f" without AutoAugment ({card})")

    x_test, y_test, mask, n_eval = _pad_eval(raw.x_test, raw.y_test,
                                             cfg.eval_batch_size)
    x_test, y_test, mask = (torch.from_numpy(a).cuda()
                            for a in (x_test, y_test, mask))
    eb = cfg.eval_batch_size
    sums = {"loss_sum": 0.0, "correct_sum": 0.0, "count": 0.0}
    for b in range(n_eval):
        out = eval_step(x_test[b * eb:(b + 1) * eb],
                        y_test[b * eb:(b + 1) * eb], mask[b * eb:(b + 1) * eb])
        sums = {k: sums[k] + out[k] for k in sums}
    sums = {k: float(v) for k, v in sums.items()}
    launches = {n: w.launches for n, w in KERNEL_WRAPPERS.items()}
    eval_launches = launches["mhsa_fwd"]
    val_acc = sums["correct_sum"] / sums["count"]
    val_loss = sums["loss_sum"] / sums["count"]
    print(f"eval: {n_eval} batches of {eb} ({int(sums['count'])} images, "
          f"last batch masked), {eval_launches} launches of mhsa_fwd; "
          f"val_loss {val_loss:.4f}, val_acc {val_acc:.4f}")
    if n_eval != 40 or sums["count"] != len(raw.x_test):
        raise AssertionError(f"eval over {n_eval} batches, {sums['count']}")
    if eval_launches != cfg.num_layers * n_eval or {
            n: c for n, c in launches.items() if n != "mhsa_fwd"} != {
            n: c for n, c in train_launches.items() if n != "mhsa_fwd"}:
        raise AssertionError(f"eval launches {launches}")
    if not (math.isfinite(val_loss) and val_acc >= MIN_VAL_ACC):
        raise AssertionError(f"val_acc {val_acc} under {MIN_VAL_ACC}")

    # device busy share and top device ops over 20 more steps
    STEP_KERNELS["flagship"] = profile_steps(
        lambda i: train_step(state, x_train, y_train, perm, i), 20,
        "train_trace.json", step_ms, card)["kernels"]
    return launches, step_ms


def profile_steps(step, n_prof: int, trace_name: str, step_ms: float,
                  card: str) -> dict:
    """Run ``step(i)`` ``n_prof`` times under torch.profiler; print the
    device activity a step, the busy share against the unprofiled
    ``step_ms`` and the top device kernels, and return them a step:
    ``device_ms``, ``profiled_ms``, ``kernels``, ``busy`` and
    ``by_kernel`` (device ms of each kernel), each None where the profiler
    recorded no kernel (``profiled``)."""
    trace = os.path.join(WORK, trace_name)
    os.makedirs(WORK, exist_ok=True)

    def run():
        for i in range(n_prof):
            step(i)

    kernels, wall_us = profiled(run, trace)
    if kernels is None:
        print(f"profiled {n_prof} train steps: device activity not measured "
              f"({card})")
        return dict.fromkeys(("device_ms", "profiled_ms", "kernels", "busy",
                              "by_kernel"))
    busy_us, n_kernels = device_activity(trace)
    dev_ms = busy_us / 1e3 / n_prof
    print(f"profiled {n_prof} train steps: {n_kernels / n_prof:.1f} kernels "
          f"and {dev_ms:.3f} ms of device activity a step; "
          f"{wall_us / 1e3 / n_prof:.3f} ms a step under the profiler (busy "
          f"share {busy_us / wall_us:.3f}); against the unprofiled step, "
          f"device busy share {dev_ms / step_ms:.3f} ({card})")
    for a in kernels[:12]:
        print(f"  {a.self_device_time_total / 1e3 / n_prof:8.4f} ms/step "
              f"{a.count / n_prof:6.1f}x/step  {a.key[:90]}")
    return {"device_ms": dev_ms, "profiled_ms": wall_us / 1e3 / n_prof,
            "kernels": n_kernels / n_prof, "busy": dev_ms / step_ms,
            "by_kernel": {a.key: a.self_device_time_total / 1e3 / n_prof
                          for a in kernels}}


def _post(url: str, kind: str, imgs: np.ndarray) -> dict:
    if kind == "npy":
        buf = io.BytesIO()
        np.save(buf, imgs)
        data, ctype = buf.getvalue(), "application/octet-stream"
    else:
        data, ctype = json.dumps({"images": imgs.tolist()}).encode(), \
            "application/json"
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def serving_phase(card: str) -> int:
    # the main path starts here: every launch counted from now until the last
    # request is the served model's
    fused_attention.launches = 0
    cfg = Config(model_name="vit", num_layers=7, hidden=384, mlp_hidden=384,
                 head=12)
    model, _ = get_model(cfg, generator=torch.Generator().manual_seed(cfg.seed))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != PARAMS:
        raise AssertionError(f"{n_params} params, expected {PARAMS}")
    print(f"model: vit, 7 layers, hidden 384, 12 heads, {n_params} params, "
          f"{cfg.precision}")

    shutil.rmtree(WORK, ignore_errors=True)
    ckpt = os.path.join(WORK, "ckpt")
    save_checkpoint(ckpt, {"params": model.state_dict()}, cfg)
    t_export = time.perf_counter()
    art = export_inference(ckpt, os.path.join(WORK, "art"), device="cuda")
    print(f"exported serving.pt2 in {time.perf_counter() - t_export:.1f} s; "
          f"its graph calls {graph_ops(art)}")

    # the reference, rebuilt from the checkpoint: the artifact holds no
    # module of the port
    payload, ckpt_cfg = load_checkpoint(ckpt)
    plain, _ = get_model(ckpt_cfg.replace(pallas_kernel="einsum"),
                         device="cuda")
    plain.load_state_dict(payload["params"])
    plain.eval().requires_grad_(False)
    dtype = torch_dtype(cfg)

    def plain_logits(imgs):
        with torch.inference_mode():
            x = normalize(torch.from_numpy(imgs).cuda(), cfg.mean, cfg.std)
            return plain(x.to(dtype)).float().cpu().numpy()

    srv = make_http_server(art, port=0, device="cuda")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        if _get(f"{base}/healthz") != {"ok": True}:
            raise AssertionError("/healthz")
        meta = _get(f"{base}/meta")
        if meta["model_name"] != "vit" or meta["output"] != "float32[b,10]":
            raise AssertionError(f"/meta: {meta}")
        print(f"/healthz ok; /meta: device {meta['device']}, "
              f"{meta['bytes']} bytes of weights")

        rng = np.random.default_rng(0)
        batches = [rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8)
                   for _, B in REQUESTS]
        responses, per_request = [], []
        for (kind, _), imgs in zip(REQUESTS, batches):
            before = fused_attention.launches
            responses.append(_post(f"{base}/predict", kind, imgs))
            per_request.append(fused_attention.launches - before)
        launches = fused_attention.launches

        for (kind, B), imgs, resp, n in zip(REQUESTS, batches, responses,
                                            per_request):
            logits = np.asarray(resp["logits"], np.float64)
            if logits.shape != (B, cfg.num_classes):
                raise AssertionError(f"logits shape {logits.shape}")
            if not np.array_equal(logits, logits.astype(np.float32)):
                raise AssertionError("logits are not float32 values")
            if not np.isfinite(logits).all():
                raise AssertionError("non-finite logits")
            if resp["pred"] != logits.argmax(-1).tolist():
                raise AssertionError("pred != argmax(logits)")
            if n != cfg.num_layers:
                raise AssertionError(
                    f"{n} kernel launches for one request, expected "
                    f"{cfg.num_layers}")
            want = plain_logits(imgs)
            np.testing.assert_allclose(logits, want, **LOGIT_TOL)
            agree = float((logits.argmax(-1) == want.argmax(-1)).mean())
            print(f"POST /predict {kind} B={B}: logits ({B}, 10) f32 finite, "
                  f"{n} kernel launches, max |served - plain| "
                  f"{np.abs(logits - want).max():.3e} within "
                  f"rtol={LOGIT_TOL['rtol']} atol={LOGIT_TOL['atol']}, "
                  f"top-1 agreement {agree:.3f}")
        print(f"main path: {launches} launches of mhsa_fwd over "
              f"{len(REQUESTS)} requests")

        served = ServingModel(art, device="cuda")
        for B in (1, 128):
            imgs = batches[[b for _, b in REQUESTS].index(B)]
            http = host_ms(lambda: _post(f"{base}/predict", "npy", imgs), 30)
            x = torch.from_numpy(imgs).cuda()

            def forward():
                with torch.inference_mode():
                    served.infer(x).cpu()

            local = host_ms(forward, 30)
            print(f"latency B={B}: POST /predict median {http:.3f} ms, "
                  f"in-process forward median {local:.3f} ms ({card})")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    return launches


def flash_kernel_phase(card: str) -> list[dict]:
    """The tiled kernels and the Function against their plain versions at
    every shape of ``FLASH_SHAPES`` in f32 and bf16, then their times, and
    the library's, at the pixel model's shape in bf16."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs = {}
    for shape in FLASH_SHAPES:
        B, H, T, D = shape
        scale = 1.0 / math.sqrt(H * D)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            g = torch.randn((B, T, H, D), generator=gen,
                            device="cuda").to(dtype)
            inference = flash_attention(q, k, v, scale)
            out, lse = flash_attention_lse(q, k, v, scale)
            want_out, want_lse = flash_attention_lse_reference(q, k, v, scale)
            # each backward kernel reads the plain forward's out and lse, so
            # that it is held against its plain version on equal inputs
            args = (q, k, v, want_out, g, want_lse, scale)
            dq = flash_tiled_bwd_dq(*args)
            dk, dv = flash_tiled_bwd_dkv(*args)
            want = (flash_tiled_bwd_dq_reference(*args),
                    *flash_tiled_bwd_dkv_reference(*args))
            # the Function's plain version is the plain forward, then the
            # plain passes: ``want``
            leaves = [a.clone().requires_grad_() for a in (q, k, v)]
            fn_grads = torch.autograd.grad(flash_attention(*leaves, scale),
                                           leaves, g)
            del leaves
            torch.cuda.synchronize()
            tol = {"fwd": flash_tol("fwd", dtype, want_out),
                   "bwd": [flash_tol("bwd", dtype, w) for w in want],
                   "grad": [flash_tol("grad", dtype, w) for w in want]}
            torch.testing.assert_close(inference, want_out, **tol["fwd"])
            torch.testing.assert_close(out, want_out, **tol["fwd"])
            torch.testing.assert_close(lse, want_lse,
                                       **KERNEL_TOL[torch.float32])
            for got, w, t in zip((dq, dk, dv), want, tol["bwd"]):
                torch.testing.assert_close(got, w, **t)
            for got, w, t in zip(fn_grads, want, tol["grad"]):
                torch.testing.assert_close(got, w, **t)
            e = {"flash_fwd": _max_err((inference,), (want_out,)),
                 "flash_fwd_lse": _max_err((out, lse), (want_out, want_lse)),
                 "flash_bwd_dq_tiled": _max_err((dq,), want[:1]),
                 "flash_bwd_dkv_tiled": _max_err((dk, dv), want[1:]),
                 "function": _max_err(fn_grads, want)}
            print(f"flash kernels {shape} {str(dtype)[6:]}: max_abs_err "
                  + ", ".join(f"{n} {x:.3e}" for n, x in e.items())
                  + f" (atol: fwd {tol['fwd']['atol']:.3e}, dq/dk/dv "
                  + "/".join(f"{t['atol']:.3e}" for t in tol["bwd"])
                  + ", Function "
                  + "/".join(f"{t['atol']:.3e}" for t in tol["grad"])
                  + f"; rtol {tol['fwd']['rtol']}, {tol['bwd'][0]['rtol']},"
                  f" {tol['grad'][0]['rtol']})")
            if shape == PIXEL_SHAPE and dtype == torch.bfloat16:
                errs = e
            # the whole-head forward's both variants on the streamed
            # instance (bf16; its f32 instance f32_wide_checks holds)
            if D > WIDEST_FORWARD and dtype == torch.bfloat16:
                want_out, want_lse = fused_attention_lse_reference(q, k, v,
                                                                   scale)
                got = (fused_attention(q, k, v, scale),
                       *fused_attention_lse(q, k, v, scale))
                torch.cuda.synchronize()
                for a, w in zip(got, (want_out, want_out, want_lse)):
                    torch.testing.assert_close(
                        a, w, **(KERNEL_TOL[torch.float32]
                                 if w.dtype == torch.float32
                                 else flash_tol("fwd", dtype, w)))
                print(f"  mhsa_fwd, mhsa_fwd_lse {shape} {str(dtype)[6:]}: "
                      "max_abs_err "
                      f"{_max_err(got[:1], (want_out,)):.3e}, "
                      f"{_max_err(got[1:], (want_out, want_lse)):.3e}")
            del q, k, v, g, inference, out, lse, want_out, want_lse, args, \
                dq, dk, dv, want, fn_grads, tol
        torch.cuda.empty_cache()

    # the pixel model's shape in bf16, each kernel against its plain
    # version in turns; a launch takes tens of ms, so windows of 3
    B, H, T, D = PIXEL_SHAPE
    scale = 1.0 / math.sqrt(H * D)
    q, k, v = (torch.randn(PIXEL_SHAPE, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    g = torch.randn((B, T, H, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    out, lse = flash_attention_lse_reference(q, k, v, scale)
    args = (q, k, v, out.contiguous(), g, lse, scale)  # as the forward writes
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]

    def plain_fwd_bwd():
        o, l = flash_attention_lse_reference(q, k, v, scale)
        flash_tiled_bwd_dq_reference(q, k, v, o, g, l, scale)
        flash_tiled_bwd_dkv_reference(q, k, v, o, g, l, scale)

    pairs = {
        "flash_fwd": (lambda: flash_attention(q, k, v, scale),
                      lambda: flash_attention_reference(q, k, v, scale)),
        "flash_fwd_lse": (lambda: flash_attention_lse(q, k, v, scale),
                          lambda: flash_attention_lse_reference(q, k, v,
                                                                scale)),
        "flash_bwd_dq_tiled": (lambda: flash_tiled_bwd_dq(*args),
                               lambda: flash_tiled_bwd_dq_reference(*args)),
        "flash_bwd_dkv_tiled": (lambda: flash_tiled_bwd_dkv(*args),
                                lambda: flash_tiled_bwd_dkv_reference(*args)),
        "flash attention fwd+bwd": (
            lambda: torch.autograd.grad(flash_attention(*leaves, scale),
                                        leaves, g),
            plain_fwd_bwd),
    }
    library = library_ms(PIXEL_SHAPE, gen, 10, card)
    rows = []
    for name, (kernel, plain) in pairs.items():
        ms = in_turns({"kernel": kernel, "plain": plain}, rounds=2, iters=3)
        line = (f"{name} {PIXEL_SHAPE} bf16: kernel {ms['kernel']:.4f} ms, "
                f"plain {ms['plain']:.4f} ms (median of 4 windows of 3")
        if name not in REPLACES:
            print(f"{line}; SDPA fwd+bwd {library['fwd+bwd']:.4f} ms; "
                  f"library dq+dk/dv pair {library['bwd_pair']:.4f} ms; "
                  f"{card})")
            continue
        b = bound(name, PIXEL_SHAPE)
        print(f"{line}; bound {b['bound_ms']:.4f} ms by {b['bound_by']}; "
              f"{card})")
        if name in EARLIER_MAX_ABS_ERR:
            print_against_earlier(name, errs[name])
        rows.append({"name": name, "route": "cuda", "design": DESIGN[name],
                     "source": f"vit_cifar_torch/csrc/{SOURCES[name]}.cu",
                     "replaces": REPLACES[name], "max_abs_err": errs[name],
                     "ms": ms["kernel"], "plain_ms": ms["plain"], **b,
                     # no one PyTorch call computes dq or dk/dv alone
                     "library_ms": library.get(KERNEL_WORK[name])})
    return rows


def print_against_earlier(name: str, err: float,
                          earlier: dict = EARLIER_MAX_ABS_ERR,
                          shape=None) -> None:
    """A row's bf16 max_abs_err at a main shape beside the earlier
    design's (``EARLIER_MAX_ABS_ERR``); the backward pair's must be no
    worse."""
    was = ("the CUDA-core design's, PERF.md" if name not in BACKWARD_ROWS
           else "the warp-level mma design's on the same inputs")
    print(f"{name} bf16 at {shape or 'its main shape'}: max_abs_err "
          f"{err:.3e} ({DESIGN[name]}) against {earlier[name]:.3e} ({was})")
    if name in BACKWARD_ROWS and err > earlier[name]:
        raise AssertionError(f"{name}: max_abs_err {err:.3e} is worse than "
                             f"the earlier design's {earlier[name]:.3e}")


def ragged_edge_phase() -> None:
    """The bf16 (tensor-core) instances of both forwards, with and without
    lse, and of the tiled dq and dk/dv kernels against their plain versions
    at every (T, D) of RAGGED_T x RAGGED_D: ``KERNEL_TOL`` for the
    whole-head kernel, ``flash_tol`` ("fwd" or "bwd", the latter no tighter
    than ``RAGGED_BWD_ATOL_FLOOR``) for the tiled ones, lse at f32's
    1e-5."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    B, H = RAGGED_BH
    worst = {}
    for T in RAGGED_T:
        for D in RAGGED_D:
            scale = 1.0 / math.sqrt(H * D)
            q, k, v = (torch.randn((B, H, T, D), generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(3))
            g = torch.randn((B, T, H, D), generator=gen,
                            device="cuda").to(torch.bfloat16)
            mhsa = fused_attention_lse_reference(q, k, v, scale)
            flash = flash_attention_lse_reference(q, k, v, scale)
            args = (q, k, v, flash[0], g, flash[1], scale)
            bwd = (flash_tiled_bwd_dq_reference(*args),
                   *flash_tiled_bwd_dkv_reference(*args))
            # the same values in the model's layout: (B, H, T, D) views of
            # (B, T, H, D) tensors, which the forwards read in place
            qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2)
                          for t in (q, k, v))
            # name: (the kernel's outputs, its plain version's)
            checks = {
                "mhsa_fwd": ((fused_attention(q, k, v, scale),), mhsa[:1]),
                "mhsa_fwd_lse": (fused_attention_lse(q, k, v, scale), mhsa),
                "flash_fwd": ((flash_attention(q, k, v, scale),), flash[:1]),
                "flash_fwd_lse": (flash_attention_lse(q, k, v, scale), flash),
                "mhsa_fwd strided": ((fused_attention(qs, ks, vs, scale),),
                                     mhsa[:1]),
                "mhsa_fwd_lse strided": (fused_attention_lse(qs, ks, vs,
                                                             scale), mhsa),
                "flash_fwd strided": ((flash_attention(qs, ks, vs, scale),),
                                      flash[:1]),
                "flash_fwd_lse strided": (flash_attention_lse(qs, ks, vs,
                                                              scale), flash),
                "flash_bwd_dq_tiled": ((flash_tiled_bwd_dq(*args),), bwd[:1]),
                "flash_bwd_dkv_tiled": (flash_tiled_bwd_dkv(*args), bwd[1:]),
            }
            torch.cuda.synchronize()
            for name, (outs, wants) in checks.items():
                for got, want in zip(outs, wants):
                    if want.dtype == torch.float32:  # lse
                        tol = KERNEL_TOL[torch.float32]
                    elif name.startswith("mhsa"):
                        tol = KERNEL_TOL[torch.bfloat16]
                    elif "bwd" in name:
                        tol = flash_tol("bwd", torch.bfloat16, want)
                        tol["atol"] = max(tol["atol"], ragged_bwd_floor(D))
                    else:
                        tol = flash_tol("fwd", torch.bfloat16, want)
                    torch.testing.assert_close(
                        got, want, **tol,
                        msg=lambda m: f"{name} T={T} D={D}: {m}")
                worst[name] = max(worst.get(name, 0.0), _max_err(outs, wants))
    print(f"ragged edges: {len(RAGGED_T) * len(RAGGED_D)} shapes ({B}, {H}, "
          f"T, D), T in {RAGGED_T}, D in {RAGGED_D}, bf16, the forwards also "
          "on strided views: every "
          "instance within its limits (mhsa_* rtol=atol=1e-2, flash_* 1% of "
          f"max |out| or max |grad| (at least {RAGGED_BWD_ATOL_FLOOR} per 128 "
          "columns), lse "
          "1e-5); worst max_abs_err "
          + ", ".join(f"{n} {e:.3e}" for n, e in worst.items()))
    masked_tile_check()


def masked_tile_check() -> None:
    """Both bf16 forwards with lse where the key tile the kernel takes
    first has logits that all overflow to -inf (q = 1e20, k = -1e20) and
    the tiles before it finite keys: the running max stays at -inf through
    that tile without a NaN, and out and lse equal the plain version's."""
    from vit_cifar_torch.ops.cuda.common import forward_plan

    gen = torch.Generator(device="cuda").manual_seed(8)
    for shape in MASKED_TILE_SHAPES:
        B, H, T, D = shape
        q = torch.full(shape, 1e20, device="cuda").to(torch.bfloat16)
        k = (torch.randn(shape, generator=gen, device="cuda")
             * 1e-20).to(torch.bfloat16)
        v = torch.randn(shape, generator=gen,
                        device="cuda").to(torch.bfloat16)
        for name, fwd_lse, plain in (
                ("mhsa_fwd", fused_attention_lse,
                 fused_attention_lse_reference),
                ("flash_fwd", flash_attention_lse,
                 flash_attention_lse_reference)):
            keys = forward_plan(name, T, D)["rows"]["k"]
            first = (T - 1) // keys * keys
            assert first > 0, (name, shape)
            km = k.clone()
            km[:, :, first:] = -1e20
            out, lse = fwd_lse(q, km, v, 0.1)
            want_out, want_lse = plain(q, km, v, 0.1)
            torch.cuda.synchronize()
            if not (torch.isfinite(out.float()).all()
                    and torch.isfinite(lse).all()):
                raise AssertionError(f"{name} {shape}: a NaN or inf after "
                                     "a fully masked key tile")
            torch.testing.assert_close(out, want_out,
                                       **KERNEL_TOL[torch.bfloat16])
            torch.testing.assert_close(lse, want_lse,
                                       **KERNEL_TOL[torch.float32])
    print(f"fully masked first key tile: mhsa_fwd_lse and flash_fwd_lse at "
          f"{MASKED_TILE_SHAPES} finite and within their limits (bf16 "
          "rtol=atol=1e-2, lse 1e-5)")


def model_views(shape, gen, dtype=torch.bfloat16) -> list:
    """q, k, v (bf16 unless ``dtype`` says) as the model makes them: (B,
    T, H*D) projections viewed as (B, H, T, D)."""
    B, H, T, D = shape
    return [torch.randn((B, T, H * D), generator=gen, device="cuda")
            .to(dtype).view(B, T, H, D).transpose(1, 2) for _ in range(3)]


def host_us(fn, n: int = HOST_CALLS) -> float:
    """Median host microseconds of one call of ``fn`` (which only
    enqueues work), over ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def forward_timing_phase(card: str) -> None:
    """Each bf16 forward against its library call on the same inputs (the
    model's transposed views) at ``FORWARD_TIMING_SHAPES``: SDPA for the
    inference forwards, ``aten._scaled_dot_product_flash_attention`` for
    the forwards with lse; in turns (kernel, library, library, kernel) by
    CUDA events, and by device time (torch.profiler) at T=65, where an
    event window follows the host.  Then the host microseconds a forward
    call costs at the flagship's shape, beside the three q, k, v copies
    the forward made before it read the views in place.  Past 256 columns
    (``CHUNK_TIMING_SHAPES``) the wgmma forwards' column chunks, each held
    first against its plain version at ``CHUNK_CHECK_BATCH``, against SDPA
    with the bound and the instance's ptxas report beside them; past 512
    (``STREAMED_TIMING_SHAPES``) the streamed instance the same way."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    aten = torch.ops.aten
    for shape in FORWARD_TIMING_SHAPES:
        B, H, T, D = shape
        scale = 1.0 / math.sqrt(H * D)
        q, k, v = model_views(shape, gen)
        library = {
            "fwd": lambda: F.scaled_dot_product_attention(q, k, v,
                                                          scale=scale),
            "fwd_lse": lambda: aten._scaled_dot_product_flash_attention(
                q, k, v, scale=scale)[:2]}
        kernels = {"mhsa_fwd": lambda: fused_attention(q, k, v, scale),
                   "mhsa_fwd_lse": lambda: fused_attention_lse(q, k, v,
                                                               scale),
                   "flash_fwd": lambda: flash_attention(q, k, v, scale),
                   "flash_fwd_lse": lambda: flash_attention_lse(q, k, v,
                                                                scale)}
        for name, kernel in kernels.items():
            lib = library[KERNEL_WORK[name]]
            if T <= 65:
                ms = {"kernel": device_ms(kernel)[0],
                      "library": device_ms(lib)[0]}
                how = "device ms, torch.profiler"
            else:
                iters = max(3, min(50, round(20 / (B * H * T * T / 1e9))))
                ms = in_turns({"kernel": kernel, "library": lib}, rounds=2,
                              iters=iters)
                how = f"median of 4 event windows of {iters}"
            b = bound(name, shape)
            ratio = (f"{ms['kernel'] / ms['library']:.3f}x the library"
                     if None not in ms.values() else "ratio not measured")
            print(f"forward {name} {shape} bf16: kernel "
                  f"{ms_text(ms['kernel'])}, library "
                  f"{ms_text(ms['library'])} ({ratio}; {how}); bound "
                  f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({card})")
        del q, k, v, library, kernels
        torch.cuda.empty_cache()

    # past 256 columns: the wgmma kernel's column chunks of o (two a query
    # tile at 320-512 columns, each computing the softmax); past 512 the
    # streamed instance (s summed over 64-column chunks of q and K)
    from vit_cifar_torch.ops.cuda.common import forward_plan

    for shape in (*CHUNK_TIMING_SHAPES, *STREAMED_TIMING_SHAPES):
        B, H, T, D = shape
        scale = 1.0 / math.sqrt(H * D)
        small = model_views((CHUNK_CHECK_BATCH, H, T, D), gen)
        q, k, v = model_views(shape, gen)
        for name, fwd, fwd_lse, plain in (
                ("flash_fwd", flash_attention, flash_attention_lse,
                 flash_attention_lse_reference),
                ("mhsa_fwd", fused_attention, fused_attention_lse,
                 fused_attention_lse_reference)):
            out, lse = fwd_lse(*small, scale)
            want_out, want_lse = plain(*small, scale)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                out, want_out, **flash_tol("fwd", torch.bfloat16, want_out),
                msg=lambda m: f"{name} {shape}: {m}")
            torch.testing.assert_close(lse, want_lse,
                                       **KERNEL_TOL[torch.float32])
            err = (out.float() - want_out.float()).abs().max().item()
            plan = forward_plan(name, T, D)
            design = (f"wgmma {plan['grid']}, {plan['chunks']} chunks of "
                      f"{plan['cols']} columns, {forward_ptxas(name, shape)}")
            ms = in_turns({"kernel": lambda: fwd(q, k, v, scale),
                           "library": lambda: F.scaled_dot_product_attention(
                               q, k, v, scale=scale)}, rounds=2, iters=10)
            b = bound(name, shape)
            print(f"forward {name} {shape} bf16 ({design}): kernel "
                  f"{ms['kernel']:.4f} ms, SDPA {ms['library']:.4f} ms "
                  f"({ms['kernel'] / ms['library']:.3f}x the library; "
                  f"median of 4 event windows of 10); bound "
                  f"{b['bound_ms']:.4f} ms by {b['bound_by']}; with lse at "
                  f"B={CHUNK_CHECK_BATCH} max_abs_err {err:.3e} against the "
                  f"plain version ({card})")
        print(f"SDPA {shape} bf16 runs (its backend, torch.profiler): "
              + device_ms(lambda: F.scaled_dot_product_attention(
                  q, k, v, scale=scale), n=3)[1])
        del q, k, v, small
        torch.cuda.empty_cache()

    from vit_cifar_torch.ops.cuda.common import readable

    q, k, v = model_views((128, 12, 65, 32), gen)
    calls = {"fused_attention": lambda: fused_attention(q, k, v, 0.05),
             "fused_attention_lse": lambda: fused_attention_lse(q, k, v,
                                                                0.05),
             "flash_attention": lambda: flash_attention(q, k, v, 0.05),
             "of it the views' plan (readable)":
                 lambda: readable(q, k, v),
             "the three copies of q, k, v the forward made before":
                 lambda: [t.contiguous() for t in (q, k, v)]}
    print("host microseconds a call at (128, 12, 65, 32) bf16 on the "
          f"model's views (median of {HOST_CALLS}): "
          + "; ".join(f"{n} {host_us(fn):.1f}" for n, fn in calls.items())
          + f" ({card})")


def tiled_vs_whole_head(card: str) -> None:
    """The whole-head forwards, and the fused Function (whole-head forward,
    tiled backward), against their tiled counterparts, in turns, at
    (128, 12, T, 32) bf16 for each T of ``ROUTE_T``: the measurement behind
    ``route``'s choice of the whole-head forward wherever it fits."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    for T in ROUTE_T:
        B, H, D = 128, 12, 32
        scale = 1.0 / math.sqrt(H * D)
        q, k, v = (torch.randn((B, H, T, D), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        g = torch.randn((B, T, H, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]

        def fwd_bwd(fn):
            return lambda: torch.autograd.grad(fn(*leaves, scale), leaves, g)

        pairs = {
            "fwd": (lambda: fused_attention(q, k, v, scale),
                    lambda: flash_attention(q, k, v, scale)),
            "fwd_lse": (lambda: fused_attention_lse(q, k, v, scale),
                        lambda: flash_attention_lse(q, k, v, scale)),
            "fwd+bwd": (fwd_bwd(fused_attention), fwd_bwd(flash_attention)),
        }
        iters = max(3, round(100 * (65 / T) ** 2))
        for name, (whole, tiled) in pairs.items():
            ms = in_turns({"whole-head": whole, "tiled": tiled}, rounds=2,
                          iters=iters)
            print(f"route timing ({B}, {H}, {T}, {D}) bf16 {name}: "
                  f"whole-head {ms['whole-head']:.4f} ms, tiled "
                  f"{ms['tiled']:.4f} ms, tiled/whole-head "
                  f"{ms['tiled'] / ms['whole-head']:.3f} (median of 4 "
                  f"windows of {iters}; {card})")
        del q, k, v, g, leaves, pairs


def einsum_attention(q, k, v, scale: float) -> torch.Tensor:
    """The einsum path of ``ops/attention.py``: logits in the input dtype,
    an f32 softmax cast back, the (B, T, H, D) context."""
    logits = torch.einsum("bhid,bhjd->bhij", q, k) * scale
    attn = torch.softmax(logits.float(), -1).to(q.dtype)
    return torch.einsum("bhij,bhjd->bihd", attn, v)


def head_dim_timing(card: str) -> None:
    """The tiled kernels at ``HEAD_DIM_SHAPES`` in bf16, each beside its
    bound and the library's call on the same inputs, and the tiled
    Function's forward+backward beside the einsum path's and SDPA's: up to
    128 columns one block holds a row's whole head, past it each 128-column
    chunk of the output has its own block."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape in HEAD_DIM_SHAPES:
        B, H, T, D = shape
        scale = 1.0 / math.sqrt(H * D)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        g = torch.randn((B, T, H, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        out, lse = flash_attention_lse(q, k, v, scale)
        args = (q, k, v, out, g, lse, scale)
        iters = 20
        ms = {"flash_fwd": cuda_ms(lambda: flash_attention(q, k, v, scale),
                                   iters),
              "flash_fwd_lse": cuda_ms(
                  lambda: flash_attention_lse(q, k, v, scale), iters),
              "flash_bwd_dq_tiled": cuda_ms(lambda: flash_tiled_bwd_dq(*args),
                                            iters),
              "flash_bwd_dkv_tiled": cuda_ms(
                  lambda: flash_tiled_bwd_dkv(*args), iters)}
        library = library_ms(shape, gen, iters, card)
        lib_of = {"flash_fwd": library["fwd"],
                  "flash_fwd_lse": library["fwd_lse"]}
        for name, t in ms.items():
            b = bound(name, shape)
            lib = lib_of.get(name)
            print(f"head dim {shape} bf16 {name}: {t:.4f} ms (windows of "
                  f"{iters}); bound {b['bound_ms']:.4f} ms by "
                  f"{b['bound_by']}; library "
                  + (f"{lib:.4f} ms" if lib is not None else "none alone")
                  + f" ({card})")
        print(f"head dim {shape} bf16 dq + dk/dv pair: "
              f"{ms['flash_bwd_dq_tiled'] + ms['flash_bwd_dkv_tiled']:.4f} "
              f"ms; library backward {library['bwd_pair']:.4f} ms ({card})")
        # forward + backward of the tiled Function against the plain einsum
        # attention of ``ops/attention.py`` (bf16 logits and probabilities)
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        fwd_bwd = {
            name: cuda_ms(lambda fn=fn: torch.autograd.grad(
                fn(*leaves, scale), leaves, g), iters)
            for name, fn in (("tiled", flash_attention),
                             ("einsum", einsum_attention))}
        print(f"head dim {shape} bf16 fwd+bwd: tiled Function "
              f"{fwd_bwd['tiled']:.4f} ms, einsum path {fwd_bwd['einsum']:.4f}"
              f" ms, SDPA {library['fwd+bwd']:.4f} ms ({card})")
        del q, k, v, g, out, lse, args, leaves
        torch.cuda.empty_cache()


def backward_timing_phase(card: str) -> None:
    """The bf16 tiled dq and dk/dv passes on the model's views (q, k, v
    transposed (B, T, H, D) projections, o and lse as the forward kernel
    returns them, a (B, T, H, D) cotangent) against the library's backward,
    ``aten._scaled_dot_product_flash_attention_backward`` on the same views
    and its own forward's residuals, at ``BACKWARD_TIMING_SHAPES``: the pair
    and the library in turns (pair, library, library, pair) by CUDA events,
    and by device time (torch.profiler) at T=65, where an event window
    follows the host; each pass, and the pair, beside its bound; past
    ``LIBRARY_WIDEST`` columns, which the library's flash backward does not
    take, against the backward of SDPA on the same views on the first of
    ``SDPA_BACKENDS`` that takes the head (``sdpa_backward``), its backend
    named.  Two calls of the pair must give equal bits (no atomics: every
    output is summed in one order)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    aten = torch.ops.aten
    for shape in BACKWARD_TIMING_SHAPES:
        B, H, T, D = shape
        scale = 1.0 / math.sqrt(H * D)
        q, k, v = model_views(shape, gen)
        out, lse = flash_attention_lse(q, k, v, scale)
        g = torch.randn((B, T, H, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        args = (q, k, v, out, g, lse, scale)
        passes = {"flash_bwd_dq_tiled": lambda: flash_tiled_bwd_dq(*args),
                  "flash_bwd_dkv_tiled": lambda: flash_tiled_bwd_dkv(*args)}
        fns = {"pair": lambda: (flash_tiled_bwd_dq(*args),
                                *flash_tiled_bwd_dkv(*args))}
        backend = "flash"
        if D <= LIBRARY_WIDEST:
            o, l, cq, ck, mq, mk, seed, offset, _ = \
                aten._scaled_dot_product_flash_attention(q, k, v,
                                                         scale=scale)
            library = aten._scaled_dot_product_flash_attention_backward
            fns["library"] = lambda: library(
                g.transpose(1, 2), q, k, v, o, l, cq, ck, mq, mk, 0.0, False,
                seed, offset, scale=scale)
        else:
            backend, fns["library"] = sdpa_backward(q, k, v, g, scale)
        first, second = fns["pair"](), fns["pair"]()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"backward pair {shape}: two calls on the "
                                 "same inputs differ")
        del first, second
        if T <= 65:
            ms = {n: device_ms(fn)[0] for n, fn in (*passes.items(),
                                                    *fns.items())}
            how = "device ms, torch.profiler"
        else:  # windows of about 20 ms of the pair
            iters = max(3, min(30, round(20 / cuda_ms(fns["pair"], 1, 1))))
            ms = {**in_turns(passes, rounds=2, iters=iters),
                  **in_turns(fns, rounds=2, iters=iters)}
            how = f"median of 4 event windows of {iters}"
        bounds = {n: bound(n, shape) for n in passes}
        for name in passes:
            b = bounds[name]
            print(f"backward {name} {shape} bf16 on the model's views: "
                  f"{ms_text(ms[name])} ({how}); bound {b['bound_ms']:.4f} "
                  f"ms by {b['bound_by']} ({card})")
        pair_bound = sum(b["bound_ms"] for b in bounds.values())
        if None in (ms["pair"], ms["library"]):
            library_text = (f"library backward ({backend}) "
                            f"{ms_text(ms['library'])} (ratio not measured)")
        else:
            library_text = (f"library backward ({backend}) "
                            f"{ms_text(ms['library'])} "
                            f"({ms['pair'] / ms['library']:.3f}x the "
                            "library)")
        print(f"backward pair {shape} bf16 on the model's views: "
              f"{ms_text(ms['pair'])}, {library_text} ({how}); bound "
              f"{pair_bound:.4f} ms; two calls equal bit for bit ({card})")
        del q, k, v, out, lse, g, args, passes, fns
        torch.cuda.empty_cache()


def sdpa_backward(q, k, v, g, scale: float):
    """(backend, a call) for the backward of SDPA on the (B, H, T, D) views
    q, k, v with the (B, T, H, D) cotangent g: the first of
    ``SDPA_BACKENDS`` that takes the head, through
    ``torch.nn.attention.sdpa_kernel``; the call runs only the backward
    (the forward's graph is kept), dq, dk and dv as the pair computes
    them.  Timed here, called nowhere in the port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    cot = g.transpose(1, 2)
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name)
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(*leaves, scale=scale)
                torch.autograd.grad(out, leaves, cot, retain_graph=True)
        except RuntimeError as err:
            print(f"SDPA backend {name} does not take {tuple(q.shape)}: "
                  f"{str(err).splitlines()[0][:120]}")
            continue

        def call(out=out, backend=backend):
            with sdpa_kernel(backend):
                return torch.autograd.grad(out, leaves, cot,
                                           retain_graph=True)
        return name, call
    raise AssertionError(f"no SDPA backend takes {tuple(q.shape)}")


def f32_instances(name: str) -> list[str]:
    """ptxas's report of the f32 instances of kernel row ``name``: the
    TF32 split kernels of its library (every FWD_F32 and WHOLE_F32 row of
    the forwards, every DQ_F32 or DKV_F32 row of the backward pair)."""
    lib = SOURCES[F32_ROWS[name]]
    return [f"{i}: {r}" for i, r in PTXAS[lib].items()
            if i.split("<")[0] in F32_INSTANCE_KINDS[name]]


def f32_ptxas(name: str, shape) -> str:
    """ptxas's report of the TF32 instance that f32 row ``name`` runs at
    ``shape`` (``f32_forward_plan`` or ``f32_backward_plan`` names it)."""
    from vit_cifar_torch.ops.cuda.common import (f32_backward_plan,
                                                 f32_forward_plan)

    lib = SOURCES[F32_ROWS[name]]
    if "fwd" in name:
        plan = f32_forward_plan(lib, *shape[2:])
        if plan["grid"] == "streamed":  # and its split pass
            instance = (f"fwd_split_stream_kernel<{plan['keys']},"
                        f"{plan['cols']}>")
            return (f"{instance}: {PTXAS[lib][instance]}; split_qkv_kernel: "
                    f"{PTXAS[lib]['split_qkv_kernel']}")
        instance = (f"fwd_split_kernel<{plan['width']},{plan['keys']},"
                    f"{plan['cols']},{int(plan['bf16x3'])},"
                    f"{int(plan['grid'] == 'whole')}>")
        return f"{instance}: {PTXAS[lib][instance]}"
    plan = f32_backward_plan(*shape[2:])
    kind = "dq" if "dq" in name else "dkv"
    cut = plan[kind]
    instance = (f"{kind}_split_stream_kernel<{cut['tile']},{cut['cols']},"
                f"{int(cut['bf16x3'])}>" if cut["streamed"] else
                f"{kind}_split_kernel<{plan['width']},{cut['tile']},"
                f"{cut['cols']},{int(cut['bf16x3'])}>")
    return f"{instance}: {PTXAS[lib][instance]}"


def library_f32(shape, q, k, v, g, scale: float, want) -> dict:
    """The library's f32 yardsticks on the (B, H, T, D) views q, k, v
    (timed here, called nowhere in the port), each with its own max error
    against the port's plain f32 versions (``want``: out, lse, dq, dk,
    dv): ``aten._scaled_dot_product_efficient_attention`` with its
    logsumexp ("fwd_lse"; the flash backend takes no f32) and SDPA's
    backward on the first backend that takes the head (``sdpa_backward``,
    "bwd_pair")."""
    aten = torch.ops.aten
    fwd = lambda: aten._scaled_dot_product_efficient_attention(  # noqa: E731
        q, k, v, None, True, scale=scale)[:2]
    backend, bwd = sdpa_backward(q, k, v, g, scale)
    out, lse = fwd()
    T = shape[2]
    grads = bwd()
    errs = {"fwd_lse": max(_max_err((out.transpose(1, 2),), want[:1]),
                           _max_err((lse[..., :T],), want[1:2])),
            "bwd_pair": _max_err(grads, want[2:])}
    tols = {"fwd_lse": KERNEL_TOL[torch.float32],
            "bwd_pair": BWD_TOL[torch.float32]}
    meets = {}
    for key, got, w in (("fwd_lse", (out.transpose(1, 2), lse[..., :T]),
                         want[:2]), ("bwd_pair", grads, want[2:])):
        meets[key] = all(torch.allclose(a.float(), b.float(), **tols[key])
                         for a, b in zip(got, w))
    del out, lse, grads
    return {"fwd_lse": fwd, "bwd_pair": bwd, "backend": backend,
            "errs": errs, "meets": meets}


def f32_wide_checks() -> None:
    """The f32 instances past 128 columns (both forwards' streamed TF32
    instance, with and without lse, and the streamed TF32 pair) on the
    model's views at ``F32_WIDE_CHECK_SHAPES``: each against its plain
    version within the f32 limits, and two calls of each bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    for shape in F32_WIDE_CHECK_SHAPES:
        B, H, T, D = shape
        scale = 1.0 / math.sqrt(H * D)
        q, k, v = model_views(shape, gen, torch.float32)
        g = torch.randn((B, T, H, D), generator=gen, device="cuda")
        calls = lambda: (  # noqa: E731
            flash_attention(q, k, v, scale),
            *flash_attention_lse(q, k, v, scale),
            fused_attention(q, k, v, scale),
            *fused_attention_lse(q, k, v, scale))
        fwds = calls()
        infer, out, lse = fwds[:3]
        args = (q, k, v, out, g, lse, scale)
        pair = lambda: (flash_tiled_bwd_dq(*args),  # noqa: E731
                        *flash_tiled_bwd_dkv(*args))
        first, second, again = pair(), pair(), calls()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in
                   zip((*first, *fwds), (*second, *again))):
            raise AssertionError(f"f32 {shape}: two calls differ")
        want_out, want_lse = flash_attention_lse_reference(q, k, v, scale)
        fused_out, fused_lse = fused_attention_lse_reference(q, k, v, scale)
        want = (flash_tiled_bwd_dq_reference(*args),
                *flash_tiled_bwd_dkv_reference(*args))
        wants = (want_out, want_out, want_lse, fused_out, fused_out,
                 fused_lse)
        for a, w in zip(fwds, wants):
            torch.testing.assert_close(a, w, **KERNEL_TOL[torch.float32])
        for a, w in zip(first, want):
            torch.testing.assert_close(a, w, **BWD_TOL[torch.float32])
        print(f"f32 past 128 columns {shape} on the model's views: "
              f"flash_fwd max_abs_err {_max_err(fwds[:3], wants[:3]):.3e}, "
              f"mhsa_fwd {_max_err(fwds[3:], wants[3:]):.3e} (each with "
              f"and without lse), streamed pair (dq, dk, dv) "
              + ", ".join(f"{_max_err((a,), (w,)):.3e}"
                          for a, w in zip(first, want))
              + "; two calls of each equal bit for bit")
        del q, k, v, g, fwds, infer, out, lse, args, first, second, again
        del want, wants


def f32_kernel_phase(card: str) -> list[dict]:
    """The f32 instances (``--precision 32``) on the model's views at their
    main shapes (``F32_MAIN_SHAPE``; the pair also at the flagship's
    (128, 12, 65, 32); past 128 columns ``F32_WIDE_SHAPE``, the streamed
    pair and both forwards' streamed instance, rows of their own): each
    against its plain version (max error within the f32 limits), two calls
    of each bit
    for bit, then each kernel and its plain version in turns, and the
    library's f32 call beside it with that call's own error against the
    plain version (named where it misses the f32 limit), each beside its
    f32 bound; device ms at T=65.  Returns the kernels line's f32 rows."""
    f32_wide_checks()
    gen = torch.Generator(device="cuda").manual_seed(19)
    rows = []
    for shape in (PIXEL_SHAPE, (128, 12, 65, 32), F32_WIDE_SHAPE):
        B, H, T, D = shape
        scale = 1.0 / math.sqrt(H * D)
        q, k, v = model_views(shape, gen, torch.float32)
        g = torch.randn((B, T, H, D), generator=gen, device="cuda")
        want_out, want_lse = flash_attention_lse_reference(q, k, v, scale)
        fwd, fwd_lse, plain_fwd, plain_lse = (
            (fused_attention, fused_attention_lse, fused_attention_reference,
             fused_attention_lse_reference) if T <= 65 else
            (flash_attention, flash_attention_lse, flash_attention_reference,
             flash_attention_lse_reference))
        out, lse = fwd_lse(q, k, v, scale)
        infer = fwd(q, k, v, scale)
        args = (q, k, v, out, g, lse, scale)
        want = (flash_tiled_bwd_dq_reference(*args),
                *flash_tiled_bwd_dkv_reference(*args))
        pair = lambda: (flash_tiled_bwd_dq(*args),  # noqa: E731
                        *flash_tiled_bwd_dkv(*args))
        first, second = pair(), pair()
        again = (fwd(q, k, v, scale), *fwd_lse(q, k, v, scale))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"f32 pair {shape}: two calls differ")
        if not all(torch.equal(a, b)
                   for a, b in zip((infer, out, lse), again)):
            raise AssertionError(f"f32 forwards {shape}: two calls differ")
        for a, w in ((out, want_out), (lse, want_lse), (infer, want_out)):
            torch.testing.assert_close(a, w, **KERNEL_TOL[torch.float32])
        for a, w in zip(first, want):
            torch.testing.assert_close(a, w, **BWD_TOL[torch.float32])
        kind = "mhsa" if T <= 65 else "flash"
        # the row names: past 128 columns the rows of their own
        fwd_tail, bwd_tail = ("_wide", "_streamed") if D > 128 else ("", "")
        names = {"fwd_lse": f"{kind}_fwd_lse_f32{fwd_tail}",
                 "fwd": f"{kind}_fwd_f32{fwd_tail}",
                 "dq": f"flash_bwd_dq_tiled_f32{bwd_tail}",
                 "dkv": f"flash_bwd_dkv_tiled_f32{bwd_tail}"}
        errs = {names["fwd_lse"]: _max_err((out, lse), (want_out, want_lse)),
                names["fwd"]: _max_err((infer,), (want_out,)),
                names["dq"]: _max_err(first[:1], want[:1]),
                names["dkv"]: _max_err(first[1:], want[1:])}
        if D > 128:  # the whole-head forward, on the same streamed items
            fused = (fused_attention(q, k, v, scale),
                     *fused_attention_lse(q, k, v, scale))
            fused_again = (fused_attention(q, k, v, scale),
                           *fused_attention_lse(q, k, v, scale))
            fused_want = fused_attention_lse_reference(q, k, v, scale)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b)
                       for a, b in zip(fused, fused_again)):
                raise AssertionError(f"f32 mhsa_fwd {shape}: two calls "
                                     "differ")
            for a, w in zip(fused, (fused_want[0], *fused_want)):
                torch.testing.assert_close(a, w, **KERNEL_TOL[torch.float32])
            errs["mhsa_fwd_f32_wide"] = _max_err(fused[:1], fused_want[:1])
            errs["mhsa_fwd_lse_f32_wide"] = _max_err(fused[1:], fused_want)
            del fused, fused_again, fused_want
        lib = library_f32(shape, q, k, v, g, scale,
                          (want_out, want_lse, *want))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, scale=scale)
        sdpa_out = sdpa().transpose(1, 2)
        sdpa_err = _max_err((sdpa_out,), (want_out,))
        sdpa_meets = torch.allclose(sdpa_out, want_out,
                                    **KERNEL_TOL[torch.float32])
        del sdpa_out
        del first, second, again
        fns = {names["fwd_lse"]: (lambda: fwd_lse(q, k, v, scale),
                                  lambda: plain_lse(q, k, v, scale),
                                  lib["fwd_lse"]),
               names["fwd"]: (lambda: fwd(q, k, v, scale),
                              lambda: plain_fwd(q, k, v, scale), sdpa),
               names["dq"]: (
                   lambda: flash_tiled_bwd_dq(*args),
                   lambda: flash_tiled_bwd_dq_reference(*args), None),
               names["dkv"]: (
                   lambda: flash_tiled_bwd_dkv(*args),
                   lambda: flash_tiled_bwd_dkv_reference(*args), None),
               "pair": (pair, lambda: (
                   flash_tiled_bwd_dq_reference(*args),
                   *flash_tiled_bwd_dkv_reference(*args)), lib["bwd_pair"])}
        if D > 128:
            fns["mhsa_fwd_lse_f32_wide"] = (
                lambda: fused_attention_lse(q, k, v, scale),
                lambda: fused_attention_lse_reference(q, k, v, scale),
                lib["fwd_lse"])
            fns["mhsa_fwd_f32_wide"] = (
                lambda: fused_attention(q, k, v, scale),
                lambda: fused_attention_reference(q, k, v, scale), sdpa)
        for name, (kernel, plain, library) in fns.items():
            main = name == "pair" or F32_MAIN_SHAPE[name] == shape
            iters = max(2, min(30, round(20 / cuda_ms(kernel, 1, 1))))
            ms = in_turns({"kernel": kernel, "plain": plain}, rounds=2,
                          iters=iters)
            how = f"median of 4 event windows of {iters}"
            lib_ms = None
            if library is not None:
                lib_ms = in_turns({"kernel": kernel, "library": library},
                                  rounds=2, iters=iters)["library"]
            if T <= 65:  # an event window there follows the host
                how += f"; device kernel {ms_text(device_ms(kernel)[0])}"
                if library is not None:
                    how += f", library {ms_text(device_ms(library)[0])}"
            if name == "pair":
                b = {n: bound(names[n], shape, torch.float32)["bound_ms"]
                     for n in ("dq", "dkv")}
                # the pair as one function: five products (s, dp, dq, dk,
                # dv) and 8 tensors moved
                n8 = 8 * 4 * B * H * T * D
                least = max(5 * 2 * B * H * T * T * D / F32_SPLIT_FLOP_PER_S,
                            n8 / HBM_BYTES_PER_S,
                            B * H * T * T / EXP_PER_S) * 1e3
                meets = "" if lib["meets"]["bwd_pair"] else \
                    ", MISSES the f32 limit rtol 1e-4 / atol 1e-5"
                print(f"f32 pair {shape} on the model's views: "
                      f"{ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, "
                      f"library backward ({lib['backend']}) {lib_ms:.4f} ms "
                      f"(max_abs_err {lib['errs']['bwd_pair']:.3e} against "
                      f"the plain passes{meets}); pair "
                      f"{ms['kernel'] / lib_ms:.3f}x the library; bound "
                      f"{sum(b.values()):.4f} ms (the two kernels' own "
                      f"work), {least:.4f} ms (the pair as one function); "
                      f"two calls equal bit for bit ({how}; {card})")
                continue
            b = bound(name, shape, torch.float32)
            err = errs[name]
            line = (f"{name} {shape} f32 on the model's views: kernel "
                    f"{ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms"
                    f"; bound {b['bound_ms']:.4f} ms by {b['bound_by']}; "
                    f"max_abs_err {err:.3e}")
            if lib_ms is not None and "lse" in name:
                meets = "" if lib["meets"]["fwd_lse"] else \
                    ", MISSES the f32 limit 1e-5"
                line += (f"; library efficient attention with lse "
                         f"{lib_ms:.4f} ms (max_abs_err "
                         f"{lib['errs']['fwd_lse']:.3e}{meets})")
            elif lib_ms is not None:
                meets = "" if sdpa_meets else ", MISSES the f32 limit 1e-5"
                line += (f"; library SDPA {lib_ms:.4f} ms (max_abs_err "
                         f"{sdpa_err:.3e}{meets})")
            if "fwd" in name:
                line += "; two calls equal bit for bit"
            print(f"{line} ({how}; {card})")
            if main:
                rows.append({
                    "name": name, "route": "cuda",
                    "design": F32_DESIGN[name],
                    "source": f"vit_cifar_torch/csrc/"
                              f"{SOURCES[F32_ROWS[name]]}.cu",
                    "replaces": REPLACES[F32_ROWS[name]],
                    "max_abs_err": err, "ms": ms["kernel"],
                    "plain_ms": ms["plain"], **b,
                    # no one PyTorch call computes dq or dk/dv alone
                    "library_ms": lib_ms,
                    "ptxas": f32_ptxas(name, shape),
                    "instances": f32_instances(name)})
        del q, k, v, g, out, lse, infer, args, want, lib, fns
        torch.cuda.empty_cache()
    for row in rows:
        print(f"{row['name']} instances: " + "; ".join(row["instances"]))
    return rows


def f32_training_phase(card: str) -> dict:
    """One ``--precision 32`` step of the flagship and of the pixel ViT
    (B=128; the pixel ViT's check at B=8, as its bf16 one): the kernel
    path's loss and gradient against the plain-attention (einsum) path's
    within ``F32_STEP_LOSS_ATOL`` and ``F32_STEP_REL_L2``; one eval
    (no-grad) forward at that batch, its launches counted from zero (7 of
    the f32 inference forward: ``mhsa_fwd`` for the flagship,
    ``flash_fwd`` for the pixel ViT), its logits against the plain
    model's within ``F32_STEP_REL_L2``; then ``F32_STEPS`` steps each after
    3 untimed, their launches counted from zero (7 a step of the forward
    with lse and of each backward pass) and the host ms a step.  Returns
    the launches under the f32 rows' names."""
    launches = {row: 0 for row in F32_ROWS if row not in F32_WIDE_ROWS}
    for what, cfg, batch in (("flagship", flagship_cfg(precision="32"), 128),
                             ("pixel", flagship_cfg(precision="32", patch=32),
                              PIXEL_STEP_BATCH)):
        _, x_train, y_train, model, state, train_step, perm = \
            training_setup(cfg, n_train=(F32_STEPS + 3) * cfg.batch_size)
        img, label, _, _ = train_step.make_batch(state, x_train, y_train,
                                                 perm, 0)
        criterion = make_criterion(cfg)
        plain = plain_twin(cfg, model)

        def loss_and_grad(m):
            loss = criterion(m(img[:batch], deterministic=False),
                             label[:batch])
            grads = torch.autograd.grad(loss, list(m.parameters()))
            return loss.item(), torch.cat([g.reshape(-1) for g in grads])

        (loss_k, grad_k), (loss_p, grad_p) = (loss_and_grad(model),
                                              loss_and_grad(plain))
        rel = ((grad_k - grad_p).norm() / grad_p.norm()).item()
        print(f"f32 {what} step at B={batch} (--precision 32), kernel vs "
              f"einsum path: loss {loss_k:.7f} vs {loss_p:.7f} (|diff| "
              f"{abs(loss_k - loss_p):.3e}, bound {F32_STEP_LOSS_ATOL}); "
              f"gradient relative L2 {rel:.3e} (bound {F32_STEP_REL_L2})")
        if not (abs(loss_k - loss_p) <= F32_STEP_LOSS_ATOL
                and rel <= F32_STEP_REL_L2):
            raise AssertionError(f"f32 {what} step: kernel path and einsum "
                                 "path disagree")
        # the eval path: the f32 inference forward, its launches counted
        # from zero
        with torch.no_grad():
            want_logits = plain(img[:batch], deterministic=True)
            for wrapper in KERNEL_WRAPPERS.values():
                wrapper.launches = 0
            logits = model(img[:batch], deterministic=True)
            torch.cuda.synchronize()
            counts = _launch_counts()
        fwd = "mhsa_fwd" if what == "flagship" else "flash_fwd"
        want = dict({n: 0 for n in KERNEL_WRAPPERS}, **{fwd: cfg.num_layers})
        rel = ((logits - want_logits).norm() / want_logits.norm()).item()
        print(f"f32 {what} eval forward at B={batch} (--precision 32, no "
              f"grad): launches {counts}; logits against the einsum path's "
              f"relative L2 {rel:.3e} (bound {F32_STEP_REL_L2}) ({card})")
        if counts != want or not rel <= F32_STEP_REL_L2:
            raise AssertionError(f"f32 {what} eval: launches {counts}, "
                                 f"expected {want}; logits relative L2 "
                                 f"{rel}")
        for row, base in F32_ROWS.items():
            if row not in F32_WIDE_ROWS:
                launches[row] += counts[base]
        del plain, grad_k, grad_p, logits, want_logits
        torch.cuda.empty_cache()

        # the f32 path: its launches counted from zero
        for wrapper in KERNEL_WRAPPERS.values():
            wrapper.launches = 0
        losses = []
        for i in range(F32_STEPS + 3):
            if i == 3:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, metrics = train_step(state, x_train, y_train, perm, i)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / F32_STEPS
        counts = _launch_counts()
        fwd = "mhsa_fwd_lse" if what == "flagship" else "flash_fwd_lse"
        want = {n: 0 for n in KERNEL_WRAPPERS}
        want.update({fwd: cfg.num_layers * (F32_STEPS + 3),
                     "flash_bwd_dq_tiled": cfg.num_layers * (F32_STEPS + 3),
                     "flash_bwd_dkv_tiled": cfg.num_layers * (F32_STEPS + 3)})
        losses = torch.stack(losses).cpu()
        print(f"f32 {what} train: {F32_STEPS + 3} steps, launches {counts}; "
              f"losses " + " ".join(f"{x:.4f}" for x in losses.tolist())
              + f"; {step_ms:.3f} ms a step over the last {F32_STEPS} (host "
              f"clock, synchronized), {cfg.batch_size / step_ms * 1e3:.1f} "
              f"img/s at B={cfg.batch_size} ({card})")
        if counts != want or not torch.isfinite(losses).all():
            raise AssertionError(f"f32 {what}: launches {counts}, expected "
                                 f"{want}; losses {losses.tolist()}")
        for row, base in F32_ROWS.items():
            if row not in F32_WIDE_ROWS:
                launches[row] += counts[base]
        del model, state, train_step, x_train, y_train
        torch.cuda.empty_cache()
    return launches


def wide_head_phase(card: str) -> dict:
    """``pallas_kernel="fused"`` at T=5, head_dim 192: one step's loss and
    gradients against the plain-attention model, then serving and training
    through the whole-head forward's column-chunk layout and the tiled
    pair."""
    cfg = flagship_cfg(num_layers=WIDE_LAYERS, head=2, patch=2,
                       pallas_kernel="fused", batch_size=WIDE_BATCH)
    _, x_train, y_train, model, state, train_step, perm = \
        training_setup(cfg, 256)
    plain = plain_twin(cfg, model)
    print(f"wide heads: vit, patch 2 (T=5), {WIDE_LAYERS} layers, hidden "
          f"384, 2 heads (head_dim 192), pallas_kernel 'fused', "
          f"{cfg.precision}")
    img, label, _, _ = train_step.make_batch(state, x_train, y_train, perm, 0)
    check_step(cfg, model, plain, img, label, "wide heads, one step")

    # the main path starts here: serving, then training
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    x = normalize(x_train[:WIDE_BATCH], cfg.mean, cfg.std).to(
        torch_dtype(cfg))
    model.eval()
    plain.eval()
    with torch.inference_mode():
        logits = model(x).float()
        want = plain(x).float()
    served = _launch_counts()
    if served != dict({n: 0 for n in KERNEL_WRAPPERS},
                      mhsa_fwd=WIDE_LAYERS):
        raise AssertionError(f"serving launches {served}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    torch.testing.assert_close(logits, want, **LOGIT_TOL)
    print(f"wide heads, serving B={WIDE_BATCH}: logits finite, max |kernel - "
          f"plain| {(logits - want).abs().max().item():.3e} within "
          f"rtol={LOGIT_TOL['rtol']} atol={LOGIT_TOL['atol']}, "
          f"{served['mhsa_fwd']} launches of mhsa_fwd")

    del plain
    model.train()
    before = _launch_counts()
    losses = []
    for i in range(WIDE_STEPS):
        state, metrics = train_step(state, x_train, y_train, perm, i)
        losses.append(metrics["loss"].item())
    launches = _launch_counts()
    per_step = {n: (c - before[n]) / WIDE_STEPS for n, c in launches.items()}
    want_step = dict({n: 0 for n in KERNEL_WRAPPERS},
                     mhsa_fwd_lse=WIDE_LAYERS, flash_bwd_dq_tiled=WIDE_LAYERS,
                     flash_bwd_dkv_tiled=WIDE_LAYERS)
    if per_step != want_step:
        raise AssertionError(f"launches a step {per_step}, expected "
                             f"{want_step}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    print(f"wide heads, {WIDE_STEPS} training steps at B={WIDE_BATCH}: "
          f"losses {' '.join(f'{x:.4f}' for x in losses)}, launches a step "
          f"{ {n: c for n, c in per_step.items() if c} }")
    return launches


def wide_head_f32_phase(card: str) -> dict:
    """The wide-head model (hidden 384 in 2 heads at ``WIDE_F32_PATCH``, 16
    patches a side: T=257, head_dim 192; 2 layers, B=8) under
    ``--precision 32`` with the default
    route, through ``get_model`` -> ``make_train_step``: one step's loss
    and gradients against the plain-attention model within the f32 step
    bounds; one eval forward counted from zero (2 launches of the f32
    inference forward, its streamed TF32 instance), its logits against
    the plain model's; then ``WIDE_STEPS`` steps counted from zero, 2
    launches a step of the forward with lse and of each pass of the
    streamed TF32 pair, finite losses; then the same model with
    ``pallas_kernel="fused"`` (``wide_head_f32_fused_pass``).  Returns the
    launches under the wide f32 rows' names."""
    cfg = flagship_cfg(num_layers=WIDE_LAYERS, head=2, patch=WIDE_F32_PATCH,
                       precision="32", batch_size=WIDE_BATCH)
    _, x_train, y_train, model, state, train_step, perm = \
        training_setup(cfg, 256)
    plain = plain_twin(cfg, model)
    print(f"wide heads in f32: vit, patch {WIDE_F32_PATCH} (T="
          f"{cfg.seq_len}), {WIDE_LAYERS} layers, "
          f"hidden 384, 2 heads (head_dim 192), the default route, "
          f"--precision {cfg.precision}")
    img, label, _, _ = train_step.make_batch(state, x_train, y_train, perm, 0)
    check_step(cfg, model, plain, img, label, "wide heads in f32, one step",
               F32_STEP_LOSS_ATOL, F32_STEP_REL_L2)
    with torch.no_grad():
        want_logits = plain(img, deterministic=True)
        for wrapper in KERNEL_WRAPPERS.values():
            wrapper.launches = 0
        logits = model(img, deterministic=True)
        torch.cuda.synchronize()
        served = _launch_counts()
    rel = ((logits - want_logits).norm() / want_logits.norm()).item()
    if served != dict({n: 0 for n in KERNEL_WRAPPERS}, flash_fwd=WIDE_LAYERS) \
            or not rel <= F32_STEP_REL_L2:
        raise AssertionError(f"wide heads in f32, eval: launches {served}; "
                             f"logits relative L2 {rel}")
    print(f"wide heads in f32, eval forward at B={WIDE_BATCH}: launches "
          f"{ {n: c for n, c in served.items() if c} }; logits against the "
          f"einsum path's relative L2 {rel:.3e} (bound {F32_STEP_REL_L2})")
    del plain, logits, want_logits

    # the path: its launches counted from zero
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    losses = []
    for i in range(WIDE_STEPS):
        state, metrics = train_step(state, x_train, y_train, perm, i)
        losses.append(metrics["loss"].item())
    torch.cuda.synchronize()
    counts = _launch_counts()
    want = dict({n: 0 for n in KERNEL_WRAPPERS},
                flash_fwd_lse=WIDE_LAYERS * WIDE_STEPS,
                flash_bwd_dq_tiled=WIDE_LAYERS * WIDE_STEPS,
                flash_bwd_dkv_tiled=WIDE_LAYERS * WIDE_STEPS)
    if counts != want or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"wide heads in f32: launches {counts}, "
                             f"expected {want}; losses {losses}")
    print(f"wide heads in f32, {WIDE_STEPS} training steps at B={WIDE_BATCH}: "
          f"losses {' '.join(f'{x:.4f}' for x in losses)}, launches "
          f"{ {n: c for n, c in counts.items() if c} } ({card})")
    del model, state, train_step, x_train, y_train
    torch.cuda.empty_cache()
    fused = wide_head_f32_fused_pass(card)
    return {"flash_fwd_f32_wide": served["flash_fwd"],
            "flash_fwd_lse_f32_wide": counts["flash_fwd_lse"],
            "flash_bwd_dq_tiled_f32_streamed": counts["flash_bwd_dq_tiled"]
            + fused["flash_bwd_dq_tiled"],
            "flash_bwd_dkv_tiled_f32_streamed": counts["flash_bwd_dkv_tiled"]
            + fused["flash_bwd_dkv_tiled"],
            "mhsa_fwd_f32_wide": fused["mhsa_fwd"],
            "mhsa_fwd_lse_f32_wide": fused["mhsa_fwd_lse"]}


def wide_head_f32_fused_pass(card: str) -> dict:
    """The same wide-head f32 model with ``pallas_kernel="fused"``: the
    whole-head forward past 128 columns, which takes the streamed f32
    instance's tiled items there.  Its logits against the plain model's
    and one step's loss and gradients against it within the f32 bounds;
    then, counted from zero, one eval forward (2 launches of ``mhsa_fwd``)
    and ``WIDE_STEPS`` steps (2 launches a step of ``mhsa_fwd_lse`` and of
    each pass of the streamed pair), finite losses.  Returns the counts."""
    cfg = flagship_cfg(num_layers=WIDE_LAYERS, head=2, patch=WIDE_F32_PATCH,
                       precision="32", batch_size=WIDE_BATCH,
                       pallas_kernel="fused")
    _, x_train, y_train, model, state, train_step, perm = \
        training_setup(cfg, 256)
    plain = plain_twin(cfg, model)
    img, label, _, _ = train_step.make_batch(state, x_train, y_train, perm, 0)
    check_step(cfg, model, plain, img, label,
               "wide heads in f32, pallas_kernel 'fused', one step",
               F32_STEP_LOSS_ATOL, F32_STEP_REL_L2)
    with torch.no_grad():
        want_logits = plain(img, deterministic=True)
    del plain

    # the path: its launches counted from zero
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    with torch.no_grad():
        logits = model(img, deterministic=True)
    losses = []
    for i in range(WIDE_STEPS):
        state, metrics = train_step(state, x_train, y_train, perm, i)
        losses.append(metrics["loss"].item())
    torch.cuda.synchronize()
    counts = _launch_counts()
    rel = ((logits - want_logits).norm() / want_logits.norm()).item()
    want = dict({n: 0 for n in KERNEL_WRAPPERS}, mhsa_fwd=WIDE_LAYERS,
                mhsa_fwd_lse=WIDE_LAYERS * WIDE_STEPS,
                flash_bwd_dq_tiled=WIDE_LAYERS * WIDE_STEPS,
                flash_bwd_dkv_tiled=WIDE_LAYERS * WIDE_STEPS)
    if counts != want or not rel <= F32_STEP_REL_L2 \
            or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"wide heads in f32, fused: launches {counts}, "
                             f"expected {want}; logits relative L2 {rel}; "
                             f"losses {losses}")
    print(f"wide heads in f32, pallas_kernel 'fused': eval forward logits "
          f"against the einsum path's relative L2 {rel:.3e} (bound "
          f"{F32_STEP_REL_L2}), {WIDE_STEPS} training steps at "
          f"B={WIDE_BATCH}: losses {' '.join(f'{x:.4f}' for x in losses)}, "
          f"launches { {n: c for n, c in counts.items() if c} } ({card})")
    del model, state, train_step, x_train, y_train, logits, want_logits
    torch.cuda.empty_cache()
    return counts


def _launch_counts() -> dict:
    return {n: w.launches for n, w in KERNEL_WRAPPERS.items()}


def pixel_serving_phase(card: str) -> dict:
    cfg = flagship_cfg(patch=32)  # one pixel a token, T=1025
    model, _ = get_model(cfg, generator=torch.Generator().manual_seed(cfg.seed))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != PIXEL_PARAMS:
        raise AssertionError(f"{n_params} params, expected {PIXEL_PARAMS}")
    print(f"pixel model: vit, patch 32 (T=1025), 7 layers, hidden 384, 12 "
          f"heads, {n_params} params, {cfg.precision}")
    work = os.path.join(WORK, "pixel")
    shutil.rmtree(work, ignore_errors=True)
    ckpt = os.path.join(work, "ckpt")
    save_checkpoint(ckpt, {"params": model.state_dict()}, cfg)
    art = export_inference(ckpt, os.path.join(work, "art"), device="cuda")
    print(f"pixel serving.pt2: its graph calls {graph_ops(art)}")

    payload, ckpt_cfg = load_checkpoint(ckpt)
    plain, _ = get_model(ckpt_cfg.replace(pallas_kernel="einsum"),
                         device="cuda")
    plain.load_state_dict(payload["params"])
    plain.eval().requires_grad_(False)
    dtype = torch_dtype(cfg)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8)
               for B in PIXEL_REQUESTS]
    want = {n: 0 for n in KERNEL_WRAPPERS}
    want["flash_fwd"] = cfg.num_layers

    srv = make_http_server(art, port=0, device="cuda")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        # the main path starts here
        for wrapper in KERNEL_WRAPPERS.values():
            wrapper.launches = 0
        responses, per_request = [], []
        for imgs in batches:
            before = _launch_counts()
            responses.append(_post(f"{base}/predict", "npy", imgs))
            per_request.append({n: c - before[n]
                                for n, c in _launch_counts().items()})
        launches = _launch_counts()

        for B, imgs, resp, n in zip(PIXEL_REQUESTS, batches, responses,
                                    per_request):
            logits = np.asarray(resp["logits"], np.float64)
            if logits.shape != (B, cfg.num_classes) \
                    or not np.isfinite(logits).all():
                raise AssertionError(f"logits {logits.shape}, not finite")
            if n != want:
                raise AssertionError(f"launches for one request {n}, "
                                     f"expected {want}")
            with torch.inference_mode():
                x = normalize(torch.from_numpy(imgs).cuda(), cfg.mean, cfg.std)
                ref = plain(x.to(dtype)).float().cpu().numpy()
            np.testing.assert_allclose(logits, ref, **LOGIT_TOL)
            agree = float((logits.argmax(-1) == ref.argmax(-1)).mean())
            print(f"pixel POST /predict npy B={B}: logits ({B}, 10) finite, "
                  f"{n['flash_fwd']} launches of flash_fwd and none of "
                  f"another kernel, max |served - plain| "
                  f"{np.abs(logits - ref).max():.3e} within "
                  f"rtol={LOGIT_TOL['rtol']} atol={LOGIT_TOL['atol']}, "
                  f"top-1 agreement {agree:.3f}")
        print(f"pixel main path: {launches['flash_fwd']} launches of "
              f"flash_fwd over {len(PIXEL_REQUESTS)} requests")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)

    served = ServingModel(art, device="cuda")
    for B in (1, 128):
        x = torch.from_numpy(rng.integers(0, 256, (B, 32, 32, 3),
                                          dtype=np.uint8)).cuda()

        def forward():
            with torch.inference_mode():
                served.infer(x).cpu()

        print(f"pixel latency B={B}: in-process forward median "
              f"{host_ms(forward, 10):.3f} ms (10 calls; {card})")
    return launches


def pixel_training_phase(card: str) -> dict:
    cfg = flagship_cfg(patch=32)
    raw, x_train, y_train, model, state, train_step, perm = \
        training_setup(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != PIXEL_PARAMS:
        raise AssertionError(f"{n_params} params, expected {PIXEL_PARAMS}")
    eval_step = make_eval_step(cfg, model)
    print(f"pixel train: vit, patch 32 (T=1025), 7 layers, hidden 384, 12 "
          f"heads, {n_params} params, {cfg.precision}, batch "
          f"{cfg.batch_size}, label smoothing, adam lr {cfg.lr}, "
          f"warmup_epoch 0, no AutoAugment")

    # one step at B=8: at B=128 the einsum path's saved (B, H, T, T)
    # tensors need ~90 GB
    img, label, _, _ = train_step.make_batch(state, x_train, y_train, perm, 0)
    check_step(cfg, model, plain_twin(cfg, model), img[:PIXEL_STEP_BATCH],
               label[:PIXEL_STEP_BATCH],
               f"pixel step at B={PIXEL_STEP_BATCH}")
    torch.cuda.empty_cache()

    # the main path starts here
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    losses = torch.empty(PIXEL_STEPS, device="cuda")
    warm = 3
    for i in range(PIXEL_STEPS):
        if i == warm:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        state, metrics = train_step(state, x_train, y_train, perm, i)
        losses[i] = metrics["loss"]
        if i == 0:
            first = _launch_counts()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_start) * 1e3 / (PIXEL_STEPS - warm)
    train_launches = _launch_counts()
    want = {n: 0 for n in KERNEL_WRAPPERS}
    want.update({"flash_fwd_lse": cfg.num_layers,
                 "flash_bwd_dq_tiled": cfg.num_layers,
                 "flash_bwd_dkv_tiled": cfg.num_layers})
    if first != want or train_launches != {
            n: c * PIXEL_STEPS for n, c in want.items()}:
        raise AssertionError(f"launches: first step {first}, all "
                             f"{train_launches}, expected {want} a step")
    losses = losses.cpu()
    acc = {k: v.item() for k, v in state.metrics_acc.items()}
    head, tail = losses[:5].mean().item(), losses[-5:].mean().item()
    print(f"pixel train: {PIXEL_STEPS} steps, launches per step "
          f"{ {n: c for n, c in first.items() if c} }; loss first 5 steps "
          f"{head:.4f}, last 5 {tail:.4f}; losses "
          + " ".join(f"{x:.4f}" for x in losses.tolist())
          + f"; skipped {acc['skipped_nonfinite']:.0f}")
    if not torch.isfinite(losses).all():
        raise AssertionError("a training loss is not finite")
    if not tail < head or acc["skipped_nonfinite"] != 0:
        raise AssertionError("training loss did not fall")
    print(f"pixel train step: {step_ms:.3f} ms mean over steps {warm}-"
          f"{PIXEL_STEPS - 1} (host clock, synchronized), "
          f"{cfg.batch_size / step_ms * 1e3:.1f} img/s at B={cfg.batch_size}"
          f" without AutoAugment ({card})")

    x_test, y_test, mask, n_eval = _pad_eval(
        raw.x_test[:PIXEL_EVAL_IMAGES], raw.y_test[:PIXEL_EVAL_IMAGES],
        cfg.eval_batch_size)
    x_test, y_test, mask = (torch.from_numpy(a).cuda()
                            for a in (x_test, y_test, mask))
    eb = cfg.eval_batch_size
    sums = {"loss_sum": 0.0, "correct_sum": 0.0, "count": 0.0}
    for b in range(n_eval):
        out = eval_step(x_test[b * eb:(b + 1) * eb],
                        y_test[b * eb:(b + 1) * eb], mask[b * eb:(b + 1) * eb])
        sums = {k: sums[k] + out[k] for k in sums}
    sums = {k: float(v) for k, v in sums.items()}
    launches = _launch_counts()
    val_acc = sums["correct_sum"] / sums["count"]
    val_loss = sums["loss_sum"] / sums["count"]
    print(f"pixel eval: {n_eval} batches of {eb} ({int(sums['count'])} "
          f"images, last batch masked), {launches['flash_fwd']} launches of "
          f"flash_fwd; val_loss {val_loss:.4f}, val_acc {val_acc:.4f}")
    want_eval = dict(train_launches, flash_fwd=cfg.num_layers * n_eval)
    if n_eval != 4 or sums["count"] != PIXEL_EVAL_IMAGES \
            or launches != want_eval:
        raise AssertionError(f"eval over {n_eval} batches, {sums['count']} "
                             f"images, launches {launches}")
    if not (math.isfinite(val_loss) and math.isfinite(val_acc)):
        raise AssertionError(f"val_loss {val_loss}, val_acc {val_acc}")

    STEP_KERNELS["pixel"] = profile_steps(
        lambda i: train_step(state, x_train, y_train, perm, i), 5,
        "pixel_train_trace.json", step_ms, card)["kernels"]
    return launches


def aa_card_against_cpu(card: str) -> None:
    """``apply_autoaugment`` at B=128 on the card and on the CPU, on the
    same images and the same draws (from a card generator)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    imgs = torch.randint(0, 256, (AA_BATCH, 32, 32, 3), dtype=torch.uint8,
                         device="cuda", generator=gen)
    for policy in ("cifar10", "svhn"):
        draws = autoaugment_draws(gen, AA_BATCH, policy)
        got = apply_autoaugment(imgs, *draws, policy).cpu()
        want = apply_autoaugment(imgs.cpu(), *(d.cpu() for d in draws),
                                 policy)
        diff = (got.int() - want.int()).abs()
        share = (diff > 0).float().mean().item()
        changed = (want != imgs.cpu()).float().mean().item()
        print(f"AutoAugment {policy} B={AA_BATCH}, card vs CPU on the same "
              f"draws: {int((diff > 0).sum())} of {diff.numel()} values "
              f"differ (share {share:.2e}, limit {AA_CARD_SHARE}), max "
              f"{int(diff.max())} levels; {changed:.3f} of the values "
              f"changed by the policy")
        if share > AA_CARD_SHARE:
            raise AssertionError(f"AutoAugment {policy}: card and CPU differ "
                                 f"on {share:.2e} of the values")


def aa_profile(card: str) -> dict:
    """AutoAugment's device ms and kernels a B=128 batch (cifar10 policy)
    under torch.profiler (None where it recorded no kernel), and its event
    ms."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    imgs = torch.randint(0, 256, (AA_BATCH, 32, 32, 3), dtype=torch.uint8,
                         device="cuda", generator=gen)

    def batch():
        autoaugment_batch(gen, imgs, "cifar10")

    ms = cuda_ms(batch, 20, 3)
    n = 10

    def run():
        for _ in range(n):
            batch()

    os.makedirs(WORK, exist_ok=True)
    trace = os.path.join(WORK, "aa_trace.json")
    if profiled(run, trace)[0] is None:
        print(f"AutoAugment cifar10 B={AA_BATCH}: device activity not "
              f"measured; {ms:.3f} ms a batch by events (windows of 20; "
              f"{card})")
        return {"device_ms": None, "kernels": None, "ms": ms}
    busy_us, kernels = device_activity(trace)
    out = {"device_ms": busy_us / 1e3 / n, "kernels": kernels / n, "ms": ms}
    print(f"AutoAugment cifar10 B={AA_BATCH}: {out['kernels']:.1f} kernels "
          f"and {out['device_ms']:.3f} ms of device activity a batch "
          f"(profiler, {n} batches); {ms:.3f} ms a batch by events "
          f"(windows of 20; {card})")
    return out


def recipe_cfg(**kw) -> Config:
    """The README recipe with AutoAugment, as ``train()`` takes it."""
    return flagship_cfg(**{"autoaugment": True, "max_epochs": RECIPE_EPOCHS,
                           "log_dir": os.path.join(WORK, "logs"),
                           "ckpt_dir": os.path.join(WORK, "models"), **kw})


def run_train(cfg: Config, what: str, stop_after: int | None = None):
    """``train()`` on the card with the launch counts set to 0 just before;
    checks the launches of its steps, eval batches and probe forwards.
    Returns (result, launches)."""
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    res = train(cfg, verbose=False, stop_after=stop_after)
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    epochs = len(res["history"])
    steps = epochs * TRAIN_STEPS
    # 40 eval batches an epoch, and one probe forward of the layer-output
    # histograms an epoch (max_epochs // 10 rounds up to every epoch)
    forwards = epochs * (40 + 1)
    want = dict({n: 0 for n in KERNEL_WRAPPERS},
                mhsa_fwd=cfg.num_layers * forwards,
                mhsa_fwd_lse=cfg.num_layers * steps,
                flash_bwd_dq_tiled=cfg.num_layers * steps,
                flash_bwd_dkv_tiled=cfg.num_layers * steps)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    if torch.get_float32_matmul_precision() != "highest" \
            or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("train() left its matmul precision behind")
    for e, row in enumerate(res["history"]):
        print(f"{what}, epoch {e}: loss {row['loss']:.4f} acc "
              f"{row['acc']:.4f} val_loss {row['val_loss']:.4f} val_acc "
              f"{row['val_acc']:.4f} lr_0 {row['lr_0']:.6f}, "
              f"{row['epoch_time']:.3f} s ({row['images_per_sec']:.1f} "
              f"img/s), eval {row['eval_time']:.3f} s, skipped "
              f"{row['skipped_nonfinite']}")
    print(f"{what}: {epochs} epochs of {TRAIN_STEPS} steps in {seconds:.1f} s "
          f"(data set-up included), launches {launches}: 7 a step of each "
          "training kernel, 7 an eval batch and probe forward of mhsa_fwd")
    if not all(math.isfinite(row["loss"]) and row["skipped_nonfinite"] == 0
               for row in res["history"]):
        raise AssertionError(f"{what}: a loss is not finite")
    return res, launches


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def full_recipe_phase(card: str, no_aa_step_ms: float) -> dict:
    aa_card_against_cpu(card)
    aa = aa_profile(card)
    shutil.rmtree(os.path.join(WORK, "models"), ignore_errors=True)
    shutil.rmtree(os.path.join(WORK, "logs"), ignore_errors=True)

    cfg = recipe_cfg()
    print(f"full recipe through train(): vit, 7 layers, hidden 384, 12 "
          f"heads, {cfg.precision}, batch {cfg.batch_size}, label smoothing, "
          f"AutoAugment (cifar10 policy), warmup_epoch 0, {RECIPE_EPOCHS} "
          f"epochs, matmul precision {cfg.matmul_precision}")
    res_a, launches = run_train(cfg, "run (a)")
    hist = res_a["history"]
    if not hist[1]["loss"] < hist[0]["loss"]:
        raise AssertionError("the recipe's loss did not fall")
    if not hist[-1]["val_acc"] >= MIN_VAL_ACC:
        raise AssertionError(f"val_acc {hist[-1]['val_acc']}")
    step_ms = hist[1]["epoch_time"] * 1e3 / TRAIN_STEPS
    print(f"full-recipe step: {step_ms:.3f} ms a step, "
          f"{hist[1]['images_per_sec']:.1f} img/s at B={cfg.batch_size} "
          f"(epoch 1 of run (a), host clock over the epoch, synchronized by "
          f"its metric read); without AutoAugment (phase 3, same call) "
          f"{no_aa_step_ms:.3f} ms a step, "
          f"{cfg.batch_size / no_aa_step_ms * 1e3:.1f} img/s ({card})")

    res_b1, b1 = run_train(cfg, "run (b), stopped after epoch 1",
                           stop_after=1)
    res_b2, b2 = run_train(recipe_cfg(resume=res_b1["ckpt_dir"]),
                           "run (b), resumed")
    if len(res_b1["history"]) != 1 or len(res_b2["history"]) != 1:
        raise AssertionError("the resumed run did not train one epoch")
    pa = load_checkpoint(res_a["ckpt_dir"], prefer="last")[0]
    pb = load_checkpoint(res_b2["ckpt_dir"], prefer="last")[0]
    if not pa["step"] == pb["step"] == RECIPE_EPOCHS * TRAIN_STEPS:
        raise AssertionError(f"steps {pa['step']} and {pb['step']}")
    flat_a, flat_b = (torch.cat([t.reshape(-1) for t in p["params"].values()])
                      for p in (pa, pb))
    gaps = {"params": _rel_l2(flat_b, flat_a)}
    gaps.update({k: _rel_l2(pb["opt_state"][k], pa["opt_state"][k])
                 for k in ("mu", "nu")})
    exact = torch.equal(flat_a, flat_b) and all(
        torch.equal(pa["opt_state"][k], pb["opt_state"][k])
        for k in ("count", "mu", "nu"))
    print(f"resume: run (b) ends at step {pb['step']} as run (a) at "
          f"{pa['step']}; relative L2 to run (a): "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f" (limit {RESUME_REL_L2}); max |params diff| "
          f"{(flat_a - flat_b).abs().max().item():.3e}; bit for bit: {exact}"
          f"; epoch 2 loss {hist[1]['loss']:.6f} vs resumed "
          f"{res_b2['history'][0]['loss']:.6f}")
    if int(pb["opt_state"]["count"]) != pb["step"] or max(
            gaps.values()) > RESUME_REL_L2:
        raise AssertionError(f"resumed run away from run (a): {gaps}")

    pre, pre_launches = run_train(
        recipe_cfg(max_epochs=1, preaugment_epoch=True),
        "--preaugment-epoch --autoaugment")
    row = pre["history"][0]
    print(f"--preaugment-epoch: {row['epoch_time'] * 1e3 / TRAIN_STEPS:.3f} "
          f"ms a step with the dataset pass, {row['images_per_sec']:.1f} "
          f"img/s ({card})")

    # busy share of the recipe step, over 20 steps of its train_step
    rcfg = flagship_cfg(autoaugment=True)
    _, x_train, y_train, _, state, train_step, perm = training_setup(rcfg)
    for i in range(3):
        train_step(state, x_train, y_train, perm, i)
    prof = profile_steps(
        lambda i: train_step(state, x_train, y_train, perm, i + 3), 20,
        "recipe_trace.json", step_ms, card)
    if None not in (aa["kernels"], prof["kernels"]):
        print(f"AutoAugment in the recipe step: {aa['kernels']:.1f} kernels "
              f"and {aa['device_ms']:.3f} device ms a batch alone; the step "
              f"{prof['kernels']:.1f} kernels and {prof['device_ms']:.3f} "
              f"device ms ({card})")
    return {n: launches[n] + b1[n] + b2[n] + pre_launches[n]
            for n in launches}


def zoo_cfg(**kw) -> Config:
    """The default model (AEViT: 1 layer, hidden 384, ffn 768, AE hidden
    128; bf16-mixed, B=128) on synthetic c10 from epoch 0, seed 2045."""
    return Config(**{"seed": ZOO_SEED, "synthetic_data": True,
                     "warmup_epoch": 0,
                     "log_dir": os.path.join(WORK, "zoo_logs"),
                     "ckpt_dir": os.path.join(WORK, "zoo_models"), **kw})


def readme_cfg(**kw) -> Config:
    """``zoo_cfg`` at the README recipe's depth and width (7 layers,
    hidden 384, 12 heads, MLP 384, label smoothing)."""
    return zoo_cfg(**{"num_layers": 7, "hidden": 384, "mlp_hidden": 384,
                      "head": 12, "label_smoothing": True, **kw})


def check_no_launch(what: str) -> None:
    """The zoo's mixers are plain PyTorch: no attention kernel launches."""
    launches = {n: c for n, c in _launch_counts().items() if c}
    if launches:
        raise AssertionError(f"{what} launched attention kernels: "
                             f"{launches}")


def evaluate(cfg: Config, model, raw) -> tuple[float, float]:
    """(val_loss, val_acc) of ``model`` over the padded test set."""
    eval_step = make_eval_step(cfg, model)
    eb = cfg.eval_batch_size
    x, y, mask, n = _pad_eval(raw.x_test, raw.y_test, eb)
    x, y, mask = (torch.from_numpy(a).cuda() for a in (x, y, mask))
    sums = torch.zeros(3, device="cuda")
    for b in range(n):
        sl = slice(b * eb, (b + 1) * eb)
        out = eval_step(x[sl], y[sl], mask[sl])
        sums += torch.stack([out["loss_sum"], out["correct_sum"],
                             out["count"]])
    loss, correct, count = sums.tolist()
    return loss / count, correct / count


def zoo_default_run(card: str, raw) -> dict:
    """``python -m vit_cifar_torch`` with no model flag, one epoch: the
    loss must fall from the untrained model's, which the same seed gives."""
    argv = ["--dataset", "c10", "--synthetic-data", "--max-epochs", "1",
            # the default warmup of 5 epochs would train epoch 0 at lr 0
            "--warmup-epoch", "0", "--seed", str(ZOO_SEED),
            "--log-dir", os.path.join(WORK, "zoo_logs"),
            "--ckpt-dir", os.path.join(WORK, "zoo_models")]
    cfg = config_from_args(argv)
    if (cfg.model_name, cfg.num_layers, cfg.hidden, cfg.ffn_features,
            cfg.ae_hidden_features, cfg.precision) != (
            "ae", 1, 384, 768, 128, "bf16-mixed"):
        raise AssertionError(f"the default config changed: {cfg}")
    untrained, _ = get_model(cfg)
    val0, acc0 = evaluate(cfg, untrained, raw)
    del untrained
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    res = cli.main(argv)
    seconds = time.perf_counter() - t0
    check_no_launch("the default run")
    row = res["history"][0]
    step_ms = row["epoch_time"] * 1e3 / TRAIN_STEPS
    print(f"default run (AEViT, 1 layer, {res['n_params']} params) through "
          f"`python -m vit_cifar_torch`: {seconds:.1f} s (data set-up "
          f"included); train loss {row['loss']:.4f} (epoch mean), val_loss "
          f"{row['val_loss']:.4f}, val_acc {row['val_acc']:.4f}, from the "
          f"untrained model's val_loss {val0:.4f} (val_acc {acc0:.4f}); "
          f"{step_ms:.3f} ms a step, {row['images_per_sec']:.1f} img/s "
          f"(host clock over the epoch; {card})")
    if not (math.isfinite(row["loss"]) and row["skipped_nonfinite"] == 0
            and row["loss"] < val0 and row["val_loss"] < val0):
        raise AssertionError("the default run's loss did not fall")
    _, x, y, _, state, step, perm = training_setup(cfg, raw=raw)
    for i in range(ZOO_WARM):
        step(state, x, y, perm, i)
    prof = profile_steps(lambda i: step(state, x, y, perm, i + ZOO_WARM), 20,
                         "zoo_default_trace.json", step_ms, card)
    return {"ms": step_ms, "img_s": row["images_per_sec"],
            "val_acc": row["val_acc"], **prof}


def zoo_steps(cfg: Config, raw, what: str, card: str,
              trace: str | None = None) -> float:
    """``ZOO_STEPS`` training steps of ``cfg`` on the card: finite losses,
    no attention kernel; returns the ms a step after ``ZOO_WARM``.  With
    ``trace``, 5 more steps under the profiler (``profile_steps``)."""
    _, x, y, model, state, step, perm = training_setup(cfg, raw=raw)
    n_params = sum(p.numel() for p in model.parameters())
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    metrics = []
    for i in range(ZOO_STEPS):
        if i == ZOO_WARM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = step(state, x, y, perm, i)
        metrics.append(m)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (ZOO_STEPS - ZOO_WARM)
    check_no_launch(what)
    losses = torch.stack([m["loss"] for m in metrics]).float().cpu()
    text = f"loss {losses[0]:.4f} -> {losses[-1]:.4f}"
    if "unsupervised_loss" in metrics[0]:
        unsup = torch.stack([m["unsupervised_loss"] for m in metrics]).cpu()
        text += f", unsupervised_loss {unsup[0]:.4f} -> {unsup[-1]:.4f}"
        if not torch.isfinite(unsup).all():
            raise AssertionError(f"{what}: an unsupervised loss is not finite")
    print(f"{what}: {n_params} params, {ZOO_STEPS} steps at "
          f"B={cfg.batch_size}, {text}; {ms:.3f} ms a step (steps "
          f"{ZOO_WARM}-{ZOO_STEPS - 1}, host clock, synchronized; {card})")
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{what}: a loss is not finite")
    if trace:
        profile_steps(lambda i: step(state, x, y, perm, ZOO_STEPS + i), 5,
                      trace, ms, card)
    return ms


def zoo_card_against_cpu(raw) -> dict:
    """One f32 step on the card and on the CPU from the same weights and
    batch: the default model, and the heads AE (aece, 1 unsupervised step)
    at the README depth."""
    gaps = {}
    for what, cfg in (
            ("default", zoo_cfg(precision="32")),
            ("heads", readme_cfg(ae_type="heads", unsupervised_steps=1,
                                 criterion="aece", precision="32"))):
        B = cfg.batch_size
        img = normalize(torch.from_numpy(raw.x_train[:B]), cfg.mean, cfg.std)
        label = torch.from_numpy(raw.y_train[:B])
        out = {}
        for dev in ("cuda", "cpu"):
            model, _ = get_model(cfg, device=dev)
            tx = make_optimizer(cfg, TRAIN_STEPS)
            state = init_state(cfg, model, tx)
            step = make_train_step(cfg, model, tx)
            t0 = time.perf_counter()
            state, m = step.on_batch(state, img.to(dev), label.to(dev))
            tensors = {"params": state.params, **state.opt_state}
            if state.ae_opt_state is not None:
                tensors.update({f"ae_{k}": v
                                for k, v in state.ae_opt_state.items()})
            out[dev] = {k: v.float().cpu() for k, v in tensors.items()
                        if v.dim()}
            out[dev]["loss"] = m["loss"].item()
            out[dev]["s"] = time.perf_counter() - t0
        gap = {k: _rel_l2(out["cuda"][k], out["cpu"][k])
               for k in out["cpu"] if k not in ("loss", "s")}
        limit = {k: ZOO_AE_CARD_CPU_REL_L2 if k.startswith("ae_")
                 else ZOO_CARD_CPU_REL_L2 for k in gap}
        print(f"card vs CPU, one f32 step of the {what} model at B={B}: loss "
              f"{out['cuda']['loss']:.6f} vs {out['cpu']['loss']:.6f}; "
              f"relative L2 " + ", ".join(f"{k} {v:.3e}" for k, v in
                                          gap.items())
              + f" (limit {ZOO_CARD_CPU_REL_L2}, {ZOO_AE_CARD_CPU_REL_L2} "
              f"for ae_*); the CPU step took {out['cpu']['s']:.1f} s")
        if any(gap[k] > limit[k] for k in gap):
            raise AssertionError(f"{what}: card and CPU disagree: {gap}")
        gaps[what] = max(gap.values())
    return gaps


def zoo_ce_leaves_the_ae(raw) -> None:
    """Under ``ce``, on the card: the main update leaves the AE entries
    exactly where the unsupervised loop wrote them (the loop run alone on
    the same forward's inputs), and their main moments at zero."""
    cfg = zoo_cfg(unsupervised_steps=1)
    _, x, y, model, state, step, perm = training_setup(cfg, raw=raw)
    img, label = step.make_batch(state, x, y, perm, 0)[:2]
    before = state.params.clone()
    ae_state = {k: v.clone() for k, v in state.ae_opt_state.items()}
    with torch.no_grad():
        model(img, deterministic=False, generator=state.generator)
    make_unsupervised_update(cfg, model)[1](state)
    alone = state.params.clone()
    state.params.copy_(before)
    state.ae_opt_state = ae_state
    state, _ = step.on_batch(state, img, label)
    ae = flat_mask(model, is_ae_param)
    moved = not torch.equal(alone[ae], before[ae])
    exact = torch.equal(state.params[ae], alone[ae])
    zero = not any(torch.any(state.opt_state[k][ae]) for k in ("mu", "nu"))
    print(f"ce + 1 unsupervised step on the card: the inner loop moved the "
          f"AE's {int(ae.sum())} entries: {moved}; the step left them where "
          f"the loop wrote them, bit for bit: {exact}; their main moments "
          f"zero: {zero}")
    if not (moved and exact and zero):
        raise AssertionError("the main update moved the AE entries")


def zoo_semi_and_resume(card: str) -> None:
    """One ``--semi-supervised`` epoch of the default model, then an
    unsupervised run stopped after epoch 1 and resumed, against the
    straight run."""
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    semi = train(zoo_cfg(semi_supervised=True, max_epochs=1), verbose=False)
    row = semi["history"][0]
    step = load_checkpoint(semi["ckpt_dir"], prefer="last")[0]["step"]
    print(f"--semi-supervised, one epoch: {step} steps (10 passes over the "
          f"4,000 labeled images), loss {row['loss']:.4f}, val_acc "
          f"{row['val_acc']:.4f}, {row['epoch_time'] * 1e3 / step:.3f} ms a "
          f"step ({card})")
    if step != SEMI_STEPS or not math.isfinite(row["loss"]):
        raise AssertionError(f"--semi-supervised: {step} steps, {row}")
    cfg = zoo_cfg(unsupervised_steps=1, max_epochs=2)
    runs = {}
    for name, kw, stop in (("a", {}, None), ("b1", {}, 1), ("b2", None, None)):
        kw = {"resume": runs["b1"]["ckpt_dir"]} if kw is None else kw
        runs[name] = train(cfg.replace(
            ckpt_dir=os.path.join(WORK, "zoo_models", name), **kw),
            verbose=False, stop_after=stop)
    check_no_launch("the semi-supervised and resume runs")
    pa, pb = (load_checkpoint(runs[n]["ckpt_dir"], prefer="last")[0]
              for n in ("a", "b2"))
    flat_a, flat_b = (torch.cat([t.reshape(-1) for t in p["params"].values()])
                      for p in (pa, pb))
    pairs = {"params": (flat_a, flat_b)}
    for key in ("opt_state", "ae_opt_state"):
        pairs.update({f"{key}.{k}": (pa[key][k], pb[key][k])
                      for k in ("count", "mu", "nu")})
    exact = {k: torch.equal(a, b) for k, (a, b) in pairs.items()}
    print(f"unsupervised run resumed after epoch 1: step {pb['step']} as "
          f"the straight run's {pa['step']}; equal to it: {exact}; "
          f"unsupervised_loss of epoch 2 "
          f"{runs['a']['history'][1]['unsupervised_loss']:.6f} vs "
          f"{runs['b2']['history'][0]['unsupervised_loss']:.6f}")
    if pa["step"] != pb["step"] or not all(exact.values()):
        raise AssertionError("the resumed unsupervised run is not the "
                             "straight run")


def zoo_phase(card: str) -> dict:
    shutil.rmtree(os.path.join(WORK, "zoo_models"), ignore_errors=True)
    shutil.rmtree(os.path.join(WORK, "zoo_logs"), ignore_errors=True)
    raw = load_dataset("c10", "data", synthetic=True)
    out = {"default": zoo_default_run(card, raw)}
    out["heads"] = zoo_steps(
        readme_cfg(ae_type="heads", unsupervised_steps=1, criterion="aece"),
        raw, "AEViT heads (chunked eye mask), 7 layers, 12 heads, aece, 1 "
        "unsupervised step", card, trace="zoo_heads_trace.json")
    out["card_vs_cpu"] = zoo_card_against_cpu(raw)
    zoo_ce_leaves_the_ae(raw)
    for name in ZOO_MIXERS:
        out[name] = zoo_steps(readme_cfg(model_name=name), raw,
                              f"{name}, 7 layers, README width", card)
    zoo_semi_and_resume(card)
    return out


@contextlib.contextmanager
def train_precision(cfg: Config):
    """``cfg.matmul_precision`` for f32 products, as ``train()`` sets it
    for its run; the previous setting is restored on exit."""
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(cfg.matmul_precision)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)


def nnmf_epoch(card: str, raw) -> dict:
    """``gnnmf_sbs --optimizer madam --train-md-bases`` for one uncut epoch
    through ``train()``: the loss falls from the untrained model's, no step
    is skipped, and after the epoch every ``nnmf_weights`` column sums to 1
    and sits at or above its after-care floor; then its step under the
    profiler, at ``train()``'s matmul precision."""
    cfg = readme_cfg(model_name="gnnmf_sbs", optimizer="madam",
                     train_md_bases=True, max_epochs=1)
    untrained, _ = get_model(cfg)
    val0, acc0 = evaluate(cfg, untrained, raw)
    del untrained
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    res = train(cfg, verbose=False)
    seconds = time.perf_counter() - t0
    check_no_launch("the gnnmf_sbs epoch")
    row = res["history"][0]
    step_ms = row["epoch_time"] * 1e3 / TRAIN_STEPS
    params = load_checkpoint(res["ckpt_dir"], prefer="last")[0]["params"]
    thr = cfg.nnmf_learning_rate_threshold_w
    weights = {n: w for n, w in params.items() if n.endswith("nnmf_weights")}
    col_err = max(float((w.sum(0) - 1).abs().max()) for w in weights.values())
    floor_gap = min(float(w.min()) - thr / (1 + w.shape[0] * thr)
                    for w in weights.values())
    print(f"gnnmf_sbs + madam + --train-md-bases, 7 layers, one epoch "
          f"through train(): {res['n_params']} params, {seconds:.1f} s "
          f"(data set-up included); train loss {row['loss']:.4f} (epoch "
          f"mean), val_loss {row['val_loss']:.4f}, val_acc "
          f"{row['val_acc']:.4f}, from the untrained model's val_loss "
          f"{val0:.4f} (val_acc {acc0:.4f}); lr_0 {row['lr_0']:.6f}, lr_1 "
          f"{row['lr_1']:.6f}; skipped {row['skipped_nonfinite']}; "
          f"{step_ms:.3f} ms a step, {row['images_per_sec']:.1f} img/s "
          f"(host clock over the epoch; {card})")
    print(f"after the epoch, {len(weights)} nnmf_weights: largest |column "
          f"sum - 1| {col_err:.3e}; smallest entry minus the after-care "
          f"floor thr/(1 + C thr) {floor_gap:.3e}")
    if not (math.isfinite(row["loss"]) and row["skipped_nonfinite"] == 0
            and row["loss"] < val0 and row["val_loss"] < val0):
        raise AssertionError("the gnnmf_sbs epoch's loss did not fall, or "
                             "it skipped a step")
    if len(weights) != cfg.num_layers or col_err > 1e-5 or floor_gap < -1e-9:
        raise AssertionError("the after-care did not hold the nnmf_weights")
    with train_precision(cfg):
        _, x, y, _, state, step, perm = training_setup(cfg, raw=raw)
        for i in range(ZOO_WARM):
            step(state, x, y, perm, i)
        prof = profile_steps(
            lambda i: step(state, x, y, perm, i + ZOO_WARM),
            NNMF_PROFILE_STEPS, "nnmf_sbs_trace.json", step_ms, card)
    return {"ms": step_ms, "img_s": row["images_per_sec"],
            "val_acc": row["val_acc"], **prof}


def nnmf_steps(cfg: Config, raw, what: str, card: str,
               finite: bool = True) -> dict:
    """``NNMF_STEPS`` training steps of ``cfg`` on the card at ``train()``'s
    matmul precision, no attention kernel; ms a step after ``ZOO_WARM`` and
    the steps the guard skipped.  With ``finite``, every loss must be
    finite and no step skipped."""
    with train_precision(cfg):
        _, x, y, model, state, step, perm = training_setup(cfg, raw=raw)
        n_params = sum(p.numel() for p in model.parameters())
        for wrapper in KERNEL_WRAPPERS.values():
            wrapper.launches = 0
        metrics = []
        for i in range(NNMF_STEPS):
            if i == ZOO_WARM:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, m = step(state, x, y, perm, i)
            metrics.append(m)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (NNMF_STEPS - ZOO_WARM)
    check_no_launch(what)
    losses = torch.stack([m["loss"] for m in metrics]).float().cpu()
    skipped = int(sum(float(m["skipped_nonfinite"]) for m in metrics))
    text = (f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, finite "
            f"{int(torch.isfinite(losses).sum())}/{NNMF_STEPS}, skipped "
            f"{skipped}")
    if "unsupervised_loss" in metrics[0]:
        unsup = torch.stack([m["unsupervised_loss"] for m in metrics]).cpu()
        text += f", unsupervised_loss {unsup[0]:.4f} -> {unsup[-1]:.4f}"
    print(f"{what}: {n_params} params, {NNMF_STEPS} steps at "
          f"B={cfg.batch_size}, matmul precision {cfg.matmul_precision}, "
          f"{text}; {ms:.3f} ms a step (steps {ZOO_WARM}-{NNMF_STEPS - 1}, "
          f"host clock, synchronized; {card})")
    if finite and (skipped or not torch.isfinite(losses).all()):
        raise AssertionError(f"{what}: a loss is not finite")
    return {"ms": ms, "skipped": skipped}


def nnmf_card_against_cpu(raw) -> dict:
    """One f32 step of gnnmf_sbs (madam, --train-md-bases) and of the heads
    NNMF AE (7 layers, 12 heads, one unsupervised step; norm1 biases
    raised by ``NNMF_NORM1_SHIFT``) on the card and on the CPU from the
    same weights and batch: params, both moments and the AE's Madam
    moments, in relative L2."""
    gaps = {}
    for what, cfg in (
            ("gnnmf_sbs", readme_cfg(model_name="gnnmf_sbs",
                                     optimizer="madam", train_md_bases=True,
                                     precision="32")),
            # B=32: its masked rows' W.W^T products take about 5.6 TFLOP
            # of f32 a step at B=128, tens of seconds on the host's cores
            ("heads NNMF AE", readme_cfg(ae_type="heads",
                                         use_nnmf_layers=True,
                                         unsupervised_steps=1,
                                         precision="32", batch_size=32))):
        B = cfg.batch_size
        img = normalize(torch.from_numpy(raw.x_train[:B]), cfg.mean, cfg.std)
        label = torch.from_numpy(raw.y_train[:B])
        out = {}
        # the card again with the input one ulp larger: the step's spread
        for run, dev, scale in (("cuda", "cuda", 1.0), ("cpu", "cpu", 1.0),
                                ("ulp", "cuda", 1.0 + 2.0 ** -23)):
            model, _ = get_model(cfg, device=dev)
            if cfg.use_nnmf_layers:
                with torch.no_grad():
                    for m in model.modules():
                        if hasattr(m, "ae_input"):
                            m.norm1.bias += NNMF_NORM1_SHIFT
            tx = make_optimizer(cfg, TRAIN_STEPS, model)
            state = init_state(cfg, model, tx)
            step = make_train_step(cfg, model, tx)
            t0 = time.perf_counter()
            state, m = step.on_batch(state, (img * scale).to(dev),
                                     label.to(dev))
            tensors = {"params": state.params, **state.opt_state}
            if state.ae_opt_state is not None:
                tensors.update({f"ae_{k}": v
                                for k, v in state.ae_opt_state.items()})
            out[run] = {k: v.float().cpu() for k, v in tensors.items()
                        if v.dim()}
            out[run]["loss"] = m["loss"].item()
            out[run]["skipped"] = m["skipped_nonfinite"].item()
            out[run]["s"] = time.perf_counter() - t0
        keys = [k for k in out["cpu"] if k not in ("loss", "skipped", "s")]
        gap = {k: _rel_l2(out["cuda"][k], out["cpu"][k]) for k in keys}
        spread = {k: _rel_l2(out["ulp"][k], out["cuda"][k]) for k in keys}
        limit = {k: NNMF_AE_CARD_CPU_REL_L2 if k.startswith("ae_")
                 else NNMF_CARD_CPU_REL_L2[what] for k in gap}
        print(f"card vs CPU, one f32 step of {what} at B={B}: loss "
              f"{out['cuda']['loss']:.6f} vs {out['cpu']['loss']:.6f}, "
              f"skipped {out['cuda']['skipped']} vs {out['cpu']['skipped']}; "
              f"relative L2 " + ", ".join(f"{k} {v:.3e}" for k, v in
                                          gap.items())
              + f" (limit {NNMF_CARD_CPU_REL_L2[what]}, "
              f"{NNMF_AE_CARD_CPU_REL_L2} for ae_*); the card's own step "
              "with the input one ulp larger: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in spread.items())
              + f"; the CPU step took {out['cpu']['s']:.1f} s")
        if any(gap[k] > limit[k] for k in gap) or out["cuda"]["skipped"] \
                or out["cpu"]["skipped"]:
            raise AssertionError(f"{what}: card and CPU disagree: {gap}")
        gaps[what] = max(gap.values())
    return gaps


def nnmf_resume(card: str) -> None:
    """A short gnnmf_ham --train-md-bases (madam) run, 2 epochs over the
    4,000 labeled images of ``--semi-supervised`` without the combined
    pacing (31 steps an epoch): stopped after epoch 1 and resumed, it must
    equal the straight run bit for bit, its bases included."""
    cfg = zoo_cfg(model_name="gnnmf_ham", train_md_bases=True,
                  optimizer="madam", semi_supervised=True,
                  ss_combined_epoch=False, max_epochs=2)
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    runs = {}
    for name, kw, stop in (("a", {}, None), ("b1", {}, 1), ("b2", None, None)):
        kw = {"resume": runs["b1"]["ckpt_dir"]} if kw is None else kw
        runs[name] = train(cfg.replace(
            ckpt_dir=os.path.join(WORK, "nnmf_models", name), **kw),
            verbose=False, stop_after=stop)
    check_no_launch("the gnnmf_ham resume runs")
    pa, pb = (load_checkpoint(runs[n]["ckpt_dir"], prefer="last")[0]
              for n in ("a", "b2"))
    pairs = {f"{key}.{k}": (pa[key][k], pb[key][k])
             for key in ("params", "model_state", "opt_state")
             for k in pa[key]}
    exact = all(torch.equal(a, b) for a, b in pairs.values())
    moved = not torch.equal(
        pa["model_state"]["enc0.mixer.NNMF.bases"],
        load_checkpoint(runs["b1"]["ckpt_dir"], prefer="last")[0][
            "model_state"]["enc0.mixer.NNMF.bases"])
    row_a, row_b = runs["a"]["history"][1], runs["b2"]["history"][0]
    print(f"gnnmf_ham --train-md-bases, resumed after epoch 1: step "
          f"{pb['step']} as the straight run's {pa['step']}; params, "
          f"{len(pa['model_state'])} bases buffer(s) and optimizer state "
          f"equal to it bit for bit: {exact}; the bases moved in epoch 2: "
          f"{moved}; epoch 2 loss {row_a['loss']:.6f} vs {row_b['loss']:.6f}"
          f", lr_1 {row_a['lr_1']:.6f} vs {row_b['lr_1']:.6f}, "
          f"{row_a['epoch_time'] * 1e3 / pa['step'] * 2:.3f} ms a step "
          f"({card})")
    if pa["step"] != pb["step"] or not exact or not moved:
        raise AssertionError("the resumed gnnmf_ham run is not the straight "
                             "run")


def nnmf_phase(card: str) -> dict:
    """The NNMF family (seed 2045, bf16-mixed, synthetic c10, B=128): no
    attention kernel launches in any of it."""
    t0 = time.perf_counter()
    shutil.rmtree(os.path.join(WORK, "nnmf_models"), ignore_errors=True)
    raw = load_dataset("c10", "data", synthetic=True)
    out = {"gnnmf_sbs": nnmf_epoch(card, raw)}
    for name, kw in (("gnnmf_sbsed", {}), ("gnnmf_ham", {}),
                     ("gnnmf_ham", {"train_md_bases": True})):
        what = name + (" --train-md-bases" if kw else "") + ", 7 layers"
        out[what] = nnmf_steps(readme_cfg(model_name=name, **kw), raw, what,
                               card)
    # the feature-dim AE of NNMF layers is not finite in the reference
    # (NNMFLinear L1-normalizes the LayerNormed input): the guard skips
    out["ae_nnmf"] = nnmf_steps(
        zoo_cfg(use_nnmf_layers=True), raw,
        "ae --use-nnmf-layers (AEViT, 1 layer)", card, finite=False)
    out["heads_nnmf"] = nnmf_steps(
        readme_cfg(ae_type="heads", use_nnmf_layers=True,
                   unsupervised_steps=1), raw,
        "heads NNMF AE, 7 layers, 12 heads, 1 unsupervised step", card,
        finite=False)
    out["card_vs_cpu"] = nnmf_card_against_cpu(raw)
    nnmf_resume(card)
    print(f"the NNMF phase took {time.perf_counter() - t0:.1f} s")
    return out


def moe_cfg(**kw) -> Config:
    """The README recipe (AutoAugment included) with --moe-experts 8."""
    return readme_cfg(**{"model_name": "vit", "autoaugment": True,
                         "moe_experts": REST_MOE_EXPERTS, **kw})


def batch_stat_accuracy(cfg: Config, model, raw) -> float:
    """val_acc of ``model`` over the test set with every BatchNorm using the
    batch's own statistics (``deterministic=False``; the config has no
    dropout), the running statistics restored afterwards."""
    kept = [b.clone() for b in model.buffers()]
    eb = cfg.eval_batch_size
    correct = 0
    with torch.no_grad():
        for b in range(0, len(raw.x_test), eb):
            x = normalize(torch.from_numpy(raw.x_test[b:b + eb]).cuda(),
                          cfg.mean, cfg.std).to(torch_dtype(cfg))
            pred = model(x, deterministic=False).argmax(-1).cpu().numpy()
            correct += int((pred == raw.y_test[b:b + eb]).sum())
        for buf, old in zip(model.buffers(), kept):
            buf.copy_(old)
    return correct / len(raw.x_test)


def lgcnn_bn_epoch(card: str, raw) -> dict:
    """``lgcnn --cnn-normalization batch_norm`` for one epoch through
    ``train()``: no kernel launches, no step skipped and val_acc >=
    ``MIN_VAL_ACC`` by the eval path (the running statistics); val_acc with
    each batch's own statistics beside it.  Then its step under the
    profiler.  Returns the row's numbers, the profile and the run's
    checkpoint directory."""
    cfg = readme_cfg(model_name="lgcnn", cnn_normalization="batch_norm",
                     max_epochs=1,
                     ckpt_dir=os.path.join(WORK, "rest_models"))
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    res = train(cfg, verbose=False)
    seconds = time.perf_counter() - t0
    check_no_launch("the lgcnn batch_norm epoch")
    row = res["history"][0]
    step_ms = row["epoch_time"] * 1e3 / TRAIN_STEPS
    payload, _ = load_checkpoint(res["ckpt_dir"], prefer="last")
    model, _ = get_model(cfg)
    model.load_state_dict({**payload["params"], **payload["model_state"]})
    batch_acc = batch_stat_accuracy(cfg, model, raw)
    print(f"lgcnn --cnn-normalization batch_norm, 7 layers, one epoch "
          f"through train(): {res['n_params']} params, {seconds:.1f} s (data "
          f"set-up included); train loss {row['loss']:.4f} (epoch mean), "
          f"acc {row['acc']:.4f}; by the running statistics val_loss "
          f"{row['val_loss']:.4f}, val_acc {row['val_acc']:.4f} (at least "
          f"{MIN_VAL_ACC}); with each batch's own statistics val_acc "
          f"{batch_acc:.4f}; skipped {row['skipped_nonfinite']}; "
          f"{step_ms:.3f} ms a step, "
          f"{row['images_per_sec']:.1f} img/s (host clock over the epoch; "
          f"{card})")
    if not (math.isfinite(row["loss"]) and row["skipped_nonfinite"] == 0
            and row["val_acc"] >= MIN_VAL_ACC):
        raise AssertionError("the lgcnn batch_norm epoch did not learn")
    with train_precision(cfg):
        _, x, y, _, state, step, perm = training_setup(cfg, raw=raw)
        for i in range(ZOO_WARM):
            step(state, x, y, perm, i)
        prof = profile_steps(lambda i: step(state, x, y, perm, i + ZOO_WARM),
                             REST_PROFILE_STEPS, "lgcnn_bn_trace.json",
                             step_ms, card)
    return {"ms": step_ms, "img_s": row["images_per_sec"],
            "val_acc": row["val_acc"], "batch_stat_val_acc": batch_acc,
            "ckpt": res["ckpt_dir"], **prof}


def lgcnn_bn_resume(card: str) -> None:
    """A short lgcnn batch_norm run, 2 epochs over the 4,000 labeled images
    of ``--semi-supervised`` without the combined pacing, at
    ``RESUME_BATCH``: stopped after epoch 1 and resumed, it must equal the
    straight run bit for bit, its running statistics included."""
    cfg = readme_cfg(model_name="lgcnn", cnn_normalization="batch_norm",
                     semi_supervised=True, ss_combined_epoch=False,
                     max_epochs=2, batch_size=RESUME_BATCH,
                     eval_batch_size=RESUME_EVAL_BATCH)
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    runs = {}
    for name, kw, stop in (("a", {}, None), ("b1", {}, 1), ("b2", None, None)):
        kw = {"resume": runs["b1"]["ckpt_dir"]} if kw is None else kw
        runs[name] = train(cfg.replace(
            ckpt_dir=os.path.join(WORK, "rest_models", name), **kw),
            verbose=False, stop_after=stop)
    check_no_launch("the lgcnn resume runs")
    pa, pb, pb1 = (load_checkpoint(runs[n]["ckpt_dir"], prefer="last")[0]
                   for n in ("a", "b2", "b1"))
    pairs = {f"{key}.{k}": (pa[key][k], pb[key][k])
             for key in ("params", "model_state", "opt_state")
             for k in pa[key]}
    exact = all(torch.equal(a, b) for a, b in pairs.values())
    moved = sum(not torch.equal(pa["model_state"][k], pb1["model_state"][k])
                for k in pa["model_state"])
    row_a, row_b = runs["a"]["history"][1], runs["b2"]["history"][0]
    print(f"lgcnn batch_norm, resumed after epoch 1: step {pb['step']} as "
          f"the straight run's {pa['step']}; params, "
          f"{len(pa['model_state'])} running-statistics buffers and the "
          f"optimizer state equal to it bit for bit: {exact}; buffers that "
          f"moved in epoch 2: {moved}; epoch 2 loss {row_a['loss']:.6f} vs "
          f"{row_b['loss']:.6f}, val_loss {row_a['val_loss']:.6f} vs "
          f"{row_b['val_loss']:.6f} ({card})")
    if pa["step"] != pb["step"] or not exact or moved != len(
            pa["model_state"]) or not pa["model_state"]:
        raise AssertionError("the resumed lgcnn run is not the straight run")


def lgcnn_bn_serving(card: str, ckpt: str, raw) -> None:
    """The epoch's checkpoint exported and served at B=1 and B=128: the
    logits within the eval path's (the model rebuilt from the checkpoint,
    its running statistics included, ``deterministic=True``), and away from
    what the same weights give with fresh statistics."""
    art = export_inference(ckpt, os.path.join(WORK, "rest_art"),
                           which="last", device="cuda")
    served = ServingModel(art, device="cuda")
    payload, cfg = load_checkpoint(ckpt, prefer="last")
    model, _ = get_model(cfg)
    model.load_state_dict({**payload["params"], **payload["model_state"]})
    fresh, _ = get_model(cfg)
    fresh.load_state_dict(payload["params"], strict=False)
    for n in (1, 128):
        imgs = raw.x_test[:n]
        t0 = time.perf_counter()
        got = served.predict(imgs)
        ms = (time.perf_counter() - t0) * 1e3
        x = normalize(torch.from_numpy(imgs).cuda(), cfg.mean,
                      cfg.std).to(torch_dtype(cfg))
        with torch.no_grad():
            want = model(x, deterministic=True).float().cpu().numpy()
            other = fresh(x, deterministic=True).float().cpu().numpy()
        err, apart = (float(np.abs(got - want).max()),
                      float(np.abs(got - other).max()))
        print(f"lgcnn batch_norm served at B={n}: {ms:.3f} ms (first call "
              f"included); max |served - eval path| {err:.3e} (rtol="
              f"{LOGIT_TOL['rtol']} atol={LOGIT_TOL['atol']}); with fresh "
              f"running statistics the logits move by {apart:.3e} ({card})")
        np.testing.assert_allclose(got, want, **LOGIT_TOL)
        if not apart > LOGIT_TOL["atol"]:
            raise AssertionError("the served model ignores its statistics")


def rest_steps(cfg: Config, raw, what: str, card: str,
               per_step: dict | None = None,
               trace: str | None = None) -> dict:
    """``ZOO_STEPS`` training steps of ``cfg`` on the card at ``train()``'s
    matmul precision: finite losses, no step skipped, and no attention
    kernel, or ``per_step`` launches of each a step; then, with ``per_step``,
    the eval over the padded test set.  Returns the ms a step after
    ``ZOO_WARM``, the launches, and with ``trace`` the profile of
    ``REST_PROFILE_STEPS`` more steps."""
    with train_precision(cfg):
        _, x, y, model, state, step, perm = training_setup(cfg, raw=raw)
        n_params = sum(p.numel() for p in model.parameters())
        for wrapper in KERNEL_WRAPPERS.values():
            wrapper.launches = 0
        metrics = []
        for i in range(ZOO_STEPS):
            if i == ZOO_WARM:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, m = step(state, x, y, perm, i)
            metrics.append(m)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (ZOO_STEPS - ZOO_WARM)
        launches = _launch_counts()
        val = evaluate(cfg, model, raw) if per_step else None
    eval_launches = _launch_counts()
    losses = torch.stack([m["loss"] for m in metrics]).float().cpu()
    skipped = int(sum(float(m["skipped_nonfinite"]) for m in metrics))
    text = f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, skipped {skipped}"
    if "moe_aux" in metrics[0]:
        aux = torch.stack([m["moe_aux"] for m in metrics]).float().cpu()
        text += f", moe_aux {aux[0]:.4f} -> {aux[-1]:.4f}"
    if val is not None:
        text += f"; eval val_loss {val[0]:.4f}, val_acc {val[1]:.4f}"
    print(f"{what}: {n_params} params, {ZOO_STEPS} steps at "
          f"B={cfg.batch_size}, {text}; {ms:.3f} ms a step (steps "
          f"{ZOO_WARM}-{ZOO_STEPS - 1}, host clock, synchronized; {card})")
    if skipped or not torch.isfinite(losses).all():
        raise AssertionError(f"{what}: a loss is not finite")
    if per_step is None:
        check_no_launch(what)
    else:
        want = {n: per_step.get(n, 0) * ZOO_STEPS for n in KERNEL_WRAPPERS}
        # 40 eval batches of 256, one launch a layer each
        want_eval = dict(want, mhsa_fwd=want["mhsa_fwd"] + 40 * cfg.num_layers)
        print(f"{what}: launches over the {ZOO_STEPS} steps "
              f"{ {n: c for n, c in launches.items() if c} }, then the eval "
              f"{eval_launches['mhsa_fwd'] - launches['mhsa_fwd']} of "
              f"mhsa_fwd")
        if launches != want or eval_launches != want_eval:
            raise AssertionError(f"{what}: launches {launches}, then "
                                 f"{eval_launches}; expected {want}, then "
                                 f"{want_eval}")
    out = {"ms": ms, "launches": eval_launches}
    if trace:
        with train_precision(cfg):
            out.update(profile_steps(
                lambda i: step(state, x, y, perm, ZOO_STEPS + i),
                REST_PROFILE_STEPS, trace, ms, card))
    return out


def inexact_constant_mean(token: torch.Tensor, batch: int, device) -> int:
    """The channels where ``TorchBatchNorm``'s batch mean of ``batch``
    copies of ``token`` (the cls token at layer 0) differs from the token
    on ``device``: there its residual, multiplied by 1/sqrt(eps), is what
    the normalization passes on.  ``token`` is (1, 1, C), as at
    ``--kernel-size 1``."""
    x = token.detach().to(device).expand(batch, *token.shape).contiguous()
    return int((x[0, 0, 0] != x.mean((0, 1, 2))).sum())


def rest_card_against_cpu(raw) -> dict:
    """One f32 step of lgcnn (both norms), hamburger V2+ and the MoE ViT on
    the card and on the CPU from the same weights and batch, at
    ``REST_CARD_CPU_BATCH``: params, both moments and the buffers (running
    statistics), in relative L2, beside the card's own spread with the
    input one f32 ulp larger.  For lgcnn also each side's own spread with
    the cls token one ulp larger (the CPU's is the witness), and for lgcnn
    batch_norm the channels where each side's mean of the batch-constant
    cls token is not exact and the bf16-mixed step against the f32 CPU
    (the control)."""
    gaps = {}
    for what, cfg in (
            ("lgcnn layer_norm", readme_cfg(model_name="lgcnn")),
            ("lgcnn batch_norm", readme_cfg(
                model_name="lgcnn", cnn_normalization="batch_norm")),
            # persistent bases: drawn once from the CPU generator, where
            # fresh ones would come from each device's own stream
            ("hamburger V2+ --train-md-bases", readme_cfg(
                model_name="hamburger", burger_mode="V2+",
                train_md_bases=True)),
            ("vit --moe-experts 8", moe_cfg(autoaugment=False))):
        cfg = cfg.replace(precision="32", batch_size=REST_CARD_CPU_BATCH)
        B = cfg.batch_size
        img = normalize(torch.from_numpy(raw.x_train[:B]), cfg.mean, cfg.std)
        label = torch.from_numpy(raw.y_train[:B])
        runs = [("cuda", "cuda", 1.0, cfg), ("cpu", "cpu", 1.0, cfg),
                ("ulp", "cuda", 1.0 + 2.0 ** -23, cfg)]
        if what.startswith("lgcnn"):
            runs += [("cls_ulp", "cuda", 1.0, cfg),
                     ("cpu_cls_ulp", "cpu", 1.0, cfg)]
        if what == "lgcnn batch_norm":
            runs.append(("bf16", "cuda", 1.0,
                         cfg.replace(precision="bf16-mixed")))
        out = {}
        for run, dev, scale, run_cfg in runs:
            model, _ = get_model(run_cfg, device=dev)
            if run == "cpu" and what.startswith("lgcnn"):
                token = model.cls_token.detach().clone()
            if run.endswith("cls_ulp"):
                with torch.no_grad():
                    model.cls_token.copy_(torch.nextafter(
                        model.cls_token, torch.full_like(model.cls_token,
                                                         math.inf)))
            tx = make_optimizer(run_cfg, TRAIN_STEPS, model)
            state = init_state(run_cfg, model, tx)
            step = make_train_step(run_cfg, model, tx)
            t0 = time.perf_counter()
            state, m = step.on_batch(state, (img * scale).to(dev),
                                     label.to(dev))
            tensors = {"params": state.params, **state.opt_state}
            buffers = [b.reshape(-1) for b in model.buffers()]
            if buffers:
                tensors["buffers"] = torch.cat(buffers)
            out[run] = {k: v.float().cpu() for k, v in tensors.items()
                        if v.dim()}
            out[run]["loss"] = m["loss"].item()
            out[run]["s"] = time.perf_counter() - t0
            shapes = [(n, p.numel()) for n, p in model.named_parameters()]
        keys = [k for k in out["cpu"] if k not in ("loss", "s")]
        gap = {k: _rel_l2(out["cuda"][k], out["cpu"][k]) for k in keys}
        spread = {run: {k: _rel_l2(out[run][k], out[base][k]) for k in keys}
                  for run, base in (("ulp", "cuda"), ("cls_ulp", "cuda"),
                                    ("cpu_cls_ulp", "cpu")) if run in out}
        control = ({k: _rel_l2(out["bf16"][k], out["cpu"][k]) for k in keys}
                   if "bf16" in out else None)
        limit = (LGCNN_BN_CARD_CPU_REL_L2 if what == "lgcnn batch_norm"
                 else ZOO_CARD_CPU_REL_L2)
        # the parameter tensors farthest apart
        names, sizes = zip(*shapes)
        by_tensor = sorted(zip(
            (_rel_l2(a, b) for a, b in zip(
                out["cuda"]["params"].split(sizes),
                out["cpu"]["params"].split(sizes))), names), reverse=True)

        def line(d):
            return ", ".join(f"{k} {v:.3e}" for k, v in d.items())

        text = (f"card vs CPU, one f32 step of {what} at B={B}: loss "
                f"{out['cuda']['loss']:.6f} vs {out['cpu']['loss']:.6f}; "
                f"relative L2 {line(gap)} (limit {limit}); the card's own "
                f"step with the input one ulp larger: {line(spread['ulp'])}")
        if "cls_ulp" in spread:
            text += (f"; the CPU's own step with the cls token one ulp "
                     f"larger (the witness): {line(spread['cpu_cls_ulp'])}; "
                     f"the card's: {line(spread['cls_ulp'])}")
        if what == "lgcnn batch_norm":
            inexact = {dev: inexact_constant_mean(token, B, dev)
                       for dev in ("cuda", "cpu")}
            text += (f"; channels where the mean of the {B} equal cls "
                     f"tokens is not exact: card {inexact['cuda']}, CPU "
                     f"{inexact['cpu']} of {token.shape[-1]}")
        if control is not None:
            text += (f"; bf16-mixed on the card vs the f32 CPU (the "
                     f"control): loss {out['bf16']['loss']:.6f}, "
                     f"{line(control)}")
        print(text + "; farthest params: " + ", ".join(
            f"{n} {v:.3e}" for v, n in by_tensor[:3])
            + f"; the CPU step took {out['cpu']['s']:.1f} s")
        if any(v > limit for v in gap.values()):
            raise AssertionError(f"{what}: card and CPU disagree: {gap}")
        if what == "lgcnn layer_norm" and any(
                v > ZOO_CARD_CPU_REL_L2
                for v in spread["cpu_cls_ulp"].values()):
            raise AssertionError(f"{what}: the cls token's ulp moves the "
                                 f"step: {spread['cls_ulp']}")
        if what == "lgcnn batch_norm":
            witness, worst = max(spread["cpu_cls_ulp"].values()), max(
                gap.values())
            if witness < LGCNN_BN_WITNESS_SHARE * worst:
                raise AssertionError(
                    f"{what}: the cls token's ulp spreads {witness:.3e}, "
                    f"not the card-vs-CPU gap {worst:.3e}: the stated cause "
                    "does not explain the gap")
            if max(control.values()) <= limit:
                raise AssertionError(
                    f"{what}: the bf16 control {control} is within the "
                    f"limit {limit}: the limit tells nothing apart")
        gaps[what] = max(gap.values())
    return gaps


def rest_phase(card: str) -> dict:
    """The rest of the zoo (seed 2045, bf16-mixed, synthetic c10, B=128,
    the README depth and width): the CNNs and burgers launch no attention
    kernel; the MoE ViT launches the flagship's, whose counts it returns
    under ``launches``."""
    t0 = time.perf_counter()
    shutil.rmtree(os.path.join(WORK, "rest_models"), ignore_errors=True)
    raw = load_dataset("c10", "data", synthetic=True)
    epoch = lgcnn_bn_epoch(card, raw)
    t_epoch = time.perf_counter()
    lgcnn_bn_resume(card)
    lgcnn_bn_serving(card, epoch.pop("ckpt"), raw)
    t_resume = time.perf_counter()
    out = {"lgcnn_bn": epoch}
    for what, kw in REST_MODELS:
        out[what] = rest_steps(readme_cfg(**kw), raw, what + ", 7 layers",
                               card)
    t_steps = time.perf_counter()
    moe = moe_cfg()
    # the flagship's fused Function: its forward with lse and the tiled
    # pair, once a layer and step
    out["moe"] = rest_steps(
        moe, raw, f"the README recipe with --moe-experts {REST_MOE_EXPERTS}",
        card, per_step=dict.fromkeys(("mhsa_fwd_lse", "flash_bwd_dq_tiled",
                                      "flash_bwd_dkv_tiled"),
                                     moe.num_layers),
        trace="moe_trace.json")
    t_moe = time.perf_counter()
    out["card_vs_cpu"] = rest_card_against_cpu(raw)
    t_end = time.perf_counter()
    print(f"the rest-of-the-zoo phase took {t_end - t0:.1f} s: the lgcnn "
          f"epoch and its profile {t_epoch - t0:.1f}, resume and serving "
          f"{t_resume - t_epoch:.1f}, the {len(REST_MODELS)} 20-step runs "
          f"{t_steps - t_resume:.1f}, the MoE ViT {t_moe - t_steps:.1f}, card "
          f"vs CPU {t_end - t_moe:.1f}")
    return out


def graph_ops(art: str) -> dict:
    """The port's operators in an artifact's exported graph, with counts."""
    program = torch.export.load(os.path.join(art, "serving.pt2"))
    ops: dict = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if name.startswith(registry.NAMESPACE):
            ops[name] = ops.get(name, 0) + 1
    if not ops:
        raise AssertionError(f"{art}: no operator of the port in the graph")
    return ops


def dispatch_cost(card: str) -> None:
    """The flagship's training step (the README recipe without AutoAugment,
    B=128) with the attention kernels called through ``torch.library``'s
    dispatcher, as the port calls them, and with their CUDA
    implementations called directly, as before they were operators; in
    turns, windows of ``DISPATCH_STEPS`` steps ending in a host read."""
    t0 = time.perf_counter()
    cfg = flagship_cfg()
    _, x_train, y_train, model, state, train_step, perm = \
        training_setup(cfg, cfg.batch_size * 64)
    modes = {"dispatcher": registry.OPS,
             "direct": types.SimpleNamespace(**registry.CUDA_IMPLS)}
    held = [state, 0]

    def window(mode: str, n: int) -> float:
        registry.OPS = modes[mode]
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                held[0], metrics = train_step(held[0], x_train, y_train,
                                              perm, held[1] % 64)
                held[1] += 1
            metrics["loss"].item()
            return (time.perf_counter() - t) * 1e3 / n
        finally:
            registry.OPS = modes["dispatcher"]

    window("dispatcher", 5)
    window("direct", 5)
    times = {m: [] for m in modes}
    for _ in range(2):
        for mode in ("dispatcher", "direct", "direct", "dispatcher"):
            times[mode].append(window(mode, DISPATCH_STEPS))
    ms = {m: statistics.median(t) for m, t in times.items()}
    print(f"flagship step (README recipe without AutoAugment, B=128): "
          f"{ms['dispatcher']:.3f} ms with the kernels as torch.library "
          f"operators, {ms['direct']:.3f} ms calling their CUDA "
          f"implementations directly (median of 4 windows of "
          f"{DISPATCH_STEPS} steps each; all windows: "
          + ", ".join(f"{m} " + " ".join(f"{x:.3f}" for x in t)
                      for m, t in times.items())
          + f"; {card}); {time.perf_counter() - t0:.1f} s")


def int8_phase(card: str) -> dict:
    """``--quantize int8`` of the serving phase's checkpoint: the artifact's
    bytes against the f32 artifact's, the logits' deviation and top-1
    agreement on ``INT8_IMAGES`` images, 7 launches of the whole-head
    forward a request, and both artifacts' latency at B=1 and B=128."""
    t0 = time.perf_counter()
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    art = export_inference(os.path.join(WORK, "ckpt"),
                           os.path.join(WORK, "art_int8"), quantize="int8",
                           device="cuda")
    f32 = ServingModel(os.path.join(WORK, "art"), device="cuda")
    int8 = ServingModel(art, device="cuda")
    ratio = int8.meta["bytes"] / f32.meta["bytes"]
    print(f"int8 serving.pt2: {int8.meta['bytes']} bytes against the f32 "
          f"artifact's {f32.meta['bytes']} ({ratio:.4f}x, bound "
          f"{INT8_BYTES_RATIO}); {int8.meta['quantized']} int8 tensors; its "
          f"graph calls {graph_ops(art)}")
    if not ratio < INT8_BYTES_RATIO:
        raise AssertionError(f"int8 artifact {ratio:.4f}x the f32 one")
    imgs = np.random.default_rng(8).integers(
        0, 256, (INT8_IMAGES, 32, 32, 3), dtype=np.uint8)
    before = _launch_counts()
    got = int8.predict(imgs)
    per_request = {n: c - before[n] for n, c in _launch_counts().items()}
    want = f32.predict(imgs)
    if per_request != dict({n: 0 for n in KERNEL_WRAPPERS}, mhsa_fwd=7):
        raise AssertionError(f"int8 request launches {per_request}")
    dev = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"int8 against f32 on {INT8_IMAGES} images: max |logit "
          f"deviation| {dev:.4e} (largest f32 logit {scale:.4e}, bound "
          f"{0.05 * scale + 0.05:.4e}), top-1 agreement {agree:.4f} (bound "
          f">= {INT8_MIN_AGREE}); 7 launches of mhsa_fwd a request")
    if not (np.isfinite(got).all() and dev <= 0.05 * scale + 0.05
            and agree >= INT8_MIN_AGREE):
        raise AssertionError("the int8 artifact strays from the f32 one")
    for B in (1, 128):
        x = torch.from_numpy(imgs[:B]).cuda()
        lat = {}
        for name, served in (("f32", f32), ("int8", int8)):
            def forward(served=served):
                with torch.inference_mode():
                    served.infer(x).cpu()

            lat[name] = host_ms(forward, 20)
        print(f"serving latency B={B}: f32 artifact {lat['f32']:.3f} ms, "
              f"int8 artifact {lat['int8']:.3f} ms (in-process forward, "
              f"median of 20; {card})")
    print(f"the int8 phase took {time.perf_counter() - t0:.1f} s")
    return _launch_counts()


def fused_key_tiled_phase(card: str) -> dict:
    """``pallas_kernel="fused"`` past the whole head, where the whole-head
    forward walks K and V in key tiles: ``mhsa_fwd`` and ``mhsa_fwd_lse`` against
    their plain versions at ``KEY_TILED_SHAPES``; the module at T=1025
    (forward and backward against the einsum module), which must launch
    the whole-head kernels and no tiled forward; and the key-tiled mode's
    time beside the tiled kernels' at the pixel shape."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape, dtypes in KEY_TILED_SHAPES:
        B, H, T, D = shape
        scale = 1.0 / math.sqrt(H * D)
        for dtype in dtypes:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            out = fused_attention(q, k, v, scale)
            out_l, lse = fused_attention_lse(q, k, v, scale)
            want, want_lse = fused_attention_lse_reference(q, k, v, scale)
            torch.cuda.synchronize()
            tol = flash_tol("fwd", dtype, want)
            torch.testing.assert_close(out, want, **tol)
            torch.testing.assert_close(out_l, want, **tol)
            torch.testing.assert_close(lse, want_lse,
                                       **KERNEL_TOL[torch.float32])
            print(f"key-tiled whole-head forward {shape} {str(dtype)[6:]}: "
                  f"max_abs_err out {_max_err((out,), (want,)):.3e}, with "
                  f"lse {_max_err((out_l, lse), (want, want_lse)):.3e} "
                  f"(tolerance {tol}, lse {KERNEL_TOL[torch.float32]})")
            del q, k, v, out, out_l, lse, want, want_lse

    # the path: the module with pallas_kernel="fused" at T=1025
    B, T, features, heads = KEY_TILED_MODULE
    weights = torch.Generator().manual_seed(0)
    fused = MultiHeadSelfAttention(features, heads, generator=weights,
                                   pallas_kernel="fused", device="cuda")
    plain = MultiHeadSelfAttention(features, heads,
                                   generator=torch.Generator(),
                                   pallas_kernel="einsum", device="cuda")
    plain.load_state_dict(fused.state_dict())
    x, g = (torch.randn((B, T, features), generator=gen, device="cuda")
            for _ in range(2))
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    xk = x.clone().requires_grad_()
    out = fused(xk)
    out.backward(g)
    with torch.no_grad():
        served = fused(x)
    torch.cuda.synchronize()
    launches = _launch_counts()
    want = dict({n: 0 for n in KERNEL_WRAPPERS}, mhsa_fwd=1, mhsa_fwd_lse=1,
                flash_bwd_dq_tiled=1, flash_bwd_dkv_tiled=1)
    if launches != want:
        raise AssertionError(f"'fused' at T={T}: launches {launches}, "
                             f"expected {want}")
    xp = x.clone().requires_grad_()
    ref = plain(xp)
    ref.backward(g)
    torch.testing.assert_close(out, ref, **GRAD_TOL[torch.float32])
    torch.testing.assert_close(served, ref.detach(),
                               **GRAD_TOL[torch.float32])
    torch.testing.assert_close(xk.grad, xp.grad, **GRAD_TOL[torch.float32])
    for (name, a), b in zip(fused.named_parameters(), plain.parameters()):
        torch.testing.assert_close(a.grad, b.grad, **GRAD_TOL[torch.float32],
                                   msg=name)
    print(f"'fused' module at (B, T, F, heads) {KEY_TILED_MODULE} f32: output "
          f"and grads match the einsum module (tolerance "
          f"{GRAD_TOL[torch.float32]}); launches "
          f"{ {n: c for n, c in launches.items() if c} }, none of flash_fwd "
          "or flash_fwd_lse")

    B, H, T, D = PIXEL_SHAPE
    scale = 1.0 / math.sqrt(H * D)
    q, k, v = (torch.randn(PIXEL_SHAPE, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    for what, whole, tiled in (
            ("fwd_lse", lambda: fused_attention_lse(q, k, v, scale),
             lambda: flash_attention_lse(q, k, v, scale)),
            ("fwd", lambda: fused_attention(q, k, v, scale),
             lambda: flash_attention(q, k, v, scale))):
        ms = in_turns({"key-tiled": whole, "tiled": tiled}, rounds=2,
                      iters=10)
        print(f"key-tiled whole-head {what} {PIXEL_SHAPE} bf16: "
              f"{ms['key-tiled']:.4f} ms, the tiled kernel "
              f"{ms['tiled']:.4f} ms, key-tiled/tiled "
              f"{ms['key-tiled'] / ms['tiled']:.3f} (median of 4 windows "
              f"of 10; {card})")
    print(f"the key-tiled phase took {time.perf_counter() - t0:.1f} s")
    return launches


def analysis_phase(card: str) -> None:
    """The analysis tools on the card: ``load_run_model`` and
    ``run_on_images`` of a README-width f32 checkpoint (random weights from
    its seed), the attention maps and their rollout row-stochastic and
    equal to the same model's on the CPU, ``model_payload``'s quantized
    maps, and a short ``run_study`` of the regenerator on synthetic c10."""
    t0 = time.perf_counter()
    cfg = flagship_cfg(precision="32")
    model, _ = get_model(cfg, generator=torch.Generator().manual_seed(cfg.seed))
    work = os.path.join(WORK, "analysis")
    shutil.rmtree(work, ignore_errors=True)
    ckpt = os.path.join(work, "exp")
    save_checkpoint(ckpt, {"params": model.state_dict()}, cfg)
    del model
    _, _, imgs, logits, inter = load_run_model(ckpt, ANALYSIS_BATCH,
                                               device="cuda")
    maps = collect_attention_maps(inter)
    joint = get_joint_attentions(maps)
    shape = (cfg.num_layers, ANALYSIS_BATCH, cfg.head, 65, 65)
    if maps.shape != shape or not np.isfinite(logits).all():
        raise AssertionError(f"maps {maps.shape}, expected {shape}")
    for what, m in (("maps", maps), ("rollout", joint)):
        np.testing.assert_allclose(m.sum(-1), 1.0, rtol=0, atol=1e-4,
                                   err_msg=what)
    _, _, _, logits_c, inter_c = load_run_model(ckpt, ANALYSIS_BATCH,
                                                device="cpu")
    maps_c = collect_attention_maps(inter_c)
    np.testing.assert_allclose(maps, maps_c, **ANALYSIS_TOL)
    np.testing.assert_allclose(joint, get_joint_attentions(maps_c),
                               **ANALYSIS_TOL)
    _, logits2, inter2 = run_on_images(ckpt, imgs[:2], device="cuda")
    np.testing.assert_allclose(collect_attention_maps(inter2), maps[:, :2],
                               **ANALYSIS_TOL)
    payload = model_payload(ckpt, batch_size=ANALYSIS_BATCH, device="cuda")
    if payload["shape"] != list(shape):
        raise AssertionError(f"payload shape {payload['shape']}")
    print(f"analysis: maps {maps.shape} and rollout row-stochastic, card "
          f"against CPU max |diff| maps {np.abs(maps - maps_c).max():.3e}, "
          f"rollout {np.abs(joint - get_joint_attentions(maps_c)).max():.3e}"
          f", logits {np.abs(logits - logits_c).max():.3e} (maps within "
          f"{ANALYSIS_TOL}); run_on_images and model_payload agree")
    t_study = time.perf_counter()
    history = run_study(epochs=1, batch_size=512, log_interval=50,
                        out_dir=os.path.join(work, "regen"), synthetic=True,
                        verbose=False, device="cuda")
    row = history[-1]
    if not (len(history) == 1 and all(math.isfinite(row[k]) for k in row)):
        raise AssertionError(f"regenerator study {history}")
    print(f"regenerator study, 1 epoch of synthetic c10 at B=512 on the card "
          f"in {time.perf_counter() - t_study:.1f} s: {row}")
    print(f"the analysis phase took {time.perf_counter() - t0:.1f} s ({card})")


PARALLEL_STEPS = 20  # the flagship on the mesh path
PARALLEL_ZOO_STEPS = 5  # lgcnn batch_norm and the MoE ViT
PARALLEL_EVAL = 256  # one eval batch


def write_cifar10(root: str, steps: int, batch: int = 128) -> None:
    """A CIFAR-10 data set in the archive's python layout
    (``cifar-10-batches-py``) of ``steps * batch`` training images and
    ``PARALLEL_EVAL`` test images cut from synthetic c10, so that
    ``train()`` takes exactly ``steps`` steps an epoch."""
    import pickle

    raw = load_dataset("c10", "data", synthetic=True)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    per = steps * batch // 5

    def dump(name, x, y):
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": x.transpose(0, 3, 1, 2).reshape(len(x), -1),
                         b"labels": [int(v) for v in y]}, f)

    for i in range(5):
        sl = slice(i * per, (i + 1) * per)
        dump(f"data_batch_{i + 1}", raw.x_train[sl], raw.y_train[sl])
    dump("test_batch", raw.x_test[:PARALLEL_EVAL], raw.y_test[:PARALLEL_EVAL])


def parallel_run(cfg: Config, name: str, mesh: bool) -> tuple:
    """``train()`` on the card, in a NCCL process group of one rank
    (``mesh``) or in none; returns (ms a step, launches, last payload)."""
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    cfg = cfg.replace(ckpt_dir=os.path.join(WORK, "parallel", "models", name))
    if mesh:
        store = os.path.join(WORK, "parallel", f"store_{name}")
        if os.path.exists(store):
            os.remove(store)
        dist.init_process_group("nccl", store=dist.FileStore(store, 1),
                                rank=0, world_size=1)
    try:
        res = train(cfg, verbose=False)
    finally:
        if mesh:
            dist.destroy_process_group()
    launches = _launch_counts()
    row = res["history"][-1]
    if not (math.isfinite(row["loss"]) and row["skipped_nonfinite"] == 0):
        raise AssertionError(f"{name}: a loss is not finite")
    payload, _ = load_checkpoint(res["ckpt_dir"], prefer="last")
    return row["epoch_time"] * 1e3, launches, payload


def parallel_phase(card: str) -> dict:
    """The mesh path of ``train()`` at world size 1 against the same runs
    without a process group, bit for bit (see the module docstring);
    returns the flagship mesh run's launches."""
    t0 = time.perf_counter()
    shutil.rmtree(os.path.join(WORK, "parallel"), ignore_errors=True)
    runs = (("flagship", PARALLEL_STEPS, flagship_cfg()),
            ("lgcnn_bn", PARALLEL_ZOO_STEPS,
             readme_cfg(model_name="lgcnn", cnn_normalization="batch_norm")),
            ("moe", PARALLEL_ZOO_STEPS, moe_cfg()))
    print(f"parallel phase: NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}"
          f", a process group of one rank; {card}")
    out = {}
    for name, steps, cfg in runs:
        root = os.path.join(WORK, "parallel", f"data_{steps}")
        if not os.path.isdir(root):
            write_cifar10(root, steps)
        cfg = cfg.replace(max_epochs=1, synthetic_data=False, data_dir=root,
                          log_dir=os.path.join(WORK, "parallel", "logs"))
        # in turns: without, with, with, without the group
        got = [(mesh, parallel_run(cfg, f"{name}_{k}", mesh))
               for k, mesh in enumerate((False, True, True, False))]
        plain = [r for mesh, r in got if not mesh]
        on_mesh = [r for mesh, r in got if mesh]
        pairs = [(f"{key}.{k}", a[2][key][k], v)
                 for a in on_mesh for b in plain
                 for key in ("params", "opt_state", "model_state")
                 for k, v in b[2].get(key, {}).items()]
        unequal = sorted({n for n, a, b in pairs if not torch.equal(a, b)})
        launches = [r[1] for _, r in got]
        per_step = {k: cfg.num_layers * steps for k in (
            "mhsa_fwd_lse", "flash_bwd_dq_tiled", "flash_bwd_dkv_tiled")}
        kernels_ok = name == "lgcnn_bn" or all(
            launches[1][k] == v for k, v in per_step.items())
        ms = {mesh: ", ".join(f"{r[0] / steps:.3f}" for r in rs)
              for mesh, rs in ((True, on_mesh), (False, plain))}
        print(f"parallel phase, {name} ({cfg.num_layers} layers, hidden "
              f"{cfg.hidden}, B={cfg.batch_size}, {cfg.precision}), {steps} "
              f"steps through train(), in turns without, with, with and "
              f"without the group: {ms[True]} ms a step on the mesh path, "
              f"{ms[False]} ms without a process group (host clock over the "
              f"epoch, first step included); {len(pairs)} tensor pairs of "
              f"the checkpoints, unequal {unequal}; launches {launches[1]} "
              f"on the mesh path, the same in every run: "
              f"{all(l == launches[0] for l in launches)}")
        if unequal or not pairs or not kernels_ok or any(
                l != launches[0] for l in launches):
            raise AssertionError(f"parallel phase, {name}: the mesh path is "
                                 "not the one-process run")
        out[name] = launches[1]
    print(f"the parallel phase took {time.perf_counter() - t0:.1f} s")
    return out["flagship"]


PIPE_MICROBATCHES = 4  # of 32 images at B=128
PIPE_STEPS = 10  # counted, and timed in turns with the sequential step
SEQ_AXIS = 4  # the flagship's stream padded as a seq axis of 4 pads it


def loss_and_grad(cfg: Config, forward, params, img, label) -> tuple:
    """(loss, flat gradient) of one training forward ``forward(img)``."""
    loss = make_criterion(cfg)(forward(img), label)
    grads = torch.autograd.grad(loss, params)
    return loss.item(), torch.cat([g.reshape(-1) for g in grads])


def check_against(what: str, got: tuple, want: tuple, card: str) -> None:
    """A (loss, flat gradient) pair within the step bounds of another."""
    (loss_g, grad_g), (loss_w, grad_w) = got, want
    rel = ((grad_g - grad_w).norm() / grad_w.norm()).item()
    print(f"{what}: loss {loss_g:.6f} vs {loss_w:.6f} (|diff| "
          f"{abs(loss_g - loss_w):.3e}, bound {STEP_LOSS_ATOL}); gradient "
          f"relative L2 {rel:.3e} (bound {STEP_GRAD_REL_L2}) ({card})")
    if not (abs(loss_g - loss_w) <= STEP_LOSS_ATOL
            and rel <= STEP_GRAD_REL_L2):
        raise AssertionError(f"{what}: out of bounds")


def check_logits(what: str, got: torch.Tensor, want: torch.Tensor,
                 card: str) -> None:
    err = (got.float() - want.float()).abs().max().item()
    print(f"{what}: logits max |diff| {err:.3e} (rtol={LOGIT_TOL['rtol']} "
          f"atol={LOGIT_TOL['atol']}) ({card})")
    torch.testing.assert_close(got.float(), want.float(), **LOGIT_TOL)


def pipe_seq_phase(card: str) -> dict:
    """GPipe's tick loop and sequence parallelism's padded stream on the
    card, at the README flagship's width (7 layers, hidden 384, 12 heads,
    bf16-mixed, B=128).  The card is one H100 and NCCL takes one rank a
    card, so the pipe and seq axes above one rank are CPU gloo tests
    (``tests/test_torch_pipeline*.py``, ``tests/test_torch_sequence.py``);
    here (a) ``pipeline_forward`` at one stage runs M=4 microbatches of 32
    through the tick loop and its backward, a step and an eval batch,
    against the plain (einsum, sequential) model on the same weights and
    batch, with the kernels' launches of ``PIPE_STEPS`` train steps and one
    eval batch counted from zero; and (b) the flagship padded as a seq axis
    of 4 pads it (``seq_pad=3``, ``valid_len=65``) against the unpadded
    model.  Returns the launches of (a)'s steps and eval."""
    t0 = time.perf_counter()
    cfg = flagship_cfg()
    M = PIPE_MICROBATCHES
    raw, x_train, y_train, model, state, train_step, perm = training_setup(
        cfg, n_train=2 * PIPE_STEPS * cfg.batch_size)
    plain = plain_twin(cfg, model)
    img, label, _, _ = train_step.make_batch(state, x_train, y_train, perm, 0)
    params, plain_params = list(model.parameters()), list(plain.parameters())
    print(f"pipe/seq phase: {cfg.num_layers} layers, hidden {cfg.hidden}, "
          f"{cfg.head} heads, {cfg.precision}, B={cfg.batch_size}; {card}")

    # (a) the tick loop at one stage, its step and eval against the plain
    # model (the launches here are the check's, not the path's)
    want = loss_and_grad(cfg, lambda x: plain(x, deterministic=False),
                         plain_params, img, label)
    got = loss_and_grad(cfg, lambda x: pipeline_forward(
        model, None, M, x, deterministic=False), params, img, label)
    check_against(f"tick loop at one stage, M={M} microbatches of "
                  f"{cfg.batch_size // M}, vs the plain model", got, want,
                  card)
    x_eval = normalize(torch.from_numpy(raw.x_test[:cfg.eval_batch_size])
                       .cuda(), cfg.mean, cfg.std).to(torch_dtype(cfg))
    with torch.no_grad():
        plain_logits = plain(x_eval)
        check_logits(f"tick loop eval, B={cfg.eval_batch_size}, M={M}",
                     pipeline_forward(model, None, M, x_eval), plain_logits,
                     card)

    # the path: PIPE_STEPS train steps and one eval batch with the model's
    # forward on the tick loop, every launch counted from zero
    eval_step = make_eval_step(cfg, model)
    e_img = torch.from_numpy(raw.x_test[:cfg.eval_batch_size]).cuda()
    e_label = torch.from_numpy(raw.y_test[:cfg.eval_batch_size]).cuda()
    e_mask = torch.ones(cfg.eval_batch_size, device="cuda")
    model.pipeline = Pipeline(None, M)
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    for i in range(PIPE_STEPS):
        state, metrics = train_step(state, x_train, y_train, perm, i)
    torch.cuda.synchronize()
    step_launches = _launch_counts()
    sums = eval_step(e_img, e_label, e_mask)
    launches = _launch_counts()
    eval_fwd = launches["mhsa_fwd"] - step_launches["mhsa_fwd"]
    want_step = {n: 0 for n in KERNEL_WRAPPERS}
    want_step.update({k: cfg.num_layers * M * PIPE_STEPS for k in (
        "mhsa_fwd_lse", "flash_bwd_dq_tiled", "flash_bwd_dkv_tiled")})
    print(f"tick loop path: {PIPE_STEPS} train steps, launches "
          f"{step_launches} ({cfg.num_layers * M} a step of each training "
          f"kernel expected: {cfg.num_layers} layers x {M} microbatches); "
          f"one eval batch of {cfg.eval_batch_size}: {eval_fwd} launches of "
          f"mhsa_fwd ({cfg.num_layers * M} expected), accuracy "
          f"{float(sums['correct_sum']) / cfg.eval_batch_size:.4f}; last "
          f"loss {float(metrics['loss']):.4f} ({card})")
    if step_launches != want_step or eval_fwd != cfg.num_layers * M:
        raise AssertionError("the tick loop's launches are not 28 a step "
                             "of each training kernel and 28 in eval")
    if not (math.isfinite(float(metrics["loss"]))
            and float(metrics["skipped_nonfinite"]) == 0):
        raise AssertionError("a tick-loop step is not finite")

    # ms a step, the tick loop against the sequential step, in turns
    ms = {"sequential": [], "tick loop": []}
    i = PIPE_STEPS
    for name in ("sequential", "tick loop", "tick loop", "sequential"):
        model.pipeline = Pipeline(None, M) if name == "tick loop" else None
        state, _ = train_step(state, x_train, y_train, perm, i)  # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        for k in range(1, 5):
            state, _ = train_step(state, x_train, y_train, perm, i + k)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t) * 1e3 / 4)
        i = (i + 5) % (2 * PIPE_STEPS)
    model.pipeline = None
    print("train step, in turns (host clock, synchronized, 4 steps each "
          "after one warm step): " + "; ".join(
              f"{k} {', '.join(f'{v:.3f}' for v in vs)} ms"
              for k, vs in ms.items()) + f" ({card})")

    # (b) the padded stream against the unpadded model on the same weights
    padded, _ = get_model(cfg, device="cuda")
    padded.load_state_dict(model.state_dict())
    pad = pad_stream(padded, SEQ_AXIS)
    if pad != 3 or padded.enc0.mixer.valid_len != 65:
        raise AssertionError(f"pad {pad}, valid_len "
                             f"{padded.enc0.mixer.valid_len}")
    with torch.no_grad():
        check_logits(f"padded stream (seq_pad={pad}, valid_len=65) eval",
                     padded(x_eval), model(x_eval), card)
    img, label, _, _ = train_step.make_batch(state, x_train, y_train, perm, 1)
    check_against(f"padded stream (seq_pad={pad}) step vs the unpadded "
                  "model", loss_and_grad(
                      cfg, lambda x: padded(x, deterministic=False),
                      list(padded.parameters()), img, label),
                  loss_and_grad(cfg, lambda x: model(x, deterministic=False),
                                list(model.parameters()), img, label), card)
    print(f"the pipe/seq phase took {time.perf_counter() - t0:.1f} s "
          f"({card})")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs a CUDA card")
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN: f32 references run in full f32")

    t0 = time.perf_counter()
    build_kernels()
    fwd_row, library = kernel_phase(card)
    rows = [fwd_row, *training_kernel_phase(card, library),
            *flash_kernel_phase(card)]
    for row in rows:
        if row["name"] in FORWARD_MAIN_SHAPE:
            row["ptxas"] = forward_ptxas(row["name"])
        elif row["name"] in BACKWARD_ROWS:
            row["ptxas"] = backward_ptxas(row["name"])
        row["instances"] = row_instances(row["name"])
    ragged_edge_phase()
    forward_timing_phase(card)
    tiled_vs_whole_head(card)
    head_dim_timing(card)
    backward_timing_phase(card)
    rows += f32_kernel_phase(card)
    # each path's launches, counted from zero just before it
    train_launches, no_aa_step_ms = training_phase(card)
    dispatch_cost(card)
    paths = [{"mhsa_fwd": serving_phase(card)}, int8_phase(card),
             train_launches, pixel_serving_phase(card),
             pixel_training_phase(card), wide_head_phase(card),
             wide_head_f32_phase(card), fused_key_tiled_phase(card),
             full_recipe_phase(card, no_aa_step_ms),
             f32_training_phase(card)]
    analysis_phase(card)
    # last: the zoo and the NNMF family, which launch none of the
    # attention kernels, and the rest of the zoo, whose MoE ViT does
    zoo_phase(card)
    nnmf_phase(card)
    paths.append(rest_phase(card)["moe"]["launches"])
    paths.append(parallel_phase(card))
    paths.append(pipe_seq_phase(card))
    for row in rows:
        row["launches"] = sum(p.get(row["name"], 0) for p in paths)
        if row["launches"] < 1:
            raise AssertionError(f"the main path never launched {row['name']}")
    print("kernels a step (torch.profiler): " + ", ".join(
        f"{path} " + ("not measured" if n is None else f"{n:.1f}")
        for path, n in STEP_KERNELS.items()))
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} "
          "s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
