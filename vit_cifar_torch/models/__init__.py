"""Model factory: ``get_model(cfg) -> (model, can_learn_unsupervised)``, as
``vit_cifar_tpu/models/__init__.py``: one ViT trunk and a registry of token
mixers, plus the two CNN models (``models/cnn.py``).

Every name of ``MODEL_NAMES`` builds: ``vit``, ``ae`` (``AEAttention``, or
``AEAttentionHeads`` for ``ae_type="heads"`` without ``--legacy-heads``;
with or without ``--use-nnmf-layers``), ``ae_baseline``, ``aftfull``,
``aftsimple``, ``gmlp``, ``wgmlp``, ``linear``, the gated-NNMF models
``gnnmf_ham``, ``gnnmf_sbs`` and ``gnnmf_sbsed``, ``hamburger``,
``hamburger_attention``, ``lgcnn``, ``wlgcnn`` and ``cnn_baseline``; and
``--moe-experts`` swaps the ViT trunk's encoder MLP for the MoE MLP.  The
JAX factory's deviations from reference bugs are kept: AFT's head is pinned
to 1 (the reference crashes for head > 1, layers.py:128), AFT-Simple's gate
is always on (layers.py:233), and ``ae_baseline`` and ``cnn_baseline`` are
the working equivalents of the reference's crashing models.  The hamburger
models take persistent EMA bases under ``--train-md-bases`` (``rand_init =
not train_md_bases``), as ``gnnmf_ham`` does.
"""

from __future__ import annotations

import functools

import torch

from ..config import MODEL_NAMES, Config, torch_dtype
from ..ops.ae_attention import (AEAttention, AEAttentionHeads,
                                BaselineAEAttention)
from ..ops.aft import AFT
from ..ops.attention import MultiHeadSelfAttention
from ..ops.autoencoders import NNMFParams
from ..ops.gated_nnmf import GatedNNMF
from ..ops.gmlp import GatedMLP, LinearAttention, WeightGatedMLP
from ..ops.hamburger import Hamburger, HamburgerAttention
from ..ops.moe import MoEMLP
from .cnn import BaselineCNN, LocalGlobalCNN
from .vit import ViT

CNN_MODELS = ("cnn_baseline", "lgcnn", "wlgcnn")
AFT_MODES = {"aftfull": "full", "aftsimple": "simple"}


def nnmf_params_from_cfg(cfg: Config) -> NNMFParams:
    """The reference's ``_nnmf_params`` dict (network.py:19-33)."""
    return NNMFParams(
        number_of_iterations=cfg.md_iter, w_trainable=cfg.train_md_bases,
        local_learning=cfg.nnmf_local_learning,
        disable_scale_grade=not cfg.nnmf_scale_grade)


def _make_mixer(cfg: Config, dtype: torch.dtype, generator, device):
    """The mixer factory of ``cfg.model_name``, with the factory arguments
    of the JAX package's ``_make_mixer``."""
    name, h = cfg.model_name, cfg.hidden
    common = dict(generator=generator, dtype=dtype, device=device)
    if name == "vit":
        return functools.partial(
            MultiHeadSelfAttention, h, cfg.head, cfg.dropout,
            save_attn_map=cfg.save_attn_map,
            pallas_kernel=cfg.pallas_kernel or None, **common)
    if name in AFT_MODES:
        return functools.partial(
            AFT, h, cfg.seq_len, mode=AFT_MODES[name],
            factorize=cfg.factorize,
            factorization_dimension=cfg.factorization_dimension,
            head=1,  # pinned: the reference's AFT crashes for head > 1
            dropout=cfg.dropout,
            # the encoder never forwards --no-query to AFTSimple
            query=cfg.query if name == "aftfull" else True, **common)
    if name in ("hamburger", "hamburger_attention"):
        # the reference wrapper passes only version/in_c/depthwise
        # (layers.py:243-258): the MD steps stay at the burger's 6/7
        burger = dict(burger_mode=cfg.burger_mode, depthwise=cfg.depthwise,
                      rand_init=not cfg.train_md_bases, **common)
        if name == "hamburger":
            return functools.partial(Hamburger, cfg.seq_len, h, **burger)
        return functools.partial(HamburgerAttention, cfg.seq_len, h,
                                 dropout=cfg.dropout, query=cfg.query,
                                 **burger)
    gated = {"gmlp": GatedMLP, "wgmlp": WeightGatedMLP,
             "linear": LinearAttention}
    if name in gated:
        return functools.partial(gated[name], h, cfg.ffn_features,
                                 cfg.seq_len, **common)
    if name.startswith("gnnmf"):
        return functools.partial(
            GatedNNMF, h, cfg.ffn_features, cfg.seq_len,
            nnmf_type=name.split("_")[1],  # utils.py:150
            md_iter=cfg.md_iter, depthwise=cfg.depthwise,
            train_bases=cfg.train_md_bases,
            local_learning=cfg.local_learning, **common)
    nnmf = dict(use_nnmf_layers=cfg.use_nnmf_layers,
                nnmf_params=nnmf_params_from_cfg(cfg))
    if name == "ae":
        if cfg.ae_type == "heads" and not cfg.legacy_heads:
            return functools.partial(
                AEAttentionHeads, h, cfg.seq_len, cfg.ffn_features,
                heads=cfg.head, ae_hidden_seq_len=cfg.ae_hidden_seq_len,
                mask_type=cfg.mask_type, chunk=cfg.chunk,
                save_attn_map=cfg.save_attn_map,
                mask_chunk=cfg.ae_mask_chunk, **nnmf, **common)
        return functools.partial(
            AEAttention, h, cfg.seq_len, cfg.ffn_features, head=cfg.head,
            ae_type=cfg.ae_type, ae_hidden_features=cfg.ae_hidden_features,
            ae_hidden_seq_len=cfg.ae_hidden_seq_len, order_2d=cfg.order_2d,
            mask_type=cfg.mask_type, chunk=cfg.chunk,
            legacy_heads=cfg.legacy_heads,
            save_attn_map=cfg.save_attn_map, **nnmf, **common)
    if name == "ae_baseline":
        return functools.partial(
            BaselineAEAttention, h, cfg.seq_len, cfg.ffn_features,
            ae_hidden_features=cfg.ae_hidden_features,
            save_attn_map=cfg.save_attn_map, **common)
    raise NotImplementedError(f"{name} is not implemented yet...")


def get_model(cfg: Config, *, device="cuda",
              generator: torch.Generator | None = None):
    """Build the model of ``cfg`` on ``device`` (default the CUDA card;
    pass ``device="cpu"`` for the CPU).  Without a card the default raises.

    Weights are drawn from ``generator`` (default: a CPU generator seeded
    with ``cfg.seed``), always on the CPU, so a seed gives one set of weights
    on every device.
    """
    name = cfg.model_name
    if name not in MODEL_NAMES:
        raise NotImplementedError(f"{name} is not implemented yet...")
    if cfg.moe_experts > 0 and name in CNN_MODELS:
        raise ValueError(
            "--moe-experts replaces the ViT-trunk encoder MLP (ops/moe.py); "
            f"CNN model {name!r} has no encoder MLP to replace.")
    if cfg.moe_experts > 0 and not cfg.use_encoder_mlp:
        raise ValueError(
            "--moe-experts requires the encoder MLP; it is disabled "
            "(use_encoder_mlp=False).")
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    dtype = torch_dtype(cfg)
    common = dict(generator=generator, dtype=dtype, device=device)
    if name == "cnn_baseline":
        return BaselineCNN(cfg.num_classes, img_size=cfg.img_size,
                           in_c=cfg.in_c, **common), False
    if name in ("lgcnn", "wlgcnn"):
        return LocalGlobalCNN(
            weight_gated=name == "wlgcnn", num_layers=cfg.num_layers,
            num_classes=cfg.num_classes,
            n_channels=cfg.hidden,  # utils.py:220: the ViT hidden
            hidden_features=cfg.ffn_features, img_size=cfg.img_size,
            patch=cfg.patch, kernel_size=cfg.kernel_size,
            use_cls_token=cfg.is_cls_token, mlp_hidden=cfg.mlp_hidden,
            dropout=cfg.dropout, normalization=cfg.cnn_normalization,
            use_mlp=cfg.use_encoder_mlp, in_c=cfg.in_c, **common), False
    mlp_factory = None
    if cfg.moe_experts > 0:
        mlp_factory = functools.partial(
            MoEMLP, cfg.hidden, cfg.mlp_hidden, cfg.moe_experts,
            cfg.moe_capacity_factor, cfg.dropout, **common)
    model = ViT(
        _make_mixer(cfg, dtype, generator, device),
        num_classes=cfg.num_classes, img_size=cfg.img_size,
        patch=cfg.patch, num_layers=cfg.num_layers, hidden=cfg.hidden,
        mlp_hidden=cfg.mlp_hidden, dropout=cfg.dropout,
        use_encoder_mlp=cfg.use_encoder_mlp, is_cls_token=cfg.is_cls_token,
        in_c=cfg.in_c,
        # the plain ViT has no pos_emb flag (reference vit.py:19-48); every
        # other transformer model takes it
        pos_emb=True if name == "vit" else cfg.pos_emb,
        remat=cfg.remat, mlp_factory=mlp_factory, **common)
    # only the AEViT can learn unsupervised (reference utils.py:279)
    return model, name == "ae"
