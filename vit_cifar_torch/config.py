"""Typed configuration, field for field the JAX package's ``Config``.

The port keeps its own copy so that it imports nothing of the JAX package
and runs where jax is not installed.  Every field has the JAX
package's name, default and meaning, and ``to_json``/``from_json`` read and
write the same JSON, so a checkpoint's ``config.json`` moves between the two
packages unchanged; ``tests/test_torch_vit.py`` holds the two dataclasses
field for field.  The TPU-only knobs stay as fields so that a config round
trips; the port reads only the ones its modules use.

``build_parser`` and ``config_from_args`` are the JAX package's CLI surface,
flag for flag (reference main.py:12-167); ``tests/test_torch_loop.py`` holds
the two parsers to the same Config for every option.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from typing import Any

import torch

# Dataset constants (reference: utils.py:445-503).
DATASET_INFO: dict[str, dict[str, Any]] = {
    "c10": {"num_classes": 10, "in_c": 3, "size": 32, "padding": 4,
            "mean": (0.4914, 0.4822, 0.4465),
            "std": (0.2470, 0.2435, 0.2616)},
    "c100": {"num_classes": 100, "in_c": 3, "size": 32, "padding": 4,
             "mean": (0.5071, 0.4867, 0.4408),
             "std": (0.2675, 0.2565, 0.2761)},
    "svhn": {"num_classes": 10, "in_c": 3, "size": 32, "padding": 4,
             "mean": (0.4377, 0.4438, 0.4728),
             "std": (0.1980, 0.2010, 0.1970)},
}

MODEL_NAMES = (
    "vit", "aftfull", "aftsimple", "hamburger", "hamburger_attention",
    "gnnmf_ham", "gnnmf_sbs", "gnnmf_sbsed", "gmlp", "wgmlp", "lgcnn",
    "wlgcnn", "ae", "ae_baseline", "linear", "cnn_baseline",
)


@dataclass(frozen=True)
class Config:
    """One typed config object; see ``vit_cifar_tpu/config.py`` for what
    each field does in the JAX package."""

    # -- dataset / loader
    dataset: str = "c10"
    model_name: str = "ae"
    semi_supervised: bool = False
    patch: int = 8  # patches per row/col
    batch_size: int = 128
    eval_batch_size: int = 256
    shuffle: bool = True
    download_data: bool = False
    data_dir: str = "data"
    synthetic_data: bool = False

    # -- optimizer / schedule
    optimizer: str = "adam"
    lr: float = 1e-3
    lr_nnmf: float = 1e-2
    min_lr: float = 1e-5
    beta1: float = 0.9
    beta2: float = 0.999
    max_epochs: int = 100
    weight_decay: float = 5e-5
    warmup_epoch: int = 5
    precision: str = "bf16-mixed"  # bf16-mixed | 32
    matmul_precision: str = "medium"

    # -- criterion / augmentation
    criterion: str = "ce"
    label_smoothing: bool = False
    smoothing: float = 0.1
    autoaugment: bool = False
    rcpaste: bool = False
    cutmix: bool = False
    mixup: bool = False

    # -- architecture
    dropout: float = 0.0
    head: int = 12
    num_layers: int = 1
    hidden: int = 384
    ffn_features: int = 384 * 2
    mlp_hidden: int = 384
    use_encoder_mlp: bool = True
    kernel_size: int = 1
    is_cls_token: bool = True
    pos_emb: bool = True
    query: bool = True
    factorize: bool = False
    factorization_dimension: int = 32
    cnn_normalization: str = "layer_norm"

    # -- hamburger / matrix decomposition
    burger_mode: str = "V1"
    depthwise: bool = False
    md_iter: int = 7
    train_md_bases: bool = False

    # -- NNMF
    local_learning: bool = False
    use_nnmf_layers: bool = False
    nnmf_local_learning: bool = False
    nnmf_scale_grade: bool = False
    nnmf_learning_rate_threshold_w: float = 1e-3

    # -- autoencoder attention
    unsupervised_steps: int = 0
    mask_type: str = "zeros"
    chunk: bool = False
    legacy_heads: bool = False
    ae_type: str = "simple"
    ae_hidden_features: int = 128
    ae_hidden_seq_len: int = 8
    order_2d: str = "sfsf"
    AE_transpose: bool = False
    aece_l1_regularization: float = 0.0
    aece_l1_outputs: bool = False

    # -- run control / logging
    dry_run: bool = False
    benchmark: bool = True
    seed: int = 2045
    project_name: str = "Rethinking-Transformers"
    tags: str = ""
    log_gradients: bool = False
    log_gradients_interval: int = 250
    log_weights: bool = True
    model_summary_depth: int = -1
    comet_api_key: str = ""
    log_dir: str = "logs"
    ckpt_dir: str = "models"
    save_attn_map: bool = False
    profile_dir: str = ""
    resume: str = ""

    # -- knobs of the JAX package (kept so that configs round trip)
    mesh_shape: tuple[int, ...] = ()
    mesh_axes: tuple[str, ...] = ("data",)
    pipeline_microbatches: int = 0
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    multihost: bool = False
    ss_combined_epoch: bool = True
    donate_buffers: bool = True
    remat: bool = False
    use_pallas: bool = False
    # '' routes the 'vit' attention through the port's kernel; 'einsum'
    # forces the plain path; 'fused' is the kernel by name
    pallas_kernel: str = ""
    preaugment_epoch: bool = False
    nonfinite_guard: bool = True
    device_data: bool = True
    compile_cache_dir: str = "~/.cache/vit_cifar_tpu/xla"
    ae_mask_chunk: int = 16
    flat_optimizer: bool = True

    @property
    def num_classes(self) -> int:
        return DATASET_INFO[self.dataset]["num_classes"]

    @property
    def in_c(self) -> int:
        return DATASET_INFO[self.dataset]["in_c"]

    @property
    def img_size(self) -> int:
        return DATASET_INFO[self.dataset]["size"]

    @property
    def padding(self) -> int:
        return DATASET_INFO[self.dataset]["padding"]

    @property
    def mean(self) -> tuple[float, ...]:
        return DATASET_INFO[self.dataset]["mean"]

    @property
    def std(self) -> tuple[float, ...]:
        return DATASET_INFO[self.dataset]["std"]

    @property
    def seq_len(self) -> int:
        # main.py:184
        return self.patch**2 + 1 if self.is_cls_token else self.patch**2

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        names = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in names}
        for k in ("mesh_shape", "mesh_axes"):
            if k in d and isinstance(d[k], list):
                d[k] = tuple(d[k])
        return cls(**d)


def torch_dtype(cfg: Config) -> torch.dtype:
    """The compute dtype: bf16 activations under ``bf16*`` precision, else
    f32.  Parameters stay f32 either way."""
    return torch.bfloat16 if cfg.precision.startswith("bf16") else torch.float32


def _add_bool_flag(p: argparse.ArgumentParser, name: str, default: bool):
    p.add_argument(f"--{name}", action="store_true",
                   dest=name.replace("-", "_"), default=default)


def build_parser() -> argparse.ArgumentParser:
    """The CLI, with the JAX package's flags and defaults."""
    p = argparse.ArgumentParser(
        description="ViT-CIFAR on one CUDA card (the PyTorch port)")
    d = Config()

    p.add_argument("--comet-api-key", default=d.comet_api_key,
                   dest="comet_api_key")
    p.add_argument("--dataset", default=d.dataset, choices=list(DATASET_INFO))
    p.add_argument("--model-name", default=d.model_name,
                   choices=list(MODEL_NAMES))
    _add_bool_flag(p, "semi-supervised", d.semi_supervised)
    p.add_argument("--patch", default=d.patch, type=int)
    p.add_argument("--batch-size", default=d.batch_size, type=int)
    p.add_argument("--eval-batch-size", default=d.eval_batch_size, type=int)
    p.add_argument("--optimizer", default=d.optimizer,
                   choices=["adam", "sgd", "madam"])
    p.add_argument("--lr", default=d.lr, type=float)
    p.add_argument("--lr-nnmf", default=d.lr_nnmf, type=float)
    p.add_argument("--min-lr", default=d.min_lr, type=float)
    p.add_argument("--beta1", default=d.beta1, type=float)
    p.add_argument("--beta2", default=d.beta2, type=float)
    p.add_argument("--off-benchmark", action="store_false", dest="benchmark",
                   default=True)
    p.add_argument("--max-epochs", default=d.max_epochs, type=int)
    _add_bool_flag(p, "dry-run", d.dry_run)
    p.add_argument("--weight-decay", default=d.weight_decay, type=float)
    p.add_argument("--warmup-epoch", default=d.warmup_epoch, type=int)
    p.add_argument("--precision", default=d.precision, type=str)
    _add_bool_flag(p, "autoaugment", d.autoaugment)
    p.add_argument("--criterion", default=d.criterion, choices=["ce", "aece"])
    _add_bool_flag(p, "label-smoothing", d.label_smoothing)
    p.add_argument("--smoothing", default=d.smoothing, type=float)
    _add_bool_flag(p, "rcpaste", d.rcpaste)
    _add_bool_flag(p, "cutmix", d.cutmix)
    _add_bool_flag(p, "mixup", d.mixup)
    _add_bool_flag(p, "depthwise", d.depthwise)
    p.add_argument("--md-iter", default=d.md_iter, type=int)
    _add_bool_flag(p, "train-md-bases", d.train_md_bases)
    _add_bool_flag(p, "local-learning", d.local_learning)
    p.add_argument("--dropout", default=d.dropout, type=float)
    p.add_argument("--head", default=d.head, type=int)
    p.add_argument("--num-layers", default=d.num_layers, type=int)
    p.add_argument("--hidden", default=d.hidden, type=int)
    p.add_argument("--ffn-features", default=d.ffn_features, type=int)
    p.add_argument("--mlp-hidden", default=d.mlp_hidden, type=int)
    p.add_argument("--no-encoder-mlp", action="store_false",
                   dest="use_encoder_mlp", default=True)
    p.add_argument("--kernel-size", default=d.kernel_size, type=int)
    p.add_argument("--unsupervised-steps", default=d.unsupervised_steps,
                   type=int)
    p.add_argument("--mask-type", default=d.mask_type,
                   choices=["zeros", "random"])
    _add_bool_flag(p, "use-nnmf-layers", d.use_nnmf_layers)
    _add_bool_flag(p, "nnmf-local-learning", d.nnmf_local_learning)
    _add_bool_flag(p, "nnmf-scale-grade", d.nnmf_scale_grade)
    _add_bool_flag(p, "chunk", d.chunk)
    _add_bool_flag(p, "legacy-heads", d.legacy_heads)
    p.add_argument("--ae-type", default=d.ae_type,
                   choices=["simple", "transpose", "heads", "2d"])
    p.add_argument("--ae-hidden-features", default=d.ae_hidden_features,
                   type=int)
    p.add_argument("--ae-hidden-seq-len", default=d.ae_hidden_seq_len,
                   type=int)
    p.add_argument("--order-2d", default=d.order_2d, choices=["sfsf", "sffs"],
                   dest="order_2d")
    p.add_argument("--ae-transpose", action="store_true", dest="AE_transpose",
                   default=False)
    p.add_argument("--cnn-normalization", default=d.cnn_normalization,
                   type=str)
    _add_bool_flag(p, "factorize", d.factorize)
    p.add_argument("--no-query", action="store_false", dest="query",
                   default=True)
    p.add_argument("--no-pos-emb", action="store_false", dest="pos_emb",
                   default=True)
    p.add_argument("--burger-mode", default=d.burger_mode,
                   choices=["V1", "V2", "V2+", "Gated"])
    p.add_argument("--factorization-dimension",
                   default=d.factorization_dimension, type=int)
    p.add_argument("--off-cls-token", action="store_false",
                   dest="is_cls_token", default=True)
    p.add_argument("--matmul-precision", default=d.matmul_precision,
                   choices=["medium", "high", "highest"])
    _add_bool_flag(p, "log-gradients", d.log_gradients)
    p.add_argument("--log-gradients-interval",
                   default=d.log_gradients_interval, type=int)
    p.add_argument("--no-log-weights", action="store_false",
                   dest="log_weights", default=True)
    p.add_argument("--model-summary-depth", default=d.model_summary_depth,
                   type=int)
    p.add_argument("--tags", default=d.tags, type=str)
    p.add_argument("--seed", default=d.seed, type=int)
    p.add_argument("--project-name", default=d.project_name, type=str)
    p.add_argument("--nnmf_learning_rate_threshold_w",
                   default=d.nnmf_learning_rate_threshold_w, type=float)
    p.add_argument("--aece_l1_regularization",
                   default=d.aece_l1_regularization, type=float)
    _add_bool_flag(p, "aece_l1_outputs", d.aece_l1_outputs)
    p.add_argument("--no-pin-memory", action="store_false", dest="pin_memory",
                   default=True)
    p.add_argument("--no-shuffle", action="store_false", dest="shuffle",
                   default=True)
    p.add_argument("--allow-download", action="store_true",
                   dest="download_data", default=False)

    # the JAX package's own flags
    p.add_argument("--resume", default=d.resume, type=str,
                   help="checkpoint dir to resume training from")
    p.add_argument("--profile-dir", default=d.profile_dir, type=str)
    p.add_argument("--data-dir", default=d.data_dir, type=str)
    _add_bool_flag(p, "synthetic-data", d.synthetic_data)
    p.add_argument("--mesh-shape", default="", type=str,
                   help="comma ints, e.g. '8' or '4,2'")
    p.add_argument("--mesh-axes", default=",".join(d.mesh_axes), type=str)
    p.add_argument("--pipeline-microbatches",
                   default=d.pipeline_microbatches, type=int,
                   help="GPipe microbatches when the mesh has a 'pipe' axis; "
                        "0 = one per stage")
    p.add_argument("--moe-experts", default=d.moe_experts, type=int,
                   help="replace the encoder MLP with this many Switch-"
                        "routed experts (0 = dense reference MLP)")
    p.add_argument("--moe-capacity-factor", default=d.moe_capacity_factor,
                   type=float)
    p.add_argument("--moe-aux-weight", default=d.moe_aux_weight, type=float)
    _add_bool_flag(p, "multihost", d.multihost)
    p.add_argument("--no-ss-combined-epoch", action="store_false",
                   dest="ss_combined_epoch", default=True)
    p.add_argument("--no-donate", action="store_false", dest="donate_buffers",
                   default=True)
    _add_bool_flag(p, "remat", d.remat)
    _add_bool_flag(p, "use-pallas", d.use_pallas)
    p.add_argument("--pallas-kernel", default=d.pallas_kernel,
                   choices=["", "einsum", "fused", "flash"],
                   help="force an attention path ('' = the port's route)")
    p.add_argument("--no-device-data", action="store_false",
                   dest="device_data", default=True)
    p.add_argument("--ae-mask-chunk", default=d.ae_mask_chunk, type=int,
                   help="AEAttentionHeads masked-row chunk size "
                        "(0 = materialize)")
    p.add_argument("--compile-cache-dir", default=d.compile_cache_dir,
                   type=str, help="accepted and ignored by the port")
    p.add_argument("--no-flat-optimizer", action="store_false",
                   dest="flat_optimizer", default=True)
    _add_bool_flag(p, "preaugment-epoch", d.preaugment_epoch)
    p.add_argument("--log-dir", default=d.log_dir, type=str)
    p.add_argument("--ckpt-dir", default=d.ckpt_dir, type=str)
    return p


def config_from_namespace(ns: argparse.Namespace) -> Config:
    """The Config of parsed arguments; names that are no Config field (the
    host loader's ``pin_memory``, a caller's own flags) are dropped."""
    d = vars(ns).copy()
    d["mesh_shape"] = tuple(int(x) for x in d["mesh_shape"].split(",") if x)
    d["mesh_axes"] = tuple(x for x in d["mesh_axes"].split(",") if x)
    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in d.items() if k in names})


def config_from_args(argv: list[str] | None = None) -> Config:
    return config_from_namespace(build_parser().parse_args(argv))
