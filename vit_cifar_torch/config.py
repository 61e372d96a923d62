"""Typed configuration, field for field the JAX package's ``Config``.

The port keeps its own copy so that it imports nothing of the JAX package
and runs where jax is not installed.  Every field has the JAX
package's name, default and meaning, and ``to_json``/``from_json`` read and
write the same JSON, so a checkpoint's ``config.json`` moves between the two
packages unchanged; ``tests/test_torch_vit.py`` holds the two dataclasses
field for field.  The TPU-only knobs stay as fields so that a config round
trips; the port reads only the ones its modules use.
"""

from __future__ import annotations

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
