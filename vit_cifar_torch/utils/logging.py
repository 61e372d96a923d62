"""Experiment naming and metric logging, as ``vit_cifar_tpu/utils/logging.py``
(the port's own copy).

Reference: the Comet-or-CSV logger choice (main.py:201-211), experiment
naming (utils.py:525-548) and tags (utils.py:550-556).  ``CSVLogger`` writes
``{log_dir}/{experiment}/metrics.csv`` as Lightning's CSVLogger does;
``CometLogger`` is taken only with a Comet API key, imports ``comet_ml``
only then, and logs to CSV alone where it is not installed.
"""

from __future__ import annotations

import csv
import os
import random
import string
import time
from datetime import datetime
from typing import Any


def random_string(n: int) -> str:
    return "".join(random.choice(string.ascii_lowercase) for _ in range(n))


def get_experiment_name(cfg) -> str:
    """utils.py:525-548, flag for flag."""
    name = f"{cfg.model_name}_{cfg.dataset}_{cfg.num_layers}l"
    if not cfg.query:
        name += "_nq"
    if not cfg.use_encoder_mlp:
        name += "_nem"
    if cfg.autoaugment:
        name += "_aa"
    if cfg.label_smoothing:
        name += "_ls"
    if cfg.rcpaste:
        name += "_rc"
    if cfg.cutmix:
        name += "_cm"
    if cfg.mixup:
        name += "_mu"
    if not cfg.is_cls_token:
        name += "_gap"
    name += f"_{random_string(5)}_{datetime.now().strftime('%Y%m%d%H%M%S')}"
    return name


def get_experiment_tags(cfg) -> list[str]:
    """utils.py:550-556."""
    tags = [cfg.model_name]
    if not cfg.query:
        tags.append("no-query")
    if not cfg.use_encoder_mlp:
        tags.append("no-encoder-mlp")
    return tags


class CSVLogger:
    """Append-only metrics.csv whose columns grow with the metrics logged."""

    def __init__(self, log_dir: str, experiment: str):
        self.dir = os.path.join(log_dir, experiment)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.csv")
        self._rows: list[dict[str, Any]] = []
        self._fields: list[str] = ["step", "epoch", "time"]
        self._t0 = time.time()

    def log(self, step: int, epoch: int, **metrics):
        row = {"step": step, "epoch": epoch,
               "time": round(time.time() - self._t0, 2)}
        for k, v in metrics.items():
            row[k] = float(v) if hasattr(v, "__float__") else v
            if k not in self._fields:
                self._fields.append(k)
        self._rows.append(row)

    def log_text(self, name: str, text: str):
        with open(os.path.join(self.dir, name), "w") as f:
            f.write(text)

    def flush(self):
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields)
            w.writeheader()
            w.writerows(self._rows)

    def finalize(self):
        self.flush()


class CometLogger(CSVLogger):
    """Comet.ml logging beside the CSV file (main.py:201-211)."""

    def __init__(self, log_dir: str, experiment: str, api_key: str,
                 project: str, tags=()):
        super().__init__(log_dir, experiment)
        self.comet = None
        try:
            import comet_ml  # type: ignore

            self.comet = comet_ml.Experiment(
                api_key=api_key, project_name=project,
                display_summary_level=0)
            self.comet.set_name(experiment)
            for t in tags:
                self.comet.add_tag(t)
        except Exception as e:  # comet_ml absent or refusing the key
            print(f"[vit_cifar_torch] comet unavailable ({e}); logging to "
                  "CSV only")

    def log(self, step: int, epoch: int, **metrics):
        super().log(step, epoch, **metrics)
        if self.comet is not None:
            self.comet.log_metrics(
                {k: float(v) for k, v in metrics.items()
                 if hasattr(v, "__float__")}, step=step, epoch=epoch)

    def log_histogram(self, name: str, values, step: int):
        if self.comet is not None:
            self.comet.log_histogram_3d(values, name=name, step=step)

    def finalize(self):
        super().finalize()
        if self.comet is not None:
            self.comet.end()


def make_logger(cfg, experiment: str):
    if cfg.comet_api_key:
        return CometLogger(cfg.log_dir, experiment, cfg.comet_api_key,
                           cfg.project_name, tags=get_experiment_tags(cfg))
    return CSVLogger(cfg.log_dir, experiment)
