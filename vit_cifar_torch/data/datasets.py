"""Dataset loading, as ``vit_cifar_tpu/data/datasets.py`` (numpy only).

The whole dataset is one uint8 (N, H, W, C) array that the training code
moves to the device once; every augmentation runs in the train step.  Real
data is read from the torchvision on-disk layouts under ``data_dir``
(``cifar-10-batches-py/``, ``cifar-100-python/``, ``train_32x32.mat`` and
``test_32x32.mat``); nothing is downloaded.  Where the archives are absent,
or with ``synthetic=True``, the loader returns the deterministic
class-structured synthetic data of the JAX package, array for array the same.
Unlike the JAX package it keeps no on-disk cache of the synthetic arrays.
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple

import numpy as np

_SIZES = {
    "c10": (50_000, 10_000, 10),
    "c100": (50_000, 10_000, 100),
    "svhn": (73_257, 26_032, 10),
}


class RawData(NamedTuple):
    x_train: np.ndarray  # (N, H, W, C) uint8
    y_train: np.ndarray  # (N,) int32
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int
    synthetic: bool = False


def _synthetic(dataset: str) -> RawData:
    """Deterministic, class-structured synthetic data (same shapes as
    real): a low-frequency template per class plus N(0, 40) noise."""
    n_train, n_test, n_classes = _SIZES[dataset]
    rng = np.random.default_rng({"c10": 10, "c100": 100, "svhn": 3}[dataset])
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 31.0
    templates = np.stack([
        127.5
        + 80 * np.sin(2 * np.pi * ((c % 7 + 1) * xx + (c // 7) * yy))[..., None]
        * np.array([1.0, (c % 3) - 1.0, 1.0 - (c % 2) * 2])
        for c in range(n_classes)
    ]).astype(np.float32)  # (C, 32, 32, 3)

    def make(n, seed_rng):
        y = np.tile(np.arange(n_classes, dtype=np.int32),
                    -(-n // n_classes))[:n]
        x = np.empty((n, 32, 32, 3), np.uint8)
        chunk = 8192  # in f32 chunks, as the JAX package draws them
        for i in range(0, n, chunk):
            j = min(n, i + chunk)
            noise = seed_rng.standard_normal((j - i, 32, 32, 3),
                                             dtype=np.float32)
            noise *= 40.0
            noise += templates[y[i:j]]
            np.clip(noise, 0, 255, out=noise)
            x[i:j] = noise.astype(np.uint8)
        return x, y

    x_train, y_train = make(n_train, rng)
    x_test, y_test = make(n_test, rng)
    return RawData(x_train, y_train, x_test, y_test, n_classes, synthetic=True)


def _load_cifar10(root: str) -> RawData | None:
    d = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(d):
        return None
    xs, ys = [], []
    for i in range(1, 6):
        with open(os.path.join(d, f"data_batch_{i}"), "rb") as f:
            b = pickle.load(f, encoding="bytes")
        xs.append(b[b"data"])
        ys.extend(b[b"labels"])
    with open(os.path.join(d, "test_batch"), "rb") as f:
        b = pickle.load(f, encoding="bytes")
    x_train = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    x_test = b[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return RawData(
        np.ascontiguousarray(x_train), np.asarray(ys, np.int32),
        np.ascontiguousarray(x_test), np.asarray(b[b"labels"], np.int32), 10)


def _load_cifar100(root: str) -> RawData | None:
    d = os.path.join(root, "cifar-100-python")
    if not os.path.isdir(d):
        return None
    out = []
    for name in ("train", "test"):
        with open(os.path.join(d, name), "rb") as f:
            b = pickle.load(f, encoding="bytes")
        x = b[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        out.append((np.ascontiguousarray(x),
                    np.asarray(b[b"fine_labels"], np.int32)))
    (xtr, ytr), (xte, yte) = out
    return RawData(xtr, ytr, xte, yte, 100)


def _load_svhn(root: str) -> RawData | None:
    tr = os.path.join(root, "train_32x32.mat")
    te = os.path.join(root, "test_32x32.mat")
    if not (os.path.exists(tr) and os.path.exists(te)):
        return None
    from scipy.io import loadmat

    out = []
    for p in (tr, te):
        m = loadmat(p)
        x = np.ascontiguousarray(m["X"].transpose(3, 0, 1, 2))  # HWCN -> NHWC
        y = m["y"].reshape(-1).astype(np.int32) % 10  # torchvision: 10 -> 0
        out.append((x, y))
    (xtr, ytr), (xte, yte) = out
    return RawData(xtr, ytr, xte, yte, 10)


def load_dataset(dataset: str, data_dir: str = "data",
                 synthetic: bool = False) -> RawData:
    if dataset not in _SIZES:
        raise NotImplementedError(f"dataset {dataset!r}")
    if not synthetic:
        loader = {"c10": _load_cifar10, "c100": _load_cifar100,
                  "svhn": _load_svhn}
        raw = loader[dataset](data_dir)
        if raw is not None:
            return raw
        print(f"[vit_cifar_torch] {dataset} archives not found under "
              f"{data_dir!r} -- using deterministic synthetic data with "
              "identical shapes.")
    return _synthetic(dataset)


def semi_supervised_split(raw: RawData, n_valid: int = 500,
                          n_labeled: int = 400) -> dict:
    """Per-class quota split in dataset order (datasets.py:116-133): the
    first ``n_valid`` images of each class are "valid", the next
    ``n_labeled`` "labeled", the rest "unlabeled", with -1 labels (the
    reference means to set them, but its line is a no-op expression,
    datasets.py:215).  Returns {"labeled": (x, y), "valid": (x, y),
    "unlabeled": (x, -1), "test": (x, y)}."""
    y = np.asarray(raw.y_train)
    # each image's rank among the images of its class, in dataset order
    order = np.argsort(y, kind="stable")
    rank = np.empty(len(y), np.int64)
    starts = np.searchsorted(y[order], y[order])
    rank[order] = np.arange(len(y)) - starts
    split = np.where(rank < n_valid, 0, np.where(rank < n_valid + n_labeled,
                                                 1, 2))
    out = {}
    for sid, name in ((1, "labeled"), (0, "valid"), (2, "unlabeled")):
        m = split == sid
        labels = y[m].copy()
        if name == "unlabeled":
            labels[:] = -1
        out[name] = (raw.x_train[m], labels)
    out["test"] = (raw.x_test, raw.y_test)
    return out
