"""Accuracy/loss curve plots from training logs, as
``vit_cifar_tpu/analysis/curves.py``, from the port's ``metrics.csv``.

Reference parity: the README's imgs/{acc,loss}_{c10,c100,svhn}.jpeg curves
(README.md:41-60).  Reads one or more `logs/<experiment>/metrics.csv` files
and writes acc/loss PNGs.

    python -m vit_cifar_torch.analysis.curves --logs logs/exp1 logs/exp2 --out imgs/
"""

from __future__ import annotations

import argparse
import csv
import os


def read_metrics(exp_dir: str) -> dict[str, list]:
    path = os.path.join(exp_dir, "metrics.csv")
    cols: dict[str, list] = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            for k, v in row.items():
                if v not in (None, ""):
                    try:
                        cols.setdefault(k, []).append((int(row["epoch"]), float(v)))
                    except ValueError:
                        pass
    return cols


def plot_curves(exp_dirs: list[str], out_dir: str = "imgs") -> list[str]:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for metric_pair, fname in [
        (("acc", "val_acc"), "acc.png"),
        (("loss", "val_loss"), "loss.png"),
    ]:
        fig, ax = plt.subplots(figsize=(7, 4.5))
        for d in exp_dirs:
            name = os.path.basename(os.path.normpath(d))
            cols = read_metrics(d)
            for m in metric_pair:
                if m in cols:
                    xs, ys = zip(*cols[m])
                    ax.plot(xs, ys, label=f"{name}:{m}",
                            linestyle="--" if m.startswith("val") else "-")
        ax.set_xlabel("epoch")
        ax.set_ylabel(metric_pair[0])
        ax.legend(fontsize=7)
        ax.grid(alpha=0.3)
        path = os.path.join(out_dir, fname)
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description="Plot acc/loss curves from metrics.csv")
    p.add_argument("--logs", nargs="+", required=True, help="experiment log dirs")
    p.add_argument("--out", default="imgs")
    a = p.parse_args(argv)
    for path in plot_curves(a.logs, a.out):
        print(path)


if __name__ == "__main__":
    main()
