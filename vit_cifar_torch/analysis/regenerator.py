"""Token-regenerator study: can an autoencoder reconstruct masked tokens?
As ``vit_cifar_tpu/analysis/regenerator.py``.

Reference: test_regenerator.py — a wandb experiment training a patch-token
autoencoder ("regenerator") to reconstruct images, then measuring how well it
regenerates each token from a one-token-masked sequence (cosine and MSE score
matrices, with and without the self-reconstruction diagonal).  The reference
script is broken as shipped (imports ``autotoencoders`` — a typo —
test_regenerator.py:15, and references undefined ``nnmf_layers``/``AutoNNMF``,
:150,385); this is a working equivalent with matplotlib/CSV output instead of
wandb.  The network is built of the port's ``ops/autoencoders.py`` and
``ops/patchify.py``; the optimisers are ``torch.optim.Adam`` (optax's
``adam`` defaults), the weights come from a ``torch.Generator`` seeded with
``seed``, and everything runs on ``device`` (default the card).  Without
matplotlib the study runs and writes its CSV, and says which pictures it
did not draw.

    python -m vit_cifar_torch.analysis.regenerator --epochs 2 --out regen_report/
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.augment import normalize
from ..data.datasets import load_dataset
from ..ops.autoencoders import Autoencoder, Autoencoder2D, AutoencoderT
from ..ops.common import LayerNorm
from ..ops.init import Linear, normal
from ..ops.patchify import from_words, to_words


class RegeneratorNet(nn.Module):
    """test_regenerator.py:19-122: patchify -> embed -> cls+pos -> regenerator
    AE -> un-embed -> fold back to an image.  Parameter names are the flax
    module's."""

    def __init__(self, regenerator: str = "simple", in_c: int = 3,
                 img_size: int = 32, patch: int = 8, hidden: int = 384,
                 ae_hidden: int = 128, is_cls_token: bool = True, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.patch, self.img_size, self.in_c = patch, img_size, in_c
        self.hidden, self.is_cls_token = hidden, is_cls_token
        f = (img_size // patch) ** 2 * in_c
        T = patch**2 + (1 if is_cls_token else 0)
        lin = dict(generator=generator, device=device)
        self.emb = Linear(f, hidden, **lin)
        if is_cls_token:
            self.cls_token = nn.Parameter(
                normal((1, 1, hidden), generator).to(device))
        self.pos_emb = nn.Parameter(normal((1, T, hidden), generator).to(device))
        if regenerator == "simple":
            self.regenerator = Autoencoder(hidden, ae_hidden, **lin)
        elif regenerator == "transpose":
            self.regenerator = AutoencoderT(T, 8, **lin)
        elif regenerator == "2d":
            self.regenerator = Autoencoder2D(
                "sfsf", seq=T, features=hidden, seq_hidden=8,
                features_hidden=ae_hidden, **lin)
        else:
            raise NotImplementedError(regenerator)
        self.unembed_norm = LayerNorm(hidden, device=device)
        self.unembed_fc = Linear(hidden, f, **lin)

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        out = self.emb(to_words(x, self.patch))
        if self.is_cls_token:
            cls = self.cls_token.expand(out.shape[0], 1, self.hidden)
            out = torch.cat([cls, out], dim=1)
        return out + self.pos_emb

    def forward(self, x: torch.Tensor, *, mask: bool = False):
        tok = self.tokens(x)
        regen_input = tok.detach()
        if mask:
            # eye-masked (B,T,T,H): row i keeps only token i
            T = tok.shape[1]
            rep = tok[:, None].expand(tok.shape[0], T, T, tok.shape[-1])
            eye = torch.eye(T, dtype=tok.dtype, device=tok.device)
            out = self.regenerator(eye[None, :, :, None] * rep)[0]
            return regen_input, out.detach()
        out = self.regenerator(tok)[0]
        regen_output = out.detach()
        if self.is_cls_token:
            out = out[:, 1:, :]
        out = self.unembed_fc(self.unembed_norm(out))
        img = from_words(out, self.patch, self.img_size, self.in_c)
        return img, regen_input, regen_output

    def regenerate(self, regen_input: torch.Tensor) -> torch.Tensor:
        """One regenerator forward for its own optimiser."""
        return self.regenerator(regen_input)[0]


def score_matrices(regen_input: torch.Tensor, masked_output: torch.Tensor):
    """Cosine and MSE score matrices (test_regenerator.py:229-273)."""
    num = torch.einsum("bjh,bijh->bij", regen_input, masked_output)
    den = (torch.linalg.norm(regen_input, dim=-1)[:, None, :]
           * torch.linalg.norm(masked_output, dim=-1) + 1e-8)
    cos = num / den
    mse = ((masked_output - regen_input[:, None, :, :]) ** 2).mean(dim=-1)
    return cos, mse


def run_study(
    dataset: str = "c10",
    regenerator: str = "simple",
    epochs: int = 1,
    batch_size: int = 128,
    regenerator_iterations: int = 1,
    lr: float = 1e-3,
    hidden: int = 384,
    patch: int = 8,
    out_dir: str = "regen_report",
    log_interval: int = 100,
    synthetic: bool = False,
    seed: int = 0,
    verbose: bool = True,
    device="cuda",
):
    os.makedirs(out_dir, exist_ok=True)
    device = torch.device(device)
    raw = load_dataset(dataset, synthetic=synthetic)
    # reference uses Normalize((0.5,), (0.5,))
    mean = std = (0.5, 0.5, 0.5)
    model = RegeneratorNet(regenerator=regenerator, hidden=hidden,
                           patch=patch,
                           generator=torch.Generator().manual_seed(seed),
                           device=device)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    regen_opt = torch.optim.Adam(model.regenerator.parameters(), lr=lr)

    def images(idx) -> torch.Tensor:
        return normalize(torch.from_numpy(raw.x_train[idx]).to(device),
                         mean, std)

    def train_step(img):
        out, regen_in, _ = model(img)
        loss = F.mse_loss(out, img)
        opt.zero_grad()
        loss.backward()
        opt.step()
        regen_loss = torch.zeros((), device=device)
        for _ in range(regenerator_iterations):
            rl = F.mse_loss(model.regenerate(regen_in), regen_in)
            regen_opt.zero_grad()
            rl.backward()
            regen_opt.step()
            regen_loss = regen_loss + rl.detach()
        return loss.detach(), regen_loss

    n = len(raw.x_train)
    steps_per_epoch = n // batch_size
    rng = np.random.default_rng(seed)
    history = []
    for epoch in range(epochs):
        order = rng.permutation(n)
        for i in range(steps_per_epoch):
            img = images(order[i * batch_size: (i + 1) * batch_size])
            loss, regen_loss = train_step(img)
            step = epoch * steps_per_epoch + i
            if i % log_interval == log_interval - 1:
                with torch.no_grad():
                    cos, mse = score_matrices(*model(img[:32], mask=True))
                cosm = cos.mean(0).cpu().numpy()
                msem = mse.mean(0).cpu().numpy()
                nsr = cosm.copy()
                np.fill_diagonal(nsr, 0.0)
                row = dict(
                    step=step,
                    loss=float(loss),
                    regenerator_loss=float(regen_loss),
                    score=float(cosm.mean()),
                    score_nsr=float(nsr.mean()),
                    mse=float(msem.mean()),
                )
                history.append(row)
                if verbose:
                    print(row)
                _draw(_plot_scores, cosm, nsr, msem,
                      os.path.join(out_dir, f"scores_{step}.png"))

    # final reconstruction grid (test_regenerator.py's Network_reconstruct image)
    test_img = normalize(torch.from_numpy(raw.x_test[:10]).to(device),
                         mean, std)
    with torch.no_grad():
        recon = model(test_img)[0]
    _draw(_plot_recon, test_img.cpu().numpy(), recon.cpu().numpy(),
          os.path.join(out_dir, "reconstruction.png"))

    import csv

    with open(os.path.join(out_dir, "metrics.csv"), "w", newline="") as f:
        if history:
            w = csv.DictWriter(f, fieldnames=list(history[0]))
            w.writeheader()
            w.writerows(history)
    return history


def _draw(plot, *args) -> None:
    """``plot(*args)``, whose last argument is the PNG's path; where
    matplotlib is not installed, say so and go on without the picture."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"[regenerator] matplotlib is not installed: {args[-1]} not "
              "drawn")
        return
    plot(*args)


def _plot_scores(cos, nsr, mse, path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    for ax, data, title in [
        (axes[0], cos, "regenerator_score"),
        (axes[1], nsr, "regenerator_score (NSR)"),
        (axes[2], mse, "MSE"),
    ]:
        im = ax.imshow(data, cmap="viridis")
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def _plot_recon(orig, recon, path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(orig)
    fig, axes = plt.subplots(2, n, figsize=(1.4 * n, 3))
    for i in range(n):
        axes[0][i].imshow(np.clip(orig[i] * 0.5 + 0.5, 0, 1))
        axes[1][i].imshow(np.clip(recon[i] * 0.5 + 0.5, 0, 1))
        for ax in (axes[0][i], axes[1][i]):
            ax.set_xticks([])
            ax.set_yticks([])
    axes[0][0].set_ylabel("input")
    axes[1][0].set_ylabel("reconstruction")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser(description="Token-regenerator study")
    p.add_argument("--dataset", default="c10", choices=["c10", "c100", "svhn"])
    p.add_argument("--regenerator", default="simple", choices=["simple", "transpose", "2d"])
    p.add_argument("--epochs", default=1, type=int)
    p.add_argument("--batch-size", default=128, type=int)
    p.add_argument("--regenerator-iterations", default=1, type=int)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--hidden", default=384, type=int)
    p.add_argument("--patch", default=8, type=int)
    p.add_argument("--log-interval", default=100, type=int)
    p.add_argument("--out", default="regen_report")
    p.add_argument("--synthetic-data", action="store_true")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda",
                   help="the torch device of the study (default cuda)")
    a = p.parse_args(argv)
    run_study(
        dataset=a.dataset, regenerator=a.regenerator, epochs=a.epochs,
        batch_size=a.batch_size, regenerator_iterations=a.regenerator_iterations,
        lr=a.lr, hidden=a.hidden, patch=a.patch, out_dir=a.out,
        log_interval=a.log_interval, synthetic=a.synthetic_data,
        seed=a.seed, device=a.device,
    )


if __name__ == "__main__":
    main()
