"""The port's training CLI (``vit-cifar-torch``, ``python -m
vit_cifar_torch``): the JAX package's flags (``config.build_parser``) plus
``--device``, default the CUDA card.

    python -m vit_cifar_torch --dataset c10 --model-name vit --num-layers 7 \
        --hidden 384 --mlp-hidden 384 --head 12 --label-smoothing --autoaugment
"""

from __future__ import annotations

from pprint import pprint

from .config import build_parser, config_from_namespace
from .train.loop import train


def main(argv=None):
    parser = build_parser()
    parser.add_argument("--device", default="cuda",
                        help="the torch device to train on (default: cuda)")
    ns = parser.parse_args(argv)
    cfg = config_from_namespace(ns)
    pprint(dict(cfg.__dict__))
    result = train(cfg, device=ns.device)
    print(f"Finished '{result['experiment']}': "
          f"val_acc={result['val_acc']:.4f} "
          f"val_loss={result['val_loss']:.4f} "
          f"({result['images_per_sec']:.0f} img/s, "
          f"{result['total_time_s']:.1f}s)")
    return result


if __name__ == "__main__":
    main()
