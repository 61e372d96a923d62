"""The port's training CLI (``vit-cifar-torch``, ``python -m
vit_cifar_torch``): the JAX package's flags (``config.build_parser``) plus
``--device``, default the CUDA card.

    python -m vit_cifar_torch --dataset c10 --model-name vit --num-layers 7 \
        --hidden 384 --mlp-hidden 384 --head 12 --label-smoothing --autoaugment

On a mesh, one process per device under torchrun; each rank takes
``cuda:{LOCAL_RANK}`` (NCCL), or the CPU with ``--device cpu`` (gloo):

    torchrun --nproc-per-node 4 -m vit_cifar_torch --model-name vit \
        --mesh-shape 2,2 --mesh-axes data,model
"""

from __future__ import annotations

import os
from pprint import pprint

import torch
import torch.distributed as dist

from .config import build_parser, config_from_namespace
from .parallel.mesh import initialize_multihost
from .train.loop import train


def main(argv=None):
    parser = build_parser()
    parser.add_argument("--device", default="cuda",
                        help="the torch device to train on (default: cuda)")
    ns = parser.parse_args(argv)
    cfg = config_from_namespace(ns)
    device = ns.device
    launched = "LOCAL_RANK" in os.environ  # by torchrun
    if launched:
        if device == "cuda":
            device = f"cuda:{os.environ['LOCAL_RANK']}"
            torch.cuda.set_device(device)
        initialize_multihost(device=device)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    try:
        if lead:
            pprint(dict(cfg.__dict__))
        result = train(cfg, device=device)
    finally:
        if launched:
            dist.destroy_process_group()
    if lead:
        print(f"Finished '{result['experiment']}': "
              f"val_acc={result['val_acc']:.4f} "
              f"val_loss={result['val_loss']:.4f} "
              f"({result['images_per_sec']:.0f} img/s, "
              f"{result['total_time_s']:.1f}s)")
    return result


if __name__ == "__main__":
    main()
