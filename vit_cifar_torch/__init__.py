"""vit_cifar_torch — the PyTorch and CUDA port of ``vit_cifar_tpu`` for one
NVIDIA H100.

Module names follow the JAX package, so each module's counterpart is found
under the same path.  The port imports torch and never jax; its kernels are
hand-written for Hopper (``csrc/``) and built at first use.  The slices
ported so far are the serving path of the ``vit`` model (``deploy.py``) and
the README recipe's training with AutoAugment, checkpoints and resume
(``train/loop.py``, the CLI ``python -m vit_cifar_torch``).
"""

from .config import Config, torch_dtype

__all__ = ["Config", "torch_dtype"]
