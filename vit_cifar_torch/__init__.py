"""vit_cifar_torch — the PyTorch and CUDA port of ``vit_cifar_tpu`` for one
NVIDIA H100.

Module names follow the JAX package, so each module's counterpart is found
under the same path.  The port imports torch and never jax; its kernels are
hand-written for Hopper (``csrc/``), built at first use and registered as
``torch.library`` operators (``ops/cuda/``).  Ported so far: every model of
the zoo with its training (``train/loop.py``, the CLI ``python -m
vit_cifar_torch``: AutoAugment, checkpoints, resume), serving as an
exported ``torch.export`` artifact with optional int8 weights
(``deploy.py``), and the analysis tools (``analysis/``).  The parallel
modes are not ported yet.
"""

from .config import Config, torch_dtype

__all__ = ["Config", "torch_dtype"]
