"""The hand-written CUDA kernels of the port and their wrappers:
``attention`` (the whole-head forward, whose autograd Function takes the
tiled backward) and ``flash_attention`` (the tiled kernels), each kernel an
operator of ``torch.library`` (``registry``).  Importing this package
registers every operator of the port, the seed-0 draw included, which is
all a process that serves an exported model (``deploy.py``) needs of this
package.  ``KERNEL_WRAPPERS`` maps each kernel's name to the wrapper that
counts its launches in ``<wrapper>.launches``."""

from . import attention, flash_attention, registry

KERNEL_WRAPPERS = {"mhsa_fwd": attention.fused_attention,
                   "mhsa_fwd_lse": attention.fused_attention_lse,
                   "flash_fwd": flash_attention.flash_attention,
                   "flash_fwd_lse": flash_attention.flash_attention_lse,
                   "flash_bwd_dq_tiled": flash_attention.flash_tiled_bwd_dq,
                   "flash_bwd_dkv_tiled": flash_attention.flash_tiled_bwd_dkv}
