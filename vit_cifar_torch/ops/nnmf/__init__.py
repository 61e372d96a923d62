"""The NNMF stack, as ``vit_cifar_tpu/ops/nnmf``: the iterate with its
hand-derived backward (``functional``), the layers and the after-care
(``layers``) and the Madam optimizer (``optimizer``)."""
