"""``python -m vit_cifar_torch``: the training CLI (``cli.py``)."""

from .cli import main

if __name__ == "__main__":
    main()
