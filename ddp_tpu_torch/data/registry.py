"""Dataset registry: name → (train split, test split) (the MNIST family
of ``ddp_tpu/data/registry.py``, plus the vendored ``uci_digits``)."""

from __future__ import annotations

from ddp_tpu_torch.data import mnist

NUM_CLASSES = {name: 10 for name in mnist.VARIANTS}


def load_dataset(
    name: str,
    root: str = "./data",
    *,
    allow_synthetic: bool = False,
    synthetic_size: int | None = None,
) -> tuple[mnist.Split, mnist.Split]:
    """(train, test); a synthetic test split is ``synthetic_size // 6``."""
    if name not in NUM_CLASSES:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(NUM_CLASSES)}")
    train = mnist.load(
        root, "train", variant=name,
        allow_synthetic=allow_synthetic, synthetic_size=synthetic_size,
    )
    test = mnist.load(
        root, "test", variant=name,
        allow_synthetic=allow_synthetic,
        synthetic_size=max(1, synthetic_size // 6) if synthetic_size else None,
    )
    return train, test
