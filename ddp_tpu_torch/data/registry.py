"""Dataset registry: name → (train split, test split) (the MNIST, CIFAR
and ImageNet families of ``ddp_tpu/data/registry.py``, plus the vendored
``uci_digits``)."""

from __future__ import annotations

from ddp_tpu_torch.data import cifar, imagenet, mnist

NUM_CLASSES = {**{name: 10 for name in mnist.VARIANTS},
               "cifar10": 10, "cifar100": 100,
               "imagenet": imagenet.NUM_CLASSES}
# A synthetic test split is synthetic_size // this (the JAX loaders').
_TEST_SHARE = {**{name: 6 for name in mnist.VARIANTS},
               "cifar10": 5, "cifar100": 5, "imagenet": 4}


def load_split(
    name: str,
    root: str,
    split: str,
    *,
    allow_synthetic: bool = False,
    synthetic_size: int | None = None,
) -> mnist.Split:
    """ONE split of ``name`` (``registry.py:114``); ``synthetic_size`` is
    that split's own size."""
    kw = dict(allow_synthetic=allow_synthetic, synthetic_size=synthetic_size)
    if name in cifar.NAMES:
        return cifar.load(root, split, name=name, **kw)
    if name in mnist.VARIANTS:
        return mnist.load(root, split, variant=name, **kw)
    if name == "imagenet":
        return imagenet.load(root, split, **kw)
    raise KeyError(f"unknown dataset {name!r}; have {sorted(NUM_CLASSES)}")


def load_dataset(
    name: str,
    root: str = "./data",
    *,
    allow_synthetic: bool = False,
    synthetic_size: int | None = None,
) -> tuple[mnist.Split, mnist.Split]:
    """(train, test); a synthetic test split is ``synthetic_size // 6``
    (MNIST family), ``// 5`` (CIFAR) or ``// 4`` (ImageNet)."""
    if name not in NUM_CLASSES:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(NUM_CLASSES)}")
    test_size = (max(1, synthetic_size // _TEST_SHARE[name])
                 if synthetic_size else None)
    kw = dict(allow_synthetic=allow_synthetic)
    return (load_split(name, root, "train", synthetic_size=synthetic_size, **kw),
            load_split(name, root, "test", synthetic_size=test_size, **kw))
