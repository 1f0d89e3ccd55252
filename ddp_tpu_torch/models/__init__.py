"""Models: the causal LM (dense or expert-routed) with its slot-level
decode primitives, and the image families of
``ddp_tpu/models/__init__.py``'s registry (the MoE ViTs among them).

:func:`get_model` builds an image model by its registry name; every one
takes ``num_classes``, ``side`` and ``in_channels`` (the dataset's) and
has ``init_state(seed)``, its seeded numpy weights.
"""

from __future__ import annotations

from ddp_tpu_torch.models.cnn import SimpleCNN
from ddp_tpu_torch.models.moe import MoEViTTiny, moe_vit_micro
from ddp_tpu_torch.models.resnet import ResNet18, ResNet34, ResNet50
from ddp_tpu_torch.models.vit import ViTTiny, vit_micro


def _resnet(ctor):
    def build(num_classes, *, side, in_channels, **kw):
        del side  # the global pool makes ResNet size-agnostic
        return ctor(num_classes, in_channels=in_channels, **kw)
    return build


_REGISTRY = {
    "simple_cnn": SimpleCNN,
    # BASELINE.json config 3: CIFAR-10 ResNet-18
    "resnet18": _resnet(ResNet18),
    "resnet34": _resnet(ResNet34),
    # BASELINE.json config 5: ImageNet-1k ResNet-50
    "resnet50": _resnet(ResNet50),
    # BASELINE.json config 4: ViT-Tiny / CIFAR-100 (attention path)
    "vit_tiny": ViTTiny,
    "vit_micro": vit_micro,
    # The expert-routed family (no reference counterpart)
    "vit_moe_tiny": MoEViTTiny,
    "vit_moe_micro": moe_vit_micro,
}
IMAGE_MODELS = tuple(_REGISTRY)


def get_model(name: str, *, num_classes: int, side: int, in_channels: int,
              **kwargs):
    """An image model, with torch's placeholder weights (load
    ``model.init_state(seed)`` or a checkpoint into it)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](num_classes, side=side, in_channels=in_channels,
                           **kwargs)
