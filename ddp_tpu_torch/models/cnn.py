"""SimpleCNN, the reference's model (``ddp_tpu/models/cnn.py:23-47``).

Conv2d(1→32, 3×3, pad 1) → ReLU → Conv2d(32→64, 3×3, pad 1) → ReLU →
flatten → Linear(64·28·28 → 10): 520,586 parameters at the reference's
width. NCHW, cuDNN's layout, with the reference ``model.py``'s
parameter names (``net.0``, ``net.2``, ``fl``), so its ``torch.save``
state dicts load as they are. The JAX package is NHWC, so the two
flatten orders differ; ``interop/jax_params.cnn_params_from_jax``
re-gathers the head so both compute the same function.

``compute_dtype`` runs the forward on parameters cast to that dtype (the
casts are differentiable: gradients reach the fp32 masters in fp32), as
the JAX step casts its params. TF32 is the caller's decision
(``parallel/common.precision``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class SimpleCNN(nn.Module):
    def __init__(self, num_classes: int = 10, features=(32, 64), *,
                 side: int = 28, in_channels: int = 1):
        super().__init__()
        f0, f1 = features
        self.net = nn.Sequential(
            nn.Conv2d(in_channels, f0, 3, padding=1), nn.ReLU(),
            nn.Conv2d(f0, f1, 3, padding=1), nn.ReLU(),
        )
        self.fl = nn.Linear(f1 * side * side, num_classes)

    def forward(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        """``x`` [B, C, H, W] → logits [B, num_classes] in ``x``'s dtype."""
        dt = compute_dtype or x.dtype
        c1, c2 = self.net[0], self.net[2]
        x = F.relu(F.conv2d(x, c1.weight.to(dt), c1.bias.to(dt), padding=1))
        x = F.relu(F.conv2d(x, c2.weight.to(dt), c2.bias.to(dt), padding=1))
        return F.linear(x.flatten(1), self.fl.weight.to(dt), self.fl.bias.to(dt))

    def init_state(self, seed: int = 0) -> dict[str, np.ndarray]:
        """:func:`init_cnn_state` at this model's widths."""
        c1, c2 = self.net[0], self.net[2]
        side = math.isqrt(self.fl.in_features // c2.out_channels)
        return init_cnn_state((c1.out_channels, c2.out_channels),
                              num_classes=self.fl.out_features, side=side,
                              in_channels=c1.in_channels, seed=seed)

    @classmethod
    def from_state(cls, state: dict, device, *, num_classes: int = 10):
        """A model on ``device`` holding ``state`` (numpy arrays or tensors
        keyed as ``state_dict()``); widths are read from the shapes."""
        w1, w2 = state["net.0.weight"], state["net.2.weight"]
        side = int(round((np.shape(state["fl.weight"])[1] / w2.shape[0]) ** 0.5))
        model = cls(num_classes, (w1.shape[0], w2.shape[0]), side=side,
                    in_channels=w1.shape[1])
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in state.items()})
        return model.to(device)


def init_cnn_state(features=(32, 64), *, num_classes: int = 10,
                   side: int = 28, in_channels: int = 1,
                   seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded random weights made with numpy: weights N(0, 1/fan_in) (the
    scale of Flax's default initialiser), biases zero."""
    rng = np.random.default_rng(seed)
    f0, f1 = features

    def normal(shape, fan_in):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(fan_in ** -0.5))

    flat = f1 * side * side
    return {
        "net.0.weight": normal((f0, in_channels, 3, 3), in_channels * 9),
        "net.0.bias": np.zeros(f0, np.float32),
        "net.2.weight": normal((f1, f0, 3, 3), f0 * 9),
        "net.2.bias": np.zeros(f1, np.float32),
        "fl.weight": normal((num_classes, flat), flat),
        "fl.bias": np.zeros(num_classes, np.float32),
    }
