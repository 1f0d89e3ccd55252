"""The ResNet family (``ddp_tpu/models/resnet.py``), NCHW.

``BasicBlock`` (ResNet-18/34) and ``BottleneckBlock`` (ResNet-50), the
CIFAR stem (3×3/1, no pool) or the ImageNet stem (7×7/2, 3×3/2 max
pool), zero-gamma on the last BatchNorm of each residual branch, a
global average pool and an fp32 ``fc``. Submodules carry the Flax names
(``stem_conv``, ``stage1_block1.Conv_0``, ``BatchNorm_1``,
``downsample_bn``, ``fc``), so ``interop/jax_params`` maps the two
trees name for name. What the port must do as Flax does, where torch's
defaults differ:

- **BatchNorm** (:class:`BatchNorm`): momentum 0.9 on the running
  average (torch's 0.1), eps 1e-5, and the *biased* batch variance
  folded into the running variance (torch folds the unbiased one);
  statistics and normalisation in fp32 (fp64 for an fp64 input), the
  output in the input's dtype
  (Flax ``dtype=x.dtype``: bf16 under ``compute_dtype=bfloat16``). The
  running statistics are buffers (``running_mean``, ``running_var``):
  they ride ``state_dict()`` and the data-parallel step's bucket.
- **SAME padding** (:func:`same_pads`): Flax pads ``"SAME"`` by
  ``total = max((ceil(n/s) − 1)·s + k − n, 0)``, ``total // 2`` before
  and the rest after: (0, 1) for a 3×3 stride-2 conv on an even side,
  (2, 3) for the 7×7/2 stem at 224. ``padding=1`` in torch would shift
  the image by a pixel. The max pool pads with −inf.
- **Layout**: Flax kernels are HWIO, torch's OIHW.

``compute_dtype`` runs the forward on parameters cast to that dtype, as
the JAX step casts its params (the running statistics stay fp32).
``remat`` recomputes each residual block in the backward
(``models/remat.py``); its BatchNorms advance their running statistics
on the first forward only.

Under the image family's GSPMD step (``parallel/spmd``) each BatchNorm
has ``sync``, the communicator of the data axes: in training it
normalises by the moments of the global batch, as flax's
``nn.BatchNorm`` does when XLA partitions it (its fast variance,
E[x²] − E[x]², from one all-reduce of the per-channel sums that is
differentiable: the gradient goes through it), and advances the
running averages by them, so every replica holds the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddp_tpu_torch.models.remat import remat_block
from ddp_tpu_torch.parallel.tp import psum

BN_MOMENTUM = 0.9  # Flax's: running = momentum · running + (1 − momentum) · batch
BN_EPS = 1e-5


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """Flax/XLA ``"SAME"`` padding of one spatial dim → (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kernel: int, stride: int, value: float = 0.0):
    (t, b), (l, r) = (same_pads(n, kernel, stride) for n in x.shape[-2:])
    if t == b and l == r and value == 0.0:
        return x, (t, l)  # symmetric: the conv pads it itself
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


def _wide(dt: torch.dtype) -> torch.dtype:
    """The dtype of statistics and of the head: fp32, or fp64 for fp64."""
    return torch.promote_types(dt, torch.float32)


def batch_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased variance) per channel of [B, C, H, W], in fp32 (or
    fp64): what Flax folds into the running averages."""
    var, mean = torch.var_mean(x.to(_wide(x.dtype)), dim=(0, 2, 3),
                               unbiased=False)
    return mean, var


class Conv(nn.Module):
    """``nn.Conv(features, (k, k), strides, use_bias=False)`` with SAME
    padding; weight OIHW."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__()
        self.stride, self.kernel = stride, kernel
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))

    def forward(self, x, dt):
        x, pad = _pad_same(x, self.kernel, self.stride)
        return F.conv2d(x, self.weight.to(dt), stride=self.stride, padding=pad)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=x.dtype)``
    over the channels of NCHW; the mode is the module's (``train()``:
    batch statistics, the running averages advanced; ``eval()``: the
    running averages). While ``recomputing`` (a remat backward's second
    forward) it normalises by the batch statistics without folding them
    into the running averages again."""

    def __init__(self, features: int, *, zero_init: bool = False):
        super().__init__()
        self.zero_init = zero_init  # zero-gamma: init_state's scale is 0
        self.recomputing = False
        self.sync = None  # the data axes' communicator under GSPMD
        self.weight = nn.Parameter(torch.ones(features))  # Flax "scale"
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, dt):
        wide = _wide(dt)
        scale, bias = self.weight.to(dt).to(wide), self.bias.to(dt).to(wide)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                scale, bias, False, 0.0, BN_EPS)
        if self.sync is not None:
            return self._synced(x, scale, bias, wide)
        if not self.recomputing:
            with torch.no_grad():
                mean, var = batch_stats(x)
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    mean, alpha=1 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    var, alpha=1 - BN_MOMENTUM)
        return F.batch_norm(x, None, None, scale, bias, True, 0.0, BN_EPS)

    def _synced(self, x, scale, bias, wide):
        """Training over the global batch of ``sync``'s ranks."""
        xw = x.to(wide)
        n = xw.numel() // xw.shape[1] * self.sync.size
        sums = psum(torch.stack([xw.sum((0, 2, 3)),
                                 xw.square().sum((0, 2, 3))]), self.sync)
        mean = sums[0] / n
        var = torch.clamp(sums[1] / n - mean.square(), min=0.0)
        if not self.recomputing:
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    mean, alpha=1 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    var, alpha=1 - BN_MOMENTUM)
        mul = torch.rsqrt(var + BN_EPS) * scale
        y = (xw - mean[:, None, None]) * mul[:, None, None] \
            + bias[:, None, None]
        return y.to(x.dtype)


class BasicBlock(nn.Module):
    """2×(3×3 conv) residual block — ResNet-18/34."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 3, stride)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv(features, features, 3)
        self.BatchNorm_1 = BatchNorm(features, zero_init=True)
        if stride != 1 or cin != features:
            self.downsample = Conv(cin, features, 1, stride)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x, dt):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x, dt), dt))
        y = self.BatchNorm_1(self.Conv_1(y, dt), dt)
        if hasattr(self, "downsample"):
            x = self.downsample_bn(self.downsample(x, dt), dt)
        return F.relu(y + x)


class BottleneckBlock(nn.Module):
    """1×1 → 3×3 → 1×1 residual block (4× expansion) — ResNet-50."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        out = features * 4
        self.Conv_0 = Conv(cin, features, 1)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv(features, features, 3, stride)
        self.BatchNorm_1 = BatchNorm(features)
        self.Conv_2 = Conv(features, out, 1)
        self.BatchNorm_2 = BatchNorm(out, zero_init=True)
        if stride != 1 or cin != out:
            self.downsample = Conv(cin, out, 1, stride)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x, dt):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x, dt), dt))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y, dt), dt))
        y = self.BatchNorm_2(self.Conv_2(y, dt), dt)
        if hasattr(self, "downsample"):
            x = self.downsample_bn(self.downsample(x, dt), dt)
        return F.relu(y + x)


class ResNet(nn.Module):
    """Stage-configurable ResNet with the ImageNet or the CIFAR stem."""

    def __init__(self, stage_sizes, block, num_classes: int = 1000, *,
                 width: int = 64, cifar_stem: bool = False,
                 in_channels: int = 3, remat: bool = False):
        super().__init__()
        self.cifar_stem = cifar_stem
        self.remat = remat
        self.stem_conv = (Conv(in_channels, width, 3) if cifar_stem
                          else Conv(in_channels, width, 7, 2))
        self.stem_bn = BatchNorm(width)
        self.block_names = []
        cin = width
        for stage, num_blocks in enumerate(stage_sizes):
            for i in range(num_blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                name = f"stage{stage + 1}_block{i + 1}"
                self.add_module(name, block(cin, width * 2**stage, stride))
                self.block_names.append(name)
                cin = width * 2**stage * (4 if block is BottleneckBlock else 1)
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        """``x`` [B, C, H, W] → fp32 (fp64 under fp64) logits [B, num_classes]."""
        dt = compute_dtype or x.dtype
        # NCHW-contiguous: the step hands over a permuted NHWC view, and
        # torch's CPU backward of a stride-2 1×1 conv on a channels-last
        # input corrupts the heap (torch 2.13.0+cpu).
        x = x.to(dt).contiguous()
        x = F.relu(self.stem_bn(self.stem_conv(x, dt), dt))
        if not self.cifar_stem:
            x, _ = _pad_same(x, 3, 2, value=-math.inf)
            x = F.max_pool2d(x, 3, 2)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            x = remat_block(block, x, dt) if remat else block(x, dt)
        x = x.mean(dim=(2, 3))  # global average pool
        wide = _wide(dt)
        return F.linear(x.to(wide), self.fc.weight.to(dt).to(wide),
                        self.fc.bias.to(dt).to(wide))

    def init_state(self, seed: int = 0) -> dict[str, np.ndarray]:
        """Seeded random weights made with numpy (the scales of the JAX
        initialisers, untruncated): convs He-normal N(0, 2/fan_in), the
        fc LeCun-normal N(0, 1/fan_in) with a zero bias, BN scale 1 (0 on
        each branch's last BN) and bias 0; running mean 0, variance 1."""
        rng = np.random.default_rng(seed)
        state = {}
        for name, t in self.state_dict().items():
            shape, leaf = tuple(t.shape), name.rsplit(".", 1)[-1]
            if name.endswith("fc.weight"):
                v = rng.standard_normal(shape, dtype=np.float32) * shape[1] ** -0.5
            elif len(shape) == 4:
                fan_in = shape[1] * shape[2] * shape[3]
                v = (rng.standard_normal(shape, dtype=np.float32)
                     * np.float32((2.0 / fan_in) ** 0.5))
            elif leaf == "weight":
                bn = self.get_submodule(name.rsplit(".", 1)[0])
                v = np.full(shape, 0.0 if bn.zero_init else 1.0, np.float32)
            elif leaf == "running_var":
                v = np.ones(shape, np.float32)
            else:
                v = np.zeros(shape, np.float32)
            state[name] = np.asarray(v, np.float32)
        return state


def ResNet18(num_classes: int = 10, cifar_stem: bool = True, **kw) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, num_classes,
                  cifar_stem=cifar_stem, **kw)


def ResNet34(num_classes: int = 1000, cifar_stem: bool = False, **kw) -> ResNet:
    return ResNet((3, 4, 6, 3), BasicBlock, num_classes,
                  cifar_stem=cifar_stem, **kw)


def ResNet50(num_classes: int = 1000, cifar_stem: bool = False, **kw) -> ResNet:
    return ResNet((3, 4, 6, 3), BottleneckBlock, num_classes,
                  cifar_stem=cifar_stem, **kw)
