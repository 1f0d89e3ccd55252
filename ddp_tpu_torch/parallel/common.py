"""Train-step pieces shared by the data-parallel step and the epoch
runner (``ddp_tpu/parallel/common.py``): preprocessing, the loss, the
accumulation check, and the numerics of ``compute_dtype``."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def _preprocess(images: torch.Tensor, compute_dtype) -> torch.Tensor:
    """ToTensor's scaling (``common.py:32``): uint8 NHWC → compute dtype,
    ``/ 255`` in that dtype, as NCHW (a view for one channel). Feature
    sequences [B, T, d] (the long-context model's) only take the dtype."""
    x = images
    if x.dtype == torch.uint8:
        x = x.to(compute_dtype) / torch.tensor(255.0, dtype=compute_dtype)
    x = x.to(compute_dtype)
    return x.permute(0, 3, 1, 2) if x.dim() == 4 else x


def xent(logits32: torch.Tensor, labels: torch.Tensor,
         label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-example softmax cross-entropy against ``(1-α)·one_hot +
    α/num_classes`` targets (``common.py:42``); unreduced."""
    if not 0.0 <= label_smoothing < 1.0:
        raise ValueError(
            f"label_smoothing must be in [0, 1), got {label_smoothing}"
        )
    return F.cross_entropy(logits32, labels.long(), reduction="none",
                           label_smoothing=label_smoothing)


def check_accum_divisible(batch: int, grad_accum_steps: int) -> int:
    """Microbatch size (``common.py:112``)."""
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be ≥ 1, got {grad_accum_steps}")
    if batch % grad_accum_steps or batch < grad_accum_steps:
        raise ValueError(
            f"batch of {batch} not divisible into {grad_accum_steps} "
            f"non-empty microbatches"
        )
    return batch // grad_accum_steps


@contextlib.contextmanager
def precision(compute_dtype):
    """What ``compute_dtype=float32`` means on the card: full fp32. cuDNN
    runs fp32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32``); the step turns that off around
    its forward and backward and restores it after. (fp32 matmuls already
    run in full fp32 by default.) bfloat16 needs no such guard."""
    if compute_dtype != torch.float32:
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
