"""Per-step training metrics (the counterpart of ``ddp_tpu/parallel/ddp.py``).

Only :class:`StepMetrics` and the gradient norm it carries so far; the
data-parallel step, its state and the eval step come with the slice of
the reference trainer's main path.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class StepMetrics(NamedTuple):
    """One step's metrics, as tensors on the step's device (reading them
    is the caller's host sync)."""

    loss: Any
    accuracy: Any
    # Global L2 norm of the gradient (before any clipping); None means
    # the step did not compute it.
    grad_norm: Any = None
    health: Any = None


def global_norm(tensors) -> torch.Tensor:
    """√Σ‖t‖², as ``optax.global_norm``; on the tensors' device."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))
