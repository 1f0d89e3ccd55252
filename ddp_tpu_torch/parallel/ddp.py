"""The data-parallel train and eval steps (``ddp_tpu/parallel/ddp.py``).

DDP's whole job is one line of the JAX step, ``lax.pmean(grads)``
(``ddp.py:160``). Here it is one ``all_reduce`` of one flat fp32 bucket
per optimizer step: every gradient, then the local loss and correct
count, summed over the world; gradients and loss are then divided by the
world. No ``DistributedDataParallel`` wrapper: the per-rank step and the
epoch runner (``train/fast.py``) share this one body, and gradient
accumulation keeps one all-reduce per update. Replicas start identical
(the same seeded weights on every rank), so no broadcast is needed.

``reduce`` sums a tensor over the world in place:
``runtime/dist.all_reduce_sum`` in a run; the tests pass an in-process
stand-in to hold a world of 2 against a 2-device JAX mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ddp_tpu_torch.parallel.common import (
    _preprocess,
    check_accum_divisible,
    precision,
    xent,
)
from ddp_tpu_torch.runtime.dist import all_reduce_sum


class StepMetrics(NamedTuple):
    """One step's metrics, as tensors on the step's device (reading them
    is the caller's host sync)."""

    loss: Any
    accuracy: Any
    # Global L2 norm of the gradient (before any clipping); None means
    # the step did not compute it.
    grad_norm: Any = None
    health: Any = None


@dataclasses.dataclass
class TrainState:
    """What a checkpoint carries (``ddp.py:44``): the optimizer-step
    count, the model (its parameters), the optimizer (its state), and
    the non-gradient collections (empty for SimpleCNN)."""

    step: int
    model: torch.nn.Module
    optimizer: Any
    model_state: dict = dataclasses.field(default_factory=dict)


def global_norm(tensors) -> torch.Tensor:
    """√Σ‖t‖², as ``optax.global_norm``; on the tensors' device."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def _loss_and_correct(model, images, labels, compute_dtype, label_smoothing):
    logits = model(_preprocess(images, compute_dtype),
                   compute_dtype=compute_dtype).float()
    loss = xent(logits, labels, label_smoothing).mean()
    correct = (logits.argmax(-1) == labels.long()).sum().float()
    return loss, correct


def make_train_step(
    state: TrainState,
    *,
    world: int = 1,
    reduce=all_reduce_sum,
    compute_dtype=torch.float32,
    grad_accum_steps: int = 1,
    label_smoothing: float = 0.0,
):
    """``step(images, labels) -> StepMetrics`` (``ddp.py:98-235``):
    this rank's uint8 batch through forward and backward, the one
    all-reduce, one optimizer update; ``state.step`` counts it.

    ``grad_accum_steps=k`` splits the local batch into k contiguous
    microbatches and averages their gradients. Metrics (``ddp.py:170``):
    loss is the mean over ranks, accuracy Σcorrect / (n·world), grad_norm
    the norm of the averaged, unclipped gradient. No host read.
    """
    model, optimizer = state.model, state.optimizer
    params = [p for p in model.parameters() if p.requires_grad]
    sizes = [p.numel() for p in params]

    def step(images, labels) -> StepMetrics:
        n = labels.shape[0]
        for p in params:
            p.grad = None
        with precision(compute_dtype):
            if grad_accum_steps == 1:
                loss, correct = _loss_and_correct(
                    model, images, labels, compute_dtype, label_smoothing)
                loss.backward()
            else:
                mb = check_accum_divisible(n, grad_accum_steps)
                loss = correct = 0.0
                for i in range(grad_accum_steps):
                    rows = slice(i * mb, (i + 1) * mb)
                    l_i, c_i = _loss_and_correct(
                        model, images[rows], labels[rows], compute_dtype,
                        label_smoothing)
                    l_i.backward()
                    loss, correct = loss + l_i.detach(), correct + c_i
        bucket = torch.cat([p.grad.reshape(-1) for p in params]
                           + [loss.detach().reshape(1), correct.reshape(1)])
        if grad_accum_steps > 1:
            bucket[:-1].div_(grad_accum_steps)
        reduce(bucket)
        bucket[:-1].div_(world)
        for p, g in zip(params, bucket[:-2].split(sizes)):
            p.grad = g.view_as(p)
        grad_norm = torch.linalg.vector_norm(bucket[:-2])  # one reduction
        optimizer.step()
        state.step += 1
        loss, correct = bucket[-2:].clone()  # not views: the bucket is freed
        return StepMetrics(loss=loss, accuracy=correct / (n * world),
                           grad_norm=grad_norm)

    return step


def make_eval_step(model, *, reduce=all_reduce_sum,
                   compute_dtype=torch.float32):
    """``step(images, labels, weights) -> (Σ w·correct, Σ w·loss)`` summed
    over the world (``ddp.py:237-268``); weights zero the wraparound
    padding of the last batch, so the caller divides by the split size."""

    @torch.no_grad()
    def step(images, labels, weights):
        with precision(compute_dtype):
            logits = model(_preprocess(images, compute_dtype),
                           compute_dtype=compute_dtype).float()
        w = weights.float()
        loss = xent(logits, labels)
        out = torch.stack([
            ((logits.argmax(-1) == labels.long()).float() * w).sum(),
            (loss * w).sum(),
        ])
        reduce(out)
        return out[0], out[1]

    return step
