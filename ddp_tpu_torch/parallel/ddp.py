"""The data-parallel train and eval steps (``ddp_tpu/parallel/ddp.py``).

DDP's whole job is one line of the JAX step, ``lax.pmean(grads)``
(``ddp.py:160``), and one more for the non-gradient state,
``lax.pmean(new_ms)`` (``ddp.py:168-173``). Here both are one
``all_reduce`` of one flat fp32 bucket per optimizer step: every
gradient, every floating-point buffer of the model (BatchNorm's running
mean and variance, after this step's forward advanced them), then the
local loss and correct count, summed over the world; all but the count
are then divided by the world. Averaging the running statistics keeps
the replicas identical; it is not SyncBN (each rank normalises by its own
batch's statistics). No ``DistributedDataParallel`` wrapper: the
per-rank step and the epoch runner (``train/fast.py``) share this one
body, and gradient accumulation keeps one all-reduce per update. Replicas
start identical (the same seeded weights on every rank), so no broadcast
is needed.

``reduce`` sums a tensor over the world in place:
``runtime/dist.all_reduce_sum`` in a run; the tests pass an in-process
stand-in to hold a world of 2 against a 2-device JAX mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ddp_tpu_torch.data.augment import step_key
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
    count, the model (its parameters, and its buffers: BatchNorm's
    running statistics, JAX's ``batch_stats`` collection, ride the
    model's ``state_dict()``), the optimizer (its state), and any other
    non-gradient collection (none of the ported models has one)."""

    step: int
    model: torch.nn.Module
    optimizer: Any
    model_state: dict = dataclasses.field(default_factory=dict)


def global_norm(tensors) -> torch.Tensor:
    """√Σ‖t‖², as ``optax.global_norm``; on the tensors' device."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def bucket_all_reduce(params, extras, world: int, reduce, *, accum: int = 1):
    """The one all-reduce of a step: every parameter's gradient (divided
    by ``accum``, the microbatches it sums) and then ``extras`` (tensors,
    the last a count) concatenated into one flat bucket, summed over the
    world by ``reduce``, all but the count divided by the world; each
    parameter's gradient becomes its view of the bucket → (the flat
    averaged gradient, the reduced extras as one flat copy, so that no
    metric keeps the bucket alive)."""
    sizes = [p.numel() for p in params]
    n = sum(sizes)
    bucket = torch.cat([p.grad.reshape(-1) for p in params]
                       + [e.reshape(-1) for e in extras])
    if accum > 1:
        bucket[:n].div_(accum)
    reduce(bucket)
    bucket[:-1].div_(world)
    grads = bucket[:n]
    for p, g in zip(params, grads.split(sizes)):
        p.grad = g.view_as(p)
    return grads, bucket[n:].clone()


def ring_all_reduce_bytes(params, world: int) -> int:
    """The bytes a rank sends in a ring all-reduce of the full fp32
    gradient a step, 2·(N−1)/N of its size (``parallel/zero.py:981``'s
    analytic payload)."""
    n = sum(p.numel() for p in params)
    return int(2 * (world - 1) / world * n * 4)


# The weight of a routed model's load-balance losses in its loss
# (``ddp.py:106``'s default, the only value the trainers use).
AUX_LOSS_WEIGHT = 0.01


def _loss_and_correct(model, images, labels, compute_dtype, label_smoothing,
                      augment_fn=None, key=None):
    x = _preprocess(images, compute_dtype)
    if augment_fn is not None:
        x = augment_fn(key, x)
    if getattr(model, "routed", False):
        # A routed model (MoE): the cross-entropy plus the weighted SUM of
        # its blocks' load-balance losses (``common.py:103-106``).
        logits, aux = model(x, compute_dtype=compute_dtype, with_aux=True)
        logits = logits.float()
        loss = (xent(logits, labels, label_smoothing).mean()
                + AUX_LOSS_WEIGHT * aux)
    else:
        logits = model(x, compute_dtype=compute_dtype).float()
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
    augment_fn=None,
    seed: int = 0,
    rank: int = 0,
):
    """``step(images, labels) -> StepMetrics`` (``ddp.py:98-235``):
    this rank's uint8 batch through forward (the model in train mode)
    and backward, the one all-reduce, one optimizer update;
    ``state.step`` counts it.

    ``grad_accum_steps=k`` splits the local batch into k contiguous
    microbatches and averages their gradients; the running statistics
    advance once a microbatch (``grad_accum_scan`` threads
    ``model_state``). ``augment_fn(key, x)`` (``data/augment``) runs on
    the scaled batch with the key of (``seed``, step, ``rank``,
    microbatch). Metrics (``ddp.py:170``): loss is the mean over ranks,
    accuracy Σcorrect / (n·world), grad_norm the norm of the averaged,
    unclipped gradient. No host read. A routed model's loss adds
    AUX_LOSS_WEIGHT × the sum of its blocks' aux losses.
    """
    model, optimizer = state.model, state.optimizer
    params = [p for p in model.parameters() if p.requires_grad]
    buffers = [b for b in model.buffers() if b.is_floating_point()]
    buf_sizes = [b.numel() for b in buffers]
    n_buf = sum(buf_sizes)

    def key(micro):
        return augment_fn and step_key(seed, state.step, rank, micro)

    def step(images, labels) -> StepMetrics:
        n = labels.shape[0]
        model.train()
        for p in params:
            p.grad = None
        with precision(compute_dtype):
            if grad_accum_steps == 1:
                loss, correct = _loss_and_correct(
                    model, images, labels, compute_dtype, label_smoothing,
                    augment_fn, key(0))
                loss.backward()
            else:
                mb = check_accum_divisible(n, grad_accum_steps)
                loss = correct = 0.0
                for i in range(grad_accum_steps):
                    rows = slice(i * mb, (i + 1) * mb)
                    l_i, c_i = _loss_and_correct(
                        model, images[rows], labels[rows], compute_dtype,
                        label_smoothing, augment_fn, key(i))
                    l_i.backward()
                    loss, correct = loss + l_i.detach(), correct + c_i
        grads, rest = bucket_all_reduce(
            params, buffers + [loss.detach() / grad_accum_steps, correct],
            world, reduce, accum=grad_accum_steps)
        for b, v in zip(buffers, rest[:n_buf].split(buf_sizes)):
            b.copy_(v.view_as(b))
        grad_norm = torch.linalg.vector_norm(grads)  # one reduction
        optimizer.step()
        state.step += 1
        loss, correct = rest[n_buf:]
        return StepMetrics(loss=loss, accuracy=correct / (n * world),
                           grad_norm=grad_norm)

    return step


def make_eval_step(model, *, reduce=all_reduce_sum,
                   compute_dtype=torch.float32):
    """``step(images, labels, weights) -> (Σ w·correct, Σ w·loss)`` summed
    over the world (``ddp.py:237-268``), the model in eval mode (BatchNorm
    normalises by its running averages); weights zero the wraparound
    padding of the last batch, so the caller divides by the split size."""

    @torch.no_grad()
    def step(images, labels, weights):
        model.eval()
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
